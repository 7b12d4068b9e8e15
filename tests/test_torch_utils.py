"""spacer_tpu_torch.utils.profiling and .debugging (counterpart of
tests/test_utils_profiling_debugging.py): a torch.profiler trace with a
named region and a program span, the anomaly-detection and determinism
switches,
the no-op disabled_jit, and interpret_kernels, the opt-in context that
sends CUDA tensors to the kernels' plain versions and counts them (checked
here on a meta tensor, the one non-CPU device this host has, and on the
card by the gpu-marked test)."""

import json

import pytest
import torch

from spacer_tpu_torch.ops import _build
from spacer_tpu_torch.utils.debugging import (
    disabled_jit,
    enable_determinism,
    enable_nan_checks,
    interpret_kernels,
)
from spacer_tpu_torch.utils.profiling import annotate, last_record, span, trace


def test_profiler_trace_and_annotation(tmp_path):
    with trace(str(tmp_path)):
        with annotate("unit-test-region"):
            with span("unit-test-span"):
                float(torch.ones(8).sum())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"unit-test-region", "unit-test-span"} <= names
    # the session's program record holds both, nested
    (inner,) = last_record().named("unit-test-span")
    assert inner.parent.name == "unit-test-region"


def test_nan_checks_toggle():
    enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_enable_determinism():
    try:
        enable_determinism()
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(False)


def test_disabled_jit_is_a_no_op():
    with disabled_jit():
        assert float(torch.ones(2).sum()) == 2.0


def test_interpret_kernels_reroutes_and_counts():
    meta = torch.empty((1, 4, 2, 8), device="meta")
    cpu = torch.empty(1)
    assert _build.takes_plain(cpu, "K1") and not _build.takes_plain(meta, "K1")
    with interpret_kernels() as calls:
        assert _build.takes_plain(meta, "K1")
        assert _build.takes_plain(meta, "K4")
        assert _build.takes_plain(cpu, "K1")    # CPU calls are not counted
        from spacer_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(meta, meta, meta, causal=True)
    assert out.shape == meta.shape and out.device.type == "meta"
    assert calls == {"K1": 2, "K4": 1}
    assert not _build.takes_plain(meta, "K1")   # closed: kernels again


@pytest.mark.gpu
def test_interpret_kernels_on_the_card():
    """Inside the context the card runs the plain version (no launch); the
    result equals a launch-free CPU run of the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from spacer_tpu_torch.ops.flash_attention import flash_attention

    q = torch.randn((1, 64, 2, 128), device="cuda").to(torch.bfloat16)
    before = flash_attention.launches
    with interpret_kernels() as calls:
        out = flash_attention(q, q, q, causal=True)
    assert flash_attention.launches == before and calls == {"K1": 1}
    ref = flash_attention(q.cpu(), q.cpu(), q.cpu(), causal=True)
    assert torch.allclose(out.cpu().float(), ref.float(), atol=1e-2)

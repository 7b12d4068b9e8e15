"""Debugging aids (counterpart of spacer_tpu/utils/debugging.py)."""

from __future__ import annotations

import collections
import contextlib
import os

import torch


def enable_nan_checks(on: bool = True) -> None:
    """Autograd anomaly detection: a backward op that produces a NaN raises,
    with the traceback of the forward op that made its input."""
    torch.autograd.set_detect_anomaly(on)


def enable_determinism() -> None:
    """Bit-reproducible runs: deterministic algorithms only (an op without
    one raises), and the cuBLAS workspace setting they need on the card.
    Costs speed; for debugging divergence."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


@contextlib.contextmanager
def interpret_kernels():
    """Send every kernel wrapper's CUDA call to its plain PyTorch version
    while the context is open (slow, the reference semantics), to tell a
    kernel's fault from the algorithm's.  Opt-in and counted: yields a
    Counter of the calls it rerouted, by kernel id; outside it a CUDA
    tensor launches its kernel or raises (ops/_build.py takes_plain)."""
    from spacer_tpu_torch.ops import _build

    calls = collections.Counter()
    _build.INTERPRET.append(calls)
    try:
        yield calls
    finally:
        _build.INTERPRET.remove(calls)


@contextlib.contextmanager
def disabled_jit():
    """Eager execution for step-through debugging: PyTorch already runs
    eagerly, so this is a no-op kept for the reference's API."""
    yield

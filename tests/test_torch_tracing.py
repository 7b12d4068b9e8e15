"""The program's spans and counters (spacer_tpu_torch/utils/profiling.py) and
the serving path they are put in (serving/server.py, serving/batcher.py):
nothing recorded while off, nesting and self time, the record a
torch.profiler session takes, idle put under the span it fell in, every
span of an admission wave and a decode chunk of a tiny Qwen batcher with
its counters, the served tokens the same with recording on and off, the
request ids of a ServingLoop run, and speculative block steps.

The tests marked `gpu` run on the card
(`python -m pytest tests/test_torch_tracing.py -q -m gpu`): the benchmark's
device trace (perfbench/harness/devtrace.py) puts a kernel inside the span
that launched it, and every host sync torch reports is one the program
counts."""

from __future__ import annotations

import copy
import importlib.util
import pathlib
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
from spacer_tpu_torch.models.qwen25_vl.config import (
    Qwen25VLConfig,
    TextConfig,
    VisionConfig,
    tiny_config,
)
from spacer_tpu_torch.models.qwen25_vl.model import init_params
from spacer_tpu_torch.models.registry import encode_request
from spacer_tpu_torch.serving.batcher import ContinuousBatcher
from spacer_tpu_torch.serving.server import ServingLoop, _Pending
from spacer_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parent.parent

ADMIT_CHILDREN = ("admit.host", "admit.vit", "admit.prefill",
                  "admit.slot_copy", "admit.first_token")
DECODE_SPANS = ("batcher.decode_chunk", "decode.step", "decode.done_check",
                "decode.launch")


def _harness(name: str):
    """A module of the benchmark's harness (perfbench/harness/<name>.py)."""
    path = REPO / "perfbench" / "harness" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_harness_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _conversations():
    from PIL import Image

    rng = np.random.default_rng(0)

    def frames(n, size):
        return [Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8))
                for _ in range(n)]

    def user(*content):
        return [{"role": "user", "content": list(content)}]

    return [
        user({"type": "video", "video": frames(4, 112)},
             {"type": "text", "text": "what is on the table"}),
        user({"type": "text", "text": "count the chairs in the room please"}),
        user({"type": "video", "video": frames(2, 56)},
             {"type": "text", "text": "and here"}),
        user({"type": "text", "text": "x y z"}),
    ]


def _requests(cfg, budgets=(8, 8, 8, 8)):
    proc = VLProcessor(MockTokenizer(cfg.text.vocab_size), cfg)
    reqs = [encode_request(proc, cfg, m) for m in _conversations()]
    for r, b in zip(reqs, budgets):
        r["max_new_tokens"] = b
    bucket = max(r["input_ids"].shape[1] for r in reqs)
    return reqs, bucket, proc


def _batcher(cfg, params, bucket, proc, **kw):
    common = dict(slots=4, prompt_len=bucket, max_new_tokens=8,
                  temperature=0.0, chunk_steps=3, seed=0,
                  eos_token_id=proc.eos_token_id,
                  pad_token_id=proc.pad_token_id)
    return ContinuousBatcher(cfg, params, **dict(common, **kw))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    params = init_params(cfg, seed=0)
    reqs, bucket, proc = _requests(cfg)
    return cfg, params, reqs, bucket, proc


# -- the recorder -----------------------------------------------------------


def test_off_records_nothing_and_span_is_the_shared_no_op():
    before = profiling.last_record()
    a, b = profiling.span("a"), profiling.span("b", request=3, sync=True)
    assert a is b and not profiling.enabled()
    with a:
        profiling.count("n", 5)
        profiling.event("e", request=1)
    assert profiling.last_record() is before
    assert _Pending().id is None and _Pending().submitted_ns is None


@pytest.mark.parametrize("threads", [1, 2])
def test_nesting_parents_counters_and_self_time(threads):
    def work(tag):
        with profiling.span("outer", request=tag) as outer:
            time.sleep(0.002)
            with profiling.span("inner"):
                profiling.count("n", 2)
                time.sleep(0.004)
                with profiling.span("leaf"):
                    profiling.count("n")
            profiling.count("n", 10)
            with profiling.span("inner"):
                time.sleep(0.001)
        return outer

    with profiling.recording() as rec:
        assert profiling.enabled()
        pool = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in pool)
        profiling.count("loose", 7)
    assert rec.closed and profiling.last_record() is rec
    outers = rec.named("outer")
    assert len(outers) == threads and len(rec.named("inner")) == 2 * threads
    for outer in outers:
        kids = rec.children(outer)
        assert [k.name for k in kids] == ["inner", "inner"]
        assert all(k.thread == outer.thread for k in kids)
        (leaf,) = rec.children(kids[0])
        assert rec.path(leaf) == "outer/inner/leaf"
        assert outer.counts == {"n": 10} and kids[0].counts == {"n": 2}
        assert leaf.counts == {"n": 1}
        covered = sum(k.end - k.start for k in kids)
        assert rec.self_ns(outer) == (outer.end - outer.start) - covered
        assert rec.self_ns(outer) >= 2_000_000
        assert rec.self_ns(kids[0]) == (kids[0].end - kids[0].start) - (
            leaf.end - leaf.start)
    assert {o.request for o in outers} == set(range(threads))
    assert rec.counted("n", under="inner") == 3 * threads
    assert rec.counted("n", under="outer") == 13 * threads
    assert rec.counted("n") == 13 * threads
    assert rec.counted("loose") == 7
    window = (outers[0].start * 1e-9, outers[0].end * 1e-9)
    assert [s for s in rec.named("inner", window)
            if s.thread == outers[0].thread] == rec.children(outers[0])


def test_a_profiler_session_is_recorded_and_closed():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("in_session"):
            profiling.count("n")
        rec = profiling.last_record()
        assert rec is not None and not rec.closed
    assert profiling.span("after") is profiling.span("other")
    assert profiling.last_record() is rec and rec.closed
    assert [s.name for s in rec.spans] == ["in_session"]
    assert rec.counted("n", under="in_session") == 1


def test_idle_is_put_under_the_innermost_span_open_at_its_start():
    """The record's segments tile each thread's outermost span by its
    innermost open span; the benchmark's device trace, given them in place
    of its proxy spans, puts each device gap under the one open at its
    start ("queue" outside them)."""
    with profiling.recording() as rec:
        with profiling.span("loop"):
            with profiling.span("chunk"):
                with profiling.span("step"):
                    time.sleep(0.002)
                time.sleep(0.002)
            time.sleep(0.002)
        profiling.event("req", request=1, start_ns=rec.named("loop")[0].start)
        time.sleep(0.001)
    step, chunk, loop = (rec.named(n)[0] for n in ("step", "chunk", "loop"))
    segs = rec.segments()
    assert {p for p, _a, _b in segs} == {"loop", "loop/chunk",
                                         "loop/chunk/step"}
    assert segs[0][1] == loop.start * 1e-9 and segs[-1][2] == loop.end * 1e-9
    assert all(a[2] == b[1] for a, b in zip(segs, segs[1:]))
    assert [p for p, _a, _b in segs if p.endswith("step")] == [
        "loop/chunk/step"]

    s, us = 1e-9, 1e-6
    gaps = [(step.start * s + 100 * us, 100 * us),
            (step.end * s + 100 * us, 300 * us),
            (chunk.end * s + 100 * us, 50 * us),
            (loop.end * s + 100 * us, 400 * us)]
    dt = _harness("devtrace").DeviceTrace(cuda=False)
    dt.t0, dt.t1 = loop.start * s - 100 * us, loop.end * s + 900 * us
    edge, dt.events = dt.t0, []
    for a, length in gaps:
        dt.events.append((edge, a, "busy"))
        edge = a + length
    dt.events.append((edge, dt.t1, "busy"))
    idle = dt.summary(segs)["idle_s"]
    assert set(idle) == {"loop/chunk/step", "loop/chunk", "loop", "queue"}
    # gap edges as float seconds round by a few picoseconds
    for name, want in zip(("loop/chunk/step", "loop/chunk", "loop", "queue"),
                          (100 * us, 300 * us, 50 * us, 400 * us)):
        assert idle[name] == pytest.approx(want, abs=1e-9), name


# -- the batcher --------------------------------------------------------------


def _serve_wave(cfg, params, reqs, bucket, proc, *, record: bool,
                speculate_k: int = 0):
    """One wave of every request, one chunk (recorded), then the rest to
    the end -> (record or None, clock advance of the chunk, steps it ran,
    finished outputs by tag)."""
    b = _batcher(cfg, params, bucket, proc, speculate_k=speculate_k)
    wave = [(i, copy.deepcopy(r), b.budget_of(r), i) for i, r in enumerate(reqs)]
    rec = None
    if record:
        with profiling.recording() as rec:
            b.admit(wave)
            clock = b.clock
            b.decode_chunk()
    else:
        b.admit(wave)
        clock = b.clock
        b.decode_chunk()
    advance = b.clock - clock
    out = {}
    while b.has_active():
        for tag, served in b.poll_finished():
            out[tag] = served.sequences[:served.length].tolist()
        if b.has_active():
            b.decode_chunk()
    return rec, advance, out


def test_admission_and_chunk_spans_counters_and_tokens(tiny):
    cfg, params, reqs, bucket, proc = tiny
    rec, advance, served = _serve_wave(cfg, params, reqs, bucket, proc,
                                       record=True)
    _, _, plain = _serve_wave(cfg, params, reqs, bucket, proc, record=False)
    assert served == plain and len(served) == len(reqs)

    names = {s.name for s in rec.spans}
    assert {"batcher.admit", *ADMIT_CHILDREN, *DECODE_SPANS} <= names
    (admit,) = rec.named("batcher.admit")
    for name in ADMIT_CHILDREN:
        assert all(s.parent is admit for s in rec.named(name)), name
    n_vision = sum(r.get("vision_kwargs") is not None for r in reqs)
    assert len(rec.named("admit.vit")) == len(reqs) > n_vision > 0
    assert rec.counted("admit.positions") == bucket * len(reqs)
    assert rec.counted("admit.real_positions") == sum(
        int(np.asarray(r["attention_mask"]).sum()) for r in reqs)

    (chunk,) = rec.named("batcher.decode_chunk")
    steps = rec.named("decode.step")
    assert advance == 3 and len(steps) == advance
    assert all(s.parent is chunk for s in steps)
    assert [c.name for c in rec.children(steps[0])] == ["decode.launch",
                                                       "decode.done_check"]
    assert rec.counted("decode.steps") == advance
    assert rec.counted("decode.slots_held") == advance * len(reqs)
    # one blocking read per plain step: the done flags
    assert rec.counted("host_syncs", under="batcher.decode_chunk") == advance
    assert rec.counted("host_syncs", under="decode.launch") == 0
    assert rec.counted("host_syncs", under="batcher.admit") > 0


@pytest.mark.parametrize("speculate_k", [0, 2])
def test_each_step_is_a_decode_step_span(tiny, speculate_k):
    """Plain clock steps and speculative block steps alike: as many
    decode.step spans as the chunks ran, and an early exit's extra done
    check."""
    cfg, params, reqs, bucket, proc = tiny
    short = [dict(r, max_new_tokens=3) for r in reqs]
    b = _batcher(cfg, params, bucket, proc, speculate_k=speculate_k,
                 chunk_steps=4)
    b.admit([(i, r, b.budget_of(r), i) for i, r in enumerate(short)])
    with profiling.recording() as rec:
        b.decode_chunk()
    steps = rec.counted("decode.steps")
    assert 1 <= steps < 4
    assert len(rec.named("decode.step")) == steps
    assert len(rec.named("decode.launch")) == steps
    assert len(rec.named("decode.done_check")) == steps + 1
    assert bool(b.done.all())


def test_serving_loop_request_ids_and_the_proxy_waves(tiny):
    cfg, params, reqs, bucket, proc = tiny
    proxy = _harness("proxy").BatcherProxy(_batcher(cfg, params, bucket, proc))
    loop = ServingLoop(proxy)
    try:
        with profiling.recording() as rec:
            pending = [loop.submit(copy.deepcopy(r), stream=s)
                       for r, s in zip(reqs, (True, False, True, False))]
            for p in pending:
                loop.result(p, timeout=120)
            time.sleep(0.05)
    finally:
        loop.shutdown()
    assert len({p.id for p in pending}) == len(pending)
    by_request = {}
    for s in rec.spans:
        if s.request is not None:
            by_request.setdefault(s.request, []).append(s.name)
    for p in pending:
        assert sorted(by_request[p.id]) == ["serve.first_token",
                                            "serve.queued"], by_request[p.id]
        (queued,) = [s for s in rec.spans
                     if s.request == p.id and s.name == "serve.queued"]
        assert queued.start == p.submitted_ns < queued.end
        (first,) = [s for s in rec.spans
                    if s.request == p.id and s.name == "serve.first_token"]
        assert queued.end <= first.start == first.end
    for name in ("loop.iteration", "loop.feed", "batcher.admit"):
        assert rec.named(name), name
    assert all(s.parent.name == "loop.iteration"
               for s in rec.named("batcher.admit"))
    waves = [(t0, t1) for name, t0, t1 in proxy.snapshot()["spans"]
             if name == "admission_wave"]
    admits = rec.named("batcher.admit")
    assert len(waves) == len(admits) >= 1
    for s, (t0, t1) in zip(sorted(admits, key=lambda s: s.start), sorted(waves)):
        assert t0 <= s.start * 1e-9 and s.end * 1e-9 <= t1


# -- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _kernel_config() -> Qwen25VLConfig:
    """A small config inside every kernel's shapes: LM heads of 128 (K1,
    K5), ViT heads of 80 in windows of 64 tokens (K3, K4)."""
    return Qwen25VLConfig(
        text=TextConfig(vocab_size=1024, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=2,
                        num_kv_heads=1, mrope_section=(16, 24, 24)),
        vision=VisionConfig(depth=4, hidden_size=160, intermediate_size=320,
                            num_heads=2, fullatt_block_indexes=(1, 3),
                            out_hidden_size=256, window_size=112),
        image_token_id=6, video_token_id=7, vision_start_token_id=4,
        vision_end_token_id=5, eos_token_id=2, pad_token_id=0)


@pytest.mark.gpu
def test_device_trace_puts_a_kernel_inside_its_span(card):
    """A ~2 ms sleep kernel launched inside a synchronizing program span:
    on the benchmark's clock its device interval lies inside the span, to
    50 us at each edge."""
    DeviceTrace = _harness("devtrace").DeviceTrace
    torch.cuda._sleep(1000)   # loads the kernel
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    torch.cuda.synchronize()
    cycles = int(2.0 / start.elapsed_time(end) * 10 ** 6)   # ~2 ms
    with DeviceTrace(cuda=True) as dt:
        with profiling.span("warm", sync=True):   # the session's first sync
            torch.cuda._sleep(1000)
        with profiling.span("probe", sync=True):
            torch.cuda._sleep(cycles)
        rec = profiling.last_record()
    dt.summary([])
    (probe,) = rec.named("probe")
    sleeps = [(a, b) for a, b, name in dt.events
              if "spin" in name or "sleep" in name]
    assert len(sleeps) == 2, [n for _a, _b, n in dt.events]
    a, b = sleeps[1]
    lead = a - probe.start * 1e-9      # span start -> kernel start
    tail = probe.end * 1e-9 - b        # kernel end -> span end
    print(f"clock check: kernel {1e3 * (b - a):.3f} ms, start {1e6 * lead:.1f}"
          f" us after the span's, end {1e6 * tail:.1f} us before the span's")
    assert b - a > 1e-3
    assert lead > -50e-6 and tail > -50e-6


def _aria_kernel_setup(device):
    """A small Aria (LM heads of 128, 8 experts, 2 a token) with its text
    prompts: the MoE decode path."""
    import dataclasses

    from spacer_tpu_torch.data.aria_processor import (
        AriaProcessor,
        MockAriaTokenizer,
    )
    from spacer_tpu_torch.models.aria import init_params as aria_init_params
    from spacer_tpu_torch.models.aria import tiny_aria_config

    tiny = tiny_aria_config()
    cfg = dataclasses.replace(tiny, text=dataclasses.replace(
        tiny.text, hidden_size=256, intermediate_size=128, num_heads=2,
        num_kv_heads=1))
    params = aria_init_params(cfg, seed=0, dtype=torch.bfloat16, device=device)
    proc = AriaProcessor(MockAriaTokenizer(cfg.text.vocab_size), cfg)
    reqs = [encode_request(proc, cfg, m) for m in _conversations()
            if all(c["type"] == "text" for c in m[0]["content"])]
    for r in reqs:
        r["max_new_tokens"] = 8
    bucket = max(r["input_ids"].shape[1] for r in reqs)
    return cfg, params, reqs, bucket, proc


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["qwen25_vl", "aria"])
def test_every_host_sync_torch_reports_is_counted(card, family):
    """One admission wave (Qwen: text and video prompts; Aria: text prompts
    on its MoE LM) and one decode chunk on the card's kernels under torch's
    sync debug mode: the syncs torch warns of equal the program's
    host_syncs counter."""
    if family == "aria":
        cfg, params, reqs, bucket, proc = _aria_kernel_setup(card)
    else:
        cfg = _kernel_config()
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=card)
        reqs, bucket, proc = _requests(cfg)
    bucket = -(-bucket // 128) * 128

    def wave(b):
        b.admit([(i, copy.deepcopy(r), b.budget_of(r), i)
                 for i, r in enumerate(reqs)])
        b.decode_chunk()
        b.poll_finished()

    wave(_batcher(cfg, params, bucket, proc))   # builds, caches, first calls
    b = _batcher(cfg, params, bucket, proc)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording() as rec:
                wave(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the debug mode does not report torch.cuda.synchronize, which ends each
    # admit.* span while recording)
    reported = [w for w in caught
                if str(w.message).startswith("called a synchronizing")]
    counted = rec.counted("host_syncs")
    print(f"sync check ({family}): torch reported {len(reported)}, the program"
          f" counted {counted}")
    assert len(reported) == counted, sorted(
        (w.filename, w.lineno) for w in reported)

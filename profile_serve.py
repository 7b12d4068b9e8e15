"""Where the time of a serving decode step goes, on one NVIDIA Hopper GPU.

Builds the serving slice of chip_smoke.py (chip_smoke.serving_setup: the
full Qwen2.5-VL-7B geometry, random bf16 weights, 2 video + 2 text
requests, 64 greedy tokens, 4 slots) and, for each --decode_quant, runs
QwenEngine.generate_many without the smoke's checks:
  --runs timed runs (the first also warms up), with synchronised timers
         around every ViT encode and decode step;
  then one run under torch.profiler (CPU + CUDA activities), unless
         --no_profile: wall, and the 30 ops with the most device self time
         (the table's footer gives the device's busy time);
  with --step_kernels, one more run whose 10th decode step alone runs
         under torch.profiler: every device kernel of that step by name,
         with its launches and device time.
Every line goes to stdout, and to --out when given.  --repo imports
spacer_tpu_torch from another checkout (e.g. the parent commit unpacked
under build/), so that two trees can be timed in turn in one call.

    python3 profile_serve.py [--out profile_serve.txt] \\
        [--decode_quant none int4_kv] [--runs 1] [--no_profile] \
        [--step_kernels] [--repo DIR]
"""

from __future__ import annotations

import argparse
import collections
import statistics
import sys
import time

import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    ap.add_argument("--decode_quant", nargs="+", default=["none", "int4_kv"],
                    help="decode quantizations to profile, in turn")
    ap.add_argument("--runs", type=int, default=1,
                    help="timed runs per decode quantization")
    ap.add_argument("--no_profile", action="store_true",
                    help="skip the profiled run")
    ap.add_argument("--step_kernels", action="store_true",
                    help="list the device kernels of one decode step")
    ap.add_argument("--repo", help="import spacer_tpu_torch from this checkout")
    cli = ap.parse_args()
    if cli.repo:
        sys.path.insert(0, cli.repo)
    sink = open(cli.out, "w") if cli.out else None

    def log(*a):
        print(*a, flush=True)
        if sink:
            print(*a, file=sink, flush=True)

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(cs.nvidia_smi_line())
    cs.build_kernels()
    from torch.profiler import ProfilerActivity, profile

    import spacer_tpu_torch
    import spacer_tpu_torch.serving.batcher as bm
    from spacer_tpu_torch.cli.common import decode_quant_arg
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    log(f"spacer_tpu_torch from {spacer_tpu_torch.__file__}")
    params, proc, msgs = cs.serving_setup(QWEN25_VL_7B)
    step, prologue = bm.ragged_decode_step, bm.prologue

    def timed(fn, sink):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    for name in cli.decode_quant:
        quant = decode_quant_arg(name)
        engine = QwenEngine(QWEN25_VL_7B, params, proc, decode_quant=quant)
        for run in range(1, cli.runs + 1):
            step_ms, vit_ms = [], []
            vit = timed(prologue, vit_ms)
            bm.ragged_decode_step = timed(step, step_ms)
            bm.prologue = lambda p, ids, px, **kw: (
                vit if px is not None else prologue)(p, ids, px, **kw)
            t0 = time.perf_counter()
            engine.generate_many(msgs, **cs.SERVE_GEN_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            bm.ragged_decode_step, bm.prologue = step, prologue
            log(f"[{name}] run {run}: wall {wall:.3f} s, decode step median "
                f"{statistics.median(step_ms):.2f} ms over {len(step_ms)} "
                f"steps, ViT encode ms per video "
                f"{[round(x, 2) for x in vit_ms]} (synchronised)")
        if not cli.no_profile:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                engine.generate_many(msgs, **cs.SERVE_GEN_KW)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            # (the profiler makes the program record its spans, and the
            # admission spans synchronize at their ends while it does)
            log(f"[{name}] profiled run (unsynchronised decode steps): wall "
                f"{wall:.3f} s")
            log(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30,
                                          max_name_column_width=70))
        if cli.step_kernels:
            bm.ragged_decode_step = one_step_kernels(step, log, name)
            try:
                engine.generate_many(msgs, **cs.SERVE_GEN_KW)
            finally:
                bm.ragged_decode_step = step
        del engine
        torch.cuda.empty_cache()


def one_step_kernels(step, log, tag, at: int = 10):
    """`step` (the batcher's decode step) with its `at`-th call run alone
    under torch.profiler, logging every device kernel of that step: name,
    launches, device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = [0]

    def probe(*a, **kw):
        calls[0] += 1
        if calls[0] != at:
            return step(*a, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = step(*a, **kw)
            torch.cuda.synchronize()
        count, us = collections.Counter(), collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                count[e.name] += 1
                us[e.name] += e.time_range.elapsed_us()
        log(f"[{tag}] decode step {at}: {sum(count.values())} device kernels, "
            f"{sum(us.values()) / 1e3:.3f} ms of device time")
        for n, c in count.most_common():
            log(f"  {c:5d} x {us[n]:10.1f} us  {n[:100]}")
        return out

    return probe


if __name__ == "__main__":
    main()

"""Where the time of a serving decode step goes, on one NVIDIA Hopper GPU.

Builds the serving slice of chip_smoke.py (chip_smoke.serving_setup: the
full Qwen2.5-VL-7B geometry, random bf16 weights, 2 video + 2 text
requests, 64 greedy tokens, 4 slots) and, for each --decode_quant, runs
QwenEngine.generate_many twice without the smoke's checks:
  run 1: warm-up, with synchronised timers around every decode step;
  run 2: under torch.profiler (CPU + CUDA activities): wall, the decode
         steps' count and median time, and the 30 ops with the most device
         self time (the table's footer gives the device's busy time).
Every line goes to stdout, and to --out when given.

    python3 profile_serve.py [--out profile_serve.txt] \\
        [--decode_quant none int4_kv]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    ap.add_argument("--decode_quant", nargs="+", default=["none", "int4_kv"],
                    help="decode quantizations to profile, in turn")
    cli = ap.parse_args()
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

    import spacer_tpu_torch.serving.batcher as bm
    from spacer_tpu_torch.cli.common import decode_quant_arg
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    params, proc, msgs = cs.serving_setup(QWEN25_VL_7B)
    step = bm.ragged_decode_step
    for name in cli.decode_quant:
        quant = decode_quant_arg(name)
        engine = QwenEngine(QWEN25_VL_7B, params, proc, decode_quant=quant)
        step_ms = []

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out

        bm.ragged_decode_step = timed
        t0 = time.perf_counter()
        engine.generate_many(msgs, **cs.SERVE_GEN_KW)
        torch.cuda.synchronize()
        log(f"[{name}] run 1: wall {time.perf_counter() - t0:.3f} s, decode "
            f"step median {statistics.median(step_ms):.2f} ms over "
            f"{len(step_ms)} steps (synchronised)")
        bm.ragged_decode_step = step
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.generate_many(msgs, **cs.SERVE_GEN_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        log(f"[{name}] run 2 (profiled, unsynchronised steps): wall "
            f"{wall:.3f} s")
        log(prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=30, max_name_column_width=70))
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

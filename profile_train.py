"""Where the time of an SG-RLVR training step goes, on one NVIDIA Hopper GPU.

Builds the training slice of chip_smoke.py (chip_smoke.make_trainer:
Qwen2.5-VL-7B widths, LM cut to chip_smoke.TRAIN_LM_LAYERS layers, random
bf16 weights, one 16-frame video row, merged temporal rollout of 2 x 8
completions of up to 256 tokens at --decode_quant, by default the
trainer's own "int8_kv", int8 moments) and runs three training steps
without the smoke's checks:
  steps 1-2: synchronised timers around the rollout's decode step, its
             top-p sampling, its prefill and the update (step 1 is the
             warm-up, so read step 2);
  step 3:    under torch.profiler (CPU + CUDA activities): wall, and the
             40 ops with the most device self time (the table's footer
             gives the device's busy time); skipped with --no_profile.
Every line goes to stdout, and to --out when given.  --repo imports
spacer_tpu_torch from another checkout (e.g. the parent commit unpacked
under build/), so that two trees can be timed in turn in one call.

    python3 profile_train.py [--out profile_train.txt] [--decode_quant none] \
        [--no_profile] [--repo DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    ap.add_argument("--decode_quant", default=None,
                    help="rollout decode quantization (default: the "
                    "trainer's; 'none' for bf16)")
    ap.add_argument("--no_profile", action="store_true",
                    help="skip the profiled step")
    ap.add_argument("--repo", help="import spacer_tpu_torch from this checkout")
    cli = ap.parse_args()
    if cli.repo:
        sys.path.insert(0, cli.repo)
    import spacer_tpu_torch
    from spacer_tpu_torch.cli.common import decode_quant_arg
    from spacer_tpu_torch.train.trainer import SGRLVRConfig

    if cli.decode_quant is None:
        cli.decode_quant = SGRLVRConfig().decode_quant
    out = cli.out
    sink = open(out, "w") if out else None

    def log(*a):
        print(*a, flush=True)
        if sink:
            print(*a, file=sink, flush=True)

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(cs.nvidia_smi_line())
    cs.build_kernels()
    from torch.profiler import ProfilerActivity, profile

    import spacer_tpu_torch.sampler.sampler as sm
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B

    cfg = dataclasses.replace(QWEN25_VL_7B, text=dataclasses.replace(
        QWEN25_VL_7B.text, num_layers=cs.TRAIN_LM_LAYERS))
    out_dir = str(pathlib.Path(__file__).resolve().parent / "build"
                  / "profile_train")
    trainer, _ = cs.make_trainer(cfg, "cuda", 3, out_dir,
                                 decode_quant=decode_quant_arg(cli.decode_quant))
    log(f"spacer_tpu_torch from {spacer_tpu_torch.__file__}")
    log(f"rollout decode_quant: {trainer.args.decode_quant!r}")
    row = trainer.dataset[0]
    rng = np.random.default_rng(0)
    phases = {}

    def timed(fn, key):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            phases.setdefault(key, []).append(time.perf_counter() - t)
            return r
        return wrapped

    saved = (sm.lm_decode_step_split, sm.sample_logits, sm.lm_forward,
             trainer.step_fn)
    sm.lm_decode_step_split = timed(saved[0], "decode step")
    sm.sample_logits = timed(saved[1], "sample")
    sm.lm_forward = timed(saved[2], "rollout prefill (LM)")
    trainer.step_fn = timed(saved[3], "update")
    trainer.step_fn.ref_logps_fn = saved[3].ref_logps_fn
    for i in range(2):
        phases.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.training_step([row], rng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"step {i + 1}: wall {wall:.3f} s; " + "; ".join(
            f"{k} n={len(v)} sum {sum(v):.3f} s median "
            f"{np.median(v) * 1e3:.2f} ms" for k, v in phases.items()))
        log("trainer times:", {k: v[-1] for k, v in trainer._metrics.items()
                               if k.startswith("time/")})
    sm.lm_decode_step_split, sm.sample_logits, sm.lm_forward, \
        trainer.step_fn = saved
    if cli.no_profile:
        return

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.training_step([row], rng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the table's footer "Self CUDA time total" is the device's busy time
    # (summing the rows would count an aten op and its kernels twice)
    log(f"profiled step 3: wall {wall:.3f} s")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=40, max_name_column_width=70))
    log(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")


if __name__ == "__main__":
    main()

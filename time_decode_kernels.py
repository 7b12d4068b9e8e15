"""K6 (as dense_q4) and K2 / K2-int8 alone on one NVIDIA Hopper GPU:
CUDA-event, device-only (chip_smoke.median_ms / device_ms) and host-enqueue
ms per call, with the spacer_tpu_torch of --repo, so that two trees can be
timed in turn in one call:

    git archive HEAD | tar -x -C build/ab_parent
    python3 time_decode_kernels.py --repo build/ab_parent
    python3 time_decode_kernels.py

K6: ops/quant.py dense_q4, the call every int4 decode product makes (the
scales, cast and bias included, however many launches a tree makes of it),
at every (K, N) of the 7B int4 decode, M = 4 (serving slots) and 16 (rollout
rows), beside its roofline bound.  K2 / K2-int8: flash_decode_attention at
the rollout's shape (chip_smoke.grouped_decode_case: B=2 prompts x G=8
completions of group_q 7, Hkv=4, P=1536 both padded by 467, T=256) at steps
1, 100 and 255.  Host ms is the wrapper's enqueue time alone
(time_ragged_decode.host_ms).  Times only: chip_smoke checks the outputs.
"""

from __future__ import annotations

import argparse
import sys

import torch

import chip_smoke as cs
from time_ragged_decode import host_ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", help="import spacer_tpu_torch from this checkout")
    cli = ap.parse_args()
    if cli.repo:
        sys.path.insert(0, cli.repo)
    if not torch.cuda.is_available():
        raise SystemExit("time_decode_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(cs.nvidia_smi_line())
    cs.build_kernels()
    import spacer_tpu_torch
    from spacer_tpu_torch.ops import flash_decode as fd
    from spacer_tpu_torch.ops import quant

    cs.log(f"spacer_tpu_torch from {spacer_tpu_torch.__file__}")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def report(name, call, work):
        bound = cs.roofline(*work)["bound_ms"]
        dev = cs.device_ms(call, bound)
        cs.log(f"{name}: kernel {cs.median_ms(call):.4f} ms | host "
               f"{host_ms(call):.4f} ms | bound {bound:.4f} ms | device_ms "
               + ("not measured" if dev is None else f"{dev:.4f}"))

    for K, N in cs.K6_SHAPES:
        _, params = cs.int4_dense_case(gen, K, N)
        for M in (4, 16):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            report(f"K6 dense_q4 M={M} K={K} N={N}",
                   lambda: quant.dense_q4(params, x),
                   (K * N // 2 + M * K * 2 + K * 4 + N * (4 + 2 + M * 2),
                    2 * M * K * N))
        del params
        torch.cuda.empty_cache()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    pad = cs.TRAIN_PROMPT_PAD
    args, dkw, work = cs.grouped_decode_case(randn, gen, cs.TRAIN_PROMPT_BUCKET,
                                             (pad, pad), cs.TRAIN_G)
    for step in (1, 100, cs.TRAIN_NEW_TOKENS - 1):
        a, w = args(step), work(step)
        for kid in ("K2", "K2-int8"):
            report(f"{kid} P={cs.TRAIN_PROMPT_BUCKET} G={cs.TRAIN_G} step={step}",
                   lambda: fd.flash_decode_attention(*a[kid], **dkw), w[kid])


if __name__ == "__main__":
    main()

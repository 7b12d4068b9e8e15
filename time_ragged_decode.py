"""K5 and K5-int8 alone on one NVIDIA Hopper GPU: CUDA-event, device-only
(chip_smoke.median_ms / device_ms) and host ms per call at chip_smoke's
RAGGED_CASES slot layouts (the smoke's 8 slots with Cmax 128, the serving
batcher's 4 slots with Cmax 64), with the spacer_tpu_torch of --repo, so
that two trees' kernels can be timed in turn in one call:

    git archive HEAD | tar -x -C build/ab_parent
    python3 time_ragged_decode.py --repo build/ab_parent
    python3 time_ragged_decode.py

Host ms is the wrapper's enqueue time alone: the host clock over 200 calls
with no synchronisation (the card's queue holds them all).  Times only: the
outputs are not checked (chip_smoke does that).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

import chip_smoke as cs


def host_ms(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", help="import spacer_tpu_torch from this checkout")
    cli = ap.parse_args()
    if cli.repo:
        sys.path.insert(0, cli.repo)
    if not torch.cuda.is_available():
        raise SystemExit("time_ragged_decode: no CUDA device")
    cs.log(cs.nvidia_smi_line())
    cs.build_kernels()
    import spacer_tpu_torch
    from spacer_tpu_torch.ops import flash_decode as fd

    cs.log(f"spacer_tpu_torch from {spacer_tpu_torch.__file__}")
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    P = 1024
    for tag, (C, plen, tlen, admit) in cs.RAGGED_CASES.items():
        cases, kw, live, work = cs.ragged_decode_case(randn, gen, P, C, plen,
                                                      tlen, admit)
        for kid, args in cases.items():
            def call():
                return fd.flash_ragged_decode_attention(*args, **kw)
            bound = cs.roofline(*work[kid])["bound_ms"]
            dev = cs.device_ms(call, bound)
            cs.log(f"{kid} R={len(plen)} Pmax={P} Cmax={C} "
                   f"({int(live.sum())} live slots): kernel "
                   f"{cs.median_ms(call):.4f} ms | host {host_ms(call):.4f} ms"
                   f" | bound {bound:.4f} ms | device_ms "
                   + ("not measured" if dev is None else f"{dev:.4f}"))


if __name__ == "__main__":
    main()

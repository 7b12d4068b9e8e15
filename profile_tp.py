"""Where the time of a tensor-parallel serving decode step goes, per rank.

For each N of --world (1 = one card, no mesh), N NCCL ranks
(parallel.multihost.launch_local) build chip_smoke.py's serving slice (the
full Qwen2.5-VL-7B geometry, random bf16 weights, 2 video + 2 text
requests, 64 greedy tokens, 4 slots), split it over tp = N (shard_params
with the Qwen tp plan, the fsdp shards gathered as the serve CLI does) and
run QwenEngine.generate_many three times: a warm-up, a run with
synchronised timers around every decode step (chip_smoke.SliceProbe), and
a run under torch.profiler (CPU + CUDA).  Per rank it prints the decode ms
per step, the profiled run's wall, the device's busy time (the sum of the
kernels' self time), the time inside NCCL kernels, the host's self time in
the collectives' ops and in the CUDA calls that block the host (stream,
event and device synchronisations), and the 12 host ops with the most
self time.  Every line goes to stdout, and to --out when given.

    python3 profile_tp.py --world 1,2,4 [--out chiprun_out/profile_tp.txt]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import statistics
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def _summary(prof) -> dict:
    """Host and device totals (ms) of a profiled run, by what they are."""
    dev_busy = nccl = coll_host = sync_host = 0.0
    host = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0.0) / 1e3
        cpu = e.self_cpu_time_total / 1e3
        name = e.key
        if dev:
            dev_busy += dev
            if "nccl" in name.lower():
                nccl += dev
        if any(k in name for k in ("c10d::", "nccl:", "allreduce",
                                   "all_gather", "record_param_comms")):
            coll_host += cpu
        if any(k in name for k in ("Synchronize", "cudaStreamWaitEvent")):
            sync_host += cpu
        host.append((cpu, e.count, name))
    host.sort(reverse=True)
    return {"device_busy_ms": dev_busy, "nccl_device_ms": nccl,
            "collective_host_ms": coll_host, "sync_host_ms": sync_host,
            "top_host": host[:12]}


def _rank(rank, out, world):
    import chip_smoke as cs
    from spacer_tpu_torch.cli.common import serving_params
    from spacer_tpu_torch.evalharness import QwenEngine
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh
    from spacer_tpu_torch.parallel.partition import (
        QWEN_PARTITION_RULES,
        qwen_tp_plan,
        shard_params,
    )
    from torch.profiler import ProfilerActivity, profile

    params, proc, msgs = cs.serving_setup(QWEN25_VL_7B)
    if world > 1:
        mesh = create_mesh({"data": 1, "fsdp": 1, "tp": world})
        params = serving_params(shard_params(
            params, mesh, QWEN_PARTITION_RULES,
            qwen_tp_plan(QWEN25_VL_7B))[0], mesh)
    engine = QwenEngine(QWEN25_VL_7B, params, proc)
    engine.generate_many(msgs, **cs.SERVE_GEN_KW)          # warm-up
    with cs.SliceProbe() as probe:
        engine.generate_many(msgs, **cs.SERVE_GEN_KW)
    torch.cuda.synchronize()
    multihost.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_many(msgs, **cs.SERVE_GEN_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rec = {"decode_ms": statistics.median(probe.decode_ms),
           "steps": len(probe.decode_ms), "profiled_wall_s": wall,
           **_summary(prof)}
    parts = multihost.all_gather_objects(rec)
    if rank == 0:
        torch.save(parts, os.path.join(out, f"profile_tp_{world}.pt"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", default="1,2")
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tp.py needs CUDA cards")
    import subprocess

    from spacer_tpu_torch.parallel.multihost import launch_local

    sink = open(args.out, "w") if args.out else None

    def log(*a):
        print(*a, flush=True)
        if sink:
            print(*a, file=sink, flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("cards (nvidia-smi): " + " | ".join(smi.stdout.strip().splitlines()))
    out = str(pathlib.Path(__file__).resolve().parent / "build")
    os.makedirs(out, exist_ok=True)
    os.environ["PYTHONHASHSEED"] = "0"    # every rank's mock tokenizer alike
    for world in (int(w) for w in args.world.split(",")):
        if world > torch.cuda.device_count():
            raise SystemExit(f"--world {world}: "
                             f"{torch.cuda.device_count()} cards")
        launch_local(_rank, world, args=(out, world), device="cuda",
                     timeout=1200)
        parts = torch.load(os.path.join(out, f"profile_tp_{world}.pt"),
                           weights_only=False)
        for r, p in enumerate(parts):
            log(f"tp={world} rank {r}: decode {p['decode_ms']:.2f} ms per "
                f"step (median of {p['steps']}); profiled run "
                f"{p['profiled_wall_s']:.2f} s: device busy "
                f"{p['device_busy_ms']:.1f} ms, in NCCL kernels "
                f"{p['nccl_device_ms']:.1f} ms; host self time in the "
                f"collectives' ops {p['collective_host_ms']:.1f} ms, in "
                f"blocking syncs and stream waits {p['sync_host_ms']:.1f} ms")
            log(f"tp={world} rank {r}: top host ops by self time: " + "; ".join(
                f"{name} {cpu:.1f} ms x{n}" for cpu, n, name in p["top_host"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

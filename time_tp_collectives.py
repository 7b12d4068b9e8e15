"""Times tensor parallelism's collectives alone on N cards of one host.

Each of N NCCL ranks (parallel.multihost.launch_local) runs the tp
collectives of a 7B decode step and prefill in a tight loop of `--iters`
calls, with nothing else between them: the all-reduce after a row-parallel
product at 4 slots (4, 3584) bf16 and at a 1024-token prefill (1024, 3584),
and the logits all-gather at 4 slots ((4, 152064 / N) bf16 per rank).
Per call it prints the CUDA-event time over the loop and the host's time
to issue it (the loop before the synchronize), rank by rank, so a call's
cost can be told apart from the ranks' skew inside a real step.  It also
prints `nvidia-smi topo -m`, the cards' link matrix.

    python3 time_tp_collectives.py --world 2,4 [--iters 500]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

SHAPES = (("decode all-reduce", (4, 3584)), ("prefill all-reduce",
                                             (1024, 3584)))


def _rank(rank, out, iters):
    from spacer_tpu_torch.parallel import multihost, tp
    from spacer_tpu_torch.parallel.mesh import create_mesh

    world = multihost.process_count()
    tp.set_mesh(create_mesh({"tp": world}))
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = [(name, lambda x: tp.reduce_from_tp(x), torch.randn(
        shape, device=dev).to(torch.bfloat16)) for name, shape in SHAPES]
    cases.append(("logits all-gather", lambda x: tp.gather_from_tp(x),
                  torch.randn((4, 152064 // world), device=dev).to(
                      torch.bfloat16)))
    rec = {}
    for name, fn, x in cases:
        for _ in range(20):
            fn(x)
        torch.cuda.synchronize()
        multihost.barrier()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        for _ in range(iters):
            fn(x)
        e1.record()
        issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        rec[name] = {"event_us": e0.elapsed_time(e1) * 1e3 / iters,
                     "issue_us": issue * 1e6 / iters,
                     "bytes": x.numel() * x.element_size()}
    parts = multihost.all_gather_objects(rec)
    if rank == 0:
        with open(os.path.join(out, f"tp_collectives_{world}.json"), "w") as f:
            json.dump(parts, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", default="2")
    ap.add_argument("--iters", type=int, default=500)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_tp_collectives.py needs CUDA cards")
    from spacer_tpu_torch.parallel.multihost import launch_local

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print("cards (nvidia-smi): " + " | ".join(smi.stdout.strip().splitlines()))
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    print(topo.stdout.strip() or topo.stderr.strip())
    out = str(pathlib.Path(__file__).resolve().parent / "build")
    os.makedirs(out, exist_ok=True)
    for world in (int(w) for w in args.world.split(",")):
        if world > torch.cuda.device_count():
            raise SystemExit(f"--world {world}: "
                             f"{torch.cuda.device_count()} cards")
        launch_local(_rank, world, args=(out, args.iters), device="cuda",
                     timeout=600)
        with open(os.path.join(out, f"tp_collectives_{world}.json")) as f:
            parts = json.load(f)
        for name in parts[0]:
            print(f"tp={world} {name} ({parts[0][name]['bytes']} B per rank): "
                  + ", ".join(f"rank {r} {p[name]['event_us']:.1f} us per "
                              f"call by events, {p[name]['issue_us']:.1f} "
                              f"us to issue" for r, p in enumerate(parts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

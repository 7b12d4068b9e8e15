"""The benchmark of spacer_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Each run is a new process: it makes the cell's weights and inputs from the
seed, builds the port's serving path, warms up the cell's own shapes, then
measures for `--seconds` and checks the outputs against the plain reference.
The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics from a profiled window), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared beside its limit,
which also end standard error.  It needs as many CUDA cards as the cell
names and exits with another code than 0, printing no result, without them,
or if JAX or the JAX package was loaded.

Everything the run builds or caches stays inside the checkout: the port's
nvcc library in build/spacer_tpu_torch (its default) and a Triton cache in
build/triton.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spacer_tpu")
TOP = 10


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: spacer_tpu_torch is not spacer_tpu)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN and sys.modules[m] is not None)


def breakdown(trace: dict) -> dict:
    def top(d):
        return [[n[:96], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(trace["device_s"]), "idle_gaps": top(trace["idle_s"])}


def metrics_of(cell, record, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(record)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no value")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, device_kind: str = "cuda") -> int:
    args = parse(argv)
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    sys.path[:0] = [str(BENCH), str(REPO)]
    import torch

    from harness import spec

    cell = spec.resolve(args.workload, BENCH)
    chips = cell.workload["chips"]
    if device_kind == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"needs {chips} CUDA card(s); found {n}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_kind)
    record = cell.driver().run(cell, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), device=device,
                               t_start=T_START)
    metrics = metrics_of(cell, record, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port must not import JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
           else device.type, "count": chips,
           "memory_peak_bytes": record.memory_peak_bytes}
    result = {"correct": record.correct, "attempted": record.attempted,
              "failed": record.failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = record.trace["busy_s"]
        dev["window_s"] = record.trace["window_s"]
        result["breakdown"] = breakdown(record.trace)
    result["checks"] = record.checks
    print(json.dumps(result), flush=True)
    for name, c in record.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One traced run of a benchmark cell, with the card's idle time put under the
port's own spans.

    python3 profile_idle_spans.py --workload qwen25vl7b.video_qa --seed 7 --seconds 51 --out chiprun_out/spans.json

It runs `perfbench/run.py --trace 1` in this process (the same weights,
traffic, window and result line) and, from the same device trace and the
port's record of the window (spacer_tpu_torch.utils.profiling, which the
trace's torch.profiler session turns on), writes:

- `idle_program_s`: the trace's idle seconds put under the innermost
  program span open on the host when each gap began, by path
  (`loop.iteration/batcher.decode_chunk/decode.step/decode.launch`):
  DeviceTrace.summary's own gap finding over the record's segments
  (`Record.segments`), as it puts the gaps under the proxy's spans
  ("queue" where no program span was open);
- `decode_chunk_idle_under_decode_spans`: of the idle under
  `batcher.decode_chunk`, the share under a `decode.*` span;
- `launch_idle_share`: % of the window idle in gaps that began while the
  host was inside `decode.launch`, and the same for `decode.done_check`;
- `coverage`: the seconds of `decode.done_check` + `decode.launch` over the
  proxy's `decode_chunk` seconds, and of the five `admit.*` spans over its
  `admission_wave` seconds (chunks and waves inside the window);
- `spans`: count, total, median and p90 ms of every program span name in
  the window, and the window's counters.

A stopgap beside the benchmark: once the device trace's summary returns
the idle by program span itself, this script goes.

The result line is printed last on standard output, as run.py prints it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

REPO = pathlib.Path(__file__).resolve().parent
BENCH = REPO / "perfbench"
ADMIT = ("admit.host", "admit.vit", "admit.prefill", "admit.slot_copy",
         "admit.first_token")


def inside(intervals, outer) -> list:
    """The intervals that start inside one of `outer`'s."""
    return [(a, b) for a, b in intervals
            if any(s <= a < e for s, e in outer)]


def analyse(trace, proxy_spans, summary) -> dict:
    """summary: DeviceTrace.summary as the harness has it."""
    from spacer_tpu_torch.utils import profiling

    rec = profiling.last_record()
    w0, w1 = trace.t0, trace.t1
    window = (w0, w1)
    idle = summary(trace, rec.segments())["idle_s"]
    chunks = [(a, b) for n, a, b in proxy_spans
              if n == "decode_chunk" and w0 <= a and b <= w1]
    waves = [(a, b) for n, a, b in proxy_spans
             if n == "admission_wave" and w0 <= a and b <= w1]
    in_chunk = {k: v for k, v in idle.items() if "batcher.decode_chunk" in k}
    under_decode = sum(v for k, v in in_chunk.items()
                       if k.split("/")[-1].startswith("decode."))

    def idle_in(leaf):
        return sum(v for k, v in idle.items() if k.split("/")[-1] == leaf)

    def secs(name):
        return [(s.start * 1e-9, s.end * 1e-9) for s in rec.named(name, window)]

    def covered(names, outer):
        own = sum(b - a for n in names for a, b in inside(secs(n), outer))
        return own / sum(b - a for a, b in outer) if outer else None

    stats = {}
    for name in sorted({s.name for s in rec.spans}):
        ms = [1e-6 * (s.end - s.start) for s in rec.named(name, window)]
        if ms:
            q = statistics.quantiles(ms, n=10) if len(ms) > 1 else ms * 9
            stats[name] = {"n": len(ms), "total_ms": sum(ms),
                           "median_ms": statistics.median(ms), "p90_ms": q[8]}
    counters = {}
    for s in rec.spans:
        if s.counts and w0 <= s.start * 1e-9 and s.end * 1e-9 <= w1:
            for k, v in s.counts.items():
                counters[k] = counters.get(k, 0) + v
    length = w1 - w0
    return {
        "window_s": length, "idle_s": sum(idle.values()),
        "idle_program_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "decode_chunk_idle_s": sum(in_chunk.values()),
        "decode_chunk_idle_under_decode_spans": (
            under_decode / sum(in_chunk.values()) if in_chunk else None),
        "launch_idle_share": 100.0 * idle_in("decode.launch") / length,
        "done_check_idle_share": 100.0 * idle_in("decode.done_check") / length,
        "coverage": {
            "decode_chunk": covered(("decode.done_check", "decode.launch"), chunks),
            "admission_wave": covered(ADMIT, waves)},
        "spans": stats, "counters": counters}


def main(argv=None, device_kind: str = "cuda") -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(REPO)]
    import importlib.util

    from harness import devtrace

    found = {}
    summary = devtrace.DeviceTrace.summary

    def summary_and_spans(self, spans):
        out = summary(self, spans)
        if not found:
            found.update(analyse(self, spans, summary))
        return out

    devtrace.DeviceTrace.summary = summary_and_spans
    s = importlib.util.spec_from_file_location("perfbench_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"],
                  device_kind=device_kind)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(found, indent=1))
    print(json.dumps({k: found.get(k) for k in (
        "idle_s", "decode_chunk_idle_s", "decode_chunk_idle_under_decode_spans",
        "launch_idle_share", "done_check_idle_share", "coverage")}),
        file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

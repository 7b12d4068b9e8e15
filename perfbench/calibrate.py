"""Readings that a cell's correctness limit is set from, and the rate sweep
that fixes an open-loop cell's arrival rate.  Not run by the benchmark.

    python3 perfbench/calibrate.py limits --workload W --seeds S1,S2,... \\
        --seconds T [--control N]
    python3 perfbench/calibrate.py sweep --workload W --seed S --seconds T \\
        --rates R1,R2,...

`limits`: in one process, for each seed a run of the cell's own traffic and
load for T seconds (a backlog: twice the check's most requests, at once),
drained; the sample the check takes; the program's
widest gap against the float32 reference (the lower reading).  On the
first N seeds also the control: the reference itself computed with float8
e4m3 products (the step below the bf16 the configuration states), judged
at the same positions by the gap of the token it puts first (the upper
reading).  One JSON line per seed on standard output.

With --decode_quant (int8, int8_kv, ...) the program serves through its
own lower-precision decode path: a second control, read as the program.

`sweep`: the open loop at each rate for T seconds, after the warm-up:
requests due, finished in the window, the backlog left at its close, and
TTFT p50 / p90; the highest rate whose backlog does not grow is the one the
system sustains.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("limits", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--rates", default="")
    p.add_argument("--witness", type=int, default=0)
    p.add_argument("--decode_quant", default=None,
                   help="serve with the program's own lower-precision decode path")
    return p.parse_args(argv)


def served_run(cell, seed, seconds, device, rate=None, warm=False):
    """One window of the cell's driver on fresh weights (after the cell's
    warm-up with `warm`) -> (serving, run), the program's state freed."""
    from harness.serving import Serving, collect

    tr = cell.traffic
    if rate is not None:
        tr["arrivals"]["rate_per_s"] = rate
    s = Serving(cell, seed, seconds, device, trace=False)
    if warm:
        s.warm_up()
    t0 = time.perf_counter()
    pending, submitted, due = [], [], []
    for d, req in zip(s.due, s.requests):
        when = t0 + d
        time.sleep(max(0.0, when - time.perf_counter()))
        submitted.append(time.perf_counter())
        due.append(when)
        stream = tr["driver"] == "open_loop_serving"
        pending.append(s.loop.submit(req, stream=stream))
        if (tr["arrivals"]["kind"] == "backlog"
                and len(pending) >= 2 * cell.limits["max_requests"]):
            break
    end = t0 + seconds
    time.sleep(max(0.0, end - time.perf_counter()))
    run = collect(s, pending, submitted, due, (t0, end),
                  deadline=end + tr["drain_seconds"])
    s.free()
    return s, run


def witness_logits(cell, params, items) -> list:
    """A second path of the program over the same tokens: the port's
    one-call forward without a cache, unpadded, one request at a time, in
    the served dtype -> per item (n, vocab) logits at the served positions."""
    import numpy as np
    import torch

    from harness.serving import port_config

    cfg = port_config(cell.config)
    out = []
    with torch.no_grad():
        for it in items:
            toks = np.concatenate([it["ids"], it["served"][:-1]])
            dev = params["model"]["embed_tokens"]["embedding"].device
            t = torch.as_tensor(toks, device=dev)[None]
            if cell.config["family"] == "aria":
                from spacer_tpu_torch.models.aria.language import (
                    lm_forward, positions_1d_to_3d)

                pos = positions_1d_to_3d(torch.arange(t.shape[1], device=dev)[None])
                lg, _ = lm_forward(params["model"], cfg.text, input_ids=t,
                                   position_ids=pos)
            else:
                from spacer_tpu_torch.models.qwen25_vl.model import forward
                from spacer_tpu_torch.models.qwen25_vl.rope_index import (
                    get_rope_index)

                pos, _ = get_rope_index(
                    cfg, toks[None], video_grid_thw=np.asarray([it["grid"]]),
                    second_per_grid_ts=np.asarray([it["second_per_grid"]]))
                lg, _ = forward(params, cfg, t, pixel_values=it["pixels"],
                                grid_thw=[it["grid"]],
                                position_ids=torch.as_tensor(pos, device=dev))
            out.append(lg[0, -len(it["served"]):].float())
    return out


def limits(cell, seeds, seconds, control, device, witness=False):
    import torch

    from harness import check
    from reference.common import Precision, gaps

    ref = check.reference_module(cell.config["family"])
    lim = cell.limits
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        s, run = served_run(cell, seed, seconds, device)
        picked = check.sample(run.requests, seed, lim["min_served_tokens"],
                              lim["max_requests"])
        items = check.items(s, run.requests, picked)
        model = cell.config["model"]
        f32 = ref.served_logits(s.params, model, items, Precision("f32"))
        per_item = [gaps(lg, torch.as_tensor(it["served"], device=lg.device))
                    for lg, it in zip(f32, items)]
        prog = torch.cat(per_item)
        first = torch.stack([g[0] for g in per_item])
        out = {"seed": seed, "requests": len(run.requests),
               "compared": len(picked), "tokens": int(prog.numel()),
               "program_widest_gap": float(prog.max()),
               "program_mean_gap": float(prog.mean()),
               "program_flipped": float((prog > 0).float().mean()),
               "program_widest_first_token_gap": float(first.max()),
               "unfinished": sum(r.served is None for r in run.requests)}
        if witness:
            wl = witness_logits(cell, s.params, items)
            wg = torch.cat([gaps(a, b.argmax(-1)) for a, b in zip(f32, wl)])
            agree = torch.cat([b.argmax(-1).cpu() == torch.as_tensor(it["served"])
                               for b, it in zip(wl, items)])
            out.update(witness_widest_gap=float(wg.max()),
                       witness_mean_gap=float(wg.mean()),
                       witness_flipped=float((wg > 0).float().mean()),
                       witness_agrees_with_served=float(agree.float().mean()))
        if k < control:
            low = ref.served_logits(s.params, model, items, Precision("fp8"))
            cg = torch.cat([gaps(a, b.argmax(-1)) for a, b in zip(f32, low)])
            out.update(control_widest_gap=float(cg.max()),
                       control_mean_gap=float(cg.mean()),
                       control_flipped=float((cg > 0).float().mean()))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del s, run, f32, items
        gc.collect()
        torch.cuda.empty_cache()


def sweep(cell, seed, seconds, rates, device):
    import torch

    from harness.readings import percentile

    for k, rate in enumerate(rates):
        seed += k
        s, run = served_run(cell, seed, seconds, device, rate=rate, warm=True)
        end = run.window[1]
        reqs = run.requests
        ttft = [r.first_token - r.due for r in reqs if r.first_token]
        print(json.dumps({
            "rate": rate, "due": len(reqs),
            "finished_in_window": sum(r.finish is not None and r.finish <= end
                                      for r in reqs),
            "admitted_in_window": sum(r.admitted is not None and r.admitted <= end
                                      for r in reqs),
            "waiting_at_close": sum(r.admitted is None or r.admitted > end
                                    for r in reqs),
            "ttft_p50_ms": 1e3 * percentile(ttft, 50),
            "ttft_p90_ms": 1e3 * percentile(ttft, 90), "waves": len(run.waves),
            "chunk_steps": sum(c[3] - c[2] for c in run.chunks),
            "decode_step_ms": 1e3 * sum(c[1] - c[0] for c in run.chunks)
            / max(1, sum(c[3] - c[2] for c in run.chunks))}),
            flush=True)
        del s, run
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None):
    import torch

    from harness import spec

    args = parse(argv)
    cell = spec.resolve(args.workload, BENCH)
    if args.decode_quant:
        cell.traffic["serving"]["decode_quant"] = args.decode_quant
    device = (torch.device("cuda", 0) if torch.cuda.is_available()
              else torch.device("cpu"))
    if args.what == "limits":
        limits(cell, [int(x) for x in args.seeds.split(",")], args.seconds,
               args.control, device, bool(args.witness))
    else:
        sweep(cell, args.seed, args.seconds,
              [float(x) for x in args.rates.split(",")], device)


if __name__ == "__main__":
    main()

"""Whether what the timed path served is right: after the window, a sample
drawn from the seed of the requests it finished, the one with the most
served tokens always in it, is run once through the plain float32
reference (perfbench/reference/) over each prompt with its served tokens;
each served token's gap is how far the reference's logit for it lies below
the reference's best.  The widest gap, or the mean gap, is held to the
cell's limit (limits/<workload>.json; PERF.md gives the readings it was set
from).

Besides: every request due in the window has to finish before the drain's
deadline without an error, and each stream has to carry the tokens that
were served.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.traffic import rng

FAMILIES = {"qwen25_vl": "reference.qwen25_vl", "aria": "reference.aria"}


def reference_module(family: str):
    import importlib

    return importlib.import_module(FAMILIES[family])


def sample(reqs: list, seed: int, min_tokens: int, max_requests: int) -> list:
    """Indices of finished requests: the longest served, then others in an
    order drawn from the seed, until `min_tokens` served tokens or
    `max_requests` requests."""
    done = [r for r in reqs if r.served is not None and len(r.served)]
    if not done:
        return []
    first = max(done, key=lambda r: (len(r.served), r.prompt_len))
    rest = [done[i] for i in rng(seed, 4).permutation(len(done))
            if done[i] is not first]
    picked, tokens = [first], len(first.served)
    for r in rest:
        if tokens >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(r)
        tokens += len(r.served)
    return [r.index for r in picked]


def items(serving, reqs: list, picked: list) -> list:
    """The reference's inputs for the picked requests: the benchmark's own
    prompt inputs and the program's served tokens."""
    out = []
    for i in picked:
        inp = dict(serving.inputs[i])
        inp["served"] = np.asarray(reqs[i].served, dtype=np.int64)
        out.append(inp)
    return out


def gap_numbers(gaps: list) -> dict:
    """The numbers a sample's gaps give: the widest, and the mean over every
    served token compared."""
    g = torch.cat(gaps)
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean())}


def served_model(cell, serving, run, seed: int) -> tuple[dict, dict]:
    """-> (checks {name: {"value", "limit"}}, facts) for a serving run.
    The cell's limits file names the gap numbers it holds (`widest_gap`,
    `mean_gap`) with their limits."""
    lim = cell.limits
    reqs = run.requests
    picked = sample(reqs, seed, lim["min_served_tokens"], lim["max_requests"])
    ref = reference_module(cell.config["family"])
    numbers, n_tokens = {"widest_gap": float("inf"), "mean_gap": float("inf")}, 0
    if picked:
        gaps = ref.served_gaps(serving.params, cell.config["model"],
                               items(serving, reqs, picked))
        numbers = gap_numbers(gaps)
        n_tokens = sum(len(g) for g in gaps)
    unfinished = sum(r.served is None or r.error is not None for r in reqs)
    checks = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items() if k in lim}
    checks["unfinished"] = {"value": unfinished, "limit": 0}
    checks["stream_mismatch"] = {"value": sum(not r.stream_ok for r in reqs), "limit": 0}
    return checks, {"compared_requests": len(picked), "compared_tokens": n_tokens,
                    **numbers}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())

"""The one traffic generator: a traffic file's parameters -> a deck of
request shapes and arrival times.

Every seed gets the same multiset of sizes and of gaps between arrivals,
dealt in another order: each field's n values are the n mid-quantiles
(i + 0.5) / n of its distribution, and the seed shuffles each field on its
own.  So seeds change which request is long and when it comes, not how much
work a run holds, and the spread between seeds measures the system, not the
draw.

A field is {"kind": "uniform_int", "low", "high"} (inclusive),
{"kind": "loguniform_int", "low", "high"}, {"kind": "choice", "values"}
(equal shares) or {"kind": "const", "value"}.  Arrivals are
{"kind": "poisson", "rate_per_s"} (exponential gaps) or {"kind": "backlog"}
(everything due at once: an offline queue).
"""

from __future__ import annotations

import math

import numpy as np


def rng(seed: int, *tags) -> np.random.Generator:
    """A generator for one purpose of one run: the seed with tags."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64] + [int(t) for t in tags]))


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The n mid-quantiles of a field's distribution, in increasing order."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["kind"]
    if kind == "uniform_int":
        lo, hi = spec["low"], spec["high"]
        return np.floor(lo + u * (hi - lo + 1)).astype(np.int64)
    if kind == "loguniform_int":
        lo, hi = math.log(spec["low"]), math.log(spec["high"] + 1)
        return np.minimum(np.floor(np.exp(lo + u * (hi - lo))),
                          spec["high"]).astype(np.int64)
    if kind == "choice":
        vals = np.asarray(spec["values"])
        return vals[np.minimum((u * len(vals)).astype(np.int64), len(vals) - 1)]
    if kind == "const":
        return np.full(n, spec["value"])
    raise ValueError(f"unknown field kind {kind!r}")


def deck(fields: dict, n: int, seed: int) -> list[dict]:
    """n request shapes: each field's quantiles, shuffled by the seed."""
    cols = {}
    for i, (name, spec) in enumerate(sorted(fields.items())):
        cols[name] = rng(seed, 1, i).permutation(quantiles(spec, n))
    return [{k: v[j].item() for k, v in cols.items()} for j in range(n)]


def arrivals(spec: dict, n: int, seed: int) -> np.ndarray:
    """(n,) due times in seconds from the window's start."""
    if spec["kind"] == "backlog":
        return np.zeros(n)
    if spec["kind"] == "poisson":
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u) / spec["rate_per_s"]
        return np.cumsum(rng(seed, 2).permutation(gaps))
    raise ValueError(f"unknown arrivals kind {spec['kind']!r}")


def request_count(traffic: dict, seconds: float) -> int:
    """Requests a run's window holds: rate x window for an open loop; for a
    backlog, `backlog_factor` times what the window is expected to serve
    (`expected_requests_per_s`), so that the queue never empties."""
    a = traffic["arrivals"]
    if a["kind"] == "poisson":
        return max(1, round(a["rate_per_s"] * seconds))
    return max(1, math.ceil(a["backlog_factor"] * a["expected_requests_per_s"]
                            * seconds))

"""What the metric readers share: the parts of a run's record that fall in
its measured window, percentiles, and the device seconds of a kernel.

A wave or a decode chunk counts when it starts and ends inside the window:
the traced window's device time may hold a part of one that straddles an
edge, so shares read a little low, never high.
"""

from __future__ import annotations

import math
import re

from counts import kernels


def percentile(values, q: float) -> float | None:
    """Nearest-rank q-th percentile (0 < q <= 100)."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def median(values) -> float | None:
    return percentile(values, 50)


def inside(record, t0: float, t1: float) -> bool:
    w0, w1 = record.window
    return w0 <= t0 and t1 <= w1


def waves(record) -> list:
    """[(t0, t1, [request index], clock)] of the waves inside the window."""
    return [w for w in record.waves if inside(record, w[0], w[1])]


def chunks(record) -> list:
    """[(t0, t1, clock0, clock1)] of the decode chunks inside the window."""
    return [c for c in record.chunks if inside(record, c[0], c[1])]


def decode_steps(record) -> list:
    """[(request, first step, steps)]: each request's decode steps that ran
    in the window's chunks (step j writes its j-th generated token)."""
    spans = [(c0, c1) for _a, _b, c0, c1 in chunks(record)]
    out = []
    for r in record.requests:
        if r.clock is None or r.served is None:
            continue
        lo, hi = r.clock, r.clock + len(r.served) - 1   # steps [lo, hi)
        for c0, c1 in spans:
            a, b = max(lo, c0), min(hi, c1)
            if b > a:
                out.append((r, a - r.clock + 1, b - a))
    return out


def kernel_s(record, pattern: str, kernel: str | None = None) -> float | None:
    """Device seconds of the operations whose names match `pattern` (a
    regular expression), or None without a trace or a match.  With
    `kernel` (the port's kernel id) the port's launch counter must show it
    launched in the window too, else the names matched something else."""
    if record.trace is None:
        return None
    if kernel is not None and not record.trace["launches"].get(kernel):
        return None
    rx = re.compile(pattern)
    s = sum(v for n, v in record.trace["device_s"].items() if rx.search(n))
    return s or None


def share(bound_s: float, measured_s: float | None) -> float | None:
    """A roofline share in %; None where nothing was measured or counted."""
    if not measured_s or not bound_s:
        return None
    return 100.0 * bound_s / measured_s


def bound_s(work) -> float:
    """Least seconds for [(bytes, ops)] calls."""
    from yardstick import roofline

    return sum(roofline(b, o)["bound_ms"] for b, o in work) / 1e3


def lm_heads(config: dict):
    from counts.models import lm_dims

    d = lm_dims(config)
    return d["H"], d["Hkv"], d["Dh"], d["L"]


def k5_work(record) -> list:
    H, Hkv, Dh, L = lm_heads(record.config)
    work = []
    for r, first, steps in decode_steps(record):
        b, o = kernels.k5_steps(r.prompt_len, steps, H, Hkv, Dh, first)
        work.append((L * b, L * o))
    return work

"""What the per-layer readers take from the port's own record: the spans
and counters `spacer_tpu_torch.utils.profiling` records while a
torch.profiler session runs, which the traced window's device trace
(harness/devtrace.py) is.  Times are the program's own perf_counter
nanoseconds, the clock of the window.

Every function gives None where there is nothing to read: an untraced run,
a tree of the port without the recorder (`last_record` missing), or no span
of the name inside the window.  A span counts when it starts and ends
inside the window, as waves and chunks do (harness/readings.py).
"""

from __future__ import annotations

from harness.readings import median, percentile


def record(run):
    """The port's record of the traced window, or None."""
    if run.trace is None:
        return None
    try:
        from spacer_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_record", None)
    return None if last is None else last()


def durations_ms(run, name: str) -> list:
    """Host ms of each span called `name` inside the window."""
    rec = record(run)
    if rec is None:
        return []
    return [1e-6 * (s.end - s.start) for s in rec.named(name, run.window)]


def median_ms(run, name: str) -> float | None:
    return median(durations_ms(run, name))


def total_ms(run, name: str) -> float | None:
    d = durations_ms(run, name)
    return sum(d) if d else None


def counted(run, name: str, under: str) -> int | None:
    """Counter `name` summed under the window's spans called `under`."""
    rec = record(run)
    if rec is None or not rec.named(under, run.window):
        return None
    return rec.counted(name, under=under, window=run.window)


def by_request(run, name: str) -> dict:
    """{request id: span} of the window's per-request spans called `name`
    (the serving loop's serve.queued, serve.first_token)."""
    rec = record(run)
    if rec is None:
        return {}
    return {s.request: s for s in rec.named(name, run.window)
            if s.request is not None}


def p90_ms(values_ns) -> float | None:
    value = percentile(list(values_ns), 90)
    return None if value is None else 1e-6 * value

"""The traced run's device record: torch.profiler over the measured window,
device activity only (kernels, copies, sets), read from the raw events,
and the port's own launch counters over the same window
(`spacer_tpu_torch.ops.launch_counts`), which the roofline readers hold the
traced kernel names against.

`summary()` gives what the metric readers and the result line take:
busy seconds (the union of device intervals), the window's length, device
seconds by operation name, and the device's idle gaps, each put under the
benchmark span the host was in when the gap began (harness/proxy.py's
spans; "queue" outside them).  The profiler's clock is matched to the
benchmark's (time.perf_counter) by whichever of the monotonic and the
wall clock puts the kernels inside the window.
"""

from __future__ import annotations

import bisect
import collections
import time

IDLE_GAP_S = 20e-6       # shorter device gaps are launch spacing, not idle


class DeviceTrace:
    """On a CPU device (the tests' rehearsals) it records the window's edges
    and no device activity."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.events: list = []   # (start_s, end_s, name) on perf_counter
        self.launches: dict = {}  # kernel id -> launches in the window
        self.t0 = self.t1 = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from spacer_tpu_torch.ops import reset_launch_counts

        if self.cuda:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        reset_launch_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        """Stops the profiler at the window's close; the events are read
        later (`summary`), once the serving thread has drained, so that the
        reading holds up no request."""
        import torch

        from spacer_tpu_torch.ops import launch_counts

        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.launches = launch_counts()
        if self.prof is not None:
            self.offsets = (time.perf_counter() - time.monotonic(),
                            time.perf_counter() - time.time())
            self.prof.__exit__(*exc)
        return False

    def _read(self):
        """The profiler's device events on the benchmark's clock."""
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            s = e.start_ns() * 1e-9
            raw.append((s, s + e.duration_ns() * 1e-9, e.name()))
        self.prof = None
        if raw:
            first = min(r[0] for r in raw)
            off = min(self.offsets, key=lambda o: abs(first + o - self.t0))
            self.events = sorted((a + off, b + off, n) for a, b, n in raw)

    def summary(self, spans: list) -> dict:
        """spans: [(name, t0, t1)] of the host -> busy_s, window_s,
        device_s {name: s}, idle {span name: s}, top gaps."""
        if self.prof is not None:
            self._read()
        w0, w1 = self.t0, self.t1
        by_name = collections.Counter()
        busy, gaps = 0.0, []
        cur_a = cur_b = None
        for a, b, n in self.events:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            by_name[n] += b - a
            if cur_b is None:
                cur_a, cur_b = a, b
                if a - w0 > IDLE_GAP_S:
                    gaps.append((w0, a))
            elif a <= cur_b:
                cur_b = max(cur_b, b)
            else:
                busy += cur_b - cur_a
                if a - cur_b > IDLE_GAP_S:
                    gaps.append((cur_b, a))
                cur_a, cur_b = a, b
        if cur_b is not None:
            busy += cur_b - cur_a
            if w1 - cur_b > IDLE_GAP_S:
                gaps.append((cur_b, w1))
        spans = sorted(spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        idle = collections.Counter()
        for a, b in gaps:
            i = bisect.bisect_right(starts, a) - 1
            name = "queue"
            if i >= 0 and spans[i][2] > a:
                name = spans[i][0]
            idle[name] += b - a
        return {"busy_s": busy, "window_s": w1 - w0, "device_s": dict(by_name),
                "idle_s": dict(idle), "n_events": len(self.events),
                "launches": self.launches}

"""Offline serving: a backlog that never empties.  The port's ServingLoop is
kept `arrivals.queue_depth` requests ahead of what it has finished (queued
and in its slots), fed in the deck's order from a backlog sized at
`backlog_factor` times what a window is expected to serve, so that it
always has a full wave to admit.  No streams: an offline caller reads whole
answers.  After the window, what was submitted is waited for and the
outputs are checked.
"""

from __future__ import annotations

import time

from harness.devtrace import DeviceTrace
from harness.serving import Serving, collect, finish_record, log

POLL_S = 0.01


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float):
    s = Serving(cell, seed, seconds, device, trace)
    with s.stopped_on_error():
        s.warm_up()
        depth = cell.traffic["arrivals"]["queue_depth"]
        setup_s = time.perf_counter() - t_start
        tracer = DeviceTrace(device.type == "cuda").__enter__() if trace else None
        t0 = time.perf_counter()
        end = t0 + seconds
        pending, submitted = [], []
        while time.perf_counter() < end:
            while len(pending) - len(s.proxy.finished) < depth:
                if len(pending) == len(s.requests):
                    raise RuntimeError(
                        f"the backlog of {len(s.requests)} requests ran out "
                        "before the window closed: raise backlog_factor or "
                        "expected_requests_per_s")
                submitted.append(time.perf_counter())
                pending.append(s.loop.submit(s.requests[len(pending)]))
            time.sleep(POLL_S)
        if tracer is not None:
            tracer.__exit__(None, None, None)
            log(f"profiler stopped {time.perf_counter() - end:.2f} s after the "
                f"close; launches in the window {tracer.launches}")
        run = collect(s, pending, submitted, list(submitted), (t0, end),
                      deadline=max(end, time.perf_counter())
                      + cell.traffic["drain_seconds"])
    return finish_record(cell, s, run, seed, setup_s, seconds, tracer)

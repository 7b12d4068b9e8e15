"""Open-loop serving: each request is submitted to the port's ServingLoop
when it is due on the traffic file's schedule, whatever the loop is doing,
with a token stream (`submit(..., stream=True)`, the path an SSE client
reads).  The window is `seconds` long; then every request due in it is
waited for (`drain_seconds` past the close at most) and the outputs are
checked.
"""

from __future__ import annotations

import time

from harness.devtrace import DeviceTrace
from harness.serving import Serving, collect, finish_record, log


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float):
    s = Serving(cell, seed, seconds, device, trace)
    with s.stopped_on_error():
        s.warm_up()
        setup_s = time.perf_counter() - t_start
        tracer = DeviceTrace(device.type == "cuda").__enter__() if trace else None
        t0 = time.perf_counter()
        due = [t0 + d for d in s.due]
        pending, submitted = [], []
        for when, req in zip(due, s.requests):
            wait = when - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            submitted.append(time.perf_counter())
            pending.append(s.loop.submit(req, stream=True))
        end = t0 + seconds
        time.sleep(max(0.0, end - time.perf_counter()))
        if tracer is not None:
            tracer.__exit__(None, None, None)
            log(f"profiler stopped {time.perf_counter() - end:.2f} s after the "
                f"close; launches in the window {tracer.launches}")
        run = collect(s, pending, submitted, due, (t0, end),
                      deadline=max(end, time.perf_counter())
                      + cell.traffic["drain_seconds"])
    return finish_record(cell, s, run, seed, setup_s, seconds, tracer)

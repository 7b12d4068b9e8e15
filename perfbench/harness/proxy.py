"""A thin timing proxy around the port's ContinuousBatcher, which the
ServingLoop drives in its place.  It forwards every attribute and records,
on the benchmark's clock (time.perf_counter), the spans of the calls the
serving thread makes into the batcher:

- `admission_wave`: admit(); in a traced run it ends with a device
  synchronize, so the span holds the wave's device work;
- `decode_chunk`: decode_chunk(), with the batcher's clock before and after
  (the steps the chunk ran);
- `stream_feed`: poll_finished() and poll_progress(), after which the loop
  puts the tokens on the streams; the first time a request shows a token
  there is when its first token reaches its stream.

Anything else the serving thread does falls between spans ("queue": waiting
for requests, or the loop's own bookkeeping).
"""

from __future__ import annotations

import threading
import time

import torch


class BatcherProxy:
    def __init__(self, batcher, sync: bool = False):
        self._b = batcher
        self._sync = sync
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        """Forget what was recorded (the warm-up's calls)."""
        self.spans: list = []         # (name, t0, t1)
        self.waves: list = []         # (t0, t1, [(tag, slot)], clock)
        self.chunks: list = []        # (t0, t1, clock0, clock1)
        self.first_token: dict = {}   # tag -> t
        self.finished: dict = {}      # tag -> (t, ServedOutput)
        self.admitted: dict = {}      # tag -> (t0 of its wave, clock)

    def __getattr__(self, name):
        return getattr(self._b, name)

    def _span(self, name, t0, t1):
        with self._lock:
            self.spans.append((name, t0, t1))

    def admit(self, admissions):
        t0 = time.perf_counter()
        clock = self._b.clock
        self._b.admit(admissions)
        if self._sync:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with self._lock:
            self.waves.append((t0, t1, [(a[0], a[3]) for a in admissions], clock))
            for a in admissions:
                self.admitted[a[0]] = (t0, clock)
        self._span("admission_wave", t0, t1)

    def decode_chunk(self):
        t0 = time.perf_counter()
        c0 = self._b.clock
        self._b.decode_chunk()
        t1 = time.perf_counter()
        with self._lock:
            self.chunks.append((t0, t1, c0, self._b.clock))
        self._span("decode_chunk", t0, t1)

    def poll_finished(self):
        t0 = time.perf_counter()
        out = self._b.poll_finished()
        t1 = time.perf_counter()
        with self._lock:
            for tag, served in out:
                self.first_token.setdefault(tag, t1)
                self.finished[tag] = (t1, served)
        self._span("stream_feed", t0, t1)
        return out

    def poll_progress(self):
        t0 = time.perf_counter()
        out = self._b.poll_progress()
        t1 = time.perf_counter()
        with self._lock:
            for tag, _row, t in out:
                if t > 0:
                    self.first_token.setdefault(tag, t1)
        self._span("stream_feed", t0, t1)
        return out

    def snapshot(self) -> dict:
        """Copies of what was recorded so far."""
        with self._lock:
            return {"spans": list(self.spans), "waves": list(self.waves),
                    "chunks": list(self.chunks),
                    "first_token": dict(self.first_token),
                    "finished": dict(self.finished),
                    "admitted": dict(self.admitted)}

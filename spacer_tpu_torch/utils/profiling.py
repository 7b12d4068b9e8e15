"""Profiling hooks (counterpart of spacer_tpu/utils/profiling.py): a
torch.profiler trace, and the program's own spans and counters.

`span(name)` times a region on the host clock (`time.perf_counter_ns`, the
clock the benchmark's window and its device trace are put on), `count(name,
n)` adds to a counter of the innermost open span, and `event(name)` marks an
instant (or, with `start_ns`, a region that began on another thread).  They
record while `recording()` is open, and while a torch.profiler session runs
(the benchmark's traced window, `trace()` below): then the record is taken
as that session's.  Otherwise `span` returns one shared no-op object after
two flag reads (this module's and torch's profiler flag), with no clock read
and no allocation, and `count` / `event` return at once.

So any torch.profiler session changes what the serving path does: the spans
that take `sync=True` (admission's) synchronize the card at their ends, and
the session's record grows by one object a span for as long as it runs; the
last record stays reachable through `last_record()` until the next begins.

A recorded span keeps its name, start and end, its parent (the innermost
span open on the same thread when it began), its thread, the request it
belongs to (`request=`: every span of one request shares the id) and its
counters.  `sync=True` synchronizes the card before the span ends, while
recording only, so that the span holds the device work it enqueued.  Inside
`trace()` each span also enters torch.profiler.record_function, so the
Chrome trace shows the program's spans beside the kernels.

`last_record()` is the record open now or closed last; `Record` answers the
questions the metrics ask (spans by name in a window, a span's path and self
time, counters summed under a span, the stretches in which each span was
the innermost one open, to put device idle gaps under).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _torch_profiler


class Span:
    """One recorded region.  `start` / `end` in perf_counter nanoseconds;
    `parent` the enclosing Span (None at a thread's top or for an event);
    `counts` {name: n} counted while it was the innermost open span."""

    __slots__ = ("record", "name", "start", "end", "parent", "thread",
                 "request", "counts", "_sync", "_annotation")

    def __init__(self, record, name: str, request, sync: bool):
        self.record, self.name, self.request = record, name, request
        self._sync = sync
        self.parent = self.counts = self._annotation = None
        self.start = self.end = None
        self.thread = threading.get_ident()

    def __enter__(self):
        stack = _stack()
        if stack and stack[-1].record is self.record:
            self.parent = stack[-1]
        stack.append(self)
        if _annotating:
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.end = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        _stack().pop()
        self.record.spans.append(self)
        return False


class _Off:
    """The shared no-op span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_local = threading.local()
_lock = threading.Lock()
_explicit = None      # the Record of the open `recording()`
_profiled = None      # the Record of the running torch.profiler session
_last = None          # the Record open now or closed last
_annotating = False   # inside `trace()`: spans enter record_function


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _current():
    """The Record spans go to now, or None (opens the record of a
    torch.profiler session that has just begun, closes that of one that has
    ended)."""
    global _profiled, _last
    if _explicit is not None:
        return _explicit
    with _lock:
        if _torch_profiler._is_profiler_enabled:
            if _profiled is None:
                _profiled = _last = Record()
            return _profiled
        if _profiled is not None:
            _profiled.closed = True
            _profiled = None
        return None


def span(name: str, *, request=None, sync: bool = False):
    """A context manager timing `name` (the shared no-op while not
    recording)."""
    if _explicit is None and not _torch_profiler._is_profiler_enabled:
        return _OFF
    record = _current()
    return _OFF if record is None else Span(record, name, request, sync)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the innermost open span on this thread
    (of the record itself outside any span)."""
    if _explicit is None and not _torch_profiler._is_profiler_enabled:
        return
    record = _current()
    if record is None:
        return
    stack = _stack()
    if stack and stack[-1].record is record:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n
    else:
        with _lock:
            record.counts[name] = record.counts.get(name, 0) + n


def event(name: str, *, request=None, start_ns: int | None = None) -> None:
    """Record an instant `name` now, or the region from `start_ns` (a
    perf_counter_ns reading, possibly on another thread) to now.  Events
    have no parent: they belong to their request, not to a thread's
    nesting."""
    if _explicit is None and not _torch_profiler._is_profiler_enabled:
        return
    record = _current()
    if record is None:
        return
    s = Span(record, name, request, False)
    s.end = time.perf_counter_ns()
    s.start = s.end if start_ns is None else start_ns
    record.spans.append(s)


def enabled() -> bool:
    """Whether spans and counters record now (to skip work that only feeds
    a counter)."""
    if _explicit is None and not _torch_profiler._is_profiler_enabled:
        return False
    return _current() is not None


@contextlib.contextmanager
def recording():
    """Record every span, counter and event of the process while open;
    yields the Record, complete once the block ends."""
    global _explicit, _last
    if _explicit is not None:
        raise RuntimeError("a recording is already open")
    record = _explicit = _last = Record()
    try:
        yield record
    finally:
        _explicit = None
        record.closed = True


def last_record():
    """The record open now or closed last (a `recording()`'s, or a
    torch.profiler session's), or None."""
    _current()
    return _last


class Record:
    """What one recording holds: `spans` (closed Spans and events, in the
    order they closed) and `counts` counted outside any span."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self.closed = False

    def named(self, name: str, window=None) -> list:
        """Spans called `name`; with window (t0, t1) in perf_counter
        seconds, those that start and end inside it."""
        out = [s for s in self.spans if s.name == name]
        if window is not None:
            lo, hi = (int(t * 1e9) for t in window)
            out = [s for s in out if lo <= s.start and s.end <= hi]
        return out

    @staticmethod
    def path(s: Span) -> str:
        """'outer/.../s' by span names."""
        names = []
        while s is not None:
            names.append(s.name)
            s = s.parent
        return "/".join(reversed(names))

    def children(self, s: Span) -> list:
        return [c for c in self.spans if c.parent is s]

    def self_ns(self, s: Span) -> int:
        """s's duration less what its children cover."""
        covered, edge = 0, s.start
        for c in sorted(self.children(s), key=lambda c: c.start):
            a, b = max(c.start, edge), min(c.end, s.end)
            if b > a:
                covered += b - a
                edge = b
        return (s.end - s.start) - covered

    def counted(self, name: str, under: str | None = None,
                window=None) -> int:
        """Counter `name` summed over the spans called `under` (inside
        `window`) and everything nested in them; over the whole record
        without `under`."""
        if under is None:
            return self.counts.get(name, 0) + sum(
                s.counts.get(name, 0) for s in self.spans if s.counts)
        roots = {id(s) for s in self.named(under, window)}
        total = 0
        for s in self.spans:
            if not s.counts or name not in s.counts:
                continue
            a = s
            while a is not None and id(a) not in roots:
                a = a.parent
            if a is not None:
                total += s.counts[name]
        return total

    def segments(self) -> list:
        """[(path, t0, t1)] in perf_counter seconds, by t0: the stretches
        in which each span was the innermost one open on its thread
        (request spans and events aside), to put a device gap under the
        segment open at its start."""
        by_thread: dict = {}
        for s in self.spans:
            if s.request is None and s.end > s.start:
                by_thread.setdefault(s.thread, []).append(s)
        out = []
        for spans in by_thread.values():
            stack = []   # [span, the time it is innermost again from]

            def close(t):
                while stack and stack[-1][0].end <= t:
                    s, a = stack.pop()
                    out.append((self.path(s), a, s.end))
                    if stack:
                        stack[-1][1] = s.end

            for s in sorted(spans, key=lambda s: (s.start, -s.end)):
                close(s.start)
                if stack:
                    out.append((self.path(stack[-1][0]), stack[-1][1], s.start))
                stack.append([s, s.start])
            close(float("inf"))
        return sorted(((p, a * 1e-9, b * 1e-9) for p, a, b in out if b > a),
                      key=lambda seg: seg[1])


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where a card is
    present, of its kernels, with the program's spans as named regions;
    written as log_dir/trace.json (Chrome trace format, viewable in
    Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    global _annotating
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _annotating = True
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        _annotating = False
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region: a program span (inside `trace()`, a region of the
    Chrome trace)."""
    return span(name)

"""Profiling hooks (counterpart of spacer_tpu/utils/profiling.py): a
torch.profiler trace, named regions in it, and per-stage wall-clock
accounting."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where a card is
    present, of its kernels; written as log_dir/trace.json (Chrome trace
    format, viewable in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region of the trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-stage wall-clock accounting (rollout/reward/update splits)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks: list[tuple[str, float]] = []

    def mark(self, name: str):
        self.marks.append((name, time.perf_counter()))

    def splits(self) -> dict[str, float]:
        out = {}
        prev = self.t0
        for name, t in self.marks:
            out[name] = t - prev
            prev = t
        return out

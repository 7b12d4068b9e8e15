"""The yardstick's fixed numbers and timing helpers, frozen here so that a
later change to the program cannot move them: the card's published peaks
(NVIDIA H100 SXM data sheet, dense bf16; at the full 700 W power limit),
and copies of chip_smoke.py's `median_ms`, `device_ms`, `roofline` and
`causal_pairs` (the kernel-alone timings a later change may use to check one
kernel at the cells' shapes).
"""

from __future__ import annotations

import collections
import statistics

BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
TIMED_RUNS = 25


def median_ms(fn) -> float:
    """Median CUDA-event time of `fn` over TIMED_RUNS calls, after 3."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, floor_ms: float = 0.0, runs: int = 10, tries: int = 3):
    """Device time per call of `fn`: the durations of the CUDA kernels (and
    copies) it launches, summed over `runs` calls under torch.profiler and
    divided by `runs`.  A reading that lost records is refused and taken
    again, up to `tries` times: one where some kernel name was recorded a
    number of times that is no multiple of `runs`, or whose total is under
    `floor_ms` (the call's roofline bound, which a whole reading cannot
    beat).  None if no try gave a whole reading."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        names, us = collections.Counter(), 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name] += 1
                us += e.time_range.elapsed_us()
        ms = us / runs / 1e3
        if names and ms >= floor_ms and all(n % runs == 0
                                            for n in names.values()):
            return ms
    return None


def roofline(nbytes: float, ops: float) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes over HBM_BYTES_PER_S and its bf16 operations over BF16_OPS_PER_S,
    and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def causal_pairs(valid_rows) -> int:
    """(query, key) pairs of a causal self-attention whose rows are
    left-padded: a row with n valid positions has n (n + 1) / 2."""
    return sum(n * (n + 1) // 2 for n in valid_rows)

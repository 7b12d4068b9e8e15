"""admit_ms (ms, batcher admission): the window's total time inside
ContinuousBatcher.admit (the ViT, the padded prefill and the slot copies;
in the traced run each wave ends with a device synchronize)."""

from harness.readings import waves


def read(record):
    w = waves(record)
    return 1e3 * sum(t1 - t0 for t0, t1, _i, _c in w) if w else None

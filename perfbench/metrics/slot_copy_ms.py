"""slot_copy_ms (ms, batcher admission): the traced window's total of the
port's `admit.slot_copy` spans: each wave's per-layer copies of the prefill
cache into its slots (quantized where the cache is int8), synchronized at
its end in the traced run."""

from harness.program import total_ms


def read(record):
    return total_ms(record, "admit.slot_copy")

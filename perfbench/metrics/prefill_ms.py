"""prefill_ms (ms, batcher admission): the traced window's total of the
port's `admit.prefill` spans: each wave's lm_forward over its unique
prompts padded to the bucket, synchronized at its end in the traced run."""

from harness.program import total_ms


def read(record):
    return total_ms(record, "admit.prefill")

"""decode_wait_ms (ms, batcher decode): median host time of the port's
`decode.done_check` spans in the traced window: the read of the done flags
before a step, in which the host waits for the steps enqueued before it."""

from harness.program import median_ms


def read(record):
    return median_ms(record, "decode.done_check")

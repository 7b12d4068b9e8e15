"""decode_launch_ms (ms, batcher decode): median host time of the port's
`decode.launch` spans in the traced window: one decode step's enqueue
(ragged_decode_step, sampling and the state updates), which never waits on
the card."""

from harness.program import median_ms


def read(record):
    return median_ms(record, "decode.launch")

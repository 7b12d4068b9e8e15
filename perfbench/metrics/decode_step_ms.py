"""decode_step_ms (ms, batcher decode): the window's time inside
decode_chunk over the clock-ring steps those chunks ran."""

from harness.readings import chunks


def read(record):
    c = chunks(record)
    steps = sum(c1 - c0 for _a, _b, c0, c1 in c)
    return 1e3 * sum(b - a for a, b, _c0, _c1 in c) / steps if steps else None

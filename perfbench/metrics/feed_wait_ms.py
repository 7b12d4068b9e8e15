"""feed_wait_ms (ms, serving loop's stream feed): median over the window's
requests of the time from the end of the admission wave that took a
request to its first token on the stream (the loop feeds streams only
after a whole decode chunk)."""

from harness.readings import median, waves


def read(record):
    ends = {i: t1 for _t0, t1, idx, _c in waves(record) for i in idx}
    gaps = [record.requests[i].first_token - t1 for i, t1 in ends.items()
            if record.requests[i].first_token is not None]
    value = median(gaps)
    return None if value is None else 1e3 * value

"""queue_wait_p90_ms (ms, serving loop): 90th percentile, over the requests
admitted inside the window, of the time from when each was due to the
start of the admission wave that took it."""

from harness.readings import percentile


def read(record):
    waits = [r.admitted - r.due for r in record.requests
             if r.admitted is not None and r.admitted <= record.window[1]]
    value = percentile(waits, 90)
    return None if value is None else 1e3 * value

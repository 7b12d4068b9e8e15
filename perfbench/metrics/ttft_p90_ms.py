"""ttft_p90_ms (ms): the 90th percentile, over every request due in the
window, of the time from when it was due to when its first token reached
its stream.  A request that failed or has no first token by the drain's
deadline counts as waiting until that deadline."""

from harness.readings import percentile


def read(record):
    deadline = record.window[1] + record.cell.traffic["drain_seconds"]
    waits = []
    for r in record.requests:
        first = r.first_token if r.error is None and r.first_token else deadline
        waits.append(first - r.due)
    return 1e3 * percentile(waits, 90)

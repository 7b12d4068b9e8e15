"""tpot_p90_ms (ms, batcher decode): 90th percentile, over the requests that
finished in the window with two tokens or more, of the mean gap between
their streamed tokens: (last token - first token) / (tokens - 1)."""

from harness.readings import percentile


def read(record):
    gaps = [(r.finish - r.first_token) / (len(r.served) - 1)
            for r in record.requests
            if r.served is not None and len(r.served) > 1 and r.first_token
            and r.finish <= record.window[1]]
    value = percentile(gaps, 90)
    return None if value is None else 1e3 * value

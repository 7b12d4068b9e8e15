"""program_queue_wait_p90_ms (ms, serving loop): 90th percentile over the
traced window's `serve.queued` spans of the port's ServingLoop: from a
request's submit to the start of the round that admits it, on the program's
clock (queue_wait_p90_ms times the same wait from the client's due time)."""

from harness.program import by_request, p90_ms


def read(record):
    return p90_ms(s.end - s.start for s in by_request(record, "serve.queued").values())

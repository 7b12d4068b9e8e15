"""program_ttft_p90_ms (ms, serving loop): 90th percentile, over the traced
window's requests the port's ServingLoop both queued and gave a first token
in it, of the time from submit (`serve.queued` start) to the first token
put on the stream (`serve.first_token`): ttft_p90_ms less the client's
submit and its read of the stream."""

from harness.program import by_request, p90_ms


def read(record):
    queued = by_request(record, "serve.queued")
    first = by_request(record, "serve.first_token")
    return p90_ms(first[i].end - queued[i].start for i in queued if i in first)

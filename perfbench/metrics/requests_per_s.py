"""requests_per_s (requests/s): requests completed inside the window over
the window's seconds (a backlog that never empties)."""


def read(record):
    end = record.window[1]
    done = sum(r.finish is not None and r.finish <= end and r.error is None
               for r in record.requests)
    return done / record.seconds

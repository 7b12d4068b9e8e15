"""pad_share (%, batcher admission): padded prompt positions over all the
prefilled positions of the window's waves (each prompt of a wave is
left-padded to the prompt bucket)."""

from harness.readings import waves


def read(record):
    bucket = record.serving["prompt_len"]
    total = real = 0
    for _t0, _t1, idx, _c in waves(record):
        total += bucket * len(idx)
        real += sum(record.requests[i].prompt_len for i in idx)
    return 100.0 * (total - real) / total if total else None

"""k5_roofline (%, LM kernels): K5 (the serving decode's ragged attention
over the slots' prompt caches and rings, with its split-K combine) least
time over its device time in the traced window; per step only the active
slots' live keys count (counts/kernels.k5_steps).  K2, which shares the
combine kernel, is not on the serving path."""

from harness.readings import bound_s, k5_work, kernel_s, share

NAME = r"k5::|decode_combine"


def read(record):
    return share(bound_s(k5_work(record)), kernel_s(record, NAME, "K5"))

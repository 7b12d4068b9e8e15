"""setup_s (s): from the process's start (the first line of run.py) to the
first timed request: imports, weights and inputs made from the seed, the
port's build or load of its kernels, the batcher, the warm-up."""


def read(record):
    return record.setup_s

"""mfu (%, whole step): the model operations the window's served tokens
require (each admitted prompt's ViT and prefill, one decode forward per
token decoded in the window; counts/models) over the traced window's
seconds times the card's bf16 peak (989 TFLOP/s at 700 W; the card's power
limit is printed beside the run)."""

from counts import models
from harness.readings import decode_steps, waves
from yardstick import BF16_OPS_PER_S


def read(record):
    if record.trace is None or not record.trace["busy_s"]:
        return None
    ops = 0.0
    for _t0, _t1, idx, _c in waves(record):
        for i in idx:
            r = record.requests[i]
            ops += models.prefill(record.config, r.prompt_len)
            if r.grid is not None:
                ops += models.vit(record.config, r.grid)
    for r, first, steps in decode_steps(record):
        ops += models.decode(record.config, r.prompt_len, steps, first)
    return 100.0 * ops / (record.trace["window_s"] * BF16_OPS_PER_S) if ops else None

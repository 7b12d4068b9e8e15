"""k4_roofline (%, ViT kernels): K4 (frame-chunk attention of the ViT's
full-attention blocks) least time over its device time in the traced
window (counts/kernels.k4_vit)."""

from counts import kernels
from harness.readings import bound_s, kernel_s, share, waves

NAME = r"k4::"


def read(record):
    vc = record.config["model"].get("vision_config")
    work = [kernels.k4_vit(record.requests[i].grid, vc)
            for _t0, _t1, idx, _c in waves(record) for i in idx
            if record.requests[i].grid is not None]
    return share(bound_s(work), kernel_s(record, NAME, "K4")) if work else None

"""k3_roofline (%, ViT kernels): K3 (window attention of the ViT's windowed
blocks) least time over its device time in the traced window; one ViT per
video request admitted (counts/kernels.k3_vit)."""

from counts import kernels
from harness.readings import bound_s, kernel_s, share, waves

NAME = r"k3::"


def read(record):
    vc = record.config["model"].get("vision_config")
    work = [kernels.k3_vit(record.requests[i].grid, vc)
            for _t0, _t1, idx, _c in waves(record) for i in idx
            if record.requests[i].grid is not None]
    return share(bound_s(work), kernel_s(record, NAME, "K3")) if work else None

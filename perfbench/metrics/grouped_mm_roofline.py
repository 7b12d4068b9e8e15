"""grouped_mm_roofline (%, MoE feed-forward): the MoE's grouped GEMMs
(torch._grouped_mm, PyTorch's CUTLASS kernel) least time over their device
time in the traced window.  Rows: each real prompt token of a wave and each
active slot's decode step, topk rows a token, every layer; bytes at least
topk experts' weights a layer and call (counts/kernels)."""

from counts import kernels
from counts.models import lm_dims
from harness.readings import bound_s, chunks, decode_steps, kernel_s, share, waves

NAME = r"cutlass.*(at::cuda::detail|2at4cuda6detail)"


def read(record):
    d = lm_dims(record.config)
    if not d["topk"]:
        return None
    wbytes = kernels.expert_bytes(d["topk"], d["D"], d["I"])
    work = []
    for _t0, _t1, idx, _c in waves(record):
        rows = d["topk"] * sum(record.requests[i].prompt_len for i in idx)
        work.append((d["L"] * wbytes, d["L"] * kernels.grouped_mm(rows, d["D"], d["I"])))
    token_steps = sum(steps for _r, _f, steps in decode_steps(record))
    n_steps = sum(c1 - c0 for _a, _b, c0, c1 in chunks(record))
    if n_steps:
        work.append((n_steps * d["L"] * wbytes,
                     d["L"] * kernels.grouped_mm(d["topk"] * token_steps, d["D"], d["I"])))
    return share(bound_s(work), kernel_s(record, NAME))

"""k1_roofline (%, LM kernels): K1's least time over its device time in the
traced window.  K1 runs the prefill's attention: per admission wave and
layer one call over the wave's left-padded prompts; the bound counts the
real tokens' visible pairs only (counts/kernels.k1_prefill)."""

from counts import kernels
from harness.readings import bound_s, kernel_s, lm_heads, share, waves

NAME = r"k1fwd::"


def read(record):
    H, Hkv, Dh, L = lm_heads(record.config)
    work = []
    for _t0, _t1, idx, _c in waves(record):
        b, o = kernels.k1_prefill([record.requests[i].prompt_len for i in idx],
                                  H, Hkv, Dh)
        work.append((L * b, L * o))
    return share(bound_s(work), kernel_s(record, NAME, "K1"))

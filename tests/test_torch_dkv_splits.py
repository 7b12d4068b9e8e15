"""The dk/dv kernel's split rule (ops/flash_attention.py::dkv_splits): how
many CTAs share each (key tile, kv head)'s GQA group of q heads.  Pure
arithmetic, so it runs on the CPU."""

import pytest

from spacer_tpu_torch.ops.flash_attention import dkv_splits

KEYS = 128   # keys per CTA of the dk/dv kernel (csrc/flash_attention_bwd.cu)


@pytest.mark.parametrize("B,Skv,Hq,Hkv,want", [
    (1, 1536, 28, 4, 4),     # the update's prompt pass: 48 CTAs -> 4 x 2 heads (last 1)
    (8, 1792, 28, 4, 1),     # its completion pass: 448 CTAs fill 132 SMs already
    (2, 1024, 28, 4, 4),     # a two-prompt batch: 64 CTAs
    (2, 300, 28, 4, 7),      # few key tiles: one CTA per q head
    (1, 128, 8, 8, 1),       # no GQA: nothing to split
])
def test_dkv_splits(B, Skv, Hq, Hkv, want):
    assert dkv_splits(B, Skv, Hq, Hkv, 132, KEYS) == want


@pytest.mark.parametrize("Hq,Hkv", [(28, 4), (14, 2), (8, 2), (12, 4)])
def test_dkv_splits_share_heads_evenly(Hq, Hkv):
    group = Hq // Hkv
    for Skv in (64, 640, 4096, 40000):
        splits = dkv_splits(1, Skv, Hq, Hkv, 132, KEYS)
        per_split = -(-group // splits)
        assert 1 <= splits <= group
        # every split gets heads, and no two splits differ by more than
        # the remainder of the last
        assert (splits - 1) * per_split < group <= splits * per_split

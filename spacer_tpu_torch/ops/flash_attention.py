"""K1: flash attention forward on Hopper (csrc/flash_attention.cu).

Replaces the Pallas kernel spacer_tpu/ops/flash_attention.py::flash_attention
(`_flash_fwd_impl` / `_fwd_kernel`) on the LM prefill.  Same contract and
layout as the plain version `nn.attention.xla_attention`: q (B, Sq, Hq, D),
k/v (B, Skv, Hkv, D), causal with a static `q_offset`, a (B, Skv) `kv_mask`,
optional segment ids, GQA.  The kernel also writes the (B, Hq, Sq) f32 LSE.

Bound on the H100: tensor-core flops at prefill lengths (~P/2 flops per
K/V byte).  The kernel tiles 64 queries x 64 keys per step on WMMA bf16
MMAs with f32 accumulation and an online softmax (see the .cu note).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `flash_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.nn.attention import xla_attention
from spacer_tpu_torch.ops import _build

HEAD_DIMS = (128,)


def _check(q, k, v, kv_mask, q_segment_ids, kv_segment_ids, q_offset):
    """Hopper legality gate of K1 (raises ValueError)."""
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes bf16, got {q.dtype}")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)} / {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Hq % k.shape[2]:
        raise ValueError("Hq must be a multiple of Hkv")
    if not isinstance(q_offset, int):
        raise ValueError("q_offset must be a Python int")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids or none")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for t in (k, v, kv_mask, q_segment_ids, kv_segment_ids):
        if t is not None and t.device != q.device:
            raise ValueError("all inputs must be on q's device")


def flash_attention(q, k, v, *, causal: bool = False, q_segment_ids=None,
                    kv_segment_ids=None, kv_mask=None, scale=None,
                    q_offset: int = 0, return_lse: bool = False):
    """Returns out (B, Sq, Hq, D), or (out, lse) with `return_lse`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return xla_attention(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, kv_mask=kv_mask, scale=scale,
            q_offset=q_offset, return_lse=return_lse)
    _check(q, k, v, kv_mask, q_segment_ids, kv_segment_ids, q_offset)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    valid = (None if kv_mask is None
             else kv_mask.reshape(B, Skv).to(torch.uint8).contiguous())
    q_seg = (None if q_segment_ids is None
             else q_segment_ids.reshape(B, Sq).to(torch.int32).contiguous())
    kv_seg = (None if kv_segment_ids is None
              else kv_segment_ids.reshape(B, Skv).to(torch.int32).contiguous())
    p = _build.ptr
    err = _build.kernels().spacer_flash_attention_fwd(
        p(q), p(k), p(v), p(out), p(lse), p(valid), p(q_seg), p(kv_seg),
        B, Sq, Skv, Hq, Hkv, D, int(bool(causal)), q_offset, float(scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0

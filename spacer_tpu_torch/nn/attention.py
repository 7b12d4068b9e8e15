"""Attention (counterpart of spacer_tpu/nn/attention.py).

`xla_attention` is the plain PyTorch version: float32 logits and softmax,
GQA without materialising repeated K/V.  It is the CPU path and the oracle
of the hand-written kernel K1 (ops/flash_attention.py).
`dot_product_attention` dispatches on the tensors' device only: CPU tensors
take the plain version, CUDA tensors take K1 or raise.  There is no silent
fallback between the two.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def xla_attention(q, k, v, *, causal=False, q_segment_ids=None,
                  kv_segment_ids=None, kv_mask=None, scale=None, q_offset=0,
                  return_lse: bool = False):
    """q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D).

    - `causal`: query i attends to keys j <= i + q_offset;
    - `q_segment_ids` / `kv_segment_ids`: (B, S) int, attention only within
      equal ids;
    - `kv_mask`: (B, Skv) bool, False keys are masked out.
    Masked logits are -1e30 (finite), so a fully masked row is the mean of V.
    With `return_lse` also returns the (B, Hq, Sq) f32 log-sum-exp.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    dev = q.device

    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        qpos = torch.arange(sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(skv, device=dev)[None, :]
        mask = mask & (kpos <= qpos)[None]
    if kv_mask is not None:
        mask = mask & kv_mask.bool()[:, None, :]
    if q_segment_ids is not None and kv_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])

    qg = q.reshape(b, sq, hkv, group, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=dev))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    out = out.reshape(b, sq, hq, d).to(q.dtype)
    if return_lse:
        lse = torch.logsumexp(logits, dim=-1).reshape(b, hq, sq)
        return out, lse
    return out


def dot_product_attention(q, k, v, *, causal=False, q_segment_ids=None,
                          kv_segment_ids=None, kv_mask=None, scale=None,
                          q_offset=0):
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    from spacer_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, kv_mask=kv_mask, scale=scale,
        q_offset=q_offset,
    )

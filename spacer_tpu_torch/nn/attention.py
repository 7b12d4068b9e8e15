"""Attention (counterpart of spacer_tpu/nn/attention.py).

`xla_attention` is the plain PyTorch version: float32 logits and softmax,
GQA without materialising repeated K/V.  It is the CPU path and the oracle
of the hand-written kernel K1 (ops/flash_attention.py).
`dot_product_attention` dispatches on the tensors' device only: CPU tensors
take the plain version, CUDA tensors take K1 or raise.  There is no silent
fallback between the two.  Its one accepted `impl` is JAX's sequence-parallel
tuple ("ring", mesh, axis) (ops/ring_attention.py), which applies where JAX
applies it: self-attention (Sq == Skv) at q_offset 0 without segment ids;
any other call takes the device's path, as JAX's does.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def visible(q, k, *, causal=False, q_segment_ids=None, kv_segment_ids=None,
            kv_mask=None, q_offset=0):
    """(B, Sq, Skv) bool: which keys each query row sees (xla_attention's
    masks)."""
    b, sq, skv, dev = q.shape[0], q.shape[1], k.shape[1], q.device
    mask = torch.ones((b, sq, skv), dtype=torch.bool, device=dev)
    if causal:
        qpos = torch.arange(sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(skv, device=dev)[None, :]
        mask = mask & (kpos <= qpos)[None]
    if kv_mask is not None:
        mask = mask & kv_mask.bool()[:, None, :]
    if q_segment_ids is not None and kv_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    return mask


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
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    dev = q.device
    mask = visible(q, k, causal=causal, q_segment_ids=q_segment_ids,
                   kv_segment_ids=kv_segment_ids, kv_mask=kv_mask,
                   q_offset=q_offset)

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


def ring_impl(impl):
    """(mesh, axis) of a ("ring", mesh, axis) impl; None for impl None.
    Every other value raises (the strings "xla" and "pallas" are not
    ported: the device picks the path)."""
    if impl is None:
        return None
    if isinstance(impl, tuple) and len(impl) == 3 and impl[0] == "ring":
        return impl[1], impl[2]
    raise ValueError(f"attn_impl {impl!r}: the port takes None or "
                     "('ring', mesh, axis)")


def dot_product_attention(q, k, v, *, causal=False, q_segment_ids=None,
                          kv_segment_ids=None, kv_mask=None, scale=None,
                          q_offset=0, impl=None):
    """K1 on CUDA tensors, the plain version on CPU tensors; with impl
    ("ring", mesh, axis) ring attention over that mesh axis where it
    applies (self-attention at q_offset 0 without segment ids)."""
    from spacer_tpu_torch.ops.flash_attention import flash_attention

    ring = ring_impl(impl)
    if (ring is not None and q_segment_ids is None
            and q.shape[1] == k.shape[1] and q_offset == 0):
        from spacer_tpu_torch.ops.ring_attention import make_ring_attention

        fn = make_ring_attention(*ring, causal=causal)
        return fn(q, k, v, kv_mask, scale=scale)

    return flash_attention(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, kv_mask=kv_mask, scale=scale,
        q_offset=q_offset,
    )

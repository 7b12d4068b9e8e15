"""K1: flash attention on Hopper, forward (csrc/flash_attention.cu) and
backward (csrc/flash_attention_bwd.cu).

Replaces the Pallas kernel spacer_tpu/ops/flash_attention.py::flash_attention
(`_flash_fwd_impl` / `_fwd_kernel`, and the custom VJP `_flash_bwd` with its
dq and dk/dv kernels) on the LM's prefill and training forwards.  Same
contract and layout as the plain version `nn.attention.xla_attention`:
q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), causal with a static `q_offset`, a
(B, Skv) `kv_mask`, optional segment ids, GQA.  The forward also writes the
(B, Hq, Sq) f32 LSE, which the backward reads.

On a CUDA tensor `flash_attention` is a torch.autograd.Function: its forward
launches the forward kernel and saves (q, k, v, out, lse); its backward
launches the dq and dk/dv kernels (the counts of `flash_attention_bwd_dq`
and `flash_attention_bwd_dkv`).  The backward's delta = rowsum(dout * out)
stays a torch op, as the TPU wrapper computes it outside Pallas, once per
backward for both kernels.  The plain versions of the two backward kernels
are autograd through `xla_attention` (`attention_bwd_reference`).

Both backward kernels read the LSE and delta as arguments, so they also take
statistics that are not the block's own: `flash_attention_bwd_dq_from_stats`
and `flash_attention_bwd_dkv_from_stats` take an external (B, Hq, Sq) f32
`lse` (natural log, the unit the forward writes) and `delta`.  Ring attention
(ops/ring_attention.py) runs them on each sequence block with the merged
LSE and delta of all blocks.  Their plain version is
`attention_bwd_from_stats`, the backward written out from the statistics
(autograd through `xla_attention` equals it only at the block's own).

All three kernels take head_dim 128 (the LMs), 80 (the Qwen ViTs'
full-attention blocks under ring attention, 1280 / 16 heads) and 72 (the
Aria vision tower and its projector, 1152 / 16 heads: the D = 80 tile whose
last 8 columns TMA fills with zeros).  (The JAX package's gradient at 72 and
80 is XLA's: its Pallas kernel refuses D % 128 != 0.)

Bound on the H100: tensor-core flops at prefill lengths (~P/2 flops per
K/V byte).  All three kernels run on wgmma with TMA-fed rings and their
accumulators in registers (csrc/sm90.cuh; see the .cu notes).  dk/dv splits
each GQA group's q heads over `dkv_splits` CTAs when one CTA per (key tile,
kv head) would leave the card idle, and sums their f32 partials in a fixed
order.

A row that sees no key (a left pad, under a kv_mask or segment ids) is the
mean of V over every key, as the plain version gives it (its finite mask)
and JAX does: the kernel writes the mean the wrapper computes, and the
autograd backward adds its gradient to dv (`no_key_dv`).  Pads reach live
rows through a capacity MoE (they route and take capacity) and through
SFT's last pad position, which predicts the first real token.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its kernel launches in `.launches`, and
per head_dim in `.by_head_dim` ({D: launches}, the same launches counted
by the instantiation they ran).
"""

from __future__ import annotations

from collections import Counter

import torch

from spacer_tpu_torch.nn.attention import NEG_INF, visible, xla_attention
from spacer_tpu_torch.ops import _build

# head dims of the forward and both backward kernels
HEAD_DIMS = (72, 80, 128)


def dkv_splits(B: int, Skv: int, Hq: int, Hkv: int, sms: int,
               keys_per_cta: int) -> int:
    """CTAs the dk/dv kernel gives each (key tile of `keys_per_cta`, kv
    head): enough to put about two CTAs on each of `sms` SMs, at most one
    per q head of the group, with the heads shared out evenly."""
    group = Hq // Hkv
    ctas = B * Hkv * -(-Skv // keys_per_cta)
    want = max(1, min(group, -(-2 * sms // ctas)))
    per_split = -(-group // want)
    return -(-group // per_split)


def dkv_split_count(q, k) -> int:
    """`dkv_splits` for a dk/dv call on these CUDA tensors: the card's SM
    count and the kernel's own key tile."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return dkv_splits(k.shape[0], k.shape[1], q.shape[2], k.shape[2], sms,
                      _build.kernels().spacer_flash_attention_bwd_dkv_keys())


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


def _mask_args(q, k, kv_mask, q_segment_ids, kv_segment_ids):
    """(valid uint8 (B, Skv), q_seg int32 (B, Sq), kv_seg int32 (B, Skv)),
    each contiguous or None, as the kernels read them."""
    B, Sq, Skv = q.shape[0], q.shape[1], k.shape[1]
    valid = None
    if kv_mask is not None:   # a bool mask is read as its bytes, no copy
        valid = kv_mask.reshape(B, Skv)
        valid = (valid.view(torch.uint8) if valid.dtype == torch.bool
                 else valid.to(torch.uint8)).contiguous()
    q_seg = (None if q_segment_ids is None
             else q_segment_ids.reshape(B, Sq).to(torch.int32).contiguous())
    kv_seg = (None if kv_segment_ids is None
              else kv_segment_ids.reshape(B, Skv).to(torch.int32).contiguous())
    return valid, q_seg, kv_seg


def _launch_fwd(q, k, v, masks, causal, q_offset, scale):
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    # with a mask (only then can a row see no key) such rows write V's mean
    v_mean = (v.mean(dim=1, dtype=torch.float32)
              if any(m is not None for m in masks) else None)
    p = _build.ptr
    err = _build.kernels().spacer_flash_attention_fwd(
        p(q), p(k), p(v), p(out), p(lse), *(p(m) for m in masks), p(v_mean),
        B, Sq, Skv, Hq, Hkv, D, int(bool(causal)), q_offset, float(scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.by_head_dim[D] += 1
    return out, lse


def no_key_rows(out, lse, v_mean):
    """`out` (B, Sq, Hq, D) with its rows that saw no key (LSE at NEG_INF)
    set to `v_mean` (B, Hkv, D) f32, the mean of V over every key of their
    kv head: the plain version's value for such a row (xla_attention's
    finite mask; JAX's), which the kernel writes itself (given V's mean);
    ring attention sets a merge's rows with it."""
    # the mask in out's (B, Sq, Hq) layout, so the result keeps out's
    # contiguous layout
    dead = (lse <= NEG_INF / 2).transpose(1, 2).contiguous()[..., None]
    mean = v_mean.repeat_interleave(out.shape[2] // v_mean.shape[1], dim=1)
    return torch.where(dead, mean[:, None].to(out.dtype), out)


def no_key_dv(dout, lse, hkv: int, skv: int):
    """The gradient of the rows that saw no key (V's mean, see no_key_rows)
    in each key's dv: their dout summed over each kv head's q heads, / skv
    -> (B, 1, Hkv, D) f32, the same for every key.  (Such a row's P is 0
    in the backward kernels, which see no visible key for it.)"""
    B, _, H, D = dout.shape
    dead = (lse <= NEG_INF / 2).transpose(1, 2)[..., None]
    return (torch.where(dead, dout, 0).sum(dim=1, dtype=torch.float32)
            .view(B, hkv, H // hkv, D).sum(dim=2)[:, None] / skv)


class _FlashAttentionFn(torch.autograd.Function):
    """K1 forward kernel; backward = the dq and dk/dv kernels.  With a mask
    (kv_mask or segment ids: only then can a row see no key) the rows that
    see none are V's mean (the kernel writes it), whose gradient joins
    dv."""

    @staticmethod
    def forward(ctx, q, k, v, valid, q_seg, kv_seg, causal, q_offset, scale):
        masks = (valid, q_seg, kv_seg)
        out, lse = _launch_fwd(q, k, v, masks, causal, q_offset, scale)
        ctx.masked = valid is not None or q_seg is not None
        ctx.save_for_backward(q, k, v, out, lse, *masks)
        ctx.kw = dict(causal=causal, q_offset=q_offset, scale=scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, *masks = ctx.saved_tensors
        dout = dout.contiguous()
        delta = _delta(out, dout)
        dq = _launch_dq(q, k, v, dout, lse, delta, masks, **ctx.kw)
        dk, dv = _launch_dkv(q, k, v, dout, lse, delta, masks, **ctx.kw)
        if ctx.masked:
            dv = (dv.float() + no_key_dv(dout, lse, k.shape[2], k.shape[1])
                  ).to(dv.dtype)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, q_segment_ids=None,
                    kv_segment_ids=None, kv_mask=None, scale=None,
                    q_offset: int = 0, return_lse: bool = False):
    """Returns out (B, Sq, Hq, D), or (out, lse) with `return_lse`.
    Differentiable in q, k and v on either device."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.takes_plain(q, "K1"):
        return xla_attention(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, kv_mask=kv_mask, scale=scale,
            q_offset=q_offset, return_lse=return_lse)
    _check(q, k, v, kv_mask, q_segment_ids, kv_segment_ids, q_offset)
    masks = _mask_args(q, k, kv_mask, q_segment_ids, kv_segment_ids)
    out, lse = _FlashAttentionFn.apply(q, k, v, *masks, bool(causal), q_offset,
                                       float(scale))
    return (out, lse) if return_lse else out


def attention_bwd_reference(q, k, v, dout, *, causal: bool = False,
                            q_segment_ids=None, kv_segment_ids=None,
                            kv_mask=None, scale=None, q_offset: int = 0):
    """Plain version of the backward: (dq, dk, dv) by autograd through
    `xla_attention` (f32 logits and softmax)."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = xla_attention(qd, kd, vd, causal=causal,
                            q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids, kv_mask=kv_mask,
                            scale=scale, q_offset=q_offset)
        return torch.autograd.grad(out, (qd, kd, vd), dout)


def attention_bwd_from_stats(q, k, v, dout, lse, delta, *, causal=False,
                             q_segment_ids=None, kv_segment_ids=None,
                             kv_mask=None, scale=None, q_offset: int = 0):
    """Plain version of the backward from given statistics -> (dq, dk, dv)
    in the inputs' dtype, computed in f32: P = exp(s * scale - lse) on the
    visible keys (0 elsewhere, as in the kernels), dv = P^T dout, dS = P *
    (dout v^T - delta), dq = scale dS k, dk = scale dS^T q summed over each
    kv head's q heads.  lse and delta are (B, Hq, Sq) f32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    mask = visible(q, k, causal=causal, q_segment_ids=q_segment_ids,
                   kv_segment_ids=kv_segment_ids, kv_mask=kv_mask,
                   q_offset=q_offset)[:, None, None]
    qg = q.reshape(b, sq, hkv, group, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    stat = lambda t: t.float().reshape(b, hkv, group, sq, 1)  # noqa: E731
    p = torch.where(mask, torch.exp(s - stat(lse)), 0.0)
    do = dout.reshape(b, sq, hkv, group, d).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, vf) - stat(delta))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _delta(out, dout):
    """delta = rowsum(dout * out), (B, Hq, Sq) f32 like the LSE.  The
    product is taken in f32 in place in dout's f32 copy, reading out as bf16
    (no f32 copy of out, no third tensor; an f32 dout is copied, not
    overwritten)."""
    return (dout.to(torch.float32, copy=True).mul_(out).sum(-1)
            .transpose(1, 2).contiguous())


def _bwd_args(q, k, v, out, lse, dout, kv_mask, q_segment_ids,
              kv_segment_ids, q_offset):
    """Checks of a public backward call -> (lse, delta, masks)."""
    _check(q, k, v, kv_mask, q_segment_ids, kv_segment_ids, q_offset)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor of q's shape")
    B, Sq, Hq, _ = q.shape
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError("lse must be the forward's (B, Hq, Sq) f32 LSE")
    masks = _mask_args(q, k, kv_mask, q_segment_ids, kv_segment_ids)
    return lse.contiguous(), _delta(out, dout), masks


def _stats_args(q, k, v, dout, lse, delta, kv_mask, q_segment_ids,
                kv_segment_ids, q_offset):
    """Checks of a backward call from given statistics -> (lse, delta,
    masks)."""
    _check(q, k, v, kv_mask, q_segment_ids, kv_segment_ids, q_offset)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must be a bf16 tensor of q's shape")
    B, Sq, Hq, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, Hq, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (B, Hq, Sq) f32")
        if t.device != q.device:
            raise ValueError("all inputs must be on q's device")
    masks = _mask_args(q, k, kv_mask, q_segment_ids, kv_segment_ids)
    return lse.contiguous(), delta.contiguous(), masks


def _launch_dq(q, k, v, dout, lse, delta, masks, *, causal, q_offset, scale):
    B, Sq, Hq, D = q.shape
    dq = torch.empty_like(q)
    p = _build.ptr
    err = _build.kernels().spacer_flash_attention_bwd_dq(
        p(q), p(k), p(v), p(dout), p(lse), p(delta), p(dq),
        *(p(m) for m in masks), B, Sq, k.shape[1], Hq, k.shape[2], D,
        int(bool(causal)), q_offset, float(scale), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.by_head_dim[D] += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, masks, *, causal, q_offset, scale):
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    splits = dkv_split_count(q, k)
    # f32 partial sums of dk and dv per split, summed in split order
    partial = (torch.empty((2, splits) + tuple(k.shape), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    p = _build.ptr
    err = _build.kernels().spacer_flash_attention_bwd_dkv(
        p(q), p(k), p(v), p(dout), p(lse), p(delta), p(dk), p(dv), p(partial),
        *(p(m) for m in masks), B, Sq, Skv, Hq, Hkv, D,
        int(bool(causal)), q_offset, splits, float(scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.by_head_dim[D] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, out, lse, dout, *, causal: bool = False,
                           q_segment_ids=None, kv_segment_ids=None,
                           kv_mask=None, scale=None, q_offset: int = 0):
    """K1-bwd dq (replaces `_bwd_dq_kernel`): dq (B, Sq, Hq, D) from the
    forward's out and lse and the output gradient dout."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.takes_plain(q, "K1-bwd dq"):
        return attention_bwd_reference(
            q, k, v, dout, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, kv_mask=kv_mask, scale=scale,
            q_offset=q_offset)[0]
    lse, delta, masks = _bwd_args(q, k, v, out, lse, dout, kv_mask,
                                  q_segment_ids, kv_segment_ids, q_offset)
    return _launch_dq(q, k, v, dout, lse, delta, masks, causal=causal,
                      q_offset=q_offset, scale=scale)


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, *, causal: bool = False,
                            q_segment_ids=None, kv_segment_ids=None,
                            kv_mask=None, scale=None, q_offset: int = 0):
    """K1-bwd dk/dv (replaces `_bwd_dkv_kernel` and the GQA group sum):
    (dk, dv), each (B, Skv, Hkv, D), summed over each kv head's q heads."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.takes_plain(q, "K1-bwd dkv"):
        return attention_bwd_reference(
            q, k, v, dout, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, kv_mask=kv_mask, scale=scale,
            q_offset=q_offset)[1:]
    lse, delta, masks = _bwd_args(q, k, v, out, lse, dout, kv_mask,
                                  q_segment_ids, kv_segment_ids, q_offset)
    return _launch_dkv(q, k, v, dout, lse, delta, masks, causal=causal,
                       q_offset=q_offset, scale=scale)


def flash_attention_bwd_dq_from_stats(q, k, v, dout, lse, delta, *,
                                      causal: bool = False,
                                      q_segment_ids=None, kv_segment_ids=None,
                                      kv_mask=None, scale=None,
                                      q_offset: int = 0):
    """K1-bwd dq from given statistics: dq (B, Sq, Hq, D) of this block of
    keys, with P = exp(s * scale - lse) under the given `lse` and dS = P *
    (dP - delta) under the given `delta` (each (B, Hq, Sq) f32).  Counts
    under `flash_attention_bwd_dq.launches`, the kernel's count."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.takes_plain(q, "K1-bwd dq"):
        return attention_bwd_from_stats(
            q, k, v, dout, lse, delta, causal=causal,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            kv_mask=kv_mask, scale=scale, q_offset=q_offset)[0]
    lse, delta, masks = _stats_args(q, k, v, dout, lse, delta, kv_mask,
                                    q_segment_ids, kv_segment_ids, q_offset)
    return _launch_dq(q, k, v, dout.contiguous(), lse, delta, masks,
                      causal=causal, q_offset=q_offset, scale=scale)


def flash_attention_bwd_dkv_from_stats(q, k, v, dout, lse, delta, *,
                                       causal: bool = False,
                                       q_segment_ids=None,
                                       kv_segment_ids=None, kv_mask=None,
                                       scale=None, q_offset: int = 0):
    """K1-bwd dk/dv from given statistics (as the dq entry): (dk, dv),
    each (B, Skv, Hkv, D), summed over each kv head's q heads.  Counts
    under `flash_attention_bwd_dkv.launches`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _build.takes_plain(q, "K1-bwd dkv"):
        return attention_bwd_from_stats(
            q, k, v, dout, lse, delta, causal=causal,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            kv_mask=kv_mask, scale=scale, q_offset=q_offset)[1:]
    lse, delta, masks = _stats_args(q, k, v, dout, lse, delta, kv_mask,
                                    q_segment_ids, kv_segment_ids, q_offset)
    return _launch_dkv(q, k, v, dout.contiguous(), lse, delta, masks,
                       causal=causal, q_offset=q_offset, scale=scale)


for _fn in (flash_attention, flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _fn.launches, _fn.by_head_dim = 0, Counter()

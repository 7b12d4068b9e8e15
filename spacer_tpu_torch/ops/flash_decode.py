"""Decode attention on Hopper: K5 ragged clock-ring serving decode
(csrc/flash_decode.cu) and K2 shared-prefix grouped rollout decode
(csrc/flash_decode_grouped.cu).  Both are inference-only: they raise if
asked to run where autograd would need their gradient.

K5 replaces spacer_tpu/ops/flash_decode.py::flash_ragged_decode_attention
(`_ragged_kernel`), bf16 branch, on every decode step of every layer of the
serving path.  Head-major layout as in JAX: q (R, Hkv, group_q, Dh), prompt
prefix pk/pv (R, Hkv, Pmax, Dh), completion ring tk/tv (R, Hkv, Cmax, Dh),
additive f32 window biases bias_p (R, 1, Pmax) / bias_t (R, 1, Cmax).
Output (R, Hkv, group_q, Dh) f32.

Bound on the H100: K/V bytes (one query token per row).  Split-K in two
launches (see the .cu note): one CTA per job of 64 keys of a (slot row, kv
head), which serves all group_q query heads from one read of those keys, so
even 4 slots fill the card (the job is csrc/decode_job.cuh, shared with
K2's tail jobs); a job whose keys are all dead reads no K or V; a combine
pass folds the jobs' partial outputs (scratch allocated here, sized by the
kernel's job) in a fixed order.  A row with no live key (an empty slot)
comes out 0, where the plain version gives the mean of V; callers discard
such rows.

K2 replaces spacer_tpu/ops/flash_decode.py::flash_decode_attention
(`_kernel`), bf16 branch, on every decode step of every layer of the grouped
rollout sampler.  Head-major layout as in JAX: q (B, Hkv, G*group_q, Dh)
(row g*group_q + c is q head h*group_q + c of completion row b*G + g),
prefix pk/pv (B, Hkv, P, Dh) shared by the G completions of prompt b,
additive f32 prefix bias (B, 1, P), per-row tails tk/tv (B*G, Hkv, T, Dh) of
which the first `step` positions are live.  Output (B, Hkv, G*group_q, Dh)
f32, any G*group_q (group_q <= 8).  Bound on the H100: K/V bytes; the prefix
is read once per 64 query rows (once per group at G*group_q <= 64) and dead
tail space not at all.  Split-K over 64-key jobs in two launches (see the
.cu note): prefix jobs on wgmma with TMA loads (a chunk whose keys are all
padding reads nothing), tail jobs on K5's job code, then the combine pass.

K2-int8 and K5-int8 replace the same TPU kernels' `quant=True` branches
(decode_quant "int8_kv" / "int4_kv"): the caches hold int8 codes with f32
per-key scales (ops/quant.py::quantize_kv), pk_scale/pv_scale of the prefix
shape with Dh -> 1 ((B, Hkv, 1, P) / (R, Hkv, 1, Pmax)) and tk_scale/tv_scale
likewise.  K scales multiply the f32 logits, V scales the probabilities
after the softmax and before their cast and P.V; the softmax denominator
sums the unscaled probabilities.  `flash_decode_attention` and
`flash_ragged_decode_attention` take the scales (None = bf16 caches) and
hand int8 caches to `flash_decode_attention_int8` /
`flash_ragged_decode_attention_int8`.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  Each kernel's wrapper counts its launches in `.launches`.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.ops import _build

MASK_VALUE = -1e30
HEAD_DIMS = (128,)
GROUP_Q_MAX = 8


def ragged_decode_attention_reference(q, pk, pv, bias_p, tk, tv, bias_t,
                                      pk_scale=None, pv_scale=None,
                                      tk_scale=None, tv_scale=None, *,
                                      group_q: int, sm_scale: float):
    """Plain version (spacer_tpu's ragged_decode_attention_reference): one
    softmax over [prefix | ring] per query head, f32 logits (times the K
    scales), probabilities times the V scales, rounded to q's dtype before
    P.V."""
    cdt = q.dtype
    qf = q.float()
    lp = torch.einsum("rhgd,rhpd->rhgp", qf, pk.to(cdt).float()) * sm_scale
    lt = torch.einsum("rhgd,rhtd->rhgt", qf, tk.to(cdt).float()) * sm_scale
    if pk_scale is not None:
        lp = lp * pk_scale
        lt = lt * tk_scale
    lp = lp + bias_p[:, :, None, :]
    lt = lt + bias_t[:, :, None, :]
    P = pk.shape[2]
    probs = torch.softmax(torch.cat([lp, lt], dim=-1), dim=-1)
    probs_p, probs_t = probs[..., :P], probs[..., P:]
    if pv_scale is not None:
        probs_p = probs_p * pv_scale
        probs_t = probs_t * tv_scale
    return (torch.einsum("rhgp,rhpd->rhgd", probs_p.to(cdt).float(),
                         pv.to(cdt).float())
            + torch.einsum("rhgt,rhtd->rhgd", probs_t.to(cdt).float(),
                           tv.to(cdt).float()))


def _check_caches(q, pk, pv, tk, tv, scales):
    """bf16 q; caches bf16 without scales, or int8 codes with f32 scales of
    the caches' shape with Dh -> 1, contiguous on q's device."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16, got {q.dtype}")
    quant = scales[0] is not None
    if any((s is not None) != quant for s in scales):
        raise ValueError("pass all four scales (int8 caches) or none (bf16)")
    code = torch.int8 if quant else torch.bfloat16
    for name, t in (("pk", pk), ("pv", pv), ("tk", tk), ("tv", tv)):
        if t.dtype != code:
            raise ValueError(f"{name} must be {code} with"
                             f"{'' if quant else 'out'} scales, got {t.dtype}")
    if quant:
        for name, s, c in zip(("pk_scale", "pv_scale", "tk_scale", "tv_scale"),
                              scales, (pk, pv, tk, tv)):
            if (s.dtype != torch.float32
                    or s.shape != (*c.shape[:2], 1, c.shape[2])):
                raise ValueError(f"{name} must be f32 of shape "
                                 f"{(*c.shape[:2], 1, c.shape[2])}")
    for name, t in (("pk", pk), ("pv", pv), ("tk", tk), ("tv", tv),
                    *zip(("pk_scale", "pv_scale", "tk_scale", "tv_scale"),
                         scales)):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on q's device")


def _check(q, pk, pv, bias_p, tk, tv, bias_t, group_q, scales):
    """Hopper legality gate of K5 / K5-int8 (raises ValueError)."""
    R, Hkv, gq, Dh = q.shape
    if gq != group_q or not 1 <= gq <= GROUP_Q_MAX:
        raise ValueError(f"group_q {gq} must match and be <= {GROUP_Q_MAX}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    _check_caches(q, pk, pv, tk, tv, scales)
    if pk.shape != pv.shape or pk.shape[:2] != (R, Hkv) or pk.shape[3] != Dh:
        raise ValueError(f"bad prefix shape {tuple(pk.shape)}")
    if tk.shape != tv.shape or tk.shape[:2] != (R, Hkv) or tk.shape[3] != Dh:
        raise ValueError(f"bad ring shape {tuple(tk.shape)}")
    if bias_p.shape != (R, 1, pk.shape[2]) or bias_t.shape != (R, 1, tk.shape[2]):
        raise ValueError("biases must be (R, 1, Pmax) and (R, 1, Cmax)")
    for name, t in (("q", q), ("bias_p", bias_p), ("bias_t", bias_t)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device")
    if bias_p.dtype != torch.float32 or bias_t.dtype != torch.float32:
        raise ValueError("biases must be f32")


def _ragged_scratch(q, P: int, C: int):
    """K5's f32 scratch (a partial output and an LSE per (row, head, job),
    laid out by the kernel) and its output."""
    R, Hkv, gq, Dh = q.shape
    keys = _build.kernels().spacer_decode_job_keys()
    jobs = -(-P // keys) + -(-C // keys)
    kw = dict(dtype=torch.float32, device=q.device)
    return (torch.empty(R * Hkv * jobs * gq * (Dh + 1), **kw),
            torch.empty(q.shape, **kw))


def _inference_only(name, *tensors):
    """Raise if autograd would need a gradient through an inference-only
    kernel (it has no backward; its output would silently be a constant)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is inference-only (no backward): run it "
                           "under torch.no_grad() or on detached tensors")


def flash_ragged_decode_attention(q, pk, pv, bias_p, tk, tv, bias_t,
                                  pk_scale=None, pv_scale=None, tk_scale=None,
                                  tv_scale=None, *, group_q: int,
                                  sm_scale: float):
    """K5 (bf16 caches) or, given scales, K5-int8.  Returns
    (R, Hkv, group_q, Dh) f32."""
    scales = (pk_scale, pv_scale, tk_scale, tv_scale)
    if _build.takes_plain(q, "K5" if pk_scale is None else "K5-int8"):
        return ragged_decode_attention_reference(
            q, pk, pv, bias_p, tk, tv, bias_t, *scales, group_q=group_q,
            sm_scale=sm_scale)
    if pk_scale is not None:
        return flash_ragged_decode_attention_int8(
            q, pk, pv, bias_p, tk, tv, bias_t, *scales, group_q=group_q,
            sm_scale=sm_scale)
    _inference_only("flash_ragged_decode_attention", q, pk, pv, tk, tv)
    _check(q, pk, pv, bias_p, tk, tv, bias_t, group_q, scales)
    R, Hkv, gq, Dh = q.shape
    scratch, out = _ragged_scratch(q, pk.shape[2], tk.shape[2])
    p = _build.ptr
    err = _build.kernels().spacer_ragged_decode_attention(
        p(q), p(pk), p(pv), p(bias_p), p(tk), p(tv), p(bias_t), p(scratch),
        p(out), R, Hkv, gq, pk.shape[2], tk.shape[2], Dh, float(sm_scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_ragged_decode_attention")
    flash_ragged_decode_attention.launches += 1
    return out


flash_ragged_decode_attention.launches = 0


def flash_ragged_decode_attention_int8(q, pk, pv, bias_p, tk, tv, bias_t,
                                       pk_scale, pv_scale, tk_scale, tv_scale,
                                       *, group_q: int, sm_scale: float):
    """K5-int8 (CUDA tensors only).  Returns (R, Hkv, group_q, Dh) f32."""
    scales = (pk_scale, pv_scale, tk_scale, tv_scale)
    if pk_scale is None:
        raise ValueError("K5-int8 needs the four cache scales")
    _inference_only("flash_ragged_decode_attention_int8", q)
    _check(q, pk, pv, bias_p, tk, tv, bias_t, group_q, scales)
    R, Hkv, gq, Dh = q.shape
    scratch, out = _ragged_scratch(q, pk.shape[2], tk.shape[2])
    p = _build.ptr
    err = _build.kernels().spacer_ragged_decode_attention_int8(
        p(q), p(pk), p(pv), p(bias_p), p(tk), p(tv), p(bias_t), *map(p, scales),
        p(scratch), p(out), R, Hkv, gq, pk.shape[2], tk.shape[2], Dh,
        float(sm_scale), _build.stream_ptr(q.device))
    _build.check(err, "flash_ragged_decode_attention_int8")
    flash_ragged_decode_attention_int8.launches += 1
    return out


flash_ragged_decode_attention_int8.launches = 0


# -- K2: shared-prefix grouped decode --------------------------------------


def decode_attention_reference(q, pk, pv, bias_p, tk, tv, step: int,
                               pk_scale=None, pv_scale=None, tk_scale=None,
                               tv_scale=None, *, group: int, group_q: int,
                               sm_scale: float):
    """Plain version of K2 / K2-int8 (spacer_tpu's
    decode_attention_reference): one softmax over [prefix | tail] per query
    row, f32 logits (times the K scales), tail positions >= step masked,
    probabilities times the V scales, rounded to q's dtype before P.V."""
    B, Hkv, GQ, Dh = q.shape
    G, P, T = group, pk.shape[2], tk.shape[2]
    cdt = q.dtype
    qf = q.float().reshape(B, Hkv, G, group_q, Dh)
    lp = torch.einsum("bhgcd,bhpd->bhgcp", qf, pk.to(cdt).float()) * sm_scale
    if pk_scale is not None:
        lp = lp * pk_scale[:, :, None, :, :]
    lp = lp + bias_p[:, None, None, :, :]
    qt = qf.permute(0, 2, 1, 3, 4).reshape(B * G, Hkv, group_q, Dh)
    lt = torch.einsum("nhcd,nhtd->nhct", qt, tk.to(cdt).float()) * sm_scale
    if tk_scale is not None:
        lt = lt * tk_scale
    live = torch.arange(T, device=q.device) < step
    lt = torch.where(live, lt, torch.tensor(MASK_VALUE, device=q.device))
    lp_rows = lp.permute(0, 2, 1, 3, 4).reshape(B * G, Hkv, group_q, P)
    probs = torch.softmax(torch.cat([lp_rows, lt], dim=-1), dim=-1)
    probs_p = probs[..., :P].reshape(B, G, Hkv, group_q, P)
    probs_t = probs[..., P:]
    if pv_scale is not None:
        probs_p = probs_p * pv_scale[:, None, :, 0, None, :]
    if tv_scale is not None:
        probs_t = probs_t * tv_scale
    out_p = torch.einsum("bghcp,bhpd->bghcd", probs_p.to(cdt).float(),
                         pv.to(cdt).float())
    out_t = torch.einsum("nhct,nhtd->nhcd", probs_t.to(cdt).float(),
                         tv.to(cdt).float())
    out = out_p.reshape(B * G, Hkv, group_q, Dh) + out_t
    return out.reshape(B, G, Hkv, group_q, Dh).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, GQ, Dh)


def _check_grouped(q, pk, pv, bias_p, tk, tv, step, group, group_q, scales):
    """Hopper legality gate of K2 / K2-int8 (raises ValueError)."""
    B, Hkv, GQ, Dh = q.shape
    if GQ != group * group_q or not 1 <= group_q <= GROUP_Q_MAX:
        raise ValueError(f"q rows {GQ} must be group*group_q, group_q <= "
                         f"{GROUP_Q_MAX}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    _check_caches(q, pk, pv, tk, tv, scales)
    if pk.shape != pv.shape or pk.shape[:2] != (B, Hkv) or pk.shape[3] != Dh:
        raise ValueError(f"bad prefix shape {tuple(pk.shape)}")
    if (tk.shape != tv.shape or tk.shape[:2] != (B * group, Hkv)
            or tk.shape[3] != Dh):
        raise ValueError(f"bad tail shape {tuple(tk.shape)}")
    if bias_p.shape != (B, 1, pk.shape[2]) or bias_p.dtype != torch.float32:
        raise ValueError("bias_p must be (B, 1, P) f32")
    if not isinstance(step, int) or not 1 <= step <= tk.shape[2]:
        raise ValueError(f"step must be a Python int in [1, T], got {step!r}")
    for name, t in (("q", q), ("bias_p", bias_p)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device")
    for name, t in (("q", q), ("pk", pk), ("pv", pv)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")


def _grouped_scratch(q, P: int, step: int):
    """K2's f32 scratch (a partial output and an LSE per (b, h, job, row):
    the prefix's 64-key chunks, then the live tail's) and its output."""
    B, Hkv, GQ, Dh = q.shape
    keys = _build.kernels().spacer_decode_job_keys()
    n_splits = -(-P // keys) + -(-step // keys)
    kw = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((B, Hkv, n_splits, GQ, Dh), **kw),
            torch.empty((B, Hkv, n_splits, GQ), **kw), torch.empty(q.shape, **kw))


def flash_decode_attention(q, pk, pv, bias_p, tk, tv, step: int,
                           pk_scale=None, pv_scale=None, tk_scale=None,
                           tv_scale=None, *, group: int, group_q: int,
                           sm_scale: float):
    """K2 (bf16 caches) or, given scales, K2-int8.  Returns
    (B, Hkv, G*group_q, Dh) f32."""
    scales = (pk_scale, pv_scale, tk_scale, tv_scale)
    if _build.takes_plain(q, "K2" if pk_scale is None else "K2-int8"):
        return decode_attention_reference(
            q, pk, pv, bias_p, tk, tv, step, *scales, group=group,
            group_q=group_q, sm_scale=sm_scale)
    if pk_scale is not None:
        return flash_decode_attention_int8(
            q, pk, pv, bias_p, tk, tv, step, *scales, group=group,
            group_q=group_q, sm_scale=sm_scale)
    _inference_only("flash_decode_attention", q, pk, pv, tk, tv)
    _check_grouped(q, pk, pv, bias_p, tk, tv, step, group, group_q, scales)
    B, Hkv, GQ, Dh = q.shape
    P, T = pk.shape[2], tk.shape[2]
    part_o, part_lse, out = _grouped_scratch(q, P, step)
    p = _build.ptr
    err = _build.kernels().spacer_grouped_decode_attention(
        p(q), p(pk), p(pv), p(bias_p), p(tk), p(tv), p(part_o), p(part_lse),
        p(out), B, Hkv, group, group_q, P, T, step, Dh, float(sm_scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


def flash_decode_attention_int8(q, pk, pv, bias_p, tk, tv, step: int,
                                pk_scale, pv_scale, tk_scale, tv_scale, *,
                                group: int, group_q: int, sm_scale: float):
    """K2-int8 (CUDA tensors only).  Returns (B, Hkv, G*group_q, Dh) f32."""
    scales = (pk_scale, pv_scale, tk_scale, tv_scale)
    if pk_scale is None:
        raise ValueError("K2-int8 needs the four cache scales")
    _inference_only("flash_decode_attention_int8", q)
    _check_grouped(q, pk, pv, bias_p, tk, tv, step, group, group_q, scales)
    B, Hkv, GQ, Dh = q.shape
    P, T = pk.shape[2], tk.shape[2]
    part_o, part_lse, out = _grouped_scratch(q, P, step)
    p = _build.ptr
    err = _build.kernels().spacer_grouped_decode_attention_int8(
        p(q), p(pk), p(pv), p(bias_p), p(tk), p(tv), *map(p, scales),
        p(part_o), p(part_lse), p(out), B, Hkv, group, group_q, P, T, step, Dh,
        float(sm_scale), _build.stream_ptr(q.device))
    _build.check(err, "flash_decode_attention_int8")
    flash_decode_attention_int8.launches += 1
    return out


flash_decode_attention_int8.launches = 0

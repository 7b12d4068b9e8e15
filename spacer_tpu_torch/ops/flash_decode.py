"""K5: ragged clock-ring decode attention on Hopper (csrc/flash_decode.cu).

Replaces spacer_tpu/ops/flash_decode.py::flash_ragged_decode_attention
(`_ragged_kernel`), bf16 branch, on every decode step of every layer of the
serving path.  Head-major layout as in JAX: q (R, Hkv, group_q, Dh), prompt
prefix pk/pv (R, Hkv, Pmax, Dh), completion ring tk/tv (R, Hkv, Cmax, Dh),
additive f32 window biases bias_p (R, 1, Pmax) / bias_t (R, 1, Cmax).
Output (R, Hkv, group_q, Dh) f32.

Bound on the H100: K/V bytes (one query token per row).  One CTA per
(slot row, kv head) serves all group_q query heads from one read of the
row's K/V; R * Hkv CTAs under-fill the card at small slot counts, which a
split-K pass will fix (see the .cu note).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  `flash_ragged_decode_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.ops import _build

MASK_VALUE = -1e30
HEAD_DIMS = (128,)
GROUP_Q_MAX = 8


def ragged_decode_attention_reference(q, pk, pv, bias_p, tk, tv, bias_t, *,
                                      group_q: int, sm_scale: float):
    """Plain version: one softmax over [prefix | ring] per query head, f32
    logits, probabilities rounded to the cache dtype before P.V."""
    cdt = q.dtype
    qf = q.float()
    lp = torch.einsum("rhgd,rhpd->rhgp", qf, pk.to(cdt).float()) * sm_scale
    lt = torch.einsum("rhgd,rhtd->rhgt", qf, tk.to(cdt).float()) * sm_scale
    lp = lp + bias_p[:, :, None, :]
    lt = lt + bias_t[:, :, None, :]
    P = pk.shape[2]
    probs = torch.softmax(torch.cat([lp, lt], dim=-1), dim=-1)
    probs = probs.to(cdt).float()
    return (torch.einsum("rhgp,rhpd->rhgd", probs[..., :P], pv.to(cdt).float())
            + torch.einsum("rhgt,rhtd->rhgd", probs[..., P:],
                           tv.to(cdt).float()))


def _check(q, pk, pv, bias_p, tk, tv, bias_t, group_q):
    """Hopper legality gate of K5 (raises ValueError)."""
    R, Hkv, gq, Dh = q.shape
    if gq != group_q or not 1 <= gq <= GROUP_Q_MAX:
        raise ValueError(f"group_q {gq} must match and be <= {GROUP_Q_MAX}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {Dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("tk", tk), ("tv", tv)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 (int8 caches are not "
                             f"ported yet), got {t.dtype}")
    if pk.shape != pv.shape or pk.shape[:2] != (R, Hkv) or pk.shape[3] != Dh:
        raise ValueError(f"bad prefix shape {tuple(pk.shape)}")
    if tk.shape != tv.shape or tk.shape[:2] != (R, Hkv) or tk.shape[3] != Dh:
        raise ValueError(f"bad ring shape {tuple(tk.shape)}")
    if bias_p.shape != (R, 1, pk.shape[2]) or bias_t.shape != (R, 1, tk.shape[2]):
        raise ValueError("biases must be (R, 1, Pmax) and (R, 1, Cmax)")
    for name, t in (("q", q), ("pk", pk), ("pv", pv), ("tk", tk), ("tv", tv),
                    ("bias_p", bias_p), ("bias_t", bias_t)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on q's device")
    if bias_p.dtype != torch.float32 or bias_t.dtype != torch.float32:
        raise ValueError("biases must be f32")


def flash_ragged_decode_attention(q, pk, pv, bias_p, tk, tv, bias_t, *,
                                  group_q: int, sm_scale: float):
    """K5.  Returns (R, Hkv, group_q, Dh) f32."""
    if q.device.type == "cpu":
        return ragged_decode_attention_reference(
            q, pk, pv, bias_p, tk, tv, bias_t, group_q=group_q,
            sm_scale=sm_scale)
    _check(q, pk, pv, bias_p, tk, tv, bias_t, group_q)
    R, Hkv, gq, Dh = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    p = _build.ptr
    err = _build.kernels().spacer_ragged_decode_attention(
        p(q), p(pk), p(pv), p(bias_p), p(tk), p(tv), p(bias_t), p(out),
        R, Hkv, gq, pk.shape[2], tk.shape[2], Dh, float(sm_scale),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_ragged_decode_attention")
    flash_ragged_decode_attention.launches += 1
    return out


flash_ragged_decode_attention.launches = 0

"""Ragged (per-row progress) decode step for continuous batching
(counterpart of spacer_tpu/serving/ragged.py, head-major path).

Clock-ring design: every slot advances with one global step clock, so each
active row's next KV lands at ring index `clock % Cmax` for all rows at
once; per-row raggedness lives entirely in the additive masks.  Done or
empty rows write unconditionally, which is safe because a ring position only
enters a row's mask window at the step whose write lands there, and writes
precede reads within a layer.

Cache entry per layer, head-major: pk/pv (R, Hkv, Pmax, Dh) prompt prefix
(written at admission), tk/tv (R, Hkv, Cmax, Dh) completion ring, both
updated IN PLACE; with int8 caches (decode_quant "int8_kv" / "int4_kv") an
8-tuple (pk, pv, tk, tv, pk_s, pv_s, tk_s, tv_s) of int8 codes and
(R, Hkv, T) f32 scales.  Attention is K5 / K5-int8 (ops/flash_decode.py) on
CUDA and their plain version on CPU.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.models.qwen25_vl.config import TextConfig
from spacer_tpu_torch.models.qwen25_vl.language import (
    _mlp_block,
    lm_head,
    o_proj,
    qkv_proj,
)
from spacer_tpu_torch.nn.core import embed, rms_norm
from spacer_tpu_torch.nn.rope import apply_rope, mrope_cos_sin, rope_inv_freq
from spacer_tpu_torch.ops.flash_decode import (
    MASK_VALUE,
    flash_ragged_decode_attention,
)
from spacer_tpu_torch.ops.quant import quantize_kv


def _ragged_layer_hm(h, layer_params, cache_entry, *, cfg: TextConfig, cos,
                     sin, ring_idx: int, bias_p, bias_t):
    """One decoder layer over the head-major prefix + clock-ring caches.
    h: (R, 1, D).  With int8 caches the new k/v are quantized per (row,
    head) and written with their scales."""
    R = h.shape[0]
    pk, pv, tk, tv = cache_entry[:4]
    p_attn = layer_params["self_attn"]

    x = rms_norm(layer_params["input_layernorm"], h, cfg.rms_norm_eps)
    q, k, v = qkv_proj(p_attn, x, cfg)
    H, Hkv, Dh = q.shape[-2], k.shape[-2], cfg.head_dim
    q, k = apply_rope(q, k, cos, sin)
    # in-place ring write, every row
    if len(cache_entry) == 8:
        pk_s, pv_s, tk_s, tv_s = cache_entry[4:]
        (kq, ks), (vq, vs) = quantize_kv(k[:, 0]), quantize_kv(v[:, 0])
        tk[:, :, ring_idx], tk_s[:, :, ring_idx] = kq, ks
        tv[:, :, ring_idx], tv_s[:, :, ring_idx] = vq, vs
        scales = tuple(s[:, :, None] for s in (pk_s, pv_s, tk_s, tv_s))
    else:
        tk[:, :, ring_idx] = k[:, 0]
        tv[:, :, ring_idx] = v[:, 0]
        scales = (None,) * 4

    group_q = H // Hkv
    out = flash_ragged_decode_attention(
        q.reshape(R, Hkv, group_q, Dh), pk, pv, bias_p, tk, tv, bias_t,
        *scales, group_q=group_q, sm_scale=Dh ** -0.5)
    h = h + o_proj(p_attn, out.reshape(R, 1, H * Dh).to(h.dtype), cfg)
    x = rms_norm(layer_params["post_attention_layernorm"], h, cfg.rms_norm_eps)
    return h + _mlp_block(layer_params["mlp"], x, cfg)


def ragged_decode_step(layers, params, cfg: TextConfig, cur, pos3, caches,
                       ring_idx: int, prefix_mask, ring_mask):
    """One clock-ring decode step -> logits (R, V); caches update in place.

    cur (R,) current token per slot; pos3 (3, R, 1) its rope positions;
    caches: L tuples (pk, pv, tk, tv) or int8 8-tuples; prefix_mask (R, Pmax) and ring_mask
    (R, Cmax) bool, the ring mask including the position written now."""
    Cmax = caches[0][2].shape[2]
    if not 0 <= ring_idx < Cmax:
        raise ValueError(f"ring index {ring_idx} outside [0, {Cmax})")
    h = embed(params["embed_tokens"], cur[:, None])
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=h.device)
    cos, sin = mrope_cos_sin(pos3, inv_freq, cfg.mrope_section)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    dead = torch.full((), MASK_VALUE, dtype=torch.float32, device=h.device)
    bias_p = torch.where(prefix_mask, zero, dead)[:, None, :]
    bias_t = torch.where(ring_mask, zero, dead)[:, None, :]
    for lp, entry in zip(layers, caches):
        h = _ragged_layer_hm(h, lp, entry, cfg=cfg, cos=cos, sin=sin,
                             ring_idx=ring_idx, bias_p=bias_p, bias_t=bias_t)
    h = rms_norm(params["norm"], h, cfg.rms_norm_eps)
    return lm_head(params, cfg, h[:, 0])

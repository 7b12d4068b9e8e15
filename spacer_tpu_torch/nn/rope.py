"""Rotary position embeddings (counterpart of spacer_tpu/nn/rope.py): 1D RoPE,
3-axis M-RoPE and the 2D vision RoPE of the Qwen2.5-VL ViT.

Frequencies and trig are computed in float32 and applied in float32, then
cast back to the activation dtype (HF modeling_qwen2_5_vl.py numerics).
"""

from __future__ import annotations

import torch


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def _rotate(x, cos, sin):
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def compute_rope_cos_sin(position_ids, inv_freq):
    """position_ids (..., S) int -> cos, sin of shape (..., S, head_dim)."""
    freqs = position_ids.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(q, k, cos, sin):
    """q, k: (B, S, H, D); cos, sin: (B, S, D)."""
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    return _rotate(q, cos, sin), _rotate(k, cos, sin)


def mrope_cos_sin(position_ids, inv_freq, mrope_section):
    """position_ids (3, B, S) -> cos, sin (B, S, head_dim): the frequency
    bands are split across the (t, h, w) rows per `mrope_section`, in both
    halves of the concat(freqs, freqs) layout."""
    cos3, sin3 = compute_rope_cos_sin(position_ids, inv_freq)  # (3,B,S,D)
    sections = list(mrope_section) * 2

    def mix(x):
        parts = torch.split(x, sections, dim=-1)
        return torch.cat([p[i % 3] for i, p in enumerate(parts)], dim=-1)

    return mix(cos3), mix(sin3)


def apply_mrope(q, k, position_ids, inv_freq, mrope_section):
    """q (B, S, Hq, D), k (B, S, Hkv, D), position_ids (3, B, S) -> q, k
    rotated by M-RoPE (mrope_cos_sin, then apply_rope)."""
    cos, sin = mrope_cos_sin(position_ids, inv_freq, mrope_section)
    return apply_rope(q, k, cos, sin)


def vision_rope_cos_sin(pos_hw, head_dim: int, theta: float = 10000.0):
    """pos_hw (S, 2) int (h, w) per patch token -> cos, sin (S, head_dim)."""
    inv = rope_inv_freq(head_dim // 2, theta, device=pos_hw.device)
    h = pos_hw[:, 0].float()[:, None] * inv
    w = pos_hw[:, 1].float()[:, None] * inv
    rot = torch.cat([h, w], dim=-1)
    emb = torch.cat([rot, rot], dim=-1)
    return emb.cos(), emb.sin()


def apply_vision_rope(q, k, cos, sin):
    """q, k: (S, H, D); cos, sin: (S, D)."""
    cos = cos[:, None, :].float()
    sin = sin[:, None, :].float()
    return _rotate(q, cos, sin), _rotate(k, cos, sin)

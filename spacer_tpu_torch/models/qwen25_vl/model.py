"""Combined Qwen2.5-VL model: ViT encode + scatter into the LM token embeds
(counterpart of spacer_tpu/models/qwen25_vl/model.py)."""

from __future__ import annotations

from typing import Any

import torch

from spacer_tpu_torch.models.qwen25_vl.config import Qwen25VLConfig
from spacer_tpu_torch.models.qwen25_vl.language import init_lm_params
from spacer_tpu_torch.models.qwen25_vl.vision import (
    init_vit_params,
    vision_layout,
    vit_forward,
)

Params = Any


def init_params(cfg: Qwen25VLConfig, *, seed: int = 0, dtype=torch.float32,
                device="cpu") -> Params:
    """Random weights at cfg's geometry, drawn on `device` from a
    torch.Generator seeded with `seed` (float32 draws, cast to `dtype`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=dtype, device=device)
    return {"model": init_lm_params(cfg.text, **kw),
            "visual": init_vit_params(cfg.vision, **kw)}


def encode_vision(params, cfg: Qwen25VLConfig, pixel_values, grid_thw,
                  remat: bool = False, attn_impl=None):
    """pixel_values (S, patch_dim) + grid_thw list -> (S/mu, lm_hidden);
    attn_impl None or ("ring", mesh, axis) (vision.py's full-attention
    blocks)."""
    layout = vision_layout(grid_thw, cfg.vision)
    return vit_forward(params["visual"], cfg.vision, pixel_values, layout,
                       remat=remat, attn_impl=attn_impl)


def merge_vision_embeds(cfg: Qwen25VLConfig, input_ids, token_embeds,
                        vision_embeds):
    """Place the (N, D) vision embeddings on the N image/video placeholder
    positions of input_ids (B, S), in batch-major order."""
    is_vision = (input_ids == cfg.image_token_id) | (input_ids == cfg.video_token_id)
    n = int(is_vision.sum())
    if n != vision_embeds.shape[0]:
        raise ValueError(f"{n} placeholder tokens but {vision_embeds.shape[0]} "
                         "vision embeddings")
    out = token_embeds.clone()
    out[is_vision] = vision_embeds.to(out.dtype)
    return out

"""Combined Aria model: vision tower + projector + MoE LM (counterpart of
spacer_tpu/models/aria/model.py).

Behavioral reference: modeling_aria.py AriaModel.forward: the projector's
outputs replace the <|img|> placeholder embeddings (masked_scatter, in
batch-major order), then the text model runs with plain 1D positions.
The functional surface is Qwen's, so the sampler, the batcher, the trainer
and the eval engine drive both families through one code path.
"""

from __future__ import annotations

from typing import Any

import torch

from spacer_tpu_torch.models.aria.config import AriaConfig
from spacer_tpu_torch.models.aria.language import (
    init_kv_cache,
    init_lm_params,
    lm_forward,
    positions_1d_to_3d,
)
from spacer_tpu_torch.models.aria.vision import (
    init_projector_params,
    init_vit_params,
    projector_forward,
    vit_forward,
)
from spacer_tpu_torch.nn.core import embed

Params = Any


def init_params(cfg: AriaConfig, *, seed: int = 0, dtype=torch.float32,
                device="cpu") -> Params:
    """Random weights at cfg's geometry, drawn on `device` from a
    torch.Generator seeded with `seed` (float32 draws, cast to `dtype`)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=dtype, device=device)
    return {"model": init_lm_params(cfg.text, **kw),
            "visual": init_vit_params(cfg.vision, **kw),
            "projector": init_projector_params(cfg, **kw)}


def encode_vision(params, cfg: AriaConfig, pixel_values, position_ids,
                  patch_mask=None, remat: bool = False):
    """pixel_values (N, H, W, C) image crops -> (N * Q, text hidden): the
    projector over the tower's last encoder layer (before post_layernorm).
    position_ids / patch_mask (N, Hp*Wp) come from the processor."""
    feats, _ = vit_forward(params["visual"], cfg.vision, pixel_values,
                           position_ids, patch_mask=patch_mask, remat=remat)
    out = projector_forward(params["projector"], cfg, feats,
                            patch_mask=patch_mask)
    return out.reshape(-1, out.shape[-1])


def merge_vision_embeds(cfg: AriaConfig, input_ids, token_embeds,
                        vision_embeds):
    """Place the (N, D) projector outputs on the N <|img|> positions of
    input_ids (B, S), in batch-major order (masked_scatter)."""
    is_vision = input_ids == cfg.image_token_id
    n = int(is_vision.sum())
    if n != vision_embeds.shape[0]:
        raise ValueError(f"{n} image placeholder tokens but "
                         f"{vision_embeds.shape[0]} vision embeddings")
    out = token_embeds.clone()
    out[is_vision] = vision_embeds.to(out.dtype)
    return out


def forward(params: Params, cfg: AriaConfig, input_ids, *, pixel_values=None,
            pixel_position_ids=None, patch_mask=None, vision_embeds=None,
            position_ids=None, kv_mask=None, cache=None, cache_index: int = 0,
            logits: bool = True, remat=False, attn_impl=None):
    """Full multimodal forward -> (logits or hidden, cache).  position_ids:
    (3, B, S) with equal rows, or (B, S).  `attn_impl` reaches the LM only
    (the tower keeps its own attention)."""
    token_embeds = embed(params["model"]["embed_tokens"], input_ids)
    if vision_embeds is None and pixel_values is not None:
        vision_embeds = encode_vision(params, cfg, pixel_values,
                                      pixel_position_ids,
                                      patch_mask=patch_mask, remat=bool(remat))
    if vision_embeds is not None:
        token_embeds = merge_vision_embeds(cfg, input_ids, token_embeds,
                                           vision_embeds)
    if position_ids is not None and position_ids.dim() == 2:
        position_ids = positions_1d_to_3d(position_ids)
    return lm_forward(params["model"], cfg.text, input_embeds=token_embeds,
                      position_ids=position_ids, kv_mask=kv_mask, cache=cache,
                      cache_index=cache_index, logits=logits, remat=remat,
                      attn_impl=attn_impl)


def make_kv_cache(cfg: AriaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    return init_kv_cache(cfg.text, batch, max_len, dtype, device)

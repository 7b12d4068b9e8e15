"""Combined Qwen2.5-VL model: ViT encode + scatter into the LM token embeds
(counterpart of spacer_tpu/models/qwen25_vl/model.py), for Qwen2.5-VL and
Qwen2-VL alike.  `forward` is the one-call multimodal forward (embed, the
ViT through K3 / K4, merge, the LM through K1 with an optional KV cache
written in place), the composition the serving path makes."""

from __future__ import annotations

from typing import Any

import torch

from spacer_tpu_torch.models.qwen25_vl.config import Qwen25VLConfig
from spacer_tpu_torch.models.qwen25_vl.language import (
    init_kv_cache,
    init_lm_params,
    lm_forward,
)
from spacer_tpu_torch.models.qwen25_vl.vision import (
    init_vit_params,
    vision_layout,
    vit_forward,
)
from spacer_tpu_torch.nn.core import embed
from spacer_tpu_torch.parallel.fsdp import gather

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


def forward(params: Params, cfg: Qwen25VLConfig, input_ids, *,
            pixel_values=None, grid_thw=None, vision_embeds=None,
            position_ids=None, kv_mask=None, cache=None, cache_index: int = 0,
            logits: bool = True, remat=False, attn_impl=None):
    """Full multimodal forward -> (logits or hidden, cache): the token
    embeddings of input_ids (B, S), the ViT's embeddings of pixel_values
    (packed patches of the grids `grid_thw`, taken in the params' dtype)
    unless `vision_embeds` (N, D) are given, merged on the placeholders,
    then lm_forward.  position_ids (3, B, S); with `cache` (make_kv_cache)
    the block's keys / values are written in place at `cache_index` and
    kv_mask covers the cache length (inference only, lm_forward's rule).
    `remat` and `attn_impl` reach the ViT and the LM."""
    token_embeds = embed(gather(params["model"]["embed_tokens"]), input_ids)
    if vision_embeds is None and pixel_values is not None:
        # the patch embed's input precision is the params' own, as the
        # serving path (models/registry.py) and the JAX trainer ship them
        w = gather(params["visual"]["patch_embed"]["proj"]["kernel"])
        vision_embeds = encode_vision(
            params, cfg, pixel_values.to(device=w.device, dtype=w.dtype),
            grid_thw, remat=remat, attn_impl=attn_impl)
    if vision_embeds is not None:
        token_embeds = merge_vision_embeds(cfg, input_ids, token_embeds,
                                           vision_embeds)
    return lm_forward(params["model"], cfg.text, input_embeds=token_embeds,
                      position_ids=position_ids, kv_mask=kv_mask, cache=cache,
                      cache_index=cache_index, logits=logits, remat=remat,
                      attn_impl=attn_impl)


def make_kv_cache(cfg: Qwen25VLConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    """The cache `forward` writes: {"k", "v"}, per layer (batch, max_len,
    Hkv, Dh) zeros (this rank's KV heads under tensor parallelism)."""
    return init_kv_cache(cfg.text, batch, max_len, dtype, device)

"""Model-family registry (counterpart of spacer_tpu/models/registry.py).

One adapter object per family bundles the family-specific seams (config,
random init, processor, positions, vision packing / encode / merge / tile,
checkpoint loading) so the sampler, the train step, the trainer and the
CLIs stay family-agnostic.  Two families: Qwen (Qwen2.5-VL and Qwen2-VL:
the config's vision arch picks the ViT) and Aria (image-only, as in the
reference).  The compute engine underneath is shared
(models/qwen25_vl/language.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    tiny_config: Callable[..., Any]
    # (cfg, seed=0, dtype=..., device=...) -> params
    init_params: Callable[..., Any]
    # (tokenizer, cfg, device) -> processor
    make_processor: Callable[..., Any]
    # (vocab_size) -> the family's test tokenizer
    mock_tokenizer: Callable[..., Any]
    # (cfg, input_ids, attention_mask, enc) -> (position_ids (3,B,S), deltas (B,1))
    positions: Callable[..., Any]
    # (enc) -> (vision_kwargs dict for encode_vision, static_aux) or (None, None)
    pack_vision: Callable[..., Any]
    # (params, cfg, vision_kwargs, static_aux, remat=False, attn_impl=None)
    # -> (N, D) embeddings
    encode_vision: Callable[..., Any]
    merge_vision_embeds: Callable[..., Any]
    # (ve, cfg, static_aux, num_generations, media_per_prompt) -> tiled ve
    tile_vision_embeds: Callable[..., Any]
    # (checkpoint_dir, cfg=None, dtype=..., device=...) -> (params, cfg)
    load_params_from_hf: Callable[..., Any]
    # batch keys that carry vision arrays into the train step
    vision_batch_keys: tuple = ("pixel_values",)
    # parallel/partition.py rules for shard_params
    partition_rules: tuple = ()
    # (cfg, tp) -> the partition.TPPlan of shard_params (which leaves split
    # over tp, the head counts tp must divide)
    tp_plan: Callable[..., Any] = None


def _qwen_positions(cfg, input_ids, attention_mask, enc):
    from spacer_tpu_torch.models.qwen25_vl.rope_index import get_rope_index

    return get_rope_index(
        cfg, input_ids,
        image_grid_thw=enc.get("image_grid_thw"),
        video_grid_thw=enc.get("video_grid_thw"),
        second_per_grid_ts=enc.get("second_per_grid_ts"),
        attention_mask=attention_mask,
    )


def _qwen_pack_vision(enc):
    from spacer_tpu_torch.data.processor import pack_vision_inputs

    px, grids = pack_vision_inputs(enc)
    if px is None:
        return None, None
    return {"pixel_values": px}, grids


def _qwen_encode_vision(params, cfg, vision_kwargs, static_aux,
                        remat: bool = False, attn_impl=None):
    """Pixels go to the params' device and dtype (the patch embed's input
    precision is the params' own, as the JAX trainer ships bf16 pixels to
    bf16 params); attn_impl reaches the ViT's full-attention blocks."""
    from spacer_tpu_torch.models.qwen25_vl.model import encode_vision

    w = params["visual"]["patch_embed"]["proj"]["kernel"]
    px = torch.as_tensor(np.asarray(vision_kwargs["pixel_values"])
                         if not isinstance(vision_kwargs["pixel_values"],
                                           torch.Tensor)
                         else vision_kwargs["pixel_values"])
    return encode_vision(params, cfg, px.to(device=w.device, dtype=w.dtype),
                         static_aux, remat=remat, attn_impl=attn_impl)


def _params_tensor(params, x, dtype=None):
    """A host array or tensor on the params' device (in `dtype`)."""
    dev = params["model"]["embed_tokens"]["embedding"].device
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(device=dev, dtype=dtype)


def aria_positions(cfg, input_ids, attention_mask, enc=None):
    """Plain 1D positions from the attention mask (left padding aware),
    broadcast to the (3, B, S) M-RoPE layout with equal rows; deltas (B, 1)
    put the first generated token at position n_real_tokens (delta =
    max_position + 1 - seq_len, get_rope_index's contract)."""
    mask = np.asarray(attention_mask)
    pos = np.clip(np.cumsum(mask, axis=1) - 1, 0, None).astype(np.int32)
    B, S = pos.shape
    deltas = (pos.max(axis=1, keepdims=True) + 1 - S).astype(np.int32)
    return np.broadcast_to(pos[None], (3, B, S)).copy(), deltas


def _aria_pack_vision(enc):
    if "pixel_values" not in enc:
        return None, None
    return {"pixel_values": enc["pixel_values"],
            "position_ids": enc["pixel_position_ids"],
            "patch_mask": enc["patch_mask"]}, None


def _aria_encode_vision(params, cfg, vision_kwargs, static_aux,
                        remat: bool = False, attn_impl=None):
    """Crops go to the params' device and dtype (the patch embed's input
    precision is the params' own); the NaViT ids and the patch mask come
    as pack_vision's "position_ids" or the batch's "pixel_position_ids".
    The tower takes no attn_impl (JAX's neither): it is accepted and
    unused."""
    from spacer_tpu_torch.models.aria.model import encode_vision

    w = params["visual"]["embeddings"]["patch_embedding"]["kernel"]
    pos = vision_kwargs.get("position_ids")
    if pos is None:
        pos = vision_kwargs["pixel_position_ids"]
    return encode_vision(
        params, cfg, _params_tensor(params, vision_kwargs["pixel_values"],
                                    w.dtype),
        _params_tensor(params, pos, torch.long),
        patch_mask=_params_tensor(params, vision_kwargs["patch_mask"],
                                  torch.bool), remat=remat)


def _aria_tile_vision_embeds(ve, cfg, static_aux, num_generations,
                             media_per_prompt=None):
    """Broadcast per-prompt projector embeddings across G completions.
    ve: (total_crops * Q, D); every crop gives the same Q queries, so a
    prompt of n crops owns n * Q rows."""
    if media_per_prompt is None or len(media_per_prompt) <= 1:
        return ve.repeat(num_generations, 1)
    q = ve.shape[0] // sum(media_per_prompt)
    parts, off = [], 0
    for n_crops in media_per_prompt:
        n = n_crops * q
        parts.append(ve[off:off + n].repeat(num_generations, 1))
        off += n
    return torch.cat(parts, dim=0)


def _qwen_tp_plan(cfg, tp: int = 1):
    from spacer_tpu_torch.parallel.partition import qwen_tp_plan

    return qwen_tp_plan(cfg)


def _aria_tp_plan(cfg, tp: int = 1):
    """Aria's plan (partition.aria_tp_plan); a tp that does not divide its
    heads or widths raises ValueError."""
    from spacer_tpu_torch.parallel.partition import aria_tp_plan

    return aria_tp_plan(cfg).check(tp)


def _make_qwen_family():
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.models.qwen25_vl.config import tiny_config
    from spacer_tpu_torch.models.qwen25_vl.loading import load_params_from_hf
    from spacer_tpu_torch.models.qwen25_vl.model import (
        init_params,
        merge_vision_embeds,
    )
    from spacer_tpu_torch.parallel.partition import QWEN_PARTITION_RULES
    from spacer_tpu_torch.train.step import tile_vision_embeds

    return ModelFamily(
        name="qwen25_vl",
        tiny_config=tiny_config,
        init_params=init_params,
        make_processor=lambda tok, cfg, device="cpu": VLProcessor(
            tok, cfg, device=device),
        mock_tokenizer=lambda vocab_size: MockTokenizer(vocab_size=vocab_size),
        positions=_qwen_positions,
        pack_vision=_qwen_pack_vision,
        encode_vision=_qwen_encode_vision,
        merge_vision_embeds=merge_vision_embeds,
        tile_vision_embeds=tile_vision_embeds,
        load_params_from_hf=load_params_from_hf,
        vision_batch_keys=("pixel_values",),
        partition_rules=tuple(QWEN_PARTITION_RULES),
        tp_plan=_qwen_tp_plan,
    )


def _make_aria_family():
    from spacer_tpu_torch.data.aria_processor import (
        AriaProcessor,
        MockAriaTokenizer,
    )
    from spacer_tpu_torch.models.aria import (
        init_params,
        load_params_from_hf,
        merge_vision_embeds,
        tiny_aria_config,
    )
    from spacer_tpu_torch.parallel.partition import ARIA_PARTITION_RULES

    return ModelFamily(
        name="aria",
        tiny_config=tiny_aria_config,
        init_params=init_params,
        # host numpy: the processor takes no device
        make_processor=lambda tok, cfg, device="cpu": AriaProcessor(tok, cfg),
        mock_tokenizer=lambda vocab_size: MockAriaTokenizer(
            vocab_size=vocab_size),
        positions=aria_positions,
        pack_vision=_aria_pack_vision,
        encode_vision=_aria_encode_vision,
        merge_vision_embeds=merge_vision_embeds,
        tile_vision_embeds=_aria_tile_vision_embeds,
        load_params_from_hf=load_params_from_hf,
        vision_batch_keys=("pixel_values", "pixel_position_ids",
                           "patch_mask"),
        partition_rules=tuple(ARIA_PARTITION_RULES),
        tp_plan=_aria_tp_plan,
    )


_FACTORIES = {"qwen25_vl": _make_qwen_family, "aria": _make_aria_family}
_CACHE: dict[str, ModelFamily] = {}


def get_family(name_or_model_id: str) -> ModelFamily:
    """Resolve a family by name or HF model-id substring (the reference
    trainer's dispatch rule): "aria" anywhere is Aria, everything else
    (Qwen2-VL and Qwen2.5-VL alike) is the Qwen family."""
    name = "aria" if "aria" in name_or_model_id.lower() else "qwen25_vl"
    if name not in _CACHE:
        _CACHE[name] = _FACTORIES[name]()
    return _CACHE[name]


def family_for_config(cfg) -> ModelFamily:
    """Resolve from a config object (AriaConfig vs Qwen25VLConfig)."""
    return get_family(type(cfg).__name__)


def encode_batch(processor, cfg, conversations) -> dict:
    """Conversations (the processor's message schema) -> one left-padded
    batch: input_ids, attention_mask, the family's rope positions and
    deltas, grid_thw and, with images or videos, vision_kwargs (pixels of
    both modalities in placeholder order).  Host numpy throughout when the
    processor's device is the CPU."""
    from spacer_tpu_torch.data.processor import pack_vision_inputs

    enc = processor.process_messages(list(conversations),
                                     add_generation_prompt=True)
    family = family_for_config(cfg)
    if family.name == "aria" and "pixel_values" in enc:
        # JAX's encode_request packs only Qwen's grid keys, so an Aria image
        # would reach the batcher as text placeholders (ROADMAP queue C);
        # images reach Aria through Sampler.generate and the trainer
        raise NotImplementedError(
            "serving an Aria request with an image is not supported: its "
            "vision inputs would be dropped (the reference's encode_request "
            "packs only Qwen's grids); run images through Sampler.generate "
            "or the trainer")
    pos, deltas = family.positions(
        cfg, enc["input_ids"], enc["attention_mask"], enc)
    pixel_values, grid_thw = pack_vision_inputs(enc)
    req = {"input_ids": enc["input_ids"],
           "attention_mask": enc["attention_mask"],
           "position_ids": pos, "deltas": deltas, "grid_thw": grid_thw}
    if pixel_values is not None:
        req["vision_kwargs"] = {"pixel_values": pixel_values}
    return req


def encode_request(processor, cfg, conversation: list) -> dict:
    """One conversation -> a ContinuousBatcher request: the encode path of
    QwenEngine.generate_many and the HTTP server (serving/server.py)."""
    return encode_batch(processor, cfg, [conversation])

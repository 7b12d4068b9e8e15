"""Model-family registry (counterpart of spacer_tpu/models/registry.py).

One adapter object per family bundles the family-specific seams (positions,
vision packing / encode / merge) so the sampler, the train step and
the trainer stay family-agnostic.  The Qwen family (Qwen2.5-VL and
Qwen2-VL: the config's vision arch picks the ViT) is ported; Aria raises
(ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    name: str
    # (cfg, input_ids, attention_mask, enc) -> (position_ids (3,B,S), deltas (B,1))
    positions: Callable[..., Any]
    # (enc) -> (vision_kwargs dict for encode_vision, static_aux) or (None, None)
    pack_vision: Callable[..., Any]
    # (params, cfg, vision_kwargs, static_aux, remat=False) -> (N, D) embeddings
    encode_vision: Callable[..., Any]
    merge_vision_embeds: Callable[..., Any]
    # (checkpoint_dir, cfg=None, dtype=..., device=...) -> (params, cfg)
    load_params_from_hf: Callable[..., Any]
    # batch keys that carry vision arrays into the train step
    vision_batch_keys: tuple = ("pixel_values",)


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
                        remat: bool = False):
    """Pixels go to the params' device and dtype (the patch embed's input
    precision is the params' own, as the JAX trainer ships bf16 pixels to
    bf16 params)."""
    from spacer_tpu_torch.models.qwen25_vl.model import encode_vision

    w = params["visual"]["patch_embed"]["proj"]["kernel"]
    px = torch.as_tensor(np.asarray(vision_kwargs["pixel_values"])
                         if not isinstance(vision_kwargs["pixel_values"],
                                           torch.Tensor)
                         else vision_kwargs["pixel_values"])
    return encode_vision(params, cfg, px.to(device=w.device, dtype=w.dtype),
                         static_aux, remat=remat)


def _make_qwen_family():
    from spacer_tpu_torch.models.qwen25_vl.loading import load_params_from_hf
    from spacer_tpu_torch.models.qwen25_vl.model import merge_vision_embeds

    return ModelFamily(
        name="qwen25_vl",
        positions=_qwen_positions,
        pack_vision=_qwen_pack_vision,
        encode_vision=_qwen_encode_vision,
        merge_vision_embeds=merge_vision_embeds,
        load_params_from_hf=load_params_from_hf,
        vision_batch_keys=("pixel_values",),
    )


_CACHE: dict[str, ModelFamily] = {}


def get_family(name_or_model_id: str) -> ModelFamily:
    """Resolve a family by name or HF model-id substring (the reference
    trainer's dispatch rule): "aria" is not ported, everything else
    (Qwen2-VL and Qwen2.5-VL alike) is the Qwen family."""
    if "aria" in name_or_model_id.lower():
        raise NotImplementedError(
            "the Aria family is not ported to spacer_tpu_torch (ROADMAP "
            "queue A)")
    if "qwen25_vl" not in _CACHE:
        _CACHE["qwen25_vl"] = _make_qwen_family()
    return _CACHE["qwen25_vl"]


def family_for_config(cfg) -> ModelFamily:
    """Resolve from a config object."""
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
    pos, deltas = family_for_config(cfg).positions(
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

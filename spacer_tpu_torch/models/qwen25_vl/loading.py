"""HF checkpoint (safetensors) <-> the port's Qwen2.5-VL params
(counterpart of spacer_tpu/models/qwen25_vl/loading.py).

The port's layout is the one `convert.py::params_from_jax` gives: per-layer
lists ("layers" of the LM, "blocks" of the ViT) of dicts, dense kernels
(in, out).  HF stores linear weights (out, in), so each is moved to the
target device first and transposed there; the ViT's Conv3d patch embed
(kernel == stride) is a dense kernel over the flattened (C, T, p, p) patch.
Both transformers layouts load: `model.language_model.*` / `model.visual.*`
and the legacy `model.*` / `visual.*`.  Files are read and written by
`safetensors_io` (no `safetensors` package needed).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import torch

from spacer_tpu_torch.models.qwen25_vl import safetensors_io as st
from spacer_tpu_torch.models.qwen25_vl.config import Qwen25VLConfig

CONFIG_FILE = "config.json"


def _normalize_key(k: str) -> str:
    k = re.sub(r"^model\.language_model\.", "model.", k)
    k = re.sub(r"^model\.visual\.", "visual.", k)
    k = re.sub(r"^language_model\.model\.", "model.", k)
    return k


def _check_arch(cfg: Qwen25VLConfig) -> None:
    if cfg.vision.arch != "qwen2_5":
        raise NotImplementedError(
            f"ViT arch {cfg.vision.arch!r} (Qwen2-VL) is not ported "
            "(ROADMAP queue A item 4, Qwen2-VL ViT)")


def _entries(cfg: Qwen25VLConfig) -> list:
    """(HF name, param path, kind) of every tensor, in export order.  kind:
    "t" = a dense kernel HF stores (out, in), "patch" = the ViT's Conv3d
    weight (D, C, T, p, p), "" = stored as the port holds it."""
    t, v = cfg.text, cfg.vision
    out = [("model.embed_tokens.weight", ("model", "embed_tokens", "embedding"), ""),
           ("model.norm.weight", ("model", "norm", "scale"), "")]
    if not t.tie_word_embeddings:
        out.append(("lm_head.weight", ("model", "lm_head", "kernel"), "t"))

    def dense(name, path, bias):
        out.append((f"{name}.weight", (*path, "kernel"), "t"))
        if bias:
            out.append((f"{name}.bias", (*path, "bias"), ""))

    for i in range(t.num_layers):
        pre, path = f"model.layers.{i}", ("model", "layers", i)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out.append((f"{pre}.{norm}.weight", (*path, norm, "scale"), ""))
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(f"{pre}.self_attn.{proj}", (*path, "self_attn", proj),
                  proj != "o_proj")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            dense(f"{pre}.mlp.{proj}", (*path, "mlp", proj), False)

    out.append(("visual.patch_embed.proj.weight",
                ("visual", "patch_embed", "proj", "kernel"), "patch"))
    for i in range(v.depth):
        pre, path = f"visual.blocks.{i}", ("visual", "blocks", i)
        for norm in ("norm1", "norm2"):
            out.append((f"{pre}.{norm}.weight", (*path, norm, "scale"), ""))
        for sub in ("qkv", "proj"):
            dense(f"{pre}.attn.{sub}", (*path, "attn", sub), True)
        for proj in ("gate_proj", "up_proj", "down_proj"):
            dense(f"{pre}.mlp.{proj}", (*path, "mlp", proj), True)
    out.append(("visual.merger.ln_q.weight",
                ("visual", "merger", "ln_q", "scale"), ""))
    dense("visual.merger.mlp.0", ("visual", "merger", "mlp_0"), True)
    dense("visual.merger.mlp.2", ("visual", "merger", "mlp_2"), True)
    return out


def params_from_torch_state_dict(state: Mapping[str, Any], cfg: Qwen25VLConfig,
                                 dtype=torch.float32, device="cuda"):
    """The port's params from a {HF name: tensor} mapping.  Values
    are fetched one at a time (`state` may be a `CheckpointShards`, whose
    `release` is called once a tensor is copied), copied to `device`, cast
    to `dtype` and transposed there."""
    _check_arch(cfg)
    keymap = {_normalize_key(k): k for k in state.keys()}
    release = getattr(state, "release", None)
    params = {"model": {"layers": [{} for _ in range(cfg.text.num_layers)]},
              "visual": {"blocks": [{} for _ in range(cfg.vision.depth)]}}
    for name, path, kind in _entries(cfg):
        if name not in keymap:
            raise KeyError(f"the checkpoint has no tensor {name!r}")
        x = torch.as_tensor(state[keymap[name]])
        # copy=True: a view of a read-only map never becomes a param
        x = x.to(device=device, dtype=dtype, copy=True)
        if release is not None:
            release(keymap[name])
        if kind == "t":
            x = x.t().contiguous()
        elif kind == "patch":
            x = x.reshape(x.shape[0], -1).t().contiguous()
        node = params
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = x
    return params


def load_params_from_hf(checkpoint_dir: str, cfg: Qwen25VLConfig | None = None,
                        dtype=torch.bfloat16, device="cuda"):
    """Load an HF checkpoint directory (config.json + one or more
    .safetensors, with or without the index) onto `device`.  Returns
    (params, cfg).  Tensors stream one at a time from memory-mapped shards:
    the host holds about one tensor of the checkpoint at once."""
    if cfg is None:
        with open(os.path.join(checkpoint_dir, CONFIG_FILE)) as f:
            cfg = Qwen25VLConfig.from_hf_config(json.load(f))
    _check_arch(cfg)
    with st.CheckpointShards(checkpoint_dir) as shards:
        params = params_from_torch_state_dict(shards, cfg, dtype, device)
    return params, cfg


def config_to_hf_dict(cfg: Qwen25VLConfig, torch_dtype: str = "bfloat16") -> dict:
    """An HF-style config.json that `Qwen25VLConfig.from_hf_config` reads
    back to `cfg`'s text and vision geometry and token ids."""
    t, v = cfg.text, cfg.vision
    return {
        "model_type": "qwen2_5_vl",
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_layers,
        "num_attention_heads": t.num_heads,
        "num_key_value_heads": t.num_kv_heads,
        "rms_norm_eps": t.rms_norm_eps,
        "rope_theta": t.rope_theta,
        "rope_scaling": {"type": "mrope",
                         "mrope_section": list(t.mrope_section)},
        "tie_word_embeddings": t.tie_word_embeddings,
        "max_position_embeddings": t.max_position_embeddings,
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id,
        "torch_dtype": torch_dtype,
        "vision_config": {
            "depth": v.depth,
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_heads": v.num_heads,
            "in_channels": v.in_channels,
            "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "window_size": v.window_size,
            "fullatt_block_indexes": list(v.fullatt_block_indexes),
            "out_hidden_size": v.out_hidden_size,
            "tokens_per_second": v.tokens_per_second,
        },
    }


def export_to_safetensors(params, cfg: Qwen25VLConfig, path_or_dir: str,
                          max_shard_bytes: int | None = None) -> str:
    """The inverse mapping: params -> HF-named tensors, each in its own
    dtype, transposed on the params' device and copied to the host one at a
    time.  A path ending in ".safetensors" gets one file; any other path is
    a checkpoint directory that gets config.json and either
    model.safetensors or, with `max_shard_bytes`, HF's shards and index."""
    _check_arch(cfg)
    v = cfg.vision
    patch_shape = (v.hidden_size, v.in_channels, v.temporal_patch_size,
                   v.patch_size, v.patch_size)
    specs = []
    for name, path, kind in _entries(cfg):
        p = params
        for k in path:
            p = p[k]
        if kind == "t":
            shape, produce = (p.shape[1], p.shape[0]), (
                lambda p=p: p.t().contiguous())
        elif kind == "patch":
            shape, produce = patch_shape, (
                lambda p=p: p.t().contiguous().reshape(patch_shape))
        else:
            shape, produce = tuple(p.shape), (lambda p=p: p)
        specs.append(st.TensorSpec(name, p.dtype, tuple(shape), produce))
    meta = {"format": "pt"}
    if path_or_dir.endswith(".safetensors"):
        st.save_file(specs, path_or_dir, meta)
        return path_or_dir
    os.makedirs(path_or_dir, exist_ok=True)
    if max_shard_bytes:
        st.save_sharded(specs, path_or_dir, max_shard_bytes, meta)
    else:
        st.save_file(specs, os.path.join(path_or_dir, "model.safetensors"),
                     meta)
    dtype = params["model"]["embed_tokens"]["embedding"].dtype
    with open(os.path.join(path_or_dir, CONFIG_FILE), "w") as f:
        json.dump(config_to_hf_dict(cfg, str(dtype).removeprefix("torch.")),
                  f, indent=2)
    return path_or_dir

"""HF Aria checkpoint (safetensors) <-> the port's Aria params (counterpart
of spacer_tpu/models/aria/loading.py).

Both transformers layouts load: the current `model.language_model.*` /
`model.vision_tower.*` / `model.multi_modal_projector.*` split (AriaModel)
and the legacy `language_model.model.*` / `vision_tower.*` of the original
rhymes-ai/Aria checkpoint.  Export writes the current one.  Linear weights
transpose (HF stores (out, in)); the experts' grouped-GEMM weights
(E, in, out) pass through; the stride-p conv patch embedding (D, C, p, p)
permutes to the (dy, dx, c) row order of vision.patchify.  Files are read
and written by models/qwen25_vl/safetensors_io (no `safetensors` package
needed).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import torch

from spacer_tpu_torch.models.aria.config import AriaConfig
from spacer_tpu_torch.models.qwen25_vl import safetensors_io as st

CONFIG_FILE = "config.json"

# normalized name prefix -> the current transformers layout's
_EXPORT_PREFIXES = (("model.", "model.language_model."),
                    ("vision_tower.", "model.vision_tower."),
                    ("multi_modal_projector.", "model.multi_modal_projector."))


def _normalize_key(k: str) -> str:
    k = re.sub(r"^model\.language_model\.", "model.", k)
    k = re.sub(r"^language_model\.model\.", "model.", k)
    k = re.sub(r"^language_model\.lm_head\.", "lm_head.", k)
    k = re.sub(r"^model\.vision_tower\.", "vision_tower.", k)
    k = re.sub(r"^model\.multi_modal_projector\.", "multi_modal_projector.", k)
    return k


def _export_name(name: str) -> str:
    for old, new in _EXPORT_PREFIXES:
        if name.startswith(old):
            return new + name[len(old):]
    return name


def _entries(cfg: AriaConfig) -> list:
    """(normalized HF name, param path, kind) of every tensor, in export
    order.  kind: "t" = a dense kernel HF stores (out, in), "patch" = the
    conv patch embedding (D, C, p, p), "" = stored as the port holds it."""
    t = cfg.text
    out = [("model.embed_tokens.weight", ("model", "embed_tokens", "embedding"), ""),
           ("model.norm.weight", ("model", "norm", "scale"), "")]
    if not t.tie_word_embeddings:
        out.append(("lm_head.weight", ("model", "lm_head", "kernel"), "t"))

    def dense(name, path, bias):
        out.append((f"{name}.weight", (*path, "kernel"), "t"))
        if bias:
            out.append((f"{name}.bias", (*path, "bias"), ""))

    def ln(name, path):
        out.append((f"{name}.weight", (*path, "scale"), ""))
        out.append((f"{name}.bias", (*path, "bias"), ""))

    for i in range(t.num_layers):
        pre, path = f"model.layers.{i}", ("model", "layers", i)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out.append((f"{pre}.{norm}.weight", (*path, norm, "scale"), ""))
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            dense(f"{pre}.self_attn.{proj}", (*path, "self_attn", proj),
                  t.attention_bias and proj != "o_proj")
        mlp = (*path, "mlp")
        dense(f"{pre}.mlp.router", (*mlp, "router"), False)
        for fc in ("fc1", "fc2"):
            out.append((f"{pre}.mlp.experts.{fc}.weight",
                        (*mlp, "experts", fc, "kernel"), ""))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            dense(f"{pre}.mlp.shared_experts.{proj}", (*mlp, "shared", proj),
                  False)

    vt, emb = "vision_tower", ("visual", "embeddings")
    out.append((f"{vt}.embeddings.patch_embedding.weight",
                (*emb, "patch_embedding", "kernel"), "patch"))
    out.append((f"{vt}.embeddings.patch_embedding.bias",
                (*emb, "patch_embedding", "bias"), ""))
    out.append((f"{vt}.embeddings.position_embedding.weight",
                (*emb, "position_embedding", "embedding"), ""))
    for i in range(cfg.vision.num_layers):
        pre, path = f"{vt}.encoder.layers.{i}", ("visual", "encoder", i)
        for name in ("layer_norm1", "layer_norm2"):
            ln(f"{pre}.{name}", (*path, name))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{pre}.self_attn.{proj}", (*path, "self_attn", proj), True)
        for fc in ("fc1", "fc2"):
            dense(f"{pre}.mlp.{fc}", (*path, "mlp", fc), True)
    ln(f"{vt}.post_layernorm", ("visual", "post_layernorm"))

    pj, ca = "multi_modal_projector", ("projector", "cross_attn")
    out.append((f"{pj}.query", ("projector", "query"), ""))
    for name in ("q_proj", "k_proj", "v_proj"):
        dense(f"{pj}.cross_attn.{name}", (*ca, name), False)
    out.append((f"{pj}.cross_attn.multihead_attn.in_proj_weight",
                (*ca, "mha_in_proj", "kernel"), "t"))
    out.append((f"{pj}.cross_attn.multihead_attn.in_proj_bias",
                (*ca, "mha_in_proj", "bias"), ""))
    dense(f"{pj}.cross_attn.multihead_attn.out_proj", (*ca, "mha_out_proj"),
          True)
    dense(f"{pj}.cross_attn.linear", (*ca, "linear"), True)
    for name in ("layer_norm", "layer_norm_kv"):
        ln(f"{pj}.cross_attn.{name}", (*ca, name))
    ln(f"{pj}.layer_norm", ("projector", "layer_norm"))
    for name in ("linear_in", "linear_out"):
        dense(f"{pj}.feed_forward.{name}", ("projector", "feed_forward", name),
              False)
    return out


def params_from_torch_state_dict(state: Mapping[str, Any], cfg: AriaConfig,
                                 dtype=torch.float32, device="cuda"):
    """The port's Aria params from a {HF name: tensor} mapping (either
    layout).  Values are fetched one at a time (`state` may be a
    `CheckpointShards`, whose `release` is called once a tensor is copied),
    copied to `device`, cast to `dtype` and rearranged there."""
    keymap = {_normalize_key(k): k for k in state.keys()}
    release = getattr(state, "release", None)
    params = {"model": {"layers": [{} for _ in range(cfg.text.num_layers)]},
              "visual": {"encoder": [{} for _ in range(cfg.vision.num_layers)]},
              "projector": {}}
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
            x = x.permute(2, 3, 1, 0).reshape(-1, x.shape[0]).contiguous()
        node = params
        for k in path[:-1]:
            node = node[k] if isinstance(k, int) else node.setdefault(k, {})
        node[path[-1]] = x
    return params


def config_to_hf_dict(cfg: AriaConfig, torch_dtype: str = "bfloat16") -> dict:
    """HF-style config.json dict that AriaConfig.from_hf_config reads back
    (the Aria leg of publish.save_pretrained)."""
    t, v = cfg.text, cfg.vision
    return {
        "model_type": "aria",
        "image_token_index": cfg.image_token_id,
        "projector_patch_to_query_dict": {
            str(k): val for k, val in cfg.projector_patch_to_query},
        "max_value_projector_patch_to_query_dict": cfg.max_projector_queries,
        "torch_dtype": torch_dtype,
        "text_config": {
            "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads,
            "num_key_value_heads": t.num_kv_heads,
            "rms_norm_eps": t.rms_norm_eps,
            "rope_theta": t.rope_theta,
            "tie_word_embeddings": t.tie_word_embeddings,
            "max_position_embeddings": t.max_position_embeddings,
            "attention_bias": t.attention_bias,
            "moe_num_experts": t.moe_num_experts,
            "moe_topk": t.moe_topk,
            "moe_num_shared_experts": t.moe_num_shared_experts,
        },
        "vision_config": {
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads,
            "num_channels": v.num_channels,
            "patch_size": v.patch_size,
            "image_size": v.image_size,
            "layer_norm_eps": v.layer_norm_eps,
        },
    }


def export_to_safetensors(params, cfg: AriaConfig, path_or_dir: str,
                          max_shard_bytes: int | None = None) -> str:
    """The inverse mapping: params -> HF-named tensors in the current
    transformers layout, each in its own dtype, rearranged on the params'
    device and copied to the host one at a time.  A path ending in
    ".safetensors" gets one file; any other path is a checkpoint directory
    that gets config.json and either model.safetensors or, with
    `max_shard_bytes`, HF's shards and index."""
    v = cfg.vision
    patch_shape = (v.hidden_size, v.num_channels, v.patch_size, v.patch_size)
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
                lambda p=p: p.reshape(v.patch_size, v.patch_size,
                                      v.num_channels, v.hidden_size)
                .permute(3, 2, 0, 1).contiguous())
        else:
            shape, produce = tuple(p.shape), (lambda p=p: p)
        specs.append(st.TensorSpec(_export_name(name), p.dtype, tuple(shape),
                                   produce))
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


def load_params_from_hf(checkpoint_dir: str, cfg: AriaConfig | None = None,
                        dtype=torch.bfloat16, device="cuda"):
    """Load an HF Aria checkpoint directory (config.json + one or more
    .safetensors) onto `device` -> (params, cfg).  Tensors stream one at a
    time from memory-mapped shards."""
    if cfg is None:
        with open(os.path.join(checkpoint_dir, CONFIG_FILE)) as f:
            cfg = AriaConfig.from_hf_config(json.load(f))
    with st.CheckpointShards(checkpoint_dir) as shards:
        params = params_from_torch_state_dict(shards, cfg, dtype, device)
    return params, cfg

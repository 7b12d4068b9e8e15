"""Decoder language model (M-RoPE, GQA) in PyTorch (counterpart of
spacer_tpu/models/qwen25_vl/language.py).

Params are a dict whose "layers" entry is a list of per-layer dicts (a
Python loop replaces lax.scan).  The KV cache is {"k": [...], "v": [...]},
one (B, T, Hkv, Dh) tensor per layer, written IN PLACE at `cache_index`
(JAX's donated dynamic_update_slice).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from spacer_tpu_torch.models.qwen25_vl.config import TextConfig
from spacer_tpu_torch.nn.attention import dot_product_attention
from spacer_tpu_torch.nn.core import (
    dense,
    dense_init,
    embed,
    embed_init,
    rms_norm,
    rms_norm_init,
)
from spacer_tpu_torch.nn.rope import apply_rope, mrope_cos_sin, rope_inv_freq

Params = Any


def init_lm_params(cfg: TextConfig, *, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> Params:
    """Random LM params with spacer_tpu's init scales, drawn from `generator`
    (which must live on `device`)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(generator=generator, dtype=dtype, device=device)

    def layer():
        return {
            "input_layernorm": rms_norm_init(D, dtype, device),
            "post_attention_layernorm": rms_norm_init(D, dtype, device),
            "self_attn": {
                "q_proj": dense_init(D, H * Dh, True, **kw),
                "k_proj": dense_init(D, Hkv * Dh, True, **kw),
                "v_proj": dense_init(D, Hkv * Dh, True, **kw),
                "o_proj": dense_init(H * Dh, D, False, **kw),
            },
            "mlp": {
                "gate_proj": dense_init(D, I, False, **kw),
                "up_proj": dense_init(D, I, False, **kw),
                "down_proj": dense_init(I, D, False, **kw),
            },
        }

    params = {
        "embed_tokens": embed_init(cfg.vocab_size, D, **kw),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "norm": rms_norm_init(D, dtype, device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense_init(D, cfg.vocab_size, False, **kw)
    return params


def init_kv_cache(cfg: TextConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
    }


def _mlp_block(p_mlp, x, cfg: TextConfig):
    """SwiGLU feed-forward."""
    gate = F.silu(dense(p_mlp["gate_proj"], x))
    return dense(p_mlp["down_proj"], gate * dense(p_mlp["up_proj"], x))


def _layer(h, layer_params, cache_kv, *, cfg: TextConfig, cos, sin, kv_mask,
           cache_index: int):
    """One decoder layer. h: (B, S, D); cache_kv: (k, v) tensors of this
    layer, updated in place, or None."""
    B, S, _ = h.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p_attn = layer_params["self_attn"]

    x = rms_norm(layer_params["input_layernorm"], h, cfg.rms_norm_eps)
    q = dense(p_attn["q_proj"], x).reshape(B, S, H, Dh)
    k = dense(p_attn["k_proj"], x).reshape(B, S, Hkv, Dh)
    v = dense(p_attn["v_proj"], x).reshape(B, S, Hkv, Dh)
    q, k = apply_rope(q, k, cos, sin)

    q_offset = 0
    if cache_kv is not None:
        ck, cv = cache_kv
        ck[:, cache_index:cache_index + S] = k   # in-place cache write
        cv[:, cache_index:cache_index + S] = v
        k, v = ck.to(q.dtype), cv.to(q.dtype)
        q_offset = cache_index

    attn = dot_product_attention(q, k, v, causal=True, kv_mask=kv_mask,
                                 q_offset=q_offset)
    h = h + dense(p_attn["o_proj"], attn.reshape(B, S, H * Dh))
    x = rms_norm(layer_params["post_attention_layernorm"], h, cfg.rms_norm_eps)
    return h + _mlp_block(layer_params["mlp"], x, cfg)


def split_layers(stacked, num_layers: int):
    """Stacked (L, ...) nested dict of arrays/tensors -> tuple of L
    per-layer nested dicts."""
    def take(tree, l):
        if isinstance(tree, dict):
            return {k: take(v, l) for k, v in tree.items()}
        return tree[l]

    return tuple(take(stacked, l) for l in range(num_layers))


def lm_head(params, cfg: TextConfig, h):
    if cfg.tie_word_embeddings:
        return torch.matmul(h, params["embed_tokens"]["embedding"].T)
    return dense(params["lm_head"], h)


def lm_forward(params: Params, cfg: TextConfig, *,
               input_ids: Optional[torch.Tensor] = None,
               input_embeds: Optional[torch.Tensor] = None,
               position_ids: Optional[torch.Tensor] = None,
               kv_mask: Optional[torch.Tensor] = None, cache=None,
               cache_index: int = 0, last_only: bool = False):
    """Run the causal LM -> (logits, cache).

    With `cache`, the current block's keys/values are written in place at
    `cache_index` and attention runs over the whole cache (masked by
    `kv_mask`, which then covers the cache length).  `last_only` computes
    the LM head at the last position only ((B, 1, V) logits), which is all
    a prefill for sampling reads."""
    if input_embeds is None:
        input_embeds = embed(params["embed_tokens"], input_ids)
    B, S, _ = input_embeds.shape
    dev = input_embeds.device
    if position_ids is None:
        position_ids = torch.arange(S, device=dev)[None, None].expand(3, B, S)
    if cache is not None:
        T = cache["k"][0].shape[1]
        if not 0 <= cache_index <= T - S:
            raise ValueError(f"cache_index {cache_index} + {S} tokens exceeds "
                             f"the cache length {T}")
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=dev)
    cos, sin = mrope_cos_sin(position_ids, inv_freq, cfg.mrope_section)

    h = input_embeds
    for l, lp in enumerate(params["layers"]):
        kv = None if cache is None else (cache["k"][l], cache["v"][l])
        h = _layer(h, lp, kv, cfg=cfg, cos=cos, sin=sin, kv_mask=kv_mask,
                   cache_index=cache_index)
    h = rms_norm(params["norm"], h, cfg.rms_norm_eps)
    if last_only:
        h = h[:, -1:]
    return lm_head(params, cfg, h), cache

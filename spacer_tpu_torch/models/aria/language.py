"""Aria text model: a Llama-style decoder with the MoE feed-forward
(counterpart of spacer_tpu/models/aria/language.py).

The compute engine is the shared decoder of models/qwen25_vl/language.py:
Aria's plain RoPE rides its M-RoPE path with the three position rows equal
(mrope_section puts every rotary channel on row 0), and cfg.moe_topk > 0
selects ops/moe.py's feed-forward.  The KV cache layouts, the grouped
rollout decode and the serving decode are therefore those of Qwen.
"""

from __future__ import annotations

from typing import Any

import torch

from spacer_tpu_torch.models.aria.config import AriaTextConfig
from spacer_tpu_torch.models.qwen25_vl.language import (  # noqa: F401  (re-exports)
    init_kv_cache,
    lm_decode_step,
    lm_decode_step_split,
    lm_forward,
    split_layers,
)
from spacer_tpu_torch.nn.core import dense_init, embed_init, rms_norm_init
from spacer_tpu_torch.ops.moe import init_moe_params

Params = Any


def init_lm_params(cfg: AriaTextConfig, *, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> Params:
    """Random Aria LM params in the port's per-layer layout, with
    spacer_tpu's init scales, drawn from `generator` (on `device`)."""
    D = cfg.hidden_size
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bias = cfg.attention_bias
    kw = dict(generator=generator, dtype=dtype, device=device)

    def layer():
        return {
            "input_layernorm": rms_norm_init(D, dtype, device),
            "post_attention_layernorm": rms_norm_init(D, dtype, device),
            "self_attn": {
                "q_proj": dense_init(D, H * Dh, bias, **kw),
                "k_proj": dense_init(D, Hkv * Dh, bias, **kw),
                "v_proj": dense_init(D, Hkv * Dh, bias, **kw),
                "o_proj": dense_init(H * Dh, D, False, **kw),
            },
            "mlp": init_moe_params(D, cfg.intermediate_size,
                                   cfg.moe_num_experts,
                                   cfg.moe_num_shared_experts, **kw),
        }

    params = {
        "embed_tokens": embed_init(cfg.vocab_size, D, **kw),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "norm": rms_norm_init(D, dtype, device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense_init(D, cfg.vocab_size, False, **kw)
    return params


def positions_1d_to_3d(position_ids):
    """(B, S) plain positions -> (3, B, S) for the shared M-RoPE engine
    (with equal rows it computes plain RoPE exactly)."""
    return position_ids[None].expand(3, *position_ids.shape)

"""Aria vision tower (Idefics3 / SigLIP ViT) and perceiver projector
(counterpart of spacer_tpu/models/aria/vision.py).

Behavioral reference: transformers modeling_idefics3.py (the NaViT bucketed
position embeddings, Idefics3VisionAttention, the MLP, the encoder layer)
and modeling_aria.py (AriaCrossAttention, AriaProjector).

- The stride-p conv patch embedding is a reshape and one dense over
  (N, Hp*Wp, p*p*C) rows in (dy, dx, c) order (the loader permutes HF's
  conv kernel to match).
- The bucketed position ids are computed on the host per image geometry
  (`vision_position_ids`, numpy) and passed in.
- Attention runs at head_dim 72 (1152 / 16 heads) through
  nn.attention.dot_product_attention: K1 on CUDA tensors, the plain
  version on CPU tensors, with the patch mask as the kv mask.
- Under tensor parallelism (parallel/tp.py) each encoder layer runs on
  this rank's heads (16 / tp at head_dim 72, through K1 on the card) and
  fc1 columns; out_proj and fc2 are row-parallel with their bias added
  after the all-reduce.  The embeddings and the projector stay whole: the
  projector runs on every rank on the whole features.
- Aria reads the tower at vision_feature_layer = -1, which in HF indexes
  the recorded hidden states: the last encoder layer's output, before
  post_layernorm.  `vit_forward` returns both.

Params follow the port's layout: "encoder" is a list of per-layer dicts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from spacer_tpu_torch.models.aria.config import AriaConfig, AriaVisionConfig
from spacer_tpu_torch.nn.attention import dot_product_attention
from spacer_tpu_torch.nn.core import (
    dense,
    dense_init,
    embed_init,
    layer_norm,
    layer_norm_init,
)
from spacer_tpu_torch.parallel import tp
from spacer_tpu_torch.parallel.fsdp import gather

Params = Any

# the projector's norms are plain nn.LayerNorm (torch's default eps), unlike
# the tower's config-driven 1e-6
PROJECTOR_EPS = 1e-5


def init_vit_params(cfg: AriaVisionConfig, *, generator: torch.Generator,
                    dtype=torch.float32, device=None) -> Params:
    D, I = cfg.hidden_size, cfg.intermediate_size
    P = cfg.num_patches_per_side ** 2
    patch_dim = cfg.num_channels * cfg.patch_size ** 2
    kw = dict(generator=generator, dtype=dtype, device=device)

    def layer():
        return {
            "layer_norm1": layer_norm_init(D, dtype, device),
            "layer_norm2": layer_norm_init(D, dtype, device),
            "self_attn": {name: dense_init(D, D, True, **kw)
                          for name in ("q_proj", "k_proj", "v_proj",
                                       "out_proj")},
            "mlp": {"fc1": dense_init(D, I, True, **kw),
                    "fc2": dense_init(I, D, True, **kw)},
        }

    return {
        "embeddings": {
            "patch_embedding": dense_init(patch_dim, D, True, **kw),
            "position_embedding": embed_init(P, D, **kw),
        },
        "encoder": [layer() for _ in range(cfg.num_layers)],
        "post_layernorm": layer_norm_init(D, dtype, device),
    }


def vision_position_ids(nb_patches_h: int, nb_patches_w: int,
                        cfg: AriaVisionConfig, max_h: int | None = None,
                        max_w: int | None = None) -> np.ndarray:
    """Bucketed NaViT position ids of one image (host numpy): fractional
    patch coordinates over the valid (unpadded) grid, bucketized into the
    pretrained num_patches_per_side grid.  Padded slots (beyond
    nb_patches_h / w inside the max grid) get id 0; they are masked out of
    attention."""
    side = cfg.num_patches_per_side
    max_h = max_h or nb_patches_h
    max_w = max_w or nb_patches_w
    boundaries = np.arange(1 / side, 1.0, 1 / side)
    frac_h = np.arange(nb_patches_h) / nb_patches_h * (1 - 1e-6)
    frac_w = np.arange(nb_patches_w) / nb_patches_w * (1 - 1e-6)
    bucket_h = np.searchsorted(boundaries, frac_h, side="right")
    bucket_w = np.searchsorted(boundaries, frac_w, side="right")
    ids = np.zeros((max_h, max_w), np.int32)
    ids[:nb_patches_h, :nb_patches_w] = (
        bucket_h[:, None] * side + bucket_w[None, :])
    return ids.reshape(-1)


def patchify(pixel_values, patch_size: int):
    """(N, H, W, C) -> (N, Hp*Wp, p*p*C) rows in conv-sliding order, each
    row's features in (dy, dx, c) order."""
    N, H, W, C = pixel_values.shape
    p = patch_size
    x = pixel_values.reshape(N, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)   # (N, Hp, Wp, p, p, C)
    return x.reshape(N, (H // p) * (W // p), p * p * C)


def _vit_layer(h, lp, kv_mask, *, eps: float, num_heads: int,
               intermediate: int):
    """One encoder layer; under tensor parallelism q/k/v and fc1 are
    column-parallel (this rank's heads and columns, their bias columns),
    out_proj and fc2 row-parallel with their bias after the all-reduce."""
    N, S, D = h.shape
    Dh = D // num_heads
    H = tp.local_heads(num_heads, "the tower's num_heads")
    x = tp.copy_to_tp(layer_norm(lp["layer_norm1"], h, eps))
    attn = lp["self_attn"]
    q = tp.column(attn["q_proj"], x, D).reshape(N, S, H, Dh)
    k = tp.column(attn["k_proj"], x, D).reshape(N, S, H, Dh)
    v = tp.column(attn["v_proj"], x, D).reshape(N, S, H, Dh)
    o = dot_product_attention(q, k, v, kv_mask=kv_mask)
    h = h + tp.row(attn["out_proj"], o.reshape(N, S, H * Dh), D)

    x = tp.copy_to_tp(layer_norm(lp["layer_norm2"], h, eps))
    x = F.gelu(tp.column(lp["mlp"]["fc1"], x, intermediate),
               approximate="tanh")
    return h + tp.row(lp["mlp"]["fc2"], x, intermediate)


def vit_forward(params: Params, cfg: AriaVisionConfig, pixel_values,
                position_ids, patch_mask=None, remat: bool = False):
    """pixel_values (N, H, W, C) in [-1, 1] (SigLIP normalization is the
    processor's), position_ids (N, Hp*Wp) int from `vision_position_ids`,
    patch_mask (N, Hp*Wp) bool (True = a real patch).  `remat` recomputes
    each layer in the backward pass.

    Returns (last layer's hidden, post-layernormed): the former feeds the
    projector (HF vision_feature_layer = -1), the latter is the tower's
    last_hidden_state."""
    params = gather(params, keep=("encoder",))
    patches = patchify(pixel_values, cfg.patch_size)
    h = dense(params["embeddings"]["patch_embedding"], patches)
    h = h + params["embeddings"]["position_embedding"]["embedding"][
        position_ids.long()]
    kw = dict(eps=cfg.layer_norm_eps, num_heads=cfg.num_heads,
              intermediate=cfg.intermediate_size)
    remat = remat and torch.is_grad_enabled()
    for lp in params["encoder"]:
        # fsdp Shards gathered inside the (checkpointed) layer
        if remat:
            h = checkpoint(
                lambda x, lp=lp: _vit_layer(x, gather(lp), patch_mask, **kw),
                h, use_reentrant=False)
        else:
            h = _vit_layer(h, gather(lp), patch_mask, **kw)
    return h, layer_norm(params["post_layernorm"], h, cfg.layer_norm_eps)


def init_projector_params(cfg: AriaConfig, *, generator: torch.Generator,
                          dtype=torch.float32, device=None) -> Params:
    Dv, Dt = cfg.vision.hidden_size, cfg.text.hidden_size
    Q = cfg.max_projector_queries
    kw = dict(generator=generator, dtype=dtype, device=device)
    query = torch.empty((Q, Dv), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(query, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return {
        "query": query.mul_(0.02).to(dtype),
        "cross_attn": {
            "q_proj": dense_init(Dv, Dv, False, **kw),
            "k_proj": dense_init(Dv, Dv, False, **kw),
            "v_proj": dense_init(Dv, Dv, False, **kw),
            # torch nn.MultiheadAttention's own packed input projection on
            # top of q/k/v_proj (an Aria quirk kept for checkpoint parity)
            "mha_in_proj": dense_init(Dv, 3 * Dv, True, **kw),
            "mha_out_proj": dense_init(Dv, Dv, True, **kw),
            "linear": dense_init(Dv, Dv, True, **kw),
            "layer_norm": layer_norm_init(Dv, dtype, device),
            "layer_norm_kv": layer_norm_init(Dv, dtype, device),
        },
        "layer_norm": layer_norm_init(Dv, dtype, device),
        "feed_forward": {
            "linear_in": dense_init(Dv, Dt, False, **kw),
            "linear_out": dense_init(Dt, Dt, False, **kw),
        },
    }


def projector_forward(params: Params, cfg: AriaConfig, features,
                      patch_mask=None):
    """features (N, Np, Dv) -> (N, Q, Dt), Q = patch_to_query[Np]: learned
    queries, layer-normed then projected twice (q_proj, then the MHA
    in-projection), cross-attend to the layer-normed, twice-projected patch
    features (K1 at head_dim 72 on the card, Sq = Q against Skv = Np)."""
    N, Np, Dv = features.shape
    num_heads = cfg.vision.num_heads
    Dh = Dv // num_heads
    query_num = cfg.patch_to_query.get(Np)
    if query_num is None:
        raise KeyError(f"Number of patches {Np} not in patch_to_query "
                       f"{sorted(cfg.patch_to_query)}")
    p = params["cross_attn"]
    queries = params["query"][None, :query_num].expand(
        N, query_num, Dv).to(features.dtype)

    eps = PROJECTOR_EPS
    q = dense(p["q_proj"], layer_norm(p["layer_norm"], queries, eps))
    kv = layer_norm(p["layer_norm_kv"], features, eps)
    k = dense(p["k_proj"], kv)
    v = dense(p["v_proj"], kv)

    in_k, in_b = p["mha_in_proj"]["kernel"], p["mha_in_proj"]["bias"]
    q = torch.matmul(q, in_k[:, :Dv]) + in_b[:Dv]
    k = torch.matmul(k, in_k[:, Dv:2 * Dv]) + in_b[Dv:2 * Dv]
    v = torch.matmul(v, in_k[:, 2 * Dv:]) + in_b[2 * Dv:]

    attn = dot_product_attention(
        q.reshape(N, query_num, num_heads, Dh),
        k.reshape(N, Np, num_heads, Dh),
        v.reshape(N, Np, num_heads, Dh),
        kv_mask=patch_mask,
    ).reshape(N, query_num, Dv)
    attn = dense(p["linear"], dense(p["mha_out_proj"], attn))

    out = layer_norm(params["layer_norm"], attn, eps)
    ff = params["feed_forward"]
    out = F.gelu(dense(ff["linear_in"], out), approximate="tanh")  # gelu_new
    return dense(ff["linear_out"], out)

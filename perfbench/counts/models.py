"""The model operations that served tokens require, from shapes alone (the
numerator of `mfu`): a multiply-add counts two; matrix products by their
weights' shapes; attention over the visible pairs only; no padding, no
recomputation; the LM head only where a token is sampled (the last prompt
position and every decoded token).  Per-token operations of a language
model: 2 x (the matrix weights a token passes through) + 4 x head dim x
heads x (keys it sees), per layer.
"""

from __future__ import annotations

from counts import kernels


def lm_dims(config: dict) -> dict:
    """Language-model sizes of a configuration file, either family."""
    m = config["model"]
    t = m.get("text_config", m)
    D, H = t["hidden_size"], t["num_attention_heads"]
    d = {"D": D, "H": H, "Hkv": t["num_key_value_heads"], "Dh": D // H,
         "I": t["intermediate_size"], "V": t["vocab_size"],
         "L": t["num_hidden_layers"], "E": t.get("moe_num_experts", 0),
         "topk": t.get("moe_topk", 0), "shared": t.get("moe_num_shared_experts", 0)}
    return d


def layer_matmul_weights(d: dict) -> float:
    """Weights of one layer's products that one token passes through."""
    attn = d["D"] * d["Dh"] * (2 * d["H"] + 2 * d["Hkv"])
    if d["topk"]:
        routed = d["topk"] * 3 * d["D"] * d["I"]
        shared = 3 * d["D"] * d["I"] * d["shared"]
        return attn + d["D"] * d["E"] + routed + shared
    return attn + 3 * d["D"] * d["I"]


def lm_tokens(d: dict, n_tokens: int, pairs: int, heads: int) -> float:
    """n_tokens through every layer with `pairs` visible (query, key)
    pairs in all, plus the LM head for `heads` of them."""
    per_layer = 2.0 * n_tokens * layer_matmul_weights(d) + 4.0 * pairs * d["H"] * d["Dh"]
    return d["L"] * per_layer + 2.0 * heads * d["D"] * d["V"]


def prefill(config: dict, prompt_len: int) -> float:
    """One prompt's prefill, its first token sampled."""
    d = lm_dims(config)
    return lm_tokens(d, prompt_len, prompt_len * (prompt_len + 1) // 2, 1)


def decode(config: dict, prompt_len: int, steps: int, first: int = 1) -> float:
    """Decode steps first .. first + steps - 1 of one request (step j sees
    prompt_len + j keys)."""
    d = lm_dims(config)
    keys = sum(prompt_len + j for j in range(first, first + steps))
    return lm_tokens(d, steps, keys, steps)


def vit(config: dict, grid) -> float:
    """One video's ViT: patch embed, every block (its products and its
    window or frame-chunk attention), the merger."""
    vc = config["model"]["vision_config"]
    t, h, w = grid
    S = t * h * w
    D, I = vc["hidden_size"], vc["intermediate_size"]
    mu = vc["spatial_merge_size"] ** 2
    patch = 3 * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    blocks = 2.0 * S * vc["depth"] * (3 * D * D + D * D + 3 * D * I)
    attn = kernels.k3_vit(grid, vc)[1] + kernels.k4_vit(grid, vc)[1]
    merger = 2.0 * (S // mu) * (mu * D * mu * D + mu * D * vc["out_hidden_size"])
    return 2.0 * S * patch * D + blocks + attn + merger

"""Random weights made by the benchmark from the seed, on the card, in the
served dtype, in the parameter tree the port reads (dense kernels (in, out),
embeddings (vocab, dim), norm scales (dim,)).  Both sides get this same tree:
the program serves it and the reference reads it.

One draw fills every leaf at once: a flat buffer of standard normals from a
torch.Generator on the device, each leaf a view into it at an offset aligned
to 128 bytes, then one scale-and-shift per group of leaves that share their
statistics (leaves are laid out grouped).  Kernels have standard deviation
fan_in ** -0.5, biases 0.02, norm scales mean 1 and deviation 0.1 (so a
dropped scale or bias shows in the comparison), embeddings 0.02; Aria's
router is drawn wider (config `assumed.router_logit_std`) so that its
softmax over the chosen experts is peaked, as a trained router's is, and
a near-tie between the k-th and (k+1)-th expert moves the output little.
"""

from __future__ import annotations

import math

import torch

ALIGN = 64   # elements (128 bytes of bf16)


def qwen25_vl_leaves(model: dict) -> list:
    """[(path, shape, mean, std)] of Qwen2.5-VL's LM and ViT."""
    D, I, V = model["hidden_size"], model["intermediate_size"], model["vocab_size"]
    H, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    Dh = D // H
    vc = model["vision_config"]
    vD, vI = vc["hidden_size"], vc["intermediate_size"]
    patch = 3 * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    mu = vc["spatial_merge_size"] ** 2
    out = [(("model", "embed_tokens", "embedding"), (V, D), 0.0, 0.02),
           (("model", "norm", "scale"), (D,), 1.0, 0.1),
           (("model", "lm_head", "kernel"), (D, V), 0.0, D ** -0.5)]
    for l in range(model["num_hidden_layers"]):
        p = ("model", "layers", l)
        out += [(p + ("input_layernorm", "scale"), (D,), 1.0, 0.1),
                (p + ("post_attention_layernorm", "scale"), (D,), 1.0, 0.1)]
        for name, n in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)):
            out += [(p + ("self_attn", name, "kernel"), (D, n * Dh), 0.0, D ** -0.5),
                    (p + ("self_attn", name, "bias"), (n * Dh,), 0.0, 0.02)]
        out += [(p + ("self_attn", "o_proj", "kernel"), (H * Dh, D), 0.0, (H * Dh) ** -0.5),
                (p + ("mlp", "gate_proj", "kernel"), (D, I), 0.0, D ** -0.5),
                (p + ("mlp", "up_proj", "kernel"), (D, I), 0.0, D ** -0.5),
                (p + ("mlp", "down_proj", "kernel"), (I, D), 0.0, I ** -0.5)]
    out.append((("visual", "patch_embed", "proj", "kernel"), (patch, vD), 0.0,
                patch ** -0.5))
    for b in range(vc["depth"]):
        p = ("visual", "blocks", b)
        out += [(p + ("norm1", "scale"), (vD,), 1.0, 0.1),
                (p + ("norm2", "scale"), (vD,), 1.0, 0.1)]
        for name, (i, o) in (("attn.qkv", (vD, 3 * vD)), ("attn.proj", (vD, vD)),
                             ("mlp.gate_proj", (vD, vI)), ("mlp.up_proj", (vD, vI)),
                             ("mlp.down_proj", (vI, vD))):
            q = p + tuple(name.split("."))
            out += [(q + ("kernel",), (i, o), 0.0, i ** -0.5),
                    (q + ("bias",), (o,), 0.0, 0.02)]
    m = ("visual", "merger")
    out += [(m + ("ln_q", "scale"), (vD,), 1.0, 0.1),
            (m + ("mlp_0", "kernel"), (mu * vD, mu * vD), 0.0, (mu * vD) ** -0.5),
            (m + ("mlp_0", "bias"), (mu * vD,), 0.0, 0.02),
            (m + ("mlp_2", "kernel"), (mu * vD, vc["out_hidden_size"]), 0.0,
             (mu * vD) ** -0.5),
            (m + ("mlp_2", "bias"), (vc["out_hidden_size"],), 0.0, 0.02)]
    return out


def aria_leaves(model: dict, router_logit_std: float) -> list:
    """[(path, shape, mean, std)] of Aria's language model (the cells that
    use it are text only, so its vision tower is not made)."""
    tc = model["text_config"]
    D, I, V = tc["hidden_size"], tc["intermediate_size"], tc["vocab_size"]
    H, Hkv = tc["num_attention_heads"], tc["num_key_value_heads"]
    E, Is = tc["moe_num_experts"], tc["intermediate_size"] * tc["moe_num_shared_experts"]
    Dh = D // H
    out = [(("model", "embed_tokens", "embedding"), (V, D), 0.0, 0.02),
           (("model", "norm", "scale"), (D,), 1.0, 0.1),
           (("model", "lm_head", "kernel"), (D, V), 0.0, D ** -0.5)]
    for l in range(tc["num_hidden_layers"]):
        p = ("model", "layers", l)
        out += [(p + ("input_layernorm", "scale"), (D,), 1.0, 0.1),
                (p + ("post_attention_layernorm", "scale"), (D,), 1.0, 0.1)]
        for name, n in (("q_proj", H), ("k_proj", Hkv), ("v_proj", Hkv)):
            out.append((p + ("self_attn", name, "kernel"), (D, n * Dh), 0.0, D ** -0.5))
        out += [(p + ("self_attn", "o_proj", "kernel"), (H * Dh, D), 0.0, (H * Dh) ** -0.5),
                (p + ("mlp", "router", "kernel"), (D, E), 0.0,
                 router_logit_std / math.sqrt(D)),
                (p + ("mlp", "experts", "fc1", "kernel"), (E, D, 2 * I), 0.0, D ** -0.5),
                (p + ("mlp", "experts", "fc2", "kernel"), (E, I, D), 0.0, I ** -0.5),
                (p + ("mlp", "shared", "gate_proj", "kernel"), (D, Is), 0.0, D ** -0.5),
                (p + ("mlp", "shared", "up_proj", "kernel"), (D, Is), 0.0, D ** -0.5),
                (p + ("mlp", "shared", "down_proj", "kernel"), (Is, D), 0.0, Is ** -0.5)]
    return out


def leaves_for(family: str, model: dict, assumed: dict) -> list:
    if family == "qwen25_vl":
        return qwen25_vl_leaves(model)
    if family == "aria":
        return aria_leaves(model, assumed["router_logit_std"])
    raise ValueError(f"unknown family {family!r}")


def _tree(leaves, tensors) -> dict:
    """Nested dicts, with lists where the path holds an int (layers)."""
    root: dict = {}
    for (path, _shape, _m, _s), t in zip(leaves, tensors):
        node = root
        for i, key in enumerate(path[:-1]):
            nxt = path[i + 1]
            if isinstance(key, int):
                continue
            want = [] if isinstance(nxt, int) else {}
            node = node.setdefault(key, want)
            if isinstance(nxt, int):
                while len(node) <= nxt:
                    node.append({})
                node = node[nxt]
        node[path[-1]] = t
    return root


def make(family: str, model: dict, assumed: dict, seed: int, device,
         dtype=torch.bfloat16) -> dict:
    """The parameter tree of `family` at `model`'s sizes, drawn from `seed`."""
    leaves = leaves_for(family, model, assumed)
    order = sorted(range(len(leaves)), key=lambda i: (leaves[i][2], leaves[i][3]))
    offsets, pos = [0] * len(leaves), 0
    for i in order:
        offsets[i] = pos
        pos += -(-math.prod(leaves[i][1]) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.empty(pos, dtype=dtype, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    start = 0
    for j, i in enumerate(order):
        stats = leaves[i][2:]
        last = j + 1 == len(order) or leaves[order[j + 1]][2:] != stats
        if last:
            end = offsets[i] + math.prod(leaves[i][1])
            flat[start:end].mul_(stats[1]).add_(stats[0])
            if j + 1 < len(order):
                start = offsets[order[j + 1]]
    tensors = [flat[o:o + math.prod(s)].view(s)
               for (_p, s, _m, _sd), o in zip(leaves, offsets)]
    return _tree(leaves, tensors)


def count(family: str, model: dict, assumed: dict) -> int:
    """Parameters the tree holds."""
    return sum(math.prod(s) for _p, s, _m, _sd in leaves_for(family, model, assumed))

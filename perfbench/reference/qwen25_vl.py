"""Plain float32 Qwen2.5-VL: the vision transformer (windowed and full
attention, 2x2 merger) and the M-RoPE language model, written from the
published description (transformers' modeling_qwen2_5_vl.py: get_window_index,
rot_pos_emb, get_rope_index, the decoder layer) and reading the parameter
tree the benchmark made.  Nothing of the program is imported.

`served_gaps` runs each sampled request once, unpadded, over its prompt and
the tokens the program served, layer by layer for all of them together (one
float32 copy of one layer's weights at a time), and returns for every served
token how far its logit lies below the best one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import (
    Precision,
    causal_attention,
    exact_float32,
    gaps,
    rms_norm,
    rope,
    rope_freqs,
    segment_attention,
)


# -- vision ----------------------------------------------------------------

def window_index(grid, vc: dict):
    """(merge-unit permutation into window order, token counts of the
    windows) for one (t, h, w) grid, as get_window_index orders them."""
    t, h, w = grid
    m = vc["spatial_merge_size"]
    ws = vc["window_size"] // m // vc["patch_size"]
    lh, lw = h // m, w // m
    idx = np.arange(t * lh * lw).reshape(t, lh, lw)
    ph, pw = ws - lh % ws, ws - lw % ws
    padded = np.full((t, lh + ph, lw + pw), -1)
    padded[:, :lh, :lw] = idx
    nh, nw = (lh + ph) // ws, (lw + pw) // ws
    padded = padded.reshape(t, nh, ws, nw, ws).transpose(0, 1, 3, 2, 4)
    padded = padded.reshape(t, nh * nw, ws * ws)
    counts = (padded >= 0).sum(-1).reshape(-1) * m * m
    return padded[padded >= 0], counts


def patch_positions(grid, m: int):
    """(t*h*w, 2) (row, column) of each patch in the packed order: merge
    blocks of m x m patches, row-major within and between blocks."""
    t, h, w = grid
    hp = np.arange(h)[:, None].repeat(w, 1)
    wp = np.arange(w)[None, :].repeat(h, 0)

    def blocks(a):
        return a.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)

    return np.tile(np.stack([blocks(hp), blocks(wp)], -1), (t, 1))


def vision_encode(vp: dict, vc: dict, pixels, grid, prec: Precision):
    """(t*h*w, patch dim) patches of one video -> (t*h*w / 4, out hidden)
    embeddings in the packed (merge-unit) order."""
    dev = pixels.device
    t, h, w = grid
    m = vc["spatial_merge_size"]
    mu = m * m
    D, H = vc["hidden_size"], vc["num_heads"]
    Dh = D // H
    full = set(vc["fullatt_block_indexes"])
    order, win_counts = window_index(grid, vc)
    order_t = torch.as_tensor(order, device=dev)

    x = prec.linear(pixels.float(), prec.weight(vp["patch_embed"]["proj"]["kernel"]))
    S = x.shape[0]
    x = x.reshape(S // mu, mu, D)[order_t].reshape(S, D)
    pos = torch.as_tensor(patch_positions(grid, m), device=dev)
    pos = pos.reshape(S // mu, mu, 2)[order_t].reshape(S, 2).float()
    inv = rope_freqs(Dh // 2, 10000.0, dev)
    ang = torch.cat([pos[:, :1] * inv, pos[:, 1:] * inv], -1)
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    frame_counts = [h * w] * t

    for li, bp in enumerate(vp["blocks"]):
        a = bp["attn"]
        y = rms_norm(x, bp["norm1"]["scale"], 1e-6)
        qkv = prec.linear(y, prec.weight(a["qkv"]["kernel"]), a["qkv"]["bias"])
        q, k, v = qkv.reshape(S, 3, H, Dh).unbind(1)
        q, k = rope(q, cos, sin), rope(k, cos, sin)
        lengths = frame_counts if li in full else win_counts.tolist()
        o = segment_attention(q, k, v, lengths).reshape(S, D)
        x = x + prec.linear(o, prec.weight(a["proj"]["kernel"]), a["proj"]["bias"])
        mp = bp["mlp"]
        y = rms_norm(x, bp["norm2"]["scale"], 1e-6)
        g = F.silu(prec.linear(y, prec.weight(mp["gate_proj"]["kernel"]),
                               mp["gate_proj"]["bias"]))
        u = prec.linear(y, prec.weight(mp["up_proj"]["kernel"]), mp["up_proj"]["bias"])
        x = x + prec.linear(g * u, prec.weight(mp["down_proj"]["kernel"]),
                            mp["down_proj"]["bias"])

    mg = vp["merger"]
    y = rms_norm(x, mg["ln_q"]["scale"], 1e-6).reshape(S // mu, mu * D)
    y = F.gelu(prec.linear(y, prec.weight(mg["mlp_0"]["kernel"]), mg["mlp_0"]["bias"]))
    y = prec.linear(y, prec.weight(mg["mlp_2"]["kernel"]), mg["mlp_2"]["bias"])
    return y[torch.as_tensor(np.argsort(order), device=dev)]


# -- M-RoPE positions ------------------------------------------------------

def mrope_positions(ids: np.ndarray, grid, model: dict, second_per_grid: float,
                    total: int) -> np.ndarray:
    """(3, total) positions of a sequence whose first len(ids) tokens are the
    prompt (text, then one video's placeholders, then text) and the rest
    generated text: text advances all three rows by one; the video's tokens
    take (t * second_per_grid * tokens_per_second, row, column) after the
    text before them; text after a video continues from its largest
    position plus one."""
    vc = model["vision_config"]
    m = vc["spatial_merge_size"]
    vid = model["video_token_id"]
    where = np.flatnonzero(ids == vid)
    pos = np.zeros((3, total), np.int64)
    if len(where) == 0:
        pos[:] = np.arange(total)
        return pos
    a = int(where[0])
    t, h, w = grid
    lt, lh, lw = t, h // m, w // m
    if len(where) != lt * lh * lw or where[-1] != a + len(where) - 1:
        raise ValueError("expected one contiguous video placeholder run")
    pos[:, :a] = np.arange(a)
    tt = (np.arange(lt) * second_per_grid * vc["tokens_per_second"]).astype(np.int64)
    pos[0, a:a + len(where)] = np.repeat(tt, lh * lw) + a
    pos[1, a:a + len(where)] = np.tile(np.repeat(np.arange(lh), lw), lt) + a
    pos[2, a:a + len(where)] = np.tile(np.arange(lw), lt * lh) + a
    nxt = int(pos[:, a:a + len(where)].max()) + 1
    rest = total - (a + len(where))
    pos[:, a + len(where):] = nxt + np.arange(rest)
    return pos


def mrope_cos_sin(pos: torch.Tensor, head_dim: int, theta: float, sections):
    """(3, S) positions -> cos, sin (S, head_dim): frequency band i of
    `sections` (repeated for both halves) takes position row i % 3."""
    inv = rope_freqs(head_dim, theta, pos.device)
    ang = pos.float()[..., None] * inv                   # (3, S, Dh/2)
    ang = torch.cat([ang, ang], -1)                      # (3, S, Dh)
    parts = torch.split(ang, list(sections) * 2, dim=-1)
    ang = torch.cat([p[i % 3] for i, p in enumerate(parts)], -1)
    return ang.cos(), ang.sin()


# -- language model --------------------------------------------------------

def decoder_layer(x, lp, cos, sin, model: dict, prec: Precision, mlp):
    """One pre-norm decoder layer over one unpadded sequence x (S, D);
    `mlp(y)` is the feed-forward (SwiGLU here, the MoE for Aria)."""
    H, Hkv = model["num_attention_heads"], model["num_key_value_heads"]
    Dh = model["hidden_size"] // H
    a = lp["self_attn"]
    S = x.shape[0]
    y = rms_norm(x, lp["input_layernorm"]["scale"], model["rms_norm_eps"])

    def proj(name, heads):
        p = a[name]
        return prec.linear(y, p["w"], p.get("bias")).reshape(S, heads, Dh)

    q, k, v = proj("q_proj", H), proj("k_proj", Hkv), proj("v_proj", Hkv)
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    o = causal_attention(q, k, v).reshape(S, H * Dh)
    x = x + prec.linear(o, a["o_proj"]["w"])
    y = rms_norm(x, lp["post_attention_layernorm"]["scale"], model["rms_norm_eps"])
    return x + mlp(y)


def attn_weights(lp, prec: Precision) -> dict:
    """The attention projections of one layer as `prec` holds them."""
    out = {}
    for name, p in lp["self_attn"].items():
        out[name] = {"w": prec.weight(p["kernel"])}
        if "bias" in p:
            out[name]["bias"] = p["bias"]
    return {"self_attn": out,
            "input_layernorm": lp["input_layernorm"],
            "post_attention_layernorm": lp["post_attention_layernorm"]}


def lm_logits(lm: dict, model: dict, embeds: list, cos_sin: list,
              n_served: list, prec: Precision, mlp_of) -> list:
    """Run the decoder layer by layer over every sequence (one float32 copy
    of one layer's weights at a time) -> per sequence the (n, vocab) logits
    of its last n = n_served[i] positions, each of which predicts the
    served token after it.  `mlp_of(layer's mlp params, prec)` gives the
    layer's feed-forward."""
    xs = [e.float() for e in embeds]
    for lp in lm["layers"]:
        w = attn_weights(lp, prec)
        mlp = mlp_of(lp["mlp"], prec)
        xs = [decoder_layer(x, w, c, s, model, prec, mlp)
              for x, (c, s) in zip(xs, cos_sin)]
        del w, mlp
    head = prec.weight(lm["lm_head"]["kernel"])
    return [prec.linear(rms_norm(x[x.shape[0] - n:], lm["norm"]["scale"],
                                 model["rms_norm_eps"]), head)
            for x, n in zip(xs, n_served)]


def swiglu_of(mp, prec: Precision):
    g = prec.weight(mp["gate_proj"]["kernel"])
    u = prec.weight(mp["up_proj"]["kernel"])
    d = prec.weight(mp["down_proj"]["kernel"])
    return lambda y: prec.linear(F.silu(prec.linear(y, g)) * prec.linear(y, u), d)


def served_logits(params: dict, model: dict, items: list, prec: Precision) -> list:
    """items: dicts with "ids" (prompt ids, np int64), "pixels" (patches, a
    tensor on the reference's device) and "grid" (t, h, w) or None,
    "second_per_grid", and "served" (np int64 tokens).  -> per item the
    (n_served, vocab) logits at the positions that predict them."""
    vc = model["vision_config"]
    lm = params["model"]
    dev = lm["embed_tokens"]["embedding"].device
    H = model["num_attention_heads"]
    Dh = model["hidden_size"] // H
    sections = model["rope_scaling"]["mrope_section"]
    embeds, cos_sin = [], []
    with exact_float32(), torch.no_grad():
        for it in items:
            toks = np.concatenate([it["ids"], it["served"][:-1]])
            x = lm["embed_tokens"]["embedding"][torch.as_tensor(toks, device=dev)].float()
            if it.get("grid") is not None:
                ve = vision_encode(params["visual"], vc, it["pixels"], it["grid"], prec)
                where = torch.as_tensor(
                    np.flatnonzero(it["ids"] == model["video_token_id"]), device=dev)
                x[where] = ve
            pos = mrope_positions(it["ids"], it.get("grid"), model,
                                  it.get("second_per_grid", 1.0), len(toks))
            cos_sin.append(mrope_cos_sin(torch.as_tensor(pos, device=dev), Dh,
                                         model["rope_theta"], sections))
            embeds.append(x)
        return lm_logits(lm, model, embeds, cos_sin,
                         [len(it["served"]) for it in items], prec, swiglu_of)


def served_gaps(params, model, items, prec=None) -> list:
    """Per item the (n_served,) gaps of the program's served tokens under the
    float32 reference."""
    logits = served_logits(params, model, items, prec or Precision("f32"))
    return [gaps(lg, torch.as_tensor(it["served"], device=lg.device)).cpu()
            for lg, it in zip(logits, items)]

"""Plain float32 Aria language model: the Llama-style decoder of
transformers' modeling_aria.py with its MoE feed-forward (AriaTextMoELayer:
router logits, top-k, softmax over the k chosen logits; grouped experts
fc1 -> chunk(projection, gate) -> silu(projection) * gate -> fc2, weighted by
the scores; plus the shared experts' SwiGLU), a plain loop over the
experts.  Text only: the cells that use it send no image.  Nothing of the
program is imported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.common import Precision, exact_float32, gaps, rope_freqs
from reference.qwen25_vl import lm_logits, swiglu_of


def moe_of(mp, prec: Precision, topk: int):
    """The layer's MoE feed-forward as a function of y (S, D)."""
    router = mp["router"]["kernel"].float()
    fc1 = prec.weight(mp["experts"]["fc1"]["kernel"])
    fc2 = prec.weight(mp["experts"]["fc2"]["kernel"])
    shared = swiglu_of(mp["shared"], prec)

    def moe(y):
        logits = y @ router
        top, idx = torch.topk(logits, topk, dim=-1)
        scores = torch.softmax(top, dim=-1)
        out = torch.zeros_like(y)
        for e in range(fc1.shape[0]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            h = prec.linear(y[tok], fc1[e])
            p, g = h.chunk(2, dim=-1)
            out.index_add_(0, tok, prec.linear(F.silu(p) * g, fc2[e])
                           * scores[tok, slot, None])
        return out + shared(y)

    return moe


def served_logits(params: dict, model: dict, items: list, prec: Precision) -> list:
    """items: dicts with "ids" (prompt ids) and "served" (tokens), np int64.
    -> per item the (n_served, vocab) logits at the positions that predict
    the served tokens (plain 1D positions 0, 1, ...)."""
    tc = model["text_config"]
    lm = params["model"]
    dev = lm["embed_tokens"]["embedding"].device
    Dh = tc["hidden_size"] // tc["num_attention_heads"]
    inv = rope_freqs(Dh, tc["rope_theta"], dev)
    embeds, cos_sin = [], []
    with exact_float32(), torch.no_grad():
        for it in items:
            toks = np.concatenate([it["ids"], it["served"][:-1]])
            embeds.append(lm["embed_tokens"]["embedding"][
                torch.as_tensor(toks, device=dev)].float())
            ang = torch.arange(len(toks), device=dev).float()[:, None] * inv
            ang = torch.cat([ang, ang], -1)
            cos_sin.append((ang.cos(), ang.sin()))
        return lm_logits(lm, tc, embeds, cos_sin,
                         [len(it["served"]) for it in items], prec,
                         lambda mp, p: moe_of(mp, p, tc["moe_topk"]))


def served_gaps(params, model, items, prec=None) -> list:
    logits = served_logits(params, model, items, prec or Precision("f32"))
    return [gaps(lg, torch.as_tensor(it["served"], device=lg.device)).cpu()
            for lg, it in zip(logits, items)]

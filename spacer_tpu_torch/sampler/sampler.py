"""Token sampling and the vision prologue used by serving (counterpart of the
serving-side parts of spacer_tpu/sampler/sampler.py).

Random draws come from a torch.Generator; they differ from jax.random's for
the same seed, so only the distribution (`filtered_logits`) and greedy
decoding (temperature 0) are comparable across the two packages.
"""

from __future__ import annotations

import numpy as np
import torch

from spacer_tpu_torch.models.qwen25_vl.model import (
    encode_vision,
    merge_vision_embeds,
)
from spacer_tpu_torch.nn.core import embed


def _topp_threshold_bisect(logits, lse, top_p, iters: int = 24):
    """Per-row nucleus threshold by bisection: the largest t such that
    P(logit >= t) >= top_p.  The masked sums read bf16 copies of the logits
    and probabilities with f32 accumulation, as the JAX version does."""
    probs_b = torch.exp(logits - lse).to(torch.bfloat16)
    logits_b = logits.to(torch.bfloat16)
    lo = logits.amin(dim=-1, keepdim=True)
    hi = logits.amax(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=torch.bfloat16, device=logits.device)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        mass = torch.where(logits_b >= mid.to(torch.bfloat16), probs_b,
                           zero).sum(dim=-1, keepdim=True, dtype=torch.float32)
        ok = mass >= top_p
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


def filtered_logits(logits, temperature: float, top_p: float):
    """Temperature-scaled, nucleus-filtered f32 logits: the distribution
    sample_logits draws from (softmax of this)."""
    logits = logits.float() / temperature
    if top_p is not None and top_p < 1.0:
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        kept_min = _topp_threshold_bisect(logits, lse, top_p)
        keep = logits.to(torch.bfloat16) >= kept_min.to(torch.bfloat16)
        logits = torch.where(keep, logits,
                             torch.tensor(float("-inf"), device=logits.device))
    return logits


def sample_logits(logits, generator: torch.Generator | None,
                  temperature: float, top_p: float):
    """(B, V) logits -> (B,) token ids; greedy argmax at temperature <= 0."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(filtered_logits(logits, temperature, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def prologue(params, ids, pixel_values, *, cfg, grid_thw):
    """Embed, then vision-encode, then merge the vision embeddings over the
    placeholder tokens (pixel_values None for a text-only prompt)."""
    token_embeds = embed(params["model"]["embed_tokens"], ids)
    if pixel_values is None:
        return token_embeds
    ve = encode_vision(params, cfg, pixel_values, grid_thw)
    return merge_vision_embeds(cfg, ids, token_embeds, ve)


def completion_mask_from_ids(completion_ids: np.ndarray, eos_token_id: int
                             ) -> np.ndarray:
    """Mask = positions up to and including the first EOS."""
    is_eos = completion_ids == eos_token_id
    n, L = is_eos.shape
    eos_idx = np.full((n,), L, dtype=np.int64)
    any_eos = is_eos.any(axis=1)
    eos_idx[any_eos] = is_eos.argmax(axis=1)[any_eos]
    seq = np.arange(L)[None, :]
    return (seq <= eos_idx[:, None]).astype(np.int32)

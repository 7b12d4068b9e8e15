"""GRPO / SG-RLVR loss math and reward shaping (counterpart of
spacer_tpu/train/grpo.py).

Formulas (SG_RLVR_trainer.py):
- k3 KL:     exp(clamp(ref - pol, -10, 10)) - (ref - pol) - 1
- advantage: (r - mean_G(r)) / (std_G(r) + 1e-4), std unbiased
- loss:      -mean_seq( sum_t mask * (exp(logp - sg(logp)) * adv
                                       - beta * kl) / sum_t mask )
- temporal bonus: +0.3 to samples with acc > 0.1 when mean(acc) >=
  0.8 * mean(shuffled acc)
- length bonus: +0.2 for correct (acc > 0.1) completions with
  320 <= len <= 512, only when >1 completion is correct
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from spacer_tpu_torch.parallel import tp


def per_token_logps_from_logits(logits, target_ids):
    """log softmax + gather, f32.  logits: (B, S, V) for positions
    predicting target_ids (B, S).  Gathers before normalising, so no second
    (B, S, V) tensor is made."""
    logits = logits.float()
    picked = logits.gather(-1, target_ids[..., None].long())[..., 0]
    return picked - torch.logsumexp(logits, dim=-1)


def _chunk_logps(h, head_kernel, t):
    # bf16 operands, f32 products and sums: the JAX einsum's
    # preferred_element_type=f32 (a bf16 product is exact in f32)
    if tp.active():
        # this rank's vocabulary columns: vocab-parallel logps, no
        # all-gather of the (chunk x vocab) logits
        logits = torch.matmul(tp.copy_to_tp(h).float(), head_kernel.float())
        return tp.vocab_logps(logits, t)
    logits = torch.matmul(h.float(), head_kernel.float())
    return per_token_logps_from_logits(logits, t)


def chunked_per_token_logps(hidden, head_kernel, target_ids, chunk: int = 256):
    """Memory-bounded per-token logps over sequence chunks: the (B, S, V)
    logits are never materialised, in the forward or the backward (each
    chunk is checkpointed, so the backward recomputes its logits).

    hidden: (B, S, D) final hidden states aligned so position i predicts
    target_ids[:, i].  head_kernel: (D, V), or under tensor parallelism
    this rank's (D, V / tp) vocabulary columns (parallel/tp.vocab_logps)."""
    S = hidden.shape[1]
    if S <= chunk:
        return _chunk_logps(hidden, head_kernel, target_ids)
    grad = torch.is_grad_enabled()
    parts = []
    for s0 in range(0, S, chunk):
        h, t = hidden[:, s0:s0 + chunk], target_ids[:, s0:s0 + chunk]
        parts.append(checkpoint(_chunk_logps, h, head_kernel, t,
                                use_reentrant=False) if grad
                     else _chunk_logps(h, head_kernel, t))
    return torch.cat(parts, dim=1)


def k3_kl(ref_logps, logps):
    x = torch.clamp(ref_logps - logps, -10.0, 10.0)
    return torch.exp(x) - x - 1.0


def group_advantages(rewards, num_generations: int, eps: float = 1e-4):
    """(B*G,) rewards -> (B*G,) group-normalized advantages (unbiased std,
    matching torch .std(dim=1))."""
    r = torch.as_tensor(rewards).reshape(-1, num_generations)
    mean = r.mean(dim=1, keepdim=True)
    std = r.std(dim=1, unbiased=True, keepdim=True)
    return ((r - mean) / (std + eps)).reshape(-1)


def grpo_loss(per_token_logps, ref_per_token_logps, advantages,
              completion_mask, beta: float = 0.04):
    """Returns (loss, metrics dict).  All inputs over completion tokens.

    per_token_logps: (N, C); ref_per_token_logps: (N, C) (no grad), or None
    when beta == 0 (no reference model); advantages: (N,); completion_mask:
    (N, C) in {0, 1}."""
    if ref_per_token_logps is None:
        if beta != 0.0:
            raise ValueError("ref logps required when beta != 0")
        per_token_kl = torch.zeros_like(per_token_logps)
    else:
        per_token_kl = k3_kl(ref_per_token_logps.detach(), per_token_logps)
    ratio = torch.exp(per_token_logps - per_token_logps.detach())
    per_token_loss = -(ratio * advantages[:, None] - beta * per_token_kl)
    mask = completion_mask.to(per_token_loss.dtype)
    denom = mask.sum(dim=1).clamp_min(1.0)
    loss = ((per_token_loss * mask).sum(dim=1) / denom).mean()
    mean_kl = ((per_token_kl * mask).sum(dim=1) / denom).mean()
    return loss, {"kl": mean_kl.detach()}


# ---------------------------------------------------------------------------
# Reward shaping (host-side numpy; runs between reward fns and the train step)
# ---------------------------------------------------------------------------


def temporal_bonus(rewards_per_func: np.ndarray,
                   shuffled_rewards_per_func: np.ndarray,
                   bonus: float = 0.3, threshold: float = 0.8,
                   acc_floor: float = 0.1):
    """SG-RLVR temporal-shuffle consistency bonus.

    rewards_per_func: (N, n_funcs) with accuracy in column 0.  Returns
    (adjusted copy, temporal_flag in {0.0, 1.0})."""
    out = rewards_per_func.copy()
    acc_mean = out[:, 0].mean()
    shuffled_acc_mean = shuffled_rewards_per_func[:, 0].mean()
    if acc_mean >= threshold * shuffled_acc_mean:
        mask = out[:, 0] > acc_floor
        out[mask, 0] = out[mask, 0] + bonus
        return out, 1.0
    return out, 0.0


def length_control_bonus(rewards: np.ndarray, acc_rewards: np.ndarray,
                         lengths: np.ndarray, bonus: float = 0.2,
                         lo: int = 320, hi: int = 512,
                         acc_floor: float = 0.1) -> np.ndarray:
    """+bonus for correct completions with length in [lo, hi], applied only
    when more than one completion in the batch is correct."""
    out = rewards.copy()
    selected = np.nonzero(acc_rewards > acc_floor)[0]
    if len(selected) > 1:
        for idx in selected:
            if lo <= lengths[idx] <= hi:
                out[idx] += bonus
    return out

"""Optimizer: AdamW + cosine schedule + global-norm clipping (counterpart of
spacer_tpu/train/optimizer.py, which chains optax transformations).

Reference hyperparameters (run_SpaceR_SG_RLVR.sh and HF Trainer defaults):
lr 1e-6, cosine decay to 0 with linear warmup, weight decay 0.01 on
parameters of more than one dimension, max_grad_norm 5, betas (0.9, 0.999),
eps 1e-8.

`make_optimizer(...)` returns an object with optax's two calls, over flat
lists of tensors (the params flattened in a fixed order):
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
and the step applies `p + u.to(p.dtype)` (here in place, under no_grad).

Moment storage (`moment_dtype`), each as in the JAX package:
  "float32"  - both moments f32 (torch.optim.AdamW's behaviour).
  "bfloat16" - optax.adamw(mu_dtype=bf16): mu stored bf16, nu in the param
               dtype.  Kept as an explicit opt-in only.
  "int8"     - blockwise-quantised moments (2048-element blocks, one f32
               scale each): mu on a LINEAR absmax map with stochastic
               rounding, nu on a LOG map with deterministic nearest
               rounding (see the JAX module's docstring for why).  The SR
               dither is uniform in [-0.5, 0.5) from a torch.Generator
               seeded by (seed, step); `sr_impl="off"` rounds mu to nearest
               (deterministic, used by the parity tests).  Large tensors
               are updated a slab of blocks at a time, which bounds the f32
               temporaries without changing the blockwise math.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

BLOCK = 2048
# nu log map: payload p in [0, 255] represents scale * exp(LOG_RMIN *
# (1 - p / 255)); relative step ~5.6 %, nearest rounding within +-2.8 %.
LOG_RMIN = -13.815510557964274  # log(1e-6)
# int8 update slab: blocks per slab (2**14 blocks = 32 M elements)
SLAB_BLOCKS = 1 << 14


def cosine_schedule(learning_rate: float, total_steps: int,
                    warmup_steps: int = 0):
    """optax.warmup_cosine_decay_schedule(init=0 if warmup else lr,
    peak=lr, warmup, decay_steps=max(total, warmup+1), end=0) as a function
    of the update count (0 for the first update)."""
    decay = max(total_steps, warmup_steps + 1) - warmup_steps

    def sched(count: int) -> float:
        if count < warmup_steps:
            return learning_rate * count / warmup_steps
        c = min(count - warmup_steps, decay)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return sched


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, accumulated in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _to_blocks(x):
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def _quantize_mu(m, generator, sr: bool):
    """Linear per-block absmax int8 with optional stochastic rounding."""
    absmax = m.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp_min(1e-30) / 127.0
    y = m / scale
    if sr:
        y = y + (torch.rand(m.shape, generator=generator, device=m.device)
                 - 0.5)
    return y.round().clamp(-127.0, 127.0).to(torch.int8), scale


def _quantize_nu(v):
    """Log-map uint8, deterministic nearest rounding; values below 1e-6 of
    the block max clamp UP to the floor."""
    scale = v.amax(dim=1, keepdim=True)
    r = v / scale.clamp_min(1e-38)
    u = torch.log(r.clamp_min(1e-6)) / LOG_RMIN
    return ((1.0 - u) * 255.0).round().clamp(0.0, 255.0).to(torch.uint8), scale


def _dequant_nu(payload, scale):
    return scale * torch.exp(LOG_RMIN * (1.0 - payload.float() / 255.0))


class OptState(NamedTuple):
    count: int              # updates applied so far
    mu: list                # per param: tensor, or (payload, scale) for int8
    nu: list


class AdamW:
    """clip_by_global_norm -> scale_by_adam (moments per `moment_dtype`) ->
    add_decayed_weights(mask = ndim > 1) -> scale_by_learning_rate."""

    def __init__(self, schedule, *, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, max_grad_norm=5.0, moment_dtype="float32",
                 sr_impl=None, seed: int = 0):
        if moment_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unknown moment_dtype {moment_dtype!r}")
        if sr_impl not in (None, "generator", "off"):
            raise ValueError(f"unknown sr_impl {sr_impl!r} (None / "
                             "'generator' = torch.Generator dither, 'off')")
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.moment_dtype = moment_dtype
        self.sr = sr_impl != "off"
        self.seed = seed

    def init(self, params) -> OptState:
        mu, nu = [], []
        for p in params:
            if self.moment_dtype == "int8":
                nb = -(-p.numel() // BLOCK)
                z = dict(device=p.device)
                mu.append((torch.zeros((nb, BLOCK), dtype=torch.int8, **z),
                           torch.zeros((nb, 1), dtype=torch.float32, **z)))
                nu.append((torch.zeros((nb, BLOCK), dtype=torch.uint8, **z),
                           torch.zeros((nb, 1), dtype=torch.float32, **z)))
            else:
                mdt = (torch.float32 if self.moment_dtype == "float32"
                       else torch.bfloat16)
                vdt = torch.float32 if self.moment_dtype == "float32" else p.dtype
                mu.append(torch.zeros(p.shape, dtype=mdt, device=p.device))
                nu.append(torch.zeros(p.shape, dtype=vdt, device=p.device))
        return OptState(0, mu, nu)

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """-> (updates in the grads' dtypes, new state)."""
        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        gnorm = global_norm(grads)
        lr = self.schedule(state.count)
        generator = None
        if self.moment_dtype == "int8" and self.sr:
            generator = torch.Generator(device=grads[0].device).manual_seed(
                self.seed * 1_000_003 + count)
        updates, mu, nu = [], [], []
        for g, p, m, v in zip(grads, params, state.mu, state.nu):
            # optax clips with t / g_norm * max_norm in the grad dtype
            g = torch.where(gnorm < self.max_grad_norm, g,
                            (g / gnorm.to(g.dtype)) * self.max_grad_norm)
            if self.moment_dtype == "int8":
                d, m, v = self._adam_int8(g, m, v, bc1, bc2, generator)
            elif self.moment_dtype == "float32":
                m = self.b1 * m + (1.0 - self.b1) * g.float()
                v = self.b2 * v + (1.0 - self.b2) * g.float().square()
                d = ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)).to(g.dtype)
            else:
                m32 = self.b1 * m.float() + (1.0 - self.b1) * g.float()
                v = (self.b2 * v + (1.0 - self.b2) * g.to(v.dtype).square())
                d = ((m32 / bc1) / (torch.sqrt(v.float() / bc2) + self.eps)
                     ).to(g.dtype)
                m = m32.to(torch.bfloat16)
            if p.dim() > 1:
                d = d + self.weight_decay * p.to(d.dtype)
            updates.append((-lr) * d)
            mu.append(m)
            nu.append(v)
        return updates, OptState(count, mu, nu)

    def _adam_int8(self, g, m_q, v_q, bc1, bc2, generator):
        """Dequant -> adam -> requant, a slab of blocks at a time."""
        gb = _to_blocks(g)
        d_out = torch.empty_like(gb)
        mq, ms = torch.empty_like(m_q[0]), torch.empty_like(m_q[1])
        vq, vs = torch.empty_like(v_q[0]), torch.empty_like(v_q[1])
        for s0 in range(0, gb.shape[0], SLAB_BLOCKS):
            sl = slice(s0, s0 + SLAB_BLOCKS)
            gs = gb[sl]
            m = m_q[0][sl].float() * m_q[1][sl]
            v = _dequant_nu(v_q[0][sl], v_q[1][sl])
            m = self.b1 * m + (1.0 - self.b1) * gs
            v = self.b2 * v + (1.0 - self.b2) * gs * gs
            d_out[sl] = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            mq[sl], ms[sl] = _quantize_mu(m, generator, self.sr)
            vq[sl], vs[sl] = _quantize_nu(v)
        d = d_out.reshape(-1)[:g.numel()].reshape(g.shape).to(g.dtype)
        return d, (mq, ms), (vq, vs)


def make_optimizer(learning_rate: float = 1e-6, total_steps: int = 10000,
                   warmup_steps: int = 0, weight_decay: float = 0.01,
                   max_grad_norm: float = 5.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   moment_dtype: str = "float32", sr_impl=None,
                   seed: int = 0) -> AdamW:
    sched = cosine_schedule(learning_rate, total_steps, warmup_steps)
    return AdamW(sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm, moment_dtype=moment_dtype,
                 sr_impl=sr_impl, seed=seed)

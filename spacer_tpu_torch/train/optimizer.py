"""Optimizer: AdamW + cosine schedule + global-norm clipping (counterpart of
spacer_tpu/train/optimizer.py, which chains optax transformations).

Reference hyperparameters (run_SpaceR_SG_RLVR.sh and HF Trainer defaults):
lr 1e-6, cosine decay to 0 with linear warmup, weight decay 0.01 under the
JAX package's mask, max_grad_norm 5, betas (0.9, 0.999), eps 1e-8.

`make_optimizer(...)` returns an object with optax's two calls, over flat
lists of tensors (the params flattened in a fixed order):
    state = tx.init(params, names)
    updates, state = tx.update(grads, state, params)
and a third, the one the train steps call:
    state = tx.apply(grads, state, params)
which adds each update to its param in place (`p.add_(u.to(p.dtype))`, JAX's
`p + u.astype(p.dtype)`) one moment group at a time and drops that group's
grads, so no params-sized list of updates is ever held.  `MultiSteps(tx, k)`
wraps it for gradient accumulation as the JAX trainer's optax.MultiSteps
does.  Moments and the accumulator may live in host memory between updates
(parallel/offload.py); `apply` streams them through the card.

`names` are the params' paths (train/step.py `param_leaves`), in the same
order.  The JAX package stacks the per-layer params of the LM ("layers")
and the ViTs (Qwen's "blocks", Aria's "encoder") on a leading (L, ...)
axis, and two things follow
from that layout, which the port reproduces from the paths:
- the decay mask is `ndim > 1` on the STACKED leaf, so every per-layer
  tensor is decayed whatever its own rank (norm scales and biases too);
  other 1-D tensors (the final norm) are not;
- int8 moments cut the flattened stacked leaf into 2048-element blocks, so
  a per-layer tensor whose size is not a multiple of 2048 shares blocks
  with its neighbours.  Such tensors keep ONE moment state per stacked group
  (the same path across layers, concatenated in layer order, as JAX's
  row-major (L, ...) flattening); the update gathers a slab of the virtual
  concatenation at a time, so the group is never copied whole.  Tensors
  whose size is a multiple of 2048 have blocks that already coincide with
  JAX's and keep their own state.

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


def _stacked_key(name: str):
    """'model/layers/3/mlp/up_proj/bias' -> 'model/layers/*/mlp/up_proj/bias'
    for a per-layer tensor of the JAX package's stacked trees, else None."""
    parts = name.split("/")
    for i in range(len(parts) - 1):
        if (parts[i] in ("layers", "blocks", "encoder")
                and parts[i + 1].isdigit()):
            return "/".join(parts[:i + 1] + ["*"] + parts[i + 2:])
    return None


def moment_layout(params, names):
    """-> (groups, decay): lists of leaf indices that share one moment state,
    and per leaf whether it is weight-decayed (see the module docstring)."""
    groups, by_key, decay = [], {}, []
    for i, (name, p) in enumerate(zip(names, params)):
        key = _stacked_key(name)
        decay.append(key is not None or p.dim() > 1)
        if key is not None and p.numel() % BLOCK:
            if key not in by_key:
                by_key[key] = len(groups)
                groups.append([])
            groups[by_key[key]].append(i)
        else:
            groups.append([i])
    return groups, decay


def _gather(flats, start: int, end: int):
    """Elements [start, end) of the concatenation of equal-sized flat
    tensors, as one f32 tensor."""
    n = flats[0].numel()
    pieces = [flats[l][max(start - l * n, 0):min(end - l * n, n)].float()
              for l in range(start // n, -(-end // n))]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _scatter(outs, start: int, values):
    """Write `values` at [start, start + len) of the concatenation of the
    equal-sized flat tensors `outs`."""
    n, end = outs[0].numel(), start + values.numel()
    for l in range(start // n, -(-end // n)):
        a, b = max(start, l * n), min(end, (l + 1) * n)
        outs[l][a - l * n:b - l * n] = values[a - start:b - start]


def _quantize_mu(m, noise=None):
    """Linear per-block absmax int8, with stochastic rounding where
    `noise` (uniform [0, 1) draws shaped like m) is given."""
    absmax = m.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp_min(1e-30) / 127.0
    y = m / scale
    if noise is not None:
        y = y + (noise - 0.5)
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
    mu: list                # per param: tensor; int8: (payload, scale) per group
    nu: list
    groups: list            # moment groups: lists of param indices
    decay: list             # per param: weight-decayed or not
    # per group: None, or (first block, blocks of the whole tensor) where
    # the group is one fsdp Shard's blocks (parallel/fsdp.py)
    blocks: list | None = None


class AdamW:
    """clip_by_global_norm -> scale_by_adam (moments per `moment_dtype`) ->
    add_decayed_weights(JAX's stacked-leaf mask) -> scale_by_learning_rate."""

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

    def init(self, params, names, blocks=None) -> OptState:
        """`blocks`: per param None, or (first block, blocks of the whole
        tensor) for a Shard's blocks (parallel/fsdp.shard_blocks): the
        int8 stochastic rounding then draws the whole tensor's dither and
        keeps this shard's rows, as a single process would draw it."""
        groups, decay = moment_layout(params, names)
        gblocks = None
        if blocks is not None and any(b is not None for b in blocks):
            gblocks = [blocks[idx[0]] if len(idx) == 1 else None
                       for idx in groups]
        mu, nu = [], []
        if self.moment_dtype == "int8":
            for j, idx in enumerate(groups):
                nb = -(-sum(params[i].numel() for i in idx) // BLOCK)
                # a tp slice's scales are the whole tensor's blocks'
                ns = (_tp_blocks(gblocks[j]) if gblocks and gblocks[j]
                      and len(gblocks[j]) == 3 else nb)
                z = dict(device=params[idx[0]].device)
                mu.append((torch.zeros((nb, BLOCK), dtype=torch.int8, **z),
                           torch.zeros((ns, 1), dtype=torch.float32, **z)))
                nu.append((torch.zeros((nb, BLOCK), dtype=torch.uint8, **z),
                           torch.zeros((ns, 1), dtype=torch.float32, **z)))
        else:
            for p in params:
                mdt = (torch.float32 if self.moment_dtype == "float32"
                       else torch.bfloat16)
                vdt = torch.float32 if self.moment_dtype == "float32" else p.dtype
                mu.append(torch.zeros(p.shape, dtype=mdt, device=p.device))
                nu.append(torch.zeros(p.shape, dtype=vdt, device=p.device))
        return OptState(0, mu, nu, groups, decay, gblocks)

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """-> (updates in the grads' dtypes, new state): optax's call, one
        params-sized list of updates (the tests' path)."""
        updates = [None] * len(grads)

        def emit(i, u):
            updates[i] = u

        return updates, self._run(grads, state, params, emit,
                                  global_norm(grads))

    @torch.no_grad()
    def apply(self, grads, state: OptState, params, gnorm=None,
              norm=global_norm) -> OptState:
        """The update applied IN PLACE, one moment group at a time: each
        param gets `p.add_(u.to(p.dtype))` as soon as its update exists and
        its entry of the `grads` list is dropped (set to None), so neither a
        list of updates nor the applied grads outlive their group.  The
        values equal `update` followed by the add.  `gnorm`: the grads'
        global norm where the caller has it (clipping needs it before any
        group), else norm(grads) (fsdp shards: parallel/fsdp.global_norm).
        Moments held in host memory (parallel/offload.py) stream through
        the grads' device a group at a time and back."""
        if gnorm is None:
            gnorm = norm(grads)

        def emit(i, u):
            params[i].add_(u.to(params[i].dtype))
            grads[i] = None

        return self._run(grads, state, params, emit, gnorm)

    def _run(self, grads, state: OptState, params, emit, gnorm) -> OptState:
        from spacer_tpu_torch.parallel.offload import GroupStream

        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        lr = self.schedule(state.count)
        device = next(g.device for g in grads if g is not None)

        def clip(g):
            # optax clips with t / g_norm * max_norm in the grad dtype
            return torch.where(gnorm < self.max_grad_norm, g,
                               (g / gnorm.to(g.dtype)) * self.max_grad_norm)

        def finish(i, d):
            # one tensor's direction -> its update (decay, learning rate)
            if state.decay[i]:
                d = d + self.weight_decay * params[i].to(d.dtype)
            emit(i, (-lr) * d)

        int8 = self.moment_dtype == "int8"
        if int8:
            items = [[*m, *v] for m, v in zip(state.mu, state.nu)]
        else:
            items = [[state.mu[i] for i in idx] + [state.nu[i] for i in idx]
                     for idx in state.groups]
        stream = GroupStream(items, device)
        generator = None
        if int8 and self.sr:
            generator = torch.Generator(device=device).manual_seed(
                self.seed * 1_000_003 + count)
        for j, idx in enumerate(state.groups):
            mv = stream.get(j)
            if int8:
                adam = self._adam_int8
                if state.blocks and state.blocks[j] and len(
                        state.blocks[j]) == 3:
                    adam = self._adam_int8_tp
                ds, m, v = adam(
                    [clip(grads[i]) for i in idx], tuple(mv[:2]),
                    tuple(mv[2:]), bc1, bc2, generator,
                    state.blocks[j] if state.blocks else None)
                for i, d in zip(idx, ds):
                    finish(i, d)
                stream.put(j, [*m, *v])
                continue
            ms, vs = [], []
            for i, m, v in zip(idx, mv[:len(idx)], mv[len(idx):]):
                g = clip(grads[i])
                if self.moment_dtype == "float32":
                    m = self.b1 * m + (1.0 - self.b1) * g.float()
                    v = self.b2 * v + (1.0 - self.b2) * g.float().square()
                    d = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                else:
                    m32 = self.b1 * m.float() + (1.0 - self.b1) * g.float()
                    v = (self.b2 * v + (1.0 - self.b2) * g.to(v.dtype).square())
                    d = (m32 / bc1) / (torch.sqrt(v.float() / bc2) + self.eps)
                    m = m32.to(torch.bfloat16)
                finish(i, d.to(g.dtype))
                ms.append(m)
                vs.append(v)
            stream.put(j, ms + vs)
        items = stream.finish()
        if int8:
            mu = [tuple(x[:2]) for x in items]
            nu = [tuple(x[2:]) for x in items]
        else:
            mu, nu = list(state.mu), list(state.nu)
            for idx, x in zip(state.groups, items):
                for k, i in enumerate(idx):
                    mu[i], nu[i] = x[k], x[len(idx) + k]
        return OptState(count, mu, nu, state.groups, state.decay,
                        state.blocks)

    def _adam_int8(self, gs, m_q, v_q, bc1, bc2, generator, blocks=None):
        """Dequant -> adam -> requant over the virtual concatenation of one
        moment group's flattened grads, a slab of blocks at a time.

        `blocks` = (lo, nb) marks the group as blocks [lo, lo + rows) of a
        tensor of nb blocks (an fsdp Shard): the slabs are the whole
        tensor's, each draws its whole dither (the same stream as one
        process updating the whole tensor) and this shard's rows take
        theirs; rows past nb are padding and stay zero."""
        flats = [g.reshape(-1) for g in gs]
        total = sum(f.numel() for f in flats)
        rows = m_q[0].shape[0]
        lo, nb = blocks if blocks is not None else (0, rows)
        d_outs = [(torch.zeros if blocks is not None else torch.empty)(
            f.numel(), dtype=torch.float32, device=f.device) for f in flats]
        mq, ms = torch.empty_like(m_q[0]), torch.empty_like(m_q[1])
        vq, vs = torch.empty_like(v_q[0]), torch.empty_like(v_q[1])
        if blocks is not None:
            for t in (mq, ms, vq, vs):
                t.zero_()
        for s0 in range(0, nb, SLAB_BLOCKS):
            s1 = min(s0 + SLAB_BLOCKS, nb)
            noise = None
            if self.sr:
                noise = torch.rand((s1 - s0, BLOCK), generator=generator,
                                   device=m_q[0].device)
            a, b = max(s0, lo), min(s1, lo + rows)
            if a >= b:
                continue
            if noise is not None and (a, b) != (s0, s1):
                noise = noise[a - s0:b - s0]
            sl = slice(a - lo, b - lo)
            start = (a - lo) * BLOCK
            end = min((b - lo) * BLOCK, total)
            g = _gather(flats, start, end)
            pad = (-g.numel()) % BLOCK
            if pad:
                g = torch.nn.functional.pad(g, (0, pad))
            g = g.reshape(-1, BLOCK)
            m = m_q[0][sl].float() * m_q[1][sl]
            v = _dequant_nu(v_q[0][sl], v_q[1][sl])
            m = self.b1 * m + (1.0 - self.b1) * g
            v = self.b2 * v + (1.0 - self.b2) * g * g
            d = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            _scatter(d_outs, start, d.reshape(-1)[:end - start])
            mq[sl], ms[sl] = _quantize_mu(m, noise)
            vq[sl], vs[sl] = _quantize_nu(v)
        ds = [d.reshape(g.shape).to(g.dtype) for d, g in zip(d_outs, gs)]
        return ds, (mq, ms), (vq, vs)



    def _adam_int8_tp(self, gs, m_q, v_q, bc1, bc2, generator, blocks):
        """The int8 update of a tp slice (blocks = (lo, nb, Shard)): its
        moments keep this rank's elements' payloads in the slice's block
        layout and the WHOLE tensor's per-block scales, so the codes and
        scales are world 1's.  Each element reads its scale at its block of
        the whole tensor (parallel/tp.Split.full_index); the new scales
        are each block's max over every rank that holds a piece of it
        (all-reduced over the Shard's pieces_group: fsdp x tp, or an expert
        placement's ep axes x tp), and the dither is
        the whole tensor's stream, each element taking its own draw."""
        from spacer_tpu_torch.parallel import multihost

        (g,) = gs
        lo, _, shard = blocks
        split = shard.split
        rows = m_q[0].shape[0]
        nb_whole = m_q[1].shape[0]
        real = min(rows * BLOCK, max(shard.numel - lo * BLOCK, 0))
        flat = g.reshape(-1).float()
        dev = flat.device
        slabs = [(a, min(a + SLAB_BLOCKS, rows))
                 for a in range(0, rows, SLAB_BLOCKS)]

        def slab(a, b):
            n = max(min(b * BLOCK, real) - a * BLOCK, 0)
            li = torch.arange(a * BLOCK, a * BLOCK + n, device=dev)
            fi = split.full_index(lo * BLOCK + li)
            return li, fi, fi // BLOCK

        def moments(li, blk):
            # the new f32 moments of these elements, from the dequantized
            # old ones (each element's scale is its whole-tensor block's)
            g = flat[li]
            m = m_q[0].view(-1)[li].float() * m_q[1][blk, 0]
            v = _dequant_nu(v_q[0].view(-1)[li], v_q[1][blk, 0])
            m = self.b1 * m + (1.0 - self.b1) * g
            v = self.b2 * v + (1.0 - self.b2) * g * g
            return m, v

        mmax = torch.zeros((nb_whole,), dtype=torch.float32, device=dev)
        vmax = torch.zeros_like(mmax)
        for a, b in slabs:
            li, _, blk = slab(a, b)
            if li.numel():
                m, v = moments(li, blk)
                mmax.scatter_reduce_(0, blk, m.abs(), "amax")
                vmax.scatter_reduce_(0, blk, v, "amax")
        group = shard.mesh.group(shard.pieces_group)
        multihost.all_reduce(mmax, group, kind="opt_max", op="max")
        multihost.all_reduce(vmax, group, kind="opt_max", op="max")
        ms = (mmax.clamp_min(1e-30) / 127.0)[:, None]
        vs = vmax[:, None]
        noise = _WholeNoise(generator, nb_whole, dev) if self.sr else None
        mq = torch.zeros_like(m_q[0])
        vq = torch.zeros_like(v_q[0])
        d_out = torch.zeros((rows * BLOCK,), dtype=torch.float32, device=dev)
        for a, b in slabs:
            li, fi, blk = slab(a, b)
            if not li.numel():
                continue
            m, v = moments(li, blk)
            d_out[li] = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            y = m / ms[blk, 0]
            if noise is not None:
                y = y + (noise.at(fi) - 0.5)
            mq.view(-1)[li] = y.round().clamp(-127.0, 127.0).to(torch.int8)
            r = v / vs[blk, 0].clamp_min(1e-38)
            u = torch.log(r.clamp_min(1e-6)) / LOG_RMIN
            vq.view(-1)[li] = ((1.0 - u) * 255.0).round().clamp(
                0.0, 255.0).to(torch.uint8)
        if noise is not None:
            noise.finish()
        return [d_out.view(g.shape).to(g.dtype)], (mq, ms), (vq, vs)


def _tp_blocks(entry) -> int:
    """Blocks of the whole tensor of a tp slice's optimizer `blocks` entry."""
    return -(-math.prod(entry[2].split.shape) // BLOCK)


class _WholeNoise:
    """The int8 stochastic rounding's dither of a whole tensor of nb blocks,
    drawn slab by slab from the generator in the one-process order
    (AdamW._adam_int8's), read at increasing flat indices of the whole
    tensor; `finish` draws the slabs no element read, so the generator
    leaves the tensor where one process leaves it."""

    def __init__(self, generator, nb: int, device):
        self.generator, self.nb, self.device = generator, nb, device
        self.slabs: dict = {}
        self.next = 0            # the next slab to draw (in slabs)

    def _draw_to(self, s: int):
        while self.next <= s:
            s0 = self.next * SLAB_BLOCKS
            self.slabs[self.next] = torch.rand(
                (min(SLAB_BLOCKS, self.nb - s0), BLOCK),
                generator=self.generator, device=self.device).reshape(-1)
            self.next += 1

    def at(self, fi: torch.Tensor) -> torch.Tensor:
        per = SLAB_BLOCKS * BLOCK
        s_lo, s_hi = int(fi[0]) // per, int(fi[-1]) // per
        self._draw_to(s_hi)
        for k in [k for k in self.slabs if k < s_lo]:
            del self.slabs[k]
        cat = torch.cat([self.slabs[k] for k in range(s_lo, s_hi + 1)])
        return cat[fi - s_lo * per]

    def finish(self):
        self._draw_to(-(-self.nb // SLAB_BLOCKS) - 1)
        self.slabs.clear()


class MultiStepsState(NamedTuple):
    mini_step: int          # mini-steps accumulated since the last update
    gradient_step: int      # inner updates made
    inner_opt_state: OptState
    acc_grads: list         # per param: running mean, in the params' dtype


class MultiSteps:
    """Gradient accumulation as optax.MultiSteps(tx, every_k_schedule=k)
    (use_grad_mean=True), the JAX trainer's wrapper:

    - each `apply` is one mini-step: the accumulator, in the params'
      dtype, becomes `acc + (g - acc) / (mini_step + 1)` (optax's Welford
      mean, each op rounded to that dtype as XLA rounds it);
    - on the k-th mini-step the inner AdamW applies the mean (its clip sees
      the mean's global norm, its count and so its schedule advance) and
      the accumulator is zeroed;
    - on the other mini-steps the params, the inner state and its count
      stay bitwise as they were.  No inner update is computed there
      (MultiSteps computes one and discards it; the result is the same).

    The accumulator may live in host memory (parallel/offload.py): it then
    streams through the grads' device a tensor at a time and back."""

    def __init__(self, inner: AdamW, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner, self.every_k = inner, int(every_k)

    def init(self, params, names, blocks=None) -> MultiStepsState:
        return MultiStepsState(0, 0, self.inner.init(params, names, blocks),
                               [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, grads, state: MultiStepsState, params,
              gnorm=None, norm=global_norm) -> MultiStepsState:
        """One mini-step (see the class docstring).  `gnorm`, the
        mini-step's own norm, is not the mean's and is not used; the inner
        update clips at norm(mean).  The `grads` entries are dropped as they
        are consumed."""
        from spacer_tpu_torch.parallel.offload import GroupStream

        del gnorm
        n = state.mini_step
        emit = n == self.every_k - 1
        device = next(g.device for g in grads if g is not None)
        acc = state.acc_grads
        # after an update (or at the start) the accumulator is zero, and
        # 0 + (g - 0) / 1 is g + 0.0 bitwise (-0.0 becomes +0.0 as there):
        # nothing is read then
        stream = GroupStream([[a] for a in acc], device)
        for i, g in enumerate(grads):
            if n == 0:
                new = g + 0.0
            else:
                (a,) = stream.get(i)
                new = g - a
                new.div_(n + 1)
                new.add_(a)
            if emit:
                grads[i] = new
            else:
                grads[i] = None
                stream.put(i, [new])
            del g, new
        if not emit:
            acc = [x[0] for x in stream.finish()]
            return MultiStepsState(n + 1, state.gradient_step,
                                   state.inner_opt_state, acc)
        stream.finish()
        inner = self.inner.apply(grads, state.inner_opt_state, params,
                                 norm=norm)
        for a in acc:
            a.zero_()
        return MultiStepsState(0, state.gradient_step + 1, inner, acc)


def make_optimizer(learning_rate: float = 1e-6, total_steps: int = 10000,
                   warmup_steps: int = 0, weight_decay: float = 0.01,
                   max_grad_norm: float = 5.0, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   schedule: str = "cosine", moment_dtype: str = "float32",
                   sr_impl=None, seed: int = 0) -> AdamW:
    """AdamW with the learning rate `schedule` "cosine" (cosine_schedule)
    or "constant" (learning_rate at every update); any other raises
    ValueError."""
    if schedule == "cosine":
        sched = cosine_schedule(learning_rate, total_steps, warmup_steps)
    elif schedule == "constant":
        sched = lambda count: learning_rate  # noqa: E731
    else:
        raise ValueError(f"unknown schedule {schedule!r}: expected "
                         "'cosine' or 'constant'")
    return AdamW(sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm, moment_dtype=moment_dtype,
                 sr_impl=sr_impl, seed=seed)

"""Fully sharded params: the gather on use and the reduce-scatter of
gradients (ZeRO-3), which GSPMD inserts implicitly in the JAX package.

A sharded leaf is a `Shard`: this rank's whole 2048-element blocks of the
flat tensor (parallel/partition.py says which leaves and why whole blocks).
The model code calls `gather(tree)` where it is about to use a layer's
params: every Shard in the tree becomes the full tensor through an
autograd Function whose forward all-gathers the blocks over the fsdp group
and whose backward reduce-scatters the full gradient (SUM) back to the
blocks, then sums it over the data group.  The layer loops call it inside
their checkpointed layer function, so remat frees the gathered weights
after the forward and gathers them again for the backward.  On a tree
without Shards `gather` returns the tree itself: the single-process paths
do not change.

Rollouts do not gather per layer and step: `gather_params` gathers the
whole tree once per rollout (no autograd) and the caller frees it when the
rollout ends (DeepSpeed's GatheredParameters).  Replicated leaves take the
ordinary autograd gradient, summed over data x fsdp by `reduce_replicated`.
The steps normalise their losses over the global batch (`global_share`) so
the summed gradients are the world-1 gradients; `global_norm` counts each
shard once and every replicated leaf once.

Under expert parallelism the experts' Shards are placed by expert and
never gathered (parallel/expert.py).  Their blocks are split over the ep
axes (`experts`: ("fsdp",), ("data",) or ("data", "fsdp")) instead of
fsdp: `split_group` names that group, and every collective of a Shard's
blocks (its full tensor, the norm, the optimizer state's round trip) runs
over it.

With tensor parallelism a Shard holds this rank's blocks of its tp SLICE
(`split`, a parallel/tp.Split; partition.py says which leaves): `gather`
and `gather_params` collect over fsdp only and give the slice, which the
model multiplies as it is; `full_params` (checkpoints, exports) also
joins the tp slices.  The batch group is data x fsdp at one tp index, so
the gradients of leaves whole on every tp rank (the same on each: the
conjugate operations of parallel/tp.py see to it) sum as at tp 1.
"""

from __future__ import annotations

import math

import torch

from spacer_tpu_torch.parallel import multihost


def _block() -> int:
    from spacer_tpu_torch.train.optimizer import BLOCK

    return BLOCK


# the axes a Shard's blocks split over (fsdp, or the ep axes of an expert
# placement, parallel/expert.py) -> (their process group, the batch axis
# outside it, over which an expert's gradient sums, and the group of every
# rank holding a piece of one tensor: the blocks' group x tp)
SPLITS = {("fsdp",): ("fsdp", "data", "model"),
          ("data",): ("data", "fsdp", "data_tp"),
          ("data", "fsdp"): ("batch", None, "all")}


def split_group(mesh, axes) -> tuple:
    """(group name, size, this rank's index in it) of `axes`."""
    name = SPLITS[axes][0]
    return (name, math.prod(mesh.shape[a] for a in axes),
            mesh.peers(name).index(mesh.rank))


class Shard:
    """One rank's share of an fsdp-sharded tensor of `shape`: blocks
    [block_lo, block_lo + nb_local) of its flat view cut into BLOCK-element
    blocks, as a (nb_local, BLOCK) tensor `data`; blocks past the tensor's
    end are zeros.  `data` is the leaf the optimizer updates.  With a
    `split` (parallel/tp.Split) the tensor of `shape` is this rank's tp
    slice of a tensor of split.shape.  `experts`: () for an fsdp Shard, or
    the ep axes an expert placement splits the blocks over (`axes`)."""

    __slots__ = ("data", "shape", "mesh", "split", "experts")

    def __init__(self, data: torch.Tensor, shape, mesh, split=None,
                 experts: tuple = ()):
        self.data = data
        self.shape = torch.Size(shape)
        self.mesh = mesh
        self.split = split
        self.experts = tuple(experts)

    @classmethod
    def from_full(cls, full: torch.Tensor, mesh, split=None,
                  experts: tuple = ()) -> "Shard":
        """This rank's blocks of a full tensor (the same on every rank), or
        of its tp slice with a `split`."""
        if split is not None:
            full = split.take(full.detach())
        B = _block()
        _, F, index = split_group(mesh, tuple(experts) or ("fsdp",))
        nb = -(-full.numel() // B)
        per = -(-nb // F)
        lo = index * per * B
        flat = full.detach().reshape(-1)
        data = torch.zeros(per * B, dtype=full.dtype, device=full.device)
        piece = flat[lo:lo + per * B]
        data[:piece.numel()] = piece
        return cls(data.reshape(per, B), full.shape, mesh, split, experts)

    @property
    def axes(self) -> tuple:
        """The axes the blocks are split over."""
        return self.experts or ("fsdp",)

    @property
    def group(self) -> tuple:
        """(name, size, this rank's index) of the blocks' group."""
        return split_group(self.mesh, self.axes)

    @property
    def pieces_group(self) -> str:
        """The group of every rank that holds a piece of the whole tensor:
        the blocks' group x tp."""
        return SPLITS[self.axes][2]

    @property
    def numel(self) -> int:
        return self.shape.numel()

    @property
    def nb_full(self) -> int:
        """Blocks of the full tensor (the last one zero-padded)."""
        return -(-self.numel // _block())

    @property
    def block_lo(self) -> int:
        return self.group[2] * self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def requires_grad(self) -> bool:
        return self.data.requires_grad

    def full(self) -> torch.Tensor:
        """The gathered tensor (this rank's tp slice), outside autograd."""
        with torch.no_grad():
            return _all_gather(self.data, self)

    def unsplit(self) -> torch.Tensor:
        """The whole tensor: gathered over fsdp, then its tp slices
        joined, outside autograd."""
        return join_tp(self.full(), self)

    def __repr__(self):
        tp = (f", tp slice {self.split.index} of {tuple(self.split.shape)}"
              if self.split else "") + (
            f", experts over {' x '.join(self.experts)}" if self.experts
            else "")
        return (f"Shard({tuple(self.shape)}, blocks {self.block_lo}+"
                f"{self.data.shape[0]} of {self.nb_full}, {self.dtype}{tp})")


def join_tp(local: torch.Tensor, shard: Shard) -> torch.Tensor:
    """A tensor shaped like the Shard's tp slice -> the whole tensor, its
    slices all-gathered over tp (the tensor itself without a split)."""
    split = shard.split
    if split is None:
        return local
    local = local.contiguous().reshape(-1)
    out = torch.empty((split.tp * local.numel(),), dtype=local.dtype,
                      device=local.device)
    multihost.all_gather_into(out, local, shard.mesh.group("tp"))
    return split.join(out.view(split.tp, -1).unbind(0))


def _all_gather(data: torch.Tensor, shard: Shard) -> torch.Tensor:
    name, F, _ = shard.group
    out = torch.empty((F * data.numel(),), dtype=data.dtype,
                      device=data.device)
    multihost.all_gather_into(out, data.reshape(-1), shard.mesh.group(name))
    return out[:shard.numel].view(shard.shape)


class _Gather(torch.autograd.Function):
    """Shard blocks -> the full tensor; backward: the full gradient
    reduce-scattered over fsdp (SUM), then summed over data."""

    @staticmethod
    def forward(ctx, data, shard):
        ctx.shard = shard
        return _all_gather(data, shard)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        mesh = shard.mesh
        local = shard.data
        F = mesh.shape["fsdp"]
        flat = grad.reshape(-1)
        padded = torch.zeros((F * local.numel(),), dtype=grad.dtype,
                             device=grad.device)
        padded[:flat.numel()] = flat
        out = torch.empty(local.shape, dtype=grad.dtype, device=grad.device)
        multihost.reduce_scatter(out.reshape(-1), padded, mesh.group("fsdp"))
        multihost.all_reduce(out, mesh.group("data"))
        return out, None


def gather(tree, keep=()):
    """`tree` with every Shard replaced by its full tensor (autograd-aware:
    gradients flow back to the Shards' blocks).  Entries of a dict named in
    `keep` stay as they are (the layer lists a loop gathers one layer at a
    time).  A tree without Shards comes back as it is; so do expert-placed
    Shards (parallel/expert.py), which are never gathered."""
    if isinstance(tree, Shard):
        if tree.experts:
            return tree
        return _Gather.apply(tree.data, tree)
    if isinstance(tree, dict):
        if not has_shards(tree):
            return tree
        return {k: v if k in keep else gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and has_shards(tree):
        return type(tree)(gather(v) for v in tree)
    return tree


def gather_params(tree):
    """The whole tree gathered once, outside autograd (a rollout's or a
    checkpoint's full params); the caller drops it when done.  Expert-placed
    Shards stay on their owners."""
    if isinstance(tree, Shard):
        return tree if tree.experts else tree.full()
    if isinstance(tree, dict):
        return {k: gather_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_params(v) for v in tree)
    return tree


def full_params(tree):
    """The whole tree gathered over fsdp AND tp (checkpoints and exports:
    every tensor whole), outside autograd."""
    if isinstance(tree, Shard):
        return tree.unsplit()
    if isinstance(tree, dict):
        return {k: full_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_params(v) for v in tree)
    return tree


def has_shards(tree) -> bool:
    if isinstance(tree, Shard):
        return True
    if isinstance(tree, dict):
        return any(has_shards(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_shards(v) for v in tree)
    return False


def raw_leaves(tree) -> list:
    """Leaves in train.step.param_leaves order, Shards as they are."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in raw_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in raw_leaves(v)]
    return [tree]


def shard_blocks(tree):
    """Per leaf in param_leaves order: (first block, blocks of the whole
    tensor) for a Shard, with the Shard itself as a third entry for a tp
    slice (the optimizer reads its Split and mesh), None for a replicated
    leaf; None for a tree without Shards (the optimizer's `blocks`)."""
    raw = raw_leaves(tree)
    if not any(isinstance(leaf, Shard) for leaf in raw):
        return None
    return [_blocks_of(leaf) if isinstance(leaf, Shard) else None
            for leaf in raw]


def _blocks_of(leaf: Shard):
    if leaf.split is None:
        return (leaf.block_lo, leaf.nb_full)
    return (leaf.block_lo, leaf.nb_full, leaf)


def reduce_replicated(grads: list, raw: list, mesh) -> list:
    """Sum the replicated leaves' gradients over data x fsdp, in place, one
    all-reduce per dtype (the Shards' gradients were reduced by their
    gather's backward)."""
    by_dtype = {}
    for i, (g, leaf) in enumerate(zip(grads, raw)):
        if g is not None and not isinstance(leaf, Shard):
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        multihost.all_reduce(flat, mesh.group("batch"))
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].view_as(grads[i])
            off += n
    return grads


def global_norm(grads: list, raw: list, mesh) -> torch.Tensor:
    """sqrt(sum of squares) of the full gradients, accumulated in f32:
    each Shard's blocks summed over the group they split over (fsdp, or an
    expert placement's ep axes; its replicas over the other batch axes hold
    the same blocks; the zero padding adds nothing), then a tp slice's sums
    over tp, each replicated leaf (also whole on every tp rank) counted
    once."""
    def square_sum(g, leaf):
        if isinstance(leaf, Shard) and leaf.group[1] == 1:
            # one rank holds the whole tensor: sum it in its own shape, the
            # single-process norm's order
            g = g.reshape(-1)[:leaf.numel].view(leaf.shape)
        return g.float().square().sum()

    sq = torch.stack([square_sum(g, leaf) for g, leaf in zip(grads, raw)])
    groups = [leaf.group[0] if isinstance(leaf, Shard) else None
              for leaf in raw]
    # every fsdp Shard's group, and any ep group that holds experts
    for name in ["fsdp"] + sorted(set(groups) - {None, "fsdp"}):
        sharded = torch.tensor([g == name for g in groups], device=sq.device)
        part = torch.where(sharded, sq, torch.zeros_like(sq))
        multihost.all_reduce(part, mesh.group(name))
        sq = torch.where(sharded, part, sq)
    split = [isinstance(leaf, Shard) and leaf.split is not None
             for leaf in raw]
    if any(split):
        split = torch.tensor(split, device=sq.device)
        part = torch.where(split, sq, torch.zeros_like(sq))
        multihost.all_reduce(part, mesh.group("tp"))
        sq = torch.where(split, part, sq)
    return torch.sqrt(sum(sq.unbind()))


def global_share(n_local: int, device, mesh) -> torch.Tensor:
    """n_local / (sum of n_local over data x fsdp), as f32: the weight of
    this rank's local mean in the global mean (a replicated batch counts
    its rows on every rank, so each rank's weight is then 1 / world)."""
    counts = torch.tensor([float(n_local)], dtype=torch.float64, device=device)
    multihost.all_reduce(counts, mesh.group("batch"))
    return (n_local / counts[0]).float()


def global_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """A scalar summed over data x fsdp (a copy; x is left as it is)."""
    out = x.detach().clone().reshape(1)
    multihost.all_reduce(out, mesh.group("batch"))
    return out[0]


# -- optimizer state: this rank's blocks <-> the world-1 layout ----------------


def _state_leaf_to_full(t: torch.Tensor, leaf: Shard, per_param: bool):
    """A state tensor shaped like a Shard's blocks (per_param: moments or
    an accumulator, shaped (nb_local, BLOCK)) or like its int8 rows
    ((nb_local, BLOCK) payloads, (nb_local, 1) scales) -> the full
    layout."""
    name, F, _ = leaf.group
    home = t.device
    t = t.to(leaf.device)   # an offloaded state crosses the card's collective
    out = torch.empty((F * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    multihost.all_gather_into(out, t.contiguous(), leaf.mesh.group(name))
    if per_param:
        return join_tp(out.reshape(-1)[:leaf.numel].view(leaf.shape),
                       leaf).to(home)
    if leaf.split is None:
        return out.to(home)[:leaf.nb_full]
    # int8 payload rows of a tp slice -> the whole tensor's rows
    B = _block()
    whole = join_tp(out.reshape(-1)[:leaf.numel].view(leaf.shape),
                    leaf).reshape(-1).to(home)
    rows = torch.zeros((-(-whole.numel() // B) * B,), dtype=t.dtype,
                       device=home)
    rows[:whole.numel()] = whole
    return rows.view(-1, B)


def _state_leaf_from_full(t: torch.Tensor, leaf: Shard, per_param: bool):
    """Inverse of _state_leaf_to_full: this rank's rows, zero-padded."""
    B = _block()
    per = leaf.data.shape[0]
    lo = leaf.block_lo
    if leaf.split is not None:
        # the whole tensor's (elements or int8 payload rows) -> the slice's
        n = leaf.numel
        whole = leaf.split.shape
        t = leaf.split.take(t.reshape(-1)[:math.prod(whole)].view(
            whole)).reshape(-1)
        if not per_param:
            t = torch.nn.functional.pad(t, (0, (-n) % B)).view(-1, B)
    if per_param:
        rows = torch.zeros((per * B,), dtype=t.dtype, device=t.device)
        piece = t.reshape(-1)[lo * B:(lo + per) * B]
        rows[:piece.numel()] = piece
        return rows.view(per, B)
    rows = torch.zeros((per, *t.shape[1:]), dtype=t.dtype, device=t.device)
    piece = t[lo:lo + per]
    rows[:piece.shape[0]] = piece
    return rows


def _convert_state(state, raw: list, fn):
    from spacer_tpu_torch.train.optimizer import MultiStepsState, OptState

    if isinstance(state, MultiStepsState):
        acc = [fn(a, leaf, True) if isinstance(leaf, Shard) else a
               for a, leaf in zip(state.acc_grads, raw)]
        return state._replace(
            inner_opt_state=_convert_state(state.inner_opt_state, raw, fn),
            acc_grads=acc)
    if not isinstance(state, OptState):
        raise TypeError(f"unknown optimizer state {type(state).__name__}")
    if len(state.mu) == len(state.groups) and state.mu and isinstance(
            state.mu[0], tuple):
        # int8: one (payload, scale) pair per moment group
        def conv(pairs):
            out = []
            for pair, idx in zip(pairs, state.groups):
                leaf = raw[idx[0]]
                if len(idx) == 1 and isinstance(leaf, Shard):
                    # a tp slice's scales are the whole tensor's already
                    pair = (fn(pair[0], leaf, False),
                            pair[1] if leaf.split is not None
                            else fn(pair[1], leaf, False))
                out.append(pair)
            return out
    else:
        def conv(ts):
            return [fn(t, leaf, True) if isinstance(leaf, Shard) else t
                    for t, leaf in zip(ts, raw)]
    blocks = None
    if fn is _state_leaf_from_full:
        leaf_blocks = shard_blocks(raw)
        if leaf_blocks is not None:
            blocks = [leaf_blocks[idx[0]] if len(idx) == 1 else None
                      for idx in state.groups]
    return state._replace(mu=conv(state.mu), nu=conv(state.nu), blocks=blocks)


def state_to_full(state, params):
    """This rank's optimizer state -> the world-1 state (every rank gets
    it): the Shards' moments (and accumulator) gathered over their group
    (fsdp, or an expert placement's ep axes) and cut to the tensors' own
    size."""
    return _convert_state(state, raw_leaves(params), _state_leaf_to_full)


def state_from_full(state, params):
    """A world-1 optimizer state -> this rank's, for sharded `params`."""
    return _convert_state(state, raw_leaves(params), _state_leaf_from_full)


def params_from_full(full, like):
    """Full params -> the layout of `like`: Shards where `like` has them
    (cut for the mesh `like`'s Shards are on), the full tensor elsewhere."""
    if isinstance(like, Shard):
        return Shard.from_full(full.to(like.device), like.mesh, like.split,
                               like.experts)
    if isinstance(like, dict):
        return {k: params_from_full(full[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(params_from_full(f, v) for f, v in zip(full, like))
    return full

"""Expert parallelism over the fsdp axis, the data axis or both (the
cross-process half of spacer_tpu/ops/moe.py moe_mlp_ep, which GSPMD
partitions over `ep_axis`; there the axis moves data, not values).

The ep group.  `cfg.moe_ep_axis` names the axes (`ep_axes`: "fsdp",
"data" or ("data", "fsdp")); the ep group is those axes at this rank's
other coordinates (the mesh's "fsdp", "data" or "batch" group), of n
ranks.

Placement.  Under moe_impl "ep" the experts' fc1 / fc2 are Shards
(parallel/fsdp.py) whose blocks are split over the ep group instead of
fsdp (`Shard.experts` = the ep axes): with n dividing E and E / n
experts' (tp slices') elements a whole number of 2048-blocks, rank i of
the group holds exactly experts [i E / n, (i + 1) E / n), so the Shard IS
the expert placement.  `gather` and `gather_params` leave such a Shard as
it is; the MoE reads its blocks as this rank's experts (`local_experts`,
whose backward sums the gradient over the batch axes outside the ep
group: data for fsdp, fsdp for data, none for data x fsdp); the optimizer,
the norm and checkpoints treat it as any Shard over its group.

Rows.  JAX dispatches over the GLOBAL batch: an assignment's position in
its expert counts every earlier (token, k) of the global batch, and C
comes from the global token count.  The MoE cannot tell from x whether
its rows are its own or a replica's, so the code that split the rows says
so (`rows(layout)`, a context as parallel/tp.set_mesh is): a `RowLayout`
names the global row count and each batch index's row range (data major,
fsdp minor, as partition.row_range and JAX's P(("data", "fsdp"))), or
None where every rank holds every row.  Each rank counts its rows'
assignments per expert, the counts of the global rows are max-reduced
over the batch group ("ep_counts": a row held twice is counted the same
twice), and each rank offsets its positions by the counts of the rows
before its own.

Moving the tokens, over the ep group (at this rank's tp index):

- rows split within the group: x, the scores and the kept assignments'
  experts are all-gathered ("ep_all_gather"), each owner runs its experts
  on the kept assignments routed to them (ops/moe.kept_expert_ffn) and
  weights them by their scores, and the partial sums are reduce-scattered
  back to the rows' holders ("ep_reduce_scatter");
- rows replicated within the group: each owner runs its experts on the
  shared rows and the partial sums are all-reduced ("ep_all_reduce"; JAX's
  "all gather in, psum out").

Each exchange is an autograd Function whose backward is the reverse
exchange.  At ep 1 (fsdp 1) the experts are all local: the exchange is
counted in multihost.collective_stats under its kind and not issued, with
no autograd node, and the routed output is the single-process one bit for
bit, whatever the axis.  Decode loops over split rows agree on their early
exit over the batch group (`all_done`, "ep_done"): a rank that left would
stop issuing its exchanges.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from spacer_tpu_torch.parallel import multihost

_LAYOUT = [None]


class RowLayout(NamedTuple):
    """The global batch of `n` rows and each batch index's [lo, hi) of it
    (None: every rank holds all n rows; n None: whatever rows the MoE
    gets, every rank holds the same)."""

    n: int | None
    ranges: tuple | None = None

    def range(self, batch_index: int) -> tuple:
        return (0, self.n) if self.ranges is None else self.ranges[batch_index]


# every rank runs the same rows (the serving batcher's)
EVERY_RANK = RowLayout(None)


@contextlib.contextmanager
def rows(layout: RowLayout | None):
    """The rows every MoE of the enclosed forwards sees are laid out as
    `layout` says."""
    prev = _LAYOUT[0]
    _LAYOUT[0] = layout
    try:
        yield
    finally:
        _LAYOUT[0] = prev


def current() -> RowLayout | None:
    """The layout of the enclosing `rows` (what a recomputed layer needs)."""
    return _LAYOUT[0]


def split_layout(n: int, mesh, axes) -> RowLayout:
    """n rows split evenly over `axes` (("data", "fsdp"), ("data",) or ():
    replicated), as the Sampler and partition.row_range split them."""
    if mesh is None or not axes:
        return RowLayout(n)
    D, F = mesh.shape["data"], mesh.shape["fsdp"]
    if tuple(axes) == ("data", "fsdp"):
        per = n // (D * F)
        return RowLayout(n, tuple((b * per, (b + 1) * per)
                                  for b in range(D * F)))
    per = n // D
    return RowLayout(n, tuple((d * per, (d + 1) * per)
                              for d in range(D) for _ in range(F)))


def batch_layout(n: int, mesh) -> RowLayout:
    """partition.row_range's rows of every batch index: split over data x
    fsdp where n divides, else every rank holds them all."""
    if mesh is None or n % (mesh.shape["data"] * mesh.shape["fsdp"]):
        return RowLayout(n)
    return split_layout(n, mesh, ("data", "fsdp"))


def expand_layout(layout: RowLayout, group: int) -> RowLayout:
    """The rows of the `group` completions of each row of `layout`."""
    if layout.n is None:
        return layout
    return RowLayout(layout.n * group, layout.ranges and tuple(
        (lo * group, hi * group) for lo, hi in layout.ranges))


def group_layout(layout: RowLayout, group: int) -> RowLayout:
    """The rows of the groups the rows of `layout` belong to (completion
    rows -> their prompts' rows, `group` completions a prompt)."""
    if layout.ranges is None:
        return RowLayout(layout.n // group)
    return RowLayout(layout.n // group,
                     tuple((lo // group, -(-hi // group))
                           for lo, hi in layout.ranges))


def ep_axes(ep_axis) -> tuple:
    """The axes of a moe_ep_axis value ("fsdp", "data" or ("data", "fsdp"),
    a name or its 1-tuple); ValueError naming the accepted ones for any
    other."""
    from spacer_tpu_torch.parallel.fsdp import SPLITS

    axes = ((ep_axis,) if isinstance(ep_axis, str) else tuple(ep_axis)
            if isinstance(ep_axis, (list, tuple)) else None)
    if axes not in SPLITS:
        raise ValueError(f"moe ep_axis {ep_axis!r}: expert parallelism runs "
                         f"over one of {list(SPLITS)} (a name alone for a "
                         "1-tuple)")
    return axes


def is_placed(t) -> bool:
    """Whether `t` is an expert-placed Shard."""
    from spacer_tpu_torch.parallel.fsdp import Shard

    return isinstance(t, Shard) and t.experts


def has_placed(tree) -> bool:
    if isinstance(tree, dict):
        return any(has_placed(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_placed(v) for v in tree)
    return is_placed(tree)


def check_placement(shard) -> None:
    """An expert leaf must cut into whole experts: the ep group's n ranks
    divide E and the E / n experts' elements are whole 2048-blocks
    (ValueError)."""
    from spacer_tpu_torch.train.optimizer import BLOCK

    _, F, _ = shard.group
    what = " x ".join(shard.axes)
    E = shard.shape[0]
    if E % F:
        raise ValueError(f"{what}={F} does not divide the {E} experts of "
                         "moe_impl='ep'")
    per = shard.shape.numel() // E * (E // F)
    if F > 1 and per % BLOCK:
        raise ValueError(
            f"moe_impl='ep' over {what}={F}: {E // F} experts of shape "
            f"{tuple(shard.shape[1:])} are {per} elements, not whole "
            f"{BLOCK}-element blocks")


class _ExpertView(torch.autograd.Function):
    """A Shard's blocks -> its (E / n, ...) experts; backward: the gradient
    into the blocks, summed over the batch axes outside the ep group."""

    @staticmethod
    def forward(ctx, data, shard):
        ctx.shard = shard
        return _view(data, shard)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        out = torch.zeros(shard.data.numel(), dtype=grad.dtype,
                          device=grad.device)
        out[:grad.numel()] = grad.reshape(-1)
        out = out.view(shard.data.shape)
        from spacer_tpu_torch.parallel.fsdp import SPLITS

        other = SPLITS[shard.axes][1]
        if other is not None:
            multihost.all_reduce(out, shard.mesh.group(other))
        return out, None


def _view(data, shard):
    E = shard.shape[0] // shard.group[1]
    n = E * (shard.shape.numel() // shard.shape[0])
    return data.reshape(-1)[:n].view(E, *shard.shape[1:])


def local_experts(shard) -> torch.Tensor:
    """This rank's experts (their tp slices) of an expert-placed Shard."""
    if torch.is_grad_enabled() and shard.data.requires_grad:
        return _ExpertView.apply(shard.data, shard)
    return _view(shard.data, shard)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather_rows(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_rows(grad, ctx.group, ctx.n), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _scatter_rows(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        return _gather_rows(grad, ctx.group, ctx.n), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return multihost.all_reduce(x.contiguous().clone(), group,
                                    kind="ep_all_reduce")

    @staticmethod
    def backward(ctx, grad):
        return multihost.all_reduce(grad.contiguous().clone(), ctx.group,
                                    kind="ep_all_reduce"), None


def _gather_rows(x, group, n):
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return multihost.all_gather_into(out, x.contiguous(), group,
                                     kind="ep_all_gather")


def _scatter_rows(x, group, n):
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return multihost.reduce_scatter(out, x.contiguous(), group,
                                    kind="ep_reduce_scatter")


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _layout(mesh, rows: int) -> RowLayout:
    layout = _LAYOUT[0]
    if layout is None:
        if mesh.shape["data"] * mesh.shape["fsdp"] > 1:
            raise RuntimeError(
                "moe_impl='ep' over a batch group of "
                f"{mesh.shape['data'] * mesh.shape['fsdp']} ranks: the caller "
                "must say how its rows are laid out (parallel.expert.rows)")
        layout = RowLayout(rows)
    if layout.n is None:
        layout = RowLayout(rows)
    lo, hi = layout.range(mesh.batch_index)
    if hi - lo != rows:
        raise ValueError(f"the row layout gives this rank rows [{lo}, {hi}) "
                         f"but the MoE got {rows}")
    return layout


def _offsets(flat_e, rows: int, E: int, layout: RowLayout, mesh):
    """Per expert, the assignments of the global rows before this rank's
    (their counts max-reduced over the batch group)."""
    lo, hi = layout.range(mesh.batch_index)
    if layout.ranges is None or all(r == (0, layout.n)
                                    for r in layout.ranges):
        return None
    per_row = flat_e.numel() // rows
    row = torch.arange(flat_e.numel(), device=flat_e.device) // per_row
    counts = torch.zeros((layout.n, E), dtype=torch.int32,
                         device=flat_e.device)
    counts.view(-1).index_add_(0, (row + lo) * E + flat_e,
                               torch.ones_like(flat_e, dtype=torch.int32))
    multihost.all_reduce(counts, mesh.group("batch"), kind="ep_counts",
                         op="max")
    return counts[:lo].sum(dim=0)


def routed_ep(fc1, fc2, xt, scores, top_idx, capacity_factor: float,
              rows: int):
    """The routed output (T, D) f32 of x's T = rows * tokens tokens, their
    top-k `scores` (T, K) and experts `top_idx`, with the experts of the
    expert-placed Shards fc1 / fc2 on their owners (the module docstring)."""
    from spacer_tpu_torch.ops import moe
    from spacer_tpu_torch.parallel.mesh import Mesh

    mesh = fc1.mesh
    name, F, index = fc1.group
    E = fc1.shape[0]
    El, e0 = E // F, index * (E // F)
    T, K = top_idx.shape
    layout = _layout(mesh, rows)
    tokens = T // rows
    C = moe.moe_capacity(layout.n * tokens, K, E, capacity_factor)
    flat_e = top_idx.reshape(-1)
    pos = moe.expert_positions(flat_e, E)
    off = _offsets(flat_e, rows, E, layout, mesh)
    if off is not None:
        pos = pos + off[flat_e]
    keep = pos < C
    code = torch.where(keep, flat_e, -1)
    w1, w2 = local_experts(fc1), local_experts(fc2)

    # the ep group's ranks' rows, in group order
    ranges = [layout.range(Mesh(mesh.shape, r).batch_index)
              for r in mesh.peers(name)]
    if F == 1:
        # every expert is local: counted, not issued
        multihost.record("ep_all_gather", xt)
        y = moe.kept_expert_ffn(w1, w2, xt, code, keep, K, e0, El,
                                min(T * K, El * C))
        out = moe.combine(y, scores)
        multihost.record("ep_reduce_scatter", out)
        return out
    group = mesh.group(name)
    if all(r == ranges[0] for r in ranges):
        y = moe.kept_expert_ffn(w1, w2, xt, code, keep, K, e0, El,
                                min(T * K, El * C))
        part = moe.combine(y, scores)
        if _grad(part):
            return _AllReduce.apply(part, group)
        return multihost.all_reduce(part, group, kind="ep_all_reduce")

    # rows split within the ep group: every row's kept assignments gathered
    # to every owner (padded to the longest range), partial sums scattered
    # back
    width = max(hi - lo for lo, hi in ranges) * tokens
    pad = width - T

    def padded(t, value=0):
        if not pad:
            return t
        return torch.cat([t, torch.full((pad, *t.shape[1:]), value,
                                        dtype=t.dtype, device=t.device)])

    if _grad(xt, scores):
        xg = _AllGather.apply(padded(xt), group, F)
        sg = _AllGather.apply(padded(scores), group, F)
    else:
        xg = _gather_rows(padded(xt), group, F)
        sg = _gather_rows(padded(scores), group, F)
    cg = _gather_rows(padded(code.view(T, K).to(torch.int32), -1), group,
                      F).reshape(-1).long()
    disjoint = all(a[1] <= b[0] for a, b in zip(sorted(ranges),
                                                sorted(ranges)[1:]))
    bound = F * width * K
    y = moe.kept_expert_ffn(w1, w2, xg, cg, cg >= 0, K, e0, El,
                            min(bound, El * C) if disjoint else bound)
    part = moe.combine(y, sg)
    if _grad(part):
        out = _ReduceScatter.apply(part, group, F)
    else:
        out = _scatter_rows(part, group, F)
    return out[:T]


def all_done(done: torch.Tensor, mesh) -> bool:
    """Whether every row of every rank of the batch group is done (one
    all-reduce, "ep_done"): the early exit of a decode loop whose ranks
    hold different rows and share the experts' exchanges."""
    left = (~done).any().to(torch.int32).reshape(1)
    multihost.all_reduce(left, mesh.group("batch"), kind="ep_done", op="max")
    return not bool(left[0])

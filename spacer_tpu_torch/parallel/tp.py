"""Tensor parallelism, Megatron style (the JAX package gets the same
function from GSPMD over the mesh's "tp" axis).

Hidden states are replicated across a tp group.  A column-parallel product
(q/k/v, gate/up, the ViT's qkv and gate/up or fc1, the merger's mlp_0,
lm_head) multiplies the replicated input by this rank's columns and yields
its local heads or columns; a row-parallel product (o_proj, down_proj, the
ViT's proj and down or fc2, the merger's mlp_2) multiplies the local
columns by this rank's rows and yields a partial sum, all-reduced over tp
before its bias.  The embedding is vocab-parallel (a masked lookup of this
rank's vocabulary rows, then an all-reduce), and so are the per-token
log-probabilities (`vocab_logps`); at decode the logits are all-gathered
(`gather_from_tp`) before sampling.

The conjugate operations are autograd Functions over the tp group:
`copy_to_tp` (identity; backward all-reduce) goes before a column-parallel
product, `reduce_from_tp` (all-reduce; backward identity) after a
row-parallel one, `gather_from_tp` all-gathers the last dim (backward: this
rank's slice) and `take` cuts this rank's slice out of a leaf kept whole
on every rank (backward: the slices' gradients all-gathered into the full
gradient, so a replicated leaf gets the same gradient on every tp rank).

The model code reads the tp group of the ACTIVE mesh (`set_mesh`, which
`partition.shard_params` calls): with no active mesh every operation is
the identity and the model runs as one process does.  With an active mesh
whose tp is 1 the tp code paths run (local head counts, the masked
embedding, the vocab-parallel logps) and each forward collective is the
identity, counted in `multihost.collective_stats` under its kind
("tp_all_reduce", "tp_all_gather", "tp_max") without being issued and
without an autograd node or a copy: there is nothing to reduce.

`Split` says where a rank's slice sits in the full tensor: the split dim
viewed as (pre, n, post) with n cut into tp equal parts, so the ViT's fused
qkv columns (3, heads, head_dim) split head-aware (pre 3, post head_dim)
and every other column, row or vocab split is pre = post = 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from spacer_tpu_torch.parallel import multihost

_ACTIVE = [None]


def set_mesh(mesh):
    """Make `mesh` the one whose tp group the model code reduces over (None:
    no tensor parallelism); returns the mesh active before."""
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh
    return prev


def active() -> bool:
    return _ACTIVE[0] is not None


def size() -> int:
    mesh = _ACTIVE[0]
    return 1 if mesh is None else mesh.shape["tp"]


def index() -> int:
    mesh = _ACTIVE[0]
    return 0 if mesh is None else mesh.coords["tp"]


def local_heads(n: int, what: str = "heads") -> int:
    """This rank's share of n heads (n // tp); a tp that does not divide n
    raises ValueError naming it."""
    tp = size()
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {what}={n}")
    return n // tp


# -- collectives (counted; not issued at tp 1) ---------------------------------


def _all_reduce(x: torch.Tensor, kind: str, op: str = "sum") -> torch.Tensor:
    """x reduced over the tp group, in place."""
    if size() == 1:
        multihost.record(kind, x)
        return x
    return multihost.all_reduce(x, _ACTIVE[0].group("tp"), kind=kind, op=op)


def _all_gather_last(x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' x concatenated along the last dim, in rank order."""
    tp = size()
    if tp == 1:
        multihost.record("tp_all_gather", x)
        return x
    x = x.contiguous()
    out = torch.empty((tp * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    multihost.all_gather_into(out, x, _ACTIVE[0].group("tp"),
                              kind="tp_all_gather")
    return torch.cat(out.view(tp, *x.shape).unbind(0), dim=-1)


def all_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the tp group (a copy; no gradient): the
    decode quantization's scales over a dim tp splits."""
    if not active():
        return x
    if size() == 1:
        return _all_reduce(x, "tp_max")
    return _all_reduce(x.detach().contiguous().clone(), "tp_max", op="max")


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), "tp_all_reduce")


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone(), "tp_all_reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-1]
        return _all_gather_last(x)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.n
        return grad[..., index() * n:(index() + 1) * n]


def copy_to_tp(x):
    """Before a column-parallel product: identity; backward all-reduce."""
    if (size() == 1 or not torch.is_grad_enabled()
            or not x.requires_grad):
        return x
    return _CopyToTP.apply(x)


def reduce_from_tp(x):
    """After a row-parallel product: the partial sums all-reduced over tp;
    backward identity."""
    if not active():
        return x
    if size() == 1:
        return _all_reduce(x, "tp_all_reduce")
    return _ReduceFromTP.apply(x)


def gather_from_tp(x):
    """The tp ranks' last-dim slices concatenated (full logits from the
    local vocabulary's); backward: this rank's slice."""
    if not active():
        return x
    if size() == 1:
        return _all_gather_last(x)
    return _GatherFromTP.apply(x)


# -- where a slice sits in the full tensor ---------------------------------------


class Split(NamedTuple):
    """A tensor of `shape` cut along `dim` into `tp` parts, rank `index`
    keeping part `index`.  The dim is viewed as (pre, n, post) and n is
    what splits: the full tensor reads as (outer, n, inner) with outer =
    prod(shape[:dim]) * pre and inner = post * prod(shape[dim + 1:])."""

    shape: tuple
    dim: int
    tp: int
    index: int
    pre: int = 1
    post: int = 1

    @classmethod
    def make(cls, shape, dim: int, tp: int, index: int, pre: int = 1,
             post: int = 1, what: str = "") -> "Split":
        shape = tuple(int(s) for s in shape)
        dim = dim % len(shape)
        n, rem = divmod(shape[dim], pre * post)
        if rem or n % tp:
            raise ValueError(
                f"tp={tp} does not divide {what or 'dim'} (size {n} of "
                f"shape {shape}, dim {dim})")
        return cls(shape, dim, int(tp), int(index), int(pre), int(post))

    @property
    def view(self) -> tuple:
        d = self.dim
        n = self.shape[d] // (self.pre * self.post)
        return (math.prod(self.shape[:d]) * self.pre, n,
                self.post * math.prod(self.shape[d + 1:]))

    @property
    def local_shape(self) -> tuple:
        s = list(self.shape)
        s[self.dim] //= self.tp
        return tuple(s)

    def take(self, full: torch.Tensor, index: int | None = None):
        """Part `index` (default this split's) of the full tensor."""
        o, n, i = self.view
        t = self.index if index is None else index
        nl = n // self.tp
        return full.reshape(o, n, i)[:, t * nl:(t + 1) * nl].reshape(
            self.local_shape)

    def join(self, parts) -> torch.Tensor:
        """The full tensor from the tp parts, in rank order."""
        o, n, i = self.view
        nl = n // self.tp
        return torch.cat([p.reshape(o, nl, i) for p in parts],
                         dim=1).reshape(self.shape)

    def full_index(self, local_flat: torch.Tensor) -> torch.Tensor:
        """Flat indices into the full tensor of the slice's flat indices
        (increasing with them)."""
        _, n, i = self.view
        nl = n // self.tp
        o, r = local_flat // (nl * i), local_flat % (nl * i)
        return (o * n + self.index * nl + r // i) * i + r % i


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, full, split):
        ctx.split = split
        return split.take(full).contiguous()

    @staticmethod
    def backward(ctx, grad):
        split = ctx.split
        o, n, i = split.view
        g = grad.contiguous().reshape(o, n // split.tp, i)
        if split.tp == 1:
            multihost.record("tp_all_gather", g)
            return g.reshape(split.shape), None
        out = torch.empty((split.tp * g.shape[0], *g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        multihost.all_gather_into(out, g, _ACTIVE[0].group("tp"),
                                  kind="tp_all_gather")
        return split.join(out.view(split.tp, *g.shape).unbind(0)), None


def local(t: torch.Tensor, dim: int, full: int, pre: int = 1, post: int = 1):
    """This rank's slice of a tensor along `dim`: the tensor itself where it
    already is a slice (size full / tp there), the slice of a tensor kept
    whole on every rank (size full; a bias, or a small per-layer kernel the
    partition keeps whole), taken with `take`'s gradient."""
    tp = size()
    n = t.shape[dim]
    if tp == 1 or n == full // tp and n != full:
        return t
    if n != full:
        raise ValueError(f"a tensor of size {n} along dim {dim} is neither "
                         f"the whole {full} nor its 1/{tp}")
    split = Split.make(t.shape, dim, tp, index(), pre, post)
    if torch.is_grad_enabled() and t.requires_grad:
        return _Take.apply(t, split)
    return split.take(t)


# -- products ----------------------------------------------------------------


def column(p: dict, x, full_out: int, pre: int = 1, post: int = 1):
    """Column-parallel dense: x (replicated; the caller puts copy_to_tp
    before the products that share it) times this rank's columns, plus its
    bias columns -> (..., full_out / tp)."""
    from spacer_tpu_torch.nn.core import dense

    if not active():
        return dense(p, x)
    q = dict(p)
    if "kernel" in q:
        q["kernel"] = local(q["kernel"], -1, full_out, pre, post)
    if "bias" in q:
        q["bias"] = local(q["bias"], 0, full_out, pre, post)
    return dense(q, x)


def row(p: dict, x, full_in: int):
    """Row-parallel dense: this rank's columns of x times its rows of the
    kernel, all-reduced over tp, then the (replicated) bias."""
    from spacer_tpu_torch.nn.core import dense

    if not active():
        return dense(p, x)
    q = {k: v for k, v in p.items() if k != "bias"}
    if "kernel" in q:
        q["kernel"] = local(q["kernel"], -2, full_in)
    y = reduce_from_tp(dense(q, x))
    if "bias" in p:
        y = y + p["bias"]
    return y


def embed(table: torch.Tensor, ids):
    """Vocab-parallel lookup: this rank's rows [t * V/tp, (t + 1) * V/tp)
    of the vocabulary, zeros for the ids other ranks own, all-reduced (one
    rank adds each row: the full lookup's values exactly)."""
    n = table.shape[0]
    lo = index() * n
    rel = ids - lo
    mine = (rel >= 0) & (rel < n)
    rows = table[torch.where(mine, rel, 0)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return reduce_from_tp(rows)


def vocab_logps(logits: torch.Tensor, targets) -> torch.Tensor:
    """log_softmax(full logits)[target] from this rank's vocabulary slice
    of f32 logits (..., V/tp): the max and the sum of exponentials
    all-reduced over tp, the target's logit taken from the rank that owns
    it (and its gradient going there only).  At tp 1 it is the one-process
    formula (train/grpo.per_token_logps_from_logits), with the three
    collectives counted."""
    if size() == 1:
        multihost.record("tp_max", logits[..., :1])
        multihost.record("tp_all_reduce", logits[..., :1])
        multihost.record("tp_all_reduce", logits[..., :1])
        picked = logits.gather(-1, targets[..., None].long())[..., 0]
        return picked - torch.logsumexp(logits, dim=-1)
    n = logits.shape[-1]
    rel = targets.long() - index() * n
    mine = (rel >= 0) & (rel < n)
    with torch.no_grad():
        m = _all_reduce(logits.amax(dim=-1).contiguous(), "tp_max", op="max")
    sumexp = reduce_from_tp(torch.exp(logits - m[..., None]).sum(dim=-1))
    picked = logits.gather(-1, torch.where(mine, rel, 0)[..., None])[..., 0]
    picked = reduce_from_tp(torch.where(mine, picked, torch.zeros_like(picked)))
    return picked - (m + torch.log(sumexp))

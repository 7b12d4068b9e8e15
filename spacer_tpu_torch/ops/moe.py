"""Mixture-of-Experts feed-forward (counterpart of spacer_tpu/ops/moe.py).

Behavioral reference: transformers modeling_aria.py AriaTextMoELayer (top-k
routing, token permutation), AriaGroupedExpertsMLP (fc1 -> chunk(projection,
gate) -> silu(p) * g -> fc2) and AriaSharedExpertsMLP.  The routing softmax
covers the top-k logits only, not every expert (AriaTextMoELayer.forward).

`moe_mlp` is dropless: the T*K (token, expert) rows are sorted by expert
(a stable argsort), the two grouped products run over the expert-contiguous
rows, and the outputs are scattered back to the T*K order and summed over k
in float32 with the routing scores; the sum is cast, then the shared
experts' SwiGLU output is added.

The grouped products are `grouped_mm`: torch._grouped_mm over the sorted
rows with the cumulative group sizes as offsets, on either device (the JAX
package leaves its jax.lax.ragged_dot to XLA, outside any Pallas kernel, so
no hand-written kernel replaces it).  It reads the group sizes on the
device, so a decode step takes no host sync per layer.  Its output is in
the operands' dtype (the card's bf16 grouped GEMM refuses an f32 output;
JAX asks ragged_dot for f32 sums): on the CPU's f32 the two agree to
rounding, on the card each product is rounded to bf16 once before the
SwiGLU and the weighted sum.  Its backward is grouped products too
(_GroupedMM), since torch's own autograd of _grouped_mm refuses these
layouts.

impl: "ragged" (default), "dense" (the O(M*E) oracle: every expert on
every row, masked) or "ep" (`moe_mlp_ep`, spacer_tpu's expert-parallel
capacity dispatch).  "ep" keeps an assignment iff its position within its
expert, counted in flat (token, k) order over x.reshape(-1, D), is below
C = moe_capacity(T, K, E, capacity_factor); a dropped assignment adds
nothing, so a token whose assignments all drop gets the shared experts'
output alone.  Padded positions route and take capacity like any other,
as in JAX's static shapes.  Its products are `grouped_mm` too, over the
kept rows sorted by expert (`kept_expert_ffn`: a static bound of
min(T*K, E*C) rows, the rows past the kept ones zero), not JAX's
(E, C, D) capacity buffers: an empty expert then reads no weights, which
at decode is most of them.  Their output dtype on the card is bf16, as
above.  Across processes the experts stay on their owners
(parallel/expert.py) and the same function runs on each owner's experts.

Tensor parallelism (parallel/tp.py): the router runs on the replicated
input (every tp rank routes alike), fc1 is column-parallel over both of
its [projection, gate] halves (each rank's columns of each), fc2
row-parallel, the shared experts as Qwen's MLP; the routed sum over k
(f32) is all-reduced over tp, cast, then the shared experts' reduced
output is added.  The scores pass copy_to_tp, since the gradient they get
from this rank's partial outputs is a partial sum.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from spacer_tpu_torch.parallel import tp

Params = Any


def _trunc_normal(shape, scale, *, generator, dtype, device):
    """Truncated normal in [-2, 2] sigma times `scale`, drawn in float32 on
    `device`, then cast (the init of spacer_tpu's init_moe_params)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def init_moe_params(hidden: int, intermediate: int, num_experts: int,
                    num_shared: int, *, generator: torch.Generator,
                    dtype=torch.float32, device=None) -> Params:
    """Parameter tree mirroring the HF Aria MoE layer: router (D, E), no
    bias; fc1 (E, D, 2I) producing [projection, gate] chunks; fc2 (E, I, D);
    the shared experts one SwiGLU MLP at width I * num_shared."""
    D, I, E = hidden, intermediate, num_experts
    Is = I * num_shared
    kw = dict(generator=generator, dtype=dtype, device=device)
    s = D ** -0.5
    return {
        "router": {"kernel": _trunc_normal((D, E), s, **kw)},
        "experts": {
            "fc1": {"kernel": _trunc_normal((E, D, 2 * I), s, **kw)},
            "fc2": {"kernel": _trunc_normal((E, I, D), I ** -0.5, **kw)},
        },
        "shared": {
            "gate_proj": {"kernel": _trunc_normal((D, Is), s, **kw)},
            "up_proj": {"kernel": _trunc_normal((D, Is), s, **kw)},
            "down_proj": {"kernel": _trunc_normal((Is, D), Is ** -0.5, **kw)},
        },
    }


def route_topk(router_kernel, x, topk: int):
    """x: (T, D) -> (scores (T, K) f32, expert indices (T, K) int64).
    Logits in f32; softmax over the K selected logits only."""
    logits = torch.matmul(x.float(), router_kernel.float())
    top_logits, top_idx = torch.topk(logits, topk, dim=-1)
    return torch.softmax(top_logits, dim=-1), top_idx


class _GroupedMM(torch.autograd.Function):
    """y[rows of group e] = x[rows of group e] @ w[e]; backward dx = dy
    w[e]^T per group and dw[e] = x_e^T dy_e, both grouped products."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return torch._grouped_mm(x, w, offs=offs)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch._grouped_mm(dy, w.transpose(1, 2), offs=offs)
        if ctx.needs_input_grad[1]:
            # offsets split the reduction (row) dimension: (E, K, N)
            dw = torch._grouped_mm(x.t(), dy, offs=offs)
        return dx, dw, None


def grouped_mm(x, w, group_sizes):
    """x (M, K) rows sorted by group, w (G, K, N), group_sizes (G,) summing
    to M -> (M, N) in x's dtype."""
    offs = torch.cumsum(group_sizes, 0).to(torch.int32)
    return _GroupedMM.apply(x.contiguous(), w, offs)


def grouped_mm_reference(x, w, group_sizes):
    """Plain version of grouped_mm: a per-group loop over the sorted row
    ranges (the group sizes are read on the host)."""
    out, start = [], 0
    for g, n in enumerate(group_sizes.tolist()):
        out.append(torch.matmul(x[start:start + n], w[g]))
        start += n
    return torch.cat(out, dim=0)


def expert_ffn_ragged(fc1_kernel, fc2_kernel, tokens, group_sizes):
    """Grouped SwiGLU over expert-contiguous rows -> (M, D) f32.
    tokens: (M, D) sorted by expert; group_sizes: (E,) rows per expert."""
    h = grouped_mm(tokens, fc1_kernel.to(tokens.dtype), group_sizes).float()
    proj, gate = h.chunk(2, dim=-1)
    h = (F.silu(proj) * gate).to(tokens.dtype)
    return grouped_mm(h, fc2_kernel.to(tokens.dtype), group_sizes).float()


def expert_ffn_dense(fc1_kernel, fc2_kernel, tokens, one_hot):
    """Oracle path: every expert on every row, masked-combined (f32).
    one_hot: (M, E) row-to-expert assignment."""
    h = torch.einsum("md,edi->emi", tokens.float(), fc1_kernel.float())
    proj, gate = h.chunk(2, dim=-1)
    h = F.silu(proj) * gate
    out = torch.einsum("emi,eid->emd", h, fc2_kernel.float())
    return torch.einsum("emd,me->md", out, one_hot.float())


IMPLS = ("ragged", "dense", "ep")


def moe_mlp(params: Params, x, *, topk: int, impl: str | None = None,
            capacity_factor: float = 2.0, ep_axis="fsdp",
            widths: tuple | None = None):
    """MoE feed-forward, x: (..., D) -> (..., D): top-k softmax routing,
    the per-token weighted combine of the routed experts' outputs, plus the
    shared experts' SwiGLU on the raw input.  impl "ep" is `moe_mlp_ep`
    (capacity_factor and ep_axis are its).  `widths` = (the expert
    intermediate, the shared experts' width), which tensor parallelism
    needs to tell a slice from a whole tensor (see the module docstring)."""
    from spacer_tpu_torch.parallel import expert

    impl = impl or "ragged"
    if impl not in IMPLS:
        raise ValueError(f"unknown moe impl {impl!r} (expected 'ragged', "
                         "'dense' or 'ep')")
    fc1 = params["experts"]["fc1"]["kernel"]
    fc2 = params["experts"]["fc2"]["kernel"]
    if impl == "ep":
        axes = expert.ep_axes(ep_axis)
        if expert.is_placed(fc1) and fc1.axes != axes:
            raise ValueError(f"moe ep_axis {ep_axis!r}: the experts are "
                             f"placed over {fc1.axes}")
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    if widths is None:
        if tp.active():
            raise ValueError("moe_mlp under tensor parallelism needs the "
                             "full widths (intermediate, shared width)")
        widths = (None, None)
    # the router reads the replicated input, so every tp rank picks the
    # same routes; its scores' gradient is a partial sum per tp rank
    # (they weight this rank's partial outputs), summed by copy_to_tp
    scores, top_idx = route_topk(params["router"]["kernel"], xt, topk)
    scores = tp.copy_to_tp(scores)
    xe = tp.copy_to_tp(xt)
    if impl == "ep" and expert.is_placed(fc1):
        combined = expert.routed_ep(fc1, fc2, xe, scores, top_idx,
                                    capacity_factor, rows=shape[0])
    else:
        fc1, fc2 = _local_experts(fc1, fc2, widths[0])
        if impl == "ep":
            E = params["router"]["kernel"].shape[-1]
            C = moe_capacity(xt.shape[0], topk, E, capacity_factor)
            flat_e = top_idx.reshape(-1)
            keep = expert_positions(flat_e, E) < C
            y = kept_expert_ffn(fc1, fc2, xe, flat_e, keep, topk, 0, E,
                                min(flat_e.numel(), E * C))
            combined = combine(y, scores)
        else:
            combined = _routed_dropless(fc1, fc2, xe, scores, top_idx, impl)
    # the routed partial sums of the tp ranks, then the shared experts'
    # (reduced inside their row-parallel down_proj)
    combined = tp.reduce_from_tp(combined)
    out = combined.to(x.dtype) + shared_expert_mlp(params["shared"], xe,
                                                   widths[1])
    return out.reshape(shape)


def moe_mlp_ep(params: Params, x, *, topk: int,
               capacity_factor: float = 2.0, ep_axis="fsdp",
               widths: tuple | None = None):
    """Expert-parallel MoE feed-forward with a per-expert capacity
    (spacer_tpu's moe_mlp_ep; see the module docstring): assignments past
    an expert's C = moe_capacity(T, K, E, capacity_factor) rows, in flat
    (token, k) order, are dropped."""
    return moe_mlp(params, x, topk=topk, impl="ep",
                   capacity_factor=capacity_factor, ep_axis=ep_axis,
                   widths=widths)


def _local_experts(fc1, fc2, intermediate):
    """This tp rank's columns of fc1 (of both its [projection, gate]
    halves) and rows of fc2, from their slices or whole tensors."""
    if not tp.active():
        return fc1, fc2
    return (tp.local(fc1, -1, 2 * intermediate, pre=2),
            tp.local(fc2, -2, intermediate))


def _routed_dropless(fc1, fc2, xt, scores, top_idx, impl):
    """The dropless routed output, combined over k in f32: (T, D)."""
    T, topk = top_idx.shape
    E = fc1.shape[0]
    flat_expert = top_idx.reshape(-1)                         # (T*K,)
    sort_ids = torch.argsort(flat_expert, stable=True)        # rows by expert
    permuted = xt[sort_ids // topk]                           # (T*K, D)
    if impl == "dense":
        one_hot = F.one_hot(flat_expert[sort_ids], E)
        expert_out = expert_ffn_dense(fc1, fc2, permuted, one_hot)
    else:
        # rows per expert, counted on the device (torch.bincount would read
        # the largest index on the host: a sync per layer)
        group_sizes = torch.zeros(E, dtype=torch.long, device=xt.device
                                  ).index_add_(0, flat_expert,
                                               torch.ones_like(flat_expert))
        expert_out = expert_ffn_ragged(fc1, fc2, permuted, group_sizes)
    # unpermute to the T*K order and combine with the routing scores in f32
    inv = torch.zeros((T * topk, expert_out.shape[-1]), dtype=torch.float32,
                      device=xt.device).index_copy(0, sort_ids, expert_out)
    return combine(inv, scores)


def combine(y, scores):
    """(T*K, D) per-assignment outputs -> (T, D): the sum over k weighted
    by the routing scores, in f32."""
    T, K = scores.shape
    return (y.view(T, K, -1) * scores[..., None]).sum(dim=1)


# copied from spacer_tpu/ops/moe.py moe_capacity
def moe_capacity(num_tokens: int, topk: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Per-expert row budget: cf * perfectly-balanced load, lane-rounded."""
    per_expert = num_tokens * topk / num_experts
    c = int(np.ceil(per_expert * capacity_factor))
    return max(8, min(num_tokens * topk, -(-c // 8) * 8))


def expert_positions(flat_e, num_experts: int):
    """The position of each assignment within its expert, counted in flat
    order (JAX's cumsum of the one-hot assignments): the rank of the
    assignment in a stable sort by expert, less its expert's first row."""
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.long,
                         device=flat_e.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    ranked = torch.arange(flat_e.numel(), device=flat_e.device) - starts[
        flat_e[order]]
    return torch.empty_like(ranked).index_copy_(0, order, ranked)


def kept_expert_ffn(fc1, fc2, xt, code, keep, topk: int, e0: int,
                    n_experts: int, rows: int):
    """The routed outputs of the kept assignments of experts [e0, e0 +
    n_experts), whose weights fc1 / fc2 are: (T*K, D) f32, zeros for every
    other assignment.

    code: (T*K,) expert per assignment; keep: (T*K,) bool.  Those
    assignments are sorted by expert (flat order within one) ahead of all
    others, and the first `rows` sorted rows (a static bound on the kept
    ones) run through the grouped products, the rows past the kept ones
    zeroed and counted into the last expert's group: a zero row gives a
    zero output and a zero weight gradient."""
    mine = keep & (code >= e0) & (code < e0 + n_experts)
    key = torch.where(mine, code - e0, n_experts)
    order = torch.argsort(key, stable=True)[:rows]
    sizes = torch.zeros(n_experts + 1, dtype=torch.long,
                        device=xt.device).index_add_(0, key,
                                                     torch.ones_like(key))
    sizes = sizes[:n_experts].clone()
    sizes[-1] += rows - sizes.sum()
    valid = mine[order]
    tokens = xt[order // topk] * valid[:, None].to(xt.dtype)
    out = expert_ffn_ragged(fc1, fc2, tokens, sizes)
    return torch.zeros((code.numel(), out.shape[-1]), dtype=torch.float32,
                       device=xt.device).index_copy(0, order, out)


def shared_expert_mlp(params: Params, x, width: int | None = None):
    """SwiGLU shared-experts MLP (AriaSharedExpertsMLP), through
    nn.core.dense so quantized decode trees dispatch to dense_q8 / dense_q4;
    under tensor parallelism gate / up are column-parallel and down
    row-parallel over `width` (x already past copy_to_tp)."""
    gate = F.silu(tp.column(params["gate_proj"], x, width))
    return tp.row(params["down_proj"],
                  gate * tp.column(params["up_proj"], x, width), width)

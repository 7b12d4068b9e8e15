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

impl: "ragged" (default) or "dense" (the O(M*E) oracle: every expert on
every row, masked); "ep", the expert-parallel capacity dispatch, belongs to
the parallel/ slice (ROADMAP queue A item 2) and raises.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from spacer_tpu_torch.nn.core import dense

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


def moe_mlp(params: Params, x, *, topk: int, impl: str | None = None):
    """MoE feed-forward, x: (..., D) -> (..., D): top-k softmax routing,
    the per-token weighted combine of the routed experts' outputs, plus the
    shared experts' SwiGLU on the raw input."""
    impl = impl or "ragged"
    if impl == "ep":
        raise NotImplementedError(
            "moe_mlp impl='ep' (expert-parallel dispatch, moe_mlp_ep) is not "
            "ported: it comes with Aria under tensor parallelism (ROADMAP "
            "queue A item 2b.2)")
    if impl not in ("ragged", "dense"):
        raise ValueError(f"unknown moe impl {impl!r} (expected 'ragged', "
                         "'dense' or 'ep')")
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    T = xt.shape[0]
    E = params["router"]["kernel"].shape[-1]

    scores, top_idx = route_topk(params["router"]["kernel"], xt, topk)
    flat_expert = top_idx.reshape(-1)                         # (T*K,)
    sort_ids = torch.argsort(flat_expert, stable=True)        # rows by expert
    permuted = xt[sort_ids // topk]                           # (T*K, D)
    fc1 = params["experts"]["fc1"]["kernel"]
    fc2 = params["experts"]["fc2"]["kernel"]
    if impl == "dense":
        one_hot = F.one_hot(flat_expert[sort_ids], E)
        expert_out = expert_ffn_dense(fc1, fc2, permuted, one_hot)
    else:
        # rows per expert, counted on the device (torch.bincount would read
        # the largest index on the host: a sync per layer)
        group_sizes = torch.zeros(E, dtype=torch.long, device=x.device
                                  ).index_add_(0, flat_expert,
                                               torch.ones_like(flat_expert))
        expert_out = expert_ffn_ragged(fc1, fc2, permuted, group_sizes)

    # unpermute to the T*K order and combine with the routing scores in f32
    inv = torch.zeros((T * topk, expert_out.shape[-1]), dtype=torch.float32,
                      device=x.device).index_copy(0, sort_ids, expert_out)
    combined = (inv.view(T, topk, -1) * scores[..., None]).sum(dim=1)
    out = combined.to(x.dtype) + shared_expert_mlp(params["shared"], xt)
    return out.reshape(shape)


def shared_expert_mlp(params: Params, x):
    """SwiGLU shared-experts MLP (AriaSharedExpertsMLP), through
    nn.core.dense so quantized decode trees dispatch to dense_q8 / dense_q4."""
    gate = F.silu(dense(params["gate_proj"], x))
    return dense(params["down_proj"], gate * dense(params["up_proj"], x))

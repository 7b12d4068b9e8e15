"""Ring attention: sequence-parallel exact attention over a mesh axis
(counterpart of spacer_tpu/ops/ring_attention.py).

The sequence is cut into n shards over the axis's ranks.  Each rank keeps
its queries and passes its keys, values and key mask around the ring: at
step i it holds the block of rank (index - i) mod n, attends to it with K1
(`flash_attention(..., return_lse=True)`) and merges the block's output
into its running output by their log-sum-exps.  Under `causal` a block
from a later rank is all future keys and is skipped, a block from an
earlier rank is all past keys and runs without the causal mask, and the
rank's own block runs causal.

The backward runs K1-bwd dq and dk/dv on each block with the MERGED
statistics (the LSE of all blocks and delta = rowsum(dout * out) of the
merged output; `flash_attention_bwd_*_from_stats`), not the block's own:
with them, P = exp(s * scale - lse) is the probability over the whole
sequence.  K/V go around the ring again, each block's dk/dv partial sums
(f32) travel with it and go home to their owner after the last step.  The
whole ring is one torch.autograd.Function on both devices: K1's own
autograd marks its LSE non-differentiable, so autograd through the block
calls would drop the merge weights' gradient on the card.

A row that sees no key in a block has LSE -1e30 there (K1's epilogue; the
plain version's logsumexp over -1e30 logits); the merge subtracts the
larger LSE before exp, so such a block weighs exactly 0 beside a live one.
A row that sees no key anywhere comes out as the attention over the whole
sequence gives it: the mean of V over every key of the sequence
(flash_attention.no_key_rows, xla_attention's value and JAX's), not the
merge of its blocks' means, with that mean's gradient 1 / S to each key's
dv (no_key_dv).  Such rows are pads, but a capacity MoE (moe_impl "ep")
routes them and counts them against its capacity, so live rows read them.

The per-step pieces (`block_forward`, `merge`, `block_backward`) are plain
functions on tensors with the communication outside them, so one process
can run them over emulated shards.  Every transfer goes through
parallel/multihost's counted records: "ring_p2p" (one batch of sends and
receives per rotation) and "ring_all_gather"; a group of one records its
gathers and issues nothing.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.ops import flash_attention as fa
from spacer_tpu_torch.parallel import multihost

NEG_INF = -1e30


def _visit(causal: bool, q_index: int, k_index: int):
    """None where the block is skipped (a causal future block), else
    whether it runs with the causal mask (the rank's own block)."""
    if causal and k_index > q_index:
        return None
    return causal and k_index == q_index


def block_forward(q, k, v, *, q_index: int, k_index: int, causal: bool,
                  kv_mask=None, scale=None):
    """One block of the ring: (out (B, Sq, H, D), lse (B, H, Sq) f32) of
    the queries of shard q_index against the keys of shard k_index (K1 on
    CUDA, the plain version on the CPU); None for a skipped block."""
    mode = _visit(causal, q_index, k_index)
    if mode is None:
        return None
    return fa.flash_attention(q, k, v, causal=mode, kv_mask=kv_mask,
                              scale=scale, return_lse=True)


def merge(out, lse, out_b, lse_b):
    """Merge a block's (out_b, lse_b) into the running (out f32, lse) ->
    (out f32, lse); out None starts the merge.  The larger LSE is
    subtracted before exp, so NEG_INF (the LSE of a row that saw no key)
    merges to weight 0 beside a live block and never to NaN; one block
    merges to itself exactly."""
    if out is None:
        return out_b.float(), lse_b
    m = torch.maximum(lse, lse_b)
    new = m + torch.log(torch.exp(lse - m) + torch.exp(lse_b - m))
    w = lambda x: torch.exp(x - new).transpose(1, 2)[..., None]  # noqa: E731
    return out * w(lse) + out_b.float() * w(lse_b), new


def block_backward(q, k, v, dout, lse, delta, *, q_index: int, k_index: int,
                   causal: bool, kv_mask=None, scale=None):
    """(dq, dk, dv) of one block under the merged `lse` and `delta` (K1-bwd
    dq and dk/dv from given statistics); None for a skipped block."""
    mode = _visit(causal, q_index, k_index)
    if mode is None:
        return None
    kw = dict(causal=mode, kv_mask=kv_mask, scale=scale)
    dq = fa.flash_attention_bwd_dq_from_stats(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv_from_stats(q, k, v, dout, lse, delta,
                                                   **kw)
    return dq, dk, dv


def delta_of(out, dout):
    """delta = rowsum(dout * out), (B, H, S) f32: the backward's second
    statistic, of the merged output."""
    return fa._delta(out, dout)


def _rotate(tensors, ring):
    """Send each tensor to the next rank of the ring and receive the
    previous rank's in its place -> the received tensors."""
    ranks, index, group = ring
    n = len(ranks)
    nxt, prev = ranks[(index + 1) % n], ranks[(index - 1) % n]
    tensors = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in tensors]
    multihost.p2p([(t, nxt) for t in tensors], [(g, prev) for g in got],
                  group, send_kind="ring_p2p")
    return got


class _Ring(torch.autograd.Function):
    """The ring over this rank's (B, S_loc, ...) shards; see the module
    docstring."""

    @staticmethod
    def forward(ctx, q, k, v, mask, ring, causal, scale):
        ranks, index, _ = ring
        n = len(ranks)
        out = lse = None
        kb, vb, mb = k, v, mask
        v_sum = 0.0
        for i in range(n):
            if i:
                kb, vb, *rest = _rotate([kb, vb] + ([mb] if mb is not None
                                                    else []), ring)
                mb = rest[0] if rest else None
            if n > 1:
                v_sum = v_sum + vb.float().sum(dim=1)
            blk = block_forward(q, kb, vb, q_index=index,
                                k_index=(index - i) % n, causal=causal,
                                kv_mask=mb, scale=scale)
            if blk is not None:
                out, lse = merge(out, lse, *blk)
        if n > 1 and mask is not None:
            # one shard's block is the whole sequence: its own value
            out = fa.no_key_rows(out, lse, v_sum / (n * k.shape[1]))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        ranks, index, _ = ring
        n = len(ranks)
        dout = dout.contiguous()
        delta = delta_of(out, dout)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb, mb = k, v, mask
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros_like(dkb)
        # the no-key rows' mean: their dout / S to every key of every block
        dead_dv = (None if mask is None
                   else fa.no_key_dv(dout, lse, k.shape[2], n * k.shape[1]))
        for i in range(n):
            if i:
                kb, vb, dkb, dvb, *rest = _rotate(
                    [kb, vb, dkb, dvb] + ([mb] if mb is not None else []),
                    ring)
                mb = rest[0] if rest else None
            if dead_dv is not None:
                dvb += dead_dv
            g = block_backward(q, kb, vb, dout, lse, delta, q_index=index,
                               k_index=(index - i) % n, causal=causal,
                               kv_mask=mb, scale=scale)
            if g is not None:
                dq += g[0].float()
                dkb += g[1].float()
                dvb += g[2].float()
        if n > 1:   # the held block's partial sums go home to their owner
            dkb, dvb = _rotate([dkb, dvb], ring)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None,
                None, None, None)


def ring_attention(q, k, v, *, group=None, causal: bool = False,
                   kv_mask=None, scale=None):
    """Per-rank body (JAX's ring_attention under shard_map): q (B, S_loc, H,
    D), k/v (B, S_loc, Hkv, D) and kv_mask (B, S_loc) are this rank's
    sequence shard, the shards in rank order over `group` (a
    torch.distributed process group; None: this process alone).
    Differentiable in q, k and v."""
    ranks, index = [0], 0
    if group is not None:
        import torch.distributed as dist

        ranks = dist.get_process_group_ranks(group)
        index = dist.get_rank(group)
    return _body(q, k, v, (ranks, index, group), causal, kv_mask, scale)


def _body(q, k, v, ring, causal, kv_mask, scale):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = None
    if kv_mask is not None:
        # bool travels as its bytes (NCCL has no bool)
        mask = kv_mask.reshape(q.shape[0], -1).to(torch.uint8).contiguous()
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                       ring, bool(causal), float(scale))


def _all_gather_seq(x, mesh, axis):
    """The axis's shards of x concatenated along dim 1 (the sequence)."""
    n = mesh.shape[axis]
    if n == 1:
        multihost.record("ring_all_gather", x)
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    multihost.all_gather_into(out, x, mesh.group(axis),
                              kind="ring_all_gather")
    out = out.view(n, *x.shape).transpose(0, 1)
    return out.reshape(x.shape[0], n * x.shape[1], *x.shape[2:])


class _Slice(torch.autograd.Function):
    """This rank's sequence shard; backward: the shards' gradients
    all-gathered (every rank's gradient of the whole tensor)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        n, i = mesh.shape[axis], mesh.coords[axis]
        s = x.shape[1] // n
        return x[:, i * s:(i + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_seq(grad, ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    """The shards all-gathered along the sequence; backward: this rank's
    shard of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.s = mesh, axis, x.shape[1]
        return _all_gather_seq(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        i, s = ctx.mesh.coords[ctx.axis], ctx.s
        return grad[:, i * s:(i + 1) * s], None, None


def make_ring_attention(mesh, axis: str, *, causal: bool = False):
    """Ring attention over `axis` of `mesh` (parallel/mesh.py) -> fn(q, k,
    v, kv_mask=None, scale=None) on GLOBAL (B, S, H, D) tensors, the same
    on every rank of the axis, returning the global output: each rank
    slices its shard of the sequence (S must divide by the axis size), runs
    the ring and all-gathers the output.  The backward hands every rank the
    whole gradient of q, k and v."""
    n = mesh.shape[axis]
    ring = (mesh.peers(axis), mesh.coords[axis],
            mesh.group(axis) if n > 1 else None)

    def fn(q, k, v, kv_mask=None, scale=None):
        if q.shape[1] % n:
            raise ValueError(f"sequence {q.shape[1]} does not divide over "
                             f"{n} ranks of {axis!r}")
        multihost.warm_p2p(mesh, axis)
        s, i = q.shape[1] // n, mesh.coords[axis]
        ql, kl, vl = (_Slice.apply(t, mesh, axis) for t in (q, k, v))
        ml = None if kv_mask is None else kv_mask[:, i * s:(i + 1) * s]
        out = _body(ql, kl, vl, ring, causal, ml, scale)
        return _Gather.apply(out, mesh, axis)

    return fn

"""Pipeline parallelism (GPipe) for the LM decoder stack (counterpart of
spacer_tpu/parallel/pipeline.py).

The decoder layers are cut over the mesh's `pipe` axis (parallel/mesh.py):
stage s of S keeps layers [s L/S, (s + 1) L/S) of the per-layer list
(`shard_layers_for_pipeline`); the embedding, final norm and head stay
whole on every stage.  `pipeline_lm_forward` runs JAX's GPipe schedule of
M + S - 1 ticks over M microbatches: at tick t stage s runs microbatch
t - s through its layers (stage 0 takes it fresh from the input) and hands
the result to stage s + 1; a tick where t - s is outside [0, M) is a bubble
and does no work (JAX's one SPMD program computes it and masks it out).
The last stage's outputs are broadcast over the pipe group, so every stage
returns the final hidden state (JAX's psum), and the head runs on each.

The schedule is one torch.autograd.Function per stage.  Its forward
records each tick's graph (the layers under torch.utils.checkpoint as
`remat` says, the lm_forward modes); its backward walks the ticks in
reverse: the gradient of the last stage's outputs is its rows of the
(replicated) output gradient, every other stage receives its outputs'
gradient from the next stage and sends its inputs' to the previous one.
Each tick's transfers, forward and back, are one dist.batch_isend_irecv
with both neighbours (NCCL deadlocks on unpaired blocking P2P), counted
as "pp_send" / "pp_recv".  Stage 0 alone holds the gradient of the input
embeddings; the backward sums it over the pipe group ("pp_all_reduce"),
so the embedding and the vision tower upstream get one gradient on every
stage, as do the final norm and head, which every stage computes alike.

`batch_axis="data"` composes the pipeline with data parallelism: each
(pipe, data) rank runs its rows of every microbatch, the output is
all-gathered over data ("pp_all_gather") into the global batch, and the
backward sums the layer gradients and the input gradient over data.  The
pipe composes with data only (mesh.py refuses fsdp or tp > 1 beside it).

The MoE under moe_impl "ep" (Aria) runs as JAX's stage body runs it: each
call takes its capacity over the tokens it is given, this (pipe, data)
rank's rows of one microbatch (JAX's P(None, batch_axis) slice of the
(M, mb, ...) microbatches), with the experts whole on every stage (the
params are unsharded), so no enclosing parallel/expert.rows layout is
read.  A recomputed layer (remat, the backward) sees the same tokens and
drops the same assignments.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from spacer_tpu_torch.parallel import multihost


def pipeline_param_spec(axis: str = "pipe") -> tuple:
    """Spec of the decoder-layer list: cut over the pipe axis (the partition
    specs' tuple form of JAX's P(axis))."""
    return (axis,)


def stage_layers(num_layers: int, mesh, axis: str = "pipe") -> range:
    """The global indices of the layers this rank's stage holds."""
    S = mesh.shape[axis]
    if num_layers % S:
        raise ValueError(f"{num_layers} layers not divisible into {S} "
                         "stages")
    per = num_layers // S
    return range(mesh.coords[axis] * per, (mesh.coords[axis] + 1) * per)


def shard_layers_for_pipeline(params, mesh, axis: str = "pipe"):
    """The LM param dict -> this stage's: `layers` cut to the stage's
    layers (stage_layers), every other entry as it is (replicated).  The
    tensors are shared with `params`, not copied."""
    out = dict(params)
    out["layers"] = [params["layers"][i]
                     for i in stage_layers(len(params["layers"]), mesh,
                                           axis)]
    return out


def is_layer_leaf(name: str) -> bool:
    """Whether a train.step.param_leaves path is a decoder layer's (a
    stage's own) rather than a replicated tensor."""
    return name.split("/")[:2] == ["model", "layers"]


class _Plan:
    """The static schedule of one pipeline_lm_forward call on this rank."""

    def __init__(self, mesh, axis, batch_axis, M, B, layers, run_layer):
        self.mesh, self.axis, self.batch_axis = mesh, axis, batch_axis
        self.S, self.s = mesh.shape[axis], mesh.coords[axis]
        self.M, self.mb = M, B // M
        self.Dn = mesh.shape[batch_axis] if batch_axis else 1
        self.d = mesh.coords[batch_axis] if batch_axis else 0
        if self.mb % self.Dn:
            raise ValueError(f"microbatch of {self.mb} rows does not divide "
                             f"over {self.Dn} ranks of {batch_axis!r}")
        self.rows = self.mb // self.Dn
        peers = mesh.peers(axis)
        self.prev = peers[self.s - 1] if self.s > 0 else None
        self.next = peers[self.s + 1] if self.s < self.S - 1 else None
        self.last = peers[-1]
        self.layers, self.run_layer = layers, run_layer

    def active(self, stage: int, t: int) -> bool:
        return 0 <= t - stage < self.M

    def lo(self, m: int) -> int:
        """First global row of this rank's share of microbatch m."""
        return m * self.mb + self.d * self.rows

    def stage(self, x, m: int):
        """This stage's layers on microbatch m's rows x."""
        for j, lp in enumerate(self.layers):
            x = self.run_layer(x, lp, j, self.lo(m), self.rows)
        return x

    def reduce(self, x, name: str):
        """Sum x over this rank's `name` group, in place (recorded only
        for a group of one)."""
        if self.mesh.shape[name] == 1:
            multihost.record("pp_all_reduce", x)
            return x
        return multihost.all_reduce(x, self.mesh.group(name),
                                    kind="pp_all_reduce")


def _exchange(plan, t, send, recv_like, backward=False):
    """Tick t's transfers -> the received tensor or None.  Forward: `send`
    (this stage's output) to the next stage, and the previous stage's
    output received when that stage ran at tick t.  Backward: `send` (the
    gradient of the input this stage received at tick t) to the previous
    stage, and the gradient of this stage's tick-t output received from
    the next stage when this stage sent one."""
    to, frm = (plan.prev, plan.next) if backward else (plan.next, plan.prev)
    sender = plan.s if backward else plan.s - 1
    got = None
    if frm is not None and plan.active(sender, t):
        got = torch.empty_like(recv_like)
    sends = [(send, to)] if send is not None else []
    recvs = [(got, frm)] if got is not None else []
    if sends or recvs:
        multihost.p2p(sends, recvs, plan.mesh.group(plan.axis),
                      send_kind="pp_send", recv_kind="pp_recv")
    return got


def _gather_rows(h, plan):
    """(M, rows, ...) of this data rank -> the global (B, ...) batch."""
    if not plan.batch_axis or plan.Dn == 1:
        if plan.batch_axis:
            multihost.record("pp_all_gather", h)
        return h.reshape(plan.M * plan.rows, *h.shape[2:])
    out = torch.empty((plan.Dn * h.shape[0], *h.shape[1:]), dtype=h.dtype,
                      device=h.device)
    multihost.all_gather_into(out, h.contiguous(),
                              plan.mesh.group(plan.batch_axis),
                              kind="pp_all_gather")
    # (Dn, M, rows) -> (M, Dn, rows): microbatch-major global rows
    out = out.view(plan.Dn, *h.shape).transpose(0, 1)
    return out.reshape(plan.M * plan.mb, *h.shape[2:])


class _GPipe(torch.autograd.Function):
    """The whole schedule on this stage: x (B, T, D), the stage's layer
    tensors -> the final hidden state (B, T, D) on every stage."""

    @staticmethod
    def forward(ctx, plan, x, *leaves):
        grad = any(ctx.needs_input_grad[1:])
        S, s, M = plan.S, plan.s, plan.M
        like = x.new_empty((plan.rows, *x.shape[1:]))
        ticks, outs, state = {}, [], None
        for t in range(M + S - 1):
            y = None
            if plan.active(s, t):
                m = t - s
                inp = (x[plan.lo(m):plan.lo(m) + plan.rows] if s == 0
                       else state)
                inp = inp.detach().requires_grad_(grad)
                with torch.set_grad_enabled(grad):
                    y = plan.stage(inp, m)
                if grad:
                    ticks[t] = (inp, y)
                if s == S - 1:
                    outs.append(y.detach())
            state = _exchange(plan, t, None if y is None or plan.next is None
                              else y.detach().contiguous(), like)
        h = (torch.stack(outs) if s == S - 1
             else x.new_empty((M, plan.rows, *x.shape[1:])))
        if S == 1:
            multihost.record("pp_broadcast", h)
        else:
            multihost.broadcast(h, plan.last, plan.mesh.group(plan.axis),
                                kind="pp_broadcast")
        ctx.plan, ctx.ticks = plan, ticks
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return _gather_rows(h, plan)

    @staticmethod
    def backward(ctx, dh):
        plan, ticks = ctx.plan, ctx.ticks
        S, s, M = plan.S, plan.s, plan.M
        leaves = [lf for lp in plan.layers for lf in _tensors(lp)]
        wanted = [lf for lf in leaves if lf.requires_grad]
        shape, dtype, device = ctx.x_meta
        dx = torch.zeros(shape, dtype=dtype, device=device)
        like = torch.empty((plan.rows, *shape[1:]), dtype=dtype,
                           device=device)
        # the layers' gradients accumulate over the microbatches in their
        # .grad, in their own dtype (as JAX's scan sums cotangents), one
        # copy at a time; the leaves' own .grad is put back afterwards
        saved = [lf.grad for lf in wanted]
        for lf in wanted:
            lf.grad = None
        try:
            d_in = None   # gradient of the input of tick t + 1's microbatch
            for t in reversed(range(M + S - 1)):
                # the reverse of tick t's exchange: this stage's input
                # gradient of tick t + 1 goes back, its output gradient of
                # tick t comes in
                dy = _exchange(plan, t, d_in, like, backward=True)
                d_in = None
                if not plan.active(s, t):
                    continue
                m = t - s
                if s == S - 1:
                    dy = dh[plan.lo(m):plan.lo(m) + plan.rows]
                inp, y = ticks.pop(t)
                torch.autograd.backward(y, dy.contiguous(),
                                        inputs=[inp] + wanted)
                if s == 0:
                    dx[plan.lo(m):plan.lo(m) + plan.rows] = inp.grad
                else:
                    d_in = inp.grad.contiguous()
                del inp, y
            grads = {id(lf): lf.grad for lf in wanted}
        finally:
            for lf, g in zip(wanted, saved):
                lf.grad = g
        # stage 0 alone holds the input gradient: sum it over the stages,
        # then (disjoint rows) over data; the layers' over data
        plan.reduce(dx, plan.axis)
        if plan.batch_axis:
            plan.reduce(dx, plan.batch_axis)
            _reduce_over(grads, plan)
        return (None, dx, *(grads.get(id(lf)) for lf in leaves))


def _reduce_over(grads: dict, plan):
    """Sum the layers' gradients over the data group, one flat all-reduce
    per dtype (recorded only for a group of one)."""
    live = {k: g for k, g in grads.items() if g is not None}
    if plan.Dn == 1:
        multihost.record_bytes("pp_all_reduce", sum(
            g.numel() * g.element_size() for g in live.values()))
        return
    for dt in {g.dtype for g in live.values()}:
        keys = [k for k, g in live.items() if g.dtype == dt]
        flat = torch.cat([live[k].reshape(-1) for k in keys])
        plan.reduce(flat, plan.batch_axis)
        off = 0
        for k in keys:
            n = live[k].numel()
            grads[k] = flat[off:off + n].view_as(live[k])
            off += n


def global_norm(grads, names, mesh, axis: str = "pipe") -> torch.Tensor:
    """sqrt(sum of squares) of a pipelined model's gradients (names: their
    train.step.param_leaves paths), accumulated in f32: the layer tensors'
    sums over the stages, each replicated tensor (the same on every stage)
    counted once."""
    sq = torch.stack([g.float().square().sum() for g in grads])
    layer = torch.tensor([is_layer_leaf(n) for n in names], device=sq.device)
    part = torch.where(layer, sq, torch.zeros_like(sq))
    if mesh.shape[axis] == 1:
        multihost.record("pp_all_reduce", part)
    else:
        multihost.all_reduce(part, mesh.group(axis), kind="pp_all_reduce")
    sq = torch.where(layer, part, sq)
    return torch.sqrt(sum(sq.unbind()))


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


def pipeline_lm_forward(params, cfg, mesh, *, axis: str = "pipe",
                        num_microbatches: int, input_ids=None,
                        input_embeds=None, position_ids=None, kv_mask=None,
                        causal: bool = True, remat=True, logits: bool = True,
                        batch_axis: str | None = None):
    """Full-sequence LM forward with the decoder stack pipelined over
    `mesh.shape[axis]` stages -> logits (B, T, V), or the final-norm hidden
    states with logits=False, on every stage; the numerics of lm_forward.

    `params` is this stage's LM dict (shard_layers_for_pipeline).  B must
    divide into num_microbatches and cfg.num_layers into the stages
    (ValueError).  `remat` takes lm_forward's modes (check_remat).  With
    `batch_axis` each (pipe, batch_axis) rank runs its rows of every
    microbatch and the result is the global batch.  `causal=False` runs
    every stage's layers with bidirectional attention (lm_forward's)."""
    from spacer_tpu_torch.models.qwen25_vl.language import (
        _checkpoint_kwargs,
        _layer,
        _layer_remat,
        check_remat,
        lm_head,
    )
    from spacer_tpu_torch.nn.core import embed, rms_norm
    from spacer_tpu_torch.nn.rope import mrope_cos_sin, rope_inv_freq

    from spacer_tpu_torch.parallel.fsdp import has_shards

    remat = check_remat(remat)
    if has_shards(params):
        raise ValueError("the pipeline takes unsharded params "
                         "(shard_layers_for_pipeline, not shard_params)")
    if input_embeds is None:
        input_embeds = embed(params["embed_tokens"], input_ids)
    B, T, _ = input_embeds.shape
    M, L = num_microbatches, cfg.num_layers
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    span = stage_layers(L, mesh, axis)
    if len(params["layers"]) != len(span):
        raise ValueError(f"stage holds {len(params['layers'])} layers, "
                         f"expected {len(span)} of {L} "
                         "(shard_layers_for_pipeline)")
    dev = input_embeds.device
    if position_ids is None:
        position_ids = torch.arange(T, device=dev)[None, None].expand(3, B, T)
    if kv_mask is None:
        kv_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=dev)
    cos, sin = mrope_cos_sin(position_ids, inv_freq, cfg.mrope_section)

    def run_layer(h, lp, j, lo, rows):
        kw = dict(cfg=cfg, cos=cos[lo:lo + rows], sin=sin[lo:lo + rows],
                  kv_mask=kv_mask[lo:lo + rows], cache_index=0,
                  causal=causal)
        if remat and torch.is_grad_enabled():
            mode = _layer_remat(remat, span[j])
            return checkpoint(lambda x: _layer(x, lp, None, **kw)[0], h,
                              use_reentrant=False,
                              **_checkpoint_kwargs(mode, cfg))
        return _layer(h, lp, None, **kw)[0]

    multihost.warm_p2p(mesh, axis)
    plan = _Plan(mesh, axis, batch_axis, M, B, params["layers"], run_layer)
    h = _GPipe.apply(plan, input_embeds, *_tensors(params["layers"]))
    h = rms_norm(params["norm"], h, cfg.rms_norm_eps)
    if not logits:
        return h
    return lm_head(params, cfg, h)

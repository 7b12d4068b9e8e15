"""GRPO and SFT train steps (counterpart of spacer_tpu/train/step.py).

One GRPO step: vision encode (once per prompt) -> policy logps over the
completion tokens (shared-prefix schema, chunked head) -> k3 KL against the
reference logps + GRPO loss -> gradients -> AdamW update.  One SFT step
(`make_sft_train_step`): next-token cross-entropy over the labels that are
not -100.  JAX's stop_gradient points are torch.no_grad / detach here; its
jit is eager PyTorch.  Rewards and advantages arrive from the host.

Params are nested dicts/lists of tensors (spacer_tpu_torch's layout).  The
steps flatten them in a fixed order (`param_leaves`), take gradients with
torch.autograd.grad (nothing is left in .grad), and update the params IN
PLACE through `tx.apply` (train/optimizer.py: `p.add_(u.to(p.dtype))`, JAX's
`p + u.astype(p.dtype)`, one moment group at a time, each group's grads
dropped once applied).  Gradient accumulation is the optimizer's
(`MultiSteps`, as the JAX trainer's optax.MultiSteps), not a step of its
own.  Not ported: `step_accum` and `grad_chunk` / `apply_grads` (the
bench's one-program and chunked accumulation, which no trainer calls).

`make_grpo_train_step` takes JAX's two batch schemas, dispatched on
"prompt_ids" in the batch: the shared-prefix one (the trainers') and the
packed (input_ids / kv_mask) one (`_completion_logps`).  Both builders take
JAX's `attn_impl=("ring", mesh, axis)` (sequence-parallel ring attention,
ops/ring_attention.py, wherever self-attention has Sq == Skv: the packed
rows, the shared-prefix prompt pass; and the Qwen ViTs' full-attention
blocks over equal frame chunks, models/qwen25_vl/vision.py) and
`pipeline=(mesh, M)` (the decoder
stack pipelined over the mesh's pipe axis in M microbatches,
parallel/pipeline.py; packed schema only).  Each runs the whole batch on
every rank of its mesh, so the loss and the replicated gradients come out
whole on every rank; under the pipeline each stage's layer gradients are
its own layers' (summed over data), and the global norm sums those over
the stages and counts each replicated tensor once.  Neither composes with
the `mesh` below (ValueError).

With a device mesh (parallel/mesh.py) the params may hold fsdp Shards
(parallel/fsdp.py, gathered layer by layer where they are used) and the
step takes the GLOBAL batch on every rank: each rank runs its rows of it
(parallel/partition.row_range over data x fsdp; the prompt rows a rank's
completion rows need when the prompts do not divide), weights its local
mean by its share of the global rows or tokens, and the summed gradients
are the single-process ones.  The vision tower encodes the whole batch's
media on every rank (JAX replicates the packed pixels) and each rank
merges them into the whole prompt batch before keeping its rows.  Under
tensor parallelism the rows split over data x fsdp only (a tp group runs
the same rows), and the logps are vocab-parallel on the rank's head
columns (train/grpo.chunked_per_token_logps).  The MoE is told every
rank's rows (parallel/expert.rows): the completion rows as row_range
splits them, and the prompt rows they belong to.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.models.qwen25_vl.language import check_remat, lm_forward
from spacer_tpu_torch.models.registry import family_for_config
from spacer_tpu_torch.nn.attention import ring_impl
from spacer_tpu_torch.nn.core import embed
from spacer_tpu_torch.parallel import expert, fsdp, tp
from spacer_tpu_torch.parallel import pipeline as pp
from spacer_tpu_torch.parallel.partition import row_range
from spacer_tpu_torch.parallel.pipeline import pipeline_lm_forward
from spacer_tpu_torch.train.grpo import chunked_per_token_logps, grpo_loss
from spacer_tpu_torch.train.optimizer import global_norm


def param_leaves(tree, prefix: str = ""):
    """[(path, tensor)] of a nested dict/list params tree, in a fixed order
    (an fsdp Shard contributes its blocks, the tensor the optimizer
    updates)."""
    if isinstance(tree, fsdp.Shard):
        return [(prefix[:-1], tree.data)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in param_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in param_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _track(params, select=None):
    """Leaves in param_leaves order, with requires_grad set on those that
    get a gradient (all, or those whose path `select` accepts)."""
    named = param_leaves(params)
    want = [select is None or bool(select(n)) for n, _ in named]
    for (_, t), w in zip(named, want):
        t.requires_grad_(w)
    return [t for _, t in named], want


def _grads(loss, leaves, want):
    """d loss / d leaves where wanted (zeros where the loss does not reach
    a tensor, as jax.grad gives), None elsewhere."""
    got = iter(torch.autograd.grad(
        loss, [t for t, w in zip(leaves, want) if w], allow_unused=True))
    out = []
    for t, w in zip(leaves, want):
        g = next(got) if w else None
        out.append(torch.zeros_like(t) if w and g is None else g)
    return out


def _head_kernel(params_model, text_cfg):
    """The (D, V) head, or under tensor parallelism this rank's (D, V / tp)
    vocabulary columns."""
    params_model = fsdp.gather(params_model, keep=("layers",))
    V = text_cfg.vocab_size
    if text_cfg.tie_word_embeddings:
        return tp.local(params_model["embed_tokens"]["embedding"], 0, V).T
    return tp.local(params_model["lm_head"]["kernel"], -1, V)


def tile_vision_embeds(ve, cfg, grid_thw, num_generations: int,
                       grids_per_prompt=None):
    """Broadcast per-prompt vision embeddings across each prompt's G
    completions, preserving group-major row order [p0*G, p1*G, ...] (the
    packed oracle's vision input; the train step encodes once per prompt)."""
    if grids_per_prompt is None or len(grids_per_prompt) <= 1:
        return ve.repeat(num_generations, 1)
    mu = cfg.vision.spatial_merge_unit
    counts = [t * h * w // mu for (t, h, w) in grid_thw]
    parts, off, i = [], 0, 0
    for ng in grids_per_prompt:
        n = sum(counts[i:i + ng])
        i += ng
        parts.append(ve[off:off + n].repeat(num_generations, 1))
        off += n
    return torch.cat(parts, dim=0)


def _completion_logps(params, cfg, input_ids, position_ids, kv_mask,
                      prompt_len: int, vision_embeds=None, remat=False,
                      logp_chunk: int = 256, merge_fn=None, attn_impl=None,
                      pipeline=None):
    """Per-token logps of the completion part of packed (N, P+C) rows (the
    packed schema's, and the numerics oracle of the shared-prefix path).
    `pipeline` = (mesh, M) runs the decoder stack pipelined
    (parallel/pipeline.py), its rows over the mesh's data axis."""
    from spacer_tpu_torch.models.qwen25_vl.model import merge_vision_embeds

    merge_fn = merge_fn or merge_vision_embeds
    token_embeds = embed(params["model"]["embed_tokens"], input_ids)
    if vision_embeds is not None:
        token_embeds = merge_fn(cfg, input_ids, token_embeds, vision_embeds)
    if pipeline is not None:
        pp_mesh, n_micro = pipeline
        hidden = pipeline_lm_forward(
            params["model"], cfg.text, pp_mesh, num_microbatches=n_micro,
            input_embeds=token_embeds, position_ids=position_ids,
            kv_mask=kv_mask, remat=remat, logits=False, batch_axis="data")
    else:
        hidden, _ = lm_forward(params["model"], cfg.text,
                               input_embeds=token_embeds,
                               position_ids=position_ids, kv_mask=kv_mask,
                               logits=False, remat=remat, attn_impl=attn_impl)
    # position i predicts token i+1; completion tokens are ids[:, P:]
    h = hidden[:, prompt_len - 1:-1]
    targets = input_ids[:, prompt_len:]
    head = _head_kernel(params["model"], cfg.text)
    return chunked_per_token_logps(h, head, targets, chunk=logp_chunk)


def _packed_logps(params, cfg, batch, vision_embeds, grid_thw,
                 num_generations: int, *, remat=False, logp_chunk: int = 256,
                 attn_impl=None, pipeline=None):
    """The packed schema's logps (make_grpo_train_step's and the LoRA
    step's): the per-prompt vision embeddings tiled over each prompt's
    num_generations rows, then _completion_logps with the prompt length
    read off the batch (input_ids' width less completion_mask's)."""
    family = family_for_config(cfg)
    if vision_embeds is not None:
        vision_embeds = family.tile_vision_embeds(vision_embeds, cfg,
                                                  grid_thw, num_generations)
    ids = batch["input_ids"]
    return _completion_logps(
        params, cfg, ids, batch["position_ids"], batch["kv_mask"],
        ids.shape[1] - batch["completion_mask"].shape[1],
        vision_embeds=vision_embeds, remat=remat, logp_chunk=logp_chunk,
        merge_fn=family.merge_vision_embeds, attn_impl=attn_impl,
        pipeline=pipeline)


def _rows(x, lo: int, hi: int, dim: int = 0):
    """Rows [lo, hi) of dim `dim`; the tensor itself for all of them."""
    if (lo, hi) == (0, x.shape[dim]):
        return x
    return x.narrow(dim, lo, hi - lo)


def _completion_logps_shared(params, cfg, prompt_ids, prompt_position_ids,
                             prompt_mask, completion_ids,
                             completion_position_ids, completion_mask,
                             num_generations: int, vision_embeds=None,
                             remat=False, logp_chunk: int = 256,
                             merge_fn=None, rows=None, layout=None,
                             attn_impl=None):
    """Shared-prefix per-token completion logps: the prompt forward runs
    once per group (B rows) and its per-layer K/V, repeated G times, is the
    prefix of the G completion rows' attention.  The repeat's backward sums
    the G rows' gradients (jnp.repeat's VJP), so logps AND gradients equal
    the packed full forward's up to summation order.

    prompt_ids (B, P) left-padded; completion_ids (B*G, C) group-major;
    completion_mask doubles as the completion part of the attention mask.
    `rows` = (c_lo, c_hi) computes completion rows [c_lo, c_hi) only,
    running the prompt rows they belong to (the vision embeddings are
    merged into the whole prompt batch first); None is all rows.  `layout`
    (parallel/expert.RowLayout) lays out every rank's completion rows for
    the MoE, and its prompt rows follow.  `attn_impl` reaches both passes
    (the ring applies to the prompt pass, where Sq == Skv)."""
    from spacer_tpu_torch.models.qwen25_vl.model import merge_vision_embeds

    merge_fn = merge_fn or merge_vision_embeds
    G = num_generations
    tc = cfg.text
    model = fsdp.gather(params["model"], keep=("layers",))
    B = prompt_ids.shape[0]
    c_lo, c_hi = rows if rows is not None else (0, B * G)
    p_lo, p_hi = c_lo // G, -(-c_hi // G)
    prompt_embeds = embed(model["embed_tokens"], prompt_ids)
    if vision_embeds is not None:
        prompt_embeds = merge_fn(cfg, prompt_ids, prompt_embeds, vision_embeds)
    prompt_embeds = _rows(prompt_embeds, p_lo, p_hi)
    prompt_position_ids = _rows(prompt_position_ids, p_lo, p_hi, dim=1)
    prompt_mask = _rows(prompt_mask, p_lo, p_hi).bool()
    completion_ids = _rows(completion_ids, c_lo, c_hi)
    completion_position_ids = _rows(completion_position_ids, c_lo, c_hi,
                                    dim=1)
    completion_mask = _rows(completion_mask, c_lo, c_hi)
    off, n = c_lo - p_lo * G, c_hi - c_lo

    def expand(x):
        # prompt rows -> the rows of their completions [c_lo, c_hi); an
        # expand (whose backward sums the G rows: jnp.repeat's VJP, the
        # same bits on every run) rather than repeat_interleave (an
        # index_select, whose backward adds the G rows atomically on CUDA)
        rep = x[:, None].expand(x.shape[0], G, *x.shape[1:])
        return _rows(rep.reshape(x.shape[0] * G, *x.shape[1:]), off, off + n)

    with expert.rows(layout and expert.group_layout(layout, G)):
        hp, prompt_kv = lm_forward(
            model, tc, input_embeds=prompt_embeds,
            position_ids=prompt_position_ids, kv_mask=prompt_mask,
            logits=False, remat=remat, return_kv=True, attn_impl=attn_impl)
    prefix_kv = [(expand(k), expand(v)) for k, v in prompt_kv]
    kv_mask = torch.cat([expand(prompt_mask), completion_mask.bool()], dim=1)
    comp_embeds = embed(model["embed_tokens"], completion_ids)
    with expert.rows(layout):
        hc, _ = lm_forward(model, tc, input_embeds=comp_embeds,
                           position_ids=completion_position_ids,
                           kv_mask=kv_mask, logits=False, remat=remat,
                           prefix_kv=prefix_kv, attn_impl=attn_impl)
    # position P-1 (shared across the group) predicts completion token 0;
    # completion position i predicts token i+1
    h = torch.cat([expand(hp[:, -1:]), hc[:, :-1]], dim=1)
    head = _head_kernel(model, tc)
    return chunked_per_token_logps(h, head, completion_ids, chunk=logp_chunk)


def _check_parallel(mesh, attn_impl, pipeline):
    """attn_impl and pipeline run the whole batch on every rank of their
    own mesh: neither composes with the row-splitting `mesh`."""
    ring_impl(attn_impl)
    if mesh is not None and (pipeline is not None
                             or ring_impl(attn_impl) is not None):
        raise ValueError("the ring attn_impl and the pipeline run on their "
                         "own mesh: pass mesh=None")
    if pipeline is not None and ring_impl(attn_impl) is not None:
        raise ValueError("the pipeline's stages run K1 (JAX's attn_impl is "
                         "None there)")


def make_grpo_train_step(cfg, tx, *, beta: float = 0.04, remat=True,
                         logp_chunk: int = 256, mesh=None, attn_impl=None,
                         pipeline=None, encode_vision_in_step: bool = True):
    """Returns step(params, ref_params, opt_state, batch, grid_thw,
    num_generations) -> (params, opt_state, metrics), with `.ref_logps_fn`
    and `.loss_and_grads` attached.

    Two batch schemas, tensors on the params' device, dispatched on
    "prompt_ids" in the batch as JAX's are.  Shared-prefix: prompt_ids
    (B, P), prompt_mask, prompt_position_ids (3, B, P), completion_ids
    (B*G, C), completion_position_ids (3, B*G, C), completion_mask
    (B*G, C), advantages (B*G,), pixel_values.  Packed: input_ids
    (N, P+C) (the left-padded prompt, then the completion), kv_mask
    (N, P+C), position_ids (3, N, P+C), completion_mask (N, C), advantages
    (N,) and the vision inputs of one prompt, tiled over its
    num_generations rows; P is input_ids' width less completion_mask's.
    With a `mesh` the batch is the global one and the logps, ref logps and
    gradients are this rank's (see the module docstring); the loss and
    the metrics are global.  `attn_impl` ("ring", mesh, axis) and
    `pipeline` (mesh, M, packed schema only) as in the module docstring;
    with `pipeline` the params' LM is the stage's
    (parallel.pipeline.shard_layers_for_pipeline).  With
    `encode_vision_in_step=False` a batch's vision inputs are not encoded
    (nor merged) in the step, in either schema, as JAX's flag does."""
    remat = check_remat(remat)
    family = family_for_config(cfg)
    _check_parallel(mesh, attn_impl, pipeline)

    def _local(batch):
        if mesh is None:
            return None
        return row_range(batch["completion_ids"].shape[0], mesh)

    def _logps(params, batch, grid_thw, num_generations):
        vk = {k: batch[k] for k in family.vision_batch_keys if k in batch}
        ve = None
        if vk and encode_vision_in_step:
            ve = family.encode_vision(params, cfg, vk, grid_thw, remat=remat,
                                      attn_impl=attn_impl)
        if "prompt_ids" not in batch:
            if mesh is not None:
                raise ValueError("the packed schema runs without a mesh "
                                 "(or over the ring's / pipeline's own)")
            return _packed_logps(params, cfg, batch, ve, grid_thw,
                                num_generations, remat=remat,
                                logp_chunk=logp_chunk, attn_impl=attn_impl,
                                pipeline=pipeline)
        if pipeline is not None:
            raise ValueError("pipeline parallelism uses the packed "
                             "(input_ids / kv_mask) schema, like JAX's")
        return _completion_logps_shared(
            params, cfg, batch["prompt_ids"], batch["prompt_position_ids"],
            batch["prompt_mask"], batch["completion_ids"],
            batch["completion_position_ids"], batch["completion_mask"],
            num_generations, vision_embeds=ve, remat=remat,
            logp_chunk=logp_chunk, merge_fn=family.merge_vision_embeds,
            rows=_local(batch),
            layout=expert.batch_layout(batch["completion_ids"].shape[0],
                                       mesh), attn_impl=attn_impl)

    def ref_logps_fn(ref_params, batch, grid_thw=None, num_generations=1):
        """Reference logps (no gradient) of this rank's rows; None at
        beta == 0 (no reference model, TRL GRPOConfig beta=0 semantics)."""
        if beta == 0.0:
            return None
        with torch.no_grad():
            return _logps(ref_params, batch, grid_thw, num_generations)

    def loss_and_grads(params, ref_logps, batch, grid_thw=None,
                       num_generations=1, select=None):
        """-> (loss, metrics, grads) with grads in param_leaves order (a
        parameter the loss does not reach gets zeros, as jax.grad gives).
        `select`, a predicate on param paths, limits the gradients to those
        tensors (the others get None), for checks that cannot hold two
        full gradient sets.  With a mesh the grads are this rank's blocks
        of the summed gradients (replicated leaves: the whole sum)."""
        rows = _local(batch) if "prompt_ids" in batch else None
        lo, hi = rows if rows is not None else (0, None)
        with torch.enable_grad():
            leaves, want = _track(params, select)
            logps = _logps(params, batch, grid_thw, num_generations)
            loss, metrics = grpo_loss(
                logps, ref_logps, batch["advantages"][lo:hi],
                batch["completion_mask"][lo:hi], beta=beta)
            if mesh is not None:
                share = fsdp.global_share(hi - lo, loss.device, mesh)
                loss = loss * share
                metrics = {k: fsdp.global_sum(v * share, mesh)
                           for k, v in metrics.items()}
            grads = _grads(loss, leaves, want)
        if mesh is not None:
            fsdp.reduce_replicated(grads, fsdp.raw_leaves(params), mesh)
            loss = fsdp.global_sum(loss, mesh)
        return loss.detach(), metrics, grads

    def step(params, ref_params, opt_state, batch, grid_thw=None,
             num_generations: int = 1):
        if beta == 0.0:
            ref_logps = None
        elif "ref_logps" in batch:
            ref_logps = batch["ref_logps"].detach()
        else:
            ref_logps = ref_logps_fn(ref_params, batch, grid_thw,
                                     num_generations)
        loss, metrics, grads = loss_and_grads(
            params, ref_logps, {k: v for k, v in batch.items()
                                if k != "ref_logps"},
            grid_thw, num_generations)
        leaves = [t for _, t in param_leaves(params)]
        norm = _norm_fn(params, mesh, pipeline)
        gnorm = norm(grads)
        # in place, a moment group at a time; the list's grads are dropped
        opt_state = tx.apply(grads, opt_state, leaves, gnorm=gnorm, norm=norm)
        del grads
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    step.ref_logps_fn = ref_logps_fn
    step.loss_and_grads = loss_and_grads
    return step


def _norm_fn(params, mesh, pipeline=None):
    """The gradients' global norm: over fsdp shards with a mesh, over the
    stages' layers with a pipeline."""
    if pipeline is not None:
        names = [n for n, _ in param_leaves(params)]
        return lambda grads: pp.global_norm(grads, names, pipeline[0])
    if mesh is None:
        return global_norm
    raw = fsdp.raw_leaves(params)
    return lambda grads: fsdp.global_norm(grads, raw, mesh)


def make_sft_train_step(cfg, tx, *, remat=True, logp_chunk: int = 256,
                        mesh=None, attn_impl=None, pipeline=None):
    """SFT step (sft.py semantics; spacer_tpu's make_sft_train_step):
    next-token cross-entropy with labels = input_ids, positions labelled
    -100 (padding and visual tokens) masked out, averaged over the
    unmasked tokens.

    Returns step(params, opt_state, batch, grid_thw=None) -> (params,
    opt_state, metrics) with `.loss_and_grads` attached.  batch: tensors
    on the params' device: input_ids (N, S), labels (N, S), kv_mask
    (N, S) bool, position_ids (3, N, S), pixel_values optional.  With a
    `mesh` the batch is the global one, each rank runs its rows and the
    mean is over the global batch's unmasked tokens.  `attn_impl` and
    `pipeline` as in make_grpo_train_step."""
    remat = check_remat(remat)
    family = family_for_config(cfg)
    _check_parallel(mesh, attn_impl, pipeline)

    def loss_fn(params, batch, grid_thw):
        model = fsdp.gather(params["model"], keep=("layers",))
        ids = batch["input_ids"]
        lo, hi = row_range(ids.shape[0], mesh)
        token_embeds = embed(model["embed_tokens"], ids)
        if grid_thw is not None:
            vk = {k: batch[k] for k in family.vision_batch_keys if k in batch}
            ve = family.encode_vision(params, cfg, vk, grid_thw, remat=remat,
                                      attn_impl=attn_impl)
            token_embeds = family.merge_vision_embeds(cfg, ids, token_embeds,
                                                      ve)
        if pipeline is not None:
            hidden = pipeline_lm_forward(
                model, cfg.text, pipeline[0], num_microbatches=pipeline[1],
                input_embeds=token_embeds,
                position_ids=batch["position_ids"],
                kv_mask=batch["kv_mask"], remat=remat, logits=False,
                batch_axis="data")
        else:
            with expert.rows(expert.batch_layout(ids.shape[0], mesh)):
                hidden, _ = lm_forward(
                    model, cfg.text, input_embeds=_rows(token_embeds, lo, hi),
                    position_ids=_rows(batch["position_ids"], lo, hi, dim=1),
                    kv_mask=_rows(batch["kv_mask"], lo, hi), logits=False,
                    remat=remat, attn_impl=attn_impl)
        labels = _rows(batch["labels"], lo, hi)[:, 1:]
        mask = labels != -100
        # f32 products over the params' dtype, as JAX's f32 upcasts
        logps = chunked_per_token_logps(
            hidden[:, :-1], _head_kernel(model, cfg.text),
            torch.where(mask, labels, 0), chunk=logp_chunk)
        n = mask.sum()
        # a batch that does not divide runs whole on every rank, and its
        # tokens then count once per rank: the summed gradients stay right
        if mesh is None:
            denom = n.clamp_min(1)
        else:
            denom = fsdp.global_sum(n, mesh).clamp_min(1)
        return -(logps * mask).sum() / denom, {"n_tokens": denom}

    def loss_and_grads(params, batch, grid_thw=None, select=None):
        """-> (loss, metrics, grads in param_leaves order); `select` as in
        make_grpo_train_step's."""
        with torch.enable_grad():
            leaves, want = _track(params, select)
            loss, metrics = loss_fn(params, batch, grid_thw)
            grads = _grads(loss, leaves, want)
        if mesh is not None:
            fsdp.reduce_replicated(grads, fsdp.raw_leaves(params), mesh)
            loss = fsdp.global_sum(loss, mesh)
        return loss.detach(), metrics, grads

    def step(params, opt_state, batch, grid_thw=None):
        loss, metrics, grads = loss_and_grads(params, batch, grid_thw)
        leaves = [t for _, t in param_leaves(params)]
        norm = _norm_fn(params, mesh, pipeline)
        gnorm = norm(grads)
        opt_state = tx.apply(grads, opt_state, leaves, gnorm=gnorm, norm=norm)
        del grads
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    step.loss_and_grads = loss_and_grads
    return step

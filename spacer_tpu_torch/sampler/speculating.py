"""Speculative decoding for the trainer's grouped shared-prefix rollout
(counterpart of spacer_tpu/sampler/speculating.py).

The machinery of serving/speculative.py pointed at Sampler.generate:
prompt-lookup drafts (trigram, then bigram), one (1 + k)-token block
forward per step, greedy verification at temperature 0 and exact
speculative sampling otherwise.  Layout, as the sequential grouped decode
(sampler.py):

  - the prompt prefix KV (B, Hkv, P, Dh) is shared by the G completions of
    its group: one read of it per layer serves all G rows x kb positions;
  - the per-row tails (B*G, Hkv, T, Dh) are positional, the block written
    in place at slots t - 1 .. t - 1 + k of each row (out-of-range slots
    and finished rows masked out of the write);
  - rows retire one by one (per-row t and done) instead of the sequential
    loop's lockstep step counter;
  - the tails are allocated at max_new_tokens, and the tail length a step
    reads grows in JAX's buckets (128, 256, ... then max_new_tokens): the
    smallest that holds every live row's next block, never shrinking.

int8 weights and int8 caches compose as in serving: the block's k/v codes
and their per-(row, position, head) scales ride the same writes.
"""

from __future__ import annotations

import torch

from spacer_tpu_torch.models.qwen25_vl.config import TextConfig
from spacer_tpu_torch.models.qwen25_vl.language import (
    _mlp_block,
    lm_head,
    o_proj,
    qkv_proj,
)
from spacer_tpu_torch.nn.core import embed, rms_norm
from spacer_tpu_torch.nn.rope import apply_rope, mrope_cos_sin, rope_inv_freq
from spacer_tpu_torch.ops.quant import quantize_kv
from spacer_tpu_torch.parallel import multihost
from spacer_tpu_torch.serving.speculative import (
    _build_drafts,
    block_attention,
    block_biases,
    block_write_index,
    emit_block,
    verify_block,
    write_block,
)


def _spec_grouped_layer(h, layer_params, prefix_entry, tail_entry, *,
                        cfg: TextConfig, cos, sin, index, bias_p, bias_t,
                        tail_len: int, group: int):
    """One decoder layer over a kb-token block per row, grouped prefix.

    h (N, kb, D), N = B * G rows, group-major; prefix_entry (pk, pv)
    (B, Hkv, P, Dh) or the int8 4-tuple (codes, codes, (B, Hkv, P) scales);
    tail_entry (tk, tv) (N, Hkv, T, Dh) or its int8 4-tuple, written in
    place at `index` before the block attends.  Keep numerically in sync
    with serving/speculative.py::_spec_layer and language.py's grouped
    decode layer (kb = 1)."""
    N, kb, _ = h.shape
    pk, pv = prefix_entry[:2]
    tk, tv = tail_entry[:2]
    p_attn = layer_params["self_attn"]

    x = rms_norm(layer_params["input_layernorm"], h, cfg.rms_norm_eps)
    q, k, v = qkv_proj(p_attn, x, cfg)
    q, k = apply_rope(q, k, cos, sin)
    scales = None
    if len(tail_entry) == 4:
        tks, tvs = tail_entry[2:]
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        for dst, src in ((tk, kq), (tv, vq), (tks, ks), (tvs, vs)):
            write_block(dst, src, index)
        scales = (prefix_entry[2], prefix_entry[3], tks[:, :, :tail_len],
                  tvs[:, :, :tail_len])
    else:
        write_block(tk, k, index)
        write_block(tv, v, index)
    attn = block_attention(q, pk, pv, tk[:, :, :tail_len], tv[:, :, :tail_len],
                           scales, bias_p, bias_t, group=group, dtype=h.dtype)
    h = h + o_proj(p_attn, attn, cfg)
    x = rms_norm(layer_params["post_attention_layernorm"], h, cfg.rms_norm_eps)
    return h + _mlp_block(layer_params["mlp"], x, cfg)


def _spec_grouped_step(layers, params_model, cfg: TextConfig, toks, pos3,
                       prefix_split, prefix_mask, tail_split, t, active,
                       group: int, tail_len: int | None = None):
    """One speculative block step -> logits (N, kb, V); the tails update in
    place.  toks (N, kb) = [cur, draft_1 .. draft_k]; pos3 (3, N, kb); t (N,)
    emitted-token counts (block writes start at t - 1); active (N,) bool,
    the rows whose block is written; tail_len: the tail slots read."""
    N, kb = toks.shape
    Cmax = tail_split[0][0].shape[2]
    T = Cmax if tail_len is None else tail_len
    h = embed(params_model["embed_tokens"], toks)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=h.device)
    cos, sin = mrope_cos_sin(pos3, inv_freq, cfg.mrope_section)
    index = block_write_index(t, active, kb, Cmax)
    bias_p, bias_t = block_biases(prefix_mask, t, kb, T)
    for lp, pe, te in zip(layers, prefix_split, tail_split):
        h = _spec_grouped_layer(h, lp, pe, te, cfg=cfg, cos=cos, sin=sin,
                                index=index, bias_p=bias_p, bias_t=bias_t,
                                tail_len=T, group=group)
    h = rms_norm(params_model["norm"], h, cfg.rms_norm_eps)
    return lm_head(params_model, cfg, h)


def tail_buckets(max_new_tokens: int) -> list:
    """JAX's tail sizes: 128, 256, ... below max_new_tokens, then it."""
    bucket, out = min(128, max_new_tokens), []
    while bucket < max_new_tokens:
        out.append(bucket)
        bucket *= 2
    return out + [max_new_tokens]


def spec_decode_loop(model, text_cfg, prefix_split, prefix_mask, tail_split,
                     first_tokens, prompt_ids, deltas, prompt_len: int,
                     group: int, max_new_tokens: int, temperature: float,
                     top_p: float, eos_token_id: int, pad_token_id: int,
                     speculate_k: int, generator, rows=None, split=None):
    """Speculative shared-prefix rollout loop.

    prompt_ids / prefix_mask: (B, S) prompts left-padded to the bucket, the
    drafting context (each row drafts from its group's prompt and its own
    emitted tokens); deltas (N,).  -> (tokens (N, max_new_tokens), zeros
    past each row's end, and [active-row steps, emitted tokens]: tokens /
    steps is the mean acceptance; a sequential decode scores 1.0).

    Over rows split across ranks: `rows` = (n, lo), these N rows are rows
    [lo, lo + N) of n (the draws are made for all n, verify_block); `split`
    = (mesh, axes) the batch axes the rows split over.  Every rank then
    steps until every rank's rows are done, the step's tail bucket from
    the farthest live row of all of them (one max-reduce of (not all done,
    farthest need) over the batch group per step: the one host read), so
    each rank runs the steps and buckets one process runs; the counts
    come back summed over the ranks that hold distinct rows."""
    N = first_tokens.shape[0]
    G, kb = group, 1 + speculate_k
    dev = first_tokens.device
    pids = prompt_ids.repeat_interleave(G, dim=0)
    pmask = prefix_mask.repeat_interleave(G, dim=0)
    out = torch.zeros((N, max_new_tokens), dtype=torch.long, device=dev)
    out[:, 0] = first_tokens
    t = torch.ones((N,), dtype=torch.long, device=dev)
    done = first_tokens == eos_token_id
    cur = first_tokens.long()
    budget = torch.full_like(t, max_new_tokens)
    spec = torch.zeros((2,), dtype=torch.long, device=dev)
    rows_k = torch.arange(kb, device=dev)
    buckets = tail_buckets(max_new_tokens)
    bucket = buckets[0]
    while True:
        # one host read per step: any row left?, and the live rows'
        # farthest block end, which picks the tail bucket
        left = torch.stack([(~done).any().long(),
                            torch.where(done, 0, t - 1 + kb).amax()])
        if split is not None:
            multihost.all_reduce(left, split[0].group("batch"),
                                 kind="spec_step", op="max")
        left, need = left.tolist()
        if not left:
            break
        bucket = max(bucket, next((b for b in buckets if b >= need),
                                  max_new_tokens))
        was_done = done
        drafts = _build_drafts(pids, pmask, out, cur, t, speculate_k,
                               pad_token_id)
        toks = torch.cat([cur[:, None], drafts], dim=1)
        pos = (prompt_len + deltas + t - 1)[:, None] + rows_k
        logits = _spec_grouped_step(
            model["layers"], model, text_cfg, toks,
            pos[None].expand(3, N, kb), prefix_split, prefix_mask, tail_split,
            t, ~was_done, G, tail_len=bucket)
        preds, a, hit_eos = verify_block(
            logits, drafts, t, was_done, budget, eos_token_id=eos_token_id,
            temperature=temperature, top_p=top_p, generator=generator,
            rows=rows)
        emit_block(out, preds, t, a)
        last = preds.gather(1, (a - 1).clamp(min=0)[:, None])[:, 0]
        cur = torch.where(was_done, cur, last)
        t = t + a
        done = was_done | hit_eos | (t >= max_new_tokens)
        spec += torch.stack([(~was_done).sum(), a.sum()])
    if split is not None:
        mesh, axes = split
        # fsdp replicas of rows split over data alone count once
        multihost.all_reduce(spec, mesh.group(
            "batch" if tuple(axes) == ("data", "fsdp") else "data"),
            kind="spec_stats")
    return out, spec

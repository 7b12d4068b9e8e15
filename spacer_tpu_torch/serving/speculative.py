"""Speculative decoding (prompt-lookup drafts) for the continuous batcher
(counterpart of spacer_tpu/serving/speculative.py): greedy verification at
temperature 0, exact rejection sampling otherwise.

Each step processes a block of kb = 1 + speculate_k tokens per slot: the
slot's current token plus speculate_k drafts proposed by the most recent
trigram (else bigram) match in the slot's own context (prompt + emitted
tokens).  One forward over the block gives a prediction for every block
position; the step emits the longest run where prediction i equals draft i,
plus the first correction, so it emits between 1 and kb tokens and greedy
output is the sequential loop's by construction (up to float reassociation:
the block attention and K5 reduce in different orders, so an exact logit
tie could resolve differently).

KV writes: block position i of slot r belongs at tail slot t_r - 1 + i.
The spec path does not use the clock ring: the tail is positional, written
in place at those slots (the head-major caches of the ring batcher,
(R, Hkv, Cmax, Dh), with (R, Hkv, Cmax) f32 scales for int8 caches).  Slots
past the tail's end (possible near the budget; never accepted) and the rows
of slots that are done or empty are masked out of the write, never clamped.
Rejected slots hold stale drafts; the read mask `slot < t + i` never admits
a slot past the accepted frontier, and the next step's block starts at the
first stale slot (t' - 1 = t + a - 1), overwriting it before any mask can
expose it.

The block attention is its own function of torch ops mirroring the JAX
einsums (operands in the cache dtype, f32 logits and softmax, int8 K scales
folded into the logits and V scales into the probabilities): it is neither
K5 nor its plain version.  Under decode_quant "int4*" the block's weight
products are K6 at M = R * kb.
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

MASK_VALUE = -1e30


def block_write_index(t, active, kb: int, Cmax: int):
    """The in-place block write of one step: (rows, tail slots, block
    positions) of every write that lands.  Block position i of row r goes to
    slot t[r] - 1 + i; slots outside [0, Cmax) and inactive rows are left
    out (a CUDA index past the end is a device-side assert, and JAX's
    one-hot write drops them)."""
    slot = (t - 1)[:, None] + torch.arange(kb, device=t.device)
    keep = (slot >= 0) & (slot < Cmax) & active[:, None]
    rows, pos = keep.nonzero(as_tuple=True)
    return rows, slot[rows, pos], pos


def write_block(tail, blk, index):
    """tail (N, Hkv, Cmax[, Dh]) <- blk (N, kb, Hkv[, Dh]) at `index`
    (block_write_index's), in place."""
    rows, slots, pos = index
    tail[rows, :, slots] = blk[rows, pos].to(tail.dtype)


def block_biases(prefix_mask, t, kb: int, T: int):
    """The additive masks of one block step, built once for every layer:
    bias_p (B, 1, 1, P) over the prefix keys and bias_t (N, 1, 1, kb, T)
    over the tail slots, block-causal (position i reads slot j iff
    j < t + i, its own just-written KV included); 0 where read, MASK_VALUE
    elsewhere."""
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    dead = torch.full((), MASK_VALUE, dtype=torch.float32, device=t.device)
    iota = torch.arange(T, device=t.device)
    reads = iota[None, None, :] < (t[:, None]
                                   + torch.arange(kb, device=t.device))[:, :, None]
    return (torch.where(prefix_mask, zero, dead)[:, None, None, :],
            torch.where(reads, zero, dead)[:, None, None])


def block_attention(q, pk, pv, tk, tv, scales, bias_p, bias_t, *, group: int,
                    dtype):
    """Attention of a kb-token block over [prefix | tail], the JAX spec
    layers' einsums in torch ops: operands in `dtype` (int8 codes widened),
    f32 logits and softmax, int8 K scales folded into the logits and V
    scales into the probabilities.

    q (N, kb, H, Dh); pk/pv (B, Hkv, P, Dh) with N = B * group (serving:
    group 1, a prefix per row; the grouped rollout: the group's shared
    prefix, read once for its G rows); tk/tv (N, Hkv, T, Dh); scales None
    or (pk_s, pv_s, tk_s, tv_s) of shapes (B, Hkv, P) / (N, Hkv, T);
    bias_p / bias_t from block_biases.  -> (N, kb, H * Dh) in `dtype`."""
    N, kb, H, Dh = q.shape
    B, Hkv, P, _ = pk.shape
    gq, G = H // Hkv, group
    Q, T = gq * kb, tk.shape[2]
    scale = Dh ** -0.5

    def f32(x):
        return x.to(dtype).float()

    def to_prefix(x):   # (N, Hkv, Q, ·) -> (B, Hkv, G * Q, ·)
        return x.reshape(B, G, Hkv, Q, -1).transpose(1, 2).reshape(
            B, Hkv, G * Q, -1)

    def to_rows(x):     # the inverse
        return x.reshape(B, Hkv, G, Q, -1).transpose(1, 2).reshape(
            N, Hkv, Q, -1)

    # query rows per (row, kv head): (head of the group, block position)
    qh = f32(q).reshape(N, kb, Hkv, gq, Dh).permute(0, 2, 3, 1, 4).reshape(
        N, Hkv, Q, Dh)
    lp = torch.matmul(to_prefix(qh), f32(pk).transpose(-1, -2)) * scale
    lt = torch.matmul(qh, f32(tk).transpose(-1, -2)) * scale
    if scales is not None:
        pk_s, pv_s, tk_s, tv_s = scales
        lp = lp * pk_s[:, :, None, :]
        lt = lt * tk_s[:, :, None, :]
    lp = to_rows(lp + bias_p)
    lt = (lt.view(N, Hkv, gq, kb, T) + bias_t).view(N, Hkv, Q, T)
    probs = torch.softmax(torch.cat([lp, lt], dim=-1), dim=-1)
    probs_p, probs_t = to_prefix(probs[..., :P]), probs[..., P:]
    if scales is not None:
        probs_p = probs_p * pv_s[:, :, None, :]
        probs_t = probs_t * tv_s[:, :, None, :]
    out = (to_rows(torch.matmul(f32(probs_p), f32(pv)))
           + torch.matmul(f32(probs_t), f32(tv))).to(dtype)
    return out.reshape(N, Hkv, gq, kb, Dh).permute(0, 3, 1, 2, 4).reshape(
        N, kb, H * Dh)


def _spec_layer(h, layer_params, cache_entry, *, cfg: TextConfig, cos, sin,
                index, bias_p, bias_t, tail_len: int):
    """One decoder layer over a kb-token block per slot.  cache_entry: the
    batcher's head-major (pk, pv, tk, tv) or int8 8-tuple with (R, Hkv, T)
    scales; the block's k/v are written in place at `index` (int8: quantized
    per (row, position, head)) before the block attends, so position i reads
    its own KV.  Keep numerically in sync with serving/ragged.py (its
    kb = 1 case)."""
    R, kb, _ = h.shape
    pk, pv, tk, tv = cache_entry[:4]
    p_attn = layer_params["self_attn"]

    x = rms_norm(layer_params["input_layernorm"], h, cfg.rms_norm_eps)
    q, k, v = qkv_proj(p_attn, x, cfg)
    q, k = apply_rope(q, k, cos, sin)
    scales = None
    if len(cache_entry) == 8:
        pk_s, pv_s, tk_s, tv_s = cache_entry[4:]
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        for dst, src in ((tk, kq), (tv, vq), (tk_s, ks), (tv_s, vs)):
            write_block(dst, src, index)
        scales = (pk_s, pv_s, tk_s[:, :, :tail_len], tv_s[:, :, :tail_len])
    else:
        write_block(tk, k, index)
        write_block(tv, v, index)
    attn = block_attention(q, pk, pv, tk[:, :, :tail_len], tv[:, :, :tail_len],
                           scales, bias_p, bias_t, group=1, dtype=h.dtype)
    h = h + o_proj(p_attn, attn, cfg)
    x = rms_norm(layer_params["post_attention_layernorm"], h, cfg.rms_norm_eps)
    return h + _mlp_block(layer_params["mlp"], x, cfg)


def spec_decode_step(layers, params, cfg: TextConfig, toks, pos3, caches,
                     prefix_mask, t, active, tail_len: int | None = None):
    """One speculative block step -> logits (R, kb, V); the caches update in
    place.  toks (R, kb) = [cur, draft_1 .. draft_k]; pos3 (3, R, kb) rope
    positions; t (R,) emitted-token counts (block writes start at t - 1);
    active (R,) bool, the rows whose block is written; tail_len: the tail
    slots read (default all; every slot past it must be masked for every
    active row)."""
    R, kb = toks.shape
    Cmax = caches[0][2].shape[2]
    T = Cmax if tail_len is None else tail_len
    h = embed(params["embed_tokens"], toks)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=h.device)
    cos, sin = mrope_cos_sin(pos3, inv_freq, cfg.mrope_section)
    index = block_write_index(t, active, kb, Cmax)
    bias_p, bias_t = block_biases(prefix_mask, t, kb, T)
    for lp, entry in zip(layers, caches):
        h = _spec_layer(h, lp, entry, cfg=cfg, cos=cos, sin=sin, index=index,
                        bias_p=bias_p, bias_t=bias_t, tail_len=T)
    h = rms_norm(params["norm"], h, cfg.rms_norm_eps)
    return lm_head(params, cfg, h)


def _build_drafts(pids, pmask, out, cur, t, n_draft: int, pad_token: int):
    """Prompt-lookup drafts: for each row, the most recent earlier
    occurrence of the trailing n-gram in [prompt tokens, emitted tokens],
    longest first (trigram, then bigram), and the n_draft tokens that
    followed it.  No match, or a match running off the known context,
    drafts pad tokens: drafting is never wrong, only more or less useful."""
    R, Pmax = pids.shape
    Cmax = out.shape[1]
    PT = Pmax + Cmax
    dev = pids.device
    ctx = torch.cat([pids, out], dim=1)                               # (R, PT)
    valid = torch.cat([pmask.bool(),
                       torch.arange(Cmax, device=dev)[None] < t[:, None]], 1)
    cur_pos = Pmax + t - 1                                            # cur's index

    def tok_at(offset):
        """The token `offset` places before cur and whether it is real
        context (left padding never matches)."""
        idx = (cur_pos - offset).clamp(0, PT - 1)[:, None]
        return (ctx.gather(1, idx)[:, 0],
                valid.gather(1, idx)[:, 0] & (cur_pos - offset >= 0))

    prev1, ok1 = tok_at(1)
    prev2, ok2 = tok_at(2)
    j = torch.arange(PT, device=dev)
    earlier = j[None, 1:] < cur_pos[:, None]                          # strictly
    m2 = ((ctx[:, 1:] == cur[:, None]) & (ctx[:, :-1] == prev1[:, None])
          & valid[:, 1:] & valid[:, :-1] & ok1[:, None] & earlier)    # j = 1..
    m3 = m2 & torch.cat([
        torch.zeros((R, 1), dtype=torch.bool, device=dev),
        (ctx[:, :-2] == prev2[:, None]) & valid[:, :-2]], dim=1) & ok2[:, None]
    jj = j[None, 1:]
    none = torch.full_like(m2, -1, dtype=torch.long)
    best3 = torch.where(m3, jj, none).amax(dim=1)
    best2 = torch.where(m2, jj, none).amax(dim=1)
    best = torch.where(best3 >= 0, best3, best2)
    has = best >= 0
    gidx = best[:, None] + 1 + torch.arange(n_draft, device=dev)[None]
    in_ctx = gidx < cur_pos[:, None] + 1                              # known only
    gathered = ctx.gather(1, gidx.clamp(0, PT - 1))
    return torch.where(has[:, None] & in_ctx, gathered,
                       torch.full_like(gathered, pad_token))


def _speculative_sample(p, drafts, generator, rows=None):
    """Exact speculative sampling with deterministic (delta) drafts.

    p (R, kb, V) target probabilities per block position (position i is the
    distribution of the token after block token i); drafts (R, kb-1).
    Accept draft d_{i+1} at position i with probability p_i(d_{i+1}); on the
    first rejection emit a sample of p_i conditioned on != d; if every draft
    is accepted emit a bonus sample of the last position's p.  For every
    position P(emit y) = p(y).  -> (emit (R, kb), a (R,) in [1, kb]):
    emit[:, :a] are the step's tokens.  The sample is torch.multinomial's
    for one draw (argmax of p / q, q ~ Exp(1): the same tokens), and
    `rows` = (n, lo) says these R rows are rows [lo, lo + R) of n: every
    draw is made for all n rows, so each row gets the draws it gets in one
    process (sampler.sample_logits' rule)."""
    R, kb, V = p.shape
    dev = p.device
    n, lo = rows if rows is not None else (R, 0)
    p_draft = p[:, :-1].gather(-1, drafts[:, :, None].long())[..., 0]
    u = torch.rand((n, kb - 1), generator=generator, device=dev)[lo:lo + R]
    accept = (u < p_draft).long()
    m = accept.cumprod(dim=1).sum(dim=1)                              # 0..kb-1
    excl = torch.cat([drafts.long(),
                      torch.full((R, 1), -1, dtype=torch.long, device=dev)], 1)
    pv = p * (torch.arange(V, device=dev)[None, None] != excl[:, :, None])
    q = torch.empty((n * kb, V), dtype=pv.dtype, device=dev).exponential_(
        1, generator=generator).view(n, kb, V)[lo:lo + R]
    y = ((pv + 1e-30) / q).argmax(dim=-1)
    corr = y.gather(1, m[:, None])[:, 0]
    emit = torch.cat([drafts.long(), y[:, -1:]], dim=1)
    emit = torch.where(torch.arange(kb, device=dev)[None] == m[:, None],
                       corr[:, None], emit)
    return emit, m + 1


def verify_block(logits, drafts, t, was_done, budget, *, eos_token_id: int,
                 temperature: float, top_p: float, generator, rows=None):
    """The tokens a block step emits: greedy (temperature 0: the longest
    run of predictions equal to the drafts, plus the first correction) or
    exact speculative sampling (`rows` as _speculative_sample takes it);
    capped at the first EOS (inclusive) and at `budget` - t; 0 for rows
    already done.  -> (preds (R, kb), a (R,), hit_eos (R,) bool: an EOS
    was emitted)."""
    R, kb, V = logits.shape
    if temperature and temperature > 0.0:
        from spacer_tpu_torch.sampler.sampler import filtered_logits

        p = torch.softmax(filtered_logits(logits.reshape(R * kb, V),
                                          temperature, top_p), dim=-1)
        preds, a = _speculative_sample(p.reshape(R, kb, V), drafts, generator,
                                       rows)
    else:
        preds = logits.argmax(dim=-1)
        hit = (preds[:, :-1] == drafts).long()
        a = hit.cumprod(dim=1).sum(dim=1) + 1
    is_eos = preds == eos_token_id
    f = torch.where(is_eos.any(dim=1), is_eos.long().argmax(dim=1),
                    torch.full_like(a, kb))
    a = torch.minimum(a, f + 1)
    a = torch.minimum(a, budget - t)
    a = torch.where(was_done, torch.zeros_like(a), a.clamp(min=0))
    return preds, a, f + 1 <= a


def emit_block(out, preds, t, a):
    """out[r, t + i] = preds[r, i] for i < a[r] (in place)."""
    R, kb = preds.shape
    Cmax = out.shape[1]
    rows_k = torch.arange(kb, device=out.device)
    sel = ((torch.arange(Cmax, device=out.device)[None, None]
            == (t[:, None] + rows_k)[:, :, None])
           & (rows_k[None, :, None] < a[:, None, None]))              # (R, kb, C)
    upd = (sel.long() * preds[:, :, None]).sum(dim=1)
    out.copy_(torch.where(sel.any(dim=1), upd, out))


def spec_chunk(b, layers, model, cfg: TextConfig, *, chunk_steps: int,
               speculate_k: int) -> int:
    """Up to chunk_steps speculative block steps over the batcher `b`'s slots
    (serving/batcher.py ContinuousBatcher: its pids, pmask, delta, maxnew,
    cur, t, done, out and spec counters, updated in place); stops early once
    every slot is done (checked before each step, as JAX's while_loop; each
    block step is a `decode.step`, ContinuousBatcher.run_steps) -> the
    steps run.  The clock and admit indices are left alone: speculation is
    positional."""
    R, Pmax = b.pmask.shape
    kb = 1 + speculate_k
    rows_k = torch.arange(kb, device=b.t.device)

    def step():
        was_done = b.done
        drafts = _build_drafts(b.pids, b.pmask, b.out, b.cur, b.t, speculate_k,
                               b.pad)
        toks = torch.cat([b.cur[:, None], drafts], dim=1)
        pos = (Pmax + b.delta + b.t - 1)[:, None] + rows_k
        logits = spec_decode_step(layers, model, cfg, toks,
                                  pos[None].expand(3, R, kb), b.caches,
                                  b.pmask, b.t, ~was_done)
        preds, a, hit_eos = verify_block(
            logits, drafts, b.t, was_done, b.maxnew, eos_token_id=b.eos,
            temperature=b.temperature, top_p=b.top_p, generator=b.generator)
        emit_block(b.out, preds, b.t, a)
        last = preds.gather(1, (a - 1).clamp(min=0)[:, None])[:, 0]
        b.cur = torch.where(was_done, b.cur, last)
        b.t = b.t + a
        b.done = was_done | hit_eos | (b.t >= b.maxnew)
        # row-steps: a sequential decode emits one token per active row per
        # step, so tokens / steps is the mean acceptance (1.0 = no help)
        b.spec += torch.stack([(~was_done).sum(), a.sum()])

    return b.run_steps(step, chunk_steps)

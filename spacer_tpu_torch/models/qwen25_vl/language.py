"""Decoder language model (M-RoPE, GQA) in PyTorch (counterpart of
spacer_tpu/models/qwen25_vl/language.py).

Params are a dict whose "layers" entry is a list of per-layer dicts (a
Python loop replaces lax.scan).  Two ways to attend over earlier keys:

- inference: the KV cache is {"k": [...], "v": [...]}, one (B, T, Hkv, Dh)
  tensor per layer, written IN PLACE at `cache_index` (JAX's donated
  dynamic_update_slice).  Inference-only: lm_forward refuses it when
  autograd would record the writes.
- training: `prefix_kv` hands each layer the (N, P, Hkv, Dh) keys/values of
  an earlier pass, concatenated in front of the block's own (functional, as
  JAX's padded cache + write at P), and `return_kv` returns each layer's
  block keys/values.  Per-layer remat is torch.utils.checkpoint, whole or
  selective (`check_remat`'s modes).

`attn_impl=("ring", mesh, axis)` (lm_forward, `_layer`) runs the layers'
self-attention as ring attention over that mesh axis where it applies (no
cache, no prefix: Sq == Skv at q_offset 0), as JAX's attn_impl tuple does
(nn/attention.dot_product_attention).

The grouped rollout's decode step (`lm_decode_step_split`, head-major caches,
attention through K2, or K2-int8 for int8 caches) writes its tail caches in
place, under no_grad; `lm_decode_step` is JAX's one-shot wrapper of it over
stacked (position-major) buffers.

Tensor parallelism (parallel/tp.py, active once params are sharded onto a
mesh): every layer runs on this rank's heads and columns (head counts
cfg.num_heads // tp), q/k/v and gate/up are column-parallel after
`copy_to_tp`, o_proj and down_proj row-parallel with `reduce_from_tp`, the
embedding vocab-parallel, and `lm_head` all-gathers the local vocabulary's
logits (`local_logits` keeps them local: the train step's logps).  KV
caches hold the local KV heads (`init_kv_cache`, `local_kv_heads`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from spacer_tpu_torch.models.qwen25_vl.config import TextConfig
from spacer_tpu_torch.nn.attention import dot_product_attention
from spacer_tpu_torch.nn.core import (
    dense_init,
    embed,
    embed_init,
    rms_norm,
    rms_norm_init,
)
from spacer_tpu_torch.nn.rope import apply_rope, mrope_cos_sin, rope_inv_freq
from spacer_tpu_torch.ops.flash_decode import (
    MASK_VALUE,
    flash_decode_attention,
)
from spacer_tpu_torch.ops.quant import quantize_kv
from spacer_tpu_torch.parallel import expert, tp
from spacer_tpu_torch.parallel.fsdp import gather

Params = Any


def init_lm_params(cfg: TextConfig, *, generator: torch.Generator,
                   dtype=torch.float32, device=None) -> Params:
    """Random LM params with spacer_tpu's init scales, drawn from `generator`
    (which must live on `device`)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(generator=generator, dtype=dtype, device=device)

    def layer():
        return {
            "input_layernorm": rms_norm_init(D, dtype, device),
            "post_attention_layernorm": rms_norm_init(D, dtype, device),
            "self_attn": {
                "q_proj": dense_init(D, H * Dh, True, **kw),
                "k_proj": dense_init(D, Hkv * Dh, True, **kw),
                "v_proj": dense_init(D, Hkv * Dh, True, **kw),
                "o_proj": dense_init(H * Dh, D, False, **kw),
            },
            "mlp": {
                "gate_proj": dense_init(D, I, False, **kw),
                "up_proj": dense_init(D, I, False, **kw),
                "down_proj": dense_init(I, D, False, **kw),
            },
        }

    params = {
        "embed_tokens": embed_init(cfg.vocab_size, D, **kw),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "norm": rms_norm_init(D, dtype, device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense_init(D, cfg.vocab_size, False, **kw)
    return params


def local_kv_heads(cfg: TextConfig) -> int:
    """The KV heads this rank holds (all of them without tp)."""
    return tp.local_heads(cfg.num_kv_heads, "num_kv_heads")


def init_kv_cache(cfg: TextConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, local_kv_heads(cfg), cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device)
              for _ in range(cfg.num_layers)],
    }


def _mlp_block(p_mlp, x, cfg: TextConfig):
    """Feed-forward: SwiGLU (Qwen), or with cfg.moe_topk > 0 the MoE
    (Aria; ops/moe.py)."""
    if getattr(cfg, "moe_topk", 0):
        from spacer_tpu_torch.ops.moe import moe_mlp

        I = cfg.intermediate_size
        return moe_mlp(p_mlp, x, topk=cfg.moe_topk, impl=cfg.moe_impl,
                       capacity_factor=cfg.moe_capacity_factor,
                       ep_axis=cfg.moe_ep_axis,
                       widths=(I, I * cfg.moe_num_shared_experts))
    I = cfg.intermediate_size
    x = tp.copy_to_tp(x)
    gate = F.silu(tp.column(p_mlp["gate_proj"], x, I))
    return tp.row(p_mlp["down_proj"], gate * tp.column(p_mlp["up_proj"], x, I),
                  I)


def qkv_proj(p_attn, x, cfg: TextConfig):
    """q (..., H, Dh), k and v (..., Hkv, Dh) of this rank's heads."""
    H, Dh = tp.local_heads(cfg.num_heads, "num_heads"), cfg.head_dim
    Hkv = local_kv_heads(cfg)
    lead = x.shape[:-1]
    x = tp.copy_to_tp(x)
    q = tp.column(p_attn["q_proj"], x, cfg.num_heads * Dh)
    k = tp.column(p_attn["k_proj"], x, cfg.num_kv_heads * Dh)
    v = tp.column(p_attn["v_proj"], x, cfg.num_kv_heads * Dh)
    return (q.reshape(*lead, H, Dh), k.reshape(*lead, Hkv, Dh),
            v.reshape(*lead, Hkv, Dh))


def o_proj(p_attn, attn, cfg: TextConfig):
    """The row-parallel output projection of (..., local heads * Dh)."""
    return tp.row(p_attn["o_proj"], attn, cfg.num_heads * cfg.head_dim)


def _layer(h, layer_params, cache_kv, *, cfg: TextConfig, cos, sin, kv_mask,
           cache_index: int, prefix_kv=None, attn_impl=None,
           causal: bool = True):
    """One decoder layer -> (h, (k, v) of this block).  h: (B, S, D);
    cache_kv: (k, v) cache tensors of this layer, updated in place, or None;
    prefix_kv: (pk, pv) (B, P, Hkv, Dh) keys/values attended before the
    block's own (causal offset P), or None; attn_impl: None or ("ring",
    mesh, axis); causal=False lets every query see every key kv_mask
    keeps (the whole cache, with one)."""
    B, S, _ = h.shape
    p_attn = layer_params["self_attn"]

    x = rms_norm(layer_params["input_layernorm"], h, cfg.rms_norm_eps)
    q, k, v = qkv_proj(p_attn, x, cfg)
    q, k = apply_rope(q, k, cos, sin)
    block_kv = (k, v)

    q_offset = 0
    if cache_kv is not None:
        ck, cv = cache_kv
        ck[:, cache_index:cache_index + S] = k   # in-place cache write
        cv[:, cache_index:cache_index + S] = v
        k, v = ck.to(q.dtype), cv.to(q.dtype)
        q_offset = cache_index
    elif prefix_kv is not None:
        pk, pv = prefix_kv
        k = torch.cat([pk.to(k.dtype), k], dim=1)
        v = torch.cat([pv.to(v.dtype), v], dim=1)
        q_offset = pk.shape[1]

    attn = dot_product_attention(q, k, v, causal=causal, kv_mask=kv_mask,
                                 q_offset=q_offset, impl=attn_impl)
    h = h + o_proj(p_attn, attn.reshape(B, S, -1), cfg)
    x = rms_norm(layer_params["post_attention_layernorm"], h, cfg.rms_norm_eps)
    return h + _mlp_block(layer_params["mlp"], x, cfg), block_kv


def _layer_in(layout, h, *args, **kw):
    """_layer under a parallel/expert.rows layout."""
    with expert.rows(layout):
        return _layer(h, *args, **kw)


def split_layers(stacked, num_layers: int):
    """Stacked (L, ...) nested dict of arrays/tensors -> tuple of L
    per-layer nested dicts."""
    def take(tree, l):
        if isinstance(tree, dict):
            return {k: take(v, l) for k, v in tree.items()}
        return tree[l]

    return tuple(take(stacked, l) for l in range(num_layers))


def local_logits(params, cfg: TextConfig, h):
    """Logits over this rank's vocabulary slice (all of it without tp)."""
    h = tp.copy_to_tp(h)
    if cfg.tie_word_embeddings:
        table = tp.local(params["embed_tokens"]["embedding"], 0,
                         cfg.vocab_size)
        return torch.matmul(h, table.T)
    return tp.column(params["lm_head"], h, cfg.vocab_size)


def lm_head(params, cfg: TextConfig, h):
    """Logits over the whole vocabulary (all-gathered over tp)."""
    return tp.gather_from_tp(local_logits(params, cfg, h))


def check_attn_impl(attn_impl):
    """Validate an attn_impl: None or ("ring", mesh, axis) (ValueError).
    Under the ring only self-attention is sequence-parallel: its output is
    all-gathered, so the MLP, the MoE of moe_impl "ep" included, runs on
    the whole batch on every rank, its capacity over every token, as in
    JAX's global program."""
    from spacer_tpu_torch.nn.attention import ring_impl

    ring_impl(attn_impl)


def check_remat(remat):
    """Validate a remat mode up front (a typo must not pass through) and
    return it normalised: False, True (full per-layer recompute), "dots"
    (save every matmul output without batch dims), "dots_narrow" (the same
    but outputs at least intermediate_size wide: gate/up are recomputed) or
    "dots_mixed:K" ("dots" for the first K layers, "dots_narrow" for the
    rest), as spacer_tpu's `_remat_wrap` and `lm_apply` take them."""
    if remat in (False, True, None):
        return bool(remat)
    if remat in ("dots", "dots_narrow"):
        return remat
    if isinstance(remat, str) and remat.startswith("dots_mixed:"):
        k = remat.split(":", 1)[1]
        if k.isdigit():
            return f"dots_mixed:{int(k)}"
    raise ValueError(
        f"unknown remat mode {remat!r}: expected False, True, 'dots', "
        "'dots_narrow' or 'dots_mixed:K' with an integer K >= 0")


def _layer_remat(remat, layer: int):
    """The mode one layer runs under: "dots_mixed:K" splits at layer K."""
    if isinstance(remat, str) and remat.startswith("dots_mixed:"):
        return "dots" if layer < int(remat.split(":", 1)[1]) else "dots_narrow"
    return remat


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(wide: Optional[int]):
    """Selective-checkpoint policy: save the output of every 2-D matmul
    (`dense`'s aten.mm / addmm; JAX's dots without batch dims) narrower
    than `wide` columns (None: every one); recompute everything else.
    Attention's products are batched (bmm) or inside K1's autograd
    Function, so attention is recomputed, as JAX recomputes its batched
    dots."""
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        if op in _MATMULS and (wide is None or args[-1].shape[-1] < wide):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _checkpoint_kwargs(mode, cfg: TextConfig) -> dict:
    if mode is True:
        return {}
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    policy = _dots_policy(None if mode == "dots" else cfg.intermediate_size)
    return {"context_fn":
            lambda: create_selective_checkpoint_contexts(policy)}


def _records_grad(params, x) -> bool:
    """Whether autograd would record a forward over these params/inputs
    (the layer weights are all-or-nothing trainable)."""
    if not torch.is_grad_enabled():
        return False
    layers = params["layers"]
    return x.requires_grad or bool(
        layers and layers[0]["self_attn"]["q_proj"]["kernel"].requires_grad)


def lm_forward(params: Params, cfg: TextConfig, *,
               input_ids: Optional[torch.Tensor] = None,
               input_embeds: Optional[torch.Tensor] = None,
               position_ids: Optional[torch.Tensor] = None,
               kv_mask: Optional[torch.Tensor] = None, causal: bool = True,
               cache=None, cache_index: int = 0, last_only: bool = False,
               logits: bool = True, remat=False, prefix_kv=None,
               return_kv: bool = False, attn_impl=None):
    """Run the LM -> (logits or hidden, cache or per-layer kv).

    `causal=False` runs it with bidirectional attention: every query sees
    every key kv_mask keeps (with a cache, the whole cache under kv_mask,
    as JAX's _layer), through K1 at causal=0 on the card.
    With `cache`, the current block's keys/values are written in place at
    `cache_index` and attention runs over the whole cache (masked by
    `kv_mask`, which then covers the cache length); inference only.  With
    `prefix_kv` (a per-layer list of (pk, pv)), attention runs over
    [prefix | block] (kv_mask covers both); with `return_kv` the second
    result is the per-layer list of the block's (k, v) instead of the cache.
    `last_only` computes the head at the last position only ((B, 1, V)
    logits), which is all a prefill for sampling reads; `logits=False`
    returns the final-norm hidden states.  `remat=True` recomputes each
    layer in the backward pass (torch.utils.checkpoint); the selective
    modes of `check_remat` save the matmul outputs their policy names
    (create_selective_checkpoint_contexts) and recompute the rest.
    `attn_impl` ("ring", mesh, axis) runs the self-attention as ring
    attention over that axis where it applies (see the module docstring)."""
    remat = check_remat(remat)
    check_attn_impl(attn_impl)
    # fsdp Shards are gathered where used: the layers one at a time, inside
    # each (checkpointed) layer
    params = gather(params, keep=("layers",))
    if input_embeds is None:
        input_embeds = embed(params["embed_tokens"], input_ids)
    B, S, _ = input_embeds.shape
    dev = input_embeds.device
    if position_ids is None:
        position_ids = torch.arange(S, device=dev)[None, None].expand(3, B, S)
    grad = _records_grad(params, input_embeds)
    if cache is not None:
        if grad or prefix_kv is not None:
            raise ValueError("the in-place KV cache is an inference path: run "
                             "it under torch.no_grad(); training passes "
                             "prefix_kv")
        T = cache["k"][0].shape[1]
        if not 0 <= cache_index <= T - S:
            raise ValueError(f"cache_index {cache_index} + {S} tokens exceeds "
                             f"the cache length {T}")
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=dev)
    cos, sin = mrope_cos_sin(position_ids, inv_freq, cfg.mrope_section)

    # the MoE's row layout, which the backward's recomputed layers run under
    layout = expert.current()
    h, kvs = input_embeds, []
    for l, lp in enumerate(params["layers"]):
        kw = dict(cfg=cfg, cos=cos, sin=sin, kv_mask=kv_mask,
                  cache_index=cache_index, attn_impl=attn_impl, causal=causal,
                  prefix_kv=None if prefix_kv is None else prefix_kv[l])
        if cache is not None:
            h, kv = _layer(h, gather(lp), (cache["k"][l], cache["v"][l]), **kw)
        elif remat and grad:
            h, kv = checkpoint(
                lambda x, lp=lp, kw=kw: _layer_in(layout, x, gather(lp),
                                                  None, **kw), h,
                use_reentrant=False,
                **_checkpoint_kwargs(_layer_remat(remat, l), cfg))
        else:
            h, kv = _layer(h, gather(lp), None, **kw)
        if return_kv:
            kvs.append(kv)
    h = rms_norm(params["norm"], h, cfg.rms_norm_eps)
    if last_only:
        h = h[:, -1:]
    second = kvs if return_kv else cache
    if not logits:
        return h, second
    return lm_head(params, cfg, h), second


# -- grouped rollout decode (head-major caches, K2) -------------------------


def _decode_layer_hm(h, layer_params, prefix_entry, tail_entry, *,
                     cfg: TextConfig, cos, sin, bias_p, tail_len: int,
                     tail_index: int, group: int):
    """Head-major decode layer (spacer_tpu's _decode_layer_hm): writes this
    step's k/v into the tail IN PLACE at `tail_index`, then attends through
    K2 (ops/flash_decode.flash_decode_attention: the kernel on CUDA tensors,
    its plain version on CPU tensors).

    h: (N = B*G, 1, D); prefix_entry (pk, pv): (B, Hkv, P, Dh), shared by the
    G completions of each prompt; tail_entry (tk, tv): (N, Hkv, T, Dh);
    int8 caches (decode_quant "int8_kv" / "int4_kv") are 4-tuples (codes k,
    codes v, f32 k scales, f32 v scales) with scales (B, Hkv, P) /
    (N, Hkv, T), and the new k/v are quantized per (row, head) and written
    with their scales; bias_p: (B, 1, P) additive f32; tail_len: live tail
    length after the write (a host int)."""
    N = h.shape[0]
    pk, pv = prefix_entry[:2]
    tk, tv = tail_entry[:2]
    quant = len(prefix_entry) == 4
    p_attn = layer_params["self_attn"]

    x = rms_norm(layer_params["input_layernorm"], h, cfg.rms_norm_eps)
    q, k, v = qkv_proj(p_attn, x, cfg)
    H, Hkv, Dh = q.shape[-2], k.shape[-2], cfg.head_dim
    B, G, group_q = pk.shape[0], group, H // Hkv
    q, k = apply_rope(q, k, cos, sin)
    # in-place tail write
    if quant:
        tks, tvs = tail_entry[2:]
        (kq, ks), (vq, vs) = quantize_kv(k[:, 0]), quantize_kv(v[:, 0])
        tk[:, :, tail_index], tks[:, :, tail_index] = kq, ks
        tv[:, :, tail_index], tvs[:, :, tail_index] = vq, vs
        scales = (prefix_entry[2][:, :, None], prefix_entry[3][:, :, None],
                  tks[:, :, None], tvs[:, :, None])
    else:
        tk[:, :, tail_index] = k[:, 0].to(tk.dtype)
        tv[:, :, tail_index] = v[:, 0].to(tv.dtype)
        scales = (None,) * 4

    # q rows per (b, hkv): the group's G completions x group_q heads
    q_hm = q.reshape(B, G, Hkv, group_q, Dh).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, G * group_q, Dh).contiguous()
    out = flash_decode_attention(q_hm, pk, pv, bias_p, tk, tv, tail_len,
                                 *scales, group=G, group_q=group_q,
                                 sm_scale=Dh ** -0.5)
    out = out.reshape(B, Hkv, G, group_q, Dh).permute(0, 2, 1, 3, 4).reshape(
        N, 1, H * Dh).to(h.dtype)
    h = h + o_proj(p_attn, out, cfg)
    x = rms_norm(layer_params["post_attention_layernorm"], h, cfg.rms_norm_eps)
    return h + _mlp_block(layer_params["mlp"], x, cfg)


def lm_decode_step_split(layers, params: Params, cfg: TextConfig, input_ids,
                         position_ids, prefix_split, bias_p, tail_split,
                         tail_index: int, group: int, tail_len: int):
    """One shared-prefix decode step over per-layer head-major caches ->
    logits (N, 1, V); the tails are written in place (spacer_tpu's
    lm_decode_step_split with head_major=True).

    input_ids (N, 1); position_ids (3, N, 1); prefix_split: per layer
    (pk, pv) (B, Hkv, P, Dh); bias_p (B, 1, P) f32; tail_split: per layer
    (tk, tv) (N, Hkv, T, Dh) (or int8 4-tuples, see _decode_layer_hm);
    tail_len = tail_index + 1."""
    h = embed(params["embed_tokens"], input_ids)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, device=h.device)
    cos, sin = mrope_cos_sin(position_ids, inv_freq, cfg.mrope_section)
    for l, lp in enumerate(layers):
        h = _decode_layer_hm(h, lp, prefix_split[l], tail_split[l], cfg=cfg,
                             cos=cos, sin=sin, bias_p=bias_p,
                             tail_len=tail_len, tail_index=tail_index,
                             group=group)
    h = rms_norm(params["norm"], h, cfg.rms_norm_eps)
    return lm_head(params, cfg, h)


def _split_cache(cache, num_layers: int) -> list:
    """A stacked decode cache {"k", "v"[, "k_scale", "v_scale"]} (each a
    (L, ...) tensor or a per-layer list) -> per layer its head-major entry:
    (k, v) (rows, Hkv, T, Dh), or with scales the int8 4-tuple (codes k,
    codes v, f32 k scales, f32 v scales) with scales (rows, Hkv, T)."""
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache else (
        "k", "v")
    return [tuple(cache[n][l].transpose(1, 2).contiguous() for n in names)
            for l in range(num_layers)]


@torch.no_grad()
def lm_decode_step(params: Params, cfg: TextConfig, input_ids, position_ids,
                   prefix_cache, prefix_mask, tail_cache, tail_mask,
                   tail_index: int, group: int):
    """Shared-prefix decode step over stacked buffers -> (logits (B*G, 1,
    V), new tail_cache): spacer_tpu's lm_decode_step, the one-shot wrapper
    around lm_decode_step_split (the sampler's loop calls that directly).

    prefix_cache {"k", "v"}: per layer (B, P, Hkv, Dh), as init_kv_cache
    holds them (a list, or one stacked (L, ...) tensor each); with
    "k_scale" / "v_scale" ((B, P, Hkv) f32 per layer) the codes are int8
    (quantize_kv) and the step runs K2-int8, else K2.  prefix_mask (B, P);
    tail_cache likewise (B*G, T, Hkv, Dh); tail_mask (B*G, T) must be the
    live prefix [0, tail_index] of every row (the head-major kernels take
    the scalar live length; any other mask raises ValueError).  The
    caches are copied to the head-major layout, the new token's k/v written
    at tail_index into the copy, and the new tail returned in the caller's
    layout and kind (a list, or stacked tensors).  Inference only, as
    K2 is."""
    L = cfg.num_layers
    params = gather(params)
    T = tail_cache["k"][0].shape[1]
    live = torch.arange(T, device=tail_mask.device) <= tail_index
    if not bool((tail_mask.bool() == live).all()):
        raise ValueError("tail_mask must be the positions [0, tail_index] of "
                         "every row (the decode kernels take a live length)")
    prefix_mask = prefix_mask.bool()
    bias_p = torch.where(prefix_mask, 0.0, MASK_VALUE)[:, None, :].float()
    tails = _split_cache(tail_cache, L)
    logits = lm_decode_step_split(
        params["layers"], params, cfg, input_ids,
        position_ids, _split_cache(prefix_cache, L), bias_p.contiguous(),
        tails, tail_index=tail_index, group=group, tail_len=tail_index + 1)
    names = ("k", "v", "k_scale", "v_scale")
    new = {}
    for i, n in enumerate(names[:len(tails[0])]):
        per_layer = [t[i].transpose(1, 2).contiguous() for t in tails]
        new[n] = (torch.stack(per_layer) if isinstance(tail_cache[n],
                                                       torch.Tensor)
                  else per_layer)
    return logits, new

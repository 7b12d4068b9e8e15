"""Entry points and keywords of spacer_tpu that the port gained late, each
against the JAX function on the same numpy inputs (tiny configs, float32,
the CPU: the port's kernel wrappers take their plain versions, JAX's
Pallas calls run in interpret mode or through their plain reference).

- models/qwen25_vl/model.py `forward` (both Qwen families; pixels,
  precomputed vision embeddings, text; no cache, and a cache prefilled at
  cache_index 0 then stepped at cache_index > 0) and `make_kv_cache`;
- language.py `lm_forward(causal=False)`: logits and gradients, with a
  cache too; the pipeline at a pipe of one with causal=False;
- `lm_decode_step` over stacked buffers, bf16-layout (f32 here) and int8
  caches, against JAX's lm_decode_step / lm_decode_step_split;
- nn/rope.py `apply_mrope`;
- ops/vit_window_attention.py `window_attention` / `make_window_attention`:
  forward and gradients;
- Sampler.generate(vision_embeds=): greedy tokens;
- make_grpo_train_step(encode_vision_in_step=False): metrics and updated
  params, the ViT untouched;
- the LoRA GRPO step with the ring attn_impl at a world of one against the
  plain LoRA step and JAX's ring LoRA step on a one-device mesh;
- make_optimizer(schedule="constant"): the updates of JAX's at every step;
- train/checkpoint.py `load_model_only` after save_model_only, onto plain
  tensors and onto fsdp Shards;
- parallel/multihost.py `replicate_to_mesh`, `global_batch_from_local(
  batch_axes=)`; evalharness `InferenceEngine`.

Tolerance: atol = rtol = 1e-4 in f32 (tests/test_torch_language.py's:
a few layers of matmuls, norms and attention differ in summation order
only).  Where a test says bitwise, the two sides run the same operations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import get_rope_index
from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu_torch.models.qwen25_vl import params_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
GRID = (2, 8, 12)
ARCHS = ("qwen2_5", "qwen2")


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    cfg = tiny_config(arch=request.param)
    params = jax_init_params(jax.random.key(3), cfg, jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, np_params, params_from_jax(np_params, cfg)


@pytest.fixture(scope="module")
def qwen():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(1), cfg, jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    return cfg, params, np_params, params_from_jax(np_params, cfg)


def _video_rows(cfg, pad=3):
    """Two left-padded rows: a video prompt and a text prompt -> (ids,
    mask, pos, deltas, pixels)."""
    nv = GRID[0] * GRID[1] * GRID[2] // cfg.vision.spatial_merge_unit
    video = ([10, 11, cfg.vision_start_token_id] + [cfg.video_token_id] * nv
             + [cfg.vision_end_token_id, 20, 21])
    S = len(video)
    text = list(np.random.default_rng(5).integers(10, cfg.text.vocab_size,
                                                  S - pad))
    ids = np.array([video, [cfg.pad_token_id] * pad + text])
    mask = np.ones_like(ids)
    mask[1, :pad] = 0
    pos, deltas = get_rope_index(cfg, ids, video_grid_thw=np.array([GRID]),
                                 attention_mask=mask)
    px = np.random.default_rng(2).normal(
        size=(GRID[0] * GRID[1] * GRID[2], cfg.vision.patch_dim)).astype(
        np.float32)
    return ids, mask, np.asarray(pos), np.asarray(deltas), px


# -- forward / make_kv_cache ---------------------------------------------------


def test_forward_matches_jax(family):
    """No cache: with pixels, with precomputed vision embeddings (the same
    bits as the pixels' own encode) and text alone."""
    from spacer_tpu.models.qwen25_vl import forward as jax_forward
    from spacer_tpu_torch.models.qwen25_vl import encode_vision, forward

    cfg, params, _, tparams = family
    ids, mask, pos, _, px = _video_rows(cfg)
    ref, _ = jax_forward(params, cfg, jnp.asarray(ids),
                         pixel_values=jnp.asarray(px), grid_thw=[GRID],
                         position_ids=jnp.asarray(pos),
                         kv_mask=jnp.asarray(mask, bool), attn_impl="xla")
    kw = dict(position_ids=_t(pos).long(), kv_mask=_t(mask).bool())
    with torch.no_grad():
        out, cache = forward(tparams, cfg, _t(ids).long(),
                             pixel_values=_t(px), grid_thw=[GRID], **kw)
        ve = encode_vision(tparams, cfg, _t(px), [GRID])
        again, _ = forward(tparams, cfg, _t(ids).long(), vision_embeds=ve,
                           **kw)
        text, _ = forward(tparams, cfg, _t(ids[1:]).long(),
                          position_ids=_t(pos[:, 1:]).long(),
                          kv_mask=_t(mask[1:]).bool())
    assert cache is None
    live = mask.astype(bool)
    np.testing.assert_allclose(out.numpy()[live], np.asarray(ref)[live], **TOL)
    assert torch.equal(out, again)
    ref_text, _ = jax_forward(params, cfg, jnp.asarray(ids[1:]),
                              position_ids=jnp.asarray(pos[:, 1:]),
                              kv_mask=jnp.asarray(mask[1:], bool),
                              attn_impl="xla")
    np.testing.assert_allclose(text.numpy()[0, 3:],
                               np.asarray(ref_text)[0, 3:], **TOL)


def test_forward_with_cache_matches_jax(family):
    """A prefill with pixels into make_kv_cache at cache_index 0, then two
    one-token steps at cache_index S and S + 1: logits and the cache
    against JAX's forward on its functional cache."""
    from spacer_tpu.models.qwen25_vl import forward as jax_forward
    from spacer_tpu.models.qwen25_vl.model import make_kv_cache as jax_make_cache
    from spacer_tpu_torch.models.qwen25_vl import forward, make_kv_cache

    cfg, params, _, tparams = family
    ids, mask, pos, deltas, px = _video_rows(cfg)
    B, S = ids.shape
    T = S + 4
    kv = np.concatenate([mask, np.zeros((B, T - S), mask.dtype)], 1)
    jcache = jax_make_cache(cfg, B, T, jnp.float32)
    cache = make_kv_cache(cfg, B, T, torch.float32)
    nxt = np.random.default_rng(6).integers(10, cfg.text.vocab_size, (B, 2))
    steps = [(ids, pos, 0, dict(pixel_values=px, grid_thw=[GRID]))]
    for i in range(2):
        p = np.broadcast_to((deltas.reshape(B) + S + i)[None, :, None],
                            (3, B, 1))
        steps.append((nxt[:, i:i + 1], p, S + i, {}))
    with torch.no_grad():
        for x, p, at, vis in steps:
            if at:   # a decoded token is live; the prompt keeps its mask
                kv[:, at:at + x.shape[1]] = 1
            ref, jcache = jax_forward(
                params, cfg, jnp.asarray(x), position_ids=jnp.asarray(p),
                kv_mask=jnp.asarray(kv, bool), cache=jcache, cache_index=at,
                attn_impl="xla",
                **{k: (jnp.asarray(v) if k == "pixel_values" else v)
                   for k, v in vis.items()})
            out, cache = forward(
                tparams, cfg, _t(x).long(), position_ids=_t(p).long(),
                kv_mask=_t(kv).bool(), cache=cache, cache_index=at,
                **{k: (_t(v) if k == "pixel_values" else v)
                   for k, v in vis.items()})
            rows = kv[:, at:at + x.shape[1]].astype(bool) & (
                mask.any(1)[:, None])
            np.testing.assert_allclose(out.numpy()[rows],
                                       np.asarray(ref)[rows], **TOL)
    written = kv.astype(bool)
    for name in ("k", "v"):
        got = torch.stack(cache[name]).numpy()
        np.testing.assert_allclose(got[:, written], np.asarray(
            jcache[name])[:, written], **TOL)


def test_make_kv_cache_shapes_and_dtypes():
    from spacer_tpu.models.qwen25_vl.model import make_kv_cache as jax_make_cache
    from spacer_tpu_torch.models.qwen25_vl import make_kv_cache

    for arch in ARCHS:
        cfg = tiny_config(arch=arch)
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            ref = jax_make_cache(cfg, 3, 20, jdt)
            got = make_kv_cache(cfg, 3, 20, tdt)
            for name in ("k", "v"):
                assert len(got[name]) == ref[name].shape[0]
                for t in got[name]:
                    assert tuple(t.shape) == ref[name].shape[1:]
                    assert t.dtype == tdt and not bool(t.any())
    assert make_kv_cache(cfg, 1, 4)["k"][0].dtype == torch.bfloat16


# -- the non-causal LM -----------------------------------------------------------


def _text_rows(cfg, B=2, S=16, pad=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, cfg.text.vocab_size, (B, S))
    mask = np.ones((B, S), bool)
    mask[1, :pad] = False
    pos = np.broadcast_to(np.maximum(np.cumsum(mask, 1) - 1, 0)[None],
                          (3, B, S))
    return ids, mask, np.ascontiguousarray(pos)


def test_lm_forward_non_causal_matches_jax(qwen):
    """causal=False: logits and every parameter's gradient of a loss over
    the live rows; with a cache, every query sees the whole cache under
    kv_mask."""
    from spacer_tpu.models.qwen25_vl.language import (
        init_kv_cache as jax_init_cache,
        lm_forward as jax_lm_forward,
    )
    from spacer_tpu_torch.models.qwen25_vl.language import (
        init_kv_cache,
        lm_forward,
    )
    from spacer_tpu_torch.train.step import param_leaves

    cfg, params, np_params, tparams = qwen
    ids, mask, pos = _text_rows(cfg)
    w = np.random.default_rng(1).normal(
        size=(*ids.shape, cfg.text.vocab_size)).astype(np.float32)
    w[~mask] = 0.0

    def jloss(model):
        out, _ = jax_lm_forward(model, cfg.text, input_ids=jnp.asarray(ids),
                                position_ids=jnp.asarray(pos),
                                kv_mask=jnp.asarray(mask), causal=False)
        return jnp.sum(jnp.tanh(out) * w), out

    with jax.default_matmul_precision("highest"):
        (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            params["model"])
    model = params_from_jax(np_params, cfg)["model"]
    named = param_leaves(model)
    for _, t in named:
        t.requires_grad_(True)
    kw = dict(input_ids=_t(ids).long(), position_ids=_t(pos).long(),
              kv_mask=_t(mask))
    out, _ = lm_forward(model, cfg.text, causal=False, **kw)
    grads = torch.autograd.grad((torch.tanh(out) * _t(w)).sum(),
                                [t for _, t in named])
    np.testing.assert_allclose(out.detach().numpy()[mask],
                               np.asarray(ref)[mask], **TOL)
    causal, _ = lm_forward(tparams["model"], cfg.text, **kw)
    assert not np.allclose(causal.detach().numpy()[mask],
                           out.detach().numpy()[mask], atol=1e-3)
    jflat = [t.detach().numpy() for _, t in param_leaves(
        params_from_jax(jax.tree.map(np.asarray, {"model": jgrads,
                                                  "visual": np_params[
                                                      "visual"]}),
                        cfg)["model"])]
    for (name, _), g, want in zip(named, grads, jflat):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-4, rtol=1e-3,
                                   err_msg=name)

    # a cache: the prompt written at 0, then 3 tokens at S that see it all
    B, S = ids.shape
    T = S + 3
    kv = np.concatenate([mask, np.ones((B, 3), bool)], 1)
    more = np.random.default_rng(4).integers(10, cfg.text.vocab_size, (B, 3))
    pos2 = np.ascontiguousarray(np.broadcast_to(
        (pos[0, :, -1:] + 1 + np.arange(3)[None])[None], (3, B, 3)))
    jcache = jax_init_cache(cfg.text, B, T, jnp.float32)
    cache = init_kv_cache(cfg.text, B, T, torch.float32)
    with torch.no_grad():
        for x, p, at in ((ids, pos, 0), (more, pos2, S)):
            ref, jcache = jax_lm_forward(
                params["model"], cfg.text, input_ids=jnp.asarray(x),
                position_ids=jnp.asarray(p), kv_mask=jnp.asarray(kv),
                causal=False, cache=jcache, cache_index=at)
            got, cache = lm_forward(
                tparams["model"], cfg.text, input_ids=_t(x).long(),
                position_ids=_t(p).long(), kv_mask=_t(kv), causal=False,
                cache=cache, cache_index=at)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_pipeline_non_causal_at_a_pipe_of_one(qwen):
    """pipeline_lm_forward(causal=False) on a mesh of one: logits and
    gradients bitwise lm_forward(causal=False) under the same remat, and
    the logits within TOL of JAX's non-causal LM."""
    from spacer_tpu.models.qwen25_vl.language import (
        lm_forward as jax_lm_forward,
    )
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
    from spacer_tpu_torch.parallel.mesh import Mesh
    from spacer_tpu_torch.parallel.pipeline import pipeline_lm_forward
    from spacer_tpu_torch.train.step import param_leaves

    cfg, params, np_params, _ = qwen
    ids, mask, pos = _text_rows(cfg, B=4, seed=2)
    model = params_from_jax(np_params, cfg)["model"]
    leaves = [t for _, t in param_leaves(model)]
    for t in leaves:
        t.requires_grad_(True)
    kw = dict(input_ids=_t(ids).long(), position_ids=_t(pos).long(),
              kv_mask=_t(mask), causal=False)
    want = lm_forward(model, cfg.text, remat=True, **kw)[0]
    got = pipeline_lm_forward(model, cfg.text, Mesh({"pipe": 1}, 0),
                              num_microbatches=1, **kw)
    assert torch.equal(got, want)
    ga = torch.autograd.grad(want.square().mean(), leaves)
    gb = torch.autograd.grad(got.square().mean(), leaves)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    ref, _ = jax_lm_forward(params["model"], cfg.text,
                            input_ids=jnp.asarray(ids),
                            position_ids=jnp.asarray(pos),
                            kv_mask=jnp.asarray(mask), causal=False)
    np.testing.assert_allclose(got.detach().numpy()[mask],
                               np.asarray(ref)[mask], **TOL)


# -- lm_decode_step ---------------------------------------------------------------


def _decode_inputs(cfg, B=2, G=2, P=12, T=6, tail_index=3, seed=0):
    tc = cfg.text
    L, Hkv, Dh = tc.num_layers, tc.num_kv_heads, tc.head_dim
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    N = B * G
    prefix = {"k": mk(L, B, P, Hkv, Dh), "v": mk(L, B, P, Hkv, Dh)}
    tail = {"k": mk(L, N, T, Hkv, Dh), "v": mk(L, N, T, Hkv, Dh)}
    pmask = np.ones((B, P), bool)
    pmask[1, :4] = False
    tmask = np.broadcast_to(np.arange(T)[None] <= tail_index, (N, T))
    ids = rng.integers(10, tc.vocab_size, (N, 1))
    pos = np.broadcast_to((P + tail_index + np.arange(N))[None, :, None],
                          (3, N, 1)).copy()
    return prefix, tail, pmask, np.ascontiguousarray(tmask), ids, pos


def test_lm_decode_step_matches_jax(qwen):
    """Stacked position-major caches (the layout init_kv_cache holds): the
    logits and the new tail against JAX's lm_decode_step; a list of
    per-layer tensors gives the same result as stacked ones; a tail mask
    that is not the live prefix raises."""
    from spacer_tpu.models.qwen25_vl.language import (
        lm_decode_step as jax_step,
    )
    from spacer_tpu_torch.models.qwen25_vl.language import lm_decode_step

    cfg, params, _, tparams = qwen
    prefix, tail, pmask, tmask, ids, pos = _decode_inputs(cfg)
    G, ti = 2, 3
    ref, jtail = jax_step(params["model"], cfg.text, jnp.asarray(ids),
                          jnp.asarray(pos),
                          {k: jnp.asarray(v) for k, v in prefix.items()},
                          jnp.asarray(pmask),
                          {k: jnp.asarray(v) for k, v in tail.items()},
                          jnp.asarray(tmask), ti, group=G)
    args = (tparams["model"], cfg.text, _t(ids).long(), _t(pos).long())
    stacked = lm_decode_step(
        *args, {k: _t(v) for k, v in prefix.items()}, _t(pmask),
        {k: _t(v) for k, v in tail.items()}, _t(tmask), ti, G)
    listed = lm_decode_step(
        *args, {k: list(_t(v).unbind(0)) for k, v in prefix.items()},
        _t(pmask), {k: list(_t(v).unbind(0)) for k, v in tail.items()},
        _t(tmask), ti, G)
    logits, new = stacked
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(),
                                   np.asarray(jtail[name]), **TOL)
        assert torch.equal(torch.stack(listed[1][name]), new[name])
    assert torch.equal(listed[0], logits)
    # the caller's tail is not written: the new one comes back
    np.testing.assert_array_equal(tail["k"], tail["k"].copy())
    bad = tmask.copy()
    bad[0, 0] = False
    with pytest.raises(ValueError, match="tail_mask"):
        lm_decode_step(*args, {k: _t(v) for k, v in prefix.items()},
                       _t(pmask), {k: _t(v) for k, v in tail.items()},
                       _t(bad), ti, G)


def test_lm_decode_step_int8_matches_jax(qwen):
    """int8 caches (codes and f32 scales, "k_scale" / "v_scale"): the
    logits against JAX's lm_decode_step_split on the same codes; the new
    tail's codes within one step of JAX's quantisation and its scales
    within TOL."""
    from spacer_tpu.models.qwen25_vl.language import (
        lm_decode_step_split as jax_split_step,
        split_layers as jax_split_layers,
    )
    from spacer_tpu.ops.quant import quantize_kv as jax_quantize_kv
    from spacer_tpu_torch.models.qwen25_vl.language import lm_decode_step

    cfg, params, _, tparams = qwen
    prefix, tail, pmask, tmask, ids, pos = _decode_inputs(cfg, seed=1)
    G, ti, L = 2, 3, cfg.text.num_layers

    def q8(cache):
        (kq, ks), (vq, vs) = (jax_quantize_kv(jnp.asarray(cache[n]))
                              for n in ("k", "v"))
        return {"k": np.asarray(kq), "v": np.asarray(vq),
                "k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}

    pq, tq = q8(prefix), q8(tail)
    entries = lambda c: tuple(  # noqa: E731
        tuple(jnp.asarray(c[n][l]) for n in ("k", "v", "k_scale", "v_scale"))
        for l in range(L))
    model = params["model"]
    ref, jtail = jax_split_step(
        jax_split_layers(model["layers"], L), model, cfg.text,
        jnp.asarray(ids), jnp.asarray(pos), entries(pq), jnp.asarray(pmask),
        entries(tq), jnp.asarray(tmask), ti, G)
    logits, new = lm_decode_step(
        tparams["model"], cfg.text, _t(ids).long(), _t(pos).long(),
        {k: _t(v) for k, v in pq.items()}, _t(pmask),
        {k: _t(v) for k, v in tq.items()}, _t(tmask), ti, G)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    assert new["k"].dtype == torch.int8 and new["k_scale"].dtype == \
        torch.float32
    for i, name in enumerate(("k", "v", "k_scale", "v_scale")):
        want = np.stack([np.asarray(e[i]) for e in jtail])
        got = new[name].numpy()
        if i < 2:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
            assert (got != want).mean() < 0.01, name
        else:
            np.testing.assert_allclose(got, want, **TOL)


# -- apply_mrope, window_attention ------------------------------------------------


def test_apply_mrope_matches_jax():
    from spacer_tpu.nn.rope import apply_mrope as jax_apply_mrope
    from spacer_tpu.nn.rope import rope_inv_freq as jax_inv_freq
    from spacer_tpu_torch.nn.rope import apply_mrope, rope_inv_freq

    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 2, 9, 4, 2, 32
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    pos = rng.integers(0, 40, (3, B, S))
    section = (4, 6, 6)
    jq, jk = jax_apply_mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                             jax_inv_freq(D, 10000.0), section)
    tq, tk = apply_mrope(_t(q), _t(k), _t(pos), rope_inv_freq(D, 10000.0),
                         section)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    assert tq.shape == (B, S, H, D) and tk.shape == (B, S, Hkv, D)


@pytest.mark.parametrize("D", [80, 64])
def test_window_attention_matches_jax(D):
    """Forward and the gradients of q, k and v (JAX: its Pallas kernel in
    interpret mode, the VJP through its XLA reference); make_window_
    attention binds the same function."""
    from spacer_tpu.ops.vit_window_attention import (
        window_attention as jax_window_attention,
    )
    from spacer_tpu_torch.ops.vit_window_attention import (
        make_window_attention,
        window_attention,
    )

    wt, H = 16, 2
    lengths = (16, 10, 16, 5)
    S = wt * len(lengths)
    rng = np.random.default_rng(D)
    q, k, v = (rng.normal(size=(S, H, D)).astype(np.float32)
               for _ in range(3))
    w = rng.normal(size=(S, H, D)).astype(np.float32)
    valid = (np.arange(wt)[None] < np.array(lengths)[:, None]).reshape(-1)

    def jloss(q, k, v):
        out = jax_window_attention(q, k, v, lengths, wt=wt, interpret=True)
        return jnp.sum(out * w), out

    (_, ref), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = window_attention(tq, tk, tv, lengths, wt=wt)
    grads = torch.autograd.grad((out * _t(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy()[valid],
                               np.asarray(ref)[valid], **TOL)
    for name, g, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"d{name}")
    bound = make_window_attention(lengths, wt, D ** -0.5)
    assert torch.equal(bound(tq, tk, tv), out)


# -- Sampler.generate(vision_embeds=) ---------------------------------------------


def test_generate_with_vision_embeds_matches_jax(qwen):
    """Precomputed vision embeddings passed through: greedy tokens equal
    JAX's, and equal the pixels' own run; refused under a mesh."""
    from spacer_tpu.models.qwen25_vl import encode_vision as jax_encode
    from spacer_tpu.sampler import Sampler as JaxSampler
    from spacer_tpu_torch.parallel.mesh import Mesh
    from spacer_tpu_torch.sampler import Sampler

    cfg, params, _, tparams = qwen
    ids, mask, pos, deltas, px = _video_rows(cfg)
    ids, mask, pos, deltas = ids[:1], mask[:1], pos[:, :1], deltas[:1]
    ve = np.asarray(jax_encode(params, cfg, jnp.asarray(px), [GRID],
                               attn_impl="xla"))
    kw = dict(position_ids=pos, deltas=deltas, num_generations=2,
              max_new_tokens=8, temperature=0.0, top_p=1.0, seed=0)
    ref = JaxSampler(cfg, length_bucket=64, decode_impl="flash_ref").generate(
        ids, mask, params, vision_embeds=jnp.asarray(ve), **kw)
    sampler = Sampler(cfg, length_bucket=64)
    out = sampler.generate(ids, mask, tparams, vision_embeds=ve, **kw)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    own = sampler.generate(ids, mask, tparams, pixel_values=px,
                           grid_thw=(GRID,), **kw)
    np.testing.assert_array_equal(out.sequences, own.sequences)
    with pytest.raises(ValueError, match="single-process"):
        Sampler(cfg, mesh=Mesh({"fsdp": 2}, 0)).generate(
            ids, mask, tparams, vision_embeds=ve, **kw)


# -- training ---------------------------------------------------------------------


def _grpo_batch(cfg, P_LEN=48, C=12, G=4, seed=0):
    """The shared-prefix batch of tests/test_torch_train_step.py (one video
    prompt, G completions) and its packed form."""
    grid = (2, 8, 8)
    rng = np.random.default_rng(seed)
    n_video = (2 * 8 * 8) // 4
    prompt = ([10, 11, cfg.vision_start_token_id]
              + [cfg.video_token_id] * n_video
              + [cfg.vision_end_token_id, 20, 21])
    pad = P_LEN - len(prompt)
    prompt_ids = np.array([[cfg.pad_token_id] * pad + prompt])
    prompt_mask = np.array([[0] * pad + [1] * len(prompt)])
    pos, deltas = get_rope_index(cfg, prompt_ids, video_grid_thw=np.array(
        [grid]), attention_mask=prompt_mask)
    comp = rng.integers(10, cfg.text.vocab_size, size=(G, C))
    comp_mask = np.ones((G, C), np.int64)
    comp_mask[:, C - 3:] = rng.integers(0, 2, size=(G, 3))
    comp_pos = np.broadcast_to((deltas.reshape(-1, 1) + P_LEN
                                + np.arange(C)[None])[None], (3, G, C))
    adv = rng.normal(size=(G,)).astype(np.float32)
    px = rng.normal(size=(2 * 8 * 8, cfg.vision.patch_dim)).astype(np.float32)
    shared = {"prompt_ids": prompt_ids, "prompt_mask": prompt_mask,
              "prompt_position_ids": np.asarray(pos), "completion_ids": comp,
              "completion_position_ids": comp_pos,
              "completion_mask": comp_mask, "advantages": adv,
              "pixel_values": px}
    packed = {
        "input_ids": np.concatenate([np.repeat(prompt_ids, G, 0), comp], 1),
        "position_ids": np.concatenate([np.repeat(pos, G, 1), comp_pos], 2),
        "kv_mask": np.concatenate([np.repeat(prompt_mask, G, 0), comp_mask],
                                  1).astype(bool),
        "completion_mask": comp_mask, "advantages": adv, "pixel_values": px}
    return shared, packed, (grid,), G, P_LEN


def _torch(batch):
    out = {k: _t(v) for k, v in batch.items()}
    for k, v in out.items():
        if k not in ("advantages", "pixel_values", "kv_mask"):
            out[k] = v.long()
    return out


def test_grpo_step_without_vision_encode_matches_jax(qwen):
    """encode_vision_in_step=False: the placeholders keep their token
    embeddings in both packages; loss, kl, grad_norm and the updated params
    against JAX's step, the ViT's gradients zero."""
    from spacer_tpu.train.optimizer import make_optimizer as jax_make_opt
    from spacer_tpu.train.step import make_grpo_train_step as jax_make_step
    from spacer_tpu_torch.train import step as tstep
    from spacer_tpu_torch.train.optimizer import make_optimizer

    cfg, _, np_params, _ = qwen
    shared, _, grid, G, P_LEN = _grpo_batch(cfg)
    opt_kw = dict(learning_rate=1e-3, total_steps=10, eps=1e-6,
                  moment_dtype="float32")
    jtx = jax_make_opt(**opt_kw)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstep = jax_make_step(cfg, jtx, beta=0.04, remat=False, logp_chunk=8,
                          encode_vision_in_step=False)
    jb = {k: jnp.asarray(v) for k, v in shared.items()}
    with jax.default_matmul_precision("highest"):
        jnew, _, jm = jstep(jparams, jax.tree.map(jnp.asarray, np_params),
                            jtx.init(jparams), jb,
                            grid_thw=grid, num_generations=G,
                            prompt_len=P_LEN)
    tx = make_optimizer(**opt_kw)
    params = params_from_jax(np_params, cfg)
    ref = params_from_jax(np_params, cfg)
    named = tstep.param_leaves(params)
    state = tx.init([t for _, t in named], [n for n, _ in named])
    step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=False,
                                      logp_chunk=8,
                                      encode_vision_in_step=False)
    tb = _torch(shared)
    _, _, grads = step.loss_and_grads(
        params, step.ref_logps_fn(ref, tb, grid, G), tb, grid_thw=grid,
        num_generations=G)
    for (name, _), g in zip(named, grads):
        if name.startswith("visual/"):
            assert not bool(g.any()), name
    params, _, m = step(params, ref, state, tb, grid_thw=grid,
                        num_generations=G)
    for key in ("loss", "kl", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    want = tstep.param_leaves(params_from_jax(jax.tree.map(np.asarray, jnew),
                                              cfg))
    for (name, t), (_, w) in zip(tstep.param_leaves(params), want):
        np.testing.assert_allclose(t.detach().numpy(), w.numpy(), atol=5e-6,
                                   err_msg=name)
    with_vision = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=False,
                                             logp_chunk=8)
    assert not torch.equal(step.ref_logps_fn(ref, tb, grid, G),
                           with_vision.ref_logps_fn(ref, tb, grid, G))


def test_lora_step_with_the_ring_at_a_world_of_one(qwen):
    """make_lora_grpo_train_step(attn_impl=("ring", mesh, "fsdp")) on the
    packed batch over a mesh of one: the loss bitwise the plain LoRA
    step's (the ring's forward at one rank is the plain attention), the
    adapters after the step within 5e-6 of it (its backward is written out
    from the statistics, the plain one is autograd) and of JAX's ring LoRA
    step on a one-device mesh."""
    from spacer_tpu.parallel import create_mesh as jax_create_mesh
    from spacer_tpu.train.lora import LoraConfig as JaxLoraConfig
    from spacer_tpu.train.lora import init_lora_params as jax_init_lora
    from spacer_tpu.train.lora import (
        make_lora_grpo_train_step as jax_lora_step,
    )
    from spacer_tpu.train.optimizer import make_optimizer as jax_make_opt
    from spacer_tpu_torch.parallel.mesh import Mesh
    from spacer_tpu_torch.train.lora import (
        LoraConfig,
        lora_leaves,
        make_lora_grpo_train_step,
    )
    from spacer_tpu_torch.train.optimizer import make_optimizer
    from spacer_tpu_torch.train.step import param_leaves

    cfg, params, np_params, _ = qwen
    _, packed, grid, G, P_LEN = _grpo_batch(cfg)
    jlcfg = JaxLoraConfig(r=4)
    jlora = jax_init_lora(jax.random.key(1), params, jlcfg)
    attn = jlora["model"]["layers"]["self_attn"]
    projs = ("q", "k", "v", "o")
    for p in projs:
        kb = attn[f"{p}_proj"]["kernel"]
        kb["b"] = jnp.asarray(np.random.default_rng(2).normal(
            size=kb["b"].shape).astype(np.float32) * 0.05)
    opt_kw = dict(learning_rate=1e-3, total_steps=10, eps=1e-6,
                  moment_dtype="float32")
    # the JAX step donates its adapters: keep them as numpy first
    start = {(p, k): np.asarray(attn[f"{p}_proj"]["kernel"][k]).copy()
             for p in projs for k in ("a", "b")}
    jtx = jax_make_opt(**opt_kw)
    jmesh = jax_create_mesh({"data": 1, "fsdp": 1, "tp": 1},
                            devices=jax.devices()[:1])
    jstep = jax_lora_step(cfg, jtx, jlcfg, beta=0.04, remat=True,
                          attn_impl=("ring", jmesh, "fsdp"), logp_chunk=8)
    with jax.default_matmul_precision("highest"):
        jlora2, _, jm = jstep(params, jlora, jtx.init(jlora),
                              {k: jnp.asarray(v) for k, v in packed.items()},
                              grid_thw=grid, num_generations=G,
                              prompt_len=P_LEN)
    jattn = jlora2["model"]["layers"]["self_attn"]
    runs = {}
    for name, impl in (("plain", None),
                       ("ring", ("ring", Mesh({"fsdp": 1}, 0), "fsdp"))):
        tparams = params_from_jax(np_params, cfg)
        lora = {f"model/layers/{l}/self_attn/{p}_proj/kernel": {
            k: _t(start[p, k][l].copy())
            for k in ("a", "b")}
            for l in range(cfg.text.num_layers) for p in projs}
        tx = make_optimizer(**opt_kw)
        leaves = lora_leaves(lora)
        state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
        step = make_lora_grpo_train_step(cfg, tx, LoraConfig(r=4), beta=0.04,
                                         remat=True, attn_impl=impl,
                                         logp_chunk=8)
        before = [t.clone() for _, t in param_leaves(tparams)]
        lora, _, m = step(tparams, lora, state, _torch(packed), grid_thw=grid,
                          num_generations=G)
        assert all(torch.equal(a, b) for a, (_, b) in
                   zip(before, param_leaves(tparams)))
        runs[name] = (lora, m)
    (plain, pm), (ring, rm) = runs["plain"], runs["ring"]
    assert float(pm["loss"]) == float(rm["loss"])
    for key in ("loss", "kl", "grad_norm"):
        np.testing.assert_allclose(float(rm[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-8, err_msg=key)
    for path, ab in ring.items():
        l, p = int(path.split("/")[2]), path.split("/")[4][0]
        for k in ("a", "b"):
            got = ab[k].detach().numpy()
            np.testing.assert_allclose(got, plain[path][k].detach().numpy(),
                                       atol=5e-6, err_msg=f"{path} {k}")
            np.testing.assert_allclose(
                got, np.asarray(jattn[f"{p}_proj"]["kernel"][k][l]),
                atol=5e-6, err_msg=f"{path} {k} vs JAX")
    with pytest.raises(ValueError, match="attn_impl"):
        make_lora_grpo_train_step(cfg, make_optimizer(), LoraConfig(r=4),
                                  attn_impl="xla")


def test_sft_config_keeps_attn_impl_and_refuses_the_jax_strings():
    from spacer_tpu.train.sft_trainer import SFTConfig as JaxSFTConfig
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.models.qwen25_vl import tiny_config as t_tiny
    from spacer_tpu_torch.train.sft_trainer import SFTConfig, SFTTrainer

    assert SFTConfig().attn_impl is None is JaxSFTConfig().attn_impl
    cfg = t_tiny()
    params = init_params(cfg, seed=0)
    for impl in ("xla", "pallas"):
        with pytest.raises(NotImplementedError, match="attn_impl"):
            SFTTrainer(cfg, params, None, [], SFTConfig(attn_impl=impl,
                                                        max_steps=1))
    assert SFTTrainer(cfg, params, None, [], SFTConfig(
        max_steps=1)).args.attn_impl is None


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_make_optimizer_schedule_matches_jax(schedule):
    """Four AdamW updates of the same params from the same gradients under
    each schedule: the params after every step equal JAX's (so do the
    learning rates); "constant" is the learning rate at every count; any
    other schedule raises ValueError in both packages."""
    from spacer_tpu.train.optimizer import make_optimizer as jax_make_opt
    from spacer_tpu_torch.train.optimizer import make_optimizer

    kw = dict(learning_rate=1e-2, total_steps=4, warmup_steps=0,
              weight_decay=0.01, max_grad_norm=1e9, moment_dtype="float32",
              schedule=schedule)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(6, 5)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    jtx = jax_make_opt(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jtx.init(jp)
    tx = make_optimizer(**kw, sr_impl="off")
    names = ["w", "b"]
    tp = [_t(p0[n].copy()) for n in names]
    state = tx.init(tp, names)
    for i in range(4):
        g = {n: rng.normal(size=p0[n].shape).astype(np.float32)
             for n in names}
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        state = tx.apply([_t(g[n]) for n in names], state, tp)
        for n, t in zip(names, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[n]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {n}")
    if schedule == "constant":
        assert [tx.schedule(c) for c in range(10)] == [1e-2] * 10
    else:
        assert tx.schedule(4) == 0.0 and tx.schedule(0) == 1e-2
    with pytest.raises(ValueError):
        jax_make_opt(schedule="linear")
    with pytest.raises(ValueError, match="schedule"):
        make_optimizer(schedule="linear")


# -- checkpoints, multihost, the engine protocol -----------------------------------


def _shard_like(tree, mesh):
    """Every 2-D tensor of a params tree as its fsdp Shard on `mesh`."""
    from spacer_tpu_torch.parallel.fsdp import Shard

    if isinstance(tree, dict):
        return {k: _shard_like(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shard_like(v, mesh) for v in tree]
    return Shard.from_full(tree, mesh) if tree.dim() == 2 else tree


def test_load_model_only_round_trip(tmp_path):
    """save_model_only -> load_model_only: the full tree on the CPU
    bitwise; onto plain tensors; onto fsdp Shards of another world (rank 1
    of fsdp 2) each rank's blocks, bitwise those of the saved params."""
    from spacer_tpu_torch.models.qwen25_vl import init_params
    from spacer_tpu_torch.models.qwen25_vl import tiny_config as t_tiny
    from spacer_tpu_torch.parallel.fsdp import Shard
    from spacer_tpu_torch.parallel.mesh import Mesh
    from spacer_tpu_torch.train.checkpoint import (
        load_model_only,
        save_model_only,
    )
    from spacer_tpu_torch.train.step import param_leaves

    cfg = t_tiny()
    params = init_params(cfg, seed=3, dtype=torch.bfloat16)
    path = save_model_only(str(tmp_path / "model"), params)
    saved = [t for _, t in param_leaves(params)]
    for like in (None, init_params(cfg, seed=9, dtype=torch.bfloat16)):
        got = [t for _, t in param_leaves(load_model_only(path, like))]
        assert len(got) == len(saved)
        assert all(torch.equal(a, b) and a.device.type == "cpu"
                   for a, b in zip(got, saved))
    mesh = Mesh({"fsdp": 2}, 1)
    like = _shard_like(init_params(cfg, seed=9, dtype=torch.bfloat16), mesh)
    loaded = load_model_only(path, like)
    want = _shard_like(params, mesh)
    n_shards = 0

    def walk(a, b):
        nonlocal n_shards
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert isinstance(a, Shard) == isinstance(b, Shard)
            if isinstance(a, Shard):
                n_shards += 1
                assert a.mesh is mesh and a.shape == b.shape
                assert torch.equal(a.data, b.data)
            else:
                assert torch.equal(a, b)

    walk(loaded, want)
    assert n_shards > 0


def _multihost_worker(rank, out_dir):
    """One rank of a gloo world over a data axis: replicate_to_mesh and
    global_batch_from_local over ("data",) and ("data", "fsdp")."""
    import pickle

    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh({"data": multihost.process_count()})
    local = {"input_ids": np.full((1, 3), rank, np.int32),
             "n": np.int32(10 + rank)}
    res = {"replicated": multihost.replicate_to_mesh(
        np.arange(12, dtype=np.float32).reshape(3, 4), mesh)}
    for axes in (("data",), ("data", "fsdp")):
        res[axes] = multihost.global_batch_from_local(local, mesh,
                                                      batch_axes=axes)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


@pytest.mark.parametrize("world", [1, 2])
def test_replicate_to_mesh_and_batch_axes(tmp_path, world):
    """In a gloo world replicate_to_mesh puts the value on the CPU; rows
    that tile the batch axes stay this rank's, a 0-d value is rank 0's on
    every rank.  Without a process group the value goes to CUDA where
    there is a card, else the CPU, and the local batch is the global one
    whatever the axes."""
    import pickle

    from spacer_tpu_torch.parallel import multihost
    from spacer_tpu_torch.parallel.mesh import Mesh

    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    multihost.launch_local(_multihost_worker, world, args=(str(tmp_path),),
                           device="cpu", timeout=120, threads=1)
    for rank in range(world):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            res = pickle.load(f)
        got = res["replicated"]
        assert got.device.type == "cpu", (rank, got.device)
        np.testing.assert_array_equal(got.numpy(), x)
        for axes in (("data",), ("data", "fsdp")):
            np.testing.assert_array_equal(res[axes]["input_ids"],
                                          np.full((1, 3), rank),
                                          err_msg=f"rank {rank} {axes}")
            assert int(res[axes]["n"]) == 10, (rank, axes, res[axes]["n"])
    mesh = Mesh({"data": 2, "fsdp": 2}, 0)
    got = multihost.replicate_to_mesh(x, mesh)
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert got.device.type == want
    np.testing.assert_array_equal(got.cpu().numpy(), x)
    batch = {"input_ids": np.ones((2, 5), np.int32)}
    for axes in (("data", "fsdp"), ("data",), ("fsdp",)):
        assert multihost.global_batch_from_local(
            batch, mesh, batch_axes=axes) is batch


def test_engines_satisfy_the_protocol():
    import inspect

    from spacer_tpu.evalharness.engine import (
        InferenceEngine as JaxInferenceEngine,
    )
    from spacer_tpu_torch.evalharness.engine import (
        EchoEngine,
        InferenceEngine,
        QwenEngine,
    )

    assert isinstance(EchoEngine(), InferenceEngine)
    assert issubclass(QwenEngine, InferenceEngine)
    assert not isinstance(object(), InferenceEngine)
    want = inspect.signature(JaxInferenceEngine.generate)
    got = inspect.signature(InferenceEngine.generate)
    assert list(got.parameters) == list(want.parameters)
    for cls in (EchoEngine, QwenEngine):
        params = inspect.signature(cls.generate).parameters
        assert {"messages_list", "max_new_tokens", "temperature"} <= set(
            params)
    assert EchoEngine().generate([[{"role": "user", "content": "q"}]],
                                 max_new_tokens=4, temperature=0.0) == [
        "<answer>A</answer>"]

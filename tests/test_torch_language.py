"""LM parity: spacer_tpu_torch lm_forward (prefill into a KV cache, left
padding, M-RoPE positions) and the ragged decode step against spacer_tpu on
converted weights.

Tolerance 1e-4 abs/rel in float32: two decoder layers of matmuls, norms and
attention accumulate the per-op ~1e-6 summation-order differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu.models.qwen25_vl.language import (
    init_kv_cache as jax_init_kv_cache,
    lm_forward as jax_lm_forward,
    split_layers as jax_split_layers,
)
from spacer_tpu.serving.ragged import ragged_decode_step as jax_ragged_step
from spacer_tpu_torch.models.qwen25_vl import get_rope_index, params_from_jax
from spacer_tpu_torch.models.qwen25_vl.language import init_kv_cache, lm_forward
from spacer_tpu_torch.serving.ragged import ragged_decode_step

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(1), cfg, jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


def test_prefill_logits_and_cache_match_jax(model):
    cfg, params, tparams = model
    B, S, T, pad = 2, 24, 32, 5
    rng = np.random.default_rng(0)
    ids = rng.integers(10, cfg.text.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, :pad] = 0
    ids[1, :pad] = cfg.pad_token_id
    pos, _ = get_rope_index(cfg, ids, attention_mask=mask)
    full_mask = np.concatenate([mask, np.zeros((B, T - S), np.int32)], 1)

    jlogits, jcache = jax_lm_forward(
        params["model"], cfg.text, input_ids=jnp.asarray(ids),
        position_ids=jnp.asarray(pos), kv_mask=jnp.asarray(full_mask, bool),
        cache=jax_init_kv_cache(cfg.text, B, T, jnp.float32), cache_index=0)
    cache = init_kv_cache(cfg.text, B, T, torch.float32)
    logits, cache = lm_forward(
        tparams["model"], cfg.text, input_ids=torch.from_numpy(ids).long(),
        position_ids=torch.from_numpy(pos), kv_mask=torch.from_numpy(full_mask).bool(),
        cache=cache, cache_index=0)
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits[0].numpy(), jlogits[0], **TOL)
    np.testing.assert_allclose(logits[1, pad:].numpy(), jlogits[1, pad:], **TOL)
    for name in ("k", "v"):
        got = torch.stack(cache[name]).numpy()
        np.testing.assert_allclose(got, np.asarray(jcache[name]), **TOL)

    last, _ = lm_forward(tparams["model"], cfg.text,
                         input_ids=torch.from_numpy(ids).long(),
                         position_ids=torch.from_numpy(pos),
                         kv_mask=torch.from_numpy(mask).bool(), last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), jlogits[:, S - 1], **TOL)


def test_ragged_decode_step_matches_jax(model):
    cfg, params, tparams = model
    tc = cfg.text
    R, P, C = 3, 16, 8
    L, Hkv, Dh = tc.num_layers, tc.num_kv_heads, tc.head_dim
    rng = np.random.default_rng(1)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    caches = [tuple(mk(R, Hkv, n, Dh) for n in (P, P, C, C)) for _ in range(L)]
    cur = rng.integers(10, tc.vocab_size, R).astype(np.int32)
    pos3 = np.broadcast_to(np.array([P + 3, P + 1, P + 6])[None, :, None],
                           (3, R, 1)).astype(np.int32)
    pmask = np.arange(P)[None] >= np.array([0, 6, P])[:, None]   # row 2 empty
    admit, t, clock = np.array([3, 9, 0]), np.array([4, 2, 0]), 10
    rel = np.mod(np.arange(C)[None] - admit[:, None], C)
    rmask = rel < t[:, None]

    other = {k: v for k, v in params["model"].items() if k != "layers"}
    jlogits, jnew = jax_ragged_step(
        jax_split_layers(params["model"]["layers"], L), other, tc,
        jnp.asarray(cur), jnp.asarray(pos3),
        tuple(tuple(jnp.asarray(a) for a in e) for e in caches),
        clock % C, jnp.asarray(pmask), jnp.asarray(rmask), head_major=True)
    tcaches = [tuple(torch.from_numpy(a.copy()) for a in e) for e in caches]
    logits = ragged_decode_step(
        tparams["model"]["layers"], tparams["model"], tc,
        torch.from_numpy(cur).long(), torch.from_numpy(pos3), tcaches,
        clock % C, torch.from_numpy(pmask), torch.from_numpy(rmask))
    live = pmask.any(1) | rmask.any(1)
    assert live.tolist() == [True, True, False]
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(jlogits)[live],
                               **TOL)
    assert np.isfinite(logits.numpy()).all()
    for (tk, tv), jentry in ((e[2:], je) for e, je in zip(tcaches, jnew)):
        np.testing.assert_allclose(tk[live].numpy(), np.asarray(jentry[2])[live],
                                   **TOL)
        np.testing.assert_allclose(tv[live].numpy(), np.asarray(jentry[3])[live],
                                   **TOL)

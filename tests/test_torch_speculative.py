"""Speculative serving (serving/speculative.py) in spacer_tpu_torch against
spacer_tpu's, at tiny size in float32 on the CPU.

- spec_decode_step: logits against JAX's to 1e-4 (f32, summation order
  only) with the caches converted between JAX's position-major and the
  port's head-major layout, and the block's cache writes equal.
- _build_drafts: equal to JAX's exactly (integer code).
- ContinuousBatcher(speculate_k): greedy tokens equal to the port's own
  sequential (clock-ring) run and to JAX's speculative run, token for
  token, with refill (more requests than slots), rows that run to the full
  budget, and decode_quant int8 / int8_kv / int4_kv.
- _speculative_sample: exact in distribution, by the statistics of JAX's
  test_speculative_sample_is_exact and _multi_draft_chain (5-sigma
  binomial bounds).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu.models.qwen25_vl.language import split_layers
from spacer_tpu.serving import ContinuousBatcher as JaxBatcher
from spacer_tpu.serving import speculative as jspec
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
from spacer_tpu_torch.serving import ContinuousBatcher
from spacer_tpu_torch.serving import speculative as tspec


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(0), cfg, jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


def _req(cfg, S, seed):
    r = np.random.RandomState(seed)
    return {
        "input_ids": r.randint(10, cfg.text.vocab_size, size=(1, S)).astype(
            np.int32),
        "attention_mask": np.ones((1, S), np.int32),
        "position_ids": np.broadcast_to(
            np.arange(S)[None, None], (3, 1, S)).astype(np.int32),
        "deltas": np.zeros((1, 1), np.int32),
    }


def _run(cls, cfg, params, reqs, **kw):
    base = dict(slots=2, prompt_len=16, max_new_tokens=24, eos_token_id=11,
                temperature=0.0, chunk_steps=4)
    base.update(kw)
    if cls is JaxBatcher:
        base["dtype"] = jnp.float32
    b = cls(cfg, params, **base)
    return b, b.run(copy.deepcopy(reqs))


def _tokens(outs):
    return [list(np.asarray(o.sequences[:o.length])) for o in outs]


@pytest.mark.parametrize("quant", [None, "int8_kv"])
def test_spec_decode_step_logits_match_jax(models, quant):
    """One block step over random caches, ragged t (a row at t = 1, a row
    whose block runs past the tail's end): logits to 1e-4, the tail writes
    equal (codes exactly, values to 1e-5)."""
    cfg, params, tparams = models
    tc = cfg.text
    R, P, C, kb = 3, 8, 6, 4
    Hkv, Dh = tc.num_kv_heads, tc.head_dim
    rng = np.random.default_rng(0)
    t = np.array([1, 3, 5])
    toks = rng.integers(10, tc.vocab_size, (R, kb))
    pos3 = np.broadcast_to((P + t - 1)[:, None] + np.arange(kb), (3, R, kb))
    pmask = np.ones((R, P), bool)
    pmask[1, :3] = False
    caches_pm = []   # position-major, JAX's layout
    for _ in range(tc.num_layers):
        pk, pv = (rng.normal(size=(R, P, Hkv, Dh)).astype(np.float32)
                  for _ in range(2))
        tk, tv = (rng.normal(size=(R, C, Hkv, Dh)).astype(np.float32)
                  for _ in range(2))
        if quant:
            entry = [np.clip(np.round(x * 40), -127, 127).astype(np.int8)
                     for x in (pk, pv, tk, tv)]
            entry += [rng.uniform(0.01, 0.03, x.shape[:-1]).astype(np.float32)
                      for x in (pk, pv, tk, tv)]
        else:
            entry = [pk, pv, tk, tv]
        caches_pm.append(entry)
    jlayers = split_layers(params["model"]["layers"], tc.num_layers)
    jother = {k: v for k, v in params["model"].items() if k != "layers"}
    jlogits, jnew = jspec.spec_decode_step(
        jlayers, jother, tc, jnp.asarray(toks, jnp.int32),
        jnp.asarray(pos3, jnp.int32),
        tuple(tuple(jnp.asarray(x) for x in e) for e in caches_pm),
        jnp.asarray(pmask), jnp.asarray(t, jnp.int32))

    def head_major(x):
        return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))

    caches = [tuple(head_major(x) for x in e) for e in caches_pm]
    reset_launch_counts()
    logits = tspec.spec_decode_step(
        tparams["model"]["layers"], tparams["model"], tc,
        torch.from_numpy(toks), torch.from_numpy(np.ascontiguousarray(pos3)),
        caches, torch.from_numpy(pmask), torch.from_numpy(t),
        torch.ones(R, dtype=torch.bool))
    assert set(launch_counts().values()) == {0}
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    for entry, jentry in zip(caches, jnew):
        for i in (2, 3) + ((6, 7) if quant else ()):
            got = np.swapaxes(entry[i].numpy(), 1, 2)
            want = np.asarray(jentry[i])
            if got.dtype == np.int8:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_drafts_matches_jax(seed):
    """Contexts with repeated n-grams, left padding and ragged t; drafts
    running off the known context."""
    rng = np.random.default_rng(seed)
    R, P, C, k = 6, 12, 10, 4
    pids = rng.integers(0, 6, (R, P))
    pmask = np.ones((R, P), bool)
    pmask[0, :4] = False
    pmask[3, :P - 1] = False
    out = rng.integers(0, 6, (R, C))
    t = np.array([1, 2, 5, 3, 10, 7])
    cur = out[np.arange(R), t - 1]
    want = np.asarray(jspec._build_drafts(
        jnp.asarray(pids, jnp.int32), jnp.asarray(pmask),
        jnp.asarray(out, jnp.int32), jnp.asarray(cur, jnp.int32),
        jnp.asarray(t, jnp.int32), k, 0))
    got = tspec._build_drafts(*(torch.from_numpy(x) for x in
                                (pids, pmask, out, cur, t)), k, 0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any()   # some lookup hit


def test_speculative_greedy_parity_with_refill(models):
    """Five requests through two slots: the speculative tokens equal the
    port's clock-ring run and JAX's speculative run; drafts are accepted
    (tokens per row-step > 1)."""
    cfg, params, tparams = models
    reqs = [_req(cfg, S, i) for i, S in enumerate([12, 16, 7, 16, 10])]
    _, plain = _run(ContinuousBatcher, cfg, tparams, reqs)
    b, spec = _run(ContinuousBatcher, cfg, tparams, reqs, speculate_k=3)
    _, jspec_out = _run(JaxBatcher, cfg, params, reqs, speculate_k=3)
    assert _tokens(spec) == _tokens(plain) == _tokens(jspec_out)
    stats = b.spec_stats
    assert 0 < stats["steps"] < stats["tokens"]


def test_speculative_full_budget_rows(models):
    """Rows that never emit EOS run to the budget: blocks near the tail's
    end run past Cmax, and those writes are masked out."""
    cfg, params, tparams = models
    reqs = [_req(cfg, 9, 100 + i) for i in range(3)]
    _, plain = _run(ContinuousBatcher, cfg, tparams, reqs, eos_token_id=-1)
    _, spec = _run(ContinuousBatcher, cfg, tparams, reqs, eos_token_id=-1,
                   speculate_k=3)
    _, jout = _run(JaxBatcher, cfg, params, reqs, eos_token_id=-1,
                   speculate_k=3)
    assert [o.length for o in spec] == [24] * 3
    assert _tokens(spec) == _tokens(plain) == _tokens(jout)


@pytest.mark.parametrize("quant", ["int8", "int8_kv", "int4_kv"])
def test_speculative_quantized(models, quant):
    """Quantized weights (K6 plain at M = R * kb for int4) and int8 caches
    (block codes and scales written per (row, position, head)): equal to
    the port's sequential run and JAX's speculative run."""
    cfg, params, tparams = models
    reqs = [_req(cfg, 10, 200 + i) for i in range(3)]
    kw = dict(max_new_tokens=16, decode_quant=quant)
    _, plain = _run(ContinuousBatcher, cfg, tparams, reqs, **kw)
    _, spec = _run(ContinuousBatcher, cfg, tparams, reqs, speculate_k=2, **kw)
    _, jout = _run(JaxBatcher, cfg, params, reqs, speculate_k=2, **kw)
    assert _tokens(spec) == _tokens(plain) == _tokens(jout)


def test_speculative_scope_validation(models):
    cfg, _, tparams = models
    with pytest.raises(ValueError, match=">= 0"):
        ContinuousBatcher(cfg, tparams, slots=1, prompt_len=8,
                          max_new_tokens=4, speculate_k=-1)


def test_speculative_sample_is_exact():
    """P(emit y) == p(y) for a fixed p and a mid-probability draft, and the
    draft's acceptance rate == p(draft)."""
    V, N = 8, 120_000
    rng = np.random.RandomState(0)
    base = rng.dirichlet(np.ones(V))
    p = torch.from_numpy(np.broadcast_to(base, (N, 2, V)).astype(np.float32))
    draft = int(np.argsort(base)[-2])
    drafts = torch.full((N, 1), draft, dtype=torch.long)
    emit, a = tspec._speculative_sample(
        p, drafts, torch.Generator().manual_seed(7))
    freq = np.bincount(emit[:, 0].numpy(), minlength=V) / N
    tol = 5 * np.sqrt(base * (1 - base) / N)
    np.testing.assert_array_less(np.abs(freq - base), tol + 1e-12)
    acc = float((a == 2).float().mean())
    assert abs(acc - base[draft]) < 5 * np.sqrt(
        base[draft] * (1 - base[draft]) / N)


def test_speculative_sample_multi_draft_chain():
    """k = 2 with distinct per-position distributions: the acceptance chain
    and the position-1 marginal given acceptance at position 0."""
    V, N = 8, 150_000
    rng = np.random.RandomState(1)
    p0, p1, p2 = (rng.dirichlet(np.ones(V)) for _ in range(3))
    p = torch.from_numpy(np.broadcast_to(
        np.stack([p0, p1, p2]), (N, 3, V)).astype(np.float32))
    d1, d2 = int(np.argsort(p0)[-2]), int(np.argsort(p1)[-3])
    drafts = torch.tensor([[d1, d2]]).expand(N, 2)
    emit, a = tspec._speculative_sample(
        p, drafts, torch.Generator().manual_seed(11))
    emit, a = emit.numpy(), a.numpy()

    def close(x, q, n):
        assert abs(x - q) < 5 * np.sqrt(max(q * (1 - q), 1e-6) / n), (x, q)

    close(float((a >= 2).mean()), p0[d1], N)
    acc0 = a >= 2
    close(float((a[acc0] >= 3).mean()), p1[d2], int(acc0.sum()))
    freq0 = np.bincount(emit[:, 0], minlength=V) / N
    np.testing.assert_array_less(
        np.abs(freq0 - p0), 5 * np.sqrt(p0 * (1 - p0) / N) + 1e-12)
    n1 = int(acc0.sum())
    freq1 = np.bincount(emit[acc0, 1], minlength=V) / n1
    np.testing.assert_array_less(
        np.abs(freq1 - p1), 5 * np.sqrt(p1 * (1 - p1) / n1) + 1e-12)


def test_speculative_sampled_e2e(models):
    """temperature > 0: in-vocabulary tokens within the budget, sane
    telemetry, and clones of one prompt sample independently."""
    cfg, _, tparams = models
    reqs = [_req(cfg, 10, 400 + i) for i in range(4)]
    b, outs = _run(ContinuousBatcher, cfg, tparams, reqs, max_new_tokens=20,
                   temperature=1.0, top_p=0.95, speculate_k=2)
    for o in outs:
        assert 1 <= o.length <= 20
        toks = np.asarray(o.sequences[:o.length])
        assert toks.min() >= 0 and toks.max() < cfg.text.vocab_size
    assert b.spec_stats["tokens"] >= b.spec_stats["steps"] > 0
    _, clones = _run(ContinuousBatcher, cfg, tparams, [reqs[0]] * 4,
                     max_new_tokens=20, eos_token_id=-1, temperature=1.0,
                     top_p=0.95, speculate_k=2)
    assert len({tuple(t) for t in _tokens(clones)}) > 1


def test_engine_generate_many_speculative(models):
    """QwenEngine(speculate_k) reaches its batchers; greedy texts equal the
    engine without speculation and JAX's speculative engine."""
    from spacer_tpu.data.processor import MockTokenizer as JaxTokenizer
    from spacer_tpu.data.processor import VLProcessor as JaxProcessor
    from spacer_tpu.evalharness.engine import QwenEngine as JaxEngine
    from spacer_tpu_torch.data.processor import MockTokenizer, VLProcessor
    from spacer_tpu_torch.evalharness.engine import QwenEngine

    cfg, params, tparams = models
    proc = VLProcessor(MockTokenizer(cfg.text.vocab_size), cfg)
    messages = [[{"role": "user", "content": [
        {"type": "text", "text": f"question {i} about x"}]}] for i in range(4)]
    kw = dict(max_new_tokens=12, temperature=0.0, slots=2, chunk_steps=4)
    base = QwenEngine(cfg, tparams, proc).generate_many(messages, **kw)
    engine = QwenEngine(cfg, tparams, proc, speculate_k=3)
    spec = engine.generate_many(messages, **kw)
    jproc = JaxProcessor(JaxTokenizer(cfg.text.vocab_size), cfg)
    jout = JaxEngine(cfg, params, jproc, speculate_k=3).generate_many(
        messages, **kw)
    assert spec == base == jout
    (batcher,) = engine._batchers.values()
    assert batcher.speculate_k == 3 and batcher.spec_stats["steps"] > 0

"""The speculative grouped rollout (sampler/speculating.py) in
spacer_tpu_torch against the port's sequential rollout and spacer_tpu's
speculative rollout, at tiny size in float32 on the CPU.

Greedy tokens, completion masks and lengths must be identical (both
packages compute f32; summation order differs far below the logit gaps of
a random tiny model's argmax), across B > 1 groups, every decode_quant, a
rollout that crosses the first tail bucket (128 slots) and rows that run
to the budget.  Tokens past a row's end are compared under its completion
mask: the sequential loop writes EOS there, the speculative loop nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu.sampler import Sampler as JaxSampler
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
from spacer_tpu_torch.sampler import Sampler
from spacer_tpu_torch.sampler import speculating


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(0), cfg, jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


def _prompts(cfg, B, S, seed=0):
    r = np.random.RandomState(seed)
    ids = r.randint(10, cfg.text.vocab_size, size=(B, S)).astype(np.int32)
    ids[:, S // 2:] = ids[:, : S - S // 2]   # repeated bigrams to look up
    mask = np.ones((B, S), np.int32)
    mask[-1, :2] = 0                          # a left-padded prompt
    pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).astype(np.int32)
    return ids, mask, pos, np.zeros((B, 1), np.int32)


def _gen(cls, cfg, params, prompts, *, k, eos=11, G=2, C=24, temp=0.0,
         quant=None, seed=3):
    ids, mask, pos, deltas = prompts
    kw = dict(eos_token_id=eos, pad_token_id=0, length_bucket=8,
              decode_quant=quant, speculate_k=k)
    if cls is JaxSampler and not k:
        kw["decode_impl"] = "flash_ref"
    return cls(cfg, **kw).generate(
        ids, mask, params, position_ids=pos, deltas=deltas,
        num_generations=G, max_new_tokens=C, temperature=temp, top_p=0.95,
        seed=seed)


def _assert_same_masked(a, b):
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.completion_mask, b.completion_mask)
    np.testing.assert_array_equal(np.asarray(a.sequences) * a.completion_mask,
                                  np.asarray(b.sequences) * b.completion_mask)


@pytest.mark.parametrize("quant", [None, "int8", "int8_kv", "int4_kv"])
def test_spec_grouped_greedy_parity(models, quant):
    cfg, params, tparams = models
    prompts = _prompts(cfg, B=2, S=16)
    reset_launch_counts()
    spec = _gen(Sampler, cfg, tparams, prompts, k=3, quant=quant)
    assert set(launch_counts().values()) == {0}   # CPU: no kernel
    plain = _gen(Sampler, cfg, tparams, prompts, k=0, quant=quant)
    jspec = _gen(JaxSampler, cfg, params, prompts, k=3, quant=quant)
    _assert_same_masked(spec, plain)
    _assert_same_masked(spec, jspec)
    np.testing.assert_array_equal(spec.sequences, np.asarray(jspec.sequences))
    assert spec.stats["spec_row_steps"] == jspec.stats["spec_row_steps"]
    assert spec.stats["spec_tokens"] == jspec.stats["spec_tokens"]
    assert spec.stats["spec_acceptance"] > 1.0


def test_spec_grouped_full_budget_and_bucket_growth(models, monkeypatch):
    """EOS never fires and the budget (160) is past the first tail bucket
    (128): every row emits exactly 160 tokens, the read length grows from
    128 to 160, and tokens equal the sequential rollout and JAX's."""
    cfg, params, tparams = models
    prompts = _prompts(cfg, B=1, S=8, seed=1)
    seen = []
    step = speculating._spec_grouped_step

    def spy(*a, tail_len=None, **kw):
        seen.append(tail_len)
        return step(*a, tail_len=tail_len, **kw)

    monkeypatch.setattr(speculating, "_spec_grouped_step", spy)
    kw = dict(eos=-1, G=3, C=160)
    spec = _gen(Sampler, cfg, tparams, prompts, k=2, **kw)
    assert sorted(set(seen)) == [128, 160] and seen == sorted(seen)
    np.testing.assert_array_equal(spec.lengths, np.full(3, 160))
    plain = _gen(Sampler, cfg, tparams, prompts, k=0, **kw)
    jspec = _gen(JaxSampler, cfg, params, prompts, k=2, **kw)
    np.testing.assert_array_equal(spec.sequences, plain.sequences)
    np.testing.assert_array_equal(spec.sequences, np.asarray(jspec.sequences))


def test_per_call_override(models):
    """generate(speculate_k=...) overrides the sampler's own setting."""
    cfg, _, tparams = models
    prompts = _prompts(cfg, B=1, S=12, seed=4)
    s = Sampler(cfg, eos_token_id=11, pad_token_id=0, length_bucket=8)
    ids, mask, pos, deltas = prompts
    kw = dict(position_ids=pos, deltas=deltas, num_generations=2,
              max_new_tokens=12, temperature=0.0)
    plain = s.generate(ids, mask, tparams, **kw)
    spec = s.generate(ids, mask, tparams, speculate_k=2, **kw)
    assert plain.stats is None and spec.stats["spec_row_steps"] > 0
    _assert_same_masked(plain, spec)
    with pytest.raises(ValueError, match="speculate_k"):
        s.generate(ids, mask, tparams, speculate_k=-1, **kw)
    with pytest.raises(ValueError, match="speculate_k"):
        Sampler(cfg, speculate_k=-1)


def test_spec_grouped_sampled_e2e(models):
    """temperature > 0: in-vocabulary tokens of the budget's shape, the G
    completions of a group independent, acceptance >= 1."""
    cfg, _, tparams = models
    out = _gen(Sampler, cfg, tparams, _prompts(cfg, B=1, S=12, seed=2), k=2,
               eos=-1, G=4, C=20, temp=1.0)
    assert out.sequences.shape == (4, 20)
    assert out.sequences.min() >= 0 and out.sequences.max() < cfg.text.vocab_size
    assert len({tuple(row) for row in out.sequences}) > 1
    assert out.stats["spec_acceptance"] >= 1.0


def test_spec_grouped_step_writes_only_live_rows(models):
    """A finished row's tail is left alone, and a block running past the
    tail's end writes only the slots inside it."""
    cfg, _, tparams = models
    tc = cfg.text
    B, G, P, C, kb = 1, 2, 4, 5, 3
    N, Hkv, Dh = B * G, tc.num_kv_heads, tc.head_dim
    gen = torch.Generator().manual_seed(0)
    prefix = [tuple(torch.randn((B, Hkv, P, Dh), generator=gen)
                    for _ in range(2)) for _ in range(tc.num_layers)]
    tails = [tuple(torch.randn((N, Hkv, C, Dh), generator=gen)
                   for _ in range(2)) for _ in range(tc.num_layers)]
    before = [tuple(x.clone() for x in e) for e in tails]
    t = torch.tensor([4, 2])
    active = torch.tensor([True, False])
    toks = torch.randint(10, tc.vocab_size, (N, kb), generator=gen)
    pos = (P + t - 1)[:, None] + torch.arange(kb)
    logits = speculating._spec_grouped_step(
        tparams["model"]["layers"], tparams["model"], tc, toks,
        pos[None].expand(3, N, kb), prefix, torch.ones((B, P), dtype=torch.bool),
        tails, t, active, G)
    assert logits.shape == (N, kb, tc.vocab_size)
    for now, was in zip(tails, before):
        for x, y in zip(now, was):
            assert torch.equal(x[1], y[1])              # the done row
            assert torch.equal(x[0, :, :3], y[0, :, :3])
            assert not torch.equal(x[0, :, 3:], y[0, :, 3:])   # slots 3, 4

"""Gradient accumulation of spacer_tpu_torch (train/optimizer.py MultiSteps)
against the JAX trainer's optax.MultiSteps(make_optimizer(...), k) on the
same params and the same per-mini-step gradients.

- f32 params and moments, k = 2 and 4 over 8 mini-steps: after every call
  the params, both moments, the accumulator and the counts (mini-step,
  inner updates, the schedule's count) equal JAX's, rtol 1e-5 (both sides
  compute f32 with the same formulas; they differ in summation order in
  the global norm only).  The params also get atol 1e-6, 1e-4 of the
  learning rate: Adam divides each element by its own gradient scale, so
  an element whose first moment nearly cancels carries that ~1e-7
  relative difference into its update amplified.  Params stay bitwise
  unchanged on calls that do not emit, and the schedule advances only on
  emit.
- bf16 params: the accumulator equals JAX's bitwise (each op of the
  Welford mean rounds to bf16 on both sides).
- The clip sees the mean's global norm: the emit equals one AdamW apply on
  the mean gradients, bitwise.
- A checkpoint saved between mini-steps and restored continues bitwise as
  the uninterrupted run, with and without offloaded state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from spacer_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from spacer_tpu_torch.parallel import is_on_host, offload_to_host
from spacer_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_train_state,
)
from spacer_tpu_torch.train.optimizer import MultiSteps, make_optimizer

L, DIN, DOUT = 2, 24, 16
KW = dict(learning_rate=1e-2, total_steps=8, warmup_steps=1,
          max_grad_norm=0.5, weight_decay=0.01, moment_dtype="float32")


def _jax_params(dtype):
    rng = np.random.default_rng(0)
    return {"model": {
        "layers": {"w": rng.normal(size=(L, DIN, DOUT)).astype(np.float32),
                   "b": rng.normal(size=(L, DOUT)).astype(np.float32)},
        "norm": {"scale": rng.normal(size=(DOUT,)).astype(np.float32)}}}


def _to_port(tree):
    """The JAX tree's leaves as the port's per-layer list and names."""
    m = tree["model"]
    names, leaves = [], []
    for l in range(L):
        for k in ("w", "b"):
            names.append(f"model/layers/{l}/{k}")
            leaves.append(np.asarray(m["layers"][k][l]))
    names.append("model/norm/scale")
    leaves.append(np.asarray(m["norm"]["scale"]))
    return names, leaves


def _grads(step, scale=1.0):
    rng = np.random.default_rng(100 + step)
    return {"model": {
        "layers": {"w": rng.normal(size=(L, DIN, DOUT)).astype(np.float32),
                   "b": rng.normal(size=(L, DOUT)).astype(np.float32)},
        "norm": {"scale": rng.normal(size=(DOUT,)).astype(np.float32)}}}


def _tensor(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dtype)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_counts(state):
    """Every `count` field of the inner optax state (adam's, the
    schedule's)."""
    out = []

    def walk(x):
        if "count" in getattr(x, "_fields", ()):
            out.append(int(x.count))
        if isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(state.inner_opt_state)
    return out


def _jax_adam(state):
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x)
        elif isinstance(x, tuple):
            for y in x:
                walk(y)

    walk(state.inner_opt_state)
    return found[0]


@pytest.mark.parametrize("k", [2, 4])
def test_multisteps_matches_optax(k):
    jtx = optax.MultiSteps(jax_make_optimizer(**KW), every_k_schedule=k)
    jparams = jax.tree.map(jnp.asarray, _jax_params(np.float32))
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)

    names, leaves = _to_port(_jax_params(np.float32))
    params = [_tensor(a, torch.float32) for a in leaves]
    tx = MultiSteps(make_optimizer(**KW, sr_impl="off"), k)
    state = tx.init(params, names)
    for step in range(8):
        g = _grads(step)
        upd, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        before = [p.clone() for p in params]
        _, gl = _to_port(g)
        state = tx.apply([_tensor(a, torch.float32) for a in gl], state,
                         params)
        emitted = (step + 1) % k == 0
        if not emitted:
            for a, b in zip(before, params):
                assert torch.equal(a, b)
        assert state.mini_step == int(jstate.mini_step) == (step + 1) % k
        assert state.gradient_step == int(jstate.gradient_step) \
            == (step + 1) // k
        # the schedule's count (and adam's) advance on emit only
        assert set(_jax_counts(jstate)) == {state.inner_opt_state.count} \
            == {(step + 1) // k}
        _, jp = _to_port(jax.tree.map(np.asarray, jparams))
        _, jacc = _to_port(jax.tree.map(np.asarray, jstate.acc_grads))
        adam = _jax_adam(jstate)
        _, jmu = _to_port(jax.tree.map(np.asarray, adam.mu))
        _, jnu = _to_port(jax.tree.map(np.asarray, adam.nu))
        ist = state.inner_opt_state
        for i, name in enumerate(names):
            np.testing.assert_allclose(params[i].numpy(), jp[i], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
            for got, want in ((state.acc_grads[i], jacc[i]),
                              (ist.mu[i], jmu[i]), (ist.nu[i], jnu[i])):
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-7, err_msg=name)


def test_bf16_accumulator_bitwise():
    k = 4
    jtx = optax.MultiSteps(jax_make_optimizer(**KW), every_k_schedule=k)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                           _jax_params(np.float32))
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)
    names, leaves = _to_port(jax.tree.map(_np, jparams))
    params = [_tensor(a, torch.bfloat16) for a in leaves]
    tx = MultiSteps(make_optimizer(**KW, sr_impl="off"), k)
    state = tx.init(params, names)
    for step in range(k - 1):
        # gradients of every magnitude, cast to bf16 the same way
        g = jax.tree.map(
            lambda a: (jnp.asarray(a) * 10.0 ** jnp.asarray(
                np.random.default_rng(step).uniform(-6, 3, a.shape),
                jnp.float32)).astype(jnp.bfloat16), _grads(step))
        _, jstate = jupdate(g, jstate, jparams)
        _, gl = _to_port(jax.tree.map(_np, g))
        state = tx.apply([_tensor(a, torch.bfloat16) for a in gl], state,
                         params)
        _, jacc = _to_port(jax.tree.map(_np, jstate.acc_grads))
        for name, a, b in zip(names, state.acc_grads, jacc):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.float().numpy(), b, err_msg=name)


def test_emit_clips_by_the_mean_norm():
    """k = 2: the emit equals one AdamW apply on the Welford mean of the two
    mini-steps' grads (clip at the mean's norm, count 0's learning rate),
    bitwise; the clip is active (the mean's norm exceeds max_grad_norm)."""
    names, leaves = _to_port(_jax_params(np.float32))
    pa = [_tensor(a, torch.float32) for a in leaves]
    pb = [p.clone() for p in pa]
    kw = dict(KW, warmup_steps=0)
    ms = MultiSteps(make_optimizer(**kw), 2)
    state = ms.init(pa, names)
    g1, g2 = ([_tensor(a, torch.float32) for a in _to_port(_grads(s))[1]]
              for s in (0, 1))
    state = ms.apply([g.clone() for g in g1], state, pa)
    state = ms.apply([g.clone() for g in g2], state, pa)
    mean = [(a + 0.0) + (b - (a + 0.0)) / 2 for a, b in zip(g1, g2)]
    from spacer_tpu_torch.train.optimizer import global_norm

    assert float(global_norm(mean)) > kw["max_grad_norm"]
    tx = make_optimizer(**kw)
    ref = tx.apply(mean, tx.init(pb, names), pb)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
    for a, b in zip(state.inner_opt_state.mu, ref.mu):
        assert torch.equal(a, b)
    assert all(not bool(a.any()) for a in state.acc_grads)   # zeroed


@pytest.mark.parametrize("offload", [False, True])
def test_resume_between_mini_steps_is_exact(tmp_path, offload):
    """A GRPO step on the tiny model under MultiSteps(k = 2) with int8
    moments: mini-step 1, save, restore into fresh params and state,
    mini-step 2 (the emit) equals the uninterrupted run bitwise."""
    from spacer_tpu_torch.models.qwen25_vl import init_params, tiny_config
    from spacer_tpu_torch.train.step import make_grpo_train_step, param_leaves

    cfg = tiny_config()
    G, P, C = 2, 12, 6

    def batch(seed):
        rng = np.random.default_rng(seed)
        pos = np.broadcast_to(np.arange(P)[None, None], (3, 1, P))
        cpos = np.broadcast_to(P + np.arange(C)[None, None], (3, G, C))
        return {
            "prompt_ids": torch.from_numpy(rng.integers(10, 200, (1, P))),
            "prompt_mask": torch.ones(1, P, dtype=torch.long),
            "prompt_position_ids": torch.from_numpy(pos.copy()),
            "completion_ids": torch.from_numpy(rng.integers(10, 200, (G, C))),
            "completion_position_ids": torch.from_numpy(cpos.copy()),
            "completion_mask": torch.ones(G, C, dtype=torch.long),
            "advantages": torch.tensor([1.0, -1.0])}

    def fresh():
        params = init_params(cfg, seed=0)
        ref = init_params(cfg, seed=0)
        tx = MultiSteps(make_optimizer(learning_rate=1e-3, total_steps=4,
                                       moment_dtype="int8", seed=5), 2)
        leaves = param_leaves(params)
        state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
        if offload:
            state = offload_to_host(state)
        step = make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                    logp_chunk=4)
        return params, ref, state, step

    kw = dict(grid_thw=None, num_generations=G)
    params, ref, state, step = fresh()
    params, state, _ = step(params, ref, state, batch(0), **kw)
    path = save_train_state(str(tmp_path / "ckpt"), params, state,
                            {"global_step": 1})
    params, state, _ = step(params, ref, state, batch(1), **kw)

    p2, ref2, s2, step2 = fresh()
    p2, s2, _ = restore_train_state(path, p2, s2)
    if offload:
        s2 = offload_to_host(s2)
        assert is_on_host(s2)
    assert s2.mini_step == 1 and bool(
        any(bool(a.any()) for a in s2.acc_grads))
    p2, s2, _ = step2(p2, ref2, s2, batch(1), **kw)
    assert s2.mini_step == 0 and s2.gradient_step == 1
    for (n, a), (_, b) in zip(param_leaves(params), param_leaves(p2)):
        assert torch.equal(a.detach(), b.detach()), n
    for x, y in zip(state.inner_opt_state.mu, s2.inner_opt_state.mu):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])

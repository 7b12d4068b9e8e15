"""The GRPO train step: spacer_tpu_torch against spacer_tpu on the same
converted weights and the same fixed completions (tiny config, float32).

Tolerances: logps 1e-4 absolute; loss, kl and grad_norm 1e-4 relative;
updated params 5e-6 absolute per element and 2e-7 in the mean (learning
rate 1e-3, so an update is ~1e-3 and a wrong moment, clip, decay mask or
schedule moves many elements by >= 1e-4).  Both sides compute f32 with the
same formulas and differ in summation order only (~1e-6 relative on the
gradients).  Adam divides each element by its own gradient scale, so an
element whose gradient is near zero would carry that difference into its
update at up to a few percent: the test runs Adam with eps 1e-6 (instead of
1e-8), which damps gradients below that scale on both sides alike.

int8 moments run with deterministic rounding (sr_impl="off" here,
SPACER_ADAM8_SR=off on the JAX side), so the two quantised trajectories are
comparable.  A moment that falls on a rounding tie can quantise one code
apart (summation order), which moves that element's update by up to ~1e-4:
the int8 case allows 1e-3 of a tensor's elements (at least 2) past 5e-6,
each within 2e-4.  Every leaf is compared: the port's optimizer reproduces
the JAX package's stacked (L, ...) layout from the param paths, both its
decay mask (every per-layer tensor decayed, the final norm not) and its
2048-element int8 moment blocks spanning layers.

Shared prefix vs packed gradients: 1e-5 absolute and relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import get_rope_index, init_params, tiny_config
from spacer_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from spacer_tpu.train.step import make_grpo_train_step as jax_make_step
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.train import step as tstep
from spacer_tpu_torch.train.optimizer import make_optimizer

P_LEN, C, G = 48, 12, 4
GRID = ((2, 8, 8),)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n_video = (2 * 8 * 8) // 4
    prompt = ([10, 11, cfg.vision_start_token_id]
              + [cfg.video_token_id] * n_video
              + [cfg.vision_end_token_id, 20, 21])
    pad = P_LEN - len(prompt)
    prompt_ids = np.array([[cfg.pad_token_id] * pad + prompt])
    prompt_mask = np.array([[0] * pad + [1] * len(prompt)])
    pos, deltas = get_rope_index(cfg, prompt_ids, video_grid_thw=np.array(GRID),
                                 attention_mask=prompt_mask)
    completion = rng.integers(10, cfg.text.vocab_size, size=(G, C))
    comp_mask = np.ones((G, C), np.int32)
    comp_mask[:, C - 3:] = rng.integers(0, 2, size=(G, 3))
    comp_pos = np.repeat(deltas.reshape(-1, 1) + P_LEN + np.arange(C)[None], G, 0)
    return {
        "prompt_ids": prompt_ids.astype(np.int32),
        "prompt_mask": prompt_mask.astype(np.int32),
        "prompt_position_ids": pos.astype(np.int32),
        "completion_ids": completion.astype(np.int32),
        "completion_position_ids": np.broadcast_to(
            comp_pos[None], (3, G, C)).astype(np.int32),
        "completion_mask": comp_mask,
        "advantages": rng.normal(size=(G,)).astype(np.float32),
        "pixel_values": rng.normal(
            size=(2 * 8 * 8, cfg.vision.patch_dim)).astype(np.float32),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    for k in ("prompt_ids", "prompt_mask", "prompt_position_ids",
              "completion_ids", "completion_position_ids", "completion_mask"):
        out[k] = out[k].long()
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    params = init_params(jax.random.key(0), cfg, jnp.float32)
    return cfg, jax.tree.map(np.asarray, params)


def _flat(tp):
    return [t.detach().numpy() for _, t in tstep.param_leaves(tp)]


@pytest.mark.parametrize("moment_dtype,weight_decay",
                         [("float32", 0.01), ("int8", 0.0)])
def test_two_steps_match_jax(setup, moment_dtype, weight_decay, monkeypatch):
    cfg, np_params = setup
    batch = _batch(cfg)
    monkeypatch.setenv("SPACER_ADAM8_SR", "off")
    opt_kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1,
                  moment_dtype=moment_dtype, max_grad_norm=0.5,
                  weight_decay=weight_decay, eps=1e-6)
    jtx = jax_make_optimizer(**opt_kw)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jref = jax.tree.map(jnp.asarray, np_params)
    jstate = jtx.init(jparams)
    jstep = jax_make_step(cfg, jtx, beta=0.04, remat=True, logp_chunk=8)

    tx = make_optimizer(**opt_kw, sr_impl="off")
    tparams = params_from_jax(np_params, cfg)
    tref = params_from_jax(np_params, cfg)
    leaves = tstep.param_leaves(tparams)
    tstate = tx.init([t for _, t in leaves], [n for n, _ in leaves])
    step = tstep.make_grpo_train_step(cfg, tx, beta=0.04, remat=True,
                                      logp_chunk=8)
    tb = _torch_batch(batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = dict(grid_thw=GRID, num_generations=G)
    jkw = dict(kw, prompt_len=P_LEN)

    with jax.default_matmul_precision("highest"):
        jlogps = jstep.ref_logps_fn(jref, jb, **jkw)
    logps = step.ref_logps_fn(tref, tb, **kw)
    np.testing.assert_allclose(logps.numpy(), np.asarray(jlogps), atol=1e-4)

    for i in range(2):
        with jax.default_matmul_precision("highest"):
            jparams, jstate, jm = jstep(jparams, jref, jstate, jb, **jkw)
        tparams, tstate, m = step(tparams, tref, tstate, tb, **kw)
        for key in ("loss", "kl", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-7, err_msg=key)
        jleaves = _flat(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
        for (name, t), b in zip(tstep.param_leaves(tparams), jleaves):
            a = t.detach().numpy()
            diff = np.abs(a - b)
            if moment_dtype == "int8":
                # a moment on a rounding tie may quantise one code apart
                assert (diff > 5e-6).sum() <= max(2, diff.size // 1000), name
                assert diff.max() <= 2e-4, name
            else:
                np.testing.assert_allclose(a, b, atol=5e-6, err_msg=name)
            assert diff.mean() <= 2e-7, name
    # warmup makes step 1's learning rate 0, so step 2's kl is 0; after
    # step 2 the policy has moved away from the reference
    moved = step.ref_logps_fn(tparams, tb, **kw)
    assert float((moved - logps).abs().max()) > 0


def test_shared_prefix_equals_packed_and_vit_gets_grads(setup):
    cfg, np_params = setup
    batch = _torch_batch(_batch(cfg, seed=1))
    params = params_from_jax(np_params, cfg)
    leaves = [t for _, t in tstep.param_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    ve = tstep.family_for_config(cfg).encode_vision(
        params, cfg, {"pixel_values": batch["pixel_values"]}, GRID, remat=True)
    shared = tstep._completion_logps_shared(
        params, cfg, batch["prompt_ids"], batch["prompt_position_ids"],
        batch["prompt_mask"], batch["completion_ids"],
        batch["completion_position_ids"], batch["completion_mask"], G,
        vision_embeds=ve, remat=True, logp_chunk=8)
    ids = torch.cat([batch["prompt_ids"].repeat(G, 1), batch["completion_ids"]], 1)
    kv_mask = torch.cat([batch["prompt_mask"].repeat(G, 1),
                         batch["completion_mask"]], 1).bool()
    pos = torch.cat([batch["prompt_position_ids"].repeat(1, G, 1),
                     batch["completion_position_ids"]], 2)
    packed = tstep._completion_logps(
        params, cfg, ids, pos, kv_mask, P_LEN,
        vision_embeds=tstep.tile_vision_embeds(ve, cfg, GRID, G), logp_chunk=8)
    np.testing.assert_allclose(shared.detach().numpy(), packed.detach().numpy(),
                               atol=1e-5)
    w = batch["completion_mask"].float()
    # both paths read the same vision embeddings: keep their graph
    gs = torch.autograd.grad((shared * w).sum(), leaves, allow_unused=True,
                             retain_graph=True)
    gp = torch.autograd.grad((packed * w).sum(), leaves, allow_unused=True)
    names = [n for n, _ in tstep.param_leaves(params)]
    for name, a, b in zip(names, gs, gp):
        assert a is not None and b is not None, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
        if name.startswith("visual/blocks") and name.endswith("kernel"):
            assert float(a.abs().max()) > 0, name   # the ViT trains


def test_unported_modes_raise(setup):
    """The selective remat modes are ported and build; a misspelt mode
    raises ValueError when the step is built (no typo passes through), as
    does an unknown moment dtype."""
    cfg, _ = setup
    tx = make_optimizer()
    for ok in ("dots", "dots_narrow", "dots_mixed:2"):
        tstep.make_grpo_train_step(cfg, tx, remat=ok)
    for bad in ("dotz", "dots_narow", "dots_mixed:", "dots_mixed:-1"):
        with pytest.raises(ValueError):
            tstep.make_grpo_train_step(cfg, tx, remat=bad)
    with pytest.raises(ValueError):
        make_optimizer(moment_dtype="int4")


def test_int8_moment_groups_equal_one_stacked_leaf(monkeypatch):
    """Per-layer tensors whose size is not a multiple of 2048 share one int8
    moment state per stacked group, so their update equals that of the
    stacked (L, ...) leaf JAX holds, whatever the slab size; per-layer 1-D
    tensors are decayed, a top-level 1-D tensor is not."""
    from spacer_tpu_torch.train import optimizer as opt

    rng = np.random.default_rng(0)
    L, n = 3, 3000
    stacked = torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32))
    grads = torch.from_numpy(rng.normal(size=(L, n)).astype(np.float32))
    norm = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    names = [f"model/layers/{l}/input_layernorm/scale" for l in range(L)]
    kw = dict(learning_rate=1e-2, total_steps=10, moment_dtype="int8",
              weight_decay=0.1, sr_impl="off")

    def run(params, grads, names, slab):
        monkeypatch.setattr(opt, "SLAB_BLOCKS", slab)
        tx = opt.make_optimizer(**kw)
        state = tx.init(params, names)
        for _ in range(2):
            upd, state = tx.update(grads, state, params)
        return upd, state

    per_layer = list(stacked) + [norm]
    g_layer = list(grads) + [torch.zeros(n)]
    for slab in (1, opt.SLAB_BLOCKS):
        upd, state = run(per_layer, g_layer, names + ["model/norm/scale"],
                         slab)
        assert state.groups == [[0, 1, 2], [3]]
        assert state.decay == [True, True, True, False]
        ref, _ = run([stacked, norm], [grads, torch.zeros(n)],
                     ["stacked", "norm"], opt.SLAB_BLOCKS)
        torch.testing.assert_close(torch.stack(upd[:3]), ref[0], rtol=0,
                                   atol=0)
        assert torch.equal(upd[3], torch.zeros(n))   # 1-D top level: no decay

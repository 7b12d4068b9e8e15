"""Selective rematerialisation of spacer_tpu_torch (counterpart of
tests/test_train_step.py::test_remat_modes_same_gradients): remat is a
memory / recompute schedule, never math.

The GRPO step's loss and gradients under remat False, True, "dots",
"dots_narrow" and "dots_mixed:1" (tiny config, float32, the shared-prefix
batch with a video) equal each other (rtol 1e-6; the recompute repeats the
same ops on the same inputs) and JAX's step under the same mode (loss and
grad_norm, rtol 1e-5, JAX at matmul precision "highest").  The policies
save what they name: "dots" keeps every dense output, "dots_narrow" all
but the intermediate_size-wide ones.  Misspelt modes raise ValueError when
the step is built.
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
from spacer_tpu_torch.models.qwen25_vl.language import (
    _dots_policy,
    check_remat,
)
from spacer_tpu_torch.train import step as tstep
from spacer_tpu_torch.train.optimizer import make_optimizer

P_LEN, C, G = 48, 12, 4
GRID = ((2, 8, 8),)
MODES = (False, True, "dots", "dots_narrow", "dots_mixed:1")


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
    comp_pos = np.repeat(deltas.reshape(-1, 1) + P_LEN + np.arange(C)[None],
                         G, 0)
    return {
        "prompt_ids": prompt_ids.astype(np.int32),
        "prompt_mask": prompt_mask.astype(np.int32),
        "prompt_position_ids": pos.astype(np.int32),
        "completion_ids": rng.integers(10, cfg.text.vocab_size,
                                       size=(G, C)).astype(np.int32),
        "completion_position_ids": np.broadcast_to(
            comp_pos[None], (3, G, C)).astype(np.int32),
        "completion_mask": np.ones((G, C), np.int32),
        "advantages": rng.normal(size=(G,)).astype(np.float32),
        "ref_logps": rng.normal(size=(G, C)).astype(np.float32) * 0.1 - 5.0,
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
    return cfg, jax.tree.map(np.asarray, params), _batch(cfg)


@pytest.fixture(scope="module")
def port_runs(setup):
    cfg, np_params, batch = setup
    tb = _torch_batch(batch)
    runs = {}
    for mode in MODES:
        params = params_from_jax(np_params, cfg)
        step = tstep.make_grpo_train_step(cfg, make_optimizer(), beta=0.04,
                                          remat=mode, logp_chunk=8)
        runs[mode] = step.loss_and_grads(
            params, tb["ref_logps"],
            {k: v for k, v in tb.items() if k != "ref_logps"}, GRID, G)
    return runs


@pytest.mark.parametrize("mode", MODES[1:])
def test_remat_modes_same_loss_and_grads(port_runs, mode):
    loss0, _, g0 = port_runs[False]
    loss, _, grads = port_runs[mode]
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    for a, b in zip(grads, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("mode", [True, "dots_narrow", "dots_mixed:1"])
def test_remat_modes_match_jax(setup, port_runs, mode):
    """One JAX step under the same mode: its loss and the global norm of
    its gradients (the step's grad_norm) against the port's."""
    cfg, np_params, batch = setup
    jtx = jax_make_optimizer(learning_rate=1e-3, total_steps=10)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstep = jax_make_step(cfg, jtx, beta=0.04, remat=mode, logp_chunk=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        _, _, jm = jstep(jparams, jparams, jtx.init(jparams), jb,
                         grid_thw=GRID, num_generations=G, prompt_len=P_LEN)
    loss, _, grads = port_runs[mode]
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-5)
    gnorm = float(torch.sqrt(sum(g.square().sum() for g in grads)))
    np.testing.assert_allclose(gnorm, float(jm["grad_norm"]), rtol=1e-5)


def test_policies_save_what_they_name():
    """The policy keeps 2-D matmul outputs narrower than its width (all of
    them for "dots") and recomputes batched products and everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    mm, addmm, bmm = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default)
    x, wide, narrow = torch.zeros(4, 8), torch.zeros(8, 64), torch.zeros(8, 16)
    dots, narrow_policy = _dots_policy(None), _dots_policy(64)
    save, recompute = CheckpointPolicy.MUST_SAVE, CheckpointPolicy.PREFER_RECOMPUTE
    assert dots(None, mm, x, wide) == save
    assert dots(None, addmm, torch.zeros(64), x, wide) == save
    assert narrow_policy(None, mm, x, wide) == recompute      # gate / up
    assert narrow_policy(None, mm, x, narrow) == save         # q, k, v, o, down
    assert dots(None, bmm, torch.zeros(2, 4, 8), torch.zeros(2, 8, 4)) == recompute
    assert dots(None, torch.ops.aten.add.Tensor, x, x) == recompute


@pytest.mark.parametrize("bad", ["dots_narow", "dots_mixed:", "dots_mixed:-1",
                                 "dots_mixed:x", "Dots", 2])
def test_bad_remat_strings_raise(setup, bad):
    cfg, _, _ = setup
    with pytest.raises(ValueError):
        check_remat(bad)
    with pytest.raises(ValueError):
        tstep.make_grpo_train_step(cfg, make_optimizer(), remat=bad)
    with pytest.raises(ValueError):
        tstep.make_sft_train_step(cfg, make_optimizer(), remat=bad)


def test_good_remat_strings_normalise():
    assert check_remat(None) is False and check_remat(1) is True
    assert check_remat("dots_mixed:03") == "dots_mixed:3"
    assert check_remat("dots_narrow") == "dots_narrow"


def test_recompute_reruns_only_unsaved_matmuls():
    """Count the backward's 2-D matmuls of a tiny LM forward under each
    mode: full remat recomputes 6 of every layer's 7 dense products (down's
    output only joins the residual, and the recompute stops once every
    saved tensor is back), "dots" none of them, "dots_narrow" the 2 wide
    ones (gate, up) and "dots_mixed:1" those of the layers after the first;
    the backward's own products are the same in every mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from spacer_tpu_torch.models.qwen25_vl import init_params as t_init
    from spacer_tpu_torch.models.qwen25_vl.language import lm_forward

    cfg = tiny_config()
    L = cfg.text.num_layers
    assert L >= 2

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    def backward_mms(mode):
        params = t_init(cfg, seed=0)["model"]
        for lp in params["layers"]:
            for t in (lp["mlp"]["up_proj"]["kernel"],):
                t.requires_grad_(True)
        x = torch.randn(1, 6, cfg.text.hidden_size, requires_grad=True)
        h, _ = lm_forward(params, cfg.text, input_embeds=x, logits=False,
                          remat=mode)
        CountMM.n = 0
        with CountMM():
            h.sum().backward()
        return CountMM.n

    n = {m: backward_mms(m) for m in (False, True, "dots", "dots_narrow",
                                      "dots_mixed:1")}
    assert n["dots"] == n[False]
    assert n[True] == n[False] + 6 * L
    assert n["dots_narrow"] == n[False] + 2 * L
    assert n["dots_mixed:1"] == n[False] + 2 * (L - 1)


def test_selected_gradients_equal_the_full_set(setup, port_runs):
    """`select` (the full-depth smoke's partial replays) gives the selected
    tensors the same gradients as the full set and the others none."""
    cfg, np_params, batch = setup
    tb = _torch_batch(batch)
    params = params_from_jax(np_params, cfg)
    step = tstep.make_grpo_train_step(cfg, make_optimizer(), beta=0.04,
                                      remat=True, logp_chunk=8)

    def select(name):
        return name.startswith(("model/layers/0/", "visual/merger/"))

    loss, _, grads = step.loss_and_grads(
        params, tb["ref_logps"],
        {k: v for k, v in tb.items() if k != "ref_logps"}, GRID, G,
        select=select)
    loss0, _, g0 = port_runs[False]
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    names = [n for n, _ in tstep.param_leaves(params)]
    assert sum(g is not None for g in grads) == sum(map(select, names)) > 0
    for n, a, b in zip(names, grads, g0):
        if select(n):
            # a smaller graph sums some gradients in another order
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=1e-5,
                atol=1e-5 * float(b.abs().max()), err_msg=n)
        else:
            assert a is None, n

"""LoRA of spacer_tpu_torch (counterpart of tests/test_lora.py): zero
init is the identity, the merge math, the mapping of the port's per-layer
param paths onto the JAX package's stacked ones, and one adapter-only GRPO
step against spacer_tpu's on the same weights and data (tiny config,
float32).

The JAX step takes the packed batch, the port's the shared-prefix one
built from the same prompt and completions (their logps are equal:
tests/test_torch_train_step.py).  Tolerances: loss and kl rtol 1e-5; the
adapters after the step 5e-6 absolute (learning rate 1e-3; Adam with eps
1e-6 on both sides, which damps elements whose gradient is near zero, as
in tests/test_torch_train_step.py); the base params bitwise unchanged.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import get_rope_index, init_params, tiny_config
from spacer_tpu.train.lora import LoraConfig as JaxLoraConfig
from spacer_tpu.train.lora import init_lora_params as jax_init_lora
from spacer_tpu.train.lora import make_lora_grpo_train_step as jax_lora_step
from spacer_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.models.qwen25_vl import init_params as t_init_params
from spacer_tpu_torch.train.lora import (
    LoraConfig,
    init_lora_params,
    lora_leaves,
    make_lora_grpo_train_step,
    merge_lora,
    stacked_path,
)
from spacer_tpu_torch.train.optimizer import make_optimizer
from spacer_tpu_torch.train.step import param_leaves

P_LEN, C, G = 48, 12, 4
GRID = ((2, 8, 8),)
PROJ = ("q", "k", "v", "o")


def test_lora_zero_init_is_identity():
    cfg = tiny_config()
    params = t_init_params(cfg, seed=0)
    lcfg = LoraConfig(r=4)
    lora = init_lora_params(torch.Generator().manual_seed(1), params, lcfg)
    assert len(lora) == 4 * cfg.text.num_layers     # q, k, v, o per layer
    for ab in lora.values():
        assert not bool(ab["b"].any()) and bool(ab["a"].any())
    merged = merge_lora(params, lora, lcfg)
    for (n, a), (_, b) in zip(param_leaves(params), param_leaves(merged)):
        assert torch.equal(a, b), n


def test_lora_merge_math():
    cfg = tiny_config()
    params = t_init_params(cfg, seed=0)
    lcfg = LoraConfig(r=2, alpha=4)
    lora = init_lora_params(torch.Generator().manual_seed(1), params, lcfg)
    name = "model/layers/1/self_attn/q_proj/kernel"
    lora[name]["b"] = torch.full_like(lora[name]["b"], 0.01)
    merged = merge_lora(params, lora, lcfg)
    base = params["model"]["layers"][1]["self_attn"]["q_proj"]["kernel"]
    got = merged["model"]["layers"][1]["self_attn"]["q_proj"]["kernel"]
    want = base + 2.0 * lora[name]["a"] @ lora[name]["b"]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # untargeted tensors are the params' own
    assert (merged["model"]["layers"][1]["mlp"]["gate_proj"]["kernel"]
            is params["model"]["layers"][1]["mlp"]["gate_proj"]["kernel"])


def test_port_paths_map_to_jax_stacked_paths():
    """The port's default pattern selects, layer by layer, exactly the
    tensors whose stacked JAX path the JAX default pattern selects; the
    same holds for a pattern over the MLP written both ways."""
    import re

    cfg = tiny_config()
    params = t_init_params(cfg, seed=0)
    names = [n for n, t in param_leaves(params) if t.dim() >= 2]
    assert stacked_path("model/layers/3/mlp/up_proj/kernel") == \
        "model/layers/mlp/up_proj/kernel"
    assert stacked_path("visual/blocks/0/attn/qkv/kernel") == \
        "visual/blocks/attn/qkv/kernel"
    assert stacked_path("model/lm_head/kernel") == "model/lm_head/kernel"
    pairs = [(LoraConfig().target_patterns, JaxLoraConfig().target_patterns),
             ((r"model/layers/\d+/mlp/(gate|up)_proj/kernel",),
              (r"model/layers/mlp/(gate|up)_proj/kernel",))]
    for port_pats, jax_pats in pairs:
        ours = {n for n in names if any(re.search(p, n) for p in port_pats)}
        theirs = {n for n in names
                  if any(re.search(p, stacked_path(n)) for p in jax_pats)}
        assert ours == theirs and ours
        lora = init_lora_params(torch.Generator().manual_seed(0), params,
                                LoraConfig(target_patterns=port_pats))
        assert set(lora) == ours


def _batches(cfg):
    """The same prompt and completions, shared-prefix (port) and packed
    (JAX)."""
    rng = np.random.default_rng(0)
    n_video = (2 * 8 * 8) // 4
    prompt = ([10, 11, cfg.vision_start_token_id]
              + [cfg.video_token_id] * n_video
              + [cfg.vision_end_token_id, 20, 21])
    pad = P_LEN - len(prompt)
    prompt_ids = np.array([[cfg.pad_token_id] * pad + prompt])
    prompt_mask = np.array([[0] * pad + [1] * len(prompt)])
    pos, deltas = get_rope_index(cfg, prompt_ids, video_grid_thw=np.array(GRID),
                                 attention_mask=prompt_mask)
    comp = rng.integers(10, cfg.text.vocab_size, size=(G, C))
    comp_mask = np.ones((G, C), np.int64)
    comp_mask[:, C - 3:] = rng.integers(0, 2, size=(G, 3))
    comp_pos = np.repeat(deltas.reshape(-1, 1) + P_LEN + np.arange(C)[None],
                         G, 0)
    adv = rng.normal(size=(G,)).astype(np.float32)
    px = rng.normal(size=(2 * 8 * 8, cfg.vision.patch_dim)).astype(np.float32)
    shared = {
        "prompt_ids": prompt_ids, "prompt_mask": prompt_mask,
        "prompt_position_ids": pos,
        "completion_ids": comp, "completion_position_ids": np.broadcast_to(
            comp_pos[None], (3, G, C)),
        "completion_mask": comp_mask, "advantages": adv, "pixel_values": px}
    packed = {
        "input_ids": np.concatenate([np.repeat(prompt_ids, G, 0), comp], 1),
        "position_ids": np.concatenate(
            [np.repeat(pos, G, 1), shared["completion_position_ids"]], 2),
        "kv_mask": np.concatenate([np.repeat(prompt_mask, G, 0), comp_mask],
                                  1).astype(bool),
        "completion_mask": comp_mask.astype(np.int32), "advantages": adv,
        "pixel_values": px}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in shared.items()}
    for k in ("prompt_ids", "prompt_mask", "prompt_position_ids",
              "completion_ids", "completion_position_ids", "completion_mask"):
        tb[k] = tb[k].long()
    return tb, {k: jnp.asarray(v) for k, v in packed.items()}


def test_lora_grpo_step_matches_jax():
    cfg = tiny_config()
    jparams = init_params(jax.random.key(0), cfg, jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    jlcfg, lcfg = JaxLoraConfig(r=4), LoraConfig(r=4)
    jlora = jax_init_lora(jax.random.key(1), jparams, jlcfg)
    # b nonzero so both adapters get gradients on the first step
    attn = jlora["model"]["layers"]["self_attn"]
    for p in PROJ:
        kb = attn[f"{p}_proj"]["kernel"]
        kb["b"] = jnp.asarray(np.random.default_rng(2).normal(
            size=kb["b"].shape).astype(np.float32) * 0.05)
    lora = {}
    for l in range(cfg.text.num_layers):
        for p in PROJ:
            ab = attn[f"{p}_proj"]["kernel"]
            lora[f"model/layers/{l}/self_attn/{p}_proj/kernel"] = {
                k: torch.from_numpy(np.asarray(ab[k][l]).copy())
                for k in ("a", "b")}
    opt_kw = dict(learning_rate=1e-3, total_steps=10, eps=1e-6,
                  moment_dtype="float32")
    jtx = jax_make_optimizer(**opt_kw)
    jstate = jtx.init(jlora)
    jstep = jax_lora_step(cfg, jtx, jlcfg, beta=0.04, remat=True,
                          attn_impl="xla", logp_chunk=8)
    tb, jb = _batches(cfg)
    with jax.default_matmul_precision("highest"):
        jlora2, _, jm = jstep(jparams, jlora, jstate, jb, grid_thw=GRID,
                              num_generations=G, prompt_len=P_LEN)

    params = params_from_jax(np_params, cfg)
    before = [t.clone() for _, t in param_leaves(params)]
    tx = make_optimizer(**opt_kw)
    leaves = lora_leaves(lora)
    state = tx.init([t for _, t in leaves], [n for n, _ in leaves])
    step = make_lora_grpo_train_step(cfg, tx, lcfg, beta=0.04, remat=True,
                                     logp_chunk=8)
    lora, state, m = step(params, lora, state, tb, grid_thw=GRID,
                          num_generations=G)
    for key in ("loss", "kl", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-8, err_msg=key)
    assert float(m["grad_norm"]) > 0
    jattn = jlora2["model"]["layers"]["self_attn"]
    for l in range(cfg.text.num_layers):
        for p in PROJ:
            ab = lora[f"model/layers/{l}/self_attn/{p}_proj/kernel"]
            for k in ("a", "b"):
                np.testing.assert_allclose(
                    ab[k].detach().numpy(),
                    np.asarray(jattn[f"{p}_proj"]["kernel"][k][l]), atol=5e-6,
                    err_msg=f"{l} {p} {k}")
    for a, (n, b) in zip(before, param_leaves(params)):
        assert torch.equal(a, b) and not b.requires_grad, n

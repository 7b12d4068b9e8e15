"""The Qwen2-VL family (arch "qwen2": every ViT block full attention,
LayerNorm with bias, fc1 -> quick_gelu -> fc2) in spacer_tpu_torch against
spacer_tpu, at tiny_config(arch="qwen2") on the CPU.

- vit_forward against JAX's all-full path (attn_impl="xla"), one grid and
  two grids of unequal frame chunks (one K4 plain call per grid against
  JAX's segment mask).  Tolerance 1e-4 in f32, as the Qwen2.5 ViT tests:
  four blocks of matmuls, norms and MLPs accumulate ~1e-6 per op.
- the multimodal forward (ViT, merge, LM) against JAX's `forward`, 1e-4.
- greedy rollout and serving tokens against JAX's on the same weights.
- a safetensors export -> load round trip, bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import forward as jax_forward
from spacer_tpu.models.qwen25_vl import get_rope_index
from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.vision import (
    vision_layout as jax_vision_layout,
    vit_forward as jax_vit_forward,
)
from spacer_tpu.sampler import Sampler as JaxSampler
from spacer_tpu_torch.models.qwen25_vl import (
    export_to_safetensors,
    init_params,
    load_params_from_hf,
    params_from_jax,
    tiny_config,
)
from spacer_tpu_torch.models.qwen25_vl.language import lm_forward
from spacer_tpu_torch.models.qwen25_vl.vision import vision_layout, vit_forward
from spacer_tpu_torch.sampler import Sampler
from spacer_tpu_torch.sampler.sampler import prologue

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny2():
    cfg = tiny_config(arch="qwen2")
    params = jax_init_params(jax.random.key(7), cfg, jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


def _pixels(grids, cfg, seed):
    S = sum(t * h * w for t, h, w in grids)
    return np.random.default_rng(seed).normal(
        size=(S, cfg.vision.patch_dim)).astype(np.float32)


def test_init_params_have_the_qwen2_layout():
    cfg = tiny_config(arch="qwen2")
    p = init_params(cfg, seed=0)["visual"]
    assert set(p["blocks"][0]["norm1"]) == {"scale", "bias"}
    assert set(p["blocks"][0]["mlp"]) == {"fc1", "fc2"}
    assert set(p["merger"]["ln_q"]) == {"scale", "bias"}
    assert p["blocks"][0]["mlp"]["fc1"]["kernel"].shape == (32, 128)


@pytest.mark.parametrize("grids", [((2, 8, 12),), ((2, 8, 12), (2, 8, 8))],
                         ids=["one grid", "mixed grids"])
def test_vit_forward_matches_jax(tiny2, grids):
    cfg, params, tparams = tiny2
    px = _pixels(grids, cfg, 0)
    ref = np.asarray(jax_vit_forward(
        params["visual"], cfg.vision, jnp.asarray(px),
        jax_vision_layout(grids, cfg.vision), attn_impl="xla"))
    out = vit_forward(tparams["visual"], cfg.vision, torch.from_numpy(px),
                      vision_layout(grids, cfg.vision)).numpy()
    S = px.shape[0]
    assert out.shape == ref.shape == (S // 4, cfg.vision.out_hidden_size)
    np.testing.assert_allclose(out, ref, **TOL)


def test_vit_forward_remat_gradients_equal(tiny2):
    """remat recomputes each block in the backward pass: same loss and
    gradients as without it."""
    cfg, _, tparams = tiny2
    grids = ((2, 8, 8),)
    px = torch.from_numpy(_pixels(grids, cfg, 1))
    layout = vision_layout(grids, cfg.vision)
    grads = []
    for remat in (False, True):
        w = tparams["visual"]["blocks"][0]["mlp"]["fc1"]["kernel"]
        w.requires_grad_(True)
        vit_forward(tparams["visual"], cfg.vision, px, layout,
                    remat=remat).square().sum().backward()
        grads.append(w.grad.clone())
        w.grad = None
        w.requires_grad_(False)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def _video_prompt(cfg, grid):
    nv = grid[0] * grid[1] * grid[2] // 4
    ids = np.array([[10, 11, cfg.vision_start_token_id]
                    + [cfg.video_token_id] * nv
                    + [cfg.vision_end_token_id, 20, 21]])
    mask = np.ones_like(ids)
    pos, deltas = get_rope_index(cfg, ids, video_grid_thw=np.array([grid]),
                                 attention_mask=mask)
    return ids, mask, pos, deltas


def test_multimodal_forward_matches_jax(tiny2):
    cfg, params, tparams = tiny2
    grid = (2, 8, 12)
    ids, mask, pos, _ = _video_prompt(cfg, grid)
    px = _pixels([grid], cfg, 2)
    ref, _ = jax_forward(params, cfg, jnp.asarray(ids),
                         pixel_values=jnp.asarray(px), grid_thw=[grid],
                         position_ids=jnp.asarray(pos),
                         kv_mask=jnp.asarray(mask, bool), attn_impl="xla")
    with torch.no_grad():
        embeds = prologue(tparams, torch.from_numpy(ids), torch.from_numpy(px),
                          cfg=cfg, grid_thw=[grid])
        out, _ = lm_forward(tparams["model"], cfg.text, input_embeds=embeds,
                            position_ids=torch.from_numpy(np.asarray(pos)),
                            kv_mask=torch.from_numpy(mask.astype(bool)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_greedy_rollout_matches_jax(tiny2):
    """Sampler.generate (ViT through the all-full path, K2 plain decode)
    against the JAX sampler: identical greedy tokens."""
    cfg, params, tparams = tiny2
    grid = (2, 8, 8)
    ids, mask, pos, deltas = _video_prompt(cfg, grid)
    kw = dict(position_ids=pos, deltas=deltas,
              pixel_values=_pixels([grid], cfg, 3), grid_thw=(grid,),
              num_generations=2, max_new_tokens=10, temperature=0.0,
              top_p=1.0, seed=0)
    ref = JaxSampler(cfg, length_bucket=64, decode_impl="flash_ref").generate(
        ids, mask, params, **kw)
    out = Sampler(cfg, length_bucket=64).generate(ids, mask, tparams, **kw)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))


def test_export_load_round_trip(tmp_path, tiny2):
    """export_to_safetensors -> load_params_from_hf, bitwise, with the
    config read back to the same geometry; the loaded model encodes a video
    exactly as the exported one."""
    cfg, _, tparams = tiny2
    export_to_safetensors(tparams, cfg, str(tmp_path / "ckpt"))
    loaded, cfg2 = load_params_from_hf(str(tmp_path / "ckpt"),
                                       dtype=torch.float32, device="cpu")
    assert (cfg2.text, cfg2.vision) == (cfg.text, cfg.vision)
    grids = ((2, 8, 8),)
    px = torch.from_numpy(_pixels(grids, cfg, 4))
    layout = vision_layout(grids, cfg.vision)
    a = vit_forward(tparams["visual"], cfg.vision, px, layout)
    b = vit_forward(loaded["visual"], cfg.vision, px, layout)
    assert torch.equal(a, b)

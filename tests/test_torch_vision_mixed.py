"""Mixed grids in one ViT call: two videos whose frame chunks differ, grids
(2, 8, 12) and (2, 6, 10), at the tiny config (float32).

The port runs the full-attention blocks as one K4 call per grid over the
grid's contiguous token range (its plain version here); JAX masks segments
over the whole sequence.  Held to rtol 1e-5 (f32, summation order only):
- the merged embeddings and the gradient with respect to the pixels
  (absolute 1e-5 of its largest element where elements cancel), against
  JAX's encode_vision;
- the merged embeddings against the two grids encoded apart;
- the layout: each grid's tokens are contiguous in window order and no
  window crosses a grid (so the windowed blocks need nothing new);
- a greedy `Sampler.generate` over the two videos in one call (two
  prompts, G = 2) against JAX's sampler (decode_impl="flash_ref"): equal
  token ids.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import get_rope_index, init_params, tiny_config
from spacer_tpu.models.qwen25_vl.model import encode_vision as jax_encode
from spacer_tpu.sampler import Sampler as JaxSampler
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.models.qwen25_vl.model import encode_vision
from spacer_tpu_torch.models.qwen25_vl.vision import chunk_runs, vision_layout
from spacer_tpu_torch.sampler import Sampler

GRIDS = ((2, 8, 12), (2, 6, 10))


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    params = init_params(jax.random.key(0), cfg, jnp.float32)
    np_params = jax.tree.map(np.asarray, params)
    n = sum(t * h * w for t, h, w in GRIDS)
    px = np.random.default_rng(0).normal(
        size=(n, cfg.vision.patch_dim)).astype(np.float32)
    return cfg, params, np_params, px


def test_layout_keeps_grids_contiguous(setup):
    cfg = setup[0]
    layout = vision_layout(GRIDS, cfg.vision)
    assert layout.full_chunk == 0           # the chunks differ: 96 vs 60
    # one K4 call per grid; equal neighbouring grids share one
    assert chunk_runs(layout) == [(0, 192, 96), (192, 120, 60)]
    assert chunk_runs(vision_layout(GRIDS + GRIDS[1:], cfg.vision)) == [
        (0, 192, 96), (192, 240, 60)]
    assert chunk_runs(vision_layout(GRIDS[:1], cfg.vision)) == [(0, 192, 96)]
    grid_of = np.repeat([0, 1], [192, 120])
    # window order permutes within a grid only
    mu = cfg.vision.spatial_merge_unit
    units = layout.window_index
    assert (np.sort(units[:192 // mu]) == np.arange(192 // mu)).all()
    # every window's valid tokens lie in one grid
    for gather, valid in zip(layout.win_gather, layout.win_valid):
        assert len(set(grid_of[gather[valid]])) == 1


def test_mixed_grids_match_jax_segment_path(setup):
    cfg, params, np_params, px = setup
    w = np.random.default_rng(1).normal(
        size=(px.shape[0] // cfg.vision.spatial_merge_unit,
              cfg.vision.out_hidden_size)).astype(np.float32)

    def jloss(p):
        out = jax_encode(params, cfg, p, GRIDS, attn_impl="xla")
        return (out * w).sum(), out

    with jax.default_matmul_precision("highest"):
        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(px))
    tparams = params_from_jax(np_params, cfg)
    tpx = torch.from_numpy(px).requires_grad_(True)
    out = encode_vision(tparams, cfg, tpx, GRIDS, remat=True)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    # gradient elements sum many products and can cancel to near zero:
    # their absolute tolerance is 1e-5 of the largest gradient
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tpx.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jgrad).max()))


def test_mixed_grids_equal_grids_apart(setup):
    cfg, _, np_params, px = setup
    tparams = params_from_jax(np_params, cfg)
    with torch.no_grad():
        both = encode_vision(tparams, cfg, torch.from_numpy(px), GRIDS)
        n0 = 2 * 8 * 12
        a = encode_vision(tparams, cfg, torch.from_numpy(px[:n0]), GRIDS[:1])
        b = encode_vision(tparams, cfg, torch.from_numpy(px[n0:]), GRIDS[1:])
    np.testing.assert_allclose(both.numpy(), torch.cat([a, b]).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_two_unequal_videos_generate_like_jax(setup):
    cfg, params, np_params, px = setup
    mu = cfg.vision.spatial_merge_unit
    rows = []
    for t, h, w in GRIDS:
        rows.append([10, 11, cfg.vision_start_token_id]
                    + [cfg.video_token_id] * (t * h * w // mu)
                    + [cfg.vision_end_token_id, 20, 21])
    L = max(map(len, rows))
    ids = np.array([[cfg.pad_token_id] * (L - len(r)) + r for r in rows])
    mask = np.array([[0] * (L - len(r)) + [1] * len(r) for r in rows])
    pos, deltas = get_rope_index(cfg, ids, video_grid_thw=np.array(GRIDS),
                                 attention_mask=mask)
    kw = dict(position_ids=pos, deltas=deltas, pixel_values=px, grid_thw=GRIDS,
              num_generations=2, max_new_tokens=10, temperature=0.0,
              top_p=1.0, seed=0)
    ref = JaxSampler(cfg, length_bucket=64, decode_impl="flash_ref").generate(
        ids, mask, params, **kw)
    out = Sampler(cfg, length_bucket=64).generate(
        ids, mask, params_from_jax(np_params, cfg), **kw)
    assert out.sequences.shape == (4, 10)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))

"""K3/K4 and the ViT: spacer_tpu_torch against spacer_tpu on the same inputs.

- K3 / K4 plain versions against the Pallas kernels in interpret mode (the
  JAX side zero-pads head_dim to 128 lanes, as its ViT does, and the result
  is sliced back).  Tolerance 1e-5 in f32: summation order only.
- vit_forward / encode_vision against JAX vit_forward(attn_impl="pallas")
  on converted weights.  Tolerance 1e-4 in f32: four blocks of matmuls,
  norms and MLPs accumulate the per-op ~1e-6 differences.
- vision_layout: the copied numpy code gives identical arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import init_params as jax_init_params
from spacer_tpu.models.qwen25_vl.config import tiny_config
from spacer_tpu.models.qwen25_vl.model import encode_vision as jax_encode_vision
from spacer_tpu.models.qwen25_vl.vision import (
    vision_layout as jax_vision_layout,
    vit_forward as jax_vit_forward,
)
from spacer_tpu.ops import vit_window_attention as jwa
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.models.qwen25_vl.model import encode_vision
from spacer_tpu_torch.models.qwen25_vl.vision import vision_layout, vit_forward
from spacer_tpu_torch.ops import vit_window_attention as twa

TOL = dict(atol=1e-5, rtol=1e-5)
GRIDS = [((2, 8, 8),), ((2, 8, 12),), ((2, 8, 12), (2, 8, 12))]


def _qkv(seed, H, S, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(H, S, D)).astype(np.float32) for _ in range(3)]


def _jax_hsd(fn, arrays, *args):
    """Run a JAX (H, S, 128k) kernel on D-wide inputs: pad, run, slice."""
    D = arrays[0].shape[-1]
    pad = [jnp.pad(jnp.asarray(a), ((0, 0), (0, 0), (0, 128 - D)))
           for a in arrays]
    return np.asarray(fn(*pad, *args))[..., :D]


def test_window_attention_matches_pallas():
    H, wt, D = 2, 64, 16
    lengths = [64, 32, 5, 64]
    q, k, v = _qkv(0, H, wt * len(lengths), D)
    bias = twa.validity_bias(lengths, wt)
    np.testing.assert_array_equal(bias, jwa.validity_bias(lengths, wt))
    scale = D ** -0.5
    out = twa.window_attention_hsd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   torch.from_numpy(bias), wt, scale).numpy()
    ref = _jax_hsd(jwa.window_attention_hsd, (q, k, v), jnp.asarray(bias), wt,
                   scale, True)
    np.testing.assert_allclose(out, ref, **TOL)


# (wt, D): a small chunk; the ViT's 480-token chunk and a 252-token one
# (18 x 14 patches, no multiple of 64) at its head width 80, the shapes the
# card compares K4 with this plain version at
@pytest.mark.parametrize("wt,D", [(96, 16), (480, 80), (252, 80)])
def test_chunk_attention_matches_pallas(wt, D):
    H = 2
    q, k, v = _qkv(1, H, 2 * wt, D)
    scale = D ** -0.5
    out = twa.chunk_attention_hsd(*(torch.from_numpy(x) for x in (q, k, v)),
                                  wt, scale).numpy()
    ref = _jax_hsd(jwa.chunk_attention_hsd, (q, k, v), wt, scale, True)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("grids", GRIDS)
def test_vision_layout_is_identical(grids):
    cfg = tiny_config()
    a, b = vision_layout(grids, cfg.vision), jax_vision_layout(grids, cfg.vision)
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), err_msg=name)


@pytest.fixture(scope="module")
def vit_params():
    cfg = tiny_config()
    params = jax_init_params(jax.random.key(3), cfg, jnp.float32)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params), cfg)


@pytest.mark.parametrize("grids", GRIDS[1:])
def test_vit_forward_matches_jax_pallas_path(vit_params, grids):
    cfg, params, tparams = vit_params
    S = sum(t * h * w for t, h, w in grids)
    px = np.random.default_rng(4).normal(
        size=(S, cfg.vision.patch_dim)).astype(np.float32)
    ref = np.asarray(jax_vit_forward(
        params["visual"], cfg.vision, jnp.asarray(px),
        jax_vision_layout(grids, cfg.vision), attn_impl="pallas"))
    out = vit_forward(tparams["visual"], cfg.vision, torch.from_numpy(px),
                      vision_layout(grids, cfg.vision)).numpy()
    assert out.shape == ref.shape == (S // 4, cfg.vision.out_hidden_size)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_encode_vision_matches_jax(vit_params):
    cfg, params, tparams = vit_params
    grids = GRIDS[0]
    S = sum(t * h * w for t, h, w in grids)
    px = np.random.default_rng(5).normal(
        size=(S, cfg.vision.patch_dim)).astype(np.float32)
    ref = np.asarray(jax_encode_vision(params, cfg, jnp.asarray(px), grids,
                                       attn_impl="pallas"))
    out = encode_vision(tparams, cfg, torch.from_numpy(px), grids).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

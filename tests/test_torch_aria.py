"""Aria parity: spacer_tpu_torch.models.aria against spacer_tpu.models.aria
on the same weights (the JAX tree converted by params_from_jax), float32 on
the CPU at tiny_aria_config: the MoE LM's logits with and without left
padding, the cached decode against the full forward, the ViT and the
projector under a patch mask, the full forward with an image, the 1D
positions, the tiling of vision rows across completions, and the converted
tree's layout.

Router weights are drawn wide (normal 0.5, as tests/test_aria_generate.py
does) so that no near-tie flips a top-k choice between the packages.
Tolerance 1e-4 abs/rel (tests/test_torch_language.py's): two decoder and
two ViT layers of f32 products that differ in summation order only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models import aria as jaria
from spacer_tpu.models.registry import aria_positions as jax_aria_positions
from spacer_tpu_torch.models import aria
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.models.registry import aria_positions, get_family
from spacer_tpu_torch.ops import launch_counts, reset_launch_counts

TOL = dict(atol=1e-4, rtol=1e-4)


def wide_routers(np_params, seed=0):
    """The JAX tree (numpy) with every layer's router drawn normal(0, 0.5)."""
    r = np_params["model"]["layers"]["mlp"]["router"]
    r["kernel"] = np.random.default_rng(seed).normal(
        0, 0.5, r["kernel"].shape).astype(np.float32)
    return np_params


@pytest.fixture(scope="module")
def model():
    cfg = aria.tiny_aria_config()
    np_params = wide_routers(jax.tree.map(
        np.asarray, jaria.init_params(jax.random.key(5), cfg, jnp.float32)))
    return cfg, jax.tree.map(jnp.asarray, np_params), params_from_jax(
        np_params, cfg)


def _image(cfg, valid_rows: int = 3, seed: int = 0):
    """One crop (1, S, S, 3) and its NaViT ids / patch mask: the bottom rows
    of patches beyond `valid_rows` are padding."""
    v = cfg.vision
    side = v.image_size // v.patch_size
    px = np.random.default_rng(seed).uniform(
        -1, 1, (1, v.image_size, v.image_size, 3)).astype(np.float32)
    mask = np.zeros((1, side, side), bool)
    mask[:, :valid_rows] = True
    pos = aria.vision_position_ids(valid_rows, side, v, side, side)[None]
    return px, pos, mask.reshape(1, -1)


def test_lm_logits_match_jax_with_left_padding(model):
    cfg, jparams, tparams = model
    B, S, pad = 2, 11, 4
    rng = np.random.default_rng(1)
    ids = rng.integers(10, cfg.text.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, :pad] = 0
    ids[1, :pad] = cfg.pad_token_id
    pos, _ = aria_positions(cfg, ids, mask)
    ref, _ = jaria.lm_forward(jparams["model"], cfg.text,
                              input_ids=jnp.asarray(ids),
                              position_ids=jnp.asarray(pos),
                              kv_mask=jnp.asarray(mask, bool))
    got, _ = aria.lm_forward(tparams["model"], cfg.text,
                             input_ids=torch.from_numpy(ids).long(),
                             position_ids=torch.from_numpy(pos),
                             kv_mask=torch.from_numpy(mask).bool())
    ref = np.asarray(ref)
    np.testing.assert_allclose(got[0].numpy(), ref[0], **TOL)
    np.testing.assert_allclose(got[1, pad:].numpy(), ref[1, pad:], **TOL)


def test_cached_decode_matches_full_forward(model):
    """Prefill into a KV cache, then one token at a time: every step's
    logits equal the full forward's (JAX) at that position."""
    cfg, jparams, tparams = model
    B, S, T = 2, 6, 10
    rng = np.random.default_rng(2)
    ids = rng.integers(10, cfg.text.vocab_size, (B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy()
    ref, _ = jaria.lm_forward(jparams["model"], cfg.text,
                              input_ids=jnp.asarray(ids),
                              position_ids=jnp.asarray(pos))
    ref = np.asarray(ref)
    cache = aria.make_kv_cache(cfg, B, T, dtype=torch.float32)
    full_mask = torch.ones((B, T), dtype=torch.bool)
    tids, tpos = torch.from_numpy(ids).long(), torch.from_numpy(pos)
    with torch.no_grad():
        logits, cache = aria.lm_forward(
            tparams["model"], cfg.text, input_ids=tids[:, :S],
            position_ids=tpos[:, :, :S], kv_mask=full_mask, cache=cache,
            cache_index=0)
        np.testing.assert_allclose(logits.numpy(), ref[:, :S], **TOL)
        for t in range(S, T):
            step, cache = aria.lm_forward(
                tparams["model"], cfg.text, input_ids=tids[:, t:t + 1],
                position_ids=tpos[:, :, t:t + 1],
                kv_mask=torch.arange(T)[None].expand(B, T) <= t, cache=cache,
                cache_index=t)
            np.testing.assert_allclose(step[:, 0].numpy(), ref[:, t], **TOL)


def test_vit_and_projector_match_jax_with_patch_mask(model):
    cfg, jparams, tparams = model
    px, pos, pmask = _image(cfg)
    jfeat, jpost = jaria.vit_forward(jparams["visual"], cfg.vision,
                                     jnp.asarray(px), jnp.asarray(pos),
                                     patch_mask=jnp.asarray(pmask))
    feat, post = aria.vit_forward(tparams["visual"], cfg.vision,
                                  torch.from_numpy(px), torch.from_numpy(pos),
                                  patch_mask=torch.from_numpy(pmask))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), **TOL)
    np.testing.assert_allclose(post.numpy(), np.asarray(jpost), **TOL)
    jout = jaria.projector_forward(jparams["projector"], cfg, jfeat,
                                   patch_mask=jnp.asarray(pmask))
    out = aria.projector_forward(tparams["projector"], cfg, feat,
                                 patch_mask=torch.from_numpy(pmask))
    assert out.shape == (1, cfg.max_projector_queries, cfg.text.hidden_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_full_forward_with_image_matches_jax(model):
    """Text, 8 <|img|> placeholders (one crop's queries) and more text, the
    image through the ViT, the projector and the masked scatter."""
    cfg, jparams, tparams = model
    px, pos, pmask = _image(cfg, valid_rows=4, seed=3)
    ids = np.random.default_rng(4).integers(10, cfg.text.vocab_size, (1, 14))
    ids[0, 2:2 + cfg.max_projector_queries] = cfg.image_token_id
    ids = ids.astype(np.int32)
    text_pos = np.arange(14, dtype=np.int32)[None]
    ref, _ = jaria.forward(jparams, cfg, jnp.asarray(ids),
                           pixel_values=jnp.asarray(px),
                           pixel_position_ids=jnp.asarray(pos),
                           patch_mask=jnp.asarray(pmask),
                           position_ids=jnp.asarray(text_pos))
    reset_launch_counts()
    got, _ = aria.forward(tparams, cfg, torch.from_numpy(ids).long(),
                          pixel_values=torch.from_numpy(px),
                          pixel_position_ids=torch.from_numpy(pos),
                          patch_mask=torch.from_numpy(pmask),
                          position_ids=torch.from_numpy(text_pos))
    assert set(launch_counts().values()) == {0}   # CPU: plain versions only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_aria_positions_match_jax():
    cfg = aria.tiny_aria_config()
    mask = np.ones((3, 9), np.int32)
    mask[1, :4] = 0
    mask[2, :8] = 0
    got = aria_positions(cfg, np.zeros_like(mask), mask)
    ref = jax_aria_positions(cfg, np.zeros_like(mask), mask)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert got[0].shape == (3, 3, 9) and got[1].shape == (3, 1)


@pytest.mark.parametrize("media", [None, (2,), (1, 3)])
def test_tile_vision_embeds_matches_jax(media):
    """The family's tiling of per-prompt projector rows across G
    completions (crop counts per prompt, Q = 8 rows a crop)."""
    from spacer_tpu.models.registry import (
        _aria_tile_vision_embeds as jax_tile,
    )

    cfg = aria.tiny_aria_config()
    ve = np.random.default_rng(6).normal(
        size=(8 * sum(media or (1,)), 5)).astype(np.float32)
    got = get_family("aria").tile_vision_embeds(torch.from_numpy(ve), cfg,
                                                None, 3, media)
    ref = jax_tile(jnp.asarray(ve), cfg, None, 3, media)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_params_from_jax_layout_equals_init_params(model):
    """The converted JAX tree has the port's own layout (per-layer lists of
    the LM and the ViT encoder, the projector as a dict): the same paths
    and shapes as aria.init_params, and the registry resolves the family."""
    cfg, _, tparams = model

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in shapes(sub, f"{prefix}{key}/").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in shapes(sub, f"{prefix}{i}/").items()}
        return {prefix[:-1]: tuple(tree.shape)}

    assert shapes(tparams) == shapes(aria.init_params(cfg))
    assert len(tparams["model"]["layers"]) == cfg.text.num_layers
    assert len(tparams["visual"]["encoder"]) == cfg.vision.num_layers
    fam = get_family("rhymes-ai/Aria")
    assert fam.name == "aria" and get_family("AriaConfig") is fam

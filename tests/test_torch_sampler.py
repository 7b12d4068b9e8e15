"""The grouped rollout sampler: spacer_tpu_torch Sampler.generate against
spacer_tpu's Sampler with decode_impl="flash_ref" (head-major shared-prefix
decode through the K2 reference), same converted float32 weights, a video
prompt and a text prompt of different lengths (left padding), G=2.

Greedy decoding must give identical token ids, completion masks and
lengths: both sides compute f32 and differ in summation order only, far
below the logit gaps of a random tiny model's argmax.  The same holds for
the quantized rollouts (decode_quant "int8_kv" and "int4_kv"): the weight
and KV codes are equal on both sides (tests/test_torch_quant.py), and the
int4 products round x to bf16 on both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.models.qwen25_vl import get_rope_index, init_params, tiny_config
from spacer_tpu.sampler import Sampler as JaxSampler
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
from spacer_tpu_torch.sampler import Sampler

GRID = ((2, 8, 8),)


def _prompts(cfg):
    n_video = 2 * 8 * 8 // 4
    video = ([10, 11, cfg.vision_start_token_id] + [cfg.video_token_id] * n_video
             + [cfg.vision_end_token_id, 20, 21])
    text = [30 + i for i in range(12)]
    L = len(video)
    ids = np.array([video, [cfg.pad_token_id] * (L - len(text)) + text])
    mask = np.array([[1] * L, [0] * (L - len(text)) + [1] * len(text)])
    pos, deltas = get_rope_index(cfg, ids, video_grid_thw=np.array(GRID),
                                 attention_mask=mask)
    px = np.random.default_rng(0).normal(
        size=(2 * 8 * 8, cfg.vision.patch_dim)).astype(np.float32)
    return ids, mask, pos, deltas, px


@pytest.mark.parametrize("max_new", [12])
def test_greedy_generate_matches_jax_flash_ref(max_new):
    cfg = tiny_config()
    params = init_params(jax.random.key(0), cfg, jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    ids, mask, pos, deltas, px = _prompts(cfg)
    kw = dict(position_ids=pos, deltas=deltas, pixel_values=px, grid_thw=GRID,
              num_generations=2, max_new_tokens=max_new, temperature=0.0,
              top_p=1.0, seed=0)
    ref = JaxSampler(cfg, length_bucket=64, decode_impl="flash_ref").generate(
        ids, mask, params, **kw)
    reset_launch_counts()
    out = Sampler(cfg, length_bucket=64).generate(ids, mask, tparams, **kw)
    assert set(launch_counts().values()) == {0}   # CPU: plain versions only
    assert out.sequences.shape == (4, max_new)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.completion_mask,
                                  np.asarray(ref.completion_mask))
    np.testing.assert_array_equal(out.lengths, np.asarray(ref.lengths))


def _decode_logits(monkeypatch, sampler, *args, **kw):
    """Run sampler.generate and return the logits of every sampled step."""
    import spacer_tpu_torch.sampler.sampler as sm

    seen, sample = [], sm.sample_logits

    def record(logits, *a):
        seen.append(logits)
        return sample(logits, *a)

    monkeypatch.setattr(sm, "sample_logits", record)
    out = sampler.generate(*args, **kw)
    monkeypatch.setattr(sm, "sample_logits", sample)
    return out, torch.cat(seen)


@pytest.mark.parametrize("quant", ["int8_kv", "int4_kv"])
def test_greedy_generate_quantized_matches_jax_flash_ref(quant, monkeypatch):
    cfg = tiny_config()
    params = init_params(jax.random.key(0), cfg, jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    ids, mask, pos, deltas, px = _prompts(cfg)
    kw = dict(position_ids=pos, deltas=deltas, pixel_values=px, grid_thw=GRID,
              num_generations=2, max_new_tokens=12, temperature=0.0,
              top_p=1.0, seed=0)
    ref = JaxSampler(cfg, length_bucket=64, decode_impl="flash_ref",
                     decode_quant=quant).generate(ids, mask, params, **kw)
    _, plain = _decode_logits(monkeypatch, Sampler(cfg, length_bucket=64),
                              ids, mask, tparams, **kw)
    reset_launch_counts()
    out, logits = _decode_logits(
        monkeypatch, Sampler(cfg, length_bucket=64, decode_quant=quant),
        ids, mask, tparams, **kw)
    assert set(launch_counts().values()) == {0}   # CPU: plain versions only
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.lengths, np.asarray(ref.lengths))
    # the decode steps (not the prefill's first token) ran quantized
    assert torch.equal(logits[:4], plain[:4])
    assert float((logits[4:] - plain[4:]).abs().max()) > 1e-4


def test_unported_configurations_raise():
    """A mesh that is not the port's parallel.mesh.Mesh raises TypeError
    and a tp that does not divide Aria's heads or widths ValueError (the
    tiny tower's 2 heads at tp 4); Aria's and Qwen's tp-2 meshes construct
    since tensor parallelism was ported (tests/test_torch_tp_model.py,
    tests/test_torch_aria_tp.py), as the data x fsdp mesh does
    (tests/test_torch_parallel.py); speculative decode is ported
    (tests/test_torch_sampler_speculative.py) and constructs."""
    from spacer_tpu_torch.models.aria import tiny_aria_config
    from spacer_tpu_torch.parallel.mesh import Mesh

    cfg = tiny_config()
    with pytest.raises(TypeError):
        Sampler(cfg, mesh=object())
    tp_mesh = Mesh({"data": 1, "fsdp": 2, "tp": 2}, rank=0)
    assert Sampler(tiny_aria_config(), mesh=tp_mesh).mesh.shape["tp"] == 2
    with pytest.raises(ValueError, match="tower's num_heads=2"):
        Sampler(tiny_aria_config(), mesh=Mesh({"tp": 4}, rank=0))
    assert Sampler(cfg, mesh=tp_mesh).mesh.shape["tp"] == 2
    assert Sampler(cfg, mesh=Mesh({"fsdp": 2}, rank=1)).mesh.coords == {
        "data": 0, "fsdp": 1, "tp": 0}
    assert Sampler(cfg, speculate_k=2).speculate_k == 2
    with pytest.raises(ValueError, match="speculate_k"):
        Sampler(cfg, speculate_k=-1)
    for quant in (None, "int8", "int8_kv", "int4", "int4_kv"):
        assert Sampler(cfg, decode_quant=quant).decode_quant == quant
    with pytest.raises(ValueError, match="decode_quant"):
        Sampler(cfg, decode_quant="int2")
    with pytest.raises(ValueError):   # an id past the vocabulary
        Sampler(cfg).generate(np.array([[cfg.text.vocab_size]]),
                              np.ones((1, 1)), {"model": {}},
                              position_ids=np.zeros((3, 1, 1)),
                              deltas=np.zeros((1, 1)))
    torch.manual_seed(0)

"""Aria generation through the port's family-generic entry points against
spacer_tpu's, same converted float32 weights at tiny_aria_config: greedy
Sampler.generate tokens for left-padded text prompts (G = 2) and for an
image prompt that goes through the AriaProcessor, the ViT and the
projector; QwenEngine.generate_many (the continuous batcher) on text; and
the serving encode of an image request, which the reference drops silently
and the port refuses.

Greedy decoding must give identical token ids: both sides compute f32 and
differ in summation order only, far below the logit gaps of the argmax.
Router weights are drawn wide (normal 0.5, as tests/test_aria_generate.py
does) so that no near-tie flips a top-k choice between the packages.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.data.aria_processor import AriaProcessor as JaxAriaProcessor
from spacer_tpu.data.aria_processor import MockAriaTokenizer as JaxTokenizer
from spacer_tpu.evalharness.engine import QwenEngine as JaxEngine
from spacer_tpu.models import aria as jaria
from spacer_tpu.models.registry import encode_request as jax_encode_request
from spacer_tpu.sampler import Sampler as JaxSampler
from spacer_tpu_torch.data.aria_processor import AriaProcessor, MockAriaTokenizer
from spacer_tpu_torch.evalharness.engine import QwenEngine
from spacer_tpu_torch.models.aria import tiny_aria_config
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.models.registry import (
    aria_positions,
    encode_request,
    get_family,
)
from spacer_tpu_torch.ops import launch_counts, reset_launch_counts
from spacer_tpu_torch.sampler import Sampler

# the tiny tower's 56-pixel crops give 16 patches -> 8 projector queries
PROC_KW = dict(max_image_size=56, min_image_size=14,
               size_conversion={56: 8})


@pytest.fixture(scope="module")
def model():
    cfg = tiny_aria_config()
    np_params = jax.tree.map(np.asarray, jaria.init_params(
        jax.random.key(11), cfg, jnp.float32))
    r = np_params["model"]["layers"]["mlp"]["router"]
    r["kernel"] = np.random.default_rng(3).normal(
        0, 0.5, r["kernel"].shape).astype(np.float32)
    return (cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, cfg))


def _image_messages():
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3), np.uint8)
    return [[{"role": "user", "content": [
        {"type": "image", "image": img},
        {"type": "text", "text": "what is in the picture"}]}]]


@pytest.mark.parametrize("decode_quant", [None, "int8_kv", "int4_kv"])
def test_greedy_text_tokens_match_jax(model, decode_quant):
    """f32 rollouts, and the quantized ones: the router and the experts
    stay unquantized on both sides (ops/quant.py's skip list), the
    attention and shared-expert kernels and lm_head take equal codes."""
    cfg, jparams, tparams = model
    B, S, pad = 2, 9, 3
    rng = np.random.default_rng(0)
    ids = rng.integers(10, cfg.text.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    ids[1, :pad], mask[1, :pad] = cfg.pad_token_id, 0
    pos, deltas = aria_positions(cfg, ids, mask)
    kw = dict(position_ids=pos, deltas=deltas, num_generations=2,
              max_new_tokens=8, temperature=0.0)
    ref = JaxSampler(cfg, length_bucket=16, decode_quant=decode_quant
                     ).generate(ids, mask, jparams, **kw)
    reset_launch_counts()
    out = Sampler(cfg, length_bucket=16, decode_quant=decode_quant
                  ).generate(ids, mask, tparams, **kw)
    assert set(launch_counts().values()) == {0}   # CPU: plain versions only
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.completion_mask,
                                  np.asarray(ref.completion_mask))


def test_greedy_image_tokens_match_jax(model):
    cfg, jparams, tparams = model
    msgs = _image_messages()
    enc = AriaProcessor(MockAriaTokenizer(cfg.text.vocab_size), cfg,
                        **PROC_KW).process_messages(msgs)
    jenc = JaxAriaProcessor(JaxTokenizer(cfg.text.vocab_size), cfg,
                            **PROC_KW).process_messages(copy.deepcopy(msgs))
    np.testing.assert_array_equal(enc["input_ids"], jenc["input_ids"])
    assert not enc["patch_mask"].all()   # the 40-pixel side is padded
    vision_kwargs, _ = get_family("aria").pack_vision(enc)
    pos, deltas = aria_positions(cfg, enc["input_ids"], enc["attention_mask"])
    kw = dict(position_ids=pos, deltas=deltas, vision_kwargs=vision_kwargs,
              num_generations=1, max_new_tokens=6, temperature=0.0)
    ref = JaxSampler(cfg, length_bucket=16).generate(
        enc["input_ids"], enc["attention_mask"], jparams, **kw)
    out = Sampler(cfg, length_bucket=16).generate(
        enc["input_ids"], enc["attention_mask"], tparams, **kw)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))


def test_batcher_text_matches_jax(model):
    cfg, jparams, tparams = model
    msgs = [[{"role": "user", "content": "count the chairs in the room"}],
            [{"role": "user", "content": "x y"}],
            [{"role": "user", "content": "what is on the table today"}]]
    kw = dict(max_new_tokens=7, temperature=0.0, slots=2, chunk_steps=3)
    ref = JaxEngine(cfg, jparams, JaxAriaProcessor(
        JaxTokenizer(cfg.text.vocab_size), cfg), length_bucket=32
    ).generate_many(copy.deepcopy(msgs), **kw)
    got = QwenEngine(cfg, tparams, AriaProcessor(
        MockAriaTokenizer(cfg.text.vocab_size), cfg), length_bucket=32
    ).generate_many(copy.deepcopy(msgs), **kw)
    assert got == ref and all(got)


def test_image_request_reference_drops_vision_port_refuses(model):
    """The reference's encode_request packs only Qwen's grid keys, so an
    Aria image request reaches its batcher without vision inputs (the
    <|img|> tokens embedded as text); the port refuses the request."""
    cfg = model[0]
    msgs = _image_messages()[0]
    jreq = jax_encode_request(JaxAriaProcessor(
        JaxTokenizer(cfg.text.vocab_size), cfg, **PROC_KW), cfg,
        copy.deepcopy(msgs))
    assert "vision_kwargs" not in jreq
    assert (np.asarray(jreq["input_ids"]) == cfg.image_token_id).sum() == 8
    with pytest.raises(NotImplementedError, match="Sampler.generate"):
        encode_request(AriaProcessor(MockAriaTokenizer(cfg.text.vocab_size),
                                     cfg, **PROC_KW), cfg, msgs)


def test_decode_quant_skips_router_and_experts(model):
    """quantize_decode_model on the Aria LM: the router and the experts are
    the float tensors themselves; every attention and shared-expert dense
    and lm_head carry int4 codes (K6 on the card)."""
    from spacer_tpu_torch.ops.quant import quantize_decode_model

    tparams = model[2]["model"]
    q = quantize_decode_model(tparams, "int4_kv")
    for lq, lp in zip(q["layers"], tparams["layers"]):
        assert lq["mlp"]["router"] is lp["mlp"]["router"]
        assert lq["mlp"]["experts"] is lp["mlp"]["experts"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            assert lq["self_attn"][n]["kernel_q4"].dtype == torch.int8
        for n in ("gate_proj", "up_proj", "down_proj"):
            assert lq["mlp"]["shared"][n]["kernel_q4"].dtype == torch.int8
    assert "kernel_q4" in q["lm_head"]

"""K1 parity: spacer_tpu_torch flash_attention (its plain version on CPU)
against spacer_tpu's Pallas flash_attention in interpret mode and its XLA
reference, on the same numpy inputs.

Tolerance: 1e-5 abs/rel in float32.  Both sides compute f32 logits and
softmax; they differ only in summation order (online vs one-shot softmax),
which moves O(1) outputs by ~1e-6.  Only rows with at least one visible key
are compared: a fully masked row is defined as finite garbage on both sides
(the mean of V), and its exact value depends on the kernel's blocking.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spacer_tpu.nn.attention import xla_attention as jax_xla_attention
from spacer_tpu.ops.flash_attention import flash_attention as jax_flash
from spacer_tpu_torch.ops.flash_attention import flash_attention

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, B, Sq, Skv, Hq, Hkv, D, pad):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    mask = np.ones((B, Skv), bool)
    for b, p in enumerate(pad):
        mask[b, :p] = False   # left padding
    return q, k, v, mask


@pytest.mark.parametrize("q_offset,Sq,Skv", [(0, 128, 128), (128, 128, 256)])
def test_causal_leftpad_gqa_matches_jax(q_offset, Sq, Skv):
    B, Hq, Hkv, D = 2, 4, 2, 16
    pad = (0, 37)
    q, k, v, mask = _inputs(0, B, Sq, Skv, Hq, Hkv, D, pad)
    kw = dict(causal=True, q_offset=q_offset)
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               kv_mask=torch.from_numpy(mask),
                               return_lse=True, **kw)
    jq, jk, jv, jm = (jnp.asarray(x) for x in (q, k, v, mask))
    ref_kernel = np.asarray(jax_flash(jq, jk, jv, kv_mask=jm, interpret=True,
                                      **kw))
    ref_xla = np.asarray(jax_xla_attention(jq, jk, jv, kv_mask=jm, **kw))
    out = out.numpy()
    for b, p in enumerate(pad):
        rows = slice(max(0, p - q_offset), Sq)   # rows that see a live key
        np.testing.assert_allclose(out[b, rows], ref_kernel[b, rows], **TOL)
        np.testing.assert_allclose(out[b, rows], ref_xla[b, rows], **TOL)
    assert np.isfinite(out).all() and np.isfinite(lse.numpy()).all()


def test_lse_matches_direct_logsumexp():
    B, S, H, D = 1, 64, 2, 8
    q, k, v, _ = _inputs(1, B, S, S, H, H, D, (0,))
    _, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, return_lse=True)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    logits = np.where(np.tril(np.ones((S, S), bool)), logits, -1e30)
    ref = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) \
        + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref, **TOL)


def test_segment_ids_match_jax():
    B, S, H, D = 1, 128, 2, 16
    q, k, v, _ = _inputs(2, B, S, S, H, H, D, (0,))
    seg = np.repeat(np.arange(4), S // 4)[None].astype(np.int32)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          q_segment_ids=torch.from_numpy(seg),
                          kv_segment_ids=torch.from_numpy(seg))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    q_segment_ids=jnp.asarray(seg),
                    kv_segment_ids=jnp.asarray(seg), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

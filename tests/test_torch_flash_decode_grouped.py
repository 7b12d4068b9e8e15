"""K2 parity: spacer_tpu_torch flash_decode_attention (its plain version on
CPU) against spacer_tpu's Pallas shared-prefix grouped decode kernel in
interpret mode and its XLA reference, with a left-padded prompt and live
tail length step < T (the dead tail must not be read).

Tolerance: 2e-5 abs/rel in float32, as the JAX package's own kernel test:
online vs one-shot softmax summation order only.  In bf16 the plain version
rounds the probabilities to bf16 before P.V as the JAX reference does;
there 1e-2 (a different f32 summation order can flip one bf16 rounding of a
probability, 2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spacer_tpu.ops.flash_decode import (
    decode_attention_reference as jax_reference,
    flash_decode_attention as jax_kernel,
)
from spacer_tpu_torch.ops.flash_decode import (
    decode_attention_reference,
    flash_decode_attention,
)

TOL = dict(atol=2e-5, rtol=2e-5)


def _case(seed=0, B=2, Hkv=2, G=3, gq=2, Dh=128, P=256, T=128):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q = mk(B, Hkv, G * gq, Dh)
    pk, pv = mk(B, Hkv, P, Dh), mk(B, Hkv, P, Dh)
    tk, tv = mk(B * G, Hkv, T, Dh), mk(B * G, Hkv, T, Dh)
    mask = np.ones((B, P), bool)
    mask[0, :P // 3] = False   # left padding on prompt 0
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)[:, None, :]
    kw = dict(group=G, group_q=gq, sm_scale=Dh ** -0.5)
    return (q, pk, pv, bias, tk, tv), kw


@pytest.mark.parametrize("step", [1, 37, 100])
def test_grouped_decode_matches_jax_kernel_and_reference(step):
    args, kw = _case()
    tk = args[4].copy()
    tk[:, :, step:] = 1e4   # dead tail: reading it would swamp the softmax
    args = (*args[:4], tk, args[5])
    before = flash_decode_attention.launches
    out = flash_decode_attention(*(torch.from_numpy(a) for a in args), step,
                                 **kw).numpy()
    assert flash_decode_attention.launches == before   # no kernel on CPU
    assert out.dtype == np.float32 and np.isfinite(out).all()
    jargs = [jnp.asarray(a) for a in args]
    ref_kernel = np.asarray(jax_kernel(*jargs, step, interpret=True, **kw))
    ref_xla = np.asarray(jax_reference(*jargs, step, **kw))
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)


@pytest.mark.parametrize("step", [1, 65])
def test_grouped_decode_g16_matches_jax_kernel_and_reference(step):
    """G = 16 completions of group_q 7 (112 query rows per prompt, more than
    one 64-row tile of the CUDA kernel's prefix jobs; the port once refused
    G * group_q > 64 where JAX takes any): the plain version against the
    JAX kernel in interpret mode and its reference."""
    args, kw = _case(2, B=2, Hkv=1, G=16, gq=7, P=256, T=128)
    tk = args[4].copy()
    tk[:, :, step:] = 1e4   # dead tail: reading it would swamp the softmax
    args = (*args[:4], tk, args[5])
    out = flash_decode_attention(*(torch.from_numpy(a) for a in args), step,
                                 **kw).numpy()
    assert out.shape == (2, 1, 112, 128) and np.isfinite(out).all()
    jargs = [jnp.asarray(a) for a in args]
    ref_kernel = np.asarray(jax_kernel(*jargs, step, interpret=True, **kw))
    ref_xla = np.asarray(jax_reference(*jargs, step, **kw))
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)


def test_bf16_plain_version_matches_jax_reference():
    """bf16 caches through the port's plain version against the JAX
    reference on the same bf16-representable values held in f32 (JAX's CPU
    backend has no bf16 x bf16 -> f32 dot)."""
    args, kw = _case(1)
    step = 57
    tq = [torch.from_numpy(a) for a in args]
    tq = [t if i == 3 else t.to(torch.bfloat16) for i, t in enumerate(tq)]
    out = decode_attention_reference(*tq, step, **kw).numpy()
    ref = np.asarray(jax_reference(*(jnp.asarray(t.float().numpy()) for t in tq),
                                   step, **kw))
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=1e-2)

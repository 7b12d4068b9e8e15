"""K5 parity: spacer_tpu_torch flash_ragged_decode_attention (its plain
version on CPU) against spacer_tpu's Pallas ragged decode kernel in interpret
mode and its XLA reference, with ring wrap-around, empty slots and ragged
prefixes built as the batcher builds them.

Tolerance: 1e-5 abs/rel in float32 (online vs one-shot softmax summation
order).  Rows of empty slots have no live key: they are checked to be
finite, not compared (the kernels define them as finite garbage).
"""

import numpy as np
import torch

import jax.numpy as jnp

from spacer_tpu.ops.flash_decode import (
    flash_ragged_decode_attention as jax_kernel,
    ragged_decode_attention_reference as jax_reference,
)
from spacer_tpu_torch.ops.flash_decode import (
    flash_ragged_decode_attention,
    ragged_decode_attention_reference,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed=0):
    R, Hkv, gq, Dh, P, C = 4, 2, 4, 32, 256, 128
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, pk, pv = mk(R, Hkv, gq, Dh), mk(R, Hkv, P, Dh), mk(R, Hkv, P, Dh)
    tk, tv = mk(R, Hkv, C, Dh), mk(R, Hkv, C, Dh)
    # ragged left-padded prompts; row 3 is an empty slot
    prompt_len = [P, 100, 7, 0]
    pmask = np.arange(P)[None, :] >= (P - np.asarray(prompt_len))[:, None]
    # clock-ring windows: admitted at different clocks, one wraps past Cmax
    admit, t = np.array([30, 140, 149, 0]), np.array([121, 11, 1, 0])
    rel = np.mod(np.arange(C)[None, :] - admit[:, None], C)
    rmask = rel < t[:, None]
    bias_p = np.where(pmask, 0.0, -1e30).astype(np.float32)[:, None, :]
    bias_t = np.where(rmask, 0.0, -1e30).astype(np.float32)[:, None, :]
    live = pmask.any(1) | rmask.any(1)
    return (q, pk, pv, bias_p, tk, tv, bias_t), dict(group_q=gq,
                                                      sm_scale=Dh ** -0.5), live


def test_ragged_decode_matches_jax_kernel_and_reference():
    args, kw, live = _case()
    assert (~live).sum() == 1 and live.sum() == 3
    out = flash_ragged_decode_attention(*(torch.from_numpy(a) for a in args),
                                        **kw).numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    jargs = [jnp.asarray(a) for a in args]
    ref_kernel = np.asarray(jax_kernel(*jargs, interpret=True, **kw))
    ref_xla = np.asarray(jax_reference(*jargs, **kw))
    np.testing.assert_allclose(out[live], ref_kernel[live], **TOL)
    np.testing.assert_allclose(out[live], ref_xla[live], **TOL)


def test_plain_version_rounds_probs_like_jax_in_bf16():
    """bf16 caches: the plain version rounds the probabilities to bf16
    before P.V, as the JAX reference does.  Tolerance 1e-2: the two differ
    only in f32 summation order, which can flip the bf16 rounding of a
    probability (one bf16 ulp, 2^-8 relative)."""
    args, kw, live = _case(1)
    tq = [torch.from_numpy(a) for a in args]
    tq = [t.to(torch.bfloat16) if i not in (3, 6) else t
          for i, t in enumerate(tq)]
    out = ragged_decode_attention_reference(*tq, **kw).numpy()
    jargs = [jnp.asarray(a, jnp.bfloat16) if i not in (3, 6) else jnp.asarray(a)
             for i, a in enumerate(args)]
    ref = np.asarray(jax_reference(*jargs, **kw))
    np.testing.assert_allclose(out[live], ref[live], atol=1e-2, rtol=1e-2)

"""K1 backward parity: gradients of spacer_tpu_torch's flash_attention path
(on CPU: autograd through its plain version) and of the CPU branches of the
K1-bwd wrappers (flash_attention_bwd_dq / _dkv) against jax.grad through
spacer_tpu's Pallas flash_attention in interpret mode (its custom VJP runs
the dq and dk/dv kernels), on the same numpy inputs.

Cases: GQA with left-padded kv_mask (causal), a completion-style q_offset
window, and segment ids.  The JAX kernel needs Skv >= 128.

The loss is sum(sin(out) * w), where w zeroes query rows with no visible
key: nothing downstream reads such rows (a padded prompt row), and for them
the two sides legitimately differ (see tests/test_flash_attention.py).

Tolerance: 2e-4 relative, 2e-5 absolute in float32, as the JAX package's
own kernel-vs-XLA gradient test uses: both sides compute f32 and differ in
summation order only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.ops.flash_attention import flash_attention as jax_flash
from spacer_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-5)

CASES = {
    # name: (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, left pad per row, segments)
    "gqa_leftpad": (2, 128, 128, 4, 2, 32, True, 0, (0, 37), False),
    "q_offset": (2, 64, 192, 4, 1, 32, True, 128, (13, 0), False),
    "segments": (1, 128, 128, 2, 2, 32, False, 0, (0,), True),
}


def _case(name, seed=0):
    B, Sq, Skv, Hq, Hkv, D, causal, off, pad, seg = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32)
    mask = np.ones((B, Skv), bool)
    for b, p in enumerate(pad):
        mask[b, :p] = False
    kw = dict(causal=causal, q_offset=off, kv_mask=mask)
    visible = np.broadcast_to(mask[:, None, :], (B, Sq, Skv))
    if causal:
        visible = visible & (np.arange(Skv)[None, None, :]
                             <= np.arange(Sq)[None, :, None] + off)
    if seg:
        q_seg = (np.arange(Sq) >= 50).astype(np.int32)[None].repeat(B, 0)
        kv_seg = (np.arange(Skv) >= 50).astype(np.int32)[None].repeat(B, 0)
        kw.update(q_segment_ids=q_seg, kv_segment_ids=kv_seg)
        visible = visible & (q_seg[:, :, None] == kv_seg[:, None, :])
    w = visible.any(-1).astype(np.float32)[:, :, None, None]  # (B, Sq, 1, 1)
    return (q, k, v), kw, w


def _jax_grads(qkv, kw, w):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}

    def loss(q, k, v):
        o = jax_flash(q, k, v, interpret=True, **jkw)
        return jnp.sum(jnp.sin(o) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in qkv))
    return [np.asarray(g) for g in grads]


def _torch_kw(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_jax_kernel(name):
    qkv, kw, w = _case(name)
    ref = _jax_grads(qkv, kw, w)
    tkw = _torch_kw(kw)
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in qkv)
    out = fa.flash_attention(q, k, v, **tkw)
    loss = (torch.sin(out) * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    for g, r, n in zip(grads, ref, "qkv"):
        assert np.isfinite(g.numpy()).all(), n
        np.testing.assert_allclose(g.numpy(), r, err_msg=f"d{n}", **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_wrappers_match_jax_kernel(name):
    """The wrappers the CUDA backward launches, on their CPU branch, fed
    the forward's out / lse and dout = cos(out) * w."""
    qkv, kw, w = _case(name)
    ref = _jax_grads(qkv, kw, w)
    tkw = _torch_kw(kw)
    q, k, v = (torch.from_numpy(x) for x in qkv)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **tkw)
    dout = torch.cos(out) * torch.from_numpy(w)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, dout, **tkw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, dout, **tkw)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == before  # no kernel on CPU
    assert dk.shape == k.shape and dv.shape == v.shape
    for g, r, n in zip((dq, dk, dv), ref, "qkv"):
        np.testing.assert_allclose(g.numpy(), r, err_msg=f"d{n}", **TOL)

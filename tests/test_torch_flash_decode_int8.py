"""K2-int8 and K5-int8 parity: spacer_tpu_torch's decode attention over int8
caches (its plain versions on the CPU) against spacer_tpu's Pallas kernels
in interpret mode (`quant=True` branches) and their XLA references, at
head_dim 128 with left-padded prefixes, a live tail shorter than T (K2) and
random ring windows (K5).

The codes and scales come from quantize_kv of random f32 caches, so the
per-key scales differ from key to key: a scale applied to the wrong key, or
to the denominator, moves the outputs by O(0.1).

Tolerance: 2e-5 abs/rel in float32, as the JAX package's own kernel tests:
the two sides differ in the softmax's summation order only.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spacer_tpu.ops import flash_decode as jfd
from spacer_tpu.ops.quant import quantize_kv as jax_quantize_kv
from spacer_tpu_torch.ops import flash_decode as fd
from spacer_tpu_torch.ops.quant import quantize_kv

TOL = dict(atol=2e-5, rtol=2e-5)


def _quant(x):
    """f32 cache -> (int8 codes, f32 scales with a unit axis before T)."""
    q, s = quantize_kv(torch.from_numpy(x))
    return q, s[:, :, None, :].contiguous()


def _grouped_case(seed=0, B=2, Hkv=2, G=3, gq=2, Dh=128, P=256, T=128):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q = mk(B, Hkv, G * gq, Dh)
    caches = [mk(B, Hkv, P, Dh), mk(B, Hkv, P, Dh),
              mk(B * G, Hkv, T, Dh), mk(B * G, Hkv, T, Dh)]
    # per-key magnitudes that differ, so the scales do too
    for c in caches:
        c *= rng.uniform(0.2, 3.0, size=c.shape[:-1] + (1,)).astype(np.float32)
    mask = np.ones((B, P), bool)
    mask[0, :P // 3] = False   # left padding on prompt 0
    bias = np.where(mask, 0.0, -1e30).astype(np.float32)[:, None, :]
    kw = dict(group=G, group_q=gq, sm_scale=Dh ** -0.5)
    return q, caches, bias, kw


@pytest.mark.parametrize("step", [1, 37, 100])
def test_grouped_int8_matches_jax_kernel_and_reference(step):
    q, caches, bias, kw = _grouped_case()
    (pk, pks), (pv, pvs), (tk, tks), (tv, tvs) = map(_quant, caches)
    tk[:, :, step:] = 127      # dead tail: reading it would swamp the softmax
    tks[..., step:] = 1e3
    before = (fd.flash_decode_attention.launches,
              fd.flash_decode_attention_int8.launches)
    out = fd.flash_decode_attention(
        torch.from_numpy(q), pk, pv, torch.from_numpy(bias), tk, tv, step,
        pks, pvs, tks, tvs, **kw).numpy()
    assert (fd.flash_decode_attention.launches,
            fd.flash_decode_attention_int8.launches) == before   # CPU
    assert out.dtype == np.float32 and np.isfinite(out).all()
    j = [jnp.asarray(t.numpy()) for t in (pk, pv, tk, tv, pks, pvs, tks, tvs)]
    jargs = (jnp.asarray(q), j[0], j[1], jnp.asarray(bias), j[2], j[3], step,
             *j[4:])
    ref_kernel = np.asarray(jfd.flash_decode_attention(*jargs, interpret=True,
                                                       **kw))
    ref_xla = np.asarray(jfd.decode_attention_reference(*jargs, **kw))
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)
    # int8 error against the unquantized f32 oracle stays small
    ft = [torch.from_numpy(c) for c in caches]
    ft[2][:, :, step:], ft[3][:, :, step:] = 0, 0
    oracle = fd.decode_attention_reference(
        torch.from_numpy(q), ft[0], ft[1], torch.from_numpy(bias), ft[2],
        ft[3], step, **kw).numpy()
    assert np.abs(out - oracle).max() < 0.1


@pytest.mark.parametrize("step", [1, 65])
def test_grouped_int8_g16_matches_jax_kernel_and_reference(step):
    """K2-int8's plain version at G = 16, group_q 7 (112 query rows per
    prompt: any G * group_q is legal, as in JAX) against the JAX kernel in
    interpret mode and its reference."""
    q, caches, bias, kw = _grouped_case(3, B=2, Hkv=1, G=16, gq=7, P=256,
                                        T=128)
    (pk, pks), (pv, pvs), (tk, tks), (tv, tvs) = map(_quant, caches)
    tk[:, :, step:] = 127      # dead tail: reading it would swamp the softmax
    tks[..., step:] = 1e3
    out = fd.flash_decode_attention(
        torch.from_numpy(q), pk, pv, torch.from_numpy(bias), tk, tv, step,
        pks, pvs, tks, tvs, **kw).numpy()
    assert out.shape == (2, 1, 112, 128) and np.isfinite(out).all()
    j = [jnp.asarray(t.numpy()) for t in (pk, pv, tk, tv, pks, pvs, tks, tvs)]
    jargs = (jnp.asarray(q), j[0], j[1], jnp.asarray(bias), j[2], j[3], step,
             *j[4:])
    ref_kernel = np.asarray(jfd.flash_decode_attention(*jargs, interpret=True,
                                                       **kw))
    ref_xla = np.asarray(jfd.decode_attention_reference(*jargs, **kw))
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)


def test_grouped_int8_scales_are_applied_per_key():
    """Swapping the K and V scale roles, or using unit scales, changes the
    output: the parity above is not blind to where the scales go."""
    q, caches, bias, kw = _grouped_case(1)
    (pk, pks), (pv, pvs), (tk, tks), (tv, tvs) = map(_quant, caches)
    args = (torch.from_numpy(q), pk, pv, torch.from_numpy(bias), tk, tv, 50)
    out = fd.decode_attention_reference(*args, pks, pvs, tks, tvs, **kw)
    for wrong in ((pvs, pks, tvs, tks),
                  tuple(torch.ones_like(s) * s.mean() for s in (pks, pvs, tks, tvs))):
        other = fd.decode_attention_reference(*args, *wrong, **kw)
        assert float((out - other).abs().max()) > 1e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_ragged_int8_matches_jax_kernel_and_reference(seed):
    R, Hkv, gq, Dh, P, T = 8, 2, 4, 128, 256, 128
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q = mk(R, Hkv, gq, Dh)
    caches = [mk(R, Hkv, P, Dh), mk(R, Hkv, P, Dh), mk(R, Hkv, T, Dh),
              mk(R, Hkv, T, Dh)]
    for c in caches:
        c *= rng.uniform(0.2, 3.0, size=c.shape[:-1] + (1,)).astype(np.float32)
    pm = np.ones((R, P), bool)
    pm[0, :100] = False                       # left padding
    pm[3, :P - 7] = False                     # a short prompt
    rm = rng.integers(0, 2, (R, T)).astype(bool)
    rm[:, 0] = True
    bp = np.where(pm, 0, -1e30).astype(np.float32)[:, None, :]
    bt = np.where(rm, 0, -1e30).astype(np.float32)[:, None, :]
    kw = dict(group_q=gq, sm_scale=Dh ** -0.5)
    (pk, pks), (pv, pvs), (tk, tks), (tv, tvs) = map(_quant, caches)
    before = fd.flash_ragged_decode_attention_int8.launches
    out = fd.flash_ragged_decode_attention(
        torch.from_numpy(q), pk, pv, torch.from_numpy(bp), tk, tv,
        torch.from_numpy(bt), pks, pvs, tks, tvs, **kw).numpy()
    assert fd.flash_ragged_decode_attention_int8.launches == before   # CPU
    j = [jnp.asarray(t.numpy()) for t in (pk, pv, tk, tv, pks, pvs, tks, tvs)]
    jargs = (jnp.asarray(q), j[0], j[1], jnp.asarray(bp), j[2], j[3],
             jnp.asarray(bt), *j[4:])
    ref_kernel = np.asarray(jfd.flash_ragged_decode_attention(
        *jargs, interpret=True, **kw))
    ref_xla = np.asarray(jfd.ragged_decode_attention_reference(*jargs, **kw))
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)


def test_quantize_kv_matches_jax_on_caches():
    x = np.random.default_rng(3).normal(size=(2, 2, 64, 128)).astype(np.float32)
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = jax_quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_gates_take_int8_codes_with_f32_scales_only():
    """The Hopper gates accept bf16 caches without scales or int8 codes with
    all four f32 scales, and nothing else (checked on CPU tensors)."""
    B, Hkv, G, gq, D, P, T = 1, 2, 2, 2, 128, 128, 128
    bf, i8 = torch.bfloat16, torch.int8
    q = torch.zeros(B, Hkv, G * gq, D, dtype=bf)
    bias = torch.zeros(B, 1, P)

    def caches(dt):
        return (torch.zeros(B, Hkv, P, D, dtype=dt),
                torch.zeros(B, Hkv, P, D, dtype=dt),
                torch.zeros(B * G, Hkv, T, D, dtype=dt),
                torch.zeros(B * G, Hkv, T, D, dtype=dt))

    pk, pv, tk, tv = caches(i8)
    sc = (torch.ones(B, Hkv, 1, P), torch.ones(B, Hkv, 1, P),
          torch.ones(B * G, Hkv, 1, T), torch.ones(B * G, Hkv, 1, T))
    fd._check_grouped(q, pk, pv, bias, tk, tv, 5, G, gq, sc)
    fd._check_grouped(q, *caches(bf)[:2], bias, *caches(bf)[2:], 5, G, gq,
                      (None,) * 4)
    bad = [
        (caches(bf), sc),                                  # bf16 + scales
        (caches(i8), (None,) * 4),                         # int8, no scales
        (caches(i8), (*sc[:3], None)),                     # one missing
        (caches(i8), tuple(s.to(bf) for s in sc)),         # bf16 scales
        (caches(i8), (sc[0][..., :P // 2], *sc[1:])),      # wrong shape
        ((*caches(i8)[:3], caches(bf)[3]), sc),            # mixed codes
    ]
    for (a, b, c, d), s in bad:
        with pytest.raises(ValueError):
            fd._check_grouped(q, a, b, bias, c, d, 5, G, gq, s)
    R = 2
    rq = torch.zeros(R, Hkv, gq, D, dtype=bf)
    rc = [torch.zeros(R, Hkv, n, D, dtype=i8) for n in (P, P, T, T)]
    rs = [torch.ones(R, Hkv, 1, n) for n in (P, P, T, T)]
    rb = (torch.zeros(R, 1, P), torch.zeros(R, 1, T))
    fd._check(rq, rc[0], rc[1], rb[0], rc[2], rc[3], rb[1], gq, rs)
    with pytest.raises(ValueError):
        fd._check(rq, rc[0], rc[1], rb[0], rc[2], rc[3], rb[1], gq, (None,) * 4)

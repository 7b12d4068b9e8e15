"""Quantized decode helpers and K6: spacer_tpu_torch.ops.quant /
ops.int4_matmul against spacer_tpu.ops.quant / ops.int4_matmul on the same
numpy inputs.

- Codes (int8 weights, int4 weights, int8 KV) equal JAX's exactly on f32
  inputs: both round half to even after the same f32 division; the scales
  agree within 1 f32 ulp (amax and a division by a constant).
- Packed int4 bytes equal JAX's (block-local half pairing) and unpack
  round-trips.
- K6's plain version against JAX's Pallas kernel in interpret mode and its
  XLA reference: the bf16 x small-int products are exact in f32, so the two
  differ only in the order of the f32 sums over K: |error| <= 1e-5 relative
  to the sum of |terms| per output (K <= 3584 terms, 2^-24 each).
- dense_q8 / dense_q4 in f32 (rtol 1e-5: summation order) and bf16 (one bf16
  rounding of the output, 2^-8 relative: rtol 1e-2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spacer_tpu.ops import int4_matmul as jim
from spacer_tpu.ops import quant as jq
from spacer_tpu_torch.models.qwen25_vl import params_from_jax
from spacer_tpu_torch.ops import int4_matmul as im
from spacer_tpu_torch.ops import quant


def _w(*shape, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    # rows and columns of differing magnitude: the scales matter
    w *= rng.uniform(0.1, 2.0, size=shape[:-1] + (1,)).astype(np.float32)
    return w


def _p(w, bias=True):
    n = w.shape[-1]
    b = np.random.default_rng(9).normal(size=w.shape[:-2] + (n,)).astype(np.float32)
    return ({"kernel": w, "bias": b} if bias else {"kernel": w})


@pytest.mark.parametrize("shape", [(512, 96), (3, 64, 40), (6, 20)])
@pytest.mark.parametrize("bits", [8, 4])
def test_weight_codes_and_scales_match_jax(shape, bits):
    w = _w(*shape)
    tq = {8: quant.quantize_dense_int8, 4: quant.quantize_dense_int4}[bits]
    jqf = {8: jq.quantize_dense_int8, 4: jq.quantize_dense_int4}[bits]
    out = tq({k: torch.from_numpy(v) for k, v in _p(w).items()})
    ref = jqf({k: jnp.asarray(v) for k, v in _p(w).items()})
    assert sorted(out) == sorted(ref)
    for k in ref:
        a, b = out[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_array_max_ulp(a, b, maxulp=1)


def test_kv_codes_and_scales_match_jax():
    x = _w(2, 3, 40, 128, seed=2)
    x[0, 0, 0] = 0.0                  # an all-zero vector: the 1e-12 guard
    q, s = quant.quantize_kv(torch.from_numpy(x))
    jqv, js = jq.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)


@pytest.mark.parametrize("K", [64, 512, 768, 3584, 7168])
def test_pack_int4_bytes_match_jax(K):
    codes = np.random.default_rng(K).integers(-7, 8, (K, 48)).astype(np.int8)
    packed = im.pack_int4(torch.from_numpy(codes))
    ref = np.asarray(jim.pack_int4(jnp.asarray(codes)))
    assert packed.dtype == torch.int8 and packed.shape == (K // 2, 48)
    np.testing.assert_array_equal(packed.numpy(), ref)
    np.testing.assert_array_equal(im.unpack_int4(packed, K).numpy(), codes)
    assert im._block_k(K) == jim._block_k(K)


def test_tree_skip_list_and_odd_k():
    rng = np.random.default_rng(0)
    tree = {
        "attn": {"q": {"kernel": torch.from_numpy(_w(8, 16))}},
        "router": {"kernel": torch.from_numpy(_w(8, 4))},
        "experts": {"up": {"kernel": torch.from_numpy(_w(8, 6))}},
        "odd": {"kernel": torch.from_numpy(_w(7, 16))},
        "norm": {"scale": torch.from_numpy(rng.normal(size=8))},
    }
    for fn, key in ((quant.quantize_tree_int8, "kernel_q8"),
                    (quant.quantize_tree_int4, "kernel_q4")):
        out = fn(tree)
        assert key in out["attn"]["q"]
        assert out["router"] is tree["router"]
        assert out["experts"] is tree["experts"]
        assert out["norm"]["scale"] is tree["norm"]["scale"]
        assert "kernel_q8" in out["odd"]          # odd K stays int8
    layers = [{"mlp": {"up": {"kernel": torch.from_numpy(_w(8, 16))}}}] * 2
    assert all("kernel_q4" in l["mlp"]["up"]
               for l in quant.quantize_tree_int4(layers))


def test_decode_weights_quantize_the_head_only_when_untied():
    layers = [{"p": {"kernel": torch.from_numpy(_w(8, 16))}}]
    head = {"kernel": torch.from_numpy(_w(8, 32))}
    lq, hq = quant.quantize_decode_weights(layers, head, bits=4)
    assert "kernel_q4" in lq[0]["p"] and "kernel_q4" in hq
    lq, hq = quant.quantize_decode_weights(layers, None, bits=8)
    assert "kernel_q8" in lq[0]["p"] and hq is None
    _, hq = quant.quantize_decode_weights(
        layers, {"kernel": torch.from_numpy(_w(7, 32))}, bits=4)
    assert "kernel_q8" in hq                      # odd K: int8


@pytest.mark.parametrize("K,N", [(512, 256), (3584, 512), (1024, 384)])
def test_int4_matmul_reference_matches_jax_kernel_interpret(K, N):
    rng = np.random.default_rng(K + N)
    codes = rng.integers(-7, 8, (K, N)).astype(np.int8)
    x = rng.normal(size=(8, K)).astype(np.float32)
    packed = jim.pack_int4(jnp.asarray(codes))
    out = im.int4_matmul(torch.from_numpy(x), torch.from_numpy(np.array(packed)))
    assert out.dtype == torch.float32 and im.int4_matmul.launches == 0
    kernel = np.asarray(jim.int4_matmul(jnp.asarray(x), packed, interpret=True))
    ref = np.asarray(jim.int4_matmul_reference(jnp.asarray(x), packed))
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    bound = 1e-5 * (np.abs(xb) @ np.abs(codes.astype(np.float32)))
    for other in (kernel, ref):
        assert (np.abs(out.numpy() - other) <= bound + 1e-6).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dense_q8_q4_match_jax(dtype, bits):
    w = _w(256, 48, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 3, 256)).astype(np.float32)
    jp = {8: jq.quantize_dense_int8, 4: jq.quantize_dense_int4}[bits](
        {k: jnp.asarray(v) for k, v in _p(w).items()})
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = dict(jp, bias=jp["bias"].astype(jdt))
    tp = dict(tp, bias=tp["bias"].to(tdt))
    jdense = {8: jq.dense_q8, 4: jq.dense_q4}[bits]
    ref = np.asarray(jdense(jp, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    out = quant.dense_q8 if bits == 8 else quant.dense_q4
    got = out(tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 3, 48)
    rtol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_params_from_jax_keeps_quantization_leaves():
    """A pre-quantized JAX tree converted with dtype=bf16: int8 codes and
    f32 scales keep their dtype (JAX's dense_q4 multiplies the f32 column
    scale), other floating leaves are cast; the port's dense on the
    converted tree equals JAX's on the same tree."""
    from spacer_tpu.models.qwen25_vl import init_params, tiny_config

    cfg = tiny_config()
    params = init_params(jax.random.key(0), cfg, jnp.float32)
    layers, head = jq.quantize_decode_weights(
        params["model"]["layers"], params["model"]["lm_head"], bits=4)
    params["model"] = dict(params["model"], layers=layers, lm_head=head)
    tp = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                         dtype=torch.bfloat16)
    th = tp["model"]["lm_head"]
    assert th["kernel_q4"].dtype == torch.int8
    assert th["q4_row_scale"].dtype == th["q4_col_scale"].dtype == torch.float32
    q_proj = tp["model"]["layers"][1]["self_attn"]["q_proj"]
    assert q_proj["kernel_q4"].dtype == torch.int8
    assert q_proj["q4_col_scale"].dtype == torch.float32
    assert q_proj["bias"].dtype == torch.bfloat16
    assert tp["model"]["norm"]["scale"].dtype == torch.bfloat16
    x = np.random.default_rng(0).normal(
        size=(4, cfg.text.hidden_size)).astype(np.float32)
    from spacer_tpu_torch.nn.core import dense

    ref = np.asarray(jq.dense_q4(head, jnp.asarray(x)))
    got = dense(th, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M", [4, 16])
@pytest.mark.parametrize("K,N", [(3584, 3584), (3584, 512), (3584, 18944),
                                 (18944, 3584), (3584, 152064)])
def test_k6_split_plan_covers_k_and_fills_the_card(M, K, N):
    """The wrapper's split-K plan at the 7B decode shapes (132 SMs, 4 CTAs
    per SM): the splits cover every packed row and none is empty, rows per
    split are whole 64-row chunks of the kernel's ring, and the grid holds
    >= 2 CTAs per SM where K allows it."""
    splits, rows = im.k_splits(M, K, N, 132, 4)
    K2 = K // 2
    assert rows % im.CHUNK_ROWS == 0
    assert splits * rows >= K2 > (splits - 1) * rows
    tiles = -(-N // im.COLS_PER_CTA) * -(-M // im.M_TILE)
    assert tiles * splits >= min(2 * 132, tiles * (K2 // im.CHUNK_ROWS))


@pytest.mark.parametrize("M", [1, 5, 16])
def test_dense_q4_with_bias_matches_jax(M):
    """dense_q4 with a bias on bf16 activations (the decode path's dtypes)
    at M = 1, 5 (no multiple of JAX's 8-row padding) and 16 rows: the port
    (its plain composition on the CPU, which the fused CUDA kernel rounds
    alike) against JAX's dense_q4.  Both round the row-scaled x, the cast
    and the bias add to bf16 at the same places and differ only in the f32
    summation order, which can flip one bf16 rounding of an output: rtol
    1e-2 (2^-8 relative per rounding, two roundings), atol 1e-2 * max."""
    w = _w(512, 96, seed=M)
    x = np.random.default_rng(M).normal(size=(M, 512)).astype(np.float32)
    jp = jq.quantize_dense_int4({k: jnp.asarray(v) for k, v in _p(w).items()})
    jp = dict(jp, bias=jp["bias"].astype(jnp.bfloat16))
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32)
                                       if k == "bias" else v))
          for k, v in jp.items()}
    tp["bias"] = tp["bias"].to(torch.bfloat16)
    ref = np.asarray(jq.dense_q4(jp, jnp.asarray(x).astype(jnp.bfloat16))
                     .astype(jnp.float32))
    got = quant.dense_q4(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (M, 96)
    assert im.int4_matmul.launches == 0   # the CPU takes the plain version
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=1e-2,
                               atol=1e-2 * np.abs(ref).max())

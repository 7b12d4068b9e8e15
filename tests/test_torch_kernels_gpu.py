"""The hand-written CUDA kernels against their plain versions on a CUDA card
(K1, K1-bwd, K2, K2-int8, K3, K4, K5, K5-int8, K6), their legality gates,
a backward pass through the LM and a checkpoint round trip on the card.  These need the card and nvcc: on a host
without CUDA they skip.  Run them on the card with

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Tolerance: |kernel - plain| <= 2e-2 * (1 + |plain|) in bf16 (one bf16 step
of 2^-8 relative, plus the kernel's bf16 rounding of the probabilities).
Gradients (K1-bwd), whose elements sum many bf16-rounded products:
||kernel - plain|| <= 2e-2 * ||plain|| per tensor.  K6 (f32 output of
exact bf16 x int4 products): |kernel - plain| <= 1e-5 * sum |terms|, the f32
summation-order bound; K6 as dense_q4 (bf16 out) adds one bf16 ulp (<= 2^-7
relative) at each of its two roundings, the cast and the bias add, which a
different summation order can flip.
"""

import numpy as np
import pytest
import torch

from spacer_tpu_torch.nn.attention import xla_attention
from spacer_tpu_torch.ops import flash_attention as fa
from spacer_tpu_torch.ops import flash_decode as fd
from spacer_tpu_torch.ops import int4_matmul as im
from spacer_tpu_torch.ops import quant
from spacer_tpu_torch.ops import vit_window_attention as vwa
from spacer_tpu_torch.ops.quant import quantize_kv
from spacer_tpu_torch.ops.flash_attention import flash_attention

pytestmark = pytest.mark.gpu
TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    # the plain versions' f32 matmuls must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + sum(shape))
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def _close(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    assert bool(((out - ref).abs() <= TOL * (1 + ref.abs())).all()), \
        float((out - ref).abs().max())


def _padded_mask(dev, B, Skv, pad, tail):
    """Row 1 left-padded by `pad` keys; every row's last `tail` keys masked
    (a completion that ended early)."""
    mask = torch.ones((B, Skv), dtype=torch.bool, device=dev)
    mask[1, :pad] = False
    if tail:
        mask[:, Skv - tail:] = False
    return mask


# (Sq, Skv, q_offset, Hq, Hkv, pad, tail): the prefill square; a q_offset
# that is no multiple of the tile; the main path's GQA group of 7 with
# ragged lengths and a row whose first key tiles are all padding; the
# completion layout (q_offset a multiple of the tile, key tails masked)
K1_CASES = [(256, 256, 0, 8, 2, 40, 0), (70, 200, 130, 8, 2, 40, 0),
            (300, 300, 0, 28, 4, 200, 0), (128, 384, 256, 14, 2, 100, 50)]


@pytest.mark.parametrize("Sq,Skv,q_offset,H,Hkv,pad,tail", K1_CASES)
def test_flash_attention_kernel(dev, Sq, Skv, q_offset, H, Hkv, pad, tail):
    B, D = 2, 128
    q, k, v = _randn(dev, B, Sq, H, D), _randn(dev, B, Skv, Hkv, D), \
        _randn(dev, B, Skv, Hkv, D)
    mask = _padded_mask(dev, B, Skv, pad, tail)
    kw = dict(causal=True, kv_mask=mask, q_offset=q_offset, return_lse=True)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    # row 1's first queries see only padding: they stay finite
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    ref, ref_lse = xla_attention(q, k, v, **kw)
    live = slice(max(0, pad - q_offset), Sq)
    _close(out[0], ref[0])
    _close(lse[0], ref_lse[0])
    _close(out[1, live], ref[1, live])
    _close(lse[1, :, live], ref_lse[1, :, live])


def test_flash_attention_kernel_segments(dev):
    B, S, H, Hkv, D = 2, 200, 14, 2, 128
    q, k, v = _randn(dev, B, S, H, D), _randn(dev, B, S, Hkv, D), \
        _randn(dev, B, S, Hkv, D)
    pos = torch.arange(S, device=dev)
    seg = torch.stack([(pos >= 77).int(), (pos >= 150).int() + (pos >= 190).int()])
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg,
              return_lse=True)
    out, lse = flash_attention(q, k, v, **kw)
    ref, ref_lse = xla_attention(q, k, v, **kw)
    _close(out, ref)
    _close(lse, ref_lse)


def test_flash_attention_fully_masked_rows(dev):
    """Query rows that see no key (row 1's left padding).  The kernel skips
    the key tiles whose keys are all padding, so a row comes out exactly 0
    where its CTA walks no other tile, and the mean of V over the keys it
    walks otherwise.  The plain version gives the mean of V over all keys;
    no live row reads these rows (their keys are masked downstream and
    their output gradient is 0)."""
    B, S, H, Hkv, D, pad = 2, 256, 14, 2, 128, 130
    q, k, v = _randn(dev, B, S, H, D), _randn(dev, B, S, Hkv, D), \
        _randn(dev, B, S, Hkv, D)
    mask = _padded_mask(dev, B, S, pad, 0)
    out, lse = flash_attention(q, k, v, causal=True, kv_mask=mask,
                               return_lse=True)
    assert torch.isfinite(lse).all()
    # queries 0-127 (one q tile) walk keys 0-127: all padding, all skipped
    assert not out[1, :128].any()
    # queries 128, 129 walk the key tiles of keys 128-255 (two padded keys)
    walked = v[1, 128:].float().mean(0).repeat_interleave(H // Hkv, dim=0)
    _close(out[1, 128:pad], walked.expand(pad - 128, H, D))


# K4 chunk sizes: a multiple of 32 but not of 64; (h/14)(w/14) patch chunks
# that are multiples of 4 only (100, 252); the ViT's 480 at its 16 heads
@pytest.mark.parametrize("chunk", [96, 100, 252, 480])
def test_window_and_chunk_kernels(dev, chunk):
    H, wt, D = 4, 64, 80
    lengths = [64, 17, 40, 1, 64, 33]
    q, k, v = (_randn(dev, H, wt * len(lengths), D, seed=i) for i in range(3))
    bias = torch.from_numpy(vwa.validity_bias(lengths, wt)).to(dev)
    _close(vwa.window_attention_hsd(q, k, v, bias, wt, D ** -0.5),
           vwa.window_attention_reference(q, k, v, bias, wt, D ** -0.5))
    # K4 over 3 chunks: a tile that reads across a chunk's end would mix in
    # the next chunk's keys and fail the comparison
    Hc = 16 if chunk == 480 else 4
    q, k, v = (_randn(dev, Hc, 3 * chunk, D, seed=i) for i in range(3))
    before = vwa.chunk_attention_hsd.launches
    out = vwa.chunk_attention_hsd(q, k, v, chunk, D ** -0.5)
    assert vwa.chunk_attention_hsd.launches == before + 1
    _close(out, vwa.chunk_attention_reference(q, k, v, chunk, D ** -0.5))


def _vit_window_lengths():
    """Valid tokens per window of the ViT at grid (8, 16, 30): 64 windows of
    wt = 64."""
    from spacer_tpu_torch.models.qwen25_vl import QWEN25_VL_7B
    from spacer_tpu_torch.models.qwen25_vl.vision import vision_layout

    layout = vision_layout([(8, 16, 30)], QWEN25_VL_7B.vision)
    return [int(n) for n in layout.win_valid.sum(1)]


def _lengths(n, wt, seed):
    rng = np.random.default_rng(seed)
    return [1, wt, *rng.integers(1, wt + 1, n - 2).tolist()]


# (heads, wt, window lengths): the ViT's layout at its 16 heads; lengths 1
# and 64 among random ones; window counts 6 and 63; a window of 32 tokens
K3_CASES = {"vit": lambda: (16, 64, _vit_window_lengths()),
            "ends": lambda: (4, 64, [1, 64, 2, 63, 64, 1, 30, 64]),
            "six": lambda: (16, 64, [64, 17, 40, 1, 64, 33]),
            "sixty-three": lambda: (4, 64, _lengths(63, 64, 3)),
            "wt32": lambda: (4, 32, _lengths(10, 32, 4))}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_window_attention_kernel(dev, case):
    """K3 against its plain version, every row (pad rows too), one launch."""
    H, wt, lengths = K3_CASES[case]()
    D = 80
    q, k, v = (_randn(dev, H, wt * len(lengths), D, seed=i) for i in range(3))
    bias = torch.from_numpy(vwa.validity_bias(lengths, wt)).to(dev)
    before = vwa.window_attention_hsd.launches
    out = vwa.window_attention_hsd(q, k, v, bias, wt, D ** -0.5)
    assert vwa.window_attention_hsd.launches == before + 1
    _close(out, vwa.window_attention_reference(q, k, v, bias, wt, D ** -0.5))


def test_window_attention_kernel_refuses_large_windows(dev):
    """K3 takes windows of at most one key tile (64 tokens)."""
    x = _randn(dev, 2, 256, 80)
    bias = torch.zeros((1, 256), device=dev)
    with pytest.raises(ValueError):
        vwa.window_attention_hsd(x, x, x, bias, 128, 0.1)


def _ragged_case(dev, P, C, quant):
    """Six slot rows: 0 the whole prefix and a ring window that wraps past
    index C - 1; 1 a prefix live only in its last 70 keys (dead leading
    jobs); 2 and 5 empty (no live key); 3 a prefix alone; 4 a full ring
    alone.  -> (args, kwargs, live rows)."""
    R, Hkv, gq, D = 6, 2, 7, 128
    q = _randn(dev, R, Hkv, gq, D)
    caches = [_randn(dev, R, Hkv, T, D, seed=i)
              for i, T in ((1, P), (2, P), (3, C), (4, C))]
    plen = torch.tensor([P, 70, 0, P // 2 + 3, 0, 0], device=dev)
    tlen = torch.tensor([30, 5, 0, 0, C, 0], device=dev)
    admit = torch.tensor([C - 10, 3, 0, 0, C - 1, 0], device=dev)
    pm = torch.arange(P, device=dev)[None] >= (P - plen)[:, None]
    rel = torch.remainder(torch.arange(C, device=dev)[None] - admit[:, None], C)
    rm = rel < tlen[:, None]
    bias_p = torch.where(pm, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    bias_t = torch.where(rm, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    if quant:
        (pk, pks), (pv, pvs), (tk, tks), (tv, tvs) = map(_int8, caches)
        args = (q, pk, pv, bias_p, tk, tv, bias_t, pks, pvs, tks, tvs)
    else:
        pk, pv, tk, tv = caches
        args = (q, pk, pv, bias_p, tk, tv, bias_t)
    return args, dict(group_q=gq, sm_scale=D ** -0.5), pm.any(1) | rm.any(1)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("P", [192, 1000, 1024])
def test_ragged_decode_split_kernel(dev, P, C, quant):
    """K5 / K5-int8 over 64-key jobs that end ragged (P = 1000), a wrapping
    ring window and dead leading jobs: live rows against the plain version,
    rows with no live key exactly 0 (the plain version gives the mean of V
    there; callers discard them), two calls bitwise equal, two launches of
    the right kernel."""
    args, kw, live = _ragged_case(dev, P, C, quant)
    wrapper = (fd.flash_ragged_decode_attention_int8 if quant
               else fd.flash_ragged_decode_attention)
    other = (fd.flash_ragged_decode_attention if quant
             else fd.flash_ragged_decode_attention_int8)
    before = (wrapper.launches, other.launches)
    first = fd.flash_ragged_decode_attention(*args, **kw)
    second = fd.flash_ragged_decode_attention(*args, **kw)
    assert (wrapper.launches, other.launches) == (before[0] + 2, before[1])
    assert first.dtype == torch.float32 and torch.equal(first, second)
    assert not first[~live].any()
    _close(first[live], fd.ragged_decode_attention_reference(*args, **kw)[live])


def test_ragged_decode_kernel_keeps_empty_slots_finite(dev):
    R, Hkv, gq, D, P, C = 4, 2, 7, 128, 192, 64
    q = _randn(dev, R, Hkv, gq, D)
    pk, pv = _randn(dev, R, Hkv, P, D, seed=1), _randn(dev, R, Hkv, P, D, seed=2)
    tk, tv = _randn(dev, R, Hkv, C, D, seed=3), _randn(dev, R, Hkv, C, D, seed=4)
    pm = torch.arange(P, device=dev)[None] >= torch.tensor(
        [0, 50, 191, P], device=dev)[:, None]
    rm = torch.zeros((R, C), dtype=torch.bool, device=dev)
    rm[0, 60:], rm[0, :3], rm[1, 5] = True, True, True
    bias_p = torch.where(pm, 0.0, -1e30)[:, None].float().contiguous()
    bias_t = torch.where(rm, 0.0, -1e30)[:, None].float().contiguous()
    args = (q, pk, pv, bias_p, tk, tv, bias_t)
    kw = dict(group_q=gq, sm_scale=D ** -0.5)
    out = fd.flash_ragged_decode_attention(*args, **kw)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    _close(out[:3], fd.ragged_decode_attention_reference(*args, **kw)[:3])


def test_kernels_raise_on_shapes_they_do_not_take(dev):
    q = _randn(dev, 1, 64, 2, 96)   # head_dim 96 has no kernel
    with pytest.raises(ValueError):
        flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q.float(), q.float(), q.float())
    x = _randn(dev, 2, 100, 80)
    with pytest.raises(ValueError):
        vwa.chunk_attention_hsd(x, x, x, 64, 0.1)   # 100 % 64 != 0
    qd = _randn(dev, 1, 1, 9, 128)  # group_q 9 > 8
    kv = _randn(dev, 1, 1, 8, 128)
    b = torch.zeros((1, 1, 8), device=dev)
    with pytest.raises(ValueError):
        fd.flash_ragged_decode_attention(qd, kv, kv, b, kv, kv, b, group_q=9,
                                         sm_scale=0.1)


def _close_norm(out, ref):
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    rel = float((out - ref).norm() / ref.norm())
    assert rel <= TOL, rel


@pytest.mark.parametrize("Sq,Skv,q_offset,H,Hkv,pad,tail", [
    (256, 256, 0, 8, 2, 70, 0), (64, 320, 256, 8, 2, 70, 0),
    (300, 300, 0, 28, 4, 200, 0), (256, 640, 384, 28, 4, 300, 100)])
def test_flash_attention_backward_kernels(dev, Sq, Skv, q_offset, H, Hkv, pad,
                                          tail):
    """dq, dk, dv of the autograd.Function (launching both K1-bwd kernels)
    against autograd through the plain version; row 1 left-padded, whose
    padded query rows get no output gradient, and key tails masked in the
    completion layout (the cases of K1_CASES' kinds)."""
    B, D = 2, 128
    q, k, v = _randn(dev, B, Sq, H, D), _randn(dev, B, Skv, Hkv, D), \
        _randn(dev, B, Skv, Hkv, D)
    dout = _randn(dev, B, Sq, H, D, seed=7)
    mask = _padded_mask(dev, B, Skv, pad, tail)
    dout[1, :max(0, pad - q_offset)] = 0
    kw = dict(causal=True, kv_mask=mask, q_offset=q_offset)
    before = (fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    grads = torch.autograd.grad(fa.flash_attention(qg, kg, vg, **kw),
                                (qg, kg, vg), dout)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref = fa.attention_bwd_reference(q, k, v, dout, **kw)
    for g, r in zip(grads, ref):
        _close_norm(g, r)
    # keys that are masked get exactly zero dk and dv
    for g in grads[1:]:
        assert not g.float()[~mask].any()


@pytest.mark.parametrize("Sq,Skv,q_offset,H,Hkv,pad,tail", K1_CASES)
def test_flash_attention_bwd_dq_kernel(dev, Sq, Skv, q_offset, H, Hkv, pad,
                                       tail):
    """dq alone at the K1_CASES kinds: against the plain version; exactly 0
    on the query rows that see no key (row 1's first pad - q_offset rows),
    whatever their output gradient; two calls bitwise equal (one CTA owns
    all of its rows' dq: no partial sums, no atomics)."""
    B, D = 2, 128
    q, k, v = _randn(dev, B, Sq, H, D), _randn(dev, B, Skv, Hkv, D), \
        _randn(dev, B, Skv, Hkv, D)
    dout = _randn(dev, B, Sq, H, D, seed=7)
    kw = dict(causal=True, kv_mask=_padded_mask(dev, B, Skv, pad, tail),
              q_offset=q_offset)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout)
    before = fa.flash_attention_bwd_dq.launches
    first = fa.flash_attention_bwd_dq(*args, **kw)
    second = fa.flash_attention_bwd_dq(*args, **kw)
    assert fa.flash_attention_bwd_dq.launches == before + 2
    assert torch.equal(first, second)
    assert not first[1, :max(0, pad - q_offset)].any()
    _close_norm(first, fa.attention_bwd_reference(q, k, v, dout, **kw)[0])


def test_flash_attention_bwd_dq_kernel_segments(dev):
    """dq with segment ids and a left-padded row: rows that see no key are
    exactly 0, two calls bitwise equal."""
    B, S, H, Hkv, D, pad = 2, 200, 14, 2, 128, 70
    q, k, v = _randn(dev, B, S, H, D), _randn(dev, B, S, Hkv, D), \
        _randn(dev, B, S, Hkv, D)
    dout = _randn(dev, B, S, H, D, seed=7)
    pos = torch.arange(S, device=dev)
    seg = torch.stack([(pos >= 77).int(), (pos >= 150).int() + (pos >= 190).int()])
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg,
              kv_mask=_padded_mask(dev, B, S, pad, 0))
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout)
    first = fa.flash_attention_bwd_dq(*args, **kw)
    assert torch.equal(first, fa.flash_attention_bwd_dq(*args, **kw))
    assert not first[1, :pad].any()
    _close_norm(first, fa.attention_bwd_reference(q, k, v, dout, **kw)[0])


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_flash_attention_dkv_splits_are_deterministic(dev, monkeypatch, splits):
    """dk/dv with the GQA group over 1, 2 or 7 CTAs per key tile: right, and
    two calls on the same inputs bitwise equal (partials summed in a fixed
    order, no atomics)."""
    monkeypatch.setattr(fa, "dkv_splits", lambda *a: splits)
    B, S, H, Hkv, D, pad = 1, 700, 28, 4, 128, 267
    q, k, v = _randn(dev, B, S, H, D), _randn(dev, B, S, Hkv, D), \
        _randn(dev, B, S, Hkv, D)
    mask = torch.ones((B, S), dtype=torch.bool, device=dev)
    mask[0, :pad] = False
    dout = _randn(dev, B, S, H, D, seed=7) * mask[:, :, None, None]
    kw = dict(causal=True, kv_mask=mask)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout)
    first = fa.flash_attention_bwd_dkv(*args, **kw)
    second = fa.flash_attention_bwd_dkv(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for g, r in zip(first, fa.attention_bwd_reference(q, k, v, dout, **kw)[1:]):
        _close_norm(g, r)
        assert not g[0, :pad].any()


def test_flash_attention_backward_segments(dev):
    B, S, H, D = 1, 192, 4, 128
    q, k, v = (_randn(dev, B, S, H, D, seed=i) for i in range(3))
    dout = _randn(dev, B, S, H, D, seed=9)
    seg = (torch.arange(S, device=dev) >= 77).int()[None]
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    args = (q, k, v, out, lse, dout)
    ref = fa.attention_bwd_reference(q, k, v, dout, **kw)
    _close_norm(fa.flash_attention_bwd_dq(*args, **kw), ref[0])
    for g, r in zip(fa.flash_attention_bwd_dkv(*args, **kw), ref[1:]):
        _close_norm(g, r)


@pytest.mark.parametrize("step", [1, 70, 256])
def test_grouped_decode_kernel(dev, step):
    B, Hkv, G, gq, D, P, T = 2, 2, 4, 7, 128, 320, 256
    q = _randn(dev, B, Hkv, G * gq, D)
    pk, pv = _randn(dev, B, Hkv, P, D, seed=1), _randn(dev, B, Hkv, P, D, seed=2)
    tk, tv = _randn(dev, B * G, Hkv, T, D, seed=3), _randn(dev, B * G, Hkv, T, D,
                                                          seed=4)
    tk[:, :, step:] = 1e4   # dead tail: reading it would swamp the softmax
    mask = torch.ones((B, P), dtype=torch.bool, device=dev)
    mask[0, :100] = False
    bias = torch.where(mask, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    args = (q, pk, pv, bias, tk, tv, step)
    kw = dict(group=G, group_q=gq, sm_scale=D ** -0.5)
    before = fd.flash_decode_attention.launches
    out = fd.flash_decode_attention(*args, **kw)
    assert fd.flash_decode_attention.launches == before + 1
    assert out.dtype == torch.float32
    _close(out, fd.decode_attention_reference(*args, **kw))


def _int8(x):
    """bf16 cache with per-key magnitudes that differ -> codes, (.., 1, T)
    f32 scales."""
    g = torch.Generator(device=x.device).manual_seed(x.shape[-2])
    x = x.float() * torch.rand(x.shape[:-1] + (1,), generator=g,
                               device=x.device).mul(2.8).add(0.2)
    q, s = quantize_kv(x)
    return q, s[:, :, None].contiguous()


@pytest.mark.parametrize("step", [1, 70, 256])
def test_grouped_decode_int8_kernel(dev, step):
    B, Hkv, G, gq, D, P, T = 2, 2, 4, 7, 128, 320, 256
    q = _randn(dev, B, Hkv, G * gq, D)
    (pk, pks), (pv, pvs) = (_int8(_randn(dev, B, Hkv, P, D, seed=i))
                            for i in (1, 2))
    (tk, tks), (tv, tvs) = (_int8(_randn(dev, B * G, Hkv, T, D, seed=i))
                            for i in (3, 4))
    tk[:, :, step:], tks[..., step:] = 127, 1e3   # dead tail: never read
    mask = torch.ones((B, P), dtype=torch.bool, device=dev)
    mask[0, :100] = False
    bias = torch.where(mask, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    args = (q, pk, pv, bias, tk, tv, step, pks, pvs, tks, tvs)
    kw = dict(group=G, group_q=gq, sm_scale=D ** -0.5)
    before = (fd.flash_decode_attention.launches,
              fd.flash_decode_attention_int8.launches)
    out = fd.flash_decode_attention(*args, **kw)
    assert (fd.flash_decode_attention.launches,
            fd.flash_decode_attention_int8.launches) == (before[0], before[1] + 1)
    _close(out, fd.decode_attention_reference(*args, **kw))


@pytest.mark.parametrize("quant_kv", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("G", [1, 8, 16])
@pytest.mark.parametrize("step", [1, 64, 65, 255])
def test_grouped_decode_kernel_any_group(dev, quant_kv, G, step):
    """K2 / K2-int8 at G = 1 (the eval's static path: 7 live rows of a
    prefix job's 64-row tile), 8 and 16 completions of group_q 7 (56 and 112
    query rows: one and two 64-row tiles of the prefix jobs), live tails
    ending inside, at and just past a 64-key tail job, prompt 0 padded by
    100 keys (its first 64-key chunk all padding: that job reads nothing),
    against the plain version; two calls bitwise equal, one launch each.
    int8: the V values reach ~10 (scales up to 3), and the kernel rounds
    p * v_scale to bf16 against its 64-key job's max where the plain version
    rounds it against the row's, two roundings of <= 2^-9 each per term; an
    output that cancels between a few such terms can be off by up to 2^-8
    of sum_j p_j |v_j|, which the tolerance adds to TOL * (1 + |ref|)."""
    B, Hkv, gq, D, P, T = 2, 2, 7, 128, 320, 256
    q = _randn(dev, B, Hkv, G * gq, D)
    caches = [_randn(dev, B, Hkv, P, D, seed=1), _randn(dev, B, Hkv, P, D, seed=2),
              _randn(dev, B * G, Hkv, T, D, seed=3),
              _randn(dev, B * G, Hkv, T, D, seed=4)]
    mask = torch.ones((B, P), dtype=torch.bool, device=dev)
    mask[0, :100] = False
    bias = torch.where(mask, 0.0, fd.MASK_VALUE)[:, None].float().contiguous()
    if quant_kv:
        (pk, pks), (pv, pvs), (tk, tks), (tv, tvs) = map(_int8, caches)
        tk[:, :, step:], tks[..., step:] = 127, 1e3   # dead tail: never read
        args = (q, pk, pv, bias, tk, tv, step, pks, pvs, tks, tvs)
    else:
        pk, pv, tk, tv = caches
        tk[:, :, step:] = 1e4   # dead tail: reading it would swamp the softmax
        args = (q, pk, pv, bias, tk, tv, step)
    kw = dict(group=G, group_q=gq, sm_scale=D ** -0.5)
    wrapper = (fd.flash_decode_attention_int8 if quant_kv
               else fd.flash_decode_attention)
    before = wrapper.launches
    first = fd.flash_decode_attention(*args, **kw)
    second = fd.flash_decode_attention(*args, **kw)
    assert wrapper.launches == before + 2
    assert first.shape == (B, Hkv, G * gq, D) and torch.equal(first, second)
    ref = fd.decode_attention_reference(*args, **kw)
    if not quant_kv:
        _close(first, ref)
        return
    absv = (*args[:2], args[2].abs(), *args[3:5], args[5].abs(), *args[6:])
    allowed = (TOL * (1 + ref.abs())
               + 2.0 ** -8 * fd.decode_attention_reference(*absv, **kw))
    assert torch.isfinite(first).all()
    assert bool(((first - ref).abs() <= allowed).all()), \
        float((first - ref).abs().max())


def test_checkpoint_round_trip_onto_the_card(dev, tmp_path):
    """export_to_safetensors of params on the card (HF's sharded layout,
    transposed there) -> load_params_from_hf(device="cuda"): every tensor
    equal bitwise, on the card."""
    from spacer_tpu_torch.models.qwen25_vl import (
        export_to_safetensors,
        init_params,
        load_params_from_hf,
        tiny_config,
    )

    cfg = tiny_config()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    export_to_safetensors(params, cfg, str(tmp_path), max_shard_bytes=100_000)
    loaded, _ = load_params_from_hf(str(tmp_path), device="cuda")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], (*path, k))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, (*path, i))
        else:
            yield path, tree

    want, got = dict(leaves(params)), dict(leaves(loaded))
    assert set(want) == set(got)
    for path, x in want.items():
        y = got[path]
        assert y.is_cuda and y.dtype == x.dtype and torch.equal(x, y), path


def test_ragged_decode_int8_kernel(dev):
    R, Hkv, gq, D, P, C = 4, 2, 7, 128, 192, 64
    q = _randn(dev, R, Hkv, gq, D)
    (pk, pks), (pv, pvs) = (_int8(_randn(dev, R, Hkv, P, D, seed=i))
                            for i in (1, 2))
    (tk, tks), (tv, tvs) = (_int8(_randn(dev, R, Hkv, C, D, seed=i))
                            for i in (3, 4))
    pm = torch.arange(P, device=dev)[None] >= torch.tensor(
        [0, 50, 191, P], device=dev)[:, None]
    rm = torch.zeros((R, C), dtype=torch.bool, device=dev)
    rm[0, 60:], rm[0, :3], rm[1, 5] = True, True, True
    bias_p = torch.where(pm, 0.0, -1e30)[:, None].float().contiguous()
    bias_t = torch.where(rm, 0.0, -1e30)[:, None].float().contiguous()
    args = (q, pk, pv, bias_p, tk, tv, bias_t, pks, pvs, tks, tvs)
    kw = dict(group_q=gq, sm_scale=D ** -0.5)
    before = fd.flash_ragged_decode_attention_int8.launches
    out = fd.flash_ragged_decode_attention(*args, **kw)
    assert fd.flash_ragged_decode_attention_int8.launches == before + 1
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    _close(out[:3], fd.ragged_decode_attention_reference(*args, **kw)[:3])
    with pytest.raises(ValueError):   # int8 codes without scales
        fd.flash_ragged_decode_attention(*args[:7], **kw)


@pytest.mark.parametrize("M,K,N", [(4, 3584, 512), (16, 3584, 1024),
                                   (5, 1024, 3584), (33, 512, 272)])
def test_int4_matmul_kernel(dev, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    codes = torch.randint(-7, 8, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
    packed = im.pack_int4(codes)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    before = im.int4_matmul.launches
    out = im.int4_matmul(x, packed)
    assert im.int4_matmul.launches == before + 1
    ref = im.int4_matmul_reference(x, packed)
    bound = 1e-5 * (x.float().abs() @ codes.float().abs()) + 1e-6
    assert out.shape == (M, N) and out.dtype == torch.float32
    assert bool(((out - ref).abs() <= bound).all()), float((out - ref).abs().max())
    with pytest.raises(ValueError):   # N % 16 != 0 (the TMA row stride)
        im.int4_matmul(x, packed[:, :N - 4].contiguous())
    with pytest.raises(ValueError):   # K % 128 != 0 (a chunk would straddle)
        im.int4_matmul(x[:, :K - 64].contiguous(), packed[:K // 2 - 32])


# (K, N) of every int4 decode product of the 7B: q/o, k/v, gate/up, down,
# lm_head
K6_7B_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
                (3584, 152064)]


def _q4_params(dev, K, N, bias, seed=0):
    """An int4-quantized dense of rows of differing magnitude (the scales
    matter), with a bf16 bias or none."""
    g = torch.Generator(device=dev).manual_seed(seed + K + N)
    w = torch.randn((K, N), generator=g, device=dev)
    w = w * (0.1 + 2 * torch.rand((K, 1), generator=g, device=dev))
    p = {"kernel": w}
    if bias:
        p["bias"] = torch.randn((N,), generator=g, device=dev).to(torch.bfloat16)
    return quant.quantize_dense_int4(p)


def _q4_allowed(p, x, ref):
    """|fused - plain| bound: the f32 summation order (1e-5 * sum |terms|,
    times the column scale) plus one bf16 ulp (<= 2^-7 relative) at the cast
    and at the bias add."""
    K = x.shape[-1]
    codes = im.unpack_int4(p["kernel_q4"], K).float()
    xs = (x * p["q4_row_scale"].to(x.dtype)).float()
    cs = p["q4_col_scale"].float()
    terms = (xs.abs() @ codes.abs()) * cs
    pre = ((xs @ codes) * cs).abs()
    return 1e-5 * terms + 2.0 ** -7 * (pre + ref.float().abs()) + 1e-6


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("M", [1, 4, 5, 16])
@pytest.mark.parametrize("K,N", K6_7B_SHAPES)
def test_dense_q4_fused_kernel(dev, K, N, M, bias):
    """dense_q4 on CUDA (row scale, product, column scale, cast, bias in one
    K6 launch) against its plain composition at every 7B int4 shape."""
    p = _q4_params(dev, K, N, bias)
    x = _randn(dev, M, K)
    before = im.int4_matmul.launches
    out = quant.dense_q4(p, x)
    assert im.int4_matmul.launches == before + 1
    ref = quant.dense_q4_reference(p, x)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert torch.isfinite(out.float()).all()
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= _q4_allowed(p, x, ref)).all()), float(diff.max())


@pytest.mark.parametrize("M,K,N", [(4, 3584, 18944), (16, 18944, 3584),
                                   (4, 3584, 512)])
def test_k6_split_k_is_deterministic(dev, M, K, N):
    """Shapes whose plan splits K: the last CTA of each column tile sums the
    partials in split order, so two calls are bitwise equal (dense_q4 and
    the scale-free product), and the tickets are left for the next call."""
    splits, _ = im.k_splits(M, K, N, im._sm_count(0), im._ctas_per_sm())
    assert splits > 1
    p = _q4_params(dev, K, N, True)
    x = _randn(dev, M, K)
    assert torch.equal(quant.dense_q4(p, x), quant.dense_q4(p, x))
    assert torch.equal(im.int4_matmul(x, p["kernel_q4"]),
                       im.int4_matmul(x, p["kernel_q4"]))
    assert not im._TICKETS[x.device].any()


def test_dense_q4_is_one_kernel_launch(dev):
    """Each dense_q4 call on CUDA runs exactly one kernel on the device (no
    scale, cast, bias or split-sum kernel), by the profiler's count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p = _q4_params(dev, 3584, 18944, True)
    x = _randn(dev, 4, 3584)
    quant.dense_q4(p, x)
    torch.cuda.synchronize()
    for _ in range(3):   # the profiler has been seen to lose a record
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                quant.dense_q4(p, x)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if len(kernels) == 3:
            break
    assert len(kernels) == 3 and len(set(kernels)) == 1, kernels
    assert "int4_matmul_kernel" in kernels[0], kernels


def test_inference_only_kernels_refuse_autograd(dev):
    q = _randn(dev, 1, 1, 4, 128).requires_grad_(True)
    kv = _randn(dev, 1, 1, 128, 128)
    b = torch.zeros((1, 1, 128), device=dev)
    with pytest.raises(RuntimeError):
        fd.flash_ragged_decode_attention(q, kv, kv, b, kv, kv, b, group_q=4,
                                         sm_scale=0.1)
    with pytest.raises(RuntimeError):
        fd.flash_decode_attention(q, kv, kv, b, kv, kv, 1, group=1, group_q=4,
                                  sm_scale=0.1)
    with torch.no_grad():
        fd.flash_ragged_decode_attention(q, kv, kv, b, kv, kv, b, group_q=4,
                                         sm_scale=0.1)


def test_lm_backward_on_the_card_reaches_qkv_projections(dev):
    """loss.backward() through the LM on CUDA tensors (K1 forward and both
    K1-bwd kernels) gives every q/k/v/o projection a nonzero gradient that
    agrees with the same backward through plain attention."""
    import spacer_tpu_torch.models.qwen25_vl.language as lang
    from spacer_tpu_torch.models.qwen25_vl import TextConfig

    cfg = TextConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                     num_layers=2, num_heads=4, num_kv_heads=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lang.init_lm_params(cfg, generator=gen, dtype=torch.bfloat16,
                                 device=dev)
    ids = torch.randint(0, 1024, (2, 256), generator=gen, device=dev)
    mask = torch.ones((2, 256), dtype=torch.bool, device=dev)
    mask[1, :40] = False

    def proj_grads():
        projs = [lp["self_attn"][n]["kernel"] for lp in params["layers"]
                 for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
        for t in projs:
            t.grad = None
            t.requires_grad_(True)
        logits, _ = lang.lm_forward(params, cfg, input_ids=ids, kv_mask=mask,
                                    remat=True)
        (logits.float()[mask].logsumexp(-1).sum()).backward()
        return [t.grad.clone() for t in projs]

    before = fa.flash_attention_bwd_dq.launches
    grads = proj_grads()
    assert fa.flash_attention_bwd_dq.launches > before
    saved = lang.dot_product_attention
    lang.dot_product_attention = xla_attention
    try:
        ref = proj_grads()
    finally:
        lang.dot_product_attention = saved
    for g, r in zip(grads, ref):
        assert float(g.abs().max()) > 0
        cos = torch.nn.functional.cosine_similarity(
            g.float().flatten(), r.float().flatten(), dim=0)
        assert float(cos) >= 0.99, float(cos)

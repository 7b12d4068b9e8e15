"""The hand-written CUDA kernels against their plain versions on a CUDA card
(K1, K3, K4, K5), and their legality gates.  These need the card and nvcc:
on a host without CUDA they skip.  Run them on the card with

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Tolerance: |kernel - plain| <= 2e-2 * (1 + |plain|) in bf16 (one bf16 step
of 2^-8 relative, plus the kernel's bf16 rounding of the probabilities).
"""

import pytest
import torch

from spacer_tpu_torch.nn.attention import xla_attention
from spacer_tpu_torch.ops import flash_decode as fd
from spacer_tpu_torch.ops import vit_window_attention as vwa
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


@pytest.mark.parametrize("Sq,Skv,q_offset", [(256, 256, 0), (70, 200, 130)])
def test_flash_attention_kernel(dev, Sq, Skv, q_offset):
    B, H, Hkv, D = 2, 8, 2, 128
    q, k, v = _randn(dev, B, Sq, H, D), _randn(dev, B, Skv, Hkv, D), \
        _randn(dev, B, Skv, Hkv, D)
    mask = torch.ones((B, Skv), dtype=torch.bool, device=dev)
    mask[1, :40] = False
    kw = dict(causal=True, kv_mask=mask, q_offset=q_offset, return_lse=True)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    ref, ref_lse = xla_attention(q, k, v, **kw)
    live = slice(max(0, 40 - q_offset), Sq)
    _close(out[0], ref[0])
    _close(out[1, live], ref[1, live])
    _close(lse[1, :, live], ref_lse[1, :, live])


def test_window_and_chunk_kernels(dev):
    H, wt, D = 4, 64, 80
    lengths = [64, 17, 40, 1, 64, 33]
    q, k, v = (_randn(dev, H, wt * len(lengths), D, seed=i) for i in range(3))
    bias = torch.from_numpy(vwa.validity_bias(lengths, wt)).to(dev)
    _close(vwa.window_attention_hsd(q, k, v, bias, wt, D ** -0.5),
           vwa.window_attention_reference(q, k, v, bias, wt, D ** -0.5))
    _close(vwa.chunk_attention_hsd(q, k, v, 96, D ** -0.5),
           vwa.chunk_attention_reference(q, k, v, 96, D ** -0.5))


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

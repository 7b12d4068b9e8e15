"""K6: packed-int4 weight matmul on Hopper (csrc/int4_matmul.cu).

Replaces spacer_tpu/ops/int4_matmul.py::int4_matmul (`_kernel`), the
decode-path product of decode_quant="int4" / "int4_kv": y = x @ unpack(packed)
with bf16 operands and f32 sums, x (M, K), packed int8 (K/2, N), y (M, N)
f32.  The kernel is scale-free: ops/quant.py::dense_q4 folds the row scale
into x and the column scale into y.

Packing (block-local half pairing, the JAX package's bytes): within each
K-block of `_block_k(K)` rows, byte r holds code[r] in its low nibble and
code[r + bk/2] in its high nibble.  The TPU's N tile (`_block_n`) has no
role here: the CUDA kernel picks its own column tile.

Bound on the H100: the K*N/2 packed bytes (decode M is 4-16, so ~4 flops
per weight byte); see the .cu note for the design.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.  The wrapper
counts its launches in `int4_matmul.launches`.
"""

from __future__ import annotations

import functools

import torch

from spacer_tpu_torch.ops import _build

# columns of one CTA (32 lanes x 4 packed bytes) and rows of the M tile
COLS_PER_CTA = 128
M_TILE = 16


# Copied from spacer_tpu/ops/int4_matmul.py (_block_k; pure Python).
def _block_k(K: int) -> int:
    """Deterministic K-block: packing and matmul must agree, so both
    derive it from K alone."""
    for bk in (1024, 512, 256):
        if K % bk == 0:
            return bk
    if K % 2:
        raise ValueError(f"int4 packing needs even K, got {K}")
    return K


def pack_int4(codes):
    """(..., K, N) int4 codes (int8 storage, in [-8, 7]) -> (..., K/2, N)
    packed bytes with block-local half pairing."""
    *lead, K, N = codes.shape
    bk = _block_k(K)
    h = bk // 2
    c = codes.to(torch.int32).reshape(*lead, K // bk, 2, h, N)
    lo, hi = c[..., 0, :, :], c[..., 1, :, :]
    byte = (lo & 0xF) | ((hi & 0xF) << 4)
    return byte.to(torch.uint8).view(torch.int8).reshape(*lead, K // 2, N)


def unpack_int4(packed, K: int):
    """Inverse of pack_int4: (..., K/2, N) bytes -> (..., K, N) int8 codes."""
    *lead, K2, N = packed.shape
    if K2 * 2 != K:
        raise ValueError(f"packed {tuple(packed.shape)} does not hold K={K}")
    bk = _block_k(K)
    h = bk // 2
    v = packed.to(torch.int32).reshape(*lead, K // bk, h, N)
    lo = ((v & 15) ^ 8) - 8
    hi = v >> 4
    c = torch.stack([lo, hi], dim=-3)   # (..., K//bk, 2, h, N)
    return c.reshape(*lead, K, N).to(torch.int8)


def int4_matmul_reference(x, packed):
    """Plain version: unpack, then x (rounded to bf16) @ codes with f32
    sums (bf16 x small-int products are exact in f32)."""
    K = x.shape[-1]
    w = unpack_int4(packed, K).float()
    return torch.matmul(x.to(torch.bfloat16).float(), w)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_splits(M: int, K: int, N: int, sms: int) -> tuple[int, int]:
    """-> (splits, packed rows per split): the K range is cut so that the
    grid holds >= 2 CTAs per SM; more than one split sums partials in a
    second pass."""
    K2 = K // 2
    tiles = -(-N // COLS_PER_CTA) * -(-M // M_TILE)
    splits = max(1, min(-(-2 * sms // tiles), K2 // 64))
    rows = -(-K2 // splits)
    rows = -(-rows // 8) * 8
    return -(-K2 // rows), rows


def _check(x, packed):
    M, K = x.shape
    K2, N = packed.shape
    if K2 * 2 != K:
        raise ValueError(f"x {tuple(x.shape)} and packed {tuple(packed.shape)}"
                         " disagree on K")
    if packed.dtype != torch.int8 or x.dtype != torch.bfloat16:
        raise ValueError("int4_matmul takes bf16 x and int8 packed bytes")
    if N % 4 or K % 2 or M < 1:
        raise ValueError(f"int4_matmul needs N % 4 == 0 and even K, got "
                         f"K={K} N={N}")
    for name, t in (("x", x), ("packed", packed)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on x's device")
    if packed.data_ptr() % 4:
        raise ValueError("packed must be 4-byte aligned")


def int4_matmul(x, packed):
    """K6.  x (M, K) (cast to bf16, as the TPU kernel does), packed (K/2, N)
    -> (M, N) f32."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed)
    x = x.to(torch.bfloat16).contiguous()
    _check(x, packed)
    M, K = x.shape
    N = packed.shape[1]
    splits, rows = k_splits(M, K, N, _sm_count(x.device.index or 0))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    p = _build.ptr
    err = _build.kernels().spacer_int4_matmul(
        p(x), p(packed), p(part), p(out), M, K, N, _block_k(K), splits, rows,
        _build.stream_ptr(x.device))
    _build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0

"""K6: packed-int4 weight products on Hopper (csrc/int4_matmul.cu).

Replaces spacer_tpu/ops/int4_matmul.py::int4_matmul (`_kernel`), the
decode-path product of decode_quant="int4" / "int4_kv", and, in the same
launch, the scales, cast and bias that ops/quant.py::dense_q4 puts around
it.  Two entry points, one kernel:
  - `int4_matmul(x, packed)`: y = x @ unpack(packed) with bf16 operands and
    f32 sums, x (M, K), packed int8 (K/2, N), y (M, N) f32 (the JAX
    function's counterpart, scale-free);
  - `dense_q4_fused(x, packed, row_scale, col_scale, bias)`: dense_q4 on
    CUDA tensors, bf16 x (M, K) -> bf16 (M, N).
Every launch of either counts in `int4_matmul.launches` (kernel K6).

Packing (block-local half pairing, the JAX package's bytes): within each
K-block of `_block_k(K)` rows, byte r holds code[r] in its low nibble and
code[r + bk/2] in its high nibble.  The TPU's N tile (`_block_n`) has no
role here: the CUDA kernel picks its own column tile.

Bound on the H100: the K*N/2 packed bytes (decode M is 4-16, so ~4-16
flops per weight byte); see the .cu note for the design (one TMA ring for
weights, x and the row scale, mma.sync on nibbles widened in registers,
split K summed by the last CTA of each column tile).  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from spacer_tpu_torch.ops import _build

# output columns of one CTA (one 128-byte TMA box row), rows of x per CTA
# (the mma's M), packed rows per chunk of the kernel's ring (a split is a
# whole number of chunks)
COLS_PER_CTA = 128
M_TILE = 16
CHUNK_ROWS = 64


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


@functools.lru_cache(maxsize=None)
def _ctas_per_sm() -> int:
    return _build.kernels().spacer_int4_matmul_ctas_per_sm()


@functools.lru_cache(maxsize=None)
def k_splits(M: int, K: int, N: int, sms: int, ctas_per_sm: int
             ) -> tuple[int, int]:
    """-> (splits, packed rows per split): the K/2 packed rows are cut into
    splits of whole 64-row chunks so that the grid holds >= 2 CTAs per SM
    where K allows; among such plans the one with the least cost, in chunk
    times: waves of CTAs (`ctas_per_sm` per SM at once, the kernel's
    occupancy) x (chunks per CTA + 1 for a CTA's fixed cost, + 2 more where
    K is split: the partial's store, a fence and the ticket, + 1/2 per 4
    splits the last CTA sums), plus the f32 partial sums that splitting
    writes and reads (M x 128 x 8 bytes per CTA, against a chunk's 8 KB of
    weights)."""
    K2 = K // 2
    chunks = -(-K2 // CHUNK_ROWS)
    tiles = -(-N // COLS_PER_CTA) * -(-M // M_TILE)
    slots = sms * max(ctas_per_sm, 1)
    fill = min(2 * sms, tiles * chunks)
    best = None
    for splits in range(1, chunks + 1):
        per = -(-chunks // splits)
        if -(-chunks // per) != splits or tiles * splits < fill:
            continue
        fixed = 1 + (2 + -(-splits // 4) / 2 if splits > 1 else 0)
        cost = -(-tiles * splits // slots) * (per + fixed)
        if splits > 1:
            cost += tiles * splits * min(M, M_TILE) / 8 / slots
        if best is None or cost < best[0]:
            best = (cost, splits, per * CHUNK_ROWS)
    return best[1], best[2]


def _check(x, packed):
    M, K = x.shape
    K2, N = packed.shape
    if K2 * 2 != K:
        raise ValueError(f"x {tuple(x.shape)} and packed {tuple(packed.shape)}"
                         " disagree on K")
    if packed.dtype != torch.int8 or x.dtype != torch.bfloat16:
        raise ValueError("K6 takes bf16 x and int8 packed bytes")
    if N % 16 or K % 64 or M < 1:
        raise ValueError(f"K6 needs N % 16 == 0 and K % 64 == 0, got K={K} "
                         f"N={N}")
    for name, t in (("x", x), ("packed", packed)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on x's device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# per device: one zeroed int per column tile for the split-K tickets; every
# launch leaves them zeroed (launches share them, so they run one at a time:
# on one stream)
_TICKETS: dict = {}


def _tickets(device, n: int):
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = _TICKETS[device] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                           device=device)
    return t


def _launch(x, packed, row_scale, col_scale, bias, out):
    M, K = x.shape
    N = packed.shape[1]
    splits, rows = k_splits(M, K, N, _sm_count(x.device.index or 0),
                            _ctas_per_sm())
    part = tickets = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, -(-N // COLS_PER_CTA) * -(-M // M_TILE))
    p = _build.ptr
    err = _build.kernels().spacer_int4_matmul(
        p(x), p(packed), p(row_scale), p(col_scale), p(bias), p(part),
        p(tickets), p(out), M, K, N, _block_k(K), splits, rows,
        _build.stream_ptr(x.device))
    _build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return out


def int4_matmul(x, packed):
    """K6.  x (M, K) (cast to bf16, as the TPU kernel does), packed (K/2, N)
    -> (M, N) f32."""
    if _build.takes_plain(x, "K6"):
        return int4_matmul_reference(x, packed)
    x = x.to(torch.bfloat16).contiguous()
    _check(x, packed)
    out = torch.empty((x.shape[0], packed.shape[1]), dtype=torch.float32,
                      device=x.device)
    return _launch(x, packed, None, None, None, out)


int4_matmul.launches = 0


def dense_q4_fused(x, packed, row_scale, col_scale, bias=None):
    """K6 with dense_q4's arithmetic (CUDA tensors only): x (M, K) bf16,
    row_scale (K) and col_scale (N) f32, bias (N) bf16 or None ->
    bf16(bf16(bf16(x * bf16(row_scale)) @ codes * col_scale) [+ bias]),
    (M, N) bf16, in one launch."""
    _check(x, packed)
    K, N = x.shape[1], packed.shape[1]
    for name, t, n, dt in (("row_scale", row_scale, K, torch.float32),
                           ("col_scale", col_scale, N, torch.float32),
                           ("bias", bias, N, torch.bfloat16)):
        if t is None and name == "bias":
            continue
        if (t.shape != (n,) or t.dtype != dt or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{dt} ({n},) on x's device")
    out = torch.empty((x.shape[0], N), dtype=torch.bfloat16, device=x.device)
    return _launch(x, packed, row_scale, col_scale, bias, out)

// K6: packed-int4 weight products of the int4 decode path, on tensor cores.
//
// Replaces spacer_tpu/ops/int4_matmul.py::int4_matmul (`_kernel`) and, in
// one launch, the whole of ops/quant.py::dense_q4 around it (the JAX order
// of spacer_tpu/ops/quant.py::dense_q4):
//   xs = bf16(x * bf16(row_scale))          x (M, K) bf16, as torch's bf16 mul
//   y  = xs @ unpack(packed)                f32 sums, packed (K/2, N) int8
//   out = bf16(y * col_scale) [+ bias]      the cast, then the bias in bf16
// or, without scales, the scale-free y (M, N) f32 of int4_matmul.
// Packing: within each K-block of bk rows, packed row r of block j holds
// code[j*bk + r] in its low nibble and code[j*bk + bk/2 + r] in its high
// nibble (signed 4-bit), so packed row pr pairs K indices
// lo(pr) = (pr / h) * bk + pr % h and lo(pr) + h, h = bk / 2.  The bytes are
// read as they are: no repacked copy of the weights.
//
// What bounds it on the H100: the K * N / 2 packed bytes (decode has M = 4
// to 16 rows: ~4-16 flops per weight byte).  The first port kept one 4-byte
// load per lane in flight and FMA'd every code on the CUDA cores (at M = 16
// that, not the bytes, set its pace) and added a second launch for split
// sums, with the scales, cast and bias as four more launches around it.
//
// Design: one CTA of 4 warps per (128-column tile, split of the packed rows,
// 16-row tile of x); the wrapper picks the splits (ops/int4_matmul.py
// k_splits) for as few waves of CTAs as the card holds at once, >= 2 CTAs
// per SM where K allows.
//   - Everything a CTA reads streams through one ring of 4 stages fed by
//     TMA (sm90.cuh), thread 0 refilling a stage as soon as the CTA has
//     consumed it: per chunk of 64 packed rows the weights (64 x 128 bytes,
//     the 128-byte swizzle), the two 64-column boxes of x they pair with
//     (K indices lo(c0) .. +63 and lo(c0) + h .. +63, 16 rows of x; rows past
//     M read as zeros) and the row scale over the same K indices.  12.5 KB
//     per stage (8 KB of it from device memory), 4 CTAs per SM (<= 128
//     registers): up to 128 KB of weights in flight per SM, and nothing of
//     x is staged by threads.  A chunk never straddles a K-block: splits
//     start at multiples of 64 rows, and a K of several blocks has blocks
//     of 256-1024 (half-blocks of whole chunks).  K % 64 == 0 suffices: a K
//     that is not a multiple of 128 (832, Aria's shared down_proj at tp 4)
//     is one block (bk = K) whose last chunk is half (32 packed rows); its
//     boxes read zeros past K / 2 packed rows and past K, and the k16 loop
//     stops at the last real row.
//   - Products on tensor cores: mma.sync m16n8k16 bf16 with f32 sums, x as
//     the 16-row A operand (M = 4 pads rows with zeros).  mma.sync and not
//     wgmma: wgmma's 64-row A would be 4-16x padding, and its B must sit in
//     shared memory in bf16, which the packed bytes are not.  A k16 step
//     covers 8 packed rows (16 K indices): thread (g, t) of a warp reads
//     16 bytes of rows 2t and 2t + 1 of the step (columns 16g .. 16g + 15),
//     two conflict-free 16-byte shared loads under the swizzle; a byte
//     permute pairs the two rows' bytes of one column, and a mask, an XOR
//     (0x4300 | (nibble ^ 8) is the bf16 136 + code) and one bf16x2 FMA
//     (- 136, exact for codes in [-8, 7]) widen them to the B fragments of
//     16 n8 tiles: B's k rows (2t, 2t+1 | 2t+8, 2t+9) are the K indices
//     (lo, lo of the next row | their + h), which are adjacent pairs of the
//     two x boxes: the A fragment is four 32-bit shared loads, each pair
//     times bf16(row scale) rounded to bf16 as torch's bf16 mul rounds it.
//     Tile i's column p is output column 16 p + i (the epilogue writes each
//     column to its place).  A warp owns all 128 columns for every 4th k16
//     step.
//   - The 4 warps' sums are added in shared memory in a fixed order.
//   - One launch, deterministic: with several splits, each CTA writes its
//     f32 partial to scratch and takes a ticket (atomicAdd on the tile's
//     counter); the last CTA of the tile sums the partials in split order
//     (16-byte loads, 4 splits x 4 rows in flight per thread), runs the
//     epilogue and resets the counter to 0 for the next launch.  Two calls
//     are bitwise equal.
//   - Epilogue: y * col_scale in f32, the cast to bf16, + bias in bf16, as
//     the plain composition rounds them; or y as f32 without scales.
#include <type_traits>

#include "sm90.cuh"

namespace spacer {
namespace k6 {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 128;                      // output columns per CTA
constexpr int CH = 64;                         // packed rows per chunk (stage)
constexpr int STAGES = 4;
constexpr int MT = 16;                         // rows of x per CTA (the mma's M)

// One ring stage: the chunk's weights, its two boxes of x (16 rows x 64
// bf16, 128-byte swizzle) and of the row scale (64 f32), 1024-aligned.
struct Stage {
  static constexpr int w = 0, w_bytes = CH * COLS;
  static constexpr int x = w + w_bytes, x_box = MT * 64 * 2;   // lo box, then hi
  static constexpr int rs = x + 2 * x_box, rs_box = 64 * 4;    // lo box, then hi
  static constexpr int bytes = rs + 2 * rs_box;
  static constexpr int stride = (bytes + 1023) / 1024 * 1024;
};
constexpr int SMEM = STAGES * Stage::stride + STAGES * 8 + 1024;

// bf16x2 of the signed nibbles at bits 0-3 and 16-19 of d.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t d) {
  const uint32_t r = (d & 0x000F000Fu) ^ 0x43084308u;   // 136 + code, bf16
  uint32_t o;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(o)
      : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));   // * 1 - 136
  return o;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column of the 4-warp reduction buffer: a permutation inside each row that
// makes both its writes (fragment order) and its reads (column order) free
// of bank conflicts.
__device__ __forceinline__ int red_col(int col, int row) {
  return col ^ (((col >> 5) & 3) << 3) ^ (row & 7);
}

template <class OutT>
__device__ __forceinline__ void store(OutT* out, long i, float y, int n,
                                      const float* __restrict__ cs,
                                      const bf16* __restrict__ bias) {
  if constexpr (std::is_same<OutT, float>::value) {
    out[i] = y;
  } else {
    bf16 r = __float2bfloat16(y * cs[n]);
    if (bias != nullptr) r = __float2bfloat16(__bfloat162float(r) + __bfloat162float(bias[n]));
    out[i] = r;
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A bf16 pair of x times its two row scales, each rounded to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t x2, float2 rs) {
  return sm90::pack_bf16(__uint_as_float(x2 << 16) * bf16_round(rs.x),
                         __uint_as_float(x2 & 0xffff0000u) * bf16_round(rs.y));
}

// OutT = bf16: dense_q4 (rs, cs given, bias optional); OutT = float: the
// scale-free int4_matmul (rs, cs, bias null).
template <class OutT>
__global__ void __launch_bounds__(THREADS, 4)
int4_matmul_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap trs, const float* __restrict__ cs,
                   const bf16* __restrict__ bias, float* __restrict__ part,
                   int* __restrict__ tickets, OutT* __restrict__ out, int M, int K, int N,
                   int bk, int rows) {
  using namespace sm90;
  constexpr bool kScaled = !std::is_same<OutT, float>::value;
  constexpr uint32_t kStageTx =
      Stage::w_bytes + 2 * Stage::x_box + (kScaled ? 2 * Stage::rs_box : 0);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Stage::stride);
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int K2 = K / 2, h = bk / 2;
  const int n0 = blockIdx.x * COLS, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int mr = min(MT, M - m0);
  const int r0 = split * rows, nr = min(rows, K2 - r0);
  const int nch = (nr + CH - 1) / CH;

  // the loads of chunk c into stage st: weights, x and row scale at the K
  // indices the chunk's packed rows pair
  const CUtensorMap *mw = &tw, *mx = &tx, *mrs = &trs;
  auto load = [=](int c, int st) {
    unsigned char* dst = ring + st * Stage::stride;
    const int pr = r0 + c * CH, lo = (pr / h) * bk + pr % h;
    mbar_arrive_expect_tx(&full[st], kStageTx);
    tma_load_4d(dst + Stage::w, mw, &full[st], n0, pr, 0, 0);
    tma_load_4d(dst + Stage::x, mx, &full[st], lo, m0, 0, 0);
    tma_load_4d(dst + Stage::x + Stage::x_box, mx, &full[st], lo + h, m0, 0, 0);
    if (kScaled) {
      tma_load_4d(dst + Stage::rs, mrs, &full[st], lo, 0, 0, 0);
      tma_load_4d(dst + Stage::rs + Stage::rs_box, mrs, &full[st], lo + h, 0, 0, 0);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int c = 0; c < min(STAGES, nch); ++c) load(c, c);
  }
  __syncthreads();

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < nch; ++c) {
    const int st = c % STAGES;
    mbar_wait(&full[st], (c / STAGES) & 1);
    const unsigned char* stage = ring + st * Stage::stride;
    for (int k8 = warp; k8 < CH / 8; k8 += WARPS) {
      if (c * CH + 8 * k8 >= nr) break;
      const int rr = 8 * k8 + 2 * t;     // this thread's rows of the chunk: rr, rr + 1
      const uint4 w0 = *reinterpret_cast<const uint4*>(stage + Stage::w + rr * COLS +
                                                       ((g ^ (rr & 7)) << 4));
      const uint4 w1 = *reinterpret_cast<const uint4*>(stage + Stage::w + (rr + 1) * COLS +
                                                       ((g ^ ((rr + 1) & 7)) << 4));
      // x rows g and g + 8, K indices 8 k8 + 2t, +1 of each box: 16-byte
      // chunk k8 of a 128-byte row, stored at chunk k8 ^ (row % 8)
      const unsigned char* xa = stage + Stage::x + ((k8 ^ g) << 4) + 4 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(xa + g * 128);
      a[1] = *reinterpret_cast<const uint32_t*>(xa + (g + 8) * 128);
      a[2] = *reinterpret_cast<const uint32_t*>(xa + Stage::x_box + g * 128);
      a[3] = *reinterpret_cast<const uint32_t*>(xa + Stage::x_box + (g + 8) * 128);
      if (kScaled) {
        const float* rsl = reinterpret_cast<const float*>(stage + Stage::rs) + 8 * k8 + 2 * t;
        const float2 rlo = *reinterpret_cast<const float2*>(rsl);
        const float2 rhi = *reinterpret_cast<const float2*>(rsl + 64);
        a[0] = scale_pair(a[0], rlo);
        a[1] = scale_pair(a[1], rlo);
        a[2] = scale_pair(a[2], rhi);
        a[3] = scale_pair(a[3], rhi);
      }
      const uint32_t W0[4] = {w0.x, w0.y, w0.z, w0.w}, W1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // bytes of columns 4q, 4q+1 (dl) and 4q+2, 4q+3 (dh) of both rows:
        // [row rr col, row rr col+1, row rr+1 col, row rr+1 col+1]
        const uint32_t dl = __byte_perm(W0[q], W1[q], 0x5410);
        const uint32_t dh = __byte_perm(W0[q], W1[q], 0x7632);
        mma_bf16(acc[4 * q + 0], a, nibbles_bf16x2(dl), nibbles_bf16x2(dl >> 4));
        mma_bf16(acc[4 * q + 1], a, nibbles_bf16x2(dl >> 8), nibbles_bf16x2(dl >> 12));
        mma_bf16(acc[4 * q + 2], a, nibbles_bf16x2(dh), nibbles_bf16x2(dh >> 4));
        mma_bf16(acc[4 * q + 3], a, nibbles_bf16x2(dh >> 8), nibbles_bf16x2(dh >> 12));
      }
    }
    __syncthreads();   // every warp is done with this stage
    if (tid == 0 && c + STAGES < nch) load(c + STAGES, st);
  }

  // the warps' sums, through shared memory (the ring's, all consumed):
  // acc[i][j] is row g + 8 (j / 2), column 16 (2t + j % 2) + i
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = g + 8 * (j / 2), col = 32 * t + 16 * (j % 2) + i;
      red[(warp * MT + row) * COLS + red_col(col, row)] = acc[i][j];
    }
  __syncthreads();
  float v[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    v[m] = 0.f;
    if (m < mr) {
      const int c = red_col(tid, m);
      v[m] = red[m * COLS + c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v[m] += red[(w * MT + m) * COLS + c];
    }
  }
  const int n = n0 + tid;
  if (gridDim.y == 1) {
    if (n < N)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < mr) store(out, (long)(m0 + m) * N + n, v[m], n, cs, bias);
    return;
  }

  // several splits: the partial to scratch; the tile's last CTA sums them
  if (n < N)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < mr) part[((long)split * M + m0 + m) * N + n] = v[m];
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(&tickets[tile], 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread: columns n4 .. n4 + 3 of rows tid / 32 + 4 j; the partials loaded
  // 4 splits x 4 rows at a time (16-byte loads) and summed in split order
  const int n4 = n0 + 4 * (tid % 32);
  if (n4 < N) {
    const int splits = gridDim.y;
    const long MN = (long)M * N;
    float4 y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += 4) {
      float4 p[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tid / 32 + 4 * j;
          p[k][j] = s0 + k < splits && m < mr
                        ? __ldcg(reinterpret_cast<const float4*>(
                              part + (s0 + k) * MN + (long)(m0 + m) * N + n4))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s0 + k < splits)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            y[j].x += p[k][j].x;
            y[j].y += p[k][j].y;
            y[j].z += p[k][j].z;
            y[j].w += p[k][j].w;
          }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = tid / 32 + 4 * j;
      if (m >= mr) continue;
      const long i = (long)(m0 + m) * N + n4;
      store(out, i, y[j].x, n4, cs, bias);
      store(out, i + 1, y[j].y, n4 + 1, cs, bias);
      store(out, i + 2, y[j].z, n4 + 2, cs, bias);
      store(out, i + 3, y[j].w, n4 + 3, cs, bias);
    }
  }
  if (tid == 0) tickets[tile] = 0;
}

template <class OutT>
static cudaError_t launch(const void* x, const void* packed, const void* rs, const void* cs,
                          const void* bias, void* part, void* tickets, void* out, int M,
                          int K, int N, int bk, int splits, int rows, cudaStream_t stream) {
  CUtensorMap tw, tx, trs;
  cudaError_t err = sm90::encode_2d(&tw, packed, K / 2, N, CH, COLS,
                                    CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = sm90::encode_2d(&tx, x, M, K, MT, 64, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  // the scale-free product stages no row scale: its map is never read
  if (err == cudaSuccess)
    err = sm90::encode_2d(&trs, rs != nullptr ? rs : x, 1, rs != nullptr ? K : 64, 1, 64,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(int4_matmul_kernel<OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + COLS - 1) / COLS, splits, (M + MT - 1) / MT);
  int4_matmul_kernel<OutT><<<grid, THREADS, SMEM, stream>>>(
      tw, tx, trs, (const float*)cs, (const bf16*)bias, (float*)part, (int*)tickets,
      (OutT*)out, M, K, N, bk, rows);
  return cudaGetLastError();
}

}  // namespace k6
}  // namespace spacer

// CTAs of the kernel an SM holds at once: the wrapper's plan reads it.
extern "C" int spacer_int4_matmul_ctas_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(spacer::k6::int4_matmul_kernel<spacer::bf16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           spacer::k6::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, spacer::k6::int4_matmul_kernel<spacer::bf16>, spacer::k6::THREADS,
          spacer::k6::SMEM) != cudaSuccess)
    return 0;
  return n;
}

// x (M, K) bf16, packed (K/2, N) int8; with row_scale (K) and col_scale (N)
// f32 and an optional bias (N) bf16: dense_q4, out (M, N) bf16; with none of
// the three: out (M, N) f32.  `splits` CTAs of `rows` packed rows each (a
// multiple of 64) cover K/2; with splits > 1, part holds splits * M * N f32
// and tickets one zeroed int per (column tile, 16-row tile), which every
// launch leaves zeroed.  K % 64 == 0 and bk a multiple of 128 or K itself
// (chunks of 64 packed rows never straddle a K-block; the last may be
// half), N % 16 == 0; x, packed and the scales 16-byte aligned (TMA).
extern "C" int spacer_int4_matmul(const void* x, const void* packed, const void* row_scale,
                                  const void* col_scale, const void* bias, void* part,
                                  void* tickets, void* out, int M, int K, int N, int bk,
                                  int splits, int rows, void* stream) {
  using namespace spacer::k6;
  const int K2 = K / 2;
  if (M < 1 || K < 64 || K % 64 || N < 16 || N % 16 || (bk % 128 && bk != K) || K % bk ||
      rows < CH || rows % CH || splits < 1 || splits > 65535 ||
      (long)splits * rows < K2 || (long)(splits - 1) * rows >= K2 ||
      (M + MT - 1) / MT > 65535 || (splits > 1 && (part == nullptr || tickets == nullptr)) ||
      ((row_scale == nullptr) != (col_scale == nullptr)) ||
      (col_scale == nullptr && bias != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (col_scale != nullptr)
    return (int)launch<spacer::bf16>(x, packed, row_scale, col_scale, bias, part, tickets,
                                     out, M, K, N, bk, splits, rows, s);
  return (int)launch<float>(x, packed, nullptr, nullptr, nullptr, part, tickets, out, M, K,
                            N, bk, splits, rows, s);
}

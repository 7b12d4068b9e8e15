// Hopper (sm_90a) building blocks shared by K1's forward
// (flash_attention.cu), K1-bwd dq and dk/dv (flash_attention_bwd.cu), K2
// (flash_decode_grouped.cu), K3 (vit_window_attention.cu), K4
// (vit_chunk_attention.cu) and K6 (int4_matmul.cu):
//
//   - mbarriers: init, arrive, arrive + expect-tx, wait on a phase parity;
//   - TMA: 4-D tile loads from a CUtensorMap passed as a __grid_constant__
//     kernel parameter, completing on an mbarrier; host-side encoders,
//     fetched through cudaGetDriverEntryPoint (no -lcuda), of a (B, S, H, D)
//     bf16 tensor as a (D, H, S, B) map with the 128-byte swizzle (D = 128;
//     D = 80 and 72 also as 16-column boxes with the 32-byte swizzle, into a
//     D = 80 tile),
//     of a (B, H, S, 128) tensor of bf16 (128-byte swizzle) or int8 codes (no
//     swizzle) as a (128, S, H, B) map, of an (H, S, 80) tensor cut into
//     chunks of wt rows as two (80, wt, n, H) maps, columns 0-63 with the
//     128-byte swizzle and 64-79 with the 32-byte swizzle (the ViT's head
//     width), and of a (rows, cols) matrix of bytes, bf16 or f32;
//   - the proxy fence that makes threads' shared-memory stores visible to
//     wgmma;
//   - wgmma: shared-memory descriptors of 128-byte- and 32-byte-swizzled
//     bf16 tiles, fence / commit / wait, and the bf16 -> f32 shapes the
//     kernels use: m64n64k16 with both operands in shared memory, and
//     m64n128k16, m64n64k16 and m64n16k16 with A from registers and B
//     transposed (MN-major);
//   - setmaxnreg.
//
// Tile layout in shared memory, D = 128.  With the 128-byte swizzle a TMA
// box is at most 64 bf16 wide, so a row of D = 128 arrives as two boxes: a
// tile of R rows is two [R][64] blocks of R * 128 bytes, column block c at
// c * R * 128.
// Each block is a run of 1024-byte swizzle atoms (8 rows of 128 bytes, the
// 16-byte chunk j of row r stored at chunk j ^ (r % 8)), which is the
// canonical layout wgmma reads:
//   K-major operand (the reduction runs along the row, e.g. Q and K in
//   Q K^T): SBO = 1024 (next 8 rows), LBO unused; the k-th 16-wide step
//   starts 32 bytes further inside a block, steps 4-7 in the second block.
//   MN-major operand (the reduction runs down the rows, e.g. V in P V):
//   SBO = 1024 (next 8 rows = next 8 of the reduction), LBO = R * 128 (the
//   second 64-column block); the k-th 16-row step starts 2048 bytes on.
// Every tile base is 1024-byte aligned, so the descriptors' base offset is 0.
//
// Tile layout in shared memory, D = 80 (K3, K4; K1 at D = 72).  80 = 64 + 16: a tile of R rows
// is a [R][64] block with the 128-byte swizzle (R * 128 bytes, as above)
// followed by a [R][16] block with the 32-byte swizzle (R * 32 bytes, a run
// of 256-byte atoms: 8 rows of 32 bytes, the 16-byte chunk j of row r stored
// at chunk j ^ ((r / 4) % 2)).  A row arrives as a 128-byte and a 32-byte
// box.  Five 16-column blocks, all with the 32-byte swizzle, would serve
// every product with one descriptor mode but take five 32-byte boxes per row,
// which ran slower on the card; padding to 128 columns would cost 1.6x the
// tensor-core work.
//   K-major operand: k-steps 0-3 in the first block as for D = 128; k-step 4
//   is the second block, SBO = 256 (next 8 rows), LBO unused.
//   MN-major operand: columns 0-63 from the first block as for D = 128,
//   columns 64-79 from the second, SBO = 256; the k-th 16-row step starts
//   2048 and 512 bytes on.  P V is an n64 and an n16 product.
// Block bases are multiples of 1024 and 256 bytes: the base offset is 0.
//
// Accumulator layout of a 64 x N wgmma (f32), thread t of the warpgroup
// (warp w = t / 32, lane l): d[4 * n8 + 2 * j + c] holds row 16 w + l / 4 +
// 8 j, column 8 n8 + 2 (l % 4) + c.  The A-from-registers fragment of a
// 64 x 16 bf16 tile has the same rows and columns as two adjacent n8 blocks
// of that layout, so an accumulator turns into the next product's A operand
// in place (frag_from_acc).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace spacer {

using bf16 = __nv_bfloat16;

namespace sm90 {

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive and announce `bytes` more bytes of TMA traffic on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's current phase differs from `parity` (i.e. the
// phase with that parity has completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// A ring position: stage index and the parity of its current use.
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// --------------------------------------------------------------------- TMA

// Load the box at coordinates (c0, c1, c2, c3) (innermost first) of a 4-D
// tensor map into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Load rows [s0, s0 + R) of head h, batch row b of a (B, S, H, 128) map
// whose box is (64, 1, R, 1): two boxes, column blocks 0 and 1.
template <int R>
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int h, int s0, int b) {
  tma_load_4d(dst, map, bar, 0, h, s0, b);
  tma_load_4d(static_cast<char*>(dst) + R * 128, map, bar, 64, h, s0, b);
}

// Load rows [s0, s0 + R) of head h, batch row b of a (B, H, S, 128) bf16
// map (encode_bhsd) whose box is (64, R, 1, 1): two boxes, column blocks 0
// and 1.
template <int R>
__device__ __forceinline__ void tma_load_bhsd_rows(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int s0, int h, int b) {
  tma_load_4d(dst, map, bar, 0, s0, h, b);
  tma_load_4d(static_cast<char*>(dst) + R * 128, map, bar, 64, s0, h, b);
}

// Load rows [r0, r0 + R) of chunk n, head h of an (H, S, 80) tensor into
// the two blocks of a D = 80 tile: columns 0-63 from `map64` (box (64, R, 1,
// 1)), 64-79 from `map16` (box (16, R, 1, 1)).  Rows past the chunk's end
// read as zeros.
template <int R>
__device__ __forceinline__ void tma_load_chunk_rows(void* dst, const CUtensorMap* map64,
                                                    const CUtensorMap* map16,
                                                    uint64_t* bar, int r0, int n,
                                                    int h) {
  tma_load_4d(dst, map64, bar, 0, r0, n, h);
  tma_load_4d(static_cast<char*>(dst) + R * 128, map16, bar, 64, r0, n, h);
}

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc_encode(uint32_t x) {
  return static_cast<uint64_t>((x & 0x3FFFF) >> 4);
}

// The descriptor's layout field: which swizzle the tile was stored with.
enum class Swizzle : uint64_t { B128 = 1, B32 = 3 };

// Descriptor of a swizzled bf16 tile at `p` (see the header note).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes,
                                              Swizzle swizzle = Swizzle::B128) {
  return desc_encode(smem_addr(p)) | (desc_encode(lbo_bytes) << 16) |
         (desc_encode(sbo_bytes) << 32) | (static_cast<uint64_t>(swizzle) << 62);
}

// K-major operand: rows [r0, r0 + 8 m) of a tile of R rows, k-step kk (16
// columns of D = 128).
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int r0, int kk) {
  const char* p = static_cast<const char*>(tile) + (kk / 4) * (R * 128) + r0 * 128 +
                  (kk % 4) * 32;
  return make_desc(p, 16, 1024);
}

// MN-major operand: reduction rows [16 kk, 16 kk + 16) of a tile of R rows,
// all 128 columns.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk) {
  return make_desc(static_cast<const char*>(tile) + kk * 2048, R * 128, 1024);
}

// The same two for a D = 80 tile (a [R][64] and a [R][16] block): k-step kk
// of 5; and the reduction rows of step kk in the 16-column block (columns
// 0-63 take desc_mnmajor).
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor_d80(const void* tile, int r0, int kk) {
  if (kk < 4) return desc_kmajor<R>(tile, r0, kk);
  return make_desc(static_cast<const char*>(tile) + R * 128 + r0 * 32, 16, 256,
                   Swizzle::B32);
}
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor_d80_hi(const void* tile, int kk) {
  return make_desc(static_cast<const char*>(tile) + R * 128 + kk * 512, R * 32, 256,
                   Swizzle::B32);
}

// A (B, S, H, D) head in shared memory, D = 128 or a D = 80 tile (D = 80,
// and D = 72 whose columns 72-79 TMA fills with zeros): the tile's width,
// rows [s0, s0 + R) of head h, batch row b loaded as two 64-column boxes of
// `map` (D = 128) or a 64- and a 16-column box of `map` and `map16`, and
// the K-major descriptor of k-step kk (DP / 16 of them).
constexpr int head_tile_width(int D) { return D == 128 ? 128 : 80; }

template <int D, int R>
__device__ __forceinline__ void tma_load_head_rows(void* dst, const CUtensorMap* map,
                                                   const CUtensorMap* map16,
                                                   uint64_t* bar, int h, int s0,
                                                   int b) {
  if constexpr (D == 128) {
    tma_load_rows<R>(dst, map, bar, h, s0, b);
  } else {
    tma_load_4d(dst, map, bar, 0, h, s0, b);
    tma_load_4d(static_cast<char*>(dst) + R * 128, map16, bar, 64, h, s0, b);
  }
}

template <int D, int R>
__device__ __forceinline__ uint64_t desc_kmajor_head(const void* tile, int r0, int kk) {
  if constexpr (D == 128) return desc_kmajor<R>(tile, r0, kk);
  else return desc_kmajor_d80<R>(tile, r0, kk);
}

// Order this thread's earlier generic-proxy shared-memory stores before
// later async-proxy reads of them (wgmma operands written by threads).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32) = A B^T (+ d if scale_d), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128 f32) += A B, A a 64 x 16 bf16 fragment in registers, B a
// 16 x 128 MN-major tile in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 f32) += A B, A a 64 x 16 bf16 fragment in registers, B a
// 16 x 64 MN-major tile in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 16 f32) += A B, A a 64 x 16 bf16 fragment in registers, B a
// 16 x 16 MN-major tile in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp, denormals flushed, 2^-inf = 0),
// one instruction where exp2f adds range fix-ups around it.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of reduction step kb (columns [16 kb, 16 kb + 16)) from a
// 64 x N accumulator of f32 values, rounded to bf16.
template <int N>
__device__ __forceinline__ void frag_from_acc(uint32_t (&a)[4], const float (&x)[N],
                                              int kb) {
  a[0] = pack_bf16(x[8 * kb + 0], x[8 * kb + 1]);
  a[1] = pack_bf16(x[8 * kb + 2], x[8 * kb + 3]);
  a[2] = pack_bf16(x[8 * kb + 4], x[8 * kb + 5]);
  a[3] = pack_bf16(x[8 * kb + 6], x[8 * kb + 7]);
}

// -------------------------------------------------------------- registers

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------------- host side

// Encode a 4-D tensor map: dims innermost first, byte strides of dims 1-3,
// box, swizzle, element type (bf16 unless given).  Elements outside the dims
// read as zeros.  A refused encode (e.g. a box row wider than the swizzle
// span) returns an error.
inline cudaError_t encode_4d(
    CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
    const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4], CUtensorMapSwizzle swizzle,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, dtype, 4,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous (B, S, H, D) bf16 tensor as a 4-D TMA map (D, H, S, B) with a
// (cols, 1, rows, 1) box: cols = 64 with the 128-byte swizzle, or 16 with
// the 32-byte swizzle (the second block of a D = 80 tile).  Rows past S (and
// columns past D) read as zeros.
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int B, int S,
                               int H, int D, int rows, int cols = 64) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  return encode_4d(map, base, dims, strides, box,
                   cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
}

// A contiguous (H, S, 80) bf16 tensor, S = n * wt, as a 4-D TMA map (80, wt,
// n, H) with a (cols, rows, 1, 1) box: cols = 64 with the 128-byte swizzle
// or 16 with the 32-byte swizzle (the two blocks of a D = 80 tile).  A box
// that runs past the end of a chunk reads zeros there, never the next chunk.
inline cudaError_t encode_hsd_chunks(CUtensorMap* map, const void* base, int H, int n,
                                     int wt, int rows, int cols) {
  const cuuint64_t dims[4] = {80, (cuuint64_t)wt, (cuuint64_t)n, (cuuint64_t)H};
  const cuuint64_t strides[3] = {80 * 2, (cuuint64_t)wt * 80 * 2,
                                 (cuuint64_t)n * wt * 80 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  return encode_4d(map, base, dims, strides, box,
                   cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
}

// A contiguous (B, H, S, 128) tensor as a 4-D TMA map (128, S, H, B) with a
// box of `rows` rows of one (h, b): bf16 as (64, rows, 1, 1) boxes with the
// 128-byte swizzle (two per row, as encode_bshd's), or int8 codes as one
// (128, rows, 1, 1) box, unswizzled.  Rows past S read as zeros.
inline cudaError_t encode_bhsd(CUtensorMap* map, const void* base, int B, int H, int S,
                               int rows, bool int8) {
  const cuuint64_t esz = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {128, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {128 * esz, (cuuint64_t)S * 128 * esz,
                                 (cuuint64_t)H * S * 128 * esz};
  const cuuint32_t box[4] = {int8 ? 128u : 64u, (cuuint32_t)rows, 1, 1};
  return int8 ? encode_4d(map, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_DATA_TYPE_UINT8)
              : encode_4d(map, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A contiguous (rows, cols) matrix of `dtype` (uint8, bf16 or f32) as a TMA
// map with a (box_cols, box_rows) box and `swizzle`: with the 128-byte
// swizzle a box row is 128 bytes, row r of a box lands at r * 128 and its
// 16-byte chunk j at chunk j ^ (r % 8).  The row stride (cols x element
// size) is a multiple of 16 bytes; rows and columns past the matrix read as
// zeros.
inline cudaError_t encode_2d(CUtensorMap* map, const void* base, long rows, long cols,
                             int box_rows, int box_cols, CUtensorMapDataType dtype,
                             CUtensorMapSwizzle swizzle) {
  const cuuint64_t esz = dtype == CU_TENSOR_MAP_DATA_TYPE_UINT8      ? 1
                         : dtype == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2
                                                                     : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * esz, (cuuint64_t)(rows * cols) * esz,
                                 (cuuint64_t)(rows * cols) * esz};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  return encode_4d(map, base, dims, strides, box, swizzle, dtype);
}

}  // namespace sm90
}  // namespace spacer

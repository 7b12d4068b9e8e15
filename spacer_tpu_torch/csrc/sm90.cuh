// Hopper (sm_90a) building blocks shared by K1's forward
// (flash_attention.cu) and K1-bwd dk/dv (flash_attention_bwd.cu):
//
//   - mbarriers: init, arrive, arrive + expect-tx, wait on a phase parity;
//   - TMA: 4-D tile loads from a CUtensorMap passed as a __grid_constant__
//     kernel parameter, completing on an mbarrier; the host-side encoder of
//     a (B, S, H, D) bf16 tensor as a (D, H, S, B) map with the 128-byte
//     swizzle, fetched through cudaGetDriverEntryPoint (no -lcuda);
//   - wgmma: shared-memory descriptors of 128-byte-swizzled bf16 tiles,
//     fence / commit / wait, and the two bf16 -> f32 shapes the kernels use:
//     m64n64k16 with both operands in shared memory, and m64n128k16 with A
//     from registers and B transposed (MN-major);
//   - setmaxnreg.
//
// Tile layout in shared memory.  With the 128-byte swizzle a TMA box is at
// most 64 bf16 wide, so a row of D = 128 arrives as two boxes: a tile of R
// rows is two [R][64] blocks of R * 128 bytes, column block c at c * R * 128.
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

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc_encode(uint32_t x) {
  return static_cast<uint64_t>((x & 0x3FFFF) >> 4);
}

// Descriptor of a 128-byte-swizzled bf16 tile at `p` (see the header note).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return desc_encode(smem_addr(p)) | (desc_encode(lbo_bytes) << 16) |
         (desc_encode(sbo_bytes) << 32) | (1ull << 62);
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

// Encode a contiguous (B, S, H, D) bf16 tensor as a 4-D TMA map (D, H, S, B)
// with a (64, 1, rows, 1) box and the 128-byte swizzle.  Rows past S (and
// columns past D) read as zeros.
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int B, int S,
                               int H, int D, int rows) {
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
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace spacer

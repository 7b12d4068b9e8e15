// K4: attention inside each temporal frame chunk of the ViT, on Hopper's
// wgmma and TMA.
//
// Replaces spacer_tpu/ops/vit_window_attention.py::chunk_attention_hsd
// (_kernel_nomask): the 4 full-attention layers of the Qwen2.5-VL ViT, one
// segment per frame chunk (wt = 480 tokens at grid (8, 16, 30)), every key
// valid.  Same contract as the plain version
// spacer_tpu_torch/ops/vit_window_attention.py::chunk_attention_reference:
// q, k, v (H, S, D) bf16 with D = 80 unpadded, S = n * wt; each chunk of wt
// tokens attends to itself; f32 logits, p rounded to bf16 before P V, bf16
// out.  wt may be any size (a ViT chunk is (h/14)(w/14) patches, a multiple
// of 4 such as 100 or 252, not of the tiles).
//
// What bounds it on the H100: at the ViT's shape (H = 16, S = 3840, wt =
// 480) reading q, k, v and writing out once is 39 MB (0.0117 ms at 3.35
// TB/s) and the products are 9.44 GFLOP (0.0095 ms at 989 TFLOP/s), so the
// bound is bytes, with operations close behind.  On the card the K/V tiles'
// trip from L2 through TMA weighs more than the products: in probe builds,
// dropping the softmax and P V saved less than shrinking the loads.  So one
// K/V tile feeds as many query rows as the registers allow (256), arrives
// in few wide boxes, and the softmax keeps its instructions few.
//
// Layout: one CTA per (256-row q tile, chunk, head), 5 warpgroups; a chunk
// of 480 rows is 2 q tiles (the second with 224 live rows), 256 CTAs at the
// ViT's shape.
//   - Tensor maps describe each (H, S, 80) tensor as (80, wt, n, H)
//     (sm90.cuh encode_hsd_chunks): a box that runs past a chunk's end is
//     zero-filled by TMA and never reads the next chunk, so Q needs no mask
//     and only the chunk's last key tile masks its keys past wt (-inf).
//   - The exact head width: a tile is a 64-column block with the 128-byte
//     swizzle and a 16-column block with the 32-byte swizzle (sm90.cuh's
//     D = 80 note: two TMA boxes per row, 80 % of the bytes in 128-byte
//     rows), so the tensor cores do the 80 columns the function needs and
//     no padding.
//   - warpgroup 4, one thread of it: the producer.  It TMA-loads the Q tile
//     once and streams K and V tiles of 64 keys through a ring of 3 stages
//     (full / empty mbarriers).  setmaxnreg gives its registers to the
//     consumers (24 vs 112).
//   - warpgroups 0-3: 64 query rows each (a warpgroup whose rows all lie
//     past the chunk's end exits).  Per key tile:
//       S = Q K^T      wgmma m64n64k16, 5 k-steps, both operands K-major in
//                      shared memory;
//       online softmax in registers (a thread holds parts of 2 rows; row max
//                      and sum over the quad with two shfl_xor; exp2 on the
//                      SFU with the scale folded into one FFMA; the running
//                      max moves only when a row's max exceeds it by more
//                      than 8 in log2 units, so O is rescaled on few tiles);
//       O += P V       wgmma m64n64k16 and m64n16k16 (columns 0-63 and
//                      64-79), P as bf16 A fragments from the S accumulator
//                      registers, V an MN-major B.
//     O (32 + 8 f32 per thread) stays in registers; the epilogue normalises it
//     and writes the chunk's rows only (rows past wt are never stored).
#include "sm90.cuh"

namespace spacer {
namespace k4 {

constexpr int D = 80;
constexpr int NWG = 4;        // consumer warpgroups
constexpr int BM = 64 * NWG;  // query rows per CTA
constexpr int BN = 64;        // keys per tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 128 * (NWG + 1);
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
  static constexpr int q = 0;                                 // bf16 [BM][64], [BM][16]
  static constexpr int kv = q + BM * D * 2;                   // [STAGES] x (K, V)
  static constexpr int tile = BN * D * 2;                     // one K or V tile
  static constexpr int bars = kv + STAGES * 2 * tile;         // full, empty, q
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8;
  static constexpr int alloc = bytes + 1024;                  // base alignment
};

__global__ void __launch_bounds__(NTHREADS, 1)
chunk_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tq16,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tk16,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tv16, bf16* __restrict__ out,
                       int S, int wt, float scale_log2) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem + Smem::q;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Smem::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int q0 = blockIdx.x * BM, chunk = blockIdx.y, h = blockIdx.z;
  const int n_kt = (wt + BN - 1) / BN;
  // consumer warpgroups with a row inside the chunk (the rest only exit)
  const int n_wg = min(NWG, (wt - q0 + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);      // the producer thread (+ TMA bytes)
      mbar_init(&empty[s], 128 * n_wg);   // every working consumer thread
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    regs_dealloc<24>();
    if (threadIdx.x != 128 * NWG) return;   // one producer thread
    mbar_arrive_expect_tx(qbar, BM * D * 2);
    tma_load_chunk_rows<BM>(Qs, &tq, &tq16, qbar, q0, chunk, h);
    RingPos pos;
    for (int i = 0; i < n_kt; ++i) {
      mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
      unsigned char* st = smem + Smem::kv + pos.stage * 2 * Smem::tile;
      mbar_arrive_expect_tx(&full[pos.stage], 2 * Smem::tile);
      tma_load_chunk_rows<BN>(st, &tk, &tk16, &full[pos.stage], i * BN, chunk, h);
      tma_load_chunk_rows<BN>(st + Smem::tile, &tv, &tv16, &full[pos.stage], i * BN,
                              chunk, h);
      pos.advance<STAGES>();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  regs_alloc<112>();
  if (wg >= n_wg) return;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r_lo = 64 * wg + warp * 16 + lane / 4;   // rows r_lo, r_lo + 8

  float o[32], o16[8];   // columns 0-63 and 64-79
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o16[i] = 0.f;
  // m: the running row max of s * scale_log2.  Key tile 0 holds at least
  // one key of the chunk, so every max is finite after it and the -inf of
  // keys past wt weighs exactly 0.
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  RingPos pos;
  for (int i = 0; i < n_kt; ++i) {
    mbar_wait(&full[pos.stage], pos.phase);
    const unsigned char* Ks = smem + Smem::kv + pos.stage * 2 * Smem::tile;
    const unsigned char* Vs = Ks + Smem::tile;
    const int k0 = i * BN;

    // S = Q K^T (s starts undefined: the first step ignores it)
    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(s, desc_kmajor_d80<BM>(Qs, 64 * wg, kk),
                         desc_kmajor_d80<BN>(Ks, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // keys past the chunk's end: only in its last tile
    if (k0 + BN > wt) {
#pragma unroll
      for (int idx = 0; idx < BN / 2; ++idx) {
        const int col = (idx / 4) * 8 + (lane % 4) * 2 + idx % 2;
        if (k0 + col >= wt) s[idx] = -INFINITY;
      }
    }

    // online softmax in log2 units, row max over the quad, with a lazy max:
    // a row's m moves only when its new max exceeds it by more than 8, so p
    // <= 2^8 and o and l share the stale m (out is the same function);
    // p = 2^(s scale_log2 - m) with the scale folded into one FFMA
    float mnew[2], rsum[2] = {0.f, 0.f};
    bool grow = false;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = -INFINITY;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8)
        mx = fmaxf(mx, fmaxf(s[4 * n8 + 2 * j], s[4 * n8 + 2 * j + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx *= scale_log2;
      mnew[j] = mx > m[j] + 8.f ? mx : m[j];
      grow |= mnew[j] != m[j];
    }
    if (__any_sync(0xffffffffu, grow)) {
      float alpha[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        alpha[j] = exp2_approx(m[j] - mnew[j]);
        l[j] *= alpha[j];
        m[j] = mnew[j];
      }
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) o[idx] *= alpha[(idx / 2) % 2];
#pragma unroll
      for (int idx = 0; idx < 8; ++idx) o16[idx] *= alpha[(idx / 2) % 2];
    }
#pragma unroll
    for (int idx = 0; idx < BN / 2; ++idx) {
      const int j = (idx / 2) % 2;
      s[idx] = exp2_approx(fmaf(s[idx], scale_log2, -m[j]));
      rsum[j] += s[idx];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] += rsum[j];

    // O += P V, P rounded to bf16 in registers
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) frag_from_acc(pa[kb], s, kb);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      wgmma_m64n64k16_rs(o, pa[kb], desc_mnmajor<BN>(Vs, kb), 1);
      wgmma_m64n16k16_rs(o16, pa[kb], desc_mnmajor_d80_hi<BN>(Vs, kb), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(o16);
    mbar_arrive(&empty[pos.stage]);
    pos.advance<STAGES>();
  }

  // epilogue: the row sums over the quad, normalise, write the chunk's rows
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float lj = l[j];
    lj += __shfl_xor_sync(0xffffffffu, lj, 1);
    lj += __shfl_xor_sync(0xffffffffu, lj, 2);
    const float inv = 1.f / lj;
    const int row = q0 + r_lo + 8 * j;
    if (row >= wt) continue;
    bf16* orow = out + ((long)h * S + (long)chunk * wt + row) * D + (lane % 4) * 2;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
      *reinterpret_cast<uint32_t*>(orow + n8 * 8) =
          pack_bf16(o[4 * n8 + 2 * j] * inv, o[4 * n8 + 2 * j + 1] * inv);
#pragma unroll
    for (int n8 = 0; n8 < 2; ++n8)
      *reinterpret_cast<uint32_t*>(orow + 64 + n8 * 8) =
          pack_bf16(o16[4 * n8 + 2 * j] * inv, o16[4 * n8 + 2 * j + 1] * inv);
  }
}

static cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                          int H, int S, int wt, float scale, cudaStream_t stream) {
  const int n = S / wt;
  CUtensorMap tq, tq16, tk, tk16, tv, tv16;   // columns 0-63 and 64-79
  cudaError_t err = sm90::encode_hsd_chunks(&tq, q, H, n, wt, BM, 64);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tq16, q, H, n, wt, BM, 16);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tk, k, H, n, wt, BN, 64);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tk16, k, H, n, wt, BN, 16);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tv, v, H, n, wt, BN, 64);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tv16, v, H, n, wt, BN, 16);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chunk_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::alloc);
  if (err != cudaSuccess) return err;
  dim3 grid((wt + BM - 1) / BM, n, H);
  chunk_attention_kernel<<<grid, NTHREADS, Smem::alloc, stream>>>(
      tq, tq16, tk, tk16, tv, tv16, (bf16*)out, S, wt, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace k4
}  // namespace spacer

extern "C" int spacer_chunk_attention_hsd(const void* q, const void* k,
                                          const void* v, void* out, int H, int S,
                                          int D, int wt, float scale,
                                          void* stream) {
  if (D != spacer::k4::D || H <= 0 || wt <= 0 || S <= 0 || S % wt != 0)
    return (int)cudaErrorInvalidValue;
  return spacer::k4::launch(q, k, v, out, H, S, wt, scale, (cudaStream_t)stream);
}

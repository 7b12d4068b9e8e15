// K3: attention inside the ViT's windows, on Hopper's wgmma and TMA.
//
// Replaces spacer_tpu/ops/vit_window_attention.py::window_attention_hsd
// (_kernel): the 28 windowed layers of the Qwen2.5-VL ViT, segments of
// wt = 64 tokens (4 x 4 x 4 patches) whose tail slots are padding, masked by
// an additive (1, S) validity bias (0 valid, -1e30 pad).  Same contract as
// the plain version spacer_tpu_torch/ops/vit_window_attention.py::
// window_attention_reference: q, k, v (H, S, 80) bf16, S = n * wt, each
// window attends to itself, f32 logits plus the bias, p rounded to bf16
// before P V, bf16 out.  Windows of wt <= 64 only (one key tile); the
// wrapper refuses larger ones.  K4, the 4 full-attention layers, is
// vit_chunk_attention.cu; both build on sm90.cuh.
//
// What bounds it on the H100: bytes.  At the ViT's shape (16, 4096, 80),
// wt = 64, q, k, v and out are 42 MB (0.0125 ms at 3.35 TB/s; the valid
// rows 0.0117 ms) against 1.34 GFLOP of products (0.0014 ms).  The first
// port (WMMA from shared memory, scores and O through shared memory) ran at
// 6x that bound, slower than SDPA with the windows as its batch.
//
// Design: one CTA of one warpgroup per (window, head), 1024 CTAs at the
// ViT's shape.  A window is exactly one 64-row q tile and one 64-key tile,
// so nothing streams and nothing is shared between windows: no producer
// warp and no ring.  Each CTA holds 30 KB of tiles, so 4-5 CTAs share an SM
// and one CTA's loads overlap another's products; that is the overlap a
// persistent grid with a 2-stage ring would give, at none of its code.
//   - Tensor maps describe each (H, S, 80) tensor as (80, wt, n, H)
//     (sm90.cuh encode_hsd_chunks, as K4): a box never reads the next
//     window (rows past wt read zeros), so Q needs no mask.  A tile is a
//     64-column block with the 128-byte swizzle plus a 16-column block with
//     the 32-byte swizzle (sm90.cuh's D = 80 note).
//   - One thread issues the six TMA boxes: Q and K complete on one
//     mbarrier, V on another, so S = Q K^T starts before V has arrived.
//   - S = Q K^T: wgmma m64n64k16, 4 + 1 k-steps, both operands K-major.
//     Each thread adds the bias of its 16 key columns (read while the tiles
//     load; keys past wt -inf), in log2 units with the scale in one FFMA.
//   - The softmax is exact over the single key tile (no running max, no
//     rescale): row max and sum over the quad, exp2 on the SFU.
//   - O = P V: P as bf16 A fragments from the S registers, wgmma m64n64k16
//     and m64n16k16 (columns 0-63 and 64-79), V MN-major.  O is normalised
//     in registers and the window's rows (< wt) are stored.
#include "sm90.cuh"

namespace spacer {
namespace k3 {

constexpr int D = 80;
constexpr int BN = 64;   // rows of a window tile (q and keys); wt <= BN
constexpr int NTHREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

struct Smem {
  static constexpr int tile = BN * D * 2;   // [64][64] + [64][16] bf16
  static constexpr int q = 0, k = tile, v = 2 * tile;
  static constexpr int bars = 3 * tile;     // Q + K, V
  static constexpr int bytes = bars + 2 * 8;
  static constexpr int alloc = bytes + 1024;   // base alignment
};

__global__ void __launch_bounds__(NTHREADS)
window_attention_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tq16,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tk16,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tv16,
                        const float* __restrict__ bias, bf16* __restrict__ out, int S,
                        int wt, float scale_log2) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem + Smem::q;
  unsigned char* Ks = smem + Smem::k;
  unsigned char* Vs = smem + Smem::v;
  uint64_t* qk_bar = reinterpret_cast<uint64_t*>(smem + Smem::bars);
  uint64_t* v_bar = qk_bar + 1;

  const int win = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(qk_bar, 1);
    mbar_init(v_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(qk_bar, 2 * Smem::tile);
    tma_load_chunk_rows<BN>(Qs, &tq, &tq16, qk_bar, 0, win, h);
    tma_load_chunk_rows<BN>(Ks, &tk, &tk16, qk_bar, 0, win, h);
    mbar_arrive_expect_tx(v_bar, Smem::tile);
    tma_load_chunk_rows<BN>(Vs, &tv, &tv16, v_bar, 0, win, h);
  }

  // the bias of this thread's key columns 8 n8 + 2 (lane % 4) + c, in log2
  // units; keys past the window's end weigh exactly 0
  float bl[BN / 4];
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * n8 + 2 * (lane % 4) + c;
      bl[2 * n8 + c] = col < wt ? bias[(long)win * wt + col] * LOG2E : -INFINITY;
    }

  // S = Q K^T (s starts undefined: the first step ignores it)
  float s[BN / 2];
  mbar_wait(qk_bar, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(s, desc_kmajor_d80<BN>(Qs, 0, kk), desc_kmajor_d80<BN>(Ks, 0, kk),
                       kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // exact softmax over the tile in log2 units: t = s scale_log2 + bias
  // log2(e), row max and sum over the quad; every row has a key < wt, so
  // its max is finite
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int idx = 0; idx < BN / 2; ++idx) {
    s[idx] = fmaf(s[idx], scale_log2, bl[2 * (idx / 4) + idx % 2]);
    m[(idx / 2) % 2] = fmaxf(m[(idx / 2) % 2], s[idx]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 1));
    m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 2));
  }
#pragma unroll
  for (int idx = 0; idx < BN / 2; ++idx) {
    const int j = (idx / 2) % 2;
    s[idx] = exp2_approx(s[idx] - m[j]);
    l[j] += s[idx];
  }

  // O = P V, P rounded to bf16 in registers
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int kb = 0; kb < BN / 16; ++kb) frag_from_acc(pa[kb], s, kb);
  float o[32], o16[8];   // columns 0-63 and 64-79
  mbar_wait(v_bar, 0);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < BN / 16; ++kb) {
    wgmma_m64n64k16_rs(o, pa[kb], desc_mnmajor<BN>(Vs, kb), kb > 0);
    wgmma_m64n16k16_rs(o16, pa[kb], desc_mnmajor_d80_hi<BN>(Vs, kb), kb > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(o16);

  // epilogue: the row sums over the quad, normalise, write the window's rows
  const int r_lo = warp * 16 + lane / 4;   // rows r_lo, r_lo + 8
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float lj = l[j];
    lj += __shfl_xor_sync(0xffffffffu, lj, 1);
    lj += __shfl_xor_sync(0xffffffffu, lj, 2);
    const float inv = 1.f / lj;
    const int row = r_lo + 8 * j;
    if (row >= wt) continue;
    bf16* orow = out + ((long)h * S + (long)win * wt + row) * D + (lane % 4) * 2;
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

static cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                          void* out, int H, int S, int wt, float scale,
                          cudaStream_t stream) {
  const int n = S / wt;
  CUtensorMap tq, tq16, tk, tk16, tv, tv16;   // columns 0-63 and 64-79
  cudaError_t err = sm90::encode_hsd_chunks(&tq, q, H, n, wt, BN, 64);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tq16, q, H, n, wt, BN, 16);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tk, k, H, n, wt, BN, 64);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tk16, k, H, n, wt, BN, 16);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tv, v, H, n, wt, BN, 64);
  if (err == cudaSuccess) err = sm90::encode_hsd_chunks(&tv16, v, H, n, wt, BN, 16);
  if (err != cudaSuccess) return err;
  dim3 grid(n, H);   // 31.7 KB of dynamic shared memory: under the 48 KB default
  window_attention_kernel<<<grid, NTHREADS, Smem::alloc, stream>>>(
      tq, tq16, tk, tk16, tv, tv16, (const float*)bias, (bf16*)out, S, wt,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace k3
}  // namespace spacer

extern "C" int spacer_window_attention_hsd(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* out, int H, int S, int D,
                                           int wt, float scale, void* stream) {
  if (D != spacer::k3::D || H <= 0 || H > 65535 || wt <= 0 || wt > spacer::k3::BN ||
      S <= 0 || S % wt != 0)
    return (int)cudaErrorInvalidValue;
  return spacer::k3::launch(q, k, v, bias, out, H, S, wt, scale, (cudaStream_t)stream);
}

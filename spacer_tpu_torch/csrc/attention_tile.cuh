// Device code of the WMMA attention kernel K2 (flash_decode_grouped.cu):
// one CTA computes a tile of up to 64 query rows against a run of keys with
// an online softmax, on the tensor cores through WMMA (bf16 operands, f32
// accumulation).  K1's forward, K1-bwd dq and dk/dv, K3 and K4 do not use
// it: they run on wgmma and TMA (sm90.cuh); K5 on the CUDA cores.
//
// CTA = 4 warps; warp w owns query rows [16w, 16w+16) of the tile.  Per key
// tile of 64 keys:
//   S_w = Q_w K^T          (WMMA, scores to shared memory as f32)
//   row-wise online softmax (lanes own 2 of the 64 columns of a row;
//                            P rounded to bf16, as the TPU kernel does)
//   O_w = alpha * O_w + P_w V   (WMMA, O kept in shared memory as f32)
// Masked scores take the finite value -1e30 (never -inf), so a row whose
// keys are all masked ends as the mean of V over them: finite, and what the
// plain versions compute.  Keys past the end of the run get -inf and weigh
// exactly 0; the running max starts at -1e30, so no -inf - (-inf) arises.
//
// int8 K/V (K2-int8, flash_decode_grouped.cu): with KVT = int8_t the K and
// V tiles arrive as int8 codes (half the bytes) and become bf16 in shared
// memory (exact for |c| <= 127); the mask policy applies the per-key K scale
// to the logit and supplies the per-key V scale, which multiplies p for the
// P.V product only (the denominator sums the unscaled p, as the TPU kernel
// does).  The default KVT = bf16 is K2's bf16 path.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace spacer {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;          // query rows per CTA
constexpr int BN = 64;          // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASK_VALUE = -1e30f;

// Byte offsets inside the dynamic shared memory of one CTA.  Every offset
// is a multiple of 32 bytes, as WMMA loads and stores require.  EXTRA_INFO
// more 32-bit words of side data follow the info block (the int8 path's
// per-key scales); the offsets do not depend on it.
template <int D, int EXTRA_INFO = 0>
struct TileSmem {
  static constexpr size_t q = 0;                                  // bf16 [BM][D]
  static constexpr size_t k = q + BM * D * sizeof(bf16);          // bf16 [BN][D]
  static constexpr size_t v = k + BN * D * sizeof(bf16);          // bf16 [BN][D]
  static constexpr size_t o = v + BN * D * sizeof(bf16);          // f32  [BM][D]
  static constexpr size_t s = o + BM * D * sizeof(float);         // f32  [BM][BN]
  static constexpr size_t p = s + BM * BN * sizeof(float);        // bf16 [BM][BN]
  static constexpr size_t ml = p + BM * BN * sizeof(bf16);        // f32  m[BM], l[BM]
  static constexpr size_t info = ml + 2 * BM * sizeof(float);     // 32-bit [BM + BN]
  static constexpr size_t bytes = info + (BM + BN + EXTRA_INFO) * sizeof(float);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy 64 rows of D bf16 (row stride `stride` elements) into a dense
// [64][D] shared tile with 16-byte vectors; rows >= n are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src,
                                          long stride, int n, int tid) {
  constexpr int VPR = D / 8;
  for (int i = tid; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

// The same for 64 rows of D int8 codes, widened to bf16 (exact for
// |c| <= 127) on the way into shared memory.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const int8_t* __restrict__ src,
                                          long stride, int n, int tid) {
  constexpr int VPR = D / 16;
  for (int i = tid; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 16;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < n) val = *reinterpret_cast<const int4*>(src + r * stride + c);
    const int8_t* codes = reinterpret_cast<const int8_t*>(&val);
    __align__(16) bf16 wide[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) wide[j] = __int2bfloat16_rn(codes[j]);
    *reinterpret_cast<uint4*>(dst + r * D + c) = *reinterpret_cast<const uint4*>(wide);
    *reinterpret_cast<uint4*>(dst + r * D + c + 8) = *reinterpret_cast<const uint4*>(wide + 8);
  }
}

// One CTA: rows [0, n_q) of q (row stride q_rs) against keys [0, n_kv) of
// k/v (row stride kv_rs).  Mask policy:
//   load_queries(n_q, tid, info) / load_keys(k0, nk, tid, info): fill the
//     per-row / per-key side data of the tile into `info` (shared memory);
//   apply(s, qi, kj, kg, info): the scaled score of row qi and key kj of the
//     tile (global key index kg) after masking;
//   v_scale(kj, info) (int8 K/V only): the V scale of key kj of the tile.
// Writes the normalised rows to out (f32, row stride o_rs) and the per-row
// log-sum-exp to lse (stride 1).
template <int D, class Mask, class KVT = bf16>
__device__ void attend(const bf16* __restrict__ q, long q_rs, int n_q,
                       const KVT* __restrict__ k, const KVT* __restrict__ v,
                       long kv_rs, int n_kv, float scale, const Mask& mask,
                       float* __restrict__ out, long o_rs, float* __restrict__ lse) {
  using namespace nvcuda;
  using L = TileSmem<D>;
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* m_s = reinterpret_cast<float*>(smem + L::ml);
  float* l_s = m_s + BM;
  int* info = reinterpret_cast<int*>(smem + L::info);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  load_rows<D>(Qs, q, q_rs, n_q, tid);
  for (int i = tid; i < BM * D; i += NTHREADS) Os[i] = 0.f;
  for (int i = tid; i < BM; i += NTHREADS) {
    m_s[i] = MASK_VALUE;
    l_s[i] = 0.f;
  }
  mask.load_queries(n_q, tid, info);

  float* Sw = Ss + warp * 16 * BN;
  bf16* Pw = Ps + warp * 16 * BN;
  float* Ow = Os + warp * 16 * D;
  const bf16* Qw = Qs + warp * 16 * D;

  for (int k0 = 0; k0 < n_kv; k0 += BN) {
    const int nk = min(BN, n_kv - k0);
    __syncthreads();  // the previous tile's K, V and key info are consumed
    load_rows<D>(Ks, k + k0 * kv_rs, kv_rs, nk, tid);
    load_rows<D>(Vs, v + k0 * kv_rs, kv_rs, nk, tid);
    mask.load_keys(k0, nk, tid, info);
    __syncthreads();

    // S_w = Q_w K^T: K is row-major [key][d], i.e. K^T column-major.
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qw + kk * 16, D);
        wmma::load_matrix_sync(b, Ks + n * 16 * D + kk * 16, D);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, BN, wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int qi = warp * 16 + r;
      const int c0 = lane, c1 = lane + 32;
      float s0 = c0 < nk ? mask.apply(Sw[r * BN + c0] * scale, qi, c0, k0 + c0, info)
                         : -INFINITY;
      float s1 = c1 < nk ? mask.apply(Sw[r * BN + c1] * scale, qi, c1, k0 + c1, info)
                         : -INFINITY;
      const float m_old = m_s[qi];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float alpha = __expf(m_old - m_new);
      const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      if constexpr (std::is_same<KVT, bf16>::value) {
        Pw[r * BN + c0] = __float2bfloat16(p0);
        Pw[r * BN + c1] = __float2bfloat16(p1);
      } else {  // V scales multiply p for P.V only
        Pw[r * BN + c0] = __float2bfloat16(p0 * mask.v_scale(c0, info));
        Pw[r * BN + c1] = __float2bfloat16(p1 * mask.v_scale(c1, info));
      }
      const float sum = warp_sum(p0 + p1);
      for (int c = lane; c < D; c += 32) Ow[r * D + c] *= alpha;
      if (lane == 0) {
        m_s[qi] = m_new;
        l_s[qi] = l_s[qi] * alpha + sum;
      }
    }
    __syncwarp();

    // O_w += P_w V, accumulating onto the rescaled O_w.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Ow + n * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Pw + kk * 16, BN);
        wmma::load_matrix_sync(b, Vs + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ow + n * 16, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int r = 0; r < 16; ++r) {
    const int qi = warp * 16 + r;
    if (qi >= n_q) break;
    const float l = l_s[qi];
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    for (int c = lane; c < D; c += 32)
      out[qi * o_rs + c] = Ow[r * D + c] * inv;
    if (lane == 0) lse[qi] = m_s[qi] + logf(l_safe);
  }
}

}  // namespace spacer

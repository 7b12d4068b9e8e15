// K1 backward: the two gradient kernels of the LM's flash attention.
//
// Replaces spacer_tpu/ops/flash_attention.py::_flash_bwd, which makes two
// Pallas calls: dq (`_bwd_dq_kernel`) and dk/dv (`_bwd_dkv_kernel`).  Same
// contract as K1's forward (flash_attention.cu): q (B,Sq,Hq,D), k/v
// (B,Skv,Hkv,D) bf16 in the JAX layout, causal with a static q_offset, a
// (B,Skv) validity mask and optional (B,S) segment ids (flash_mask.cuh),
// GQA.  Inputs beside q/k/v: dout (B,Sq,Hq,D) bf16, the forward's LSE
// (B,Hq,Sq) f32 and delta = rowsum(dout * out) (B,Hq,Sq) f32.
//
// Both kernels recompute p = exp(s * scale - lse) from the forward's LSE and
// set p = 0 wherever the forward's mask hid the key (as the TPU kernel's
// jnp.where(mask, p, 0) does).  A fully masked query row (a left-padded
// prompt position) therefore contributes exactly 0 to dq, dk and dv: there
// is no exp(0) = 1 weight and no inf - inf, so no NaN can reach a live row
// through 0 * NaN.  ds = p * (dp - delta) * scale, dp = dout . v.
//
// dq: one CTA (4 warps) per (64-row q tile, q head, batch row) walks the key
//   tiles up to its causal limit.  Warp w owns q rows [16w, 16w+16): per
//   key tile, S_w = Q_w K^T and dP_w = dO_w V^T on WMMA, ds in registers ->
//   bf16 in shared memory, dQ_w += dS_w K with dQ_w kept in WMMA
//   accumulator fragments across the whole walk.
// dk/dv: one CTA per (64-key tile, kv head, batch row) walks the q tiles
//   that can see its keys, for all Hq/Hkv q heads of the GQA group, so the
//   group's sum (the TPU wrapper's reshape + sum over a (B,Hq,Skv,D)
//   buffer) happens in the CTA's f32 accumulators.  Warp w owns key rows
//   [16w, 16w+16): S^T_w = K_w Q^T, dP^T_w = V_w dO^T, then
//   dV_w += P^T_w dO and dK_w += dS^T_w Q (p and ds rounded to bf16 as the
//   TPU kernel's astype does), accumulators in shared memory as f32.
//
// What bounds it on the H100: flops, about 2.5x the forward's (five
// 64x64x128 products per tile pair instead of two).  Like the forward this
// first version runs WMMA 16x16x16 out of shared memory with no
// load/compute overlap, far below the tensor-core peak; wgmma, TMA and a
// producer warp are the next steps.
#include "flash_mask.cuh"

namespace spacer {

// Dynamic shared memory of the dq kernel (byte offsets, multiples of 32).
template <int D>
struct DqSmem {
  static constexpr size_t q = 0;                                  // bf16 [BM][D]
  static constexpr size_t d_o = q + BM * D * sizeof(bf16);        // bf16 [BM][D]
  static constexpr size_t k = d_o + BM * D * sizeof(bf16);        // bf16 [BN][D]
  static constexpr size_t v = k + BN * D * sizeof(bf16);          // bf16 [BN][D]
  static constexpr size_t s = v + BN * D * sizeof(bf16);          // f32  [BM][BN]
  static constexpr size_t dp = s + BM * BN * sizeof(float);       // f32  [BM][BN]
  static constexpr size_t ds = dp + BM * BN * sizeof(float);      // bf16 [BM][BN]
  static constexpr size_t rows = ds + BM * BN * sizeof(bf16);     // f32 lse[BM], delta[BM]
  static constexpr size_t info = rows + 2 * BM * sizeof(float);   // 32-bit [BM + BN]
  static constexpr size_t bytes = info + (BM + BN) * sizeof(int);
};

// Dynamic shared memory of the dk/dv kernel.
template <int D>
struct DkvSmem {
  static constexpr size_t k = 0;                                  // bf16 [BN][D]
  static constexpr size_t v = k + BN * D * sizeof(bf16);          // bf16 [BN][D]
  static constexpr size_t q = v + BN * D * sizeof(bf16);          // bf16 [BM][D]
  static constexpr size_t d_o = q + BM * D * sizeof(bf16);        // bf16 [BM][D]
  static constexpr size_t s = d_o + BM * D * sizeof(bf16);        // f32  [BN][BM]
  static constexpr size_t dp = s + BN * BM * sizeof(float);       // f32  [BN][BM]
  static constexpr size_t p = dp + BN * BM * sizeof(float);       // bf16 [BN][BM]
  static constexpr size_t ds = p + BN * BM * sizeof(bf16);        // bf16 [BN][BM]
  static constexpr size_t dk = ds + BN * BM * sizeof(bf16);       // f32  [BN][D]
  static constexpr size_t dv = dk + BN * D * sizeof(float);       // f32  [BN][D]
  static constexpr size_t rows = dv + BN * D * sizeof(float);     // f32 lse[BM], delta[BM]
  static constexpr size_t info = rows + 2 * BM * sizeof(float);   // 32-bit [BM + BN]
  static constexpr size_t bytes = info + (BM + BN) * sizeof(int);
};

// lse / delta of rows [q0, q0 + n_q) of one (batch, head); zero past n_q.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               long base, int n_q, int tid) {
  for (int i = tid; i < BM; i += NTHREADS) {
    lse_s[i] = i < n_q ? lse[base + i] : 0.f;
    delta_s[i] = i < n_q ? delta[base + i] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, const uint8_t* __restrict__ kv_valid,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                    float scale) {
  using namespace nvcuda;
  using L = DqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::d_o);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds);
  float* lse_s = reinterpret_cast<float*>(smem + L::rows);
  float* delta_s = lse_s + BM;
  int* info = reinterpret_cast<int*>(smem + L::info);

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int n_q = min(BM, Sq - q0);
  const int hk = h / (Hq / Hkv);
  const long q_rs = (long)Hq * D, kv_rs = (long)Hkv * D;
  int n_kv = Skv;
  if (causal) n_kv = max(0, min(Skv, q0 + n_q + q_offset));
  const FlashMask mask{kv_valid ? kv_valid + (long)b * Skv : nullptr,
                       q_seg ? q_seg + (long)b * Sq : nullptr,
                       kv_seg ? kv_seg + (long)b * Skv : nullptr,
                       q0, q_offset, causal != 0};
  const long q_base = ((long)b * Sq + q0) * q_rs + (long)h * D;
  const long kv_base = (long)b * Skv * kv_rs + (long)hk * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_rows<D>(Qs, q + q_base, q_rs, n_q, tid);
  load_rows<D>(dOs, dout + q_base, q_rs, n_q, tid);
  load_row_stats(lse_s, delta_s, lse, delta, ((long)b * Hq + h) * Sq + q0, n_q, tid);
  mask.load_queries(n_q, tid, info);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  float* Sw = Ss + warp * 16 * BN;
  float* dPw = dPs + warp * 16 * BN;
  bf16* dSw = dSs + warp * 16 * BN;
  const bf16* Qw = Qs + warp * 16 * D;
  const bf16* dOw = dOs + warp * 16 * D;

  for (int k0 = 0; k0 < n_kv; k0 += BN) {
    const int nk = min(BN, n_kv - k0);
    __syncthreads();  // the previous tile's K, V and key codes are consumed
    load_rows<D>(Ks, k + kv_base + k0 * kv_rs, kv_rs, nk, tid);
    load_rows<D>(Vs, v + kv_base + k0 * kv_rs, kv_rs, nk, tid);
    mask.load_keys(k0, nk, tid, info);
    __syncthreads();

    // S_w = Q_w K^T and dP_w = dO_w V^T (K, V row-major = K^T, V^T col-major)
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc, p_acc;
      wmma::fill_fragment(s_acc, 0.f);
      wmma::fill_fragment(p_acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
        wmma::load_matrix_sync(a, Qw + kk * 16, D);
        wmma::load_matrix_sync(bm, Ks + n * 16 * D + kk * 16, D);
        wmma::mma_sync(s_acc, a, bm, s_acc);
        wmma::load_matrix_sync(a, dOw + kk * 16, D);
        wmma::load_matrix_sync(bm, Vs + n * 16 * D + kk * 16, D);
        wmma::mma_sync(p_acc, a, bm, p_acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, s_acc, BN, wmma::mem_row_major);
      wmma::store_matrix_sync(dPw + n * 16, p_acc, BN, wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int qi = warp * 16 + r;
      const float row_lse = lse_s[qi], row_delta = delta_s[qi];
      for (int c = lane; c < BN; c += 32) {
        float ds = 0.f;
        if (qi < n_q && c < nk && mask.visible(qi, c, k0 + c, info)) {
          const float p = __expf(Sw[r * BN + c] * scale - row_lse);
          ds = p * (dPw[r * BN + c] - row_delta) * scale;
        }
        dSw[r * BN + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ_w += dS_w K
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, dSw + kk * 16, BN);
        wmma::load_matrix_sync(bm, Ks + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc[n], a, bm, acc[n]);
      }
    }
  }

  // Write dq through a 16x16 f32 staging tile in the warp's score rows.
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(Sw, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int qi = warp * 16 + i / 16;
      if (qi < n_q) dq[q_base + qi * q_rs + n * 16 + i % 16] = __float2bfloat16(Sw[i]);
    }
    __syncwarp();
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     const uint8_t* __restrict__ kv_valid,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                     float scale) {
  using namespace nvcuda;
  using L = DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::d_o);
  float* STs = reinterpret_cast<float*>(smem + L::s);
  float* dPTs = reinterpret_cast<float*>(smem + L::dp);
  bf16* PTs = reinterpret_cast<bf16*>(smem + L::p);
  bf16* dSTs = reinterpret_cast<bf16*>(smem + L::ds);
  float* dKs = reinterpret_cast<float*>(smem + L::dk);
  float* dVs = reinterpret_cast<float*>(smem + L::dv);
  float* lse_s = reinterpret_cast<float*>(smem + L::rows);
  float* delta_s = lse_s + BM;
  int* info = reinterpret_cast<int*>(smem + L::info);

  const int k0 = blockIdx.x * BN, hk = blockIdx.y, b = blockIdx.z;
  const int nk = min(BN, Skv - k0);
  const int group = Hq / Hkv;
  const long q_rs = (long)Hq * D, kv_rs = (long)Hkv * D;
  const long kv_base = ((long)b * Skv + k0) * kv_rs + (long)hk * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  FlashMask mask{kv_valid ? kv_valid + (long)b * Skv : nullptr,
                 q_seg ? q_seg + (long)b * Sq : nullptr,
                 kv_seg ? kv_seg + (long)b * Skv : nullptr,
                 0, q_offset, causal != 0};

  load_rows<D>(Ks, k + kv_base, kv_rs, nk, tid);
  load_rows<D>(Vs, v + kv_base, kv_rs, nk, tid);
  mask.load_keys(k0, nk, tid, info);
  for (int i = tid; i < BN * D; i += NTHREADS) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  // Under the causal mask, q row i sees key j iff j <= i + q_offset: the
  // first q tile with a row that sees key k0 is (k0 - q_offset) / BM.
  const int t_begin = causal ? max(0, k0 - q_offset) / BM : 0;
  const int n_tiles = (Sq + BM - 1) / BM;
  const bf16* Kw = Ks + warp * 16 * D;
  const bf16* Vw = Vs + warp * 16 * D;
  float* STw = STs + warp * 16 * BM;
  float* dPTw = dPTs + warp * 16 * BM;
  bf16* PTw = PTs + warp * 16 * BM;
  bf16* dSTw = dSTs + warp * 16 * BM;
  float* dKw = dKs + warp * 16 * D;
  float* dVw = dVs + warp * 16 * D;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int t = t_begin; t < n_tiles; ++t) {
      const int q0 = t * BM;
      const int n_q = min(BM, Sq - q0);
      const long q_base = ((long)b * Sq + q0) * q_rs + (long)h * D;
      __syncthreads();  // the previous tile's Q, dO, stats and codes are consumed
      load_rows<D>(Qs, q + q_base, q_rs, n_q, tid);
      load_rows<D>(dOs, dout + q_base, q_rs, n_q, tid);
      load_row_stats(lse_s, delta_s, lse, delta, ((long)b * Hq + h) * Sq + q0, n_q,
                     tid);
      mask.q0 = q0;
      mask.load_queries(n_q, tid, info);
      __syncthreads();

      // S^T_w = K_w Q^T and dP^T_w = V_w dO^T (Q, dO row-major = col-major T)
#pragma unroll
      for (int n = 0; n < BM / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc, p_acc;
        wmma::fill_fragment(s_acc, 0.f);
        wmma::fill_fragment(p_acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(a, Kw + kk * 16, D);
          wmma::load_matrix_sync(bm, Qs + n * 16 * D + kk * 16, D);
          wmma::mma_sync(s_acc, a, bm, s_acc);
          wmma::load_matrix_sync(a, Vw + kk * 16, D);
          wmma::load_matrix_sync(bm, dOs + n * 16 * D + kk * 16, D);
          wmma::mma_sync(p_acc, a, bm, p_acc);
        }
        wmma::store_matrix_sync(STw + n * 16, s_acc, BM, wmma::mem_row_major);
        wmma::store_matrix_sync(dPTw + n * 16, p_acc, BM, wmma::mem_row_major);
      }
      __syncwarp();

      for (int r = 0; r < 16; ++r) {
        const int kj = warp * 16 + r;
        for (int c = lane; c < BM; c += 32) {
          float p = 0.f, ds = 0.f;
          if (kj < nk && c < n_q && mask.visible(c, kj, k0 + kj, info)) {
            p = __expf(STw[r * BM + c] * scale - lse_s[c]);
            ds = p * (dPTw[r * BM + c] - delta_s[c]) * scale;
          }
          PTw[r * BM + c] = __float2bfloat16(p);
          dSTw[r * BM + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();

      // dV_w += P^T_w dO and dK_w += dS^T_w Q, accumulated in shared memory
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> v_acc, k_acc;
        wmma::load_matrix_sync(v_acc, dVw + n * 16, D, wmma::mem_row_major);
        wmma::load_matrix_sync(k_acc, dKw + n * 16, D, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, PTw + kk * 16, BM);
          wmma::load_matrix_sync(bm, dOs + kk * 16 * D + n * 16, D);
          wmma::mma_sync(v_acc, a, bm, v_acc);
          wmma::load_matrix_sync(a, dSTw + kk * 16, BM);
          wmma::load_matrix_sync(bm, Qs + kk * 16 * D + n * 16, D);
          wmma::mma_sync(k_acc, a, bm, k_acc);
        }
        wmma::store_matrix_sync(dVw + n * 16, v_acc, D, wmma::mem_row_major);
        wmma::store_matrix_sync(dKw + n * 16, k_acc, D, wmma::mem_row_major);
      }
      __syncwarp();
    }
  }
  __syncwarp();

  for (int r = 0; r < 16; ++r) {
    const int kj = warp * 16 + r;
    if (kj >= nk) break;
    for (int c = lane; c < D; c += 32) {
      dk[kv_base + kj * kv_rs + c] = __float2bfloat16(dKw[r * D + c]);
      dv[kv_base + kj * kv_rs + c] = __float2bfloat16(dVw[r * D + c]);
    }
  }
}

template <int D>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              void* dq, void* dk, void* dv, const void* kv_valid,
                              const void* q_seg, const void* kv_seg, int B, int Sq,
                              int Skv, int Hq, int Hkv, int causal, int q_offset,
                              float scale, cudaStream_t stream) {
  if (dq != nullptr) {
    const int smem = (int)DqSmem<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BM - 1) / BM, Hq, B);
    flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dq, (const uint8_t*)kv_valid,
        (const int*)q_seg, (const int*)kv_seg, Sq, Skv, Hq, Hkv, causal, q_offset,
        scale);
  } else {
    const int smem = (int)DkvSmem<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Skv + BN - 1) / BN, Hkv, B);
    flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
        (const uint8_t*)kv_valid, (const int*)q_seg, (const int*)kv_seg, Sq, Skv,
        Hq, Hkv, causal, q_offset, scale);
  }
  return cudaGetLastError();
}

}  // namespace spacer

extern "C" int spacer_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, const void* kv_valid, const void* q_seg,
    const void* kv_seg, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
    int q_offset, float scale, void* stream) {
  if (D != 128 || dq == nullptr) return (int)cudaErrorInvalidValue;
  return spacer::launch_bwd<128>(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                                 kv_valid, q_seg, kv_seg, B, Sq, Skv, Hq, Hkv, causal,
                                 q_offset, scale, (cudaStream_t)stream);
}

extern "C" int spacer_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, const void* kv_valid, const void* q_seg,
    const void* kv_seg, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
    int q_offset, float scale, void* stream) {
  if (D != 128 || dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return spacer::launch_bwd<128>(q, k, v, dout, lse, delta, nullptr, dk, dv,
                                 kv_valid, q_seg, kv_seg, B, Sq, Skv, Hq, Hkv, causal,
                                 q_offset, scale, (cudaStream_t)stream);
}

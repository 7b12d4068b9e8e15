// K5: ragged (clock-ring) decode attention for continuous-batching serving.
//
// Replaces spacer_tpu/ops/flash_decode.py::flash_ragged_decode_attention
// (_ragged_kernel), bf16 branch.  Per slot row r and kv head h: the group_q
// query heads that share kv head h attend over the row's prompt prefix
// pk/pv (R, Hkv, Pmax, D) and then its completion ring tk/tv
// (R, Hkv, Cmax, D), each window masked by an additive f32 bias
// (R, 1, T): 0 live, -1e30 dead.  Output (R, Hkv, group_q, D) f32.
//
// Design: one CTA (4 warps) per (kv head, slot row) holds all group_q query
// heads, so each K/V byte is read from device memory once for the whole GQA
// group; decode is bound by those bytes (one token per row, ~2 flops per
// byte).  Keys stream in chunks of 64 with an online softmax:
//   scores: warp w takes keys w, w+4, ...; lanes split the head dim and a
//           warp reduction finishes each of the group_q dots;
//   softmax: warp w updates rows w, w+4, ...; p is rounded to bf16 for P.V
//           as in the TPU kernel;
//   P.V:    thread t owns output column t for every query head.
// Rows whose windows are all dead (empty or finished slots) keep finite
// values: the running max starts at -1e30 and the denominator is clamped at
// 1e-30, as in the TPU kernel.
// The TPU kernel batched RB rows per program to amortise grid-step overhead;
// that does not apply here.  R * Hkv CTAs (32 at 8 slots) under-fill the 132
// SMs: splitting the key range across CTAs (split-K with a second reduction
// pass) is the next step.
//
// K5-int8 (replaces the same kernel's `quant=True` branch): pk/pv/tk/tv
// are int8 codes (half the bytes of the bound) with per-key f32 scales
// (R, Hkv, 1, T).  Codes widen to f32 exactly as they are read; the K scale
// multiplies the logit after sm_scale and before the bias, the V scale
// multiplies p (before its bf16 rounding) for the P.V product only, while
// the denominator sums the unscaled p, as the TPU kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace spacer {

using bf16 = __nv_bfloat16;

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_CHUNK = 64;
constexpr int GQ_MAX = 8;
constexpr float DEC_MASK_VALUE = -1e30f;

__device__ __forceinline__ float dec_warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float dec_warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dec_load(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float dec_load(const int8_t* p) { return (float)*p; }

// KVT = bf16: K5; KVT = int8_t: K5-int8 with the four scale arrays.
template <int D, class KVT>
__global__ void __launch_bounds__(DEC_THREADS)
ragged_decode_kernel(const bf16* __restrict__ q, const KVT* __restrict__ pk,
                     const KVT* __restrict__ pv, const float* __restrict__ bias_p,
                     const KVT* __restrict__ tk, const KVT* __restrict__ tv,
                     const float* __restrict__ bias_t, const float* __restrict__ pks,
                     const float* __restrict__ pvs, const float* __restrict__ tks,
                     const float* __restrict__ tvs, float* __restrict__ out,
                     int Hkv, int gq, int P, int C, float scale) {
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  constexpr int CPT = (D + DEC_THREADS - 1) / DEC_THREADS;  // columns per thread
  __shared__ float q_s[GQ_MAX][D];
  __shared__ float s_s[GQ_MAX][DEC_CHUNK];
  __shared__ float m_s[GQ_MAX], l_s[GQ_MAX], a_s[GQ_MAX];

  const int h = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long rh = (long)r * Hkv + h;

  for (int i = tid; i < gq * D; i += DEC_THREADS)
    q_s[i / D][i % D] = __bfloat162float(q[rh * gq * D + i]);
  if (tid < GQ_MAX) {
    m_s[tid] = DEC_MASK_VALUE;
    l_s[tid] = 0.f;
  }
  float acc[GQ_MAX][CPT];
#pragma unroll
  for (int g = 0; g < GQ_MAX; ++g)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[g][c] = 0.f;
  __syncthreads();

  for (int win = 0; win < 2; ++win) {
    const int T = win ? C : P;
    const KVT* K = (win ? tk : pk) + rh * T * D;
    const KVT* V = (win ? tv : pv) + rh * T * D;
    const float* bias = (win ? bias_t : bias_p) + (long)r * T;
    const float* KS = kQuant ? (win ? tks : pks) + rh * T : nullptr;
    const float* VS = kQuant ? (win ? tvs : pvs) + rh * T : nullptr;
    for (int c0 = 0; c0 < T; c0 += DEC_CHUNK) {
      const int n = min(DEC_CHUNK, T - c0);
      for (int j = warp; j < n; j += DEC_WARPS) {
        const KVT* kr = K + (long)(c0 + j) * D;
        float part[GQ_MAX];
#pragma unroll
        for (int g = 0; g < GQ_MAX; ++g) part[g] = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float kd = dec_load(kr + d);
#pragma unroll
          for (int g = 0; g < GQ_MAX; ++g)
            if (g < gq) part[g] += q_s[g][d] * kd;
        }
        const float bj = bias[c0 + j];
        const float kj = kQuant ? KS[c0 + j] : 1.f;
#pragma unroll
        for (int g = 0; g < GQ_MAX; ++g) {
          if (g < gq) {
            const float dot = dec_warp_sum(part[g]);
            if (lane == 0) {
              float sj = dot * scale;
              if (kQuant) sj *= kj;
              s_s[g][j] = sj + bj;
            }
          }
        }
      }
      __syncthreads();

      for (int g = warp; g < gq; g += DEC_WARPS) {
        const float s0 = lane < n ? s_s[g][lane] : -INFINITY;
        const float s1 = lane + 32 < n ? s_s[g][lane + 32] : -INFINITY;
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, dec_warp_max(fmaxf(s0, s1)));
        const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
        const float sum = dec_warp_sum(p0 + p1);
        // P.V reads the bf16-rounded p (the TPU kernel's p.astype(bf16)),
        // times the V scale for int8 caches; the denominator sums the f32 p
        const float w0 = kQuant && lane < n ? VS[c0 + lane] : 1.f;
        const float w1 = kQuant && lane + 32 < n ? VS[c0 + lane + 32] : 1.f;
        if (lane < n) s_s[g][lane] = __bfloat162float(__float2bfloat16(kQuant ? p0 * w0 : p0));
        if (lane + 32 < n)
          s_s[g][lane + 32] = __bfloat162float(__float2bfloat16(kQuant ? p1 * w1 : p1));
        if (lane == 0) {
          const float alpha = __expf(m_old - m_new);
          a_s[g] = alpha;
          m_s[g] = m_new;
          l_s[g] = l_s[g] * alpha + sum;
        }
      }
      __syncthreads();

#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int d = tid + c * DEC_THREADS;
        if (d < D) {
#pragma unroll
          for (int g = 0; g < GQ_MAX; ++g)
            if (g < gq) acc[g][c] *= a_s[g];
          for (int j = 0; j < n; ++j) {
            const float vd = dec_load(V + (long)(c0 + j) * D + d);
#pragma unroll
            for (int g = 0; g < GQ_MAX; ++g)
              if (g < gq) acc[g][c] += s_s[g][j] * vd;
          }
        }
      }
      __syncthreads();  // s_s and a_s are rewritten by the next chunk
    }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = tid + c * DEC_THREADS;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < GQ_MAX; ++g)
        if (g < gq) out[(rh * gq + g) * D + d] = acc[g][c] / fmaxf(l_s[g], 1e-30f);
    }
  }
}

template <int D, class KVT>
static cudaError_t launch_decode(const void* q, const void* pk, const void* pv,
                                 const void* bias_p, const void* tk, const void* tv,
                                 const void* bias_t, const void* pks, const void* pvs,
                                 const void* tks, const void* tvs, void* out, int R,
                                 int Hkv, int gq, int P, int C, float scale,
                                 cudaStream_t stream) {
  dim3 grid(Hkv, R);
  ragged_decode_kernel<D, KVT><<<grid, DEC_THREADS, 0, stream>>>(
      (const bf16*)q, (const KVT*)pk, (const KVT*)pv, (const float*)bias_p,
      (const KVT*)tk, (const KVT*)tv, (const float*)bias_t, (const float*)pks,
      (const float*)pvs, (const float*)tks, (const float*)tvs, (float*)out, Hkv, gq, P,
      C, scale);
  return cudaGetLastError();
}

}  // namespace spacer

extern "C" int spacer_ragged_decode_attention(
    const void* q, const void* pk, const void* pv, const void* bias_p,
    const void* tk, const void* tv, const void* bias_t, void* out, int R,
    int Hkv, int gq, int P, int C, int D, float scale, void* stream) {
  if (gq < 1 || gq > spacer::GQ_MAX) return (int)cudaErrorInvalidValue;
  if (D != 128) return (int)cudaErrorInvalidValue;  // the LM head dim
  return spacer::launch_decode<128, spacer::bf16>(
      q, pk, pv, bias_p, tk, tv, bias_t, nullptr, nullptr, nullptr, nullptr, out, R, Hkv,
      gq, P, C, scale, (cudaStream_t)stream);
}

extern "C" int spacer_ragged_decode_attention_int8(
    const void* q, const void* pk, const void* pv, const void* bias_p,
    const void* tk, const void* tv, const void* bias_t, const void* pks,
    const void* pvs, const void* tks, const void* tvs, void* out, int R, int Hkv,
    int gq, int P, int C, int D, float scale, void* stream) {
  if (gq < 1 || gq > spacer::GQ_MAX || D != 128 || !pks || !pvs || !tks || !tvs)
    return (int)cudaErrorInvalidValue;
  return spacer::launch_decode<128, int8_t>(q, pk, pv, bias_p, tk, tv, bias_t, pks, pvs,
                                            tks, tvs, out, R, Hkv, gq, P, C, scale,
                                            (cudaStream_t)stream);
}

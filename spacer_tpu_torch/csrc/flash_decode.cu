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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <int D>
__global__ void __launch_bounds__(DEC_THREADS)
ragged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ pk,
                     const bf16* __restrict__ pv, const float* __restrict__ bias_p,
                     const bf16* __restrict__ tk, const bf16* __restrict__ tv,
                     const float* __restrict__ bias_t, float* __restrict__ out,
                     int Hkv, int gq, int P, int C, float scale) {
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
    const bf16* K = (win ? tk : pk) + rh * T * D;
    const bf16* V = (win ? tv : pv) + rh * T * D;
    const float* bias = (win ? bias_t : bias_p) + (long)r * T;
    for (int c0 = 0; c0 < T; c0 += DEC_CHUNK) {
      const int n = min(DEC_CHUNK, T - c0);
      for (int j = warp; j < n; j += DEC_WARPS) {
        const bf16* kr = K + (long)(c0 + j) * D;
        float part[GQ_MAX];
#pragma unroll
        for (int g = 0; g < GQ_MAX; ++g) part[g] = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float kd = __bfloat162float(kr[d]);
#pragma unroll
          for (int g = 0; g < GQ_MAX; ++g)
            if (g < gq) part[g] += q_s[g][d] * kd;
        }
        const float bj = bias[c0 + j];
#pragma unroll
        for (int g = 0; g < GQ_MAX; ++g) {
          if (g < gq) {
            const float dot = dec_warp_sum(part[g]);
            if (lane == 0) s_s[g][j] = dot * scale + bj;
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
        // P.V reads the bf16-rounded p (the TPU kernel's p.astype(bf16));
        // the denominator sums the f32 p
        if (lane < n) s_s[g][lane] = __bfloat162float(__float2bfloat16(p0));
        if (lane + 32 < n) s_s[g][lane + 32] = __bfloat162float(__float2bfloat16(p1));
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
            const float vd = __bfloat162float(V[(long)(c0 + j) * D + d]);
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

template <int D>
static cudaError_t launch_decode(const void* q, const void* pk, const void* pv,
                                 const void* bias_p, const void* tk, const void* tv,
                                 const void* bias_t, void* out, int R, int Hkv,
                                 int gq, int P, int C, float scale,
                                 cudaStream_t stream) {
  dim3 grid(Hkv, R);
  ragged_decode_kernel<D><<<grid, DEC_THREADS, 0, stream>>>(
      (const bf16*)q, (const bf16*)pk, (const bf16*)pv, (const float*)bias_p,
      (const bf16*)tk, (const bf16*)tv, (const float*)bias_t, (float*)out, Hkv,
      gq, P, C, scale);
  return cudaGetLastError();
}

}  // namespace spacer

extern "C" int spacer_ragged_decode_attention(
    const void* q, const void* pk, const void* pv, const void* bias_p,
    const void* tk, const void* tv, const void* bias_t, void* out, int R,
    int Hkv, int gq, int P, int C, int D, float scale, void* stream) {
  if (gq < 1 || gq > spacer::GQ_MAX) return (int)cudaErrorInvalidValue;
  if (D != 128) return (int)cudaErrorInvalidValue;  // the LM head dim
  return spacer::launch_decode<128>(q, pk, pv, bias_p, tk, tv, bias_t, out, R, Hkv,
                                    gq, P, C, scale, (cudaStream_t)stream);
}

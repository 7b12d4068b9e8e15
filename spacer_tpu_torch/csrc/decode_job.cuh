// One split-K decode job on the CUDA cores, shared by K5 / K5-int8
// (flash_decode.cu: every job of the serving decode) and K2 / K2-int8
// (flash_decode_grouped.cu: the tail jobs of the grouped rollout decode).
//
// A job is up to gq <= GQ_MAX query rows (one token's q heads of one kv
// head) against JOB = 64 consecutive keys, n of which lie in the cache.  It
// writes the rows' normalised partial output (f32, gq x D) and their LSE;
// decode_combine.cuh folds the jobs of a row.
//   - Liveness: an additive f32 bias per key (0 live, -1e30 dead), or none
//     (every one of the n keys is live).  The job reads its biases first
//     and, if none is live (> -5e29), writes lse = -inf and returns without
//     reading K or V.  Exact wherever the row has a live key: exp(-1e30 - m)
//     is 0 in f32.
//   - Loads: every K and V byte of the job is requested at once, 16 bytes
//     per thread (8 bf16 or 16 int8 codes), a row of K by 16 (8) adjacent
//     threads, and held in registers.
//   - Scores on the CUDA cores (at ~2 flops per byte tensor cores would wait
//     on the same loads): each thread dots its 8 (16) columns with the gq
//     queries (from shared memory), a shuffle tree over the row's threads
//     finishes the dots.  The softmax is exact over the job's 64 keys (its
//     own max): p is rounded to bf16 for P.V as in the TPU kernel, and P.V
//     sums each thread's keys in registers, then the warps' partial sums in
//     shared memory, in a fixed order.
//   - int8 codes (KVT = int8_t) with per-key f32 scales: codes widen to f32
//     exactly as they are read; the K scale multiplies the logit after
//     sm_scale and before the bias, the V scale multiplies p (before its
//     bf16 rounding) for the P.V product only, while the denominator sums
//     the unscaled p, as the TPU kernel does.  A dead job reads no scale.
// The caller's CTA is THREADS threads; it hands the job a JobSmem.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace spacer {
namespace decode_job {

using bf16 = __nv_bfloat16;

constexpr int D = 128;        // the LM head dim
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int JOB = 64;       // keys per job (two per lane in the softmax)
constexpr int GQ_MAX = 8;
constexpr float MASK_VALUE = -1e30f;

struct __align__(16) JobSmem {
  float q[GQ_MAX][D];
  float s[GQ_MAX][JOB];   // scores, then the rounded p
  float bias[JOB], ks[JOB], vs[JOB];
  float m[GQ_MAX], l[GQ_MAX];
  float red[WARPS][GQ_MAX][D];
};

// How the CTA's 16-byte loads cover a job of JOB rows of D values: VEC
// values per load, TPR threads per row, RPP rows per pass, PASSES passes.
// Thread t holds columns [VEC (t % TPR), +VEC) of rows t / TPR + RPP i.
template <class KVT>
struct Tiling {
  static constexpr int VEC = 16 / sizeof(KVT);
  static constexpr int TPR = D / VEC;
  static constexpr int RPP = THREADS / TPR;
  static constexpr int PASSES = JOB / RPP;
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

// 16 loaded bytes -> floats: 8 bf16 (a shift each) or 16 int8 codes.
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)((int32_t)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The job: q (gq x D bf16 rows), K and V (the job's first key row on; n >= 1
// rows may be read), bias (the job's first key's, or nullptr: all n live),
// ks / vs (int8 only: the job's first key's scales), out (gq x D f32) and
// lse (gq f32).  Every thread of the CTA calls it.
template <class KVT>
__device__ __forceinline__ void run(JobSmem& sm, const bf16* __restrict__ q,
                                    const KVT* __restrict__ K, const KVT* __restrict__ V,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ ks,
                                    const float* __restrict__ vs, int n, int gq,
                                    float scale, float* __restrict__ out,
                                    float* __restrict__ lse) {
  using Tl = Tiling<KVT>;
  constexpr int VEC = Tl::VEC, TPR = Tl::TPR, RPP = Tl::RPP, PASSES = Tl::PASSES;
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the job's biases (keys past n: -inf), and the vote
  float b = -INFINITY;
  if (tid < n) b = bias != nullptr ? bias[tid] : 0.f;
  if (tid < JOB) sm.bias[tid] = b;
  if (!__syncthreads_or(b > MASK_VALUE / 2)) {
    if (tid < gq) lse[tid] = -INFINITY;
    return;
  }

  // every K and V byte of the job in flight at once, into registers
  const int c = tid % TPR, jj = tid / TPR;
  uint4 kr[PASSES], vr[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int j = jj + RPP * i;
    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) {
      kr[i] = __ldg(reinterpret_cast<const uint4*>(K + (long)j * D + c * VEC));
      vr[i] = __ldg(reinterpret_cast<const uint4*>(V + (long)j * D + c * VEC));
    }
  }
  for (int i = tid; i < gq * D / 8; i += THREADS) {
    float f[8];
    widen(__ldg(reinterpret_cast<const uint4*>(q) + i), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) (&sm.q[0][0])[8 * i + e] = f[e];
  }
  if (kQuant && tid < JOB) {
    sm.ks[tid] = tid < n ? ks[tid] : 0.f;
    sm.vs[tid] = tid < n ? vs[tid] : 0.f;
  }
  __syncthreads();

  // scores: partial dots over this thread's columns, summed over the row's
  // TPR threads; thread c of the row writes query head c's logit
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    float kf[VEC];
    widen(kr[i], kf);
    float part[GQ_MAX];
#pragma unroll
    for (int g = 0; g < GQ_MAX; ++g) {
      part[g] = 0.f;
      if (g < gq) {
        const float4* qv = reinterpret_cast<const float4*>(&sm.q[g][c * VEC]);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 x = qv[e];
          part[g] += x.x * kf[4 * e] + x.y * kf[4 * e + 1] + x.z * kf[4 * e + 2] +
                     x.w * kf[4 * e + 3];
        }
      }
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GQ_MAX; ++g)
        if (g < gq) part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
    float mine = 0.f;
#pragma unroll
    for (int g = 0; g < GQ_MAX; ++g)
      if (g == c) mine = part[g];
    const int j = jj + RPP * i;
    if (c < gq) {
      float sj = mine * scale;
      if (kQuant) sj *= sm.ks[j];
      sm.s[c][j] = sj + sm.bias[j];
    }
  }
  __syncthreads();

  // softmax over the job's keys, warp w taking query heads w, w + 4
  for (int g = warp; g < gq; g += WARPS) {
    const float s0 = sm.s[g][lane], s1 = sm.s[g][lane + 32];
    const float m = warp_max(fmaxf(s0, s1));   // finite: the job has a live key
    const float p0 = __expf(s0 - m), p1 = __expf(s1 - m);
    const float l = warp_sum(p0 + p1);
    sm.s[g][lane] = round_bf16(kQuant ? p0 * sm.vs[lane] : p0);
    sm.s[g][lane + 32] = round_bf16(kQuant ? p1 * sm.vs[lane + 32] : p1);
    if (lane == 0) {
      sm.m[g] = m;
      sm.l[g] = l;
    }
  }
  __syncthreads();

  // P.V over this thread's keys and columns, then over the warp's rows
  float acc[GQ_MAX][VEC];
#pragma unroll
  for (int g = 0; g < GQ_MAX; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    float vf[VEC];
    widen(vr[i], vf);
    const int j = jj + RPP * i;
#pragma unroll
    for (int g = 0; g < GQ_MAX; ++g) {
      if (g < gq) {
        const float p = sm.s[g][j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int o = TPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GQ_MAX; ++g)
      if (g < gq)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if (lane < TPR) {
#pragma unroll
    for (int g = 0; g < GQ_MAX; ++g)
      if (g < gq)
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(&sm.red[warp][g][c * VEC + e]) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  }
  __syncthreads();

  // the job's normalised partial output and LSE, warps summed in order
  for (int i = tid; i < gq * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float o = sm.red[0][g][d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) o += sm.red[w][g][d];
    out[i] = o / sm.l[g];
  }
  if (tid < gq) lse[tid] = sm.m[tid] + logf(sm.l[tid]);
}

}  // namespace decode_job
}  // namespace spacer

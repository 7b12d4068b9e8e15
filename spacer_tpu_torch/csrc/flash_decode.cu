// K5: ragged (clock-ring) decode attention for continuous-batching serving.
//
// Replaces spacer_tpu/ops/flash_decode.py::flash_ragged_decode_attention
// (_ragged_kernel), bf16 branch.  Per slot row r and kv head h: the group_q
// query heads that share kv head h attend over the row's prompt prefix
// pk/pv (R, Hkv, Pmax, D) and then its completion ring tk/tv
// (R, Hkv, Cmax, D), each window masked by an additive f32 bias
// (R, 1, T): 0 live, -1e30 dead.  Output (R, Hkv, group_q, D) f32.
//
// What bounds it on the H100: bytes.  One query token per row, so each K/V
// byte feeds ~2 flops; at the serving shapes the live keys are 2-8 MB, a
// few microseconds at 3.35 TB/s.  What the card needs is enough loads in
// flight: the first port ran one CTA per (h, r), 16-32 CTAs on 132 SMs,
// each walking ~1100 keys serially with 2-byte loads, at 200x the bound.
//
// Design: split-K in two launches, as K2 (flash_decode_grouped.cu).
//   1. One CTA (4 warps) per job: (key job j, kv head h, slot row r), each
//      job 64 keys lying wholly inside the prefix [0, Pmax) or the ring
//      [0, Cmax).  (Pmax / 64 + Cmax / 64) * Hkv * R CTAs: 576 at 8 slots,
//      Pmax 1024, Cmax 128; 272 at the batcher's 4 slots and Cmax 64.
//      - Dead jobs do no work: the job reads its 64 biases first and, if
//        none is live (> -5e29; the ring's live window may wrap past
//        Cmax - 1, so liveness comes from the bias only), writes lse = -inf
//        and exits without reading K or V.  Exact wherever the row has a
//        live key: exp(-1e30 - m) is 0 in f32.
//      - Loads: every K and V byte of the job is requested at once, 16 bytes
//        per thread (8 bf16 or 16 int8 codes), a row of K by 16 (8) adjacent
//        threads, and held in registers.
//      - Scores on the CUDA cores (at ~2 flops per byte tensor cores would
//        wait on the same loads): each thread dots its 8 (16) columns with
//        the group_q queries (from shared memory), a shuffle tree over the
//        row's threads finishes the dots.  The softmax is exact over the
//        job's 64 keys (its own max): p is rounded to bf16 for P.V as in the
//        TPU kernel, and P.V sums each thread's keys in registers, then the
//        warps' partial sums in shared memory.
//      - The job writes its normalised f32 partial output and its LSE to
//        scratch the wrapper allocates.
//   2. decode_combine.cuh folds the jobs per (query head, r, h) in a fixed
//      order (two calls are bitwise equal).  A row with no live key (an
//      empty slot) writes 0, where the TPU kernel and the plain version give
//      the mean of V over the dead keys; callers discard such rows.
//
// K5-int8 (replaces the same kernel's `quant=True` branch): pk/pv/tk/tv
// are int8 codes (half the bytes of the bound) with per-key f32 scales
// (R, Hkv, 1, T).  Codes widen to f32 exactly as they are read; the K scale
// multiplies the logit after sm_scale and before the bias, the V scale
// multiplies p (before its bf16 rounding) for the P.V product only, while
// the denominator sums the unscaled p, as the TPU kernel does.  A dead job
// reads no scale.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_combine.cuh"

namespace spacer {
namespace k5 {

using bf16 = __nv_bfloat16;

constexpr int D = 128;        // the LM head dim
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int JOB = 64;       // keys per job (two per lane in the softmax)
constexpr int GQ_MAX = 8;
constexpr float MASK_VALUE = -1e30f;

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

// KVT = bf16: K5; KVT = int8_t: K5-int8 with the four scale arrays.
template <class KVT>
__global__ void __launch_bounds__(THREADS)
ragged_decode_split_kernel(const bf16* __restrict__ q, const KVT* __restrict__ pk,
                           const KVT* __restrict__ pv, const float* __restrict__ bias_p,
                           const KVT* __restrict__ tk, const KVT* __restrict__ tv,
                           const float* __restrict__ bias_t, const float* __restrict__ pks,
                           const float* __restrict__ pvs, const float* __restrict__ tks,
                           const float* __restrict__ tvs, float* __restrict__ part_o,
                           float* __restrict__ part_lse, int Hkv, int gq, int P, int C,
                           int nsp, float scale) {
  using Tl = Tiling<KVT>;
  constexpr int VEC = Tl::VEC, TPR = Tl::TPR, RPP = Tl::RPP, PASSES = Tl::PASSES;
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  __shared__ __align__(16) float q_s[GQ_MAX][D];
  __shared__ float s_s[GQ_MAX][JOB];   // scores, then the rounded p
  __shared__ float bias_s[JOB], ks_s[JOB], vs_s[JOB];
  __shared__ float m_s[GQ_MAX], l_s[GQ_MAX];
  __shared__ __align__(16) float red_s[WARPS][GQ_MAX][D];

  const int job = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int NS = nsp + (C + JOB - 1) / JOB;
  const bool ring = job >= nsp;
  const int T = ring ? C : P;
  const int k0 = (ring ? job - nsp : job) * JOB;
  const int n = min(JOB, T - k0);
  const long rh = (long)r * Hkv + h;
  const long slot = (rh * NS + job) * gq;   // this job's rows of part_o / part_lse
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the job's biases (keys past the window: -inf), and the vote
  float b = -INFINITY;
  if (tid < n) b = (ring ? bias_t : bias_p)[(long)r * T + k0 + tid];
  if (tid < JOB) bias_s[tid] = b;
  if (!__syncthreads_or(b > MASK_VALUE / 2)) {
    if (tid < gq) part_lse[slot + tid] = -INFINITY;
    return;
  }

  // every K and V byte of the job in flight at once, into registers
  const long key0 = rh * T + k0;
  const KVT* K = (ring ? tk : pk) + key0 * D;
  const KVT* V = (ring ? tv : pv) + key0 * D;
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
    widen(__ldg(reinterpret_cast<const uint4*>(q + rh * gq * D) + i), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) (&q_s[0][0])[8 * i + e] = f[e];
  }
  if (kQuant && tid < JOB) {
    const long s0 = key0 + tid;
    ks_s[tid] = tid < n ? (ring ? tks : pks)[s0] : 0.f;
    vs_s[tid] = tid < n ? (ring ? tvs : pvs)[s0] : 0.f;
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
        const float4* qv = reinterpret_cast<const float4*>(&q_s[g][c * VEC]);
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
      if (kQuant) sj *= ks_s[j];
      s_s[c][j] = sj + bias_s[j];
    }
  }
  __syncthreads();

  // softmax over the job's keys, warp w taking query heads w, w + 4
  for (int g = warp; g < gq; g += WARPS) {
    const float s0 = s_s[g][lane], s1 = s_s[g][lane + 32];
    const float m = warp_max(fmaxf(s0, s1));   // finite: the job has a live key
    const float p0 = __expf(s0 - m), p1 = __expf(s1 - m);
    const float l = warp_sum(p0 + p1);
    s_s[g][lane] = round_bf16(kQuant ? p0 * vs_s[lane] : p0);
    s_s[g][lane + 32] = round_bf16(kQuant ? p1 * vs_s[lane + 32] : p1);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
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
        const float p = s_s[g][j];
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
          *reinterpret_cast<float4*>(&red_s[warp][g][c * VEC + e]) =
              make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  }
  __syncthreads();

  // the job's normalised partial output and LSE, warps summed in order
  for (int i = tid; i < gq * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float o = red_s[0][g][d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) o += red_s[w][g][d];
    part_o[slot * D + i] = o / l_s[g];
  }
  if (tid < gq) part_lse[slot + tid] = m_s[tid] + logf(l_s[tid]);
}

// scratch: the jobs' partial outputs (R, Hkv, jobs, gq, D), then their LSEs
// (R, Hkv, jobs, gq), f32.
template <class KVT>
static cudaError_t launch(const void* q, const void* pk, const void* pv, const void* bias_p,
                          const void* tk, const void* tv, const void* bias_t,
                          const void* pks, const void* pvs, const void* tks, const void* tvs,
                          void* scratch, void* out, int R, int Hkv, int gq, int P, int C,
                          float scale, cudaStream_t stream) {
  const int nsp = (P + JOB - 1) / JOB, nst = (C + JOB - 1) / JOB;
  float* part_o = (float*)scratch;
  float* part_lse = part_o + (long)R * Hkv * (nsp + nst) * gq * D;
  dim3 grid(nsp + nst, Hkv, R);
  ragged_decode_split_kernel<KVT><<<grid, THREADS, 0, stream>>>(
      (const bf16*)q, (const KVT*)pk, (const KVT*)pv, (const float*)bias_p,
      (const KVT*)tk, (const KVT*)tv, (const float*)bias_t, (const float*)pks,
      (const float*)pvs, (const float*)tks, (const float*)tvs, part_o, part_lse, Hkv, gq,
      P, C, nsp, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 cgrid(gq, R * Hkv);
  decode_combine_kernel<<<cgrid, D, 0, stream>>>(part_o, part_lse, (float*)out, nsp + nst,
                                                 gq, D);
  return cudaGetLastError();
}

static bool args_ok(int R, int Hkv, int gq, int P, int C, int D_) {
  return D_ == D && gq >= 1 && gq <= GQ_MAX && R >= 1 && R <= 65535 && Hkv >= 1 &&
         Hkv <= 65535 && P >= 1 && C >= 1;
}

}  // namespace k5
}  // namespace spacer

// Keys per job: the wrapper sizes the scratch by it.
extern "C" int spacer_ragged_decode_job_keys() { return spacer::k5::JOB; }

// scratch: R * Hkv * jobs * gq * (D + 1) floats, jobs = ceil(P / JOB) +
// ceil(C / JOB).
extern "C" int spacer_ragged_decode_attention(
    const void* q, const void* pk, const void* pv, const void* bias_p,
    const void* tk, const void* tv, const void* bias_t, void* scratch, void* out, int R,
    int Hkv, int gq, int P, int C, int D, float scale, void* stream) {
  if (!spacer::k5::args_ok(R, Hkv, gq, P, C, D)) return (int)cudaErrorInvalidValue;
  return spacer::k5::launch<spacer::k5::bf16>(
      q, pk, pv, bias_p, tk, tv, bias_t, nullptr, nullptr, nullptr, nullptr, scratch, out,
      R, Hkv, gq, P, C, scale, (cudaStream_t)stream);
}

extern "C" int spacer_ragged_decode_attention_int8(
    const void* q, const void* pk, const void* pv, const void* bias_p,
    const void* tk, const void* tv, const void* bias_t, const void* pks,
    const void* pvs, const void* tks, const void* tvs, void* scratch, void* out, int R,
    int Hkv, int gq, int P, int C, int D, float scale, void* stream) {
  if (!spacer::k5::args_ok(R, Hkv, gq, P, C, D) || !pks || !pvs || !tks || !tvs)
    return (int)cudaErrorInvalidValue;
  return spacer::k5::launch<int8_t>(q, pk, pv, bias_p, tk, tv, bias_t, pks, pvs, tks, tvs,
                                    scratch, out, R, Hkv, gq, P, C, scale,
                                    (cudaStream_t)stream);
}

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
//      Pmax 1024, Cmax 128; 272 at the batcher's 4 slots and Cmax 64.  The
//      job itself is decode_job.cuh's (shared with K2's tail jobs): a vote
//      on the job's biases (the ring's live window may wrap past Cmax - 1,
//      so liveness comes from the bias only; a dead job reads no K or V),
//      16-byte loads into registers, dots and an exact softmax over the
//      job on the CUDA cores, its normalised f32 partial output and LSE
//      written to scratch the wrapper allocates.
//   2. decode_combine.cuh folds the jobs per (query head, r, h) in a fixed
//      order (two calls are bitwise equal).  A row with no live key (an
//      empty slot) writes 0, where the TPU kernel and the plain version give
//      the mean of V over the dead keys; callers discard such rows.
//
// K5-int8 (replaces the same kernel's `quant=True` branch): pk/pv/tk/tv
// are int8 codes (half the bytes of the bound) with per-key f32 scales
// (R, Hkv, 1, T), applied as decode_job.cuh sets out.
#include "decode_combine.cuh"
#include "decode_job.cuh"

namespace spacer {
namespace k5 {

using bf16 = __nv_bfloat16;
using decode_job::D;
using decode_job::GQ_MAX;
using decode_job::JOB;
using decode_job::THREADS;

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
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  __shared__ decode_job::JobSmem sm;
  const int job = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int NS = nsp + (C + JOB - 1) / JOB;
  const bool ring = job >= nsp;
  const int T = ring ? C : P;
  const int k0 = (ring ? job - nsp : job) * JOB;
  const long rh = (long)r * Hkv + h;
  const long slot = (rh * NS + job) * gq;   // this job's rows of part_o / part_lse
  const long key0 = rh * T + k0;
  decode_job::run<KVT>(sm, q + rh * gq * D, (ring ? tk : pk) + key0 * D,
                       (ring ? tv : pv) + key0 * D,
                       (ring ? bias_t : bias_p) + (long)r * T + k0,
                       kQuant ? (ring ? tks : pks) + key0 : nullptr,
                       kQuant ? (ring ? tvs : pvs) + key0 : nullptr, min(JOB, T - k0), gq,
                       scale, part_o + slot * D, part_lse + slot);
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

// Keys per job of K5 and of K2: the wrappers size their scratch by it.
extern "C" int spacer_decode_job_keys() { return spacer::decode_job::JOB; }

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

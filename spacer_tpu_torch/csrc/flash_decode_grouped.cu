// K2: shared-prefix grouped decode attention for the rollout sampler.
//
// Replaces spacer_tpu/ops/flash_decode.py::flash_decode_attention (`_kernel`),
// bf16 branch.  One decode step of the grouped rollout: for prompt b and kv
// head h, the GQ = G * group_q query rows (row g * group_q + c is q head
// h * group_q + c of completion row b * G + g) attend over
//   - the prompt prefix pk/pv (B, Hkv, P, D), shared by the G completions,
//     masked by an additive f32 bias (B, 1, P): 0 live, -1e30 padding;
//   - then each completion row's own tail tk/tv (N = B * G, Hkv, T, D), of
//     which only the first `step` positions are live.
// Output (B, Hkv, GQ, D) f32, the softmax taken over [prefix | live tail].
// Any G * group_q (group_q <= 8, the tail jobs' limit); D = 128.
//
// What bounds it on the H100: bytes (one query token per completion row).
// The prefix, the dominant read at P >> step, is read once per 64 query
// rows: at the rollout's G = 8, group_q = 7 once per group.  At B = 2,
// Hkv = 4, P = 1536 padded by 467 the live prefix is 4.4 MB, 1.3 us at
// 3.35 TB/s; the tails add 4.2 KB per key row and step.  The first port (one
// WMMA `attend` per job, loads staged synchronously through shared memory,
// 7 live rows of 64 in a tail job's tile) took 0.066 ms at every step.
//
// Design: split-K in two launches, one CTA of one warpgroup per job.
//   1. Prefix jobs (b, 64-row tile of the GQ query rows, chunk of JOB = 64
//      prefix keys), h from the grid's y:
//      - the job reads its 64 biases first; a chunk whose keys are all
//        padding writes lse = -inf for its rows and exits before any load
//        (left padding of 467 of 1536 kills 7 of 24 chunks);
//      - one thread issues the TMA boxes (sm90.cuh encode_bhsd: D = 128 as
//        two 128-byte-swizzled 64-column boxes, as K1's tiles): Q and K on
//        one mbarrier, V on another, so S = Q K^T starts before V arrives;
//        rows past GQ and keys past P read as zeros;
//      - S = Q K^T on wgmma (m64n64k16, 8 k-steps, both operands K-major in
//        shared memory); each thread adds the bias of its 16 key columns in
//        log2 units with the scale in one FFMA (keys past P weigh exactly
//        0); the softmax is exact over the chunk (row max and sum over the
//        quad, ex2 on the SFU), so nothing is rescaled; O = P V on wgmma
//        (m64n128k16, P as bf16 A fragments from the S registers, V
//        MN-major); the normalised partial O and its LSE go to scratch.
//   2. Tail jobs (completion row n, h, chunk of 64 live tail keys): the
//      group_q rows of row n against its own tail, only the ceil(step / 64)
//      live chunks, the last one stopping at `step`, so dead tail space is
//      never read (the TPU kernel's idx_tail clamp and pl.when skip).  A
//      tail job is K5's job (decode_job.cuh: 16-byte loads into registers,
//      dots and an exact softmax on the CUDA cores): its 7 rows would fill
//      11 % of a wgmma tile, and its 64 keys are read once either way.
//   3. A combine pass per (row, b, h) (decode_combine.cuh, shared with K5):
//      out = sum_s exp(lse_s - M) o_s / sum_s exp(lse_s - M), M = max_s lse_s,
//      in a fixed order (two calls are bitwise equal).  Every row has a live
//      tail key (step >= 1), so no row is empty.
// The TPU kernel walked prefix then tail chunks as the sequential grid axis
// of one program per kv head; on the H100 that would leave B * Hkv CTAs (8
// at the rollout shapes) on 132 SMs, so the key range is split across CTAs
// and the sum across CTAs is the second pass.
//
// K2-int8 (replaces the same kernel's `quant=True` branch): int8 codes for
// pk/pv (B, Hkv, P, D) and tk/tv, per-key f32 scales (B, Hkv, 1, P) and
// (N, Hkv, 1, T).  The same jobs and combine pass.  A prefix job's codes
// come in by TMA as int8 (half the bytes) and are widened to bf16 in a
// swizzled tile (exact: |code| <= 127) before the products; the K scale
// multiplies S after sm_scale and before the bias (one FFMA with a
// per-column multiplier); the V scale multiplies p before p is rounded to
// bf16 for P V, while the denominator sums the unscaled p, as the TPU
// kernel does.  Tail jobs apply the scales as decode_job.cuh sets out.
#include "decode_combine.cuh"
#include "decode_job.cuh"
#include "sm90.cuh"

namespace spacer {
namespace k2 {

using decode_job::D;
using decode_job::GQ_MAX;
using decode_job::JOB;
constexpr int NTHREADS = decode_job::THREADS;   // one warpgroup
constexpr int BQ = 64;                          // query rows of a prefix job's tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// A prefix job's shared memory: bf16 tiles of 64 rows x 128 (two [64][64]
// blocks with the 128-byte swizzle, sm90.cuh), the int8 codes as TMA lands
// them ([64][128] bytes, unswizzled; int8 only), two mbarriers.
template <bool kQuant>
struct PrefixSmem {
  static constexpr int tile = BQ * D * 2;
  static constexpr int raw_tile = JOB * D;
  static constexpr int q = 0, k = tile, v = 2 * tile;
  static constexpr int raw = 3 * tile;
  static constexpr int bars = raw + (kQuant ? 2 * raw_tile : 0);
  static constexpr int bytes = bars + 2 * 8;
};

// int8 codes [64][128] (row-major) -> the bf16 tile wgmma reads (exact).
__device__ __forceinline__ void widen_tile(const int8_t* raw, unsigned char* tile) {
  for (int i = threadIdx.x; i < JOB * D / 16; i += NTHREADS) {
    const int r = i / 8, c = i % 8;   // row, 16-column chunk
    const uint4 u = *reinterpret_cast<const uint4*>(raw + r * D + c * 16);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    uint32_t p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int lo = (int32_t)(w[e / 2] << (24 - 16 * (e % 2))) >> 24;
      const int hi = (int32_t)(w[e / 2] << (16 - 16 * (e % 2))) >> 24;
      p[e] = sm90::pack_bf16((float)lo, (float)hi);
    }
    // columns 16 c .. 16 c + 15: block c / 4, 16-byte chunks 2 (c % 4), +1
    unsigned char* row = tile + (c / 4) * (JOB * 128) + r * 128;
    const int j0 = 2 * (c % 4);
    *reinterpret_cast<uint4*>(row + ((j0 ^ (r & 7)) << 4)) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(row + (((j0 + 1) ^ (r & 7)) << 4)) =
        make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// One prefix job (see the header note).  bias, ks, vs: the chunk's first
// key's; out / lse: the tile's first row of this job's slot; rows: the
// tile's rows that exist (< GQ).
template <bool kQuant>
__device__ __forceinline__ void prefix_job(unsigned char* smem, const CUtensorMap* tq,
                                           const CUtensorMap* tk, const CUtensorMap* tv,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ vs, int n, int q0,
                                           int rows, int h, int b, int c0, float scale_log2,
                                           float* __restrict__ out, float* __restrict__ lse) {
  using namespace sm90;
  using S = PrefixSmem<kQuant>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const float bv = tid < n ? bias[tid] : -INFINITY;
  if (!__syncthreads_or(bv > decode_job::MASK_VALUE / 2)) {
    for (int i = tid; i < rows; i += NTHREADS) lse[i] = -INFINITY;
    return;
  }

  unsigned char* Qs = smem + S::q;
  unsigned char* Ks = smem + S::k;
  unsigned char* Vs = smem + S::v;
  int8_t* Kraw = reinterpret_cast<int8_t*>(smem + S::raw);
  int8_t* Vraw = Kraw + S::raw_tile;
  uint64_t* qk_bar = reinterpret_cast<uint64_t*>(smem + S::bars);
  uint64_t* v_bar = qk_bar + 1;
  if (tid == 0) {
    mbar_init(qk_bar, 1);
    mbar_init(v_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    constexpr int kv_bytes = kQuant ? S::raw_tile : S::tile;
    mbar_arrive_expect_tx(qk_bar, S::tile + kv_bytes);
    tma_load_bhsd_rows<BQ>(Qs, tq, qk_bar, q0, h, b);
    if (kQuant)
      tma_load_4d(Kraw, tk, qk_bar, 0, c0, h, b);
    else
      tma_load_bhsd_rows<JOB>(Ks, tk, qk_bar, c0, h, b);
    mbar_arrive_expect_tx(v_bar, kv_bytes);
    if (kQuant)
      tma_load_4d(Vraw, tv, v_bar, 0, c0, h, b);
    else
      tma_load_bhsd_rows<JOB>(Vs, tv, v_bar, c0, h, b);
  }

  // this thread's key columns 8 n8 + 2 (lane % 4) + c: the bias in log2
  // units (keys past n weigh exactly 0) and, for int8 codes, the logit's
  // multiplier with the K scale and the V scale
  constexpr int NC = JOB / 4;
  float add[NC], mul[NC], vsc[NC];
#pragma unroll
  for (int n8 = 0; n8 < JOB / 8; ++n8)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * n8 + 2 * (lane % 4) + c, i = 2 * n8 + c;
      const bool live = col < n;
      add[i] = live ? bias[col] * LOG2E : -INFINITY;
      mul[i] = kQuant ? (live ? scale_log2 * ks[col] : 0.f) : scale_log2;
      vsc[i] = kQuant && live ? vs[col] : 1.f;
    }

  // S = Q K^T (s starts undefined: the first step ignores it)
  mbar_wait(qk_bar, 0);
  if (kQuant) {
    widen_tile(Kraw, Ks);
    fence_async_shared();
    __syncthreads();
  }
  float s[JOB / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(s, desc_kmajor<BQ>(Qs, 0, kk), desc_kmajor<JOB>(Ks, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // exact softmax over the chunk in log2 units, row max and sum over the
  // quad; the chunk has a live key, so every row's max is finite
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int idx = 0; idx < JOB / 2; ++idx) {
    const int i = 2 * (idx / 4) + idx % 2;
    s[idx] = fmaf(s[idx], mul[i], add[i]);
    m[(idx / 2) % 2] = fmaxf(m[(idx / 2) % 2], s[idx]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 1));
    m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 2));
  }
#pragma unroll
  for (int idx = 0; idx < JOB / 2; ++idx) {
    const float p = exp2_approx(s[idx] - m[(idx / 2) % 2]);
    l[(idx / 2) % 2] += p;
    s[idx] = kQuant ? p * vsc[2 * (idx / 4) + idx % 2] : p;
  }

  // O = P V, P rounded to bf16 in registers
  uint32_t pa[JOB / 16][4];
#pragma unroll
  for (int kb = 0; kb < JOB / 16; ++kb) frag_from_acc(pa[kb], s, kb);
  mbar_wait(v_bar, 0);
  if (kQuant) {
    widen_tile(Vraw, Vs);
    fence_async_shared();
    __syncthreads();
  }
  float o[D / 2];
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < JOB / 16; ++kb)
    wgmma_m64n128k16_rs(o, pa[kb], desc_mnmajor<JOB>(Vs, kb), kb > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  // the row sums over the quad, normalise, write the tile's rows
  const int r_lo = warp * 16 + lane / 4;   // rows r_lo, r_lo + 8
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float lj = l[j];
    lj += __shfl_xor_sync(0xffffffffu, lj, 1);
    lj += __shfl_xor_sync(0xffffffffu, lj, 2);
    const int row = r_lo + 8 * j;
    if (row >= rows) continue;
    const float inv = 1.f / lj;
    float* orow = out + (long)row * D + (lane % 4) * 2;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<float2*>(orow + n8 * 8) =
          make_float2(o[4 * n8 + 2 * j] * inv, o[4 * n8 + 2 * j + 1] * inv);
    if (lane % 4 == 0) lse[row] = m[j] * LN2 + logf(lj);
  }
}

// KVT = bf16: K2; KVT = int8_t: K2-int8 with the four scale arrays.  Jobs
// [0, B * nqt * nsp) are prefix jobs, the rest tail jobs; h = blockIdx.y.
template <class KVT>
__global__ void __launch_bounds__(NTHREADS)
grouped_decode_split_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tpk,
                            const __grid_constant__ CUtensorMap tpv,
                            const bf16* __restrict__ q, const float* __restrict__ bias_p,
                            const KVT* __restrict__ tk, const KVT* __restrict__ tv,
                            const float* __restrict__ pks, const float* __restrict__ pvs,
                            const float* __restrict__ tks, const float* __restrict__ tvs,
                            float* __restrict__ part_o, float* __restrict__ part_lse, int B,
                            int Hkv, int G, int gq, int P, int T, int step, int nqt,
                            int nsp, int nst, float scale) {
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int GQ = G * gq, NS = nsp + nst;
  const int job = blockIdx.x, h = blockIdx.y;
  if (job < B * nqt * nsp) {
    const int b = job / (nqt * nsp), r = job % (nqt * nsp);
    const int q0 = (r / nsp) * BQ, s = r % nsp, c0 = s * JOB;
    const long bh = (long)b * Hkv + h;
    const long slot = (bh * NS + s) * GQ + q0;
    const long key0 = bh * P + c0;
    prefix_job<kQuant>(smem, &tq, &tpk, &tpv, bias_p + (long)b * P + c0,
                       kQuant ? pks + key0 : nullptr, kQuant ? pvs + key0 : nullptr,
                       min(JOB, P - c0), q0, min(BQ, GQ - q0), h, b, c0, scale * LOG2E,
                       part_o + slot * D, part_lse + slot);
  } else {
    const int j = job - B * nqt * nsp;
    const int row = j / nst, t = j % nst;
    const int b = row / G, g = row % G;
    const int k0 = t * JOB;
    const long bh = (long)b * Hkv + h;
    const long key0 = ((long)row * Hkv + h) * T + k0;
    const long slot = (bh * NS + nsp + t) * GQ + (long)g * gq;
    decode_job::run<KVT>(*reinterpret_cast<decode_job::JobSmem*>(smem),
                         q + (bh * GQ + (long)g * gq) * D, tk + key0 * D, tv + key0 * D,
                         nullptr, kQuant ? tks + key0 : nullptr,
                         kQuant ? tvs + key0 : nullptr, min(JOB, step - k0), gq, scale,
                         part_o + slot * D, part_lse + slot);
  }
}

template <class KVT>
static cudaError_t launch(const void* q, const void* pk, const void* pv, const void* bias_p,
                          const void* tk, const void* tv, const void* pks, const void* pvs,
                          const void* tks, const void* tvs, void* part_o, void* part_lse,
                          void* out, int B, int Hkv, int G, int gq, int P, int T, int step,
                          float scale, cudaStream_t stream) {
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  const int GQ = G * gq;
  const int nqt = (GQ + BQ - 1) / BQ, nsp = (P + JOB - 1) / JOB, nst = (step + JOB - 1) / JOB;
  CUtensorMap tq, tpk, tpv;
  cudaError_t err = sm90::encode_bhsd(&tq, q, B, Hkv, GQ, BQ, false);
  if (err == cudaSuccess) err = sm90::encode_bhsd(&tpk, pk, B, Hkv, P, JOB, kQuant);
  if (err == cudaSuccess) err = sm90::encode_bhsd(&tpv, pv, B, Hkv, P, JOB, kQuant);
  if (err != cudaSuccess) return err;
  constexpr int prefix_bytes = PrefixSmem<kQuant>::bytes;
  constexpr int job_bytes = (int)sizeof(decode_job::JobSmem);
  const int smem = (prefix_bytes > job_bytes ? prefix_bytes : job_bytes) + 1024;
  err = cudaFuncSetAttribute(grouped_decode_split_kernel<KVT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * nqt * nsp + B * G * nst, Hkv);
  grouped_decode_split_kernel<KVT><<<grid, NTHREADS, smem, stream>>>(
      tq, tpk, tpv, (const bf16*)q, (const float*)bias_p, (const KVT*)tk, (const KVT*)tv,
      (const float*)pks, (const float*)pvs, (const float*)tks, (const float*)tvs,
      (float*)part_o, (float*)part_lse, B, Hkv, G, gq, P, T, step, nqt, nsp, nst, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 cgrid(GQ, B * Hkv);
  decode_combine_kernel<<<cgrid, D, 0, stream>>>(
      (const float*)part_o, (const float*)part_lse, (float*)out, nsp + nst, GQ, D);
  return cudaGetLastError();
}

static bool args_ok(int B, int Hkv, int G, int gq, int P, int T, int step, int D_) {
  return D_ == D && B >= 1 && Hkv >= 1 && Hkv <= 65535 && G >= 1 && gq >= 1 &&
         gq <= GQ_MAX && step >= 1 && step <= T && P >= 1;
}

}  // namespace k2
}  // namespace spacer

// part_o: B * Hkv * jobs * G * gq * D floats, part_lse: B * Hkv * jobs * G *
// gq, jobs = ceil(P / 64) + ceil(step / 64) (spacer_decode_job_keys).
extern "C" int spacer_grouped_decode_attention(
    const void* q, const void* pk, const void* pv, const void* bias_p, const void* tk,
    const void* tv, void* part_o, void* part_lse, void* out, int B, int Hkv, int G,
    int gq, int P, int T, int step, int D, float scale, void* stream) {
  if (!spacer::k2::args_ok(B, Hkv, G, gq, P, T, step, D)) return (int)cudaErrorInvalidValue;
  return spacer::k2::launch<spacer::bf16>(q, pk, pv, bias_p, tk, tv, nullptr, nullptr,
                                          nullptr, nullptr, part_o, part_lse, out, B, Hkv,
                                          G, gq, P, T, step, scale, (cudaStream_t)stream);
}

extern "C" int spacer_grouped_decode_attention_int8(
    const void* q, const void* pk, const void* pv, const void* bias_p, const void* tk,
    const void* tv, const void* pks, const void* pvs, const void* tks, const void* tvs,
    void* part_o, void* part_lse, void* out, int B, int Hkv, int G, int gq, int P, int T,
    int step, int D, float scale, void* stream) {
  if (!spacer::k2::args_ok(B, Hkv, G, gq, P, T, step, D) || !pks || !pvs || !tks || !tvs)
    return (int)cudaErrorInvalidValue;
  return spacer::k2::launch<int8_t>(q, pk, pv, bias_p, tk, tv, pks, pvs, tks, tvs, part_o,
                                    part_lse, out, B, Hkv, G, gq, P, T, step, scale,
                                    (cudaStream_t)stream);
}

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
//
// Design: split-K in two launches.
//   1. One CTA per job, each job an online-softmax pass of attention_tile.cuh
//      (WMMA tiles of 64 query rows x 64 keys) writing a normalised partial
//      output (f32) and its LSE into scratch:
//      - prefix jobs (b, h, chunk of `pchunk` prefix keys): all GQ rows of
//        the group in one tile, so every prefix K/V tile is read ONCE for
//        the whole group of G completions, the point of the TPU kernel;
//      - tail jobs (completion row n, h, chunk of `tchunk` tail keys): the
//        group_q rows of row n against its own tail.  Only the
//        ceil(step / tchunk) live chunks get jobs, and the last one stops at
//        `step`: dead tail space is never read (the TPU kernel's idx_tail
//        clamp and pl.when skip).
//   2. A combine pass per (row, b, h) (decode_combine.cuh, shared with K5):
//      out = sum_s exp(lse_s - M) o_s / sum_s exp(lse_s - M), M = max_s lse_s.
// The TPU kernel walked prefix then tail chunks as the sequential grid axis
// of one program per kv head; on the H100 that would leave B * Hkv CTAs (8
// at the rollout shapes) on 132 SMs, so the key range is split across CTAs
// instead and the sum across CTAs is the second pass.
// Padding stays finite: masked prefix keys score -1e30 (never -inf), the
// running max starts at -1e30, and every row has >= 1 live tail key.
//
// What bounds it on the H100: bytes (one query token per completion row).
// The prefix, the dominant read at P >> step, is read once per group.
//
// K2-int8 (replaces the same kernel's `quant=True` branch): int8 codes for
// pk/pv (B, Hkv, P, D) and tk/tv, per-key f32 scales (B, Hkv, 1, P) and
// (N, Hkv, 1, T).  The same jobs and combine pass; each K/V tile moves half
// the bytes and is widened to bf16 in shared memory (attention_tile.cuh,
// KVT = int8_t).  The K scale multiplies the logit after sm_scale and
// before the bias; the V scale multiplies p for the P.V product only, as the
// TPU kernel folds it into the probabilities (the code x scale product is
// never formed, so V is not dequantised to bf16).
#include "attention_tile.cuh"
#include "decode_combine.cuh"

namespace spacer {

// Prefix keys: additive bias per key, staged in the tile's key info.
struct BiasMask {
  const float* bias;  // bias of this job's first key
  __device__ void load_queries(int, int, int*) const {}
  __device__ void load_keys(int k0, int nk, int tid, int* info) const {
    for (int i = tid; i < BN; i += NTHREADS)
      info[BM + i] = __float_as_int(i < nk ? bias[k0 + i] : 0.f);
  }
  __device__ float apply(float s, int, int kj, int, const int* info) const {
    return s + __int_as_float(info[BM + kj]);
  }
};

// Tail keys: every key handed to the job is live.
struct LiveKeys {
  __device__ void load_queries(int, int, int*) const {}
  __device__ void load_keys(int, int, int, int*) const {}
  __device__ float apply(float s, int, int, int, const int*) const { return s; }
};

// int8 caches: per-key K and V scales staged after the key info (the tile's
// EXTRA_INFO words), and for prefix keys the additive bias as above.
constexpr int KS_INFO = BM + BN, VS_INFO = BM + 2 * BN;

template <bool kBias>
struct ScaledKeys {
  const float* bias;  // bias of this job's first key (prefix jobs only)
  const float* ks;    // K and V scales of this job's first key
  const float* vs;
  __device__ void load_queries(int, int, int*) const {}
  __device__ void load_keys(int k0, int nk, int tid, int* info) const {
    for (int i = tid; i < BN; i += NTHREADS) {
      const bool in = i < nk;
      if (kBias) info[BM + i] = __float_as_int(in ? bias[k0 + i] : 0.f);
      info[KS_INFO + i] = __float_as_int(in ? ks[k0 + i] : 0.f);
      info[VS_INFO + i] = __float_as_int(in ? vs[k0 + i] : 0.f);
    }
  }
  __device__ float apply(float s, int, int kj, int, const int* info) const {
    s *= __int_as_float(info[KS_INFO + kj]);
    return kBias ? s + __int_as_float(info[BM + kj]) : s;
  }
  __device__ float v_scale(int kj, const int* info) const {
    return __int_as_float(info[VS_INFO + kj]);
  }
};

// KVT = bf16: K2; KVT = int8_t: K2-int8 with the four scale arrays.
template <int D, class KVT>
__global__ void __launch_bounds__(NTHREADS)
grouped_decode_split_kernel(const bf16* __restrict__ q, const KVT* __restrict__ pk,
                            const KVT* __restrict__ pv,
                            const float* __restrict__ bias_p,
                            const KVT* __restrict__ tk, const KVT* __restrict__ tv,
                            const float* __restrict__ pks, const float* __restrict__ pvs,
                            const float* __restrict__ tks, const float* __restrict__ tvs,
                            float* __restrict__ part_o, float* __restrict__ part_lse,
                            int B, int Hkv, int G, int gq, int P, int T, int step,
                            int pchunk, int tchunk, int nsp, int nst, float scale) {
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  const int GQ = G * gq, NS = nsp + nst;
  const int job = blockIdx.x, h = blockIdx.y;
  if (job < B * nsp) {
    const int b = job / nsp, s = job % nsp;
    const int c0 = s * pchunk, n = min(pchunk, P - c0);
    const long bh = (long)b * Hkv + h;
    float* o = part_o + (bh * NS + s) * GQ * D;
    float* lse = part_lse + (bh * NS + s) * GQ;
    const float* bias = bias_p + (long)b * P + c0;
    if constexpr (kQuant) {
      const ScaledKeys<true> mask{bias, pks + bh * P + c0, pvs + bh * P + c0};
      attend<D>(q + bh * GQ * D, D, GQ, pk + (bh * P + c0) * D, pv + (bh * P + c0) * D, D,
                n, scale, mask, o, D, lse);
    } else {
      attend<D>(q + bh * GQ * D, D, GQ, pk + (bh * P + c0) * D, pv + (bh * P + c0) * D, D,
                n, scale, BiasMask{bias}, o, D, lse);
    }
  } else {
    const int j = job - B * nsp;
    const int row = j / nst, t = j % nst;
    const int b = row / G, g = row % G;
    const int c0 = t * tchunk, n = min(tchunk, step - c0);
    const long bh = (long)b * Hkv + h;
    const long key0 = ((long)row * Hkv + h) * T + c0;
    const long slot = (bh * NS + nsp + t) * GQ + (long)g * gq;
    const bf16* qr = q + (bh * GQ + (long)g * gq) * D;
    if constexpr (kQuant) {
      const ScaledKeys<false> mask{nullptr, tks + key0, tvs + key0};
      attend<D>(qr, D, gq, tk + key0 * D, tv + key0 * D, D, n, scale, mask,
                part_o + slot * D, D, part_lse + slot);
    } else {
      attend<D>(qr, D, gq, tk + key0 * D, tv + key0 * D, D, n, scale, LiveKeys{},
                part_o + slot * D, D, part_lse + slot);
    }
  }
}

template <int D, class KVT>
static cudaError_t launch_grouped(const void* q, const void* pk, const void* pv,
                                  const void* bias_p, const void* tk, const void* tv,
                                  const void* pks, const void* pvs, const void* tks,
                                  const void* tvs, void* part_o, void* part_lse, void* out,
                                  int B, int Hkv, int G, int gq, int P, int T, int step,
                                  int pchunk, int tchunk, float scale,
                                  cudaStream_t stream) {
  constexpr bool kQuant = !std::is_same<KVT, bf16>::value;
  const int smem = (int)TileSmem<D, kQuant ? 2 * BN : 0>::bytes;
  cudaError_t err = cudaFuncSetAttribute(grouped_decode_split_kernel<D, KVT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const int nsp = (P + pchunk - 1) / pchunk, nst = (step + tchunk - 1) / tchunk;
  dim3 grid(B * nsp + B * G * nst, Hkv);
  grouped_decode_split_kernel<D, KVT><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const KVT*)pk, (const KVT*)pv, (const float*)bias_p,
      (const KVT*)tk, (const KVT*)tv, (const float*)pks, (const float*)pvs,
      (const float*)tks, (const float*)tvs, (float*)part_o, (float*)part_lse, B, Hkv,
      G, gq, P, T, step, pchunk, tchunk, nsp, nst, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 cgrid(G * gq, B * Hkv);
  decode_combine_kernel<<<cgrid, D, 0, stream>>>(
      (const float*)part_o, (const float*)part_lse, (float*)out, nsp + nst, G * gq, D);
  return cudaGetLastError();
}

}  // namespace spacer

static bool grouped_args_ok(int B, int G, int gq, int P, int T, int step, int D,
                            int pchunk, int tchunk) {
  return D == 128 && B >= 1 && G * gq >= 1 && G * gq <= spacer::BM && step >= 1 &&
         step <= T && P >= 1 && pchunk >= 1 && tchunk >= 1;
}

extern "C" int spacer_grouped_decode_attention(
    const void* q, const void* pk, const void* pv, const void* bias_p, const void* tk,
    const void* tv, void* part_o, void* part_lse, void* out, int B, int Hkv, int G,
    int gq, int P, int T, int step, int D, int pchunk, int tchunk, float scale,
    void* stream) {
  if (!grouped_args_ok(B, G, gq, P, T, step, D, pchunk, tchunk))
    return (int)cudaErrorInvalidValue;
  return spacer::launch_grouped<128, spacer::bf16>(
      q, pk, pv, bias_p, tk, tv, nullptr, nullptr, nullptr, nullptr, part_o, part_lse, out,
      B, Hkv, G, gq, P, T, step, pchunk, tchunk, scale, (cudaStream_t)stream);
}

extern "C" int spacer_grouped_decode_attention_int8(
    const void* q, const void* pk, const void* pv, const void* bias_p, const void* tk,
    const void* tv, const void* pks, const void* pvs, const void* tks, const void* tvs,
    void* part_o, void* part_lse, void* out, int B, int Hkv, int G, int gq, int P, int T,
    int step, int D, int pchunk, int tchunk, float scale, void* stream) {
  if (!grouped_args_ok(B, G, gq, P, T, step, D, pchunk, tchunk) || !pks || !pvs || !tks ||
      !tvs)
    return (int)cudaErrorInvalidValue;
  return spacer::launch_grouped<128, int8_t>(
      q, pk, pv, bias_p, tk, tv, pks, pvs, tks, tvs, part_o, part_lse, out, B, Hkv, G, gq,
      P, T, step, pchunk, tchunk, scale, (cudaStream_t)stream);
}

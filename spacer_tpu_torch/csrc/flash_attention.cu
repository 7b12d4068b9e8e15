// K1: flash attention forward for the LM prefill, on Hopper's wgmma and TMA.
//
// Replaces the Pallas kernel spacer_tpu/ops/flash_attention.py
// (flash_attention -> _flash_fwd_impl -> _fwd_kernel).  Same contract as the
// plain version spacer_tpu_torch/nn/attention.py::xla_attention: q (B,Sq,Hq,D),
// k/v (B,Skv,Hkv,D) bf16 in the JAX layout, D = 128 (the LMs), 80 (the Qwen
// ViTs' full-attention blocks under ring attention, 1280 / 16 heads) or 72
// (the Aria vision tower and its projector, 1152 / 16 heads), causal with a static
// q_offset (key j is visible to query i when j <= i + q_offset), a (B,Skv)
// validity mask and optional (B,S) segment ids, GQA (q head h reads kv head
// h / (Hq/Hkv)).  Writes out (B,Sq,Hq,D) bf16 and the LSE (B,Hq,Sq) f32 that
// a backward pass needs.  The validity mask folds into per-key codes as the
// TPU wrapper folds it into segment ids (0 = masked key, segment + 1
// otherwise); a key is visible to a query iff the codes are equal and the
// causal rule holds.  Masked scores take -1e30, so a row whose keys are all
// masked stays finite; given `v_mean` ((B, Hkv, D) f32, the mean of V over
// every key, which the wrapper computes), such a row writes it, the plain
// version's value, whichever key tiles it walked (without, the mean of V
// over the keys it walks, or 0 where the key-tile skip below leaves it
// none).  P is rounded to bf16 before P.V, as the TPU kernel does.
//
// What bounds it on the H100: tensor-core operations.  At the serving
// prefill (P = 1024, D = 128) a key tile of 64 is reused by 128 query rows
// and all 7 q heads of its group hit it in L2: ~P/2 flops per byte of K/V.
//
// Layout: one CTA per (128-row q tile, q head, batch row), 3 warpgroups.
//   - warpgroup 2, one warp: the producer.  It TMA-loads the Q tile once and
//     streams K and V tiles of 64 keys through a ring of 3 stages (full /
//     empty mbarriers); beside each tile it writes the tile's 64 key codes.
//     setmaxnreg gives its registers to the consumers (24 vs 240).
//   - warpgroups 0 and 1: 64 query rows each.  Per key tile:
//       S = Q K^T        wgmma m64n64k16, both operands in shared memory
//                        (a K tile stored [key][d] is K-major for B);
//       mask, online softmax in registers (a thread holds parts of 2 rows;
//                        row max over the quad with two shfl_xor; the
//                        per-element mask only on tiles that need it: the
//                        causal diagonal, the ragged end, or any tile when a
//                        kv_mask or segment ids are given);
//       O += P V         wgmma m64n128k16, P as bf16 A fragments straight
//                        from the S accumulator registers, V stored
//                        [key][d] as an MN-major B (transpose bit).
//     O (64 f32 per thread) stays in registers; the epilogue normalises and
//     writes out and lse from them.
//   - Key tiles whose keys are all masked by kv_mask (left padding, the dead
//     tail of a completion) are skipped by producer and consumers alike.
//   - The grid's slowest dimension is the q tile, reversed: the longest
//     causal walks start first.
//
// D = 80 and 72: the same kernel on sm90.cuh's D = 80 tile (a [R][64] block
// with the 128-byte swizzle and a [R][16] block with the 32-byte swizzle,
// K4's layout); Q K^T runs five k-steps, P V an n64 and an n16 product.
// At D = 72 the tensor maps declare the head 72 wide, so TMA fills columns
// 72-79 of the second box with zeros: Q K^T runs its five k-steps over
// zeros there (the products are unchanged), P V runs as an n64 and an n16
// product whose columns 72-79 are 0 and are never stored.  The scale is
// 72^-0.5 from the wrapper.  wgmma's k-step of 16 is why the tile is 80
// wide: 72 is no multiple of it.
// sm90.cuh holds the TMA / mbarrier / wgmma building blocks and the
// shared-memory layout the descriptors read.
#include "sm90.cuh"

namespace spacer {
namespace k1fwd {

constexpr int BM = 128;       // query rows per CTA (2 consumer warpgroups)
constexpr int BN = 64;        // keys per tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 384;
constexpr int MAX_TILES = 512;   // key tiles with a liveness flag; later ones count as live
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASK2 = -1e30f * LOG2E;   // the -1e30 mask in log2 units

template <int D>
struct Smem {
  static constexpr int DP = sm90::head_tile_width(D);
  static constexpr int q = 0;                                 // bf16 [BM][DP]
  static constexpr int kv = q + BM * DP * 2;                  // [STAGES] x (K, V)
  static constexpr int tile = BN * DP * 2;                    // one K or V tile
  static constexpr int codes = kv + STAGES * 2 * tile;        // int [STAGES][BN]
  static constexpr int live = codes + STAGES * BN * 4;        // int [MAX_TILES]
  static constexpr int bars = live + MAX_TILES * 4;           // full, empty, q
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8;
  static constexpr int alloc = bytes + 1024;                  // base alignment
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tq16,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tk16,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tv16, bf16* __restrict__ out,
                 float* __restrict__ lse, const uint8_t* __restrict__ kv_valid,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 const float* __restrict__ v_mean, int Sq, int Skv, int Hq,
                 int Hkv, int causal, int q_offset, float scale_log2) {
  using namespace sm90;
  using SmemD = Smem<D>;
  constexpr int DP = SmemD::DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(smem + SmemD::q);
  int* codes = reinterpret_cast<int*>(smem + SmemD::codes);
  int* live = reinterpret_cast<int*>(smem + SmemD::live);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SmemD::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int n_q = min(BM, Sq - q0);
  const int hk = h / (Hq / Hkv);
  int n_kv = Skv;
  if (causal) n_kv = max(0, min(Skv, q0 + n_q + q_offset));
  const int n_kt = (n_kv + BN - 1) / BN;

  // A key tile whose walked keys all have kv_valid == 0 is skipped: every
  // row sees none of them, so for a row with any visible key they weigh
  // exactly 0 (2^(-1e30 - m) = 0); a row that sees no key at all comes out
  // finite either way (0 if every tile is skipped), and v_mean where given.
  const bool skip_dead = kv_valid != nullptr;
  if (skip_dead) {
    for (int t = threadIdx.x; t < min(n_kt, MAX_TILES); t += NTHREADS) live[t] = 0;
    __syncthreads();
    for (int kg = threadIdx.x; kg < min(n_kv, MAX_TILES * BN); kg += NTHREADS)
      if (kv_valid[(long)b * Skv + kg] != 0) live[kg / BN] = 1;
  }
  auto tile_live = [&](int i) { return !skip_dead || i >= MAX_TILES || live[i] != 0; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);     // the producer warp's lanes (+ TMA bytes)
      mbar_init(&empty[s], 256);   // every consumer thread
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    regs_dealloc<24>();
    if (threadIdx.x >= 256 + 32) return;   // one producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, BM * DP * 2);
      tma_load_head_rows<D, BM>(Qs, &tq, &tq16, qbar, h, q0, b);
    }
    RingPos pos;
    for (int i = 0; i < n_kt; ++i) {
      if (!tile_live(i)) continue;
      mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
      const int k0 = i * BN;
      for (int j = lane; j < BN; j += 32) {
        const int kg = k0 + j;
        int code = 0;
        if (kg < Skv) {
          code = kv_seg != nullptr ? kv_seg[(long)b * Skv + kg] + 1 : 1;
          if (kv_valid != nullptr && kv_valid[(long)b * Skv + kg] == 0) code = 0;
        }
        codes[pos.stage * BN + j] = code;
      }
      if (lane == 0) {
        unsigned char* st = smem + SmemD::kv + pos.stage * 2 * SmemD::tile;
        mbar_arrive_expect_tx(&full[pos.stage], 2 * SmemD::tile);
        tma_load_head_rows<D, BN>(st, &tk, &tk16, &full[pos.stage], hk, k0, b);
        tma_load_head_rows<D, BN>(st + SmemD::tile, &tv, &tv16, &full[pos.stage], hk,
                                  k0, b);
      } else {
        mbar_arrive(&full[pos.stage]);
      }
      pos.advance<STAGES>();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  regs_alloc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r_lo = 64 * wg + warp * 16 + lane / 4;   // rows r_lo, r_lo + 8
  const bool has_codes = kv_valid != nullptr || q_seg != nullptr;
  int qcode[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r_lo + 8 * j;
    qcode[j] = (q_seg != nullptr && row < Sq) ? q_seg[(long)b * Sq + row] + 1 : 1;
  }
  const int wg_first_row = q0 + 64 * wg;

  // O: columns 0-127 (D = 128), or 0-63 and 64-79 (D = 80 and 72)
  constexpr int NO = D == 128 ? 64 : 32;
  float o[NO], o16[8];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o16[i] = 0.f;
  float m[2] = {MASK2, MASK2}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  RingPos pos;
  for (int i = 0; i < n_kt; ++i) {
    if (!tile_live(i)) continue;
    mbar_wait(&full[pos.stage], pos.phase);
    const unsigned char* Ks = smem + SmemD::kv + pos.stage * 2 * SmemD::tile;
    const unsigned char* Vs = Ks + SmemD::tile;
    const int* kcode = codes + pos.stage * BN;
    const int k0 = i * BN;

    // S = Q K^T (s starts undefined: the first step ignores it, and its
    // registers are not kept live from the previous tile)
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss(s, desc_kmajor_head<D, BM>(Qs, 64 * wg, kk),
                         desc_kmajor_head<D, BN>(Ks, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale (log2 units) and mask
    const bool masked = has_codes || k0 + BN > Skv ||
                        (causal && k0 + BN - 1 > wg_first_row + q_offset);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      float x = s[idx] * scale_log2;
      if (masked) {
        const int j = (idx / 2) % 2;
        const int col = (idx / 4) * 8 + (lane % 4) * 2 + idx % 2;
        bool vis = kcode[col] == qcode[j];
        if (causal) vis = vis && (k0 + col <= q0 + r_lo + 8 * j + q_offset);
        x = vis ? x : MASK2;
      }
      s[idx] = x;
    }

    // online softmax: row max over the quad, rescale, p = 2^(s - m)
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = m[j];
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8)
        mx = fmaxf(mx, fmaxf(s[4 * n8 + 2 * j], s[4 * n8 + 2 * j + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[j] = exp2f(m[j] - mx);
      m[j] = mx;
    }
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int j = (idx / 2) % 2;
      s[idx] = exp2f(s[idx] - m[j]);
      rsum[j] += s[idx];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rsum[j];
#pragma unroll
    for (int idx = 0; idx < NO; ++idx) o[idx] *= alpha[(idx / 2) % 2];
    if constexpr (D != 128) {
#pragma unroll
      for (int idx = 0; idx < 8; ++idx) o16[idx] *= alpha[(idx / 2) % 2];
    }

    // O += P V, P rounded to bf16 in registers
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) frag_from_acc(pa[kb], s, kb);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      if constexpr (D == 128) {
        wgmma_m64n128k16_rs(o, pa[kb], desc_mnmajor<BN>(Vs, kb), 1);
      } else {
        wgmma_m64n64k16_rs(o, pa[kb], desc_mnmajor<BN>(Vs, kb), 1);
        wgmma_m64n16k16_rs(o16, pa[kb], desc_mnmajor_d80_hi<BN>(Vs, kb), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (D != 128) fence_regs(o16);
    mbar_arrive(&empty[pos.stage]);
    pos.advance<STAGES>();
  }

  // epilogue: the row sums over the quad, normalise, write out and lse
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float lj = l[j];
    lj += __shfl_xor_sync(0xffffffffu, lj, 1);
    lj += __shfl_xor_sync(0xffffffffu, lj, 2);
    const float l_safe = lj == 0.f ? 1.f : lj;
    const float inv = 1.f / l_safe;
    const int row = q0 + r_lo + 8 * j;
    if (row >= Sq) continue;
    bf16* orow = out + (((long)b * Sq + row) * Hq + h) * D + (lane % 4) * 2;
    // a row that saw no visible key (m still the mask value): V's mean
    const float* mrow = v_mean != nullptr && m[j] == MASK2
                            ? v_mean + ((long)b * Hkv + hk) * D + (lane % 4) * 2
                            : nullptr;
#pragma unroll
    for (int n8 = 0; n8 < NO / 4; ++n8)
      *reinterpret_cast<uint32_t*>(orow + n8 * 8) =
          mrow ? pack_bf16(mrow[n8 * 8], mrow[n8 * 8 + 1])
               : pack_bf16(o[4 * n8 + 2 * j] * inv, o[4 * n8 + 2 * j + 1] * inv);
    if constexpr (D != 128)   // columns 64-71
      *reinterpret_cast<uint32_t*>(orow + 64) =
          mrow ? pack_bf16(mrow[64], mrow[65])
               : pack_bf16(o16[2 * j] * inv, o16[2 * j + 1] * inv);
    if constexpr (D == 80)    // columns 72-79 (at D = 72 the tile's zeros)
      *reinterpret_cast<uint32_t*>(orow + 72) =
          mrow ? pack_bf16(mrow[72], mrow[73])
               : pack_bf16(o16[4 + 2 * j] * inv, o16[4 + 2 * j + 1] * inv);
    if (lane % 4 == 0) lse[((long)b * Hq + h) * Sq + row] = m[j] * LN2 + logf(l_safe);
  }
}

template <int D>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                          void* lse, const void* kv_valid, const void* q_seg,
                          const void* kv_seg, const void* v_mean, int B, int Sq,
                          int Skv, int Hq, int Hkv, int causal, int q_offset,
                          float scale, cudaStream_t stream) {
  // D = 128: 64-column boxes only (the 16-column maps are unused copies);
  // D = 80 and 72: columns 0-63 and 64-79 (at 72, columns 72-79 are past the
  // head: zeros)
  CUtensorMap tq, tk, tv, tq16, tk16, tv16;
  cudaError_t err = sm90::encode_bshd(&tq, q, B, Sq, Hq, D, BM);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tk, k, B, Skv, Hkv, D, BN);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tv, v, B, Skv, Hkv, D, BN);
  tq16 = tq, tk16 = tk, tv16 = tv;
  if (D != 128) {
    if (err == cudaSuccess) err = sm90::encode_bshd(&tq16, q, B, Sq, Hq, D, BM, 16);
    if (err == cudaSuccess) err = sm90::encode_bshd(&tk16, k, B, Skv, Hkv, D, BN, 16);
    if (err == cudaSuccess) err = sm90::encode_bshd(&tv16, v, B, Skv, Hkv, D, BN, 16);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::alloc);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + BM - 1) / BM);
  flash_fwd_kernel<D><<<grid, NTHREADS, Smem<D>::alloc, stream>>>(
      tq, tq16, tk, tk16, tv, tv16, (bf16*)out, (float*)lse, (const uint8_t*)kv_valid,
      (const int*)q_seg, (const int*)kv_seg, (const float*)v_mean, Sq, Skv, Hq, Hkv,
      causal, q_offset, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace k1fwd
}  // namespace spacer

extern "C" int spacer_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_valid, const void* q_seg, const void* kv_seg,
    const void* v_mean, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int causal, int q_offset, float scale, void* stream) {
  if (Sq <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  if (D == 128)
    return spacer::k1fwd::launch<128>(q, k, v, out, lse, kv_valid, q_seg, kv_seg,
                                      v_mean, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                                      scale, (cudaStream_t)stream);
  if (D == 80)
    return spacer::k1fwd::launch<80>(q, k, v, out, lse, kv_valid, q_seg, kv_seg,
                                     v_mean, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                                     scale, (cudaStream_t)stream);
  if (D == 72)
    return spacer::k1fwd::launch<72>(q, k, v, out, lse, kv_valid, q_seg, kv_seg,
                                     v_mean, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                                     scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* spacer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

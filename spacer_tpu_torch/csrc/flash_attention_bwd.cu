// K1 backward: the two gradient kernels of the LM's flash attention.
//
// Replaces spacer_tpu/ops/flash_attention.py::_flash_bwd, which makes two
// Pallas calls: dq (`_bwd_dq_kernel`) and dk/dv (`_bwd_dkv_kernel`).  Same
// contract as K1's forward (flash_attention.cu): q (B,Sq,Hq,D), k/v
// (B,Skv,Hkv,D) bf16 in the JAX layout, D = 128, causal with a static
// q_offset, a (B,Skv) validity mask and optional (B,S) segment ids folded
// into per-key codes as the forward folds them (0 = masked key, segment + 1
// otherwise; a key is visible to a query iff the codes are equal and the
// causal rule holds), GQA.  Inputs beside q/k/v: dout (B,Sq,Hq,D) bf16, the
// forward's LSE (B,Hq,Sq) f32 and delta = rowsum(dout * out) (B,Hq,Sq) f32.
//
// Both kernels recompute p = exp(s * scale - lse) from the forward's LSE and
// set p = 0 wherever the forward's mask hid the key (as the TPU kernel's
// jnp.where(mask, p, 0) does).  A fully masked query row (a left-padded
// prompt position) therefore contributes exactly 0 to dq, dk and dv: there
// is no exp(0) = 1 weight and no inf - inf, so no NaN can reach a live row
// through 0 * NaN.  ds = p * (dp - delta) * scale, dp = dout . v, rounded to
// bf16 before its products (the TPU's astype).
//
// Both run on Hopper's wgmma and TMA (sm90.cuh has the building blocks):
// a producer warp feeds TMA rings through full / empty mbarriers, two
// consumer warpgroups keep their accumulators in registers.  What bounds
// them on the H100 is tensor-core operations: dq does three products per
// (query, key) pair (6 D flops), dk/dv four (8 D flops).
//
// dq (`_bwd_dq_kernel`): K1 forward's structure with one more product.
//   - one CTA per (128-row q tile, q head, batch row); the grid's slowest
//     dimension is the q tile, reversed: the longest causal walks start
//     first;
//   - warpgroup 2, one warp: the producer.  It TMA-loads the Q and dO tiles
//     once and streams K and V tiles of 64 keys through a ring of 3 stages,
//     writing the tile's 64 key codes beside them;
//   - warpgroups 0 and 1 own 64 q rows each; each thread reads lse (log2
//     units) and delta of its 2 rows once.  Per key tile:
//       S = Q K^T, dP = dO V^T   wgmma m64n64k16, operands K-major in
//                                shared memory;
//       p, ds in registers       p exactly 0 where the key is hidden;
//       dQ += dS K               wgmma m64n128k16, dS as A fragments from
//                                the dP accumulator registers, K (stored
//                                [key][d]) as an MN-major B.
//     dQ (64 f32 per thread) stays in registers for the whole walk, and one
//     CTA owns all of its rows' dq: no partial sums, no atomics, a run is
//     bitwise repeatable.
//   - Key tiles whose keys are all masked by kv_mask (left padding, the dead
//     tail of a completion) are skipped: p = 0 for every pair there.  A q
//     tile whose walk keeps no key tile at all writes zeros and stops (at the
//     update's prompt, B=1 S=1536 padded by 467, q tiles 0-2).
//
// dk/dv (`_bwd_dkv_kernel` plus the TPU wrapper's sum over each GQA group):
//   - one CTA per (128-key tile, kv head, batch row, split): the Hq/Hkv q
//     heads of the group are shared out over `splits` CTAs (the wrapper's
//     rule fills the card: at the update's prompt pass, B=1, S=1536, one
//     CTA per key tile and kv head would be 48 CTAs on 132 SMs).  Each CTA
//     walks its heads x the q tiles that can see its keys.  The grid's
//     slowest dimension is the key tile, ascending: under the causal rule
//     the low key tiles have the longest walks and start first;
//   - warpgroup 2, one warp: the producer.  It TMA-loads the K and V tiles
//     once and streams (Q, dO) tiles of 64 rows through a ring of 2 stages
//     (full / empty mbarriers), writing each tile's lse, delta and query
//     codes beside them;
//   - warpgroups 0 and 1 own 64 keys each.  Per q tile:
//       S^T = K Q^T, dP^T = V dO^T   wgmma m64n64k16, operands in shared
//                                    memory (K-major);
//       p, ds in registers           p = exp(s scale - lse), exactly 0
//                                    where the key is hidden; p and ds
//                                    rounded to bf16 (the TPU's astype);
//       dV += P^T dO, dK += dS^T Q   wgmma m64n128k16, P^T and dS^T as A
//                                    fragments from the S^T / dP^T
//                                    accumulator registers, dO and Q as
//                                    MN-major B (transpose bit).
//     dK and dV (64 + 64 f32 per thread) stay in registers for the walk.
//   - Key tiles whose keys are all masked (every key code 0: left padding,
//     the dead tail of a completion that ended early, keys past Skv) are
//     skipped: dk = dv = 0 exactly, because p = 0 for every pair there by
//     the rule above, which is also what the plain version computes.  The
//     CTA writes the zeros and stops.
//   - Reduction order: with splits = 1 the CTA writes bf16 dk/dv itself.
//     With splits > 1 split s writes its f32 sums to slot s of a scratch
//     buffer and a second kernel adds the slots in order 0, 1, ... before
//     rounding to bf16: no atomics, so a run is bitwise repeatable.
//
// D = 80 and 72: both kernels on sm90.cuh's D = 80 tile (K1 forward's: a
// 64-column block with the 128-byte swizzle and a 16-column block with the
// 32-byte swizzle, each row a 128-byte and a 32-byte TMA box).  S and dP run
// five k-steps of 16; dQ += dS K, dV += P^T dO and dK += dS^T Q run as an n64
// and an n16 product (as K1 forward at 72 and K4 run P V), so dQ, dK and
// dV hold 32 + 8 f32 per thread.  At D = 72 the maps declare the head 72
// wide: TMA fills columns 72-79 with zeros, which leave every product's
// columns 0-71 unchanged, and columns 72-79 of the results are not stored.
#include "sm90.cuh"

namespace spacer {

// The TMA maps of a (B, S, H, D) bf16 head in boxes of `rows` rows: D = 128
// reads `map` alone (`map16` is an unused copy); D = 80 and 72 read 64
// columns from `map` and 16 from `map16` (at 72, columns 72-79 as zeros).
template <int D>
static cudaError_t encode_maps(CUtensorMap* map, CUtensorMap* map16, const void* base,
                               int B, int S, int H, int rows) {
  cudaError_t err = sm90::encode_bshd(map, base, B, S, H, D, rows);
  *map16 = *map;
  if (err == cudaSuccess && D != 128)
    err = sm90::encode_bshd(map16, base, B, S, H, D, rows, 16);
  return err;
}

namespace dq {

constexpr int BM = 128;       // query rows per CTA (2 consumer warpgroups)
constexpr int BN = 64;        // keys per tile
constexpr int STAGES = 3;
constexpr int NTHREADS = 384;
constexpr int MAX_TILES = 512;   // key tiles with a liveness flag; later ones count as live
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int DP = sm90::head_tile_width(D);
  static constexpr int q = 0;                                 // bf16 [BM][DP]
  static constexpr int d_o = q + BM * DP * 2;                 // bf16 [BM][DP]
  static constexpr int kv = d_o + BM * DP * 2;                // [STAGES] x (K, V)
  static constexpr int tile = BN * DP * 2;                    // one K or V tile
  static constexpr int codes = kv + STAGES * 2 * tile;        // int [STAGES][BN]
  static constexpr int live = codes + STAGES * BN * 4;        // int [MAX_TILES]
  static constexpr int bars = live + MAX_TILES * 4;           // full, empty, q
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8;
  static constexpr int alloc = bytes + 1024;                  // base alignment
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tq16,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tk16,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tv16,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdo16,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, const uint8_t* __restrict__ kv_valid,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                    float scale) {
  using namespace sm90;
  using SmemD = Smem<D>;
  constexpr int DP = SmemD::DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem + SmemD::q;
  unsigned char* dOs = smem + SmemD::d_o;
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

  // live[t]: bit 0 = key tile t holds a key with kv_valid != 0, bit 1 = one
  // with kv_valid == 0.  A tile without bit 0 is skipped (p = 0 for every
  // pair there), a CTA that keeps no tile writes zeros and stops, and a tile
  // with bit 0 alone needs no per-key mask.
  const bool skip_dead = kv_valid != nullptr;
  bool any_live = !skip_dead || n_kv > MAX_TILES * BN;
  if (skip_dead) {
    for (int t = threadIdx.x; t < min(n_kt, MAX_TILES); t += NTHREADS) live[t] = 0;
    __syncthreads();
    for (int kg = threadIdx.x; kg < min(n_kv, MAX_TILES * BN); kg += NTHREADS)
      if (kv_valid[(long)b * Skv + kg] != 0) {
        atomicOr(&live[kg / BN], 1);
        any_live = true;
      } else {
        atomicOr(&live[kg / BN], 2);
      }
  }
  if (!__syncthreads_or(any_live)) {
    for (int i = threadIdx.x; i < n_q * (D / 8); i += NTHREADS)
      *reinterpret_cast<uint4*>(dq + (((long)b * Sq + q0 + i / (D / 8)) * Hq + h) * D +
                                8 * (i % (D / 8))) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  auto tile_live = [&](int i) { return !skip_dead || i >= MAX_TILES || (live[i] & 1); };

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
      mbar_arrive_expect_tx(qbar, 2 * BM * DP * 2);
      tma_load_head_rows<D, BM>(Qs, &tq, &tq16, qbar, h, q0, b);
      tma_load_head_rows<D, BM>(dOs, &tdo, &tdo16, qbar, h, q0, b);
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
  const float scale_log2 = scale * LOG2E;
  int qcode[2];
  // lse2 = lse in log2 units less log2(scale), so that the exp2 below gives
  // p * scale; rows past Sq: zero Q and dO rows give ds = 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r_lo + 8 * j;
    const bool in = row < Sq;
    qcode[j] = (q_seg != nullptr && in) ? q_seg[(long)b * Sq + row] + 1 : 1;
    lse2[j] = in ? lse[((long)b * Hq + h) * Sq + row] * LOG2E - log2f(scale) : 0.f;
    dlt[j] = in ? delta[((long)b * Hq + h) * Sq + row] : 0.f;
  }
  const int wg_first_row = q0 + 64 * wg;

  // dQ: columns 0-127 (D = 128), or 0-63 and 64-79 (D = 80 and 72)
  constexpr int NO = D == 128 ? 64 : 32;
  float dQ[NO], dQ16[8];
#pragma unroll
  for (int i = 0; i < NO; ++i) dQ[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) dQ16[i] = 0.f;

  mbar_wait(qbar, 0);
  RingPos pos;
  for (int i = 0; i < n_kt; ++i) {
    if (!tile_live(i)) continue;
    mbar_wait(&full[pos.stage], pos.phase);
    const unsigned char* Ks = smem + SmemD::kv + pos.stage * 2 * SmemD::tile;
    const unsigned char* Vs = Ks + SmemD::tile;
    const int* kcode = codes + pos.stage * BN;
    const int k0 = i * BN;

    // S = Q K^T and dP = dO V^T (both start undefined: the first step of
    // each ignores them)
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss(s, desc_kmajor_head<D, BM>(Qs, 64 * wg, kk),
                         desc_kmajor_head<D, BN>(Ks, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss(dp, desc_kmajor_head<D, BM>(dOs, 64 * wg, kk),
                         desc_kmajor_head<D, BN>(Vs, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p = exp(s scale - lse) where the key is visible, else exactly 0;
    // ds = p (dp - delta) scale, in dp's registers.  The per-key mask only
    // where a tile needs it: segments, keys past Skv, a masked key in the
    // tile, the causal diagonal
    const bool masked = q_seg != nullptr || k0 + BN > Skv ||
                        (skip_dead && (i >= MAX_TILES || live[i] != 1)) ||
                        (causal && k0 + BN - 1 > wg_first_row + q_offset);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int j = (idx / 2) % 2;
      bool vis = true;
      if (masked) {
        const int col = (idx / 4) * 8 + (lane % 4) * 2 + idx % 2;
        vis = kcode[col] == qcode[j];
        if (causal) vis = vis && (k0 + col <= q0 + r_lo + 8 * j + q_offset);
      }
      const float p = vis ? exp2_approx(s[idx] * scale_log2 - lse2[j]) : 0.f;
      dp[idx] = p * (dp[idx] - dlt[j]);
    }

    // dQ += dS K, dS rounded to bf16 in registers
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) frag_from_acc(da[kb], dp, kb);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      if constexpr (D == 128) {
        wgmma_m64n128k16_rs(dQ, da[kb], desc_mnmajor<BN>(Ks, kb), 1);
      } else {
        wgmma_m64n64k16_rs(dQ, da[kb], desc_mnmajor<BN>(Ks, kb), 1);
        wgmma_m64n16k16_rs(dQ16, da[kb], desc_mnmajor_d80_hi<BN>(Ks, kb), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dQ);
    if constexpr (D != 128) fence_regs(dQ16);
    mbar_arrive(&empty[pos.stage]);
    pos.advance<STAGES>();
  }

  // epilogue: rows r_lo, r_lo + 8 of dq
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r_lo + 8 * j;
    if (row >= Sq) continue;
    bf16* drow = dq + (((long)b * Sq + row) * Hq + h) * D + (lane % 4) * 2;
#pragma unroll
    for (int n8 = 0; n8 < NO / 4; ++n8)
      *reinterpret_cast<uint32_t*>(drow + n8 * 8) =
          pack_bf16(dQ[4 * n8 + 2 * j], dQ[4 * n8 + 2 * j + 1]);
    if constexpr (D != 128)   // columns 64-71
      *reinterpret_cast<uint32_t*>(drow + 64) = pack_bf16(dQ16[2 * j], dQ16[2 * j + 1]);
    if constexpr (D == 80)    // columns 72-79 (at D = 72 K's zero columns)
      *reinterpret_cast<uint32_t*>(drow + 72) =
          pack_bf16(dQ16[4 + 2 * j], dQ16[4 + 2 * j + 1]);
  }
}

template <int D>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dq, const void* kv_valid, const void* q_seg,
                          const void* kv_seg, int B, int Sq, int Skv, int Hq, int Hkv,
                          int causal, int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tq16, tk16, tv16, tdo16;
  cudaError_t err = encode_maps<D>(&tq, &tq16, q, B, Sq, Hq, BM);
  if (err == cudaSuccess) err = encode_maps<D>(&tdo, &tdo16, dout, B, Sq, Hq, BM);
  if (err == cudaSuccess) err = encode_maps<D>(&tk, &tk16, k, B, Skv, Hkv, BN);
  if (err == cudaSuccess) err = encode_maps<D>(&tv, &tv16, v, B, Skv, Hkv, BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::alloc);
  if (err != cudaSuccess) return err;
  dim3 grid(Hq, B, (Sq + BM - 1) / BM);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, Smem<D>::alloc, stream>>>(
      tq, tq16, tk, tk16, tv, tv16, tdo, tdo16, (const float*)lse, (const float*)delta,
      (bf16*)dq,
      (const uint8_t*)kv_valid, (const int*)q_seg, (const int*)kv_seg, Sq, Skv, Hq,
      Hkv, causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace dq

namespace dkv {

constexpr int BK = 128;       // keys per CTA (2 consumer warpgroups of 64)
constexpr int BQ = 64;        // query rows per step
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int DP = sm90::head_tile_width(D);
  static constexpr int k = 0;                                 // bf16 [BK][DP]
  static constexpr int v = k + BK * DP * 2;                   // bf16 [BK][DP]
  static constexpr int ring = v + BK * DP * 2;                // [STAGES] x (Q, dO)
  static constexpr int tile = BQ * DP * 2;                    // one Q or dO tile
  static constexpr int stats = ring + STAGES * 2 * tile;      // [STAGES] x 3 x [BQ]
  static constexpr int bars = stats + STAGES * 3 * BQ * 4;    // full, empty, kv
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8;
  static constexpr int alloc = bytes + 1024;                  // base alignment
};

// Key code of key kg of batch row b (0 = masked or past the end).
__device__ __forceinline__ int key_code(const uint8_t* kv_valid, const int* kv_seg,
                                        int b, int kg, int Skv) {
  if (kg >= Skv) return 0;
  if (kv_valid != nullptr && kv_valid[(long)b * Skv + kg] == 0) return 0;
  return kv_seg != nullptr ? kv_seg[(long)b * Skv + kg] + 1 : 1;
}

// Write two f32 values of row `row`, columns c, c + 1 of (.., Skv, Hkv, D):
// bf16 to dk/dv, or f32 to this split's slot of the partial sums.
__device__ __forceinline__ void store_pair(bf16* out, float* part, long off, float x,
                                           float y) {
  if (part != nullptr)
    *reinterpret_cast<float2*>(part + off) = make_float2(x, y);
  else
    *reinterpret_cast<uint32_t*>(out + off) = sm90::pack_bf16(x, y);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tq16,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tk16,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tv16,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tdo16,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ partial, const uint8_t* __restrict__ kv_valid,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     int B, int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                     int splits, float scale) {
  using namespace sm90;
  using SmemD = Smem<D>;
  constexpr int DP = SmemD::DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* stats = reinterpret_cast<float*>(smem + SmemD::stats);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SmemD::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int hk = blockIdx.x / splits, split = blockIdx.x % splits;
  const int b = blockIdx.y, k0 = blockIdx.z * BK;
  const int group = Hq / Hkv, hps = (group + splits - 1) / splits;
  const int h_begin = hk * group + split * hps;
  const int n_heads = max(0, min(hps, group - split * hps));
  // Under the causal rule q row i sees key j iff j <= i + q_offset: the
  // first q tile with a row that sees key k0 is (k0 - q_offset) / BQ.
  const int t_begin = causal ? max(0, k0 - q_offset) / BQ : 0;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int nt = max(0, n_qt - t_begin);
  const int n_steps = n_heads * nt;
  const long n_out = (long)B * Skv * Hkv * D;
  float* part = partial != nullptr ? partial + (long)split * n_out : nullptr;
  const long part_dv = (long)splits * n_out;   // dV's partials follow dK's

  // A tile whose keys are all masked has dk = dv = 0 exactly (p = 0 for
  // every pair): write the zeros and stop.
  const int kg_own = k0 + (int)threadIdx.x;
  const bool live = threadIdx.x < BK && key_code(kv_valid, kv_seg, b, kg_own, Skv) != 0;
  if (!__syncthreads_or(live)) {
    const int nk = min(BK, Skv - k0);
    for (int i = threadIdx.x; i < nk * (D / 2); i += NTHREADS) {
      const long off = (((long)b * Skv + k0 + i / (D / 2)) * Hkv + hk) * D + 2 * (i % (D / 2));
      store_pair(dk, part, off, 0.f, 0.f);
      store_pair(dv, part == nullptr ? nullptr : part + part_dv, off, 0.f, 0.f);
    }
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);     // the producer warp's lanes (+ TMA bytes)
      mbar_init(&empty[s], 256);   // every consumer thread
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    regs_dealloc<24>();
    if (threadIdx.x >= 256 + 32) return;   // one producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * BK * DP * 2);
      tma_load_head_rows<D, BK>(smem + SmemD::k, &tk, &tk16, kvbar, hk, k0, b);
      tma_load_head_rows<D, BK>(smem + SmemD::v, &tv, &tv16, kvbar, hk, k0, b);
    }
    RingPos pos;
    for (int step = 0; step < n_steps; ++step) {
      const int h = h_begin + step / nt, q0 = (t_begin + step % nt) * BQ;
      mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
      // per q row: lse (log2 units), delta, code (-1 past the end: no key
      // matches it)
      float* st = stats + pos.stage * 3 * BQ;
      const long row0 = ((long)b * Hq + h) * Sq + q0;
      for (int j = lane; j < BQ; j += 32) {
        const bool in = q0 + j < Sq;
        st[j] = in ? lse[row0 + j] * LOG2E : 0.f;
        st[BQ + j] = in ? delta[row0 + j] : 0.f;
        reinterpret_cast<int*>(st)[2 * BQ + j] =
            !in ? -1 : q_seg != nullptr ? q_seg[(long)b * Sq + q0 + j] + 1 : 1;
      }
      if (lane == 0) {
        unsigned char* qs = smem + SmemD::ring + pos.stage * 2 * SmemD::tile;
        mbar_arrive_expect_tx(&full[pos.stage], 2 * SmemD::tile);
        tma_load_head_rows<D, BQ>(qs, &tq, &tq16, &full[pos.stage], h, q0, b);
        tma_load_head_rows<D, BQ>(qs + SmemD::tile, &tdo, &tdo16, &full[pos.stage], h,
                                  q0, b);
      } else {
        mbar_arrive(&full[pos.stage]);
      }
      pos.advance<STAGES>();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64)
  regs_alloc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  int kg[2], kcode[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    kg[j] = k0 + 64 * wg + warp * 16 + lane / 4 + 8 * j;
    kcode[j] = key_code(kv_valid, kv_seg, b, kg[j], Skv);
  }
  const float scale_log2 = scale * LOG2E;
  // dK, dV: columns 0-127 (D = 128), or 0-63 and 64-79 (D = 80 and 72)
  constexpr int NO = D == 128 ? 64 : 32;
  float dK[NO], dV[NO], dK16[8], dV16[8];
#pragma unroll
  for (int i = 0; i < NO; ++i) dK[i] = dV[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) dK16[i] = dV16[i] = 0.f;

  mbar_wait(kvbar, 0);
  RingPos pos;
  for (int step = 0; step < n_steps; ++step) {
    const int q0 = (t_begin + step % nt) * BQ;
    mbar_wait(&full[pos.stage], pos.phase);
    const unsigned char* Qs = smem + SmemD::ring + pos.stage * 2 * SmemD::tile;
    const unsigned char* dOs = Qs + SmemD::tile;
    const float* st = stats + pos.stage * 3 * BQ;
    const int* qcode = reinterpret_cast<const int*>(st) + 2 * BQ;

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 q rows each; both start
    // undefined, the first step of each ignores them)
    float sT[32], dpT[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss(sT, desc_kmajor_head<D, BK>(smem + SmemD::k, 64 * wg, kk),
                         desc_kmajor_head<D, BQ>(Qs, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss(dpT, desc_kmajor_head<D, BK>(smem + SmemD::v, 64 * wg, kk),
                         desc_kmajor_head<D, BQ>(dOs, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);

    // p = exp(s scale - lse) where the key is visible, else exactly 0;
    // ds = p (dp - delta) scale
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int j = (idx / 2) % 2;
      const int col = (idx / 4) * 8 + (lane % 4) * 2 + idx % 2;
      bool vis = qcode[col] == kcode[j];
      if (causal) vis = vis && (kg[j] <= q0 + col + q_offset);
      const float p = vis ? exp2f(sT[idx] * scale_log2 - st[col]) : 0.f;
      sT[idx] = p;
      dpT[idx] = p * (dpT[idx] - st[BQ + col]) * scale;
    }

    // dV += P^T dO and dK += dS^T Q (p and ds rounded to bf16)
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kb = 0; kb < BQ / 16; ++kb) {
      frag_from_acc(pa[kb], sT, kb);
      frag_from_acc(da[kb], dpT, kb);
    }
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BQ / 16; ++kb) {
      if constexpr (D == 128) {
        wgmma_m64n128k16_rs(dV, pa[kb], desc_mnmajor<BQ>(dOs, kb), 1);
      } else {
        wgmma_m64n64k16_rs(dV, pa[kb], desc_mnmajor<BQ>(dOs, kb), 1);
        wgmma_m64n16k16_rs(dV16, pa[kb], desc_mnmajor_d80_hi<BQ>(dOs, kb), 1);
      }
    }
#pragma unroll
    for (int kb = 0; kb < BQ / 16; ++kb) {
      if constexpr (D == 128) {
        wgmma_m64n128k16_rs(dK, da[kb], desc_mnmajor<BQ>(Qs, kb), 1);
      } else {
        wgmma_m64n64k16_rs(dK, da[kb], desc_mnmajor<BQ>(Qs, kb), 1);
        wgmma_m64n16k16_rs(dK16, da[kb], desc_mnmajor_d80_hi<BQ>(Qs, kb), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dV);
    fence_regs(dK);
    if constexpr (D != 128) {
      fence_regs(dV16);
      fence_regs(dK16);
    }
    mbar_arrive(&empty[pos.stage]);
    pos.advance<STAGES>();
  }

  // epilogue: rows kg[j] of dk and dv (or of this split's partials)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (kg[j] >= Skv) continue;
    const long off = (((long)b * Skv + kg[j]) * Hkv + hk) * D + (lane % 4) * 2;
    float* part_v = part == nullptr ? nullptr : part + part_dv;
#pragma unroll
    for (int n8 = 0; n8 < NO / 4; ++n8) {
      const int i = 4 * n8 + 2 * j;
      store_pair(dk, part, off + n8 * 8, dK[i], dK[i + 1]);
      store_pair(dv, part_v, off + n8 * 8, dV[i], dV[i + 1]);
    }
    // columns 64-71, and 72-79 at D = 80 (at D = 72 Q's and dO's zero columns)
    if constexpr (D != 128) {
#pragma unroll
      for (int n8 = 0; n8 < (D - 64) / 8; ++n8) {
        const int i = 4 * n8 + 2 * j;
        store_pair(dk, part, off + 64 + n8 * 8, dK16[i], dK16[i + 1]);
        store_pair(dv, part_v, off + 64 + n8 * 8, dV16[i], dV16[i + 1]);
      }
    }
  }
}

// dk / dv = the sum of the splits' f32 partials, in split order, as bf16.
__global__ void dkv_reduce_kernel(const float* __restrict__ partial,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                                  long n, int splits) {
  const long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= 2 * n) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const long base = i < n ? i : splits * n + (i - n);
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(partial + base + s * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* out = i < n ? dk + i : dv + (i - n);
  reinterpret_cast<uint32_t*>(out)[0] = sm90::pack_bf16(acc.x, acc.y);
  reinterpret_cast<uint32_t*>(out)[1] = sm90::pack_bf16(acc.z, acc.w);
}

template <int D>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dk, void* dv, void* partial, const void* kv_valid,
                          const void* q_seg, const void* kv_seg, int B, int Sq, int Skv,
                          int Hq, int Hkv, int causal, int q_offset, int splits,
                          float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tq16, tk16, tv16, tdo16;
  cudaError_t err = encode_maps<D>(&tq, &tq16, q, B, Sq, Hq, BQ);
  if (err == cudaSuccess) err = encode_maps<D>(&tdo, &tdo16, dout, B, Sq, Hq, BQ);
  if (err == cudaSuccess) err = encode_maps<D>(&tk, &tk16, k, B, Skv, Hkv, BK);
  if (err == cudaSuccess) err = encode_maps<D>(&tv, &tv16, v, B, Skv, Hkv, BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::alloc);
  if (err != cudaSuccess) return err;
  float* part = splits > 1 ? (float*)partial : nullptr;
  dim3 grid(Hkv * splits, B, (Skv + BK - 1) / BK);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, Smem<D>::alloc, stream>>>(
      tq, tq16, tk, tk16, tv, tv16, tdo, tdo16, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv,
      part, (const uint8_t*)kv_valid, (const int*)q_seg, (const int*)kv_seg, B, Sq,
      Skv, Hq, Hkv, causal, q_offset, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long n = (long)B * Skv * Hkv * D;
  const int threads = 256;
  const long blocks = (2 * n / 4 + threads - 1) / threads;
  dkv_reduce_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, (bf16*)dk,
                                                               (bf16*)dv, n, splits);
  return cudaGetLastError();
}

}  // namespace dkv
}  // namespace spacer

extern "C" int spacer_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, const void* kv_valid, const void* q_seg,
    const void* kv_seg, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
    int q_offset, float scale, void* stream) {
  if (dq == nullptr || Sq <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return spacer::dq::launch<128>(q, k, v, dout, lse, delta, dq, kv_valid, q_seg,
                                   kv_seg, B, Sq, Skv, Hq, Hkv, causal, q_offset,
                                   scale, s);
  if (D == 80)
    return spacer::dq::launch<80>(q, k, v, dout, lse, delta, dq, kv_valid, q_seg,
                                  kv_seg, B, Sq, Skv, Hq, Hkv, causal, q_offset, scale,
                                  s);
  if (D == 72)
    return spacer::dq::launch<72>(q, k, v, dout, lse, delta, dq, kv_valid, q_seg,
                                  kv_seg, B, Sq, Skv, Hq, Hkv, causal, q_offset, scale,
                                  s);
  return (int)cudaErrorInvalidValue;
}

// Keys per dk/dv CTA, which the wrapper's split rule counts CTAs by.
extern "C" int spacer_flash_attention_bwd_dkv_keys() { return spacer::dkv::BK; }

// `partial`: f32 scratch of 2 * splits * B * Skv * Hkv * D values when
// splits > 1 (the wrapper sizes it; ignored for splits == 1).
extern "C" int spacer_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, void* partial, const void* kv_valid,
    const void* q_seg, const void* kv_seg, int B, int Sq, int Skv, int Hq, int Hkv,
    int D, int causal, int q_offset, int splits, float scale, void* stream) {
  if (dk == nullptr || dv == nullptr || Sq <= 0 || Skv <= 0 || splits < 1 ||
      splits > Hq / Hkv || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 128)
    return spacer::dkv::launch<128>(q, k, v, dout, lse, delta, dk, dv, partial,
                                    kv_valid, q_seg, kv_seg, B, Sq, Skv, Hq, Hkv,
                                    causal, q_offset, splits, scale, s);
  if (D == 80)
    return spacer::dkv::launch<80>(q, k, v, dout, lse, delta, dk, dv, partial,
                                   kv_valid, q_seg, kv_seg, B, Sq, Skv, Hq, Hkv,
                                   causal, q_offset, splits, scale, s);
  if (D == 72)
    return spacer::dkv::launch<72>(q, k, v, dout, lse, delta, dk, dv, partial,
                                   kv_valid, q_seg, kv_seg, B, Sq, Skv, Hq, Hkv,
                                   causal, q_offset, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}

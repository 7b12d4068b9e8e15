// Mask policy shared by K1's forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu): causal with a static q_offset (key j is visible
// to query i when j <= i + q_offset), a (B, Skv) validity mask and optional
// (B, S) segment ids.  The validity mask folds into per-key codes exactly as
// the TPU wrapper folds it into segment ids (0 = masked key, segment + 1
// otherwise); a key is visible to a query iff the codes are equal.
#pragma once

#include "attention_tile.cuh"

namespace spacer {

struct FlashMask {
  const uint8_t* kv_valid;  // (Skv,) of this batch row, or null
  const int* q_seg;         // (Sq,) or null
  const int* kv_seg;        // (Skv,) or null
  int q0;                   // global index of the tile's first query row
  int q_offset;
  bool causal;

  // info[0:BM] = query codes, info[BM:BM+BN] = key codes.
  __device__ void load_queries(int n_q, int tid, int* info) const {
    for (int i = tid; i < BM; i += NTHREADS)
      info[i] = (q_seg != nullptr && i < n_q) ? q_seg[q0 + i] + 1 : 1;
  }
  __device__ void load_keys(int k0, int nk, int tid, int* info) const {
    for (int i = tid; i < BN; i += NTHREADS) {
      int code = 0;
      if (i < nk) {
        code = kv_seg != nullptr ? kv_seg[k0 + i] + 1 : 1;
        if (kv_valid != nullptr && kv_valid[k0 + i] == 0) code = 0;
      }
      info[BM + i] = code;
    }
  }
  // Row qi of the tile sees key kj of the tile (global key index kg).
  __device__ bool visible(int qi, int kj, int kg, const int* info) const {
    bool ok = info[BM + kj] == info[qi];
    if (causal) ok = ok && (kg <= q0 + qi + q_offset);
    return ok;
  }
  __device__ float apply(float s, int qi, int kj, int kg, const int* info) const {
    return visible(qi, kj, kg, info) ? s : MASK_VALUE;
  }
};

}  // namespace spacer

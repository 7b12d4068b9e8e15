// The second pass of the split-K decode kernels K2 (flash_decode_grouped.cu)
// and K5 (flash_decode.cu): each job of the first pass wrote a normalised
// partial output o_s (f32) and its log-sum-exp lse_s for every query row;
// this pass folds them, per (query row, batch row x kv head), into
//   out = sum_s exp(lse_s - M) o_s / sum_s exp(lse_s - M),  M = max_s lse_s,
// in a fixed job order (no atomics: two calls are bitwise equal).  A job
// that saw no live key wrote lse = -inf and no o_s: it is skipped, and a row
// whose every job is such writes 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace spacer {
namespace {

// One CTA per (query row, bh); thread d owns output column d.  part_o is
// (bh, job, row, D), part_lse (bh, job, row), out (bh, row, D).
__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_lse,
                                      float* __restrict__ out, int NS, int GQ, int D) {
  const int row = blockIdx.x;
  const long bh = blockIdx.y;
  float m = -INFINITY;
  for (int s = 0; s < NS; ++s) m = fmaxf(m, part_lse[(bh * NS + s) * GQ + row]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float wsum = 0.f, acc = 0.f;
    for (int s = 0; s < NS; ++s) {
      const long slot = (bh * NS + s) * GQ + row;
      const float lse = part_lse[slot];
      if (lse == -INFINITY) continue;   // a dead job: its o_s was not written
      const float w = __expf(lse - m);
      wsum += w;
      acc += w * part_o[slot * D + d];
    }
    out[(bh * GQ + row) * D + d] = wsum > 0.f ? acc / wsum : 0.f;
  }
}

}  // namespace
}  // namespace spacer

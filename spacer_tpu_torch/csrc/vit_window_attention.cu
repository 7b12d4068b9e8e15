// K3 and K4: block-diagonal attention over uniform segments for the ViT.
//
// K3 replaces spacer_tpu/ops/vit_window_attention.py::window_attention_hsd
// (_kernel): the 28 windowed layers of the Qwen2.5-VL ViT, segments of
// wt = 64 tokens (8x8 patches) whose tail slots are padding, masked by an
// additive (1, S) validity bias (0 valid, -1e30 pad).
// K4 replaces chunk_attention_hsd (_kernel_nomask): the 4 full-attention
// layers, one segment per temporal frame chunk (wt = 480 at grid (8,16,30)),
// every slot valid.
//
// Both take q, k, v in the (H, S, D) layout, bf16, with D = 80 unpadded (the
// TPU padded it to 128 lanes; 80 = 5 x 16 is a legal MMA width here).
//
// Design: one CTA per (64-row q tile, segment, head) streams the segment's
// keys in tiles of 64 with an online softmax (attention_tile.cuh).  The TPU
// kernel's R x R block-diagonal score matmul (8x the needed flops, to feed
// the 128x128 MXU) is not carried over: a K3 window is exactly one q tile
// and one key tile.  A K4 chunk of 480 keys does not fit one score tile in
// shared memory (480^2 f32 = 900 KB), hence the streaming.
//
// What bounds it on the H100: flops (64 and 480 keys per query at D = 80);
// the WMMA-from-shared-memory design leaves most of the tensor-core rate
// unused, as in K1.
#include "attention_tile.cuh"

namespace spacer {

struct BiasMask {  // K3: additive per-key bias of the segment
  const float* bias;  // (wt,) of this segment
  __device__ void load_queries(int, int, int*) const {}
  __device__ void load_keys(int k0, int nk, int tid, int* info) const {
    float* b = reinterpret_cast<float*>(info + BM);
    for (int i = tid; i < BN; i += NTHREADS) b[i] = i < nk ? bias[k0 + i] : 0.f;
  }
  __device__ float apply(float s, int, int kj, int, const int* info) const {
    return s + reinterpret_cast<const float*>(info + BM)[kj];
  }
};

struct NoMask {  // K4: every key of the segment is valid
  __device__ void load_queries(int, int, int*) const {}
  __device__ void load_keys(int, int, int, int*) const {}
  __device__ float apply(float s, int, int, int, const int*) const { return s; }
};

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(NTHREADS)
segment_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         bf16* __restrict__ out, int S, int wt, float scale) {
  const int q0 = blockIdx.x * BM, seg = blockIdx.y, h = blockIdx.z;
  const int n_q = min(BM, wt - q0);
  const long base = ((long)h * S + (long)seg * wt) * D;
  const long qo = base + (long)q0 * D;
  if constexpr (HAS_BIAS) {
    BiasMask mask{bias + (long)seg * wt};
    attend<D>(q + qo, D, n_q, k + base, v + base, D, wt, scale, mask, out + qo,
              D, nullptr);
  } else {
    NoMask mask;
    attend<D>(q + qo, D, n_q, k + base, v + base, D, wt, scale, mask, out + qo,
              D, nullptr);
  }
}

template <int D, bool HAS_BIAS>
static cudaError_t launch_segments(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int H, int S,
                                   int wt, float scale, cudaStream_t stream) {
  const int smem = (int)TileSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(segment_attention_kernel<D, HAS_BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid((wt + BM - 1) / BM, S / wt, H);
  segment_attention_kernel<D, HAS_BIAS><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
      (bf16*)out, S, wt, scale);
  return cudaGetLastError();
}

template <bool HAS_BIAS>
static int dispatch_segments(const void* q, const void* k, const void* v,
                             const void* bias, void* out, int H, int S, int D,
                             int wt, float scale, void* stream) {
  if (D != 80) return (int)cudaErrorInvalidValue;  // the ViT head dim
  return launch_segments<80, HAS_BIAS>(q, k, v, bias, out, H, S, wt, scale,
                                       (cudaStream_t)stream);
}

}  // namespace spacer

extern "C" int spacer_window_attention_hsd(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* out, int H, int S, int D,
                                           int wt, float scale, void* stream) {
  return spacer::dispatch_segments<true>(q, k, v, bias, out, H, S, D, wt, scale,
                                         stream);
}

extern "C" int spacer_chunk_attention_hsd(const void* q, const void* k,
                                          const void* v, void* out, int H, int S,
                                          int D, int wt, float scale,
                                          void* stream) {
  return spacer::dispatch_segments<false>(q, k, v, nullptr, out, H, S, D, wt,
                                          scale, stream);
}

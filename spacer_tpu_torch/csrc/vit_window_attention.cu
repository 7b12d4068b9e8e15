// K3: block-diagonal attention over uniform windows for the ViT.
//
// Replaces spacer_tpu/ops/vit_window_attention.py::window_attention_hsd
// (_kernel): the 28 windowed layers of the Qwen2.5-VL ViT, segments of
// wt = 64 tokens (8x8 patches) whose tail slots are padding, masked by an
// additive (1, S) validity bias (0 valid, -1e30 pad).  K4, the 4
// full-attention layers, is vit_chunk_attention.cu.
//
// Takes q, k, v in the (H, S, D) layout, bf16, with D = 80 unpadded (the
// TPU padded it to 128 lanes; 80 = 5 x 16 is a legal MMA width here).
//
// Design: one CTA per (64-row q tile, window, head) streams the window's
// keys in tiles of 64 with an online softmax (attention_tile.cuh).  The TPU
// kernel's R x R block-diagonal score matmul (8x the needed flops, to feed
// the 128x128 MXU) is not carried over: a K3 window is exactly one q tile
// and one key tile.
//
// What bounds it on the H100: flops (64 keys per query at D = 80); the
// WMMA-from-shared-memory design leaves most of the tensor-core rate unused
// (K4's wgmma design in vit_chunk_attention.cu is the way forward).
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

template <int D>
__global__ void __launch_bounds__(NTHREADS)
segment_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         bf16* __restrict__ out, int S, int wt, float scale) {
  const int q0 = blockIdx.x * BM, seg = blockIdx.y, h = blockIdx.z;
  const int n_q = min(BM, wt - q0);
  const long base = ((long)h * S + (long)seg * wt) * D;
  const long qo = base + (long)q0 * D;
  BiasMask mask{bias + (long)seg * wt};
  attend<D>(q + qo, D, n_q, k + base, v + base, D, wt, scale, mask, out + qo, D,
            nullptr);
}

template <int D>
static cudaError_t launch_segments(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int H, int S,
                                   int wt, float scale, cudaStream_t stream) {
  const int smem = (int)TileSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(segment_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid((wt + BM - 1) / BM, S / wt, H);
  segment_attention_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
      (bf16*)out, S, wt, scale);
  return cudaGetLastError();
}

}  // namespace spacer

extern "C" int spacer_window_attention_hsd(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           void* out, int H, int S, int D,
                                           int wt, float scale, void* stream) {
  if (D != 80) return (int)cudaErrorInvalidValue;  // the ViT head dim
  return spacer::launch_segments<80>(q, k, v, bias, out, H, S, wt, scale,
                                     (cudaStream_t)stream);
}

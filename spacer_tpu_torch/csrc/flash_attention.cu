// K1: flash attention forward for the LM prefill.
//
// Replaces the Pallas kernel spacer_tpu/ops/flash_attention.py
// (flash_attention -> _flash_fwd_impl -> _fwd_kernel).  Same contract as the
// plain version spacer_tpu_torch/nn/attention.py::xla_attention: q (B,Sq,Hq,D),
// k/v (B,Skv,Hkv,D) bf16 in the JAX layout, causal with a static q_offset
// (key j is visible to query i when j <= i + q_offset), a (B,Skv) validity
// mask and optional (B,S) segment ids, GQA (q head h reads kv head
// h / (Hq/Hkv)).  Writes out (B,Sq,Hq,D) bf16 and the LSE (B,Hq,Sq) f32 that
// a backward pass needs.
//
// Design: one CTA per (64-row q tile, q head, batch row) walks key tiles up
// to its causal limit (attention_tile.cuh).  The TPU kernel's 8-lane
// broadcast segment layout was a Mosaic tiling artefact; here the validity
// mask folds into per-key codes (flash_mask.cuh).
//
// What bounds it on the H100: at the prefill shapes (P = 512-1024, D = 128)
// attention is compute-bound (~P/2 flops per byte of K/V).  This first
// version runs WMMA 16x16x16 bf16 MMAs out of shared memory with no
// load/compute overlap, so it sits far below the tensor-core peak; wgmma,
// TMA and a producer warp are the next steps.
#include "flash_mask.cuh"

namespace spacer {

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, const uint8_t* __restrict__ kv_valid,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 int Sq, int Skv, int Hq, int Hkv, int causal, int q_offset,
                 float scale) {
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int n_q = min(BM, Sq - q0);
  const int hk = h / (Hq / Hkv);
  const long q_rs = (long)Hq * D, kv_rs = (long)Hkv * D;
  int n_kv = Skv;
  if (causal) n_kv = max(0, min(Skv, q0 + n_q + q_offset));
  FlashMask mask{kv_valid ? kv_valid + (long)b * Skv : nullptr,
                 q_seg ? q_seg + (long)b * Sq : nullptr,
                 kv_seg ? kv_seg + (long)b * Skv : nullptr,
                 q0, q_offset, causal != 0};
  const long q_base = ((long)b * Sq + q0) * q_rs + (long)h * D;
  const long kv_base = (long)b * Skv * kv_rs + (long)hk * D;
  attend<D>(q + q_base, q_rs, n_q, k + kv_base, v + kv_base, kv_rs, n_kv,
            scale, mask, out + q_base, q_rs,
            lse + ((long)b * Hq + h) * Sq + q0);
}

template <int D>
static cudaError_t launch_flash(const void* q, const void* k, const void* v,
                                void* out, void* lse, const void* kv_valid,
                                const void* q_seg, const void* kv_seg, int B,
                                int Sq, int Skv, int Hq, int Hkv, int causal,
                                int q_offset, float scale, cudaStream_t stream) {
  const int smem = (int)TileSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse,
      (const uint8_t*)kv_valid, (const int*)q_seg, (const int*)kv_seg, Sq, Skv,
      Hq, Hkv, causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace spacer

extern "C" int spacer_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* kv_valid, const void* q_seg, const void* kv_seg, int B, int Sq,
    int Skv, int Hq, int Hkv, int D, int causal, int q_offset, float scale,
    void* stream) {
  auto s = (cudaStream_t)stream;
  if (D != 128) return (int)cudaErrorInvalidValue;  // the LM head dim
  return spacer::launch_flash<128>(q, k, v, out, lse, kv_valid, q_seg, kv_seg, B,
                                   Sq, Skv, Hq, Hkv, causal, q_offset, scale, s);
}

extern "C" const char* spacer_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K6: packed-int4 weight matmul for the int4 decode path.
//
// Replaces spacer_tpu/ops/int4_matmul.py::int4_matmul (`_kernel`).
// y (M, N) f32 = x (M, K) bf16 @ unpack(packed (K/2, N) int8), f32 sums.
// Packing: within each K-block of bk rows, packed row r of block j holds
// code[j*bk + r] in its low nibble and code[j*bk + bk/2 + r] in its high
// nibble (signed 4-bit), so packed row pr pairs with x columns
// lo(pr) = (pr / h) * bk + pr % h and lo(pr) + h, h = bk / 2.
//
// What bounds it on the H100: the K*N/2 packed bytes.  Decode has M = 4-16
// rows, ~4 flops per weight byte, far under the card's ~295 flops per byte
// of bf16 tensor-core rate, so the design streams the weights once with
// coalesced loads and keeps the arithmetic on the CUDA cores:
//   - a CTA (8 warps) owns 128 output columns; lane l of every warp reads
//     the 4 packed bytes of columns 4l..4l+3 of a packed row as one int32,
//     so a warp reads 128 contiguous bytes per row; warp w takes rows
//     w, w+8, ... of the CTA's row range;
//   - both nibbles are sign-extended with shifts on the int32 (the TPU
//     kernel's `(v << 28) >> 28` and `v >> 4`, per byte), and each code is
//     multiplied by its x element, staged in shared memory as f32 for a
//     chunk of 128 packed rows and up to M_TILE rows of x; the sums of up to
//     16 x rows x 4 columns stay in registers;
//   - the 8 warps' sums are added in shared memory in a fixed order;
//   - the K range is cut into `splits` ranges when the column tiles alone
//     would leave SMs idle (k/v projections: N = 512 gives 4 tiles); the
//     partial sums go to scratch and a second pass adds them in order, so
//     the result does not depend on scheduling.
// The TPU kernel padded M to 8 and ran bf16 MXU dots on (bk/2, bn) tiles;
// here the M tile is masked, and the f32 FMAs on the CUDA cores replace the
// MXU (at M = 16 they, not the bytes, may bound the kernel; a tensor-core
// version is for a later change).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spacer {

constexpr int I4_THREADS = 256;
constexpr int I4_WARPS = I4_THREADS / 32;
constexpr int I4_COLS = 128;        // output columns per CTA
constexpr int I4_CHUNK = 128;       // packed rows of x staged at a time
constexpr int I4_RED_ROWS = 4;      // x rows reduced across warps per pass

__device__ __forceinline__ int nibble(int w, int shift) {
  // bits [28 - shift, 32 - shift) of w, sign-extended
  return (int)((unsigned)w << shift) >> 28;
}

template <int MT>
__global__ void __launch_bounds__(I4_THREADS)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
                   float* __restrict__ out, int M, int K, int N, int bk,
                   int rows_per_split) {
  // staged x: xs[m][r] = (x[m0 + m][lo(r)], x[m0 + m][lo(r) + h]); every
  // lane of a warp reads the same (m, r), a broadcast
  __shared__ float2 xs[MT * I4_CHUNK];
  __shared__ float red[I4_WARPS * I4_RED_ROWS * I4_COLS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K2 = K / 2, h = bk / 2;
  const int n0 = blockIdx.x * I4_COLS + lane * 4;
  const int m0 = blockIdx.z * MT;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(K2, r_begin + rows_per_split);
  const bool col_ok = n0 < N;  // N % 4 == 0: all 4 columns or none

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int c0 = r_begin; c0 < r_end; c0 += I4_CHUNK) {
    const int nr = min(I4_CHUNK, r_end - c0);
    __syncthreads();  // the previous chunk's x is consumed
    for (int i = tid; i < nr * MT; i += I4_THREADS) {
      const int m = i / nr, r = i % nr;
      const int pr = c0 + r;
      const int lo = (pr / h) * bk + pr % h;
      float a = 0.f, b = 0.f;
      if (m0 + m < M) {
        const __nv_bfloat16* xr = x + (long)(m0 + m) * K;
        a = __bfloat162float(xr[lo]);
        b = __bfloat162float(xr[lo + h]);
      }
      xs[m * I4_CHUNK + r] = make_float2(a, b);
    }
    __syncthreads();
    if (col_ok) {
      const int8_t* prow = packed + (long)c0 * N + n0;
#pragma unroll 4
      for (int r = warp; r < nr; r += I4_WARPS) {
        const int w = __ldg(reinterpret_cast<const int*>(prow + (long)r * N));
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = (float)nibble(w, 28 - 8 * c);
          hi[c] = (float)nibble(w, 24 - 8 * c);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 a = xs[m * I4_CHUNK + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(a.y, hi[c], fmaf(a.x, lo[c], acc[m][c]));
        }
      }
    }
  }

  // sum the 8 warps' partials in a fixed order, I4_RED_ROWS x rows per pass
  float* dst = out + (long)blockIdx.y * M * N;
#pragma unroll
  for (int g = 0; g < MT; g += I4_RED_ROWS) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < I4_RED_ROWS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * I4_RED_ROWS + j) * I4_COLS + lane * 4 + c] = acc[g + j][c];
    __syncthreads();
    for (int i = tid; i < I4_RED_ROWS * I4_COLS; i += I4_THREADS) {
      const int j = i / I4_COLS, col = i % I4_COLS;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < I4_WARPS; ++w) s += red[(w * I4_RED_ROWS + j) * I4_COLS + col];
      const int m = m0 + g + j, n = blockIdx.x * I4_COLS + col;
      if (m < M && n < N) dst[(long)m * N + n] = s;
    }
  }
}

// out[i] = sum_s part[s][i], s in order
__global__ void int4_split_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      long n, int splits) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

template <int MT>
static cudaError_t launch_int4(const void* x, const void* packed, float* dst, int M, int K,
                               int N, int bk, int splits, int rows, cudaStream_t stream) {
  dim3 grid((N + I4_COLS - 1) / I4_COLS, splits, (M + MT - 1) / MT);
  int4_matmul_kernel<MT><<<grid, I4_THREADS, 0, stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)packed, dst, M, K, N, bk, rows);
  return cudaGetLastError();
}

}  // namespace spacer

extern "C" int spacer_int4_matmul(const void* x, const void* packed, void* part, void* out,
                                  int M, int K, int N, int bk, int splits, int rows,
                                  void* stream) {
  if (M < 1 || K < 2 || K % 2 || N < 4 || N % 4 || bk < 2 || K % bk || splits < 1 ||
      rows < 1 || (long)splits * rows < K / 2 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = splits > 1 ? (float*)part : (float*)out;
  cudaError_t err = M <= 4   ? spacer::launch_int4<4>(x, packed, dst, M, K, N, bk, splits, rows, s)
                    : M <= 8 ? spacer::launch_int4<8>(x, packed, dst, M, K, N, bk, splits, rows, s)
                             : spacer::launch_int4<16>(x, packed, dst, M, K, N, bk, splits, rows, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long n = (long)M * N;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  spacer::int4_split_sum_kernel<<<blocks, 256, 0, s>>>((const float*)part, (float*)out, n,
                                                        splits);
  return (int)cudaGetLastError();
}

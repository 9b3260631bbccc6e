// shift_matmul: y = x @ (s * 2^P) with the weight packed one int8 per element
// (bit 7 = sign, bits 0-6 = P + 64), for Hopper (sm_90a).
//
// Replaces the TPU kernel `shift_matmul_pallas` (`_shift_matmul_kernel`,
// `_assemble_bf16`) in repro/kernels/shift_matmul.py.
//
// What bounds it on an H100: memory. At the serving shapes (M = 6272 rows,
// K = N = 128) it moves x and y in float32 and the weight in one byte per
// element, a few MB, against a fraction of a GFLOP: the bytes take about ten
// times as long as the bf16 tensor-core work. The design therefore reads each
// weight as one byte and decodes it in shared memory, and reads x once per
// output-column tile (N / 64 times in all; twice at N = 128).
//
// Design (simple and right first; no TMA or wgmma yet):
//   * one block of 4 warps per 64 x 64 output tile; the block loops over K in
//     32-deep panels, always in the same order, with no split-K, so a row's
//     output depends only on that row and never on M or on the other rows;
//   * x is converted to bf16 (round to nearest even) while it is staged in
//     shared memory; the weight byte is decoded to the exact bf16 power of
//     two `sign << 15 | (P + 127) << 7`;
//   * each warp multiplies a 32 x 32 sub-tile with bf16 WMMA fragments
//     (16 x 16 x 16, mma.sync underneath) and sums in float32;
//   * ragged M / N / K edges are masked while staging (zeros, no padded
//     copies in device memory) and while storing.
// The C function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;   // bf16 elements; multiple of 8 for WMMA
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;   // float elements; multiple of 4 for WMMA

// P + 127 = (P + 64) + 63: the bf16 exponent field, mantissa zero.
__device__ __forceinline__ __nv_bfloat16 decode_po2(int8_t packed) {
  const unsigned u = static_cast<unsigned char>(packed);
  const unsigned short bits =
      static_cast<unsigned short>(((u >> 7) << 15) | (((u & 0x7Fu) + 63u) << 7));
  return __ushort_as_bfloat16(bits);
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
shift_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    T* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = (warp / 2) * 32;   // 2 x 2 warps, 32 x 32 each
  const int warp_n = (warp % 2) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage x[m0:m0+BM, k0:k0+BK] as bf16; zero outside the matrix.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * A_LD + c] = (gm < M && gk < K)
                             ? to_bf16(x[static_cast<int64_t>(gm) * K + gk])
                             : __float2bfloat16_rn(0.0f);
    }
    // Stage w[k0:k0+BK, n0:n0+BN], one byte per weight, decoded to bf16.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * B_LD + c] = (gk < K && gn < N)
                             ? decode_po2(w[static_cast<int64_t>(gk) * N + gn])
                             : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (warp_m + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + warp_n + 16 * j, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (warp_m + 16 * i) * C_LD + warp_n + 16 * j,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) store_out(&y[static_cast<int64_t>(gm) * N + gn], Cs[r * C_LD + c]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  shift_matmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<T*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Row-major, contiguous
// x (M, K), w (K, N) int8, y (M, N). Returns the launch's cudaError_t.
extern "C" int shift_matmul_launch(const void* x, const void* w, void* y, int M, int K,
                                   int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tile_matmul.cuh: the tiled bf16 tensor-core product that shift_matmul.cu,
// add_matmul.cu and add_matmul_packed.cu share. y[g] = x[g] @ B[g], where
// x (G, M, K) is float32 or bf16 and B (G, K, N) is stored in a compact form
// that a Decode policy turns into exact bf16 values while it is staged in
// shared memory (a power of two from one byte, +-1/0 from an int8, +-1 from
// one bit). A policy has `load(b, g, k, n, K, N)` and `kBatched` (false when
// G is always 1).
//
// Design (simple and right first; no TMA or wgmma yet):
//   * one block of 4 warps (2 x 2) per (g, BM x BN output tile); the tile
//     shape is a template parameter, chosen at launch from a small fixed set;
//   * the block loops over K in BK = 32 deep panels, always in the same
//     order, with no split-K, whatever the tile shape: each output element is
//     the same chain of 16-deep tensor-core steps for every tile, so the
//     result is bit-identical across tile shapes and never depends on M or
//     on the other rows;
//   * x is rounded to bf16 (round to nearest even) while it is staged; B is
//     decoded by the policy; each warp multiplies its (BM/2) x (BN/2)
//     sub-tile with bf16 WMMA fragments (16 x 16 x 16, mma.sync underneath)
//     and sums in float32;
//   * ragged M / N / K edges are masked while staging (zeros, no padded
//     copies in device memory) and while storing;
//   * the output tile is staged through the same shared memory as float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tile_matmul {

using namespace nvcuda;

constexpr int BK = 32;
constexpr int THREADS = 128;

// Shared memory of one block, in bytes: the x and B panels while summing,
// then the float32 output tile (the two never live at once). Mirrored by
// repro_torch.kernels.tile_matmul.smem_bytes.
template <int BM, int BN>
struct Layout {
  static constexpr int A_LD = BK + 8;   // bf16 elements; multiple of 8 for WMMA
  static constexpr int B_LD = BN + 8;
  static constexpr int C_LD = BN + 4;   // float elements; multiple of 4 for WMMA
  static constexpr int AB_BYTES = 2 * (BM * A_LD + BK * B_LD);
  static constexpr int C_BYTES = 4 * BM * C_LD;
  static constexpr int BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
};

// x is read through the read-only data cache (`__ldg`): the pointer is
// offset per batch inside the kernel, where `__restrict__` alone does not
// carry.
__device__ __forceinline__ __nv_bfloat16 load_bf16(const float* p) {
  return __float2bfloat16_rn(__ldg(p));
}
__device__ __forceinline__ __nv_bfloat16 load_bf16(const __nv_bfloat16* p) { return __ldg(p); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int BM, int BN, typename Decode>
__global__ void __launch_bounds__(THREADS)
tile_matmul_kernel(const T* __restrict__ x, const void* __restrict__ b, T* __restrict__ y,
                   int M, int K, int N) {
  using L = Layout<BM, BN>;
  constexpr int FM = BM / 32;   // 16 x 16 fragments per warp, down and across
  constexpr int FN = BN / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * L::A_LD;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = (warp / 2) * (BM / 2);
  const int warp_n = (warp % 2) * (BN / 2);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int64_t g = blockIdx.z;
  // An unbatched product (shift_matmul) skips the batch offset: measured on
  // the H100, the 64-bit offset arithmetic cost it ~5% at 6272 x 128 x 128.
  const T* xg = Decode::kBatched ? x + g * M * K : x;
  T* yg = Decode::kBatched ? y + g * M * N : y;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage x[g, m0:m0+BM, k0:k0+BK] as bf16; zero outside the matrix.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * L::A_LD + c] = (gm < M && gk < K)
                                ? load_bf16(xg + static_cast<int64_t>(gm) * K + gk)
                                : __float2bfloat16_rn(0.0f);
    }
    // Stage B[g, k0:k0+BK, n0:n0+BN], decoded to bf16; zero outside.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * L::B_LD + c] = (gk < K && gn < N) ? Decode::load(b, g, gk, gn, K, N)
                                               : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (warp_m + 16 * i) * L::A_LD + kk, L::A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * L::B_LD + warp_n + 16 * j, L::B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (warp_m + 16 * i) * L::C_LD + warp_n + 16 * j,
                              acc[i][j], L::C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) store_out(&yg[static_cast<int64_t>(gm) * N + gn], Cs[r * L::C_LD + c]);
  }
}

template <typename T, int BM, int BN, typename Decode>
int launch_tile(const void* x, const void* b, void* y, int G, int M, int K, int N,
                cudaStream_t stream) {
  constexpr int smem = Layout<BM, BN>::BYTES;
  if constexpr (smem > 48 * 1024) {
    // Once per instantiation: more than 48 KB only as opted-in dynamic smem.
    static const cudaError_t attr = cudaFuncSetAttribute(
        tile_matmul_kernel<T, BM, BN, Decode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  tile_matmul_kernel<T, BM, BN, Decode><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), b, static_cast<T*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// The tile shapes built: tile_m, tile_n in {32, 64, 128}. Mirrored by
// repro_torch.kernels.tile_matmul.TILES.
template <typename T, typename Decode>
int launch_tiles(const void* x, const void* b, void* y, int G, int M, int K, int N,
                 int tile_m, int tile_n, cudaStream_t s) {
#define TILE_MATMUL_CASE(TM, TN) \
  if (tile_m == TM && tile_n == TN) return launch_tile<T, TM, TN, Decode>(x, b, y, G, M, K, N, s);
  TILE_MATMUL_CASE(32, 32) TILE_MATMUL_CASE(32, 64) TILE_MATMUL_CASE(32, 128)
  TILE_MATMUL_CASE(64, 32) TILE_MATMUL_CASE(64, 64) TILE_MATMUL_CASE(64, 128)
  TILE_MATMUL_CASE(128, 32) TILE_MATMUL_CASE(128, 64) TILE_MATMUL_CASE(128, 128)
#undef TILE_MATMUL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (x and y share it).
template <typename Decode>
int launch(const void* x, const void* b, void* y, int G, int M, int K, int N, int dtype,
           int tile_m, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_tiles<float, Decode>(x, b, y, G, M, K, N, tile_m, tile_n, s);
  if (dtype == 1)
    return launch_tiles<__nv_bfloat16, Decode>(x, b, y, G, M, K, N, tile_m, tile_n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tile_matmul

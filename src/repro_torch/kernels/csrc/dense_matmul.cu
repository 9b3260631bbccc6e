// dense_matmul: y = x @ w (+ b), float32 throughout, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves its dense linears
// (repro/core/dense.py, `jnp.dot`) to XLA. It was added because cuBLAS picks
// its algorithm by the row count M, and the summation order with it: on an
// H100 the patch embedding and the Mult expert's down projection gave an
// image's rows other bits alone (M = 196) than among 8 or 32 images, and the
// logits moved by up to 8.8e-4 with the bucket (chip_smoke.py phase [7]).
// Here every output is one chain, fixed by K alone:
//
//     acc = +0; acc = fmaf(x[m][k], w[k][n], acc) for k = 0, 1, ..., K-1;
//     y[m][n] = acc (+ b[n])
//
// whatever M, the block's tile or the grid, so a row's bits never depend
// on the rows beside it.
//
// What bounds it on an H100: float32 operations on the CUDA cores (the
// tensor cores would round x and w to TF32 or bf16). At the serving shapes
// (M = 113 b or 196 b rows, K and N in {48, 128, 256}) the 2·M·K·N
// operations at 67 TFLOP/s outlast the bytes at 3.35 TB/s by about 1.5x.
// Design: one BM x BN output tile per block, each thread a 4 x 4 register
// tile; 16 k at a time of x (transposed, padded against bank conflicts) and
// w staged in shared memory, read back as float4 so each k costs two shared
// loads for 16 FMAs, with the next 16 k loaded into registers while these
// are summed; ragged edges of M, N and K masked (the last k tile's loop
// stops at K, so no padded term enters a chain). The tile, 64 x 64, 32 x 64
// or 32 x 32 (`dense_matmul.launch_tile`: the largest whose grid covers the
// SMs), changes which block sums an output, never the chain.
// The C function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;                                // k staged at once
constexpr int TM = 4;                                 // rows of a thread's tile
constexpr int TN = 4;                                 // columns of a thread's tile
constexpr int XPAD = 4;                               // floats after each xs row
constexpr int MAX_GRID_Y = 65535;

template <int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    dense_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y, int M, int K,
                        int N) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int XL = BM * BK / THREADS;               // x elements a thread loads per k tile
  constexpr int WL = BK * BN / THREADS;               // w elements a thread loads per k tile
  __shared__ __align__(16) float xs[BK][BM + XPAD];   // x tile, k-major
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int col = (tid % (BN / TN)) * TN;             // thread's first column in the tile
  const int row = (tid / (BN / TN)) * TM;             // thread's first row in the tile
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // x: 16 consecutive k of a row per 16 threads (coalesced); w: rows of BN
  // consecutive columns. Element i of a thread is tile entry tid + i·THREADS.
  float xr[XL], wr[WL];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * THREADS, m = m0 + e / BK, k = k0 + e % BK;
      xr[i] = (m < M && k < K) ? x[static_cast<int64_t>(m) * K + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int e = tid + i * THREADS, k = k0 + e / BN, n = n0 + e % BN;
      wr[i] = (k < K && n < N) ? w[static_cast<int64_t>(k) * N + n] : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < XL; ++i) {
      const int e = tid + i * THREADS;
      xs[e % BK][e / BK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WL; ++i) {
      const int e = tid + i * THREADS;
      ws[e / BN][e % BN] = wr[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);                  // in flight while this tile is summed
    const int kn = min(BK, K - k0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk >= kn) break;
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][row]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][col]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + row + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + col + j;
      if (n < N) y[static_cast<int64_t>(m) * N + n] = bias ? acc[i][j] + bias[n] : acc[i][j];
    }
  }
}

template <int BM, int BN>
int launch(const float* x, const float* w, const float* b, float* y, int M, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > MAX_GRID_Y) return static_cast<int>(cudaErrorInvalidValue);
  dense_matmul_kernel<BM, BN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, w, b, y, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row-major, contiguous float32 x (M, K), w (K, N), y (M, N); b (N) or null;
// (tile_m, tile_n) one of (64, 64), (32, 64), (32, 32). Returns the launch's
// cudaError_t.
extern "C" int dense_matmul_launch(const void* x, const void* w, const void* b, void* y,
                                   int M, int K, int N, int tile_m, int tile_n,
                                   void* stream) {
  if (M < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* yf = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (tile_m == 64 && tile_n == 64) return launch<64, 64>(xf, wf, bf, yf, M, K, N, st);
  if (tile_m == 32 && tile_n == 64) return launch<32, 64>(xf, wf, bf, yf, M, K, N, st);
  if (tile_m == 32 && tile_n == 32) return launch<32, 32>(xf, wf, bf, yf, M, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

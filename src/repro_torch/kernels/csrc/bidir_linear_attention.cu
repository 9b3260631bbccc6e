// bidir_binary_attention: non-causal Hamming-code linear attention, per
// batch*head, all in float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `bidir_binary_attention_pallas` (`_make_kernel`) in
// repro/kernels/bidir_linear_attention.py. That kernel holds the whole
// sequence in on-chip memory, which caps N at 4096; this one streams it.
//
//   bq, bk = +1 where q, k >= 0, else -1 (NaN gives -1)
//   KV = bk^T v   (Dk x Dv)   ksum = sum_n bk   vsum = sum_n v
//   out = (bq . KV + d * vsum) / (bq . ksum + d * n + 1e-6)
//
// What bounds it on an H100: memory. Each of q, k, v is read once and out is
// written once (at G = 128, N = 196, d = 32 about 12.8 MB); the contractions
// are +/-1 sums, under a tenth of that time on the float32 cores.
//
// Design (simple and right first):
//   * one block per batch*head; KV, ksum and vsum live in shared memory;
//   * pass 1 streams k and v in tiles of TILE rows: the tile's codes and
//     values are staged in shared memory and every thread adds the tile into
//     the KV entries it owns, one row after another;
//   * pass 2 streams q in the same tiles and emits each output row against
//     the finished KV, ksum and vsum;
//   * every sum runs in a fixed order, so results do not vary from run to run;
//   * no cap on N; Dk and Dv up to 128 (KV then takes 64 KB of dynamic shared
//     memory). The head dim is not padded.
// The C function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;
constexpr int MAX_D = 128;

__device__ __forceinline__ float code(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

__global__ void __launch_bounds__(THREADS)
bidir_binary_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out,
                              int N, int Dk, int Dv) {
  extern __shared__ float smem[];
  float* kv = smem;                  // Dk * Dv
  float* ksum = kv + Dk * Dv;        // Dk
  float* vsum = ksum + Dk;           // Dv
  float* ct = vsum + Dv;             // TILE * Dk codes (bk, then bq)
  float* vt = ct + TILE * Dk;        // TILE * Dv
  float* den = vt + TILE * Dv;       // TILE

  const int tid = threadIdx.x;
  const int64_t g = blockIdx.x;
  const float* qg = q + g * N * Dk;
  const float* kg = k + g * N * Dk;
  const float* vg = v + g * N * Dv;
  float* og = out + g * N * Dv;
  const float d = static_cast<float>(Dk);

  for (int e = tid; e < Dk * Dv; e += THREADS) kv[e] = 0.0f;
  for (int e = tid; e < Dk; e += THREADS) ksum[e] = 0.0f;
  for (int e = tid; e < Dv; e += THREADS) vsum[e] = 0.0f;

  // Pass 1: KV, ksum, vsum.
  for (int n0 = 0; n0 < N; n0 += TILE) {
    const int rows = min(TILE, N - n0);
    __syncthreads();
    for (int e = tid; e < rows * Dk; e += THREADS) ct[e] = code(kg[static_cast<int64_t>(n0) * Dk + e]);
    for (int e = tid; e < rows * Dv; e += THREADS) vt[e] = vg[static_cast<int64_t>(n0) * Dv + e];
    __syncthreads();
    for (int e = tid; e < Dk * Dv; e += THREADS) {
      const int i = e / Dv, j = e % Dv;
      float a = kv[e];
      for (int r = 0; r < rows; ++r) a += ct[r * Dk + i] * vt[r * Dv + j];
      kv[e] = a;
    }
    for (int i = tid; i < Dk; i += THREADS) {
      float a = ksum[i];
      for (int r = 0; r < rows; ++r) a += ct[r * Dk + i];
      ksum[i] = a;
    }
    for (int j = tid; j < Dv; j += THREADS) {
      float a = vsum[j];
      for (int r = 0; r < rows; ++r) a += vt[r * Dv + j];
      vsum[j] = a;
    }
  }

  // Pass 2: emit every row against the finished sums.
  const float dn = d * static_cast<float>(N);
  for (int n0 = 0; n0 < N; n0 += TILE) {
    const int rows = min(TILE, N - n0);
    __syncthreads();
    for (int e = tid; e < rows * Dk; e += THREADS) ct[e] = code(qg[static_cast<int64_t>(n0) * Dk + e]);
    __syncthreads();
    for (int r = tid; r < rows; r += THREADS) {
      float a = 0.0f;
      for (int i = 0; i < Dk; ++i) a += ct[r * Dk + i] * ksum[i];
      den[r] = a + dn;
    }
    __syncthreads();
    for (int e = tid; e < rows * Dv; e += THREADS) {
      const int r = e / Dv, j = e % Dv;
      float a = 0.0f;
      for (int i = 0; i < Dk; ++i) a += ct[r * Dk + i] * kv[i * Dv + j];
      a += d * vsum[j];
      og[static_cast<int64_t>(n0) * Dv + e] = a / (den[r] + 1e-6f);
    }
  }
}

}  // namespace

// q, k: (G, N, Dk) float32; v, out: (G, N, Dv) float32; all contiguous.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for Dk or Dv > 128).
extern "C" int bidir_binary_attention_launch(const void* q, const void* k, const void* v,
                                             void* out, int G, int N, int Dk, int Dv,
                                             void* stream) {
  if (Dk < 1 || Dv < 1 || Dk > MAX_D || Dv > MAX_D || G < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(Dk) * Dv + Dk + Dv + TILE * (Dk + Dv) + TILE);
  cudaError_t err = cudaFuncSetAttribute(bidir_binary_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bidir_binary_attention_kernel<<<G, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), N, Dk, Dv);
  return static_cast<int>(cudaGetLastError());
}

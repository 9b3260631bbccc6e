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
//   * one block per (batch*head, slice of Dv columns): grid (G, ceil(Dv /
//     dvs)). The slice width dvs comes from the wrapper: all of Dv (one
//     slice) when Dv <= 128 and the block fits, else the widest of 64, 32,
//     16, 8 that fits. A 256 x 256 float32 KV (256 KB) is over a block's
//     227 KB; a 64-wide slice of it is 64 KB. KV's slice, ksum, vsum's slice
//     live in shared memory;
//   * pass 1 streams k and the slice's columns of v in tiles of TILE rows:
//     the tile's codes and values are staged in shared memory and every
//     thread adds the tile into the KV entries it owns, one row after
//     another. Every block recomputes the Dk-long ksum (cheap);
//   * pass 2 streams q in the same tiles and emits each output row's slice
//     against the finished KV slice, ksum and vsum slice;
//   * every sum has one owner and runs in a fixed order (rows in order for
//     KV, ksum and vsum, head dim in order for the products), so results do
//     not vary from run to run nor with the slice width; ksum and the
//     denominators are sums of integers, exact;
//   * no cap on N; the head dim is not padded.
// The C function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;
constexpr int SMEM_LIMIT = 232448;   // what a Hopper block can opt in to

__device__ __forceinline__ float code(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// Offset in v or out (row stride Dv) of entry e of a tile of the slice's
// columns (row stride dvs) starting at row n0; a slice that is all of Dv
// keeps the tile's flat offset.
__device__ __forceinline__ int64_t row_offset(int n0, int e, int dvs, int Dv) {
  return static_cast<int64_t>(n0) * Dv + (dvs == Dv ? e : (e / dvs) * Dv + e % dvs);
}

// Shared memory of one block with a slice of dvs columns, in bytes.
// Mirrored by repro_torch.kernels.bidir_linear_attention.smem_bytes.
size_t smem_bytes(int Dk, int dvs) {
  return sizeof(float) *
         (static_cast<size_t>(Dk) * dvs + Dk + dvs + static_cast<size_t>(TILE) * (Dk + dvs) + TILE);
}

template <bool kSliced>
__global__ void __launch_bounds__(THREADS)
bidir_binary_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out,
                              int N, int Dk, int Dv, int DVS) {
  // One slice (all of Dv) compiles to the unsliced kernel.
  const int dv0 = kSliced ? blockIdx.y * DVS : 0;
  const int dvs = kSliced ? min(DVS, Dv - dv0) : Dv;  // this block's columns of v
  extern __shared__ float smem[];
  float* kv = smem;                  // Dk * dvs
  float* ksum = kv + Dk * dvs;       // Dk
  float* vsum = ksum + Dk;           // dvs
  float* ct = vsum + dvs;            // TILE * Dk codes (bk, then bq)
  float* vt = ct + TILE * Dk;        // TILE * dvs
  float* den = vt + TILE * dvs;      // TILE

  const int tid = threadIdx.x;
  const int64_t g = blockIdx.x;
  const float* qg = q + g * N * Dk;
  const float* kg = k + g * N * Dk;
  const float* vg = v + g * N * Dv + dv0;
  float* og = out + g * N * Dv + dv0;
  const float d = static_cast<float>(Dk);

  for (int e = tid; e < Dk * dvs; e += THREADS) kv[e] = 0.0f;
  for (int e = tid; e < Dk; e += THREADS) ksum[e] = 0.0f;
  for (int e = tid; e < dvs; e += THREADS) vsum[e] = 0.0f;

  // Pass 1: KV, ksum, vsum.
  for (int n0 = 0; n0 < N; n0 += TILE) {
    const int rows = min(TILE, N - n0);
    __syncthreads();
    for (int e = tid; e < rows * Dk; e += THREADS) ct[e] = code(kg[static_cast<int64_t>(n0) * Dk + e]);
    for (int e = tid; e < rows * dvs; e += THREADS)
      vt[e] = vg[row_offset(n0, e, dvs, Dv)];
    __syncthreads();
    for (int e = tid; e < Dk * dvs; e += THREADS) {
      const int i = e / dvs, j = e % dvs;
      float a = kv[e];
      for (int r = 0; r < rows; ++r) a += ct[r * Dk + i] * vt[r * dvs + j];
      kv[e] = a;
    }
    for (int i = tid; i < Dk; i += THREADS) {
      float a = ksum[i];
      for (int r = 0; r < rows; ++r) a += ct[r * Dk + i];
      ksum[i] = a;
    }
    for (int j = tid; j < dvs; j += THREADS) {
      float a = vsum[j];
      for (int r = 0; r < rows; ++r) a += vt[r * dvs + j];
      vsum[j] = a;
    }
  }

  // Pass 2: emit every row's slice against the finished sums.
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
    for (int e = tid; e < rows * dvs; e += THREADS) {
      const int r = e / dvs, j = e % dvs;
      float a = 0.0f;
      for (int i = 0; i < Dk; ++i) a += ct[r * Dk + i] * kv[i * dvs + j];
      a += d * vsum[j];
      og[row_offset(n0, e, dvs, Dv)] = a / (den[r] + 1e-6f);
    }
  }
}

}  // namespace

// q, k: (G, N, Dk) float32; v, out: (G, N, Dv) float32; all contiguous.
// dv_slice: the columns of v one block takes (1 <= dv_slice <= Dv); the
// block's shared memory must fit (cudaErrorInvalidValue otherwise).
// Returns the launch's cudaError_t.
extern "C" int bidir_binary_attention_launch(const void* q, const void* k, const void* v,
                                             void* out, int G, int N, int Dk, int Dv,
                                             int dv_slice, void* stream) {
  if (Dk < 1 || Dv < 1 || G < 1 || N < 1 || dv_slice < 1 || dv_slice > Dv)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Dk, dv_slice);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dv_slice < Dv ? bidir_binary_attention_kernel<true>
                               : bidir_binary_attention_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (Dv + dv_slice - 1) / dv_slice);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), N, Dk, Dv, dv_slice);
  return static_cast<int>(cudaGetLastError());
}

// binary_linear_attention: causal chunked Hamming-code linear attention, per
// batch*head, all in float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `binary_linear_attention_pallas` (`_make_kernel`) in
// repro/kernels/linear_attention.py. Per batch*head g and chunk of C rows,
// with the carry (KV, ksum, vsum) of all earlier chunks:
//
//   bq, bk = +1 where q, k >= 0, else -1 (NaN gives -1); d = Dk
//   num_i  = bq_i . KV + d * vsum           den_i = bq_i . ksum + d * c0
//   num_i += sum_{c0 <= j <= i} (bq_i . bk_j + d) v_j
//   den_i += sum_{c0 <= j <= i} (bq_i . bk_j + d)
//   out_i  = num_i / (den_i + 1e-6)
//   then KV += bk^T v, ksum += sum bk, vsum += sum v over the chunk's rows.
//
// What bounds it on an H100: at the serving site (G = 128, N = 196, d = 32)
// the float32 +-1 sums of the causal C x C term, a little more than the
// bytes (each of q, k, v read once, out written once; about 12.8 MB).
//
// Design (simple and right first):
//   * one block per (batch*head, slice of Dv columns) walks the chunks in
//     order; its carry (KV's slice, ksum, vsum's slice) stays in shared
//     memory, as the TPU kernel keeps the carry in VMEM across its
//     sequential grid axis. The slice width dvs comes from the wrapper: all
//     of Dv (one slice, KV 64 KB at Dk = Dv = 128) when Dv <= 128 and the
//     block fits, else the widest of 64, 32, 16, 8 that fits. Every block
//     recomputes the scores, ksum and the denominators (cheap), so each
//     slice's output and carry are what one block over all of Dv would
//     give; the returned state is assembled from the slices (ksum from the
//     first);
//   * the C x C score tile is never formed (256 KB at C = 256, more than a
//     block's 227 KB): each chunk is walked in R = 32 row sub-tiles of
//     queries, and for each, in sub-tiles of keys j <= i; the key codes sit
//     transposed in shared memory so a warp reads neighbouring banks;
//   * rows at or beyond N are never loaded, so nothing past the sequence
//     enters an output or the carry; head dims are not padded;
//   * every sum has one owner thread and a fixed order (inter-chunk term,
//     then key sub-tiles in order, rows in order), so the output is
//     identical run to run. The denominators are sums of integers below
//     2^24, exact in any order.
//   * with return_state the final carry is written out in float32.
// The C function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 32;          // row sub-tile
constexpr int SMEM_LIMIT = 232448;   // what a Hopper block can opt in to

__device__ __forceinline__ float code(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// Offset in v or out (row stride Dv) of entry e of a sub-tile of the
// slice's columns (row stride dvs) starting at row n0; a slice that is all
// of Dv keeps the sub-tile's flat offset.
__device__ __forceinline__ int64_t row_offset(int n0, int e, int dvs, int Dv) {
  return static_cast<int64_t>(n0) * Dv + (dvs == Dv ? e : (e / dvs) * Dv + e % dvs);
}

// Shared memory of one block with a slice of dvs columns, in bytes.
// Mirrored by repro_torch.kernels.linear_attention.smem_bytes.
size_t smem_bytes(int Dk, int dvs) {
  return sizeof(float) * (static_cast<size_t>(Dk) * dvs + Dk + dvs +
                          static_cast<size_t>(R) * (2 * Dk + 2 * dvs) + R * R + R);
}

template <bool kSliced>
__global__ void __launch_bounds__(THREADS)
binary_linear_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ out,
                               float* __restrict__ kv_out, float* __restrict__ ksum_out,
                               float* __restrict__ vsum_out, int N, int Dk, int Dv, int C,
                               int DVS) {
  // One slice (all of Dv) compiles to the unsliced kernel.
  const int dv0 = kSliced ? blockIdx.y * DVS : 0;
  const int dvs = kSliced ? min(DVS, Dv - dv0) : Dv;  // this block's columns of v
  extern __shared__ float smem[];
  float* kv = smem;                  // Dk * dvs, the carry
  float* ksum = kv + Dk * dvs;       // Dk
  float* vsum = ksum + Dk;           // dvs
  float* bq = vsum + dvs;            // R * Dk, query codes, row-major
  float* bkt = bq + R * Dk;          // Dk * R, key codes, transposed
  float* vt = bkt + R * Dk;          // R * dvs
  float* s = vt + R * dvs;           // R * R scores
  float* num = s + R * R;            // R * dvs
  float* den = num + R * dvs;        // R

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

  // Stage key rows [k0, k0 + rows): codes transposed, the slice's values.
  auto stage_keys = [&](int k0, int rows) {
    for (int e = tid; e < rows * Dk; e += THREADS) {
      const int r = e / Dk, i = e % Dk;
      bkt[i * R + r] = code(kg[static_cast<int64_t>(k0) * Dk + e]);
    }
    for (int e = tid; e < rows * dvs; e += THREADS)
      vt[e] = vg[row_offset(k0, e, dvs, Dv)];
  };

  for (int c0 = 0; c0 < N; c0 += C) {
    const int cend = min(c0 + C, N);
    for (int q0 = c0; q0 < cend; q0 += R) {
      const int qr = min(R, cend - q0);
      __syncthreads();
      for (int e = tid; e < qr * Dk; e += THREADS) bq[e] = code(qg[static_cast<int64_t>(q0) * Dk + e]);
      __syncthreads();
      // Inter-chunk terms from the carry.
      for (int e = tid; e < qr * dvs; e += THREADS) {
        const int r = e / dvs, j = e % dvs;
        float a = 0.0f;
        for (int i = 0; i < Dk; ++i) a += bq[r * Dk + i] * kv[i * dvs + j];
        num[e] = a + d * vsum[j];
      }
      for (int r = tid; r < qr; r += THREADS) {
        float a = 0.0f;
        for (int i = 0; i < Dk; ++i) a += bq[r * Dk + i] * ksum[i];
        den[r] = a + d * static_cast<float>(c0);
      }
      // Intra-chunk causal term, one key sub-tile at a time (j <= i).
      for (int k0 = c0; k0 <= q0; k0 += R) {
        const int kr = min(R, cend - k0);
        __syncthreads();
        stage_keys(k0, kr);
        __syncthreads();
        for (int e = tid; e < qr * R; e += THREADS) {
          const int r = e / R, c = e % R;
          float a = 0.0f;
          if (c < kr && k0 + c <= q0 + r) {
            for (int i = 0; i < Dk; ++i) a += bq[r * Dk + i] * bkt[i * R + c];
            a += d;
          }
          s[e] = a;
        }
        __syncthreads();
        for (int e = tid; e < qr * dvs; e += THREADS) {
          const int r = e / dvs, j = e % dvs;
          float a = num[e];
          for (int c = 0; c < kr; ++c) a += s[r * R + c] * vt[c * dvs + j];
          num[e] = a;
        }
        for (int r = tid; r < qr; r += THREADS) {
          float a = den[r];
          for (int c = 0; c < kr; ++c) a += s[r * R + c];
          den[r] = a;
        }
      }
      __syncthreads();
      for (int e = tid; e < qr * dvs; e += THREADS)
        og[row_offset(q0, e, dvs, Dv)] = num[e] / (den[e / dvs] + 1e-6f);
    }
    // Carry update with the chunk's rows, after its outputs.
    for (int k0 = c0; k0 < cend; k0 += R) {
      const int kr = min(R, cend - k0);
      __syncthreads();
      stage_keys(k0, kr);
      __syncthreads();
      for (int e = tid; e < Dk * dvs; e += THREADS) {
        const int i = e / dvs, j = e % dvs;
        float a = kv[e];
        for (int r = 0; r < kr; ++r) a += bkt[i * R + r] * vt[r * dvs + j];
        kv[e] = a;
      }
      for (int i = tid; i < Dk; i += THREADS) {
        float a = ksum[i];
        for (int r = 0; r < kr; ++r) a += bkt[i * R + r];
        ksum[i] = a;
      }
      for (int j = tid; j < dvs; j += THREADS) {
        float a = vsum[j];
        for (int r = 0; r < kr; ++r) a += vt[r * dvs + j];
        vsum[j] = a;
      }
    }
  }

  if (kv_out != nullptr) {
    __syncthreads();
    for (int e = tid; e < Dk * dvs; e += THREADS) {
      const int i = e / dvs, j = e % dvs;
      kv_out[(g * Dk + i) * Dv + dv0 + j] = kv[e];
    }
    if (blockIdx.y == 0)
      for (int e = tid; e < Dk; e += THREADS) ksum_out[g * Dk + e] = ksum[e];
    for (int e = tid; e < dvs; e += THREADS) vsum_out[g * Dv + dv0 + e] = vsum[e];
  }
}

}  // namespace

// q, k: (G, N, Dk) float32; v, out: (G, N, Dv) float32; all contiguous.
// kv_out (G, Dk, Dv), ksum_out (G, Dk), vsum_out (G, Dv): all three null, or
// all three set to receive the final carry. chunk: rows per chunk, >= 1.
// dv_slice: the columns of v one block takes (1 <= dv_slice <= Dv); the
// block's shared memory must fit (cudaErrorInvalidValue otherwise).
// Returns the launch's cudaError_t.
extern "C" int binary_linear_attention_launch(const void* q, const void* k, const void* v,
                                              void* out, void* kv_out, void* ksum_out,
                                              void* vsum_out, int G, int N, int Dk, int Dv,
                                              int chunk, int dv_slice, void* stream) {
  if (Dk < 1 || Dv < 1 || G < 1 || N < 1 || chunk < 1 || dv_slice < 1 || dv_slice > Dv)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool state = kv_out != nullptr;
  if (state != (ksum_out != nullptr) || state != (vsum_out != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Dk, dv_slice);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dv_slice < Dv ? binary_linear_attention_kernel<true>
                               : binary_linear_attention_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, (Dv + dv_slice - 1) / dv_slice);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(kv_out), static_cast<float*>(ksum_out),
      static_cast<float*>(vsum_out), N, Dk, Dv, chunk, dv_slice);
  return static_cast<int>(cudaGetLastError());
}

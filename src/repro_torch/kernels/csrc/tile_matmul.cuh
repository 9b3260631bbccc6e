// tile_matmul.cuh: the bf16 tensor-core product that shift_matmul.cu,
// add_matmul.cu and add_matmul_packed.cu share, designed for Hopper (sm_90a).
// y[g] = x[g] @ B[g], where x (G, M, K) is float32 or bf16 and B (G, K, N) is
// stored in a compact form that a Decode policy turns into exact bf16 values
// (a power of two from one byte, +-1/0 from an int8, +-1 from one bit).
//
// What bounds it on an H100: memory. At the serving shapes (K, N <= 256) each
// x element is used at most 256 times, below the ~295 bf16 operations per
// byte at which the tensor cores become the limit, and x and y in float32
// are almost all of the bytes. So the design keeps HBM busy and spends
// nothing on the weight:
//
//   * one block of 4 warps owns one slice of BN output columns of one batch
//     entry g, and walks the M tiles blockIdx.y, blockIdx.y + gridDim.y, ...
//     (a persistent grid: about as many blocks as the SMs hold at once);
//   * the block fetches the raw bytes of its whole K x BN panel of B with
//     asynchronous copies ahead of its first two x tiles, decodes the panel
//     in shared memory once as soon as it has landed, while x still arrives
//     (byte permutes and integer ops, in place: the raw bytes sit at the end
//     of the decoded panel's space), and keeps it for every M tile it walks;
//   * x streams through a ring of two stages with 16-byte cp.async copies:
//     each stage holds one BM x K tile (the whole K extent, up to 256), so
//     the next tile is in flight while the current one is multiplied, and
//     one barrier per tile suffices. A ragged K tail is zeroed in shared
//     memory; rows past M are zero-filled by the copy;
//   * each warp multiplies a 16-row x (BN / warps across) sub-tile with
//     mma.sync m16n8k16 (bf16 in, float32 sums): the A fragment is read from
//     the float32 stage and rounded to bf16 (round to nearest even) in
//     registers, the B fragments come from the decoded panel by
//     ldmatrix.trans. Row strides are padded by 8 elements, so neither read
//     has bank conflicts;
//   * the output leaves from the accumulator registers as float2 (bf16x2)
//     stores, with no trip through shared memory;
//   * a batched product with a small M (the attention's K^T V, 32 x 196 x 32
//     per batch*head) gets its own launch shape from the same code: the
//     wrapper shrinks the tile to M and N, so one block takes one batch*head
//     and brings its whole K extent of x and of B in with one barrier.
//
// Why mma.sync and not wgmma: at these shapes the work is bytes-bound (a
// 64-row wgmma tile would leave the 32-row ktv product half masked and adds
// descriptor and swizzle constraints for no gain in bytes); mma.sync keeps
// every tile from 16 rows up and lets A come straight from registers after
// the bf16 rounding.
//
// The contract the port relies on: every output element is one fixed chain
// of 16-deep tensor-core steps in K order into one float32 accumulator, from
// k = 0 to the end of K rounded up to 16. K longer than 256 is taken in
// chunks of 256 whose boundaries depend on K alone, one after another into
// the same accumulator. Nothing in the chain depends on M, the tile, the
// grid or the block's position, so a row's output is the same at M = 1 and
// M = 6272 and every tile gives the same bits. There is no split-K.
//
// A policy has `kBatched` (false when G is always 1), `kRows` (rows of B per
// stored row: 1 for a byte per element, 8 for a bit) and
// `decode4(uint32_t, uint2 (&)[kRows])`: four stored bytes of one stored row
// (columns n .. n+3) to kRows x 4 bf16 values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace tile_matmul {

constexpr int THREADS = 128;   // 4 warps
constexpr int KC = 256;        // K held per chunk (the whole K up to 256)
constexpr int STAGES = 2;      // x tiles in the ring
constexpr int PAD = 8;         // elements added to every shared row

__host__ __device__ constexpr int round16(int k) { return (k + 15) / 16 * 16; }

// Shared memory of one block, in bytes: the decoded B panel (kc x BN bf16)
// and the x ring (STAGES x BM x kc elements), kc = min(K rounded up to 16,
// KC). Mirrored by repro_torch.kernels.tile_matmul.smem_bytes.
template <typename T, int BM, int BN>
__host__ __device__ constexpr int smem_bytes(int kc) {
  return kc * (BN + PAD) * 2 + STAGES * BM * (kc + PAD) * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of mma.m16n8k16 (row-major 16 x 16) from the x stage at row r0,
// column c0: float32 is rounded to bf16 here, in registers.
__device__ __forceinline__ void load_a(const float* xs, int ldx, int r0, int c0, int lane,
                                       uint32_t (&a)[4]) {
  const float* p = xs + (r0 + (lane >> 2)) * ldx + c0 + (lane & 3) * 2;
  const float2 v00 = *reinterpret_cast<const float2*>(p);
  const float2 v10 = *reinterpret_cast<const float2*>(p + 8 * ldx);
  const float2 v01 = *reinterpret_cast<const float2*>(p + 8);
  const float2 v11 = *reinterpret_cast<const float2*>(p + 8 * ldx + 8);
  a[0] = pack_bf16x2(v00.x, v00.y);
  a[1] = pack_bf16x2(v10.x, v10.y);
  a[2] = pack_bf16x2(v01.x, v01.y);
  a[3] = pack_bf16x2(v11.x, v11.y);
}
__device__ __forceinline__ void load_a(const __nv_bfloat16* xs, int ldx, int r0, int c0,
                                       int lane, uint32_t (&a)[4]) {
  const __nv_bfloat16* p = xs + (r0 + (lane >> 2)) * ldx + c0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ldx);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ldx + 8);
}

__device__ __forceinline__ void ldmatrix_x4_trans(const void* p, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(const void* p, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (second) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (second) p[1] = __float2bfloat16_rn(b);
  }
}

// Decode stored rows [kr0, kr0 + rows) of B, columns [n0, n0 + BN), into
// the bf16 panel Bs (row stride BN + PAD), zero outside the krows x N
// operand, straight from global memory: the path for an operand that 16-byte
// copies cannot fetch (N not a multiple of 16, or misaligned). Four stored
// bytes per unit (one 32-bit load where it is in range and aligned, else
// byte loads); each thread loads UNROLL units before it decodes any, so
// their loads are in flight together.
template <typename Decode, int BN>
__device__ __forceinline__ void decode_panel(const uint8_t* __restrict__ bg, int krows, int N,
                                             int n0, int kr0, int rows,
                                             __nv_bfloat16* __restrict__ Bs, int tid) {
  constexpr int UNROLL = 8;
  constexpr int UNITS_N = BN / 4;
  constexpr int LDB = BN + PAD;
  const int units = rows * UNITS_N;
  const bool aligned4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(bg) % 4 == 0;
  for (int base = tid; base < units; base += THREADS * UNROLL) {
    uint32_t word[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int u = base + i * THREADS;
      const int kr = kr0 + u / UNITS_N, n = n0 + (u % UNITS_N) * 4;
      word[i] = 0;
      if (u >= units || kr >= krows || n >= N) continue;
      const uint8_t* p = bg + static_cast<int64_t>(kr) * N + n;
      if (aligned4 && n + 3 < N) {
        word[i] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
        for (int j = 0; j < 4; ++j)
          if (n + j < N) word[i] |= static_cast<uint32_t>(__ldg(p + j)) << (8 * j);
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int u = base + i * THREADS;
      if (u >= units) break;
      const int rl = u / UNITS_N, nl = (u % UNITS_N) * 4;
      const int n = n0 + nl;
      const bool row_in = kr0 + rl < krows;
      uint2 out[Decode::kRows];
      Decode::decode4(word[i], out);
      const uint32_t keep_lo =
          row_in ? (n < N ? 0xFFFFu : 0u) | (n + 1 < N ? 0xFFFF0000u : 0u) : 0u;
      const uint32_t keep_hi =
          row_in ? (n + 2 < N ? 0xFFFFu : 0u) | (n + 3 < N ? 0xFFFF0000u : 0u) : 0u;
#pragma unroll
      for (int r = 0; r < Decode::kRows; ++r)
        *reinterpret_cast<uint2*>(Bs + (rl * Decode::kRows + r) * LDB + nl) =
            make_uint2(out[r].x & keep_lo, out[r].y & keep_hi);
    }
  }
}

// Decode the stored rows [0, rows) of B that an asynchronous copy put, raw,
// at `raw` (row stride BN bytes; zeros where the copy had nothing to fetch)
// into the bf16 panel Bs (row stride BN + PAD), in place: the raw bytes sit
// at the end of the panel's own space, and every batch of rows is read into
// registers, then a barrier, then written decoded, then a barrier. A decoded
// row r ends at (r + 1) (2 BN + 16) bytes, never past the raw bytes of the
// rows after it, so no batch overwrites bytes a later batch still reads.
// Rows at or past `krows` and columns at or past N decode to zero. Every
// thread of the block calls it.
template <typename Decode, int BN>
__device__ __forceinline__ void decode_raw(const uint8_t* raw, int kr0, int rows, int krows,
                                           int N, int n0, __nv_bfloat16* Bs, int tid) {
  constexpr int UNROLL = 8;
  constexpr int UNITS_N = BN / 16;     // 16 stored bytes per unit
  constexpr int LDB = BN + PAD;
  const int units = rows * UNITS_N;
  for (int base = 0; base < units; base += THREADS * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int u = base + i * THREADS + tid;
      if (u < units)
        v[i] = *reinterpret_cast<const uint4*>(raw + (u / UNITS_N) * BN + (u % UNITS_N) * 16);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int u = base + i * THREADS + tid;
      if (u >= units) break;
      const int rl = u / UNITS_N, nl = (u % UNITS_N) * 16;
      const uint32_t keep = (kr0 + rl < krows && n0 + nl < N) ? 0xFFFFFFFFu : 0u;
      const uint32_t word[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint2 out[Decode::kRows];
        Decode::decode4(word[w], out);
#pragma unroll
        for (int r = 0; r < Decode::kRows; ++r)
          *reinterpret_cast<uint2*>(Bs + (rl * Decode::kRows + r) * LDB + nl + 4 * w) =
              make_uint2(out[r].x & keep, out[r].y & keep);
      }
    }
    __syncthreads();
  }
}

template <typename T, int BM, int BN, typename Decode>
__global__ void __launch_bounds__(THREADS)
tile_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ b, T* __restrict__ y,
                   int M, int K, int N, bool x_vec, bool b_vec16) {
  constexpr int WARPS_M = BM / 16;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WN = BN / WARPS_N;     // columns of one warp
  constexpr int NT = WN / 8;           // n8 tiles of one warp
  constexpr int LDB = BN + PAD;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));   // x elements per 16-byte copy
  static_assert(WARPS_M * WARPS_N == 4 && NT >= 1, "tile shape");

  const int Kp = round16(K);
  const int kc = Kp < KC ? Kp : KC;     // shared row length of the chunk
  const int nchunks = (Kp + KC - 1) / KC;
  const int ldx = kc + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);
  T* Xs = reinterpret_cast<T*>(smem + kc * LDB * 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN;
  const int64_t g = blockIdx.z;
  const int m_tiles = (M + BM - 1) / BM;
  // An unbatched product (shift_matmul) skips the batch offset.
  const T* xg = Decode::kBatched ? x + g * M * K : x;
  T* yg = Decode::kBatched ? y + g * M * N : y;
  const int krows = K / Decode::kRows;  // stored rows of B per batch entry
  const uint8_t* bg = Decode::kBatched ? b + g * krows * static_cast<int64_t>(N) : b;

  // B rows [c * KC, c * KC + kw) x columns [n0, n0 + BN), decoded to bf16
  // in Bs; zero outside K x N. Where the operand allows 16-byte copies
  // (b_vec16), its raw bytes are first fetched asynchronously, ahead of x,
  // into the end of the panel's space (fetch_b), and decoded there once they
  // have landed (decode_b); otherwise decode_b loads and decodes them itself.
  uint8_t* raw = reinterpret_cast<uint8_t*>(Bs) + kc * LDB * 2 - kc / Decode::kRows * BN;
  auto fetch_b = [&](int c, int kw) {
    constexpr int PER_ROW = BN / 16;
    const int kr0 = c * KC / Decode::kRows;
    const int pieces = kw / Decode::kRows * PER_ROW;
    for (int i = tid; i < pieces; i += THREADS) {
      const int r = i / PER_ROW, n = n0 + (i % PER_ROW) * 16;
      const bool valid = kr0 + r < krows && n < N;
      const uint8_t* src = valid ? bg + static_cast<int64_t>(kr0 + r) * N + n : bg;
      cp_async16(raw + r * BN + (i % PER_ROW) * 16, src, valid);
    }
  };
  auto decode_b = [&](int c, int kw) {
    const int kr0 = c * KC / Decode::kRows;
    const int rows = kw / Decode::kRows;
    if (b_vec16) {
      decode_raw<Decode, BN>(raw, kr0, rows, krows, N, n0, Bs, tid);
    } else {
      decode_panel<Decode, BN>(bg, krows, N, n0, kr0, rows, Bs, tid);
    }
  };

  // Stage x rows [t * BM, t * BM + BM), columns [c * KC, c * KC + kw) into
  // the ring's stage s: 16-byte async copies where rows are 16-byte aligned,
  // else element by element; zeros past M and past K.
  auto load_x = [&](int s, int t, int c, int kw) {
    T* dst = Xs + s * BM * ldx;
    const int kbeg = c * KC;
    const int kvalid = min(K - kbeg, kw);
    const int m0 = t * BM;
    if (x_vec) {
      const int per_row = kvalid / VEC;
      for (int i = tid; i < BM * per_row; i += THREADS) {
        const int r = i / per_row, p = i % per_row;
        const bool valid = m0 + r < M;
        const T* src = valid ? xg + static_cast<int64_t>(m0 + r) * K + kbeg + p * VEC : xg;
        cp_async16(dst + r * ldx + p * VEC, src, valid);
      }
      const int tail = kw - kvalid;
      for (int i = tid; i < BM * tail; i += THREADS)
        dst[(i / tail) * ldx + kvalid + i % tail] = T(0.0f);
    } else {
      for (int i = tid; i < BM * kw; i += THREADS) {
        const int r = i / kw, col = i % kw;
        dst[r * ldx + col] = (m0 + r < M && col < kvalid)
                                 ? xg[static_cast<int64_t>(m0 + r) * K + kbeg + col]
                                 : T(0.0f);
      }
    }
  };

  // The K steps of one chunk in order. Eight steps at a time are unrolled
  // so that the next steps' fragment loads are in flight during this step's
  // products; a loop over a run-time count is left rolled by the compiler,
  // and each step then waits on its own loads.
  auto mma_chunk = [&](float (&acc)[NT][4], int s, int kw) {
    const T* xs = Xs + s * BM * ldx;
    const int bcol = wn * WN + (lane >> 4) * 8;
    const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
    auto step = [&](int k0) {
      uint32_t a[4];
      load_a(xs, ldx, wm * 16, k0, lane, a);
#pragma unroll
      for (int j = 0; j + 1 < NT; j += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(Bs + (k0 + brow) * LDB + bcol + j * 8, b0, b1, b2, b3);
        mma_bf16(acc[j], a, b0, b1);
        mma_bf16(acc[j + 1], a, b2, b3);
      }
      if constexpr (NT % 2 == 1) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(Bs + (k0 + brow) * LDB + wn * WN + (NT - 1) * 8, b0, b1);
        mma_bf16(acc[NT - 1], a, b0, b1);
      }
    };
    int k0 = 0;
    for (; k0 + 128 <= kw; k0 += 128) {
#pragma unroll
      for (int kk = 0; kk < 128; kk += 16) step(k0 + kk);
    }
    for (; k0 < kw; k0 += 16) step(k0);
  };

  auto store_tile = [&](const float (&acc)[NT][4], int t) {
    const int row = t * BM + wm * 16 + (lane >> 2);
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn * WN + j * 8 + (lane & 3) * 2;
      if (col >= N) continue;
      const bool second = col + 1 < N;
      if (row < M)
        store2(yg + static_cast<int64_t>(row) * N + col, acc[j][0], acc[j][1], pairs, second);
      if (row + 8 < M)
        store2(yg + static_cast<int64_t>(row + 8) * N + col, acc[j][2], acc[j][3], pairs,
               second);
    }
  };

  const int t0 = blockIdx.y, dt = gridDim.y;
  const int my_tiles = t0 < m_tiles ? (m_tiles - t0 + dt - 1) / dt : 0;

  if (nchunks == 1) {
    // B's raw bytes, then the first x tiles, are put in flight; B is
    // decoded once as soon as it has landed, while x still arrives; x tiles
    // stream through the two-stage ring.
    if (b_vec16) fetch_b(0, kc);
    cp_async_commit();
    for (int j = 0; j < STAGES; ++j) {
      if (j < my_tiles) load_x(j, t0 + j * dt, 0, kc);
      cp_async_commit();
    }
    cp_async_wait<STAGES>();
    __syncthreads();
    decode_b(0, kc);
    for (int j = 0; j < my_tiles; ++j) {
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      float acc[NT][4] = {};
      mma_chunk(acc, j % STAGES, kc);
      store_tile(acc, t0 + j * dt);
      __syncthreads();
      if (j + STAGES < my_tiles) load_x(j % STAGES, t0 + (j + STAGES) * dt, 0, kc);
      cp_async_commit();
    }
  } else {
    // K longer than one chunk: per tile, the chunks in K order into one
    // accumulator, each with its own decoded panel.
    for (int j = 0; j < my_tiles; ++j) {
      float acc[NT][4] = {};
      for (int c = 0; c < nchunks; ++c) {
        const int kw = min(KC, Kp - c * KC);
        __syncthreads();
        if (b_vec16) fetch_b(c, kw);
        load_x(0, t0 + j * dt, c, kw);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        decode_b(c, kw);
        __syncthreads();
        mma_chunk(acc, 0, kw);
      }
      store_tile(acc, t0 + j * dt);
    }
  }
}

// Blocks of one instantiation that an SM holds at once with `smem` bytes,
// memoized per instantiation (the last shared-memory size asked for).
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem, std::atomic<long long>& memo) {
  const long long m = memo.load(std::memory_order_relaxed);
  if (m >= 0 && (m >> 8) == smem) return static_cast<int>(m & 0xFF);
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem) != cudaSuccess)
    occ = 1;
  occ = occ < 1 ? 1 : (occ > 255 ? 255 : occ);
  memo.store((static_cast<long long>(smem) << 8) | occ, std::memory_order_relaxed);
  return occ;
}

template <typename T, int BM, int BN, typename Decode>
int launch_tile(const void* x, const void* b, void* y, int G, int M, int K, int N,
                cudaStream_t stream) {
  auto kernel = tile_matmul_kernel<T, BM, BN, Decode>;
  constexpr int max_smem = smem_bytes<T, BM, BN>(KC);
  static_assert(max_smem <= 232448, "a block must fit the SM's shared memory");
  // Once per instantiation: more than 48 KB only as opted-in dynamic smem.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static std::atomic<long long> memo{-1};

  const int Kp = round16(K);
  const int smem = smem_bytes<T, BM, BN>(Kp < KC ? Kp : KC);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Persistent grid over M: about as many blocks as the SMs hold at once,
  // each walking an equal share of the M tiles.
  const int m_tiles = (M + BM - 1) / BM;
  const int n_slices = (N + BN - 1) / BN;
  const long long resident = static_cast<long long>(sms) * blocks_per_sm(kernel, smem, memo);
  const long long per_m = static_cast<long long>(G) * n_slices;
  long long m_blocks = (resident + per_m - 1) / per_m;
  m_blocks = m_blocks < 1 ? 1 : (m_blocks > m_tiles ? m_tiles : m_blocks);
  const long long per_block = (m_tiles + m_blocks - 1) / m_blocks;
  m_blocks = (m_tiles + per_block - 1) / per_block;

  constexpr int VEC_BYTES = 16;
  const bool x_vec = (static_cast<long long>(K) * sizeof(T)) % VEC_BYTES == 0 &&
                     reinterpret_cast<uintptr_t>(x) % VEC_BYTES == 0;
  const bool b_vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid(n_slices, static_cast<unsigned>(m_blocks), G);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const uint8_t*>(b), static_cast<T*>(y),
                                          M, K, N, x_vec, b_vec16);
  return static_cast<int>(cudaGetLastError());
}

// The tile shapes built: (tile_m, tile_n). Mirrored by
// repro_torch.kernels.tile_matmul.TILES.
template <typename T, typename Decode>
int launch_tiles(const void* x, const void* b, void* y, int G, int M, int K, int N,
                 int tile_m, int tile_n, cudaStream_t s) {
#define TILE_MATMUL_CASE(TM, TN) \
  if (tile_m == TM && tile_n == TN) return launch_tile<T, TM, TN, Decode>(x, b, y, G, M, K, N, s);
  TILE_MATMUL_CASE(16, 32) TILE_MATMUL_CASE(16, 64) TILE_MATMUL_CASE(16, 128)
  TILE_MATMUL_CASE(16, 256) TILE_MATMUL_CASE(32, 32) TILE_MATMUL_CASE(32, 64)
  TILE_MATMUL_CASE(32, 128) TILE_MATMUL_CASE(32, 256) TILE_MATMUL_CASE(64, 32)
  TILE_MATMUL_CASE(64, 64) TILE_MATMUL_CASE(64, 128)
#undef TILE_MATMUL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (x and y share it).
template <typename Decode>
int launch(const void* x, const void* b, void* y, int G, int M, int K, int N, int dtype,
           int tile_m, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 65535 || M < 1 || K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_tiles<float, Decode>(x, b, y, G, M, K, N, tile_m, tile_n, s);
  if (dtype == 1)
    return launch_tiles<__nv_bfloat16, Decode>(x, b, y, G, M, K, N, tile_m, tile_n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tile_matmul

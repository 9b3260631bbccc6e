// binary_linear_attention: causal chunked Hamming-code linear attention, per
// batch*head, all in float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `binary_linear_attention_pallas` (`_make_kernel`) in
// repro/kernels/linear_attention.py. Per batch*head g and chunk of C rows
// starting at c0, with the carry (KV, ksum, vsum) of all earlier chunks:
//
//   bq, bk = +1 where q, k >= 0, else -1 (NaN gives -1); d = Dk
//   num_i  = bq_i . KV + d * vsum           den_i = bq_i . ksum + d * c0
//   num_i += sum_{c0 <= j <= i} w_ij v_j    den_i += sum_{c0 <= j <= i} w_ij
//   w_ij   = bq_i . bk_j + d = 2 (d - hamming(bq_i, bk_j))
//   out_i  = num_i / (den_i + 1e-6)
//   then KV += bk^T v, ksum += sum bk, vsum += sum v over the chunk's rows.
//
// What bounds it on an H100: at the autotune site (G = 128, N = 196, d = 32)
// the bytes (each of q, k, v read once, out written once, 12.8 MB); at long
// N and wide heads (G = 32, N = 4096, d = 128) the float32 operations of the
// carry and of w . v. The TPU kernel walks the chunks of a batch*head in
// order with the carry in VMEM; on this card one block per batch*head leaves
// most SMs idle, so the work is split into passes, each its own launch:
//
//   1. codes (grid: 32-row groups of q and of k): each row's signs packed
//      32 to a word with __ballot_sync into a (2, G, N, W) workspace,
//      W = ceil(Dk / 32). q and k are read once, here alone;
//   2. partials (grid: chunk x batch*head, Dv slice, word of head dims): the
//      chunk's own bk^T v for 32 rows of KV, sum bk and sum v, over the
//      chunk's rows in row order, into a record of (Dk*Dv + Dk + Dv) floats
//      per (batch*head, chunk). Only chunks that have a successor get a
//      record, and the last chunk too when the final state is asked for;
//   3. scan (grid: record entries x batch*head): the inclusive prefix over
//      the records in chunk order, in place, one thread per entry: record
//      c becomes the carry after chunk c, formed once, whatever reads it;
//      with return_state the last one is the final state. Skipped when one
//      record alone is the carry;
//   4. out (grid: query tile x batch*head, Dv slice): a block takes 32 query
//      rows of one chunk. It streams the carry's KV rows, then the chunk's
//      key tiles up to its own (rows of v and the keys' codes), through a
//      four-stage ring (three for the widest slices), 32 rows a stage;
//      while it sums one key tile it forms
//      the next one's weights w = 2 (Dk - popcount(bq ^ bk)), exact integer
//      arithmetic, 32 head dims an operation, no tensor cores.
//
// Every tile comes through cp.async (16-byte copies when every row is
// 16-byte aligned, else 4-byte), into rings with one barrier a stage. A
// thread keeps one tile of sums in registers: 2 x 4 where a block's slice is
// at most 32 columns, 4 x 4 up to 64, 4 x 8 up to 128, so that a warp reads
// a stretch of a v row and a few rows of weights per step. Every sum has one
// fixed order, fixed by N, the chunk and the head dims: a record entry sums
// its chunk's rows in order, a carry sums the records in chunk order, and an
// output entry sums bq . KV over the head dim in order, then d * vsum, then
// w . v over the keys in order. The query tiles, the Dv slice width, the
// register tile, G and the grid change no bit. The denominators and ksum
// are sums of integers, exact. Rows at or past N are never loaded, and the
// head dims are not padded in device memory.
//
// The partition (chunk, rows per tile, tiles per chunk, tiles, records) and
// the Dv slice come from the wrapper (repro_torch.kernels.linear_attention.
// launch_args); the C function checks them and returns the first launch
// error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 32;             // rows of a query tile, a key tile, a ring stage
constexpr int MAX_SLICE = 128;       // the widest Dv slice
constexpr int STAGES = 3;            // ring stages of the partials pass
constexpr int CODE_ROWS = 32;        // rows of q or k a codes block packs
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_BATCH = 8;        // records a scan thread loads before it adds
constexpr int SMEM_LIMIT = 232448;   // what a Hopper block can opt in to
constexpr unsigned FULL = 0xffffffffu;
static_assert(ROWS == 32, "a ring stage of head dims is one word of codes");

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* kv_out;
  float* ksum_out;
  float* vsum_out;
  float* work;                       // (G, records, E) carry records
  unsigned* codes;                   // (2, G, N, W): query codes, then key codes
  int G, N, Dk, Dv, chunk, per, tiles, records, DVS, W;
  int vec;                           // 16-byte copies: every row 16-byte aligned
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// The row pitch, in floats, of a slice of dvs columns in shared memory.
__host__ __device__ __forceinline__ int pitch_of(int dvs) { return (dvs + 7) & ~7; }

// Ring stages of the output pass at a pitch of vp: a load is started
// stages - 2 steps before it is needed. Narrow slices take short steps and
// small stages, so they keep more in flight; the widest take long steps and
// would hold two blocks an SM with more.
constexpr int NARROW_STAGES = 4;
__host__ __device__ __forceinline__ constexpr int out_stages(int vp) {
  return vp <= 32 ? NARROW_STAGES : vp <= 64 ? 4 : 3;
}

// Floats of one (batch*head, chunk) record: KV (Dk x Dv), ksum, vsum.
__host__ __device__ __forceinline__ int64_t record(int Dk, int Dv) {
  return static_cast<int64_t>(Dk) * Dv + Dk + Dv;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Wait until at most n loads (0 to 6) are pending.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// N consecutive floats from shared memory, N = 2, 4 or 8 (aligned to N).
template <int N>
__device__ __forceinline__ void load(float (&x)[N], const float* p) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int h = 0; h < N; h += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + h);
      x[h] = t.x, x[h + 1] = t.y, x[h + 2] = t.z, x[h + 3] = t.w;
    }
  }
}

// +1 where bit b of word is set (the code of x >= 0), else -1.
__device__ __forceinline__ float sign_of(unsigned word, int b) {
  return (word >> b) & 1u ? 1.0f : -1.0f;
}

// Copy `rows` rows of `width` 4-byte words (device row stride `stride`) into
// shared memory at row pitch `pitch`: 16-byte copies when `vec` (every source
// row 16-byte aligned, width and pitch multiples of 4), else 4-byte ones.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int pitch, const T* src, int64_t stride,
                                          int rows, int width, bool vec) {
  if (vec) {
    const int w4 = width >> 2;
    for (int e = threadIdx.x; e < rows * w4; e += THREADS) {
      const int r = e / w4, c = (e - r * w4) << 2;
      cp_async16(dst + r * pitch + c, src + r * stride + c);
    }
  } else {
    for (int e = threadIdx.x; e < rows * width; e += THREADS) {
      const int r = e / width, c = e - r * width;
      cp_async4(dst + r * pitch + c, src + r * stride + c);
    }
  }
}

// This thread's tile of sums in a block of 32 rows x vp columns: rows
// i .. i + kTI - 1, columns j .. j + kTJ - 1; a warp's lanes take
// neighbouring column groups first. Off for the threads past the block.
template <int kTI, int kTJ>
struct Tile {
  int i, j;
  bool on;
  __device__ __forceinline__ explicit Tile(int vp) {
    const int groups = vp / kTJ;
    i = (threadIdx.x / groups) * kTI;
    j = (threadIdx.x % groups) * kTJ;
    on = i < ROWS;
  }
};

// Shared memory of each tiled pass's block, in 4-byte words, at a slice of
// dvs columns. Mirrored by repro_torch.kernels.linear_attention.smem_bytes.
size_t partials_words(int dvs) { return STAGES * ROWS * (pitch_of(dvs) + 1); }

size_t out_words(int Dk, int dvs) {
  const size_t vp = pitch_of(dvs), wp = ((Dk + 31) / 32) | 1;
  return out_stages(vp) * ROWS * (vp + wp) + 2 * ROWS * ROWS + round4(Dk) + vp + 4 * ROWS +
         ROWS * wp;
}

// Pass 1: the codes of 32 rows of q (blockIdx.y = 0) or k (1), starting at
// row 32 * blockIdx.x of the (G * N) rows.
__global__ void __launch_bounds__(THREADS) binary_linear_attention_codes_kernel(const Args a) {
  constexpr int PER_WARP = CODE_ROWS / (THREADS / 32);
  const int64_t rows = static_cast<int64_t>(a.G) * a.N;
  const float* x = blockIdx.y == 0 ? a.q : a.k;
  unsigned* dst = a.codes + blockIdx.y * rows * a.W;
  const int lane = threadIdx.x & 31;
  const int64_t r0 =
      static_cast<int64_t>(blockIdx.x) * CODE_ROWS + (threadIdx.x >> 5) * PER_WARP;
  for (int w = 0; w < a.W; ++w) {
    const int col = w * 32 + lane;
    float f[PER_WARP];
#pragma unroll
    for (int m = 0; m < PER_WARP; ++m)
      f[m] = r0 + m < rows && col < a.Dk ? x[(r0 + m) * a.Dk + col] : -1.0f;
#pragma unroll
    for (int m = 0; m < PER_WARP; ++m) {
      const unsigned word = __ballot_sync(FULL, f[m] >= 0.0f);
      if (lane == 0 && r0 + m < rows) dst[(r0 + m) * a.W + w] = word;
    }
  }
}

// Pass 2: rows 32 * blockIdx.z .. + 31 of the KV of the record of chunk
// blockIdx.x % records of batch*head blockIdx.x / records, for the slice
// blockIdx.y; the block of blockIdx.z = 0 also takes vsum, those of slice 0
// ksum. A thread sums a kTI x kTJ tile of KV.
template <int kTI, int kTJ>
__global__ void __launch_bounds__(THREADS) binary_linear_attention_partials_kernel(const Args a) {
  const int c = blockIdx.x % a.records;
  const int64_t g = blockIdx.x / a.records;
  const int Dk = a.Dk, Dv = a.Dv, W = a.W;
  const int p = blockIdx.z, i0 = p * ROWS;             // KV rows [i0, i0 + 32)
  const int dv0 = blockIdx.y * a.DVS;
  const int dvs = min(a.DVS, Dv - dv0);
  const int vp = pitch_of(a.DVS);
  const int r0 = c * a.chunk, r1 = min(a.N, r0 + a.chunk);   // the chunk's rows
  const int loads = (r1 - r0 + ROWS - 1) / ROWS;
  const bool vec = a.vec != 0;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  const int stage = ROWS * (vp + 1);
  const unsigned* kcg = a.codes + (static_cast<int64_t>(a.G) + g) * a.N * W + p;
  const float* vg = a.v + g * a.N * Dv + dv0;

  // Load t: rows of v's slice and word p of the rows' key codes, stage t % 3.
  auto fetch = [&](int t) {
    float* st = smem + (t % STAGES) * stage;
    const int n0 = r0 + t * ROWS, rows = min(ROWS, r1 - n0);
    copy_rows(st, vp, vg + static_cast<int64_t>(n0) * Dv, Dv, rows, dvs, vec);
    copy_rows(reinterpret_cast<unsigned*>(st + ROWS * vp), 1, kcg + static_cast<int64_t>(n0) * W,
              W, rows, 1, false);
    cp_async_commit();
  };

  const Tile<kTI, kTJ> tl(vp);
  float acc[kTI][kTJ] = {};
  float ks = 0.0f, vs = 0.0f;            // ksum of KV row i0 + tid; vsum of column tid

  fetch(0);
  if (loads > 1) fetch(1);
  for (int t = 0; t < loads; ++t) {
    wait_pending(t + 1 < loads ? 1 : 0);
    __syncthreads();
    if (t + 2 < loads) fetch(t + 2);
    const float* vt = smem + (t % STAGES) * stage;
    const unsigned* kw = reinterpret_cast<const unsigned*>(vt + ROWS * vp);
    const int rows = min(ROWS, r1 - (r0 + t * ROWS));
    if (tl.on) {
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const unsigned word = kw[r] >> tl.i;
        float x[kTJ];
        load<kTJ>(x, vt + r * vp + tl.j);
#pragma unroll
        for (int y = 0; y < kTI; ++y) {
          const float sgn = sign_of(word, y);
#pragma unroll
          for (int z = 0; z < kTJ; ++z) acc[y][z] = __fmaf_rn(sgn, x[z], acc[y][z]);
        }
      }
    }
    if (tid < ROWS)
      for (int r = 0; r < rows; ++r) ks += sign_of(kw[r], tid);
    if (p == 0 && tid < dvs)
      for (int r = 0; r < rows; ++r) vs += vt[r * vp + tid];
  }

  float* rec = a.work + (g * a.records + c) * record(Dk, Dv);
  if (tl.on) {
#pragma unroll
    for (int y = 0; y < kTI; ++y) {
      const int i = i0 + tl.i + y;
      if (i >= Dk) continue;
#pragma unroll
      for (int z = 0; z < kTJ; ++z)
        if (tl.j + z < dvs) rec[static_cast<int64_t>(i) * Dv + dv0 + tl.j + z] = acc[y][z];
    }
  }
  float* tail = rec + static_cast<int64_t>(Dk) * Dv;
  if (blockIdx.y == 0 && tid < ROWS && i0 + tid < Dk) tail[i0 + tid] = ks;
  if (p == 0 && tid < dvs) tail[Dk + dv0 + tid] = vs;
}

// Pass 3: record c <- record 0 + ... + record c, in chunk order, for entry
// blockIdx.x % per_g * SCAN_THREADS + threadIdx.x of batch*head
// blockIdx.x / per_g; the last one is also the final state when asked for.
__global__ void __launch_bounds__(SCAN_THREADS) binary_linear_attention_scan_kernel(const Args a) {
  const int64_t E = record(a.Dk, a.Dv);
  const int64_t per_g = (E + SCAN_THREADS - 1) / SCAN_THREADS;
  const int64_t g = blockIdx.x / per_g;
  const int64_t e = (blockIdx.x % per_g) * SCAN_THREADS + threadIdx.x;
  if (e >= E) return;
  float* p = a.work + g * a.records * E + e;
  float s = 0.0f;
  for (int c0 = 0; c0 < a.records; c0 += SCAN_BATCH) {
    float x[SCAN_BATCH];
#pragma unroll
    for (int b = 0; b < SCAN_BATCH; ++b)
      if (c0 + b < a.records) x[b] = p[(c0 + b) * E];
#pragma unroll
    for (int b = 0; b < SCAN_BATCH; ++b)
      if (c0 + b < a.records) {
        s = c0 + b == 0 ? x[b] : s + x[b];
        p[(c0 + b) * E] = s;
      }
  }
  if (a.kv_out != nullptr) {
    const int64_t nkv = static_cast<int64_t>(a.Dk) * a.Dv;
    if (e < nkv)
      a.kv_out[g * nkv + e] = s;
    else if (e < nkv + a.Dk)
      a.ksum_out[g * a.Dk + (e - nkv)] = s;
    else
      a.vsum_out[g * a.Dv + (e - nkv - a.Dk)] = s;
  }
}

// Pass 4: the outputs of query tile blockIdx.x % tiles of batch*head
// blockIdx.x / tiles, for the slice blockIdx.y. A thread sums a kTI x kTJ
// tile of outputs.
template <int kTI, int kTJ>
__global__ void __launch_bounds__(THREADS) binary_linear_attention_out_kernel(const Args a) {
  // The ring's stages: the tiles are launched for pitches up to 32, up to
  // 64 and above.
  constexpr int OUT_STAGES = out_stages(kTJ == 8 ? 128 : kTI == 4 ? 64 : 32);
  const int tau = blockIdx.x % a.tiles;
  const int64_t g = blockIdx.x / a.tiles;
  const int c = tau / a.per;                          // chunk
  const int c0 = c * a.chunk, cend = min(a.N, c0 + a.chunk);
  const int q0 = c0 + (tau - c * a.per) * ROWS;       // this tile's rows [q0, q0 + qr)
  const int qr = min(ROWS, cend - q0);
  const int K = q0 + qr - c0;                         // its keys: c0 .. q0 + qr - 1
  const int Dk = a.Dk, Dv = a.Dv, W = a.W, wp = W | 1;
  const int dv0 = blockIdx.y * a.DVS;
  const int dvs = min(a.DVS, Dv - dv0);
  const int vp = pitch_of(a.DVS);
  const bool vec = a.vec != 0;
  const float d = static_cast<float>(Dk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  const int stage = ROWS * (vp + wp);
  float* ring = smem;                                   // OUT_STAGES: KV or v rows, key codes
  float* wt = ring + OUT_STAGES * stage;                // 2 x (ROWS keys x ROWS queries)
  float* ksum = wt + 2 * ROWS * ROWS;                   // the carry's ksum
  float* vsum = ksum + round4(Dk);                      // the carry's vsum slice
  float* dpart = vsum + vp;                             // 4 x ROWS denominator parts
  unsigned* qc = reinterpret_cast<unsigned*>(dpart + 4 * ROWS);   // ROWS x wp

  const unsigned* qcg = a.codes + g * a.N * W;
  const unsigned* kcg = a.codes + (static_cast<int64_t>(a.G) + g) * a.N * W;
  const float* vg = a.v + g * a.N * Dv + dv0;
  const int64_t E = record(Dk, Dv);
  const float* carry = c > 0 ? a.work + (g * a.records + c - 1) * E : nullptr;
  const int pieces = c > 0 ? W : 0;                   // KV rows, 32 (one code word) a load
  const int loads = pieces + (K + ROWS - 1) / ROWS;

  // Load t into stage t % OUT_STAGES: KV rows [32 t, 32 t + 32) of the
  // carry's slice, or key tile t - pieces: its v rows and its key codes.
  auto fetch = [&](int t) {
    float* st = ring + (t % OUT_STAGES) * stage;
    if (t < pieces) {
      const int i0 = t * ROWS;
      copy_rows(st, vp, carry + static_cast<int64_t>(i0) * Dv + dv0, Dv, min(ROWS, Dk - i0),
                dvs, vec);
    } else {
      const int k0 = c0 + (t - pieces) * ROWS, rows = min(ROWS, c0 + K - k0);
      copy_rows(st, vp, vg + static_cast<int64_t>(k0) * Dv, Dv, rows, dvs, vec);
      copy_rows(reinterpret_cast<unsigned*>(st + ROWS * vp), wp,
                kcg + static_cast<int64_t>(k0) * W, W, rows, W, false);
    }
    cp_async_commit();
  };

  // This thread's part of the denominator of query row `lane`: integers.
  float den = 0.0f;
  // Weights of the key tile of load t, w = 2 (Dk - hamming), 0 past the
  // query, into weight buffer (t - pieces) % 2: thread (lane, warp) takes
  // query row lane and keys warp + 4 n.
  auto weights = [&](int t) {
    constexpr int PER = ROWS / (THREADS / 32);
    const int kt = t - pieces, k0 = c0 + kt * ROWS, kr = min(ROWS, c0 + K - k0);
    const unsigned* kc = reinterpret_cast<const unsigned*>(ring + (t % OUT_STAGES) * stage +
                                                           ROWS * vp);
    float* wk = wt + (kt & 1) * ROWS * ROWS;
    const int last = q0 + lane - k0;                    // the last key row `lane` sees
    int h[PER] = {};
    for (int x = 0; x < W; ++x) {
      const unsigned qw = qc[lane * wp + x];
#pragma unroll
      for (int n = 0; n < PER; ++n) h[n] += __popc(qw ^ kc[(warp + 4 * n) * wp + x]);
    }
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int r = warp + 4 * n;
      if (r >= kr) break;
      // 2 (Dk - h) as a float: h < 2^23, so the bits of 2^23 + h are exact.
      const float hf = __int_as_float(0x4B000000 | h[n]) - 8388608.0f;
      const float w = r <= last ? 2.0f * (d - hf) : 0.0f;
      wk[r * ROWS + lane] = w;
      den += w;
    }
  };

  copy_rows(qc, wp, qcg + static_cast<int64_t>(q0) * W, W, qr, W, false);
  for (int t = 0; t < min(loads, OUT_STAGES - 1); ++t) fetch(t);
  if (c > 0) {
    const float* tail = carry + static_cast<int64_t>(Dk) * Dv;
    for (int e = tid; e < Dk; e += THREADS) ksum[e] = tail[e];
    for (int e = tid; e < dvs; e += THREADS) vsum[e] = tail[Dk + dv0 + e];
  }
  // Load 0 (and the query codes, committed with it) in place.
  wait_pending(min(loads, OUT_STAGES - 1) - 1);
  __syncthreads();
  if (c > 0) {
    // bq . ksum over a quarter of the head dims.
    const int quarter = (Dk + 3) / 4;
    for (int i = warp * quarter; i < min(Dk, (warp + 1) * quarter); ++i)
      den += sign_of(qc[lane * wp + (i >> 5)], i & 31) * ksum[i];
  } else {
    weights(0);
  }

  const Tile<kTI, kTJ> tl(vp);
  float acc[kTI][kTJ] = {};

  // Step t: load t + 1 in place; start load t + OUT_STAGES - 1; the weights
  // of load t + 1 if it is a key tile; then the sums of load t.
  for (int t = 0; t < loads; ++t) {
    wait_pending(min(loads, t + OUT_STAGES - 1) - min(t + 2, loads));
    __syncthreads();
    if (t + OUT_STAGES - 1 < loads) fetch(t + OUT_STAGES - 1);
    if (t + 1 < loads && t + 1 >= pieces) weights(t + 1);
    if (!tl.on) continue;
    const float* xs = ring + (t % OUT_STAGES) * stage + tl.j;
    if (t < pieces) {
      // num += +-KV rows 32 t .. : those head dims are code word t.
      const int rows = min(ROWS, Dk - t * ROWS);
      unsigned word[kTI];
#pragma unroll
      for (int y = 0; y < kTI; ++y) word[y] = qc[(tl.i + y) * wp + t];
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float x[kTJ];
        load<kTJ>(x, xs + r * vp);
#pragma unroll
        for (int y = 0; y < kTI; ++y) {
          const float sgn = sign_of(word[y], r);
#pragma unroll
          for (int z = 0; z < kTJ; ++z) acc[y][z] = __fmaf_rn(sgn, x[z], acc[y][z]);
        }
      }
      if (t == pieces - 1) {
        float vs[kTJ];
        load<kTJ>(vs, vsum + tl.j);
#pragma unroll
        for (int y = 0; y < kTI; ++y)
#pragma unroll
          for (int z = 0; z < kTJ; ++z) acc[y][z] = __fmaf_rn(d, vs[z], acc[y][z]);
      }
      continue;
    }
    // num += w . v over this key tile's keys in order.
    const int kt = t - pieces;
    const int kr = min(ROWS, K - kt * ROWS);
    const float* ws = wt + (kt & 1) * ROWS * ROWS + tl.i;
    auto step = [&](int r) {
      float w[kTI], x[kTJ];
      load<kTI>(w, ws + r * ROWS);
      load<kTJ>(x, xs + r * vp);
#pragma unroll
      for (int y = 0; y < kTI; ++y)
#pragma unroll
        for (int z = 0; z < kTJ; ++z) acc[y][z] = __fmaf_rn(w[y], x[z], acc[y][z]);
    };
    if (kr == ROWS) {
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) step(r);
    } else {
#pragma unroll 4
      for (int r = 0; r < kr; ++r) step(r);
    }
  }

  dpart[warp * ROWS + lane] = den;
  __syncthreads();
  if (!tl.on) return;
  float* og = a.out + (g * a.N + q0) * Dv + dv0;
#pragma unroll
  for (int y = 0; y < kTI; ++y) {
    const int i = tl.i + y;
    if (i >= qr) continue;
    const float dn = d * static_cast<float>(c0) + dpart[i] + dpart[ROWS + i] +
                     dpart[2 * ROWS + i] + dpart[3 * ROWS + i] + 1e-6f;
    float o[kTJ];
#pragma unroll
    for (int z = 0; z < kTJ; ++z) o[z] = acc[y][z] / dn;
    float* row = og + static_cast<int64_t>(i) * Dv + tl.j;
    if (vec && tl.j + kTJ <= dvs) {
#pragma unroll
      for (int z = 0; z < kTJ; z += 4)
        *reinterpret_cast<float4*>(row + z) = make_float4(o[z], o[z + 1], o[z + 2], o[z + 3]);
    } else {
#pragma unroll
      for (int z = 0; z < kTJ; ++z)
        if (tl.j + z < dvs) row[z] = o[z];
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The partials and output kernels of one register tile shape.
struct Passes {
  void (*partials)(const Args);
  void (*out)(const Args);
};

template <int kTI, int kTJ>
Passes passes() {
  return {binary_linear_attention_partials_kernel<kTI, kTJ>,
          binary_linear_attention_out_kernel<kTI, kTJ>};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q, k: (G, N, Dk); v, out: (G, N, Dv); float32, all contiguous. kv_out
// (G, Dk, Dv), ksum_out (G, Dk), vsum_out (G, Dv): all three null, or all
// three set to receive the final carry. work: (G, records, Dk*Dv + Dk + Dv)
// float32 scratch, null when records is 0; codes: (2, G, N, ceil(Dk / 32))
// 4-byte scratch. The partition: chunk (1 to N), rows (32, the rows of a
// tile), per = ceil(chunk / rows) tiles per chunk, tiles = the query tiles
// of all chunks, records = chunks - 1, plus 1 with the final state.
// dv_slice: the columns of v one block takes (1 to min(Dv, 128)). Returns
// the first launch's cudaError_t (cudaErrorInvalidValue for what it does
// not take, and for a block whose shared memory does not fit).
extern "C" int binary_linear_attention_launch(const void* q, const void* k, const void* v,
                                              void* out, void* kv_out, void* ksum_out,
                                              void* vsum_out, void* work, void* codes, int G,
                                              int N, int Dk, int Dv, int chunk, int rows,
                                              int per, int tiles, int records, int dv_slice,
                                              void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (G < 1 || N < 1 || Dk < 1 || Dv < 1 || chunk < 1 || chunk > N || rows != ROWS ||
      dv_slice < 1 || dv_slice > Dv || dv_slice > MAX_SLICE || codes == nullptr)
    return invalid;
  const bool state = kv_out != nullptr;
  if (state != (ksum_out != nullptr) || state != (vsum_out != nullptr)) return invalid;
  const int chunks = (N + chunk - 1) / chunk;
  const int last = N - (chunks - 1) * chunk;
  if (per != (chunk + ROWS - 1) / ROWS ||
      tiles != (chunks - 1) * per + (last + ROWS - 1) / ROWS ||
      records != chunks - 1 + (state ? 1 : 0) || (records > 0) != (work != nullptr))
    return invalid;
  const int W = (Dk + 31) / 32;
  const size_t smem_partials = sizeof(float) * partials_words(dv_slice);
  const size_t smem_out = sizeof(float) * out_words(Dk, dv_slice);
  if (smem_partials > SMEM_LIMIT || smem_out > SMEM_LIMIT) return invalid;
  // A thread's register tile: 32 rows x the slice's pitch over 128 threads.
  const int vp = pitch_of(dv_slice);
  const Passes k2 = vp <= 32 ? passes<2, 4>() : vp <= 64 ? passes<4, 4>() : passes<4, 8>();

  const bool vec = Dk % 4 == 0 && Dv % 4 == 0 && (dv_slice % 4 == 0 || dv_slice == Dv) &&
                   aligned16(v) && aligned16(out) && (work == nullptr || aligned16(work));
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(out),
               static_cast<float*>(kv_out), static_cast<float*>(ksum_out),
               static_cast<float*>(vsum_out), static_cast<float*>(work),
               static_cast<unsigned*>(codes), G, N, Dk, Dv, chunk, per, tiles, records,
               dv_slice, W, vec ? 1 : 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned slices = (Dv + dv_slice - 1) / dv_slice;
  const int64_t rows_all = static_cast<int64_t>(G) * N;
  cudaError_t err = launch(binary_linear_attention_codes_kernel,
                           dim3(static_cast<unsigned>((rows_all + CODE_ROWS - 1) / CODE_ROWS), 2),
                           THREADS, 0, s, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (records > 0) {
    err = launch(k2.partials, dim3(static_cast<unsigned>(G) * records, slices, W), THREADS,
                 smem_partials, s, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (records > 1 || state) {
    const int64_t per_g = (record(Dk, Dv) + SCAN_THREADS - 1) / SCAN_THREADS;
    err = launch(binary_linear_attention_scan_kernel,
                 dim3(static_cast<unsigned>(G * per_g)), SCAN_THREADS, 0, s, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch(k2.out, dim3(static_cast<unsigned>(G) * tiles, slices), THREADS, smem_out, s, a);
  return static_cast<int>(err);
}

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
// What bounds it on an H100: memory, and in practice latency. Each of q, k,
// v is read once and out is written once (at G = 128, N = 196, d = 32 about
// 12.8 MB, 3.83 us at 3.35 TB/s). The +/-1 contractions are 102.8 MFLOP
// there, 1.53 us on the float32 cores. Tensor cores are not used: their
// float32 input is TF32, which would round v to a 10-bit mantissa, away from
// the float32 reference, for operations that are not the bound. What one
// block per batch*head lacked was parallelism: 128 blocks (4 at one image),
// each walking all N rows twice.
//
// Design:
//   * a thread-block cluster of C blocks per (batch*head, slice of Dv
//     columns); block `rank` of the cluster owns rows
//     [rank * span, min(N, (rank + 1) * span)). C and span come with the
//     launch: the wrapper passes C = min(8, ceil(N / 32)) and
//     span = ceil(N / C) (`bidir_linear_attention.partition`), functions of
//     N alone, never of G, the SM count, the slice or the layout. Grid
//     (C * G, ceil(Dv / dvs)), cluster (C, 1, 1);
//   * each block streams its rows through a two-stage ring of 32-row tiles
//     filled by cp.async (16-byte copies when every row is 16-byte aligned,
//     else 4-byte ones): first k and the slice's columns of v, then q. The
//     copy of the next tile is in flight while a tile is summed, so q's
//     first tile lands during the cluster exchange below;
//   * pass 1: each block sums its partial KV slice, ksum and vsum slice over
//     its rows in row order. A thread holds a 2 x 4 tile of KV in registers
//     (1 x 1 where rows are not 16-byte aligned), so 8 chains run side by
//     side; the threads of the first column group also keep ksum, those of
//     the first rows of KV the vsum slice;
//   * the exchange, through distributed shared memory: after a cluster
//     barrier each block owns a share of the sums, reads the C partials of
//     that share in rank order 0..C-1, adds them and writes the result over
//     the share in every block of the cluster; a second cluster barrier,
//     after which no block touches another's shared memory, so none leaves
//     while its sums may still be read or written;
//   * pass 2: each block emits its own rows' slice against the full sums, a
//     thread a 2 x 4 tile of outputs and those rows' denominators;
//   * 128 threads and at most 64 registers a thread, so 8 blocks fit an SM
//     and the 896 blocks of G = 128, N = 196 run as one wave;
//   * q, k and v are read through batch, head and row strides (the last
//     dim contiguous), and out is written through them: the serving path
//     hands the (B, H, N, Dh) views of its projections and gets a view of a
//     (B, N, H, Dv) buffer, with no layout copy on either side;
//   * every output and sum entry is one fixed chain of float32 adds (rows in
//     order within a block, blocks in rank order, head dim in order for the
//     products), so results do not vary from run to run, with G, with the
//     slice width or with the layout; ksum and the denominators are sums of
//     integers, exact;
//   * no cap on N; the head dim is not padded.
// The C function returns the launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;        // blocks an SM must hold: caps registers at 64
constexpr int TILE = 32;             // rows per ring stage
// Floats after each k or q row in shared memory: the 4 rows that one warp
// reads in pass 2 then start in different banks (a pitch of Dk, a multiple
// of 32, would put them all in one).
constexpr int PAD = 4;
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int SMEM_LIMIT = 232448;   // what a Hopper block can opt in to

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int H, N, Dk, Dv, DVS, C, span;
  int64_t sq[3], sk[3], sv[3], so[3];   // batch, head and row strides, in floats
};

// y with the sign of x's code: x >= 0 ? y : -y (NaN codes to -1). Adding it
// is adding code(x) * y, exactly.
__device__ __forceinline__ float signed_by(float x, float y) { return x >= 0.0f ? y : -y; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// V consecutive floats in registers: a float4 when V == 4, a float2 when 2.
template <int V>
struct Frag {
  float x[V];
};

template <int V>
__device__ __forceinline__ Frag<V> load(const float* p) {
  Frag<V> f;
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f.x[0] = t.x, f.x[1] = t.y, f.x[2] = t.z, f.x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    f.x[0] = t.x, f.x[1] = t.y;
  } else {
    f.x[0] = *p;
  }
  return f;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Frag<V>& f) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f.x[0], f.x[1], f.x[2], f.x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(f.x[0], f.x[1]);
  } else {
    *p = f.x[0];
  }
}

template <int V>
__device__ __forceinline__ Frag<V> zeros() {
  Frag<V> f;
#pragma unroll
  for (int x = 0; x < V; ++x) f.x[x] = 0.0f;
  return f;
}

// Copy `rows` rows of `width` floats (global row stride `stride`) into
// shared memory at row pitch `pitch`.
template <bool kVec>
__device__ __forceinline__ void copy_rows(float* dst, int pitch, const float* src,
                                          int64_t stride, int rows, int width) {
  if (kVec) {
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

// Shared memory of one block with a slice of dvs columns, in bytes: the
// ring (two stages of TILE rows of k or q, at pitch Dk + PAD, and of v's
// slice) and the sums (KV slice, ksum, vsum slice: the block's partials,
// then the full sums). Mirrored by
// repro_torch.kernels.bidir_linear_attention.smem_bytes.
size_t smem_bytes(int Dk, int dvs) {
  const size_t sums = static_cast<size_t>(Dk) * dvs + Dk + dvs;
  return sizeof(float) * (2 * static_cast<size_t>(TILE) * (Dk + PAD + dvs) + sums);
}

__device__ __forceinline__ float code(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// kVec: every row of q, k, v and out is 16-byte aligned, and Dk and the
// slice are multiples of 4; then copies are 16 bytes and a thread holds a
// TI x TJ = 2 x 4 tile of sums in registers (else 1 x 1). Each entry's
// chain of adds is the same either way, so the two give the same bits.
template <bool kVec>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) bidir_binary_attention_kernel(const Args a) {
  constexpr int TI = kVec ? 2 : 1;     // rows of KV (pass 1) or of out (pass 2) per thread
  constexpr int TJ = kVec ? 4 : 1;     // columns per thread
  constexpr int VK = kVec ? 4 : 1;     // head-dim step of pass 2
  constexpr int VX = kVec ? 2 : 1;     // sums per exchange step
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t g = blockIdx.x / C;
  const int64_t bi = g / a.H, hi = g % a.H;
  const int Dk = a.Dk;
  const int dv0 = blockIdx.y * a.DVS;
  const int dvs = min(a.DVS, a.Dv - dv0);        // this block's columns of v
  const int r0 = min(a.N, rank * a.span);
  const int r1 = min(a.N, r0 + a.span);          // this block's rows [r0, r1)
  const int tiles = (r1 - r0 + TILE - 1) / TILE;

  const float* qg = a.q + bi * a.sq[0] + hi * a.sq[1];
  const float* kg = a.k + bi * a.sk[0] + hi * a.sk[1];
  const float* vg = a.v + bi * a.sv[0] + hi * a.sv[1] + dv0;
  float* og = a.out + bi * a.so[0] + hi * a.so[1] + dv0;

  extern __shared__ __align__(16) float smem[];
  const int kp = Dk + PAD;             // row pitch of a k or q tile
  const int stage = TILE * (kp + dvs);
  const int nkv = Dk * dvs;
  const int nsum = nkv + Dk + dvs;
  float* ring = smem;                  // 2 stages: k (or q) rows, then v rows
  float* sums = ring + 2 * stage;      // KV | ksum | vsum: this block's, then over all N
  const int tid = threadIdx.x;
  const int cj = dvs / TJ;             // groups of TJ columns of the slice
  const float d = static_cast<float>(Dk);
  const float dn = d * static_cast<float>(a.N);

  // Load t of the block: the k and v rows of tile t for t < tiles, then the
  // q rows of tile t - tiles; stage t % 2.
  auto fetch = [&](int t) {
    float* st = ring + (t & 1) * stage;
    const int n0 = r0 + (t < tiles ? t : t - tiles) * TILE;
    const int rows = min(TILE, r1 - n0);
    if (t < tiles) {
      copy_rows<kVec>(st, kp, kg + n0 * a.sk[2], a.sk[2], rows, Dk);
      copy_rows<kVec>(st + TILE * kp, dvs, vg + n0 * a.sv[2], a.sv[2], rows, dvs);
    } else {
      copy_rows<kVec>(st, kp, qg + n0 * a.sq[2], a.sq[2], rows, Dk);
    }
    cp_async_commit();
  };

  // The exchange, in steps of VX sums. Each block owns a share of the
  // steps, fixed by the sizes and C. After a barrier, it reads the C
  // partials of its share over distributed shared memory, adds them in rank
  // order and writes the result over that share in every block: a share is
  // read and written by its owner alone, each step by one thread, loads
  // before stores. After a second barrier every block holds all the sums
  // and no block touches another's shared memory again, so each may run on
  // and leave.
  auto exchange = [&]() {
    const int steps = nsum / VX;
    const int per = (steps + C - 1) / C;
    const int own0 = min(steps, rank * per), own1 = min(steps, own0 + per);
    cluster_arrive();
    cluster_wait();
    for (int e = own0 + tid; e < own1; e += THREADS) {
      Frag<VX> p[MAX_CLUSTER];
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < C) p[c] = load<VX>(cluster.map_shared_rank(sums + e * VX, c));
      Frag<VX> s = p[0];
#pragma unroll
      for (int c = 1; c < MAX_CLUSTER; ++c)
        if (c < C) {
#pragma unroll
          for (int x = 0; x < VX; ++x) s.x[x] += p[c].x[x];
        }
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        if (c < C) store<VX>(cluster.map_shared_rank(sums + e * VX, c), s);
    }
    cluster_arrive();
    cluster_wait();
  };

  const int loads = 2 * tiles;
  if (loads > 0) fetch(0);
  if (tiles == 0) {                    // no rows: zeros to the cluster's sums
    for (int e = tid; e < nsum; e += THREADS) sums[e] = 0.0f;
    exchange();
  }
  for (int t = 0; t < loads; ++t) {
    if (t + 1 < loads) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = ring + (t & 1) * stage;
    const int n0 = r0 + (t < tiles ? t : t - tiles) * TILE;
    const int rows = min(TILE, r1 - n0);
    if (t < tiles) {
      // Pass 1: add this tile's rows, in order, into KV[i..i+TI)[j..j+TJ);
      // the threads of j = 0 also carry ksum[i..i+TI), those of i = 0 the
      // vsum[j..j+TJ). The first tile starts from zero.
      const float* kt = st;
      const float* vt = st + TILE * kp;
      for (int u = tid; u < (Dk / TI) * cj; u += THREADS) {
        const int i = (u / cj) * TI, j = (u % cj) * TJ;
        const bool with_ksum = j == 0, with_vsum = i == 0;
        Frag<TJ> s[TI];
        Frag<TI> ks = zeros<TI>();
        Frag<TJ> vs = zeros<TJ>();
#pragma unroll
        for (int y = 0; y < TI; ++y) s[y] = t == 0 ? zeros<TJ>() : load<TJ>(sums + (i + y) * dvs + j);
        if (t > 0) {
          ks = load<TI>(sums + nkv + i);
          vs = load<TJ>(sums + nkv + Dk + j);
        }
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
          const Frag<TI> kk = load<TI>(kt + r * kp + i);
          const Frag<TJ> vv = load<TJ>(vt + r * dvs + j);
#pragma unroll
          for (int y = 0; y < TI; ++y) {
            const float c = code(kk.x[y]);
#pragma unroll
            for (int x = 0; x < TJ; ++x) s[y].x[x] = __fmaf_rn(c, vv.x[x], s[y].x[x]);
            ks.x[y] += c;
          }
#pragma unroll
          for (int x = 0; x < TJ; ++x) vs.x[x] += vv.x[x];
        }
#pragma unroll
        for (int y = 0; y < TI; ++y) store<TJ>(sums + (i + y) * dvs + j, s[y]);
        if (with_ksum) store<TI>(sums + nkv + i, ks);
        if (with_vsum) store<TJ>(sums + nkv + Dk + j, vs);
      }
      if (t == tiles - 1) exchange();
    } else {
      // Pass 2: out[r..r+TI)[j..j+TJ) of this tile against the full sums,
      // and those rows' denominators (sums of integers, exact). A row past
      // the tile's end is summed from stale shared memory and not stored.
      const float* qt = st;
      const float* kv = sums;
      const float* ksum = sums + nkv;
      const float* vsum = ksum + Dk;
      for (int u = tid; u < ((rows + TI - 1) / TI) * cj; u += THREADS) {
        const int r = (u / cj) * TI, j = (u % cj) * TJ;
        Frag<TJ> s[TI];
        float den[TI];
#pragma unroll
        for (int y = 0; y < TI; ++y) {
          s[y] = zeros<TJ>();
          den[y] = 0.0f;
        }
#pragma unroll 2
        for (int i = 0; i < Dk; i += VK) {
          Frag<VK> qq[TI];
          Frag<TJ> w[VK];
#pragma unroll
          for (int y = 0; y < TI; ++y) qq[y] = load<VK>(qt + (r + y) * kp + i);
#pragma unroll
          for (int z = 0; z < VK; ++z) w[z] = load<TJ>(kv + (i + z) * dvs + j);
          const Frag<VK> ks = load<VK>(ksum + i);
#pragma unroll
          for (int z = 0; z < VK; ++z) {
#pragma unroll
            for (int y = 0; y < TI; ++y) {
              const float c = code(qq[y].x[z]);
#pragma unroll
              for (int x = 0; x < TJ; ++x) s[y].x[x] = __fmaf_rn(c, w[z].x[x], s[y].x[x]);
              den[y] = __fmaf_rn(c, ks.x[z], den[y]);
            }
          }
        }
        const Frag<TJ> vj = load<TJ>(vsum + j);
#pragma unroll
        for (int y = 0; y < TI; ++y) {
          if (r + y >= rows) break;
#pragma unroll
          for (int x = 0; x < TJ; ++x)
            s[y].x[x] = __fmaf_rn(d, vj.x[x], s[y].x[x]) / (den[y] + dn + 1e-6f);
          store<TJ>(og + (n0 + r + y) * a.so[2] + j, s[y]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// q, k: (B, H, N, Dk); v: (B, H, N, Dv); out: (B, H, N, Dv); float32, each
// with its last dim contiguous. strides: 12 values, the batch, head and row
// strides (in floats) of q, k, v and out, in that order. dv_slice: the
// columns of v one block takes (1 <= dv_slice <= Dv); cluster: the blocks
// per (batch*head, slice), 1 to 8; span: the rows each block owns, with
// cluster * span >= N. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for what it does not take, and for a block whose
// shared memory does not fit).
extern "C" int bidir_binary_attention_launch(const void* q, const void* k, const void* v,
                                             void* out, int B, int H, int N, int Dk, int Dv,
                                             int dv_slice, int cluster, int span,
                                             const long long* strides, void* stream) {
  if (B < 1 || H < 1 || N < 1 || Dk < 1 || Dv < 1 || dv_slice < 1 || dv_slice > Dv ||
      cluster < 1 || cluster > MAX_CLUSTER || span < 1 ||
      static_cast<int64_t>(cluster) * span < N ||
      static_cast<int64_t>(B) * H * cluster > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Dk, dv_slice);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.N = N;
  a.Dk = Dk;
  a.Dv = Dv;
  a.DVS = dv_slice;
  a.C = cluster;
  a.span = span;
  bool vec = Dk % 4 == 0 && Dv % 4 == 0 && dv_slice % 4 == 0;
  for (int x = 0; x < 3; ++x) {
    a.sq[x] = strides[x];
    a.sk[x] = strides[3 + x];
    a.sv[x] = strides[6 + x];
    a.so[x] = strides[9 + x];
    vec = vec && a.sq[x] % 4 == 0 && a.sk[x] % 4 == 0 && a.sv[x] % 4 == 0 && a.so[x] % 4 == 0;
  }
  vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0;
  void (*kernel)(Args) = vec ? bidir_binary_attention_kernel<true>
                             : bidir_binary_attention_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * B * H, (Dv + dv_slice - 1) / dv_slice, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// add_matmul: batched y[g] = x[g] @ b[g] with b in {-1, 0, +1} stored one
// int8 per element, for Hopper (sm_90a). The paper's MatAdd: a product whose
// second operand is a binary code, so every multiply is a sign.
//
// Replaces the TPU kernel `add_matmul_pallas` (`_add_matmul_kernel`) in
// repro/kernels/add_matmul.py. That kernel pads x and b to its 128 x 128 x 512
// tiles and carries its sum across a sequential K grid; here the block loops
// over K itself and masks the ragged edges (tile_matmul.cuh).
//
// What bounds it on an H100: memory. At the serving sites (G = 4 b heads,
// per-head 32 x 196 x 32 and 196 x 32 x 32) each x element and each code is
// used 32 times, far below the ~295 bf16 operations per byte at which the
// tensor cores become the limit. The code moves at one byte and becomes an
// exact bf16 +-1 or 0 in shared memory; a zero contributes exactly nothing.
// At ktv (M = 32) the tile shrinks to the product: one block per
// batch*head brings its whole K extent in with one barrier
// (tile_matmul.cuh).
// The C function returns cudaGetLastError() after the launch.

#include "tile_matmul.cuh"

namespace {

struct DecodeSign {
  static constexpr bool kBatched = true;
  static constexpr int kRows = 1;
  // Every int8 value is an exact bf16.
  static __device__ __forceinline__ void decode4(uint32_t w, uint2 (&out)[1]) {
    const auto v = [w](int i) { return static_cast<float>(static_cast<int8_t>(w >> (8 * i))); };
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v(0), v(1));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v(2), v(3));
    out[0] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                        *reinterpret_cast<const uint32_t*>(&hi));
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Row-major, contiguous
// x (G, M, K), b (G, K, N) int8, y (G, M, N); (tile_m, tile_n) one of the
// shapes tile_matmul.cuh builds. Returns the launch's cudaError_t.
extern "C" int add_matmul_launch(const void* x, const void* b, void* y, int G, int M, int K,
                                 int N, int dtype, int tile_m, int tile_n, void* stream) {
  return tile_matmul::launch<DecodeSign>(x, b, y, G, M, K, N, dtype, tile_m, tile_n, stream);
}

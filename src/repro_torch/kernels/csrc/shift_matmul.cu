// shift_matmul: y = x @ (s * 2^P) with the weight packed one int8 per element
// (bit 7 = sign, bits 0-6 = P + 64), for Hopper (sm_90a).
//
// Replaces the TPU kernel `shift_matmul_pallas` (`_shift_matmul_kernel`,
// `_assemble_bf16`) in repro/kernels/shift_matmul.py.
//
// What bounds it on an H100: memory. At the serving shapes (M = 196 b rows,
// K, N in {128, 256}) it moves x and y in float32 and the weight in one
// byte per element, a few MB, against a fraction of a GFLOP: the bytes take
// about ten times as long as the bf16 tensor-core work. The design therefore
// reads each weight as one byte, once per block, and decodes it in shared
// memory to the exact bf16 power of two `sign << 15 | (P + 127) << 7` while
// the block's first x tiles are in flight; x streams once through a
// two-stage ring of asynchronous copies. The product itself (fixed K order,
// masked edges, tile shape chosen at launch, rows bit-identical whatever M
// or the tile) is tile_matmul.cuh.
// The C function returns cudaGetLastError() after the launch.

#include "tile_matmul.cuh"

namespace {

struct DecodePo2 {
  static constexpr bool kBatched = false;
  static constexpr int kRows = 1;
  // Per byte u: bit 7 is the sign, bits 0-6 are P + 64, and P + 127 =
  // (P + 64) + 63 is the bf16 exponent field (mantissa zero). Two bytes are
  // spread to the 16-bit halves of a word and assembled side by side.
  static __device__ __forceinline__ uint32_t two(uint32_t t) {
    return ((t & 0x00800080u) << 8) | (((t & 0x007F007Fu) + 0x003F003Fu) << 7);
  }
  static __device__ __forceinline__ void decode4(uint32_t w, uint2 (&out)[1]) {
    out[0] = make_uint2(two(__byte_perm(w, 0, 0x4140)), two(__byte_perm(w, 0, 0x4342)));
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Row-major, contiguous
// x (M, K), w (K, N) int8, y (M, N); (tile_m, tile_n) one of the shapes
// tile_matmul.cuh builds. Returns the launch's cudaError_t.
extern "C" int shift_matmul_launch(const void* x, const void* w, void* y, int M, int K, int N,
                                   int dtype, int tile_m, int tile_n, void* stream) {
  return tile_matmul::launch<DecodePo2>(x, w, y, 1, M, K, N, dtype, tile_m, tile_n, stream);
}

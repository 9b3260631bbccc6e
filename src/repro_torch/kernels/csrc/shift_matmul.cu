// shift_matmul: y = x @ (s * 2^P) with the weight packed one int8 per element
// (bit 7 = sign, bits 0-6 = P + 64), for Hopper (sm_90a).
//
// Replaces the TPU kernel `shift_matmul_pallas` (`_shift_matmul_kernel`,
// `_assemble_bf16`) in repro/kernels/shift_matmul.py.
//
// What bounds it on an H100: memory. At the serving shapes (M = 6272 rows,
// K = N = 128) it moves x and y in float32 and the weight in one byte per
// element, a few MB, against a fraction of a GFLOP: the bytes take about ten
// times as long as the bf16 tensor-core work. The design therefore reads each
// weight as one byte and decodes it in shared memory to the exact bf16 power
// of two `sign << 15 | (P + 127) << 7`, and reads x once per output-column
// tile. The tiled product itself (fixed K order, masked edges, tile shape
// chosen at launch, rows bit-identical whatever M or the tile) is
// tile_matmul.cuh.
// The C function returns cudaGetLastError() after the launch.

#include "tile_matmul.cuh"

namespace {

struct DecodePo2 {
  static constexpr bool kBatched = false;
  // P + 127 = (P + 64) + 63: the bf16 exponent field, mantissa zero.
  static __device__ __forceinline__ __nv_bfloat16 load(const void* w, int64_t, int gk, int gn,
                                                       int, int N) {
    const unsigned u = __ldg(static_cast<const uint8_t*>(w) + static_cast<int64_t>(gk) * N + gn);
    const unsigned short bits =
        static_cast<unsigned short>(((u >> 7) << 15) | (((u & 0x7Fu) + 63u) << 7));
    return __ushort_as_bfloat16(bits);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Row-major, contiguous
// x (M, K), w (K, N) int8, y (M, N); tile_m, tile_n in {32, 64, 128}.
// Returns the launch's cudaError_t.
extern "C" int shift_matmul_launch(const void* x, const void* w, void* y, int M, int K, int N,
                                   int dtype, int tile_m, int tile_n, void* stream) {
  return tile_matmul::launch<DecodePo2>(x, w, y, 1, M, K, N, dtype, tile_m, tile_n, stream);
}

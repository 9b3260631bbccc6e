// add_matmul_packed: batched y[g] = x[g] @ b[g] with b in {-1, +1} packed one
// bit per element along K (bit j of packed[g, k8, n] is set iff
// b[g, 8 k8 + j, n] > 0), for Hopper (sm_90a).
//
// Replaces the TPU kernel `add_matmul_packed_pallas` (`_kernel`) in
// repro/kernels/add_matmul_packed.py. That kernel pads the packed operand to
// its tiles, decodes the padded bytes to -1 rows and relies on zero-padded x
// to cancel them; here the ragged edges are masked while staging
// (tile_matmul.cuh), so no padding is ever decoded. K is always 8 K8.
//
// What bounds it on an H100: memory, as for add_matmul; the code moves at one
// bit (8x fewer bytes than int8) and is decoded with shifts and byte
// permutes into exact bf16 +-1 in shared memory: one stored byte row gives 8
// rows of B.
// The C function returns cudaGetLastError() after the launch.

#include "tile_matmul.cuh"

namespace {

struct DecodeBit {
  static constexpr bool kBatched = true;
  static constexpr int kRows = 8;
  // Row r of the byte row takes bit r of each byte: set gives +1 (0x3F80),
  // clear gives -1 (0xBF80), so the bit flips bf16 -1's sign bit.
  static __device__ __forceinline__ void decode4(uint32_t w, uint2 (&out)[8]) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t bits = (w >> r) & 0x01010101u;
      out[r] = make_uint2(0xBF80BF80u ^ (__byte_perm(bits, 0, 0x4140) << 15),
                          0xBF80BF80u ^ (__byte_perm(bits, 0, 0x4342) << 15));
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it). Row-major, contiguous
// x (G, M, K), packed (G, K / 8, N) uint8, y (G, M, N); K must be a multiple
// of 8; (tile_m, tile_n) one of the shapes tile_matmul.cuh builds. Returns
// the launch's cudaError_t.
extern "C" int add_matmul_packed_launch(const void* x, const void* packed, void* y, int G, int M,
                                        int K, int N, int dtype, int tile_m, int tile_n,
                                        void* stream) {
  if (K % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return tile_matmul::launch<DecodeBit>(x, packed, y, G, M, K, N, dtype, tile_m, tile_n,
                                        stream);
}

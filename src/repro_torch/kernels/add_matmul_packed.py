"""`add_matmul_packed`: batched y = x @ b with b ∈ {-1, +1} packed one bit
per element along K — `pack_bits`/`unpack_bits` and the wrapper of the
hand-written CUDA kernel `csrc/add_matmul_packed.cu`.

Replaces the reference's Pallas kernel `add_matmul_packed_pallas` (with its
`pack_bits`, `unpack_bits`) in repro/kernels/add_matmul_packed.py.
Packing: bit j of packed[g, k8, n] is set iff b[g, 8·k8 + j, n] > 0. On a
CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (`unpack_bits`, then `ref.add_matmul_ref`).
`add_matmul_packed.launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, tile_matmul
from repro_torch.kernels.add_matmul import check_batched


def pack_bits(b):
    """b: (G, K, N) ±1 codes (int8 or float), K % 8 == 0 → (G, K/8, N) uint8."""
    g, k, n = b.shape
    if k % 8:
        raise ValueError(f"K must be a multiple of 8, got {k}")
    bits = (b > 0).to(torch.uint8).reshape(g, k // 8, 8, n)
    weights = (1 << torch.arange(8, device=b.device)).reshape(1, 1, 8, 1)
    return (bits * weights).sum(dim=2).to(torch.uint8)


def unpack_bits(packed, dtype=torch.float32):
    """(G, K8, N) uint8 → (G, 8·K8, N) ±1 in `dtype`."""
    g, k8, n = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device).reshape(1, 1, 8, 1)
    bits = (packed[:, :, None, :] >> shifts) & 1
    return (bits.to(dtype) * 2.0 - 1.0).reshape(g, k8 * 8, n)


def add_matmul_packed(x, packed, tile=None):
    """x: (G, M, K) float32|bf16; packed: (G, K/8, N) uint8 → (G, M, N) in
    x's dtype. K must equal 8 · packed.shape[1]."""
    check_batched(x, packed, "packed", torch.uint8, lambda k8: 8 * k8)
    tile = tile_matmul.check_tile(tile or tile_matmul.DEFAULT_TILE)
    if x.device.type == "cpu":
        return ref.add_matmul_ref(x, unpack_bits(packed))
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    g, m, k = x.shape
    n = packed.shape[2]
    tile_matmul.check_grid(g)
    y = tile_matmul.launch("add_matmul_packed", "add_matmul_packed_launch", x,
                           packed, (g, m, n), (g, m, k, n), tile)
    if y.numel():
        add_matmul_packed.launches += 1
    return y


add_matmul_packed.launches = 0

"""`add_matmul`: batched y = x @ b with b ∈ {-1, 0, +1} int8 — the wrapper
of the hand-written CUDA kernel `csrc/add_matmul.cu`.

Replaces the reference's Pallas kernel `add_matmul_pallas`
(repro/kernels/add_matmul.py). On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version
(`ref.add_matmul_ref`: x cast to bf16, float32 sums). `add_matmul.launches`
counts kernel launches. `tile` picks one of the built tile shapes
(`tile_matmul.TILES`); every tile gives the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, tile_matmul


def check_batched(x, b, name, dtype, k_of_b):
    """Raise on what the batched kernels do not take: x (G, M, K) float32 or
    bf16 and b (G, Kb, N) of `dtype` with k_of_b(Kb) == K, on one device,
    contiguous, no empty G or K."""
    if x.dim() != 3 or b.dim() != 3 or x.shape[0] != b.shape[0]:
        raise ValueError(f"expected x (G, M, K) and {name} (G, K', N), got "
                         f"{tuple(x.shape)} and {tuple(b.shape)}")
    if k_of_b(b.shape[1]) != x.shape[2]:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, {name} {tuple(b.shape)}")
    if x.shape[0] < 1 or x.shape[2] < 1:
        raise ValueError(f"empty G or K: x {tuple(x.shape)}")
    if x.dtype not in tile_matmul.DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if b.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {b.dtype}")
    if x.device != b.device:
        raise ValueError(f"x on {x.device}, {name} on {b.device}")
    if not (x.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"x and {name} must be contiguous")


def add_matmul(x, b, tile=None):
    """x: (G, M, K) float32|bf16; b: (G, K, N) int8 → (G, M, N) in x's dtype."""
    check_batched(x, b, "b", torch.int8, lambda kb: kb)
    tile = tile_matmul.check_tile(tile or tile_matmul.DEFAULT_TILE)
    if x.device.type == "cpu":
        return ref.add_matmul_ref(x, b)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    g, m, k = x.shape
    n = b.shape[2]
    tile_matmul.check_grid(g)
    y = tile_matmul.launch("add_matmul", "add_matmul_launch", x, b,
                           (g, m, n), (g, m, k, n), tile)
    if y.numel():
        add_matmul.launches += 1
    return y


add_matmul.launches = 0

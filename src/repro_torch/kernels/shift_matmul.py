"""`shift_matmul`: y = x @ (s * 2^P), packed int8 weights — the wrapper of
the hand-written CUDA kernel `csrc/shift_matmul.cu`.

Replaces the reference's Pallas kernel `shift_matmul_pallas`
(repro/kernels/shift_matmul.py). On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version
(`ref.shift_matmul_ref`), which repeats the kernel's arithmetic.
`shift_matmul.launches` counts kernel launches (plain-version calls are not
counted). `tile` picks one of the built tile shapes (`tile_matmul.TILES`);
every tile gives the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, tile_matmul


def check_args(x, w_packed):
    """Raise on what the kernel does not take: x (M, K) float32 or bf16,
    w_packed (K, N) int8 on x's device, both contiguous, K >= 1."""
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError(f"expected x (M, K) and w_packed (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    if x.shape[1] != w_packed.shape[0]:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, w_packed "
                         f"{tuple(w_packed.shape)}")
    if x.shape[1] < 1:
        raise ValueError("K must be at least 1")
    if x.dtype not in tile_matmul.DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_packed.dtype != torch.int8:
        raise TypeError(f"w_packed must be int8, got {w_packed.dtype}")
    if x.device != w_packed.device:
        raise ValueError(f"x on {x.device}, w_packed on {w_packed.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("x and w_packed must be contiguous")


def shift_matmul(x, w_packed, tile=None):
    """x: (M, K) float32|bf16; w_packed: (K, N) int8 → (M, N) in x's dtype."""
    check_args(x, w_packed)
    tile = tile_matmul.check_tile(tile or tile_matmul.DEFAULT_TILE)
    if x.device.type == "cpu":
        return ref.shift_matmul_ref(x, w_packed)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    m, k = x.shape
    n = w_packed.shape[1]
    y = tile_matmul.launch("shift_matmul", "shift_matmul_launch", x, w_packed,
                           (m, n), (m, k, n), tile)
    if y.numel():
        shift_matmul.launches += 1
    return y


shift_matmul.launches = 0

"""`shift_matmul`: y = x @ (s * 2^P), packed int8 weights — the wrapper of
the hand-written CUDA kernel `csrc/shift_matmul.cu`.

Replaces the reference's Pallas kernel `shift_matmul_pallas`
(repro/kernels/shift_matmul.py). On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version
(`ref.shift_matmul_ref`), which repeats the kernel's arithmetic.
`shift_matmul.launches` counts kernel launches (plain-version calls are not
counted).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_M = 65535 * 64          # grid.y limit times the 64-row tile


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
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_packed.dtype != torch.int8:
        raise TypeError(f"w_packed must be int8, got {w_packed.dtype}")
    if x.device != w_packed.device:
        raise ValueError(f"x on {x.device}, w_packed on {w_packed.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("x and w_packed must be contiguous")
    if x.shape[0] > _MAX_M:
        raise ValueError(f"M={x.shape[0]} exceeds the kernel's grid ({_MAX_M})")


def shift_matmul(x, w_packed):
    """x: (M, K) float32|bf16; w_packed: (K, N) int8 → (M, N) in x's dtype."""
    check_args(x, w_packed)
    if x.device.type == "cpu":
        return ref.shift_matmul_ref(x, w_packed)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    from repro_torch.kernels import build

    lib = build.load("shift_matmul")
    fn = lib.shift_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    m, k = x.shape
    n = w_packed.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_packed.data_ptr(), y.data_ptr(), m, k, n,
                 _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"shift_matmul kernel launch failed: CUDA error {err}")
    shift_matmul.launches += 1
    return y


shift_matmul.launches = 0

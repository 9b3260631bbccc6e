"""`dense_matmul`: y = x @ w (+ b) in float32, each output one chain of FMAs
in K order — the wrapper of the hand-written CUDA kernel
`csrc/dense_matmul.cu`.

Replaces no TPU kernel: the reference leaves its dense linears to XLA
(repro/core/dense.py). It carries the port's `Dense` linears on the card
because cuBLAS, which `torch.matmul` calls, picks its algorithm and so its
summation order by the row count, and an image's logits then changed with
the bucket it was served in. The kernel's sums are fixed by K alone, so a
row's bits never depend on M, nor on the tile the launch takes
(`launch_tile`). On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version
(`ref.dense_matmul_ref`). `dense_matmul.launches` counts kernel launches.
The kernel has no backward, so the wrapper raises, on any device, when
autograd would need one: a gradient through `Dense` takes impl="torch".
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

# (tile_m, tile_n) shapes built by csrc/dense_matmul.cu, largest first.
TILES = ((64, 64), (32, 64), (32, 32))
MAX_ROW_TILES = 65535      # the kernel's grid over M


def launch_tile(m: int, n: int, sms: int) -> tuple:
    """The tile a launch takes: the largest of `TILES` whose grid has at
    least one block per SM, with 64-wide tiles skipped for N <= 32; the
    smallest where none has. No tile changes an output's bits."""
    for tm, tn in TILES:
        if tn > 32 and n <= 32:
            continue
        if -(-m // tm) * -(-n // tn) >= sms:
            return tm, tn
    return TILES[-1]


def check_args(x, w, bias):
    """Raise on what the kernel does not take: x (M, K), w (K, N) and bias
    (N,) or None, float32, contiguous, on one device, K >= 1."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.shape[1] < 1:
        raise ValueError("K must be at least 1")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias must be ({w.shape[1]},), got {tuple(bias.shape)}")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _launcher():
    """The C launch, built at first use, its argument types set once."""
    from repro_torch.kernels import build

    fn = build.load("dense_matmul").dense_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dense_matmul(x, w, bias=None):
    """x: (M, K), w: (K, N), bias: (N,) or None, float32 → (M, N) float32."""
    check_args(x, w, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, w, bias)):
        raise RuntimeError("dense_matmul has no backward; for a gradient "
                           "through Dense, call it with impl=\"torch\"")
    if x.device.type == "cpu":
        return ref.dense_matmul_ref(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return y
    from repro_torch.kernels.tile_matmul import _sms

    tm, tn = launch_tile(m, n, _sms(x.device.index))
    if -(-m // tm) > MAX_ROW_TILES:
        raise ValueError(f"M={m} exceeds the kernel's grid ({MAX_ROW_TILES} row tiles)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), w.data_ptr(),
                          None if bias is None else bias.data_ptr(), y.data_ptr(),
                          m, k, n, tm, tn, stream)
    if err != 0:
        raise RuntimeError(f"dense_matmul kernel launch failed: CUDA error {err}")
    dense_matmul.launches += 1
    return y


dense_matmul.launches = 0

"""`bidir_binary_attention`: non-causal Hamming-code linear attention — the
wrapper of the hand-written CUDA kernel `csrc/bidir_linear_attention.cu`.

Replaces the reference's Pallas kernel `bidir_binary_attention_pallas`
(repro/kernels/bidir_linear_attention.py). Unlike it, there is no cap on N
and the head dim is not padded. Head dims above 128 run with Dv split
across blocks (`dv_slice`), as far as `max_dk` (1410 for this kernel, any
Dv). On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version (`ref.bidir_binary_attention_ref`).
`bidir_binary_attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import SMEM_PER_BLOCK, ref

TILE = 32          # row tile of csrc/bidir_linear_attention.cu
THREADS = 256
WHOLE_DV = 128     # Dv up to this runs as one slice when the block fits
SLICES = (64, 32, 16, 8)   # narrower Dv slices, widest first


def smem_bytes(dk: int, dvs: int) -> int:
    """Shared memory of one block with a slice of `dvs` columns of v: the KV
    slice, ksum, the vsum slice and one row tile of codes, values and
    denominators."""
    return 4 * (dk * dvs + dk + dvs + TILE * (dk + dvs) + TILE)


def dv_slice(dk: int, dv: int, smem=smem_bytes):
    """The columns of v one block takes: all of Dv when Dv <= 128 and the
    block fits, else the widest of `SLICES` below Dv that fits; None when no
    slice fits. `smem(dk, width)` is the kernel's shared memory per block.
    Each output and carry entry is summed in the same order at every width,
    so the width never changes a result."""
    widths = ([dv] if dv <= WHOLE_DV else []) + [s for s in SLICES if s < dv]
    return next((w for w in widths if smem(dk, w) <= SMEM_PER_BLOCK), None)


def max_dk(smem=smem_bytes) -> int:
    """The largest Dk at which the narrowest slice still fits a block."""
    dk = 1
    while smem(dk + 1, SLICES[-1]) <= SMEM_PER_BLOCK:
        dk += 1
    return dk


def check_args(q, k, v, smem=smem_bytes) -> int:
    """Raise on what the kernel does not take: q, k (G, N, Dk) and
    v (G, N, Dv), float32, contiguous, one device, no empty dim, and a
    Dv slice whose block fits (`dv_slice`; Dk up to `max_dk(smem)`).
    Returns the slice width."""
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"expected q, k (G, N, Dk) and v (G, N, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError(f"q, k, v must be float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if min(q.shape) < 1 or v.shape[-1] < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, v {tuple(v.shape)}")
    dk, dv = q.shape[-1], v.shape[-1]
    width = dv_slice(dk, dv, smem)
    if width is None:
        raise ValueError(f"no slice of Dv fits a block's {SMEM_PER_BLOCK} B of "
                         f"shared memory: Dk up to {max_dk(smem)} is supported, "
                         f"got Dk={dk}, Dv={dv}")
    return width


def bidir_binary_attention(q, k, v):
    """q, k: (G, N, Dk); v: (G, N, Dv), float32 → (G, N, Dv) float32."""
    width = check_args(q, k, v)
    if q.device.type == "cpu":
        return ref.bidir_binary_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    from repro_torch.kernels import build

    lib = build.load("bidir_linear_attention")
    fn = lib.bidir_binary_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g, n, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty((g, n, dv), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 g, n, dk, dv, width, stream)
    if err != 0:
        raise RuntimeError(
            f"bidir_binary_attention kernel launch failed: CUDA error {err}")
    bidir_binary_attention.launches += 1
    return out


bidir_binary_attention.launches = 0

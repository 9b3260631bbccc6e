"""`bidir_binary_attention`: non-causal Hamming-code linear attention — the
wrapper of the hand-written CUDA kernel `csrc/bidir_linear_attention.cu`.

Replaces the reference's Pallas kernel `bidir_binary_attention_pallas`
(repro/kernels/bidir_linear_attention.py). Unlike it, there is no cap on N
and the head dim is not padded. On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version
(`ref.bidir_binary_attention_ref`). `bidir_binary_attention.launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

MAX_HEAD_DIM = 128
TILE = 32          # row tile of csrc/bidir_linear_attention.cu
THREADS = 256


def smem_bytes(dk: int, dv: int) -> int:
    """Shared memory of one block: KV, ksum, vsum and one row tile of codes,
    values and denominators."""
    return 4 * (dk * dv + dk + dv + TILE * (dk + dv) + TILE)


def check_args(q, k, v):
    """Raise on what the kernel does not take: q, k (G, N, Dk) and
    v (G, N, Dv), float32, contiguous, one device, no empty dim, and
    Dk, Dv <= 128."""
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
    if q.shape[-1] > MAX_HEAD_DIM or v.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dims up to {MAX_HEAD_DIM} are supported, got "
                         f"Dk={q.shape[-1]}, Dv={v.shape[-1]}")


def bidir_binary_attention(q, k, v):
    """q, k: (G, N, Dk); v: (G, N, Dv), float32 → (G, N, Dv) float32."""
    check_args(q, k, v)
    if q.device.type == "cpu":
        return ref.bidir_binary_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    from repro_torch.kernels import build

    lib = build.load("bidir_linear_attention")
    fn = lib.bidir_binary_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g, n, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty((g, n, dv), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 g, n, dk, dv, stream)
    if err != 0:
        raise RuntimeError(
            f"bidir_binary_attention kernel launch failed: CUDA error {err}")
    bidir_binary_attention.launches += 1
    return out


bidir_binary_attention.launches = 0

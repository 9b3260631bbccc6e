"""`bidir_binary_attention`: non-causal Hamming-code linear attention — the
wrapper of the hand-written CUDA kernel `csrc/bidir_linear_attention.cu`.

Replaces the reference's Pallas kernel `bidir_binary_attention_pallas`
(repro/kernels/bidir_linear_attention.py). Unlike it, there is no cap on N
and the head dim is not padded. The kernel splits N over a thread-block
cluster of C blocks per batch·head, each owning `span` consecutive rows
(`partition`: fixed by N alone, passed to the kernel at launch). It reads
q, k and v as (B, H, N, D) views through their batch, head and row strides
and writes out into a (B, N, H, Dv) buffer, returned as its (B, H, N, Dv)
view, so the serving path makes no layout copy. Head
dims above 128 run with Dv split across clusters (`dv_slice`), as far as
`max_dk` (785 for this kernel, any Dv). On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs the plain version
(`ref.bidir_binary_attention_ref`). `bidir_binary_attention.launches`
counts kernel launches.

`check_args` is the contiguous (G, N, D) check that the causal kernel
(`linear_attention.py`) shares, with its own block size.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import SMEM_PER_BLOCK, ref

TILE = 32          # row tile of csrc/bidir_linear_attention.cu
PAD = 4            # floats after each k or q row of a tile in shared memory
THREADS = 128
MAX_CLUSTER = 8    # blocks per cluster: the portable cluster size
WHOLE_DV = 128     # Dv up to this runs as one slice when the block fits
SLICES = (64, 32, 16, 8)   # narrower Dv slices, widest first


def cluster_size(n: int) -> int:
    """Blocks that share one batch·head's rows: min(8, ceil(N / 32)), a
    function of N alone."""
    return min(MAX_CLUSTER, -(-n // TILE))


def partition(n: int) -> tuple:
    """(C, span): the cluster size and the rows each block owns. Block
    `rank` of a cluster takes rows [rank·span, min(N, (rank + 1)·span)); the
    kernel takes both from the launch, so this is the partition it runs."""
    c = cluster_size(n)
    return c, -(-n // c)


def smem_bytes(dk: int, dvs: int) -> int:
    """Shared memory of one block with a slice of `dvs` columns of v: a
    two-stage ring of TILE rows of k (or q, at pitch Dk + PAD) and of v's
    slice, and the sums (KV slice, ksum, vsum slice), which hold the block's
    partials and then the full sums."""
    return 4 * (2 * TILE * (dk + PAD + dvs) + dk * dvs + dk + dvs)


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


def _slice_width(dk: int, dv: int, smem) -> int:
    width = dv_slice(dk, dv, smem)
    if width is None:
        raise ValueError(f"no slice of Dv fits a block's {SMEM_PER_BLOCK} B of "
                         f"shared memory: Dk up to {max_dk(smem)} is supported, "
                         f"got Dk={dk}, Dv={dv}")
    return width


def _check_common(q, k, v):
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError(f"q, k, v must be float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if min(q.shape) < 1 or v.shape[-1] < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, v {tuple(v.shape)}")


def check_args(q, k, v, smem=smem_bytes) -> int:
    """Raise on what a kernel of contiguous operands does not take: q, k
    (G, N, Dk) and v (G, N, Dv), float32, contiguous, one device, no empty
    dim, and a Dv slice whose block fits (`dv_slice`; Dk up to
    `max_dk(smem)`). Returns the slice width."""
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"expected q, k (G, N, Dk) and v (G, N, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check_common(q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    return _slice_width(q.shape[-1], v.shape[-1], smem)


def check_views(q, k, v) -> int:
    """Raise on what this kernel does not take: q, k (B, H, N, Dk) and
    v (B, H, N, Dv), or (G, N, D) each, float32, one device, no empty dim,
    the last dim of each with stride 1 (any batch, head and row strides),
    and a Dv slice whose block fits (Dk up to `max_dk()`). Returns the
    slice width."""
    if (q.dim() not in (3, 4) or k.shape != q.shape or v.dim() != q.dim()
            or v.shape[:-1] != q.shape[:-1]):
        raise ValueError(f"expected q, k (B, H, N, Dk) and v (B, H, N, Dv), or "
                         f"(G, N, D) each, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_common(q, k, v)
    if any(t.stride(-1) != 1 and t.shape[-1] > 1 for t in (q, k, v)):
        raise ValueError("the last dim of q, k and v must have stride 1")
    return _slice_width(q.shape[-1], v.shape[-1], smem_bytes)


def view_strides(t) -> tuple:
    """(batch, head, row) strides of a (B, H, N, D) view, in elements; 0
    where that dim has size 1 (its stride is never used)."""
    return tuple(0 if t.shape[d] == 1 else t.stride(d) for d in range(3))


def out_buffer(b: int, h: int, n: int, dv: int, device) -> torch.Tensor:
    """The output: a (B, N, H, Dv) buffer, as its (B, H, N, Dv) view, so
    that `permute(0, 2, 1, 3).reshape(B, N, H·Dv)` copies nothing."""
    return torch.empty((b, n, h, dv), dtype=torch.float32,
                       device=device).permute(0, 2, 1, 3)


def launch_args(q, k, v, out, width: int) -> tuple:
    """The integers the C launch takes after the four pointers: B, H, N,
    Dk, Dv, the slice width, the cluster size and the rows per block
    (`partition`), then the batch, head and row strides of q, k, v and out.
    All four are (B, H, N, D) views."""
    b, h, n, dk = q.shape
    strides = sum((view_strides(t) for t in (q, k, v, out)), ())
    return (b, h, n, dk, v.shape[-1], width) + partition(n), strides


@functools.cache
def _launcher():
    """The C launch, built at first use, its argument types set once."""
    from repro_torch.kernels import build

    fn = build.load("bidir_linear_attention").bidir_binary_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bidir_binary_attention(q, k, v):
    """q, k: (B, H, N, Dk); v: (B, H, N, Dv), float32, any batch, head and
    row strides → (B, H, N, Dv) float32, a view of a (B, N, H, Dv) buffer on
    the card. (G, N, D) inputs give (G, N, Dv), contiguous."""
    width = check_views(q, k, v)
    if q.device.type == "cpu":
        return ref.bidir_binary_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    flat = q.dim() == 3
    q4, k4, v4 = (t.unsqueeze(1) if flat else t for t in (q, k, v))
    b, h, n, _ = q4.shape
    out = out_buffer(b, h, n, v4.shape[-1], q.device)
    ints, strides = launch_args(q4, k4, v4, out, width)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _launcher()(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out.data_ptr(),
                          *ints, (ctypes.c_int64 * 12)(*strides), stream)
    if err != 0:
        raise RuntimeError(
            f"bidir_binary_attention kernel launch failed: CUDA error {err}")
    bidir_binary_attention.launches += 1
    return out[:, 0] if flat else out


bidir_binary_attention.launches = 0

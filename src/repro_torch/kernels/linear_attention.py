"""`binary_linear_attention`: causal chunked Hamming-code linear attention —
the wrapper of the hand-written CUDA kernel `csrc/linear_attention.cu`.

Replaces the reference's Pallas kernel `binary_linear_attention_pallas`
(repro/kernels/linear_attention.py). Unlike it, N is not padded to the chunk
(the kernel stops at the last row) and the head dims are not padded; head
dims above 128 run with Dv split across blocks
(`bidir_linear_attention.dv_slice` with this kernel's `smem_bytes`: Dk up to
774, any Dv). On a
CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor it
runs the plain version (`ref.binary_linear_attention_ref`, the quadratic
oracle, and `ref.binary_linear_attention_state_ref`).
`binary_linear_attention.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bidir_linear_attention import check_args

CHUNK = 256
SUB_TILE = 32      # row sub-tile of csrc/linear_attention.cu
THREADS = 256


def smem_bytes(dk: int, dvs: int) -> int:
    """Shared memory of one block with a slice of `dvs` columns of v: the
    carry (KV slice, ksum, vsum slice) and the sub-tiles of query codes, key
    codes, values, scores and sums."""
    r = SUB_TILE
    return 4 * (dk * dvs + dk + dvs + r * (2 * dk + 2 * dvs) + r * r + r)


def binary_linear_attention(q, k, v, chunk=CHUNK, return_state=False):
    """q, k: (G, N, Dk); v: (G, N, Dv), float32; causal, each row sees
    itself → out (G, N, Dv) float32, and with return_state also the final
    carry kv (G, Dk, Dv), ksum (G, Dk), vsum (G, Dv) in float32."""
    width = check_args(q, k, v, smem_bytes)
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    if q.device.type == "cpu":
        out = ref.binary_linear_attention_ref(q, k, v, causal=True)
        if not return_state:
            return out
        st = ref.binary_linear_attention_state_ref(q, k, v)
        return out, st["kv"], st["ksum"], st["vsum"]
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    from repro_torch.kernels import build

    fn = build.load("linear_attention").binary_linear_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g, n, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty((g, n, dv), dtype=torch.float32, device=q.device)
    state = ()
    if return_state:
        state = tuple(torch.empty(s, dtype=torch.float32, device=q.device)
                      for s in ((g, dk, dv), (g, dk), (g, dv)))
    ptrs = [t.data_ptr() for t in state] or [None] * 3
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ptrs,
                 g, n, dk, dv, chunk, width, stream)
    if err != 0:
        raise RuntimeError(
            f"binary_linear_attention kernel launch failed: CUDA error {err}")
    binary_linear_attention.launches += 1
    return (out, *state) if return_state else out


binary_linear_attention.launches = 0

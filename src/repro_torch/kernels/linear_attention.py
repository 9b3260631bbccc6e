"""`binary_linear_attention`: causal chunked Hamming-code linear attention —
the wrapper of the hand-written CUDA kernels `csrc/linear_attention.cu`.

Replaces the reference's Pallas kernel `binary_linear_attention_pallas`
(repro/kernels/linear_attention.py). Unlike it, N is not padded to the chunk
(the kernels stop at the last row) and the head dims are not padded. One
call runs two to four kernels (`passes`): the ±1 codes of q and k packed
32 to a word, the partial carry of each chunk, the prefix over those
partials in chunk order, and the outputs, one block per (batch·head, 32
query rows of a chunk, Dv slice). The partition (`partition`: chunks and
query tiles, fixed by N and the chunk alone), the Dv slice and the shapes
of the workspaces (carry records, codes) come from `launch_args`, which
the kernels are launched with; a call whose carry records would pass
WORK_BYTES runs its batch·heads in groups, one launch each. Head dims
above 128 run with Dv split across blocks (Dk up to 9120, any Dv). On a CUDA tensor the wrapper
launches the kernels or raises; on a CPU tensor it runs the plain version
(`ref.binary_linear_attention_ref`, the quadratic oracle, and
`ref.binary_linear_attention_state_ref`).
`binary_linear_attention.launches` counts calls that launched the kernels:
one per call, whatever the number of kernels the call runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bidir_linear_attention import SLICES, check_args, dv_slice

CHUNK = 256
ROWS = 32          # rows of a query tile, a key tile and a ring stage
THREADS = 128
STAGES = 3         # ring stages of the partials kernel
SMS = 132          # the H100's SMs: narrower Dv slices until the output pass has this many blocks
WORK_BYTES = 1 << 30   # carry records one launch may hold; more batch·heads run in groups
KERNELS = ("binary_linear_attention_codes_kernel", "binary_linear_attention_partials_kernel",
           "binary_linear_attention_scan_kernel", "binary_linear_attention_out_kernel")


def _round4(x: int) -> int:
    return -(-x // 4) * 4


def words(dk: int) -> int:
    """Code words per row: 32 head dims a word."""
    return -(-dk // 32)


def smem_bytes(dk: int, dvs: int) -> int:
    """Shared memory of the larger of the two tiled kernels' blocks at a
    slice of `dvs` columns of v (its pitch rounded up to 8 floats). The
    partials block holds a ring of STAGES stages of ROWS rows of v's slice
    and one code word a row. The output block holds a ring of four stages
    (three above a pitch of 64) of ROWS rows of v's slice (or the carry's
    KV) and of key codes (an odd number of words a row), two buffers of
    ROWS x ROWS weights, the carry's ksum and vsum slice, four parts of the
    denominators, and the codes of ROWS queries."""
    vp, wp = -(-dvs // 8) * 8, words(dk) | 1
    partials = STAGES * ROWS * (vp + 1)
    out = ((3 if vp > 64 else 4) * ROWS * (vp + wp) + 2 * ROWS * ROWS + _round4(dk) + vp
           + 4 * ROWS + ROWS * wp)
    return 4 * max(partials, out)


def partition(n: int, chunk: int) -> tuple:
    """(chunk, chunks, tiles per chunk, tiles): the chunk capped at N, the
    number of chunks, and the query tiles of ROWS rows. Tile τ lies in chunk
    τ // per and starts at row chunk·(τ // per) + ROWS·(τ % per); only the
    last chunk may have fewer tiles. A function of N and the chunk alone."""
    chunk = min(int(chunk), n)
    chunks = -(-n // chunk)
    per = -(-chunk // ROWS)
    tiles = (chunks - 1) * per + -(-(n - (chunks - 1) * chunk) // ROWS)
    return chunk, chunks, per, tiles


def records(chunks: int, state: bool) -> int:
    """Carry records in the workspace per batch·head: one per chunk that has
    a successor, and one more for the final state."""
    return chunks - 1 + int(state)


def passes(chunks: int, state: bool) -> tuple:
    """The kernels one call runs, in order: the codes always, the partials
    when any record is needed, the prefix scan unless one record alone is
    the carry, and the outputs always."""
    n = records(chunks, state)
    codes, partials, scan, out = KERNELS
    return ((codes,) + ((partials,) if n else ()) + ((scan,) if n > 1 or state else ())
            + (out,))


def slice_width(g: int, tiles: int, dk: int, dv: int) -> int:
    """The columns of v one block takes: the widest slice that fits
    (`dv_slice`), narrowed through `SLICES` while the output pass would have
    fewer than SMS blocks. No width changes a bit of the result."""
    width = dv_slice(dk, dv, smem_bytes)
    narrower = [s for s in SLICES if s < width]
    while narrower and g * tiles * -(-dv // width) < SMS:
        width = narrower.pop(0)
    return width


def launch_args(q, v, chunk: int, state: bool) -> tuple:
    """(ints, workspace shape, codes shape) of one launch: the integers the
    C launch takes after its nine pointers — the batch·heads of the launch,
    N, Dk, Dv, then the partition (chunk, ROWS, tiles per chunk, tiles),
    the records and the Dv slice — the shape of the float32 workspace of
    carry records, (batch·heads, records, Dk·Dv + Dk + Dv), or None with
    no record, and that of the int32 codes, (2, batch·heads, N,
    ceil(Dk / 32)). A launch takes all G batch·heads unless their records
    would pass WORK_BYTES; then it takes as many as fit (at least one), and
    the call runs the launches one after another. q: (G, N, Dk);
    v: (G, N, Dv)."""
    g, n, dk = q.shape
    dv = v.shape[-1]
    chunk, chunks, per, tiles = partition(n, chunk)
    rec = records(chunks, state)
    entries = dk * dv + dk + dv
    group = g if not rec else max(1, min(g, WORK_BYTES // (4 * rec * entries)))
    ints = (group, n, dk, dv, chunk, ROWS, per, tiles, rec, slice_width(g, tiles, dk, dv))
    return ints, ((group, rec, entries) if rec else None), (2, group, n, words(dk))


@functools.cache
def _launcher():
    """The C launch, built at first use, its argument types set once."""
    from repro_torch.kernels import build

    fn = build.load("linear_attention").binary_linear_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def binary_linear_attention(q, k, v, chunk=CHUNK, return_state=False):
    """q, k: (G, N, Dk); v: (G, N, Dv), float32; causal, each row sees
    itself → out (G, N, Dv) float32, and with return_state also the final
    carry kv (G, Dk, Dv), ksum (G, Dk), vsum (G, Dv) in float32."""
    check_args(q, k, v, smem_bytes)
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
    ints, work_shape, codes_shape = launch_args(q, v, chunk, return_state)
    group, n, dk, dv = ints[:4]
    g = q.shape[0]
    dev = q.device
    out = torch.empty((g, n, dv), dtype=torch.float32, device=dev)
    state = ()
    if return_state:
        state = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                      for s in ((g, dk, dv), (g, dk), (g, dv)))
    work = (torch.empty(work_shape, dtype=torch.float32, device=dev)
            if work_shape else None)
    codes = torch.empty(codes_shape, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for g0 in range(0, g, group):
        # A batch·head's bits do not depend on the others in its launch.
        part = slice(g0, g0 + group)
        ptrs = [t[part].data_ptr() for t in state] or [None] * 3
        with torch.cuda.device(dev):
            err = _launcher()(q[part].data_ptr(), k[part].data_ptr(), v[part].data_ptr(),
                              out[part].data_ptr(), *ptrs,
                              None if work is None else work.data_ptr(), codes.data_ptr(),
                              min(group, g - g0), *ints[1:], stream)
        if err != 0:
            raise RuntimeError(
                f"binary_linear_attention kernel launch failed: CUDA error {err}")
    binary_linear_attention.launches += 1
    return (out, *state) if return_state else out


binary_linear_attention.launches = 0

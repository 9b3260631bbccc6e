"""What the three matmul kernels share (`csrc/tile_matmul.cuh`): the tile
shapes built, the tile a launch really takes, the shared memory and threads
of one block, and the ctypes launch.

`shift_matmul`, `add_matmul` and `add_matmul_packed` differ only in how the
second operand is stored and decoded. Each takes a tile (tile_m, tile_n)
from `TILES`: the rows of one M tile and the output columns of one block.
The kernel's grid is persistent over M, each block decodes its column
slice of the second operand once, and x streams through a two-stage ring
holding the whole K extent (up to `KC`) of a tile. A tile larger than the
product is shrunk to it, and a tile that would leave SMs idle is shrunk
until the grid covers them (`launch_tile`), so a small batched product (the
attention's 32 x 196 x 32 per batch·head) runs one block per batch entry
with nothing masked. Every output element is the same chain of 16-deep
tensor-core steps in K order whatever the tile, so every tile gives
bit-identical output.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# (tile_m, tile_n) shapes built by csrc/tile_matmul.cuh: 16-row warp tiles
# stacked 1, 2 or 4 high, at most 64 float32 sums per thread.
TILES = tuple((tm, tn) for tm in (16, 32, 64) for tn in (32, 64, 128, 256)
              if tm * tn <= 64 * 128)
DEFAULT_TILE = (32, 64)
SMS = 132           # SMs of an H100 SXM: launch_tile's count off the card
KC = 256            # K held in shared memory at once (csrc KC)
STAGES = 2          # x tiles in the ring
PAD = 8             # elements added to every shared row
THREADS = 128
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Z = 65535


def launch_tile(tile, g: int, m: int, n: int, sms: int = SMS) -> tuple:
    """The tile a launch of g batched (m × k) @ (k × n) products really
    takes: each side halved while the half still covers the product (down to
    16 rows and 32 columns), then, while the grid would have fewer blocks
    than the card has SMs, the columns halved, then the rows. The output's
    bits never depend on it."""
    tm, tn = tile
    while tm > 16 and tm // 2 >= m:
        tm //= 2
    while tn > 32 and tn // 2 >= n:
        tn //= 2
    while g * -(-m // tm) * -(-n // tn) < sms:
        if tn > 32:
            tn //= 2
        elif tm > 16:
            tm //= 2
        else:
            break
    return tm, tn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def smem_bytes(tile, k: int, elem_bytes: int = 4) -> int:
    """Shared memory of one block (`smem_bytes<T, BM, BN>` in the header):
    the decoded bf16 panel of the second operand, kc × tile_n, and the x
    ring, STAGES × tile_m × kc, with kc = min(k rounded up to 16, KC)."""
    tm, tn = tile
    kc = min(-(-k // 16) * 16, KC)
    return kc * (tn + PAD) * 2 + STAGES * tm * (kc + PAD) * elem_bytes


def check_tile(tile) -> tuple:
    tile = tuple(int(t) for t in tile)
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    return tile


def check_grid(g: int):
    if g > _MAX_GRID_Z:
        raise ValueError(f"G={g} exceeds the kernel's grid ({_MAX_GRID_Z})")


def launch(source: str, symbol: str, x, b, out_shape, dims, tile):
    """Launch `symbol` from `csrc/<source>.cu` as
    symbol(x, b, y, *dims, dtype, tile_m, tile_n, stream) with the tile
    `launch_tile` gives for dims ([g,] m, k, n) on x's card, and return y,
    in x's dtype. Raises if the launch reports an error."""
    from repro_torch.kernels import build

    fn = getattr(build.load(source), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (len(dims) + 3)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    g = dims[0] if len(dims) == 4 else 1
    tm, tn = launch_tile(tile, g, dims[-3], dims[-1], _sms(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), b.data_ptr(), y.data_ptr(), *dims,
                 DTYPE_CODE[x.dtype], tm, tn, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return y

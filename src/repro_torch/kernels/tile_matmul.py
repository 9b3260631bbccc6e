"""What the three tiled matmul kernels share (`csrc/tile_matmul.cuh`): the
tile shapes built, the shared memory and threads of one block, and the
ctypes launch.

`shift_matmul`, `add_matmul` and `add_matmul_packed` differ only in how the
second operand is stored and decoded. Each takes a tile (tile_m, tile_n) from
`TILES`; the K panel is fixed, so every tile gives bit-identical output.
"""
from __future__ import annotations

import ctypes

import torch

TILES = (32, 64, 128)          # tile_m and tile_n, each; csrc/tile_matmul.cuh
DEFAULT_TILE = (64, 64)
PANEL_K = 32
THREADS = 128
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def smem_bytes(tile_m: int, tile_n: int) -> int:
    """Shared memory of one block (`Layout<BM, BN>::BYTES`): the bf16 x and
    B panels while summing, then the float32 output tile, never at once."""
    panels = 2 * (tile_m * (PANEL_K + 8) + PANEL_K * (tile_n + 8))
    out = 4 * tile_m * (tile_n + 4)
    return max(panels, out)


def check_tile(tile) -> tuple:
    tile = tuple(int(t) for t in tile)
    if len(tile) != 2 or tile[0] not in TILES or tile[1] not in TILES:
        raise ValueError(f"tile must be (tile_m, tile_n) with each in {TILES}, got {tile}")
    return tile


def check_grid(g: int, m: int, tile):
    if g > _MAX_GRID_YZ or -(-m // tile[0]) > _MAX_GRID_YZ:
        raise ValueError(f"G={g}, M={m} exceed the kernel's grid at tile {tile}")


def launch(source: str, symbol: str, x, b, out_shape, dims, tile):
    """Launch `symbol` from `csrc/<source>.cu` as
    symbol(x, b, y, *dims, dtype, tile_m, tile_n, stream) and return y, in
    x's dtype. Raises if the launch reports an error."""
    from repro_torch.kernels import build

    fn = getattr(build.load(source), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * (len(dims) + 3)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), b.data_ptr(), y.data_ptr(), *dims,
                 DTYPE_CODE[x.dtype], tile[0], tile[1], stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return y

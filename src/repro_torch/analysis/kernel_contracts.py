"""The serving sites of every kernel and the block-resource check of a
launch configuration. Counterpart of part of
`repro/analysis/kernel_contracts.py`: `MATMUL_KERNELS`, `serving_sites` (the
same dicts as the reference's) and, in place of its 16 MiB VMEM model, a
Hopper check — shared memory per block at most 227 KB and at most 1024
threads per block. The rest of the reference's contract table (roofline
cells, pad waste, findings) is not ported yet.
"""
from __future__ import annotations

from repro_torch.kernels import (SMEM_PER_BLOCK, bidir_linear_attention,
                                 linear_attention, tile_matmul)

MATMUL_KERNELS = ("shift_matmul", "add_matmul", "add_matmul_packed")
THREADS_PER_BLOCK = 1024


def serving_sites(cfg, b) -> list:
    """Every kernel's serving call-site geometry at batch-bucket b, as plain
    dicts, equal to the reference's `serving_sites`.

    Projections see (B·N_patches, d) token matrices; the binary attention
    matmuls group over B·heads with per-head (dh) feature dims; MoE experts
    see at most the full token load (the per-image capacity split only
    shrinks M)."""
    n, d, f, h = cfg.n_patches, cfg.d_model, cfg.d_ff, cfg.n_heads
    dh = d // h
    toks = b * n
    return [
        dict(kernel="shift_matmul", site="qkvo_proj", g=1, m=toks, k=d, n=d,
             w_bytes=1, adapt_bn=False),
        dict(kernel="shift_matmul", site="moe_shift_up", g=1, m=toks, k=d,
             n=f, w_bytes=1, adapt_bn=False),
        dict(kernel="shift_matmul", site="moe_shift_down", g=1, m=toks, k=f,
             n=d, w_bytes=1, adapt_bn=False),
        dict(kernel="add_matmul", site="ktv", g=b * h, m=dh, k=n, n=dh,
             w_bytes=1, adapt_bn=True),
        dict(kernel="add_matmul", site="q_ktv", g=b * h, m=n, k=dh, n=dh,
             w_bytes=1, adapt_bn=True),
        dict(kernel="add_matmul_packed", site="ktv", g=b * h, m=dh, k=n,
             n=dh, w_bytes=1, adapt_bn=True, packed_k=True),
        dict(kernel="add_matmul_packed", site="q_ktv", g=b * h, m=n, k=dh,
             n=dh, w_bytes=1, adapt_bn=True, packed_k=True),
        dict(kernel="linear_attention", site="causal_attn", g=b * h, n=n,
             dk=dh, dv=dh),
        dict(kernel="bidir_linear_attention", site="encoder_attn", g=b * h,
             n=n, dk=dh, dv=dh),
    ]


def block_resources(spec: dict, params: dict) -> tuple:
    """(shared memory bytes, threads) of one block of `spec`'s kernel under
    the launch parameters `params` (the defaults where a key is missing).
    A matmul's block is counted for float32 x; an attention's at the Dv
    slice its wrapper takes (the whole of Dv where no slice fits); the
    bidirectional attention's block is one of a cluster of
    `bidir_linear_attention.cluster_size(n)`."""
    kernel = spec["kernel"]
    if kernel in MATMUL_KERNELS:
        tile = tile_matmul.launch_tile(
            (params.get("tile_m", tile_matmul.DEFAULT_TILE[0]),
             params.get("tile_n", tile_matmul.DEFAULT_TILE[1])),
            spec["g"], spec["m"], spec["n"])
        return tile_matmul.smem_bytes(tile, spec["k"]), tile_matmul.THREADS
    mod = {"linear_attention": linear_attention,
           "bidir_linear_attention": bidir_linear_attention}[kernel]
    width = bidir_linear_attention.dv_slice(spec["dk"], spec["dv"], mod.smem_bytes)
    return mod.smem_bytes(spec["dk"], width or spec["dv"]), mod.THREADS


def fits(spec: dict, params: dict) -> bool:
    """Whether one block of this launch fits a Hopper SM: shared memory
    within 227 KB and threads within 1024 (for an attention: some Dv slice
    fits, `bidir_linear_attention.dv_slice`)."""
    smem, threads = block_resources(spec, params)
    return smem <= SMEM_PER_BLOCK and threads <= THREADS_PER_BLOCK

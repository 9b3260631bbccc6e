"""The serving sites of every kernel and the block-resource check of a
launch configuration. Counterpart of part of
`repro/analysis/kernel_contracts.py`: `MATMUL_KERNELS`, `serving_sites` (the
same dicts as the reference's) and, in place of its 16 MiB VMEM model, a
Hopper check — shared memory per block at most 227 KB and at most 1024
threads per block. The rest of the reference's contract table (roofline
cells, pad waste, findings) is not ported yet.
"""
from __future__ import annotations

from repro_torch.kernels import bidir_linear_attention, linear_attention, tile_matmul

MATMUL_KERNELS = ("shift_matmul", "add_matmul", "add_matmul_packed")
SMEM_PER_BLOCK = 232448       # 227 KB a Hopper block can opt in to
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
    the launch parameters `params` (the defaults where a key is missing)."""
    kernel = spec["kernel"]
    if kernel in MATMUL_KERNELS:
        tm = params.get("tile_m", tile_matmul.DEFAULT_TILE[0])
        tn = params.get("tile_n", tile_matmul.DEFAULT_TILE[1])
        return tile_matmul.smem_bytes(tm, tn), tile_matmul.THREADS
    mod = {"linear_attention": linear_attention,
           "bidir_linear_attention": bidir_linear_attention}[kernel]
    return mod.smem_bytes(spec["dk"], spec["dv"]), mod.THREADS


def fits(spec: dict, params: dict) -> bool:
    """Whether one block of this launch fits a Hopper SM: shared memory
    within 227 KB and threads within 1024 (and head dims within the
    attention kernels' 128)."""
    smem, threads = block_resources(spec, params)
    dims_ok = (max(spec.get("dk", 0), spec.get("dv", 0))
               <= bidir_linear_attention.MAX_HEAD_DIM)
    return smem <= SMEM_PER_BLOCK and threads <= THREADS_PER_BLOCK and dims_ok

"""Kernel dispatch with an explicit `impl` and an optional `tune` table.
Counterpart of `repro/kernels/ops.py`.

- "cuda":  the hand-written kernels (`shift_matmul.py`, `add_matmul.py`,
           `add_matmul_packed.py`, `linear_attention.py`,
           `bidir_linear_attention.py`). On a CUDA tensor they launch or
           raise; on a CPU tensor they run their plain versions.
- "torch": the plain PyTorch versions (`ref.py`) on any device.

`impl=None` takes the tensor's device: "cuda" on a GPU, "torch" on the CPU.
There is no process-wide default to set: callers (engine → model → blocks →
here) pass `impl` and `tune` down.

`tune` is anything with `.lookup(kernel, **geometry) -> dict | None`
(`kernels.autotune.TuneTable`). Its entries name the port's own launch
parameters (`tile_m`, `tile_n`, `chunk_rows`); a miss, or an entry without
them, serves the defaults. No tile changes a matmul's K order, so a tuned
product is bit-identical to the untuned one.
"""
from __future__ import annotations

import torch

from repro_torch import default_impl
from repro_torch.kernels import ref, tile_matmul
from repro_torch.kernels.add_matmul import add_matmul as _add_matmul
from repro_torch.kernels.add_matmul_packed import add_matmul_packed as _add_matmul_packed
from repro_torch.kernels.add_matmul_packed import unpack_bits
from repro_torch.kernels.bidir_linear_attention import bidir_binary_attention
from repro_torch.kernels.linear_attention import CHUNK
from repro_torch.kernels.linear_attention import binary_linear_attention as _causal
from repro_torch.kernels.shift_matmul import shift_matmul as _shift_matmul

IMPLS = ("cuda", "torch")
KERNELS = {"shift_matmul": _shift_matmul,
           "bidir_binary_attention": bidir_binary_attention,
           "add_matmul": _add_matmul,
           "add_matmul_packed": _add_matmul_packed,
           "binary_linear_attention": _causal}


def _resolve(impl, t):
    impl = impl or default_impl(t.device)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def _tuned(tune, kernel, **geom) -> dict:
    """The table's entry for this kernel × geometry, or {} (the defaults)."""
    return (tune.lookup(kernel, **geom) if tune is not None else None) or {}


def _tile(tune, kernel, **geom) -> tuple:
    cfg = _tuned(tune, kernel, **geom)
    return (cfg.get("tile_m", tile_matmul.DEFAULT_TILE[0]),
            cfg.get("tile_n", tile_matmul.DEFAULT_TILE[1]))


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def shift_matmul(x, w_packed, impl=None, tune=None):
    """x: (..., K) float; w_packed: (K, N) int8 → (..., N) in x's dtype."""
    impl = _resolve(impl, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if impl == "torch":
        y = ref.shift_matmul_ref(x2, w_packed)
    else:
        m, k = x2.shape
        tile = _tile(tune, "shift_matmul", g=1, m=m, k=k, n=w_packed.shape[-1])
        y = _shift_matmul(x2, w_packed, tile)
    return y.reshape(*lead, -1)


def add_matmul(x, b, impl=None, tune=None):
    """x: (G, M, K) float; b: (G, K, N) int8 in {-1, 0, +1} → (G, M, N)."""
    impl = _resolve(impl, x)
    if impl == "torch":
        return ref.add_matmul_ref(x, b)
    g, m, k = x.shape
    tile = _tile(tune, "add_matmul", g=g, m=m, k=k, n=b.shape[-1])
    return _add_matmul(x.contiguous(), b.contiguous(), tile)


def add_matmul_bitpacked(x, packed, impl=None, tune=None):
    """x: (G, M, K) float; packed: (G, K/8, N) uint8 ±1 codes → (G, M, N)."""
    impl = _resolve(impl, x)
    if impl == "torch":
        return ref.add_matmul_ref(x, unpack_bits(packed))
    g, m, k = x.shape
    tile = _tile(tune, "add_matmul_packed", g=g, m=m, k=k, n=packed.shape[-1])
    return _add_matmul_packed(x.contiguous(), packed.contiguous(), tile)


def binary_linear_attention_bidir(q, k, v, impl=None, tune=None):
    """q, k: (B, H, N, Dk); v: (B, H, N, Dv), float32 → (B, H, N, Dv).
    Non-causal: the ViT serving form of the Hamming-code attention. `tune`
    is accepted for call-site uniformity and ignored: the kernel has no
    launch parameter to tune (the autotuner only checks that it fits).

    impl="cuda" hands the kernel q, k and v as they are (any batch, head and
    row strides, the last dim contiguous, as `Attention._qkv`'s permuted
    views) and returns its (B, H, N, Dv) view of a (B, N, H, Dv) buffer: no
    layout copy on either side."""
    del tune
    impl = _resolve(impl, q)
    if impl == "cuda":
        return bidir_binary_attention(q, k, v)
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    qg = q.reshape(b * h, n, dk).contiguous()
    kg = k.reshape(b * h, n, dk).contiguous()
    vg = v.reshape(b * h, n, dv).contiguous()
    return ref.bidir_binary_attention_ref(qg, kg, vg).reshape(b, h, n, dv)


def binary_linear_attention_fused(q, k, v, *, chunk=None, impl=None,
                                  tune=None, return_state=False):
    """q, k: (B, H, N, Dk); v: (B, H, N, Dv). Causal, each row sees itself.

    chunk: rows per chunk; None takes the table's `chunk_rows`, else
    `CHUNK`, capped at N. return_state=True also returns the final carry
    {"kv", "ksum", "vsum", "count"} (the decode-state layout)."""
    impl = _resolve(impl, q)
    if impl == "torch":
        out = ref.binary_linear_attention_ref(q, k, v, causal=True)
        if not return_state:
            return out
        return out, ref.binary_linear_attention_state_ref(q, k, v)
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    if chunk is None:
        cfg = _tuned(tune, "linear_attention", g=b * h, n=n, dk=dk, dv=dv)
        chunk = min(cfg.get("chunk_rows", CHUNK), n)
    res = _causal(q.reshape(b * h, n, dk).float().contiguous(),
                  k.reshape(b * h, n, dk).float().contiguous(),
                  v.reshape(b * h, n, dv).float().contiguous(),
                  chunk=chunk, return_state=return_state)
    if not return_state:
        return res.reshape(b, h, n, dv).to(v.dtype)
    out, kv, ksum, vsum = res
    state = {"kv": kv.reshape(b, h, dk, dv), "ksum": ksum.reshape(b, h, dk),
             "vsum": vsum.reshape(b, h, dv),
             "count": torch.tensor(float(n), dtype=torch.float32, device=q.device)}
    return out.reshape(b, h, n, dv).to(v.dtype), state

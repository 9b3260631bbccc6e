"""Kernel dispatch with an explicit `impl`. Counterpart of
`repro/kernels/ops.py`.

- "cuda":  the hand-written kernels (`shift_matmul.py`,
           `bidir_linear_attention.py`). On a CUDA tensor they launch or
           raise; on a CPU tensor they run their plain versions.
- "torch": the plain PyTorch versions (`ref.py`) on any device.

`impl=None` takes the tensor's device: "cuda" on a GPU, "torch" on the CPU.
There is no process-wide default to set: callers (engine → model → blocks →
here) pass `impl` down.
"""
from __future__ import annotations

from repro_torch import default_impl
from repro_torch.kernels import ref
from repro_torch.kernels.bidir_linear_attention import bidir_binary_attention
from repro_torch.kernels.shift_matmul import shift_matmul as _shift_matmul

IMPLS = ("cuda", "torch")
KERNELS = {"shift_matmul": _shift_matmul,
           "bidir_binary_attention": bidir_binary_attention}


def _resolve(impl, t):
    impl = impl or default_impl(t.device)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def shift_matmul(x, w_packed, impl=None):
    """x: (..., K) float; w_packed: (K, N) int8 → (..., N) in x's dtype."""
    impl = _resolve(impl, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if impl == "torch":
        y = ref.shift_matmul_ref(x2, w_packed)
    else:
        y = _shift_matmul(x2, w_packed)
    return y.reshape(*lead, -1)


def binary_linear_attention_bidir(q, k, v, impl=None):
    """q, k: (B, H, N, Dk); v: (B, H, N, Dv), float32 → (B, H, N, Dv).
    Non-causal: the ViT serving form of the Hamming-code attention."""
    impl = _resolve(impl, q)
    b, h, n, dk = q.shape
    dv = v.shape[-1]
    qg = q.reshape(b * h, n, dk).contiguous()
    kg = k.reshape(b * h, n, dk).contiguous()
    vg = v.reshape(b * h, n, dv).contiguous()
    if impl == "torch":
        out = ref.bidir_binary_attention_ref(qg, kg, vg)
    else:
        out = bidir_binary_attention(qg, kg, vg)
    return out.reshape(b, h, n, dv)

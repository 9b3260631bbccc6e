"""Plain PyTorch versions of the hand-written kernels.

Each mirrors its kernel's arithmetic, not merely its math: the CPU tests
hold these against the reference, and `chip_smoke.py` holds each kernel
against its plain version on the card. Counterpart of `repro/kernels/ref.py`
and the reference's Pallas kernel bodies. The causal attention is the
exception: its plain version is the quadratic oracle (float32 throughout,
so only the summation order differs from the chunked kernel).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import po2_weight_from_packed


def shift_matmul_ref(x, w_packed, out_dtype=None):
    """x: (M, K) float; w_packed: (K, N) int8 (sign | P+64) → (M, N).

    Follows the reference's Pallas kernel (`_shift_matmul_kernel`): x is
    cast to bf16, the weight is decoded to an exact bf16 power of two, and
    the products are summed in float32. (The reference's `ref.py` and its
    frozen `w_deploy` path keep x in float32 instead; the port follows the
    kernel.)"""
    w = po2_weight_from_packed(w_packed, torch.float32)
    y = torch.matmul(x.to(torch.bfloat16).float(), w)
    return y.to(out_dtype or x.dtype)


def dense_matmul_ref(x, w, bias=None):
    """x: (M, K), w: (K, N), bias: (N,) or None → x @ w (+ bias), float32:
    the library's product, in its own summation order (the kernel's is one
    chain of FMAs in K order per output)."""
    y = torch.matmul(x, w)
    return y if bias is None else y + bias


def _codes(x):
    """±1 Hamming codes in float32: +1 where x >= 0, else -1 (NaN too)."""
    return torch.where(x >= 0, 1.0, -1.0).float()


def bidir_binary_attention_ref(q, k, v):
    """Non-causal Hamming-code linear attention, all in float32.

    q, k: (..., N, Dk); v: (..., N, Dv) → (..., N, Dv) in v's dtype.
    Codes are +1 where x >= 0 and -1 otherwise (NaN included);
    KV = bkᵀ v, ksum = Σ bk, vsum = Σ v and
    out = (bq·KV + d·vsum) / (bq·ksum + d·n + 1e-6)."""
    d = q.shape[-1]
    n = q.shape[-2]
    bq, bk = _codes(q), _codes(k)
    v32 = v.float()
    kv = torch.matmul(bk.transpose(-1, -2), v32)                 # (.., Dk, Dv)
    ksum = bk.sum(dim=-2)                                        # (.., Dk)
    vsum = v32.sum(dim=-2)                                       # (.., Dv)
    num = torch.matmul(bq, kv) + float(d) * vsum[..., None, :]
    den = (bq * ksum[..., None, :]).sum(dim=-1) + float(d) * float(n)
    return (num / (den[..., None] + 1e-6)).to(v.dtype)


def add_matmul_ref(x, b):
    """x: (G, M, K) float; b: (G, K, N) int8 in {-1, 0, +1} → (G, M, N).

    Follows the reference's Pallas kernel (`_add_matmul_kernel`): x is cast
    to bf16 and the products are summed in float32; zeros in b contribute
    nothing. (The reference's `ref.py` keeps x in float32; the port follows
    the kernel, as `shift_matmul_ref` does.)"""
    return torch.matmul(x.to(torch.bfloat16).float(), b.float()).to(x.dtype)


def binary_linear_attention_ref(q, k, v, causal=True):
    """Quadratic oracle of the Hamming-code linear attention, all in float32.

    q, k: (..., N, Dk); v: (..., N, Dv) → (..., N, Dv) in v's dtype.
    Each weight is (bq_i · bk_j + d), masked to j <= i when causal;
    out_i = Σ_j w_ij v_j / (Σ_j w_ij + 1e-6)."""
    d = q.shape[-1]
    n = q.shape[-2]
    scores = torch.matmul(_codes(q), _codes(k).transpose(-1, -2)) + float(d)
    if causal:
        scores = scores * torch.ones((n, n), device=q.device).tril()
    out = torch.matmul(scores, v.float())
    den = scores.sum(dim=-1, keepdim=True)
    return (out / (den + 1e-6)).to(v.dtype)


def binary_linear_attention_state_ref(q, k, v):
    """The recurrent carry after the whole sequence: kv = Σ bkᵀ v,
    ksum = Σ bk, vsum = Σ v (float32) and count = n."""
    n = k.shape[-2]
    bk = _codes(k)
    v32 = v.float()
    return {"kv": torch.matmul(bk.transpose(-1, -2), v32),
            "ksum": bk.sum(dim=-2),
            "vsum": v32.sum(dim=-2),
            "count": torch.tensor(float(n), dtype=torch.float32, device=k.device)}

"""Power-of-two (Shift) quantization and the int8 packing (paper §4.1).

Shift weights:  W_S = s * 2^P,  s = sign(W) ∈ {-1,+1},  P = round(log2|W|)

Deployment packs one int8 per weight:

    bit 7    : sign   (1 = negative)
    bits 0-6 : P + 64 (P ∈ [-64, +63])

and the bf16 power of two is rebuilt bit-exactly from the exponent field:

    bf16 bits = sign << 15 | (P + 127) << 7        (mantissa 0 ⇒ exactly 2^P)

Counterpart of `repro/core/quant.py`; the parity tests hold packed bytes and
decoded weights exactly equal to it. Rounding is half-to-even
(`torch.round`), P is clamped to [P_MIN, P_MAX], and sign(0) is +1.
"""
from __future__ import annotations

import torch

P_MIN = -64
P_MAX = 63
_BF16_BIAS = 127
_F32_BIAS = 127


def po2_quantize(w, p_min=P_MIN, p_max=P_MAX):
    """Round |w| to the nearest power of two: returns (sign, P int32).

    Zeros get sign +1 and P = p_min (no exact-zero representation)."""
    one = torch.ones((), dtype=w.dtype, device=w.device)
    sign = torch.where(w < 0, -one, one)
    mag = torch.clamp(w.float().abs(), min=2.0 ** (p_min - 1))
    p = torch.clamp(torch.round(torch.log2(mag)), p_min, p_max).to(torch.int32)
    return sign, p


def po2_value(sign, p, dtype=torch.float32):
    """s * 2^P, built from float32 exponent bits (exact for every P in
    range, unlike a float `pow`)."""
    neg = (sign < 0).to(torch.int32)
    bits = (neg << 31) | ((p.to(torch.int32) + _F32_BIAS) << 23)
    return bits.view(torch.float32).to(dtype)


def pack_po2(sign, p):
    """Pack (sign ∈ {-1,+1}, P ∈ [-64, 63]) into one int8 per weight."""
    neg = (sign < 0).to(torch.uint8)
    biased = (p.to(torch.int32) - P_MIN).to(torch.uint8)       # [0, 127]
    return ((neg << 7) | biased).view(torch.int8)


def unpack_po2(packed):
    """Inverse of pack_po2: int8 → (sign float32 ∈ {-1,+1}, P int32)."""
    u = packed.view(torch.uint8).to(torch.int32)
    neg = u >> 7
    p = (u & 0x7F) + P_MIN
    sign = 1.0 - 2.0 * neg.to(torch.float32)
    return sign, p


def po2_weight_from_packed(packed, dtype=torch.bfloat16):
    """packed int8 → s * 2^P by bf16 exponent-bit assembly (integer ops and
    a bitcast, no exp2) — the decode the CUDA kernel does in registers."""
    u = packed.view(torch.uint8).to(torch.int32)
    sign_bit = (u >> 7) << 15
    p = (u & 0x7F) + P_MIN
    bits = sign_bit | ((p + _BF16_BIAS) << 7)                  # 16-bit pattern
    bits = bits - ((bits >> 15) << 16)                         # as signed int16
    return bits.to(torch.int16).view(torch.bfloat16).to(dtype)


def pack_from_dense(w):
    """dense float weight → packed int8 shift weight (deployment format)."""
    sign, p = po2_quantize(w)
    return pack_po2(sign, p)

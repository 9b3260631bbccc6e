"""Substrate layers of the ViT path: LayerNorm, the policy-aware linear
switch, MLP and the non-causal DWConv. Counterpart of `repro/nn/layers.py`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dense import Dense, truncated_normal
from repro_torch.core.shift_linear import ShiftLinear


def gelu(x):
    """The reference's GELU (`jax.nn.gelu` default): the tanh approximation,
    not torch's default exact erf form."""
    return F.gelu(x, approximate="tanh")


def make_linear(kind, d_in, d_out, use_bias=False, dtype=torch.float32):
    """kind: "dense" | "shift" | "shift_packed" — the policy switch for one
    projection (packed = int8 deployment format)."""
    if kind == "dense":
        return Dense(d_in, d_out, use_bias=use_bias, dtype=dtype)
    mode = "packed" if kind == "shift_packed" else "latent"
    return ShiftLinear(d_in, d_out, use_bias=use_bias, dtype=dtype, mode=mode)


def call_linear(layer, params, x, impl=None, tune=None):
    """Apply a `make_linear` product, threading the kernel choice and the
    tune table to layers that take them (ShiftLinear, Dense)."""
    if getattr(layer, "accepts_impl", False):
        return layer(params, x, impl=impl, tune=tune)
    return layer(params, x)


class LayerNorm:
    """float32 LayerNorm with biased variance (the reference's `jnp.var`)."""

    def __init__(self, dim, eps=1e-6, dtype=torch.float32):
        self.dim, self.eps, self.dtype = dim, eps, dtype

    def init(self, generator=None):
        return {"scale": torch.ones(self.dim), "bias": torch.zeros(self.dim)}

    def __call__(self, params, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * params["scale"].float() + params["bias"].float()
        return y.to(self.dtype)


class MLP:
    """The reference's MLP of kind "mlp" (the ViT's): up → GELU (tanh) →
    down, through `make_linear`. The gated kinds are not ported."""

    accepts_impl = True

    def __init__(self, d_model, d_ff, linear="dense", use_bias=False,
                 dtype=torch.float32):
        self.up = make_linear(linear, d_model, d_ff, use_bias, dtype)
        self.down = make_linear(linear, d_ff, d_model, use_bias, dtype)

    def init(self, generator):
        return {"up": self.up.init(generator), "down": self.down.init(generator)}

    def __call__(self, params, x, impl=None, tune=None):
        h = gelu(call_linear(self.up, params["up"], x, impl, tune))
        return call_linear(self.down, params["down"], h, impl, tune)


class DWConv1D:
    """Depthwise conv over the token axis in the encoder's non-causal
    ("same") form: width 3 pads (1, 1). The causal decoder form is not
    ported."""

    def __init__(self, dim, width=3, dtype=torch.float32):
        self.dim, self.width, self.dtype = dim, width, dtype

    def init(self, generator):
        k = torch.randn((self.width, self.dim), generator=generator)
        return {"kernel": k * (self.width ** -0.5), "bias": torch.zeros(self.dim)}

    def __call__(self, params, x):
        """x: (B, N, D) → (B, N, D), as `width` shifted multiply-adds in the
        reference's order (so values agree to rounding, not only in math)."""
        w = params["kernel"].to(self.dtype)
        n = x.shape[1]
        left, right = (self.width - 1) // 2, self.width // 2
        xp = F.pad(x.to(self.dtype), (0, 0, left, right))
        y = xp[:, 0:n, :] * w[0]
        for t in range(1, self.width):
            y = y + xp[:, t:t + n, :] * w[t]
        return y + params["bias"].to(self.dtype)

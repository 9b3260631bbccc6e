"""Plain dense linear — the `Mult.` primitive. Counterpart of
`repro/core/dense.py`.

Layers here are stateless descriptors: `init(generator)` makes a parameter
dict on the CPU (move it with `.to(device)` or `bridge.to_torch`), and
`__call__(params, x)` applies it, so the reference's parameter trees load
unchanged.
"""
from __future__ import annotations

import torch


def truncated_normal(generator, shape, std):
    """std * N(0, 1) truncated to [-2, 2], float32 on the CPU."""
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * std


class Dense:
    """y = x @ W + b, with truncated-normal init scaled by fan-in.

    Through `kernels.ops.dense_matmul`: impl="cuda" (the default on the
    card) runs the hand-written float32 kernel, whose sums are fixed by K
    alone, so a row's bits do not depend on the batch around it; "torch"
    (the default on the CPU) runs `torch.matmul`."""

    # Serving threads the kernel choice explicitly (engine → model → here);
    # nn.layers.call_linear keys on this attribute. Dense has no tune entry.
    accepts_impl = True

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32):
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.use_bias = use_bias
        self.dtype = dtype

    def init(self, generator):
        params = {"kernel": truncated_normal(
            generator, (self.in_features, self.out_features),
            self.in_features ** -0.5)}
        if self.use_bias:
            params["bias"] = torch.zeros(self.out_features)
        return params

    def __call__(self, params, x, impl=None, tune=None):
        from repro_torch.kernels import ops

        del tune
        bias = params["bias"].to(self.dtype) if self.use_bias else None
        return ops.dense_matmul(x.to(self.dtype), params["kernel"].to(self.dtype),
                                bias, impl)

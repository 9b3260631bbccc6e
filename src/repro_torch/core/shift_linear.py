"""ShiftLinear — the paper's `Shift` layer:  y = x @ (s * 2^P) + b.

Counterpart of `repro/core/shift_linear.py`. Two parameter forms:

- `w_latent` (training form): a float weight, power-of-two quantized on
  every forward, and a plain float32 product with x.
- `w_packed` (deployment form, what the serving engine holds): one int8 per
  weight, through `kernels.ops.shift_matmul` — the hand-written CUDA kernel
  (`impl="cuda"`) or its plain version (`impl="torch"`). Both cast x to bf16
  and sum in float32, as the reference's Pallas kernel does.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.dense import truncated_normal


class ShiftLinear:
    # Serving threads kernel selection and the tune table explicitly
    # (engine → blocks → ops); nn.layers.call_linear keys on this attribute.
    accepts_impl = True

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32, mode="latent"):
        if mode not in ("latent", "packed"):
            raise ValueError(mode)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.use_bias = use_bias
        self.dtype = dtype
        self.mode = mode

    def init(self, generator):
        w = truncated_normal(generator, (self.in_features, self.out_features),
                             self.in_features ** -0.5)
        params = ({"w_latent": w} if self.mode == "latent"
                  else {"w_packed": quant.pack_from_dense(w)})
        if self.use_bias:
            params["bias"] = torch.zeros(self.out_features)
        return params

    def __call__(self, params, x, impl=None, tune=None):
        x = x.to(self.dtype)
        if "w_packed" in params:
            from repro_torch.kernels import ops

            y = ops.shift_matmul(x, params["w_packed"], impl, tune)
        else:
            w_q = quant.po2_value(*quant.po2_quantize(params["w_latent"]))
            y = torch.matmul(x, w_q.to(self.dtype))
        if self.use_bias:
            y = y + params["bias"].to(self.dtype)
        return y

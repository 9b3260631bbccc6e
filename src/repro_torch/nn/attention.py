"""Attention of the ViT serving path. Counterpart of `repro/nn/attention.py`
(`softmax_attention`, `_repeat_kv`, `Attention._qkv`, `Attention.infer`).

- policy attention "binary_linear" (stage1, shiftadd): q/k/v projections, a
  DWConv on V added to V (`v + dwconv(v)`), the bidirectional Hamming-code
  attention through `kernels.ops.binary_linear_attention_bidir`, then the o
  projection;
- policy attention "dense": non-causal softmax attention in plain torch ops,
  as the reference computes it outside any kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.nn import layers as L


def softmax_attention(q, k, v):
    """Non-causal softmax attention in float32. q: (B, H, N, D);
    k, v: (B, H, M, D). Written as the reference's online-softmax step over a
    single chunk (max, exp, sum, then divide) so values agree to rounding."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v.float())
    return (acc / torch.clamp(l, min=1e-9)).to(v.dtype)


def _repeat_kv(x, g):
    """(B, Hkv, N, D) → (B, Hkv*g, N, D) by group repeat."""
    if g == 1:
        return x
    b, h, n, d = x.shape
    return x[:, :, None].expand(b, h, g, n, d).reshape(b, h * g, n, d)


class Attention:
    accepts_impl = True

    def __init__(self, cfg):
        p = cfg.policy
        if p.attention not in ("dense", "binary_linear"):
            raise NotImplementedError(
                f"attention={p.attention!r} is not ported (dense, binary_linear)")
        self.mode = p.attention
        self.h = cfg.n_heads
        self.hkv = cfg.n_kv_heads
        self.dh = cfg.head_dim
        d, dt, lin = cfg.d_model, cfg.activation_dtype, p.proj_linear()
        self.q_proj = L.make_linear(lin, d, self.h * self.dh, True, dt)
        self.k_proj = L.make_linear(lin, d, self.hkv * self.dh, True, dt)
        self.v_proj = L.make_linear(lin, d, self.hkv * self.dh, True, dt)
        self.o_proj = L.make_linear(lin, self.h * self.dh, d, True, dt)
        self.dwconv = None
        if self.mode == "binary_linear" and p.dwconv_v:
            self.dwconv = L.DWConv1D(self.hkv * self.dh, width=3, dtype=dt)

    def init(self, generator):
        p = {name: proj.init(generator) for name, proj in (
            ("q", self.q_proj), ("k", self.k_proj), ("v", self.v_proj),
            ("o", self.o_proj))}
        if self.dwconv is not None:
            p["dwconv"] = self.dwconv.init(generator)
        return p

    def _qkv(self, params, x, impl=None, tune=None):
        """x: (B, N, d) → q, k, v as (B, H, N, Dh)."""
        b, n, _ = x.shape
        q = L.call_linear(self.q_proj, params["q"], x, impl, tune).reshape(
            b, n, self.h, self.dh)
        k = L.call_linear(self.k_proj, params["k"], x, impl, tune).reshape(
            b, n, self.hkv, self.dh)
        vflat = L.call_linear(self.v_proj, params["v"], x, impl, tune)
        if self.dwconv is not None:
            vflat = vflat + self.dwconv(params["dwconv"], vflat)
        v = vflat.reshape(b, n, self.hkv, self.dh)
        return tuple(t.permute(0, 2, 1, 3) for t in (q, k, v))

    def infer(self, params, x, impl=None, tune=None):
        """Serving forward: x (B, N, d) → (B, N, d). impl/tune arrive
        threaded from the engine and go to every kernel call."""
        b, n, _ = x.shape
        q, k, v = self._qkv(params, x, impl, tune)
        g = self.h // self.hkv
        kf, vf = _repeat_kv(k, g), _repeat_kv(v, g)
        if self.mode == "dense":
            out = softmax_attention(q, kf, vf)
        else:
            out = ops.binary_linear_attention_bidir(
                q.float(), kf.float(), vf.float(), impl=impl,
                tune=tune).to(x.dtype)
        # The kernel's output is a view of a (B, N, H, Dh) buffer: no copy.
        out = out.permute(0, 2, 1, 3).reshape(b, n, self.h * self.dh)
        return L.call_linear(self.o_proj, params["o"], out, impl, tune)

"""Transformer block of the ViT serving path: pre-norm residual wiring,
LayerNorm → attention → LayerNorm → feed (MLP or the {Mult, Shift} MoE).
Counterpart of `repro/nn/blocks.py` (`_make_feed`, `TransformerBlock.infer`).
"""
from __future__ import annotations

from repro_torch.core.moe_primitives import MoEPrimitives
from repro_torch.nn import layers as L
from repro_torch.nn.attention import Attention


def _make_feed(cfg):
    p = cfg.policy
    dt = cfg.activation_dtype
    if p.mlp == "moe_primitives":
        experts = [L.MLP(cfg.d_model, cfg.d_ff,
                         "dense" if ek == "mult" else p.mlp_linear(), True, dt)
                   for ek in p.moe_experts]
        # Capacities are planned at the per-image token count (the regime the
        # split serves in), as the reference does for the ViT.
        return MoEPrimitives(cfg.d_model, cfg.d_ff, expert_kinds=p.moe_experts,
                             capacity_factor=cfg.moe_capacity,
                             latency_aware=p.latency_aware, dtype=dt,
                             experts=experts,
                             capacity_ref_tokens=cfg.n_patches)
    lin = p.mlp_linear() if p.mlp == "shift" else "dense"
    return L.MLP(cfg.d_model, cfg.d_ff, lin, True, dt)


class TransformerBlock:
    def __init__(self, cfg):
        self.mixer = Attention(cfg)
        self.feed = _make_feed(cfg)
        self.norm1 = L.LayerNorm(cfg.d_model, 1e-6, cfg.activation_dtype)
        self.norm2 = L.LayerNorm(cfg.d_model, 1e-6, cfg.activation_dtype)

    def init(self, generator):
        return {"mixer": self.mixer.init(generator),
                "feed": self.feed.init(generator),
                "norm1": self.norm1.init(), "norm2": self.norm2.init()}

    def _infer_feed(self, params, x, impl=None, tune=None):
        if isinstance(self.feed, MoEPrimitives):
            return self.feed.infer(params, x, impl=impl, tune=tune)
        return self.feed(params, x, impl=impl, tune=tune)

    def infer(self, params, x, impl=None, tune=None):
        """Serving forward, x (B, N, d) → (B, N, d). Every reduction is
        within one image, so a row's output never depends on its
        neighbours."""
        h = self.norm1(params["norm1"], x)
        x = x + self.mixer.infer(params["mixer"], h, impl=impl, tune=tune)
        h2 = self.norm2(params["norm2"], x)
        return x + self._infer_feed(params["feed"], h2, impl=impl, tune=tune)

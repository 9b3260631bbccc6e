"""ShiftAddViT — the paper's own model, serving path. Counterpart of
`repro/nn/vit.py`.

patchify (linear on flattened patches) → bidirectional transformer blocks
whose attention / projections / MLPs follow the ShiftAddPolicy → final
LayerNorm → mean pool → classifier head, written as a broadcast multiply
and a within-row sum so each image's logits depend on that image alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import reparam
from repro_torch.core.dense import Dense
from repro_torch.core.policy import ShiftAddPolicy
from repro_torch.nn.blocks import TransformerBlock
from repro_torch.nn.layers import LayerNorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """The reference's `ViTConfig` fields. `image_size=56` is the serving
    geometry: 196 tokens of patch 4, d_model 128, 4 layers, 4 heads, d_ff 256."""

    image_size: int = 32
    patch_size: int = 4
    in_channels: int = 3
    n_classes: int = 10
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 256
    policy: ShiftAddPolicy = ShiftAddPolicy()
    dtype: str = "float32"
    moe_capacity: float = 1.25

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_copy_tree(v) for v in tree]
        return tuple(seq) if isinstance(tree, tuple) else seq
    return tree


class ShiftAddViT:
    def __init__(self, cfg: ViTConfig):
        self.cfg = cfg
        dt = cfg.activation_dtype
        patch_dim = cfg.patch_size ** 2 * cfg.in_channels
        self.patch_embed = Dense(patch_dim, cfg.d_model, dtype=dt)
        self.blocks = [TransformerBlock(cfg) for _ in range(cfg.n_layers)]
        self.final_norm = LayerNorm(cfg.d_model, 1e-6, dt)
        self.head = Dense(cfg.d_model, cfg.n_classes, dtype=dt)

    def init(self, seed: int):
        """Random parameters from `seed` (a CPU torch.Generator), on the CPU."""
        g = torch.Generator().manual_seed(int(seed))
        return {"patch_embed": self.patch_embed.init(g),
                "blocks": [b.init(g) for b in self.blocks],
                "final_norm": self.final_norm.init(),
                "head": self.head.init(g)}

    def patchify(self, images):
        """(B, H, W, C) → (B, n_patches, patch_dim)."""
        b, h, w, ch = images.shape
        p = self.cfg.patch_size
        x = images.reshape(b, h // p, p, w // p, p, ch)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                                   p * p * ch)

    def infer(self, params, images, impl=None, tune=None):
        """images (B, H, W, C) → logits (B, n_classes). `impl` ("cuda" |
        "torch" | None for the device's default) and `tune` (a
        kernels.autotune.TuneTable, or None for the defaults) thread to every
        kernel call."""
        dt = self.cfg.activation_dtype
        x = self.patch_embed(params["patch_embed"], self.patchify(images).to(dt))
        for blk, p in zip(self.blocks, params["blocks"]):
            x = blk.infer(p, x, impl=impl, tune=tune)
        x = self.final_norm(params["final_norm"], x)
        pooled = x.mean(dim=1)                                     # (B, d)
        w = params["head"]["kernel"].to(pooled.dtype)
        logits = (pooled[:, :, None] * w[None]).sum(dim=1)
        if "bias" in params["head"]:
            logits = logits + params["head"]["bias"].to(pooled.dtype)
        return logits

    def prepare_inference(self, params, token_counts=(), tune=None):
        """Deployment freeze (core.deploy): pack every shift weight to int8
        and warm the MoE capacity plans. `tune` is recorded on the plan and
        is threaded to `infer` beside the frozen params."""
        from repro_torch.core.deploy import prepare_inference
        return prepare_inference(self, params, token_counts=token_counts,
                                 tune=tune)

    def convert_from(self, dense_model: "ShiftAddViT", dense_params, stage=2):
        """Reparameterize dense ViT params into this policy's structure.

        stage 0: structural copy (the dense arm of a policy sweep);
        stage 1: + shift projections if the policy says so, and a zero DWConv
                 on V for (binary-)linear attention;
        stage 2: + MLPs → MoE-of-primitives (zero router, see
                 `reparam.dense_mlp_to_moe`)."""
        if dense_model.cfg.n_layers != self.cfg.n_layers:
            raise ValueError("layer counts differ")
        p = self.cfg.policy
        out = _copy_tree(dense_params)
        if stage < 1:
            return out
        for i in range(len(self.blocks)):
            src = dense_params["blocks"][i]
            dst = dict(src)
            mixer = dict(src["mixer"])
            if p.projections == "shift":
                for name in ("q", "k", "v", "o"):
                    mixer[name] = reparam.dense_to_shift(mixer[name])
            if p.attention == "binary_linear" and p.dwconv_v:
                conv = self.blocks[i].mixer.dwconv
                dev = src["mixer"]["v"]["kernel"].device
                mixer["dwconv"] = {
                    "kernel": torch.zeros((conv.width, conv.dim), device=dev),
                    "bias": torch.zeros((conv.dim,), device=dev)}
            dst["mixer"] = mixer
            if stage >= 2:
                if p.mlp == "shift":
                    dst["feed"] = {
                        "up": reparam.dense_to_shift(src["feed"]["up"]),
                        "down": reparam.dense_to_shift(src["feed"]["down"])}
                elif p.mlp == "moe_primitives":
                    dst["feed"] = reparam.dense_mlp_to_moe(src["feed"],
                                                           p.moe_experts)
            out["blocks"][i] = dst
        return out


def with_seeded_router(params, seed: int):
    """Copy of `params` with every MoE router replaced by seeded
    N(0, 1/d_model) weights.

    `convert_from` leaves the router at zero, which sends every token to the
    Mult expert; serving that is measured or compared needs a router under
    which both experts carry tokens."""
    out = _copy_tree(params)
    g = torch.Generator().manual_seed(int(seed))
    for blk in out["blocks"]:
        feed = blk["feed"]
        if "router" in feed:
            k = feed["router"]["kernel"]
            w = torch.randn(tuple(k.shape), generator=g) * k.shape[0] ** -0.5
            feed["router"] = {"kernel": w.to(k.device)}
    return out

"""Dense → ShiftAdd reparameterization of pretrained params (paper §4).
Counterpart of `repro/core/reparam.py` (the helpers `convert_from` uses)."""
from __future__ import annotations

import torch

from repro_torch.core import quant


def dense_to_shift(subtree, mode="latent"):
    """{"kernel", bias?} → ShiftLinear params (latent or packed)."""
    if mode == "latent":
        out = {"w_latent": subtree["kernel"]}
    else:
        out = {"w_packed": quant.pack_from_dense(subtree["kernel"])}
    if "bias" in subtree:
        out["bias"] = subtree["bias"]
    return out


def dense_mlp_to_moe(mlp_params, expert_kinds=("mult", "shift"),
                     router_init=None):
    """Pretrained dense MLP → MoE-of-primitives params: the Mult expert keeps
    the weights, the Shift expert their latent copy.

    With no `router_init` the router is all zeros, as in the reference: every
    logit ties, argmax sends every token to expert 0 (Mult), and the Shift
    expert's output is all discarded. Serving that is measured or compared
    loads a non-zero router (`ShiftAddViT.seeded_router`)."""
    experts = []
    for kind in expert_kinds:
        experts.append({
            "up": dict(mlp_params["up"]) if kind == "mult"
            else dense_to_shift(mlp_params["up"]),
            "down": dict(mlp_params["down"]) if kind == "mult"
            else dense_to_shift(mlp_params["down"]),
        })
    kernel = mlp_params["up"]["kernel"]
    if router_init is None:
        router_init = torch.zeros((kernel.shape[0], len(expert_kinds)),
                                  dtype=torch.float32, device=kernel.device)
    return {"router": {"kernel": router_init}, "experts": experts}

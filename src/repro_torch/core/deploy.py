"""Deployment freeze: one pass over the parameter tree at engine build.
Counterpart of `repro/core/deploy.py`.

Every ShiftLinear subtree is packed to the int8 kernel format (`w_packed`,
one byte per weight) whichever impl serves it: the CUDA kernel and its plain
version both read the packed bytes. A subtree arrives as a float latent
(`w_latent`), already packed, or as the reference's `impl="xla"` freeze
(`w_deploy`, the decoded s·2^P); every s·2^P with P in range repacks to the
same byte, so all three give the bytes the reference packs. Packing runs on
the CPU and the bytes are then moved to the parameters' device, so they are
the same bytes on every device. Each MoE feed's capacity plan is warmed for the per-image token
counts the engine serves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch.core import quant


_SHIFT_WEIGHTS = ("w_packed", "w_latent", "w_deploy")


def _is_shift_leaf(tree) -> bool:
    return isinstance(tree, dict) and any(k in tree for k in _SHIFT_WEIGHTS)


def _freeze_shift_leaf(leaf):
    if "w_packed" in leaf:
        out = {"w_packed": leaf["w_packed"]}
    else:
        w = leaf["w_latent"] if "w_latent" in leaf else leaf["w_deploy"]
        out = {"w_packed": quant.pack_from_dense(w.cpu()).to(w.device)}
    if "bias" in leaf:
        out["bias"] = leaf["bias"]
    return out


@dataclasses.dataclass(frozen=True)
class DeployPlan:
    """params: the frozen tree (same structure, shift subtrees packed);
    frozen_linears: shift subtrees packed; moe_layers: MoE feeds warmed;
    token_counts: per-image token counts the capacity plans were warmed for;
    tune: the kernels.autotune.TuneTable every kernel call of the frozen
    model takes (None → the kernels' default launch configurations)."""

    params: Any
    frozen_linears: int = 0
    moe_layers: int = 0
    token_counts: Tuple[int, ...] = ()
    tune: Any = None


def freeze_params(params):
    """Walk a parameter tree, packing every shift subtree. Returns
    (tree, count)."""
    count = 0

    def walk(tree):
        nonlocal count
        if _is_shift_leaf(tree):
            count += 1
            return _freeze_shift_leaf(tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            seq = [walk(v) for v in tree]
            return tuple(seq) if isinstance(tree, tuple) else seq
        return tree

    return walk(params), count


def prepare_inference(model, params, token_counts=(), tune=None) -> DeployPlan:
    """Freeze `params` for serving, warm `model`'s MoE capacity plans for
    the per-image `token_counts`, and record the tune table."""
    from repro_torch.core.moe_primitives import MoEPrimitives

    frozen, n_frozen = freeze_params(params)
    token_counts = tuple(sorted(set(int(t) for t in token_counts)))
    moe_layers = 0
    for blk in getattr(model, "blocks", []):
        feed = getattr(blk, "feed", None)
        if isinstance(feed, MoEPrimitives):
            moe_layers += 1
            for t in token_counts:
                feed.capacity_plan(t)
    return DeployPlan(params=frozen, frozen_linears=n_frozen,
                      moe_layers=moe_layers, token_counts=token_counts,
                      tune=tune)

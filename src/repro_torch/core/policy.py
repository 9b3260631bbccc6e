"""ShiftAddPolicy — which components of a model are reparameterized, and how.

A copy of the reference's policy (framework-free), kept here so the port
never imports the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShiftAddPolicy:
    """Per-component reparameterization policy (paper §4).

    attention: "dense" (softmax) | "linear" | "binary_linear" (Hamming codes).
    projections: "dense" | "shift" (q/k/v/o as `s * 2^P` shift layers).
    mlp: "dense" | "shift" | "moe_primitives" (the paper's {Mult, Shift} MoE).
    """

    attention: str = "dense"
    projections: str = "dense"
    mlp: str = "dense"
    moe_experts: Tuple[str, ...] = ("mult", "shift")
    latency_aware: bool = True
    balance_loss_weight: float = 0.01
    dwconv_v: bool = True
    deploy: bool = False

    def proj_linear(self) -> str:
        if self.projections == "dense":
            return "dense"
        return "shift_packed" if self.deploy else "shift"

    def mlp_linear(self) -> str:
        if self.mlp == "dense":
            return "dense"
        return "shift_packed" if self.deploy else "shift"

    def __post_init__(self):
        if self.attention not in ("dense", "linear", "binary_linear"):
            raise ValueError(self.attention)
        if self.projections not in ("dense", "shift"):
            raise ValueError(self.projections)
        if self.mlp not in ("dense", "shift", "moe_primitives"):
            raise ValueError(self.mlp)
        for e in self.moe_experts:
            if e not in ("mult", "shift"):
                raise ValueError(e)

    @property
    def is_dense(self) -> bool:
        return (self.attention == "dense" and self.projections == "dense"
                and self.mlp == "dense")


DENSE = ShiftAddPolicy()
# Paper's full recipe (Tab. 4 bottom rows: LA + Quant-Add + MoE(Both)).
SHIFTADD = ShiftAddPolicy(
    attention="binary_linear", projections="shift", mlp="moe_primitives")
# Stage-1 only (LA + Add, projections/MLP untouched).
STAGE1 = ShiftAddPolicy(attention="binary_linear")

"""Analytic latency model behind the MoE's latency-aware capacity split.

A copy of the latency half of the reference's `core/energy.py`. The roofline
constants below are the reference's accelerator model and are kept unchanged
on purpose: they set the capacity split (`MoEPrimitives.capacities`; at 196
tokens per image the caps are (113, 133)), so changing them changes which
tokens each expert serves and the port would no longer route like the
reference. A prior measured on the GPU is a later, separate change.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 197e12      # FLOP/s
PEAK_OPS_INT8 = 394e12        # int8 ops/s
HBM_BW = 819e9                # B/s

# Nominal token count at which expert latencies are evaluated when a feed
# has no deployment per-group token count (it only fixes the regime).
NOMINAL_MOE_TOKENS = 1024


def linear_latency_estimate(tokens: int, d_in: int, d_out: int, kind: str) -> float:
    """Seconds for a `tokens x d_in @ d_in x d_out` linear of a given kind:
    "mult" (bf16 dense) | "shift" (packed-int8 weights) | "add" (binary)."""
    flops = 2.0 * tokens * d_in * d_out
    if kind == "mult":
        w_bytes = d_in * d_out * 2
        t_c = flops / PEAK_FLOPS_BF16
    elif kind in ("shift", "add"):
        w_bytes = d_in * d_out * 1
        t_c = flops / PEAK_OPS_INT8
    else:
        raise ValueError(kind)
    act_bytes = tokens * (d_in + d_out) * 2
    t_m = (w_bytes + act_bytes) / HBM_BW
    return max(t_c, t_m)


def mlp_latency_estimate(tokens: int, d_model: int, d_hidden: int, kind: str) -> float:
    """Two-linear MLP expert latency (the paper's MoE experts)."""
    return (linear_latency_estimate(tokens, d_model, d_hidden, kind)
            + linear_latency_estimate(tokens, d_hidden, d_model, kind))


def expert_latencies(tokens: int, d_model: int, d_hidden: int, kinds) -> list:
    return [mlp_latency_estimate(tokens, d_model, d_hidden, k) for k in kinds]


def inverse_latency_weights(latencies) -> list:
    """Normalized 1/latency weights — the latency-aware token split."""
    inv = [1.0 / l for l in latencies]
    return [w / sum(inv) for w in inv]

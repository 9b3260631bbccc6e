"""Heterogeneous mixture of multiplication primitives (paper §4.2), serving
path. Counterpart of `repro/core/moe_primitives.py` (inference only).

A Mult expert (dense linears) and a Shift expert (power-of-two linears); a
dense router sends each token to its top-1 expert by clean-logit argmax.
Expert capacities are static and latency-aware (capacity ∝ 1/latency from
`core.energy`), planned per image row and memoized per token count.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import energy
from repro_torch.core.dense import Dense
from repro_torch.core.shift_linear import ShiftLinear
from repro_torch.nn.layers import gelu


class _MLPExpert:
    """Two-linear expert of a given primitive kind ("mult" | "shift")."""

    accepts_impl = True

    def __init__(self, d_model, d_hidden, kind, dtype=torch.float32):
        linear = Dense if kind == "mult" else ShiftLinear
        self.kind = kind
        self.up = linear(d_model, d_hidden, dtype=dtype)
        self.down = linear(d_hidden, d_model, dtype=dtype)

    def init(self, generator):
        return {"up": self.up.init(generator), "down": self.down.init(generator)}

    def __call__(self, params, x, impl=None, tune=None):
        if self.kind == "shift":
            h = self.up(params["up"], x, impl=impl, tune=tune)
            return self.down(params["down"], gelu(h), impl=impl, tune=tune)
        return self.down(params["down"], gelu(self.up(params["up"], x)))


class MoEPrimitives:
    """Token-routed mixture of {Mult, Shift} experts with latency-aware
    capacities. `experts` (modules with init/__call__) overrides the
    built-in `_MLPExpert`s — the ViT pairs its own MLP with a shift twin."""

    accepts_impl = True

    def __init__(self, d_model, d_hidden, expert_kinds=("mult", "shift"),
                 capacity_factor=1.25, latency_aware=True,
                 dtype=torch.float32, experts=None, capacity_ref_tokens=None):
        self.d_model = int(d_model)
        self.d_hidden = int(d_hidden)
        self.expert_kinds = tuple(expert_kinds)
        self.n_experts = (len(experts) if experts is not None
                          else len(self.expert_kinds))
        self.capacity_factor = float(capacity_factor)
        self.latency_aware = latency_aware
        self.dtype = dtype
        self.capacity_ref_tokens = (None if capacity_ref_tokens is None
                                    else int(capacity_ref_tokens))
        self._capacity_plans = {}   # n_tokens → (caps, offsets)
        self.router = Dense(d_model, self.n_experts, use_bias=False)
        self.experts = (list(experts) if experts is not None else
                        [_MLPExpert(d_model, d_hidden, k, dtype)
                         for k in self.expert_kinds])

    def init(self, generator):
        return {"router": self.router.init(generator),
                "experts": [e.init(generator) for e in self.experts]}

    # -- capacity schedule ---------------------------------------------------
    def latencies(self):
        """Analytic per-expert latencies at the feed's deployment token count
        (the regime constant behind the split)."""
        n = self.capacity_ref_tokens or energy.NOMINAL_MOE_TOKENS
        return energy.expert_latencies(n, self.d_model, self.d_hidden,
                                       self.expert_kinds)

    def _capacity_weights(self):
        if self.latency_aware:
            return energy.inverse_latency_weights(self.latencies())
        return [1.0 / self.n_experts] * self.n_experts

    def capacities(self, n_tokens: int):
        """Static per-expert capacities. With capacity_factor >= 1 any deficit
        left after the min(c, n_tokens) clamp is topped back up,
        largest-weight experts first, so sum(caps) >= n_tokens."""
        weights = self._capacity_weights()
        caps = [min(int(math.ceil(self.capacity_factor * n_tokens * w)), n_tokens)
                for w in weights]
        if self.capacity_factor >= 1.0:
            deficit = n_tokens - sum(caps)
            for i in sorted(range(self.n_experts), key=lambda j: -weights[j]):
                if deficit <= 0:
                    break
                bump = min(deficit, n_tokens - caps[i])
                caps[i] += bump
                deficit -= bump
        return caps

    def capacity_plan(self, n_tokens: int):
        """Memoized (caps, offsets) for a per-image token count."""
        plan = self._capacity_plans.get(n_tokens)
        if plan is None:
            caps = self.capacities(n_tokens)
            offsets = [0]
            for c in caps:
                offsets.append(offsets[-1] + c)
            plan = (tuple(caps), tuple(offsets[:-1]))
            self._capacity_plans[n_tokens] = plan
        return plan

    # -- forward ------------------------------------------------------------
    @staticmethod
    def _gates(select_logits, clean_logits):
        """Top-1 on `select_logits` (ties go to the first index), gate from
        the clean softmax. Returns (probs, top1, gate (..., 1))."""
        probs = torch.softmax(clean_logits, dim=-1)
        top1 = torch.argmax(select_logits, dim=-1)
        gate = torch.gather(probs, -1, top1[..., None])
        return probs, top1, gate

    def _route_infer(self, params, xg):
        clean_logits = self.router(params["router"], xg.float())
        _, top1, gate = self._gates(clean_logits, clean_logits)
        return top1, gate[..., 0].float()

    def _dispatch_tokens(self, params, x):
        """group per image → route → gather-ordered dispatch. Returns
        (info, per-expert segments, ungroup)."""
        from repro_torch.nn.dispatch import dispatch_infer, group_rows

        xg, ungroup = group_rows(x, self.d_model)
        s = xg.shape[1]
        top1, gate = self._route_infer(params, xg)
        caps, offsets = self.capacity_plan(s)
        buf, info = dispatch_infer(xg.to(self.dtype), top1, gate, list(caps))
        segments = [buf[:, off:off + cap, :] for off, cap in zip(offsets, caps)]
        return info, segments, ungroup

    def infer(self, params, x, impl=None, tune=None):
        """Deterministic serving forward: clean-logit argmax routing, static
        per-image capacities, experts on their static segments, per-token
        gather combine. Returns y only. impl/tune reach the kernel experts."""
        from repro_torch.nn.dispatch import combine_infer

        info, segments, ungroup = self._dispatch_tokens(params, x)
        outs = [expert(params["experts"][i], seg, impl=impl, tune=tune)
                if getattr(expert, "accepts_impl", False)
                else expert(params["experts"][i], seg)
                for i, (expert, seg) in enumerate(zip(self.experts, segments))]
        return ungroup(combine_infer(outs, info)).to(x.dtype)

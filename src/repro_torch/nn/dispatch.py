"""Per-image capacity dispatch for the MoE's serving path. Counterpart of
`repro/nn/dispatch.py` (`group_rows`, `dispatch_infer`, `combine_infer`).

Each image (batch row) is its own routing group: capacities are planned from
the per-image token count, so an image's routing never reads another
image's tokens. Ranks follow token order (a stable argsort; the earlier
token wins a capacity tie), exactly as the reference.
"""
from __future__ import annotations

import torch


def group_rows(x, d_model):
    """(..., S, d) → (G, S, d), one group per batch row, plus an ungroup
    closure. A 2-D input (S, d) is one row."""
    xg = x[None] if x.dim() == 2 else x.reshape(-1, x.shape[-2], d_model)

    def ungroup(y):
        return y.reshape(*x.shape[:-1], d_model)

    return xg, ungroup


def dispatch_infer(xg, expert_idx, gate, caps):
    """Top-1 inference dispatch. xg: (G, S, d); expert_idx: (G, S) int64;
    gate: (G, S); caps: static per-expert capacities.

    Returns (buf (G, total, d), info). Expert e owns rows
    [offset_e, offset_e + cap_e) of buf, filled with the tokens routed to e
    in token order. Rows past an expert's live count hold clipped duplicates
    of real tokens, not zeros: `combine_infer` never reads them back."""
    g, s, d = xg.shape
    dev = xg.device
    n_exp = len(caps)
    offsets = [0]
    for c in caps:
        offsets.append(offsets[-1] + c)
    total = offsets[-1]
    caps_t = torch.tensor(caps, dtype=torch.int64, device=dev)
    offs_t = torch.tensor(offsets[:-1], dtype=torch.int64, device=dev)
    row_e = torch.tensor([e for e, c in enumerate(caps) for _ in range(c)],
                         dtype=torch.int64, device=dev)

    onehot = (expert_idx[..., None]
              == torch.arange(n_exp, device=dev)).to(torch.int64)
    counts = onehot.sum(dim=1)                                   # (G, E)
    starts = torch.cumsum(counts, dim=-1) - counts               # (G, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - onehot, 2,
                       expert_idx[..., None])[..., 0]            # (G, S)
    keep = pos < caps_t[expert_idx]
    order = torch.argsort(expert_idx, dim=-1, stable=True)       # (G, S)
    local = torch.arange(total, device=dev) - offs_t[row_e]      # (total,)
    src_sorted = torch.clamp(starts[:, row_e] + local[None], 0, s - 1)
    src = torch.gather(order, 1, src_sorted)                     # (G, total)
    flat_src = (src + torch.arange(g, device=dev)[:, None] * s).reshape(-1)
    buf = xg.reshape(g * s, d)[flat_src].reshape(g, total, d)
    info = {"expert": expert_idx, "pos": pos, "keep": keep, "gate": gate,
            "caps": tuple(caps)}
    return buf, info


def combine_infer(expert_outs, info):
    """expert_outs: per-expert (G, cap_e, d) outputs in segment order →
    (G, S, d). Each token reads row `pos` of its expert's segment, scaled by
    gate·keep."""
    expert, pos, keep, gate = (info["expert"], info["pos"], info["keep"],
                               info["gate"])
    g, s = expert.shape
    y = None
    for e, out_e in enumerate(expert_outs):
        cap_e = out_e.shape[1]
        sel = torch.clamp(pos, 0, cap_e - 1)
        flat = (sel + torch.arange(g, device=sel.device)[:, None]
                * cap_e).reshape(-1)
        got = out_e.reshape(g * cap_e, -1)[flat].reshape(g, s, -1)
        got = torch.where((expert == e)[..., None], got, 0.0)
        y = got if y is None else y + got
    w = (gate * keep.to(gate.dtype)).to(y.dtype)
    return y * w[..., None]

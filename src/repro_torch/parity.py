"""The scaled-error metric the port is held to, on the CPU against the
reference and on the card against the plain versions:

    max |a - b| / max(std(b), 1e-3)

(the metric of the reference's kernel tests)."""
from __future__ import annotations

import numpy as np


def _np(a):
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def scaled_error(a, b) -> float:
    a, b = _np(a), _np(b)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    return float(np.max(np.abs(a - b)) / max(float(np.std(b)), 1e-3))

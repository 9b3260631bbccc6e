"""Parameter trees across frameworks, via numpy.

The reference keeps parameters as nested dicts/lists/tuples of arrays. The
port consumes the same trees with torch tensors as leaves, under the same
keys, so one set of weights can be loaded into both packages (the parity
tests do exactly that). Leaves cross as numpy arrays: anything with
`__array__` (numpy, or a reference array) converts without this module
importing the framework that made it.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(leaf, device):
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16 has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_torch(tree, device="cpu"):
    """Nested dict/list/tuple tree of arrays → the same tree of tensors on
    `device`. dtypes are kept (int8 `w_packed` stays `torch.int8`)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [to_torch(v, device) for v in tree]
        return tuple(seq) if isinstance(tree, tuple) else seq
    return _leaf_to_torch(tree, device)


def to_numpy(tree):
    """Inverse of `to_torch`: tensors → numpy arrays (bf16 → float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [to_numpy(v) for v in tree]
        return tuple(seq) if isinstance(tree, tuple) else seq
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()

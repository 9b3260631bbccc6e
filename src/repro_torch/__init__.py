"""PyTorch/CUDA port of the ShiftAddViT serving path.

The package mirrors `repro`'s layout (`core/`, `kernels/`, `nn/`, `serve/`,
`launch/`) so each module has an obvious counterpart in the JAX reference.
It imports `torch` only: nothing of `jax` and nothing of `repro`.

- :mod:`repro_torch.bridge` — reference parameter trees (numpy leaves) →
  torch tensors on a device, same keys.
- :mod:`repro_torch.kernels` — the hand-written CUDA kernels (`shift_matmul`,
  `bidir_binary_attention`), their plain PyTorch versions, and the `impl`
  dispatch (`"cuda"` | `"torch"`), threaded explicitly — never a global.
- :mod:`repro_torch.serve.vision` — `BucketedViTEngine`, the serving entry
  point. Entry points run on the card unless the caller asks for the CPU.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. "cuda" (the default everywhere)
    raises when no GPU is present instead of quietly running on the CPU;
    pass device="cpu" to ask for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def default_impl(device) -> str:
    """Kernel choice for a device: the hand-written kernels on a GPU, the
    plain PyTorch versions on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"

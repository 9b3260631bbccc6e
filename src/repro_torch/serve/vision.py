"""Batched ShiftAddViT inference engine. Counterpart of
`repro/serve/vision.py` (`BucketedViTEngine`, `build_policy_model`).

Requests of any size are cut into chunks of at most the largest bucket, each
chunk is padded up to the smallest bucket that holds it, and the padding is
sliced off the logits. The engine freezes its parameters once at build
(`core.deploy`) and runs eagerly: there is no compile step, so nothing
recompiles; per-bucket CUDA graphs are later work.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import default_impl, resolve_device
from repro_torch.core.policy import DENSE, SHIFTADD, STAGE1
from repro_torch.nn.vit import ShiftAddViT, ViTConfig

DEFAULT_BUCKETS = (1, 8, 32)

# name → (policy, convert_from stage)
SWEEP_POLICIES = {
    "dense": (DENSE, 0),
    "stage1": (STAGE1, 1),
    "shiftadd": (SHIFTADD, 2),
}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_to_device(v, device) for v in tree]
        return tuple(seq) if isinstance(tree, tuple) else seq
    return tree.to(device)


class BucketedViTEngine:
    """Pads variable-size image batches into bucket shapes.

    model/params: a ShiftAddViT and its parameter tree (any device; it is
    moved to `device`). device: "cuda" by default; raises when there is no
    GPU unless the caller passes device="cpu". impl: "cuda" (the hand-written
    kernels) or "torch" (their plain versions); default "cuda" on a GPU,
    "torch" on the CPU. tune: a kernels.autotune.TuneTable whose launch
    configurations every kernel call takes (None → the defaults); no entry
    changes a logit's bits.
    """

    def __init__(self, model: ShiftAddViT, params, buckets=DEFAULT_BUCKETS,
                 device="cuda", impl=None, tune=None):
        if len(buckets) == 0 or min(buckets) < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.model = model
        self.device = resolve_device(device)
        self.impl = impl or default_impl(self.device)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.plan = model.prepare_inference(
            _to_device(params, self.device),
            token_counts=(model.cfg.n_patches,), tune=tune)
        self.batches_served = 0
        self.images_served = 0
        self.padded_images_served = 0   # bucket slots, padding included

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits n (callers chunk to the largest first)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def _call(self, images):
        return self.model.infer(self.plan.params, images, impl=self.impl,
                                tune=self.plan.tune)

    def warmup(self):
        """Run every bucket once (kernel builds, allocator, library set-up)."""
        c = self.model.cfg
        for b in self.buckets:
            self._call(torch.zeros((b, c.image_size, c.image_size,
                                    c.in_channels), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def infer(self, images):
        """images: (n, H, W, C), any n >= 1 (numpy or tensor) → logits
        (n, n_classes) float32 on the engine's device."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        n = images.shape[0]
        if n == 0:
            return torch.zeros((0, self.model.cfg.n_classes), device=self.device)
        bmax = self.buckets[-1]
        outs = []
        start = 0
        while start < n:
            take = min(bmax, n - start)
            bucket = self.bucket_for(take)
            chunk = images[start:start + take]
            if take < bucket:
                pad = torch.zeros((bucket - take,) + tuple(chunk.shape[1:]),
                                  dtype=chunk.dtype, device=self.device)
                chunk = torch.cat([chunk, pad], dim=0)
            outs.append(self._call(chunk)[:take])
            self.batches_served += 1
            self.padded_images_served += bucket
            start += take
        self.images_served += n
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def build_policy_model(base_cfg: ViTConfig, name: str,
                       dense_model: ShiftAddViT, dense_params):
    """A (model, params) pair for one sweep arm: the base config re-policied
    and the dense params pushed through the paper's conversion."""
    policy, stage = SWEEP_POLICIES[name]
    model = ShiftAddViT(dataclasses.replace(base_cfg, policy=policy))
    return model, model.convert_from(dense_model, dense_params, stage=stage)

"""Serve a stream of mixed-size image requests through the port's bucketed
ShiftAddViT engine and report per-bucket latency and kernel launches.

    python -m repro_torch.launch.serve_vit --policy shiftadd
    python -m repro_torch.launch.serve_vit --policy shiftadd --tune TUNE_kernels_torch.json
    python -m repro_torch.launch.serve_vit --policy stage1 --device cpu --image-size 16

Weights are random from `--seed` (a dense ViT pushed through the paper's
conversion, with a seeded non-zero MoE router). Runs on the GPU by default;
`--device cpu` asks for the CPU (plain PyTorch versions of the kernels).
`--tune` serves with a table written by `python -m repro_torch.launch.autotune`
(a table that cannot be loaded serves the defaults, with a warning).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch.core.policy import DENSE
from repro_torch.kernels import autotune, ops
from repro_torch.nn.vit import ShiftAddViT, ViTConfig, with_seeded_router
from repro_torch.serve.vision import (SWEEP_POLICIES, BucketedViTEngine,
                                      build_policy_model)


def bucket_latencies(engine, iters=20, seed=0):
    """Median seconds of one `engine.infer` per bucket, on a full bucket of
    images, each run ended by a device synchronize."""
    c = engine.model.cfg
    g = torch.Generator(device=engine.device).manual_seed(seed)
    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    out = {}
    for b in engine.buckets:
        images = torch.randn((b, c.image_size, c.image_size, c.in_channels),
                             generator=g, device=engine.device)
        times = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            engine.infer(images)
            sync()
            times.append(time.perf_counter() - t0)
        out[b] = statistics.median(times)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="shiftadd", choices=sorted(SWEEP_POLICIES))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=56,
                    help="56 is the serving geometry (196 tokens)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", choices=list(ops.IMPLS), default=None,
                    help="default: cuda on a GPU, torch on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tune", default=None, metavar="TUNE_kernels_torch.json",
                    help="autotune table (repro_torch.launch.autotune output)")
    args = ap.parse_args(argv)

    tune = None
    if args.tune:
        tune = autotune.load_table(args.tune)
        if tune is None:
            print(f"warning: could not load tune table {args.tune}; serving "
                  "with the default launch configurations")

    cfg = ViTConfig(image_size=args.image_size)
    dense_model = ShiftAddViT(dataclasses.replace(cfg, policy=DENSE))
    model, params = build_policy_model(cfg, args.policy, dense_model,
                                       dense_model.init(args.seed))
    params = with_seeded_router(params, args.seed + 1)
    engine = BucketedViTEngine(model, params, device=args.device,
                               impl=args.impl, tune=tune).warmup()
    print(f"policy={args.policy} device={engine.device} impl={engine.impl} "
          f"tuned={tune is not None} "
          f"buckets={list(engine.buckets)} tokens/image={cfg.n_patches} "
          f"shift weights packed={engine.plan.frozen_linears}")

    g = torch.Generator(device=engine.device).manual_seed(args.seed + 2)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    sizes = [(i % engine.buckets[-1]) + 1 for i in range(args.requests)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for n in sizes:
        logits = engine.infer(torch.randn((n,) + shape, generator=g,
                                          device=engine.device))
        if not torch.isfinite(logits).all():
            raise RuntimeError("non-finite logits")
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"served {len(sizes)} requests ({sum(sizes)} images, "
          f"{engine.batches_served} batches) in {dt:.4f} s; kernel launches "
          f"{counts}")
    for b, s in bucket_latencies(engine, seed=args.seed).items():
        print(f"bucket {b:3d}: median {s * 1e3:.4f} ms/batch")


if __name__ == "__main__":
    main()

"""The Hamming attentions and the serving forward of one checkout of the
PyTorch/CUDA port, on the card, measured with `chip_smoke.py`'s own timing
functions so that two checkouts can be compared in turns.

    python3 tools/ab_attention.py [--src DIR] [--label NAME]
                                  [--parts attention causal forward buckets]

`--src` is the `src/` directory whose `repro_torch` is measured (this
checkout's by default): unpack the other checkout under `build/` and run
parent, change, change, parent on one card. It prints, from `chip_smoke`:
- attention (`time_attention`, `time_site`): the bidirectional kernel's
  device ms at G = 4 and G = 128; the serving site's device µs, kernels and
  host µs per call at buckets 1 and 32;
- causal (`time_causal` at `CAUSAL_TIMED`): the causal kernel's device ms
  per call (summed over the call's kernels) at G = 128, N = 196, D = 32 with
  chunks 196, 64 and 128, at G = 4, and at G = 32, N = 4096, D = 128;
- forward (`profile_forward`): device-busy ms, kernels, and each serving
  kernel's ms and launches per forward of each arm at buckets 1 and 32,
  beside the median
  wall ms of a full-bucket forward (`launch.serve_vit.bucket_latencies`);
- buckets (`bucket_gaps`, `stage_gaps`): for each arm's engine with its
  default kernels, the logits of 4 probe images alone (bucket 1), among 8
  and among 32, compared bit for bit (differing logits, largest gap), and
  for shiftadd where the bits part stage by stage.
Only what every version of the port has is called. Prints the card's name
and power limit and, last, one JSON object. Needs one CUDA device; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("attention", "causal", "forward", "buckets")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--wall-iters", type=int, default=100)
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; {args.label}: {args.src}", flush=True)
    dev = torch.device("cuda", 0)
    result = {"label": args.label, "card": smi, "kernel_ms": {}, "site": {},
              "causal_ms": {}, "forward": {}, "buckets": {}}
    if "attention" in args.parts:
        for g in (4, 128):
            result["kernel_ms"][f"G={g}"] = cs.time_attention(torch, dev, g, 196, 32)[0]
        for b in (1, 32):
            dev_us, kernels, host_us = cs.time_site(torch, dev, b)
            result["site"][f"bucket {b}"] = {"device_us": dev_us, "kernels": kernels,
                                             "host_us": host_us}
    if "causal" in args.parts:
        for name, shape in cs.CAUSAL_TIMED.items():
            result["causal_ms"][f"{name} {shape}"] = cs.time_causal(torch, dev, *shape)[0]
    if "forward" in args.parts:
        forward(torch, dev, cs, args.wall_iters, result)
    if "buckets" in args.parts:
        buckets(torch, dev, cs, result)
    for key, val in result.items():
        if isinstance(val, dict):
            for sub, x in val.items():
                print(f"  {key} {sub}: {x}", flush=True)
    print(smi)
    print(json.dumps(result), flush=True)
    return 0


def forward(torch, dev, cs, wall_iters, result):
    """Device-busy ms, kernels, attention launches and wall ms per forward
    of each arm at buckets 1 and 32, into result["forward"]."""
    from repro_torch.core.policy import DENSE
    from repro_torch.launch.serve_vit import bucket_latencies
    from repro_torch.nn.vit import ShiftAddViT, ViTConfig, with_seeded_router
    from repro_torch.serve.vision import BucketedViTEngine, build_policy_model

    cfg = ViTConfig(image_size=56)
    dense_model = ShiftAddViT(dataclasses.replace(cfg, policy=DENSE))
    dense_params = dense_model.init(0)
    for arm in ("shiftadd", "stage1", "dense"):
        model, params = build_policy_model(cfg, arm, dense_model, dense_params)
        engine = BucketedViTEngine(model, with_seeded_router(params, 7), device=dev).warmup()
        wall = bucket_latencies(engine, iters=wall_iters)
        for b in (1, 32):
            n_k, busy, _, serving = cs.profile_forward(torch, engine, b)
            result["forward"][f"{arm} b{b}"] = {
                "device_busy_ms": busy, "kernels": n_k,
                "serving_kernels_ms_launches": serving, "wall_ms": wall[b] * 1e3}


def buckets(torch, dev, cs, result):
    """Each arm's logits by bucket, and shiftadd's by stage, into
    result["buckets"]."""
    from repro_torch.serve.vision import BucketedViTEngine

    for arm in ("shiftadd", "stage1", "dense"):
        engine = BucketedViTEngine(*cs.arm_model(torch, arm), device=dev).warmup()
        result["buckets"][f"{arm} logits"] = cs.bucket_gaps(torch, engine)
        if arm == "shiftadd":
            result["buckets"][f"{arm} stages"] = cs.stage_gaps(torch, engine)


if __name__ == "__main__":
    sys.exit(main())

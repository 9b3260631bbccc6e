"""Kernel autotune on the card: time every launch configuration of every
kernel at each serving site × bucket, and write the winners.

    python -m repro_torch.launch.autotune                  # on the card
    python -m repro_torch.launch.autotune --device cpu --measure off --out /tmp/t.json
    python -m repro_torch.launch.autotune --buckets 1 8 32 --image-size 56

The output (default `TUNE_kernels_torch.json`; the root `TUNE_kernels.json`
belongs to the JAX package) feeds `--tune` on
`python -m repro_torch.launch.serve_vit`, which threads the table to every
kernel call. Runs on the card unless `--device cpu` is given; there
`--measure off` gives every site its kernel's default configuration.

The flags are the reference CLI's, with `--device` added and `--shortlist`
left out: the reference ranks candidates by a cost model and times the first
few, while here nothing is ranked and every candidate that fits is timed
(at most 9 per site).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.kernels import autotune as at
from repro_torch.nn.vit import ViTConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image-size", type=int, default=56,
                    help="56 → 196 tokens at patch 4 (the serving geometry)")
    ap.add_argument("--patch-size", type=int, default=4)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=None,
                    help="default 2 × d_model (the benchmark convention)")
    ap.add_argument("--buckets", type=int, nargs="+", default=None,
                    help="serving bucket set to tune for (default: the "
                         "engine's DEFAULT_BUCKETS)")
    ap.add_argument("--measure", choices=["auto", "on", "off"],
                    default="auto",
                    help="time the candidates on the card (auto: on the "
                         "card, not on the CPU)")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed launches per candidate")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="TUNE_kernels_torch.json")
    args = ap.parse_args(argv)

    cfg = ViTConfig(image_size=args.image_size, patch_size=args.patch_size,
                    n_layers=args.layers, d_model=args.d_model,
                    n_heads=args.heads, d_ff=args.d_ff or 2 * args.d_model)
    measure = {"auto": None, "on": True, "off": False}[args.measure]
    table, report = at.autotune(cfg, buckets=args.buckets, measure=measure,
                                iters=args.iters, device=args.device)
    table.save(args.out, report=report)

    meta = table.meta_dict
    print(f"tuned {len(table)} geometries over buckets {meta['buckets']} on "
          f"{meta['device']} ({meta['card']}): {meta['reason']}")
    for row in report:
        head = f"{row['kernel']:<22} {row['site']:<14} b={row['bucket']:<3}"
        if row.get("winner") is None:
            print(f"{head} fits={row['fits']} ({row['note']})")
        elif row["winner_ms"] is None:
            print(f"{head} {row['winner']} (default, not measured)")
        else:
            print(f"{head} {row['winner']} {row['winner_ms']:.6f} ms; default "
                  f"{row['default']} {row['default_ms']:.6f} ms")
    print(f"wrote {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()

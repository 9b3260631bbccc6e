"""Chip smoke test of the PyTorch/CUDA port: builds the hand-written kernels
from this checkout, holds each against its plain PyTorch version on the card,
then serves the frozen ShiftAddViT at its serving geometry (196 tokens,
d_model 128, 4 layers, 4 heads) through the bucketed engine for the dense,
stage1 and shiftadd arms, and checks what comes out.

    python3 chip_smoke.py

Needs one CUDA device and nvcc. Imports nothing of JAX or of the reference
package. Prints the card's name and power limit, a JSON line of per-kernel
measurements, and, last, {"ok": true, "device": {...}}. Any failure raises
and exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks from NVIDIA's data sheet (dense): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

SHIFT_TOL = 2e-2      # scaled error, bf16 products summed in float32
ATTN_TOL = 1e-3       # scaled error, float32 throughout
# Engine logits, kernels vs plain versions on the card: the kernels sum in
# other orders than cuBLAS, which can flip a ±1 attention code or a router
# argmax that sits at a near-tie; one such flip moves a logit by far more
# than rounding, so the bound is the kernel tolerance, not float32 noise.
ENGINE_TOL = 2e-2
REQUEST_SIZES = (1, 5, 32, 40)


def log(*a):
    print(*a, flush=True)


def kernel_times(torch, fn, iters):
    """{kernel name: (device µs, launches)} over `iters` back-to-back calls
    of `fn` (after a warm-up), from a torch.profiler (CUPTI) trace."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    return by_name


def device_ms(torch, fn, iters=50):
    """Mean device milliseconds per call: the summed duration of the kernels
    each call ran. Host launch overhead and gaps are left out: timing the
    same loop with CUDA events measures the host's launch rate instead, as
    each call's Python and ctypes overhead outlasts these kernels. Inputs
    stay resident in L2, as in the model, where each kernel reads what the
    op before it just wrote."""
    return sum(t for t, _ in kernel_times(torch, fn, iters).values()) / iters / 1e3


def bound_ms(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_shift_matmul(torch, dev, shapes):
    """Kernel vs plain version at every shape; returns the max abs error."""
    from repro_torch.core.quant import pack_from_dense
    from repro_torch.kernels import ref
    from repro_torch.kernels.shift_matmul import shift_matmul
    from repro_torch.parity import scaled_error

    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=g, device=dev)
        wp = pack_from_dense(torch.randn((k, n), generator=g, device=dev) * k ** -0.5)
        got = shift_matmul(x, wp)
        want = ref.shift_matmul_ref(x, wp)
        torch.cuda.synchronize()
        err = scaled_error(got, want)
        log(f"  shift_matmul M={m} K={k} N={n}: scaled err {err:.3e}")
        if not err < SHIFT_TOL:
            raise AssertionError(f"shift_matmul {m}x{k}x{n}: {err} >= {SHIFT_TOL}")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def check_row_invariance(torch, dev):
    """Row i of shift_matmul is bit-identical at M=1 and at M=6272."""
    from repro_torch.core.quant import pack_from_dense
    from repro_torch.kernels.shift_matmul import shift_matmul

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((6272, 128), generator=g, device=dev)
    wp = pack_from_dense(torch.randn((128, 128), generator=g, device=dev) / 11.3)
    full = shift_matmul(x, wp)
    for i in (0, 63, 64, 3137, 6271):
        one = shift_matmul(x[i:i + 1].contiguous(), wp)
        if not torch.equal(one[0], full[i]):
            raise AssertionError(f"shift_matmul row {i} differs between M=1 and M=6272")
    log("  shift_matmul rows 0, 63, 64, 3137, 6271: bit-identical at M=1 and M=6272")


def check_attention(torch, dev, shapes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bidir_linear_attention import bidir_binary_attention
    from repro_torch.parity import scaled_error

    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for gg, n, dk, dv in shapes:
        q, k = (torch.randn((gg, n, dk), generator=g, device=dev) for _ in range(2))
        v = torch.randn((gg, n, dv), generator=g, device=dev)
        got = bidir_binary_attention(q, k, v)
        want = ref.bidir_binary_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = scaled_error(got, want)
        log(f"  bidir_binary_attention G={gg} N={n} Dk={dk} Dv={dv}: scaled err {err:.3e}")
        if not err < ATTN_TOL:
            raise AssertionError(f"attention {gg}x{n}x{dk}x{dv}: {err} >= {ATTN_TOL}")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def time_shift_matmul(torch, dev, m, k, n):
    from repro_torch.core.quant import pack_from_dense, po2_weight_from_packed
    from repro_torch.kernels import ref
    from repro_torch.kernels.shift_matmul import shift_matmul

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((m, k), generator=g, device=dev)
    wp = pack_from_dense(torch.randn((k, n), generator=g, device=dev) * k ** -0.5)
    w_bf16 = po2_weight_from_packed(wp)           # yardstick only: pre-decoded
    x_bf16 = x.to(torch.bfloat16)
    ms = device_ms(torch, lambda: shift_matmul(x, wp))
    plain = device_ms(torch, lambda: ref.shift_matmul_ref(x, wp))
    library = device_ms(torch, lambda: torch.matmul(x_bf16, w_bf16))
    b, by = bound_ms(4 * m * k + k * n + 4 * m * n, 2 * m * k * n, BF16_TENSOR_FLOPS)
    return ms, plain, library, b, by


def time_attention(torch, dev, gg, n, d):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bidir_linear_attention import bidir_binary_attention

    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((gg, n, d), generator=g, device=dev) for _ in range(3))
    ms = device_ms(torch, lambda: bidir_binary_attention(q, k, v))
    plain = device_ms(torch, lambda: ref.bidir_binary_attention_ref(q, k, v))
    # ±1 contractions: KV (N·Dk·Dv multiply-adds) and the numerator (the
    # same), 2 operations each, on the float32 cores.
    b, by = bound_ms(4 * gg * n * 4 * d, 2 * 2 * gg * n * d * d, FP32_FLOPS)
    return ms, plain, None, b, by


def seeded_live_params(torch, params, seed):
    """Seeded non-zero DWConv-on-V weights (convert_from leaves zeros)."""
    g = torch.Generator().manual_seed(seed)
    for blk in params["blocks"]:
        conv = blk["mixer"].get("dwconv")
        if conv is not None:
            blk["mixer"]["dwconv"] = {
                k: (torch.randn(tuple(t.shape), generator=g) * 0.3).to(t.device)
                for k, t in conv.items()}
    return params


def profile_forward(torch, engine, bucket, iters=20):
    """Device time of one forward on a full bucket: (kernels per forward,
    device-busy ms per forward, top kernels as (name, ms, launches) per
    forward)."""
    c = engine.model.cfg
    images = torch.randn((bucket, c.image_size, c.image_size, c.in_channels),
                         device=engine.device)
    by_name = kernel_times(torch, lambda: engine.infer(images), iters)
    busy_ms = sum(t for t, _ in by_name.values()) / iters / 1e3
    n_kernels = sum(n for _, n in by_name.values()) / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return n_kernels, busy_ms, [(name[:70], t / iters / 1e3, n / iters)
                                for name, (t, n) in top]


def serve_arms(torch, dev):
    """Serve requests of REQUEST_SIZES through each arm's engine on the card.
    Returns per-arm launch counts, per-bucket median latencies and errors."""
    from repro_torch.core.policy import DENSE
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_vit import bucket_latencies
    from repro_torch.nn.vit import ShiftAddViT, ViTConfig, with_seeded_router
    from repro_torch.parity import scaled_error
    from repro_torch.serve.vision import BucketedViTEngine, build_policy_model

    cfg = ViTConfig(image_size=56)                # 196 tokens, the serving geometry
    dense_model = ShiftAddViT(dataclasses.replace(cfg, policy=DENSE))
    dense_params = dense_model.init(0)
    g = torch.Generator(device=dev).manual_seed(6)
    requests = [torch.randn((s, 56, 56, 3), generator=g, device=dev) for s in REQUEST_SIZES]
    forwards = sum(-(-s // 32) for s in REQUEST_SIZES)
    expected = {"shiftadd": (24, 4), "stage1": (0, 4), "dense": (0, 0)}
    results = {}
    for arm in ("shiftadd", "stage1", "dense"):
        model, params = build_policy_model(cfg, arm, dense_model, dense_params)
        params = seeded_live_params(torch, with_seeded_router(params, 7), 8)
        engine = BucketedViTEngine(model, params, device=dev).warmup()
        plain = BucketedViTEngine(model, params, device=dev, impl="torch").warmup()
        if engine.impl != "cuda" or engine.buckets != (1, 8, 32):
            raise AssertionError(f"{arm}: impl {engine.impl}, buckets {engine.buckets}")

        ops.reset_launch_counts()
        outs = [engine.infer(r) for r in requests]
        torch.cuda.synchronize()
        counts = ops.launch_counts()

        want = (expected[arm][0] * forwards, expected[arm][1] * forwards)
        got = (counts["shift_matmul"], counts["bidir_binary_attention"])
        if got != want:
            raise AssertionError(f"{arm}: launches {got}, expected {want} "
                                 f"over {forwards} forwards")
        worst, agree = 0.0, 0
        for r, o in zip(requests, outs):
            if tuple(o.shape) != (r.shape[0], 10) or not torch.isfinite(o).all():
                raise AssertionError(f"{arm}: bad logits for a request of {r.shape[0]}")
            ref_logits = plain.infer(r)
            for i in range(r.shape[0]):
                worst = max(worst, scaled_error(o[i], ref_logits[i]))
            agree += int((o.argmax(-1) == ref_logits.argmax(-1)).sum())
        if not worst < ENGINE_TOL:
            raise AssertionError(f"{arm}: kernels vs plain logits, scaled err {worst}")
        if arm == "shiftadd":
            # the plain versions on the CPU, on a small input
            cpu = BucketedViTEngine(model, params, buckets=(2,), device="cpu")
            small = requests[1][:2]
            cpu_err = max(scaled_error(engine.infer(small)[i],
                                       cpu.infer(small.cpu())[i]) for i in range(2))
            if not cpu_err < ENGINE_TOL:
                raise AssertionError(f"card vs CPU logits: scaled err {cpu_err}")
            log(f"  shiftadd card vs CPU (2 images): scaled err {cpu_err:.3e}")
        lat = bucket_latencies(engine, iters=30)
        lat_plain = bucket_latencies(plain, iters=30) if arm != "dense" else None
        profiles = {}
        for b in (1, 32):
            n_k, busy, top = profile_forward(torch, engine, b)
            profiles[b] = {"kernels_per_forward": n_k, "device_busy_ms": busy,
                           "idle_share": (1.0 - busy / (lat[b] * 1e3)
                                          if busy > 0 else "not measured"),
                           "top": top}
        results[arm] = {"launches": counts, "forwards": forwards,
                        "max_scaled_err_vs_plain": worst,
                        "argmax_agree": f"{agree}/{sum(REQUEST_SIZES)}",
                        "bucket_ms": {b: s * 1e3 for b, s in lat.items()},
                        "plain_bucket_ms": (None if lat_plain is None else
                                            {b: s * 1e3 for b, s in lat_plain.items()}),
                        "profile": profiles}
        log(f"  {arm}: {json.dumps(results[arm])}")
    return results


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    log("[1] build")
    t0 = time.perf_counter()
    for name, (sec, text) in build.build_all().items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: built in {sec:.1f} s; " + " | ".join(regs))
    log(f"  build total {time.perf_counter() - t0:.1f} s")

    log("[2] kernels vs plain versions")
    cap = {1: (133, 113), 32: (32 * 133, 32 * 113)}   # Shift / Mult expert rows
    shift_shapes = []
    for b in (1, 32):
        shift_shapes += [(196 * b, 128, 128), (cap[b][0], 128, 256), (cap[b][0], 256, 128)]
    shift_shapes += [(197, 128, 128), (70, 300, 200), (1, 64, 640)]
    shift_err = check_shift_matmul(torch, dev, shift_shapes)
    check_row_invariance(torch, dev)
    attn_err = check_attention(torch, dev, [(4, 196, 32, 32), (128, 196, 32, 32),
                                            (8, 197, 32, 32), (2, 197, 64, 48)])

    log("[3] timing at the bucket-32 shapes")
    timings = {
        "shift_matmul": time_shift_matmul(torch, dev, 6272, 128, 128),
        "shift_matmul up": time_shift_matmul(torch, dev, 4256, 128, 256),
        "shift_matmul down": time_shift_matmul(torch, dev, 4256, 256, 128),
        "bidir_binary_attention": time_attention(torch, dev, 128, 196, 32),
    }
    for name, (ms, plain, lib, b, by) in timings.items():
        log(f"  {name}: kernel {ms:.5f} ms, plain {plain:.5f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.5f} ms'}, bound {b:.5f} ms ({by})")

    log("[4] serving the three arms at 196 tokens")
    arms = serve_arms(torch, dev)

    launches = {k: sum(a["launches"][k] for a in arms.values())
                for k in ("shift_matmul", "bidir_binary_attention")}
    kernels = []
    for name, source, replaces, err, shape, t in (
            ("shift_matmul", "src/repro_torch/kernels/csrc/shift_matmul.cu",
             "src/repro/kernels/shift_matmul.py:57", shift_err, "M=6272 K=128 N=128 fp32",
             timings["shift_matmul"]),
            ("bidir_binary_attention",
             "src/repro_torch/kernels/csrc/bidir_linear_attention.cu",
             "src/repro/kernels/bidir_linear_attention.py:82", attn_err,
             "G=128 N=196 D=32 fp32", timings["bidir_binary_attention"])):
        ms, plain, lib, b, by = t
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": b, "bound_by": by, "library_ms": lib,
                        "shape": shape})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke test of the PyTorch/CUDA port: builds the hand-written kernels
from this checkout, holds each against its plain PyTorch version on the card,
then drives the port's two paths at the serving geometry (196 tokens,
d_model 128, 4 layers, 4 heads) and checks what comes out:

- [1] build the five kernel sources (one nvcc each, in parallel);
- [2] each kernel against its plain version at the serving shapes and at
  ragged ones, the attentions also at head dim 256 (Dv split across
  blocks) and at N = 5000; every tile of the three matmuls bit-identical, a
  row of shift_matmul and a batch entry of add_matmul the same bits alone
  as among all; a batch·head of the bidirectional attention the same bits
  alone, among G = 4 and among G = 128, on strided projection views as on
  contiguous copies, and whatever the Dv slice width;
- [3] device time of each kernel at its bucket-32 shape (the bidirectional
  attention also at bucket 1, G = 4) beside its time before its last
  redesign, its bound, its plain version and, where one exists, one PyTorch
  call's time; the attention's serving site (projection views in, the
  o-projection's reshape after) at buckets 1 and 32: device µs, kernels
  and host µs per call;
- [4] serving the frozen ShiftAddViT through the bucketed engine for the
  dense, stage1 and shiftadd arms, with kernels and attention launches per
  forward from a profiler trace;
- [5] the autotune entry point: every serving site × bucket (1, 8, 32),
  every launch configuration timed on the card, the table written to
  build/TUNE_kernels_torch.json;
- [6] serving shiftadd with that table: logits bit-identical to the untuned
  engine's, 24 shift_matmul + 4 attention launches per forward, tuned and
  untuned wall times side by side.

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
import statistics
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
ADD_TOL = 2e-2        # the same, for add_matmul and add_matmul_packed
ATTN_TOL = 1e-3       # scaled error, float32 throughout (both attentions)
# Engine logits, kernels vs plain versions on the card: the kernels sum in
# other orders than cuBLAS, which can flip a ±1 attention code or a router
# argmax that sits at a near-tie; one such flip moves a logit by far more
# than rounding, so the bound is the kernel tolerance, not float32 noise.
ENGINE_TOL = 2e-2
REQUEST_SIZES = (1, 5, 32, 40)
# Device ms per launch of each kernel at the phase-[3] shapes before its
# last redesign, printed beside each new time: the matmuls and the causal
# attention with the first tiled matmul core era's kernels (WMMA), the
# bidirectional attention with its one-block-per-batch·head kernel (the
# G = 128 time of the third slice's run); this script's runs on an NVIDIA
# H100 80GB HBM3 at 700.00 W, recorded in PERF.md. None: never measured.
EARLIER_MS = {"shift_matmul": 0.01463546, "shift_matmul up": 0.01544,
              "shift_matmul down": 0.02546, "bidir_binary_attention": 0.04558,
              "bidir_binary_attention G=4": None,
              "add_matmul": 0.01867232, "add_matmul q_ktv": 0.00719,
              "add_matmul_packed": 0.01797008, "add_matmul_packed q_ktv": 0.00746,
              "binary_linear_attention": 0.19065472}


def log(*a):
    print(*a, flush=True)


def kernel_times(torch, fn, iters):
    """{kernel name: (device µs, launches)} over `iters` back-to-back calls
    of `fn` (after a warm-up), from a torch.profiler (CUPTI) trace; {} if
    the profiler recorded no device event in any of its attempts."""
    from repro_torch.kernels.autotune import trace_device

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    by_name = {}
    for name, ms in trace_device(fn, iters):
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + ms * 1e3, n + 1)
    return by_name


PROFILED = "mean summed kernel durations per call (torch.profiler)"
GRAPHED = ("mean per call over CUDA-graph replays (CUDA events, gaps between "
           "kernels included; the profiler recorded nothing)")


def device_ms(torch, fn, iters=50):
    """(mean device milliseconds per call, how it was timed): the summed
    duration of the kernels each call ran. Host launch overhead and gaps are
    left out: timing the same loop with CUDA events measures the host's
    launch rate instead, as each call's Python and ctypes overhead outlasts
    these kernels. Inputs stay resident in L2, as in the model, where each
    kernel reads what the op before it just wrote. Should the profiler
    record nothing, CUDA-graph replays timed with CUDA events stand in
    (gaps between kernels included), and the method says so."""
    from repro_torch.kernels.autotune import graph_ms

    by_name = kernel_times(torch, fn, iters)
    if by_name:
        return sum(t for t, _ in by_name.values()) / iters / 1e3, PROFILED
    log("  (the profiler recorded no device time; timed by CUDA-graph replays)")
    return graph_ms(fn, iters), GRAPHED


def timed(torch, **fns):
    """{key: ms} and {key: how it was timed} of device_ms for each of
    ms / plain_ms / library_ms (a None function gives None)."""
    times, how = {}, {}
    for key, fn in fns.items():
        times[key], how[key] = device_ms(torch, fn) if fn is not None else (None, None)
    return times, how


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
    """Row i of shift_matmul is bit-identical at M=1 and at the full M of
    each serving site; batch·head g of add_matmul alone gives the bits it
    gets among G=128, at ktv and q_ktv."""
    from repro_torch.core.quant import pack_from_dense
    from repro_torch.kernels.add_matmul import add_matmul
    from repro_torch.kernels.shift_matmul import shift_matmul

    g = torch.Generator(device=dev).manual_seed(2)
    for m, k, n in ((6272, 128, 128), (4256, 128, 256), (4256, 256, 128)):
        x = torch.randn((m, k), generator=g, device=dev)
        wp = pack_from_dense(torch.randn((k, n), generator=g, device=dev) * k ** -0.5)
        full = shift_matmul(x, wp)
        for i in (0, 63, 64, 3137, m - 1):
            one = shift_matmul(x[i:i + 1].contiguous(), wp)
            if not torch.equal(one[0], full[i]):
                raise AssertionError(f"shift_matmul {m}x{k}x{n}: row {i} differs between "
                                     f"M=1 and M={m}")
    log("  shift_matmul rows 0, 63, 64, 3137, M-1: bit-identical at M=1 and at M=6272 "
        "(q/k/v/o), 4256 (expert up, down)")
    for m, k, n in ((32, 196, 32), (196, 32, 32)):
        x = torch.randn((128, m, k), generator=g, device=dev)
        b = _signs(torch, g, (128, k, n), dev, zeros=True)
        full = add_matmul(x, b)
        for i in (0, 77, 127):
            one = add_matmul(x[i:i + 1].contiguous(), b[i:i + 1].contiguous())
            if not torch.equal(one[0], full[i]):
                raise AssertionError(f"add_matmul {m}x{k}x{n}: batch entry {i} differs "
                                     "alone and among G=128")
    log("  add_matmul batch entries 0, 77, 127: bit-identical alone and among G=128 "
        "(ktv, q_ktv)")


def check_attention(torch, dev, shapes):
    """The bidirectional kernel against its plain version at every shape,
    run to run identical; returns the max abs error."""
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
        if not torch.equal(bidir_binary_attention(q, k, v), got):
            raise AssertionError(f"attention {gg}x{n}x{dk}x{dv}: differs between runs")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def check_attention_invariance(torch, dev):
    """The bidirectional kernel's invariants: batch·heads 0, 77 and 127 give
    the same bits alone (G = 1), among G = 4 and among G = 128; the
    (B, H, N, D) views of (B, N, H·D) projections give the bits of
    contiguous copies, within ATTN_TOL of the plain version, and the output
    is a view of a (B, N, H, D) buffer; at Dk = 256 the slice width, which
    follows Dv, changes no bit. Returns the max abs error of the strided runs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bidir_linear_attention import bidir_binary_attention, dv_slice
    from repro_torch.parity import scaled_error

    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v = (torch.randn((128, 196, 32), generator=g, device=dev) for _ in range(3))
    full = bidir_binary_attention(q, k, v)
    pick = [0, 77, 127, 5]
    four = bidir_binary_attention(*(t[pick].contiguous() for t in (q, k, v)))
    for j, i in enumerate(pick[:3]):
        one = bidir_binary_attention(*(t[i:i + 1].contiguous() for t in (q, k, v)))
        if not (torch.equal(one[0], full[i]) and torch.equal(four[j], full[i])):
            raise AssertionError(f"attention: batch·head {i} differs alone, among G=4 "
                                 "and among G=128")
    log("  bidir_binary_attention batch·heads 0, 77, 127: bit-identical alone, among G=4 "
        "and among G=128")
    worst = 0.0
    for b, n, h, d in ((1, 196, 4, 32), (32, 196, 4, 32), (2, 197, 3, 48), (1, 70, 2, 7)):
        qv, kv, vv = (torch.randn((b, n, h * d), generator=g, device=dev)
                      .reshape(b, n, h, d).permute(0, 2, 1, 3) for _ in range(3))
        got = bidir_binary_attention(qv, kv, vv)
        flat = bidir_binary_attention(*(t.reshape(b * h, n, d).contiguous()
                                        for t in (qv, kv, vv)))
        want = ref.bidir_binary_attention_ref(qv, kv, vv)
        torch.cuda.synchronize()
        err = scaled_error(got, want)
        if not (torch.equal(got.reshape(b * h, n, d), flat) and err < ATTN_TOL
                and got.permute(0, 2, 1, 3).is_contiguous()):
            raise AssertionError(f"attention views B={b} N={n} H={h} D={d}: err {err}, "
                                 "or bits differ from contiguous copies")
        worst = max(worst, float((got - want).abs().max()))
    log(f"  bidir_binary_attention on projection views (B, H, N, D): bit-identical to "
        f"contiguous copies, max abs err {worst:.3e}")
    # The slice width follows Dv: 64 at Dv = 256 and 200, all of Dv from 128
    # down. An output column depends on its column of v alone.
    for dv in (256, 200):
        q, k = (torch.randn((2, 197, 256), generator=g, device=dev) for _ in range(2))
        v = torch.randn((2, 197, dv), generator=g, device=dev)
        want = bidir_binary_attention(q, k, v)
        for cols in (128, 64, 32, 24, 16, 10, 8):
            got = bidir_binary_attention(q, k, v[..., :cols].contiguous())
            if not torch.equal(got, want[..., :cols]):
                raise AssertionError(f"attention Dk=256: Dv={cols} (slice "
                                     f"{dv_slice(256, cols)}) differs from the first "
                                     f"columns at Dv={dv} (slice {dv_slice(256, dv)})")
    log("  bidir_binary_attention Dk=256: the first columns at Dv=256 and 200 (slices of 64) "
        "bit-identical to Dv=128, 64, 32, 24, 16, 10, 8 (one slice each)")
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
    t, how = timed(torch, ms=lambda: shift_matmul(x, wp),
                   plain_ms=lambda: ref.shift_matmul_ref(x, wp),
                   library_ms=lambda: torch.matmul(x_bf16, w_bf16))
    b, by = bound_ms(4 * m * k + k * n + 4 * m * n, 2 * m * k * n, BF16_TENSOR_FLOPS)
    return t["ms"], t["plain_ms"], t["library_ms"], b, by, how


def time_attention(torch, dev, gg, n, d):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bidir_linear_attention import bidir_binary_attention

    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((gg, n, d), generator=g, device=dev) for _ in range(3))
    t, how = timed(torch, ms=lambda: bidir_binary_attention(q, k, v),
                   plain_ms=lambda: ref.bidir_binary_attention_ref(q, k, v),
                   library_ms=None)
    # ±1 contractions: KV (N·Dk·Dv multiply-adds) and the numerator (the
    # same), 2 operations each, on the float32 cores.
    b, by = bound_ms(4 * gg * n * 4 * d, 2 * 2 * gg * n * d * d, FP32_FLOPS)
    return t["ms"], t["plain_ms"], None, b, by, how


def time_site(torch, dev, b, n=196, h=4, d=32, iters=200, rounds=5):
    """The bidirectional attention's serving site at bucket `b`:
    `ops.binary_linear_attention_bidir(impl="cuda")` on the (B, H, N, D)
    views of (B, N, H·D) projections, then the o-projection's reshape, as
    `nn/attention.Attention.infer` calls them. Returns (device µs per call,
    kernels per call, host µs per call). Host µs: the median over `rounds`
    of `iters` back-to-back calls on the host clock with no synchronize
    inside, so it is the time the host takes to issue one call (the device
    never holds the loop up: fewer launches are queued than it can take)."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn((b, n, h * d), generator=g, device=dev)
               .reshape(b, n, h, d).permute(0, 2, 1, 3) for _ in range(3))

    def site():
        out = ops.binary_linear_attention_bidir(q, k, v, impl="cuda")
        return out.permute(0, 2, 1, 3).reshape(b, n, h * d)

    by_name = kernel_times(torch, site, iters)
    dev_us = sum(t for t, _ in by_name.values()) / iters if by_name else "not measured"
    kernels = sum(c for _, c in by_name.values()) / iters if by_name else "not measured"
    host = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            site()
        host.append((time.perf_counter() - t0) / iters * 1e6)
    torch.cuda.synchronize()
    return dev_us, kernels, statistics.median(host)


def _signs(torch, gen, shape, dev, zeros=False):
    """int8 codes: ±1, or {-1, 0, +1} with zeros=True."""
    if zeros:
        return torch.randint(-1, 2, shape, generator=gen, device=dev, dtype=torch.int8)
    return torch.randint(0, 2, shape, generator=gen, device=dev, dtype=torch.int8) * 2 - 1


def check_add_matmuls(torch, dev, shapes):
    """add_matmul (b with zeros) and add_matmul_packed (K rounded up to 8)
    against their plain versions; returns the max abs error of each."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.add_matmul import add_matmul
    from repro_torch.kernels.add_matmul_packed import add_matmul_packed, pack_bits, unpack_bits
    from repro_torch.parity import scaled_error

    gen = torch.Generator(device=dev).manual_seed(9)
    worst = {"add_matmul": 0.0, "add_matmul_packed": 0.0}
    for g, m, k, n in shapes:
        x = torch.randn((g, m, k), generator=gen, device=dev)
        b = _signs(torch, gen, (g, k, n), dev, zeros=True)
        kp = -(-k // 8) * 8
        xp = torch.randn((g, m, kp), generator=gen, device=dev)
        packed = pack_bits(_signs(torch, gen, (g, kp, n), dev))
        for name, got, want in (
                ("add_matmul", add_matmul(x, b), ref.add_matmul_ref(x, b)),
                ("add_matmul_packed", add_matmul_packed(xp, packed),
                 ref.add_matmul_ref(xp, unpack_bits(packed)))):
            torch.cuda.synchronize()
            err = scaled_error(got, want)
            log(f"  {name} G={g} M={m} K={k if name == 'add_matmul' else kp} N={n}: "
                f"scaled err {err:.3e}")
            if not err < ADD_TOL:
                raise AssertionError(f"{name} {g}x{m}x{k}x{n}: {err} >= {ADD_TOL}")
            worst[name] = max(worst[name], float((got - want).abs().max()))
    return worst


def check_tiles_bit_identical(torch, dev):
    """Every tile of the three matmuls gives the default tile's bits at the
    serving shapes and at a ragged one longer than one K chunk: a tuned
    launch never changes an output."""
    from repro_torch.core.quant import pack_from_dense
    from repro_torch.kernels.add_matmul import add_matmul
    from repro_torch.kernels.add_matmul_packed import add_matmul_packed, pack_bits
    from repro_torch.kernels.shift_matmul import shift_matmul
    from repro_torch.kernels.tile_matmul import TILES

    from repro_torch.kernels.tile_matmul import _sms, launch_tile

    gen = torch.Generator(device=dev).manual_seed(10)
    cases = {}
    # The last shape of each kernel is large enough that every tile launches
    # as itself (no tile is shrunk to the product or to cover the SMs).
    for m, k, n in ((6272, 128, 128), (4256, 128, 256), (4256, 256, 128), (300, 600, 200),
                    (4256, 256, 256)):
        x = torch.randn((m, k), generator=gen, device=dev)
        wp = pack_from_dense(torch.randn((k, n), generator=gen, device=dev) * k ** -0.5)
        cases[f"shift_matmul {m}x{k}x{n}"] = (1, m, n,
                                              lambda t, x=x, wp=wp: shift_matmul(x, wp, t))
    for g, m, k, n in ((128, 32, 200, 32), (128, 200, 32, 32), (3, 70, 304, 200),
                       (16, 512, 200, 256)):
        xa = torch.randn((g, m, k), generator=gen, device=dev)
        b = _signs(torch, gen, (g, k, n), dev)
        packed = pack_bits(b)
        cases[f"add_matmul {g}x{m}x{k}x{n}"] = (g, m, n,
                                                lambda t, xa=xa, b=b: add_matmul(xa, b, t))
        cases[f"add_matmul_packed {g}x{m}x{k}x{n}"] = (
            g, m, n, lambda t, xa=xa, p=packed: add_matmul_packed(xa, p, t))
        if not torch.equal(add_matmul_packed(xa, packed), add_matmul(xa, b)):
            raise AssertionError(f"add_matmul_packed and add_matmul differ on the same codes "
                                 f"at {g}x{m}x{k}x{n}")
    launched = {kernel: set() for kernel in ("shift_matmul", "add_matmul", "add_matmul_packed")}
    for name, (g, m, n, fn) in cases.items():
        want = fn(None)
        for tile in TILES:
            launched[name.split()[0]].add(launch_tile(tile, g, m, n, _sms(dev.index or 0)))
            if not torch.equal(fn(tile), want):
                raise AssertionError(f"{name}: tile {tile} changes the output")
    missing = {k: sorted(set(TILES) - v) for k, v in launched.items() if set(TILES) - v}
    if missing:
        raise AssertionError(f"tiles never launched as themselves: {missing}")
    log(f"  shift_matmul, add_matmul, add_matmul_packed: all {len(TILES)} tiles launched and "
        f"bit-identical over {len(cases)} cases; packed == int8 operand bit for bit")


def check_causal(torch, dev, shapes):
    """The causal kernel against the quadratic plain version, with and
    without return_state; ksum exact; run to run identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.linear_attention import binary_linear_attention
    from repro_torch.parity import scaled_error

    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for g, n, dk, dv, chunk in shapes:
        q, k = (torch.randn((g, n, dk), generator=gen, device=dev) for _ in range(2))
        v = torch.randn((g, n, dv), generator=gen, device=dev)
        got = binary_linear_attention(q, k, v, chunk)
        out, kv, ksum, vsum = binary_linear_attention(q, k, v, chunk, return_state=True)
        want = ref.binary_linear_attention_ref(q, k, v)
        st = ref.binary_linear_attention_state_ref(q, k, v)
        torch.cuda.synchronize()
        errs = [scaled_error(got, want), scaled_error(out, want),
                scaled_error(kv, st["kv"]), scaled_error(vsum, st["vsum"])]
        log(f"  binary_linear_attention G={g} N={n} Dk={dk} Dv={dv} chunk={chunk}: "
            f"scaled err out {errs[0]:.3e}, with state {errs[1]:.3e}, kv {errs[2]:.3e}, "
            f"vsum {errs[3]:.3e}")
        if not max(errs) < ATTN_TOL:
            raise AssertionError(f"causal {g}x{n}x{dk}x{dv}: {max(errs)} >= {ATTN_TOL}")
        if not torch.equal(ksum, st["ksum"]):
            raise AssertionError("causal: ksum is not exact")
        if not (torch.equal(out, got)
                and torch.equal(binary_linear_attention(q, k, v, chunk), got)):
            raise AssertionError("causal: output differs between runs")
        worst = max(worst, float((got - want).abs().max()), float((kv - st["kv"]).abs().max()))
    return worst


def time_add_matmul(torch, dev, g, m, k, n, packed=False):
    from repro_torch.kernels import ref
    from repro_torch.kernels.add_matmul import add_matmul
    from repro_torch.kernels.add_matmul_packed import add_matmul_packed, pack_bits, unpack_bits

    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((g, m, k), generator=gen, device=dev)
    b = _signs(torch, gen, (g, k, n), dev)
    if packed:
        p = pack_bits(b)
        t, how = timed(torch, ms=lambda: add_matmul_packed(x, p),
                       plain_ms=lambda: ref.add_matmul_ref(x, unpack_bits(p)),
                       library_ms=None)
        b_bytes = g * k // 8 * n
    else:
        x_bf16, b_bf16 = x.to(torch.bfloat16), b.to(torch.bfloat16)
        t, how = timed(torch, ms=lambda: add_matmul(x, b),
                       plain_ms=lambda: ref.add_matmul_ref(x, b),
                       library_ms=lambda: torch.bmm(x_bf16, b_bf16))
        b_bytes = g * k * n
    bound, by = bound_ms(4 * g * m * k + b_bytes + 4 * g * m * n, 2 * g * m * k * n,
                         BF16_TENSOR_FLOPS)
    return t["ms"], t["plain_ms"], t["library_ms"], bound, by, how


def causal_ops(n, dk, dv, chunk):
    """Operations of the chunked causal attention at one chunk size: per
    chunk of r rows, the inter-chunk products against the carry (none for
    the first chunk), the r(r+1)/2 causal scores and their sums over v, and
    the carry update (none after the last chunk)."""
    ops = 0
    for c0 in range(0, n, chunk):
        r = min(chunk, n - c0)
        if c0 > 0:
            ops += 2 * r * dk * dv + 2 * r * dk
        pairs = r * (r + 1) // 2
        ops += 2 * pairs * dk + 2 * pairs * dv + pairs
        if c0 + r < n:
            ops += 2 * r * dk * dv + r * (dk + dv)
    return ops


def time_causal(torch, dev, g, n, d):
    from repro_torch.kernels import ref
    from repro_torch.kernels.linear_attention import binary_linear_attention

    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (torch.randn((g, n, d), generator=gen, device=dev) for _ in range(3))
    chunk = min(256, n)               # what ops.binary_linear_attention_fused takes
    t, how = timed(torch, ms=lambda: binary_linear_attention(q, k, v, chunk),
                   plain_ms=lambda: ref.binary_linear_attention_ref(q, k, v),
                   library_ms=None)
    # The function's least work, not the kernel's own chunking: the fewest
    # operations over every chunk size (1 is the recurrent form).
    least = min(causal_ops(n, d, d, c) for c in range(1, n + 1))
    b, by = bound_ms(4 * g * n * 4 * d, g * least, FP32_FLOPS)
    return t["ms"], t["plain_ms"], None, b, by, how


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
    forward, shift_matmul's and the bidirectional attention's (ms,
    launches) per forward); "not measured" where the profiler recorded
    nothing."""
    c = engine.model.cfg
    images = torch.randn((bucket, c.image_size, c.image_size, c.in_channels),
                         device=engine.device)
    by_name = kernel_times(torch, lambda: engine.infer(images), iters)
    if not by_name:
        return "not measured", "not measured", [], "not measured", "not measured"
    busy_ms = sum(t for t, _ in by_name.values()) / iters / 1e3
    n_kernels = sum(n for _, n in by_name.values()) / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    shift = [(t, n) for name, (t, n) in by_name.items() if "DecodePo2" in name]
    shift_ms = (sum(t for t, _ in shift) / iters / 1e3, sum(n for _, n in shift) / iters)
    attn = [(t, n) for name, (t, n) in by_name.items() if "bidir_binary_attention" in name]
    attn_ms = (sum(t for t, _ in attn) / iters / 1e3, sum(n for _, n in attn) / iters)
    return n_kernels, busy_ms, [(name[:70], t / iters / 1e3, n / iters)
                                for name, (t, n) in top], shift_ms, attn_ms


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
            n_k, busy, top, shift, attn = profile_forward(torch, engine, b)
            if attn != "not measured" and attn[1] != expected[arm][1]:
                raise AssertionError(f"{arm} bucket {b}: {attn[1]} attention kernels per "
                                     f"forward in the trace, expected {expected[arm][1]}")
            log(f"  {arm} bucket {b}: {n_k} kernels per forward, device busy {busy} ms, "
                f"attention (ms, launches) per forward {attn}")
            profiles[b] = {"kernels_per_forward": n_k, "device_busy_ms": busy,
                           "shift_matmul_ms_launches": shift,
                           "attention_ms_launches": attn,
                           "idle_share": (1.0 - busy / (lat[b] * 1e3)
                                          if isinstance(busy, float) and busy > 0
                                          else "not measured"),
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


def run_autotune(torch, dev):
    """Phase [5]: the autotune entry point at the serving geometry; writes
    the table under build/ and returns (table as loaded back, report)."""
    from repro_torch.kernels import autotune
    from repro_torch.nn.vit import ViTConfig

    t0 = time.perf_counter()
    table, report = autotune.autotune(ViTConfig(image_size=56), buckets=(1, 8, 32),
                                      measure=True, device=dev)
    if len(report) != 27:
        raise AssertionError(f"autotune reported {len(report)} site x bucket pairs, not 27")
    for row in report:
        head = f"  {row['kernel']:<22} {row['site']:<14} b={row['bucket']:<3}"
        if row["winner"] is None:
            if not row["fits"]:
                raise AssertionError(f"{row['kernel']} does not fit a block at {row}")
            log(f"{head} fits ({row['smem_bytes']} B smem, {row['threads']} threads)")
            continue
        if not 0 < row["winner_ms"] <= row["default_ms"]:
            raise AssertionError(f"bad timing row {row}")
        log(f"{head} winner {row['winner']} {row['winner_ms']:.6f} ms; default "
            f"{row['default']} {row['default_ms']:.6f} ms ({row['n_candidates']} timed"
            f"{'' if row['timing'] == autotune.PROFILER else ', by CUDA-graph replays'})")
    out = os.path.join(HERE, "build", "TUNE_kernels_torch.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    table.save(out, report=report)
    loaded = autotune.load_table(out)
    if loaded != table:
        raise AssertionError("the saved table does not load back as written")
    log(f"  {len(table)} geometries tuned in {time.perf_counter() - t0:.1f} s; wrote {out}")
    return loaded, report


def serve_tuned(torch, dev, table):
    """Phase [6]: shiftadd served with the tuned table beside the untuned
    engine; logits bit-identical, launches per forward unchanged. Returns the
    tuned engine's launch counts over the requests."""
    from repro_torch.core.policy import DENSE
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_vit import bucket_latencies
    from repro_torch.nn.vit import ShiftAddViT, ViTConfig, with_seeded_router
    from repro_torch.serve.vision import BucketedViTEngine, build_policy_model

    cfg = ViTConfig(image_size=56)
    dense_model = ShiftAddViT(dataclasses.replace(cfg, policy=DENSE))
    model, params = build_policy_model(cfg, "shiftadd", dense_model, dense_model.init(0))
    params = seeded_live_params(torch, with_seeded_router(params, 7), 8)
    untuned = BucketedViTEngine(model, params, device=dev).warmup()
    tuned = BucketedViTEngine(model, params, device=dev, tune=table).warmup()
    g = torch.Generator(device=dev).manual_seed(6)
    requests = [torch.randn((s, 56, 56, 3), generator=g, device=dev) for s in REQUEST_SIZES]
    forwards = sum(-(-s // 32) for s in REQUEST_SIZES)

    ops.reset_launch_counts()
    outs = [tuned.infer(r) for r in requests]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    got = (counts["shift_matmul"], counts["bidir_binary_attention"])
    if got != (24 * forwards, 4 * forwards):
        raise AssertionError(f"tuned shiftadd: launches {got} over {forwards} forwards")
    for r, o in zip(requests, outs):
        if not torch.equal(o, untuned.infer(r)):
            raise AssertionError(f"tuned logits differ from untuned for a request of "
                                 f"{r.shape[0]}")
    from repro_torch.kernels.autotune import DEFAULTS
    hits = sum(tuned.plan.tune.lookup("shift_matmul", g=1, m=196 * b, k=128, n=128)
               != DEFAULTS["shift_matmul"] for b in tuned.buckets)
    log(f"  tuned vs untuned logits bit-identical over {len(requests)} requests "
        f"({forwards} forwards); {hits} of {len(tuned.buckets)} buckets run a "
        f"non-default q/k/v/o tile")
    # Interleaved in one call, three rounds of untuned, tuned, tuned,
    # untuned; each entry is the median of 30 full-bucket batches.
    lat = {"untuned": [], "tuned": []}
    for name in ("untuned", "tuned", "tuned", "untuned") * 3:
        lat[name].append(bucket_latencies(untuned if name == "untuned" else tuned, iters=30))
    for b in tuned.buckets:
        u = [x[b] * 1e3 for x in lat["untuned"]]
        t = [x[b] * 1e3 for x in lat["tuned"]]
        log(f"  bucket {b:2d}: wall ms median untuned {statistics.median(u):.4f}, tuned "
            f"{statistics.median(t):.4f} (untuned {' '.join(f'{v:.4f}' for v in u)}; "
            f"tuned {' '.join(f'{v:.4f}' for v in t)})")
    return counts


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
    # The serving shapes at buckets 1 and 32, ragged ones, head dims 256 and
    # 200 (Dv split into slices) and a long N (each block walks 625 rows).
    attn_err = check_attention(torch, dev, [(4, 196, 32, 32), (128, 196, 32, 32),
                                            (8, 197, 32, 32), (2, 197, 64, 48),
                                            (8, 196, 256, 256), (2, 300, 256, 200),
                                            (2, 5000, 64, 64)])
    attn_err = max(attn_err, check_attention_invariance(torch, dev))
    # add-matmul serving sites ktv (M=32, K=196, N=32) and q_ktv (M=196,
    # K=32, N=32) at G = 4 heads × buckets 1 and 32, and two ragged shapes.
    add_err = check_add_matmuls(torch, dev, [
        (4, 32, 196, 32), (4, 196, 32, 32), (128, 32, 196, 32), (128, 196, 32, 32),
        (3, 70, 300, 200), (1, 1, 8, 640)])
    check_tiles_bit_identical(torch, dev)
    # The causal site at bucket 32 with the default chunk (196) and every
    # chunk the autotune launches there (64, 128, 256), ragged shapes, and
    # head dims 256 and 200 (Dv split into 64-wide slices, the last one
    # ragged at 200).
    causal_err = check_causal(torch, dev, [
        (128, 196, 32, 32, 196), (128, 196, 32, 32, 64), (128, 196, 32, 32, 128),
        (128, 196, 32, 32, 256), (8, 197, 64, 48, 197), (8, 197, 64, 48, 64),
        (2, 5000, 64, 64, 256), (8, 196, 256, 256, 64), (2, 300, 256, 200, 128)])

    log("[3] timing at the bucket-32 shapes")
    timings = {
        "shift_matmul": time_shift_matmul(torch, dev, 6272, 128, 128),
        "shift_matmul up": time_shift_matmul(torch, dev, 4256, 128, 256),
        "shift_matmul down": time_shift_matmul(torch, dev, 4256, 256, 128),
        "bidir_binary_attention": time_attention(torch, dev, 128, 196, 32),
        "bidir_binary_attention G=4": time_attention(torch, dev, 4, 196, 32),
        "add_matmul": time_add_matmul(torch, dev, 128, 32, 196, 32),
        "add_matmul q_ktv": time_add_matmul(torch, dev, 128, 196, 32, 32),
        "add_matmul_packed": time_add_matmul(torch, dev, 128, 32, 200, 32, packed=True),
        "add_matmul_packed q_ktv": time_add_matmul(torch, dev, 128, 196, 32, 32,
                                                   packed=True),
        "binary_linear_attention": time_causal(torch, dev, 128, 196, 32),
    }
    for name, (ms, plain, lib, b, by, _) in timings.items():
        earlier = EARLIER_MS[name]
        log(f"  {name}: kernel {ms:.5f} ms (before its redesign: "
            f"{'not measured' if earlier is None else f'{earlier:.5f}'}), "
            f"plain {plain:.5f} ms, "
            f"library {'n/a' if lib is None else f'{lib:.5f} ms'}, bound {b:.5f} ms ({by}), "
            f"{ms / b:.2f}x bound" + ("" if lib is None else f", {ms / lib:.2f}x library"))

    sites = {f"bucket {b}": time_site(torch, dev, b) for b in (1, 32)}
    for key, (dev_us, n_k, host_us) in sites.items():
        log(f"  attention serving site {key}: device {dev_us} us, {n_k} kernels, "
            f"host {host_us:.2f} us per call")

    log("[4] serving the three arms at 196 tokens")
    arms = serve_arms(torch, dev)
    serving = {k: sum(a["launches"][k] for a in arms.values())
               for k in ("shift_matmul", "bidir_binary_attention")}

    log("[5] autotune: every serving site x bucket (1, 8, 32), timed on the card")
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    table, report = run_autotune(torch, dev)
    tune_launches = ops.launch_counts()
    log("[6] serving shiftadd with the tuned table")
    tuned_launches = serve_tuned(torch, dev, table)
    path = {k: tune_launches[k] + tuned_launches[k] for k in tune_launches}
    missing = [k for k, n in path.items() if n == 0]
    if missing:
        raise AssertionError(f"the autotune/tuned-serving path launched no {missing}")
    log(f"  launches on the autotune path [5]: {tune_launches}; tuned serving [6]: "
        f"{tuned_launches}")

    kernels = []
    for name, source, replaces, err, shape in (
            ("shift_matmul", "src/repro_torch/kernels/csrc/shift_matmul.cu",
             "src/repro/kernels/shift_matmul.py:57", shift_err, "M=6272 K=128 N=128 fp32"),
            ("bidir_binary_attention",
             "src/repro_torch/kernels/csrc/bidir_linear_attention.cu",
             "src/repro/kernels/bidir_linear_attention.py:82", attn_err,
             "G=128 N=196 D=32 fp32"),
            ("add_matmul", "src/repro_torch/kernels/csrc/add_matmul.cu",
             "src/repro/kernels/add_matmul.py:45", add_err["add_matmul"],
             "G=128 M=32 K=196 N=32 fp32 x, int8 b (ktv, bucket 32)"),
            ("add_matmul_packed", "src/repro_torch/kernels/csrc/add_matmul_packed.cu",
             "src/repro/kernels/add_matmul_packed.py:62", add_err["add_matmul_packed"],
             "G=128 M=32 K=200 N=32 fp32 x, 1-bit b (ktv, bucket 32)"),
            ("binary_linear_attention", "src/repro_torch/kernels/csrc/linear_attention.cu",
             "src/repro/kernels/linear_attention.py:97", causal_err,
             "G=128 N=196 D=32 fp32 causal, chunk 196")):
        ms, plain, lib, b, by, how = timings[name]
        by_path = {"serving [4]": serving.get(name, 0), "autotune [5]": tune_launches[name],
                   "tuned serving [6]": tuned_launches[name]}
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b, "bound_by": by, "library_ms": lib,
               "timing": how, "shape": shape}
        if name == "bidir_binary_attention":       # also at bucket 1
            ms4, plain4, _, b4, _, _ = timings["bidir_binary_attention G=4"]
            row.update(ms_g4=ms4, plain_ms_g4=plain4, bound_ms_g4=b4,
                       serving_site={key: {"device_us": x, "kernels": n_k, "host_us": y}
                                     for key, (x, n_k, y) in sites.items()})
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

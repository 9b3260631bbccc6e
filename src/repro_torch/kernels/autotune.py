"""Kernel autotune: time each kernel's launch configurations at every
serving site × bucket on the card, keep the fastest, and let the serving
stack replay them. Counterpart of `repro/kernels/autotune.py`.

What is tunable per kernel (the port's own parameter names, so a table
written for the TPU, whose entries say `bm`/`bn`/`bk`/`bk8`/`chunk`, never
selects a CUDA launch: its lookups serve the defaults):

- shift_matmul, add_matmul, add_matmul_packed: `tile_m`, `tile_n`, the
  rows of one M tile and the output columns of one block
  (`tile_matmul.TILES`). Every tile takes the same K order, so every tile
  gives bit-identical output: a tuned engine's logits equal the untuned
  engine's. Tiles that launch alike at a site (a tile shrinks to the
  product and until its grid covers the SMs, `tile_matmul.launch_tile`)
  are timed once.
- linear_attention (the causal kernel): `chunk_rows`, the rows per chunk.
- bidir_linear_attention: nothing; the tuner only checks that it fits.

Each candidate must fit a Hopper block (`analysis.kernel_contracts.fits`).
On the card every candidate is timed through the real `kernels.ops` wrapper
(a one-entry table forces it down the serving path) by its device time from
a torch.profiler trace, and the median decides; should the profiler record
nothing, the site is timed by CUDA-graph replays instead, and its report row
says so. Without measurement, every site takes its kernel's default
configuration and the table says so.

Winning configurations persist as JSON (`TuneTable.save`/`load`, the
reference's schema) keyed by exact kernel × geometry; the engine threads the
table to every `kernels.ops` call, and a miss serves the defaults.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import shutil
import statistics
import subprocess
import time

from repro_torch.analysis.kernel_contracts import MATMUL_KERNELS
from repro_torch.kernels import linear_attention, tile_matmul

SCHEMA_VERSION = 1

_TILE_SPACE = {"tile_m": tuple(sorted({t[0] for t in tile_matmul.TILES})),
               "tile_n": tuple(sorted({t[1] for t in tile_matmul.TILES}))}
SEARCH_SPACE = {
    "shift_matmul": _TILE_SPACE,
    "add_matmul": _TILE_SPACE,
    "add_matmul_packed": _TILE_SPACE,
    "linear_attention": {"chunk_rows": (64, 128, 256)},
    "bidir_linear_attention": {},
}
_TILE = dict(zip(("tile_m", "tile_n"), tile_matmul.DEFAULT_TILE))
DEFAULTS = {"shift_matmul": _TILE, "add_matmul": _TILE,
            "add_matmul_packed": _TILE,
            "linear_attention": {"chunk_rows": linear_attention.CHUNK},
            "bidir_linear_attention": {}}

# Geometry keys each kernel's ops-wrapper lookup passes (the `_tuned(...)`
# call sites in kernels.ops); equal to the reference's.
GEOMETRY_KEYS = {
    "shift_matmul": ("g", "m", "k", "n"),
    "add_matmul": ("g", "m", "k", "n"),
    "add_matmul_packed": ("g", "m", "k", "n"),
    "linear_attention": ("g", "n", "dk", "dv"),
}

# The kernel function each site's launch runs, as the profiler names it.
_SYMBOL = {"shift_matmul": "tile_matmul_kernel",
           "add_matmul": "tile_matmul_kernel",
           "add_matmul_packed": "tile_matmul_kernel",
           "linear_attention": "binary_linear_attention_kernel"}


def geometry_key(kernel: str, **geom) -> str:
    """Canonical string key for one kernel × exact geometry."""
    return "|".join([kernel] + [f"{k}={geom[k]}" for k in sorted(geom)])


@dataclasses.dataclass(frozen=True)
class TuneTable:
    """Immutable, hashable tune table.

    entries: ((geometry_key, ((param, value), ...)), ...) — sorted tuples.
    meta: ((key, value), ...) — provenance (device, card, measured, ...).
    """

    entries: tuple = ()
    meta: tuple = ()

    def __post_init__(self):
        # Derived lookup index; not a dataclass field, so hash/eq stay on the
        # canonical tuples.
        object.__setattr__(
            self, "_index", {k: dict(v) for k, v in self.entries})

    def lookup(self, kernel: str, **geom):
        """The entry for this exact geometry, or None (→ defaults)."""
        return self._index.get(geometry_key(kernel, **geom))

    def __len__(self):
        return len(self.entries)

    @property
    def meta_dict(self) -> dict:
        return dict(self.meta)

    @staticmethod
    def from_dicts(entries: dict, meta: dict = None) -> "TuneTable":
        def _freeze(v):
            return tuple(v) if isinstance(v, list) else v

        ent = tuple(sorted(
            (k, tuple(sorted((p, int(c)) for p, c in v.items())))
            for k, v in entries.items()))
        mt = tuple(sorted((k, _freeze(v)) for k, v in (meta or {}).items()))
        return TuneTable(entries=ent, meta=mt)

    def to_json_dict(self) -> dict:
        def _thaw(v):
            return list(v) if isinstance(v, tuple) else v

        return {"schema": SCHEMA_VERSION,
                "meta": {k: _thaw(v) for k, v in self.meta},
                "entries": {k: dict(v) for k, v in self.entries}}

    def save(self, path: str, report=None):
        doc = self.to_json_dict()
        if report is not None:
            doc["report"] = report
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    @staticmethod
    def load(path: str) -> "TuneTable":
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("schema") != SCHEMA_VERSION:
            raise ValueError(f"{path}: schema {doc.get('schema')!r}, "
                             f"expected {SCHEMA_VERSION}")
        return TuneTable.from_dicts(doc.get("entries", {}),
                                    doc.get("meta", {}))


def _launch(spec: dict, config: dict):
    """What a configuration launches at the site: a matmul's tile after
    `tile_matmul.launch_tile`; any other kernel's configuration as given."""
    if spec["kernel"] not in MATMUL_KERNELS:
        return tuple(sorted(config.items()))
    return tile_matmul.launch_tile((config["tile_m"], config["tile_n"]),
                                   spec["g"], spec["m"], spec["n"])



def candidates(spec: dict) -> list:
    """Every launch configuration of the site's kernel that is built and
    fits a Hopper block, the default first, one per distinct launch (dicts;
    [{}] for a kernel with nothing to tune)."""
    from repro_torch.analysis import kernel_contracts as kc

    kernel = spec["kernel"]
    space = SEARCH_SPACE[kernel]
    keys = sorted(space)
    combos = [dict(zip(keys, vals))
              for vals in itertools.product(*(space[k] for k in keys))]
    combos.sort(key=lambda c: c != DEFAULTS[kernel])
    seen, out = set(), []
    for c in combos:
        if _valid(kernel, c) and kc.fits(spec, c) and _launch(spec, c) not in seen:
            seen.add(_launch(spec, c))
            out.append(c)
    return out


def _valid(kernel: str, params: dict) -> bool:
    """A matmul's (tile_m, tile_n) pair is one the header builds."""
    if kernel not in MATMUL_KERNELS or not {"tile_m", "tile_n"} <= set(params):
        return True
    return (params["tile_m"], params["tile_n"]) in tile_matmul.TILES


def _site_geometry(spec: dict) -> dict:
    geom = {k: spec[k] for k in GEOMETRY_KEYS[spec["kernel"]]}
    if spec["kernel"] == "add_matmul_packed":
        # pack_bits needs K padded to a multiple of 8 by the caller, so at
        # e.g. the 196-token site the wrapper looks up k=200, never k=196.
        geom["k"] = -(-geom["k"] // 8) * 8
    return geom


def _site_call(spec: dict, device):
    """fn(table) that runs the site's `kernels.ops` wrapper once on seeded
    inputs of the site's shapes, on `device`."""
    import torch

    from repro_torch.core.quant import pack_from_dense
    from repro_torch.kernels import ops
    from repro_torch.kernels.add_matmul_packed import pack_bits

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def signs(*shape):
        return (torch.randint(0, 2, shape, generator=gen, device=device,
                              dtype=torch.int8) * 2 - 1)

    kernel = spec["kernel"]
    geom = _site_geometry(spec)
    if kernel == "shift_matmul":
        x = randn(geom["m"], geom["k"])
        w = pack_from_dense(randn(geom["k"], geom["n"]) * geom["k"] ** -0.5)
        return lambda table: ops.shift_matmul(x, w, "cuda", table)
    if kernel in ("add_matmul", "add_matmul_packed"):
        g, m, k, n = (geom[a] for a in ("g", "m", "k", "n"))
        x, b = randn(g, m, k), signs(g, k, n)
        if kernel == "add_matmul":
            return lambda table: ops.add_matmul(x, b, "cuda", table)
        packed = pack_bits(b)
        return lambda table: ops.add_matmul_bitpacked(x, packed, "cuda", table)
    g, n, dk, dv = (geom[a] for a in ("g", "n", "dk", "dv"))
    q, k, v = randn(g, 1, n, dk), randn(g, 1, n, dk), randn(g, 1, n, dv)
    return lambda table: ops.binary_linear_attention_fused(
        q, k, v, impl="cuda", tune=table)


def trace_device(fn, iters: int, attempts: int = 4) -> list:
    """[(kernel name, device ms)] of every kernel that `iters` back-to-back
    calls of `fn` ran, from a torch.profiler (CUPTI) trace. Now and then a
    trace on the card comes back without device events; it is taken again,
    after a growing pause, up to `attempts` times. [] if every trace came
    back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        time.sleep(0.5 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device milliseconds per call of `fn`, without the profiler: `iters`
    back-to-back calls are captured in one CUDA graph, and each replay is
    timed with CUDA events, so the host's launch rate stays out; the median
    of `replays` replays. It includes the few-microsecond gaps between the
    graph's kernels, which the profiler's kernel durations leave out.

    A wrapper counts a launch when it enqueues its kernel, and under capture
    that enqueues into the graph, where nothing runs: the captured counts
    are taken back, and each replay adds the launches it runs."""
    import torch

    from repro_torch.kernels import ops

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    captured = {k: n - before[k] for k, n in ops.launch_counts().items()}

    def replay():
        graph.replay()
        for k, n in captured.items():
            ops.KERNELS[k].launches += n

    for k, n in captured.items():
        ops.KERNELS[k].launches -= n
    replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


PROFILER = "median kernel duration per launch (torch.profiler)"
GRAPH = "mean per launch over CUDA-graph replays (CUDA events; the profiler recorded nothing)"


def measure_site(spec: dict, configs: list, iters: int = 20,
                 device="cuda") -> tuple:
    """(device milliseconds of one launch under each config, how they were
    timed), through the real `kernels.ops` wrapper on the card. Each config
    runs `iters` times back to back inside its own profiler trace, and each
    launch's kernel duration is read from the trace (CUDA events around
    single short launches would time the host's launch rate instead). Should
    the profiler record nothing, the whole site is timed by CUDA-graph
    replays instead, so that its configs are compared by one method."""
    import torch

    from repro_torch import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"measuring needs the card, got device {device}")
    kernel = spec["kernel"]
    key = geometry_key(kernel, **_site_geometry(spec))
    run = _site_call(spec, device)
    calls = []
    for config in configs:
        table = TuneTable.from_dicts({key: config})
        calls.append(lambda table=table: run(table))
    medians = []
    for call in calls:
        call()                            # build, allocate and warm
        call()
        torch.cuda.synchronize(device)
        ms = [t for name, t in trace_device(call, iters) if _SYMBOL[kernel] in name]
        # A trace may drop an event at its edges; the median stands on the
        # rest, but never on fewer than half the launches.
        if not iters // 2 < len(ms) <= iters:
            return [graph_ms(c, iters) for c in calls], GRAPH
        medians.append(statistics.median(ms))
    return medians, PROFILER


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    "not available" where there is no nvidia-smi."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "not available"
    out = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() if out.returncode == 0 else "not available"


def autotune(base_cfg=None, buckets=None, measure=None, iters=20,
             device="cuda"):
    """Search every serving site × bucket; return (TuneTable, report rows).

    device: "cuda" (the default; raises without a GPU) or "cpu".
    measure: None → measure on the card, not on the CPU. Unmeasured, every
    tunable site gets its kernel's default configuration. Measured, every
    candidate that fits is timed (at most 9 per site)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.analysis import kernel_contracts as kc
    from repro_torch.nn.vit import ViTConfig
    from repro_torch.serve.vision import DEFAULT_BUCKETS

    cfg = base_cfg or ViTConfig()
    buckets = tuple(buckets or DEFAULT_BUCKETS)
    device = resolve_device(device)
    if measure is None:
        measure = device.type == "cuda"
    if measure and device.type != "cuda":
        raise ValueError("measure=True needs the card (device='cuda')")
    entries, report = {}, []
    for b in buckets:
        for spec in kc.serving_sites(cfg, b):
            kernel = spec["kernel"]
            row = {"kernel": kernel, "site": spec["site"], "bucket": b}
            if not SEARCH_SPACE[kernel]:
                smem, threads = kc.block_resources(spec, {})
                report.append(dict(
                    row, geometry={k: spec[k] for k in ("g", "n", "dk", "dv")},
                    winner=None, fits=kc.fits(spec, {}), smem_bytes=smem,
                    threads=threads,
                    note="feasibility-only (no launch parameter)"))
                continue
            geom = _site_geometry(spec)
            configs = candidates(spec)
            if not configs:
                report.append(dict(row, geometry=geom, winner=None, fits=False,
                                   note="no configuration fits a block"))
                continue
            times, timing = (measure_site(spec, configs, iters, device) if measure
                             else ([None] * len(configs), None))
            best = (min(range(len(configs)), key=lambda i: times[i])
                    if measure else 0)
            entries.setdefault(geometry_key(kernel, **geom), configs[best])
            report.append(dict(
                row, geometry=geom, winner=configs[best],
                default=DEFAULTS[kernel], winner_ms=times[best],
                default_ms=times[configs.index(DEFAULTS[kernel])],
                n_candidates=len(configs), timing=timing,
                all_ms=(None if not measure else
                        [[c, t] for c, t in zip(configs, times)])))
    on_card = device.type == "cuda"
    reason = (f"device time per launch, {iters} launches per candidate, "
              "through kernels.ops (each report row says how it was timed)"
              if measure else
              f"not measured (device={device.type}): every site takes its "
              "kernel's default configuration")
    meta = {"backend": device.type, "measured": bool(measure),
            "reason": reason,
            "device": torch.cuda.get_device_name(device) if on_card else "cpu",
            "card": nvidia_smi() if on_card else "not measured",
            "buckets": list(buckets), "image_size": cfg.image_size,
            "d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads, "d_ff": cfg.d_ff}
    return TuneTable.from_dicts(entries, meta), report


def _usable(table: TuneTable) -> bool:
    """Every value the table gives one of the port's own parameters is in
    the search space. Parameters the port does not know (a TPU table's
    `bm`, `bk8`, `chunk`, ...) are left alone: their lookups serve the
    defaults."""
    for key, params in table.entries:
        kernel = key.split("|")[0]
        space = SEARCH_SPACE.get(kernel, {})
        if any(p in space and c not in space[p] for p, c in params):
            return False
        if not _valid(kernel, dict(params)):
            return False
    return True


def load_table(path: str):
    """TuneTable from a JSON path, or None if it is missing, unreadable, of
    another schema, or gives a parameter a value the kernels were not built
    for: serving then runs the defaults rather than failing to start. Only
    reading and parsing the file is guarded; nothing here builds or launches
    a kernel."""
    with contextlib.suppress(OSError, ValueError, TypeError, AttributeError):
        table = TuneTable.load(path)
        return table if _usable(table) else None
    return None

"""Build the CUDA sources under `csrc/` at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (pointers, ints and the
stream; the function returns the launch's `cudaGetLastError()`), so it is
compiled by `nvcc` alone, without PyTorch's headers, into
`build/kernels/<name>-<hash of the sources>.so` at the root of the checkout.
The content hash in the file name means an edited source or header is never
served from a stale library. `build_all` starts one `nvcc` per source, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("shift_matmul", "bidir_linear_attention", "add_matmul",
           "add_matmul_packed", "linear_attention", "dense_matmul")

_libs = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source and of every header
    beside it (`tile_matmul.cuh`), so an edited header rebuilds too."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)                       # atomic against a racing build
    out.with_suffix(".log").write_text(log)
    return log


def build_all(names=SOURCES) -> dict:
    """Compile every named source in parallel (one nvcc each). Returns
    {name: (seconds, compiler log)}; a library already built reports 0 s."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    report = {}
    for n, s in started.items():
        log = "" if s is None else _finish(n, s)
        report[n] = (time.perf_counter() - t0 if s is not None else 0.0, log)
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib

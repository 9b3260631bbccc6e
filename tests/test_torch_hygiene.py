"""The port stands alone: nothing under src/repro_torch/, in chip_smoke.py or
in tools/ab_attention.py imports `jax` or the reference package `repro`,
checked statically (AST) and at run time in a fresh interpreter where
importing either raises. The check never touches this process's modules. Also: the kernel modules hold no
`try`, so no build or launch failure is caught and carried on past."""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                           ROOT / "tools" / "ab_attention.py"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", sorted((PORT / "kernels").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernel_modules_catch_nothing(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path.name


_BLOCKED_RUN = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    spec.loader.exec_module(importlib.util.module_from_spec(spec))

    import torch
    from repro_torch.nn.vit import ShiftAddViT, ViTConfig, with_seeded_router
    from repro_torch.serve.vision import BucketedViTEngine, build_policy_model
    cfg = ViTConfig(image_size=8, n_layers=1, d_model=16, n_heads=2, d_ff=32)
    dense = ShiftAddViT(cfg)
    model, params = build_policy_model(cfg, "shiftadd", dense, dense.init(0))
    engine = BucketedViTEngine(model, with_seeded_router(params, 1), buckets=(1, 2),
                               device="cpu").warmup()
    assert engine.infer(torch.zeros(3, 8, 8, 3)).shape == (3, 10)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("OK", len(names))
""")


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")

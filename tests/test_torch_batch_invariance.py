"""Batch-invariance tier of the port: a given image's logits are
BIT-IDENTICAL whatever (a) row of the batch it sits in, (b) images it is
co-batched with, (c) engine bucket it is padded into, and (d) whether it is
served alone or among N, for every sweep policy. The port's counterpart of
`tests/test_batch_invariance.py`, as fixed-seed parametrized cases.

Each case runs on the CPU with the plain versions (impl="torch") and,
marked `gpu`, on the card with the kernels (impl="cuda"), where every dense
linear runs the fixed-order `dense_matmul` kernel: through cuBLAS an image's
logits moved with the bucket (chip_smoke.py phase [7]). Equality is exact
within the port; parity with the reference is held elsewhere, with
tolerances. This file imports no JAX, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_batch_invariance.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policy import DENSE  # noqa: E402
from repro_torch.nn.vit import ShiftAddViT, ViTConfig, with_seeded_router  # noqa: E402
from repro_torch.serve.vision import SWEEP_POLICIES, BucketedViTEngine, build_policy_model  # noqa: E402

POLICIES = tuple(SWEEP_POLICIES)          # ("dense", "stage1", "shiftadd")
CFG = ViTConfig(image_size=16, patch_size=4, n_layers=2, d_model=32,
                n_heads=2, d_ff=64)
TARGETS = [pytest.param("torch", id="cpu-torch"),
           pytest.param("cuda", id="card-cuda", marks=pytest.mark.gpu)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def arms():
    """(policy, device, impl) → (model, engine), built once per module."""
    return {}


@pytest.fixture(params=TARGETS)
def target(request, arms):
    """(arms, device, impl): the CPU with the plain versions, or the card
    with the kernels (skipped without one)."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernels run only on the card")
        return arms, torch.device("cuda"), "cuda"
    return arms, torch.device("cpu"), "torch"


def _arm(policy, arms, device, impl):
    """(model, engine) for one sweep arm with seeded non-zero routers and
    DWConv weights (both experts carry tokens)."""
    key = (policy, str(device), impl)
    if key not in arms:
        dense_model = ShiftAddViT(dataclasses.replace(CFG, policy=DENSE))
        model, params = build_policy_model(CFG, policy, dense_model, dense_model.init(0))
        params = with_seeded_router(params, 1)
        g = torch.Generator().manual_seed(2)
        for blk in params["blocks"]:
            if "dwconv" in blk["mixer"]:
                blk["mixer"]["dwconv"] = {
                    k: torch.randn(tuple(t.shape), generator=g) * 0.3
                    for k, t in blk["mixer"]["dwconv"].items()}
        engine = BucketedViTEngine(model, params, buckets=(1, 4, 8), device=device,
                                   impl=impl).warmup()
        arms[key] = (model, engine)
    return arms[key]


def _infer(policy, target):
    """The unpadded forward on the frozen parameters: images → logits."""
    model, engine = _arm(policy, *target)

    def infer(images):
        with torch.inference_mode():
            return model.infer(engine.plan.params, images.to(engine.device),
                               impl=engine.impl).cpu()
    return infer


def _imgs(n, seed):
    x = np.random.default_rng(seed).standard_normal(
        (n, CFG.image_size, CFG.image_size, CFG.in_channels)).astype(np.float32)
    return torch.from_numpy(x)


def _equal(a, b):
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# (a) batch-row permutation
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("perm_seed", (0, 3, 7))
def test_row_permutation_invariance(policy, perm_seed, target):
    infer = _infer(policy, target)
    imgs = _imgs(6, seed=1)
    perm = torch.from_numpy(np.random.default_rng(perm_seed).permutation(6))
    _equal(infer(imgs[perm]), infer(imgs)[perm])


# (b) co-batching with arbitrary neighbours
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("neighbor_seed", (10, 11))
def test_cobatch_neighbor_invariance(policy, neighbor_seed, target):
    infer = _infer(policy, target)
    probe = _imgs(1, seed=2)
    alone = infer(probe)
    for n_neighbors in (1, 3, 7):
        neighbors = _imgs(n_neighbors, seed=neighbor_seed)
        _equal(infer(torch.cat([probe, neighbors]))[:1], alone)


# (c) padding to any engine bucket (20 > the largest bucket: chunked)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n", (1, 2, 3, 5, 8, 20))
def test_bucket_padding_invariance(policy, n, target):
    _, engine = _arm(policy, *target)
    imgs = _imgs(n, seed=3)
    _equal(engine.infer(imgs).cpu(), _infer(policy, target)(imgs))


@pytest.mark.parametrize("policy", POLICIES)
def test_explicit_zero_padding_rows_are_inert(policy, target):
    infer = _infer(policy, target)
    imgs = _imgs(3, seed=4)
    padded = torch.cat([imgs, torch.zeros((5,) + tuple(imgs.shape[1:]))])
    _equal(infer(padded)[:3], infer(imgs))


# (d) batch=1 vs batch=N
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n", (2, 5, 8))
def test_batch_one_vs_n_bit_identical(policy, n, target):
    infer = _infer(policy, target)
    imgs = _imgs(n, seed=5)
    _equal(infer(imgs), torch.cat([infer(imgs[i:i + 1]) for i in range(n)]))

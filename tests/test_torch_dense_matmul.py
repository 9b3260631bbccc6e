"""The fixed-order float32 linear `dense_matmul` (`kernels/dense_matmul.py`,
`csrc/dense_matmul.cu`) and the `Dense` layer that calls it.

On the CPU: the wrapper's argument checks, its plain version (torch.matmul
plus the bias) and the `impl` dispatch of `ops.dense_matmul` and `Dense`.
Marked `gpu`, on the card: the kernel against its plain version (scaled
error < 1e-4: float32 sums in another order than cuBLAS's), and its rows
bit-identical alone and among any M, with and without a bias, at the
serving shapes and ragged ones. This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dense_matmul.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dense import Dense  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import dense_matmul as tdense  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402

TOL = 1e-4
# (M, K, N): the shiftadd forward's dense linears at buckets 1 and 32 (patch
# embedding, router, the Mult expert at its capacity rows, the head), the
# dense arm's projections, and ragged shapes across the 64 x 64 tile and
# the 16-deep k step.
SHAPES = [(196, 48, 128), (6272, 48, 128), (196, 128, 2), (3616, 128, 256),
          (3616, 256, 128), (1, 128, 10), (32, 128, 10), (6272, 128, 128),
          (70, 300, 200), (65, 17, 65), (1, 1, 1), (130, 16, 63)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _operands(m, k, n, dev="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g)
    w = torch.randn((k, n), generator=g) * k ** -0.5
    b = torch.randn((n,), generator=g)
    return x.to(dev), w.to(dev), b.to(dev)


@pytest.mark.parametrize("bias", (False, True))
def test_cpu_wrapper_is_the_plain_version(bias):
    x, w, b = _operands(70, 33, 20)
    b = b if bias else None
    want = torch.matmul(x, w) + (0 if b is None else b)
    np.testing.assert_array_equal(tdense.dense_matmul(x, w, b).numpy(), want.numpy())
    np.testing.assert_array_equal(ref.dense_matmul_ref(x, w, b).numpy(), want.numpy())


def test_plain_calls_count_no_launch():
    before = tdense.dense_matmul.launches
    x, w, b = _operands(8, 8, 8)
    tdense.dense_matmul(x, w, b)
    ops.dense_matmul(x, w, b, impl="torch")
    assert tdense.dense_matmul.launches == before
    assert "dense_matmul" in ops.launch_counts()


@pytest.mark.parametrize("bad", ("dtype", "shape", "bias", "contiguous", "k0"))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, w, b = _operands(8, 8, 8)
    args = {"dtype": (x.double(), w, b), "shape": (x, w[:4], b),
            "bias": (x, w, b[:3]), "contiguous": (x, w.t(), b),
            "k0": (x[:, :0], w[:0], b)}[bad]
    with pytest.raises((TypeError, ValueError)):
        tdense.dense_matmul(*args)


@pytest.mark.parametrize("m,n,tile", [
    (6272, 128, (64, 64)),       # patch embedding, q/k/v/o at bucket 32
    (3616, 256, (64, 64)),       # Mult expert up at bucket 32
    (3616, 128, (32, 64)),       # Mult expert down at bucket 32: 114 blocks at 64 x 64
    (6272, 2, (32, 32)),         # router: N <= 32 skips the 64-wide tiles
    (196, 128, (32, 32)),        # bucket 1: no tile fills the SMs
    (32, 10, (32, 32)),          # head
])
def test_launch_tile(m, n, tile):
    assert tdense.launch_tile(m, n, 132) == tile
    assert tile in tdense.TILES


def test_ops_dense_matmul_keeps_leading_dims():
    x = torch.randn((2, 3, 7, 5))
    w = torch.randn((5, 4))
    b = torch.randn((4,))
    for impl in ("torch", "cuda"):           # "cuda" on a CPU tensor: the plain version
        got = ops.dense_matmul(x, w, b, impl=impl)
        assert tuple(got.shape) == (2, 3, 7, 4)
        np.testing.assert_allclose(got.numpy(), (x @ w + b).numpy(), rtol=1e-6, atol=1e-6)


def test_dense_layer_threads_impl():
    layer = Dense(6, 3)
    params = layer.init(torch.Generator().manual_seed(0))
    params["bias"] = torch.randn(3)
    x = torch.randn((4, 6))
    want = torch.matmul(x, params["kernel"]) + params["bias"]
    for impl in (None, "torch", "cuda"):
        np.testing.assert_array_equal(layer(params, x, impl=impl).numpy(), want.numpy())
    with pytest.raises(ValueError):
        layer(params, x, impl="pallas")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_matches_plain_version(cuda, m, k, n):
    x, w, b = _operands(m, k, n, cuda, seed=m + k + n)
    for bias in (None, b):
        got = tdense.dense_matmul(x, w, bias)
        err = scaled_error(got, ref.dense_matmul_ref(x, w, bias))
        assert err < TOL, (m, k, n, err)
        assert torch.equal(tdense.dense_matmul(x, w, bias), got)     # run to run


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_rows_are_bit_identical_whatever_m(cuda, m, k, n):
    x, w, b = _operands(m, k, n, cuda, seed=1)
    full = tdense.dense_matmul(x, w, b)
    for lo, hi in ((0, 1), (m - 1, m), (0, min(196, m)), (max(0, m - 113), m),
                   (m // 2, m // 2 + 1)):
        assert torch.equal(tdense.dense_matmul(x[lo:hi].contiguous(), w, b), full[lo:hi])


@pytest.mark.gpu
def test_kernel_counts_launches(cuda):
    x, w, b = _operands(64, 32, 16, cuda)
    before = tdense.dense_matmul.launches
    tdense.dense_matmul(x, w, b)
    ops.dense_matmul(x, w, None, impl="cuda")
    assert tdense.dense_matmul.launches == before + 2


@pytest.mark.parametrize("needs_grad", ("x", "w", "bias"))
def test_wrapper_refuses_a_gradient(needs_grad):
    """The kernel has no backward: the wrapper raises, on the CPU as on the
    card, rather than drop a gradient; without grad mode it runs."""
    ops_ = dict(zip(("x", "w", "bias"), _operands(6, 5, 4)))
    ops_[needs_grad].requires_grad_(True)
    with pytest.raises(RuntimeError, match='impl="torch"'):
        tdense.dense_matmul(ops_["x"], ops_["w"], ops_["bias"])
    with pytest.raises(RuntimeError, match='impl="torch"'):
        ops.dense_matmul(ops_["x"], ops_["w"], ops_["bias"], impl="cuda")
    with torch.no_grad():
        tdense.dense_matmul(ops_["x"], ops_["w"], ops_["bias"])
    y = ops.dense_matmul(ops_["x"], ops_["w"], ops_["bias"], impl="torch")
    y.sum().backward()
    assert ops_[needs_grad].grad is not None

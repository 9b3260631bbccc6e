"""Port parity for the two add-matmul kernels (`add_matmul`, the int8 ±1/0
operand, and `add_matmul_packed`, the operand packed one bit per element).

On the CPU: `pack_bits`/`unpack_bits` byte for byte against the reference's;
each kernel's plain version, the `ops` wrappers and the kernel wrapper (which
takes the plain version for a CPU tensor) against the reference's Pallas
kernels run in interpret mode, over the shapes of tests/test_kernels.py (the
197-token edge and zeros in b included). Tolerance: the reference kernel
tests' scaled error (max |a-b| / std(ref)) < 2e-2 — x is rounded to bf16 on
both sides; what differs is the float32 summation order.

The CUDA kernels themselves are held against the plain versions on the card
by test_torch_cuda_kernels.py and chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import add_matmul_packed as jpacked  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import add_matmul as tadd  # noqa: E402
from repro_torch.kernels import add_matmul_packed as tpacked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _signs(rng, shape, zeros=False):
    """±1 codes as int8, or {-1, 0, +1} with zeros=True."""
    if zeros:
        return rng.integers(-1, 2, shape).astype(np.int8)
    return (rng.integers(0, 2, shape) * 2 - 1).astype(np.int8)


@pytest.mark.parametrize("g,k,n,seed", [(2, 64, 32, 1), (3, 200, 32, 2)])
def test_pack_bits_byte_equal_to_reference(g, k, n, seed):
    rng = np.random.default_rng(seed)
    b = _signs(rng, (g, k, n))
    want = np.asarray(jpacked.pack_bits(jnp.asarray(b)))
    got = tpacked.pack_bits(torch.from_numpy(b))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpacked.unpack_bits(got).numpy(),
        np.asarray(jpacked.unpack_bits(jnp.asarray(want))))
    np.testing.assert_array_equal(tpacked.unpack_bits(got).numpy(), b.astype(np.float32))


def test_pack_bits_float_and_zero_codes_like_reference():
    """A float operand packs by `b > 0` as the reference's does: 0 and -0.0
    become -1 rows; a K that is not a multiple of 8 is refused."""
    b = np.array([[[0.0, 1.5], [-0.0, -2.0], [3.0, 0.0], [1.0, 1.0],
                   [-1.0, 0.5], [0.0, -1.0], [2.0, 2.0], [-3.0, 0.0]]],
                 np.float32)
    np.testing.assert_array_equal(
        tpacked.pack_bits(torch.from_numpy(b)).numpy(),
        np.asarray(jpacked.pack_bits(jnp.asarray(b))))
    with pytest.raises(ValueError):
        tpacked.pack_bits(torch.ones((1, 12, 3)))


# (G, M, K, N, x dtype, zeros in b): the shapes of tests/test_kernels.py,
# the 197-token edge, and the bucket-1 serving sites ktv and q_ktv.
ADD_CASES = [(2, 8, 32, 16, "float32", False), (6, 50, 100, 60, "float32", True),
             (1, 128, 512, 128, "bfloat16", False),
             (1, 197, 64, 48, "float32", True), (2, 197, 100, 60, "bfloat16", True),
             (1, 3, 5, 2, "float32", False), (4, 32, 196, 32, "float32", True),
             (4, 196, 32, 32, "bfloat16", False)]


@pytest.mark.parametrize("g,m,k,n,dtype,zeros", ADD_CASES)
def test_add_matmul_matches_pallas(g, m, k, n, dtype, zeros):
    rng = np.random.default_rng(g * 1000 + m + k + n)
    x = rng.standard_normal((g, m, k)).astype(np.float32)
    b = _signs(rng, (g, k, n), zeros)
    want = np.asarray(jops.add_matmul(jnp.asarray(x, dtype), jnp.asarray(b),
                                      "interpret"), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tb = torch.from_numpy(b)
    for got in (ref.add_matmul_ref(tx, tb), ops.add_matmul(tx, tb, "torch"),
                ops.add_matmul(tx, tb, "cuda"), tadd.add_matmul(tx, tb, (32, 128))):
        assert got.dtype == tx.dtype and tuple(got.shape) == (g, m, n)
        assert scaled_error(got, want) < 2e-2


def test_add_matmul_zero_entries_contribute_nothing():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    b = torch.zeros((1, 16, 8), dtype=torch.int8)
    want = np.asarray(jops.add_matmul(jnp.asarray(x.numpy()), jnp.asarray(b.numpy()),
                                      "interpret"))
    np.testing.assert_array_equal(want, 0.0)
    for got in (ref.add_matmul_ref(x, b), ops.add_matmul(x, b, "cuda")):
        np.testing.assert_array_equal(got.numpy(), 0.0)


PACKED_CASES = [(2, 16, 64, 32, "float32"), (1, 50, 128, 96, "bfloat16"),
                (3, 8, 256, 128, "float32"), (1, 197, 64, 48, "bfloat16"),
                (2, 33, 72, 60, "float32"), (4, 32, 200, 32, "float32")]


@pytest.mark.parametrize("g,m,k,n,dtype", PACKED_CASES)
def test_add_matmul_bitpacked_matches_pallas(g, m, k, n, dtype):
    rng = np.random.default_rng(g * 100 + m + k + n)
    x = rng.standard_normal((g, m, k)).astype(np.float32)
    b = _signs(rng, (g, k, n))
    packed = np.array(jpacked.pack_bits(jnp.asarray(b)))
    want = np.asarray(jops.add_matmul_bitpacked(
        jnp.asarray(x, dtype), jnp.asarray(packed), "interpret"), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tp = torch.from_numpy(packed)
    for got in (ops.add_matmul_bitpacked(tx, tp, "torch"),
                ops.add_matmul_bitpacked(tx, tp, "cuda"),
                tpacked.add_matmul_packed(tx, tp, (64, 32))):
        assert got.dtype == tx.dtype and tuple(got.shape) == (g, m, n)
        assert scaled_error(got, want) < 2e-2


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 4, 16)
    b = torch.zeros(2, 16, 3, dtype=torch.int8)
    packed = torch.zeros(2, 2, 3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tadd.add_matmul(x, torch.zeros(2, 15, 3, dtype=torch.int8))
    with pytest.raises(ValueError):
        tadd.add_matmul(x, torch.zeros(3, 16, 3, dtype=torch.int8))
    with pytest.raises(TypeError):
        tadd.add_matmul(x, b.float())
    with pytest.raises(TypeError):
        tadd.add_matmul(x.double(), b)
    with pytest.raises(ValueError):
        tadd.add_matmul(x, b, tile=(48, 64))
    with pytest.raises(ValueError):
        tpacked.add_matmul_packed(torch.zeros(2, 4, 17), packed)
    with pytest.raises(TypeError):
        tpacked.add_matmul_packed(x, packed.to(torch.int8))
    with pytest.raises(ValueError):
        tpacked.add_matmul_packed(x.transpose(1, 2).contiguous().transpose(1, 2), packed)
    with pytest.raises(ValueError):
        ops.add_matmul(x, b, impl="interpret")


def test_plain_versions_count_no_launches():
    before = ops.launch_counts()
    x = torch.ones(1, 2, 8)
    ops.add_matmul(x, torch.ones(1, 8, 3, dtype=torch.int8), "cuda")
    ops.add_matmul_bitpacked(x, torch.ones(1, 1, 3, dtype=torch.uint8), "cuda")
    assert ops.launch_counts() == before

"""Port parity for the two kernels of the serving path.

On the CPU: each kernel's plain version, and the kernel wrapper (which takes
the plain version for a CPU tensor), against the reference's Pallas kernel run
in interpret mode, over the reference's shape sweeps. Tolerances are the
reference kernel tests' scaled error (max |a-b| / std(ref)): < 2e-2 for
`shift_matmul` (x is rounded to bf16 on both sides; what differs is the fp32
summation order) and < 1e-3 for the attention (fp32 throughout; the ±1 sums
and the division round differently).

The CUDA kernels themselves are held against the plain versions on the card
by test_torch_cuda_kernels.py and chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import bidir_linear_attention as tbidir  # noqa: E402
from repro_torch.kernels import shift_matmul as tshift  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SHIFT_SHAPES = [(8, 32, 16), (70, 300, 200), (128, 512, 128), (1, 64, 640),
                (197, 100, 60), (5, 7, 3)]


def _shift_inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, np.array(jq.pack_from_dense(jnp.asarray(w)))


@pytest.mark.parametrize("m,k,n", SHIFT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shift_matmul_matches_pallas(m, k, n, dtype):
    x, wp = _shift_inputs(m * 7 + n, m, k, n)
    want = jops.shift_matmul(jnp.asarray(x, dtype), jnp.asarray(wp), "interpret")
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    twp = torch.from_numpy(wp)
    for got in (ref.shift_matmul_ref(tx, twp), ops.shift_matmul(tx, twp, "torch"),
                ops.shift_matmul(tx, twp, "cuda")):
        assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
        assert scaled_error(got, np.asarray(want, np.float32)) < 2e-2


def test_shift_matmul_leading_dims_and_rows_independent_of_m():
    """ops flattens leading dims; on the CPU the plain version's row i is the
    same whatever M is (the kernel's M-invariance is checked on the card)."""
    x, wp = _shift_inputs(5, 64, 128, 96)
    tx, twp = torch.from_numpy(x), torch.from_numpy(wp)
    y = ops.shift_matmul(tx.reshape(4, 16, 128), twp, "torch")
    assert tuple(y.shape) == (4, 16, 96)
    np.testing.assert_array_equal(y.reshape(64, 96).numpy(),
                                  ops.shift_matmul(tx, twp, "torch").numpy())


BIDIR_SHAPES = [
    (1, 2, 64, 32, 32),      # aligned ViT bucket shape
    (2, 2, 197, 64, 48),     # DeiT token count: odd N, odd Dv
    (1, 3, 196, 80, 80),
    (2, 1, 8, 16, 16),
    (2, 4, 196, 32, 32),     # the serving geometry, per head
    (1, 1, 33, 7, 5),        # odd head dims
]


@pytest.mark.parametrize("b,h,n,dk,dv", BIDIR_SHAPES)
def test_bidir_attention_matches_pallas(b, h, n, dk, dv):
    rng = np.random.default_rng(n * 31 + dk)
    q = rng.standard_normal((b, h, n, dk)).astype(np.float32)
    k = rng.standard_normal((b, h, n, dk)).astype(np.float32)
    v = rng.standard_normal((b, h, n, dv)).astype(np.float32)
    want = np.asarray(jops.binary_linear_attention_bidir(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="interpret"))
    tq_, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    # The same values as the serving path passes them: the permuted
    # (B, H, N, D) views of (B, N, H·D) projections.
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
             .reshape(b, n, -1).reshape(b, n, h, a.shape[-1]).permute(0, 2, 1, 3)
             for a in (q, k, v)]
    assert not views[0].is_contiguous() or h == 1
    for impl in ("torch", "cuda"):
        for args in ((tq_, tk, tv), views):
            got = ops.binary_linear_attention_bidir(*args, impl=impl)
            assert tuple(got.shape) == (b, h, n, dv)
            assert scaled_error(got, want) < 1e-3


def test_bidir_codes_zero_and_nan_like_reference():
    """q, k exactly 0 code to +1, NaN to -1 (`where(x >= 0, 1, -1)`)."""
    q = torch.tensor([[[0.0, -1.0], [float("nan"), 2.0]]])
    k = torch.tensor([[[float("nan"), 0.0], [-0.0, -3.0]]])
    v = torch.tensor([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]])
    want = np.asarray(jops.binary_linear_attention_bidir(
        jnp.asarray(q.numpy())[None], jnp.asarray(k.numpy())[None],
        jnp.asarray(v.numpy())[None], impl="interpret"))[0]
    got = ref.bidir_binary_attention_ref(q, k, v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    wp = torch.zeros(8, 3, dtype=torch.int8)
    with pytest.raises(ValueError):
        tshift.shift_matmul(x, torch.zeros(9, 3, dtype=torch.int8))
    with pytest.raises(TypeError):
        tshift.shift_matmul(x.double(), wp)
    with pytest.raises(TypeError):
        tshift.shift_matmul(x, wp.float())
    with pytest.raises(ValueError):
        tshift.shift_matmul(torch.zeros(8, 4).t(), wp)
    q = torch.zeros(2, 5, 8)
    big = torch.zeros(2, 5, tbidir.max_dk() + 1)      # no Dv slice fits past it
    with pytest.raises(ValueError, match=f"Dk up to {tbidir.max_dk()}"):
        tbidir.bidir_binary_attention(big, big, q)
    with pytest.raises(TypeError):
        tbidir.bidir_binary_attention(q, q.double(), q)
    with pytest.raises(ValueError):
        tbidir.bidir_binary_attention(q, q, torch.zeros(2, 4, 8))
    with pytest.raises(ValueError):
        ops.shift_matmul(x, wp, impl="xla")


def test_plain_versions_count_no_launches():
    before = ops.launch_counts()
    x, wp = _shift_inputs(1, 4, 8, 3)
    ops.shift_matmul(torch.from_numpy(x), torch.from_numpy(wp), "cuda")
    q = torch.zeros(1, 1, 5, 4)
    ops.binary_linear_attention_bidir(q, q, q, impl="cuda")
    assert ops.launch_counts() == before

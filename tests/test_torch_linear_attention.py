"""Port parity for the causal chunked Hamming-code attention
(`binary_linear_attention`, the kernel behind `ops.binary_linear_attention_fused`).

On the CPU: the plain version (the quadratic oracle), the `ops` wrapper and
the kernel wrapper (which takes the plain version for a CPU tensor) against
the reference's Pallas kernel run in interpret mode, at N ∈ {1, 7, 64, 197},
chunk ∈ {64, None} and Dk ≠ Dv; with return_state, the final carry against
the reference's. Tolerance: the reference kernel tests' scaled error
(max |a-b| / std(ref)) < 1e-3 — float32 throughout; the chunked and the
quadratic forms sum in other orders. ksum is a sum of ±1 and must be exact.

The CUDA kernel itself is held against the plain version on the card by
test_torch_cuda_kernels.py and chip_smoke.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import bidir_linear_attention as tbidir  # noqa: E402
from repro_torch.kernels import linear_attention as tcausal  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, b, h, n, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, n, dk)).astype(np.float32),
            rng.standard_normal((b, h, n, dk)).astype(np.float32),
            rng.standard_normal((b, h, n, dv)).astype(np.float32))


# (B, H, N, Dk, Dv): G = B·H ≤ 4, head dims 32/64/48, Dk ≠ Dv.
SHAPES = [(1, 2, 1, 32, 48), (2, 2, 7, 64, 48), (1, 4, 64, 32, 48),
          (2, 1, 197, 48, 32)]


@pytest.mark.parametrize("chunk", [64, None])
@pytest.mark.parametrize("b,h,n,dk,dv", SHAPES)
def test_causal_attention_matches_pallas(b, h, n, dk, dv, chunk):
    q, k, v = _qkv(n * 7 + dk, b, h, n, dk, dv)
    want = np.asarray(jops.binary_linear_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk,
        impl="interpret"))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    g = b * h
    for got in (ref.binary_linear_attention_ref(tq, tk, tv),
                ops.binary_linear_attention_fused(tq, tk, tv, chunk=chunk, impl="torch"),
                ops.binary_linear_attention_fused(tq, tk, tv, chunk=chunk, impl="cuda"),
                tcausal.binary_linear_attention(
                    tq.reshape(g, n, dk), tk.reshape(g, n, dk), tv.reshape(g, n, dv),
                    chunk or tcausal.CHUNK).reshape(b, h, n, dv)):
        assert tuple(got.shape) == (b, h, n, dv) and got.dtype == torch.float32
        assert scaled_error(got, want) < 1e-3


@pytest.mark.parametrize("b,h,n,dk,dv", [(1, 2, 197, 32, 48), (2, 2, 64, 64, 32)])
def test_return_state_matches_reference_carry(b, h, n, dk, dv):
    q, k, v = _qkv(n + dv, b, h, n, dk, dv)
    want_out, want = jops.binary_linear_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=64,
        impl="interpret", return_state=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for impl in ("torch", "cuda"):
        out, state = ops.binary_linear_attention_fused(
            tq, tk, tv, chunk=64, impl=impl, return_state=True)
        assert scaled_error(out, np.asarray(want_out)) < 1e-3
        assert tuple(state["kv"].shape) == (b, h, dk, dv)
        assert scaled_error(state["kv"], np.asarray(want["kv"])) < 1e-3
        assert scaled_error(state["vsum"], np.asarray(want["vsum"])) < 1e-3
        np.testing.assert_array_equal(state["ksum"].numpy(), np.asarray(want["ksum"]))
        assert float(state["count"]) == float(want["count"]) == float(n)


def test_codes_zero_and_nan_like_reference():
    """q, k exactly 0 code to +1, NaN to -1 (`where(x >= 0, 1, -1)`)."""
    q = np.array([[[[0.0, -1.0], [np.nan, 2.0], [1.0, -0.0]]]], np.float32)
    k = np.array([[[[np.nan, 0.0], [-0.0, -3.0], [0.5, 0.5]]]], np.float32)
    v = np.array([[[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0]]]], np.float32)
    want = np.asarray(jops.binary_linear_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="interpret"))
    got = ref.binary_linear_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 5, 8)
    limit = tbidir.max_dk(tcausal.smem_bytes)            # 774: no Dv slice fits past it
    big = torch.zeros(2, 5, limit + 1)
    with pytest.raises(ValueError, match=f"Dk up to {limit}"):
        tcausal.binary_linear_attention(big, big, q)
    with pytest.raises(TypeError):
        tcausal.binary_linear_attention(q, q.double(), q)
    with pytest.raises(ValueError):
        tcausal.binary_linear_attention(q, q, q, chunk=0)
    before = ops.launch_counts()
    tcausal.binary_linear_attention(q, q, q, return_state=True)
    assert ops.launch_counts() == before, "the plain version counts no launch"


@pytest.mark.parametrize("b,h,n", [(1, 2, 33), (2, 1, 70)])
def test_head_dim_256_matches_reference(b, h, n):
    """Dk = Dv = 256, over the 128 a single block's KV used to take: both
    kernel wrappers accept it (Dv split into 64-wide slices on the card) and,
    on CPU tensors, pass it to their plain versions. Bidirectional and causal
    with the final carry, against the reference in interpret mode; ksum
    exact."""
    dk = dv = 256
    assert tbidir.dv_slice(dk, dv) == 64
    assert tbidir.dv_slice(dk, dv, tcausal.smem_bytes) == 64
    q, k, v = _qkv(n + 256, b, h, n, dk, dv)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = np.asarray(jops.binary_linear_attention_bidir(jq, jk, jv, impl="interpret"))
    got = ops.binary_linear_attention_bidir(tq, tk, tv, impl="cuda")
    assert tuple(got.shape) == (b, h, n, dv)
    assert scaled_error(got, want) < 1e-3
    want_out, want_st = jops.binary_linear_attention_fused(
        jq, jk, jv, chunk=32, impl="interpret", return_state=True)
    out, state = ops.binary_linear_attention_fused(tq, tk, tv, impl="cuda",
                                                   return_state=True)
    assert scaled_error(out, np.asarray(want_out)) < 1e-3
    assert tuple(state["kv"].shape) == (b, h, dk, dv)
    assert scaled_error(state["kv"], np.asarray(want_st["kv"])) < 1e-3
    assert scaled_error(state["vsum"], np.asarray(want_st["vsum"])) < 1e-3
    np.testing.assert_array_equal(state["ksum"].numpy(), np.asarray(want_st["ksum"]))

"""Port parity: `repro_torch.core.quant` against `repro.core.quant`.

Packing is integer arithmetic on the result of a float rounding, so the gate
is exact equality: the same packed bytes, the same (sign, P), and the same
decoded weights bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(seed, shape):
    """Gaussian weights at several scales plus the edge cases: zeros, ±0,
    values past both ends of the P range, and exact powers of two."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w *= np.float32(10.0) ** rng.integers(-6, 3, size=shape).astype(np.float32)
    flat = w.reshape(-1)
    edge = np.array([0.0, -0.0, 1e-30, -1e-30, 3e30, -3e30, 1.0, -0.5, 2.0 ** -64,
                     2.0 ** 63, 1.5, 0.75, -3.0], np.float32)
    flat[:edge.size] = edge
    return flat.reshape(shape)


@pytest.mark.parametrize("seed,shape", [(0, (64, 48)), (1, (300, 200)),
                                        (2, (128, 512)), (3, (7, 5))])
def test_pack_and_decode_exact(seed, shape):
    w = _weights(seed, shape)
    js, jp = jq.po2_quantize(jnp.asarray(w))
    ts, tp = tq.po2_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    jpk = np.array(jq.pack_from_dense(jnp.asarray(w)))
    tpk = tq.pack_from_dense(torch.from_numpy(w))
    assert tpk.dtype == torch.int8
    np.testing.assert_array_equal(tpk.numpy(), jpk)

    # unpack / decode from the SAME bytes, bit for bit
    js2, jp2 = jq.unpack_po2(jnp.asarray(jpk))
    ts2, tp2 = tq.unpack_po2(torch.from_numpy(jpk))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
    jw = np.asarray(jq.po2_weight_from_packed(jnp.asarray(jpk), jnp.float32))
    tw = tq.po2_weight_from_packed(torch.from_numpy(jpk), torch.float32)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw.view(np.uint32))
    jbf = np.asarray(jq.po2_weight_from_packed(jnp.asarray(jpk))).view(np.uint16)
    tbf = tq.po2_weight_from_packed(torch.from_numpy(jpk)).view(torch.int16)
    np.testing.assert_array_equal(tbf.numpy().view(np.uint16), jbf)

    # the latent-branch value s·2^P
    jv = np.asarray(jq.po2_value(js, jp, jnp.float32))
    tv = tq.po2_value(ts, tp)
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), jv.view(np.uint32))


def test_every_byte_decodes_like_the_reference():
    """All 256 packed bytes: the bf16 exponent-bit decode matches exactly."""
    allb = np.arange(256, dtype=np.uint8).view(np.int8)
    jw = np.asarray(jq.po2_weight_from_packed(jnp.asarray(allb), jnp.float32))
    tw = tq.po2_weight_from_packed(torch.from_numpy(allb), torch.float32)
    np.testing.assert_array_equal(tw.numpy(), jw)


def test_sign_of_zero_and_half_to_even():
    w = torch.tensor([0.0, -0.0, 2.0 ** 0.5 * 1.0000001, 2.0 ** -70, 2.0 ** 70])
    sign, p = tq.po2_quantize(w)
    assert sign[0] == 1 and sign[1] == 1        # sign(0) = +1, also for -0.0
    assert p[2] == 1                            # just past the midpoint rounds up
    assert p[3] == tq.P_MIN and p[4] == tq.P_MAX

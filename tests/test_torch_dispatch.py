"""Port parity for the MoE serving path: capacities, routing and the
gather-ordered dispatch are integer bookkeeping and must equal the
reference's exactly; the MoE output is float and matches within tolerance."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.policy import SHIFTADD as J_SHIFTADD  # noqa: E402
from repro.nn import dispatch as jdisp  # noqa: E402
from repro.nn import vit as jvit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import SHIFTADD as T_SHIFTADD  # noqa: E402
from repro_torch.nn import dispatch as tdisp  # noqa: E402
from repro_torch.nn import vit as tvit  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402

SMOKE = dict(image_size=16, patch_size=4, n_layers=2, d_model=32, n_heads=2,
             d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("g,s,d,caps", [(3, 16, 8, (7, 11)), (2, 196, 16, (113, 133)),
                                        (4, 10, 4, (3, 3)), (1, 5, 6, (5, 0, 2))])
def test_dispatch_infer_exact(seed, g, s, d, caps):
    """Same tokens, experts and gates → the same buffer rows, ranks and keep
    flags, bit for bit, including rows past an expert's live count (clipped
    duplicates) and dropped tokens (capacities below demand)."""
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((g, s, d)).astype(np.float32)
    n_exp = len(caps)
    # skewed expert choice so some experts overflow their capacity
    idx = rng.choice(n_exp, size=(g, s), p=np.linspace(2, 1, n_exp) / np.linspace(2, 1, n_exp).sum())
    gate = rng.uniform(0.2, 1.0, (g, s)).astype(np.float32)
    jbuf, jinfo = jdisp.dispatch_infer(jnp.asarray(xg), jnp.asarray(idx, jnp.int32),
                                       jnp.asarray(gate), list(caps))
    tbuf, tinfo = tdisp.dispatch_infer(torch.from_numpy(xg), torch.from_numpy(idx),
                                       torch.from_numpy(gate), list(caps))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    for key in ("pos", "keep", "expert"):
        np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
    assert tinfo["caps"] == tuple(jinfo["caps"])
    if min(caps) > 0:
        segs_j, segs_t, off = [], [], 0
        for c in caps:
            segs_j.append(jbuf[:, off:off + c] * 2.0)
            segs_t.append(tbuf[:, off:off + c] * 2.0)
            off += c
        np.testing.assert_array_equal(
            tdisp.combine_infer(segs_t, tinfo).numpy(),
            np.asarray(jdisp.combine_infer(segs_j, jinfo)))


def test_group_rows_shapes():
    x = torch.zeros(2, 3, 5, 4)
    xg, ungroup = tdisp.group_rows(x, 4)
    assert tuple(xg.shape) == (6, 5, 4)
    assert tuple(ungroup(xg).shape) == (2, 3, 5, 4)
    xg, _ = tdisp.group_rows(torch.zeros(5, 4), 4)
    assert tuple(xg.shape) == (1, 5, 4)


def _moe_pair(seed):
    """Block 0's MoE feed of the SMOKE shiftadd model in both packages, with
    the same weights (packed shift experts) and a seeded non-zero router."""
    cfg = jvit.ViTConfig(**SMOKE, policy=J_SHIFTADD)
    jmodel = jvit.ShiftAddViT(cfg)
    feed = jax.tree_util.tree_map(
        np.asarray, jmodel.blocks[0].feed.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    feed["router"]["kernel"] = (rng.standard_normal(feed["router"]["kernel"].shape)
                                * SMOKE["d_model"] ** -0.5).astype(np.float32)
    plan = jmodel.prepare_inference({"blocks": [{"feed": feed}]}, impl="interpret")
    jfeed_params = plan.params["blocks"][0]["feed"]
    tmodel = tvit.ShiftAddViT(tvit.ViTConfig(**SMOKE, policy=T_SHIFTADD))
    return (jmodel.blocks[0].feed, jfeed_params, tmodel.blocks[0].feed,
            bridge.to_torch(jfeed_params))


@pytest.mark.parametrize("n_tokens", [1, 16, 196, 197, 1000])
def test_capacities_exact(n_tokens):
    jfeed = jvit.ShiftAddViT(jvit.ViTConfig(**SMOKE, policy=J_SHIFTADD)).blocks[0].feed
    tfeed = tvit.ShiftAddViT(tvit.ViTConfig(**SMOKE, policy=T_SHIFTADD)).blocks[0].feed
    assert tfeed.capacities(n_tokens) == jfeed.capacities(n_tokens)
    assert tfeed.capacity_plan(n_tokens) == jfeed.capacity_plan(n_tokens)


def test_serving_geometry_caps():
    """At the 196-token serving geometry the split is (113, 133)."""
    feed = tvit.ShiftAddViT(tvit.ViTConfig(image_size=56, policy=T_SHIFTADD)).blocks[0].feed
    assert feed.capacity_plan(196) == ((113, 133), (0, 113))


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_infer_matches_reference(seed):
    """Routing (top1, pos, keep, caps) exactly; output within 1e-3 scaled
    error. Both sides round the Shift expert's inputs to bf16 and sum in
    float32 in different orders (measured ~1e-6); the bound leaves room for a
    last-bit GELU difference moving one bf16 rounding."""
    jfeed, jp, tfeed, tp = _moe_pair(seed)
    x = np.random.default_rng(seed + 7).standard_normal((3, 16, SMOKE["d_model"])).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    jxg, _ = jdisp.group_rows(jx, SMOKE["d_model"])
    jtop1, jgate = jfeed._route_infer(jp, jxg)
    txg, _ = tdisp.group_rows(tx, SMOKE["d_model"])
    ttop1, tgate = tfeed._route_infer(tp, txg)
    np.testing.assert_array_equal(ttop1.numpy(), np.asarray(jtop1))
    assert set(np.unique(ttop1.numpy())) == {0, 1}, "both experts carry tokens"
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate), rtol=1e-6, atol=1e-7)

    caps = list(jfeed.capacity_plan(16)[0])
    assert list(tfeed.capacity_plan(16)[0]) == caps
    _, jinfo = jdisp.dispatch_infer(jxg, jtop1, jgate, caps)
    _, tinfo = tdisp.dispatch_infer(txg, ttop1, tgate, caps)
    for key in ("pos", "keep"):
        np.testing.assert_array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))

    want = np.asarray(jax.jit(lambda p, v: jfeed.infer(p, v, impl="interpret"))(jp, jx))
    for impl in ("torch", "cuda"):
        got = tfeed.infer(tp, tx, impl=impl)
        assert scaled_error(got, want) < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_builtin_experts_match_reference(seed):
    """MoEPrimitives with its own `_MLPExpert`s (latent shift weights, the
    float32 `w_latent` branch on both sides): routing exactly, output within
    1e-4 scaled error (float32 throughout; the reference's straight-through
    forward value `w + (q - w)` can differ from q in the last bit)."""
    from repro.core.moe_primitives import MoEPrimitives as JMoE
    from repro_torch.core.moe_primitives import MoEPrimitives as TMoE

    d, h = 16, 32
    jmoe, tmoe = JMoE(d, h), TMoE(d, h)
    params = jax.tree_util.tree_map(np.asarray, jmoe.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    params["router"]["kernel"] = (rng.standard_normal((d, 2)) * d ** -0.5).astype(np.float32)
    assert "w_latent" in params["experts"][1]["up"]
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    assert tmoe.capacity_plan(24) == jmoe.capacity_plan(24)
    want = np.asarray(jax.jit(lambda p, v: jmoe.infer(p, v, impl="xla"))(
        params, jnp.asarray(x)))
    got = tmoe.infer(bridge.to_torch(params), torch.from_numpy(x))
    assert scaled_error(got, want) < 1e-4

"""Port parity for the serving model: `Attention.infer`,
`TransformerBlock.infer` and per-image `ShiftAddViT.infer` logits for the
dense, stage1 and shiftadd arms, with the reference's weights bridged into
the port, at the reduced SMOKE geometry (image 16, 2 layers, d_model 32,
2 heads, d_ff 64). The routers and the DWConv on V are set to seeded
non-zero values in both trees, so both experts carry tokens and the DWConv
path is live. The reference runs its deployment-frozen parameters (packed
int8 shift weights) with its Pallas kernels in interpret mode; the port runs
the same bytes through its plain versions and through its kernel wrappers
(which take the plain version for CPU tensors).

Tolerances (scaled error, max |a-b| / std(ref)):
- dense arm: 1e-4 — float32 throughout; only summation order differs.
- stage1 / shiftadd: 1e-3 — the shift projections and the Shift expert round
  their inputs to bf16 on both sides; float32 sums in different orders, and a
  last-bit difference ahead of a bf16 rounding can move that rounding."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.policy import DENSE as J_DENSE  # noqa: E402
from repro.nn import vit as jvit  # noqa: E402
from repro.serve import vision as jvision  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn import vit as tvit  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402
from repro_torch.serve import vision as tvision  # noqa: E402

SMOKE = dict(image_size=16, patch_size=4, n_layers=2, d_model=32, n_heads=2,
             d_ff=64)
ARMS = ("dense", "stage1", "shiftadd")
TOL = {"dense": 1e-4, "stage1": 1e-3, "shiftadd": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _seed_live_params(params, seed):
    """Non-zero routers and DWConv weights (numpy), in place of the zeros
    `convert_from` leaves."""
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for blk in params["blocks"]:
        mixer, feed = blk["mixer"], blk["feed"]
        if "dwconv" in mixer:
            for key, arr in mixer["dwconv"].items():
                mixer["dwconv"][key] = (rng.standard_normal(arr.shape) * 0.3).astype(np.float32)
        if "router" in feed:
            k = feed["router"]["kernel"]
            feed["router"]["kernel"] = (rng.standard_normal(k.shape)
                                        * k.shape[0] ** -0.5).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def arms():
    """arm → (reference model, its frozen params, port model, bridged params)."""
    cfg = jvit.ViTConfig(**SMOKE)
    dense_model = jvit.ShiftAddViT(dataclasses.replace(cfg, policy=J_DENSE))
    dense_params = dense_model.init(jax.random.PRNGKey(0))
    out = {}
    for name in ARMS:
        jmodel, params = jvision.build_policy_model(cfg, name, dense_model,
                                                    dense_params)
        params = _seed_live_params(params, seed=11)
        plan = jmodel.prepare_inference(params, impl="interpret",
                                        token_counts=(cfg.n_patches,))
        tcfg = tvit.ViTConfig(**SMOKE, policy=tvision.SWEEP_POLICIES[name][0])
        out[name] = (jmodel, plan.params, tvit.ShiftAddViT(tcfg),
                     bridge.to_torch(plan.params))
    return out


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arm", ARMS)
def test_attention_infer_matches_reference(arms, arm):
    jmodel, jp, tmodel, tp = arms[arm]
    x = _x(1, (3, 16, SMOKE["d_model"]))
    want = np.asarray(jmodel.blocks[0].mixer.infer(
        jp["blocks"][0]["mixer"], jnp.asarray(x), impl="interpret"))
    got = tmodel.blocks[0].mixer.infer(tp["blocks"][0]["mixer"],
                                       torch.from_numpy(x), impl="torch")
    assert scaled_error(got, want) < TOL[arm]


@pytest.mark.parametrize("arm", ARMS)
def test_block_infer_matches_reference(arms, arm):
    jmodel, jp, tmodel, tp = arms[arm]
    x = _x(2, (3, 16, SMOKE["d_model"]))
    want = np.asarray(jmodel.blocks[1].infer(jp["blocks"][1], jnp.asarray(x),
                                             impl="interpret"))
    got = tmodel.blocks[1].infer(tp["blocks"][1], torch.from_numpy(x),
                                 impl="torch")
    assert scaled_error(got, want) < TOL[arm]


@pytest.mark.parametrize("arm", ARMS)
def test_vit_logits_match_reference(arms, arm):
    """Per-image logits; the kernel-wrapper path (impl="cuda" on CPU tensors)
    takes the plain versions and launches nothing."""
    jmodel, jp, tmodel, tp = arms[arm]
    images = _x(3, (3, 16, 16, 3))
    want = np.asarray(jmodel.infer(jp, jnp.asarray(images), impl="interpret"))
    before = ops.launch_counts()
    for impl in ("torch", "cuda"):
        got = tmodel.infer(tp, torch.from_numpy(images), impl=impl)
        assert tuple(got.shape) == (3, 10)
        for i in range(3):
            assert scaled_error(got[i], want[i]) < TOL[arm], (impl, i)
    assert ops.launch_counts() == before


def test_shift_leaves_are_packed_like_reference(arms):
    """The port's own deployment freeze packs the latent shift weights to the
    reference's bytes."""
    jmodel, jp, tmodel, _ = arms["shiftadd"]
    cfg = jvit.ViTConfig(**SMOKE)
    dense_model = jvit.ShiftAddViT(dataclasses.replace(cfg, policy=J_DENSE))
    _, live = jvision.build_policy_model(cfg, "shiftadd", dense_model,
                                         dense_model.init(jax.random.PRNGKey(0)))
    plan = tmodel.prepare_inference(bridge.to_torch(
        jax.tree_util.tree_map(np.asarray, live)), token_counts=(16,))
    assert plan.frozen_linears == 2 * (4 + 2) and plan.moe_layers == 2
    for tb, jb in zip(plan.params["blocks"], jp["blocks"]):
        for name in ("q", "k", "v", "o"):
            np.testing.assert_array_equal(tb["mixer"][name]["w_packed"].numpy(),
                                          np.asarray(jb["mixer"][name]["w_packed"]))


def test_port_convert_from_matches_reference_structure(arms):
    """The port's convert_from builds the same tree as the reference's."""
    cfg = jvit.ViTConfig(**SMOKE)
    dense_model = jvit.ShiftAddViT(dataclasses.replace(cfg, policy=J_DENSE))
    dense_params = dense_model.init(jax.random.PRNGKey(0))
    tdense = tvit.ShiftAddViT(tvit.ViTConfig(**SMOKE))
    tdense_params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, dense_params))
    for name in ARMS:
        _, jparams = jvision.build_policy_model(cfg, name, dense_model, dense_params)
        _, tparams = tvision.build_policy_model(tvit.ViTConfig(**SMOKE), name,
                                                tdense, tdense_params)
        jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
        tflat = jax.tree_util.tree_flatten_with_path(bridge.to_numpy(tparams))[0]
        assert [p for p, _ in tflat] == [p for p, _ in jflat]
        for (_, a), (_, b) in zip(tflat, jflat):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_engine_chunks_and_pads_like_direct_infer(arms):
    """Requests larger than the biggest bucket are split, chunks are padded
    to a bucket and the padding sliced off; the logits equal a direct
    `infer` of each chunk's images."""
    _, _, tmodel, tp = arms["shiftadd"]
    engine = tvision.BucketedViTEngine(tmodel, tp, buckets=(1, 4),
                                       device="cpu").warmup()
    assert engine.impl == "torch"
    images = _x(4, (10, 16, 16, 3))
    got = engine.infer(images)
    assert tuple(got.shape) == (10, 10)
    assert engine.batches_served == 3            # 4 + 4 + 2 (padded to 4)
    assert engine.images_served == 10
    assert engine.padded_images_served == 12
    with torch.inference_mode():
        for lo, hi in ((0, 4), (4, 8)):
            np.testing.assert_array_equal(
                got[lo:hi].numpy(),
                tmodel.infer(engine.plan.params, torch.from_numpy(images[lo:hi])).numpy())
        tail = np.concatenate([images[8:], np.zeros((2, 16, 16, 3), np.float32)])
        np.testing.assert_array_equal(
            got[8:].numpy(),
            tmodel.infer(engine.plan.params, torch.from_numpy(tail))[:2].numpy())
    one = engine.infer(images[:1])
    assert scaled_error(one[0], got[0]) < 1e-5
    assert tuple(engine.infer(images[:0]).shape) == (0, 10)


def test_entry_points_default_to_the_card(arms):
    """Without a GPU, the default device raises instead of quietly running
    on the CPU; device="cpu" is the explicit request."""
    _, _, tmodel, tp = arms["dense"]
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvision.BucketedViTEngine(tmodel, tp)

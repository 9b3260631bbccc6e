"""Port parity for the deployment freeze: a reference tree frozen for
`impl="xla"` (every shift leaf decoded to `w_deploy`, the float32 s·2^P)
loads into the port, at the reduced SMOKE geometry (image 16, 2 layers,
d_model 32, 2 heads, d_ff 64).

The port's freeze repacks each `w_deploy` to the int8 kernel format. Every
value is ±2^P with P in [-64, 63], so the repack is exact: the packed bytes
must equal the reference's own packing of the latent (its
`impl="interpret"` freeze), and the port's logits from the two loads must be
equal bit for bit."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.core.policy import DENSE as J_DENSE  # noqa: E402
from repro.nn import vit as jvit  # noqa: E402
from repro.serve import vision as jvision  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import deploy  # noqa: E402
from repro_torch.nn import vit as tvit  # noqa: E402
from repro_torch.serve import vision as tvision  # noqa: E402

SMOKE = dict(image_size=16, patch_size=4, n_layers=2, d_model=32, n_heads=2,
             d_ff=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def shift_leaves(tree, path=()):
    """[(path, leaf dict)] of every shift subtree, in tree order."""
    if isinstance(tree, dict):
        if any(k in tree for k in ("w_latent", "w_packed", "w_deploy")):
            return [(path, tree)]
        return [x for k in tree for x in shift_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in shift_leaves(v, path + (i,))]
    return []


def frozen_pair(cfg_kwargs, arm, seed=0):
    """(port model, live reference params as numpy, reference tree frozen
    for xla, the same frozen for interpret), both bridged to torch."""
    cfg = jvit.ViTConfig(**cfg_kwargs)
    dense_model = jvit.ShiftAddViT(dataclasses.replace(cfg, policy=J_DENSE))
    jmodel, params = jvision.build_policy_model(
        cfg, arm, dense_model, dense_model.init(jax.random.PRNGKey(seed)))
    live = jax.tree_util.tree_map(np.asarray, params)
    trees = [bridge.to_torch(jmodel.prepare_inference(
        params, impl=impl, token_counts=(cfg.n_patches,)).params)
        for impl in ("xla", "interpret")]
    tmodel = tvit.ShiftAddViT(tvit.ViTConfig(
        **cfg_kwargs, policy=tvision.SWEEP_POLICIES[arm][0]))
    return tmodel, live, trees[0], trees[1]


def test_xla_frozen_tree_loads_with_the_reference_bytes():
    """shiftadd, the arm with shift leaves (q/k/v/o and the Shift expert)."""
    tmodel, live, xla_tree, interp_tree = frozen_pair(SMOKE, "shiftadd")
    leaves = shift_leaves(xla_tree)
    assert leaves and all(set(leaf) - {"bias"} == {"w_deploy"} for _, leaf in leaves)
    plan = tmodel.prepare_inference(xla_tree, token_counts=(16,))
    assert plan.frozen_linears == len(leaves)
    got = dict(shift_leaves(plan.params))
    want = dict(shift_leaves(interp_tree))
    latent = dict(shift_leaves(live))
    assert set(got) == set(want) == set(latent)
    for path, leaf in got.items():
        assert leaf["w_packed"].dtype == torch.int8
        ref_bytes = np.asarray(jquant.pack_from_dense(latent[path]["w_latent"]))
        np.testing.assert_array_equal(leaf["w_packed"].numpy(), ref_bytes)
        np.testing.assert_array_equal(want[path]["w_packed"].numpy(), ref_bytes)
    images = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 16, 16, 3)).astype(np.float32))
    interp_plan = tmodel.prepare_inference(interp_tree, token_counts=(16,))
    for impl in ("torch", "cuda"):
        assert torch.equal(tmodel.infer(plan.params, images, impl=impl),
                           tmodel.infer(interp_plan.params, images, impl=impl))


def test_w_deploy_repack_is_exact_over_the_whole_exponent_range():
    """Every sign and every P in [-64, 63] survives decode → repack."""
    p = torch.arange(-64, 64, dtype=torch.int32)
    sign = torch.tensor([1.0, -1.0]).repeat_interleave(p.numel())
    packed = deploy.quant.pack_po2(sign, p.repeat(2))
    w = deploy.quant.po2_value(*deploy.quant.unpack_po2(packed))
    frozen, n = deploy.freeze_params({"lin": {"w_deploy": w.reshape(16, 16),
                                              "bias": torch.zeros(16)}})
    assert n == 1 and set(frozen["lin"]) == {"w_packed", "bias"}
    assert torch.equal(frozen["lin"]["w_packed"], packed.reshape(16, 16))

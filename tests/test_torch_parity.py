"""The main path's parity gate at the serving geometry: per-image logits of
the port against the reference at `ViTConfig(image_size=56)` (196 tokens of
patch 4, d_model 128, 4 layers, 4 heads, d_ff 256, MoE caps (113, 133)), for
the dense, stage1 and shiftadd arms.

The reference runs its deployment-frozen parameters (`impl="interpret"`:
packed int8 shift weights through its Pallas kernels in interpret mode); the
port runs the same bytes through its plain versions (`impl="torch"`) and
through its kernel wrappers (`impl="cuda"`, which take the plain version for
CPU tensors). The routers and the DWConv on V are seeded non-zero in the
reference's tree before the freeze, so both experts carry tokens.

Tolerance: scaled error (max |a-b| / std(ref)) < 1e-3 per image, the
reference kernel tests' bound for float32 sums in other orders; the shift
projections round their inputs to bf16 on both sides, and a last-bit
difference ahead of that rounding can move it.

The same shiftadd weights frozen by the reference for `impl="xla"` (shift
leaves decoded to `w_deploy`) load into the port with logits equal, bit for
bit, to the `interpret`-frozen load."""
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.nn import vit as tvit  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402
from repro_torch.serve import vision as tvision  # noqa: E402

GEOMETRY = dict(image_size=56)
TOL = 1e-3
N_IMAGES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dense():
    cfg = jvit.ViTConfig(**GEOMETRY)
    model = jvit.ShiftAddViT(dataclasses.replace(cfg, policy=J_DENSE))
    return cfg, model, model.init(jax.random.PRNGKey(0))


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


@pytest.mark.parametrize("arm", ["dense", "stage1", "shiftadd"])
def test_logits_match_reference_at_196_tokens(dense, arm):
    cfg, dense_model, dense_params = dense
    jmodel, params = jvision.build_policy_model(cfg, arm, dense_model, dense_params)
    params = _seed_live_params(params, seed=11)
    plan = jmodel.prepare_inference(params, impl="interpret",
                                    token_counts=(cfg.n_patches,))
    images = np.random.default_rng(3).standard_normal(
        (N_IMAGES, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jmodel.infer(plan.params, jnp.asarray(images), impl="interpret"))

    tmodel = tvit.ShiftAddViT(tvit.ViTConfig(**GEOMETRY,
                                             policy=tvision.SWEEP_POLICIES[arm][0]))
    tp = bridge.to_torch(plan.params)
    timages = torch.from_numpy(images)
    before = ops.launch_counts()
    for impl in ("torch", "cuda"):
        got = tmodel.infer(tp, timages, impl=impl)
        assert tuple(got.shape) == (N_IMAGES, 10)
        for i in range(N_IMAGES):
            assert scaled_error(got[i], want[i]) < TOL, (impl, i)
    assert ops.launch_counts() == before, "CPU tensors launch no kernel"

    if arm == "shiftadd":
        xla = bridge.to_torch(jmodel.prepare_inference(
            params, impl="xla", token_counts=(cfg.n_patches,)).params)
        frozen = tmodel.prepare_inference(xla, token_counts=(cfg.n_patches,))
        assert frozen.frozen_linears == 4 * (4 + 2)
        assert torch.equal(tmodel.infer(frozen.params, timages, impl="torch"),
                           tmodel.infer(tp, timages, impl="torch"))

"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device (a CUDA
kernel has no CPU mode). Run on a machine with the card and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances are the reference kernel tests' scaled error: < 2e-2 for
`shift_matmul` (bf16 products, float32 sums in another order) and < 1e-3 for
the attention (float32 throughout). This file imports no JAX, so it runs
where only the port is installed."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quant import pack_from_dense  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import bidir_linear_attention as tbidir  # noqa: E402
from repro_torch.kernels import shift_matmul as tshift  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402

SHIFT_SHAPES = [(8, 32, 16), (70, 300, 200), (128, 512, 128), (1, 64, 640),
                (197, 100, 60), (5, 7, 3), (6272, 128, 128), (4256, 256, 128)]
BIDIR_SHAPES = [(2, 64, 32, 32), (4, 197, 64, 48), (3, 196, 80, 80),
                (2, 8, 16, 16), (128, 196, 32, 32), (1, 33, 7, 5),
                (1, 5000, 128, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(g, k, n, dev):
    return pack_from_dense(torch.randn((k, n), generator=g, device=dev) * k ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", SHIFT_SHAPES)
def test_shift_matmul_kernel(cuda, m, k, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    wp = _packed(g, k, n, cuda)
    n0 = tshift.shift_matmul.launches
    got = tshift.shift_matmul(x, wp)
    torch.cuda.synchronize()
    assert tshift.shift_matmul.launches == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    assert scaled_error(got, ref.shift_matmul_ref(x, wp)) < 2e-2


@pytest.mark.gpu
def test_shift_matmul_rows_independent_of_m(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((6272, 128), generator=g, device=cuda)
    wp = _packed(g, 128, 128, cuda)
    full = tshift.shift_matmul(x, wp)
    for i in (0, 1, 63, 64, 3137, 6271):
        assert torch.equal(tshift.shift_matmul(x[i:i + 1].contiguous(), wp)[0], full[i])


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,dk,dv", BIDIR_SHAPES)
def test_bidir_attention_kernel(cuda, g, n, dk, dv):
    gen = torch.Generator(device=cuda).manual_seed(n)
    q, k = (torch.randn((g, n, dk), generator=gen, device=cuda) for _ in range(2))
    v = torch.randn((g, n, dv), generator=gen, device=cuda)
    n0 = tbidir.bidir_binary_attention.launches
    got = tbidir.bidir_binary_attention(q, k, v)
    torch.cuda.synchronize()
    assert tbidir.bidir_binary_attention.launches == n0 + 1
    assert scaled_error(got, ref.bidir_binary_attention_ref(q, k, v)) < 1e-3
    again = tbidir.bidir_binary_attention(q, k, v)
    assert torch.equal(again, got), "fixed summation order: run-to-run identical"


@pytest.mark.gpu
def test_cuda_impl_on_cuda_tensors_launches(cuda):
    """impl="cuda" on CUDA tensors goes through the kernels (no plain-version
    fallback); impl="torch" launches nothing."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((3, 10, 32), generator=g, device=cuda)
    wp = _packed(g, 32, 16, cuda)
    q = torch.randn((2, 4, 10, 8), generator=g, device=cuda)
    before = ops.launch_counts()
    ops.shift_matmul(x, wp, "torch")
    ops.binary_linear_attention_bidir(q, q, q, impl="torch")
    assert ops.launch_counts() == before
    ops.shift_matmul(x, wp, "cuda")
    ops.binary_linear_attention_bidir(q, q, q, impl="cuda")
    after = ops.launch_counts()
    assert after["shift_matmul"] == before["shift_matmul"] + 1
    assert after["bidir_binary_attention"] == before["bidir_binary_attention"] + 1


@pytest.mark.gpu
def test_kernel_rejects_oversized_head_dim(cuda):
    q = torch.zeros((1, 4, 129), device=cuda)
    with pytest.raises(ValueError):
        tbidir.bidir_binary_attention(q, q, q)

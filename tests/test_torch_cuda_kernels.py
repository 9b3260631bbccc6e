"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA device (a CUDA
kernel has no CPU mode). Run on a machine with the card and nvcc:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances are the reference kernel tests' scaled error: < 2e-2 for the
matmuls (`shift_matmul`, `add_matmul`, `add_matmul_packed`: bf16 products,
float32 sums in another order) and < 1e-3 for the attentions (float32
throughout). Every tile shape of a matmul gives the same bits (every output
element is the same chain of tensor-core steps in K order), which the tile
tests hold exactly. This file imports no JAX, so it
runs where only the port is installed."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quant import pack_from_dense  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import add_matmul as tadd  # noqa: E402
from repro_torch.kernels import add_matmul_packed as tpacked  # noqa: E402
from repro_torch.kernels import bidir_linear_attention as tbidir  # noqa: E402
from repro_torch.kernels import linear_attention as tcausal  # noqa: E402
from repro_torch.kernels import shift_matmul as tshift  # noqa: E402
from repro_torch.kernels.tile_matmul import TILES  # noqa: E402
from repro_torch.parity import scaled_error  # noqa: E402

SHIFT_SHAPES = [(8, 32, 16), (70, 300, 200), (128, 512, 128), (1, 64, 640),
                (197, 100, 60), (5, 7, 3), (6272, 128, 128), (4256, 256, 128)]
ADD_SHAPES = [(2, 8, 32, 16), (6, 50, 100, 60), (1, 128, 512, 128),
              (1, 197, 64, 48), (2, 197, 100, 60), (1, 3, 5, 2),
              (128, 32, 196, 32), (128, 196, 32, 32), (3, 70, 300, 200),
              (1, 1, 8, 640)]
PACKED_SHAPES = [(2, 16, 64, 32), (1, 50, 128, 96), (3, 8, 256, 128),
                 (1, 197, 64, 48), (2, 33, 72, 60), (128, 32, 200, 32),
                 (128, 196, 32, 32), (1, 1, 8, 640)]
CAUSAL_SHAPES = [(1, 128, 16, 16, 128), (4, 256, 64, 64, 128),
                 (3, 512, 80, 80, 128), (2, 384, 128, 96, 128),
                 (2, 300, 24, 20, 128), (128, 196, 32, 32, 196),
                 (8, 197, 64, 48, 64), (2, 5000, 64, 64, 256), (1, 1, 8, 8, 256),
                 (2, 7, 32, 16, 64), (1, 100, 16, 16, 1)]
ALL_TILES = list(TILES)
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
def test_bidir_attention_batch_entry_independent_of_g(cuda):
    """Batch·heads 0, 77 and 127 give the same bits alone (G = 1), among
    G = 4 (bucket 1) and among G = 128 (bucket 32): the row partition
    depends on N alone. One launch per call."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((128, 196, 32), generator=gen, device=cuda) for _ in range(3))
    full = tbidir.bidir_binary_attention(q, k, v)
    pick = [0, 77, 127, 5]
    four = tbidir.bidir_binary_attention(*(t[pick].contiguous() for t in (q, k, v)))
    for j, i in enumerate(pick[:3]):
        n0 = tbidir.bidir_binary_attention.launches
        one = tbidir.bidir_binary_attention(*(t[i:i + 1].contiguous() for t in (q, k, v)))
        assert tbidir.bidir_binary_attention.launches == n0 + 1
        assert torch.equal(one[0], full[i]) and torch.equal(four[j], full[i]), i


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,h,d", [(2, 196, 4, 32), (2, 197, 3, 48), (1, 70, 2, 7),
                                     (2, 300, 1, 256)])
def test_bidir_attention_strided_views_equal_contiguous(cuda, b, n, h, d):
    """The (B, H, N, D) views of (B, N, H·D) projections, as the serving
    path passes them, give the bits of contiguous (G, N, D) copies; the
    output is a view of a (B, N, H, D) buffer, so the o-projection's
    reshape copies nothing."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    q, k, v = (torch.randn((b, n, h * d), generator=gen, device=cuda)
               .reshape(b, n, h, d).permute(0, 2, 1, 3) for _ in range(3))
    got = tbidir.bidir_binary_attention(q, k, v)
    assert tuple(got.shape) == (b, h, n, d)
    assert got.permute(0, 2, 1, 3).is_contiguous()
    flat = tbidir.bidir_binary_attention(*(t.reshape(b * h, n, d).contiguous()
                                           for t in (q, k, v)))
    assert torch.equal(got.reshape(b * h, n, d), flat)
    assert scaled_error(got, ref.bidir_binary_attention_ref(q, k, v)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dv", [256, 200])
def test_bidir_attention_slice_width_changes_no_bit(cuda, dv):
    """At Dk = 256 the slice width follows Dv (`dv_slice`): 64-wide slices
    at Dv = 256 and 200 (the last one 8 wide at 200), one slice of all of
    Dv from 128 down. An output column depends on its column of v alone, so
    the first columns of the Dv = 256 or 200 run equal, bit for bit, the
    runs on v's first 128, 64, 32, 24, 16, 10 and 8 columns (10: rows not
    16-byte aligned, the 4-byte-copy kernel)."""
    gen = torch.Generator(device=cuda).manual_seed(dv)
    q, k = (torch.randn((2, 197, 256), generator=gen, device=cuda) for _ in range(2))
    v = torch.randn((2, 197, dv), generator=gen, device=cuda)
    want = tbidir.bidir_binary_attention(q, k, v)
    assert tbidir.dv_slice(256, dv) == 64
    for cols in (128, 64, 32, 24, 16, 10, 8):
        assert tbidir.dv_slice(256, cols) == cols
        got = tbidir.bidir_binary_attention(q, k, v[..., :cols].contiguous())
        assert torch.equal(got, want[..., :cols]), cols


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
@pytest.mark.parametrize("g,n", [(2, 197), (1, 1000)])
def test_attention_kernels_at_head_dim_256(cuda, g, n):
    """Dk = Dv = 256: the KV is split into 64-wide Dv slices, one block each;
    both kernels hold their plain versions, the causal one with its carry
    (ksum exact), and repeat bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(n + 256)
    q, k, v = (torch.randn((g, n, 256), generator=gen, device=cuda) for _ in range(3))
    got = tbidir.bidir_binary_attention(q, k, v)
    assert scaled_error(got, ref.bidir_binary_attention_ref(q, k, v)) < 1e-3
    assert torch.equal(tbidir.bidir_binary_attention(q, k, v), got)
    out, kv, ksum, vsum = tcausal.binary_linear_attention(q, k, v, 128, return_state=True)
    st = ref.binary_linear_attention_state_ref(q, k, v)
    assert scaled_error(out, ref.binary_linear_attention_ref(q, k, v)) < 1e-3
    assert scaled_error(kv, st["kv"]) < 1e-3 and scaled_error(vsum, st["vsum"]) < 1e-3
    assert torch.equal(ksum, st["ksum"])
    assert torch.equal(tcausal.binary_linear_attention(q, k, v, 128), out)


@pytest.mark.gpu
def test_kernels_reject_head_dims_past_their_limit(cuda):
    """Only a Dk at which no Dv slice fits a block is refused."""
    v = torch.zeros((1, 4, 8), device=cuda)
    for fn, smem in ((tbidir.bidir_binary_attention, tbidir.smem_bytes),
                     (tcausal.binary_linear_attention, tcausal.smem_bytes)):
        limit = tbidir.max_dk(smem)
        fn(*(torch.zeros((1, 4, limit), device=cuda),) * 2, v)
        big = torch.zeros((1, 4, limit + 1), device=cuda)
        with pytest.raises(ValueError, match=f"Dk up to {limit}"):
            fn(big, big, v)


def _signs(gen, shape, dev, zeros=False):
    lo = -1 if zeros else 0
    b = torch.randint(lo, 2, shape, generator=gen, device=dev, dtype=torch.int8)
    return b if zeros else b * 2 - 1


@pytest.mark.gpu
def test_shift_matmul_every_tile_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    for m, k, n in ((6272, 128, 128), (197, 300, 200), (1, 64, 640), (4256, 256, 256)):
        wp = _packed(g, k, n, cuda)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
            want = tshift.shift_matmul(x, wp)
            for tile in ALL_TILES:
                assert torch.equal(tshift.shift_matmul(x, wp, tile), want), (m, k, n, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,m,k,n", ADD_SHAPES)
def test_add_matmul_kernel(cuda, g, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(g + m + k + n)
    x = torch.randn((g, m, k), generator=gen, device=cuda).to(dtype)
    b = _signs(gen, (g, k, n), cuda, zeros=True)
    n0 = tadd.add_matmul.launches
    got = tadd.add_matmul(x, b)
    torch.cuda.synchronize()
    assert tadd.add_matmul.launches == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (g, m, n)
    assert scaled_error(got, ref.add_matmul_ref(x, b)) < 2e-2
    for tile in ALL_TILES:
        assert torch.equal(tadd.add_matmul(x, b, tile), got), tile


@pytest.mark.gpu
def test_add_matmul_zeros_contribute_nothing(cuda):
    x = torch.randn((2, 40, 70), device=cuda)
    assert torch.equal(tadd.add_matmul(x, torch.zeros((2, 70, 9), dtype=torch.int8,
                                                      device=cuda)),
                       torch.zeros((2, 40, 9), device=cuda))


@pytest.mark.gpu
def test_add_matmul_batch_entry_independent_of_g(cuda):
    """Batch·head g alone gives the bits it gets among G = 128."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    for m, k, n in ((32, 196, 32), (196, 32, 32)):
        x = torch.randn((128, m, k), generator=gen, device=cuda)
        b = _signs(gen, (128, k, n), cuda)
        full = tadd.add_matmul(x, b)
        for i in (0, 77, 127):
            assert torch.equal(tadd.add_matmul(x[i:i + 1].contiguous(),
                                               b[i:i + 1].contiguous())[0], full[i])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,m,k,n", PACKED_SHAPES)
def test_add_matmul_packed_kernel(cuda, g, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(g * m + k + n)
    x = torch.randn((g, m, k), generator=gen, device=cuda).to(dtype)
    b = _signs(gen, (g, k, n), cuda)
    packed = tpacked.pack_bits(b)
    n0 = tpacked.add_matmul_packed.launches
    got = tpacked.add_matmul_packed(x, packed)
    torch.cuda.synchronize()
    assert tpacked.add_matmul_packed.launches == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (g, m, n)
    assert scaled_error(got, ref.add_matmul_ref(x, b)) < 2e-2
    assert torch.equal(got, tadd.add_matmul(x, b)), "same bits as the int8 operand"
    for tile in ALL_TILES:
        assert torch.equal(tpacked.add_matmul_packed(x, packed, tile), got), tile


@pytest.mark.gpu
@pytest.mark.parametrize("g,n,dk,dv,chunk", CAUSAL_SHAPES)
def test_causal_attention_kernel(cuda, g, n, dk, dv, chunk):
    gen = torch.Generator(device=cuda).manual_seed(n + dk)
    q, k = (torch.randn((g, n, dk), generator=gen, device=cuda) for _ in range(2))
    v = torch.randn((g, n, dv), generator=gen, device=cuda)
    n0 = tcausal.binary_linear_attention.launches
    got = tcausal.binary_linear_attention(q, k, v, chunk)
    out, kv, ksum, vsum = tcausal.binary_linear_attention(q, k, v, chunk, return_state=True)
    torch.cuda.synchronize()
    assert tcausal.binary_linear_attention.launches == n0 + 2
    assert scaled_error(got, ref.binary_linear_attention_ref(q, k, v)) < 1e-3
    assert torch.equal(out, got), "return_state leaves the output as it was"
    want = ref.binary_linear_attention_state_ref(q, k, v)
    assert torch.equal(ksum, want["ksum"]), "ksum is a sum of ±1: exact"
    assert scaled_error(kv, want["kv"]) < 1e-3
    assert scaled_error(vsum, want["vsum"]) < 1e-3
    assert torch.equal(tcausal.binary_linear_attention(q, k, v, chunk), got), \
        "fixed summation order: run-to-run identical"


@pytest.mark.gpu
def test_new_kernels_launch_through_ops(cuda):
    """impl="cuda" on CUDA tensors launches each new kernel once, with the
    tune table's configuration; impl="torch" launches nothing."""
    from repro_torch.kernels.autotune import TuneTable, geometry_key

    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((8, 32, 200), generator=gen, device=cuda)
    b = _signs(gen, (8, 200, 32), cuda)
    packed = tpacked.pack_bits(b)
    q = torch.randn((2, 4, 196, 32), generator=gen, device=cuda)
    table = TuneTable.from_dicts({
        geometry_key("add_matmul", g=8, m=32, k=200, n=32): {"tile_m": 32, "tile_n": 32},
        geometry_key("linear_attention", g=8, n=196, dk=32, dv=32): {"chunk_rows": 64}})
    before = ops.launch_counts()
    ops.add_matmul(x, b, "torch")
    ops.add_matmul_bitpacked(x, packed, "torch")
    ops.binary_linear_attention_fused(q, q, q, impl="torch")
    assert ops.launch_counts() == before
    tuned = ops.add_matmul(x, b, "cuda", table)
    assert torch.equal(tuned, ops.add_matmul(x, b, "cuda"))
    ops.add_matmul_bitpacked(x, packed, "cuda", table)
    out64 = ops.binary_linear_attention_fused(q, q, q, impl="cuda", tune=table)
    assert torch.equal(out64, ops.binary_linear_attention_fused(q, q, q, chunk=64,
                                                                impl="cuda"))
    after = ops.launch_counts()
    assert after["add_matmul"] == before["add_matmul"] + 2
    assert after["add_matmul_packed"] == before["add_matmul_packed"] + 1
    assert after["binary_linear_attention"] == before["binary_linear_attention"] + 2


@pytest.mark.gpu
def test_autotune_times_each_site_by_either_method(cuda, monkeypatch):
    """measure_site reads kernel durations from a profiler trace; where the
    profiler records nothing, CUDA-graph replays time the whole site, and
    the launch counts are those the replays ran."""
    from repro_torch.analysis.kernel_contracts import serving_sites
    from repro_torch.kernels import autotune
    from repro_torch.nn.vit import ViTConfig

    counted = {"shift_matmul": "shift_matmul", "add_matmul": "add_matmul",
               "add_matmul_packed": "add_matmul_packed",
               "linear_attention": "binary_linear_attention"}

    sites = [s for s in serving_sites(ViTConfig(image_size=56), 1)
             if autotune.SEARCH_SPACE[s["kernel"]]]
    for spec in sites:
        configs = autotune.candidates(spec)[:2]
        ms, how = autotune.measure_site(spec, configs, iters=5, device=cuda)
        assert how == autotune.PROFILER and all(0 < t < 10 for t in ms), spec
    monkeypatch.setattr(autotune, "trace_device", lambda fn, iters: [])
    for spec in sites:
        configs = autotune.candidates(spec)[:2]
        name = counted[spec["kernel"]]
        before = ops.launch_counts()[name]
        ms, how = autotune.measure_site(spec, configs, iters=5, device=cuda)
        assert how == autotune.GRAPH and all(0 < t < 10 for t in ms), spec
        # Two warm-up calls, then per config one call before capture and
        # 5 launches in each of 1 + 5 replays; the capture itself counts none.
        assert ops.launch_counts()[name] - before == 2 + len(configs) * (1 + 5 * 6), spec

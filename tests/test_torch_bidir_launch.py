"""The launch helpers of the clustered bidirectional attention kernel
(`kernels/bidir_linear_attention.py`), on the CPU.

The kernel splits each batch·head's N rows over a thread-block cluster. Its
row partition and cluster size are functions of N alone, so a batch·head
gets the same chain of adds whatever G, the slice width or the layout; its
operands are strided (B, H, N, D) views and its output a view of a
(B, N, H, Dv) buffer. The kernel itself runs only on the card
(test_torch_cuda_kernels.py, chip_smoke.py); this file imports no JAX."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import SMEM_PER_BLOCK, ref  # noqa: E402
from repro_torch.kernels import bidir_linear_attention as tb  # noqa: E402
from repro_torch.kernels import linear_attention as tcausal  # noqa: E402

NS = [1, 2, 31, 32, 33, 64, 65, 196, 197, 224, 225, 250, 256, 257, 300, 1000, 4096,
      5000, 12345]


def block_rows(c, span, n):
    """The rows [r0, r1) of each block, in rank order, as the kernel forms
    them from the cluster size and span it is launched with."""
    return [(min(n, r * span), min(n, min(n, r * span) + span)) for r in range(c)]


@pytest.mark.parametrize("n", NS)
def test_rows_cover_n_once_in_rank_order(n):
    q = torch.empty((1, 1, n, 8))
    ints, _ = tb.launch_args(q, q, q, tb.out_buffer(1, 1, n, 8, "cpu"), 8)
    c, span = ints[-2:]
    assert (c, span) == tb.partition(n)
    assert 1 <= c <= tb.MAX_CLUSTER == 8 and c == min(8, -(-n // 32))
    ranges = block_rows(c, span, n)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0, "contiguous, in rank order"
    assert all(r1 > r0 for r0, r1 in ranges), "no block without rows"
    covered = [i for r0, r1 in ranges for i in range(r0, r1)]
    assert covered == list(range(n)), "every row exactly once"
    assert max(r1 - r0 for r0, r1 in ranges) == span == -(-n // c)


@pytest.mark.parametrize("n", [196, 197, 5000])
def test_partition_is_the_same_for_every_g_slice_and_layout(n):
    """The cluster size and span the launch passes depend on N alone: G = 1,
    4 and 128, contiguous or strided, any Dv slice."""
    seen = set()
    for g in (1, 4, 128):
        q = torch.empty((g, 1, n, 8))
        for width in (8, 4):
            ints, _ = tb.launch_args(q, q, q, tb.out_buffer(g, 1, n, 8, "cpu"), width)
            seen.add(ints[-2:])
        b, h = (g, 1) if g < 4 else (g // 4, 4)
        x = torch.empty((b, n, h * 8)).reshape(b, n, h, 8).permute(0, 2, 1, 3)
        ints, _ = tb.launch_args(x, x, x, tb.out_buffer(b, h, n, 8, "cpu"), 8)
        seen.add(ints[-2:])
    assert seen == {tb.partition(n)}


def test_strides_of_projection_views_and_output():
    b, n, h, d, dv = 2, 196, 4, 32, 48
    q, k = (torch.randn(b, n, h * d).reshape(b, n, h, d).permute(0, 2, 1, 3)
            for _ in range(2))
    v = torch.randn(b, n, h * dv).reshape(b, n, h, dv).permute(0, 2, 1, 3)
    assert tb.view_strides(q) == (n * h * d, d, h * d)
    out = tb.out_buffer(b, h, n, dv, "cpu")
    assert tuple(out.shape) == (b, h, n, dv)
    assert tb.view_strides(out) == (n * h * dv, dv, h * dv) and out.stride(-1) == 1
    flat = out.permute(0, 2, 1, 3).reshape(b, n, h * dv)
    assert flat.data_ptr() == out.data_ptr(), "the o-projection's reshape copies nothing"
    ints, strides = tb.launch_args(q, k, v, out, 48)
    assert ints == (b, h, n, d, dv, 48, 7, 28)
    assert strides == (n * h * d, d, h * d) * 2 + (n * h * dv, dv, h * dv) * 2
    # contiguous (G, N, D), as (G, 1, N, D): the unit head dim has stride 0
    g3 = torch.randn(3, 70, 16).unsqueeze(1)
    assert tb.view_strides(g3) == (70 * 16, 0, 16)
    assert tb.view_strides(torch.randn(1, 5, 9, 4)) == (0, 36, 4)


def test_shared_memory_slices_and_head_dim_limit_follow_the_block():
    def block(dk, dvs):     # ring of two 32-row stages, then the sums
        return 4 * (2 * 32 * ((dk + 4) + dvs) + dk * dvs + dk + dvs)

    for dk, dvs in ((32, 32), (7, 5), (256, 64), (128, 128), (785, 8)):
        assert tb.smem_bytes(dk, dvs) == block(dk, dvs)
    assert tb.dv_slice(32, 32) == 32 and tb.dv_slice(128, 128) == 128
    assert tb.dv_slice(256, 256) == 64 and tb.dv_slice(256, 200) == 64
    assert 200 - 3 * 64 == 8, "the last slice at Dv = 200 is ragged"
    for dk, dv in ((32, 32), (64, 48), (256, 256), (256, 200), (7, 5), (785, 3)):
        assert tb.smem_bytes(dk, tb.dv_slice(dk, dv)) <= SMEM_PER_BLOCK
    limit = tb.max_dk()
    assert limit == 785
    assert tb.smem_bytes(limit, 8) <= SMEM_PER_BLOCK < tb.smem_bytes(limit + 1, 8)
    assert tb.dv_slice(limit + 1, 8) is None
    # the causal kernel keeps its own block and limit
    assert tb.max_dk(tcausal.smem_bytes) == 774
    assert tb.dv_slice(256, 256, tcausal.smem_bytes) == 64


def test_checks_take_views_and_keep_the_causal_check_contiguous():
    b, n, h, d = 1, 9, 2, 4
    x = torch.randn(b, n, h * d).reshape(b, n, h, d).permute(0, 2, 1, 3)
    assert tb.check_views(x, x, x) == d
    assert tb.check_views(torch.randn(3, n, d), torch.randn(3, n, d), torch.randn(3, n, 5)) == 5
    cols = torch.randn(b, h, d, n).transpose(-1, -2)      # (B, H, N, D), stride(-1) = N
    with pytest.raises(ValueError, match="stride 1"):
        tb.check_views(cols, cols, x)
    with pytest.raises(ValueError):
        tb.check_views(x, x, torch.randn(b, h, n + 1, d))
    with pytest.raises(TypeError):
        tb.check_views(x, x.double(), x)
    with pytest.raises(ValueError, match=f"Dk up to {tb.max_dk()}"):
        big = torch.zeros(1, 4, tb.max_dk() + 1)
        tb.check_views(big, big, torch.zeros(1, 4, 8))
    strided = torch.randn(3, n, 2 * d)[..., :d]
    with pytest.raises(ValueError, match="contiguous"):
        tb.check_args(strided, strided, strided, tcausal.smem_bytes)
    with pytest.raises(ValueError, match="contiguous"):
        tcausal.binary_linear_attention(strided, strided, strided)


def test_wrapper_on_cpu_views_runs_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    b, n, h, d = 2, 33, 3, 8
    q, k, v = (torch.randn(b, n, h * d, generator=gen).reshape(b, n, h, d)
               .permute(0, 2, 1, 3) for _ in range(3))
    before = tb.bidir_binary_attention.launches
    got = tb.bidir_binary_attention(q, k, v)
    assert tb.bidir_binary_attention.launches == before, "the plain version counts no launch"
    want = ref.bidir_binary_attention_ref(*(t.contiguous() for t in (q, k, v)))
    assert tuple(got.shape) == (b, h, n, d)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

"""The launch helpers of the causal chunked attention kernels
(`kernels/linear_attention.py`) and the autotuner's per-call timing, on the
CPU.

One call runs two to four kernels: the ±1 codes of q and k, the partial
carry of each chunk, the prefix over those partials in chunk order, and the
outputs, one block per (batch·head, 32 query rows of a chunk, Dv slice). The partition the kernels
are launched with is a function of N and the chunk alone, so a batch·head
gets the same chains of adds whatever G, the slice width or the layout; the
slice only narrows to fill the card. The kernels themselves run only on the
card (test_torch_cuda_kernels.py, chip_smoke.py); this file imports no JAX."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import SMEM_PER_BLOCK, ops, ref  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import bidir_linear_attention as tb  # noqa: E402
from repro_torch.kernels import linear_attention as tl  # noqa: E402

NS = [1, 2, 31, 32, 33, 63, 64, 65, 196, 197, 256, 257, 1000, 4096, 5000]
CHUNKS = [1, 7, 32, 64, 100, 128, 196, 256, 10_000]


def tile_rows(n, chunk, per, tiles):
    """The query rows [q0, q1) and chunk of each tile τ, as the output
    kernel forms them from the partition it is launched with."""
    rows = []
    for tau in range(tiles):
        c = tau // per
        c0, cend = c * chunk, min(n, (c + 1) * chunk)
        q0 = c0 + (tau - c * per) * tl.ROWS
        rows.append((c, q0, min(q0 + tl.ROWS, cend)))
    return rows


def _ints(g, n, dk=8, dv=8, chunk=64, state=False):
    """(ints, workspace shape) of the launch."""
    q, v = torch.empty((g, n, dk)), torch.empty((g, n, dv))
    ints, work, codes = tl.launch_args(q, v, chunk, state)
    assert codes == (2, ints[0], n, -(-dk // 32)), "a code word per 32 head dims of a row"
    return ints, work


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("n", NS)
def test_tiles_cover_n_once_in_chunk_order(n, chunk):
    ints, _ = _ints(2, n, chunk=chunk)
    g, nn, _, _, ch, rows, per, tiles, _, _ = ints
    assert (g, nn, rows) == (2, n, 32) and tl.ROWS == 32
    assert (ch, per, tiles) == tl.partition(n, chunk)[:1] + tl.partition(n, chunk)[2:]
    assert ch == min(chunk, n) and per == -(-ch // 32)
    got = tile_rows(n, ch, per, tiles)
    covered = [i for _, q0, q1 in got for i in range(q0, q1)]
    assert covered == list(range(n)), "every row exactly once, in order"
    assert all(q1 > q0 for _, q0, q1 in got), "no tile without rows"
    for c, q0, q1 in got:
        assert c * ch <= q0 < q1 <= min(n, (c + 1) * ch), "a tile lies in one chunk"
        assert (q0 - c * ch) % 32 == 0, "tiles start 32 rows apart from the chunk's start"
    assert {c for c, _, _ in got} == set(range(-(-n // ch)))


@pytest.mark.parametrize("n,chunk", [(196, 196), (196, 64), (197, 128), (5000, 256),
                                     (4096, 256), (100, 1)])
def test_partition_is_the_same_for_every_g_slice_and_layout(n, chunk):
    """Chunk, rows, tiles per chunk and tiles depend on N and the chunk
    alone: G = 1, 4 and 128 (so slices of 8 to all of Dv), Dv of 8, 32, 200
    and 256, and (B, H) layouts that flatten to one G."""
    seen, widths = set(), set()
    for g in (1, 4, 128):
        for dk, dv in ((32, 32), (8, 8), (256, 200), (256, 256)):
            for state in (False, True):
                ints, _ = _ints(g, n, dk, dv, chunk, state)
                seen.add(ints[4:8])
                widths.add(ints[-1])
    for b, h in ((1, 128), (32, 4), (128, 1)):
        x = torch.empty((b, n, h * 8)).reshape(b, n, h, 8).permute(0, 2, 1, 3)
        flat = x.reshape(b * h, n, 8).contiguous()
        seen.add(tl.launch_args(flat, flat, chunk, False)[0][4:8])
    assert seen == {(min(chunk, n), 32) + tl.partition(n, chunk)[2:]}
    assert len(widths) > 1, "the slice width varies over these cases"


@pytest.mark.parametrize("n,chunk,state,recs", [
    (196, 196, False, 0), (196, 196, True, 1), (196, 128, False, 1), (196, 64, False, 3),
    (196, 64, True, 4), (5000, 256, False, 19), (5000, 256, True, 20), (1, 1, True, 1),
    (100, 1, False, 99)])
def test_workspace_records_and_kernels_per_call(n, chunk, state, recs):
    dk, dv = 48, 40
    ints, shape = _ints(3, n, dk, dv, chunk, state)
    chunks = tl.partition(n, chunk)[1]
    assert ints[8] == tl.records(chunks, state) == recs
    assert shape == ((3, recs, dk * dv + dk + dv) if recs else None)
    names = tl.passes(chunks, state)
    assert names[0] == "binary_linear_attention_codes_kernel"
    assert names[-1] == "binary_linear_attention_out_kernel"
    assert ("binary_linear_attention_partials_kernel" in names) == (recs > 0)
    assert ("binary_linear_attention_scan_kernel" in names) == (recs > 1 or state)
    assert all(at._SYMBOL["linear_attention"] in name for name in names)


@pytest.mark.parametrize("g,n,d,chunk,state", [
    (128, 5000, 256, 1, True), (128, 5000, 256, 64, False), (32, 4096, 128, 1, False),
    (2, 20000, 512, 1, True)])
def test_launches_split_g_only_where_the_records_would_not_fit(g, n, d, chunk, state):
    """All batch·heads in one launch unless their carry records pass
    WORK_BYTES; then as many as fit, at least one, with the partition and
    the slice of the whole call."""
    q = torch.empty((g, n, d))
    ints, work, codes = tl.launch_args(q, q, chunk, state)
    group, rec = ints[0], ints[8]
    per_g = 4 * rec * (d * d + 2 * d)
    assert work == (group, rec, d * d + 2 * d) and codes[:2] == (2, group)
    if g * per_g <= tl.WORK_BYTES:
        assert group == g
    else:
        assert 1 <= group < g and (group == 1 or group * per_g <= tl.WORK_BYTES)
        assert group == 1 or (group + 1) * per_g > tl.WORK_BYTES
    whole = tl.launch_args(q[:1], q[:1], chunk, state)[0]
    assert ints[4:9] == whole[4:9] and ints[-1] == tl.slice_width(g, ints[7], d, d)


def test_slice_fills_the_card_and_always_fits():
    # G = 128 at the autotune site: 7 tiles x 128 blocks, all of Dv
    assert _ints(128, 196, 32, 32, 196)[0][-1] == 32
    # G = 4: 28 blocks, so 16 (56) then 8 (112); no narrower slice
    assert _ints(4, 196, 32, 32, 196)[0][-1] == 8
    assert _ints(32, 4096, 128, 128, 256)[0][-1] == 128
    assert _ints(2, 197, 256, 256, 64)[0][-1] == 16
    for g, n, dk, dv in ((1, 1, 1, 1), (4, 196, 32, 32), (1, 33, 9120, 3), (2, 70, 256, 200),
                         (128, 196, 32, 32), (1, 5000, 128, 128)):
        width = _ints(g, n, dk, dv)[0][-1]
        assert 1 <= width <= dv and tl.smem_bytes(dk, width) <= SMEM_PER_BLOCK
        assert width == dv or width in tb.SLICES


def test_shared_memory_and_head_dim_limit():
    def block(dk, dvs):      # three-stage rings of 32 rows, then each kernel's own
        vp, wp = -(-dvs // 8) * 8, -(-dk // 32) | 1
        partials = 3 * 32 * (vp + 1)                    # v rows, a code word a row
        stages = 3 if vp > 64 else 4
        out = (stages * 32 * (vp + wp) + 2 * 32 * 32    # v and key-code rows, weights
               + -(-dk // 4) * 4 + vp + 4 * 32 + 32 * wp)   # carry, den parts, q codes
        return 4 * max(partials, out)

    for dk, dvs in ((32, 32), (7, 5), (256, 64), (128, 128), (788, 8), (64, 48), (70, 72)):
        assert tl.smem_bytes(dk, dvs) == block(dk, dvs)
    limit = tb.max_dk(tl.smem_bytes)
    assert limit == 9120, "the causal kernels take Dk up to 9120 (774 before)"
    assert tl.smem_bytes(limit, 8) <= SMEM_PER_BLOCK < tl.smem_bytes(limit + 1, 8)


def test_refusals():
    q = torch.zeros(2, 5, 8)
    big = torch.zeros(2, 5, tb.max_dk(tl.smem_bytes) + 1)
    with pytest.raises(ValueError, match="Dk up to 9120"):
        tl.binary_linear_attention(big, big, q)
    with pytest.raises(ValueError, match="chunk must be at least 1"):
        tl.binary_linear_attention(q, q, q, chunk=0)
    with pytest.raises(TypeError):
        tl.binary_linear_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros(2, 5, 16)[..., :8]
        tl.binary_linear_attention(strided, strided, strided)
    with pytest.raises(ValueError):
        tl.binary_linear_attention(q, q, torch.zeros(2, 6, 8))
    with pytest.raises(ValueError):
        tl.binary_linear_attention(q, q, q.to("meta"))


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((3, 40, 8), generator=gen) for _ in range(3))
    before = ops.launch_counts()
    out, kv, ksum, vsum = tl.binary_linear_attention(q, k, v, 16, return_state=True)
    assert ops.launch_counts() == before
    torch.testing.assert_close(out, ref.binary_linear_attention_ref(q, k, v), rtol=0, atol=0)
    st = ref.binary_linear_attention_state_ref(q, k, v)
    for got, key in ((kv, "kv"), (ksum, "ksum"), (vsum, "vsum")):
        torch.testing.assert_close(got, st[key], rtol=0, atol=0)


C, A, S, O = tl.KERNELS
OTHER = "void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>"


@pytest.mark.parametrize("events,want", [
    # four kernels per call, another kernel between calls
    ([(C, 0.5), (A, 1.0), (S, 0.5), (O, 2.0), (OTHER, 9.0), (C, 0.5), (A, 1.5), (S, 0.5),
      (O, 2.0)], [4.0, 4.5]),
    # one kernel per call
    ([(O, 1.0), (O, 2.0), (O, 3.0)], [1.0, 2.0, 3.0]),
    # two kernels per call; the trace dropped the first call's first kernel
    # and the last call's last one: each kept group sums one of each kernel
    ([(O, 2.0), (A, 1.0), (O, 2.5), (A, 1.0), (O, 2.0)], [3.0, 3.5]),
    # the matmuls' symbol: template arguments in the name
    ([("tile_matmul_kernel<64, 128>", 0.25)] * 2, [0.25, 0.25]),
    ([], []),
    ([(OTHER, 1.0)], []),
])
def test_per_call_sums_every_kernel_of_a_call(events, want):
    symbol = "tile_matmul_kernel" if events and "tile" in events[0][0] \
        else at._SYMBOL["linear_attention"]
    assert at.per_call_ms(events, symbol) == want

"""The port's autotune entry point on the CPU: serving sites and table keys
equal to the reference's, the table's JSON schema, fail-open loading, the
unmeasured search, the tuned engine and the CLIs.

The reference autotuner appears here only through `serving_sites`,
`geometry_key`, `GEOMETRY_KEYS` and `TuneTable.to_json_dict`; nothing runs
its search or its CLI. Every file this module writes goes to `tmp_path`.
Timing candidates needs the card: chip_smoke.py does that."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import kernel_contracts as jkc  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro.nn.vit import ViTConfig as JViTConfig  # noqa: E402
from repro_torch.analysis import kernel_contracts as kc  # noqa: E402
from repro_torch.core.policy import DENSE  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import bidir_linear_attention as tbidir  # noqa: E402
from repro_torch.launch import autotune as at_cli  # noqa: E402
from repro_torch.launch import serve_vit  # noqa: E402
from repro_torch.nn.vit import ShiftAddViT, ViTConfig, with_seeded_router  # noqa: E402
from repro_torch.serve.vision import BucketedViTEngine, build_policy_model  # noqa: E402

SMOKE = dict(image_size=16, patch_size=4, n_layers=2, d_model=32, n_heads=2,
             d_ff=64)
CONFIGS = {"serving": {"image_size": 56}, "reduced": SMOKE}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("bucket", [1, 8, 32])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serving_sites_and_keys_equal_reference(name, bucket):
    want = jkc.serving_sites(JViTConfig(**CONFIGS[name]), bucket)
    got = kc.serving_sites(ViTConfig(**CONFIGS[name]), bucket)
    assert got == want
    for spec in got:
        if spec["kernel"] in jat.GEOMETRY_KEYS:
            geom = at._site_geometry(spec)
            assert geom == jat._site_geometry(spec)
            assert (at.geometry_key(spec["kernel"], **geom)
                    == jat.geometry_key(spec["kernel"], **geom))


def test_geometry_keys_and_schema_version_equal_reference():
    assert at.GEOMETRY_KEYS == jat.GEOMETRY_KEYS
    assert at.SCHEMA_VERSION == jat.SCHEMA_VERSION
    assert set(at.SEARCH_SPACE) == set(jat.SEARCH_SPACE)
    ported = {p for space in at.SEARCH_SPACE.values() for p in space}
    reference = {p for space in jat.SEARCH_SPACE.values() for p in space}
    assert not ported & reference, "the port's parameters have their own names"


def test_json_round_trip_with_the_reference_schema(tmp_path):
    entries = {at.geometry_key("add_matmul", g=4, m=32, k=196, n=32):
               {"tile_m": 32, "tile_n": 32},
               at.geometry_key("linear_attention", g=4, n=196, dk=32, dv=32):
               {"chunk_rows": 128}}
    meta = {"backend": "cpu", "buckets": [1, 8], "measured": False}
    table = at.TuneTable.from_dicts(entries, meta)
    assert table.to_json_dict() == jat.TuneTable.from_dicts(entries, meta).to_json_dict()
    path = tmp_path / "t.json"
    table.save(str(path), report=[{"kernel": "add_matmul"}])
    doc = json.loads(path.read_text())
    assert set(doc) == {"schema", "meta", "entries", "report"}
    back = at.TuneTable.load(str(path))
    assert back == table and hash(back) == hash(table)
    assert back.lookup("add_matmul", g=4, m=32, k=196, n=32) == {"tile_m": 32, "tile_n": 32}
    assert back.lookup("add_matmul", g=4, m=32, k=200, n=32) is None


def test_load_table_fails_open(tmp_path):
    assert at.load_table(str(tmp_path / "missing.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert at.load_table(str(bad)) is None
    bad.write_text(json.dumps({"schema": 2, "entries": {}}))
    assert at.load_table(str(bad)) is None
    bad.write_text(json.dumps({"schema": 1, "entries": {"add_matmul|g=1|k=8|m=8|n=8":
                                                        {"tile_m": 48}}}))
    assert at.load_table(str(bad)) is None, "a tile the kernels were not built for"
    bad.write_text(json.dumps({"schema": 1, "entries": {"add_matmul|g=1|k=8|m=8|n=8":
                                                        {"tile_m": "x"}}}))
    assert at.load_table(str(bad)) is None


def test_a_reference_table_never_selects_a_cuda_launch(tmp_path):
    """A table in the reference's names (bm/bn/bk, chunk) loads, and its
    lookups carry none of the port's parameters: the defaults serve."""
    entries = {jat.geometry_key("add_matmul", g=4, m=32, k=196, n=32):
               {"bm": 32, "bn": 128, "bk": 256},
               jat.geometry_key("linear_attention", g=4, n=196, dk=32, dv=32):
               {"chunk": 64}}
    path = tmp_path / "tpu.json"
    jat.TuneTable.from_dicts(entries).save(str(path))
    table = at.load_table(str(path))
    assert table is not None and len(table) == 2
    for key, params in table.entries:
        kernel = key.split("|")[0]
        assert not {p for p, _ in params} & set(at.SEARCH_SPACE[kernel])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unmeasured_autotune_keys_every_tunable_site(name):
    cfg = ViTConfig(**CONFIGS[name])
    table, report = at.autotune(cfg, buckets=(1, 8, 32), measure=False, device="cpu")
    keys = {at.geometry_key(s["kernel"], **at._site_geometry(s))
            for b in (1, 8, 32) for s in kc.serving_sites(cfg, b)
            if at.SEARCH_SPACE[s["kernel"]]}
    assert {k for k, _ in table.entries} == keys
    for key, params in table.entries:
        assert dict(params) == at.DEFAULTS[key.split("|")[0]]
    meta = table.meta_dict
    assert meta["measured"] is False and "not measured" in meta["reason"]
    assert len(report) == 27
    bidir = [r for r in report if r["kernel"] == "bidir_linear_attention"]
    assert len(bidir) == 3 and all(r["fits"] for r in bidir)
    # The clustered block at every bucket: 128 threads and the slice's ring
    # and sums, one of 7 blocks per batch·head at 196 tokens (1 at 16).
    dh, n = cfg.head_dim, cfg.n_patches
    for r in bidir:
        assert r["smem_bytes"] == tbidir.smem_bytes(dh, dh) and r["threads"] == 128
    assert tbidir.cluster_size(n) == (7 if n == 196 else 1)
    with pytest.raises(ValueError):
        at.autotune(cfg, buckets=(1,), measure=True, device="cpu")


def test_candidates_fit_a_hopper_block():
    spec = kc.serving_sites(ViTConfig(image_size=56), 32)[0]
    cands = at.candidates(spec)
    # 11 tiles; at 6272 x 128 x 128, (16, 256) and (32, 256) launch as
    # (16, 128) and (32, 128), and (64, 128) as (64, 64) to cover the SMs.
    assert len(cands) == 8 and cands[0] == at.DEFAULTS["shift_matmul"]
    assert len({at._launch(spec, c) for c in cands}) == 8
    assert all(kc.block_resources(spec, c)[0] <= kc.SMEM_PER_BLOCK for c in cands)
    causal = dict(kernel="linear_attention", site="causal_attn", g=1, n=8,
                  dk=128, dv=128)
    assert [c["chunk_rows"] for c in at.candidates(causal)] == [256, 64, 128]
    assert [c["chunk_rows"] for c in at.candidates(dict(causal, dk=256))] == [256, 64, 128]
    assert at.candidates(dict(causal, dk=9121)) == [], "no Dv slice fits past Dk 9120"


def _engine_pair():
    cfg = ViTConfig(**SMOKE)
    dense = ShiftAddViT(dataclasses.replace(cfg, policy=DENSE))
    model, params = build_policy_model(cfg, "shiftadd", dense, dense.init(0))
    return cfg, model, with_seeded_router(params, 1)


def test_tuned_cpu_engine_logits_equal_untuned():
    """Every matmul site tuned to a non-default tile: the wrappers check and
    take the table's launch configuration, and the logits keep their bits."""
    cfg, model, params = _engine_pair()
    table, _ = at.autotune(cfg, buckets=(1, 8), measure=False, device="cpu")
    odd = at.TuneTable.from_dicts(
        {k: ({"chunk_rows": 64} if k.startswith("linear") else
             {"tile_m": 64, "tile_n": 32}) for k, _ in table.entries})
    images = torch.randn((5, 16, 16, 3), generator=torch.Generator().manual_seed(3))
    want = BucketedViTEngine(model, params, buckets=(1, 8), device="cpu",
                             impl="cuda").infer(images)
    for tune in (table, odd):
        engine = BucketedViTEngine(model, params, buckets=(1, 8), device="cpu",
                                   impl="cuda", tune=tune)
        assert engine.plan.tune is tune
        assert torch.equal(engine.infer(images), want)


def test_autotune_and_serve_clis_on_cpu(tmp_path, capsys):
    out = tmp_path / "tune.json"
    at_cli.main(["--device", "cpu", "--measure", "off", "--out", str(out),
                 "--image-size", "16", "--layers", "1", "--d-model", "32",
                 "--heads", "2", "--buckets", "1", "8"])
    table = at.load_table(str(out))
    assert table is not None and len(table) == 12
    assert "not measured" in capsys.readouterr().out
    serve_vit.main(["--device", "cpu", "--image-size", "16", "--requests", "2",
                    "--tune", str(out)])
    printed = capsys.readouterr().out
    assert "tuned=True" in printed and "served 2 requests" in printed

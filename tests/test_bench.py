"""bench.py contract: variant registry, row fields, driver format."""

import json
import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

from opencl_montecarlo_path_tracing_tpu.scene.builtin import demo_scene  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_cache_dir():
    """bench.main() turns on the persistent compile cache; keep that from
    leaking into the rest of this test process."""
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_every_variant_has_a_config():
    for v, (size, spp) in bench.STD_CONFIG.items():
        assert size >= 64 and spp >= 1, v
        assert bench.spp_of(v, spp) >= 1, v


def test_make_render_builds_every_variant():
    scene, _ = demo_scene()
    for v in bench.STD_CONFIG:
        fn = bench.make_render(v, scene, 64, 4)
        assert callable(fn), v


ROW_FIELDS = ("metric", "value", "unit", "config", "render_s",
              "first_call_s", "film_mean", "platform", "device_kind",
              "device_count", "card")


def test_bench_one_json_contract():
    """One tiny real measurement (CPU): the emitted record carries the
    throughput and names the device it ran on."""
    scene, tag = demo_scene()
    rec = bench.bench_one("super", scene, tag, 32, 2, repeats=1)
    for field in ROW_FIELDS:
        assert field in rec, field
    assert rec["unit"] == "Mpaths/s"
    assert rec["value"] > 0
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    # value is paths / render_s in Mpaths/s, rounded to 2 decimals
    assert abs(rec["value"] - 32 * 32 * 2 / rec["render_s"] / 1e6) <= 0.0051


def test_default_mode_is_all_with_headline_last():
    """The default must exercise every row and keep the headline super
    row as the LAST line for final-line parsers."""
    assert list(bench.STD_CONFIG)[-1] == "super"
    # the stress rows exist
    assert "super_largemesh" in bench.STD_CONFIG
    assert "bidirectional_dense" in bench.STD_CONFIG


def _fake_row(variant, scene, tag, size, spp, repeats, device=None):
    return {"metric": f"{variant}_pathtracer_throughput", "value": 1.0,
            "unit": "Mpaths/s", "platform": "cpu"}


def test_all_mode_prints_every_row_headline_last(monkeypatch, capsys):
    """main() prints one row per variant, headline last, and exits 0
    when no row crashed."""
    monkeypatch.setattr(bench, "bench_one", _fake_row)
    monkeypatch.setenv("BENCH_VARIANT", "all")
    assert bench.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == len(bench.STD_CONFIG)
    assert json.loads(out[-1])["metric"] == "super_pathtracer_throughput"


def test_all_mode_budget_skips_but_headline_runs(monkeypatch, capsys):
    """With the time budget already spent, non-headline rows must emit
    explicit skipped records (never silently dropped) while the headline
    super row still renders and prints LAST."""
    ran = []

    def fake_bench_one(variant, scene, tag, size, spp, repeats, device=None):
        ran.append(variant)
        return _fake_row(variant, scene, tag, size, spp, repeats)

    monkeypatch.setattr(bench, "bench_one", fake_bench_one)
    monkeypatch.setenv("BENCH_VARIANT", "all")
    monkeypatch.setenv("BENCH_BUDGET_S", "1e-9")
    assert bench.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(l) for l in out]
    assert ran == ["super"]
    assert len(recs) == len(bench.STD_CONFIG)
    assert recs[-1]["metric"] == "super_pathtracer_throughput"
    assert "value" in recs[-1] and "skipped" not in recs[-1]
    skipped = [r for r in recs if r.get("skipped")]
    assert len(skipped) == len(bench.STD_CONFIG) - 1
    assert all("BENCH_BUDGET_S" in r["reason"] for r in skipped)


def test_rows_share_one_device_record(monkeypatch, capsys):
    """main() names the device once and hands that record to every row."""
    seen = []

    def fake(variant, scene, tag, size, spp, repeats, device=None):
        seen.append(device)
        return _fake_row(variant, scene, tag, size, spp, repeats)

    monkeypatch.setattr(bench, "bench_one", fake)
    monkeypatch.setenv("BENCH_VARIANT", "all")
    assert bench.main() == 0
    capsys.readouterr()
    assert len(seen) == len(bench.STD_CONFIG)
    assert all(d == seen[0] for d in seen)
    assert seen[0]["platform"] == "cpu"


def test_all_mode_isolates_row_crashes(monkeypatch, capsys):
    """A row that RAISES must not take down the later rows - the headline
    prints last - but must still fail the run and carry the error."""
    def fake_bench_one(variant, scene, tag, size, spp, repeats, device=None):
        if variant == "simple":
            raise RuntimeError("boom")
        return _fake_row(variant, scene, tag, size, spp, repeats)

    monkeypatch.setattr(bench, "bench_one", fake_bench_one)
    monkeypatch.setenv("BENCH_VARIANT", "all")
    rc = bench.main()
    out = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(l) for l in out]
    assert rc == 1
    assert len(recs) == len(bench.STD_CONFIG)
    assert recs[-1]["metric"] == "super_pathtracer_throughput"
    bad = [r for r in recs if "error" in r]
    assert len(bad) == 1 and "boom" in bad[0]["error"]


def test_bench_multichip_smoke(capsys):
    """The multi-chip scaling harness (tools/bench_multichip.py) runs end
    to end on the virtual CPU mesh and emits well-formed strong/weak rows
    for each device count, with no edits for other hardware."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_multichip
    rc = bench_multichip.main(["--size", "32", "--spp", "8",
                               "--spp-local", "2", "--n-vlp", "16",
                               "--repeats", "1", "--max-devices", "2"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(l) for l in out if l.startswith("{")]
    modes = {(r["mode"], r["variant"], r["n_devices"]) for r in recs}
    assert ("strong", "super", 1) in modes
    assert ("strong", "super", 2) in modes
    assert ("weak", "super", 2) in modes
    assert ("strong", "bidirectional", 2) in modes
    for r in recs:
        assert r["mpaths_per_s"] > 0 and r["ms"] > 0
        assert r["mpaths_per_s_per_chip"] <= r["mpaths_per_s"] + 1e-9
    strong1 = [r for r in recs
               if (r["mode"], r["variant"], r["n_devices"]) ==
               ("strong", "super", 1)]
    assert strong1[0]["speedup_vs_1"] == 1.0

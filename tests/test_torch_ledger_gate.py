"""The port's drift gate and legacy bridge (``arrow_matrix_tpu_torch.
ledger.gate`` and ``.export``) against the JAX package's: the same
baselines, failures and notes on the same records (the planted 10%
regression, the host-load band, degraded and new keys, the curve
cliffs, the lens bands, the xray class band, the committed stores);
a TPU record never bands a card record; ``compose_round`` over a copy
of the committed JAX store gives the JAX export's bytes; ingest and
export write only where they are told; the gate CLI trips on a tampered
chain.  The committed JAX store is read from a copy, never written."""

import copy
import hashlib
import json
import os
import shutil

import pytest
import torch

from arrow_matrix_tpu.ledger import export as jexport
from arrow_matrix_tpu.ledger import gate as jgate
from arrow_matrix_tpu.ledger.store import Ledger as JLedger
from arrow_matrix_tpu_torch.ledger import export as pexport
from arrow_matrix_tpu_torch.ledger import gate as pgate
from arrow_matrix_tpu_torch.ledger.store import (
    DEFAULT_LEDGER_DIR,
    Ledger,
    canonical_record_id,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "bench_results", "ledger")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ledger")
BENCH_R06 = os.path.join(REPO, "BENCH_r06.json")
CARD = "NVIDIA H100 80GB HBM3"


def _digest(directory):
    return {n: hashlib.sha256(open(os.path.join(directory, n), "rb")
                              .read()).hexdigest()
            for n in sorted(os.listdir(directory))
            if not n.endswith(".lock")}


def _bench(lg, value, *, host_load=0.2, metric="t_ms", ts=None,
           payload=None, platform="cpu", device_kind="host"):
    return lg.record("bench", metric, value, unit="ms",
                     structure_hash="s0", platform=platform,
                     device_kind=device_kind, host_load=host_load,
                     git_rev=None, ts_unix=ts, payload=payload or {})


def _curve(lg, dtype, rel, ts, platform="cpu"):
    return lg.record(
        "error_curve", f"error_curve_{dtype}", rel[-1],
        unit="rel_frobenius", structure_hash="s0", platform=platform,
        device_kind="host", host_load=None, git_rev=None, ts_unix=ts,
        knobs={"dtype": dtype, "k": 2, "iterations": len(rel), "seed": 3,
               "emulated": False, "fmt": "fold"},
        payload={"frobenius": rel, "rel_frobenius": rel, "max_abs": rel})


def _xray(lg, metric, value, ts=2000.0):
    return lg.record("xray", metric, value, unit="ms",
                     structure_hash="s0", platform="cpu",
                     device_kind="host", host_load=0.0, git_rev=None,
                     ts_unix=ts, payload={})


def _lens(lg, value, metric, ts):
    return lg.record("lens", metric, value, unit="ratio",
                     structure_hash="s0", platform="gpu",
                     device_kind=CARD, host_load=None, git_rev=None,
                     ts_unix=ts)


def _steady(lg):
    for i, v in enumerate([10.0, 10.05, 9.95, 10.02]):
        _bench(lg, v, ts=1000.0 + i)


# Each scenario fills a store with history and returns the fresh
# records to check against the history's baseline.
def _planted_10pct(lg):
    _steady(lg)
    return [_bench(lg, 11.0, ts=2000.0), _bench(lg, 10.2, ts=2001.0)]


def _loaded_host(lg):
    _steady(lg)
    return [_bench(lg, 13.0, host_load=0.6, ts=2000.0),
            _bench(lg, 13.0, ts=2001.0)]


def _degraded_and_new(lg):
    _steady(lg)
    _bench(lg, 500.0, ts=1500.0, payload={"parsed": {"degraded": True}})
    lg.record("serve", "requests_per_s", 5.0, unit="req/s",
              platform="cpu", host_load=0.2, git_rev=None, ts_unix=999.0)
    return [_bench(lg, 50.0, ts=2000.0,
                   payload={"parsed": {"degraded": True}}),
            _bench(lg, 99.0, metric="never_seen_ms", ts=2001.0),
            lg.record("serve", "requests_per_s", 3.0, unit="req/s",
                      platform="cpu", host_load=0.2, git_rev=None,
                      ts_unix=2002.0)]


def _curve_cliffs(lg):
    _curve(lg, "bf16", [1e-3, 1.5e-3, 2e-3], ts=1000.0)
    _curve(lg, "f32", [0.0, 0.0, 0.0], ts=1001.0)
    return [_curve(lg, "bf16", [1.1e-3, 1.6e-3, 2.1e-3], ts=2000.0),
            _curve(lg, "bf16", [1e-3, 1.5e-3, 5e-2], ts=2001.0),
            _curve(lg, "bf16", [1e-3, 1.5e-3], ts=2002.0),
            _curve(lg, "f32", [0.0, 1e-5, 1e-5], ts=2003.0),
            _curve(lg, "f32", [0.0, 0.0, 0.0], ts=2004.0),
            _curve(lg, "int8", [1e-2], ts=2005.0)]


def _lens_bands(lg):
    _lens(lg, 1.0, "lens_ratio_t0", 1000.0)
    return [_lens(lg, 3.0, "lens_ratio_t0", 2000.0),
            _lens(lg, 1.8, "lens_ratio_t0", 2001.0),
            _lens(lg, 1.2, "lens_ratio_t0", 2002.0),
            _lens(lg, 0.9, "lens_ratio_t9", 2003.0)]


def _xray_classes(lg):
    for i, v in enumerate([10.0, 10.1, 9.9]):
        _xray(lg, "iter_ms_exact", v, ts=1000.0 + i)
    return [_xray(lg, "iter_ms_approx", 12.0, ts=2000.0),
            _xray(lg, "iter_ms_approx", 30.0, ts=2001.0)]


SCENARIOS = {"planted_10pct": _planted_10pct, "loaded_host": _loaded_host,
             "degraded_and_new": _degraded_and_new,
             "curve_cliffs": _curve_cliffs, "lens_bands": _lens_bands,
             "xray_classes": _xray_classes}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_baseline_failures_and_notes_equal_jax(tmp_path, name):
    lg = Ledger(str(tmp_path / "lg"))
    fresh = SCENARIOS[name](lg)
    history = [r for r in lg.read_all()
               if r["record_id"] not in {f["record_id"] for f in fresh}]
    base = pgate.build_baseline(history)
    assert base == jgate.build_baseline(history)
    ours = pgate.check_records(fresh, base)
    assert ours == jgate.check_records(fresh, base)
    failures, notes = ours
    expect = {"planted_10pct": ["perf regression"],
              "loaded_host": ["perf regression"],
              "degraded_and_new": [],
              "curve_cliffs": ["accuracy regression: ", "curve shortened"],
              "lens_bands": ["lens miscalibration", "drifted"],
              "xray_classes": ["class regression"]}[name]
    for word in expect:
        assert any(word in f for f in failures), (word, failures)
    if name == "planted_10pct":
        assert len(failures) == 1           # +2% stays inside the band
    if name == "degraded_and_new":
        assert failures == []
        for word in ("degraded", "new metric key", "unbanded unit"):
            assert any(word in n for n in notes), word


def test_a_tpu_record_never_bands_a_card_record(tmp_path):
    lg = Ledger(str(tmp_path / "lg"))
    for i, v in enumerate([1.0, 1.01, 0.99]):
        _bench(lg, v, ts=1000.0 + i, platform="tpu",
               device_kind="TPU v5 lite")
    base = pgate.build_baseline(lg.read_all())
    card = _bench(lg, 50.0, ts=2000.0, platform="gpu", device_kind=CARD)
    failures, notes = pgate.check_records([card], base)
    assert failures == []
    assert any("new metric key" in n and "|gpu" in n for n in notes)
    assert pgate.baseline_key(card) == "bench|t_ms|s0|gpu"
    # With a card history, the same value is a regression.
    for i, v in enumerate([1.0, 1.01, 0.99]):
        _bench(lg, v, ts=3000.0 + i, platform="gpu", device_kind=CARD)
    base = pgate.build_baseline(
        [r for r in lg.read_all() if r["record_id"] != card["record_id"]])
    failures, _ = pgate.check_records([card], base)
    assert any("perf regression" in f and "|gpu" in f for f in failures)


def test_committed_stores_gate_as_jax(tmp_path):
    copy_dir = str(tmp_path / "committed")
    shutil.copytree(COMMITTED, copy_dir)
    before = _digest(COMMITTED)
    for directory, bpath in (
            (copy_dir, os.path.join(copy_dir, "baseline.json")),
            (FIXTURE, os.path.join(FIXTURE, "baseline.json"))):
        assert pgate.run_gate(directory, bpath) == \
            jgate.run_gate(directory, bpath)
        assert pgate.run_gate(directory, bpath)[0] == 0
        recs = Ledger(directory).read_all()
        assert pgate.build_baseline(recs) == jgate.build_baseline(recs)
    # The fixture's planted 10x regression trips both gates alike.
    baseline = pgate.load_baseline(os.path.join(FIXTURE, "baseline.json"))
    planted = copy.deepcopy(next(r for r in Ledger(FIXTURE).read_all()
                                 if r.get("unit") == "ms"))
    planted["value"] = float(planted["value"]) * 10.0
    planted["record_id"] = canonical_record_id(planted)
    ours = pgate.check_records([planted], baseline)
    assert ours == jgate.check_records([planted], baseline)
    assert any("perf regression" in f for f in ours[0])
    assert _digest(COMMITTED) == before


def test_default_store_is_the_ports(monkeypatch):
    monkeypatch.delenv("AMT_LEDGER_DIR", raising=False)
    assert pgate.baseline_path() == os.path.join(DEFAULT_LEDGER_DIR,
                                                 "baseline.json")
    assert "ledger_torch" in pgate.baseline_path()


def test_gate_cli_trips_on_a_tampered_chain(tmp_path):
    lg = Ledger(str(tmp_path / "lg"))
    _steady(lg)
    assert pgate.main(["--check", "--ledger-dir", lg.directory]) == 0
    assert pgate.main(["--rebaseline", "--ledger-dir", lg.directory]) == 0
    assert pgate.main(["--check", "--ledger-dir", lg.directory]) == 0
    lines = open(lg.path, encoding="utf-8").read().splitlines()
    doctored = json.loads(lines[0])
    doctored["value"] = 0.5
    lines[0] = json.dumps(doctored, separators=(",", ":"))
    with open(lg.path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    assert pgate.main(["--check", "--ledger-dir", lg.directory]) == 1
    assert jgate.main(["--check", "--ledger-dir", lg.directory]) == 1
    assert pgate.main(["--rebaseline", "--ledger-dir", lg.directory]) == 1


def test_compose_round_over_the_committed_store_equals_jax(tmp_path):
    copy_dir = str(tmp_path / "store")
    shutil.copytree(COMMITTED, copy_dir)
    head = json.load(open(BENCH_R06, encoding="utf-8"))[
        "parsed"]["ledger"]["head"]
    for kw in ({}, {"head": head}):
        ours = pexport.compose_round(Ledger(copy_dir), 99, **kw)
        theirs = jexport.compose_round(JLedger(copy_dir), 99, **kw)
        assert ours == theirs
        assert pexport.validate_legacy(ours) == []
    # Written, byte for byte the reference's file.
    ours_path, theirs_path = tmp_path / "ours.json", tmp_path / "theirs.json"
    pexport.export_legacy_round(Ledger(copy_dir), 6, str(ours_path),
                                head=head)
    jexport.export_legacy_round(JLedger(copy_dir), 6, str(theirs_path),
                                head=head)
    assert ours_path.read_bytes() == theirs_path.read_bytes()
    # Regenerating an existing round pins its recorded head.
    again = pexport.export_legacy_round(Ledger(copy_dir), 6,
                                        str(ours_path))
    assert again["parsed"]["ledger"]["head"] == head
    with pytest.raises(ValueError, match="not in the store chain"):
        pexport.compose_round(Ledger(copy_dir), 6, head="nope")
    with pytest.raises(ValueError, match="bench record"):
        pexport.compose_round(Ledger(str(tmp_path / "empty")), 6)


def test_ingest_equals_jax_and_writes_only_the_store(tmp_path):
    rounds = sorted(os.path.join(REPO, f"BENCH_r0{i}.json")
                    for i in range(1, 9))
    rounds = [p for p in rounds if os.path.exists(p)]
    ours, theirs = Ledger(str(tmp_path / "p")), JLedger(str(tmp_path / "j"))
    top = set(os.listdir(REPO))
    assert pexport.ingest_legacy_bench(ours, rounds) == \
        jexport.ingest_legacy_bench(theirs, rounds)
    plans = os.path.join(REPO, "bench_cache", "tune_plans")
    assert pexport.ingest_tune_plans(ours, plans) == \
        jexport.ingest_tune_plans(theirs, plans)
    assert pexport.ingest_tune_plans(ours, str(tmp_path / "none"))[0] == 0

    def content(lg):
        return [{k: v for k, v in r.items()
                 if k not in ("record_id", "prev", "ts_unix", "git_rev")}
                for r in lg.read_all()]

    assert content(ours) == content(theirs)
    assert set(os.listdir(REPO)) == top
    for p in rounds:
        doc = json.load(open(p, encoding="utf-8"))
        assert pexport.validate_legacy(doc) == jexport.validate_legacy(doc)

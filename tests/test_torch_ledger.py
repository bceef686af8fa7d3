"""The port's ledger store (``arrow_matrix_tpu_torch.ledger``) against the
JAX package's: the same records get the same ids and the same bytes on
disk, schema drift and tampering are reported word for word alike, each
package validates the other's store (the committed JAX store read only),
the environment switches behave alike, and concurrent appends keep the
chain whole."""

import copy
import hashlib
import json
import os
import threading

import pytest
import torch

from arrow_matrix_tpu.ledger import store as jstore
from arrow_matrix_tpu_torch.ledger import store as pstore

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "bench_results", "ledger")
PKGS = {"jax": jstore, "port": pstore}

#: Pinned provenance, so both packages hash the same content.
PINNED = dict(host_load=0.25, git_rev="abc1234")


def _fill(mod, directory):
    """Three chained records with pinned provenance and timestamps."""
    lg = mod.Ledger(directory)
    out = [lg.record("bench", "spmm_ms", 1.25, unit="ms",
                     structure_hash="s0", platform="gpu",
                     device_kind="NVIDIA H100 80GB HBM3",
                     knobs={"k": 16, "fmt": "fold"},
                     payload={"note": "x", "runs": [1.0, 2.5]},
                     ts_unix=1000.0, **PINNED)]
    out.append(lg.record("serve", "requests_per_s", 3.5, unit="req/s",
                         ts_unix=1001.5, **PINNED))
    out.append(lg.record("pulse", "pulse_p99_ms", None, unit="ms",
                         payload={"totals": {"completed": 0}},
                         ts_unix=1002.0, **PINNED))
    return lg, out


@pytest.fixture
def stores(tmp_path):
    """The same three records in a JAX store and a port store."""
    return {name: _fill(mod, str(tmp_path / name))
            for name, mod in PKGS.items()}


def test_same_records_same_ids_and_bytes(stores):
    (jlg, jrecs), (plg, precs) = stores["jax"], stores["port"]
    assert [r["record_id"] for r in precs] == \
        [r["record_id"] for r in jrecs]
    assert precs[1]["prev"] == precs[0]["record_id"]
    for rec in precs:
        assert pstore.canonical_record_id(rec) == \
            jstore.canonical_record_id(rec) == rec["record_id"]
    with open(jlg.path, "rb") as a, open(plg.path, "rb") as b:
        assert a.read() == b.read()
    assert plg.validate() == jlg.validate() == []


def _drift_cases(rec):
    out = [rec, "not a dict", {}]
    for field, value in (("kind", "vibes"), ("value", True),
                         ("schema", pstore.SCHEMA_VERSION + 1),
                         ("knobs", []), ("prev", 3), ("ts_unix", None),
                         ("unit", 5), ("platform", None)):
        bad = dict(rec)
        bad[field] = value
        bad["record_id"] = pstore.canonical_record_id(bad)
        out.append(bad)
    for field in ("metric", "payload", "record_id"):
        bad = dict(rec)
        del bad[field]
        out.append(bad)
    return out


def test_schema_problems_agree_on_drift_cases(stores):
    rec = stores["port"][1][0]
    for i, case in enumerate(_drift_cases(rec)):
        assert pstore.schema_problems(case, index=i) == \
            jstore.schema_problems(case, index=i)
    assert pstore.schema_problems(rec) == []
    assert any("unknown kind" in p
               for p in pstore.schema_problems(_drift_cases(rec)[3]))


def _edit(lines):
    doctored = json.loads(lines[0])
    doctored["value"] = 0.5
    lines[0] = json.dumps(doctored, separators=(",", ":"))
    return lines


TAMPER = {
    "edited": _edit,
    "deleted": lambda lines: lines[:1] + lines[2:],
    "reordered": lambda lines: [lines[1], lines[0], lines[2]],
    "torn": lambda lines: lines + ['{"schema": 1, "kind": "ben'],
    "garbage": lambda lines: ["garbage"] + lines,
}


@pytest.mark.parametrize("how", sorted(TAMPER))
def test_tampering_is_found_the_same_way(stores, how):
    problems = {}
    for name, (lg, _) in stores.items():
        with open(lg.path, encoding="utf-8") as fh:
            lines = TAMPER[how](fh.read().splitlines())
        with open(lg.path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + ("" if how == "torn" else "\n"))
        problems[name] = lg.validate()
        assert problems[name], how
    assert problems["port"] == problems["jax"]
    assert pstore.Ledger(os.path.dirname(stores["port"][0].path)
                         ).read_all() == stores["jax"][0].read_all()


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def test_port_validates_the_committed_jax_store_read_only():
    path = os.path.join(COMMITTED, pstore.LEDGER_BASENAME)
    before = (_sha(path), os.stat(path).st_mtime_ns)
    port, jax = pstore.Ledger(COMMITTED), jstore.Ledger(COMMITTED)
    assert port.validate() == jax.validate() == []
    assert port.read_all() == jax.read_all()
    assert len(port.read_all()) > 0
    assert port.query(kind="error_curve") == jax.query(kind="error_curve")
    assert (_sha(path), os.stat(path).st_mtime_ns) == before


def test_jax_validates_a_store_the_port_wrote(tmp_path):
    lg = pstore.Ledger(str(tmp_path))
    stamp = pstore.device_stamp("cpu")
    assert stamp == {"platform": "cpu", "device_kind": "cpu"}
    for i in range(4):
        lg.record("smoke", f"m{i}", float(i), unit="ms",
                  knobs={"i": i}, **stamp)
    assert jstore.Ledger(str(tmp_path)).validate() == []
    assert jstore.Ledger(str(tmp_path)).read_all() == lg.read_all()
    assert jstore.records_from([lg.path]) == pstore.records_from([lg.path])


def test_refused_records_are_not_appended(tmp_path):
    for mod in PKGS.values():
        lg = mod.Ledger(str(tmp_path / mod.__name__))
        with pytest.raises(ValueError):
            lg.record("vibes", "m", 1.0)
        with pytest.raises(TypeError):
            lg.record("bench", "m", 1.0, knobs={"x": object()})
        assert lg.read_all() == []


def test_environment_switches_behave_alike(tmp_path, monkeypatch):
    assert pstore.DEFAULT_LEDGER_DIR != jstore.DEFAULT_LEDGER_DIR
    assert pstore.DEFAULT_LEDGER_DIR == os.path.join("bench_results",
                                                     "ledger_torch")
    monkeypatch.delenv("AMT_LEDGER_DIR", raising=False)
    assert pstore.ledger_dir() == pstore.DEFAULT_LEDGER_DIR
    monkeypatch.setenv("AMT_LEDGER_DIR", str(tmp_path / "env"))
    for mod in PKGS.values():
        assert mod.ledger_dir() == str(tmp_path / "env")
        assert mod.ledger_dir("explicit") == "explicit"
        assert mod.ledger_path() == os.path.join(str(tmp_path / "env"),
                                                 "ledger.jsonl")
    monkeypatch.setenv("AMT_LEDGER", "0")
    for mod in PKGS.values():
        assert mod.record("bench", "m", 1.0) is None
    assert not os.path.exists(str(tmp_path / "env"))
    monkeypatch.delenv("AMT_LEDGER")
    got = {name: mod.record("bench", "m", 1.0, directory=str(tmp_path / name),
                            ts_unix=5.0, **PINNED)
           for name, mod in PKGS.items()}
    assert got["port"] == got["jax"]
    # the env directory is used when no directory is given
    rec = pstore.record("bench", "m2", 2.0, **PINNED)
    assert pstore.Ledger(str(tmp_path / "env")).read_all() == [rec]
    # a failed append is reported and returns None, never raises
    assert pstore.record("vibes", "m", 1.0, **PINNED) is None


def test_bench_metric_matches():
    for cfg in (None, {}, {"n": 1 << 20, "width": 2048}, {"n": 4}):
        assert pstore.bench_metric("spmm_iter_ms", cfg) == \
            jstore.bench_metric("spmm_iter_ms", cfg)


def test_concurrent_records_keep_the_chain_valid(tmp_path):
    """The read-prev and the append are one critical section under the
    file lock: concurrent recorders leave a fully linked chain."""
    lg = pstore.Ledger(str(tmp_path))
    writers, rows = 6, 5
    errors = []

    def write(i):
        try:
            for j in range(rows):
                lg.record("probe", f"writer{i}_ms", float(j), unit="ms",
                          host_load=0.0, git_rev=None)
        except Exception as e:    # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=write, args=(i,))
               for i in range(writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert lg.validate() == []
    assert jstore.Ledger(str(tmp_path)).validate() == []
    recs = lg.read_all()
    assert len(recs) == writers * rows
    for i in range(writers):
        assert sum(r["metric"] == f"writer{i}_ms" for r in recs) == rows


def test_host_load_and_git_rev_default_to_live_lookups(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("AMT_GIT_REV", "feedbee")
    rec = pstore.Ledger(str(tmp_path)).record("bench", "m", 1.0)
    assert rec["git_rev"] == "feedbee"
    assert isinstance(rec["host_load"], float)
    monkeypatch.setenv("AMT_GIT_REV", "")
    rec = pstore.Ledger(str(tmp_path)).record("bench", "m", 1.0)
    assert rec["git_rev"] is None
    assert copy.deepcopy(rec) == pstore.Ledger(str(tmp_path)).last_record()

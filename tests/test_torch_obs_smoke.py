"""The port's smoke run and ``graft_trace`` (``obs/smoke.py``,
``obs/__main__.py``) against the JAX package's.

The counterparts of the smoke and CLI cases of ``tests/test_obs.py``:
one reduced-scale run of the five algorithms on 4 gloo ranks on the CPU
(``run_smoke(n=128, width=32, k=4, n_dev=4, iters=2)``), shared by the
artifact checks; the JAX smoke at the same scale on the conftest's
virtual CPU devices, whose ``ideal_bytes`` and imbalance block the
port's must equal; and each package's ``summarize`` reading the other's
run directory.
"""

import json
import os
import sys

import pytest

from arrow_matrix_tpu.obs.__main__ import main as jax_trace_main
from arrow_matrix_tpu.obs.smoke import run_smoke as jax_run_smoke
from arrow_matrix_tpu_torch.obs.__main__ import _diff_records
from arrow_matrix_tpu_torch.obs.__main__ import main as trace_main
from arrow_matrix_tpu_torch.obs.smoke import ALGORITHMS, validate_run_dir
from arrow_matrix_tpu_torch.parallel.launch import RankPool

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_baseline_jobs"
SCALE = dict(n=128, width=32, k=4, iters=2)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("obs_run_torch"))
    with RankPool(4, device="cpu", timeout_s=60) as pool:
        summaries = pool.run(JOBS, "smoke", run_dir, SCALE,
                             job_timeout_s=300)
    return run_dir, summaries[0]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("obs_run_jax"))
    return run_dir, jax_run_smoke(run_dir, n_dev=4, **SCALE)


def test_smoke_run_valid_and_complete(smoke_run):
    run_dir, summary = smoke_run
    assert validate_run_dir(run_dir) == []
    assert set(summary["algorithms"]) == set(ALGORITHMS)
    on_disk = json.load(open(os.path.join(run_dir, "summary.json"),
                             encoding="utf-8"))
    assert set(on_disk["algorithms"]) == set(ALGORITHMS)
    assert on_disk["ledger_record_id"]
    for name, rec in summary["algorithms"].items():
        assert len(rec["steps_ms"]) == 2
        assert rec["measured_bytes"] >= 0
        assert rec["comm_source"] == "counted"
        # Every algorithm has a paper cost model: a ratio exists.
        assert rec["ideal_bytes"] and rec["bytes_vs_ideal"] is not None
        # Perfetto nesting: the per-step spans inside iterate.
        trace = json.load(open(os.path.join(run_dir, rec["trace"]),
                               encoding="utf-8"))
        spans = {e["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "X"}
        assert {f"{name}/iterate", f"{name}/step"} <= spans


def test_ideal_bytes_and_imbalance_match_jax(smoke_run, jax_run):
    """The same executors at the same seeds and meshes: each algorithm's
    paper-model bytes and its imbalance block equal the JAX smoke's."""
    ours = smoke_run[1]["algorithms"]
    theirs = jax_run[1]["algorithms"]
    assert set(ours) == set(theirs)
    for name in ALGORITHMS:
        assert ours[name]["ideal_bytes"] == theirs[name]["ideal_bytes"], name
        assert ours[name]["repl"] == theirs[name]["repl"], name
        a, b = ours[name]["imbalance"], theirs[name]["imbalance"]
        assert set(a) == set(b), name
        for key, v in b.items():
            if isinstance(v, float):
                assert a[key] == pytest.approx(v), (name, key)
            else:
                assert a[key] == v, (name, key)


def test_summarize_reads_either_packages_run_dir(smoke_run, jax_run,
                                                 capsys):
    for main, run in ((trace_main, jax_run[0]),
                      (jax_trace_main, smoke_run[0])):
        assert main(["summarize", run]) == 0
        out = capsys.readouterr().out
        for name in ALGORITHMS:
            assert name in out


def test_graft_trace_summarize_and_export(smoke_run, tmp_path, capsys):
    run_dir, _ = smoke_run
    assert trace_main(["summarize", run_dir]) == 0
    out = capsys.readouterr().out
    for name in ALGORITHMS:
        assert name in out

    merged = str(tmp_path / "merged.json")
    assert trace_main(["export", run_dir, "--out", merged]) == 0
    trace = json.load(open(merged, encoding="utf-8"))
    pids = {e["pid"] for e in trace["traceEvents"]}
    assert len(pids) == len(ALGORITHMS)    # one pid per algorithm


def test_graft_trace_memreport_on_the_cpu(smoke_run, capsys):
    run_dir, _ = smoke_run
    assert trace_main(["memreport", run_dir, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ALGORITHMS:
        assert f"== {name} ==" in out
    assert "largest 2.5D replication fitting budget" in out


def test_graft_trace_diff_identical_runs_clean(smoke_run):
    run_dir, _ = smoke_run
    assert trace_main(["diff", run_dir, run_dir]) == 0


def _write_summary(path, step_ms, phase_ms, measured=1000):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "summary.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"scale": {}, "algorithms": {
            "algo": {"step_ms_mean": step_ms, "measured_bytes": measured,
                     "phase_ms": {"algo/iterate": phase_ms}}}}, fh)


def test_graft_trace_diff_flags_regression(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_summary(a, step_ms=1.0, phase_ms=10.0)
    _write_summary(b, step_ms=2.0, phase_ms=25.0)
    assert trace_main(["diff", a, b, "--threshold", "0.2"]) == 1
    assert "REGRESSED" in capsys.readouterr().out
    # The same delta under a permissive threshold passes.
    assert trace_main(["diff", a, b, "--threshold", "2.0"]) == 0


def test_diff_records_noise_floor_and_missing_algorithm():
    a = {"algo": {"step_ms_mean": 0.010, "measured_bytes": 10,
                  "phase_ms": {}}}
    # +100% relative but only +0.01 ms absolute: under the noise floor.
    b = {"algo": {"step_ms_mean": 0.020, "measured_bytes": 10,
                  "phase_ms": {}}}
    rows = _diff_records(a, b, threshold=0.2, min_delta_ms=0.1)
    assert not any(r["regressed"] for r in rows)
    # Bytes have no noise floor: +100% regresses.
    b2 = {"algo": {"step_ms_mean": 0.010, "measured_bytes": 20,
                   "phase_ms": {}}}
    rows = _diff_records(a, b2, threshold=0.2, min_delta_ms=0.1)
    assert any(r["quantity"] == "measured_bytes" and r["regressed"]
               for r in rows)
    # An algorithm missing from B is itself a regression.
    rows = _diff_records(a, {}, threshold=0.2, min_delta_ms=0.1)
    assert any(r["quantity"] == "presence" and r["regressed"]
               for r in rows)


def test_blackbox_reads_a_flight_artifact(tmp_path, capsys):
    from arrow_matrix_tpu_torch.obs import flight

    rec = flight.FlightRecorder(str(tmp_path / "flight.json"))
    rec.record("span", "smoke/step", ms=1.5)
    rec.seal("test")
    assert trace_main(["blackbox", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "smoke/step" in out
    assert trace_main(["blackbox", str(tmp_path / "nothing")]) == 1

"""The port's protocol bench (``python -m arrow_matrix_tpu_torch.bench``)
on the CPU: its one-line contract, its device rule, its configuration
against the root ``bench.py``'s, its bytes bound, its cache key, and the
host modules it reads (artifacts, logging, host load) against the JAX
package's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arrow_matrix_tpu_torch import bench
from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.tools import gather_probe
from arrow_matrix_tpu_torch.utils import barabasi_albert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _bench(tmp_path, args, **env):
    full = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                AMT_BENCH_CACHE_DIR=str(tmp_path / "cache"), **env)
    proc = subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.bench", *args],
        cwd=tmp_path, env=full, capture_output=True, text=True, timeout=300)
    last = proc.stdout.strip().splitlines()[-1]
    return proc, json.loads(last)


def test_cpu_run_prints_one_gated_contract_line(tmp_path):
    proc, line = _bench(tmp_path, ["--device", "cpu"], AMT_BENCH_N="8192",
                        AMT_BENCH_FMT="fold,hyb", AMT_BENCH_K128="0")
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip().splitlines()) == 1
    assert line["metric"] == "spmm_iter_ms" and line["unit"] == "ms"
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["frobenius_err_vs_cpu"] <= line["frobenius_gate"]
    assert line["platform"] == "cpu" and line["degraded"] is True
    assert line["card"] is None and "roofline_frac" not in line
    assert line["fmt_used"] in ("fold", "hyb")
    assert set(line["device_runs"]) == {"fold", "hyb"}
    assert line["vs_baseline"] > 0 and line["scipy_cpu_ms"] > 0
    cfg = line["config"]
    assert cfg["n"] == 8192 and cfg["features"] == 16
    assert cfg["decompose_backend"] in ("native", "numpy")
    assert cfg["levels"] >= 1 and cfg["edges_nnz"] > 0
    assert "k128_ms" not in line and "host_load" in line


def test_no_card_and_no_cpu_flag_is_an_error_line(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc, line = _bench(tmp_path, [])
    assert proc.returncode != 0
    assert line["value"] is None and "no card answers" in line["error"]
    assert "--device cpu" in line["error"]


def test_a_race_where_every_candidate_fails_exits_nonzero(tmp_path):
    proc, line = _bench(tmp_path, ["--device", "cpu"], AMT_BENCH_N="4096",
                        AMT_BENCH_FMT="nosuch")
    assert proc.returncode != 0
    assert line["value"] is None
    assert "every config failed" in line["error"]
    assert "unknown fmt" in line["device_runs"]["nosuch"]["error"]


@pytest.mark.parametrize("env", [{}, {"AMT_BENCH_N": "4096"},
                                 {"AMT_BENCH_SMALL": "1"},
                                 {"AMT_BENCH_FULL": "1"},
                                 {"AMT_BENCH_FMT": "fold,hyb",
                                  "AMT_BENCH_LEVELS": "3",
                                  "AMT_BENCH_K128": "1"}])
def test_config_agrees_with_the_root_bench(monkeypatch, env):
    monkeypatch.syspath_prepend(REPO)
    import bench as root_bench

    for key in list(os.environ):
        if key.startswith("AMT_BENCH_"):
            monkeypatch.delenv(key)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for ours_p, theirs_p in (("cuda", "tpu"), ("cpu", "cpu")):
        ours = bench._bench_config(ours_p)
        theirs = root_bench._bench_config(theirs_p)
        assert ours.pop("platform") == ours_p
        theirs.pop("platform")
        assert ours == theirs
    monkeypatch.setenv("AMT_BENCH_REPL", "2")
    monkeypatch.setenv("AMT_BENCH_OVERLAP_SLABS", "2")
    ours, theirs = bench._bench_config("cuda"), root_bench._bench_config(
        "tpu")
    assert (ours["repl"], ours["overlap_slabs"]) == (2, 2)
    assert (theirs["repl"], theirs["overlap_slabs"]) == (2, 2)


def test_cpu_run_with_a_column_schedule_writes_it_on_the_line(tmp_path):
    proc, line = _bench(tmp_path, ["--device", "cpu"], AMT_BENCH_N="4096",
                        AMT_BENCH_FMT="fold,hyb", AMT_BENCH_K128="0",
                        AMT_BENCH_REPL="2", AMT_BENCH_OVERLAP_SLABS="2")
    assert proc.returncode == 0, proc.stderr
    assert line["repl"] == 2 and line["overlap_slabs"] == 2
    assert line["frobenius_err_vs_cpu"] <= line["frobenius_gate"]
    runs = line["device_runs"]
    assert (runs["fold"]["repl"], runs["fold"]["overlap_slabs"]) == (2, 2)
    # repl is a fold schedule: the hyb candidate takes the slabs alone.
    assert "repl" not in runs["hyb"] and runs["hyb"]["overlap_slabs"] == 2


def test_the_column_schedule_sweep_flags_measure_each_point(tmp_path):
    """``--overlap_slabs`` and ``--repl`` (the root bench's sweeps): the
    winner again at each S, the fold at each c, each point gated, and
    the points the width cannot take named."""
    proc, line = _bench(tmp_path, ["--device", "cpu", "--overlap_slabs",
                                   "1,2,3,x", "--repl", "2"],
                        AMT_BENCH_N="2048", AMT_BENCH_FMT="hyb",
                        AMT_BENCH_K128="0")
    assert proc.returncode == 0, proc.stderr
    over, repl = line["overlap_sweep"], line["repl_sweep"]
    assert over["fmt"] == "hyb" and repl["fmt"] == "fold"
    for point in (over["1"], over["2"], repl["2"]):
        assert point["ms"] > 0 and point["err"] <= line["frobenius_gate"]
        assert "gate_missed" not in point
    assert over["3"] == {"error": "S=3 does not divide k=16"}
    assert over["x"] == {"error": "not a positive integer"}


def test_the_sweep_env_names_the_root_benchs(monkeypatch):
    from arrow_matrix_tpu_torch import bench as pbench

    calls = []
    monkeypatch.setattr(pbench, "_spawn_candidate",
                        lambda fmt, cfg, timeout_s: calls.append(
                            (fmt, cfg["overlap_slabs"], cfg["repl"]))
                        or {"ms": 1.0, "err": 1.0})
    monkeypatch.setenv("AMT_BENCH_OVERLAP_SWEEP", "4")
    monkeypatch.setenv("AMT_BENCH_REPL_SWEEP", "2,5")
    result = {"fmt_used": "hyb"}
    cfg = {"k": 16, "platform": "cpu", "overlap_slabs": 1, "repl": 1}
    pbench.column_sweeps(result, cfg, tol=0.5)
    assert calls == [("hyb", 4, 1), ("fold", 1, 2)]
    assert result["overlap_sweep"]["4"]["gate_missed"] == 0.5
    assert result["repl_sweep"]["5"] == {"error": "c=5 does not divide "
                                                  "k=16"}
    root = open(os.path.join(REPO, "bench.py")).read()
    assert '"AMT_BENCH_OVERLAP_SWEEP"' in root and \
        '"AMT_BENCH_REPL_SWEEP"' in root


@pytest.fixture(scope="module")
def tiny_levels():
    a = barabasi_albert(500, 3, seed=4)
    return arrow_decomposition(a, 64, max_levels=4, block_diagonal=True,
                               seed=2)


@pytest.mark.parametrize("k", [16, 128])
def test_bytes_bound_of_a_tiny_fold_and_hyb_by_hand(tiny_levels, k):
    n = 500
    nnz = [int(lvl.matrix.nnz) for lvl in tiny_levels]
    fold = MultiLevelArrow(tiny_levels, 64, fmt="fold", device="cpu")
    assert fold.binary
    # One 4-byte index per nonzero; X read once, the output written once.
    assert bench.min_bytes_per_iter(fold, tiny_levels, k) == \
        4 * sum(nnz) + 2 * n * k * 4
    hyb = MultiLevelArrow(tiny_levels, 64, fmt="hyb", device="cpu")
    rows = hyb.total_rows
    pairs = len(tiny_levels) - 1
    # Per level: its nonzeros' indices, X once, output once; per pair of
    # levels: a gather (rows read, rows written, indices) and a
    # gather-add (the same, plus its base read).
    want = (4 * sum(nnz) + len(nnz) * 2 * n * k * 4
            + pairs * ((2 * rows * k * 4 + 4 * rows)
                       + (3 * rows * k * 4 + 4 * rows)))
    assert bench.min_bytes_per_iter(hyb, tiny_levels, k) == want
    # Never more than what the executor holds plus one input and output:
    # the bound is at most the bytes a step touches.
    held = fold.sell.device_nbytes() + 2 * fold.total_rows * k * 4
    assert bench.min_bytes_per_iter(fold, tiny_levels, k) <= held


def test_roofline_is_at_most_one_by_construction():
    # At the bound's own time the fraction is 1; any slower run is less.
    by = 1 << 30
    peak = bench.peak_bytes_s("NVIDIA H100 80GB HBM3")
    assert peak == 3.35e12
    assert by / (by / peak) / peak == pytest.approx(1.0)
    assert bench.peak_bytes_s("Some Other Card") is None
    assert bench.peak_bytes_s("host") is None


def test_cache_key_separates_the_backends(tmp_path):
    args = (1 << 10, 3, 64, 1, 4)
    numpy_base = gather_probe.cache_base(*args, "numpy", str(tmp_path))
    native_base = gather_probe.cache_base(*args, "native", str(tmp_path))
    assert numpy_base != native_base
    assert numpy_base.endswith("ba_1024_3_w64_s1_L4_numpy")
    assert gather_probe.cache_base(*args, "auto", str(tmp_path)) in (
        numpy_base, native_base)
    a = gather_probe.cached_levels(1 << 10, 3, 64, seed=1, max_levels=4,
                                   cache_dir=str(tmp_path), backend="numpy")
    b = gather_probe.cached_levels(1 << 10, 3, 64, seed=1, max_levels=4,
                                   cache_dir=str(tmp_path), backend="native")
    assert os.path.exists(numpy_base + ".complete")
    assert os.path.exists(native_base + ".complete")
    # Two random forests: a numpy artifact never stands in for native.
    assert any(not np.array_equal(x.permutation, y.permutation)
               for x, y in zip(a, b))


def test_artifacts_behave_as_jax(tmp_path):
    from arrow_matrix_tpu.utils import artifacts as jax_art
    from arrow_matrix_tpu_torch.utils import artifacts as art

    texts = ["", "chatter\n{\"a\": 1}\n", "[1, 2]", "{\"x\": 2}\nnot json",
             "  \n{\"v\": null}  \n"]
    for t in texts:
        assert art.parse_last_json_line(t) == jax_art.parse_last_json_line(t)
    for rec in ({}, {"platform": "cpu"}, {"platform": "cuda"},
                {"platform": "gpu"}, {"platform": "cuda", "degraded": True},
                {"platform": "tpu"}):
        assert art.record_is_onchip(rec) == jax_art.record_is_onchip(rec)
    assert art.record_is_onchip({"platform": "cuda"})
    assert art.record_is_onchip({"platform": "gpu"})
    for name in ("onchip_VERIFYDRIVE.json", "onchip_x.json", "a_dryrun.json"):
        assert (art.is_stray_verification_artifact(name)
                == jax_art.is_stray_verification_artifact(name))
    for mod, side in ((art, "ours"), (jax_art, "theirs")):
        d = tmp_path / side
        mod.atomic_write_json(str(d / "rec.json"), {"platform": "cuda"},
                              indent=1, sort_keys=True)
        mod.append_jsonl(str(d / "log.jsonl"), {"i": 1})
        mod.append_jsonl(str(d / "log.jsonl"), {"i": 2}, lock=False)
        with mod.locked_file(str(d / "log.jsonl")):
            pass
        with open(d / "lockme", "w") as fh:
            assert mod.flock_acquire(fh, nonblocking=True)
        (d / "cpu.json").write_text('{"platform": "cpu"}\n')
        (d / "bad.json").write_text("nope")
    for name in ("rec.json", "log.jsonl"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "theirs" / name).read_bytes()
    for name in ("rec.json", "cpu.json", "bad.json", "missing.json"):
        assert art.classify_artifact(str(tmp_path / "ours" / name)) == \
            jax_art.classify_artifact(str(tmp_path / "theirs" / name))
    assert art.load_last_json_line(str(tmp_path / "ours" / "log.jsonl")) \
        == {"i": 2}


def test_logging_and_host_load_behave_as_jax(tmp_path):
    from arrow_matrix_tpu.utils import logging as jax_wb
    from arrow_matrix_tpu.utils.platform import host_load as jax_host_load
    from arrow_matrix_tpu_torch.utils import logging as wb
    from arrow_matrix_tpu_torch.utils.platform import host_load

    logs = []
    for mod in (wb, jax_wb):
        seg = mod.init("bench", "ba", config={"n": 4})
        mod.set_iteration_data({"iteration": 3})
        mod.log({"spmm_time": 0.5})
        with pytest.raises(RuntimeError):
            with mod.segment("failing"):
                raise RuntimeError("boom")
        logs.append(seg)
        s = mod.get_log().summarize()
        assert s["spmm_time"] == {"mean": 0.5, "min": 0.5, "max": 0.5,
                                  "count": 1}
        assert "failing" in s
    ours, theirs = logs
    assert [sorted(e) for e in ours.entries] == \
        [sorted(e) for e in theirs.entries]
    base = ours.finish(str(tmp_path / "logs"))
    with open(base + ".json") as fh:
        assert json.load(fh)["config"] == {"n": 4}
    assert wb.log_local_runs(str(tmp_path / "logs")) == \
        jax_wb.log_local_runs(str(tmp_path / "logs"))
    x = torch.ones(3)
    assert wb.block_until_ready(x) is x
    assert wb.block_until_ready((x, 1))[1] == 1
    with wb.trace(str(tmp_path / "traces"), device="cpu") as prof:
        with wb.segment("traced"):
            torch.ones(8) @ torch.ones(8)
    assert os.path.isfile(prof.path) and prof.kernels == []
    ours, theirs = host_load(), jax_host_load()
    assert set(ours) == set(theirs) == {"loadavg_1m", "competing"}
    assert isinstance(ours["loadavg_1m"], float)
    assert isinstance(ours["competing"], list)
    assert len(host_load(max_pids=1)["competing"]) <= 1


# ---------------------------------------------------------------------------
# The ledger record, the prior on-card capture, the flight recorders
# ---------------------------------------------------------------------------

def test_the_runs_record_lands_in_the_ledger_dir(tmp_path):
    from arrow_matrix_tpu_torch.ledger import Ledger

    store = tmp_path / "ledger"
    proc, line = _bench(tmp_path, ["--device", "cpu"], AMT_BENCH_N="4096",
                        AMT_BENCH_FMT="fold", AMT_BENCH_K128="0",
                        AMT_LEDGER_DIR=str(store))
    assert proc.returncode == 0, proc.stderr
    lg = Ledger(str(store))
    assert lg.validate() == []
    (rec,) = lg.read_all()
    assert rec["kind"] == "bench"
    assert rec["metric"] == "spmm_iter_ms_n4096_w2048"
    assert rec["value"] == line["value"] and rec["unit"] == "ms"
    assert (rec["platform"], rec["device_kind"]) == ("cpu", "host")
    assert rec["payload"]["parsed"] == line
    assert rec["knobs"]["fmt_used"] == line["fmt_used"]
    # Each candidate subprocess left its flight recorder behind.
    flight = json.loads((tmp_path / "cache" / "flight" /
                         "candidate_fold.json").read_text())
    assert any("candidate start" in str(ev.get("name"))
               for ev in flight.get("events", []))


def _capture(path, **fields):
    rec = {"metric": "spmm_iter_ms", "value": 0.34, "unit": "ms",
           "config": {"n": 1 << 20, "width": 2048, "features": 16,
                      "iterations": 10, "levels": 10, "decompose_s": 1.0},
           **fields}
    path.write_text("progress\n" + json.dumps(rec) + "\n")
    return rec


def test_last_onchip_evidence_takes_only_a_card_record(tmp_path,
                                                       monkeypatch):
    committed = [os.path.join(REPO, "bench_results", n)
                 for n in ("onchip_r3_full.json", "onchip_r3_foldonly.json")]
    from arrow_matrix_tpu_torch.utils.artifacts import (
        load_last_json_line,
        record_is_onchip,
    )

    for p in committed:
        rec = load_last_json_line(p)
        # The committed captures are the JAX package's TPU records, which
        # the shared predicate accepts.
        assert rec["platform"] == "tpu" and record_is_onchip(rec)
    monkeypatch.setenv("AMT_BENCH_CACHE_DIR", str(tmp_path))
    assert bench._last_onchip_evidence() is None
    for name, fields in (("onchip_a.json", {"platform": "tpu"}),
                         ("onchip_b.json", {"platform": "cuda"}),
                         ("onchip_c.json", {"platform": "gpu",
                                            "degraded": True}),
                         ("onchip_VERIFYDRIVE.json", {"platform": "gpu"})):
        _capture(tmp_path / name, **fields)
    assert bench._last_onchip_evidence() is None
    want = _capture(tmp_path / "onchip_card.json", platform="gpu",
                    device_kind="NVIDIA H100 80GB HBM3", k128_ms=2.75)
    ev = bench._last_onchip_evidence()
    assert ev["path"] == str(tmp_path / "onchip_card.json")
    assert ev["summary"]["platform"] == "gpu"
    assert ev["summary"]["value"] == want["value"]
    assert ev["summary"]["k128_ms"] == 2.75
    assert "decompose_s" not in ev["summary"]["config"]
    assert "prior run" in ev["note"]


def test_a_timed_out_candidate_names_its_flight_recorder(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("AMT_FLIGHT_DIR", str(tmp_path))
    cfg = {"k128_run": True}
    assert bench._flight_path(bench._candidate_flight_name("fold", cfg)) \
        == str(tmp_path / "candidate_fold_k128.json")

    def hang(*a, **kw):
        raise subprocess.TimeoutExpired("bench", 1.0)

    monkeypatch.setattr(bench.subprocess, "run", hang)
    err = bench._spawn_candidate("fold", {}, 1.0)
    assert err["timed_out"] and "flight" not in err
    (tmp_path / "candidate_fold.json").write_text("{}")
    err = bench._spawn_candidate("fold", {}, 1.0)
    assert err["flight"] == str(tmp_path / "candidate_fold.json")

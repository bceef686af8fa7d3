"""The port's copies of the reference's last gates and CLIs on the CPU
(``--device cpu``): the chaos and serve gates run the JAX package's
scenarios under its names with no problem; the obs gate's validators
give the JAX validators' verdicts on the summaries the JAX tests plant;
the kernel gate trips on planted kernel files and its selftest and
fixtures pass; ``comm_report``'s bytes are ``commstats``' for each mode;
``log_upload`` lists the runs each package's ``spmm_arrow --logdir``
writes."""

import ast
import copy
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.tools import (
    chaos_gate,
    comm_report,
    kernel_gate,
    obs_gate,
    serve_gate,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_mesh_jobs"

#: The JAX chaos gate's fast list, as ``tests/test_faults.py`` asserts it.
JAX_CHAOS_FAST = ["nan", "hang", "corrupt", "sync", "kcert", "lens",
                  "synth", "host_kill", "serve_hang", "serve_corrupt",
                  "serve_overflow", "serve_hbm", "slo_burn_degrade",
                  "serve_classes", "reshard_h7"]


def _jax_serve_scenarios():
    """The scenario list the JAX ``run_serve_scenarios`` builds, read off
    its source (running it would run the JAX gate)."""
    path = os.path.join(REPO, "tools", "serve_gate.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_serve_scenarios")
    names = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "scenarios":
            names = [e.value for e in node.value.elts]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "append"
              and getattr(node.func.value, "id", None) == "scenarios"):
            late = node.args[0].value
    return names, late


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=60, threads=1) as pool:
        yield pool


def test_chaos_gate_fast_runs_the_jax_list_clean(tmp_path):
    problems, scenarios = chaos_gate.run_gate(str(tmp_path), fast=True,
                                              device="cpu")
    assert problems == []
    assert scenarios == JAX_CHAOS_FAST
    # The mesh scenarios' ranks each kept a flight ring.
    assert len(list(tmp_path.glob("flight_rank*.json"))) == \
        chaos_gate.RANKS


@pytest.mark.slow
def test_chaos_gate_full(tmp_path):
    """The subprocess scenarios too: SIGKILL and resume of the batch CLI
    (plain and replicated), of the server, of the fleet, mid-migration."""
    problems, scenarios = chaos_gate.run_gate(str(tmp_path), fast=False,
                                              device="cpu")
    assert problems == []
    for name in ("kill", "kill_repl", "serve_kill", "fleet_kill",
                 "xray_kill", "kill_mid_migration"):
        assert name in scenarios


def test_serve_gate_names_are_the_jax_gates_and_main_passes(tmp_path):
    names, late = _jax_serve_scenarios()
    assert list(serve_gate.SCENARIOS) == names and late == "serve_kill"
    assert (serve_gate.N, serve_gate.WIDTH, serve_gate.K, serve_gate.SEED,
            serve_gate.REQUESTS, serve_gate.ITERS) == (128, 16, 2, 11, 8, 4)
    assert serve_gate.main(["--fast", "--device", "cpu",
                            str(tmp_path)]) == 0
    assert json.loads((tmp_path / "flight.json").read_text())


@pytest.fixture(scope="module")
def jax_obs_gate():
    sys.path.insert(0, REPO)
    return importlib.import_module("tools.obs_gate")


def _profile(family="xla:tail", full_ms=0.1, ms=0.06, **drop):
    tier = {"tier": 0, "family": family, "rows": 10, "nnz": 40,
            "slots": 48, "slot_width": 4, "padded_slots": 8,
            "streamed_bytes": 1024, "measured_ms": ms}
    for key in drop:
        del tier[key]
    return {"schema": 1, "kind": "lens_profile", "structure_hash": "h",
            "kernel": family.split(":")[0],
            "dtypes": {"f32": {"full_ms": full_ms, "tiers": [tier],
                               "attributed_ms": ms,
                               "coverage": ms / full_ms if full_ms
                               else 0.0}}}


def test_obs_validators_flag_the_jax_planted_summaries(jax_obs_gate):
    """Each validator of the port's obs gate gives the JAX gate's
    verdict, word for word, on the summaries ``tests/test_lens.py`` and
    ``tests/test_repl.py`` plant and on their healthy twins."""
    og = jax_obs_gate
    profile = _profile()
    wrong = copy.deepcopy(profile)
    wrong["dtypes"]["f32"]["tiers"][0]["family"] = "pallas:tail"
    for doc in (profile, wrong, _profile(nnz=None),
                dict(profile, schema=2), _profile(full_ms=0.0)):
        assert obs_gate.lens_problems(doc) == og.lens_problems(doc)
    assert obs_gate.lens_problems(profile) == []
    assert obs_gate.lens_problems(wrong) and \
        obs_gate.lens_problems(_profile(nnz=None))
    comm = [{"algorithms": {"a": {"exposed_comm_ms": 0.1, "repl": r,
                                  "reduce_bytes": rb}}}
            for r, rb in ((2, 64), (2, None), (1, 0))]
    comm.append({"algorithms": {"a": {"repl": 1}}})
    for summary in comm:
        assert obs_gate.comm_problems(summary) == \
            og.comm_problems(summary)
    assert [bool(obs_gate.comm_problems(s)) for s in comm] == \
        [False, True, False, True]
    mem = {"algorithms": {
        "ok": {"memory": {}, "hbm_measured_bytes": 10,
               "hbm_vs_predicted": 1.5},
        "big": {"memory": {}, "hbm_measured_bytes": 90,
                "hbm_vs_predicted": 9.0, "hbm_predicted_bytes": 10},
        "none": {"memory": None}}}
    assert obs_gate.memory_problems(mem, 8.0) == \
        og.memory_problems(mem, 8.0)
    assert len(obs_gate.memory_problems(mem, 8.0)) == 2
    for serve in ({}, {"latency_ms": {"p50": 1.0, "p99": 2.0},
                       "completed": 0, "per_class": {"exact": {}}}):
        assert obs_gate.serve_problems(serve) == og.serve_problems(serve)
    assert obs_gate.pulse_problems({}) == og.pulse_problems({})
    assert obs_gate.ledger_problems({}, {}) == og.ledger_problems({}, {})
    trace = {"xray": {"processes": [{"process": "router", "pid": 1}]}}
    assert obs_gate.xray_problems(trace, []) == og.xray_problems(trace, [])


def test_obs_gate_passes_on_the_cpu(tmp_path):
    assert obs_gate.main([str(tmp_path / "run"), "--device", "cpu"]) == 0
    assert (tmp_path / "run" / "serve" / "serve_summary.json").exists()


def test_kernel_gate_trips_on_planted_paths_and_passes_its_twins(tmp_path):
    paths = kernel_gate.planted_fixtures(str(tmp_path))
    assert len(paths) == 7
    for path in paths:
        assert kernel_gate.main(["--paths", path]) == 1, path
    assert kernel_gate.main(["--selftest"]) == 0
    assert kernel_gate.main(["--fixtures"]) == 0
    assert kernel_gate.main(["--fixture", paths[0]]) == 0
    good = tmp_path / "good.json"
    from arrow_matrix_tpu_torch.analysis.kernels import _good_k1_meta

    good.write_text(json.dumps({"metas": [_good_k1_meta()]}))
    assert kernel_gate.main(["--paths", str(good)]) == 0
    assert kernel_gate.main(["--device", "cpu"]) == 0


def test_comm_report_bytes_equal_commstats_for_each_mode(pool4):
    n, width, k = 1024, 64, 8
    doc = comm_report.run_report(n, width, k, 4, device="cpu")
    want = pool4.run(JOBS, "comm_by_mode", n, width, k,
                     job_timeout_s=120)
    modes = comm_report.modes_for(doc["n_levels"], 4)
    assert modes == tuple(want[0]) and len(modes) >= 4
    for mode in modes:
        assert doc[mode]["ranks"] == [w[mode] for w in want], mode
        assert doc[mode]["ranks"][0]["total_bytes"] > 0
    assert doc["time-shared/a2a"]["ideal"] > 0
    assert doc["ideal_routing"] > 0


def _log_runs(path):
    return sorted(p[:-len(".json")] for p in os.listdir(path)
                  if p.endswith(".json"))


def test_each_packages_log_upload_lists_the_others_runs(tmp_path, capsys):
    """A run the JAX ``spmm_arrow --logdir`` writes is listed by the
    port's ``log_upload``, and the port's by the JAX one."""
    from arrow_matrix_tpu.cli import log_upload as jupload
    from arrow_matrix_tpu_torch.cli import log_upload, spmm_arrow

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    jlogs, plogs = tmp_path / "jax_logs", tmp_path / "port_logs"
    r = subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu.cli.spmm_arrow",
         "--device", "cpu", "--vertices", "256", "--width", "16",
         "--features", "4", "--iterations", "2", "--logdir", str(jlogs)],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert spmm_arrow.main(["--device", "cpu", "--vertices", "256",
                                "--width", "16", "--features", "4",
                                "--iterations", "2", "--validate",
                                "--logdir", str(plogs)]) == 0
    finally:
        os.chdir(old)
    (run,) = _log_runs(plogs)
    doc = json.loads((plogs / f"{run}.json").read_text())
    assert doc["algorithm"] == "ArrowTPU_vBlockDiagonal_Slim_TimeShared"
    assert [e["iteration"] for e in doc["entries"]
            if "spmm_time" in e] == [0, 1]
    assert any("frobenius_err" in e for e in doc["entries"])
    capsys.readouterr()
    for upload, logs in ((log_upload, jlogs), (jupload, plogs),
                         (log_upload, plogs)):
        assert upload.main(["-f", str(logs)]) == 0
        out = capsys.readouterr().out
        (run,) = _log_runs(logs)
        assert f"pending (wandb not installed): {logs / run}" in out
        assert "1 run(s) handled" in out
    with pytest.raises(SystemExit, match="is not a directory"):
        log_upload.main(["-f", str(tmp_path / "none")])

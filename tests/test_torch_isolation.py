"""The port stands alone: no JAX, nothing of the JAX package, and no
quiet fallback to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from arrow_matrix_tpu_torch.utils import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "arrow_matrix_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "arrow_matrix_tpu")

torch.set_num_threads(2)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    names = {os.path.relpath(f, PORT) for f in files}
    assert {os.path.join("ops", "arrow_blocks.py"),
            os.path.join("ops", "cuda_blocks.py"),
            os.path.join("ops", "cuda_ell.py"),
            os.path.join("ops", "hyb.py"),
            os.path.join("utils", "platform.py"),
            os.path.join("ops", "gather.py"),
            os.path.join("ops", "cuda_gather.py"),
            os.path.join("tools", "gather_probe.py"),
            os.path.join("tools", "granule_gather_probe.py"),
            os.path.join("utils", "timing.py"),
            "sync.py", "classes.py",
            os.path.join("obs", "flight.py"),
            os.path.join("obs", "metrics.py"),
            os.path.join("obs", "memview.py"),
            os.path.join("obs", "comm.py"),
            os.path.join("faults", "plan.py"),
            os.path.join("faults", "policy.py"),
            os.path.join("faults", "supervisor.py"),
            os.path.join("utils", "checkpoint.py"),
            os.path.join("parallel", "routing.py"),
            os.path.join("serve", "request.py"),
            os.path.join("serve", "admission.py"),
            os.path.join("serve", "scheduler.py"),
            os.path.join("serve", "loadgen.py"),
            os.path.join("cli", "graft_serve.py"),
            os.path.join("ledger", "store.py"),
            os.path.join("obs", "tracer.py"),
            os.path.join("obs", "pulse.py"),
            os.path.join("obs", "xray.py"),
            os.path.join("fleet", "wire.py"),
            os.path.join("fleet", "shm.py"),
            os.path.join("fleet", "health.py"),
            os.path.join("fleet", "placement.py"),
            os.path.join("parallel", "reshard.py"),
            os.path.join("fleet", "worker.py"),
            os.path.join("fleet", "router.py"),
            os.path.join("fleet", "host.py"),
            os.path.join("cli", "graft_fleet.py"),
            os.path.join("cli", "graft_xray.py"),
            os.path.join("cli", "graft_pulse.py"),
            os.path.join("tools", "fleet_gate.py"),
            os.path.join("obs", "lens.py"),
            os.path.join("obs", "costmodel.py"),
            os.path.join("obs", "imbalance.py"),
            os.path.join("tune", "fingerprint.py"),
            os.path.join("tune", "search.py"),
            os.path.join("ledger", "gate.py"),
            os.path.join("ledger", "export.py"),
            os.path.join("ledger", "probe.py"),
            os.path.join("cli", "graft_lens.py"),
            os.path.join("cli", "graft_ledger.py"),
            os.path.join("tools", "lens_gate.py"),
            os.path.join("tools", "ledger_gate.py"),
            os.path.join("analysis", "contracts.py"),
            os.path.join("parallel", "mesh.py"),
            os.path.join("parallel", "collectives.py"),
            os.path.join("parallel", "launch.py"),
            os.path.join("parallel", "sell_slim.py"),
            os.path.join("parallel", "arrow_layout.py"),
            os.path.join("parallel", "autograd.py"),
            os.path.join("parallel", "space_shared.py"),
            os.path.join("parallel", "sell_space.py"),
            os.path.join("parallel", "spmm_1d.py"),
            os.path.join("parallel", "spmm_15d.py"),
            os.path.join("obs", "smoke.py"),
            os.path.join("obs", "__main__.py"),
            os.path.join("cli", "spmm_petsc.py"),
            os.path.join("cli", "spmm_15d.py"),
            os.path.join("models", "propagation.py"),
            os.path.join("utils", "commstats.py"),
            os.path.join("utils", "buildstats.py"),
            os.path.join("ops", "kernel_span.py"),
            os.path.join("analysis", "core.py"),
            os.path.join("analysis", "rules.py"),
            os.path.join("analysis", "audit.py"),
            os.path.join("analysis", "prove.py"),
            os.path.join("analysis", "sync.py"),
            os.path.join("analysis", "__main__.py"),
            os.path.join("cli", "graft_lint.py"),
            os.path.join("cli", "doctor.py"),
            os.path.join("tools", "proof_gate.py"),
            os.path.join("tools", "lint_gate.py"),
            os.path.join("tools", "sync_gate.py"),
            os.path.join("tools", "reshard_gate.py"),
            os.path.join("tools", "chaos_gate.py"),
            os.path.join("tools", "serve_gate.py"),
            os.path.join("tools", "obs_gate.py"),
            os.path.join("tools", "kernel_gate.py"),
            os.path.join("tools", "comm_report.py"),
            os.path.join("cli", "log_upload.py")} <= names
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


BLOCKED_RUN = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "optax",
                                  "arrow_matrix_tpu"}:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import numpy as np
from arrow_matrix_tpu_torch.decomposition import (arrow_decomposition,
                                                 decomposition_spmm)
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.utils import (barabasi_albert, random_dense,
                                          relative_error)
import arrow_matrix_tpu_torch.cli.spmm_arrow, arrow_matrix_tpu_torch.convert
from arrow_matrix_tpu_torch.ops import cuda_gather, gather
from arrow_matrix_tpu_torch.tools import gather_probe, granule_gather_probe
from arrow_matrix_tpu_torch.utils import timing
a = barabasi_albert(400, 3, seed=0)
levels = arrow_decomposition(a, 32, max_levels=4, block_diagonal=True,
                             seed=0)
ml = MultiLevelArrow(levels, 32, fmt="fold", device="cpu")
x = random_dense(400, 8, seed=1)
err = relative_error(ml.gather_result(ml.step(ml.set_features(x))),
                     decomposition_spmm(levels, x))
assert err < 1e-5, err
dense = MultiLevelArrow(levels, 32, fmt="dense", device="cpu")
err_dense = relative_error(
    dense.gather_result(dense.step(dense.set_features(x))),
    decomposition_spmm(levels, x))
assert err_dense < 1e-5, err_dense
for fmt in ("ell", "hyb"):
    other = MultiLevelArrow(levels, 32, fmt=fmt, device="cpu")
    err_fmt = relative_error(
        other.gather_result(other.step(other.set_features(x))),
        decomposition_spmm(levels, x))
    assert err_fmt < 1e-5, (fmt, err_fmt)
probe = granule_gather_probe.run_probe("cpu", 1024, 256, reps=1)
assert all(v["exact"] for v in probe["variants"].values()), probe
assert all(r["exact"] for r in gather_probe.gather_rates(
    n=256, m=2, device="cpu", ks=(16,), reps=1))
assert gather_probe.fold_gate(gather_probe.fold_step(16, ml, iters=1),
                              ml.nnz / ml.n)
import arrow_matrix_tpu_torch.bench, arrow_matrix_tpu_torch.cli.arrow_decompose
from arrow_matrix_tpu_torch.parallel import space_shared, sell_space
from arrow_matrix_tpu_torch.parallel import spmm_1d, spmm_15d
import arrow_matrix_tpu_torch.obs.smoke, arrow_matrix_tpu_torch.obs.__main__
import arrow_matrix_tpu_torch.cli.spmm_petsc, arrow_matrix_tpu_torch.cli.spmm_15d
from arrow_matrix_tpu_torch.models import propagation
from arrow_matrix_tpu_torch.utils import artifacts, logging, platform
native_levels = arrow_decomposition(a, 32, max_levels=4, seed=0,
                                    backend="auto")
assert sum(l.matrix.nnz for l in native_levels) == a.nnz
assert not any(m.split(".")[0] in {"jax", "flax", "arrow_matrix_tpu"}
               for m in sys.modules)
print("ok", err)
"""


def test_port_runs_a_fold_step_with_jax_blocked():
    """A fold step, a dense step, both gather probes, the bench and
    decomposer modules and a native decomposition, with JAX and the JAX
    package unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_runs_a_two_rank_mesh_step_with_jax_blocked(tmp_path):
    """``spmm_arrow --devices 2 --device cpu --fmt sell --validate`` with
    JAX and the JAX package unimportable in the launcher and in both of
    the gloo ranks it starts (a ``sitecustomize`` on the path blocks
    them in every process)."""
    blocker = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")]
    (tmp_path / "sitecustomize.py").write_text(blocker)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    proc = subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.spmm_arrow",
         "--devices", "2", "--device", "cpu", "--fmt", "sell",
         "--vertices", "512", "--width", "32", "--features", "4",
         "--iterations", "1", "--validate"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "over gloo (2 ranks on cpu)" in proc.stdout
    assert "rel err vs host" in proc.stdout


def test_baselines_and_the_smoke_run_with_jax_blocked(tmp_path):
    """``spmm_15d --devices 2 --device cpu --validate`` and ``graft_trace
    smoke --devices 2 --device cpu`` over the two baselines, with JAX and
    the JAX package unimportable in the launchers and in every rank."""
    blocker = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")]
    (tmp_path / "sitecustomize.py").write_text(blocker)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    proc = subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.spmm_15d",
         "--devices", "2", "--device", "cpu", "--vertices", "256",
         "--edges", "1024", "--columns", "4", "--iterations", "1",
         "--validate", "true", "--logdir", str(tmp_path / "logs")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "validation: ok=True" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.obs", "smoke",
         str(tmp_path / "run"), "--devices", "2", "--device", "cpu",
         "--n", "64", "--iters", "1", "--algorithms", "spmm_1d,spmm_15d"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "spmm_15d" in proc.stdout and "INVALID" not in proc.stderr


def test_mesh_serving_and_state_run_with_jax_blocked(tmp_path):
    """``graft_serve --fmt ell --devices 2 --checkpoint`` (a lockstep
    server on a mesh of gloo ranks, its checkpoints written by rank 0)
    and ``spmm_arrow --devices 2 --memmap --carry --checkpoint`` (the
    memmapped levels, a checkpoint of the sharded carriage), at once,
    with JAX and the JAX package unimportable in the launchers and in
    every rank."""
    blocker = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")]
    (tmp_path / "sitecustomize.py").write_text(blocker)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    env.pop("AMT_FAULT_PLAN", None)
    runs = [["arrow_matrix_tpu_torch.cli.graft_serve", "--fmt", "ell",
             "--vertices", "128", "--width", "16", "--requests", "4",
             "--iterations", "2", "--checkpoint", str(tmp_path / "ck")],
            ["arrow_matrix_tpu_torch.cli.spmm_arrow", "--vertices", "512",
             "--width", "32", "--features", "4", "--iterations", "2",
             "--memmap", "--carry", "--checkpoint", "ckpt", "--validate"]]
    procs = [subprocess.Popen(
        [sys.executable, "-m", *run, "--devices", "2", "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for run in runs]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    assert "4 completed" in outs[0][0]
    assert "iteration 1: rel err vs host" in outs[1][0]
    assert os.path.exists(tmp_path / "ckpt.npz")


SERVE_RUN = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")] + r"""
import json, os, tempfile
import arrow_matrix_tpu_torch.sync, arrow_matrix_tpu_torch.classes
from arrow_matrix_tpu_torch import faults
from arrow_matrix_tpu_torch.obs import comm, flight, memview, metrics
from arrow_matrix_tpu_torch.serve import (ArrowServer, ExecConfig,
                                          ba_executor_factory, run_trace,
                                          slo_summary, synthetic_trace)
from arrow_matrix_tpu_torch.utils import checkpoint
import arrow_matrix_tpu_torch.cli.graft_serve
work = tempfile.mkdtemp()
fac, n = ba_executor_factory(64, 16, 5, device="cpu")
faults.set_plan({"scenario": "error", "site": "multi_level.step",
                 "after": 1})
srv = ArrowServer(fac, ExecConfig(repl=2, overlap_slabs=2), max_batch_k=8,
                  policy=faults.RetryPolicy(backoff_s=0.001),
                  checkpoint_dir=os.path.join(work, "ck"),
                  registry=metrics.MetricsRegistry())
tickets = run_trace(srv, synthetic_trace(n, requests=4, k=4, seed=5))
assert [t.status for t in tickets] == ["completed"] * 4
s = slo_summary(srv, tickets, 1.0)
assert s["faults_seen"] == 1 and s["recoveries"] == 1, s
from arrow_matrix_tpu_torch import fleet, ledger
from arrow_matrix_tpu_torch.obs import Tracer, pulse, xray
from arrow_matrix_tpu_torch.serve import smoke_serve
from arrow_matrix_tpu_torch.utils import logging as wb
faults.clear_plan()
smoke = smoke_serve(os.path.join(work, "smoke"), device="cpu")
assert smoke["completed"] == 4 and smoke["ledger_record_id"], smoke
assert ledger.Ledger(os.path.join(work, "smoke", "ledger")).validate() == []
tr = Tracer("blocked")
with wb.trace(os.path.join(work, "tr"), device="cpu") as prof:
    with tr.span("phase"):
        pass
assert "phase" in prof.annotations
assert xray.process_trace(tr, "p")["spans"][0]["name"] == "phase"
assert fleet.measure_transports(1 << 12, repeats=1)["shm"]["frame_bytes"]
assert not any(m.split(".")[0] in {"jax", "flax", "arrow_matrix_tpu"}
               for m in sys.modules)
print("ok", json.dumps(s["hbm"]))
"""


def test_serving_runtime_runs_with_jax_blocked():
    """Every module of the serving runtime imported, a supervised,
    batched, checkpointing server run with a column schedule and one
    injected fault, and the observability layer (a smoke serve with its
    pulse monitor and ledger, a CPU profile, a trace document) and the
    fleet's data plane, with JAX and the JAX package unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("AMT_FAULT_PLAN", None)
    proc = subprocess.run([sys.executable, "-c", SERVE_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


FLEET_RUN = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")] + r"""
import os, tempfile, threading
import numpy as np
import arrow_matrix_tpu_torch.cli.graft_fleet
import arrow_matrix_tpu_torch.cli.graft_pulse
import arrow_matrix_tpu_torch.cli.graft_xray
import arrow_matrix_tpu_torch.tools.fleet_gate
import arrow_matrix_tpu_torch.tools.reshard_gate
from arrow_matrix_tpu_torch.fleet import FleetRouter, WorkerHandle
from arrow_matrix_tpu_torch.fleet.host import RouterQuorum, plan_host_mesh
from arrow_matrix_tpu_torch.fleet.worker import FleetWorker, serve_worker
from arrow_matrix_tpu_torch.parallel import reshard
from arrow_matrix_tpu_torch.serve import synthetic_trace
work = tempfile.mkdtemp()
ck = os.path.join(work, "ck")
handles, workers = [], []
for wid in ("w0", "w1"):
    w = FleetWorker(wid, vertices=64, width=16, seed=5, checkpoint_dir=ck,
                    device="cpu")
    box, ready = {}, threading.Event()
    def announce(port, box=box, ready=ready):
        box["port"] = port
        ready.set()
    threading.Thread(target=serve_worker, args=(w,),
                     kwargs={"announce": announce}, daemon=True).start()
    assert ready.wait(60)
    workers.append(w)
    handles.append(WorkerHandle(wid, "127.0.0.1", box["port"]))
router = FleetRouter(handles=handles, checkpoint_dir=ck)
trace = synthetic_trace(router.n_rows, tenants=2, requests=4, k=2,
                        iterations=2, seed=3)
tickets = [router.submit(r) for r in trace]
router.drain(timeout_s=120)
assert [t.status for t in tickets] == ["completed"] * 4, tickets
moved = router.migrate(trace[0].tenant, scratch_budget_bytes=256)
assert moved["checkpoints"], moved
report = router.fleet_summary()
assert report["latency_ms"]["count"] == 4, report["latency_ms"]
router.shutdown()
for w in workers:
    w.close()
assert len(plan_host_mesh(2, 1)) == 2
assert reshard.layout_tag("t", reshard.Layout(8)) == "t@rows8c1d1"
assert not any(m.split(".")[0] in {"jax", "flax", "arrow_matrix_tpu"}
               for m in sys.modules)
print("ok", moved["to_worker"])
"""


def test_fleet_runs_with_jax_blocked():
    """Two fleet workers (in-process, on the CPU) behind the router
    serve a trace and hand a tenant's checkpoints off, with every fleet
    module, the fleet CLIs and the gate imported, and JAX and the JAX
    package unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("AMT_FAULT_PLAN", None)
    proc = subprocess.run([sys.executable, "-c", FLEET_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # The router prints its migration line before the verdict.
    assert proc.stdout.splitlines()[-1].startswith("ok"), proc.stdout


def test_resolve_device_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for request in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(request)


def test_cuda_only_tests_exist_and_are_marked():
    path = os.path.join(REPO, "tests", "test_torch_cuda.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    tests = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert len(tests) >= 3
    src = open(path, encoding="utf-8").read()
    assert "pytestmark = pytest.mark.cuda" in src
    for t in tests:
        assert "cuda" in [a.arg for a in t.args.args], t.name


LENS_RUN = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")] + r"""
import os, tempfile
from arrow_matrix_tpu_torch.obs import lens
from arrow_matrix_tpu_torch.ledger import Ledger, export, gate, probe
from arrow_matrix_tpu_torch.tools import lens_gate, ledger_gate
from arrow_matrix_tpu_torch.tune import load_levels_from_source
import arrow_matrix_tpu_torch.cli.graft_lens, arrow_matrix_tpu_torch.cli.graft_ledger
work = tempfile.mkdtemp()
src = {"kind": "ba", "n": 128, "m": 3, "width": 16, "seed": 1,
       "max_levels": 10}
levels, width = load_levels_from_source(src)
prof = lens.profile_fold(levels, width, 4, iters=2, device="cpu")
lg = Ledger(os.path.join(work, "ledger"))
assert lens.fit_from_profile(prof).coeffs
lens.record_profile(prof, None, lg.directory)
probe.error_curves_for_source(src, k=2, iterations=2, ledger=lg,
                              device="cpu")
assert gate.main(["--rebaseline", "--ledger-dir", lg.directory]) == 0
assert gate.main(["--check", "--ledger-dir", lg.directory]) == 0
assert lens_gate.main([]) == 0
assert not any(m.split(".")[0] in {"jax", "flax", "arrow_matrix_tpu"}
               for m in sys.modules)
print("ok")
"""


def test_lens_and_ledger_run_with_jax_blocked():
    """A lens profile, its records, the probe's curves, the gate and the
    lens gate, with JAX and the JAX package unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", LENS_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


ANALYSIS_RUN = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")] + r"""
import os
import arrow_matrix_tpu_torch
import arrow_matrix_tpu_torch.cli.doctor, arrow_matrix_tpu_torch.cli.graft_lint
from arrow_matrix_tpu_torch.analysis import audit, lint_paths, prove
from arrow_matrix_tpu_torch.analysis import sync as graft_sync
from arrow_matrix_tpu_torch.tools import (lint_gate, proof_gate,
                                          reshard_gate, sync_gate)
pkg = os.path.dirname(arrow_matrix_tpu_torch.__file__)
findings, _ = lint_paths([pkg])
assert not findings, findings[:3]
assert prove.selftest()
assert graft_sync.selftest()[0]
assert graft_sync.run_sync(write=False)["ok"]
assert not any(m.split(".")[0] in {"jax", "flax", "arrow_matrix_tpu"}
               for m in sys.modules)
print("ok")
"""


def test_analysis_family_runs_with_jax_blocked():
    """The lint over the port's tree, the prover's selftest (its live
    planted ``dist.all_gather`` on a one-rank group), the sync analyzer
    and every analysis CLI, gate and the doctor imported, with JAX and
    the JAX package unimportable."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", ANALYSIS_RUN], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok", proc.stdout


def test_the_reference_gates_run_with_jax_blocked(tmp_path):
    """The port's chaos (``--fast``), obs and kernel gates, ``comm_report``
    on 4 gloo ranks, and ``spmm_arrow --logdir`` with ``log_upload``
    listing its run, each with ``--device cpu``, one after another (at
    once they hold some 20 processes beside the suite's workers), with
    JAX and the JAX package unimportable in every process they start."""
    blocker = BLOCKED_RUN[:BLOCKED_RUN.index("import numpy as np")]
    (tmp_path / "sitecustomize.py").write_text(blocker)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    env.pop("AMT_FAULT_PLAN", None)
    logs = str(tmp_path / "logs")
    runs = {
        "chaos": ["arrow_matrix_tpu_torch.tools.chaos_gate", "--fast",
                  "--device", "cpu", str(tmp_path / "chaos")],
        "obs": ["arrow_matrix_tpu_torch.tools.obs_gate", "--device", "cpu",
                str(tmp_path / "obs")],
        "kernel": ["arrow_matrix_tpu_torch.tools.kernel_gate", "--selftest"],
        "comm": ["arrow_matrix_tpu_torch.tools.comm_report", "512", "32",
                 "4", "4", "--device", "cpu"],
        "logdir": ["arrow_matrix_tpu_torch.cli.spmm_arrow", "--device",
                   "cpu", "--vertices", "256", "--width", "16",
                   "--iterations", "1", "--logdir", logs]}
    out = {}
    for name, argv in runs.items():
        p = subprocess.run(
            [sys.executable, "-m", *argv], cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600)
        out[name] = p.stdout
        assert p.returncode == 0, (name, out[name][-3000:])
    assert "chaos gate: ok" in out["chaos"]
    assert "obs gate: ok" in out["obs"]
    assert "selftest passed" in out["kernel"]
    assert '"ideal_routing"' in out["comm"]
    up = subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.log_upload",
         "-f", logs], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert up.returncode == 0 and "1 run(s) handled" in up.stdout, \
        up.stdout + up.stderr

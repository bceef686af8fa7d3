"""The port's fault plans, supervisor and checkpoint-resume loop
(``arrow_matrix_tpu_torch.faults``) against the JAX package's on the
CPU: the same plan JSON drives both servers through hang, error, nan
and corrupt with the same fault and recovery counts and flight event
kinds, and results equal to the fault-free replay; the kill scenario is
a subprocess of the port's ``graft_serve`` CLI, killed and resumed."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from arrow_matrix_tpu import faults as jfaults
from arrow_matrix_tpu import serve as jserve
from arrow_matrix_tpu.obs import flight as jflight
from arrow_matrix_tpu_torch import faults as pfaults
from arrow_matrix_tpu_torch import serve as pserve
from arrow_matrix_tpu_torch.faults import (
    Abort,
    FaultInjected,
    FaultPlan,
    Supervisor,
    state_is_finite,
)
from arrow_matrix_tpu_torch.faults import plan as pplan
from arrow_matrix_tpu_torch.obs import flight as pflight
from arrow_matrix_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, WIDTH, K, SEED = 128, 16, 2, 11
TENANTS, REQUESTS, ITERS = 4, 8, 4


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    jfaults.clear_plan()
    pfaults.clear_plan()
    yield
    jfaults.clear_plan()
    pfaults.clear_plan()


@pytest.fixture(scope="module")
def pkgs():
    return {
        "jax": types.SimpleNamespace(
            serve=jserve, faults=jfaults, flight=jflight,
            factory=jserve.ba_executor_factory(N, WIDTH, SEED, fmt="fold")),
        "port": types.SimpleNamespace(
            serve=pserve, faults=pfaults, flight=pflight,
            factory=pserve.ba_executor_factory(N, WIDTH, SEED, fmt="fold",
                                               device="cpu")),
    }


def _gate_run(p, plan=None, ckdir=None, **policy):
    """The serve gate's trace (4 tenants, 8 requests, 4 iterations)
    under ``plan``, with a flight recorder; returns the server, its
    tickets and the (kind, name) of every fault, heal and serve
    event."""
    kw = dict(max_retries=2, backoff_s=0.001, jitter=0.2, seed=SEED)
    kw.update(policy)
    rec = p.flight.FlightRecorder(None, capacity=100_000)
    p.flight.set_recorder(rec)
    if plan is not None:
        p.faults.set_plan(plan)
    try:
        srv = p.serve.ArrowServer(
            p.factory[0], p.serve.ExecConfig(), queue_capacity=16,
            policy=p.faults.RetryPolicy(**kw), name="gate",
            checkpoint_dir=ckdir, checkpoint_every=2)
        tickets = p.serve.run_trace(srv, p.serve.synthetic_trace(
            p.factory[1], tenants=TENANTS, requests=REQUESTS, k=K,
            iterations=ITERS, seed=SEED))
    finally:
        p.faults.clear_plan()
        p.flight.set_recorder(None)
    kinds = [(e["kind"], e["name"]) for e in rec.events
             if e["kind"] in ("fault", "heal", "serve")]
    return srv, tickets, kinds


PLANS = {
    # The watchdog leaves room for the JAX step's first compile.
    "hang": ({"scenario": "hang", "site": "multi_level.step", "after": 3,
              "hang_s": 3.0}, dict(watchdog_s=2.0, watchdog_grace_s=60.0)),
    "error": ({"scenario": "error", "site": "*.step", "after": 5,
               "count": 2}, {}),
    "nan": ({"scenario": "nan", "site": "multi_level.step", "after": 6,
             "burst": 3, "seed": 2}, {}),
    "corrupt": ({"scenario": "corrupt", "site": "multi_level.step",
                 "after": 9}, {}),
}


@pytest.mark.parametrize("scenario", sorted(PLANS))
def test_one_plan_drives_both_servers_alike(pkgs, scenario, tmp_path):
    plan, policy = PLANS[scenario]
    runs = {}
    for w in ("jax", "port"):
        ck = str(tmp_path / w) if scenario == "nan" else None
        runs[w] = _gate_run(pkgs[w], plan, ckdir=ck, **policy)
    (ps, pt, pk), (js, jt, jk) = runs["port"], runs["jax"]
    assert (ps.faults_seen, ps.recoveries) == (js.faults_seen,
                                               js.recoveries)
    assert ps.faults_seen >= 1 and ps.recoveries >= 1
    assert pk == jk
    assert [t.status for t in pt] == ["completed"] * REQUESTS
    _, ref, _ = _gate_run(pkgs["port"])
    for a, b in zip(pt, ref):
        assert a.result.tobytes() == b.result.tobytes()


def test_corrupt_checkpoint_is_discarded_and_recomputed(pkgs, tmp_path):
    p = pkgs["port"]
    victim = tmp_path / "ck_r0000.npz"
    victim.write_bytes(b"\x00corrupt\xff" * 64)
    (tmp_path / "ck_r0000.npz.sha256").write_text("0" * 64 + "\n")
    srv, tickets, kinds = _gate_run(p, ckdir=str(tmp_path))
    assert srv.summary()["checkpoint_corruptions"] >= 1
    assert ("serve", "checkpoint_corrupt_discarded") in kinds
    _, ref, _ = _gate_run(p)
    assert [a.result.tobytes() for a in tickets] == \
        [b.result.tobytes() for b in ref]


def test_plan_parsing_equals_jax(tmp_path):
    spec = {"scenario": "hang", "site": "*.step", "after": 2,
            "hang_s": 0.5}
    assert vars(pplan.parse_plan(json.dumps(spec))) == \
        vars(jfaults.plan.parse_plan(json.dumps(spec)))
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    assert pplan.parse_plan(str(path)) == FaultPlan(**spec)
    for bad in ({"scenario": "melt"}, {"scenario": "hang", "when": 1}):
        with pytest.raises(ValueError):
            FaultPlan.from_json(bad)
        with pytest.raises(ValueError):
            jfaults.FaultPlan.from_json(bad)


def test_inject_fires_in_its_window_only():
    pfaults.set_plan({"scenario": "error", "site": "io.*", "after": 1,
                      "count": 2, "target": "ba_"})
    pfaults.inject("io.load_decomposition", target="other")   # filtered
    pfaults.inject("multi_level.step")                        # other site
    pfaults.inject("io.load_decomposition", target="ba_1")    # hit 0
    for _ in range(2):
        with pytest.raises(FaultInjected):
            pfaults.inject("io.load_decomposition", target="ba_1")
    pfaults.inject("io.load_decomposition", target="ba_1")    # past it
    pfaults.clear_plan()
    pfaults.inject("io.load_decomposition", target="ba_1")


def test_nan_hook_never_writes_its_input_and_is_seeded():
    x = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    keep = x.clone()
    assert pfaults.on_step("multi_level.step", x) is x   # no plan
    outs = []
    for _ in range(2):
        pfaults.set_plan({"scenario": "nan", "site": "*.step",
                          "burst": 3, "seed": 4})
        outs.append(pfaults.on_step("multi_level.step", x))
    assert torch.equal(x, keep)
    assert torch.equal(torch.isnan(outs[0]), torch.isnan(outs[1]))
    jfaults.set_plan({"scenario": "nan", "site": "*.step", "burst": 3,
                      "seed": 4})
    import jax.numpy as jnp

    want = np.isnan(np.asarray(jfaults.on_step("multi_level.step",
                                               jnp.asarray(keep))))
    assert np.array_equal(torch.isnan(outs[0]).numpy(), want)


def test_the_decomposition_loader_has_its_fault_seam(tmp_path):
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import load_decomposition, \
        save_decomposition
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    base = str(tmp_path / "ba")
    save_decomposition(arrow_decomposition(barabasi_albert(64, 3, seed=1),
                                           16, max_levels=2, seed=1),
                       base, block_diagonal=True)
    pfaults.set_plan({"scenario": "corrupt",
                      "site": "io.load_decomposition", "target": "ba"})
    with pytest.raises(FaultInjected, match="corrupt-artifact"):
        load_decomposition(base, 16)
    assert load_decomposition(base, 16)        # one-shot


def _supervise(body, x0, stop, **kw):
    sup = Supervisor("t", verbose=False, backoff_s=0.0, **kw)
    return sup, sup.run(body, x0, 0, stop)


def test_supervisor_clean_retry_exhaust_and_abort():
    x0 = torch.ones(4, 2)
    sup, (x, ok) = _supervise(lambda x, it: x * 2, x0, 3)
    assert ok and torch.equal(x, x0 * 8) and sup.faults_seen == 0
    fails = {"n": 1}

    def flaky(x, it):
        if it == 1 and fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("transient")
        return x * 2

    sup, (x, ok) = _supervise(flaky, x0, 3)
    assert ok and torch.equal(x, x0 * 8)
    assert (sup.faults_seen, sup.recoveries) == (1, 1)
    sup, (x, ok) = _supervise(lambda x, it: 1 / 0, x0, 3, max_retries=2)
    assert not ok and sup.faults_seen == 3
    sup, (x, ok) = _supervise(
        lambda x, it: (_ for _ in ()).throw(Abort("gate")), x0, 3)
    assert not ok and sup.faults_seen == 0


def test_supervisor_nan_rolls_back_to_the_checkpoint(tmp_path):
    x0 = torch.ones(4, 2)
    poisoned = {"n": 1}

    def body(x, it):
        y = x * 2
        if it == 3 and poisoned["n"]:
            poisoned["n"] -= 1
            y[0, 0] = float("nan")
        return y

    sup, (x, ok) = _supervise(body, x0, 5,
                              checkpoint_path=str(tmp_path / "ck"),
                              checkpoint_every=2)
    assert ok and torch.equal(x, x0 * 32)
    assert sup.faults_seen == 1 and sup.recoveries == 1
    state = load_state(str(tmp_path / "ck"))
    assert state[1] == 5 and torch.equal(state[0], x0 * 32)
    assert state_is_finite(x0) and not state_is_finite(
        torch.tensor([1.0, float("inf")]))
    assert state_is_finite((torch.zeros(2, dtype=torch.int8),
                            torch.ones(1, 2)))


def test_supervisor_watchdog_retries_a_stall():
    x0 = torch.ones(4, 2)
    stalled = {"n": 1}

    def body(x, it):
        if it == 1 and stalled["n"]:
            stalled["n"] -= 1
            import time

            time.sleep(0.5)
        return x + 1

    sup, (x, ok) = _supervise(body, x0, 3, watchdog_s=0.2,
                              watchdog_grace_s=30.0)
    assert ok and torch.equal(x, x0 + 3)
    assert sup.faults_seen == 1 and sup.recoveries == 1


def _serve_cli(tmp_path, extra, plan=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("AMT_FAULT_PLAN", None)
    if plan is not None:
        env["AMT_FAULT_PLAN"] = json.dumps(plan)
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_serve",
           "--vertices", str(N), "--width", str(WIDTH), "--features",
           str(K), "--tenants", str(TENANTS), "--requests", str(REQUESTS),
           "--iterations", str(ITERS), "--seed", str(SEED), "--device",
           "cpu", "--checkpoint_every", "2", *extra]
    return subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)


def test_killed_server_resumes_to_the_never_killed_results(tmp_path):
    """The serve gate's kill scenario on the port's CLI: SIGKILL at step
    hit 18 (mid request 4, four requests done), then a rerun that
    resumes from the checkpoints; its results equal a never-killed
    run's bit for bit."""
    ref, out, ck = (str(tmp_path / f) for f in ("ref.npz", "kill.npz",
                                                 "ck"))
    r = _serve_cli(tmp_path, ["--results_out", ref])
    assert r.returncode == 0, r.stderr
    r = _serve_cli(tmp_path, ["--results_out", out, "--checkpoint", ck],
                   plan={"scenario": "kill", "site": "*.step",
                         "after": 18})
    assert r.returncode == -9 and not os.path.exists(out)
    r = _serve_cli(tmp_path, ["--results_out", out, "--checkpoint", ck])
    assert r.returncode == 0, r.stderr
    assert "resumed request" in r.stdout
    with np.load(ref) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == \
            REQUESTS
        for rid in a.files:
            assert a[rid].tobytes() == b[rid].tobytes()


def test_cli_flags_of_parts_not_ported_exit_naming_them(tmp_path):
    """``--devices`` serves the mesh format: the fold on two ranks exits
    naming it, before any work (``--fmt ell`` on a mesh is held in
    tests/test_torch_mesh_cli.py)."""
    r = _serve_cli(tmp_path, ["--devices", "2"])
    assert r.returncode != 0
    assert "--devices serves --fmt ell over a mesh" in r.stderr

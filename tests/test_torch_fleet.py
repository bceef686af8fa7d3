"""The port's multi-process fleet (``arrow_matrix_tpu_torch.fleet``:
worker, router, host; ``cli/graft_fleet.py``; ``tools/fleet_gate.py``)
against the JAX package's, on the CPU: host domains and the global-job
env plans equal; ring placement and packing of the same tenants onto
the same worker ids equal (the JAX router drives the port's workers
over the shared wire); an in-process two-worker fleet on the fleet
gate's trace bit-equal to the port's single-process replay and within
``relative_tolerance`` of the JAX package's; exact pooled quantiles;
requeue onto a survivor; the router quorum's agreement and failover;
``migrate`` handing checkpoints off so the destination resumes them;
the card's budget split; the worker's refusal of a global job; the
CLI's verdict keys against the JAX CLI's; and the gate's kill
scenario with real worker processes."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from arrow_matrix_tpu import faults as jfaults
from arrow_matrix_tpu.fleet import host as jhost
from arrow_matrix_tpu.fleet.router import FleetRouter as JRouter
from arrow_matrix_tpu.fleet.router import WorkerHandle as JHandle
from arrow_matrix_tpu.serve import loadgen as jloadgen
from arrow_matrix_tpu.serve.scheduler import ArrowServer as JServer
from arrow_matrix_tpu.serve.scheduler import ExecConfig as JConfig
from arrow_matrix_tpu_torch import faults as pfaults
from arrow_matrix_tpu_torch.fleet import host, wire
from arrow_matrix_tpu_torch.fleet import router as router_mod
from arrow_matrix_tpu_torch.fleet import worker as worker_mod
from arrow_matrix_tpu_torch.fleet.health import HealthMonitor
from arrow_matrix_tpu_torch.fleet.router import FleetRouter, WorkerHandle
from arrow_matrix_tpu_torch.fleet.worker import FleetWorker, serve_worker
from arrow_matrix_tpu_torch.obs.metrics import Histogram
from arrow_matrix_tpu_torch.serve.loadgen import synthetic_trace
from arrow_matrix_tpu_torch.serve.request import Request
from arrow_matrix_tpu_torch.tools import fleet_gate as gate
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    relative_error,
    relative_tolerance,
)
from arrow_matrix_tpu_torch.utils.checkpoint import list_checkpoints

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = gate.GateShape(device="cpu")


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    jfaults.clear_plan()
    pfaults.clear_plan()
    yield
    jfaults.clear_plan()
    pfaults.clear_plan()


def _gate_trace(n_rows, **kw):
    args = dict(tenants=gate.TENANTS, requests=gate.REQUESTS, k=gate.K,
                iterations=gate.ITERS, seed=gate.TRACE_SEED)
    args.update(kw)
    return synthetic_trace(n_rows, **args)


class _Fleet:
    """In-process workers (``serve_worker`` on threads, ``device="cpu"``)
    sharing one checkpoint directory; stopped and closed on exit."""

    def __init__(self, ckpt, ids=("w0", "w1"), checkpoint_every=2):
        self.workers, self.threads, self.ports = {}, {}, {}
        for wid in ids:
            w = FleetWorker(wid, vertices=gate.N, width=gate.WIDTH,
                            seed=gate.SEED, checkpoint_dir=ckpt,
                            checkpoint_every=checkpoint_every,
                            device="cpu")
            ready, box = threading.Event(), {}

            def announce(port, box=box, ready=ready):
                box["port"] = port
                ready.set()

            th = threading.Thread(target=serve_worker, args=(w,),
                                  kwargs={"announce": announce},
                                  daemon=True)
            th.start()
            assert ready.wait(120), f"{wid} never bound"
            self.workers[wid], self.threads[wid] = w, th
            self.ports[wid] = box["port"]

    def handles(self, cls=WorkerHandle):
        return [cls(wid, "127.0.0.1", port)
                for wid, port in sorted(self.ports.items())]

    def stop(self, wid):
        """Shut one worker's wire front and wait until it refuses
        connections (so no request can reach it after this)."""
        wire.request_call("127.0.0.1", self.ports[wid], {"op": "shutdown"})
        self.threads[wid].join(30)
        assert not self.threads[wid].is_alive()

    def close(self):
        for wid, th in self.threads.items():
            if th.is_alive():
                try:
                    self.stop(wid)
                except (OSError, wire.WireError):
                    pass
        for w in self.workers.values():
            w.close()


@pytest.fixture()
def fleet(tmp_path):
    f = _Fleet(str(tmp_path / "ckpt"))
    try:
        yield f
    finally:
        f.close()


def _router(fleet, **kw):
    kw.setdefault("health", HealthMonitor(timeout_s=5.0, max_failures=3))
    return FleetRouter(handles=fleet.handles(), **kw)


# ---------------------------------------------------------------------------
# Host domains, the global-job env, the budget split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks,hosts", [(1, 1), (4, 2), (5, 2), (7, 3),
                                         (8, 8), (12, 5)])
def test_host_of_and_plan_host_mesh_equal_jax(ranks, hosts):
    assert [host.host_of(r, ranks, hosts) for r in range(ranks)] == \
        [jhost.host_of(r, ranks, hosts) for r in range(ranks)]
    per = max(ranks // hosts, 1)
    assert host.plan_host_mesh(hosts, per, coordinator="10.0.0.1",
                               port=1234) == \
        jhost.plan_host_mesh(hosts, per, coordinator="10.0.0.1", port=1234)
    for mod in (host, jhost):
        with pytest.raises(ValueError):
            mod.host_of(ranks, ranks, hosts)
        with pytest.raises(ValueError):
            mod.host_of(0, ranks, ranks + 1)


def test_a_global_job_env_raises_naming_the_multi_device_executors(
        monkeypatch):
    for key in worker_mod.DISTRIBUTED_ENV:
        monkeypatch.delenv(key, raising=False)
    assert worker_mod.maybe_init_distributed() is False
    env = host.plan_host_mesh(2, 1, port=2345)[1]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    # With the triple set the worker joins the one job as its rank (the
    # join itself is held in tests/test_torch_mesh_cli.py): over gloo on
    # the CPU, at the coordinator's TCP address; with no card and none
    # asked for, it raises instead of running on the CPU.
    from arrow_matrix_tpu_torch.parallel import mesh as mesh_mod

    joined = []
    monkeypatch.setattr(mesh_mod, "_RANK_DEVICE", [None])
    monkeypatch.setattr(mesh_mod, "init_distributed",
                        lambda *a, **k: joined.append((a, k)))
    assert worker_mod.maybe_init_distributed(verbose=True, device="cpu")
    (rank, world, backend, dev), kw = joined[0]
    assert (rank, world, backend, dev.type) == (1, 2, "gloo", "cpu")
    assert kw == {"init_method": "tcp://127.0.0.1:2345"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_mod.maybe_init_distributed()
    # Two of the three set is not a global job.
    monkeypatch.delenv("AMT_FLEET_PROCESS_ID")
    assert worker_mod.maybe_init_distributed() is False


@pytest.mark.parametrize("card,workers", [(40 * 2**30 + 7, 2),
                                          (79_000_000_001, 3),
                                          (1 << 20, 5)])
def test_workers_on_one_card_share_its_budget(monkeypatch, card, workers):
    from arrow_matrix_tpu_torch.obs import comm

    monkeypatch.setattr(comm, "hbm_budget_bytes",
                        lambda default=None, device=None: card)
    mb, got = router_mod.worker_budgets(torch.device("cuda", 0), workers)
    assert got == card
    # The share survives the trip through the worker's flag exactly.
    share = int(float(repr(mb)) * 2**20)
    assert share == card // workers
    assert share * workers <= card
    # An explicit budget, and any budget on the CPU, stay each
    # worker's own, as in the JAX package.
    assert router_mod.worker_budgets(torch.device("cuda", 0), workers,
                                     64.0) == (64.0, None)
    assert router_mod.worker_budgets(torch.device("cpu"), workers) == \
        (0.0, None)


def test_a_worker_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetWorker("w", vertices=64, width=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRouter(spawn=1, vertices=64, width=16)


# ---------------------------------------------------------------------------
# Placement: the JAX router over the port's workers
# ---------------------------------------------------------------------------

def test_ring_and_packing_place_tenants_as_the_jax_router(fleet):
    port = _router(fleet)
    jax_router = JRouter(handles=fleet.handles(JHandle))
    try:
        tenants = [f"tenant{i}" for i in range(64)]
        placed = {t: port._place(t) for t in tenants}
        assert placed == {t: jax_router._place(t) for t in tenants}
        assert set(placed.values()) == {"w0", "w1"}
        ks = {t: 1 + i % 3 for i, t in enumerate(tenants[:8])}
        assert port.plan_packing(ks) == jax_router.plan_packing(ks)
        assert port._place("tenant0") == jax_router._place("tenant0")
    finally:
        port.shutdown()
        jax_router.shutdown()


# ---------------------------------------------------------------------------
# An in-process fleet on the gate's trace
# ---------------------------------------------------------------------------

def _jax_replay(iterations=gate.ITERS):
    factory, n_rows = jloadgen.ba_executor_factory(gate.N, gate.WIDTH,
                                                   gate.SEED, fmt="fold")
    server = JServer(factory, JConfig(), name="jax-ref")
    trace = jloadgen.synthetic_trace(
        n_rows, tenants=gate.TENANTS, requests=gate.REQUESTS, k=gate.K,
        iterations=iterations, seed=gate.TRACE_SEED)
    return {t.request.request_id: np.asarray(t.result)
            for t in jloadgen.run_trace(server, trace)}


def test_fleet_is_bit_equal_to_the_replay_and_pools_exactly(fleet):
    router = _router(fleet)
    try:
        trace = _gate_trace(router.n_rows)
        tickets = [router.submit(r) for r in trace]
        router.drain(timeout_s=180)
        assert [t.status for t in tickets] == ["completed"] * len(trace)
        report = router.fleet_summary()
    finally:
        router.shutdown()
    assert {t.worker_id for t in tickets} == {"w0", "w1"}
    ref = gate.reference_results(CPU)
    assert {t.request.request_id: t.result.tobytes() for t in tickets} \
        == ref
    jref = _jax_replay()
    row_nnz = barabasi_albert(gate.N, 3, seed=gate.SEED).nnz / gate.N
    tol = relative_tolerance(row_nnz, gate.ITERS)
    for t in tickets:
        err = relative_error(t.result, jref[t.request.request_id])
        assert err <= tol, (t.request.request_id, err, tol)
    # Exact pooled quantiles over the workers' raw samples.
    assert report["completed"] == len(trace)
    assert report["shed"] == report["failed"] == 0
    pooled, samples = Histogram(), []
    for rec in report["workers"].values():
        samples += rec["latency_samples_ms"]
        for v in rec["latency_samples_ms"]:
            pooled.observe(v)
    lat = report["latency_ms"]
    assert lat["count"] == len(samples) == len(trace)
    for q, field in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        assert lat[field] == pooled.quantile(q) == \
            gate.nearest_rank(samples, q)
    assert report["device"] is None and report["card_budget_bytes"] is None
    launches = [rec["kernel_launches"] for rec in report["workers"].values()]
    assert launches[0]["K1"] == 0     # the plain version on the CPU


def test_a_dead_workers_request_is_requeued_onto_the_survivor(fleet):
    router = _router(fleet)
    try:
        victim = next(t for t in (f"t{i}" for i in range(256))
                      if router.ring.lookup(t) == "w0")
        fleet.stop("w0")
        x = np.ones((router.n_rows, 2), dtype=np.float32)
        t = router.submit(Request("rq-dead", victim, x, 2))
        router.drain(timeout_s=180)
        assert t.status == "completed"
        assert getattr(t, "requeues", 0) >= 1 and t.worker_id == "w1"
        assert router.live_workers() == ["w1"]
        assert not router.health.snapshot()["w0"]["alive"]
        assert router.fleet_summary()["dead_workers"] == ["w0"]
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# Router quorum
# ---------------------------------------------------------------------------

def test_quorum_agrees_refuses_splits_and_fails_over_without_loss(fleet,
                                                                  monkeypatch):
    routers = {name: _router(fleet, name=f"quorum-{name}")
               for name in ("A", "B")}
    quorum = host.RouterQuorum(routers)
    try:
        tenants = [f"t{i}" for i in range(16)]
        ks = {t: 2 for t in tenants}
        doc = quorum.verify_agreement(tenants, tenant_ks=ks)
        assert doc["agreed"] and doc["routers"] == ["A", "B"]
        assert doc["packing"] is not None
        routers["B"].ring.remove("w0")
        with pytest.raises(host.QuorumDisagreement,
                           match="placement split"):
            quorum.verify_agreement(tenants)
        routers["B"].ring.add("w0")
        quorum.verify_agreement(tenants)
        real = routers["A"].plan_packing(ks)
        forged = {"assignment": dict(real["assignment"]),
                  "unplaced": list(real["unplaced"])}
        t0 = sorted(forged["assignment"])[0]
        forged["assignment"][t0] = ("w1" if forged["assignment"][t0]
                                    == "w0" else "w0")
        with monkeypatch.context() as m:
            m.setattr(routers["B"], "plan_packing", lambda tenant_ks: forged)
            with pytest.raises(host.QuorumDisagreement,
                               match="packing split"):
                quorum.verify_agreement(tenants, tenant_ks=ks)

        trace = _gate_trace(routers["A"].n_rows)
        for r in trace:
            quorum.submit(r)
        assert quorum.summary()["accepted_per_router"] == {"A": 5, "B": 5}
        moved = quorum.fail_router("B")
        assert quorum.fail_router("B") == []
        quorum.drain(timeout_s=180)
        s = quorum.summary()
        assert s["lost_requests"] == [] and s["failed_routers"] == ["B"]
        assert s["failovers"] == len(moved)
        assert s["status_counts"] == {"completed": len(trace)}
        ref = gate.reference_results(CPU)
        assert {rid: t.result.tobytes()
                for rid, t in quorum.results().items()} == ref
        with pytest.raises(RuntimeError, match="last quorum member"):
            quorum.fail_router("A")
    finally:
        for r in routers.values():
            r.shutdown()


# ---------------------------------------------------------------------------
# Tenant migration
# ---------------------------------------------------------------------------

def test_migrate_hands_checkpoints_off_and_the_destination_resumes(fleet,
                                                                   tmp_path):
    ckpt = str(tmp_path / "ckpt")
    router = _router(fleet, checkpoint_dir=ckpt)
    try:
        trace = _gate_trace(router.n_rows)
        tenant = trace[0].tenant
        mine = [r for r in trace if r.tenant == tenant]
        first = [router.submit(r) for r in mine]
        router.drain(timeout_s=180)
        assert all(t.status == "completed" for t in first)
        src = router._place(tenant)
        stems = [s for s in list_checkpoints(ckpt)
                 if os.path.basename(s) in {f"ck_{r.request_id}"
                                            for r in mine}]
        assert stems
        before = {s: open(s + ".npz", "rb").read() for s in stems}
        dry = router.migrate(tenant, scratch_budget_bytes=256,
                             dry_run=True)
        assert dry["dry_run"] and len(dry["checkpoints"]) == len(stems)
        assert router.fleet_summary()["tenant_pins"] == {}
        assert router._place(tenant) == src
        assert {s: open(s + ".npz", "rb").read() for s in stems} == before
        mig = router.migrate(tenant, scratch_budget_bytes=256)
        dst = mig["to_worker"]
        assert mig["from_worker"] == src != dst
        assert len(mig["checkpoints"]) == len(stems)
        from arrow_matrix_tpu.parallel.reshard import handoff_plan

        for h in mig["checkpoints"]:
            want = handoff_plan(h["rows"], h["k"], 256, itemsize=4,
                                src_tag=src, dst_tag=dst)
            assert h["plan"] == want.describe()
            assert h["n_stages"] == want.n_stages > 1
            assert max(h["stage_bytes"]) <= 256
        # The handoff rewrote the same bits (pure row copies).
        for s in stems:
            with np.load(s + ".npz") as a:
                x = a["x"]
            with np.load(io.BytesIO(before[s])) as b:
                assert x.tobytes() == b["x"].tobytes()
        again = [router.submit(r) for r in mine]
        router.drain(timeout_s=180)
        for t, t0 in zip(again, first):
            assert t.status == "completed" and t.worker_id == dst
            assert t.resumed_step == gate.ITERS      # nothing recomputed
            assert t.result.tobytes() == t0.result.tobytes()
        s = router.fleet_summary()
        assert s["migrations"] == 1 and s["tenant_pins"] == {tenant: dst}
    finally:
        router.shutdown()


# ---------------------------------------------------------------------------
# Spawned processes: the CLI and the gate
# ---------------------------------------------------------------------------

def _cli(module, run_dir, extra=(), timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    env.pop("AMT_FAULT_PLAN", None)
    cmd = [sys.executable, "-m", module, "--run_dir", run_dir,
           "--workers", "2", "--vertices", "64", "--width", "16",
           "--requests", "4", "--iterations", "2", *extra]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_graft_fleet_cpu_verdict_has_the_jax_verdicts_keys(tmp_path):
    port = _cli("arrow_matrix_tpu_torch.cli.graft_fleet",
                str(tmp_path / "port"), ("--device", "cpu"))
    ref = _cli("arrow_matrix_tpu.cli.graft_fleet", str(tmp_path / "jax"))
    assert set(port) == set(ref)
    for key in ("requests", "completed", "failed", "shed", "rejected",
                "workers", "dead_workers", "hosts", "transports"):
        assert port[key] == ref[key], key
    run = tmp_path / "port"
    for name in ("fleet_report.json", "fleet_xray.json",
                 "xray_report.json", "pulse_merged.json"):
        assert (run / name).is_file(), name
    report = json.loads((run / "fleet_report.json").read_text())
    assert set(report["worker_hello"]) == {"worker-0", "worker-1"}
    assert all(h["device"] == "cpu" and h["budget_bytes"] > 0
               for h in report["worker_hello"].values())
    # The two operator CLIs read the run dir.
    env = dict(os.environ, PYTHONPATH=REPO)
    for cmd in (["arrow_matrix_tpu_torch.cli.graft_xray", "report",
                 str(run), "--json"],
                ["arrow_matrix_tpu_torch.cli.graft_pulse", "merge",
                 str(run / "worker-0"), str(run / "worker-1")],
                ["arrow_matrix_tpu_torch.cli.graft_pulse", "check",
                 str(run / "worker-0")]):
        proc = subprocess.run([sys.executable, "-m", *cmd], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "OK" in out


def test_the_fleet_gate_kill_scenario_on_worker_processes(tmp_path,
                                                         monkeypatch):
    """One worker of three SIGKILLs itself mid-batch: buried alone, no
    request lost, requeued work resumed from its checkpoint on a
    survivor, every result bit-equal to the replay."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    problems, ran = gate.run_fleet_scenarios(
        str(tmp_path), shape=CPU, scenarios=("fleet_kill",))
    assert ran == ["fleet_kill"] and problems == []


@pytest.mark.slow
def test_fleet_spawned_processes_roundtrip(tmp_path):
    """The real subprocess path: spawn 2 worker processes, route a
    trace, fold their run-dir ledgers, and shut down cleanly."""
    router = FleetRouter(spawn=2, vertices=64, width=16, seed=5,
                         run_dir=str(tmp_path), device="cpu")
    try:
        trace = synthetic_trace(router.n_rows, tenants=2, requests=4,
                                k=2, iterations=2, seed=3)
        tickets = [router.submit(r) for r in trace]
        router.drain(timeout_s=240)
        assert [t.status for t in tickets] == ["completed"] * 4
    finally:
        router.shutdown()
    assert router.fold_ledgers() > 0
    from arrow_matrix_tpu_torch.ledger import Ledger

    assert Ledger(str(tmp_path / "ledger")).validate() == []


@pytest.mark.slow
def test_the_whole_fleet_gate_on_the_cpu(tmp_path):
    problems, ran = gate.run_fleet_scenarios(str(tmp_path), shape=CPU)
    assert ran == list(gate.SCENARIOS) and problems == []


def test_gate_shape_defaults_are_the_jax_gates():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import fleet_gate as jgate
    finally:
        sys.path.pop(0)
    for name in ("N", "WIDTH", "K", "TENANTS", "REQUESTS", "ITERS", "SEED",
                 "TRACE_SEED", "KILL_AFTER", "HOST_KILL_ITERS"):
        assert getattr(gate, name) == getattr(jgate, name), name
    assert dataclasses.asdict(gate.GateShape())["device"] == "cuda"

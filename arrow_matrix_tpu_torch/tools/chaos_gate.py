"""Chaos gate: the fault-injection scenario matrix, on the port.

The port's counterpart of ``tools/chaos_gate.py``: the same scenario
names in the same order, each made of the port's parts.  A fault must
be **detected** (a supervisor fault event, a loud integrity error),
**recovered** (retry, rollback, restore, checkpoint resume), and the
recovered result **bit-identical** to the fault-free run's.

* ``nan``, ``hang``, ``corrupt`` run the supervisor over
  ``MultiLevelArrow(mesh=4 gloo ranks, fmt="ell")`` at the reference's
  shape (BA N=256, m=3, width 32, k=4, seed 11, 6 iterations, a
  checkpoint every 2): a seeded NaN burst at the step hook rolled back
  to a checkpoint; a stall past the watchdog drained and retried; real
  bytes of the saved artifact overwritten, the sha256 manifest failing
  the load by the file's name, the artifact restored and the run
  rebuilt.  On a mesh the plan is set alike on every rank, the
  supervisor agrees each attempt's outcome over the ranks (a fault on
  one is a fault on all, so no collective hangs), rank 0 alone touches
  the artifact, and every rank's outcome (ok, faults seen, recoveries)
  and final carriage must equal the others' and the fault-free run's.
* ``kill`` and ``kill_repl`` (not under ``fast``): ``spmm_arrow
  --devices 2 --carry --checkpoint`` (``kill_repl`` also ``--fmt sell
  --repl 2``) SIGKILLed by a kill plan after its step-4 checkpoint,
  rerun from it, its final state bit-equal to a never-killed run.
* ``sync``: ``analysis/sync.py``'s broken twins trip and RC1-RC5 hold
  over the package.
* ``kcert``: the certifier's twins trip and every kernel certifies
  (``analysis/kernels.certify_all``).
* ``lens``: the cost model's fit reproduces its own points and
  round-trips, and a planted out-of-band ratio trips the ledger gate's
  lens band.
* ``synth``: ``tune/synth.py`` is deterministic, its schedule certifies,
  a planted knob point K1 refuses is pruned with a ``kcert:`` reason,
  and a persisted program survives the store round trip while a
  corrupted record trips the certifier.
* ``host_kill``: a 4-worker fleet in two host domains loses all of
  host-1 at once mid-batch; exactly that domain is buried, its work
  requeued, no accepted request lost.
* the serving matrix (``tools/serve_gate.py``); then, not under
  ``fast``, the fleet matrix (``tools/fleet_gate.py``), ``xray_kill``
  over the trace ``fleet_kill`` left, and the reshard matrix
  (``tools/reshard_gate.py``: ``reshard_h7``, and not under ``fast``
  ``kill_mid_migration``).

    python -m arrow_matrix_tpu_torch.tools.chaos_gate [--fast] [workdir]
        [--device cpu]

Runs on the card unless ``--device cpu`` (the mesh's ranks share it
over gloo).  Exits 0 when every scenario passes.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

ITERS = 6
N, WIDTH, K = 256, 32, 4
SEED = 11
RANKS = 4

#: The in-process mesh scenarios, in the reference's order.
MESH_SCENARIOS = ("nan", "hang", "corrupt")


# -- the mesh scenarios (one job on RANKS gloo ranks) ------------------------

def _load(base: str, width0: int):
    from arrow_matrix_tpu_torch.io import (
        as_levels,
        load_decomposition,
        load_level_widths,
    )

    loaded = load_decomposition(base, width0)   # manifest-verified
    widths = load_level_widths(base, width0)
    return as_levels(loaded, widths if widths is not None else width0)


def _executor(levels, width0: int, mesh):
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    return MultiLevelArrow(levels, width0, mesh=mesh, fmt="ell")


def _digest(y) -> str:
    return hashlib.sha256(y.detach().cpu().numpy().tobytes()).hexdigest()


def _supervised(ml, x0, ck, **kw):
    from arrow_matrix_tpu_torch.faults import Supervisor

    sup = Supervisor("chaos", carry=True, checkpoint_path=ck,
                     checkpoint_every=2, verbose=False, mesh=ml.mesh, **kw)
    y, ok = sup.run(lambda x, it: ml.step(x), x0, 0, ITERS)
    return {"ok": bool(ok), "faults": sup.faults_seen,
            "recoveries": sup.recoveries,
            "digest": _digest(y) if ok else None}


def mesh_rank(ctx, workdir: str, base: str, width0: int) -> dict:
    """``nan``, ``hang`` and ``corrupt`` in one rank: each scenario's
    outcome, and the problems this rank saw."""
    from arrow_matrix_tpu_torch import faults
    from arrow_matrix_tpu_torch.io import ArtifactIntegrityError, num_rows
    from arrow_matrix_tpu_torch.io.graphio import FileKind, format_path
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.utils import random_dense

    from arrow_matrix_tpu_torch.obs import flight

    faults.clear_plan()
    rec = flight.FlightRecorder(os.path.join(workdir,
                                             f"flight_rank{ctx.rank}.json"))
    flight.set_recorder(rec)
    mesh = make_mesh((ctx.world,), ("blocks",))
    levels = _load(base, width0)
    ml = _executor(levels, width0, mesh)
    x0 = ml.set_features(random_dense(num_rows(levels[0].matrix), K,
                                      seed=7))
    out = {"baseline": _supervised(ml, x0, None)}

    def ck(tag):
        return os.path.join(workdir, f"ck_{tag}")

    for name, plan, kw in (
            ("nan", {"scenario": "nan", "site": "multi_level.step",
                     "after": 3, "seed": 5}, {}),
            ("hang", {"scenario": "hang", "site": "multi_level.step",
                      "after": 2, "hang_s": 1.2},
             {"watchdog_s": 0.3, "watchdog_grace_s": 60.0})):
        # The same plan on every rank: the hook fires at the same hit
        # of each rank's step.
        faults.set_plan(plan)
        try:
            out[name] = _supervised(ml, x0, ck(name), **kw)
        finally:
            faults.clear_plan()

    # corrupt: rank 0 flips real bytes mid-file; every rank's load must
    # fail naming the file; rank 0 restores; every rank rebuilds.
    victim = format_path(base, width0, 0, True, FileKind.data)
    pristine = None
    if ctx.rank == 0:
        with open(victim, "rb") as fh:
            pristine = fh.read()
        with open(victim, "r+b") as fh:
            fh.seek(max(0, len(pristine) // 2))
            fh.write(b"\xff\x00\xff\x00\xff\x00\xff\x00")
    coll.all_reduce_max(0, mesh, None)          # the bytes are flipped
    try:
        _load(base, width0)
        caught = "loaded without an integrity error"
    except ArtifactIntegrityError as e:
        caught = (None if os.path.basename(victim) in str(e)
                  else f"integrity error does not name the file: {e}")
    coll.all_reduce_max(0, mesh, None)          # every rank has tried
    if ctx.rank == 0:
        with open(victim, "wb") as fh:
            fh.write(pristine)
    coll.all_reduce_max(0, mesh, None)          # restored
    ml2 = _executor(_load(base, width0), width0, mesh)
    out["corrupt"] = dict(_supervised(ml2, x0, ck("corrupt")),
                          detected=caught)
    rec.seal("chaos gate rank done")
    flight.set_recorder(None)
    out["kinds"] = sorted({e.get("kind") for e in rec.events})
    return out


def check_mesh(per_rank: list) -> list:
    """Problems of the mesh scenarios from every rank's outcomes: each
    detected, recovered and bit-identical to the fault-free run, the
    ranks in agreement."""
    problems = []
    for r, res in enumerate(per_rank):
        base = res["baseline"]
        if not base["ok"]:
            problems.append(f"baseline: rank {r}: the fault-free "
                            f"supervised run failed")
            continue
        for name in MESH_SCENARIOS:
            o = res[name]
            tag = f"{name}: rank {r}"
            if not o["ok"]:
                problems.append(f"{tag}: supervised run did not complete")
                continue
            if name != "corrupt":
                if o["faults"] == 0:
                    problems.append(f"{tag}: the injected fault was not "
                                    f"detected")
                if o["recoveries"] == 0:
                    problems.append(f"{tag}: no recovery was taken")
            elif o["detected"] is not None:
                problems.append(f"{tag}: corrupted artifact "
                                f"{o['detected']}")
            if o["digest"] != base["digest"]:
                problems.append(f"{tag}: recovered final X is not "
                                f"bit-identical to the fault-free run")
    for name in ("baseline",) + MESH_SCENARIOS:
        seen = {(o[name]["ok"], o[name]["faults"], o[name]["recoveries"])
                for o in per_rank}
        if len(seen) != 1:
            problems.append(f"{name}: the ranks disagree on the outcome "
                            f"(ok, faults, recoveries): {sorted(seen)}")
    return problems


def build_artifact(workdir: str):
    """The gate's artifact on disk: (base path, level-0 width)."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import save_decomposition
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    a = barabasi_albert(N, 3, seed=SEED)
    levels = arrow_decomposition(a, WIDTH, max_levels=10,
                                 block_diagonal=True, seed=SEED)
    base = os.path.join(workdir, "ba")
    save_decomposition(levels, base)
    return base, levels[0].arrow_width


# -- the subprocess kill scenarios ---------------------------------------

def _kill_scenario(workdir: str, tag: str, extra: list, device) -> list:
    """``spmm_arrow --devices 2 --carry --checkpoint`` never killed, then
    SIGKILLed at hit 5 (iteration 4, after the step-2 and step-4
    checkpoints), then rerun; the final states must be equal."""
    from arrow_matrix_tpu_torch.utils.checkpoint import load_state

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("AMT_FAULT_PLAN", None)
    sfx = "" if tag == "kill" else "_repl"
    ck_ok = os.path.join(workdir, f"ck_ref{sfx}")
    ck_kill = os.path.join(workdir, f"ck_kill{sfx}")
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.spmm_arrow",
           "--devices", "2", "--vertices", str(N), "--width", str(WIDTH),
           "--features", str(K), "--device", str(device or "cuda"),
           "--carry", "true", "--seed", str(SEED),
           "--iterations", str(ITERS), "--checkpoint_every", "2",
           "--logdir", os.path.join(workdir, f"logs{sfx}"), *extra]

    def run(more, fault_env=None):
        e = dict(env)
        if fault_env:
            e["AMT_FAULT_PLAN"] = fault_env
        return subprocess.run(cmd + more, env=e, cwd=workdir,
                              capture_output=True, text=True, timeout=600)

    r = run(["--checkpoint", ck_ok])
    if r.returncode != 0:
        return [f"{tag}: fault-free reference run failed rc="
                f"{r.returncode}: {r.stderr[-500:]}"]
    plan = json.dumps({"scenario": "kill", "site": "*.step", "after": 5})
    r = run(["--checkpoint", ck_kill], fault_env=plan)
    if r.returncode == 0:
        return [f"{tag}: injected SIGKILL did not terminate the run"]
    mid = load_state(ck_kill)
    if mid is None:
        return [f"{tag}: no checkpoint survived the SIGKILL"]
    problems = []
    if mid[1] != 4:
        problems.append(f"{tag}: expected the step-4 checkpoint to "
                        f"survive, found step {mid[1]}")
    r = run(["--checkpoint", ck_kill])
    if r.returncode != 0:
        return problems + [f"{tag}: resume run failed rc={r.returncode}: "
                           f"{r.stderr[-500:]}"]
    if "resumed" not in r.stdout:
        problems.append(f"{tag}: rerun did not report resuming from the "
                        f"checkpoint")
    a, b = load_state(ck_ok), load_state(ck_kill)
    if a is None or b is None:
        return problems + [f"{tag}: final checkpoints missing"]
    if a[1] != ITERS or b[1] != ITERS:
        problems.append(f"{tag}: final steps {a[1]}/{b[1]} != {ITERS}")
    if a[0].cpu().numpy().tobytes() != b[0].cpu().numpy().tobytes():
        problems.append(f"{tag}: resumed run's final X is not "
                        f"bit-identical to the never-killed run")
    return problems


def scenario_kill(workdir, device=None):
    return _kill_scenario(workdir, "kill", [], device)


def scenario_kill_repl(workdir, device=None):
    """``kill`` under 2.5D replication (``--fmt sell --repl 2``, k=4:
    each replica group carries 2 features): the saved checkpoint must be
    the merged carriage, or the resumed run diverges."""
    return _kill_scenario(workdir, "kill_repl",
                          ["--fmt", "sell", "--repl", "2"], device)


# -- the host-side scenarios ---------------------------------------------

def scenario_sync():
    """RC1-RC5 hold over the package and the analyzer's broken twins
    trip."""
    from arrow_matrix_tpu_torch.analysis import sync as graft_sync

    problems = []
    ok, lines = graft_sync.selftest()
    if not ok:
        problems += [f"sync: {ln}" for ln in lines]
    report = graft_sync.analyze_package()
    problems += [f"sync: {f.format()}" for f in report.findings]
    return problems


def scenario_kcert():
    """The certifier's broken twins trip and every registered kernel
    certifies under KC1-KC5."""
    from arrow_matrix_tpu_torch.analysis import kernels as graft_kcert

    problems = []
    ok, lines = graft_kcert.selftest()
    if not ok:
        problems += [f"kcert: {ln}" for ln in lines]
    for rec in graft_kcert.certify_all():
        problems += [f"kcert: {f}" for f in rec["findings"]]
    return problems


def scenario_lens(workdir):
    """The cost model's fit reproduces its points and round-trips
    losslessly, and a planted out-of-band ratio trips the ledger gate's
    lens band."""
    from arrow_matrix_tpu_torch.ledger import gate as ledger_gate
    from arrow_matrix_tpu_torch.ledger.store import Ledger
    from arrow_matrix_tpu_torch.obs.costmodel import (
        CostModel,
        fit_cost_model,
    )

    problems = []
    pts = [
        {"family": "xla:tail", "nnz": 1000, "rows": 200,
         "streamed_bytes": 400000, "measured_ms": 0.05},
        {"family": "xla:tail", "nnz": 2000, "rows": 400,
         "streamed_bytes": 800000, "measured_ms": 0.10},
        {"family": "xla:mid", "nnz": 1500, "rows": 100,
         "streamed_bytes": 600000, "measured_ms": 0.06},
        {"family": "xla:mid", "nnz": 3000, "rows": 200,
         "streamed_bytes": 1200000, "measured_ms": 0.12},
    ]
    model = fit_cost_model(pts, structure_hash="chaos", platform="cpu")
    for p in pts:
        pred = model.predict_point(p["family"], p["nnz"], p["rows"],
                                   p["streamed_bytes"])
        if pred <= 0 or not 0.5 <= p["measured_ms"] / pred <= 2.0:
            problems.append(f"lens: fit does not reproduce its own points: "
                            f"{p['family']} measured {p['measured_ms']} vs "
                            f"predicted {pred}")
    if CostModel.from_dict(model.to_dict()).to_dict() != model.to_dict():
        problems.append("lens: CostModel round trip is lossy")
    lg = Ledger(os.path.join(workdir, "lens_ledger"))
    rec = lg.record("lens", "lens_ratio_chaos", 3.0, unit="ratio",
                    structure_hash="chaos", host_load=None)
    failures, _ = ledger_gate.check_records([rec], {"metrics": {}})
    if not any("lens miscalibration" in f for f in failures):
        problems.append("lens: planted out-of-band ratio record (3.0) did "
                        "NOT trip the ledger gate's lens band")
    return problems


def scenario_synth(workdir):
    """Synthesis is deterministic over a hand-built 4-tier ladder, its
    schedule certifies, a planted knob point K1 refuses (batch 3) is
    pruned with a ``kcert:`` reason, and a persisted program survives
    the store round trip while a corrupted record trips the
    certifier."""
    from arrow_matrix_tpu_torch.analysis import kernels as graft_kcert
    from arrow_matrix_tpu_torch.ops.kernel_contract import unregister_kernel
    from arrow_matrix_tpu_torch.tune import synth

    problems = []
    fp = {"n": 96, "binary": True, "total_rows": 120,
          "ladder": {"rows": [24, 64, 24, 8], "nnz": [0, 180, 300, 400],
                     "slots": [0, 256, 384, 512],
                     "slot_width": [0, 4, 16, 80]}}
    s1 = synth.synthesize_schedule(fp)
    if s1 != synth.synthesize_schedule(fp):
        problems.append("synth: synthesize_schedule is not deterministic "
                        "over the same fingerprint")
    fams = [e["family"] for e in s1]
    if fams != ["tail", "mid", "head"]:
        problems.append(f"synth: 4-tier ladder (zero/tail/mid/head) "
                        f"synthesized families {fams}, expected "
                        f"['tail', 'mid', 'head']")
    why = graft_kcert.certify_candidate_opts({"schedule": s1}, 16)
    if why is not None:
        problems.append(f"synth: freshly synthesized schedule did not "
                        f"certify: {why}")
    why = graft_kcert.certify_candidate_opts(
        {"schedule": [dict(s1[0], batch=3)]}, 16)
    if why is None or not why.startswith("kcert:"):
        problems.append(f"synth: planted batch=3 schedule was NOT pruned "
                        f"with a kcert: reason (got {why!r})")
    store = os.path.join(workdir, "synth_store.json")
    name = synth.persist_program(fp, "chaos" + "0" * 11, 16, s1, path=store)
    try:
        names = synth.register_persisted_programs(store)
        if name not in names:
            problems.append(f"synth: persisted program {name} did not "
                            f"come back from the store (got {names})")
        progs = synth.load_store(store)["programs"]
        rec = graft_kcert.certify_entry(
            synth.entry_from_program(name, progs[name]))
        if rec["findings"]:
            problems.append(f"synth: persisted program does not certify: "
                            f"{rec['findings']}")
        corrupt = dict(progs[name])
        corrupt["schedule"] = [dict(e, batch=3)
                               for e in corrupt["schedule"]]
        try:
            rec = graft_kcert.certify_entry(
                synth.entry_from_program(name + "_corrupt", corrupt))
            tripped = bool(rec["findings"])
        except ValueError:
            tripped = True                 # refused before certifying
        if not tripped:
            problems.append("synth: corrupted store record (batch 3) did "
                            "NOT trip the certifier")
    finally:
        unregister_kernel(name)
    return problems


def scenario_host_kill(workdir, device=None):
    """A bounded 2-domain fleet (4 spawned workers, host-0/host-1) loses
    all of host-1 to one SIGKILL mid-batch: exactly that domain buried,
    its accepted work requeued onto host-0, zero accepted requests
    lost, every completed result finite."""
    import time as time_mod

    import numpy as np

    from arrow_matrix_tpu_torch.fleet.router import FleetRouter
    from arrow_matrix_tpu_torch.serve import request as rq
    from arrow_matrix_tpu_torch.serve.loadgen import synthetic_trace

    problems = []
    router = FleetRouter(spawn=4, hosts=2, vertices=96, width=16,
                         seed=SEED, fmt="fold",
                         checkpoint_dir=os.path.join(workdir,
                                                     "host_kill_ckpt"),
                         device=device, name="hostchaos")
    try:
        hm = router.host_map()
        if sorted(hm) != ["host-0", "host-1"] \
                or hm["host-1"] != ["worker-2", "worker-3"]:
            return [f"host_kill: 4 workers did not split into two "
                    f"contiguous domains: {hm}"]
        trace = synthetic_trace(router.n_rows, tenants=5, requests=8,
                                k=2, iterations=4, seed=5)
        tickets = [router.submit(r) for r in trace]
        deadline = time_mod.monotonic() + 120
        while time_mod.monotonic() < deadline:
            if any(t.status in rq.TERMINAL for t in tickets):
                break
            time_mod.sleep(0.02)
        victims = router.kill_host("host-1")
        for wid in victims:
            router._on_worker_failure(wid, "host-1 killed (chaos)")
        router.drain(timeout_s=240)
        summ = router.fleet_summary()
        if sorted(summ["dead_workers"]) != sorted(victims):
            problems.append(f"host_kill: buried {summ['dead_workers']} != "
                            f"the whole killed domain {sorted(victims)}")
        if summ.get("live_hosts") != ["host-0"]:
            problems.append(f"host_kill: live hosts "
                            f"{summ.get('live_hosts')} != ['host-0']")
        lost = [t.request.request_id for t in tickets
                if t.status not in rq.TERMINAL]
        if lost:
            problems.append(f"host_kill: LOST requests {lost}")
        if summ["failed"]:
            problems.append(f"host_kill: {summ['failed']} request(s) failed "
                            f"instead of requeueing")
        if summ["completed"] + summ["shed"] + summ["rejected"] \
                != len(tickets):
            problems.append(f"host_kill: zero-loss violated — "
                            f"{summ['completed']} completed + "
                            f"{summ['shed'] + summ['rejected']} shed != "
                            f"{len(tickets)} accepted")
        if summ["requeues"] < 1:
            problems.append("host_kill: the domain died with no request "
                            "requeued — the kill landed outside the "
                            "in-flight window")
        for t in tickets:
            if t.status == rq.COMPLETED and (
                    t.result is None or not np.all(np.isfinite(t.result))):
                problems.append(f"host_kill: completed request "
                                f"{t.request.request_id} carries a bad "
                                f"result")
    finally:
        router.shutdown()
    return problems


def scenario_xray_kill(workdir):
    """The merged trace ``fleet_kill`` left must still carry the killed
    worker's track, rebuilt from its flight ring with explicit
    ``truncated`` markers and a request id shared with the router."""
    path = os.path.join(workdir, "fleet_kill", "fleet_xray.json")
    try:
        with open(path, encoding="utf-8") as fh:
            trace = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"xray_kill: merged fleet trace unreadable: {e}"]
    problems = []
    xr = trace.get("xray") or {}
    procs = {p["process"]: p for p in xr.get("processes", [])}
    victim = procs.get("worker-1")
    if victim is None:
        return ["xray_kill: the SIGKILLed worker-1 has no track in the "
                "merged trace (flight-ring recovery failed)"]
    if ("worker-1" not in (xr.get("truncated") or [])
            or not victim.get("truncated")):
        problems.append("xray_kill: worker-1's recovered track is not "
                        "marked truncated")
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    vic = [e for e in events if e.get("pid") == victim.get("pid")]
    if not vic:
        return problems + ["xray_kill: no spans recovered from worker-1's "
                           "flight ring"]
    untagged = sorted({e["name"] for e in vic
                       if not (e.get("args") or {}).get("truncated")})
    if untagged:
        problems.append(f"xray_kill: recovered spans lack the explicit "
                        f"truncated marker: {untagged}")

    def rids(evs):
        return {m for e in evs
                for m in str((e.get("args") or {}).get("request_id", ""))
                .split("+") if m}

    vic_rids = rids(vic)
    if not vic_rids:
        problems.append("xray_kill: no recovered victim span carries a "
                        "request id")
    router_pid = procs.get("router", {}).get("pid")
    if vic_rids and not vic_rids & rids(
            [e for e in events if e.get("pid") == router_pid]):
        problems.append("xray_kill: no request id shared between the "
                        "router track and the victim's recovered track")
    return problems


# -- the matrix ----------------------------------------------------------

def run_gate(workdir, fast=False, device=None):
    """Run the matrix; returns (problems, scenarios_run)."""
    from arrow_matrix_tpu_torch import faults
    from arrow_matrix_tpu_torch.obs import flight
    from arrow_matrix_tpu_torch.parallel.launch import spawn
    from arrow_matrix_tpu_torch.tools import (
        fleet_gate,
        reshard_gate,
        serve_gate,
    )

    workdir = os.path.abspath(workdir)
    rec = flight.FlightRecorder(os.path.join(workdir, "flight.json"))
    flight.set_recorder(rec)
    faults.clear_plan()   # a stray AMT_FAULT_PLAN must not skew the gate
    try:
        base, width0 = build_artifact(workdir)
        per_rank = spawn(mesh_rank, RANKS, (workdir, base, width0),
                         backend="gloo", device=device, threads=1)
        problems = check_mesh(per_rank)
        scenarios = list(MESH_SCENARIOS)
        steps = [("sync", scenario_sync), ("kcert", scenario_kcert),
                 ("lens", lambda: scenario_lens(workdir)),
                 ("synth", lambda: scenario_synth(workdir)),
                 ("host_kill", lambda: scenario_host_kill(workdir,
                                                          device))]
        if not fast:
            steps[:0] = [("kill", lambda: scenario_kill(workdir, device)),
                         ("kill_repl",
                          lambda: scenario_kill_repl(workdir, device))]
        for name, fn in steps:
            scenarios.append(name)
            problems += fn()
        sp, ss = serve_gate.run_serve_scenarios(workdir, fast=fast,
                                                device=device)
        problems += sp
        scenarios += ss
        fp, fs = fleet_gate.run_fleet_scenarios(
            workdir, fast=fast,
            shape=fleet_gate.GateShape(device=device or "cuda"))
        problems += fp
        scenarios += fs
        if "fleet_kill" in fs:
            scenarios.append("xray_kill")
            problems += scenario_xray_kill(workdir)
        scenarios.append("reshard_h7")
        problems += reshard_gate.scenario_reshard_h7(device)
        if not fast:
            scenarios.append("kill_mid_migration")
            problems += reshard_gate.scenario_kill_mid_migration(
                workdir, device)["problems"]
        # The mesh scenarios' supervisors ran in the ranks: their flight
        # events are in each rank's recorder.
        kinds = {e.get("kind") for e in rec.events}.union(
            *(r["kinds"] for r in per_rank))
        if "fault" not in kinds or "heal" not in kinds:
            problems.append(f"flight recorder saw kinds {sorted(kinds)} — "
                            f"fault and heal events are required")
        if "serve" not in kinds:
            problems.append(f"flight recorder saw kinds {sorted(kinds)} — "
                            f"serve events are required")
        return problems, scenarios
    finally:
        rec.seal("chaos gate done")
        flight.set_recorder(None)


def main(argv=None) -> int:
    import argparse
    import tempfile

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("--fast", action="store_true",
                   help="skip the subprocess scenarios (kill, kill_repl, "
                        "serve_kill, the fleet, kill_mid_migration)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    workdir = os.path.abspath(args.workdir
                              or tempfile.mkdtemp(prefix="chaos_gate_"))
    os.makedirs(workdir, exist_ok=True)
    problems, scenarios = run_gate(workdir, fast=args.fast,
                                   device=args.device)
    if problems:
        for prob in problems:
            print(f"chaos gate: {prob}", file=sys.stderr)
        print("chaos gate: FAILED", file=sys.stderr)
        return 1
    print(f"chaos gate: ok — scenarios {'+'.join(scenarios)} detected, "
          f"recovered, bit-identical ({workdir})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

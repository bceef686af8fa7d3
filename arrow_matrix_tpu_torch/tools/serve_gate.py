"""Serve gate: chaos under load for the port's serving runtime.

The port's counterpart of ``tools/serve_gate.py``, with its scenarios
under its names and at its shape (BA N=128, width 16, 4 tenants, 8
requests of 4 iterations at k=2, seed 11): a synthetic trace runs
against an :class:`~arrow_matrix_tpu_torch.serve.ArrowServer` while
faults land mid-flight, and every scenario must end detected and
recovered (or explicitly shed), every surviving request bit-identical
to a fault-free replay, the server never restarted from outside:

* ``serve_hang`` — a stall outlasts the per-request watchdog with 4
  tenants queued; the request is retried and every request completes.
* ``serve_corrupt`` — a corrupted per-request checkpoint (bad bytes, a
  mismatched sha256 sidecar) is planted first; the resume detects it,
  discards it and recomputes.
* ``serve_overflow`` — a burst past the bounded queue is shed
  explicitly (count, ticket reason), the same census on a replay.
* ``serve_hbm`` — a device-memory budget with room for one request's
  carriage: one admission, every other request rejected by name, the
  peak within the budget.
* ``slo_burn_degrade`` — on a manual pulse clock two faulty windows trip
  the ``fault_rate`` burn rule once, the tenant takes one rung, the
  first healthy window clears it; results bit-equal to a fault-free run
  on the same base rung, the burn sequence replayed identically.
* ``serve_classes`` — approx (bf16) tenants under a probed certificate
  within the class tolerance of the f32 replay (not its bits), exact
  tenants bit-identical beside them, approx priced below exact, a
  request deeper than the curve served exact with its reason.
* ``serve_kill`` (a subprocess; not under ``fast``) — ``graft_serve``
  SIGKILLed mid-request by a kill plan, rerun from its checkpoints, its
  results bit-equal to a never-killed run.

``scenario_serve_nan`` (a NaN burst rolled back to a checkpoint) is not
in the reference's list; ``chip_smoke.py`` phase 15 runs it with the
in-process scenarios over its own factory and trace
(:func:`run_serve_scenarios` with ``factory``/``trace``).

    python -m arrow_matrix_tpu_torch.tools.serve_gate [--fast] [workdir]
        [--device cpu]

Runs on the card unless ``--device cpu``.  Exits 0 when every scenario
passes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

N, WIDTH, K = 128, 16, 2
TENANTS, REQUESTS, ITERS = 4, 8, 4
SEED = 11

#: The reference's scenarios, in its order (``serve_kill`` last, not
#: under ``fast``).
SCENARIOS = ("serve_hang", "serve_corrupt", "serve_overflow", "serve_hbm",
             "slo_burn_degrade", "serve_classes")


def _policy(**kw):
    from arrow_matrix_tpu_torch.faults import RetryPolicy

    base = dict(max_retries=2, backoff_s=0.01, jitter=0.2, seed=SEED)
    base.update(kw)
    return RetryPolicy(**base)


@dataclasses.dataclass
class Bench:
    """What the in-process scenarios serve: an executor factory, the
    trace, and the reference's bytes of each request."""

    factory: object
    trace: list
    ref: dict = dataclasses.field(default_factory=dict)

    @property
    def requests(self) -> int:
        return len(self.trace)

    def fresh(self) -> list:
        return [dataclasses.replace(r) for r in self.trace]

    def server(self, **kw):
        from arrow_matrix_tpu_torch.serve import ArrowServer, ExecConfig

        base = dict(queue_capacity=16, policy=_policy(), name="gate")
        base.update(kw)
        return ArrowServer(self.factory, ExecConfig(), **base)

    def run(self, server):
        from arrow_matrix_tpu_torch.serve import run_trace

        return run_trace(server, self.fresh())


def gate_trace(n_rows: int) -> list:
    from arrow_matrix_tpu_torch.serve import synthetic_trace

    return synthetic_trace(n_rows, tenants=TENANTS, requests=REQUESTS,
                           k=K, iterations=ITERS, seed=SEED)


def _result_bytes(tickets) -> dict:
    return {t.request.request_id: t.result.tobytes()
            for t in tickets if t.result is not None}


def _completed(tag, srv, want):
    s = srv.summary()
    if s["completed"] != want:
        return [f"{tag}: {s['completed']}/{want} requests completed"]
    return []


def scenario_serve_hang(b: Bench):
    """Watchdog-timeout recovery with the tenants in flight."""
    from arrow_matrix_tpu_torch import faults

    faults.set_plan({"scenario": "hang", "site": "multi_level.step",
                     "after": 3, "hang_s": 1.0})
    srv = b.server(policy=_policy(watchdog_s=0.3, watchdog_grace_s=60.0))
    try:
        tickets = b.run(srv)
    finally:
        faults.clear_plan()
    problems = _completed("serve_hang", srv, b.requests)
    if srv.faults_seen == 0:
        problems.append("serve_hang: the watchdog never fired on the "
                        "injected stall")
    if srv.recoveries == 0:
        problems.append("serve_hang: no recovery was taken")
    if _result_bytes(tickets) != b.ref:
        problems.append("serve_hang: surviving results are not "
                        "bit-identical to the fault-free replay")
    return problems


def scenario_serve_corrupt(b: Bench, workdir):
    """A corrupted per-request checkpoint under a full queue: the sha256
    sidecar fails the resume loudly; the server discards it and
    recomputes."""
    from arrow_matrix_tpu_torch.utils.checkpoint import load_state

    ckdir = os.path.join(workdir, "serve_ck_corrupt")
    os.makedirs(ckdir, exist_ok=True)
    victim = os.path.join(ckdir, "ck_r0000.npz")
    with open(victim, "wb") as fh:
        fh.write(b"\x00corrupt\xff" * 64)
    with open(victim + ".sha256", "w", encoding="utf-8") as fh:
        fh.write("0" * 64 + "\n")
    srv = b.server(checkpoint_dir=ckdir, checkpoint_every=2)
    tickets = b.run(srv)
    problems = []
    s = srv.summary()
    if s["checkpoint_corruptions"] < 1:
        problems.append("serve_corrupt: the corrupted checkpoint was not "
                        "detected")
    problems += _completed("serve_corrupt", srv, b.requests)
    if _result_bytes(tickets) != b.ref:
        problems.append("serve_corrupt: recomputed results are not "
                        "bit-identical to the fault-free replay")
    # Discarded: the path holds nothing, or the recomputed request's own
    # final checkpoint (the port keeps a request's last checkpoint).
    if os.path.exists(victim):
        final = load_state(victim[:-len(".npz")])
        iters = b.trace[0].iterations
        if final is None or final[1] != iters:
            problems.append("serve_corrupt: the corrupt checkpoint was not "
                            "discarded")
    return problems


def scenario_serve_overflow(b: Bench):
    """Burst past the bounded queue: deterministic, explicit shed."""
    capacity = 3

    def burst():
        srv = b.server(queue_capacity=capacity)
        tickets = [srv.submit(r) for r in b.fresh()]
        srv.drain()
        return srv, tickets

    srv, tickets = burst()
    problems = []
    s = srv.summary()
    want_shed = b.requests - capacity
    if s["shed"] != want_shed or s["completed"] != capacity:
        problems.append(
            f"serve_overflow: expected exactly {capacity} completed + "
            f"{want_shed} shed, got {s['completed']} + {s['shed']}")
    for t in tickets:
        if not t.done:
            problems.append(f"serve_overflow: request "
                            f"{t.request.request_id} never reached a "
                            f"terminal state (silently dropped)")
        elif t.status == "shed" and t.reason != "queue_full":
            problems.append(f"serve_overflow: shed request "
                            f"{t.request.request_id} lacks the explicit "
                            f"queue_full reason")
    for rid, payload in _result_bytes(tickets).items():
        if b.ref.get(rid) != payload:
            problems.append(f"serve_overflow: surviving request {rid} is "
                            f"not bit-identical to the fault-free replay")
    _, tickets2 = burst()
    if [(t.status, t.reason) for t in tickets] != \
            [(t.status, t.reason) for t in tickets2]:
        problems.append("serve_overflow: the shed census is not "
                        "replay-deterministic")
    return problems


def scenario_serve_hbm(b: Bench):
    """Admission control: headroom for exactly one request's carriage."""
    from arrow_matrix_tpu_torch.obs.memview import predicted_bytes_for
    from arrow_matrix_tpu_torch.serve import ExecConfig, request_price_bytes

    executor = b.factory(ExecConfig())
    resident = predicted_bytes_for(executor, 0) or 0
    price = request_price_bytes(executor, b.trace[0].k)
    srv = b.server(hbm_budget_bytes=resident + price)
    tickets = [srv.submit(r) for r in b.fresh()]
    srv.drain()
    problems = []
    s = srv.summary()
    if s["admitted"] != 1 or s["rejected"] != b.requests - 1:
        problems.append(
            f"serve_hbm: expected exactly 1 admission + "
            f"{b.requests - 1} rejections at a one-request budget, got "
            f"{s['admitted']} + {s['rejected']}")
    peak = s["hbm"]["peak_in_use_bytes"]
    if peak > resident + price:
        problems.append(f"serve_hbm: peak {peak} B exceeded the budget "
                        f"{resident + price} B — an over-budget request "
                        f"was admitted")
    for t in tickets:
        if t.status == "rejected" and t.reason != "hbm_budget":
            problems.append(f"serve_hbm: rejected request "
                            f"{t.request.request_id} lacks the explicit "
                            f"hbm_budget reason")
    for rid, payload in _result_bytes(tickets).items():
        if b.ref.get(rid) != payload:
            problems.append(f"serve_hbm: admitted request {rid} is not "
                            f"bit-identical to the fault-free replay")
    return problems


def scenario_serve_nan(b: Bench, workdir):
    """A NaN burst at a step: the finite check catches it and the
    request rolls back to its checkpoint, to the fault-free bits."""
    import shutil

    from arrow_matrix_tpu_torch import faults

    ck = os.path.join(workdir, "serve_ck_nan")
    srv = b.server(checkpoint_dir=ck, checkpoint_every=2)
    faults.set_plan({"scenario": "nan", "site": "multi_level.step",
                     "after": 5, "burst": 4, "seed": 0})
    try:
        tickets = b.run(srv)
    finally:
        faults.clear_plan()
        shutil.rmtree(ck, ignore_errors=True)
    problems = []
    if srv.faults_seen == 0 or srv.recoveries == 0:
        problems.append(f"serve_nan: {srv.faults_seen} faults seen, "
                        f"{srv.recoveries} recoveries")
    if _result_bytes(tickets) != b.ref:
        problems.append("serve_nan: recovered results are not "
                        "bit-identical to the fault-free replay")
    return problems


def scenario_slo_burn_degrade(b: Bench):
    """Measured SLO pressure drives the ladder faults drive: two
    consecutive faulty windows trip the ``fault_rate`` burn rule, the
    watchdog degrades the burning window's tenant one rung, the first
    healthy window clears the burn — on a manual clock, so the episode
    replays exactly."""
    from arrow_matrix_tpu_torch import faults
    from arrow_matrix_tpu_torch.obs import flight, pulse
    from arrow_matrix_tpu_torch.serve import ArrowServer, ExecConfig

    # overlap_slabs=2 gives the ladder a second rung (overlap 1) that
    # takes the same k.
    base_cfg = ExecConfig(overlap_slabs=2)

    def one_pass(inject):
        now = [0.0]
        mon = pulse.PulseMonitor(
            window_s=1.0, clock=lambda: now[0], name="gate-burn",
            watchdog=pulse.SloWatchdog(
                [pulse.BurnRule.fault_rate(0.0, min_windows=2)]))
        # degrade_after=100: only the watchdog's forced score moves the
        # ladder in this run.
        srv = ArrowServer(b.factory, base_cfg, queue_capacity=16,
                          policy=_policy(), degrade_after=100,
                          name="gate-burn")
        srv.attach_pulse(mon)
        tickets = []
        try:
            for i, r in enumerate(b.fresh()):
                if inject and i < 2:
                    faults.set_plan({"scenario": "error",
                                     "site": "multi_level.step",
                                     "after": 0, "count": 1})
                else:
                    faults.clear_plan()
                tickets.append(srv.submit(r))
                srv.drain()
                now[0] += 1.0
                mon.advance()
        finally:
            faults.clear_plan()
        mon.close("scenario done")
        return srv, mon, tickets

    ref_srv, _, ref_tickets = one_pass(inject=False)
    if ref_srv.summary()["completed"] != b.requests:
        return ["slo_burn_degrade: fault-free reference run on the overlap "
                "base rung did not complete every request"]
    ref = _result_bytes(ref_tickets)
    srv, mon, tickets = one_pass(inject=True)
    problems = _completed("slo_burn_degrade", srv, b.requests)
    s = srv.summary()
    burns = [(e["rule"], e["window"]) for e in mon.burn_events
             if e["event"] == "slo_burn"]
    if burns != [("fault_rate", 1)]:
        problems.append(f"slo_burn_degrade: expected one fault_rate burn "
                        f"at window 1, got {burns}")
    cleared = [(e["rule"], e["window"]) for e in mon.burn_events
               if e["event"] == "slo_burn_cleared"]
    if cleared != [("fault_rate", 2)]:
        problems.append(f"slo_burn_degrade: expected one recovery "
                        f"(slo_burn_cleared) at window 2, got {cleared}")
    faulty = [w["window"] for w in mon.series() if w["faults_seen"]]
    if faulty != [0, 1]:
        problems.append(f"slo_burn_degrade: injected faults landed in "
                        f"windows {faulty}, expected [0, 1]")
    hits = [(name, d) for name, t in s["tenants"].items()
            for d in t["degradations"]]
    burn_hits = [(name, d) for name, d in hits
                 if d["reason"] == "slo_burn:fault_rate"]
    if len(burn_hits) != 1:
        problems.append(f"slo_burn_degrade: expected exactly one "
                        f"slo_burn:fault_rate degradation, got "
                        f"{[(n, d['reason']) for n, d in hits]}")
    else:
        name, d = burn_hits[0]
        if s["tenants"][name]["rung"] != 1 \
                or d["to"]["overlap_slabs"] != 1:
            problems.append(
                f"slo_burn_degrade: tenant {name} should sit on rung 1 "
                f"(overlap_slabs=1), got rung "
                f"{s['tenants'][name]['rung']} -> {d['to']}")
    if _result_bytes(tickets) != ref:
        problems.append("slo_burn_degrade: surviving results are not "
                        "bit-identical to the fault-free run on the same "
                        "base rung")
    rec = flight.get_recorder()
    if rec is not None and "slo_burn" not in {e.get("kind")
                                              for e in rec.events}:
        problems.append("slo_burn_degrade: the watchdog trip left no "
                        "slo_burn flight event")
    _, mon2, tickets2 = one_pass(inject=True)
    seq = [(e["event"], e["rule"], e["window"]) for e in mon.burn_events]
    seq2 = [(e["event"], e["rule"], e["window"])
            for e in mon2.burn_events]
    if seq != seq2:
        problems.append(f"slo_burn_degrade: burn-event sequence is not "
                        f"replay-deterministic: {seq} vs {seq2}")
    if [(t.status, t.reason) for t in tickets] != \
            [(t.status, t.reason) for t in tickets2]:
        problems.append("slo_burn_degrade: the ticket census is not "
                        "replay-deterministic")
    if _result_bytes(tickets2) != _result_bytes(tickets):
        problems.append("slo_burn_degrade: replayed results are not "
                        "bit-identical")
    return problems


def scenario_serve_classes(b: Bench, device=None):
    """Approx (bf16) tenants under a probed certificate (never one made
    by hand) within the class tolerance of the f32 replay and not its
    bits; exact tenants bit-identical beside them; approx priced below
    exact; a request deeper than the curve served exact with its
    reason; the pass replay-deterministic."""
    import numpy as np

    from arrow_matrix_tpu_torch.classes import certificate_from_record
    from arrow_matrix_tpu_torch.ledger.probe import error_curves_for_source
    from arrow_matrix_tpu_torch.serve import run_trace

    source = {"kind": "ba", "n": N, "m": 3, "width": WIDTH, "seed": SEED}
    recs = error_curves_for_source(source, k=K, iterations=ITERS,
                                   seed=SEED, dtypes=("bf16",),
                                   device=device)
    cert = certificate_from_record(recs[0])
    if cert is None or not cert.covers(ITERS):
        return [f"serve_classes: the probed bf16 curve does not certify "
                f"{ITERS} iterations "
                f"(curve={None if cert is None else cert.rel_frobenius})"]

    def classed(trace):
        return [dataclasses.replace(r, traffic_class="approx")
                if r.tenant in ("tenant0", "tenant1") else r
                for r in trace]

    def one_pass():
        srv = b.server(certificates=[cert])
        return srv, run_trace(srv, classed(b.fresh()))

    srv, tickets = one_pass()
    problems = _completed("serve_classes", srv, b.requests)
    s = srv.summary()
    approx = [t for t in tickets if t.request.traffic_class == "approx"]
    exact = [t for t in tickets if t.request.traffic_class == "exact"]
    if not approx or not exact:
        return [f"serve_classes: trace split degenerate ({len(approx)} "
                f"approx / {len(exact)} exact)"]
    for t in approx:
        rid = t.request.request_id
        if t.served_class != "approx" or t.class_fallback is not None:
            problems.append(f"serve_classes: certified approx request "
                            f"{rid} was not served approx "
                            f"(served={t.served_class}, "
                            f"fallback={t.class_fallback})")
            continue
        if t.certified_bound != cert.bound_at(ITERS):
            problems.append(f"serve_classes: ticket {rid} carries bound "
                            f"{t.certified_bound}, certificate says "
                            f"{cert.bound_at(ITERS)}")
        gold = np.frombuffer(b.ref[rid], dtype=np.float32).reshape(
            t.result.shape).astype(np.float64)
        rel = float(np.linalg.norm(t.result.astype(np.float64) - gold)
                    / np.linalg.norm(gold))
        if rel > cert.tolerance:
            problems.append(f"serve_classes: approx result {rid} drifted "
                            f"rel={rel:.3e} past the class tolerance "
                            f"{cert.tolerance:.0e}")
        if rel == 0.0:
            problems.append(f"serve_classes: approx request {rid} returned "
                            f"the f32 bits — the reduced carriage never "
                            f"ran")
    for t in exact:
        rid = t.request.request_id
        if rid in b.ref and (t.result is None
                             or t.result.tobytes() != b.ref[rid]):
            problems.append(f"serve_classes: exact request {rid} is not "
                            f"bit-identical beside approx traffic")
    if approx[0].predicted_bytes >= exact[0].predicted_bytes:
        problems.append(f"serve_classes: approx admission price "
                        f"{approx[0].predicted_bytes} B is not below exact "
                        f"{exact[0].predicted_bytes} B")
    deep = dataclasses.replace(b.trace[0], iterations=ITERS + 2,
                               traffic_class="approx")
    t_deep = srv.submit(deep)
    srv.drain()
    if t_deep.status != "completed" or t_deep.served_class != "exact" \
            or t_deep.class_fallback != "curve_shorter_than_request":
        problems.append(
            f"serve_classes: beyond-curve approx request ended "
            f"{t_deep.status}/{t_deep.served_class} with fallback "
            f"{t_deep.class_fallback!r} (want completed/exact/"
            f"curve_shorter_than_request)")
    if s["classes"]["approx"]["completed"] != len(approx):
        problems.append(f"serve_classes: summary counts "
                        f"{s['classes']['approx']['completed']} approx "
                        f"completions, trace had {len(approx)}")
    _, tickets2 = one_pass()
    if [(t.status, t.served_class, t.class_fallback) for t in tickets] != \
            [(t.status, t.served_class, t.class_fallback)
             for t in tickets2]:
        problems.append("serve_classes: the class census is not "
                        "replay-deterministic")
    if _result_bytes(tickets) != _result_bytes(tickets2):
        problems.append("serve_classes: approx results are not "
                        "replay-deterministic")
    return problems


def scenario_serve_kill(workdir, device=None):
    """SIGKILL mid-request in a checkpointing ``graft_serve`` run; the
    rerun resumes and the result set is bit-identical to a never-killed
    run."""
    import numpy as np

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("AMT_FAULT_PLAN", None)
    ck = os.path.join(workdir, "serve_ck_kill")
    ref_npz = os.path.join(workdir, "serve_ref.npz")
    kill_npz = os.path.join(workdir, "serve_kill.npz")
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_serve",
           "--vertices", str(N), "--width", str(WIDTH),
           "--features", str(K), "--tenants", str(TENANTS),
           "--requests", str(REQUESTS), "--iterations", str(ITERS),
           "--seed", str(SEED), "--device", str(device or "cuda"),
           "--checkpoint_every", "2"]

    def run(extra, fault_env=None):
        e = dict(env)
        if fault_env:
            e["AMT_FAULT_PLAN"] = fault_env
        return subprocess.run(cmd + extra, env=e, cwd=workdir,
                              capture_output=True, text=True, timeout=600)

    r = run(["--results_out", ref_npz])
    if r.returncode != 0:
        return [f"serve_kill: fault-free reference run failed rc="
                f"{r.returncode}: {r.stderr[-500:]}"]
    # 8 requests x 4 iterations = 32 step hits; hit 18 lands mid-request
    # 4, four requests done and a step-2 checkpoint for the victim.
    plan = json.dumps({"scenario": "kill", "site": "*.step", "after": 18})
    r = run(["--results_out", kill_npz, "--checkpoint", ck],
            fault_env=plan)
    if r.returncode == 0:
        return ["serve_kill: injected SIGKILL did not terminate the "
                "server"]
    r = run(["--results_out", kill_npz, "--checkpoint", ck])
    if r.returncode != 0:
        return [f"serve_kill: resume run failed rc={r.returncode}: "
                f"{r.stderr[-500:]}"]
    problems = []
    if "resumed request" not in r.stdout:
        problems.append("serve_kill: rerun did not report resuming any "
                        "request from its checkpoint")
    with np.load(ref_npz) as a, np.load(kill_npz) as b:
        if sorted(a.files) != sorted(b.files):
            problems.append(f"serve_kill: result sets differ: "
                            f"{sorted(a.files)} vs {sorted(b.files)}")
        else:
            for rid in a.files:
                if a[rid].tobytes() != b[rid].tobytes():
                    problems.append(f"serve_kill: resumed request {rid} "
                                    f"is not bit-identical to the "
                                    f"never-killed run")
    return problems


def run_serve_scenarios(workdir, fast=False, device=None, *, factory=None,
                        trace=None, scenarios=None):
    """Run the serving matrix; returns (problems, scenarios_run).

    By default the reference's scenarios over ``ba_executor_factory(N,
    WIDTH, SEED)`` on ``device`` (the card unless ``"cpu"``) and its
    trace, then ``serve_kill`` unless ``fast``.  ``factory`` and
    ``trace`` replace the executor and the trace (``chip_smoke.py``
    phase 15), ``scenarios`` the names run (among :data:`SCENARIOS`,
    ``serve_nan`` and ``serve_kill``)."""
    from arrow_matrix_tpu_torch import faults
    from arrow_matrix_tpu_torch.serve import ba_executor_factory

    faults.clear_plan()
    if factory is None:
        factory, n_rows = ba_executor_factory(N, WIDTH, SEED, fmt="fold",
                                              device=device)
        trace = gate_trace(n_rows)
    b = Bench(factory, list(trace))
    ref_srv = b.server()
    ref_tickets = b.run(ref_srv)
    if ref_srv.summary()["completed"] != b.requests:
        return (["serve baseline: fault-free serve run did not complete "
                 "every request"], [])
    b.ref = _result_bytes(ref_tickets)
    names = list(SCENARIOS if scenarios is None else scenarios)
    if scenarios is None and not fast:
        names.append("serve_kill")
    run = {"serve_hang": lambda: scenario_serve_hang(b),
           "serve_corrupt": lambda: scenario_serve_corrupt(b, workdir),
           "serve_overflow": lambda: scenario_serve_overflow(b),
           "serve_hbm": lambda: scenario_serve_hbm(b),
           "serve_nan": lambda: scenario_serve_nan(b, workdir),
           "slo_burn_degrade": lambda: scenario_slo_burn_degrade(b),
           "serve_classes": lambda: scenario_serve_classes(b, device),
           "serve_kill": lambda: scenario_serve_kill(workdir, device)}
    problems = []
    for name in names:
        problems += run[name]()
    return problems, names


def main(argv=None) -> int:
    import argparse
    import tempfile

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("--fast", action="store_true",
                   help="skip serve_kill (the subprocess scenario)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from arrow_matrix_tpu_torch import sync
    from arrow_matrix_tpu_torch.obs import flight

    # The lock-order witness is armed before any server exists, so
    # every scenario is also a lock-order run.
    registry = sync.enable_witness()
    workdir = os.path.abspath(
        args.workdir or tempfile.mkdtemp(prefix="serve_gate_"))
    os.makedirs(workdir, exist_ok=True)
    rec = flight.FlightRecorder(os.path.join(workdir, "flight.json"))
    flight.set_recorder(rec)
    try:
        problems, scenarios = run_serve_scenarios(
            workdir, fast=args.fast, device=args.device)
        kinds = {e.get("kind") for e in rec.events}
        if "serve" not in kinds:
            problems.append(f"flight recorder saw kinds {sorted(kinds)} — "
                            f"serve events are required")
    finally:
        rec.seal("serve gate done")
        flight.set_recorder(None)
    snap = registry.snapshot()
    problems.extend(f"lock witness: {v}" for v in snap["violations"])
    if not snap["acquisitions"]:
        problems.append("lock witness: zero witnessed acquisitions — the "
                        "serving stack stopped routing its locks through "
                        "sync.witnessed()")
    print(f"serve gate: lock witness — {snap['acquisitions']} "
          f"acquisitions, {len(snap['violations'])} violations",
          file=sys.stderr)
    if problems:
        for prob in problems:
            print(f"serve gate: {prob}", file=sys.stderr)
        print("serve gate: FAILED", file=sys.stderr)
        return 1
    print(f"serve gate: ok — scenarios {'+'.join(scenarios)} detected, "
          f"recovered (or explicitly shed), bit-identical ({workdir})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

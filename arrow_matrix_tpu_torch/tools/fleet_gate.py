"""Fleet chaos gate: kill-one-worker-of-N survival, on the port's fleet.

The port's counterpart of ``tools/fleet_gate.py``: the same scenarios,
run as real spawned worker processes of the port through its
``graft_fleet`` CLI, against a fault-free single-process
:class:`~arrow_matrix_tpu_torch.serve.ArrowServer` replay of the same
trace built by the port on the same device:

* **fleet_baseline** — N=2 workers, no faults: every request
  completes, every result is bit-identical to the replay, the merged
  pulse document is problem-free, and the report's fleet p99 EQUALS
  the nearest-rank pooled quantile over all workers' raw samples
  (recomputed here independently — no approximation).
* **fleet_kill** — N=3 workers with >=4 tenants in flight; one victim
  worker is armed (via its spawn environment only) with an
  ``AMT_FAULT_PLAN`` kill plan on ``*.step`` and SIGKILLs itself
  mid-batch.  Required outcome: the router buries exactly that worker
  after health probes, ZERO accepted requests are lost, at least one
  request was requeued onto a survivor, a survivor RESUMED the
  victim's checkpoint (the ``resumed request`` line in its log), and
  every result is bit-identical to the replay.
* **fleet_host_kill** — N=4 workers in TWO host fault domains;
  mid-batch, EVERY worker of host-1 is SIGKILLed at once
  (``--kill_host``) and probed to a verdict through the heartbeat
  ladder: exactly host-1's workers buried, zero loss, requeue and
  checkpoint RESUME on a host-0 survivor, results bit-identical, and
  the same-host shm wire carried payload (``wire_shm_bytes > 0``).
* **router_quorum** — two shared-nothing routers over ONE spawned
  worker set: identical placement and FFD packing with no tenant
  double-admitted (``RouterQuorum.verify_agreement``), then one router
  dies mid-batch (``fail_router``) and its accepted requests fail over
  to the survivor with zero loss, results bit-identical.
* **fleet_migrate** — ``graft_fleet migrate --resubmit``: a tenant's
  checkpoints are handed off through staged plans, every later request
  of it lands on the destination, and its resent requests are RESUMED
  there from the handed-off checkpoints (not recomputed), every result
  bit-identical to the replay.

The lock-order witness is armed in the gate's process.  Run::

    python -m arrow_matrix_tpu_torch.tools.fleet_gate [workdir]
        [--device cpu] [--fast]

On the card (the default) every worker and the replay run K1;
``chip_smoke.py`` phase 17 runs the scenarios at a larger graph
through :class:`GateShape`.  ``--fast`` skips every scenario (they are
all processes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Small enough for the CPU gate budget, big enough that a mid-batch
# SIGKILL leaves several accepted-but-unfinished requests to requeue.
N, WIDTH, K = 96, 16, 2
TENANTS, REQUESTS, ITERS = 5, 10, 4
SEED, TRACE_SEED = 11, 5
#: *.step hits before the armed worker SIGKILLs itself: late enough
#: that it accepted work, early enough that the work is unfinished.
KILL_AFTER = 6

#: Iterations for the host-kill scenario: long enough that a request
#: is mid-flight for many step+checkpoint cycles, so the router-side
#: domain SIGKILL reliably lands between a checkpoint save and the
#: request's completion (the resume-not-recompute window).
HOST_KILL_ITERS = 24

SCENARIOS = ("fleet_baseline", "fleet_kill", "fleet_host_kill",
             "router_quorum", "fleet_migrate")
#: Time limits (s) of one ``graft_fleet`` subprocess and of the quorum's
#: drain.
CLI_TIMEOUT_S, DRAIN_TIMEOUT_S = 900, 300


@dataclasses.dataclass(frozen=True)
class GateShape:
    """The operator every worker and the replay build
    (``ba_executor_factory(n, width, SEED)``) and their device."""

    n: int = N
    width: int = WIDTH
    device: str = "cuda"


def nearest_rank(vals, q):
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def reference_results(shape: GateShape, *, k=K, iters=ITERS,
                      tenants=TENANTS, requests=REQUESTS,
                      trace_seed=TRACE_SEED):
    """Fault-free single-process replay of the gate trace on
    ``shape.device``: the bit-identity reference the scenarios compare
    against (request id -> result bytes), or None when a request did
    not complete."""
    from arrow_matrix_tpu_torch.serve.loadgen import (
        ba_executor_factory,
        run_trace,
        synthetic_trace,
    )
    from arrow_matrix_tpu_torch.serve.scheduler import (
        ArrowServer,
        ExecConfig,
    )

    factory, n_rows = ba_executor_factory(shape.n, shape.width, SEED,
                                          fmt="fold",
                                          device=shape.device)
    server = ArrowServer(factory, ExecConfig(), name="fleet-ref")
    trace = synthetic_trace(n_rows, tenants=tenants,
                            requests=requests, k=k, iterations=iters,
                            seed=trace_seed)
    tickets = run_trace(server, trace)
    out = {}
    for t in tickets:
        if t.result is None:
            return None
        out[t.request.request_id] = t.result.tobytes()
    return out


def fleet_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("AMT_FAULT_PLAN", None)
    return env


def last_json(stdout: str):
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def run_fleet_cli(workdir, tag, workers, extra, shape: GateShape,
                  command=()):
    """One ``graft_fleet`` subprocess run (``command=("migrate",)`` for
    the migrate subcommand); ``extra`` arguments come last, so they
    override the gate's defaults.  Returns (completed_process,
    verdict_dict_or_None, run_dir, npz_path)."""
    run_dir = os.path.join(workdir, f"fleet_{tag}")
    npz = os.path.join(workdir, f"fleet_{tag}.npz")
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_fleet",
           *command,
           "--run_dir", run_dir, "--workers", str(workers),
           "--vertices", str(shape.n), "--width", str(shape.width),
           "--seed", str(SEED), "--k", str(K),
           "--tenants", str(TENANTS), "--requests", str(REQUESTS),
           "--iterations", str(ITERS),
           "--trace_seed", str(TRACE_SEED),
           "--device", shape.device,
           "--results_npz", npz]
    if not command:
        # Coarse pulse windows: on a loaded host the 0.25 s default
        # can idle-gap past the ring's bounded gap fill and drop
        # windows, which (correctly) fails the pooled==streamed merge
        # check for a reason that is host speed, not fleet behavior.
        cmd += ["--window_s", "2.0"]
    r = subprocess.run(cmd + list(extra), env=fleet_env(), cwd=workdir,
                       capture_output=True, text=True,
                       timeout=CLI_TIMEOUT_S)
    return r, last_json(r.stdout), run_dir, npz


def check_bit_identity(tag, npz, ref, expect_ids=None):
    import numpy as np

    problems = []
    if not os.path.exists(npz):
        return [f"{tag}: no results npz written"]
    with np.load(npz) as got:
        ids = sorted(got.files)
        want = sorted(expect_ids if expect_ids is not None else ref)
        if ids != want:
            problems.append(f"{tag}: completed set {ids} != "
                            f"expected {want}")
        for rid in ids:
            if rid in ref and got[rid].tobytes() != ref[rid]:
                problems.append(
                    f"{tag}: request {rid} is not bit-identical to "
                    f"the fault-free single-process replay")
    return problems


def check_exact_pooled_p99(tag, run_dir):
    """Recompute the pooled quantiles from the workers' RAW samples in
    fleet_report.json and require the report's merged latency to
    equal them exactly."""
    path = os.path.join(run_dir, "fleet_report.json")
    try:
        with open(path, encoding="utf-8") as fh:
            report = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{tag}: fleet_report.json unreadable: {e}"]
    samples = []
    for rec in (report.get("workers") or {}).values():
        if rec.get("alive"):
            samples.extend(rec.get("latency_samples_ms") or [])
    lat = report.get("latency_ms") or {}
    problems = []
    if len(samples) != lat.get("count"):
        problems.append(f"{tag}: merged latency count "
                        f"{lat.get('count')} != pooled sample count "
                        f"{len(samples)}")
        return problems
    if not samples:
        return [f"{tag}: no latency samples in the fleet report"]
    for q, field in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        want = nearest_rank(samples, q)
        if lat.get(field) != want:
            problems.append(
                f"{tag}: merged {field} {lat.get(field)!r} != exact "
                f"pooled quantile {want!r} over all workers' raw "
                f"samples")
    return problems


def check_xray_artifacts(tag, run_dir):
    """Every fleet run must leave ONE merged trace
    (``fleet_xray.json``) and the per-class critical-path report next
    to its fleet report."""
    problems = []
    for name in ("fleet_xray.json", "xray_report.json"):
        if not os.path.isfile(os.path.join(run_dir, name)):
            problems.append(f"{tag}: {name} artifact missing")
    return problems


def check_resumed(tag, run_dir, workers):
    """True when a worker of ``workers`` logged ``resumed request``."""
    for wid in workers:
        log = os.path.join(run_dir, wid, "worker.log")
        try:
            with open(log, encoding="utf-8") as fh:
                if "resumed request" in fh.read():
                    return True
        except OSError:
            continue
    return False


def completed_ids(run_dir):
    with open(os.path.join(run_dir, "fleet_report.json"),
              encoding="utf-8") as fh:
        report = json.load(fh)
    return sorted(t["request_id"] for t in report["tickets"]
                  if t["status"] == "completed")


def check_zero_loss(tag, verdict, requests=REQUESTS):
    problems = []
    accounted = (verdict["completed"] + verdict["failed"]
                 + verdict["shed"] + verdict["rejected"])
    if accounted != requests:
        problems.append(f"{tag}: {requests - accounted} "
                        f"request(s) LOST (no terminal state)")
    if verdict["failed"]:
        problems.append(f"{tag}: {verdict['failed']} request(s) "
                        f"failed instead of being requeued")
    shed_explicit = sum((verdict.get("shed_reasons") or {}).values())
    if shed_explicit != verdict["shed"] + verdict["rejected"]:
        problems.append(
            f"{tag}: {verdict['shed'] + verdict['rejected']} "
            f"shed/rejected but only {shed_explicit} carry an "
            f"explicit reason in the SLO report")
    if verdict["completed"] + shed_explicit != requests:
        problems.append(
            f"{tag}: zero-loss violated — "
            f"{verdict['completed']} completed + {shed_explicit} "
            f"explicitly shed != {requests} accepted")
    if verdict["requeues"] < 1:
        problems.append(f"{tag}: the victims died with no request "
                        f"requeued — the kill landed outside the "
                        f"in-flight window")
    return problems


def scenario_fleet_baseline(workdir, ref, shape: GateShape):
    """No-fault fleet run: complete, bit-identical, exact quantiles,
    clean merged pulse."""
    r, verdict, run_dir, npz = run_fleet_cli(workdir, "baseline", 2,
                                             [], shape)
    if r.returncode != 0 or verdict is None:
        return [f"fleet_baseline: run failed rc={r.returncode}: "
                f"{r.stderr[-500:]}"]
    problems = []
    if verdict["completed"] != REQUESTS:
        problems.append(f"fleet_baseline: {verdict['completed']}/"
                        f"{REQUESTS} completed")
    if verdict["dead_workers"]:
        problems.append(f"fleet_baseline: unexpected deaths "
                        f"{verdict['dead_workers']}")
    if verdict["pulse_problems"]:
        problems.append(f"fleet_baseline: merged pulse problems: "
                        f"{verdict['pulse_problems']}")
    problems += check_bit_identity("fleet_baseline", npz, ref)
    problems += check_exact_pooled_p99("fleet_baseline", run_dir)
    problems += check_xray_artifacts("fleet_baseline", run_dir)
    return problems


def scenario_fleet_kill(workdir, ref, shape: GateShape):
    """Kill-one-worker-of-N survival (the acceptance scenario)."""
    plan = json.dumps({"scenario": "kill", "site": "*.step",
                       "after": KILL_AFTER})
    r, verdict, run_dir, npz = run_fleet_cli(
        workdir, "kill", 3,
        ["--fault_worker", "worker-1", "--fault_plan", plan], shape)
    if r.returncode != 0 or verdict is None:
        return [f"fleet_kill: run failed rc={r.returncode}: "
                f"{r.stderr[-500:]}"]
    problems = []
    if verdict["dead_workers"] != ["worker-1"]:
        problems.append(f"fleet_kill: dead workers "
                        f"{verdict['dead_workers']} != ['worker-1'] "
                        f"(the armed victim, and only it)")
    problems += check_zero_loss("fleet_kill", verdict)
    # Survivors must RESUME the victim's checkpointed work, not
    # recompute it: the scheduler's resume line in a survivor log.
    if not check_resumed("fleet_kill", run_dir,
                         ("worker-0", "worker-2")):
        problems.append("fleet_kill: no survivor resumed a "
                        "checkpointed request (requeued work was "
                        "recomputed, not resumed)")
    problems += check_bit_identity("fleet_kill", npz, ref,
                                   expect_ids=completed_ids(run_dir))
    problems += check_exact_pooled_p99("fleet_kill", run_dir)
    problems += check_xray_artifacts("fleet_kill", run_dir)
    return problems


def scenario_fleet_host_kill(workdir, ref, shape: GateShape):
    """Kill-a-host survival: both host-1 workers SIGKILLed AT ONCE
    mid-batch.  Runs at ``K=4`` so that a request clears
    ``shm.SHM_MIN_BYTES`` at the gate's smallest shape, and at
    ``HOST_KILL_ITERS`` iterations so the domain SIGKILL lands inside a
    checkpointed request; ``ref`` must be the matching replay."""
    r, verdict, run_dir, npz = run_fleet_cli(
        workdir, "host_kill", 4,
        ["--hosts", "2", "--kill_host", "host-1", "--measure_wire",
         "--k", "4", "--iterations", str(HOST_KILL_ITERS)], shape)
    if r.returncode != 0 or verdict is None:
        return [f"fleet_host_kill: run failed rc={r.returncode}: "
                f"{r.stderr[-500:]}"]
    problems = []
    domain = sorted((verdict.get("hosts") or {}).get("host-1") or [])
    if domain != ["worker-2", "worker-3"]:
        problems.append(f"fleet_host_kill: host-1 domain {domain} != "
                        f"['worker-2', 'worker-3'] (contiguous "
                        f"2-host split of 4 workers)")
    if sorted(verdict["dead_workers"]) != domain:
        problems.append(
            f"fleet_host_kill: buried {verdict['dead_workers']} != "
            f"the whole killed domain {domain} (and only it)")
    if "host-0" not in (verdict.get("live_hosts") or []) \
            or "host-1" in (verdict.get("live_hosts") or []):
        problems.append(f"fleet_host_kill: live hosts "
                        f"{verdict.get('live_hosts')} != ['host-0']")
    problems += check_zero_loss("fleet_host_kill", verdict)
    if not check_resumed("fleet_host_kill", run_dir,
                         ("worker-0", "worker-1")):
        problems.append("fleet_host_kill: no host-0 survivor resumed "
                        "a checkpointed request (requeued work was "
                        "recomputed, not resumed)")
    # The same-host data plane must actually have carried payload via
    # shm descriptors, and the measured shm wire must be cheaper per
    # MB than the base64 envelope it replaces.
    if not verdict.get("wire_shm_bytes"):
        problems.append("fleet_host_kill: wire_shm_bytes == 0 — the "
                        "same-host shm data plane carried nothing")
    wm = verdict.get("wire_measured") or {}
    shm_ms = (wm.get("shm") or {}).get("serialize_ms_per_mb")
    b64_ms = (wm.get("base64") or {}).get("serialize_ms_per_mb")
    if shm_ms is None or b64_ms is None or shm_ms >= b64_ms:
        problems.append(f"fleet_host_kill: shm serialize "
                        f"{shm_ms} ms/MB is not cheaper than base64 "
                        f"{b64_ms} ms/MB")
    problems += check_bit_identity("fleet_host_kill", npz, ref,
                                   expect_ids=completed_ids(run_dir))
    problems += check_exact_pooled_p99("fleet_host_kill", run_dir)
    return problems


def scenario_router_quorum(workdir, ref, shape: GateShape):
    """Two shared-nothing routers over one worker set: provable
    placement agreement, no double-admit, router-death failover with
    zero accepted-request loss."""
    from arrow_matrix_tpu_torch.fleet.host import (
        QuorumDisagreement,
        RouterQuorum,
    )
    from arrow_matrix_tpu_torch.fleet.router import FleetRouter
    from arrow_matrix_tpu_torch.serve.loadgen import synthetic_trace

    ckpt = os.path.join(workdir, "quorum_checkpoints")
    problems = []
    routerA = FleetRouter(spawn=3, hosts=1, vertices=shape.n,
                          width=shape.width, seed=SEED, fmt="fold",
                          checkpoint_dir=ckpt, device=shape.device,
                          name="quorumA")
    routerB = None
    try:
        clones = [dataclasses.replace(h, proc=None,
                                      meta=dict(h.meta))
                  for h in routerA.workers.values()]
        routerB = FleetRouter(handles=clones, vertices=shape.n,
                              width=shape.width, seed=SEED, fmt="fold",
                              checkpoint_dir=ckpt, name="quorumB")
        quorum = RouterQuorum({"A": routerA, "B": routerB})
        trace = synthetic_trace(routerA.n_rows, tenants=TENANTS,
                                requests=REQUESTS, k=K,
                                iterations=ITERS, seed=TRACE_SEED)
        tenants = sorted({r.tenant for r in trace})
        try:
            doc = quorum.verify_agreement(
                tenants, tenant_ks={t: K for t in tenants})
        except QuorumDisagreement as e:
            return [f"router_quorum: placement split between "
                    f"shared-nothing routers: {e}"]
        if not doc["agreed"] or doc["packing"] is None:
            problems.append(f"router_quorum: agreement doc "
                            f"incomplete: {doc}")
        for r in trace:
            quorum.submit(r)
        moved = quorum.fail_router("B")
        if not moved:
            problems.append("router_quorum: router B died holding no "
                            "unfinished request — the failover window "
                            "was empty (retune the trace)")
        quorum.drain(timeout_s=DRAIN_TIMEOUT_S)
        summ = quorum.summary()
        if summ["lost_requests"]:
            problems.append(f"router_quorum: LOST requests after "
                            f"failover: {summ['lost_requests']}")
        if summ["status_counts"].get("completed", 0) != REQUESTS:
            problems.append(f"router_quorum: {summ['status_counts']} "
                            f"!= {REQUESTS} completed")
        for rid, ticket in sorted(quorum.results().items()):
            if ticket.result is None:
                problems.append(f"router_quorum: {rid} completed "
                                f"with no result array")
            elif rid in ref \
                    and ticket.result.tobytes() != ref[rid]:
                problems.append(
                    f"router_quorum: {rid} is not bit-identical to "
                    f"the fault-free single-process replay")
    finally:
        if routerB is not None:
            routerB.shutdown()
        routerA.shutdown()
    return problems


def scenario_fleet_migrate(workdir, ref, shape: GateShape):
    """``graft_fleet migrate --resubmit`` over the gate's trace (its
    first half before the migration, its second half after): the
    tenant of the first request moves, its later requests all land on
    the destination, its resent requests resume there from the
    handed-off checkpoints, and every result is bit-identical."""
    from arrow_matrix_tpu_torch.serve.loadgen import synthetic_trace

    tenant = synthetic_trace(1, tenants=TENANTS, requests=1, k=1,
                             seed=TRACE_SEED)[0].tenant
    r, verdict, run_dir, npz = run_fleet_cli(
        workdir, "migrate", 2,
        ["--requests", str(REQUESTS // 2), "--tenant", tenant,
         "--resubmit"], shape, command=("migrate",))
    if r.returncode != 0 or verdict is None:
        return [f"fleet_migrate: run failed rc={r.returncode}: "
                f"{r.stderr[-500:]}"]
    problems = []
    mig = verdict["migration"]
    if not mig["checkpoints"] or mig["total_stages"] < 1:
        problems.append(f"fleet_migrate: nothing handed off: {mig}")
    if verdict["post_migration_on_destination"] \
            != verdict["post_migration_tenant_requests"]:
        problems.append(f"fleet_migrate: a request of {tenant} strayed "
                        f"from {mig['to_worker']}")
    resent = verdict.get("resubmitted") or []
    if not resent or verdict.get("resumed_on_destination") != len(resent):
        problems.append(f"fleet_migrate: {resent} resent, "
                        f"{verdict.get('resumed_on_destination')} "
                        f"resumed on {mig['to_worker']} (a handed-off "
                        f"request was recomputed)")
    if not check_resumed("fleet_migrate", run_dir, (mig["to_worker"],)):
        problems.append("fleet_migrate: the destination logged no "
                        "resumed request")
    lost = (verdict["requests"] - verdict["completed"]
            - verdict["failed"] - verdict["shed"] - verdict["rejected"])
    if lost or verdict["failed"] or verdict["completed"] \
            != REQUESTS + len(resent):
        problems.append(f"fleet_migrate: {verdict['completed']} of "
                        f"{verdict['requests']} completed")
    problems += check_bit_identity("fleet_migrate", npz, ref)
    return problems


def run_fleet_scenarios(workdir, fast=False, shape: GateShape = GateShape(),
                        scenarios=SCENARIOS):
    """Run the fleet matrix; returns (problems, scenarios_run).
    Subprocess scenarios (all of them — the fleet IS processes) skip
    under ``fast``."""
    if fast:
        return [], []
    workdir = os.path.abspath(workdir)
    ref = reference_results(shape)
    ref4 = (reference_results(shape, k=4, iters=HOST_KILL_ITERS)
            if "fleet_host_kill" in scenarios else {})
    if ref is None or ref4 is None:
        return (["fleet reference: fault-free single-process replay "
                 "did not complete every request"], [])
    problems = []
    run = {"fleet_baseline": lambda: scenario_fleet_baseline(
               workdir, ref, shape),
           "fleet_kill": lambda: scenario_fleet_kill(workdir, ref, shape),
           "fleet_host_kill": lambda: scenario_fleet_host_kill(
               workdir, ref4, shape),
           "router_quorum": lambda: scenario_router_quorum(
               workdir, ref, shape),
           "fleet_migrate": lambda: scenario_fleet_migrate(
               workdir, ref, shape)}
    for name in scenarios:
        problems += run[name]()
    return problems, list(scenarios)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from arrow_matrix_tpu_torch import sync

    # Arm the lock-order witness before any router is constructed.
    registry = sync.enable_witness()

    workdir = os.path.abspath(
        args.workdir or tempfile.mkdtemp(prefix="fleet_gate_"))
    os.makedirs(workdir, exist_ok=True)
    problems, scenarios = run_fleet_scenarios(
        workdir, fast=args.fast, shape=GateShape(device=args.device))
    snap = registry.snapshot()
    if snap["violations"]:
        problems.extend(f"lock witness: {v}" for v in snap["violations"])
    print(f"fleet gate: lock witness — {snap['acquisitions']} "
          f"acquisitions, {len(snap['threads'])} threads, "
          f"{len(snap['observed_edges'])} observed edges, "
          f"{len(snap['violations'])} violations", file=sys.stderr)
    if problems:
        for prob in problems:
            print(f"fleet gate: {prob}", file=sys.stderr)
        print("fleet gate: FAILED", file=sys.stderr)
        return 1
    print(f"fleet gate: ok — scenarios "
          f"{'+'.join(scenarios) or '(fast: skipped)'} survived, zero "
          f"loss, bit-identical ({workdir})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

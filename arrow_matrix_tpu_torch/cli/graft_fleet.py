"""``graft_fleet`` — run a multi-process ArrowServer fleet end to end.

The port's copy of ``arrow_matrix_tpu/cli/graft_fleet.py``; run it as
``python -m arrow_matrix_tpu_torch.cli.graft_fleet``.  Spawns N worker
processes on ``--device`` (the card unless ``--device cpu``; on the
card they share its HBM budget), each a full ArrowServer (supervisor,
admission, checkpoint-resume, pulse ring, run-dir ledger), routes a
deterministic synthetic trace through the
:class:`~arrow_matrix_tpu_torch.fleet.router.FleetRouter`, and writes the
merged fleet artifacts into ``--run_dir``:

  * ``fleet_report.json`` — the merged SLO report; ``latency_ms`` is
    the EXACT pooled-quantile summary over every worker's raw
    samples, ``host_load`` records the 1-minute loadavg the run saw;
  * ``pulse_merged.json`` — the workers' pulse rings pooled via
    ``graft_pulse merge`` semantics (:func:`~arrow_matrix_tpu_torch.obs
    .pulse.merge_rings`);
  * ``ledger/ledger.jsonl`` — every worker's run-dir ledger folded
    into one chained fleet history (kind ``fleet``);
  * ``fleet_xray.json`` and ``xray_report.json`` — the merged fleet
    trace and its per-class critical path;
  * ``<worker-id>/`` — each worker's own ring, ledger, summary, log.

Chaos knobs: ``--fault_worker``/``--fault_plan`` arm EXACTLY ONE
worker's environment with an ``AMT_FAULT_PLAN`` (e.g. a ``kill`` plan
on ``*.step`` — the worker SIGKILLs itself mid-batch
deterministically), which is how the port's ``tools/fleet_gate.py``
runs the kill-one-worker-of-N survival scenario.  The last stdout line
is the JSON verdict (the gate handshake).

graft-host: ``--hosts H`` groups the workers into H host fault
domains (contiguous blocks, spawn env ``AMT_HOST_ID``); the router
resolves the wire per domain (same host -> shm descriptors, cross
host -> raw framing; ``--transport`` overrides).  ``--fault_host``
arms EVERY worker of one domain with the same fault plan — the
kill-a-host rung: a whole domain SIGKILLs mid-batch and the
survivors must absorb its work with zero accepted-request loss.
``--measure_wire`` additionally benchmarks all three transports over
a local socketpair and records ``serialize_ms_per_mb_<transport>``
in the run ledger, the banded evidence that the shm path stays
cheaper than base64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from arrow_matrix_tpu_torch.serve import request as rq


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graft_fleet", description=__doc__.splitlines()[0])
    p.add_argument("--run_dir", required=True)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--vertices", type=int, default=128)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--fmt", default="fold")
    p.add_argument("--tenants", type=int, default=4)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--trace_seed", type=int, default=5)
    p.add_argument("--queue", type=int, default=64)
    p.add_argument("--hbm_budget_mb", type=float, default=0.0,
                   help="each worker's budget; 0: on the card the "
                        "workers share the card's budget equally, on "
                        "the CPU each reads its own")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; raises without "
                        "one) or 'cpu'")
    p.add_argument("--placement", choices=("ring", "pack"),
                   default="ring")
    p.add_argument("--window_s", type=float, default=0.25)
    p.add_argument("--submit_timeout_s", type=float, default=300.0)
    p.add_argument("--results_npz", default=None,
                   help="also save completed results (request id -> "
                        "array) for bit-identity comparisons")
    p.add_argument("--hosts", type=int, default=1,
                   help="host fault domains to split the workers "
                        "into (graft-host; contiguous blocks)")
    p.add_argument("--transport", default="auto",
                   choices=("auto", "json", "raw", "shm"),
                   help="wire transport override (auto: same-host "
                        "shm, cross-host raw)")
    p.add_argument("--fault_worker", default=None,
                   help="worker id whose environment gets "
                        "--fault_plan (chaos scenarios)")
    p.add_argument("--fault_host", default=None,
                   help="host domain id (e.g. host-1) whose EVERY "
                        "worker gets --fault_plan — the kill-a-host "
                        "rung")
    p.add_argument("--fault_plan", default=None,
                   help="AMT_FAULT_PLAN JSON (or a path to it) for "
                        "--fault_worker / --fault_host only")
    p.add_argument("--kill_host", default=None,
                   help="router-side kill-a-host rung: once the batch "
                        "is mid-flight, SIGKILL every worker of this "
                        "domain AT ONCE and heartbeat-probe the "
                        "victims to a dead verdict")
    p.add_argument("--measure_wire", action="store_true",
                   help="benchmark json/raw/shm over a socketpair "
                        "and record serialize_ms_per_mb_<transport> "
                        "in the run ledger")
    p.add_argument("--verbose", action="store_true")
    return p


def run_fleet(args) -> dict:
    from arrow_matrix_tpu_torch.fleet.router import FleetRouter
    from arrow_matrix_tpu_torch.ledger import store as ledger_store
    from arrow_matrix_tpu_torch.ledger.store import _default_host_load
    from arrow_matrix_tpu_torch.obs import pulse as pulse_mod
    from arrow_matrix_tpu_torch.obs import xray as xray_mod
    from arrow_matrix_tpu_torch.serve.loadgen import synthetic_trace
    from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

    os.makedirs(args.run_dir, exist_ok=True)
    if args.fault_worker and getattr(args, "fault_host", None):
        raise SystemExit("pass --fault_worker or --fault_host, "
                         "not both")
    worker_env = None
    if args.fault_worker or getattr(args, "fault_host", None):
        plan = args.fault_plan or ""
        if os.path.exists(plan):
            with open(plan, encoding="utf-8") as fh:
                plan = fh.read()
        if args.fault_worker:
            worker_env = {args.fault_worker: {"AMT_FAULT_PLAN": plan}}
        else:
            # Arm the WHOLE domain: worker i of n lives in
            # host-{i*hosts//n} (the router's contiguous-block split).
            n, hosts = args.workers, max(1, int(args.hosts))
            victims = [f"worker-{i}" for i in range(n)
                       if f"host-{i * min(hosts, n) // n}"
                       == args.fault_host]
            if not victims:
                raise SystemExit(f"--fault_host {args.fault_host!r} "
                                 f"matches no worker (workers={n}, "
                                 f"hosts={hosts})")
            worker_env = {wid: {"AMT_FAULT_PLAN": plan}
                          for wid in victims}
    router = FleetRouter(
        spawn=args.workers, vertices=args.vertices, width=args.width,
        seed=args.seed, fmt=args.fmt, queue_capacity=args.queue,
        hbm_budget_mb=args.hbm_budget_mb,
        checkpoint_dir=os.path.join(args.run_dir, "checkpoints"),
        run_dir=args.run_dir, window_s=args.window_s,
        placement=args.placement, device=args.device,
        hosts=getattr(args, "hosts", 1),
        transport=getattr(args, "transport", "auto"),
        worker_env=worker_env,
        submit_timeout_s=args.submit_timeout_s,
        verbose=args.verbose)
    try:
        trace = synthetic_trace(
            router.n_rows, tenants=args.tenants,
            requests=args.requests, k=args.k,
            iterations=args.iterations, seed=args.trace_seed)
        if args.placement == "pack":
            router.plan_packing({r.tenant: r.k for r in trace})
        tickets = [router.submit(r) for r in trace]
        killed_hosts = []
        if getattr(args, "kill_host", None):
            # Mid-batch on purpose, and timed so the survivors can
            # RESUME rather than recompute: wait until some request
            # dispatched to the doomed domain is still in flight AND
            # has a checkpoint on the shared dir (per-request
            # ``ck_<request_id>`` keys), then take the whole domain
            # down in one sweep.  The deaths are then probed to a
            # verdict through the REAL heartbeat ladder — the same
            # wire discovery a dispatch failure triggers — so the
            # burial is deterministic for the gate without
            # short-circuiting health.
            domain = set(router.host_map().get(args.kill_host) or [])
            ck_dir = os.path.join(args.run_dir, "checkpoints")

            def _resumable_in_flight():
                for t in tickets:
                    if t.status in rq.TERMINAL:
                        continue
                    if getattr(t, "worker_id", None) not in domain:
                        continue
                    # The FINAL checkpoint path only (save_state
                    # writes a *.tmp.npz then renames atomically): its
                    # existence means a COMPLETE save a survivor can
                    # resume; matching the tmp file would fire the
                    # kill mid-write, before anything is resumable.
                    if os.path.exists(os.path.join(
                            ck_dir, f"ck_{t.request.request_id}.npz")):
                        return True
                return False

            deadline = time.monotonic() + args.submit_timeout_s
            while time.monotonic() < deadline:
                if _resumable_in_flight():
                    break
                if all(t.status in rq.TERMINAL for t in tickets):
                    break   # batch outran the kill; fire anyway
                time.sleep(0.005)
            victims = router.kill_host(args.kill_host)
            killed_hosts.append(args.kill_host)
            for wid in victims:
                router._on_worker_failure(
                    wid, f"host domain {args.kill_host} killed")
        router.drain(timeout_s=args.submit_timeout_s)
        report = router.fleet_summary()
        # The router's own trace doc goes to disk while the router is
        # still alive; workers write theirs on graceful close (during
        # shutdown), and a SIGKILLed worker leaves its flight ring —
        # merge_run_dir below stitches whichever survived.
        xray_mod.save_router_trace(router.tracer, args.run_dir)
    finally:
        router.shutdown()
    report["host_load"] = _default_host_load()
    report["killed_hosts"] = killed_hosts
    # Each worker's handshake: its pid, device, build seconds and the
    # HBM budget it admits against.
    report["worker_hello"] = {
        wid: {key: h.meta.get(key) for key in
              ("pid", "device", "build_s", "budget_bytes", "host_id")}
        for wid, h in sorted(router.workers.items())}
    report["tickets"] = [
        {"request_id": t.request.request_id,
         "tenant": t.request.tenant, "status": t.status,
         "reason": t.reason,
         "worker_id": getattr(t, "worker_id", None),
         "requeues": getattr(t, "requeues", 0),
         "served_class": getattr(t, "served_class", None),
         "trace_id": (t.trace or {}).get("trace_id")}
        for t in tickets]
    folded = router.fold_ledgers()
    report["ledger_records_folded"] = folded

    # graft-xray: ONE merged fleet trace (router + every worker track,
    # clock-offset aligned, dead workers recovered truncated), the
    # per-class critical-path report over it, and the wire cost totals
    # as banded first-class ledger metrics.
    trace_doc = xray_mod.merge_run_dir(args.run_dir, report=report)
    trace_path = xray_mod.save_fleet_trace(trace_doc, args.run_dir)
    classes = {t["request_id"]: t["served_class"]
               for t in report["tickets"] if t["served_class"]}
    cp = xray_mod.critical_path(trace_doc, classes=classes)
    atomic_write_json(os.path.join(args.run_dir, "xray_report.json"),
                      cp, indent=2, sort_keys=True)
    report["xray"] = {
        "trace": trace_path,
        "processes": trace_doc["xray"]["processes"],
        "truncated": trace_doc["xray"]["truncated"],
        "per_class": {cls: {"count": agg["count"],
                            "mean_ms": agg.get("mean_ms"),
                            "segments_mean_ms":
                                agg.get("segments_mean_ms")}
                      for cls, agg in cp["per_class"].items()},
    }
    tot = report.get("wire", {}).get("totals") or {}
    shape_tag = (f"fleet_w{args.workers}_n{args.vertices}"
                 f"_r{args.requests}_k{args.k}")
    stamp = ledger_store.device_stamp(router.device)
    for metric, value, unit in (
            ("wire_bytes",
             tot.get("bytes_out", 0) + tot.get("bytes_in", 0), "B"),
            ("wire_ms", tot.get("wire_ms"), "ms"),
            ("serialize_ms", tot.get("serialize_ms"), "ms")):
        ledger_store.record(
            "fleet", metric, value,
            directory=os.path.join(args.run_dir, "ledger"),
            unit=unit, structure_hash=shape_tag,
            knobs={"fleet": report["fleet"],
                   "workers": args.workers,
                   "requests": args.requests,
                   "frames": tot.get("frames"),
                   "hosts": getattr(args, "hosts", 1),
                   "payload_bytes": tot.get("payload_bytes"),
                   "shm_bytes": tot.get("shm_bytes")},
            **stamp)
    if getattr(args, "measure_wire", False):
        # Same payload, three wires, one socketpair: the banded proof
        # that shm descriptor passing stays cheaper than the base64
        # envelope (and how close it gets to raw framing).
        from arrow_matrix_tpu_torch.fleet import wire as wire_mod
        measured = wire_mod.measure_transports()
        report["wire_measured"] = measured
        for transport in ("base64", "raw", "shm"):
            ledger_store.record(
                "fleet", f"serialize_ms_per_mb_{transport}",
                round(float(
                    measured[transport]["serialize_ms_per_mb"]), 4),
                directory=os.path.join(args.run_dir, "ledger"),
                unit="ms", structure_hash="wire_1mb",
                knobs={"transport": transport,
                       "frame_bytes":
                           measured[transport]["frame_bytes"]})

    ring_docs = []
    for wid in sorted(router.workers):
        handle = router.workers[wid]
        if not handle.obs_dir:
            continue
        ring_path = os.path.join(handle.obs_dir, "pulse_ring.json")
        if os.path.exists(ring_path):
            ring_docs.append(pulse_mod.load_ring(ring_path))
    merged_pulse = pulse_mod.merge_rings(ring_docs)
    atomic_write_json(os.path.join(args.run_dir,
                                   "pulse_merged.json"),
                      merged_pulse, indent=2, sort_keys=True)
    report["pulse_merged"] = {
        "rings": merged_pulse["rings"],
        "totals": merged_pulse["totals"],
        "problems": merged_pulse["problems"],
    }
    if args.results_npz:
        import numpy as np

        np.savez(args.results_npz,
                 **{t.request.request_id: t.result for t in tickets
                    if t.status == rq.COMPLETED
                    and t.result is not None})
        report["results_npz"] = args.results_npz
    atomic_write_json(os.path.join(args.run_dir,
                                   "fleet_report.json"),
                      report, indent=2, sort_keys=True)
    return report


def build_migrate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graft_fleet migrate",
        description="Rebalance one tenant between fleet workers via "
                    "staged checkpoint handoff on the shared "
                    "checkpoint dir (FleetRouter.migrate).")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--tenant", default="tenant1",
                   help="synthetic_trace tenant id to rebalance "
                        "(tenant1 owns phase-1 requests at the "
                        "default trace_seed, so its checkpoints are "
                        "on the shared dir when the handoff runs)")
    p.add_argument("--to_worker", default=None,
                   help="destination worker id (default: the ring's "
                        "next live candidate)")
    p.add_argument("--dry-run", dest="dry_run", action="store_true",
                   help="print the staged handoff plan and per-stage "
                        "bytes without rewriting checkpoints or "
                        "moving the tenant")
    p.add_argument("--scratch_budget_kb", type=float, default=64.0,
                   help="per-endpoint per-stage handoff scratch "
                        "budget")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--vertices", type=int, default=128)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--fmt", default="fold")
    p.add_argument("--tenants", type=int, default=2)
    p.add_argument("--requests", type=int, default=4,
                   help="requests per phase (pre- and post-migration)")
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--trace_seed", type=int, default=5)
    p.add_argument("--submit_timeout_s", type=float, default=300.0)
    p.add_argument("--results_npz", default=None,
                   help="also save completed results (request id -> "
                        "array) for bit-identity comparisons")
    p.add_argument("--resubmit", action="store_true",
                   help="phase 2 also resends the tenant's phase-1 "
                        "requests, which the destination resumes from "
                        "the handed-off checkpoints")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card) or 'cpu'")
    p.add_argument("--verbose", action="store_true")
    return p


def run_migrate(args) -> dict:
    """The tenant-rebalance path end to end: phase 1 routes requests
    (writing per-request checkpoints onto the shared dir), the router
    migrates the tenant — staged handoff plans over those checkpoints,
    then a placement pin — and phase 2 proves every subsequent request
    of that tenant lands on the destination worker.  ``--resubmit``
    also sends the tenant's phase-1 requests again in phase 2 (same ids
    and payloads): the destination resumes each from its handed-off
    checkpoint instead of recomputing it.  ``--dry-run`` stops after
    printing the plans: nothing is rewritten or repinned.
    """
    from arrow_matrix_tpu_torch.fleet.router import FleetRouter
    from arrow_matrix_tpu_torch.serve.loadgen import synthetic_trace
    from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

    os.makedirs(args.run_dir, exist_ok=True)
    router = FleetRouter(
        spawn=args.workers, vertices=args.vertices, width=args.width,
        seed=args.seed, fmt=args.fmt,
        checkpoint_dir=os.path.join(args.run_dir, "checkpoints"),
        run_dir=args.run_dir,
        submit_timeout_s=args.submit_timeout_s,
        device=args.device,
        verbose=args.verbose)
    try:
        trace = synthetic_trace(
            router.n_rows, tenants=args.tenants,
            requests=2 * args.requests, k=args.k,
            iterations=args.iterations, seed=args.trace_seed)
        phase1, phase2 = trace[:args.requests], trace[args.requests:]
        t1 = [router.submit(r) for r in phase1]
        router.drain(timeout_s=args.submit_timeout_s)

        migration = router.migrate(
            args.tenant, args.to_worker,
            scratch_budget_bytes=int(args.scratch_budget_kb * 1024),
            dry_run=args.dry_run)
        for h in migration["checkpoints"]:
            print(h["plan"], flush=True)
        if not migration["checkpoints"]:
            print(f"[graft-fleet] tenant {args.tenant} has no "
                  f"checkpoints on the shared dir (phase 1 routed "
                  f"none of its requests?)", flush=True)

        t2 = []
        if not args.dry_run:
            again = ([r for r in phase1 if r.tenant == args.tenant]
                     if getattr(args, "resubmit", False) else [])
            t2 = [router.submit(r) for r in phase2 + again]
            router.drain(timeout_s=args.submit_timeout_s)
        tickets = t1 + t2
        summary = router.fleet_summary()
    finally:
        router.shutdown()

    post = [t for t in t2 if t.request.tenant == args.tenant]
    on_dst = [t for t in post
              if getattr(t, "worker_id", None)
              == migration["to_worker"]]
    report = {
        "migration": migration,
        "phase1_completed": sum(t.status == rq.COMPLETED for t in t1),
        "phase2_completed": sum(t.status == rq.COMPLETED for t in t2),
        "post_migration_tenant_requests": len(post),
        "post_migration_on_destination": len(on_dst),
        "requests": len(tickets),
        "completed": summary["completed"],
        "failed": summary["failed"],
        "shed": summary["shed"],
        "rejected": summary["rejected"],
        "migrations": summary["migrations"],
        "tenant_pins": summary["tenant_pins"],
        "run_dir": args.run_dir,
    }
    if getattr(args, "resubmit", False):
        redone = t2[len(phase2):]
        report["resubmitted"] = [t.request.request_id for t in redone]
        report["resumed_on_destination"] = sum(
            t.resumed_step is not None
            and getattr(t, "worker_id", None) == migration["to_worker"]
            for t in redone)
    atomic_write_json(os.path.join(args.run_dir,
                                   "migrate_report.json"),
                      report, indent=2, sort_keys=True)
    if getattr(args, "results_npz", None):
        import numpy as np

        np.savez(args.results_npz,
                 **{t.request.request_id: t.result for t in tickets
                    if t.status == rq.COMPLETED})
    return report


def main_migrate(argv=None) -> int:
    args = build_migrate_parser().parse_args(argv)
    report = run_migrate(args)
    verdict = {key: report[key] for key in
               ("phase1_completed", "phase2_completed",
                "post_migration_tenant_requests",
                "post_migration_on_destination", "requests",
                "completed", "failed", "shed", "rejected",
                "migrations", "tenant_pins", "run_dir")}
    verdict["migration"] = {
        key: report["migration"][key] for key in
        ("tenant", "from_worker", "to_worker", "dry_run",
         "total_stages", "moved_bytes", "scratch_budget_bytes")}
    for key in ("resubmitted", "resumed_on_destination"):
        if key in report:
            verdict[key] = report[key]
    verdict["migration"]["checkpoints"] = [
        {key: h[key] for key in
         ("checkpoint", "rows", "k", "n_stages", "stage_bytes",
          "moved_bytes")}
        for h in report["migration"]["checkpoints"]]
    print(json.dumps(verdict, sort_keys=True), flush=True)
    lost = (report["requests"] - report["completed"]
            - report["failed"] - report["shed"] - report["rejected"])
    strayed = (report["post_migration_tenant_requests"]
               - report["post_migration_on_destination"])
    if report["migration"]["dry_run"]:
        strayed = 0
    return 0 if (lost == 0 and strayed == 0) else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "migrate":
        return main_migrate(argv[1:])
    args = build_parser().parse_args(argv)
    report = run_fleet(args)
    verdict = {
        "fleet": report["fleet"],
        "workers": report["num_workers"],
        "dead_workers": report["dead_workers"],
        "hosts": report.get("hosts"),
        "live_hosts": report.get("live_hosts"),
        "killed_hosts": report.get("killed_hosts"),
        "transports": report.get("transports"),
        "wire_shm_bytes": (report.get("wire", {}).get("totals")
                           or {}).get("shm_bytes"),
        "wire_measured": {
            t: {"serialize_ms_per_mb":
                    round(float(m["serialize_ms_per_mb"]), 4)}
            for t, m in (report.get("wire_measured") or {}).items()},
        "requests": report["requests"],
        "completed": report["completed"],
        "failed": report["failed"],
        "shed": report["shed"],
        "rejected": report["rejected"],
        "shed_reasons": report["shed_reasons"],
        "requeues": report["requeues"],
        "requests_per_s": report["requests_per_s"],
        "latency_ms": {f: report["latency_ms"].get(f)
                       for f in ("count", "p50", "p90", "p99")},
        "host_load": report["host_load"],
        "pulse_problems": report["pulse_merged"]["problems"],
        "run_dir": args.run_dir,
    }
    print(json.dumps(verdict, sort_keys=True), flush=True)
    lost = (report["requests"] - report["completed"]
            - report["failed"] - report["shed"] - report["rejected"])
    return 0 if lost == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

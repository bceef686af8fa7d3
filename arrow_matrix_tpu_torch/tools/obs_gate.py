"""Obs gate: the observability layer's reduced-scale smoke, validated.

The port's counterpart of ``tools/obs_gate.py``: runs all five
parallel algorithms through ``obs/smoke.run_smoke`` on 4 gloo ranks
(n=128, width 32, k=4, 2 iterations; ``graft_trace smoke``'s world),
then validates the run directory (``obs/smoke.validate_run_dir``:
spans a phase, a well-formed trace, per-iteration device time,
collective bytes, the memory report) and the memory contract: every
algorithm carries a memory report and none measures more than
``OBS_GATE_MAX_HBM_RATIO`` (default 8.0) times its predicted device
bytes.  Then one ``serve.smoke_serve`` run, whose SLO report must carry
p50/p99, the shed/rejected census, device-memory occupancy, the
per-tenant and per-class breakdowns, the pulse ring and exposition
consistent with the report, and ledger records for both runs; a
2-worker in-process fleet whose merged ``graft_xray`` trace must close
every request's span tree across the wire and conserve its bytes; and
one lens profile of the reference's BA 96 source, validated
structurally.  The validators are the reference's, word for word.

    python -m arrow_matrix_tpu_torch.tools.obs_gate [run_dir]
        [--device cpu]

Runs on the card unless ``--device cpu`` (the smoke's ranks share it
over gloo).  Exits 0 on a valid run, 1 otherwise.
"""

from __future__ import annotations

import os
import sys
import tempfile


def memory_problems(summary: dict, max_ratio: float) -> list:
    """Gate problems from the smoke summary's memory section: a report
    must exist per algorithm, and measured/predicted must stay under
    ``max_ratio`` wherever the format exposes a predictor."""
    problems = []
    for name, rec in sorted(summary.get("algorithms", {}).items()):
        if rec.get("memory") is None or not rec.get("hbm_measured_bytes"):
            problems.append(f"{name}: memory report absent")
            continue
        ratio = rec.get("hbm_vs_predicted")
        if ratio is not None and ratio > max_ratio:
            problems.append(
                f"{name}: measured/predicted HBM ratio {ratio:.2f} "
                f"exceeds {max_ratio:.2f} "
                f"({rec['hbm_measured_bytes']} vs "
                f"{rec.get('hbm_predicted_bytes')} bytes)")
    return problems


def comm_problems(summary: dict) -> list:
    """Gate problems from the comm section: every algorithm's comm
    report must carry the ``exposed_comm_ms`` field (graft-stream) —
    a comm account without the exposed-time model can't state whether
    the overlap schedule is doing its job.  A replicated run
    (``repl > 1``, graft-repl) must additionally carry its ``repl``
    and ``reduce_bytes`` fields: a 2.5D report that hides the final
    merge's cost (or the factor that bought the exchange cut) is not
    an account."""
    problems = []
    for name, rec in sorted(summary.get("algorithms", {}).items()):
        if rec.get("exposed_comm_ms") is None:
            problems.append(f"{name}: comm report lacks exposed_comm_ms")
        if rec.get("repl", 1) is None or rec.get("repl", 1) > 1:
            if "repl" not in rec or rec.get("repl") is None:
                problems.append(f"{name}: repl>1 run lacks repl field")
            if rec.get("reduce_bytes") is None:
                problems.append(
                    f"{name}: repl>1 comm report lacks reduce_bytes "
                    f"(the 2.5D final-merge cost)")
    return problems


def serve_problems(summary: dict) -> list:
    """Gate problems from a graft-serve SLO report
    (serve/loadgen.py:slo_summary): the serving layer's observability
    contract.  A serve run that cannot state its p50/p99 latency, its
    shed/rejected census, and its HBM occupancy is flying blind —
    admission control and load shedding are exactly the decisions
    these numbers justify."""
    problems = []
    lat = summary.get("latency_ms") or {}
    for q in ("p50", "p99"):
        if lat.get(q) is None:
            problems.append(f"serve: SLO report lacks {q} latency")
    for field in ("shed", "rejected", "completed", "requests_per_s"):
        if summary.get(field) is None:
            problems.append(f"serve: SLO report lacks the {field} "
                            f"field")
    hbm = summary.get("hbm") or {}
    for field in ("budget_bytes", "peak_in_use_bytes",
                  "peak_occupancy"):
        if hbm.get(field) is None:
            problems.append(f"serve: SLO report lacks hbm."
                            f"{field}")
    if not summary.get("per_tenant"):
        problems.append("serve: SLO report lacks the per-tenant "
                        "breakdown")
    # graft-classes: the report must band exact and approx separately
    # — per-class admission/completion counts plus latency quantiles
    # keyed by the class actually served — and carry the loud
    # fallback counter and the certificate registry it admitted
    # against.
    per_class = summary.get("per_class")
    if not per_class:
        problems.append("serve: SLO report lacks the per-class "
                        "breakdown")
    else:
        for cls in ("exact", "approx"):
            rec = per_class.get(cls)
            if rec is None:
                problems.append(f"serve: per_class lacks the {cls} "
                                f"class")
            elif not {"completed", "latency_ms"} <= set(rec):
                problems.append(f"serve: per_class[{cls}] lacks "
                                f"completed/latency_ms")
    if summary.get("class_fallback") is None:
        problems.append("serve: SLO report lacks the class_fallback "
                        "counter")
    if summary.get("certificates") is None:
        problems.append("serve: SLO report lacks the certificates "
                        "section")
    if summary.get("completed", 0) < 1:
        problems.append("serve: smoke serve completed no requests")
    run_dir = summary.get("_run_dir")
    if run_dir and not os.path.isfile(
            os.path.join(run_dir, "serve_summary.json")):
        problems.append("serve: serve_summary.json artifact missing")
    return problems


def pulse_problems(summary: dict) -> list:
    """Gate problems from the graft-pulse surfaces of a smoke serve
    run: the on-disk ring must be crash-readable and schema-valid, the
    exposition text parseable, and the embedded window series must be
    CONSISTENT with the final SLO report — same completed count, and
    pooled window latency quantiles equal to the report's within the
    completed-event rounding (1e-3 ms).  One schema, actually
    enforced."""
    from arrow_matrix_tpu_torch.obs import pulse

    problems = []
    run_dir = summary.get("_run_dir")
    pt = summary.get("pulse")
    if not pt:
        return ["pulse: SLO report lacks the embedded pulse section"]
    if run_dir:
        ring_path = os.path.join(run_dir, "pulse_ring.json")
        if not os.path.isfile(ring_path):
            problems.append("pulse: pulse_ring.json artifact missing")
        else:
            try:
                doc = pulse.load_ring(ring_path)
            except Exception as e:
                problems.append(f"pulse: ring unreadable: {e}")
            else:
                problems += [f"pulse ring: {p}"
                             for p in pulse.validate_ring(doc)]
        prom_path = os.path.join(run_dir, "pulse_metrics.prom")
        if not os.path.isfile(prom_path):
            problems.append("pulse: pulse_metrics.prom artifact "
                            "missing")
        else:
            with open(prom_path, encoding="utf-8") as fh:
                problems += [f"pulse exposition: {p}" for p in
                             pulse.validate_exposition(fh.read())]
    for w in pt.get("windows", ()):
        missing = [f for f in pulse.SLO_SERIES_FIELDS if f not in w]
        if missing:
            problems.append(f"pulse: window {w.get('window')} missing "
                            f"fields {missing}")
            break
    totals = pt.get("totals") or {}
    if "per_class" not in totals:
        problems.append("pulse: window totals lack the per-class "
                        "breakdown (graft-classes)")
    if totals.get("completed") != summary.get("completed"):
        problems.append(
            f"pulse: window totals completed="
            f"{totals.get('completed')} != SLO report completed="
            f"{summary.get('completed')}")
    # Pooled window quantiles vs the report: the windows partition the
    # completed events, so the monitor's run-total histogram must
    # reproduce the report's quantiles up to the event's ms rounding.
    lat_total = (totals.get("latency_ms") or {})
    lat_report = (summary.get("latency_ms") or {})
    for q in ("p50", "p90", "p99"):
        a, b = lat_total.get(q), lat_report.get(q)
        if a is None or b is None:
            if (a is None) != (b is None):
                problems.append(f"pulse: {q} present in only one of "
                                f"series/report")
            continue
        if abs(a - b) > 1e-2:
            problems.append(f"pulse: pooled series {q}={a:.4f}ms "
                            f"diverges from report {q}={b:.4f}ms")
    return problems


def ledger_problems(smoke_summary: dict, serve_summary: dict) -> list:
    """Gate problems from the graft-ledger wiring of a smoke run: both
    the obs smoke summary and the serve SLO report must carry the id
    of the ledger record their run appended, and the record must
    actually exist (valid, chained) in the run-dir-local store — a
    measured number that never reached the ledger is exactly the
    unaccounted drift the ledger exists to end."""
    from arrow_matrix_tpu_torch.ledger import Ledger

    problems = []
    for label, summary in (("smoke", smoke_summary),
                           ("serve", serve_summary)):
        rec_id = summary.get("ledger_record_id")
        if not rec_id:
            problems.append(f"ledger: {label} summary carries no "
                            f"ledger_record_id")
            continue
        run_dir = summary.get("_run_dir")
        if not run_dir:
            continue
        lg = Ledger(os.path.join(run_dir, "ledger"))
        recs = {r.get("record_id") for r in lg.read_all()}
        if rec_id not in recs:
            problems.append(f"ledger: {label} record {rec_id} absent "
                            f"from {lg.path}")
        problems += [f"ledger ({label}): {p}" for p in lg.validate()]
    return problems


def xray_problems(trace_doc: dict, tickets: list, wire=None,
                  registry=None) -> list:
    """Gate problems from a merged graft-xray fleet trace.

    Two invariants, both correctness properties of the tracer rather
    than style checks:

    * **Closed span trees.**  Every COMPLETED request must appear as a
      router-track ``dispatch`` span AND at least one worker-track
      span carrying the same request id and the router-minted
      ``trace_id`` — and the worker spans must land inside the
      dispatch interval (0.25 s slack for clock-offset residue).  A
      request the fleet says it served but the trace cannot follow
      across the wire is a broken context propagation, the exact bug
      this gate exists to catch.

    * **Byte conservation.**  The router's per-frame wire ledger must
      sum EXACTLY to its totals (a dropped frame record is silent
      undercounting), and — when a fresh process-local registry is
      passed — the bytes the client side sent must equal the bytes the
      server side received, and vice versa: the wire may not create or
      destroy bytes between the two measurement points.
    """
    problems = []
    xr = trace_doc.get("xray") or {}
    procs = {p["process"]: p["pid"] for p in xr.get("processes", [])}
    if "router" not in procs:
        problems.append("xray: merged trace lacks a router track")
    if len(procs) < 2:
        problems.append("xray: merged trace has no worker tracks")
    if problems:
        return problems
    router_pid = procs["router"]
    events = [e for e in trace_doc.get("traceEvents", [])
              if e.get("ph") == "X"]
    slack_us = 0.25e6
    for t in tickets:
        if t.get("status") != "completed":
            continue
        rid = t["request_id"]
        mine = [e for e in events if rid in
                str(e.get("args", {}).get("request_id", "")).split("+")]
        disp = [e for e in mine
                if e["pid"] == router_pid and e["name"] == "dispatch"]
        remote = [e for e in mine if e["pid"] != router_pid]
        if not disp:
            problems.append(f"xray: {rid}: no router dispatch span")
            continue
        if not remote:
            problems.append(f"xray: {rid}: no worker-side spans — "
                            f"span tree not closed across the wire")
            continue
        want = t.get("trace_id")
        if want and not any(
                want in str(e["args"].get("trace_id", "")).split("+")
                for e in remote):
            problems.append(f"xray: {rid}: worker spans lack the "
                            f"router-minted trace_id {want}")
        d0 = min(e["ts"] for e in disp)
        d1 = max(e["ts"] + e["dur"] for e in disp)
        stray = [e["name"] for e in remote
                 if e["ts"] < d0 - slack_us
                 or e["ts"] + e["dur"] > d1 + slack_us]
        if stray:
            problems.append(f"xray: {rid}: worker spans {stray} fall "
                            f"outside the dispatch interval")
    if wire:
        totals = wire.get("totals") or {}
        frames = wire.get("frames") or []
        out_sum = sum(int(f.get("bytes_out") or 0) for f in frames)
        in_sum = sum(int(f.get("bytes_in") or 0) for f in frames)
        if (out_sum != totals.get("bytes_out")
                or in_sum != totals.get("bytes_in")):
            problems.append(
                f"xray: wire ledger does not conserve bytes: frame "
                f"sums {out_sum}/{in_sum} (out/in) vs totals "
                f"{totals.get('bytes_out')}/{totals.get('bytes_in')}")
        if totals.get("frames") != 2 * len(frames):
            problems.append(
                f"xray: wire ledger frame count "
                f"{totals.get('frames')} != 2 x {len(frames)} "
                f"round trips")
    if registry is not None:
        sums: dict = {}
        for rec in registry.snapshot()["histograms"]:
            if rec["name"] != "wire_frame_bytes":
                continue
            lab = rec.get("labels") or {}
            s = rec.get("summary") or {}
            key = (lab.get("role"), lab.get("dir"))
            sums[key] = sums.get(key, 0) + int(round(
                s.get("mean", 0.0) * s.get("count", 0)))
        for a, b in ((("client", "send"), ("server", "recv")),
                     (("server", "send"), ("client", "recv"))):
            if sums.get(a, 0) != sums.get(b, 0):
                problems.append(
                    f"xray: bytes not conserved across the socket: "
                    f"{'/'.join(a)}={sums.get(a, 0)} != "
                    f"{'/'.join(b)}={sums.get(b, 0)}")
    return problems


def lens_problems(profile: dict) -> list:
    """Gate problems from a graft-lens profile document: structural
    validation of the per-level attribution contract.  Every measured
    tier must ride with its full static counter row (nnz / rows /
    streamed bytes — the pairing IS the point of graft-lens), the
    family label must match the profiled kernel, and the coverage
    bookkeeping must be finite and self-consistent.  The calibration
    BANDS (coverage tolerance, ratio range) are enforced against the
    committed artifact by tools/lens_gate.py — at this gate's reduced
    smoke scale per-tier times sit at the measurement floor, so only
    the structure is load-bearing here."""
    from arrow_matrix_tpu_torch.obs import lens

    problems = []
    if profile.get("schema") != lens.LENS_PROFILE_SCHEMA:
        return [f"lens: profile schema {profile.get('schema')} != "
                f"{lens.LENS_PROFILE_SCHEMA}"]
    kernel = profile.get("kernel")
    if not profile.get("structure_hash"):
        problems.append("lens: profile lacks structure_hash")
    if not profile.get("dtypes"):
        problems.append("lens: profile has no dtype entries")
    for fd, entry in (profile.get("dtypes") or {}).items():
        full = entry.get("full_ms")
        if not isinstance(full, (int, float)) or not full > 0:
            problems.append(f"lens: {fd}: non-positive full_ms "
                            f"{full}")
        measured = 0
        for t in entry.get("tiers", ()):
            if not t.get("measured_ms"):
                continue
            measured += 1
            for field in ("nnz", "rows", "streamed_bytes", "slots",
                          "slot_width"):
                v = t.get(field)
                if not isinstance(v, (int, float)) or v < 0:
                    problems.append(
                        f"lens: {fd} tier {t.get('tier')}: measured "
                        f"tier lacks static counter {field}")
            fam = str(t.get("family", ""))
            if kernel and not fam.startswith(f"{kernel}:"):
                problems.append(
                    f"lens: {fd} tier {t.get('tier')}: family {fam!r}"
                    f" does not match profiled kernel {kernel!r}")
        if not measured:
            problems.append(f"lens: {fd}: no measured tiers")
        att = entry.get("attributed_ms")
        cov = entry.get("coverage")
        if (isinstance(att, (int, float))
                and isinstance(cov, (int, float))
                and isinstance(full, (int, float)) and full > 0
                and abs(att / full - cov) > 1e-6):
            problems.append(f"lens: {fd}: coverage {cov} inconsistent "
                            f"with attributed/full {att / full}")
    return problems


def run_lens_profile(device=None) -> list:
    """A bounded lens profile (the reference's BA 96 source, K1 at its
    defaults) validated structurally."""
    from arrow_matrix_tpu_torch.obs import lens
    from arrow_matrix_tpu_torch.tune.search import load_levels_from_source

    levels, width = load_levels_from_source(
        {"kind": "ba", "n": 96, "m": 3, "width": 16, "seed": 5,
         "max_levels": 10})
    profile = lens.profile_fold(levels, width, 8, kernel="xla",
                                feature_dtypes=("f32",), iters=20,
                                device=device)
    return lens_problems(profile)


def run_xray_fleet(out: str, device=None) -> list:
    """An in-process 2-worker fleet through the whole ``graft_xray``
    loop (trace context over the wire, per-process documents, the
    clock-offset handshake, merge, conservation); its problems."""
    import threading

    from arrow_matrix_tpu_torch.fleet.health import HealthMonitor
    from arrow_matrix_tpu_torch.fleet.router import FleetRouter, WorkerHandle
    from arrow_matrix_tpu_torch.fleet.worker import FleetWorker, serve_worker
    from arrow_matrix_tpu_torch.obs import metrics as metrics_mod
    from arrow_matrix_tpu_torch.obs import xray
    from arrow_matrix_tpu_torch.serve.loadgen import synthetic_trace

    # A fresh registry: the byte-symmetry check sees this fleet's frames
    # alone.
    metrics_mod.set_registry(metrics_mod.MetricsRegistry())
    xray_dir = os.path.join(out, "xray")
    workers, handles = [], []
    for wid in ("w0", "w1"):
        worker = FleetWorker(wid, vertices=96, width=16, seed=5,
                             obs_dir=os.path.join(xray_dir, wid),
                             device=device)
        ready = threading.Event()
        box: dict = {}

        def announce(port, box=box, ready=ready):
            box["port"] = port
            ready.set()

        threading.Thread(target=serve_worker, args=(worker,),
                         kwargs={"port": 0, "announce": announce},
                         daemon=True).start()
        if not ready.wait(120):
            return [f"xray: worker {wid} never bound"]
        workers.append(worker)
        handles.append(WorkerHandle(wid, "127.0.0.1", box["port"]))
    router = FleetRouter(
        handles=handles,
        health=HealthMonitor(timeout_s=5.0, max_failures=3),
        device=device)
    try:
        trace = synthetic_trace(router.n_rows, tenants=2, requests=4,
                                k=2, iterations=2, seed=11)
        tickets = [router.submit(r) for r in trace]
        router.drain(timeout_s=180)
        report = router.fleet_summary()
        xray.save_router_trace(router.tracer, xray_dir)
    finally:
        router.shutdown()
        for w in workers:
            w.close()
    bad = [t.request.request_id for t in tickets
           if t.status != "completed"]
    if bad:
        return [f"xray: fleet requests not completed: {bad}"]
    trace_doc = xray.merge_run_dir(xray_dir, report=report)
    xray.save_fleet_trace(trace_doc, xray_dir)
    tick = [{"request_id": t.request.request_id, "status": t.status,
             "trace_id": (t.trace or {}).get("trace_id")}
            for t in tickets]
    problems = xray_problems(trace_doc, tick, wire=report.get("wire"),
                             registry=metrics_mod.get_registry())
    offs = report.get("clock_offsets_ns") or {}
    for wid in ("w0", "w1"):
        rec = offs.get(wid)
        if not isinstance(rec, dict):
            problems.append(f"xray: no clock offset measured for {wid}")
        elif abs(rec.get("offset_ns", 0)) > 1e9:
            problems.append(f"xray: implausible same-host clock offset "
                            f"for {wid}: {rec}")
    return problems


def smoke_rank(ctx, out: str) -> dict:
    """``run_smoke`` at the gate's scale in one rank of its world."""
    from arrow_matrix_tpu_torch.obs.smoke import run_smoke

    return run_smoke(out, n=128, width=32, k=4, n_dev=ctx.world, iters=2)


def run_gate(out: str, device=None) -> list:
    """Every check of the gate over the run directory ``out``; its
    problems."""
    from arrow_matrix_tpu_torch.obs.__main__ import smoke_backend
    from arrow_matrix_tpu_torch.obs.smoke import validate_run_dir
    from arrow_matrix_tpu_torch.parallel.launch import spawn
    from arrow_matrix_tpu_torch.serve import smoke_serve

    dev = device or "cuda"
    summary = spawn(smoke_rank, 4, (os.path.abspath(out),),
                    backend=smoke_backend(4, None, dev), device=dev,
                    threads=1)[0]
    summary["_run_dir"] = out
    problems = validate_run_dir(out)
    max_ratio = float(os.environ.get("OBS_GATE_MAX_HBM_RATIO", "8.0"))
    problems += memory_problems(summary, max_ratio)
    problems += comm_problems(summary)
    serve_dir = os.path.join(out, "serve")
    s = smoke_serve(serve_dir, device=dev)
    s["_run_dir"] = serve_dir
    problems += serve_problems(s)
    problems += pulse_problems(s)
    problems += ledger_problems(summary, s)
    problems += run_xray_fleet(out, device=dev)
    problems += run_lens_profile(device=dev)
    return problems


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", nargs="?", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out = os.path.abspath(args.run_dir
                          or tempfile.mkdtemp(prefix="obs_gate_"))
    problems = run_gate(out, device=args.device)
    if problems:
        for prob in problems:
            print(f"obs gate: {prob}", file=sys.stderr)
        print("obs gate: FAILED", file=sys.stderr)
        return 1
    print(f"obs gate: ok ({out})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

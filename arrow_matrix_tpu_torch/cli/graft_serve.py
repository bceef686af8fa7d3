"""``graft_serve`` — run the always-on multi-tenant SpMM server over a
deterministic synthetic load, on the card.

The port's counterpart of ``arrow_matrix_tpu/cli/graft_serve.py``:
builds a Barabasi-Albert arrow decomposition (the resident operator,
folded into one SELL operator on the device), starts
:class:`~arrow_matrix_tpu_torch.serve.ArrowServer` with admission
control against the HBM budget, and drives it with the deterministic
load generator (serve/loadgen.py), so two runs of the same flags give
bit-identical per-request results, also across a SIGKILL and a
checkpoint resume (``--checkpoint``).

    python -m arrow_matrix_tpu_torch.cli.graft_serve --vertices 65536 \\
        --width 2048 --features 16 --requests 32 --max_batch_k 128 \\
        --checkpoint ck --results_out results.npz

Prints the SLO report (requests/s, p50/p99 latency, the shed/rejected
census, HBM occupancy) and, with ``--obs_dir``, writes
``serve_summary.json``, ``metrics.jsonl`` and the flight recorder there.
``--results_out`` writes every completed request's result (one array
per request id), the replay artifact.  ``--pulse`` attaches the live
telemetry (a PulseMonitor with the SLO-burn watchdog, ``--slo_p99_ms``
its p99 target) and a request-correlated tracer: ``--obs_dir`` then also
gets ``pulse_ring.json``, ``pulse_metrics.prom`` and
``serve_trace.json``, ``--results_out`` the window series as
``_pulse_windows``, and ``--pulse_port`` (0: any free port) serves
``/metrics``, ``/pulse.json`` and ``/healthz`` while the run lasts.
Runs on the card; ``--device cpu`` runs the plain PyTorch versions.
Exits non-zero only when a request FAILED (shed and rejected are
explicit, policy-level outcomes).

``--fmt ell`` serves ``MultiLevelArrow(mesh=, fmt="ell")`` rungs over a
mesh of ``--devices`` ranks (``cli/common.launch_ranks``; one rank is a
mesh of one): every rank runs the server on the same trace, rank 0
decides the batches, and rank 0 prints the report and writes the
summary, ``--results_out`` and the observability artifacts.  Checkpoints
are written by rank 0 and read by every rank.

    python -m arrow_matrix_tpu_torch.cli.graft_serve --fmt ell \
        --devices 2 --backend gloo --checkpoint ck --results_out r.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from arrow_matrix_tpu_torch.cli.common import (
        add_device_args,
        add_heal_args,
        add_rank_args,
    )

    p = argparse.ArgumentParser(
        prog="graft_serve", description=__doc__.splitlines()[0])
    p.add_argument("--vertices", type=int, default=256)
    p.add_argument("--width", type=int, default=32,
                   help="arrow width of the resident decomposition")
    p.add_argument("--features", type=int, default=4,
                   help="feature width k of every synthetic request")
    p.add_argument("--tenants", type=int, default=4)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--iterations", type=int, default=3,
                   help="SpMM iterations per request")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--fmt", type=str, default="fold",
                   choices=["fold", "ell"],
                   help="resident executor format: 'fold' (one SELL "
                        "operator, the full degradation ladder); 'ell' "
                        "shards level blocks over a mesh of --devices "
                        "ranks")
    p.add_argument("--kernel", type=str, default="xla", choices=["xla"],
                   help="base rung kernel: 'xla' is the hand-written K1 "
                        "on the card")
    p.add_argument("--repl", type=int, default=1,
                   help="base rung column groups (fold)")
    p.add_argument("--overlap_slabs", type=int, default=1,
                   help="base rung overlap sub-slabs")
    p.add_argument("--queue", type=int, default=16,
                   help="bounded queue capacity; overflow sheds "
                        "explicitly")
    p.add_argument("--max_batch_k", type=int, default=0,
                   help="dynamic batching: concatenate compatible queued "
                        "requests along the feature axis up to this "
                        "combined width (0 disables)")
    p.add_argument("--hbm_budget_mb", type=float, default=0.0,
                   help="HBM budget for admission control in MiB (0 = "
                        "the device's budget, or AMT_HBM_GB)")
    p.add_argument("--degrade_after", type=int, default=2,
                   help="recovered faults per tenant before its rung "
                        "degrades")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="per-request queueing deadline seconds (0 = "
                        "none); expired requests are shed explicitly at "
                        "dequeue")
    p.add_argument("--obs_dir", type=str, default=None,
                   help="run directory for serve_summary.json, "
                        "metrics.jsonl and the flight recorder")
    p.add_argument("--pulse", action="store_true",
                   help="attach live telemetry: sliding-window SLO "
                        "series, the SLO-burn watchdog and a "
                        "request-correlated trace")
    p.add_argument("--pulse_window", type=float, default=0.5,
                   help="pulse sliding-window width in seconds")
    p.add_argument("--pulse_port", type=int, default=-1,
                   help="with --pulse, serve /metrics, /pulse.json and "
                        "/healthz on this port (0 = any free port; -1 = "
                        "none)")
    p.add_argument("--slo_p99_ms", type=float, default=0.0,
                   help="p99 latency SLO target of the burn watchdog "
                        "(with --pulse)")
    p.add_argument("--results_out", type=str, default=None,
                   help="write completed request results to this .npz "
                        "(one array per request id): the replay "
                        "artifact")
    add_device_args(p)
    add_rank_args(p)
    add_heal_args(p, checkpoint_every_default=2)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fmt == "ell":
        from arrow_matrix_tpu_torch.cli.common import launch_ranks

        try:
            return launch_ranks(args, serve_rank)
        except SystemExit as e:
            raise SystemExit(f"graft_serve: {e}") from None
    if args.devices != 1:
        raise SystemExit("graft_serve: --devices serves --fmt ell over a "
                         "mesh; the fold is one device's")

    from arrow_matrix_tpu_torch.cli.common import setup_platform

    return serve(args, setup_platform(args))


def serve_rank(ctx, args) -> int:
    """One rank of ``--fmt ell``: its mesh of every rank, then
    :func:`serve` on it (rank 0 reports and writes)."""
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    return serve(args, ctx.device, mesh=make_mesh((ctx.world,),
                                                  ("blocks",)),
                 writer=ctx.rank == 0)


def serve(args, device, mesh=None, writer: bool = True) -> int:
    """Build the rungs, serve the trace, report; ``writer``: this
    process prints the report and writes the run's files."""
    import numpy as np

    from arrow_matrix_tpu_torch.faults import RetryPolicy
    from arrow_matrix_tpu_torch.obs import MetricsRegistry, flight
    from arrow_matrix_tpu_torch.serve import (
        ArrowServer,
        ExecConfig,
        ba_executor_factory,
        run_trace,
        slo_summary,
        synthetic_trace,
        write_serve_artifacts,
    )

    say = print if writer else (lambda *a, **k: None)
    registry = MetricsRegistry(run_dir=args.obs_dir if writer else None)
    if args.obs_dir and writer:
        os.makedirs(args.obs_dir, exist_ok=True)
        flight.install(os.path.join(args.obs_dir, "flight.json"))

    factory, n_rows = ba_executor_factory(
        args.vertices, args.width, args.seed, fmt=args.fmt, mesh=mesh,
        device=device)
    base_cfg = ExecConfig(kernel=args.kernel, repl=args.repl,
                          overlap_slabs=args.overlap_slabs)
    policy = RetryPolicy.from_args(args)
    budget = (int(args.hbm_budget_mb * 2**20)
              if args.hbm_budget_mb > 0 else None)
    monitor, endpoint, tracer = None, None, None
    if args.pulse and writer:
        from arrow_matrix_tpu_torch.obs import Tracer, pulse as pulse_mod

        tracer = Tracer("graft-serve", registry=registry)
        ring = (os.path.join(args.obs_dir, "pulse_ring.json")
                if args.obs_dir else None)
        monitor = pulse_mod.PulseMonitor(
            window_s=args.pulse_window, ring_path=ring,
            name="graft-serve",
            watchdog=pulse_mod.SloWatchdog(pulse_mod.default_rules(
                target_p99_ms=(args.slo_p99_ms
                               if args.slo_p99_ms > 0 else None))))
    server = ArrowServer(
        factory, base_cfg, hbm_budget_bytes=budget,
        queue_capacity=args.queue, policy=policy,
        checkpoint_dir=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        max_batch_k=args.max_batch_k,
        degrade_after=args.degrade_after,
        registry=registry, tracer=tracer, name="graft-serve",
        verbose=writer)
    if monitor is not None:
        server.attach_pulse(monitor)
        if args.pulse_port >= 0:
            from arrow_matrix_tpu_torch.obs import PulseEndpoint

            endpoint = PulseEndpoint(monitor,
                                     port=args.pulse_port).start()
            print(f"graft-serve: pulse endpoint at {endpoint.url}"
                  f"/metrics", flush=True)
    trace = synthetic_trace(
        n_rows, tenants=args.tenants, requests=args.requests,
        k=args.features, iterations=args.iterations, seed=args.seed,
        deadline_s=args.deadline if args.deadline > 0 else None)
    t0 = time.perf_counter()
    tickets = run_trace(server, trace)
    wall = time.perf_counter() - t0
    if monitor is not None:
        monitor.close()
    summary = slo_summary(server, tickets, wall, pulse=monitor)

    lat = summary["latency_ms"]
    say(f"graft-serve: {summary['requests']} requests over "
        f"{args.tenants} tenants — {summary['completed']} completed,"
        f" {summary['shed']} shed, {summary['rejected']} rejected, "
        f"{summary['failed']} failed in {wall:.2f}s "
        f"({(summary['requests_per_s'] or 0):.2f} req/s) on {device}")
    if lat["count"]:
        say(f"graft-serve: latency p50={lat['p50']:.1f}ms "
            f"p90={lat['p90']:.1f}ms p99={lat['p99']:.1f}ms")
    hbm = summary["hbm"]
    say(f"graft-serve: hbm peak {hbm['peak_in_use_bytes']} / "
        f"{hbm['budget_bytes']} B "
        f"(peak occupancy {hbm['peak_occupancy']:.2e}; resident "
        f"operator {hbm['resident_bytes']} B)")
    if summary["faults_seen"]:
        say(f"graft-serve: {summary['faults_seen']} fault(s) seen, "
            f"{summary['recoveries']} recover(ies), "
            f"{summary['checkpoint_corruptions']} checkpoint "
            f"corruption(s) discarded")
    if monitor is not None:
        pt = summary["pulse"]
        burns = [e for e in pt["burn_events"]
                 if e["event"] == "slo_burn"]
        say(f"graft-serve: pulse — {len(pt['windows'])} windows of "
            f"{pt['window_s']}s, {len(burns)} SLO burn(s)"
            + (": " + ", ".join(sorted({b['rule'] for b in burns}))
                 if burns else ""), flush=True)
    if args.results_out and writer:
        done = {t.request.request_id: t.result for t in tickets
                if t.result is not None}
        if monitor is not None:
            # The window series rides the replay artifact for offline
            # diffing, only with --pulse: it is timing-shaped, not
            # replay-identical.
            done["_pulse_windows"] = np.frombuffer(
                json.dumps(summary["pulse"]["windows"]).encode(),
                dtype=np.uint8)
        np.savez(args.results_out, **done)
        say(f"graft-serve: wrote {len(done)} result(s) to "
            f"{args.results_out}")
    if args.obs_dir and writer:
        if tracer is not None:
            tp = tracer.save(os.path.join(args.obs_dir,
                                          "serve_trace.json"))
            say(f"graft-serve: wrote request-correlated trace {tp}")
        if monitor is not None:
            with open(os.path.join(args.obs_dir, "pulse_metrics.prom"),
                      "w", encoding="utf-8") as fh:
                fh.write(monitor.exposition_text())
        path = write_serve_artifacts(args.obs_dir, summary,
                                     registry=registry)
        rec = flight.get_recorder()
        if rec is not None:
            rec.seal("graft-serve run complete")
            flight.set_recorder(None)
        say(f"graft-serve: wrote {path}")
    if endpoint is not None:
        endpoint.stop()
    if summary["failed"]:
        if writer:
            print(f"graft-serve: {summary['failed']} request(s) FAILED",
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""graft_trace: produce, inspect and diff smoke run directories.

Subcommands:

  smoke OUT          reduced-scale run of the five mesh algorithms on
                     ``--devices`` ranks (on the card unless ``--device
                     cpu``) -> OUT/{<algo>.trace.json, metrics.jsonl,
                     summary.json}
  summarize RUN      per-algorithm table: phase ms, step ms, bytes vs
                     ideal, device bytes vs predicted
  diff A B           per-algorithm, per-phase deltas between two runs;
                     exits 1 when any phase (or the counted bytes)
                     regresses beyond --threshold
  export RUN --out   merge the per-algorithm traces into one
                     Perfetto-loadable file (one pid per algorithm)
  memreport RUN      per-algorithm memory report (argument/output/temp
                     bytes, measured vs the format model) + shard
                     imbalance report
  blackbox PATH      print a flight-recorder artifact (or the newest
                     one under a directory): the last events before a
                     wedge or kill, the seal reason, the last memory
                     report

The port of ``arrow_matrix_tpu/obs/__main__.py``; installed as
``graft_trace_torch`` and runnable as ``python -m
arrow_matrix_tpu_torch.obs``.  ``summarize``, ``diff``, ``export`` and
``memreport`` read either package's run directories (the same
``summary.json`` keys).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional


def _load_summary(run_dir: str) -> dict:
    path = os.path.join(run_dir, "summary.json")
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _fmt_bytes(b) -> str:
    return "-" if b is None else f"{int(b):,d}"


def _fmt_ratio(r) -> str:
    return "-" if r is None else f"{r:.2f}"


def smoke_rank(ctx, out: str, kw: dict) -> dict:
    """``run_smoke`` in one rank of the smoke's world."""
    from arrow_matrix_tpu_torch.obs.smoke import run_smoke

    return run_smoke(out, n_dev=ctx.world, **kw)


def smoke_backend(devices: int, backend: Optional[str], device: str) -> str:
    """The smoke's process-group backend: as asked, else gloo on the CPU
    and on a card shared by several ranks, nccl when every rank has a
    card of its own."""
    if backend is not None or device == "cpu":
        return backend or "gloo"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("graft_trace smoke: no CUDA device "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run the ranks on the CPU")
    return "nccl" if devices <= torch.cuda.device_count() else "gloo"


def cmd_smoke(args) -> int:
    from arrow_matrix_tpu_torch.obs.smoke import ALGORITHMS, validate_run_dir
    from arrow_matrix_tpu_torch.parallel.launch import spawn

    algorithms = (tuple(args.algorithms.split(","))
                  if args.algorithms else ALGORITHMS)
    backend = smoke_backend(args.devices, args.backend, args.device)
    kw = dict(n=args.n, width=args.width, k=args.k, iters=args.iters,
              algorithms=algorithms)
    spawn(smoke_rank, args.devices, args=(os.path.abspath(args.out), kw),
          backend=backend, device=args.device)
    problems = validate_run_dir(args.out, algorithms=algorithms)
    for p in problems:
        print(f"INVALID: {p}", file=sys.stderr)
    print(f"run dir: {args.out} ({args.devices} {backend} rank(s), "
          f"device {args.device})")
    _print_summary(_load_summary(args.out))
    return 1 if problems else 0


def _print_summary(summary: dict) -> None:
    algos = summary.get("algorithms", {})
    print(f"{'algorithm':12s} {'step ms':>9s} {'iterate ms':>11s} "
          f"{'comm bytes':>12s} {'ideal':>12s} {'ratio':>6s}")
    for name, rec in sorted(algos.items()):
        iterate = rec.get("phase_ms", {}).get(f"{name}/iterate")
        print(f"{name:12s} {rec.get('step_ms_mean', 0.0):9.2f} "
              f"{(iterate or 0.0):11.1f} "
              f"{_fmt_bytes(rec.get('measured_bytes')):>12s} "
              f"{_fmt_bytes(rec.get('ideal_bytes')):>12s} "
              f"{_fmt_ratio(rec.get('bytes_vs_ideal')):>6s}")
    if not any(rec.get("hbm_measured_bytes") is not None
               for rec in algos.values()):
        return
    print(f"{'algorithm':12s} {'hbm bytes':>12s} {'predicted':>12s} "
          f"{'ratio':>6s} {'nnz max/mean':>13s} {'waste':>6s}")
    for name, rec in sorted(algos.items()):
        imb = rec.get("imbalance") or {}
        print(f"{name:12s} "
              f"{_fmt_bytes(rec.get('hbm_measured_bytes')):>12s} "
              f"{_fmt_bytes(rec.get('hbm_predicted_bytes')):>12s} "
              f"{_fmt_ratio(rec.get('hbm_vs_predicted')):>6s} "
              f"{_fmt_ratio(imb.get('nnz_max_over_mean')):>13s} "
              f"{_fmt_ratio(imb.get('padded_slot_waste')):>6s}")


def cmd_summarize(args) -> int:
    summary = _load_summary(args.run)
    scale = summary.get("scale", {})
    if scale:
        print("scale: " + ", ".join(f"{k}={v}"
                                    for k, v in sorted(scale.items())))
    _print_summary(summary)
    return 0


def _diff_records(a: dict, b: dict, threshold: float,
                  min_delta_ms: float) -> List[dict]:
    """Per-algorithm, per-quantity relative deltas of b against a.  A
    quantity regresses when it grows by more than ``threshold``
    (relative); a time must also grow by more than ``min_delta_ms``, so
    scheduler noise on micro-phases does not flag."""
    rows: List[dict] = []
    for name in sorted(set(a) | set(b)):
        ra, rb = a.get(name), b.get(name)
        if ra is None or rb is None:
            rows.append({"algorithm": name, "quantity": "presence",
                         "a": ra is not None, "b": rb is not None,
                         "delta": None,
                         "regressed": ra is not None and rb is None})
            continue

        quantities: Dict[str, tuple] = {
            "step_ms_mean": (ra.get("step_ms_mean"),
                             rb.get("step_ms_mean"), True),
            "measured_bytes": (ra.get("measured_bytes"),
                               rb.get("measured_bytes"), False),
        }
        pa, pb = ra.get("phase_ms", {}), rb.get("phase_ms", {})
        for phase in sorted(set(pa) | set(pb)):
            quantities[f"phase:{phase}"] = (pa.get(phase), pb.get(phase),
                                            True)

        for qname, (va, vb, is_time) in quantities.items():
            if va is None or vb is None:
                continue
            delta = None if va == 0 else (vb - va) / va
            grew = (vb - va) > (min_delta_ms if is_time else 0)
            regressed = (delta is not None and delta > threshold and grew)
            rows.append({"algorithm": name, "quantity": qname,
                         "a": va, "b": vb, "delta": delta,
                         "regressed": regressed})
    return rows


def cmd_diff(args) -> int:
    sa = _load_summary(args.run_a).get("algorithms", {})
    sb = _load_summary(args.run_b).get("algorithms", {})
    rows = _diff_records(sa, sb, args.threshold, args.min_delta_ms)

    regressions = 0
    print(f"{'algorithm':12s} {'quantity':28s} {'A':>12s} {'B':>12s} "
          f"{'delta':>8s}")
    for r in rows:
        if r["quantity"] == "presence":
            if r["regressed"]:
                regressions += 1
                print(f"{r['algorithm']:12s} {'presence':28s} "
                      f"{'yes':>12s} {'MISSING':>12s} {'':>8s}  REGRESSED")
            continue
        delta = "-" if r["delta"] is None else f"{r['delta']:+.1%}"
        flag = "  REGRESSED" if r["regressed"] else ""
        if r["regressed"]:
            regressions += 1
        if args.all or r["regressed"]:
            print(f"{r['algorithm']:12s} {r['quantity']:28s} "
                  f"{r['a']:12.2f} {r['b']:12.2f} {delta:>8s}{flag}")
    if regressions:
        print(f"{regressions} regression(s) beyond "
              f"{args.threshold:.0%}", file=sys.stderr)
        return 1
    print("no regressions")
    return 0


def cmd_export(args) -> int:
    summary = _load_summary(args.run)
    events: List[dict] = []
    for pid, (name, rec) in enumerate(
            sorted(summary.get("algorithms", {}).items()), start=1):
        tpath = os.path.join(args.run, rec.get("trace",
                                               f"{name}.trace.json"))
        with open(tpath, encoding="utf-8") as fh:
            trace = json.load(fh)
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        for e in trace.get("traceEvents", ()):
            if e.get("ph") == "M":
                continue
            e = dict(e)
            e["pid"] = pid
            events.append(e)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out} ({len(events)} events)")
    return 0


def cmd_memreport(args) -> int:
    from arrow_matrix_tpu_torch.obs.comm import hbm_budget_bytes
    from arrow_matrix_tpu_torch.obs.imbalance import format_imbalance_report
    from arrow_matrix_tpu_torch.obs.memview import (
        format_memory_report,
        largest_fitting_repl,
    )

    summary = _load_summary(args.run)
    algos = summary.get("algorithms", {})
    try:
        budget = hbm_budget_bytes(device=args.device)
    except RuntimeError as e:
        raise SystemExit(f"graft_trace memreport: {e}") from None
    missing = 0
    for name, rec in sorted(algos.items()):
        print(f"== {name} ==")
        if rec.get("memory") is None:
            print("  no memory report in this run")
            missing += 1
        else:
            rep = {"report": rec["memory"],
                   "measured_bytes": rec.get("hbm_measured_bytes"),
                   "predicted_bytes": rec.get("hbm_predicted_bytes"),
                   "ratio": rec.get("hbm_vs_predicted"),
                   "source": rec.get("hbm_source", "unknown")}
            print(format_memory_report(rep))
        predicted = rec.get("hbm_predicted_bytes")
        if predicted:
            # The 2.5D planning line: replication multiplies the
            # per-device footprint by c; the largest c the static
            # predictor certifies against the budget.
            c_fit = largest_fitting_repl(predicted, budget)
            print(f"largest 2.5D replication fitting budget "
                  f"({budget / 2**30:.2f} GiB, {args.device}): c={c_fit} "
                  f"(predicted {predicted} B per device x c)")
        imb = rec.get("imbalance")
        if imb is not None:
            print(format_imbalance_report(imb))
    return 1 if missing else 0


def cmd_blackbox(args) -> int:
    from arrow_matrix_tpu_torch.obs import flight

    path = args.path
    if os.path.isdir(path):
        found = flight.newest_artifact(path)
        if found is None:
            print(f"no flight artifacts under {path}", file=sys.stderr)
            return 1
        path = found
    try:
        snapshot = flight.load(path)
    except (OSError, ValueError) as e:
        print(f"unreadable flight artifact {path}: {e}", file=sys.stderr)
        return 1
    print(f"artifact: {path}")
    for line in flight.format_events(snapshot, last=args.last):
        print(line)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graft_trace", description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("smoke", help="reduced-scale run of the five mesh "
                                      "algorithms on ranks")
    sp.add_argument("out", help="run directory to create")
    sp.add_argument("--devices", type=int, default=4,
                    help="ranks of the smoke's world, one process each")
    sp.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where the ranks run (default: the card)")
    sp.add_argument("--backend", type=str, default=None,
                    choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl when every "
                         "rank has a card of its own, else gloo)")
    sp.add_argument("--n", type=int, default=256)
    sp.add_argument("--width", type=int, default=32)
    sp.add_argument("--k", type=int, default=4)
    sp.add_argument("--iters", type=int, default=3)
    sp.add_argument("--algorithms", default=None,
                    help="comma-separated subset (default: all five)")
    sp.set_defaults(fn=cmd_smoke)

    ss = sub.add_parser("summarize", help="summarize a run directory")
    ss.add_argument("run")
    ss.set_defaults(fn=cmd_summarize)

    sd = sub.add_parser("diff", help="diff run B against baseline A")
    sd.add_argument("run_a")
    sd.add_argument("run_b")
    sd.add_argument("--threshold", type=float, default=0.2,
                    help="relative growth beyond which a quantity "
                         "counts as regressed (default 0.2 = +20%%)")
    sd.add_argument("--min-delta-ms", type=float, default=0.1,
                    help="absolute ms growth a time delta must also "
                         "exceed (noise floor for micro-phases)")
    sd.add_argument("--all", action="store_true",
                    help="print every quantity, not just regressions")
    sd.set_defaults(fn=cmd_diff)

    se = sub.add_parser("export", help="merge per-algorithm traces into "
                                       "one Perfetto file")
    se.add_argument("run")
    se.add_argument("--out", required=True)
    se.set_defaults(fn=cmd_export)

    sm = sub.add_parser("memreport", help="per-algorithm memory + "
                                          "imbalance report")
    sm.add_argument("run")
    sm.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="the device whose budget the planning line "
                         "uses (default: the card)")
    sm.set_defaults(fn=cmd_memreport)

    sb = sub.add_parser("blackbox", help="print a flight-recorder "
                                         "artifact")
    sb.add_argument("path", help="artifact file, or a directory to "
                                 "pick the newest artifact from")
    sb.add_argument("--last", type=int, default=None,
                    help="only the last N events")
    sb.set_defaults(fn=cmd_blackbox)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

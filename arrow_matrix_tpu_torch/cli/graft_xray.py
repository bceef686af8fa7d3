"""``graft_xray`` — operator surface of the fleet tracer.

The port's copy of ``arrow_matrix_tpu/cli/graft_xray.py``, over the
port's ``obs/xray.py``; run it as ``python -m
arrow_matrix_tpu_torch.cli.graft_xray``.  Subcommands:

* ``merge`` — stitch a fleet run dir's per-process trace docs
  (``router_xray.json`` + each worker's ``xray_trace.json``, falling
  back to flight-ring recovery with ``truncated`` markers for workers
  that died mid-run) into ONE clock-offset-aligned Perfetto trace,
  ``fleet_xray.json`` — open it in ui.perfetto.dev.
* ``report`` — per-traffic-class critical-path decomposition of a
  merged trace: queue / admission / serialize / wire / worker_queue /
  compute / checkpoint / response mean ms per class.  The analyzer
  that localizes WHERE a byte-cheaper class spends the time it saves.
  ``--ledger-dir`` appends the per-class segment means as
  ``kind="xray"`` records.  ``--lens PROFILE`` splits each class's
  compute segment by a lens profile's per-tier attribution
  (``obs/lens.attribution_fractions``).
* ``diff`` — per-class, per-segment regression check of one report
  JSON against a baseline report JSON; exits nonzero on regression.

Prints ONE JSON line as its last stdout line (CLI contract).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graft_xray", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("merge", help="merge a fleet run dir into one "
                                     "Perfetto trace")
    m.add_argument("run_dir")
    m.add_argument("--out", default=None,
                   help="output path (default "
                        "<run_dir>/fleet_xray.json)")

    r = sub.add_parser("report", help="per-class critical-path "
                                      "decomposition")
    r.add_argument("run_dir",
                   help="fleet run dir (uses fleet_xray.json when "
                        "present, else merges on the fly)")
    r.add_argument("--out", default=None,
                   help="write the report JSON here too")
    r.add_argument("--ledger-dir", default=None,
                   help="append per-class segment means as "
                        "kind='xray' ledger records")
    r.add_argument("--lens", default=None, metavar="PROFILE",
                   help="lens profile JSON (graft_lens profile --out): "
                        "subdivide each class's compute segment by "
                        "per-tier attribution (the exact class by the "
                        "f32 fractions, approx by the bf16 ones when "
                        "profiled)")
    r.add_argument("--json", action="store_true",
                   help="skip the table, JSON line only")

    d = sub.add_parser("diff", help="report vs baseline report")
    d.add_argument("baseline", help="baseline report JSON "
                                    "(graft_xray report --out)")
    d.add_argument("new", help="new report JSON")
    d.add_argument("--rel-threshold", type=float, default=0.10)
    d.add_argument("--abs-floor-ms", type=float, default=1.0)
    return p


def _load_trace(run_dir: str):
    import os

    from arrow_matrix_tpu_torch.obs import xray

    path = os.path.join(run_dir, "fleet_xray.json")
    if os.path.exists(path):
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    return xray.merge_run_dir(run_dir)


def _load_classes(run_dir: str) -> dict:
    """request_id -> served_class from the run's fleet report (the
    honest class label — a certificate-miss fallback reclassifies)."""
    import os

    try:
        with open(os.path.join(run_dir, "fleet_report.json"),
                  encoding="utf-8") as fh:
            report = json.load(fh)
    except (OSError, ValueError):
        return {}
    return {t["request_id"]: t["served_class"]
            for t in report.get("tickets", [])
            if t.get("served_class")}


def cmd_merge(args) -> int:
    import os

    from arrow_matrix_tpu_torch.obs import xray

    trace = xray.merge_run_dir(args.run_dir)
    if args.out:
        from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
        atomic_write_json(args.out, trace)
        path = args.out
    else:
        path = xray.save_fleet_trace(trace, args.run_dir)
    info = dict(trace["xray"])
    info.update({"ok": True, "cmd": "merge", "trace": path,
                 "events": len(trace["traceEvents"])})
    info.pop("offsets_ns", None)
    print(json.dumps(info, sort_keys=True))
    return 0


def cmd_report(args) -> int:
    from arrow_matrix_tpu_torch.obs import xray

    trace = _load_trace(args.run_dir)
    cp = xray.critical_path(trace, classes=_load_classes(args.run_dir))
    if getattr(args, "lens", None):
        from arrow_matrix_tpu_torch.obs import lens as lens_mod
        with open(args.lens, encoding="utf-8") as fh:
            profile = json.load(fh)
        dtypes = profile.get("dtypes", {})
        fractions = {}
        if "f32" in dtypes:
            fractions["exact"] = lens_mod.attribution_fractions(
                profile, "f32")
        # Approximate traffic rides the bf16 carriage when it was
        # profiled; otherwise the f32 attribution is the best shape.
        approx_fd = "bf16" if "bf16" in dtypes else "f32"
        if approx_fd in dtypes:
            fractions["approx"] = lens_mod.attribution_fractions(
                profile, approx_fd)
        cp = xray.subdivide_compute(cp, fractions)
    if not args.json:
        for line in xray.format_report(cp):
            print(line)
    if args.out:
        from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
        atomic_write_json(args.out, cp, indent=2, sort_keys=True)
    if args.ledger_dir:
        from arrow_matrix_tpu_torch.ledger import store
        for cls in sorted(cp["per_class"]):
            agg = cp["per_class"][cls]
            for name, ms in agg["segments_mean_ms"].items():
                store.record(
                    "xray", f"seg_{name}_{cls}", round(float(ms), 4),
                    directory=args.ledger_dir, unit="ms",
                    knobs={"traffic_class": cls, "segment": name,
                           "count": agg["count"]})
            store.record(
                "xray", f"iter_ms_{cls}",
                round(float(agg["mean_ms"]), 4),
                directory=args.ledger_dir, unit="ms",
                knobs={"traffic_class": cls, "count": agg["count"]})
    summary = {"ok": True, "cmd": "report",
               "requests": len(cp["requests"]),
               "per_class": {cls: {"count": agg["count"],
                                   "mean_ms": round(agg["mean_ms"], 3)}
                             for cls, agg in cp["per_class"].items()},
               "truncated_requests": sorted(
                   rid for rid, rec in cp["requests"].items()
                   if rec["truncated"])}
    print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_diff(args) -> int:
    from arrow_matrix_tpu_torch.obs import xray

    with open(args.baseline, encoding="utf-8") as fh:
        base = json.load(fh)
    with open(args.new, encoding="utf-8") as fh:
        new = json.load(fh)
    d = xray.diff_reports(base, new,
                          rel_threshold=args.rel_threshold,
                          abs_floor_ms=args.abs_floor_ms)
    for line in d["regressions"]:
        print(f"REGRESSION {line}", file=sys.stderr)
    print(json.dumps({"ok": not d["regressions"], "cmd": "diff",
                      "regressions": d["regressions"]},
                     sort_keys=True))
    return 1 if d["regressions"] else 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return {"merge": cmd_merge, "report": cmd_report,
            "diff": cmd_diff}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())

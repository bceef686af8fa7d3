"""``graft_tune`` — structure-specialized K1 tuning with a persistent
plan cache: the port's copy of ``arrow_matrix_tpu/cli/graft_tune.py``.

Three subcommands close the tune lifecycle:

* ``search`` — fingerprint a structure (``--ba n,width,seed`` or a
  committed ``--base`` graphio directory), race the pruned candidate
  space in subprocess-isolated children on the card (``--device cpu``:
  on the host), persist the winner as a versioned TunePlan under the
  port's plan cache, ``bench_results/tune_plans_torch/<hash>.json``.
  A second search of an unchanged structure is a pure cache hit —
  zero children spawned.
* ``show`` — print a cached plan file (or list every cached hash).
* ``check`` — replay the plan cache's promises (bit-identity vs the
  golden default fold, ≤5% regression vs default, hash integrity,
  cache purity); same engine as the port's ``tools/tune_gate.py``;
  exits nonzero on any broken promise.

Consumption is ``plan="auto"`` on ``MultiLevelArrow`` (a loud
``TunePlanMiss`` and the defaults on a miss) and ``tune_plan=`` on the
serve scheduler.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _source_from_args(args) -> dict:
    if args.ba and args.base:
        raise SystemExit("graft_tune: --ba and --base are exclusive")
    if args.ba:
        try:
            n, width, seed = (int(v) for v in args.ba.split(","))
        except ValueError:
            raise SystemExit("graft_tune: --ba wants N,WIDTH,SEED "
                             "(e.g. --ba 4096,128,7)")
        return {"kind": "ba", "n": n, "m": args.ba_m, "width": width,
                "seed": seed, "max_levels": args.max_levels}
    if args.base:
        src = {"kind": "dir", "base": args.base}
        if args.width:
            src["width"] = args.width
        return src
    raise SystemExit("graft_tune search: need --ba N,WIDTH,SEED or "
                     "--base DIR")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graft_tune", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("search", help="race candidates, cache the "
                                      "winning plan")
    s.add_argument("--ba", type=str, default=None,
                   help="Barabasi-Albert source: N,WIDTH,SEED")
    s.add_argument("--ba_m", type=int, default=3,
                   help="BA attachment parameter m")
    s.add_argument("--max_levels", type=int, default=10)
    s.add_argument("--base", type=str, default=None,
                   help="graphio artifact base (the path prefix of its "
                        "files)")
    s.add_argument("--width", type=int, default=None,
                   help="decomposition width inside --base (default: "
                        "autodetect)")
    s.add_argument("--k", type=int, action="append", default=None,
                   help="feature width(s) to tune (repeatable; "
                        "default 16 128)")
    s.add_argument("--iters", type=int, default=3)
    s.add_argument("--timeout", type=float, default=240.0,
                   help="per-candidate child timeout seconds")
    s.add_argument("--plan-dir", type=str, default=None)
    s.add_argument("--refresh", action="store_true",
                   help="re-search even on a cache hit")
    s.add_argument("--allow-int8", action="store_true",
                   help="include the opt-in int8 carriage candidate")
    s.add_argument("--synth", action="store_true",
                   help="graft-synth: derive per-level schedules from "
                        "the degree ladder and race them alongside "
                        "the fixed menu")
    s.add_argument("--traffic-class", choices=("exact", "approx"),
                   default="exact",
                   help="winner gate: exact = f32 bit-identity "
                        "(default); approx = class tolerance with a "
                        "probed error-curve certificate")
    s.add_argument("--restrict", type=str, action="append",
                   default=None,
                   help="race only these candidate names (repeatable)")
    s.add_argument("--json", action="store_true",
                   help="print the full report(s) as JSON")
    s.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="where the golden and the children run (default: "
                        "the card)")
    s.add_argument("--run-dir", type=str, default=None,
                   help="where the goldens go (default "
                        "bench_results/tune_runs_torch/<hash>)")
    s.add_argument("--ledger-dir", type=str, default=None,
                   help="the ledger of the winner's record")
    s.add_argument("--quiet", action="store_true")

    w = sub.add_parser("show", help="print cached plan file(s)")
    w.add_argument("hash", nargs="?", default=None,
                   help="structure hash (omit to list the cache)")
    w.add_argument("--plan-dir", type=str, default=None)

    c = sub.add_parser("check", help="gate the plan cache "
                                     "(tools/tune_gate.py engine)")
    c.add_argument("--plan-dir", type=str, default=None)
    c.add_argument("--hash", action="append", default=None)
    c.add_argument("--iters", type=int, default=3)
    c.add_argument("--repeats", type=int, default=3)
    c.add_argument("--rel-tol", type=float, default=0.05)
    c.add_argument("--abs-tol-ms", type=float, default=0.25)
    c.add_argument("--refresh", action="store_true")
    c.add_argument("--no-timing", action="store_true")
    c.add_argument("--device", choices=("cuda", "cpu"), default=None)
    c.add_argument("--quiet", action="store_true")
    return p


def _cmd_search(args) -> int:
    from arrow_matrix_tpu_torch.tune.search import search

    source = _source_from_args(args)
    ks: List[int] = args.k or [16, 128]
    reports = []
    rc = 0
    for k in ks:
        plan, report = search(source, k, iters=args.iters,
                              timeout_s=args.timeout,
                              plan_dir=args.plan_dir,
                              refresh=args.refresh,
                              allow_int8=args.allow_int8,
                              restrict=args.restrict,
                              traffic_class=args.traffic_class,
                              synth=args.synth, run_dir=args.run_dir,
                              ledger_dir=args.ledger_dir,
                              device=args.device, quiet=args.quiet)
        reports.append(report)
        if plan is None:
            rc = 1
            continue
        if not args.json:
            tag = ("cache-hit" if report.get("cache_hit")
                   else f"searched {report.get('children_spawned')} "
                        f"children")
            print(f"k={k}: {plan.candidate!r} "
                  f"{plan.measured_ms} ms (margin {plan.margin}, "
                  f"{tag}) -> {report.get('plan_path', 'cache')}")
    if args.json:
        print(json.dumps(reports if len(reports) > 1 else reports[0],
                         indent=2, sort_keys=True, default=str))
    return rc


def _cmd_show(args) -> int:
    from arrow_matrix_tpu_torch.tune.gate import gate_sources
    from arrow_matrix_tpu_torch.tune.plan import load_plan_file, plan_dir

    if args.hash is None:
        sources = gate_sources(args.plan_dir)
        if not sources:
            print(f"graft_tune: no plans in "
                  f"{plan_dir(args.plan_dir)!r}", file=sys.stderr)
            return 1
        for h, src in sources.items():
            record = load_plan_file(h, args.plan_dir) or {}
            ks = sorted((record.get("plans") or {}),
                        key=lambda s: int(s))
            winners = {s: (record["plans"][s].get("candidate"))
                       for s in ks}
            print(f"{h}  k={','.join(ks)}  winners={winners}  "
                  f"source={src}")
        return 0
    record = load_plan_file(args.hash, args.plan_dir)
    if record is None:
        print(f"graft_tune: no plan file for {args.hash!r} in "
              f"{plan_dir(args.plan_dir)!r}", file=sys.stderr)
        return 1
    print(json.dumps(record, indent=2, sort_keys=True))
    return 0


def _cmd_check(args) -> int:
    from arrow_matrix_tpu_torch.tune.gate import run_gate

    return run_gate(directory=args.plan_dir, hashes=args.hash,
                    iters=args.iters, repeats=args.repeats,
                    rel_tol=args.rel_tol, abs_tol_ms=args.abs_tol_ms,
                    refresh=args.refresh, timing=not args.no_timing,
                    device=args.device, quiet=args.quiet)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "search":
        return _cmd_search(args)
    if args.cmd == "show":
        return _cmd_show(args)
    return _cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())

"""``graft_ledger``: the operator surface of the port's ledger store.

The port's copy of ``arrow_matrix_tpu/cli/graft_ledger.py``, run as
``python -m arrow_matrix_tpu_torch.cli.graft_ledger``.  Its default
store is the port's (``bench_results/ledger_torch/``, or
``AMT_LEDGER_DIR``).  Subcommands:

* ``report`` — summarize the store per (kind, metric, structure,
  platform) key: count, median, MAD, newest value, host-load context.
* ``diff`` — compare the newest record of every key against the
  committed baseline (the same math as the gate, presented as a table
  instead of an exit code).
* ``curve`` — print error-vs-iteration curves (``kind=error_curve``)
  as aligned columns, one row per iteration.
* ``export`` — regenerate a legacy ``BENCH_r*.json`` round document
  from the store (``--round N``), so the bench trajectory continues in
  the old vocabulary without a hand-written file.  ``--out`` is
  required: a file, or a directory that receives ``BENCH_r<N>.json``.
* ``ingest`` — load committed history INTO the store: legacy
  ``BENCH_r*.json`` rounds and/or a tune plan-cache directory.
* ``probe`` — run the accuracy probe (error-vs-iteration vs the f32
  golden) on a structure, on the card unless ``--device cpu``, and
  append the curves.
* ``check`` / ``rebaseline`` — delegate to the drift gate
  (``ledger/gate.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graft_ledger", description=__doc__.splitlines()[0])
    p.add_argument("--ledger-dir", default=None,
                   help="store directory (default: AMT_LEDGER_DIR or "
                        "bench_results/ledger_torch)")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("report", help="per-key summary of the store")
    r.add_argument("--kind", default=None)
    r.add_argument("--metric", default=None)
    r.add_argument("--structure", default=None,
                   help="filter by structure hash")
    r.add_argument("--json", action="store_true")

    d = sub.add_parser("diff", help="newest records vs the baseline")
    d.add_argument("--baseline", default=None)

    c = sub.add_parser("curve", help="print error-vs-iteration curves")
    c.add_argument("--structure", default=None)
    c.add_argument("--dtype", default=None,
                   help="f32 / bf16 / int8 (default: all)")

    e = sub.add_parser("export", help="regenerate a legacy "
                                      "BENCH_r*.json round from the "
                                      "store")
    e.add_argument("--round", type=int, required=True)
    e.add_argument("--out", required=True,
                   help="output file, or a directory that receives "
                        "BENCH_r<N>.json")
    e.add_argument("--upto", default=None, metavar="RECORD_ID",
                   help="pin the export to the chain prefix ending at "
                        "this record id (default: an existing round "
                        "file's recorded parsed.ledger.head, else the "
                        "whole store)")

    i = sub.add_parser("ingest", help="load committed history into "
                                      "the store")
    i.add_argument("--bench", nargs="*", default=None,
                   help="legacy BENCH_r*.json files")
    i.add_argument("--plans", default=None,
                   help="tune plan-cache directory")

    pr = sub.add_parser("probe", help="append error-vs-iteration "
                                      "curves for a structure")
    pr.add_argument("--ba", type=str, default=None,
                    help="Barabasi-Albert source: N,WIDTH,SEED")
    pr.add_argument("--ba_m", type=int, default=3)
    pr.add_argument("--max_levels", type=int, default=10)
    pr.add_argument("--base", type=str, default=None,
                    help="committed graphio artifact directory")
    pr.add_argument("--width", type=int, default=None)
    pr.add_argument("--k", type=int, default=4)
    pr.add_argument("--iterations", type=int, default=8)
    pr.add_argument("--seed", type=int, default=3)
    pr.add_argument("--dtypes", type=str, default="f32,bf16",
                    help="comma list of f32/bf16/int8")
    pr.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu")

    g = sub.add_parser("check", help="drift gate (nonzero exit on "
                                     "regression/schema drift)")
    g.add_argument("--baseline", default=None)

    b = sub.add_parser("rebaseline", help="rebuild the baseline from "
                                          "the store")
    b.add_argument("--baseline", default=None)
    return p


def _cmd_report(args) -> int:
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.ledger.gate import baseline_key, build_baseline

    lg = Ledger(args.ledger_dir)
    recs = lg.query(kind=args.kind, metric=args.metric,
                    structure_hash=args.structure)
    if not recs:
        print(f"graft_ledger: no records in {lg.path}",
              file=sys.stderr)
        return 1
    base = build_baseline(recs)
    newest = {}
    for rec in recs:
        newest[baseline_key(rec)] = rec
    if args.json:
        print(json.dumps({"store": lg.path, "records": len(recs),
                          "baseline": base}, indent=2,
                         sort_keys=True))
        return 0
    print(f"# {lg.path}: {len(recs)} records")
    print(f"{'key':<58} {'n':>3} {'median':>12} {'mad':>10} "
          f"{'newest':>12} {'unit':>6}")
    for key in sorted(set(list(base['metrics']) + list(base['curves']))):
        rec = newest.get(key)
        entry = base["metrics"].get(key)
        if entry is not None:
            print(f"{key:<58} {entry['count']:>3} "
                  f"{entry['median']:>12.4g} {entry['mad']:>10.4g} "
                  f"{(rec or {}).get('value') or float('nan'):>12.4g} "
                  f"{entry.get('unit') or '-':>6}")
        else:
            curve = base["curves"][key]["rel_frobenius"]
            tail = curve[-1] if curve else float("nan")
            print(f"{key:<58} {len(curve):>3}pt {'curve':>12} "
                  f"{'-':>10} {tail:>12.4g} {'rel':>6}")
    return 0


def _cmd_diff(args) -> int:
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.ledger.gate import (
        band_upper,
        baseline_key,
        baseline_path,
        load_baseline,
        normalized_value,
    )

    lg = Ledger(args.ledger_dir)
    bpath = args.baseline or baseline_path(args.ledger_dir)
    baseline = load_baseline(bpath)
    newest = {}
    for rec in lg.read_all():
        newest[baseline_key(rec)] = rec
    print(f"# newest records in {lg.path} vs baseline {bpath}")
    print(f"{'key':<58} {'newest':>12} {'median':>12} {'band':>12} "
          f"{'delta%':>8}")
    rc = 0
    for key, entry in sorted(baseline.get("metrics", {}).items()):
        rec = newest.get(key)
        if rec is None:
            print(f"{key:<58} {'absent':>12}")
            continue
        nv = normalized_value(rec)
        med = entry["median"]
        upper = band_upper(entry, baseline.get("band_k", 4.0),
                           baseline.get("rel_floor", 0.05))
        delta = (100.0 * (nv - med) / med) if med and nv is not None \
            else float("nan")
        mark = ""
        if nv is not None and nv > upper and \
                (entry.get("unit") in ("ms", "s")):
            mark = "  REGRESSED"
            rc = 1
        print(f"{key:<58} {nv if nv is not None else float('nan'):>12.4g} "
              f"{med:>12.4g} {upper:>12.4g} {delta:>8.2f}{mark}")
    return rc


def _cmd_curve(args) -> int:
    from arrow_matrix_tpu_torch.ledger import Ledger

    lg = Ledger(args.ledger_dir)
    recs = lg.query(kind="error_curve",
                    structure_hash=args.structure)
    if args.dtype:
        recs = [r for r in recs
                if r.get("knobs", {}).get("dtype") == args.dtype]
    if not recs:
        print("graft_ledger: no error_curve records match",
              file=sys.stderr)
        return 1
    for rec in recs:
        knobs = rec.get("knobs", {})
        print(f"# {rec.get('metric')} structure="
              f"{rec.get('structure_hash')} k={knobs.get('k')} "
              f"seed={knobs.get('seed')} "
              f"emulated={knobs.get('emulated')} "
              f"record={rec.get('record_id')}")
        payload = rec.get("payload", {})
        fro = payload.get("frobenius", [])
        rel = payload.get("rel_frobenius", [])
        mab = payload.get("max_abs", [])
        print(f"{'iter':>4} {'frobenius':>12} {'rel_frob':>12} "
              f"{'max_abs':>12}")
        for j in range(len(rel)):
            print(f"{j:>4} "
                  f"{fro[j] if j < len(fro) else float('nan'):>12.4e} "
                  f"{rel[j]:>12.4e} "
                  f"{mab[j] if j < len(mab) else float('nan'):>12.4e}")
    return 0


def _cmd_export(args) -> int:
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.ledger.export import export_legacy_round

    import os

    out = args.out
    if os.path.isdir(out):
        out = os.path.join(out, f"BENCH_r{args.round:02d}.json")
    doc = export_legacy_round(Ledger(args.ledger_dir), args.round, out,
                              head=args.upto)
    print(f"graft_ledger: wrote {out} (metric "
          f"{doc['parsed'].get('metric')!r}, "
          f"{len(doc['parsed'].get('tuned', []))} tuned entries, "
          f"{len(doc['parsed'].get('error_curves', []))} curves)")
    return 0


def _cmd_ingest(args) -> int:
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.ledger.export import (
        ingest_legacy_bench,
        ingest_tune_plans,
    )

    lg = Ledger(args.ledger_dir)
    total = 0
    if args.bench:
        count, notes = ingest_legacy_bench(lg, args.bench)
        total += count
        for note in notes:
            print(f"  note {note}")
        print(f"graft_ledger: ingested {count} legacy bench rounds")
    if args.plans:
        count, notes = ingest_tune_plans(lg, args.plans)
        total += count
        for note in notes:
            print(f"  note {note}")
        print(f"graft_ledger: ingested {count} tune plan winners")
    if not total and not args.bench and not args.plans:
        print("graft_ledger ingest: nothing to do (pass --bench "
              "and/or --plans)", file=sys.stderr)
        return 1
    return 0


def _probe_source(args) -> dict:
    if args.ba and args.base:
        raise SystemExit("graft_ledger probe: --ba and --base are "
                         "exclusive")
    if args.ba:
        try:
            n, width, seed = (int(v) for v in args.ba.split(","))
        except ValueError:
            raise SystemExit("graft_ledger probe: --ba wants "
                             "N,WIDTH,SEED")
        return {"kind": "ba", "n": n, "m": args.ba_m, "width": width,
                "seed": seed, "max_levels": args.max_levels}
    if args.base:
        src = {"kind": "dir", "base": args.base}
        if args.width:
            src["width"] = args.width
        return src
    raise SystemExit("graft_ledger probe: need --ba N,WIDTH,SEED or "
                     "--base DIR")


def _cmd_probe(args) -> int:
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.ledger.probe import error_curves_for_source

    dtypes = tuple(s.strip() for s in args.dtypes.split(",")
                   if s.strip())
    recs = error_curves_for_source(
        _probe_source(args), k=args.k, iterations=args.iterations,
        seed=args.seed, dtypes=dtypes, ledger=Ledger(args.ledger_dir),
        device=args.device)
    for rec in recs:
        print(f"{rec['metric']}: structure="
              f"{rec['structure_hash']} final rel_frobenius="
              f"{rec['value']:.4e} -> {rec['record_id']}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "report":
        return _cmd_report(args)
    if args.cmd == "diff":
        return _cmd_diff(args)
    if args.cmd == "curve":
        return _cmd_curve(args)
    if args.cmd == "export":
        return _cmd_export(args)
    if args.cmd == "ingest":
        return _cmd_ingest(args)
    if args.cmd == "probe":
        return _cmd_probe(args)
    from arrow_matrix_tpu_torch.ledger import gate as gate_mod

    argv2: List[str] = []
    if args.ledger_dir:
        argv2 += ["--ledger-dir", args.ledger_dir]
    if getattr(args, "baseline", None):
        argv2 += ["--baseline", args.baseline]
    argv2.append("--rebaseline" if args.cmd == "rebaseline"
                 else "--check")
    return gate_mod.main(argv2)


if __name__ == "__main__":
    sys.exit(main())

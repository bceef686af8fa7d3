"""``graft_pulse`` — watch / snapshot / check live serving telemetry.

The port's copy of ``arrow_matrix_tpu/cli/graft_pulse.py``, over the
port's ``obs/pulse.py``; run it as ``python -m
arrow_matrix_tpu_torch.cli.graft_pulse``.  The operator-side companion
to obs/pulse.py.  A *source* is either a
pulse ring artifact on disk (``pulse_ring.json``, or the run directory
that contains one) or a live :class:`~arrow_matrix_tpu_torch.obs.pulse
.PulseEndpoint` URL (``http://host:port`` — ``/pulse.json`` is
appended when missing):

  * ``snapshot <source>`` — one human-readable view: totals, the last
    closed windows, active burns;
  * ``watch <source>`` — poll the source and print one line per newly
    closed window (req/s, p50/p99, occupancy, sheds, burns) until
    ``--count`` windows or Ctrl-C;
  * ``check <source> [--metrics <path-or-url>]`` — validate the ring
    document (and optionally a Prometheus exposition payload) against
    the pulse schema; exit non-zero on any problem — the validators of
    ``obs/pulse.py``;
  * ``merge <source...>`` — pool N rings (one per graft-fleet worker)
    into one merged document via the lossless Histogram.merge: the
    merged quantiles are EXACT nearest-rank over the union of raw
    samples, and each source ring's pooled windows are asserted equal
    to its own streamed totals (exit non-zero on any mismatch).

Pure stdlib + obs/pulse.py: it touches no device, so it runs anywhere
the artifacts land.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request
from typing import Optional

from arrow_matrix_tpu_torch.obs import pulse


def _resolve(source: str) -> str:
    if source.startswith(("http://", "https://")):
        return (source if source.endswith("/pulse.json")
                else source.rstrip("/") + "/pulse.json")
    if os.path.isdir(source):
        return os.path.join(source, "pulse_ring.json")
    return source


def _load(source: str) -> dict:
    src = _resolve(source)
    if src.startswith(("http://", "https://")):
        with urllib.request.urlopen(src, timeout=10) as resp:
            return json.loads(resp.read().decode())
    return pulse.load_ring(src)


def _read_text(source: str) -> str:
    if source.startswith(("http://", "https://")):
        with urllib.request.urlopen(source, timeout=10) as resp:
            return resp.read().decode()
    with open(source, encoding="utf-8") as fh:
        return fh.read()


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.1f}"


def _window_line(w: dict, base: float = 0.0) -> str:
    lat = w["latency_ms"]
    occ = w["hbm"]["occupancy"]
    extra = ""
    if w["shed"] or w["rejected"]:
        extra += f" shed={w['shed']} rej={w['rejected']}"
    if w["faults_seen"]:
        extra += f" faults={w['faults_seen']}"
    if w["degraded"]:
        extra += f" degraded={w['degraded']}"
    if w["slo_burns"]:
        extra += f" BURNS={w['slo_burns']}"
    return (f"w{w['window']:>4} +{w['start_s'] - base:.1f}s "
            f"{(w['requests_per_s'] or 0.0):7.2f} req/s "
            f"p50={_fmt_ms(lat['p50'])}ms "
            f"p99={_fmt_ms(lat['p99'])}ms "
            f"occ={'-' if occ is None else format(occ, '.2e')}"
            f"{extra}")


def cmd_snapshot(args) -> int:
    doc = _load(args.source)
    t = doc["totals"]
    lat = t["latency_ms"]
    print(f"pulse: {doc['meta'].get('name', '?')} pid="
          f"{doc['meta'].get('pid')} window={doc['window_s']}s "
          f"windows={len(doc['windows'])} "
          f"(+{doc.get('dropped_windows', 0)} dropped) "
          f"sealed={doc.get('closed') or 'LIVE'}")
    print(f"totals: {t['completed']} completed / {t['failed']} failed "
          f"/ {t['shed']} shed / {t['rejected']} rejected; "
          f"{(t['requests_per_s'] or 0.0):.2f} req/s; "
          f"p50={_fmt_ms(lat['p50'])}ms p99={_fmt_ms(lat['p99'])}ms; "
          f"{t['faults_seen']} fault(s), {t['degraded']} "
          f"degradation(s)")
    for tenant, rec in (t.get("per_tenant") or {}).items():
        tl = rec["latency_ms"]
        print(f"  {tenant}: {rec['completed']} completed "
              f"p99={_fmt_ms(tl['p99'])}ms shed={rec['shed']} "
              f"rejected={rec['rejected']}")
    base = doc["windows"][0]["start_s"] if doc["windows"] else 0.0
    for w in doc["windows"][-args.last:]:
        print("  " + _window_line(w, base))
    burning = doc.get("burning") or []
    if burning:
        print(f"BURNING now: {', '.join(burning)}")
    for e in doc.get("burn_events", []):
        print(f"  [{e['event']}] {e['rule']} window={e['window']}"
              + (f" value={e['value']:.3g} > {e['threshold']:.3g}"
                 if e["event"] == "slo_burn" else ""))
    return 0


def cmd_watch(args) -> int:
    printed = -1
    seen = 0
    base = None
    try:
        while True:
            try:
                doc = _load(args.source)
            except (OSError, json.JSONDecodeError) as e:
                print(f"graft_pulse: source unreadable ({e}); "
                      f"retrying", file=sys.stderr)
                time.sleep(args.interval)
                continue
            for w in doc["windows"]:
                if w["window"] > printed:
                    if base is None:
                        base = w["start_s"]
                    print(_window_line(w, base), flush=True)
                    printed = w["window"]
                    seen += 1
                    if args.count and seen >= args.count:
                        return 0
            if doc.get("closed"):
                print(f"graft_pulse: source sealed "
                      f"({doc['closed']})")
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def cmd_check(args) -> int:
    problems = []
    try:
        doc = _load(args.source)
    except (OSError, json.JSONDecodeError) as e:
        problems.append(f"ring unreadable: {e}")
        doc = None
    if doc is not None:
        problems += [f"ring: {p}" for p in pulse.validate_ring(doc)]
    if args.metrics:
        try:
            text = _read_text(args.metrics)
        except OSError as e:
            problems.append(f"exposition unreadable: {e}")
        else:
            problems += [f"exposition: {p}"
                         for p in pulse.validate_exposition(text)]
    for p in problems:
        print(f"graft_pulse check: PROBLEM: {p}")
    if problems:
        return 1
    n = len(doc["windows"]) if doc else 0
    print(f"graft_pulse check: OK ({n} windows"
          + (", exposition valid" if args.metrics else "") + ")")
    return 0


def cmd_merge(args) -> int:
    docs = []
    problems = []
    for source in args.sources:
        try:
            docs.append(_load(source))
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"{source}: unreadable ({e})")
    merged = pulse.merge_rings(docs)
    problems += merged["problems"]
    merged["problems"] = problems
    if args.out:
        from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

        atomic_write_json(args.out, merged, indent=2, sort_keys=True)
    if args.json:
        print(json.dumps(merged, indent=2, sort_keys=True))
    else:
        t = merged["totals"]
        lat = t["latency_ms"]
        print(f"pulse merge: {merged['rings']} ring(s), "
              f"{lat['count']} pooled samples")
        for r in merged["per_ring"]:
            print(f"  {r['name']}: {r['windows']} windows "
                  f"(+{r['dropped_windows']} dropped), "
                  f"{r['pooled_samples']} samples")
        print(f"totals: {t['completed']} completed / {t['failed']} "
              f"failed / {t['shed']} shed / {t['rejected']} rejected; "
              f"p50={_fmt_ms(lat['p50'])}ms "
              f"p90={_fmt_ms(lat['p90'])}ms "
              f"p99={_fmt_ms(lat['p99'])}ms (exact pooled quantiles)")
    for p in problems:
        print(f"graft_pulse merge: PROBLEM: {p}")
    return 1 if problems else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graft_pulse", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("snapshot",
                        help="print one view of a pulse source")
    sp.add_argument("source", help="pulse_ring.json / run dir / "
                                   "endpoint URL")
    sp.add_argument("--last", type=int, default=5,
                    help="closed windows to show")
    sp.set_defaults(fn=cmd_snapshot)

    wp = sub.add_parser("watch",
                        help="print one line per newly closed window")
    wp.add_argument("source")
    wp.add_argument("--interval", type=float, default=1.0)
    wp.add_argument("--count", type=int, default=0,
                    help="stop after this many windows (0 = until "
                         "sealed / Ctrl-C)")
    wp.set_defaults(fn=cmd_watch)

    cp = sub.add_parser("check",
                        help="validate ring (+ exposition) schema")
    cp.add_argument("source")
    cp.add_argument("--metrics", type=str, default=None,
                    help="also validate this exposition text "
                         "(pulse_metrics.prom path or /metrics URL)")
    cp.set_defaults(fn=cmd_check)

    mp = sub.add_parser(
        "merge",
        help="pool N pulse rings (fleet workers) into one exact "
             "merged document; asserts pooled == streamed per ring")
    mp.add_argument("sources", nargs="+",
                    help="pulse_ring.json paths / run dirs / "
                         "endpoint URLs")
    mp.add_argument("--out", default=None,
                    help="write the merged document here")
    mp.add_argument("--json", action="store_true",
                    help="print the merged document as JSON")
    mp.set_defaults(fn=cmd_merge)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

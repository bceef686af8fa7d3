"""Drift detection over the ledger.

The port's copy of ``arrow_matrix_tpu/ledger/gate.py`` (its CLI is
``python -m arrow_matrix_tpu_torch.tools.ledger_gate``).  Its default
store is the port's (``bench_results/ledger_torch/``, or
``AMT_LEDGER_DIR``), never the committed JAX store or its baseline.

A baseline is a per-``(kind, metric, structure_hash, platform)``
summary of the committed ledger's history: the robust center (median)
and spread (MAD) of the host-load-normalized values, plus the pinned
reference curve for ``error_curve`` records.  ``check_records``
compares fresh records against it and reports three failure families,
each of which makes the CLI exit nonzero:

* **perf regression** — a lower-is-better metric (unit ``ms``/``s``)
  whose normalized value exceeds
  ``median + max(band_k·1.4826·MAD, rel_floor·median)``.  The MAD term
  absorbs real run-to-run noise; the relative floor (default 5%)
  guarantees a planted 10% regression trips even on a low-variance
  baseline where the MAD band alone would be microscopic.  Host-load
  normalization (``value / (1 + loadavg_1m)``) keeps a number measured
  on a loaded host from tripping (or masking) the band;
* **accuracy-curve regression** — any point of a fresh error curve
  exceeding ``curve_factor ×`` the baseline curve's point (with an
  absolute floor so a zero baseline — the f32 curve — still has a
  meaningful threshold: any f32 error above the floor is a
  bit-identity break);
* **schema drift** — records failing ``store.schema_problems`` or a
  store failing chain validation;
* **kcert regression** — a ``kind="kcert"`` rule-count record (the
  kernel certifier's passing KC-rule tally, graft-kcert) falling
  below the baseline median: certified rules may only be added,
  never silently lost;
* **lens miscalibration** — a ``kind="lens"`` ratio record (the
  compute cost model's measured/predicted ratio, graft-lens) outside
  the absolute calibration band ``[0.5, 2.0]``, or drifted more than
  ``LENS_DRIFT_FACTOR×`` from the baseline median ratio: a model that
  stops predicting within 2× of reality (or quietly walks away from
  its committed calibration) must not keep pruning tune candidates.
  Ratios are load-invariant (both sides of the division ran under the
  same load), so the comparison is on the raw value, never
  host-load-normalized.  Lens ``ms`` records band like any other
  timing metric.

Keys absent from the baseline are reported as NEW, never as failures —
a new structure/metric must not block the ledger that is trying to
record it for the first time.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from arrow_matrix_tpu_torch.ledger import store
from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

BASELINE_VERSION = 1
BASELINE_BASENAME = "baseline.json"

#: Band width in robust standard deviations (1.4826·MAD ≈ σ for
#: normal noise): generous — the gate hunts regressions, not noise.
BAND_K = 4.0

#: Relative floor on the band: a value more than 5% above the median
#: fails even when the MAD band is tighter than that.  Pinned by the
#: planted-10%-regression test.
REL_FLOOR = 0.05

#: A fresh error-curve point may be at most this factor above the
#: baseline point before it is an accuracy regression.
CURVE_FACTOR = 2.0

#: Absolute floor for curve comparison: baseline points below this
#: (including the all-zero f32 curve) use the floor as the reference,
#: so "anything above 2e-6" trips on a zero baseline.
CURVE_FLOOR = 1e-6

#: Units where larger means worse.  Everything else (errors included —
#: error curves have their own pointwise check) is compared the same
#: way on ``value``; unit-less counts are skipped for banding.
#: "B" (bytes) bands the graft-xray wire metrics: replacing the
#: base64 wire must show up as a gated byte DROP, and a frame-size
#: regression fails like a latency regression does.
_LOWER_IS_BETTER_UNITS = {"ms", "s", "B"}

#: Absolute calibration band for lens measured/predicted ratio records:
#: ``obs/lens.py``'s LENS_RATIO_MIN/MAX (pinned equal by
#: tests/test_torch_lens.py).
LENS_RATIO_MIN = 0.5
LENS_RATIO_MAX = 2.0

#: A fresh lens ratio may drift at most this factor from the baseline
#: median ratio (in either direction) before the model is declared
#: miscalibrated relative to its committed calibration.
LENS_DRIFT_FACTOR = 1.5

#: graft-host satellite: a non-exact traffic class (graft-xray
#: ``iter_ms_<cls>`` records) must keep its latency within this
#: factor of the exact class measured on the same structure/platform.
#: Reduced-precision carriage that is byte-cheaper but TIME-slower is
#: a regression the per-key band cannot see (each class drifts inside
#: its own band); this cross-class check fails it loudly.
XRAY_CLASS_FACTOR = 1.5


def baseline_key(rec: Dict[str, Any]) -> str:
    return "|".join(str(rec.get(f)) for f in
                    ("kind", "metric", "structure_hash", "platform"))


def is_degraded(rec: Dict[str, Any]) -> bool:
    """True when the record's measurement self-reports a degraded
    environment (bench.py CPU fallback after an accelerator probe
    failure: ``parsed.degraded``).  Degraded numbers are kept in the
    ledger — they are the honest history — but excluded from banding
    in BOTH directions: they must not trip the gate, and they must not
    widen the band a clean number is compared against."""
    parsed = (rec.get("payload") or {}).get("parsed")
    return bool(isinstance(parsed, dict) and parsed.get("degraded"))


def normalized_value(rec: Dict[str, Any]) -> Optional[float]:
    """Host-load-normalized value: ``value / (1 + loadavg_1m)``.
    Records without a load snapshot (or with the -1 "unknown" marker)
    normalize by 1."""
    v = rec.get("value")
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return None
    load = rec.get("host_load")
    if isinstance(load, (int, float)) and not isinstance(load, bool) \
            and load >= 0:
        return float(v) / (1.0 + float(load))
    return float(v)


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])


def _mad(vals: Sequence[float], med: float) -> float:
    return _median([abs(v - med) for v in vals])


def build_baseline(records: List[Dict[str, Any]],
                   band_k: float = BAND_K,
                   rel_floor: float = REL_FLOOR) -> Dict[str, Any]:
    """Summarize a record list into a baseline document.  Banded
    metrics keep median/MAD/count over normalized values; error-curve
    keys pin the NEWEST curve (the committed reference) instead of
    averaging — curves are deterministic at fixed seed, so the newest
    one IS the contract."""
    banded: Dict[str, List[float]] = {}
    curves: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if store.schema_problems(rec):
            continue
        key = baseline_key(rec)
        if rec["kind"] == "error_curve":
            payload = rec.get("payload", {})
            curve = payload.get("rel_frobenius")
            if isinstance(curve, list):
                curves[key] = {
                    "rel_frobenius": [float(p) for p in curve],
                    "record_id": rec.get("record_id"),
                    "knobs": dict(rec.get("knobs", {})),
                }
            continue
        if is_degraded(rec):
            continue
        nv = normalized_value(rec)
        if nv is None:
            continue
        banded.setdefault(key, []).append(nv)
    metrics: Dict[str, Any] = {}
    for key, vals in banded.items():
        med = _median(vals)
        mad = _mad(vals, med)
        unit = None
        for rec in records:
            if baseline_key(rec) == key and rec.get("unit"):
                unit = rec["unit"]
        metrics[key] = {"median": med, "mad": mad, "count": len(vals),
                        "unit": unit}
    return {"version": BASELINE_VERSION, "band_k": band_k,
            "rel_floor": rel_floor, "metrics": metrics,
            "curves": curves}


def band_upper(entry: Dict[str, Any], band_k: float,
               rel_floor: float) -> float:
    med = float(entry["median"])
    mad = float(entry["mad"])
    return med + max(band_k * 1.4826 * mad, rel_floor * abs(med))


def check_records(records: List[Dict[str, Any]],
                  baseline: Dict[str, Any], *,
                  band_k: Optional[float] = None,
                  rel_floor: Optional[float] = None,
                  curve_factor: float = CURVE_FACTOR,
                  curve_floor: float = CURVE_FLOOR
                  ) -> Tuple[List[str], List[str]]:
    """``(failures, notes)``: failures are regressions/schema drift
    (nonzero exit), notes are informational (new keys, skipped
    records)."""
    band_k = baseline.get("band_k", BAND_K) if band_k is None \
        else band_k
    rel_floor = baseline.get("rel_floor", REL_FLOOR) \
        if rel_floor is None else rel_floor
    metrics = baseline.get("metrics", {})
    curves = baseline.get("curves", {})
    failures: List[str] = []
    notes: List[str] = []
    for i, rec in enumerate(records):
        problems = store.schema_problems(rec, index=i)
        if problems:
            failures += [f"schema drift: {p}" for p in problems]
            continue
        key = baseline_key(rec)
        if rec["kind"] == "error_curve":
            base = curves.get(key)
            if base is None:
                notes.append(f"new curve key (no baseline): {key}")
                continue
            fresh = rec.get("payload", {}).get("rel_frobenius")
            if not isinstance(fresh, list):
                failures.append(f"schema drift: {key} error_curve "
                                f"record has no rel_frobenius curve")
                continue
            ref = base["rel_frobenius"]
            for j, (f, b) in enumerate(zip(fresh, ref)):
                limit = curve_factor * max(float(b), curve_floor)
                if float(f) > limit:
                    failures.append(
                        f"accuracy regression: {key} iteration {j}: "
                        f"{f:.3e} > {limit:.3e} "
                        f"(baseline {b:.3e} × {curve_factor})")
            if len(fresh) < len(ref):
                failures.append(
                    f"accuracy regression: {key} curve shortened "
                    f"({len(fresh)} < baseline {len(ref)} points)")
            continue
        if rec["kind"] == "kcert":
            # Kernel-certifier verdict counts (graft-kcert): the
            # number of passing KC rules must never shrink — fewer
            # rules passing than the baseline median means a kernel
            # or the certifier itself regressed.  Counts have no
            # host-load band; the comparison is direct.
            entry = metrics.get(key)
            if entry is None:
                notes.append(f"new metric key (no baseline): {key}")
                continue
            value = rec.get("value")
            if value is None:
                notes.append(f"no numeric value: {key}")
                continue
            if float(value) < float(entry["median"]):
                failures.append(
                    f"kcert regression: {key}: {float(value):.0f} "
                    f"passing rules < baseline median "
                    f"{entry['median']:.0f}")
            continue
        if rec["kind"] == "lens" and rec.get("unit") == "ratio":
            # Compute-model calibration (graft-lens): the
            # measured/predicted ratio must sit inside the absolute
            # band regardless of any baseline, and — once a baseline
            # exists — must not drift far from its committed median.
            # Raw value on purpose: a ratio is load-invariant.
            value = rec.get("value")
            if value is None:
                notes.append(f"no numeric value: {key}")
                continue
            v = float(value)
            if not (LENS_RATIO_MIN <= v <= LENS_RATIO_MAX):
                failures.append(
                    f"lens miscalibration: {key}: measured/predicted "
                    f"ratio {v:.3f} outside "
                    f"[{LENS_RATIO_MIN}, {LENS_RATIO_MAX}]")
                continue
            entry = metrics.get(key)
            if entry is None:
                notes.append(f"new metric key (no baseline): {key}")
                continue
            med = float(entry["median"])
            if med > 0 and not (med / LENS_DRIFT_FACTOR <= v
                                <= med * LENS_DRIFT_FACTOR):
                failures.append(
                    f"lens miscalibration: {key}: ratio {v:.3f} "
                    f"drifted > {LENS_DRIFT_FACTOR}x from baseline "
                    f"median {med:.3f}")
            continue
        if is_degraded(rec):
            notes.append(f"degraded measurement (unbanded): {key}")
            continue
        entry = metrics.get(key)
        if entry is None:
            notes.append(f"new metric key (no baseline): {key}")
            continue
        unit = rec.get("unit") or entry.get("unit")
        if unit not in _LOWER_IS_BETTER_UNITS:
            notes.append(f"unbanded unit {unit!r}: {key}")
            continue
        nv = normalized_value(rec)
        if nv is None:
            notes.append(f"no numeric value: {key}")
            continue
        upper = band_upper(entry, band_k, rel_floor)
        if nv > upper:
            failures.append(
                f"perf regression: {key}: normalized {nv:.4g} {unit} "
                f"> band {upper:.4g} (median {entry['median']:.4g}, "
                f"MAD {entry['mad']:.4g}, n={entry['count']})")
    f3, n3 = xray_class_problems(records, baseline)
    failures += f3
    notes += n3
    return failures, notes


def xray_class_problems(records: List[Dict[str, Any]],
                        baseline: Dict[str, Any],
                        factor: float = XRAY_CLASS_FACTOR
                        ) -> Tuple[List[str], List[str]]:
    """Cross-class latency check over graft-xray ``iter_ms_<cls>``
    records (see :data:`XRAY_CLASS_FACTOR`).  Classes are compared on
    the same ``(structure_hash, platform)`` cell; the exact reference
    is the fresh exact measurement when this batch carries one, else
    the committed baseline median for the exact key.  Same-batch
    comparison on purpose: both numbers then share the host load, so
    no load band is needed."""
    failures: List[str] = []
    notes: List[str] = []
    fresh: Dict[Tuple[str, str], Dict[str, float]] = {}
    for rec in records:
        metric = str(rec.get("metric") or "")
        if rec.get("kind") != "xray" \
                or not metric.startswith("iter_ms_") \
                or is_degraded(rec):
            continue
        value = rec.get("value")
        if value is None:
            continue
        cell = (str(rec.get("structure_hash")),
                str(rec.get("platform")))
        # Last write wins inside one batch — matches read_all order.
        fresh.setdefault(cell, {})[metric[len("iter_ms_"):]] = \
            float(value)
    metrics = baseline.get("metrics", {})
    for (shash, platform), by_cls in sorted(fresh.items()):
        exact = by_cls.get("exact")
        if exact is None:
            key = "|".join(("xray", "iter_ms_exact", shash, platform))
            entry = metrics.get(key)
            if entry is not None:
                exact = float(entry["median"])
        for cls in sorted(by_cls):
            if cls == "exact":
                continue
            if exact is None or exact <= 0:
                notes.append(
                    f"xray class {cls!r} has no exact reference "
                    f"(structure {shash}, {platform}) — class band "
                    f"skipped")
                continue
            v = by_cls[cls]
            if v > factor * exact:
                failures.append(
                    f"class regression: iter_ms_{cls} = {v:.4g} ms > "
                    f"{factor} x exact {exact:.4g} ms (structure "
                    f"{shash}, {platform}) — byte-cheaper but "
                    f"time-slower")
    return failures, notes


def baseline_path(directory: Optional[str] = None) -> str:
    return os.path.join(store.ledger_dir(directory), BASELINE_BASENAME)


def load_baseline(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline version {doc.get('version')} != "
                         f"runtime {BASELINE_VERSION}")
    return doc


def save_baseline(path: str, baseline: Dict[str, Any]) -> str:
    return atomic_write_json(path, baseline, indent=2, sort_keys=True)


def run_gate(ledger_dir: Optional[str] = None,
             baseline_file: Optional[str] = None,
             records: Optional[List[Dict[str, Any]]] = None
             ) -> Tuple[int, List[str]]:
    """The whole gate as a library call: validate the store (chain +
    schema), load the baseline, band every record.  Returns
    ``(exit_code, report_lines)``."""
    lg = store.Ledger(ledger_dir)
    lines: List[str] = []
    failures: List[str] = []
    chain = lg.validate()
    failures += [f"schema drift: {p}" for p in chain]
    recs = lg.read_all() if records is None else records
    bpath = baseline_file or baseline_path(ledger_dir)
    if not os.path.exists(bpath):
        lines.append(f"ledger_gate: no baseline at {bpath} — "
                     f"run `graft_ledger rebaseline` to create one")
        lines += [f"  FAIL {f}" for f in failures]
        return (1 if failures else 0), lines
    baseline = load_baseline(bpath)
    f2, notes = check_records(recs, baseline)
    failures += f2
    lines.append(f"ledger_gate: {len(recs)} records vs "
                 f"{len(baseline.get('metrics', {}))} banded keys + "
                 f"{len(baseline.get('curves', {}))} curves "
                 f"({bpath})")
    lines += [f"  FAIL {f}" for f in failures]
    lines += [f"  note {n}" for n in notes]
    lines.append("ledger_gate: FAIL" if failures else "ledger_gate: ok")
    return (1 if failures else 0), lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ledger_gate",
        description="drift gate over the graft-ledger record store")
    ap.add_argument("--ledger-dir", default=None,
                    help="store directory (default: AMT_LEDGER_DIR or "
                         "bench_results/ledger_torch)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <ledger-dir>/"
                         f"{BASELINE_BASENAME})")
    ap.add_argument("--check", action="store_true",
                    help="gate the full store against the baseline "
                         "(the default action)")
    ap.add_argument("--rebaseline", action="store_true",
                    help="rebuild the baseline from the store and "
                         "write it")
    args = ap.parse_args(argv)
    if args.rebaseline:
        lg = store.Ledger(args.ledger_dir)
        problems = lg.validate()
        if problems:
            for p in problems:
                print(f"  FAIL schema drift: {p}")
            return 1
        bpath = args.baseline or baseline_path(args.ledger_dir)
        save_baseline(bpath, build_baseline(lg.read_all()))
        print(f"ledger_gate: baseline written to {bpath}")
        return 0
    rc, lines = run_gate(args.ledger_dir, args.baseline)
    for line in lines:
        print(line)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

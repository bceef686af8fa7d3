"""Legacy-schema bridge: ``BENCH_r*.json`` rounds and the ledger.

The port's copy of ``arrow_matrix_tpu/ledger/export.py``.  A legacy
round is ``{n, cmd, rc, tail, parsed}`` whose ``tail``'s last line is
the JSON measurement record.

* **ingest** (``ingest_legacy_bench`` / ``ingest_tune_plans``) loads
  round files or a plan-cache directory into a store; rounds whose
  ``parsed`` is null are skipped with a note.
* **export** (``compose_round`` / ``export_legacy_round``) builds a
  round from a store: the newest bench record's ``parsed`` verbatim,
  plus ``tuned``, ``serving``, ``error_curves`` and ``ledger`` (the
  store's head and count).  It reads only records and adds no
  timestamps, so exporting twice from one store gives the same bytes,
  and the same bytes as the JAX package's export of that store.  It
  writes only to the path the caller names.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from arrow_matrix_tpu_torch.ledger import store
from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

#: parsed-section fields every legacy round since r02 has carried;
#: export refuses to emit a round missing any of them.
LEGACY_PARSED_REQUIRED = ("metric", "value", "unit", "vs_baseline",
                          "config", "platform", "device_kind")

LEGACY_TOP_REQUIRED = ("n", "cmd", "rc", "tail", "parsed")


def validate_legacy(doc: Any) -> List[str]:
    """Problems with one legacy round document (empty = valid)."""
    if not isinstance(doc, dict):
        return ["round document is not a JSON object"]
    problems = [f"missing top-level field {f!r}"
                for f in LEGACY_TOP_REQUIRED if f not in doc]
    parsed = doc.get("parsed")
    if parsed is not None:
        if not isinstance(parsed, dict):
            problems.append("parsed is neither null nor an object")
        else:
            problems += [f"parsed missing field {f!r}"
                         for f in LEGACY_PARSED_REQUIRED
                         if f not in parsed]
    return problems


def ingest_legacy_bench(ledger: store.Ledger,
                        paths: List[str]) -> Tuple[int, List[str]]:
    """Append one ``kind="bench"`` record per legacy round file whose
    ``parsed`` is non-null.  Returns ``(ingested, notes)``.  The whole
    parsed record rides in the payload — ingest preserves, never
    summarizes."""
    notes: List[str] = []
    count = 0
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        problems = validate_legacy(doc)
        if problems:
            notes.append(f"skip {path}: {'; '.join(problems)}")
            continue
        parsed = doc.get("parsed")
        if parsed is None:
            notes.append(f"skip {path}: parsed is null (pre-contract "
                         f"round)")
            continue
        ledger.record(
            "bench",
            store.bench_metric(parsed["metric"],
                               parsed.get("config")),
            parsed["value"],
            unit=parsed["unit"],
            structure_hash=None,  # legacy rounds predate fingerprints
            platform=parsed["platform"],
            device_kind=parsed["device_kind"],
            host_load=None,       # legacy rounds captured no loadavg
            knobs={"legacy_round": doc["n"],
                   "config": parsed.get("config", {})},
            payload={"parsed": parsed, "cmd": doc["cmd"],
                     "rc": doc["rc"], "source_file":
                         os.path.basename(path)})
        count += 1
    return count, notes


def ingest_tune_plans(ledger: store.Ledger,
                      plan_dir: str) -> Tuple[int, List[str]]:
    """Append one ``kind="tune"`` record per (structure, k) winner in
    the committed plan cache — the tuned-vs-default margins the r06
    export and the baseline both band on."""
    notes: List[str] = []
    count = 0
    try:
        names = sorted(os.listdir(plan_dir))
    except OSError as e:
        return 0, [f"skip {plan_dir}: {e}"]
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(plan_dir, name)
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        plans = doc.get("plans")
        shash = doc.get("structure_hash")
        if not isinstance(plans, dict) or not shash:
            notes.append(f"skip {path}: no plans/structure_hash")
            continue
        for k_str, plan in sorted(plans.items(),
                                  key=lambda kv: int(kv[0])):
            load = plan.get("host_load") or {}
            # k rides in the metric name: a k=16 and a k=128 timing of
            # the same structure must never share a drift band.
            ledger.record(
                "tune", f"tuned_spmm_ms_k{int(k_str)}",
                plan.get("measured_ms"),
                unit="ms", structure_hash=shash,
                platform=plan.get("platform"),
                device_kind="host" if plan.get("platform") == "cpu"
                else plan.get("platform"),
                host_load=load.get("loadavg_1m"),
                knobs={"k": int(k_str),
                       "candidate": plan.get("candidate"),
                       "kernel": plan.get("kernel"),
                       "fmt": plan.get("fmt"),
                       "chunk": plan.get("chunk"),
                       "overlap_slabs": plan.get("overlap_slabs"),
                       "feature_dtype": plan.get("feature_dtype")},
                payload={"default_ms": plan.get("default_ms"),
                         "margin": plan.get("margin"),
                         "bit_identical": plan.get("bit_identical"),
                         "evaluator": plan.get("evaluator"),
                         "source": doc.get("context", {}).get(
                             "source")})
            count += 1
    return count, notes


def _newest(records: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    return records[-1] if records else None


def compose_round(ledger: store.Ledger, round_n: int,
                  head: Optional[str] = None) -> Dict[str, Any]:
    """Build the legacy round document from the store (pure read — no
    timestamps, no environment).  Raises ``ValueError`` when the store
    has no bench record to anchor the parsed section on.

    ``head`` pins the export to the chain PREFIX ending at that record
    id — the provenance pointer every exported round records under
    ``parsed.ledger.head``.  Re-exporting a historical round through
    its own recorded head is byte-identical even after the store has
    grown past it (the chain is append-only, so the prefix below a
    record id never changes); without ``head`` the round snapshots the
    whole store."""
    records = ledger.read_all()
    if head is not None:
        ids = [r.get("record_id") for r in records]
        if head not in ids:
            raise ValueError(f"head record {head!r} is not in the "
                             f"store chain at {ledger.path}")
        records = records[:ids.index(head) + 1]

    def view(kind: str) -> List[Dict[str, Any]]:
        return [r for r in records if r.get("kind") == kind]

    # Anchor on the newest bench record that carries a parsed payload:
    # bench-kind records are also used for raw measurements (e.g. the
    # reshard peak-HBM probes), and those cannot seed a legacy round's
    # parsed section.
    bench = _newest([r for r in view("bench")
                     if r.get("payload", {}).get("parsed")])
    if bench is None:
        raise ValueError("export needs at least one bench record with "
                         "a parsed payload in the ledger (run "
                         "`graft_ledger ingest` or a bench round "
                         "first)")
    parsed = dict(bench.get("payload", {}).get("parsed") or {})

    tuned: List[Dict[str, Any]] = []
    for rec in view("tune"):
        payload = rec.get("payload", {})
        tuned.append({
            "structure_hash": rec.get("structure_hash"),
            "k": rec.get("knobs", {}).get("k"),
            "candidate": rec.get("knobs", {}).get("candidate"),
            "tuned_ms": rec.get("value"),
            "default_ms": payload.get("default_ms"),
            "margin": payload.get("margin"),
            "bit_identical": payload.get("bit_identical"),
        })

    serving = None
    serve = _newest(view("serve"))
    if serve is not None:
        sp = serve.get("payload", {})
        serving = {
            "requests": sp.get("requests"),
            "completed": sp.get("completed"),
            "failed": sp.get("failed"),
            "shed": sp.get("shed"),
            "rejected": sp.get("rejected"),
            "requests_per_s": serve.get("value"),
            "latency_ms": sp.get("latency_ms"),
            "structure_hash": serve.get("structure_hash"),
            "record_id": serve.get("record_id"),
        }

    error_curves: List[Dict[str, Any]] = []
    for rec in view("error_curve"):
        error_curves.append({
            "metric": rec.get("metric"),
            "dtype": rec.get("knobs", {}).get("dtype"),
            "emulated": rec.get("knobs", {}).get("emulated"),
            "structure_hash": rec.get("structure_hash"),
            "iterations": rec.get("knobs", {}).get("iterations"),
            "final_rel_frobenius": rec.get("value"),
            "rel_frobenius": rec.get("payload", {}).get(
                "rel_frobenius"),
            "record_id": rec.get("record_id"),
        })

    parsed["tuned"] = tuned
    parsed["serving"] = serving
    parsed["error_curves"] = error_curves
    parsed["ledger"] = {
        "records": len(records),
        "head": records[-1].get("record_id") if records else None,
        "store": ledger.path,
        "bench_record_id": bench.get("record_id"),
    }
    # tail contract: the measurement record is the LAST line (the
    # parse_last_json_line convention every legacy round honors).
    tail = json.dumps(parsed, sort_keys=True) + "\n"
    return {"n": round_n,
            "cmd": f"graft_ledger export --round {round_n}",
            "rc": 0, "tail": tail, "parsed": parsed}


def export_legacy_round(ledger: store.Ledger, round_n: int,
                        out_path: str,
                        head: Optional[str] = None) -> Dict[str, Any]:
    """Compose + validate + atomically write one legacy round file.
    When ``head`` is omitted and ``out_path`` already exists, the
    export pins itself to the existing file's recorded
    ``parsed.ledger.head`` — regenerating a round is byte-identical by
    construction, never silently rebased onto a grown store."""
    if head is None and os.path.exists(out_path):
        with open(out_path, encoding="utf-8") as fh:
            prior = json.load(fh)
        head = ((prior.get("parsed") or {}).get("ledger")
                or {}).get("head")
    doc = compose_round(ledger, round_n, head=head)
    problems = validate_legacy(doc)
    if problems:
        raise ValueError(f"composed round fails the legacy schema: "
                         f"{problems}")
    atomic_write_json(out_path, doc, indent=1, sort_keys=True)
    return doc

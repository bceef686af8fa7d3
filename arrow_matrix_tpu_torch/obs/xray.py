"""Fleet-wide distributed tracing and critical-path analysis.

The port's copy of ``arrow_matrix_tpu/obs/xray.py`` (host code, the
same documents):

* **Trace context.**  A router mints a ``trace_id`` per request
  (:func:`new_trace_id`) and stamps it into every ``submit`` frame; a
  worker enters it via :func:`obs.flight.request_context`, so every
  span and flight event carries the fleet-level correlation keys.
* **Per-process trace docs, one merged trace.**  Each process exports
  its spans with a wall-clock anchor (``Tracer.epoch_unix``);
  :func:`merge_process_traces` lays them onto ONE Perfetto timeline,
  one ``pid`` track per process, after subtracting each worker's
  measured clock offset.  A worker killed by SIGKILL never exported a
  doc; its partial trace is recovered from the flight ring it flushed
  per event (:func:`recover_from_flight`), every recovered span marked
  ``truncated``.
* **Critical-path decomposition.**  :func:`critical_path` splits each
  request of a merged trace into queue / admission / serialize / wire
  / worker-queue / compute / checkpoint / response segments and
  aggregates them per traffic class.
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, List, Optional

from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

SCHEMA_VERSION = 1

#: Critical-path segments, in pipeline order.
SEGMENTS = ("queue", "admission", "serialize", "wire", "worker_queue",
            "compute", "checkpoint", "response")

#: Correlation keys copied from a flight event into a recovered span.
_CTX_KEYS = ("request_id", "tenant", "trace_id", "parent_span")


def new_trace_id() -> str:
    """A fresh fleet-level trace id (16 hex chars — short enough to
    read in a Perfetto args pane, unique enough for any fleet run)."""
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------------------
# Per-process trace docs
# ---------------------------------------------------------------------------

def process_trace(tracer, process: str, *,
                  truncated: bool = False) -> Dict[str, Any]:
    """Export one process's spans as a mergeable trace doc.  Span
    timestamps stay on the tracer's monotonic epoch; ``epoch_unix``
    anchors them to the wall clock for cross-process alignment."""
    return {
        "schema": SCHEMA_VERSION,
        "process": process,
        "pid": os.getpid(),
        "epoch_unix": float(getattr(tracer, "epoch_unix", 0.0)),
        "truncated": bool(truncated),
        "spans": [{"name": s.name, "ts_us": s.ts_us, "dur_us": s.dur_us,
                   "tid": s.tid, "args": dict(s.args)}
                  for s in tracer.spans],
    }


def save_process_trace(tracer, path: str, process: str) -> str:
    """Atomically write one process's trace doc (the worker's
    ``close()`` artifact; atomic so a reader never sees a torn doc)."""
    atomic_write_json(path, process_trace(tracer, process))
    return path


def save_router_trace(tracer, run_dir: str) -> str:
    """The router's trace doc under its run dir (``router_xray.json``),
    where :func:`merge_run_dir` looks for it."""
    os.makedirs(run_dir, exist_ok=True)
    return save_process_trace(
        tracer, os.path.join(run_dir, "router_xray.json"), "router")


def recover_from_flight(path: str, process: str
                        ) -> Optional[Dict[str, Any]]:
    """Rebuild a killed worker's partial trace from its flight ring.

    The ring flushes eagerly per event, so every span that COMPLETED
    before the SIGKILL is on disk (kind ``"span"``, with its duration
    and request context).  Spans are reconstructed at absolute unix
    microseconds (``epoch_unix`` 0) and each carries
    ``args["truncated"] = True`` — the explicit marker that this track
    is a recovered fragment, not a sealed trace.  Returns None when the
    artifact is missing/unreadable or holds no spans.
    """
    try:
        with open(path, encoding="utf-8") as fh:
            snap = json.load(fh)
    except (OSError, ValueError):
        return None
    spans: List[Dict[str, Any]] = []
    for ev in snap.get("events", []):
        if ev.get("kind") != "span":
            continue
        dur_ms = float((ev.get("data") or {}).get("ms") or 0.0)
        end_s = float(ev.get("ts") or 0.0)   # flight stamps span END
        args: Dict[str, Any] = {k: ev[k] for k in _CTX_KEYS if k in ev}
        args["truncated"] = True
        args["recovered_from"] = "flight_ring"
        spans.append({"name": ev.get("name", "?"),
                      "ts_us": (end_s - dur_ms / 1e3) * 1e6,
                      "dur_us": dur_ms * 1e3,
                      "tid": 0, "args": args})
    if not spans:
        return None
    return {"schema": SCHEMA_VERSION, "process": process,
            "pid": snap.get("meta", {}).get("pid"),
            "epoch_unix": 0.0, "truncated": True, "spans": spans}


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------

def merge_process_traces(docs: List[Dict[str, Any]],
                         offsets_ns: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
    """Merge per-process trace docs into ONE Perfetto trace: one
    ``pid`` track per process, timestamps mapped onto the router's
    clock by subtracting each process's measured offset, the whole
    timeline rebased so it starts at 0.

    ``offsets_ns`` maps process name to either an offset in ns or a
    dict with ``offset_ns`` (the router's ping-handshake record).
    """
    offsets_ns = offsets_ns or {}

    def _offset_us(process: str) -> float:
        rec = offsets_ns.get(process)
        if isinstance(rec, dict):
            rec = rec.get("offset_ns", 0)
        return float(rec or 0) / 1e3

    ordered = sorted(
        (d for d in docs if d),
        key=lambda d: (d.get("process") != "router", d.get("process", "")))
    events: List[Dict[str, Any]] = []
    processes: List[Dict[str, Any]] = []
    truncated: List[str] = []
    for pid, doc in enumerate(ordered):
        process = str(doc.get("process", f"proc-{pid}"))
        off_us = _offset_us(process)
        base_us = float(doc.get("epoch_unix", 0.0)) * 1e6 - off_us
        if doc.get("truncated"):
            truncated.append(process)
        processes.append({"process": process, "pid": pid,
                          "os_pid": doc.get("pid"),
                          "truncated": bool(doc.get("truncated")),
                          "spans": len(doc.get("spans", []))})
        for s in doc.get("spans", []):
            args = dict(s.get("args", {}))
            args["process"] = process
            events.append({"name": s.get("name", "?"), "ph": "X",
                           "ts": base_us + float(s.get("ts_us", 0.0)),
                           "dur": float(s.get("dur_us", 0.0)),
                           "pid": pid, "tid": int(s.get("tid", 0)),
                           "args": args})
    t0 = min((e["ts"] for e in events), default=0.0)
    for e in events:
        e["ts"] -= t0
    events.sort(key=lambda e: e["ts"])
    meta = []
    for p in processes:
        label = p["process"] + (" (truncated)" if p["truncated"] else "")
        meta.append({"name": "process_name", "ph": "M", "pid": p["pid"],
                     "tid": 0, "args": {"name": label}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "xray": {"schema": SCHEMA_VERSION, "processes": processes,
                     "truncated": truncated, "t0_unix_us": t0,
                     "offsets_ns": dict(offsets_ns)}}


def merge_run_dir(run_dir: str,
                  report: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Merge a fleet run dir's artifacts into one fleet trace.

    Sources, in order of preference per process: the router's
    ``router_xray.json``; each worker subdir's ``xray_trace.json``
    (written by a graceful ``close()``); else that subdir's
    ``flight.json`` ring, recovered with ``truncated`` markers — a
    SIGKILLed worker still shows up.  Clock offsets come from
    ``report["clock_offsets_ns"]`` when given, else from the run dir's
    ``fleet_report.json``.
    """
    docs: List[Dict[str, Any]] = []
    router_path = os.path.join(run_dir, "router_xray.json")
    if os.path.exists(router_path):
        try:
            with open(router_path, encoding="utf-8") as fh:
                docs.append(json.load(fh))
        except (OSError, ValueError):
            pass
    if report is None:
        try:
            with open(os.path.join(run_dir, "fleet_report.json"),
                      encoding="utf-8") as fh:
                report = json.load(fh)
        except (OSError, ValueError):
            report = None
    offsets = (report or {}).get("clock_offsets_ns") or {}
    try:
        subdirs = sorted(os.listdir(run_dir))
    except OSError:
        subdirs = []
    for name in subdirs:
        d = os.path.join(run_dir, name)
        if not os.path.isdir(d):
            continue
        trace_path = os.path.join(d, "xray_trace.json")
        if os.path.exists(trace_path):
            try:
                with open(trace_path, encoding="utf-8") as fh:
                    docs.append(json.load(fh))
                continue
            except (OSError, ValueError):
                pass
        doc = recover_from_flight(os.path.join(d, "flight.json"), name)
        if doc is not None:
            docs.append(doc)
    return merge_process_traces(docs, offsets_ns=offsets)


def save_fleet_trace(trace_doc: Dict[str, Any], run_dir: str) -> str:
    path = os.path.join(run_dir, "fleet_xray.json")
    atomic_write_json(path, trace_doc)
    return path


# ---------------------------------------------------------------------------
# Critical path
# ---------------------------------------------------------------------------

def _members(span: Dict[str, Any]) -> List[str]:
    rid = str(span.get("args", {}).get("request_id", ""))
    return [m for m in rid.split("+") if m]


def _spans_by_request(events: List[Dict[str, Any]]
                      ) -> Dict[str, List[Dict[str, Any]]]:
    out: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        for rid in _members(e):
            out.setdefault(rid, []).append(e)
    return out


def _named(spans: List[Dict[str, Any]], name: str
           ) -> List[Dict[str, Any]]:
    return sorted((s for s in spans if s["name"] == name),
                  key=lambda s: s["ts"])


def critical_path(trace_doc: Dict[str, Any],
                  classes: Optional[Dict[str, str]] = None
                  ) -> Dict[str, Any]:
    """Decompose each request in a merged fleet trace into the
    :data:`SEGMENTS` and aggregate per traffic class.

    Segment derivation (all ms; batch-shared spans are split evenly
    over the batch's members, exact for the fleet's k-pure batches of
    one):

    * ``queue``        — router dispatch start → first RPC start;
    * ``admission``    — the scheduler's admission span;
    * ``serialize``    — measured encode/decode ms summed over the
      request's RPC frames (from wire accounting);
    * ``wire``         — measured socket ms for the same frames;
    * ``worker_queue`` — admission end → batch start on the worker;
    * ``checkpoint``   — Supervisor checkpoint + resume spans;
    * ``compute``      — batch span minus its checkpoint share;
    * ``response``     — finalize span + dispatch tail after the last
      RPC returned.

    A request's class comes from ``classes`` (request_id → class, e.g.
    the fleet report's ``served_class``), falling back to the batch
    span's ``traffic_class`` arg, else ``"exact"``.
    """
    classes = classes or {}
    events = [e for e in trace_doc.get("traceEvents", [])
              if e.get("ph") == "X"]
    by_req = _spans_by_request(events)
    requests: Dict[str, Any] = {}
    for rid, spans in sorted(by_req.items()):
        seg = {name: 0.0 for name in SEGMENTS}
        dispatches = _named(spans, "dispatch")
        rpcs = _named(spans, "rpc")
        admissions = _named(spans, "admission")
        batches = _named(spans, "batch")
        if dispatches and rpcs:
            seg["queue"] = max(0.0, (rpcs[0]["ts"]
                                     - dispatches[0]["ts"]) / 1e3)
        seg["admission"] = sum(s["dur"] for s in admissions) / 1e3
        for s in rpcs:
            seg["serialize"] += float(s["args"].get("serialize_ms") or 0.0)
            seg["wire"] += float(s["args"].get("wire_ms") or 0.0)
        if admissions and batches:
            adm_end = admissions[0]["ts"] + admissions[0]["dur"]
            seg["worker_queue"] = max(0.0,
                                      (batches[0]["ts"] - adm_end) / 1e3)
        ckpt_us = 0.0
        for name in ("checkpoint", "resume"):
            for s in _named(spans, name):
                ckpt_us += s["dur"] / max(len(_members(s)), 1)
        seg["checkpoint"] = ckpt_us / 1e3
        batch_us = sum(s["dur"] / max(len(_members(s)), 1)
                       for s in batches)
        seg["compute"] = max(0.0, batch_us - ckpt_us) / 1e3
        fin_us = sum(s["dur"] / max(len(_members(s)), 1)
                     for s in _named(spans, "finalize"))
        tail_us = 0.0
        if dispatches and rpcs:
            disp_end = dispatches[-1]["ts"] + dispatches[-1]["dur"]
            rpc_end = max(s["ts"] + s["dur"] for s in rpcs)
            tail_us = max(0.0, disp_end - rpc_end)
        seg["response"] = (fin_us + tail_us) / 1e3
        cls = classes.get(rid)
        if cls is None:
            for s in batches:
                cls = s["args"].get("traffic_class")
                if cls:
                    break
        total_ms = (sum(s["dur"] for s in dispatches) / 1e3
                    if dispatches else sum(seg.values()))
        requests[rid] = {"class": str(cls or "exact"),
                         "segments": seg,
                         "total_ms": total_ms,
                         "truncated": any(s["args"].get("truncated")
                                          for s in spans)}
    per_class: Dict[str, Any] = {}
    for rid, rec in requests.items():
        agg = per_class.setdefault(
            rec["class"],
            {"count": 0, "total_ms": 0.0,
             "segments": {name: 0.0 for name in SEGMENTS}})
        agg["count"] += 1
        agg["total_ms"] += rec["total_ms"]
        for name in SEGMENTS:
            agg["segments"][name] += rec["segments"][name]
    for agg in per_class.values():
        n = max(agg["count"], 1)
        agg["mean_ms"] = agg["total_ms"] / n
        agg["segments_mean_ms"] = {name: agg["segments"][name] / n
                                   for name in SEGMENTS}
    return {"schema": SCHEMA_VERSION, "segments": list(SEGMENTS),
            "requests": requests, "per_class": per_class}


def subdivide_compute(cp: Dict[str, Any],
                      fractions: Dict[str, Dict[str, float]]
                      ) -> Dict[str, Any]:
    """Split each class's mean ``compute`` segment by per-level
    attribution fractions.

    ``fractions`` maps traffic class → {level label → fraction of the
    compute segment} (the JAX package's ``obs.lens.attribution_fractions``
    output; the labels are ``"L<tier>:<family>"`` plus ``"other"``).  Returns a
    copy of the critical-path doc with ``compute_breakdown_ms`` added
    to each matched class aggregate — the xray ``compute`` span stops
    being opaque without re-deriving anything from the trace.
    """
    out = dict(cp, per_class={cls: dict(agg) for cls, agg in
                              cp.get("per_class", {}).items()})
    for cls, agg in out["per_class"].items():
        frac = fractions.get(cls)
        if not frac:
            continue
        compute = float(agg.get("segments_mean_ms", {})
                        .get("compute", 0.0))
        agg["compute_breakdown_ms"] = {
            label: round(compute * float(f), 6)
            for label, f in frac.items()}
    return out


def format_report(cp: Dict[str, Any]) -> List[str]:
    """Human-readable per-class segment table for the CLI (plus the
    per-level compute breakdown when :func:`subdivide_compute` ran)."""
    lines: List[str] = []
    names = list(cp.get("segments", SEGMENTS))
    header = (f"{'class':<8} {'n':>4} {'mean_ms':>9} "
              + " ".join(f"{n[:9]:>9}" for n in names))
    lines.append(header)
    lines.append("-" * len(header))
    for cls in sorted(cp.get("per_class", {})):
        agg = cp["per_class"][cls]
        segs = agg.get("segments_mean_ms", {})
        lines.append(
            f"{cls:<8} {agg['count']:>4} {agg.get('mean_ms', 0.0):>9.2f} "
            + " ".join(f"{segs.get(n, 0.0):>9.2f}" for n in names))
        breakdown = agg.get("compute_breakdown_ms")
        if breakdown:
            for label, ms in breakdown.items():
                lines.append(f"{'':<8}   compute/{label:<12} "
                             f"{float(ms):>9.3f}")
    return lines


def diff_reports(a: Dict[str, Any], b: Dict[str, Any],
                 rel_threshold: float = 0.10,
                 abs_floor_ms: float = 1.0) -> Dict[str, Any]:
    """Per-class, per-segment mean delta of report ``b`` vs baseline
    ``a``; a segment regresses when it grows by more than
    ``rel_threshold`` AND ``abs_floor_ms``."""
    regressions: List[str] = []
    deltas: Dict[str, Any] = {}
    for cls in sorted(set(a.get("per_class", {}))
                      | set(b.get("per_class", {}))):
        sa = a.get("per_class", {}).get(cls, {}).get(
            "segments_mean_ms", {})
        sb = b.get("per_class", {}).get(cls, {}).get(
            "segments_mean_ms", {})
        row = {}
        for name in set(sa) | set(sb):
            va, vb = float(sa.get(name, 0.0)), float(sb.get(name, 0.0))
            d = vb - va
            row[name] = {"base_ms": va, "new_ms": vb, "delta_ms": d}
            if d > abs_floor_ms and d > rel_threshold * max(va, 1e-9):
                regressions.append(
                    f"{cls}/{name}: {va:.2f} -> {vb:.2f} ms "
                    f"(+{d:.2f})")
        deltas[cls] = row
    return {"deltas": deltas, "regressions": regressions}

"""Live serving telemetry for the always-on server.

The port's copy of ``arrow_matrix_tpu/obs/pulse.py`` (host code, the
same documents and exposition text) for
:class:`~arrow_matrix_tpu_torch.serve.ArrowServer`:

  * **Request-scoped correlation** — re-exported from
    :mod:`~arrow_matrix_tpu_torch.obs.flight` (:func:`request_context` /
    :func:`current_request`): one contextvar key that the tracer stamps
    on spans, the flight recorder stamps on events, and the scheduler
    enters at admission and batch execution.
  * **Streaming aggregation** — :class:`PulseMonitor` folds the
    scheduler's event stream into sliding time windows (req/s,
    p50/p90/p99 latency via mergeable histograms, queue depth, HBM
    occupancy sampled from the live accountant, shed/reject/degrade
    counts, per-tenant and per-traffic-class breakdowns), flushes the
    closed-window series to a bounded on-disk ring (atomic rewrite,
    crash-readable like ``obs/flight.py``), and renders Prometheus-style
    exposition text, served by :class:`PulseEndpoint` (stdlib
    ``http.server``).
  * **SLO-burn watchdog** — :class:`SloWatchdog` evaluates windowed
    :class:`BurnRule`\\ s (p99 over target, HBM occupancy over the
    high-water mark, recovered-fault spikes) with hysteresis
    (``min_windows`` consecutive burning windows before a trip, one
    ``slo_burn_cleared`` on recovery), emits ``slo_burn`` flight events
    and, via ``ArrowServer.attach_pulse``, feeds the scheduler's
    per-tenant fault scores, so measured SLO pressure drives the
    degradation ladder.

**One schema.**  Window dicts, the monitor's totals, and the final SLO
report (``serve/loadgen.py:slo_summary``) share the same field names —
:data:`SLO_SERIES_FIELDS` / :data:`LATENCY_FIELDS` — and the pooled
window histograms equal the report's quantiles exactly.

**Determinism.**  Window assignment is pure arithmetic on an injected
``clock`` (window ``i`` spans ``[t0 + i*w, t0 + (i+1)*w)``), and the
watchdog is a pure function of the closed-window series, so a replay
with the same clock gives the same documents.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
from arrow_matrix_tpu_torch.obs.flight import (  # noqa: F401  (re-exports)
    current_request,
    request_context,
)
from arrow_matrix_tpu_torch.obs.metrics import Histogram
from arrow_matrix_tpu_torch.sync import guarded_by, witnessed

SCHEMA_VERSION = 1

#: The shared serving-telemetry vocabulary: every window dict carries
#: exactly these fields, and ``slo_summary`` uses the same names for
#: the run-total view (documented there).  :func:`validate_ring`
#: checks against this tuple — one schema for
#: the stream and the report.
SLO_SERIES_FIELDS = (
    "window", "start_s", "duration_s",
    "submitted", "admitted", "completed", "failed", "shed", "rejected",
    "degraded", "resumed", "requests_per_s", "latency_ms",
    "queue_depth", "hbm", "faults_seen", "recoveries", "slo_burns",
    "per_tenant", "per_class",
)

#: Latency sub-dict fields (identical to ``latency_summary_ms``).
LATENCY_FIELDS = ("count", "p50", "p90", "p99", "mean", "max")

#: Ticket terminal states + admission events counted per window.
_COUNTED_EVENTS = frozenset({
    "submitted", "admitted", "completed", "failed", "shed", "rejected",
    "degraded",
})

#: Gap windows materialized (empty) before snapping to the present:
#: enough healthy windows for every hysteresis clear, without writing
#: hundreds of empties after a long idle stretch.
_MAX_GAP_FILL = 8


def latency_dict(hist: Histogram, *,
                 samples: bool = False) -> Dict[str, Optional[float]]:
    """The shared latency summary shape (:data:`LATENCY_FIELDS`) from
    a mergeable histogram; all-None quantiles when empty.

    ``samples=True`` additionally carries the RAW observations under
    ``"samples"`` (an additive key — every validator checks the named
    fields, not exhaustive shape), which is what lets
    :func:`merge_rings` pool windows from many workers' rings into
    EXACT fleet quantiles instead of approximating from summaries."""
    if not hist.values:
        out: Dict[str, Any] = {"count": 0, "p50": None, "p90": None,
                               "p99": None, "mean": None, "max": None}
    else:
        out = {
            "count": len(hist.values),
            "p50": hist.quantile(0.5),
            "p90": hist.quantile(0.9),
            "p99": hist.quantile(0.99),
            "mean": sum(hist.values) / len(hist.values),
            "max": max(hist.values),
        }
    if samples:
        out["samples"] = [float(v) for v in hist.values]
    return out


def _breakdown(counts_map: Dict[str, collections.Counter],
               latency_map: Dict[str, Histogram]) -> Dict[str, dict]:
    """The shared per-key (tenant / traffic class) breakdown shape of
    window dicts and run totals."""
    out: Dict[str, dict] = {}
    for key in sorted(set(counts_map) | set(latency_map)):
        counts = counts_map.get(key, {})
        out[key] = {
            "completed": counts.get("completed", 0),
            "failed": counts.get("failed", 0),
            "shed": counts.get("shed", 0),
            "rejected": counts.get("rejected", 0),
            "latency_ms": latency_dict(
                latency_map.get(key, Histogram())),
        }
    return out


class PulseWindow:
    """One sliding-window accumulator (mutable while current)."""

    def __init__(self, index: int, start_s: float, duration_s: float):
        self.index = index
        self.start_s = start_s
        self.duration_s = duration_s
        self.counts: collections.Counter = collections.Counter()
        self.latency = Histogram()
        self.tenant_latency: Dict[str, Histogram] = {}
        self.tenant_counts: Dict[str, collections.Counter] = {}
        # The same breakdown keyed by the class actually
        # served (events stamp "traffic_class" post-fallback).
        self.class_latency: Dict[str, Histogram] = {}
        self.class_counts: Dict[str, collections.Counter] = {}
        self.queue_depth_last: Optional[int] = None
        self.queue_depth_max = 0
        self.hbm_in_use_bytes: Optional[int] = None
        self.hbm_occupancy: Optional[float] = None
        self.faults_seen = 0
        self.recoveries = 0
        self.slo_burns = 0      # filled by the watchdog at close time

    def observe(self, event: str, data: Dict[str, Any]) -> None:
        tenant = data.get("tenant")
        klass = data.get("traffic_class")
        if event in _COUNTED_EVENTS:
            self.counts[event] += 1
            if tenant is not None:
                self.tenant_counts.setdefault(
                    tenant, collections.Counter())[event] += 1
            if klass is not None:
                self.class_counts.setdefault(
                    klass, collections.Counter())[event] += 1
        elif event == "resumed_request":
            self.counts["resumed"] += 1
        elif event == "supervised":
            self.faults_seen += int(data.get("faults") or 0)
            self.recoveries += int(data.get("recoveries") or 0)
        if event == "completed" and data.get("latency_ms") is not None:
            ms = float(data["latency_ms"])
            self.latency.observe(ms)
            if tenant is not None:
                self.tenant_latency.setdefault(
                    tenant, Histogram()).observe(ms)
            if klass is not None:
                self.class_latency.setdefault(
                    klass, Histogram()).observe(ms)
        if data.get("queue_depth") is not None:
            d = int(data["queue_depth"])
            self.queue_depth_last = d
            self.queue_depth_max = max(self.queue_depth_max, d)

    def sample_hbm(self, in_use_bytes: int, occupancy: float) -> None:
        self.hbm_in_use_bytes = int(in_use_bytes)
        self.hbm_occupancy = float(occupancy)

    def to_dict(self, duration_s: Optional[float] = None) -> dict:
        """Serialize with the shared :data:`SLO_SERIES_FIELDS` names;
        ``duration_s`` overrides the nominal width for a partial final
        window so ``requests_per_s`` stays honest."""
        dur = self.duration_s if duration_s is None else duration_s
        completed = self.counts.get("completed", 0)
        return {
            "window": self.index,
            "start_s": self.start_s,
            "duration_s": dur,
            "submitted": self.counts.get("submitted", 0),
            "admitted": self.counts.get("admitted", 0),
            "completed": completed,
            "failed": self.counts.get("failed", 0),
            "shed": self.counts.get("shed", 0),
            "rejected": self.counts.get("rejected", 0),
            "degraded": self.counts.get("degraded", 0),
            "resumed": self.counts.get("resumed", 0),
            "requests_per_s": (completed / dur) if dur > 0 else None,
            # Raw samples ride in the window dict so N workers' rings
            # can be pooled into exact fleet quantiles (merge_rings).
            "latency_ms": latency_dict(self.latency, samples=True),
            "queue_depth": {"last": self.queue_depth_last,
                            "max": self.queue_depth_max},
            "hbm": {"in_use_bytes": self.hbm_in_use_bytes,
                    "occupancy": self.hbm_occupancy},
            "faults_seen": self.faults_seen,
            "recoveries": self.recoveries,
            "slo_burns": self.slo_burns,
            "per_tenant": _breakdown(self.tenant_counts,
                                     self.tenant_latency),
            "per_class": _breakdown(self.class_counts,
                                    self.class_latency),
        }


# -- SLO-burn watchdog ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One windowed burn-rate rule: ``metric`` (a dotted path into the
    window dict, e.g. ``"latency_ms.p99"``) burning means value >
    ``threshold``; the watchdog trips only after ``min_windows``
    CONSECUTIVE burning windows (hysteresis: one bad window never
    flaps the ladder)."""

    name: str
    metric: str
    threshold: float
    min_windows: int = 2

    def __post_init__(self):
        if self.min_windows < 1:
            raise ValueError(f"min_windows must be >= 1, got "
                             f"{self.min_windows}")

    def value(self, window: dict) -> Optional[float]:
        node: Any = window
        for part in self.metric.split("."):
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return None if node is None else float(node)

    def burning(self, window: dict) -> bool:
        v = self.value(window)
        return v is not None and v > self.threshold

    # -- the three production rules ------------------------------------

    @classmethod
    def p99_latency(cls, target_ms: float,
                    min_windows: int = 2) -> "BurnRule":
        """p99 latency over the SLO target."""
        return cls("p99_latency", "latency_ms.p99", float(target_ms),
                   min_windows)

    @classmethod
    def hbm_occupancy(cls, high_water: float = 0.95,
                      min_windows: int = 2) -> "BurnRule":
        """HBM occupancy over the accountant's high-water mark."""
        return cls("hbm_occupancy", "hbm.occupancy", float(high_water),
                   min_windows)

    @classmethod
    def fault_rate(cls, max_per_window: float = 0.0,
                   min_windows: int = 2) -> "BurnRule":
        """Recovered-fault (retry) spike: more supervised faults per
        window than ``max_per_window``."""
        return cls("fault_rate", "faults_seen", float(max_per_window),
                   min_windows)


def default_rules(target_p99_ms: Optional[float] = None,
                  hbm_high_water: float = 0.95,
                  max_faults_per_window: float = 2.0,
                  min_windows: int = 2) -> List[BurnRule]:
    """The production rule set; the p99 rule only exists when a target
    is configured (a latency SLO cannot be defaulted honestly)."""
    rules = [BurnRule.hbm_occupancy(hbm_high_water, min_windows),
             BurnRule.fault_rate(max_faults_per_window, min_windows)]
    if target_p99_ms is not None and target_p99_ms > 0:
        rules.insert(0, BurnRule.p99_latency(target_p99_ms,
                                             min_windows))
    return rules


@guarded_by("_lock", node="slo_watchdog",
            attrs=("events", "_streak", "_burning"),
            callbacks=("on_burn",))
class SloWatchdog:
    """Evaluates burn rules on each closed window — a pure function of
    the window series, so replays are bit-identical.  A rule that has
    been burning for ``min_windows`` consecutive windows trips once
    (``slo_burn`` event + ``on_burn(rule, window, event)`` callback —
    the degradation-ladder feed); the first healthy window after a
    trip emits ``slo_burn_cleared`` once and re-arms the rule."""

    def __init__(self, rules: Optional[List[BurnRule]] = None,
                 on_burn: Optional[Callable[..., None]] = None):
        self.rules = list(rules) if rules is not None else default_rules()
        self.on_burn = on_burn
        self.events: List[dict] = []
        self._streak: Dict[str, int] = {r.name: 0 for r in self.rules}
        self._burning: set = set()
        self._lock = witnessed("slo_watchdog", threading.Lock())

    def on_window(self, window: dict) -> List[dict]:
        """Evaluate every rule against one closed window dict; returns
        (and records) the burn events it produced."""
        fired: List[Tuple[Optional[BurnRule], dict]] = []
        with self._lock:
            for rule in self.rules:
                if rule.burning(window):
                    self._streak[rule.name] = \
                        self._streak.get(rule.name, 0) + 1
                    if (self._streak[rule.name] >= rule.min_windows
                            and rule.name not in self._burning):
                        self._burning.add(rule.name)
                        fired.append((rule, {
                            "event": "slo_burn",
                            "rule": rule.name,
                            "metric": rule.metric,
                            "value": rule.value(window),
                            "threshold": rule.threshold,
                            "window": window.get("window"),
                            "streak": self._streak[rule.name],
                        }))
                else:
                    self._streak[rule.name] = 0
                    if rule.name in self._burning:
                        self._burning.discard(rule.name)
                        fired.append((None, {
                            "event": "slo_burn_cleared",
                            "rule": rule.name,
                            "metric": rule.metric,
                            "window": window.get("window"),
                        }))
            events = [ev for _, ev in fired]
            self.events.extend(events)
        # Callbacks and flight records run OUTSIDE the lock: on_burn
        # re-enters the scheduler (degradation), which re-enters the
        # monitor — hold-and-wait here would be a lock-order inversion.
        for rule, ev in fired:
            flight.record("slo_burn", ev["rule"], **ev)
            if rule is not None and self.on_burn is not None:
                self.on_burn(rule, window, ev)
        return events

    def burning(self) -> List[str]:
        with self._lock:
            return sorted(self._burning)


# -- the streaming aggregator ----------------------------------------------


@guarded_by("_lock", node="pulse_monitor",
            attrs=("_current", "_closed", "_last_now",
                   "dropped_windows", "closed_reason", "totals",
                   "total_latency", "_tenant_totals", "_tenant_latency",
                   "_class_totals", "_class_latency", "burn_events"),
            callbacks=("hbm_sampler",))
class PulseMonitor:
    """Sliding-window telemetry aggregator for one ArrowServer.

    ``observe(event, **data)`` is the single ingest point (the
    scheduler's ``_event`` funnel forwards every serve event); windows
    rotate lazily on observation (or explicitly via :meth:`advance` —
    the deterministic path chaos scenarios use, with an injected
    ``clock``).  Closed windows are retained (bounded by
    ``ring_capacity``, histograms intact, so :meth:`merged_latency`
    can pool them exactly), evaluated by the watchdog, and flushed to
    the on-disk ring atomically — a SIGKILLed server leaves the full
    closed-window series readable on disk.
    """

    def __init__(self, *, window_s: float = 1.0,
                 ring_path: Optional[str] = None,
                 ring_capacity: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 watchdog: Optional[SloWatchdog] = None,
                 hbm_sampler: Optional[
                     Callable[[], Tuple[int, float]]] = None,
                 ledger_dir: Optional[str] = None,
                 name: str = "pulse"):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if ring_capacity < 1:
            raise ValueError(f"ring_capacity must be >= 1, got "
                             f"{ring_capacity}")
        self.name = name
        self.window_s = float(window_s)
        self.ring_path = ring_path
        self.ledger_dir = ledger_dir
        self.ledger_record: Optional[dict] = None
        self.ring_capacity = int(ring_capacity)
        self.clock = clock
        self.watchdog = watchdog
        self.hbm_sampler = hbm_sampler
        self._lock = witnessed("pulse_monitor", threading.Lock())
        self._t0 = float(clock())
        self._last_now = self._t0
        self._current = PulseWindow(0, self._t0, self.window_s)
        self._closed: collections.deque = collections.deque(
            maxlen=self.ring_capacity)   # (PulseWindow, dict) pairs
        self.dropped_windows = 0
        self.closed_reason: Optional[str] = None
        self.totals: collections.Counter = collections.Counter()
        self.total_latency = Histogram()
        self._tenant_totals: Dict[str, collections.Counter] = {}
        self._tenant_latency: Dict[str, Histogram] = {}
        self._class_totals: Dict[str, collections.Counter] = {}
        self._class_latency: Dict[str, Histogram] = {}
        self.burn_events: List[dict] = []
        #: ``platform``/``device_kind`` of the ledger record at close
        #: (``ledger.device_stamp``); ``ArrowServer.attach_pulse`` sets
        #: the server's device.
        self.device_stamp: Dict[str, str] = {}
        self.meta = {"pid": os.getpid(), "name": name,
                     "window_s": self.window_s,
                     "created_unix": time.time()}

    # -- ingest --------------------------------------------------------

    def observe(self, event: str, **data) -> None:
        """Fold one serve event into the current window (rotating any
        windows that ended before it).  No-op after :meth:`close`."""
        # The HBM sampler is a user callback that takes the
        # accountant's lock — it runs BEFORE this monitor's lock is
        # taken (RC3), so a slow or re-entrant sampler can never hold
        # telemetry ingest hostage.  The unlocked closed_reason
        # pre-check only skips a pointless sample; the authoritative
        # check happens under the lock below.
        sample = None
        if self.hbm_sampler is not None and self.closed_reason is None:
            try:
                sample = self.hbm_sampler()
            except Exception:  # graft-lint: disable=R8 — telemetry
                # must never take down the server it observes; a
                # failing sampler just leaves the gauge unsampled.
                sample = None
        with self._lock:
            if self.closed_reason is not None:
                return
            pending = self._rotate_locked(self.clock())
            w = self._current
            w.observe(event, data)
            self._fold_totals(event, data)
            if sample is not None:
                w.sample_hbm(sample[0], sample[1])
        self._dispatch(pending)

    def advance(self, now: Optional[float] = None) -> List[dict]:
        """Rotate windows up to ``now`` (default: the clock) without
        recording an event; returns the newly closed window dicts.
        The explicit rotation for deterministic tests/chaos scenarios."""
        with self._lock:
            if self.closed_reason is not None:
                return []
            pending = self._rotate_locked(
                self.clock() if now is None else float(now))
        self._dispatch(pending)
        return [d for _, d in pending]

    def close(self, reason: str = "closed") -> None:
        """Seal the monitor: the in-progress window is closed with its
        actual (partial) duration, the watchdog sees it, and the ring
        gets its final flush.  Idempotent; later observations no-op."""
        with self._lock:
            if self.closed_reason is not None:
                return
            now = float(self.clock())
            pending = self._rotate_locked(now)
            w = self._current
            partial = max(now - w.start_s, 0.0)
            if (partial > 0 or sum(w.counts.values())
                    or w.latency.values):
                d = w.to_dict(duration_s=partial or self.window_s)
                self._closed.append((w, d))
                pending.append((w, d))
            self.closed_reason = reason
        self._dispatch(pending)
        self.flush_ring()
        self._record_to_ledger()

    def _record_to_ledger(self) -> None:
        """The ledger: one ``kind="pulse"`` summary record per
        monitor lifetime, emitted at close into the configured
        (usually run-dir-local) store.  Guarded — telemetry must never
        take down what it observes."""
        if self.ledger_dir is None:
            return
        try:
            from arrow_matrix_tpu_torch.ledger import record as _ledger_rec

            totals = self.totals_dict()
            lat = totals.get("latency_ms") or {}
            self.ledger_record = _ledger_rec(
                "pulse", "pulse_p99_ms", lat.get("p99"),
                directory=self.ledger_dir, unit="ms",
                **self.device_stamp,
                knobs={"name": self.name, "window_s": self.window_s},
                payload={"totals": totals,
                         "windows": len(self._closed),
                         "dropped_windows": self.dropped_windows,
                         "burn_events": len(self.burn_events),
                         "closed": self.closed_reason})
        except Exception as e:
            print(f"[ledger] pulse record not persisted: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)

    def _fold_totals(self, event: str, data: Dict[str, Any]) -> None:
        tenant = data.get("tenant")
        klass = data.get("traffic_class")
        if event in _COUNTED_EVENTS:
            self.totals[event] += 1
            if tenant is not None:
                self._tenant_totals.setdefault(
                    tenant, collections.Counter())[event] += 1
            if klass is not None:
                self._class_totals.setdefault(
                    klass, collections.Counter())[event] += 1
        elif event == "resumed_request":
            self.totals["resumed"] += 1
        elif event == "supervised":
            self.totals["faults_seen"] += int(data.get("faults") or 0)
            self.totals["recoveries"] += \
                int(data.get("recoveries") or 0)
        if event == "completed" and data.get("latency_ms") is not None:
            ms = float(data["latency_ms"])
            self.total_latency.observe(ms)
            if tenant is not None:
                self._tenant_latency.setdefault(
                    tenant, Histogram()).observe(ms)
            if klass is not None:
                self._class_latency.setdefault(
                    klass, Histogram()).observe(ms)

    def _rotate_locked(self, now: float
                       ) -> List[Tuple[PulseWindow, dict]]:
        """Close every window that ended at or before ``now`` (window
        ``i`` spans ``[t0 + i*w, t0 + (i+1)*w)``); caller holds the
        lock.  Returns the (window, dict) pairs for post-lock watchdog
        evaluation + ring flush."""
        self._last_now = max(self._last_now, now)
        target = int((now - self._t0) // self.window_s)
        if target <= self._current.index:
            return []
        closed: List[Tuple[PulseWindow, dict]] = []
        while self._current.index < target:
            w = self._current
            d = w.to_dict()
            if len(self._closed) == self._closed.maxlen:
                self.dropped_windows += 1
            self._closed.append((w, d))
            closed.append((w, d))
            nxt = w.index + 1
            # After a long idle gap, materialize only a bounded run of
            # empty windows (enough for hysteresis clears), then snap.
            if target - nxt > _MAX_GAP_FILL and not w.counts:
                self.dropped_windows += target - nxt
                nxt = target
            self._current = PulseWindow(
                nxt, self._t0 + nxt * self.window_s, self.window_s)
        return closed

    def _dispatch(self, closed: List[Tuple[PulseWindow, dict]]) -> None:
        """Watchdog evaluation + ring flush for freshly closed windows
        — outside the monitor lock (the burn callback re-enters the
        scheduler, which re-enters :meth:`observe`)."""
        if not closed:
            return
        for _, d in closed:
            if self.watchdog is not None:
                events = self.watchdog.on_window(d)
                d["slo_burns"] = sum(
                    1 for e in events if e["event"] == "slo_burn")
                if events:
                    # Re-take the monitor lock just for the append:
                    # burn_events is read (snapshot/totals) from other
                    # threads, and list.extend from two dispatchers
                    # could interleave with a concurrent iteration.
                    with self._lock:
                        self.burn_events.extend(events)
        self.flush_ring()

    # -- views ---------------------------------------------------------

    def series(self) -> List[dict]:
        """The closed-window dicts, oldest first."""
        with self._lock:
            return [d for _, d in self._closed]

    def merged_latency(self) -> Histogram:
        """All retained window latency histograms pooled into one —
        exactly the pooled samples (Histogram.merge is lossless), the
        property the gate compares against the final SLO report."""
        out = Histogram()
        with self._lock:
            for w, _ in self._closed:
                out.merge(w.latency)
            # After close() the current window is the last closed one:
            # pooling it again would count its samples twice (the JAX
            # package's merged_latency does, after close).
            if self.closed_reason is None:
                out.merge(self._current.latency)
        return out

    def totals_dict(self) -> dict:
        with self._lock:
            elapsed = max(self._last_now - self._t0, 0.0)
            completed = self.totals.get("completed", 0)
            burn_counts: collections.Counter = collections.Counter(
                e["rule"] for e in self.burn_events
                if e["event"] == "slo_burn")
            # "Last sample" gauges: a freshly rotated (empty) current
            # window has none — fall back to the newest closed window
            # that sampled one.
            hbm_bytes = self._current.hbm_in_use_bytes
            hbm_occ = self._current.hbm_occupancy
            depth_last = self._current.queue_depth_last
            for w, _ in reversed(self._closed):
                if hbm_occ is None and w.hbm_occupancy is not None:
                    hbm_bytes = w.hbm_in_use_bytes
                    hbm_occ = w.hbm_occupancy
                if depth_last is None \
                        and w.queue_depth_last is not None:
                    depth_last = w.queue_depth_last
                if hbm_occ is not None and depth_last is not None:
                    break
            return {
                "submitted": self.totals.get("submitted", 0),
                "admitted": self.totals.get("admitted", 0),
                "completed": completed,
                "failed": self.totals.get("failed", 0),
                "shed": self.totals.get("shed", 0),
                "rejected": self.totals.get("rejected", 0),
                "degraded": self.totals.get("degraded", 0),
                "resumed": self.totals.get("resumed", 0),
                "faults_seen": self.totals.get("faults_seen", 0),
                "recoveries": self.totals.get("recoveries", 0),
                "requests_per_s": (completed / elapsed)
                                  if elapsed > 0 else None,
                "latency_ms": latency_dict(self.total_latency),
                "queue_depth": {
                    "last": depth_last,
                    "max": max([w.queue_depth_max
                                for w, _ in self._closed]
                               + [self._current.queue_depth_max] or [0]),
                },
                "hbm": {
                    "in_use_bytes": hbm_bytes,
                    "occupancy": hbm_occ,
                },
                "slo_burns": dict(sorted(burn_counts.items())),
                "per_tenant": _breakdown(self._tenant_totals,
                                         self._tenant_latency),
                "per_class": _breakdown(self._class_totals,
                                        self._class_latency),
            }

    def snapshot(self) -> dict:
        """The full ring document (identical to what
        :meth:`flush_ring` writes — one shape on disk, over HTTP, and
        in memory)."""
        totals = self.totals_dict()
        with self._lock:
            return {
                "schema": SCHEMA_VERSION,
                "kind": "pulse_ring",
                "meta": dict(self.meta),
                "window_s": self.window_s,
                "windows": [d for _, d in self._closed],
                "dropped_windows": self.dropped_windows,
                "totals": totals,
                "burn_events": list(self.burn_events),
                "burning": (self.watchdog.burning()
                            if self.watchdog is not None else []),
                "closed": self.closed_reason,
            }

    def flush_ring(self) -> Optional[str]:
        """Atomically rewrite the on-disk ring (crash-readable — the
        flight-recorder discipline); swallows write errors: telemetry
        must never take down the server."""
        if self.ring_path is None:
            return None
        snap = self.snapshot()
        try:
            # fsync=False: the ring is rewritten every window close —
            # atomicity (no torn reader) matters, per-window power-cut
            # durability does not, and the fsync would eat the <5%
            # overhead budget.
            atomic_write_json(self.ring_path, snap, fsync=False)
        except OSError:
            pass
        return self.ring_path

    # -- exposition ----------------------------------------------------

    def exposition_text(self) -> str:
        """Prometheus-style text exposition of the totals + the last
        closed window (the live scrape surface;
        :func:`validate_exposition` checks this grammar)."""
        snap = self.snapshot()
        t = snap["totals"]
        lines: List[str] = []

        def fam(name: str, kind: str, help_text: str) -> None:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")

        def num(v: Optional[float]) -> str:
            if v is None:
                return "NaN"
            f = float(v)
            return repr(int(f)) if f == int(f) else repr(f)

        fam("pulse_requests_total", "counter",
            "Requests by terminal/admission state.")
        for status in ("submitted", "admitted", "completed", "failed",
                       "shed", "rejected"):
            lines.append(f'pulse_requests_total{{status="{status}"}} '
                         f'{num(t[status])}')
        fam("pulse_latency_ms", "summary",
            "Completed-request latency quantiles (run totals).")
        lat = t["latency_ms"]
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            lines.append(f'pulse_latency_ms{{quantile="{q}"}} '
                         f'{num(lat[key])}')
        lines.append(f"pulse_latency_ms_count {num(lat['count'])}")
        fam("pulse_queue_depth", "gauge",
            "Last observed scheduler queue depth.")
        lines.append(f"pulse_queue_depth "
                     f"{num(t['queue_depth']['last'] or 0)}")
        fam("pulse_hbm_in_use_bytes", "gauge",
            "Live HBM accountant in-use bytes (last sample).")
        lines.append(f"pulse_hbm_in_use_bytes "
                     f"{num(t['hbm']['in_use_bytes'] or 0)}")
        fam("pulse_hbm_occupancy", "gauge",
            "Live HBM occupancy vs the admission budget.")
        lines.append(f"pulse_hbm_occupancy "
                     f"{num(t['hbm']['occupancy'] or 0.0)}")
        per_class = t.get("per_class") or {}
        if per_class:
            fam("pulse_class_completed_total", "counter",
                "Completed requests by served traffic class.")
            for klass, rec in sorted(per_class.items()):
                lines.append(
                    f'pulse_class_completed_total'
                    f'{{traffic_class="{klass}"}} '
                    f'{num(rec["completed"])}')
            fam("pulse_class_latency_ms", "summary",
                "Latency quantiles by served traffic class.")
            for klass, rec in sorted(per_class.items()):
                for q, key in (("0.5", "p50"), ("0.99", "p99")):
                    lines.append(
                        f'pulse_class_latency_ms{{traffic_class='
                        f'"{klass}",quantile="{q}"}} '
                        f'{num(rec["latency_ms"][key])}')
        fam("pulse_degraded_total", "counter",
            "Tenant ladder degradations.")
        lines.append(f"pulse_degraded_total {num(t['degraded'])}")
        fam("pulse_faults_total", "counter",
            "Supervised faults seen (recovered retries).")
        lines.append(f"pulse_faults_total {num(t['faults_seen'])}")
        fam("pulse_slo_burn_total", "counter",
            "SLO-burn watchdog trips by rule.")
        burns = t["slo_burns"] or {}
        if burns:
            for rule, n in burns.items():
                lines.append(f'pulse_slo_burn_total{{rule="{rule}"}} '
                             f'{num(n)}')
        else:
            lines.append("pulse_slo_burn_total 0")
        fam("pulse_windows_total", "counter",
            "Closed telemetry windows (dropped excluded).")
        lines.append(f"pulse_windows_total {num(len(snap['windows']))}")
        fam("pulse_window_seconds", "gauge", "Window width.")
        lines.append(f"pulse_window_seconds {num(snap['window_s'])}")
        if snap["windows"]:
            last = snap["windows"][-1]
            fam("pulse_window_latency_ms", "summary",
                "Latency quantiles of the last closed window.")
            wl = last["latency_ms"]
            for q, key in (("0.5", "p50"), ("0.99", "p99")):
                lines.append(
                    f'pulse_window_latency_ms{{quantile="{q}"}} '
                    f'{num(wl[key])}')
            fam("pulse_window_requests_per_s", "gauge",
                "Throughput of the last closed window.")
            lines.append(f"pulse_window_requests_per_s "
                         f"{num(last['requests_per_s'] or 0.0)}")
        return "\n".join(lines) + "\n"


# -- validation -------------------------------------------------------------

_EXPO_LINE = re.compile(
    r'^[A-Za-z_:][A-Za-z0-9_:]*'
    r'(\{[A-Za-z0-9_]+="[^"]*"(,[A-Za-z0-9_]+="[^"]*")*\})?'
    r' (NaN|[+-]?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?)$')

#: Families every exposition must carry (the gate's schema floor).
REQUIRED_FAMILIES = ("pulse_requests_total", "pulse_latency_ms",
                     "pulse_queue_depth", "pulse_hbm_occupancy",
                     "pulse_windows_total")


def validate_exposition(text: str) -> List[str]:
    """Problems with a Prometheus exposition payload: every sample
    line must parse, and the required metric families must appear."""
    problems = []
    seen = set()
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# "):
            parts = line.split()
            if len(parts) < 4 or parts[1] not in ("HELP", "TYPE"):
                problems.append(f"line {i}: malformed comment "
                                f"{line!r}")
            continue
        if not _EXPO_LINE.match(line):
            problems.append(f"line {i}: unparseable sample {line!r}")
            continue
        seen.add(line.split("{")[0].split(" ")[0])
    for fam in REQUIRED_FAMILIES:
        if not any(s == fam or s.startswith(fam + "_") for s in seen):
            problems.append(f"missing required family {fam}")
    if text and not text.endswith("\n"):
        problems.append("exposition must end with a newline")
    return problems


def validate_ring(doc: dict) -> List[str]:
    """Problems with a pulse ring document (the on-disk artifact, the
    ``/pulse.json`` payload, and ``PulseMonitor.snapshot()`` share one
    shape): schema version, the full :data:`SLO_SERIES_FIELDS` per
    window, latency sub-dicts, and monotone window indices."""
    problems = []
    if not isinstance(doc, dict):
        return ["ring document is not a JSON object"]
    if doc.get("schema") != SCHEMA_VERSION:
        problems.append(f"schema {doc.get('schema')!r} != "
                        f"{SCHEMA_VERSION}")
    if doc.get("kind") != "pulse_ring":
        problems.append(f"kind {doc.get('kind')!r} != 'pulse_ring'")
    windows = doc.get("windows")
    if not isinstance(windows, list):
        return problems + ["windows is not a list"]
    prev = None
    for w in windows:
        idx = w.get("window")
        missing = [f for f in SLO_SERIES_FIELDS if f not in w]
        if missing:
            problems.append(f"window {idx}: missing fields {missing}")
        lat = w.get("latency_ms")
        if not isinstance(lat, dict) or any(f not in lat
                                            for f in LATENCY_FIELDS):
            problems.append(f"window {idx}: latency_ms lacks "
                            f"{LATENCY_FIELDS}")
        if prev is not None and (idx is None or idx <= prev):
            problems.append(f"window indices not increasing at {idx}")
        prev = idx if isinstance(idx, int) else prev
    totals = doc.get("totals")
    if not isinstance(totals, dict):
        problems.append("totals missing")
    else:
        for f in ("completed", "shed", "rejected", "latency_ms",
                  "per_tenant", "per_class"):
            if f not in totals:
                problems.append(f"totals missing {f}")
    if not isinstance(doc.get("burn_events"), list):
        problems.append("burn_events missing")
    return problems


def load_ring(path: str) -> dict:
    """Read a pulse ring artifact back (crash-readable: the writer
    only ever renames complete documents into place)."""
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


# -- multi-ring pooling (the fleet) -----------------------------------------


def ring_latency_histogram(doc: dict) -> Tuple[Histogram, List[str]]:
    """Pool one ring's window-level RAW latency samples into a
    mergeable Histogram.  Returns ``(histogram, problems)`` — a window
    that counted completions but carries no ``samples`` list (a ring
    written before samples rode the window dicts) is a problem: its
    latencies cannot be pooled exactly, only approximated."""
    hist = Histogram()
    problems = []
    for w in doc.get("windows") or []:
        lat = w.get("latency_ms") or {}
        samples = lat.get("samples")
        if samples is None:
            if lat.get("count"):
                problems.append(
                    f"window {w.get('window')}: {lat.get('count')} "
                    f"completions but no raw samples — exact pooling "
                    f"impossible")
            continue
        hist.values.extend(float(v) for v in samples)
    return hist, problems


#: Count fields summed across rings by :func:`merge_rings`.
_MERGE_COUNT_FIELDS = (
    "submitted", "admitted", "completed", "failed", "shed",
    "rejected", "degraded", "resumed", "faults_seen", "recoveries",
)


def merge_rings(docs: List[dict]) -> dict:
    """Pool N pulse rings (one per fleet worker) into ONE exact
    fleet-level document.

    For every source ring the pooled-from-windows histogram is checked
    against the ring's own streamed totals — count and p50/p90/p99
    must match EXACTLY (Histogram.merge is lossless and both sides use
    the same nearest-rank quantile), which only holds when the ring
    dropped no windows; any mismatch, drop, or sample-less window
    lands in ``problems``.  The merged ``totals.latency_ms`` is the
    nearest-rank summary of the UNION of all workers' raw samples —
    fleet p99 with no approximation — and the count fields are sums.
    """
    problems: List[str] = []
    pooled = Histogram()
    counts = collections.Counter()
    per_ring = []
    for i, doc in enumerate(docs):
        name = str((doc.get("meta") or {}).get("name")
                   or f"ring{i}")
        for p in validate_ring(doc):
            problems.append(f"{name}: {p}")
        dropped = int(doc.get("dropped_windows") or 0)
        if dropped:
            problems.append(
                f"{name}: {dropped} dropped windows — the retained "
                f"windows under-count the stream; pooled != streamed")
        hist, ring_problems = ring_latency_histogram(doc)
        problems += [f"{name}: {p}" for p in ring_problems]
        totals = doc.get("totals") or {}
        tlat = totals.get("latency_ms") or {}
        if not dropped and not ring_problems:
            # pooled == streamed: the
            # window samples re-pooled must reproduce the monitor's
            # own streamed run-total histogram exactly.
            streamed_count = int(tlat.get("count") or 0)
            if len(hist.values) != streamed_count:
                problems.append(
                    f"{name}: pooled sample count {len(hist.values)}"
                    f" != streamed totals count {streamed_count}")
            else:
                for q, field in ((0.5, "p50"), (0.9, "p90"),
                                 (0.99, "p99")):
                    got, want = hist.quantile(q), tlat.get(field)
                    if got != want:
                        problems.append(
                            f"{name}: pooled {field} {got!r} != "
                            f"streamed {want!r}")
        for f in _MERGE_COUNT_FIELDS:
            counts[f] += int(totals.get(f) or 0)
        pooled.merge(hist)
        per_ring.append({
            "name": name,
            "windows": len(doc.get("windows") or []),
            "dropped_windows": dropped,
            "pooled_samples": len(hist.values),
            "streamed_latency_ms": {f: tlat.get(f)
                                    for f in LATENCY_FIELDS},
        })
    merged_totals = {f: counts.get(f, 0) for f in _MERGE_COUNT_FIELDS}
    merged_totals["latency_ms"] = latency_dict(pooled)
    return {
        "schema": SCHEMA_VERSION,
        "kind": "pulse_merge",
        "rings": len(docs),
        "per_ring": per_ring,
        "totals": merged_totals,
        "problems": problems,
    }


# -- the stdlib HTTP scrape endpoint ---------------------------------------


class PulseEndpoint:
    """Prometheus-style scrape endpoint over one monitor, on the
    stdlib ``http.server`` (no new dependencies):

      * ``/metrics``    — text exposition (:meth:`PulseMonitor
        .exposition_text`);
      * ``/pulse.json`` — the full ring document;
      * ``/healthz``    — liveness (200 ``ok``).

    ``port=0`` binds an ephemeral port (read it back from ``.port``
    after :meth:`start`) — what the tests use."""

    def __init__(self, monitor: PulseMonitor,
                 host: str = "127.0.0.1", port: int = 0):
        self.monitor = monitor
        self.host = host
        self.port = int(port)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PulseEndpoint":
        import http.server

        monitor = self.monitor

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):   # noqa: N802 — stdlib API name
                if self.path.startswith("/metrics"):
                    body = monitor.exposition_text().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path.startswith("/pulse.json"):
                    body = json.dumps(monitor.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/healthz"):
                    body, ctype = b"ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # silence per-scrape stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"graft-pulse-endpoint-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

"""Process-level metrics registry with a JSONL sink.

The port's copy of ``arrow_matrix_tpu/obs/metrics.py``: named counters,
gauges and histograms keyed by label sets, collected in one registry.
Every mutation is also appended to an event log, so ``write_jsonl``
writes the same ``metrics.jsonl`` (one JSON object per line) as the JAX
package, while ``snapshot`` gives the aggregated view.  Pure Python:
the registry touches no device.  ``merge_segment_log`` imports a
:class:`~arrow_matrix_tpu_torch.utils.logging.SegmentLog`'s numeric
entries into the same sink.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.sync import guarded_by, witnessed


#: Metric names whose samples are NOT mirrored into the flight ring.
#: ``span_ms`` is mirrored by a tracer itself (with request context);
#: the per-frame wire metrics fire on every frame of a multi-process
#: deployment and would evict the span events from the bounded ring.
FLIGHT_MIRROR_SKIP = frozenset(
    {"span_ms", "wire_frame_bytes", "wire_serialize_ms", "wire_ms"})


def _label_key(labels: Dict[str, Any]) -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared identity (name + labels) and event emission."""

    kind = "instrument"

    def __init__(self, registry: "MetricsRegistry | None", name: str,
                 labels: Dict[str, Any]):
        self._registry = registry
        self.name = name
        self.labels = dict(labels)

    def _emit(self, value: float) -> None:
        if self._registry is not None:
            self._registry._event(self.kind, self.name, value, self.labels)


class Counter(_Instrument):
    """Monotone accumulator (events carry the running total)."""

    kind = "counter"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n
        self._emit(self.value)


class Gauge(_Instrument):
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)
        self._emit(self.value)


class Histogram(_Instrument):
    """All observed values retained (runs here are bench-scale:
    hundreds of observations, not unbounded telemetry).

    Value retention is also what makes the histogram *mergeable*
    without approximation: :meth:`merge` pools the raw samples, so a
    merged histogram's :meth:`quantile` is exactly the quantile of the
    pooled observations — the property relied on when one
    combines per-window (or per-thread) latency histograms into the
    run-total view and asserts it equals the final SLO report.
    """

    kind = "histogram"

    def __init__(self, registry=None, name: str = "histogram",
                 labels: Optional[Dict[str, Any]] = None):
        super().__init__(registry, name, labels or {})
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))
        self._emit(float(v))

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-quantile (nearest-rank on the sorted samples, the
        convention every SLO report here already used ad hoc); None on
        an empty histogram.  ``q`` is clamped to [0, 1]."""
        if not self.values:
            return None
        q = min(max(float(q), 0.0), 1.0)
        vals = sorted(self.values)
        return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]

    def merge(self, other: "Histogram") -> "Histogram":
        """Pool ``other``'s samples into this histogram (in place;
        returns self for chaining).  No events are emitted — the
        samples were already recorded where they were observed."""
        self.values.extend(other.values)
        return self

    def summary(self) -> Dict[str, float]:
        if not self.values:
            return {"count": 0}
        vals = self.values
        return {
            "count": len(vals),
            "mean": sum(vals) / len(vals),
            "min": min(vals),
            "max": max(vals),
            "p50": self.quantile(0.5),
            "p90": self.quantile(0.9),
            # Tail percentile for the serving SLO reports; with fewer
            # than ~100 observations this clamps to the max (honest
            # for a bench-scale sample).
            "p99": self.quantile(0.99),
        }


@guarded_by("_lock", node="metrics_registry",
            attrs=("events", "_instruments"))
class MetricsRegistry:
    """Instrument factory + time-ordered event log.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create by
    (name, labels); ``record`` is the one-shot convenience that
    observes into a histogram.  ``run_dir`` only sets the default
    ``write_jsonl`` destination — nothing is written until asked.
    """

    def __init__(self, run_dir: Optional[str] = None):
        self.run_dir = run_dir
        self.events: List[dict] = []
        self._instruments: Dict[Tuple, _Instrument] = {}
        self._lock = witnessed("metrics_registry", threading.Lock())

    # -- instruments -------------------------------------------------------

    def _get(self, cls, name: str, labels: Dict[str, Any]):
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls(self, name, labels)
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def record(self, name: str, value: float, **labels) -> None:
        """Observe one value into the (name, labels) histogram."""
        self.histogram(name, **labels).observe(value)

    # -- event log ---------------------------------------------------------

    def _event(self, kind: str, name: str, value: float,
               labels: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append({"ts": time.time(), "kind": kind,
                                "name": name, "value": value,
                                "labels": dict(labels)})
        # Mirror into the flight recorder ring (no-op unless installed):
        # metric samples are the blackbox's record of what the run was
        # doing when a wedge killed it.  span_ms is skipped — the
        # Tracer mirrors spans itself with better context — and the
        # per-frame wire metrics are skipped too: a chatty wire would
        # churn the bounded ring and evict the span events a killed
        # worker's trace is recovered from.
        if name not in FLIGHT_MIRROR_SKIP:
            data = dict(labels)
            data["value"] = value
            flight.record(kind, name, **data)

    def merge_segment_log(self, seg) -> int:
        """Import a SegmentLog's numeric entries as events/observations
        (labels carry the log's algorithm/dataset identity); returns
        the number of values imported."""
        imported = 0
        for entry in seg.entries:
            for k, v in entry.items():
                if isinstance(v, (int, float)) and k != "iteration":
                    self.record(k, float(v), algorithm=seg.algorithm,
                                dataset=seg.dataset)
                    imported += 1
        return imported

    # -- output ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Aggregated view: counters/gauges with values, histograms
        with summaries."""
        out: dict = {"counters": [], "gauges": [], "histograms": []}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            rec = {"name": inst.name, "labels": inst.labels}
            if isinstance(inst, Histogram):
                rec["summary"] = inst.summary()
                out["histograms"].append(rec)
            elif isinstance(inst, Counter):
                rec["value"] = inst.value
                out["counters"].append(rec)
            else:
                rec["value"] = inst.value
                out["gauges"].append(rec)
        return out

    def write_jsonl(self, path: Optional[str] = None) -> str:
        """Flush the event log, one JSON object per line."""
        if path is None:
            if self.run_dir is None:
                raise ValueError("no path given and no run_dir set")
            path = os.path.join(self.run_dir, "metrics.jsonl")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with self._lock:
            events = list(self.events)
        with open(path, "w", encoding="utf-8") as fh:
            for e in events:
                fh.write(json.dumps(e, sort_keys=True) + "\n")
        return path


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    global _DEFAULT
    _DEFAULT = registry
    return _DEFAULT


def init_registry(run_dir: Optional[str] = None) -> MetricsRegistry:
    """Reset the process-global registry for a new run."""
    return set_registry(MetricsRegistry(run_dir=run_dir))

"""The flight recorder: a bounded ring of recent events, flushed to
disk so a killed or wedged run leaves a readable artifact.

The port's copy of ``arrow_matrix_tpu/obs/flight.py``, with the same
event vocabulary and JSON document (``meta``, ``sealed``, ``dropped``,
``last_memory_report``, ``events``), so either package's :func:`load`
reads the other's file.  A process killed by SIGKILL runs nothing at
the moment of death, so the recorder flushes eagerly: every ``record``
rewrites the artifact through an atomic tmp+rename
(``utils/artifacts.atomic_write_json``).  The artifact is at most one
event behind the process when the kill lands.

``install()`` sets the process-global recorder; the metrics registry
(``obs/metrics.py``), the supervisor and the server feed it through the
module-level :func:`record`, a no-op until a recorder is installed.
:func:`request_context` scopes events to one request (or one batch of
requests) so their streams can be joined back per request.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from arrow_matrix_tpu_torch.sync import guarded_by, witnessed
from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json

#: Default ring capacity: enough for every phase span + per-iteration
#: metric of a bench candidate with room to spare, small enough that
#: the eager per-event flush stays a one-page write.
DEFAULT_CAPACITY = 256

# -- request-scoped correlation context -----------------------------------
#
# The serving runtime processes many requests through one shared
# tracer/flight/metrics pipeline; without a shared key their streams
# cannot be joined back into one per-request story.  The context lives
# here (not in obs/pulse.py) because flight is the dependency-free spine
# every other obs module already imports: the recorder stamps events,
# the tracer stamps spans, pulse re-exports the API.  contextvars makes
# the correlation survive both the worker-thread handoff inside one
# request and interleaved requests on different threads.

_REQUEST_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "amt_request_ctx", default=None)


def current_request() -> Optional[Dict[str, str]]:
    """The active request correlation context — a dict with
    ``request_id`` (and ``tenant`` when known) — or None outside any
    request scope."""
    return _REQUEST_CTX.get()


@contextlib.contextmanager
def request_context(request_id: str,
                    tenant: Optional[str] = None,
                    **extra: Optional[str]) -> Iterator[None]:
    """Scope every flight event / tracer span / pulse observation made
    inside the body to one request (or one batch of requests — a
    batched key like ``"r0001+r0002"`` names every member).

    Nested scopes MERGE-INHERIT: keys of the enclosing context that the
    inner scope does not override stay visible, so a fleet-level
    ``trace_id`` stamped at the worker's wire entry survives the
    scheduler re-entering the context for the same request.  Extra keyword correlation keys (e.g.
    ``trace_id``, ``parent_span``) are stamped as strings; None values
    are skipped, never stored.
    """
    base = current_request()
    ctx: Dict[str, str] = dict(base) if base else {}
    ctx["request_id"] = str(request_id)
    if tenant is not None:
        ctx["tenant"] = str(tenant)
    for key, value in extra.items():
        if value is not None:
            ctx[key] = str(value)
    token = _REQUEST_CTX.set(ctx)
    try:
        yield
    finally:
        _REQUEST_CTX.reset(token)


@guarded_by("_lock", node="flight_recorder",
            attrs=("events", "dropped", "sealed",
                   "last_memory_report"))
class FlightRecorder:
    """Bounded in-memory ring of obs events with eager disk flush."""

    def __init__(self, path: Optional[str] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 autoflush: bool = True):
        self.path = path
        self.capacity = capacity
        self.events: collections.deque = collections.deque(maxlen=capacity)
        self.autoflush = autoflush and path is not None
        self.sealed: Optional[str] = None
        self.last_memory_report: Optional[Dict[str, Any]] = None
        self.dropped = 0
        # The server records from its always-on worker thread while
        # the submitting thread records admission events: ring append,
        # dropped accounting, and the snapshot-for-flush must be
        # mutually exclusive or a flush can serialize a half-updated
        # ring.  (RLock: seal() flushes while already holding it.)
        self._lock = witnessed("flight_recorder", threading.RLock())
        self.meta = {
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "created_unix": time.time(),
        }

    def record(self, kind: str, name: str, **data) -> None:
        """Append one event (and flush, when a path is configured).
        Events are stamped with the recording thread's name and, inside
        a :func:`request_context` scope, the request id/tenant — the
        correlation keys per-request streams are joined on."""
        ev: Dict[str, Any] = {"ts": time.time(), "kind": kind,
                              "name": name,
                              "thread": threading.current_thread().name}
        ctx = current_request()
        if ctx is not None:
            ev.update(ctx)
        if data:
            ev["data"] = data
        with self._lock:
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append(ev)
            if self.autoflush:
                self.flush()

    def note_memory_report(self, report: Dict[str, Any]) -> None:
        """Keep the latest per-executable memory report whole (the ring
        holds it as an event too, but a wedge postmortem wants the full
        breakdown, not whatever survived the ring)."""
        with self._lock:
            self.last_memory_report = dict(report)
        self.record("memreport", report.get("algorithm", "unknown"),
                    measured_bytes=report.get("measured_bytes"),
                    ratio=report.get("ratio"))

    def seal(self, reason: str) -> None:
        """Final flush with the termination reason.  Idempotent — the
        first seal wins (an excepthook seal must not be overwritten by
        the atexit seal that follows it)."""
        with self._lock:
            if self.sealed is None:
                self.sealed = reason
                self.flush()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "meta": self.meta,
                "sealed": self.sealed,
                "dropped": self.dropped,
                "last_memory_report": self.last_memory_report,
                "events": list(self.events),
            }

    def flush(self) -> Optional[str]:
        """Atomically rewrite the artifact; returns its path (None when
        no path is configured).  Write failures are swallowed — the
        recorder must never take down the run it is observing.  The
        tmp name carries the writing thread's id so two threads
        flushing concurrently cannot interleave one tmp file."""
        if self.path is None:
            return None
        snap = self.snapshot()
        try:
            # fsync=False: the black box flushes on EVERY event — the
            # crash modes it defends against (SIGKILL, excepthook) keep
            # the page cache, and an fsync per event would tax the run
            # it observes.
            atomic_write_json(self.path, snap, fsync=False)
        except OSError:
            pass
        return self.path


_RECORDER: Optional[FlightRecorder] = None


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def set_recorder(rec: Optional[FlightRecorder]) -> None:
    global _RECORDER
    _RECORDER = rec


def record(kind: str, name: str, **data) -> None:
    """Module-level hook used by Tracer/MetricsRegistry: no-op until a
    recorder is installed, so the obs layer pays nothing by default."""
    if _RECORDER is not None:
        _RECORDER.record(kind, name, **data)


def install(path: str, capacity: int = DEFAULT_CAPACITY
            ) -> FlightRecorder:
    """Install the process-global recorder writing to ``path`` and hook
    process termination: unhandled exceptions seal with the error,
    normal interpreter exit seals as "exit".  (A SIGKILL runs neither —
    that is what the eager per-event flush is for.)"""
    rec = FlightRecorder(path, capacity=capacity)
    set_recorder(rec)
    prev_hook = sys.excepthook

    def _seal_on_exception(exc_type, exc, tb):
        rec.seal(f"exception: {exc_type.__name__}: {exc}")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _seal_on_exception
    atexit.register(rec.seal, "exit")
    rec.flush()
    return rec


def load(path: str) -> Dict[str, Any]:
    """Read one flight artifact back."""
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def newest_artifact(directory: str) -> Optional[str]:
    """The most recently written ``*.json`` artifact under
    ``directory`` (non-recursive), or None."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    best: Optional[str] = None
    best_mt = -1.0
    for name in names:
        if not name.endswith(".json"):
            continue
        p = os.path.join(directory, name)
        try:
            mt = os.path.getmtime(p)
        except OSError:
            continue
        if mt > best_mt:
            best, best_mt = p, mt
    return best


def format_events(snapshot: Dict[str, Any],
                  last: Optional[int] = None) -> List[str]:
    """Human-readable lines of a flight artifact."""
    events = snapshot.get("events", [])
    if last is not None:
        events = events[-last:]
    meta = snapshot.get("meta", {})
    sealed = (snapshot.get("sealed")
              or "NO (process killed or still running)")
    lines = [f"flight recorder: pid={meta.get('pid')} "
             f"argv={' '.join(meta.get('argv', []))[:120]}",
             f"sealed: {sealed}; dropped={snapshot.get('dropped', 0)}"]
    t0 = events[0]["ts"] if events else 0.0
    for ev in events:
        data = ev.get("data")
        extra = (" " + " ".join(f"{k}={v}" for k, v in data.items())
                 if data else "")
        lines.append(f"  +{ev['ts'] - t0:9.3f}s [{ev['kind']:>8}] "
                     f"{ev['name']}{extra}")
    rep = snapshot.get("last_memory_report")
    if rep:
        lines.append(f"last memory report: {json.dumps(rep)}")
    return lines

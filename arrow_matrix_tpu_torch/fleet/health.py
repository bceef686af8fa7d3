"""Heartbeat-based worker health with explicit timeout and backoff.

The port's copy of ``arrow_matrix_tpu/fleet/health.py``: the same
behaviour and on-wire or on-disk forms.

A worker is never declared dead on a single wire error: the monitor
retries the heartbeat ``max_failures`` times with the per-worker
jittered backoff schedule of :class:`~arrow_matrix_tpu_torch.faults.policy
.RetryPolicy` (``for_worker`` seeding — N routers probing N workers
never thunder-herd on synchronized schedules), each probe bounded by
``timeout_s``.  Only a full streak of misses flips the verdict, and
the verdict is recorded with its evidence (consecutive failures, last
error, last-ok timestamp) so the fleet report can show WHY a worker
was buried.

Concurrency: every FleetRouter ``_dispatch`` thread folds
outcomes into one shared monitor, so the verdict state is guarded by
``_lock`` — the read-modify-write of ``consecutive_failures`` and the
alive flip must be atomic or two racing failures can each observe
streak N-1 and neither bury the worker.  Wire I/O and backoff sleeps
happen strictly OUTSIDE the lock (RC4): a probe in its retry ladder
must not stall every other thread's health bookkeeping.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

from arrow_matrix_tpu_torch.faults.policy import RetryPolicy
from arrow_matrix_tpu_torch.fleet import wire
from arrow_matrix_tpu_torch.sync import guarded_by, witnessed


@dataclasses.dataclass
class WorkerHealth:
    """The monitor's per-worker verdict + evidence."""

    worker_id: str
    alive: bool = True
    consecutive_failures: int = 0
    last_ok_s: Optional[float] = None
    last_error: Optional[str] = None
    declared_dead_s: Optional[float] = None
    readmissions: int = 0
    readmitted_s: Optional[float] = None

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@guarded_by("_lock", node="health_monitor", attrs=("state",),
            callbacks=("sleep",))
class HealthMonitor:
    """Heartbeat prober over the fleet wire protocol.

    ``probe(worker_id, host, port)`` performs up to ``max_failures``
    bounded heartbeat attempts, sleeping the worker's OWN jittered
    backoff between them, and returns the updated
    :class:`WorkerHealth`.  ``clock``/``sleep`` are injectable so the
    unit tests drive the retry ladder deterministically without wall
    time.
    """

    def __init__(self, *, policy: Optional[RetryPolicy] = None,
                 timeout_s: float = 5.0, max_failures: int = 3,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, got "
                             f"{max_failures}")
        self.policy = policy or RetryPolicy(backoff_s=0.05,
                                            jitter=0.5)
        self.timeout_s = float(timeout_s)
        self.max_failures = int(max_failures)
        self.clock = clock
        self.sleep = sleep
        self._lock = witnessed("health_monitor", threading.Lock())
        self.state: Dict[str, WorkerHealth] = {}

    def _health_locked(self, worker_id: str) -> WorkerHealth:
        h = self.state.get(worker_id)
        if h is None:
            h = self.state[worker_id] = WorkerHealth(worker_id)
        return h

    def record_ok(self, worker_id: str) -> WorkerHealth:
        """Fold an out-of-band success (e.g. a completed submit) into
        the health state: any successful op is a heartbeat."""
        now = float(self.clock())
        with self._lock:
            h = self._health_locked(worker_id)
            if h.alive:
                h.consecutive_failures = 0
                h.last_ok_s = now
                h.last_error = None
            return h

    def record_failure(self, worker_id: str,
                       error: str) -> WorkerHealth:
        """Fold one failed op into the health state; flips ``alive``
        when the consecutive-failure streak reaches the limit.  The
        streak increment and the flip happen under the lock in one
        critical section — two racing failures must count as two."""
        now = float(self.clock())
        with self._lock:
            h = self._health_locked(worker_id)
            h.consecutive_failures += 1
            h.last_error = error
            if h.alive and h.consecutive_failures >= self.max_failures:
                h.alive = False
                h.declared_dead_s = now
            return h

    def heartbeat_once(self, worker_id: str, host: str,
                       port: int) -> bool:
        """One bounded heartbeat round trip; folds the outcome.  The
        wire call runs with no lock held (RC4)."""
        try:
            reply = wire.request_call(host, port, {"op": "health"},
                                      timeout_s=self.timeout_s)
            if not (isinstance(reply, dict) and reply.get("ok")):
                raise wire.WireError(f"bad heartbeat reply: "
                                     f"{str(reply)[:120]}")
        except (OSError, wire.WireError) as e:
            self.record_failure(worker_id,
                                f"{type(e).__name__}: {e}")
            return False
        self.record_ok(worker_id)
        return True

    def probe(self, worker_id: str, host: str,
              port: int) -> WorkerHealth:
        """The death-verdict ladder: retry the heartbeat up to
        ``max_failures`` times with the worker's own jittered backoff
        between attempts.  Returns the final health state — callers
        decide what to do with a dead verdict (the router requeues).
        Backoff sleeps hold no lock (RC4)."""
        policy = self.policy.for_worker(worker_id)
        h = self.record_noop(worker_id)
        for attempt in range(1, self.max_failures + 1):
            if self.heartbeat_once(worker_id, host, port):
                return h
            with self._lock:
                alive = h.alive
            if not alive:
                break
            if attempt < self.max_failures:
                self.sleep(policy.delay_s(attempt, salt="heartbeat"))
        return h

    def readmit(self, worker_id: str) -> WorkerHealth:
        """The ONE way back from a dead verdict.  Death is sticky on
        purpose — a passing heartbeat from a half-recovered process
        must never quietly resurrect it (``record_ok`` checks
        ``h.alive`` first) — so rejoining the fleet is an explicit
        operator/host decision: a new host restarted the worker and
        vouches for it.  Resets the verdict and the failure streak and
        counts the readmission, so the fleet report shows a worker
        that died and came back as exactly that, not as one that never
        died."""
        now = float(self.clock())
        with self._lock:
            h = self._health_locked(worker_id)
            h.alive = True
            h.consecutive_failures = 0
            h.last_error = None
            h.declared_dead_s = None
            h.readmissions += 1
            h.readmitted_s = now
        try:
            from arrow_matrix_tpu_torch.obs import flight

            flight.record("fleet", "worker_readmitted",
                          worker=worker_id,
                          readmissions=h.readmissions)
        except Exception:  # graft-lint: disable=R8 — telemetry
            pass
        return h

    def record_noop(self, worker_id: str) -> WorkerHealth:
        """Materialize (without modifying) the worker's health entry."""
        with self._lock:
            return self._health_locked(worker_id)

    def alive_workers(self) -> list:
        with self._lock:
            return sorted(w for w, h in self.state.items() if h.alive)

    def dead_workers(self) -> list:
        with self._lock:
            return sorted(w for w, h in self.state.items()
                          if not h.alive)

    def snapshot(self) -> dict:
        with self._lock:
            return {w: h.snapshot()
                    for w, h in sorted(self.state.items())}

"""Request and ticket model of the serving runtime.

The port's copy of ``arrow_matrix_tpu/serve/request.py`` (numpy and
the stdlib).  A :class:`Request` is what a tenant hands the server:
host features in original row order, an iteration count, an optional
deadline and a traffic class.  A :class:`Ticket` is what the server
hands back at once; the request's life (admission, queueing,
execution, recovery, completion) is recorded on it, and every ticket
reaches exactly one terminal state: a shed or rejected request is told
so, never silently dropped.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

#: Ticket states.  pending -> admitted -> running -> one of the
#: terminal states; rejected/shed may be assigned straight from
#: pending (admission control / queue overflow / expired deadline).
PENDING = "pending"
ADMITTED = "admitted"
RUNNING = "running"
COMPLETED = "completed"
FAILED = "failed"
SHED = "shed"
REJECTED = "rejected"

TERMINAL = frozenset({COMPLETED, FAILED, SHED, REJECTED})


@dataclasses.dataclass
class Request:
    """One tenant request: iterate ``X := A @ X`` ``iterations`` times
    over the server's resident operator, starting from the tenant's
    ``x`` (host ``(n, k)`` array, original row order).

    ``deadline_s`` is a relative budget from submission: a request
    still queued past its deadline is shed explicitly at dequeue time
    (running work is governed by the watchdog, not the deadline).
    """

    request_id: str
    tenant: str
    x: np.ndarray
    iterations: int
    deadline_s: Optional[float] = None
    # The accuracy class the tenant is asking for (classes.py).
    # "exact" (default) is f32 bit-identity, today's contract; "approx"
    # asks for certified reduced-precision carriage — granted only when
    # the server holds a covering certificate for this iteration count,
    # otherwise served exact with a loud class_fallback event.
    traffic_class: str = "exact"

    @property
    def k(self) -> int:
        return int(self.x.shape[1])


class Ticket:
    """The server's receipt for one request; thread-safe to wait on."""

    def __init__(self, request: Request):
        self.request = request
        self.status = PENDING
        self.reason: Optional[str] = None
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.predicted_bytes = 0      # admission price (reserved HBM)
        self.submitted_s: Optional[float] = None
        self.latency_s: Optional[float] = None
        self.faults_seen = 0
        self.recoveries = 0
        self.attempts = 0             # executions (1 + degraded reruns)
        self.exec_config = None       # ExecConfig the result came from
        self.resumed_step: Optional[int] = None
        # The class actually served (may differ from
        # request.traffic_class on a certificate-miss fallback) and,
        # when it does differ, why — never a silent substitution.
        self.served_class: str = request.traffic_class
        self.class_fallback: Optional[str] = None
        self.certified_bound: Optional[float] = None
        # The correlation context captured at submit time
        # ({"trace_id": ...} and friends): the handoff that carries it
        # onto the batch worker thread.
        self.trace: Optional[dict] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self.status in TERMINAL

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the ticket reaches a terminal state."""
        return self._done.wait(timeout)

    def _finish(self, status: str, reason: Optional[str] = None,
                error: Optional[str] = None) -> None:
        assert status in TERMINAL, status
        self.status = status
        self.reason = reason
        self.error = error
        if self.submitted_s is not None:
            self.latency_s = time.monotonic() - self.submitted_s
        self._done.set()

    def summary(self) -> dict:
        return {
            "request_id": self.request.request_id,
            "tenant": self.request.tenant,
            "k": self.request.k,
            "iterations": self.request.iterations,
            "status": self.status,
            "reason": self.reason,
            "traffic_class": self.request.traffic_class,
            "served_class": self.served_class,
            "class_fallback": self.class_fallback,
            "certified_bound": self.certified_bound,
            "predicted_bytes": self.predicted_bytes,
            "latency_s": self.latency_s,
            "faults_seen": self.faults_seen,
            "recoveries": self.recoveries,
            "attempts": self.attempts,
        }

"""The serving scheduler: an always-on, multi-tenant SpMM server.

The port's copy of ``arrow_matrix_tpu/serve/scheduler.py``.  One
decomposed operator stays resident on the card while tenants' requests
(iterate ``X := A @ X`` from their own X) run over it:

  * **admission control** — every request is priced against the live
    HBM accountant (serve/admission.py) before it is queued; a request
    over budget is rejected explicitly, and a full bounded queue sheds
    explicitly: no silent drops.
  * **request-level supervision** — each batch runs under a fresh
    :class:`~arrow_matrix_tpu_torch.faults.Supervisor` stamped from the
    server's one :class:`~arrow_matrix_tpu_torch.faults.RetryPolicy`
    (watchdog, bounded retry, seeded backoff jitter), with a
    per-request checkpoint path: a killed server resumes every
    in-flight request from its last sha256-verified checkpoint.
  * **graceful degradation** — repeated faults on a tenant's requests
    walk that tenant down the ladder kernel "pallas_sell" -> "xla"
    (K1 with a plan's knobs -> K1 at its defaults), repl=c -> 1,
    overlap S -> 1 (:func:`degradation_ladder`, the JAX order) instead
    of failing it; only a tenant already on the last rung can fail.
    Every rung keeps the bits of a plan whose knobs keep the sum
    order.
  * **dynamic batching** — compatible queued requests (same effective
    configuration, same iteration count) are concatenated along the
    feature axis and split back after the run.  SpMM is separable per
    feature column and K1 sums every output element in an order fixed
    by the operator alone (``ops/worklist.py``), so each request's
    slice of a batched result equals its run alone bit for bit; so do
    the ``repl``/``overlap_slabs`` rungs against ``repl=1``.

Determinism: with a deterministic trace (serve/loadgen.py) and the
synchronous ``drain()`` mode, the admission census and every completed
request's result bytes replay identically.

Live telemetry: :meth:`ArrowServer.attach_pulse` feeds every serve
event to a :class:`~arrow_matrix_tpu_torch.obs.pulse.PulseMonitor`, and
its watchdog's SLO-burn trips walk tenants down the ladder.

Tune plans: ``tune_plan=`` (a ``TunePlan``, its dict) becomes the base
rung (its kernel, repl, overlap), its certificate joins the approx
class's admission, and the server logs ``tune_plan_applied``.

Growing: ``grow_config``/``grow_factory`` declare a grown layout (more
ranks of a mesh); :meth:`ArrowServer.grow` cuts the base rung over to
it and migrates every per-request checkpoint through a staged plan of
``parallel/reshard.py`` (host numpy, each stage a ``reshard.stage``
fault seam), idempotently on a rerun.

On a mesh of ranks (an executor with a ``mesh``, under a process group
of several ranks) the server runs in every rank of the job, and every
step is collective, so the ranks must never disagree.  Rank 0 alone
decides: it admits, batches, sheds, degrades and grows, and sends each
decision to the other ranks through ``parallel/collectives.py``
(counted); they carry it out.  Every rank submits the same requests and
builds each rung's executor once, in the same order, in its serving
thread.  A batch's supervisor shares its checkpoints and the outcome
of every step over the executor's mesh.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from arrow_matrix_tpu_torch.classes import (
    TRAFFIC_CLASSES,
    Certificate,
    class_itemsize,
    find_certificate,
)
from arrow_matrix_tpu_torch.faults import RetryPolicy, Supervisor
from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.obs.comm import hbm_budget_bytes as _budget
from arrow_matrix_tpu_torch.obs.memview import predicted_bytes_for
from arrow_matrix_tpu_torch.serve import request as rq
from arrow_matrix_tpu_torch.serve.admission import (
    HBMAccountant,
    ServeCapacityError,
    request_price_bytes,
)
from arrow_matrix_tpu_torch.sync import guarded_by, witnessed
from arrow_matrix_tpu_torch.utils.checkpoint import CheckpointIntegrityError


#: Seconds rank 0 of an idle mesh server waits before it sends the
#: other ranks a decision to do nothing (their receive stays far under
#: the group's timeout).
MESH_HEARTBEAT_S = 1.0


def _world() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _rank() -> int:
    import torch.distributed as dist

    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """One rung of the execution ladder: the knobs graceful degradation
    can trade away (the JAX package's fused kernel, column replication
    ``repl``, overlap sub-slabs ``overlap_slabs``) without changing the
    result's row order or the carriage layout, so a degraded rerun
    resumes the same checkpoints.  The port's executors take
    ``kernel`` "xla" (K1 at its defaults) or "pallas_sell" (K1 with a
    plan's knobs); the ladder steps "pallas_sell" down to "xla" first.

    ``feature_dtype`` is NOT a degradation knob: it is
    the carriage dtype of the traffic class a request is served under
    (None = f32 exact, "bf16" = certified approx), constant along a
    ticket's ladder walk.  It lives here because it is part of the
    executor cache key — an approx batch must never share an executor
    (or a batch) with an exact one."""

    kernel: str = "xla"
    repl: int = 1
    overlap_slabs: int = 1
    feature_dtype: Optional[str] = None

    def accepts_k(self, k: int) -> bool:
        """Whether a feature width is schedulable under this config
        (c | k and S | k/c)."""
        if k <= 0 or k % self.repl:
            return False
        return (k // self.repl) % self.overlap_slabs == 0


def degradation_ladder(base: ExecConfig) -> Tuple[ExecConfig, ...]:
    """Cumulative degradation rungs from ``base`` down to the c=1 S=1
    executor: a fused kernel first (cheapest to give up; the JAX
    package's), then replication, then overlap — the JAX order."""
    rungs = [base]
    cur = base
    if cur.kernel != "xla":
        cur = dataclasses.replace(cur, kernel="xla")
        rungs.append(cur)
    if cur.repl > 1:
        cur = dataclasses.replace(cur, repl=1)
        rungs.append(cur)
    if cur.overlap_slabs > 1:
        cur = dataclasses.replace(cur, overlap_slabs=1)
        rungs.append(cur)
    return tuple(rungs)


class _Tenant:
    __slots__ = ("rung", "fault_score", "degradations",
                 "allow_approx", "class_degraded")

    def __init__(self):
        self.rung = 0
        self.fault_score = 0
        self.degradations: List[dict] = []
        # exact -> approx is one more (opt-in) rung
        # below the terminal config rung; never taken silently.
        self.allow_approx = False
        self.class_degraded = False


@guarded_by(
    "_lock", node="arrow_server", aliases=("_cond",),
    callbacks=("_factory",),
    attrs=("_queue", "_counts", "_executors", "_tenants",
           "_latencies_s", "_tenant_latencies_s",
           "_class_latencies_s", "batches", "batched_requests",
           "faults_seen", "recoveries", "checkpoint_corruptions",
           "checkpoints_resharded", "_grown", "grows", "_outbox",
           "_stop"))
class ArrowServer:
    """Long-lived multi-tenant server over one resident arrow operator.

    ``executor_factory(config: ExecConfig)`` builds an executor
    (``set_features`` / ``step`` / ``gather_result`` plus the HBM model
    ``predicted_hbm_bytes`` / ``carriage_hbm_bytes``) for one ladder
    rung; executors are built lazily and cached — the base rung is
    built eagerly so the resident operator is charged before the first
    request.  The HBM budget defaults to the base executor's device's
    (``obs/comm.hbm_budget_bytes``).

    Two execution modes share all logic: ``start()`` spawns a worker
    thread (the always-on deployment; ``shutdown(wait=True)`` drains
    the queue first), while ``drain()`` processes synchronously in the
    caller's thread — the deterministic mode every test and gate uses.
    """

    def __init__(self, executor_factory: Callable[[ExecConfig], Any],
                 base_config: ExecConfig = ExecConfig(), *,
                 hbm_budget_bytes: Optional[int] = None,
                 queue_capacity: int = 64,
                 policy: Optional[RetryPolicy] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 2,
                 max_batch_k: int = 0,
                 degrade_after: int = 2,
                 itemsize: int = 4,
                 registry=None,
                 tracer=None,
                 name: str = "serve",
                 verbose: bool = False,
                 tune_plan=None,
                 certificates=None,
                 structure_hash: Optional[str] = None,
                 cert_ledger_dir: Optional[str] = None,
                 approx_opt_in=(),
                 grow_config: Optional[ExecConfig] = None,
                 grow_factory: Optional[
                     Callable[[ExecConfig], Any]] = None,
                 reshard_budget_bytes: int = 1 << 20):
        # A cached TunePlan becomes the base rung: admitted requests run
        # its kernel/repl/overlap at no search cost, and the ladder
        # below steps each tuned knob back down under pressure.  The
        # factory sees the tuned ExecConfig like any rung; factories
        # that consume the plan's structural knobs and K1's knobs take
        # ``plan=`` themselves (serve/loadgen.ba_executor_factory).
        self.tune_plan = None
        if tune_plan is not None:
            from arrow_matrix_tpu_torch.tune.plan import resolve_plan

            resolved = resolve_plan(tune_plan)
            if resolved is not None:
                self.tune_plan = resolved
                base_config = resolved.exec_config()
        if base_config.feature_dtype is not None:
            # The BASE rung serves the exact class; a carriage dtype
            # on it is a class
            # property, applied per ticket by _effective_config, never
            # a default every tenant silently inherits.
            base_config = dataclasses.replace(base_config,
                                              feature_dtype=None)
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, got "
                             f"{queue_capacity}")
        self.name = name
        self.verbose = verbose
        self.registry = registry
        self.tracer = tracer
        self.pulse = None   # a PulseMonitor, via attach_pulse()
        self.policy = policy or RetryPolicy()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.queue_capacity = int(queue_capacity)
        self.max_batch_k = int(max_batch_k)
        self.degrade_after = max(int(degrade_after), 1)
        self.itemsize = int(itemsize)
        self._factory = executor_factory
        self.base_config = base_config
        self.ladder = degradation_ladder(base_config)
        # The approx class serves bf16 carriage only (the int8
        # (q, scale) carriage has no checkpoint form), and only for
        # structures holding a covering certificate: passed explicitly,
        # or found in the ledger by structure hash.
        self.approx_dtype = "bf16"
        self._certificates: Dict[str, Certificate] = {}
        certs = certificates or ()
        if isinstance(certs, dict):   # {dtype: cert} or an iterable
            certs = certs.values()
        for c in certs:
            cert = (c if isinstance(c, Certificate)
                    else Certificate.from_dict(dict(c)))
            self._certificates[cert.dtype] = cert
        if self.tune_plan is not None and self.tune_plan.certificate:
            cert = Certificate.from_dict(self.tune_plan.certificate)
            self._certificates.setdefault(cert.dtype, cert)
        shash = structure_hash or (self.tune_plan.structure_hash
                                   if self.tune_plan else None)
        if shash and cert_ledger_dir is not None \
                and self.approx_dtype not in self._certificates:
            cert = find_certificate(shash, self.approx_dtype,
                                    ledger_dir=cert_ledger_dir)
            if cert is not None:
                self._certificates[cert.dtype] = cert
        self._executors: Dict[ExecConfig, Any] = {}
        self._tenants: Dict[str, _Tenant] = {}
        for t in approx_opt_in or ():
            self._tenant(t).allow_approx = True
        self._queue: collections.deque = collections.deque()
        # The worker thread, N submitter threads and the flight
        # observers all meet on this one RLock; _cond is an alias view
        # of it (declared on the contract) so a ``with self._cond:``
        # region counts as holding ``_lock``.
        self._lock = witnessed("arrow_server", threading.RLock())
        self._cond = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._counts = collections.Counter()
        self._latencies_s: List[float] = []
        self._tenant_latencies_s: Dict[str, List[float]] = {}
        self._class_latencies_s: Dict[str, List[float]] = {}
        self.batches = 0
        self.batched_requests = 0
        self.faults_seen = 0
        self.recoveries = 0
        self.checkpoint_corruptions = 0
        # The grow direction: a declared target (a config and/or a
        # factory of the grown layout, e.g. more ranks) that
        # note_slo_pressure can cut over to without a cold restart,
        # migrating checkpoints through staged plans whose per-stage
        # scratch is at most ``reshard_budget_bytes``.
        self.grow_config = grow_config
        self.grow_factory = grow_factory
        self.reshard_budget_bytes = int(reshard_budget_bytes)
        self._grown: Optional[Tuple[Any, ExecConfig]] = None
        self.grows = 0
        self.checkpoints_resharded = 0
        base = self._build_executor(base_config)
        # On a mesh of ranks: rank 0 decides, the others follow (module
        # docstring); tickets rank 0 finishes outside a batch wait in
        # ``_outbox`` for its next decision.
        self.mesh = getattr(base, "mesh", None)
        self.lockstep = self.mesh is not None and _world() > 1
        self.leader = not self.lockstep or _rank() == 0
        self._outbox: List[list] = []
        self._pending_grow: Optional[str] = None
        #: The device the executors run on (None for an executor that
        #: does not say); the pulse monitor's ledger record names it.
        self.device = getattr(base, "device", None)
        if hbm_budget_bytes is None:
            hbm_budget_bytes = _budget(None, device=self.device)
        self.accountant = HBMAccountant(hbm_budget_bytes,
                                        registry=registry, name=name)
        resident = predicted_bytes_for(base, 0, itemsize=self.itemsize,
                                       repl=base_config.repl) or 0
        self.accountant.charge_resident(resident)
        self._event("started", resident_bytes=resident,
                    budget_bytes=self.accountant.budget_bytes,
                    ladder=[dataclasses.asdict(c) for c in self.ladder])
        if self._certificates:
            self._event("certificates_loaded",
                        structure_hash=shash,
                        certificates={
                            dt: {"iterations": c.iterations,
                                 "tolerance": c.tolerance,
                                 "bound": c.bound_at(c.iterations)}
                            for dt, c in
                            sorted(self._certificates.items())})
        if self.tune_plan is not None:
            self._event("tune_plan_applied",
                        structure_hash=self.tune_plan.structure_hash,
                        candidate=self.tune_plan.candidate,
                        k=self.tune_plan.k,
                        measured_ms=self.tune_plan.measured_ms,
                        margin=self.tune_plan.margin,
                        base_config=dataclasses.asdict(base_config))

    # -- plumbing ----------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.verbose and self.leader:
            print(f"[graft-serve {self.name}] {msg}", flush=True)

    def _say(self, msg: str) -> None:
        """A line printed whatever the verbosity (the gates grep it),
        once a job: by rank 0 on a mesh."""
        if self.leader:
            print(f"[graft-serve {self.name}] {msg}", flush=True)

    def _event(self, event: str, **data) -> None:
        """The one serve-event funnel: the flight recorder gets every
        event, and so does the streaming telemetry when a PulseMonitor
        is attached."""
        flight.record("serve", event, server=self.name, **data)
        if self.pulse is not None:
            try:
                self.pulse.observe(event, **data)
            except Exception:  # graft-lint: disable=R8 — telemetry
                # must never take down the server it observes.
                pass

    def _span(self, name: str, **attrs):
        """A tracer span when a tracer is attached, else a no-op (the
        request context stamps request_id/tenant onto the span)."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **attrs)

    def _count(self, what: str, tenant: Optional[str] = None,
               klass: Optional[str] = None, **labels) -> None:
        # Counter.__iadd__ is read-modify-write: two unlocked bumps
        # from the worker and a submitter can lose one (RC1).  The
        # registry dispatch stays outside the critical section.
        with self._lock:
            self._counts[what] += 1
            if tenant is not None:
                self._counts[f"{what}:{tenant}"] += 1
            if klass is not None:
                self._counts[f"{what}:class:{klass}"] += 1
        if self.registry is not None:
            lb = dict(labels)
            if tenant is not None:
                lb["tenant"] = tenant
            if klass is not None:
                lb["traffic_class"] = klass
            self.registry.counter(f"serve_{what}", server=self.name,
                                  **lb).inc()

    def _tenant(self, tenant: str) -> _Tenant:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _Tenant()
        return t

    def _build_executor(self, cfg: ExecConfig):
        with self._lock:
            ex = self._executors.get(cfg)
        if ex is None:
            # The factory is a user callback — it compiles kernels and
            # can take seconds, so it runs with NO lock held (RC3).
            # Two racing builders both build; the first to publish
            # wins and the loser's executor is dropped.
            built = self._factory(cfg)
            with self._lock:
                ex = self._executors.setdefault(cfg, built)
        return ex

    def _effective_config(self, ticket: rq.Ticket) -> ExecConfig:
        """The ladder rung this ticket runs on: its tenant's current
        rung, or the terminal rung when the request's feature width
        fails the rung's divisibility contract (repl/overlap need
        c | k and S | k/c; the terminal rung accepts every k).
        Approx-served tickets get the class carriage dtype stamped on
        the rung — a distinct executor cache key, so exact and approx
        never share a compiled step or a batch."""
        tenant = self._tenant(ticket.request.tenant)
        cfg = self.ladder[tenant.rung]
        if not cfg.accepts_k(ticket.request.k):
            cfg = self.ladder[-1]
        if ticket.served_class == "exact" and tenant.class_degraded:
            # Opt-in class degradation (never silent): the tenant
            # consented via approx_opt_in and its ladder is exhausted.
            cert = self._certificates.get(self.approx_dtype)
            if cert is not None and cert.covers(
                    ticket.request.iterations):
                ticket.served_class = "approx"
                ticket.class_fallback = "degraded_opt_in"
                ticket.certified_bound = cert.bound_at(
                    ticket.request.iterations)
                self._event("class_degraded_applied",
                            request=ticket.request.request_id,
                            tenant=ticket.request.tenant,
                            traffic_class="approx",
                            certified_bound=ticket.certified_bound)
        if ticket.served_class == "approx":
            cfg = dataclasses.replace(cfg,
                                      feature_dtype=self.approx_dtype)
        return cfg

    def _resolve_class(self, request: rq.Request):
        """Admission-time class decision: ``(served_class,
        fallback_reason, certificate)``.  An approx request without a
        covering certificate is served EXACT — the loud fallback the
        class contract promises (never silent approx)."""
        if request.traffic_class == "exact":
            return "exact", None, None
        cert = self._certificates.get(self.approx_dtype)
        if cert is None:
            return "exact", "no_certificate", None
        if not cert.covers(request.iterations):
            reason = ("curve_shorter_than_request"
                      if cert.bound_at(request.iterations) is None
                      else "certified_bound_exceeds_tolerance")
            return "exact", reason, None
        return "approx", None, cert

    # -- admission ---------------------------------------------------------

    def submit(self, request: rq.Request) -> rq.Ticket:
        """Admission-control one request: price, reserve, enqueue —
        or reject (HBM) / shed (queue overflow) explicitly.  Returns
        the ticket immediately; it resolves when processed.

        The whole admission path runs inside the request's correlation
        context, so the shed/reject/admit events and the ``admission``
        span all carry its ``request_id``/``tenant``."""
        with flight.request_context(request.request_id, request.tenant), \
                self._span("admission", k=request.k,
                           iterations=request.iterations):
            return self._submit(request)

    def _submit(self, request: rq.Request) -> rq.Ticket:
        ticket = rq.Ticket(request)
        ticket.submitted_s = time.monotonic()
        if not self.leader:
            return self._submit_follower(ticket)
        # Keep the submit-time correlation context (trace_id and
        # friends) on the ticket: _process_batch runs on the worker
        # thread, where the submitting thread's contextvars are out of
        # reach — the ticket is the handoff.
        ctx = flight.current_request()
        ticket.trace = dict(ctx) if ctx else None
        self._count("submitted", request.tenant)
        if request.traffic_class not in TRAFFIC_CLASSES:
            self._end(
                ticket, rq.REJECTED, reason="unknown_class",
                error=f"unknown traffic class "
                      f"{request.traffic_class!r} (expected one of "
                      f"{TRAFFIC_CLASSES})")
            self._count("rejected", request.tenant,
                        reason="unknown_class")
            self._event("rejected", request=request.request_id,
                        tenant=request.tenant, reason="unknown_class",
                        traffic_class=request.traffic_class)
            return ticket
        served, fallback, cert = self._resolve_class(request)
        ticket.served_class = served
        ticket.class_fallback = fallback
        if cert is not None:
            ticket.certified_bound = cert.bound_at(request.iterations)
        if fallback is not None:
            self._count("class_fallback", request.tenant,
                        reason=fallback)
            self._event("class_fallback", request=request.request_id,
                        tenant=request.tenant,
                        requested_class=request.traffic_class,
                        traffic_class=served, reason=fallback)
            self._log(f"class fallback {request.request_id}: "
                      f"approx -> exact ({fallback})")
        # Approx carriage is priced at its TRUE (smaller) itemsize —
        # the admitted-requests-per-GB lever the class exists for.
        itemsize = (class_itemsize(self.approx_dtype)
                    if served == "approx" else self.itemsize)
        price = request_price_bytes(
            self._build_executor(self.base_config), request.k,
            itemsize=itemsize, repl=self.base_config.repl)
        ticket.predicted_bytes = price
        with self._cond:
            if self._stop:
                self._end(ticket, rq.SHED, reason="server_stopped")
                self._count("shed", request.tenant,
                            reason="server_stopped")
                self._event("shed", request=request.request_id,
                            tenant=request.tenant,
                            reason="server_stopped")
                return ticket
            if not self.accountant.reserve(price):
                self._end(
                    ticket, rq.REJECTED, reason="hbm_budget",
                    error=f"predicted {price} B exceeds remaining HBM "
                          f"headroom "
                          f"{self.accountant.headroom_bytes()} B")
                self._count("rejected", request.tenant,
                            klass=ticket.served_class,
                            reason="hbm_budget")
                self._event("rejected", request=request.request_id,
                            tenant=request.tenant, reason="hbm_budget",
                            traffic_class=ticket.served_class,
                            predicted_bytes=price,
                            headroom_bytes=self.accountant
                            .headroom_bytes())
                self._log(f"rejected {request.request_id} "
                          f"(hbm_budget: {price} B over headroom)")
                return ticket
            if len(self._queue) >= self.queue_capacity:
                self.accountant.release(price)
                self._end(
                    ticket, rq.SHED, reason="queue_full",
                    error=f"queue at capacity {self.queue_capacity}")
                self._count("shed", request.tenant,
                            reason="queue_full")
                self._event("shed", request=request.request_id,
                            tenant=request.tenant, reason="queue_full",
                            queue_depth=len(self._queue))
                self._log(f"shed {request.request_id} (queue_full)")
                return ticket
            ticket.status = rq.ADMITTED
            self._queue.append(ticket)
            self._count("admitted", request.tenant,
                        klass=ticket.served_class)
            self._event("admitted", request=request.request_id,
                        tenant=request.tenant, k=request.k,
                        predicted_bytes=price,
                        traffic_class=ticket.served_class,
                        queue_depth=len(self._queue))
            self._cond.notify_all()
        return ticket

    def _end(self, ticket: rq.Ticket, status: str,
             reason: Optional[str] = None,
             error: Optional[str] = None) -> None:
        """Finish a ticket outside a completed batch; on a mesh rank 0
        relays it, and the other ranks finish their copy alike."""
        ticket._finish(status, reason=reason, error=error)
        if self.lockstep and self.leader:
            with self._lock:
                self._outbox.append([ticket.request.request_id, status,
                                     reason, error])

    # -- the ranks of a mesh -------------------------------------------------

    def _submit_follower(self, ticket: rq.Ticket) -> rq.Ticket:
        """A rank other than 0 queues the request as rank 0's copy will
        be admitted or refused: rank 0's decisions finish it."""
        ticket.predicted_bytes = 0
        ticket.status = rq.ADMITTED
        with self._cond:
            self._queue.append(ticket)
            self._cond.notify_all()
        return ticket

    def _take_by_id(self, request_id: str,
                    timeout_s: float = 300.0) -> rq.Ticket:
        """The queued ticket of ``request_id`` (a follower waits for its
        own submission of it)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                for t in self._queue:
                    if t.request.request_id == request_id:
                        self._queue.remove(t)
                        return t
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"rank 0 decided on request {request_id}, which "
                        f"this rank has not been given: every rank of a "
                        f"mesh server submits the same requests")
                self._cond.wait(min(left, 0.05))

    def _decide(self, op: str, batch=(), cfg=None) -> dict:
        """Rank 0's decision, sent to every rank (and returned)."""
        from arrow_matrix_tpu_torch.parallel import collectives as coll

        with self._lock:
            finished, self._outbox = self._outbox, []
            grow, self._pending_grow = self._pending_grow, None
        msg = {"op": op, "finish": finished, "grow": grow,
               "run": [t.request.request_id for t in batch],
               "cfg": None if cfg is None else dataclasses.asdict(cfg)}
        return coll.broadcast_object(msg)

    def _follow(self) -> str:
        """A follower's turn: receive rank 0's decision and carry it
        out; returns its op ("batch", "idle" or "end")."""
        from arrow_matrix_tpu_torch.parallel import collectives as coll

        msg = coll.broadcast_object(None)
        self._apply(msg)
        if msg["op"] == "batch":
            batch = [self._take_by_id(rid) for rid in msg["run"]]
            self._process_batch(batch, ExecConfig(**msg["cfg"]))
        return msg["op"]

    def _apply(self, msg: dict) -> None:
        """The parts of a decision every rank carries out before its
        batch: the tickets rank 0 finished, and a grow."""
        if not self.leader:
            for rid, status, reason, error in msg["finish"]:
                self._take_by_id(rid)._finish(status, reason=reason,
                                              error=error)
        if msg["grow"] is not None:
            self._grow(msg["grow"])

    # -- scheduling --------------------------------------------------------

    def _shed_expired(self, ticket: rq.Ticket) -> bool:
        dl = ticket.request.deadline_s
        if dl is None or ticket.submitted_s is None:
            return False
        if time.monotonic() - ticket.submitted_s <= dl:
            return False
        self.accountant.release(ticket.predicted_bytes)
        self._end(ticket, rq.SHED, reason="deadline",
                  error=f"queued past the {dl:.3f}s deadline")
        self._count("shed", ticket.request.tenant, reason="deadline")
        self._event("shed", request=ticket.request.request_id,
                    tenant=ticket.request.tenant, reason="deadline")
        self._log(f"shed {ticket.request.request_id} (deadline)")
        return True

    def _take_batch(self) -> Tuple[List[rq.Ticket],
                                   Optional[ExecConfig]]:
        """Pop the head request plus every compatible queued request
        (same effective config + iteration count, combined width under
        ``max_batch_k`` and schedulable) — FIFO, deterministic."""
        with self._lock:
            head: Optional[rq.Ticket] = None
            while self._queue:
                t = self._queue.popleft()
                if self._shed_expired(t):
                    continue
                head = t
                break
            if head is None:
                return [], None
            cfg = self._effective_config(head)
            batch = [head]
            k_total = head.request.k
            if self.max_batch_k > k_total:
                keep: List[rq.Ticket] = []
                for t in list(self._queue):
                    k2 = t.request.k
                    # Class separation: config equality already
                    # differs on feature_dtype, but the served-class
                    # check is the explicit contract — a batch never
                    # mixes accuracy classes.
                    if (t.request.iterations == head.request.iterations
                            and self._effective_config(t) == cfg
                            and t.served_class == head.served_class
                            and k_total + k2 <= self.max_batch_k
                            and cfg.accepts_k(k_total + k2)
                            and not self._shed_expired(t)):
                        batch.append(t)
                        k_total += k2
                    elif not t.done:
                        keep.append(t)
                self._queue = collections.deque(keep)
            return batch, cfg

    def _pump_once(self, last_op: str = "end") -> bool:
        """One batch, or nothing when the queue is empty.  On a mesh:
        rank 0 decides and sends its decision (``last_op`` when there is
        no batch); another rank follows one decision and returns whether
        it was a batch."""
        if not self.leader:
            return self._follow() == "batch"
        batch, cfg = self._take_batch()
        if self.lockstep:
            self._apply(self._decide("batch" if batch else last_op,
                                     batch, cfg))
        if not batch:
            return False
        self._process_batch(batch, cfg)
        return True

    def drain(self) -> None:
        """Synchronously process the queue to empty in the caller's
        thread (the deterministic test/gate mode).  On a mesh every rank
        calls it: rank 0's queue decides when it ends."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "drain() is the synchronous mode; a worker thread is "
                "already running — use shutdown(wait=True)")
        if self.leader:
            while self._pump_once():
                pass
            return
        while self._follow() != "end":
            pass

    def start(self) -> None:
        """Spawn the always-on worker thread."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._serve_loop, daemon=True,
                name=f"graft-serve-{self.name}")
            self._thread.start()

    def _serve_loop(self) -> None:
        if not self.leader:
            while self._follow() != "end":
                pass
            return
        while True:
            idle_since = time.monotonic()
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(0.05)
                    if (self.lockstep and time.monotonic() - idle_since
                            > MESH_HEARTBEAT_S):
                        break
                stop = self._stop and not self._queue
            if self.lockstep and (stop or not self._queue):
                # Idle: a heartbeat keeps the other ranks' receive under
                # their group's timeout; the last decision ends them.
                self._decide("end" if stop else "idle")
            if stop:
                return
            if not self._queue:
                continue
            try:
                self._pump_once(last_op="idle")
            except Exception as e:  # noqa: BLE001 — the serving loop
                # must survive anything a batch throws; the batch's
                # tickets were already failed explicitly.
                self._log(f"worker survived unexpected error: "
                          f"{type(e).__name__}: {e}")

    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Graceful stop: the worker finishes the queued requests,
        then exits; later submissions are shed explicitly."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if wait and t is not None:
            t.join(timeout)
        self._event("stopped")

    # -- execution ---------------------------------------------------------

    def _executor_for(self, cfg: ExecConfig):
        """Build (or fetch) the executor for a rung, walking further
        down the ladder when a rung's build itself fails; returns
        ``(executor, actual_cfg)`` or ``(None, cfg)``."""
        with self._lock:
            grown = self._grown
        if grown is not None and cfg in (self.base_config, grown[1]):
            # After a grow, base-rung traffic runs the grown layout (its
            # checkpoints were migrated); degraded rungs and
            # class-stamped configs keep their own executors.
            return grown
        if cfg in self.ladder:
            rungs = list(self.ladder[self.ladder.index(cfg):])
        else:
            # A class-stamped rung (feature_dtype set by
            # _effective_config) is not a ladder member: try it
            # first, and only degrade into the exact ladder — losing
            # the carriage dtype, loudly, via rung_build_failed —
            # when the class rung itself cannot build.
            rungs = [cfg] + list(self.ladder)
        for rung in rungs:
            try:
                return self._build_executor(rung), rung
            except Exception as e:  # noqa: BLE001 — a rung that cannot
                # build is one more thing to degrade past, loudly.
                self._log(f"rung {rung} failed to build "
                          f"({type(e).__name__}: {e}); degrading")
                self._event("rung_build_failed",
                            config=dataclasses.asdict(rung),
                            error=f"{type(e).__name__}: {e}")
        return None, cfg

    def _ck_path(self, key: str) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        import os

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        return os.path.join(self.checkpoint_dir, f"ck_{key}")

    def _discard_checkpoint(self, path: str, key: str,
                            err: Exception) -> None:
        import os

        with self._lock:
            self.checkpoint_corruptions += 1
        self._count("checkpoint_corrupt")
        self._event("checkpoint_corrupt_discarded", request=key,
                    path=path, error=f"{type(err).__name__}: {err}")
        print(f"[graft-serve {self.name}] WARNING: discarding "
              f"unusable checkpoint for request {key}: {err}",
              flush=True)
        for p in (path + ".npz", path + ".npz.sha256",
                  path + ".meta.json"):
            try:
                os.remove(p)
            except OSError:
                pass

    def _process_batch(self, batch: List[rq.Ticket],
                       cfg: ExecConfig) -> None:
        """Run one batch inside its correlation context: the batched
        key ``"r0001+r0002"`` names every member request, so each
        member's spans/events are recoverable from one Perfetto track
        (membership in the joined key)."""
        key = "+".join(t.request.request_id for t in batch)
        tenants = sorted({t.request.tenant for t in batch})
        tenant = "+".join(tenants)
        # Rejoin the members' trace ids on this worker thread
        # (class-pure batches of one make the join a single id).
        trace_ids = sorted({(t.trace or {}).get("trace_id")
                            for t in batch
                            if (t.trace or {}).get("trace_id")})
        with flight.request_context(
                key, tenant,
                trace_id="+".join(trace_ids) if trace_ids else None), \
                self._span("batch", requests=len(batch),
                           k_total=sum(t.request.k for t in batch),
                           iterations=batch[0].request.iterations,
                           traffic_class=batch[0].served_class,
                           config=dataclasses.asdict(cfg)):
            self._run_batch(batch, cfg, key)

    def _run_batch(self, batch: List[rq.Ticket], cfg: ExecConfig,
                   key: str) -> None:
        iters = batch[0].request.iterations
        k_total = sum(t.request.k for t in batch)
        for t in batch:
            t.status = rq.RUNNING
            t.attempts += 1
        with self._lock:
            self.batches += 1
            self.batched_requests += len(batch)
        if self.registry is not None:
            self.registry.counter("serve_batches",
                                  server=self.name).inc()
            self.registry.record("serve_batch_k", float(k_total),
                                 server=self.name)
        executor, cfg = self._executor_for(cfg)
        if executor is None:
            self._fail_batch(batch, "no executor rung could be built")
            return
        mesh = getattr(executor, "mesh", None)
        if mesh is not None and not mesh.member:
            # A rank outside the rung's mesh holds no shard: the mesh's
            # ranks serve the batch, and this rank keeps no result.
            for t in batch:
                t.exec_config = cfg
                t._finish(rq.COMPLETED, reason="no_shard_on_this_rank")
            return
        x_cat = np.concatenate([t.request.x for t in batch], axis=1)
        ck = self._ck_path(key)
        layout = f"serve/{key}/k{k_total}/it{iters}"
        sup = Supervisor(f"{self.name}:{key}", carry=True,
                         policy=self.policy, checkpoint_path=ck,
                         checkpoint_every=(self.checkpoint_every
                                           if ck else 0),
                         layout=layout, registry=self.registry,
                         tracer=self.tracer, verbose=False,
                         mesh=getattr(executor, "mesh", None),
                         mesh_axis=getattr(executor, "axis", "blocks"))
        with self._span("set_features", k_total=k_total):
            x0 = executor.set_features(x_cat)
        start = 0
        if ck:
            try:
                st = sup.resume(x0)
            except CheckpointIntegrityError as e:
                self._discard_checkpoint(ck, key, e)
                st = None
            except Exception as e:  # noqa: BLE001 — a stale/mismatched
                # checkpoint (different batch composition, layout tag,
                # truncated file) must not wedge the server: discard
                # loudly and recompute.
                self._discard_checkpoint(ck, key, e)
                st = None
            if st is not None:
                x0, start = st
                for t in batch:
                    t.resumed_step = start
                self._event("resumed_request", request=key, step=start)
                # The chaos kill scenario greps this line in the CLI's
                # stdout; print it regardless of verbosity.
                self._say(f"resumed request {key} at iteration {start}")
        y, ok, err = None, False, None
        body = lambda x, it: executor.step(x)   # noqa: E731
        try:
            y, ok = sup.run(body, x0, start, iters)
        except CheckpointIntegrityError as e:
            # Corruption surfaced mid-run (rollback hit a corrupted
            # save): discard and recompute once from scratch.
            self._discard_checkpoint(ck or "", key, e)
            try:
                y, ok = sup.run(body, executor.set_features(x_cat), 0,
                                iters)
            except Exception as e2:  # noqa: BLE001
                err = e2
        except Exception as e:  # noqa: BLE001 — WatchdogStalled or an
            # unexpected executor error: the request fails/degrades,
            # the server survives.
            err = e
        with self._lock:
            self.faults_seen += sup.faults_seen
            self.recoveries += sup.recoveries
        for t in batch:
            t.faults_seen += sup.faults_seen
            t.recoveries += sup.recoveries
        if sup.faults_seen or sup.recoveries:
            # Surface supervised-fault pressure into the event funnel.
            self._event("supervised", request=key,
                        faults=sup.faults_seen,
                        recoveries=sup.recoveries)
        if ok:
            with self._span("finalize", requests=len(batch)):
                self._finalize_completed(batch, y, executor, cfg)
            self._note_faults(batch, sup.faults_seen)
        else:
            self._handle_failure(batch, err)

    def _note_faults(self, batch: List[rq.Ticket],
                     faults: int) -> None:
        """Accumulate recovered-fault pressure per tenant; repeated
        faults degrade the tenant's rung even when every request still
        completes (the ladder is preventive, not just reactive)."""
        if not faults:
            return
        with self._lock:
            for tenant in {t.request.tenant for t in batch}:
                self._degrade_tenant(tenant, faults,
                                     reason="repeated_faults")

    def _degrade_tenant(self, tenant: str, faults: int,
                        reason: str) -> bool:
        t = self._tenant(tenant)
        t.fault_score += faults
        if t.fault_score < self.degrade_after:
            return False
        if t.rung + 1 >= len(self.ladder):
            # One more rung exists below the terminal
            # config — exact -> approx — but ONLY for tenants that
            # opted in, and only with a certificate to serve under.
            if (t.allow_approx and not t.class_degraded
                    and self.approx_dtype in self._certificates):
                t.class_degraded = True
                t.fault_score = 0
                rec = {"tenant": tenant,
                       "from": {"traffic_class": "exact"},
                       "to": {"traffic_class": "approx",
                              "feature_dtype": self.approx_dtype},
                       "reason": f"{reason}:class_opt_in"}
                t.degradations.append(rec)
                self._count("degraded", tenant, reason=reason)
                self._event("degraded", **rec)
                self._log(f"degraded tenant {tenant} to the approx "
                          f"class ({reason}; explicit opt-in)")
                return True
            return False
        frm, t.rung = t.rung, t.rung + 1
        t.fault_score = 0
        rec = {"tenant": tenant,
               "from": dataclasses.asdict(self.ladder[frm]),
               "to": dataclasses.asdict(self.ladder[t.rung]),
               "reason": reason}
        t.degradations.append(rec)
        self._count("degraded", tenant, reason=reason)
        self._event("degraded", **rec)
        self._log(f"degraded tenant {tenant} to rung {t.rung} "
                  f"{self.ladder[t.rung]} ({reason})")
        return True

    def _handle_failure(self, batch: List[rq.Ticket],
                        err: Optional[Exception]) -> None:
        """Retries exhausted (or the attempt escalated): degrade the
        batch's tenants one rung and requeue at the FRONT; only
        tenants already on the terminal rung fail their requests —
        explicitly."""
        detail = (f"{type(err).__name__}: {err}" if err is not None
                  else "supervised run exhausted its retries")
        if not self.leader:
            # Rank 0 decides whether the batch degrades or fails; its
            # next decisions run or finish these tickets.
            with self._cond:
                for t in reversed(batch):
                    t.status = rq.ADMITTED
                    self._queue.appendleft(t)
            return
        degraded = False
        with self._lock:
            for tenant in {t.request.tenant for t in batch}:
                degraded |= self._degrade_tenant(
                    tenant, max(self.degrade_after, 1),
                    reason="request_failure")
        if degraded:
            with self._cond:
                for t in reversed(batch):
                    t.status = rq.ADMITTED
                    self._queue.appendleft(t)
                self._cond.notify_all()
            self._event("requeued_degraded",
                        requests=[t.request.request_id for t in batch],
                        error=detail)
            self._log(f"requeued {len(batch)} request(s) on a "
                      f"degraded rung after: {detail}")
            return
        self._fail_batch(batch, detail)

    def _fail_batch(self, batch: List[rq.Ticket], detail: str) -> None:
        for t in batch:
            self.accountant.release(t.predicted_bytes)
            self._end(t, rq.FAILED, reason="exhausted", error=detail)
            self._count("failed", t.request.tenant)
            self._event("failed", request=t.request.request_id,
                        tenant=t.request.tenant, error=detail)
            self._log(f"FAILED {t.request.request_id}: {detail}")

    def _finalize_completed(self, batch: List[rq.Ticket], y,
                            executor, cfg: ExecConfig) -> None:
        gathered = executor.gather_result(y)
        off = 0
        for t in batch:
            k = t.request.k
            t.result = np.ascontiguousarray(gathered[:, off:off + k])
            off += k
            t.exec_config = cfg
            self.accountant.release(t.predicted_bytes)
            t._finish(rq.COMPLETED)
            self._count("completed", t.request.tenant,
                        klass=t.served_class)
            lat_ms = (t.latency_s or 0.0) * 1e3
            with self._lock:
                self._latencies_s.append(t.latency_s or 0.0)
                self._tenant_latencies_s.setdefault(
                    t.request.tenant, []).append(t.latency_s or 0.0)
                self._class_latencies_s.setdefault(
                    t.served_class, []).append(t.latency_s or 0.0)
            if self.registry is not None:
                self.registry.record("serve_latency_ms", lat_ms,
                                     server=self.name)
                self.registry.record("serve_latency_ms", lat_ms,
                                     server=self.name,
                                     tenant=t.request.tenant)
                self.registry.record("serve_latency_ms", lat_ms,
                                     server=self.name,
                                     traffic_class=t.served_class)
            self._event("completed", request=t.request.request_id,
                        tenant=t.request.tenant,
                        traffic_class=t.served_class,
                        latency_ms=round(lat_ms, 3),
                        faults_seen=t.faults_seen)

    # -- live telemetry ----------------------------------------------------

    def attach_pulse(self, monitor) -> Any:
        """Wire a :class:`~arrow_matrix_tpu_torch.obs.pulse.PulseMonitor`
        into this server: every serve event (the :meth:`_event` funnel)
        flows into its sliding windows, HBM occupancy is sampled from the
        live accountant, its ledger record names this server's device,
        and, when the monitor carries a watchdog with no callback yet,
        SLO-burn trips feed the per-tenant degradation ladder through
        :meth:`note_slo_pressure`.  Returns the monitor."""
        from arrow_matrix_tpu_torch.ledger import device_stamp

        self.pulse = monitor
        acct = self.accountant
        monitor.hbm_sampler = lambda: (acct.in_use_bytes,
                                       acct.occupancy())
        if self.device is not None:
            monitor.device_stamp = device_stamp(self.device)
        wd = getattr(monitor, "watchdog", None)
        if wd is not None and wd.on_burn is None:
            wd.on_burn = self._on_slo_burn
        return monitor

    def _on_slo_burn(self, rule, window: dict, event: dict) -> None:
        """SloWatchdog trip callback: the tenants active in the burning
        window (all known tenants when it names none) take one forced
        ladder rung."""
        tenants = sorted((window.get("per_tenant") or {}).keys())
        self.note_slo_pressure(f"slo_burn:{rule.name}",
                               tenants=tenants or None)

    # -- measured pressure on the ladder -----------------------------------

    def note_slo_pressure(self, reason: str,
                          tenants: Optional[List[str]] = None,
                          score: Optional[int] = None,
                          direction: str = "drop") -> List[str]:
        """Feed measured SLO pressure into the degradation ladder: each
        named tenant (default: every known tenant) takes ``score``
        fault-score points (default: enough to force one rung at once).
        Returns the tenants that degraded.

        ``direction="grow"`` spends pressure the other way: the base
        rung cuts over to the declared grow target (:meth:`grow`);
        returns ``["*"]`` when it did.  On a mesh the grow is a
        collective of every rank: rank 0 sends it with its next
        decision (returning ``["*"]`` once queued), and the other ranks
        ignore pressure of their own."""
        if direction == "grow":
            if self.lockstep:
                if not self.leader or self._grown is not None:
                    return []
                with self._lock:
                    self._pending_grow = reason
                return ["*"]
            return ["*"] if self.grow(reason=reason) else []
        if direction != "drop":
            raise ValueError(f"unknown pressure direction "
                             f"{direction!r} (expected 'drop'/'grow')")
        degraded = []
        with self._lock:
            names = (list(tenants) if tenants is not None
                     else sorted(self._tenants))
            pts = self.degrade_after if score is None else int(score)
            for tenant in names:
                if self._degrade_tenant(tenant, pts, reason=reason):
                    degraded.append(tenant)
        return degraded

    # -- live elasticity: the grow direction -------------------------------

    def grow(self, reason: str = "slo_pressure") -> bool:
        """Cut the base rung over to the grown layout without a cold
        restart: build the grow target, swap the resident HBM charge,
        migrate every per-request checkpoint onto its carriage through a
        staged plan (per-stage scratch <= ``reshard_budget_bytes``;
        ``parallel/reshard.py``), then route base-rung traffic to the
        grown executor.  Idempotent: a second call (a rerun resuming
        after a kill mid-migration) migrates only the checkpoints still
        on the old layout.  Returns whether the server serves the grown
        layout afterwards.

        On a mesh it is collective: every rank calls it at the same
        point, with no worker thread running (``note_slo_pressure``
        routes a grow through rank 0's decisions instead)."""
        if self._thread is not None and self._thread.is_alive() \
                and self.lockstep:
            raise RuntimeError(
                "grow() on a mesh is a collective of every rank; with "
                "the worker thread running, use note_slo_pressure(..., "
                "direction='grow')")
        return self._grow(reason)

    def _grow(self, reason: str) -> bool:
        if self._grown is not None:
            return True
        if self.grow_config is None and self.grow_factory is None:
            self._event("grow_unavailable", reason=reason)
            self._log(f"grow requested ({reason}) but no grow target "
                      f"is declared")
            return False
        cfg = self.grow_config or self.base_config
        factory = self.grow_factory or self._factory
        new_exec, err = None, None
        try:
            new_exec = factory(cfg)
        except Exception as e:  # noqa: BLE001 — a grow target that
            # cannot build must not take the serving rung down with it.
            err = f"{type(e).__name__}: {e}"
        err = self._agreed_error(err, "the grow target failed to build")
        if err is not None:
            self._event("grow_failed", reason=reason, error=err)
            self._log(f"grow target failed to build ({err}); staying put")
            return False
        old_exec = self._build_executor(self.base_config)
        old_res = predicted_bytes_for(
            old_exec, 0, itemsize=self.itemsize,
            repl=self.base_config.repl) or 0
        new_res = predicted_bytes_for(
            new_exec, 0, itemsize=self.itemsize, repl=cfg.repl) or 0
        err = None
        try:
            self.accountant.swap_resident(old_res, new_res)
        except ServeCapacityError as e:
            err = str(e)
        if self._agreed_error(err, "the grow was refused on another "
                                   "rank") is not None:
            if err is None:       # refused elsewhere: undo the swap here
                self.accountant.swap_resident(new_res, old_res)
            self._event("grow_failed", reason=reason, error=err)
            self._log(f"grow refused: {err}")
            return False
        try:
            migrated, stages = self._migrate_on_ranks(old_exec, new_exec)
        except Exception:
            # Leave the ledger honest before surfacing the failure.
            self.accountant.swap_resident(new_res, old_res)
            raise
        with self._lock:
            self._grown = (new_exec, cfg)
            self.grows += 1
        self._event("grown", reason=reason,
                    config=dataclasses.asdict(cfg),
                    resident_bytes={"old": old_res, "new": new_res},
                    checkpoints_migrated=migrated, plan_stages=stages)
        # The reshard gate greps this line; printed whatever the
        # verbosity (like the resumed-request line).
        self._say(f"grew to {cfg} ({reason}): {migrated} checkpoint(s) "
                  f"migrated through {stages} staged plan step(s)")
        return True

    def _agreed_error(self, err: Optional[str], elsewhere: str
                      ) -> Optional[str]:
        """On a mesh, an error of any rank is every rank's (this rank's
        own text where it has one); off a mesh, ``err``."""
        if not self.lockstep:
            return err
        from arrow_matrix_tpu_torch.parallel import collectives as coll

        if coll.all_reduce_max(int(err is not None), None):
            return err or elsewhere
        return None

    def _migrate_on_ranks(self, old_exec, new_exec) -> Tuple[int, int]:
        """:meth:`_migrate_checkpoints` by rank 0 alone on a mesh (the
        files are shared); its outcome is sent to every rank, so a
        failed migration raises on all of them."""
        if not self.lockstep:
            return self._migrate_checkpoints(old_exec, new_exec)
        from arrow_matrix_tpu_torch.parallel import collectives as coll

        out = None
        if self.leader:
            try:
                out = {"done": list(self._migrate_checkpoints(old_exec,
                                                              new_exec))}
            except Exception as e:  # noqa: BLE001 — shared, then raised
                coll.broadcast_object(
                    {"error": f"{type(e).__name__}: {e}"})
                raise
        out = coll.broadcast_object(out)
        if "error" in out:
            raise RuntimeError(f"checkpoint migration failed on rank 0: "
                               f"{out['error']}")
        return tuple(out["done"])

    def _migrate_checkpoints(self, old_exec, new_exec) -> Tuple[int, int]:
        """Replay every per-request checkpoint still on the old layout
        through a staged plan onto the grown layout, in place (atomic
        save: a SIGKILL mid-migration leaves each checkpoint on the old
        or the new layout, never torn; the rerun's grow finishes the
        stragglers).  Returns (migrated, total stages)."""
        import os

        if not self.checkpoint_dir \
                or not os.path.isdir(self.checkpoint_dir):
            return 0, 0
        src_fn = getattr(old_exec, "reshard_layout", None)
        dst_fn = getattr(new_exec, "reshard_layout", None)
        if src_fn is None or dst_fn is None:
            self._event("grow_migration_skipped",
                        error="executor pair exposes no reshard_layout")
            return 0, 0
        from arrow_matrix_tpu_torch.parallel.reshard import (
            apply_plan_host,
            redistribution_plan,
        )
        from arrow_matrix_tpu_torch.utils.checkpoint import (
            checkpoint_layout_tag,
            list_checkpoints,
            load_state,
            save_state,
        )

        src_lay, dst_lay = src_fn(), dst_fn()
        ps = np.asarray(old_exec.perm0)
        pd = np.asarray(new_exec.perm0)
        if (src_lay.stored_rows == dst_lay.stored_rows
                and np.array_equal(ps, pd)):
            return 0, 0   # the same carriage: nothing to migrate
        if src_lay.stored_rows == dst_lay.stored_rows:
            # An equal-size relayout cannot be told from an already
            # migrated file by its shape: refusing beats permuting a
            # checkpoint twice on a rerun.
            raise ValueError(
                "grow between equal-size layouts with different row "
                "orders is not idempotently resumable; grow must "
                "change total_rows/n_dev/repl")
        inv_s = np.asarray(old_exec.inv_perm0)
        n = int(new_exec.n)
        perm_map = np.where(pd < n, inv_s[np.minimum(pd, len(inv_s) - 1)],
                            np.int64(-1))
        migrated = stages = 0
        for stem in list_checkpoints(self.checkpoint_dir):
            key = os.path.basename(stem)[len("ck_"):]
            tag = checkpoint_layout_tag(stem)
            try:
                got = load_state(stem, layout=tag)
            except Exception as e:  # noqa: BLE001 — an unreadable
                # file: the resume path discards it loudly.
                self._event("grow_migration_skipped", request=key,
                            error=f"{type(e).__name__}: {e}")
                continue
            if got is None:
                continue
            x, step = got
            if x.dim() != 2:
                self._event("grow_migration_skipped", request=key,
                            error=f"unmigratable carriage shape "
                                  f"{tuple(x.shape)}")
                continue
            if x.shape[0] == dst_lay.stored_rows:
                continue   # already on the grown layout (a rerun)
            if x.shape[0] != src_lay.stored_rows:
                self._event("grow_migration_skipped", request=key,
                            error=f"carriage shape {tuple(x.shape)} "
                                  f"matches neither layout")
                continue
            bf16 = x.dtype == torch.bfloat16
            host = (x.view(torch.int16) if bf16 else x).numpy()
            plan = redistribution_plan(src_lay, dst_lay,
                                       self.reshard_budget_bytes,
                                       k=int(x.shape[1]),
                                       perm_map=perm_map)
            y = torch.from_numpy(apply_plan_host(plan, host))
            save_state(stem, y.view(torch.bfloat16) if bf16 else y, step,
                       layout=tag)
            migrated += 1
            stages += plan.n_stages
            with self._lock:
                self.checkpoints_resharded += 1
            self._event("checkpoint_resharded", request=key, step=step,
                        stages=plan.n_stages,
                        max_stage_scratch_bytes=
                        plan.max_stage_scratch_bytes,
                        budget_bytes=plan.scratch_budget_bytes)
        return migrated, stages

    # -- reporting ---------------------------------------------------------

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def latency_samples_ms(self) -> List[float]:
        """Every completed request's latency in ms, in completion
        order (raw samples, so pooled quantiles over several servers
        are exact)."""
        with self._lock:
            return [lat * 1e3 for lat in self._latencies_s]

    def class_latency_samples_ms(self) -> Dict[str, List[float]]:
        """Completed-request latencies (ms) keyed by served class —
        the per-class half of the SLO report."""
        with self._lock:
            return {cls: [lat * 1e3 for lat in vals]
                    for cls, vals in
                    sorted(self._class_latencies_s.items())}

    def opt_in_approx(self, tenant: str) -> None:
        """Record a tenant's explicit consent to exact -> approx class
        degradation (the ladder rung below the terminal config; never
        taken without this)."""
        with self._lock:
            self._tenant(tenant).allow_approx = True

    def summary(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            tenants = {
                name: {
                    "rung": t.rung,
                    "config": dataclasses.asdict(self.ladder[t.rung]),
                    "fault_score": t.fault_score,
                    "allow_approx": t.allow_approx,
                    "class_degraded": t.class_degraded,
                    "completed": counts.get(f"completed:{name}", 0),
                    "failed": counts.get(f"failed:{name}", 0),
                    "shed": counts.get(f"shed:{name}", 0),
                    "rejected": counts.get(f"rejected:{name}", 0),
                    "degradations": list(t.degradations),
                }
                for name, t in sorted(self._tenants.items())
            }
            classes = {
                cls: {
                    "admitted": counts.get(f"admitted:class:{cls}", 0),
                    "completed": counts.get(
                        f"completed:class:{cls}", 0),
                    "requests": len(self._class_latencies_s.get(
                        cls, ())),
                }
                for cls in ("exact", "approx")
            }
            # The bare fault/batch counters are read under the same
            # lock their writers hold — a summary taken mid-batch is
            # a consistent cut.  The accountant snapshot nests its own
            # lock inside ours: the declared arrow_server ->
            # hbm_accountant order.
            return {
                "server": self.name,
                "submitted": counts.get("submitted", 0),
                "admitted": counts.get("admitted", 0),
                "completed": counts.get("completed", 0),
                "failed": counts.get("failed", 0),
                "shed": counts.get("shed", 0),
                "rejected": counts.get("rejected", 0),
                "class_fallback": counts.get("class_fallback", 0),
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "faults_seen": self.faults_seen,
                "recoveries": self.recoveries,
                "checkpoint_corruptions": self.checkpoint_corruptions,
                "hbm": self.accountant.snapshot(),
                "tenants": tenants,
                "classes": classes,
                "certificates": {
                    dt: {"iterations": c.iterations,
                         "tolerance": c.tolerance,
                         "bound": c.bound_at(c.iterations),
                         "record_id": c.record_id}
                    for dt, c in sorted(self._certificates.items())
                },
            }

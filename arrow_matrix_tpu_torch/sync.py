"""Declared concurrency contracts and the lock-order witness.

The port's copy of ``arrow_matrix_tpu/sync.py`` (stdlib only, copied
rather than imported: the port imports nothing of the JAX package).
The serving runtime is threaded (the ``ArrowServer`` worker, submitter
threads, the supervisor's watchdog thread); this module is a
vocabulary for declaring the locking discipline its classes follow, and
an opt-in witness that checks real executions against it.

Vocabulary
----------
``@guarded_by("_lock", node="arrow_server", attrs=(...), callbacks=(...),
aliases=("_cond",))``
    Class decorator declaring the concurrency contract: ``attrs`` may
    only be mutated while holding ``self.<lock>`` (``__init__`` is
    exempt — pre-publication); ``callbacks`` (user-supplied hooks that
    may re-enter the package) must never be invoked while the lock is
    held; ``aliases`` name attributes that guard via the same lock
    (e.g. a ``threading.Condition`` wrapping it).  ``node`` is the
    class's vertex name in the package lock graph — shared between the
    JAX package's static analyzer (``analysis/sync.py``) and
    the runtime witness.  The decorator only attaches
    ``__sync_contract__``; it costs nothing at runtime.

``witnessed(node, lock)``
    Wrap a freshly created ``threading.Lock``/``RLock`` so the witness
    sees its acquisitions.  When the witness is off (the default) the
    lock is returned *unchanged* — zero per-acquisition overhead.

``flock_witness(node)``
    Context manager registering a held ``fcntl.flock`` region as the
    graph vertex ``flock:<node>`` (no-op context when the witness is
    off).  The package's two flock disciplines — the artifacts sidecar
    lock and the preemption registry — both route through it.

The witness
-----------
Enabled by ``AMT_LOCK_WITNESS=1`` in the environment at import time
(read exactly once — the R9 discipline), or in-process via
:func:`enable_witness`.  Each thread keeps its held-lock stack; every
*first* acquisition of a node while others are held adds an edge
``held -> acquired`` to a process-wide digraph seeded with
:data:`DECLARED_ORDER`.  An edge that would close a cycle — i.e. an
acquisition order inconsistent with the declared partial order or with
any previously observed order — raises :class:`LockOrderViolation` in
the acquiring thread *before* it blocks, so a potential deadlock
surfaces as a traceback instead of a hang.  Reentrant re-acquisition
(RLock) bumps a per-entry count and adds no edge.

Tests run with the witness on, so a serving scenario doubles as a
lock-order execution test, and assert that the off-by-default path
leaves no registry behind.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "DECLARED_ORDER",
    "FLOCK_NODES",
    "LockOrderViolation",
    "LockRegistry",
    "WITNESS_ENV",
    "disable_witness",
    "enable_witness",
    "flock_witness",
    "guarded_by",
    "witness_registry",
    "witnessed",
]

WITNESS_ENV = "AMT_LOCK_WITNESS"

#: The package's declared lock partial order: ``(before, after)`` means
#: ``before`` may be held while acquiring ``after`` — never the
#: reverse.  The static analyzer folds these edges into the RC2 graph;
#: the runtime witness seeds its digraph with them, so an execution
#: that inverts any pair raises immediately.  Keep this the *minimal*
#: true order: an observed edge that is merely new (no cycle) is
#: recorded, not rejected.
DECLARED_ORDER: Tuple[Tuple[str, str], ...] = (
    # ArrowServer._event funnels every serve event while holding the
    # scheduler lock: flight.record / pulse.observe / (via pulse
    # dispatch on the same call stack) watchdog.on_window all nest
    # under it, as do admission-ledger updates and metric emissions.
    ("arrow_server", "flight_recorder"),
    ("arrow_server", "pulse_monitor"),
    ("arrow_server", "slo_watchdog"),
    ("arrow_server", "hbm_accountant"),
    ("arrow_server", "metrics_registry"),
    # Fleet dispatch threads update worker health and the blackbox
    # while holding the router lock.
    ("fleet_router", "health_monitor"),
    ("fleet_router", "flight_recorder"),
    ("fleet_router", "metrics_registry"),
    # graft-host: the shm segment pool is a LEAF below the router —
    # the data plane may be entered with routing state held, but pool
    # methods never call back into the router (the reverse order is a
    # witness violation by construction).
    ("fleet_router", "shm_pool"),
    # A router quorum coordinates member routers (submit fan-out,
    # failover resubmission) while holding its own lock; each member
    # then takes its fleet_router lock underneath.
    ("router_quorum", "fleet_router"),
    # PulseMonitor.snapshot() reads the watchdog's burning set while
    # holding the pulse lock (one consistent ring document); the
    # watchdog never takes the pulse lock (on_burn dispatches with
    # every watchdog lock released), so the edge is acyclic.
    ("pulse_monitor", "slo_watchdog"),
    # Pulse/watchdog otherwise dispatch callbacks and flight records
    # with their own locks *released* (the on_burn ladder re-enters
    # the scheduler), so they contribute no further edges.
)

#: Known flock vertices (``flock:<node>``) — the sidecar lock helper in
#: utils/artifacts.py and the preemption registry in utils/platform.py.
FLOCK_NODES: Tuple[str, ...] = ("flock:sidecar", "flock:preempt_registry")


class LockOrderViolation(RuntimeError):
    """An acquisition order inconsistent with the declared/observed
    lock partial order — a potential deadlock, raised in the acquiring
    thread before it blocks."""


def guarded_by(lock: str, *, node: Optional[str] = None,
               attrs: Sequence[str] = (),
               callbacks: Sequence[str] = (),
               aliases: Sequence[str] = ()):
    """Declare a class's concurrency contract (see module docstring).

    Purely declarative: attaches ``__sync_contract__`` for the static
    analyzer (which reads it from the AST, so the contract is enforced
    even on never-imported code paths) and for humans.
    """
    contract = {
        "lock": str(lock),
        "node": node,
        "attrs": tuple(attrs),
        "callbacks": tuple(callbacks),
        "aliases": tuple(aliases),
    }

    def deco(cls):
        cls.__sync_contract__ = dict(contract, node=node or cls.__name__)
        return cls

    return deco


class LockRegistry:
    """Per-process acquisition-order recorder (one per enabled witness).

    Thread-safe; the digraph and counters are guarded by an internal
    meta-lock that is never held while user code runs.
    """

    def __init__(self, declared: Sequence[Tuple[str, str]] = DECLARED_ORDER):
        self._meta = threading.Lock()
        self._succ: Dict[str, Set[str]] = {}
        self._declared_edges: Set[Tuple[str, str]] = set()
        self._observed_edges: Set[Tuple[str, str]] = set()
        self._tls = threading.local()
        self.acquisitions = 0
        self.reentries = 0
        self.threads_seen: Set[str] = set()
        self.violations: List[str] = []
        for a, b in declared:
            self.declare(a, b)

    # -- declared order -------------------------------------------------

    def declare(self, before: str, after: str) -> None:
        """Add a declared edge; a self-loop or a declaration that
        contradicts the existing graph is a programming error."""
        if before == after:
            raise ValueError(f"self-edge {before!r} -> {after!r}")
        with self._meta:
            path = self._path(after, before)
            if path is not None:
                raise ValueError(
                    f"declared order {before!r} -> {after!r} contradicts "
                    f"existing path {' -> '.join(path)}")
            self._succ.setdefault(before, set()).add(after)
            self._declared_edges.add((before, after))

    # -- per-thread held stack ------------------------------------------

    def _held(self) -> List[List]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def note_acquire(self, node: str) -> None:
        """Record intent to acquire ``node``; raises
        :class:`LockOrderViolation` (before the caller blocks) if the
        order contradicts the declared/observed partial order."""
        held = self._held()
        for entry in held:
            if entry[0] == node:     # reentrant (RLock): no new edge
                entry[1] += 1
                self.reentries += 1
                return
        with self._meta:
            self.acquisitions += 1
            self.threads_seen.add(threading.current_thread().name)
            for prior, _ in held:
                self._add_edge_locked(prior, node)
        held.append([node, 1])

    def note_release(self, node: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == node:
                held[i][1] -= 1
                if held[i][1] <= 0:
                    del held[i]
                return
        # A release the witness never saw acquired (e.g. enabled
        # mid-flight): tolerated, not an error.

    def note_release_all(self, node: str) -> None:
        """Drop every recursion level of ``node`` (Condition.wait's
        ``_release_save`` path on an RLock)."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == node:
                del held[i]

    # -- the digraph ----------------------------------------------------

    def _add_edge_locked(self, a: str, b: str) -> None:
        if b in self._succ.get(a, ()):
            return
        path = self._path(b, a)
        if path is not None:
            kind = ("declared" if any(
                (path[i], path[i + 1]) in self._declared_edges
                for i in range(len(path) - 1)) else "observed")
            msg = (f"lock order violation: acquiring {b!r} while holding "
                   f"{a!r}, but the {kind} order already has "
                   f"{' -> '.join(path)} (thread "
                   f"{threading.current_thread().name!r})")
            self.violations.append(msg)
            raise LockOrderViolation(msg)
        self._succ.setdefault(a, set()).add(b)
        self._observed_edges.add((a, b))

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """Shortest path ``src -> ... -> dst`` in the digraph, or None.
        Caller holds ``self._meta`` (or is single-threaded init)."""
        if src == dst:
            return [src]
        frontier = [(src, [src])]
        seen = {src}
        while frontier:
            cur, path = frontier.pop(0)
            for nxt in sorted(self._succ.get(cur, ())):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append((nxt, path + [nxt]))
        return None

    def snapshot(self) -> dict:
        """Stable summary for gate logs and the stress test."""
        with self._meta:
            return {
                "acquisitions": self.acquisitions,
                "reentries": self.reentries,
                "threads": sorted(self.threads_seen),
                "declared_edges": sorted(self._declared_edges),
                "observed_edges": sorted(self._observed_edges),
                "violations": list(self.violations),
            }


class _WitnessLock:
    """Proxy wrapping a real Lock/RLock; every acquisition path —
    including ``threading.Condition``'s ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` protocol — reports to the
    registry, so ``Condition(witnessed(...))`` stays fully witnessed."""

    __slots__ = ("_lock", "_node", "_registry")

    def __init__(self, node: str, lock, registry: LockRegistry):
        self._lock = lock
        self._node = node
        self._registry = registry

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._registry.note_acquire(self._node)
        ok = False
        try:
            ok = self._lock.acquire(blocking, timeout)
        finally:
            if not ok:
                self._registry.note_release(self._node)
        return ok

    def release(self) -> None:
        self._registry.note_release(self._node)
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol --------------------------------------------

    def _is_owned(self) -> bool:
        inner = getattr(self._lock, "_is_owned", None)
        if inner is not None:
            return inner()
        if self._lock.acquire(False):   # plain-Lock probe (CPython's own
            self._lock.release()        # generic Condition fallback)
            return False
        return True

    def _release_save(self):
        state = None
        inner = getattr(self._lock, "_release_save", None)
        if inner is not None:
            state = inner()
        else:
            self._lock.release()
        self._registry.note_release_all(self._node)
        return state

    def _acquire_restore(self, state) -> None:
        self._registry.note_acquire(self._node)
        try:
            inner = getattr(self._lock, "_acquire_restore", None)
            if inner is not None:
                inner(state)
            else:
                self._lock.acquire()
        except BaseException:
            self._registry.note_release(self._node)
            raise

    def locked(self) -> bool:
        inner = getattr(self._lock, "locked", None)
        return bool(inner()) if inner is not None else self._is_owned()

    def __repr__(self) -> str:
        return f"<witnessed {self._node!r} {self._lock!r}>"


class _FlockWitness:
    """Context manager marking a held flock region in the lock graph."""

    __slots__ = ("_node", "_registry")

    def __init__(self, registry: LockRegistry, node: str):
        self._registry = registry
        self._node = node

    def __enter__(self):
        self._registry.note_acquire(self._node)
        return self

    def __exit__(self, *exc) -> None:
        self._registry.note_release(self._node)


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_CM = _NullContext()

_REGISTRY: Optional[LockRegistry] = None


def witness_registry() -> Optional[LockRegistry]:
    """The active registry, or None when the witness is off."""
    return _REGISTRY


def enable_witness(registry: Optional[LockRegistry] = None) -> LockRegistry:
    """Turn the witness on in-process (gates/tests; construct the
    objects under test *after* this so their locks are wrapped)."""
    global _REGISTRY
    _REGISTRY = registry if registry is not None else LockRegistry()
    return _REGISTRY


def disable_witness() -> None:
    global _REGISTRY
    _REGISTRY = None


def witnessed(node: str, lock):
    """Wrap ``lock`` for the witness; returns ``lock`` unchanged (zero
    overhead, not even a proxy allocation) when the witness is off."""
    reg = _REGISTRY
    if reg is None:
        return lock
    return _WitnessLock(node, lock, reg)


def flock_witness(node: str):
    """Witness context for a held ``fcntl.flock`` region (vertex
    ``flock:<node>``); a shared no-op context when the witness is off."""
    reg = _REGISTRY
    if reg is None:
        return _NULL_CM
    return _FlockWitness(reg, "flock:" + node)


def _env_on(name: str) -> bool:
    # Read exactly once at import (the R9 discipline: no AMT_* env
    # reads in hot scopes).
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "off", "no")


if _env_on(WITNESS_ENV):
    enable_witness()

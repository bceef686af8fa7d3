"""Tenant placement over the fleet — the same pricing admission trusts.

The port's copy of ``arrow_matrix_tpu/fleet/placement.py``: the same
behaviour and on-wire or on-disk forms.

Two regimes, matching how tenants share the resident operator:

* **Shared graph** (the default fleet shape: every worker hosts the
  same decomposition) — :class:`ConsistentHashRing`.  A tenant hashes
  to a point on a sha256 ring of virtual nodes; the owning worker is
  the next point clockwise.  Deterministic (string hashing, no
  process randomness), stable under membership change: removing a
  dead worker re-homes ONLY the tenants it owned — the property that
  makes requeue-on-death surgical instead of a full reshuffle.
* **Per-tenant graphs** (each tenant's operator is resident on exactly
  one worker) — :func:`pack_tenants`, first-fit-decreasing bin
  packing of per-tenant resident+carriage byte prices (from
  ``serve/admission.request_price_bytes`` — the ``request_bytes_for``
  model) against per-worker HBM budgets.  A tenant that fits no
  worker is returned unplaced so the router can shed it EXPLICITLY
  (``fleet_capacity``) instead of over-committing a budget the
  admission controller would then reject request-by-request.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple


def _point(key: str) -> int:
    """A deterministic 64-bit ring coordinate (sha256-based: stable
    across processes and runs, unlike ``hash()``)."""
    digest = hashlib.sha256(key.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


class ConsistentHashRing:
    """sha256 consistent-hash ring with virtual nodes.

    ``lookup(tenant)`` returns the owning worker id; ``lookup`` with
    ``exclude`` skips dead workers by walking to the next live point —
    exactly the requeue path.  Empty ring lookups return None (the
    router's explicit-shed signal).
    """

    def __init__(self, worker_ids: Iterable[str] = (),
                 vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._workers: set = set()
        self._points: List[Tuple[int, str]] = []
        for w in worker_ids:
            self.add(w)

    def add(self, worker_id: str) -> None:
        if worker_id in self._workers:
            return
        self._workers.add(worker_id)
        for v in range(self.vnodes):
            self._points.append((_point(f"{worker_id}#{v}"),
                                 worker_id))
        self._points.sort()

    def remove(self, worker_id: str) -> None:
        if worker_id not in self._workers:
            return
        self._workers.discard(worker_id)
        self._points = [(p, w) for p, w in self._points
                        if w != worker_id]

    @property
    def workers(self) -> List[str]:
        return sorted(self._workers)

    def lookup(self, tenant: str,
               exclude: Iterable[str] = ()) -> Optional[str]:
        """The owning worker for ``tenant``, skipping ``exclude``d
        workers by walking the ring clockwise; None when no eligible
        worker remains."""
        dead = set(exclude)
        live = self._workers - dead
        if not live or not self._points:
            return None
        start = bisect.bisect_right(self._points,
                                    (_point(tenant), chr(0x10FFFF)))
        n = len(self._points)
        for i in range(n):
            _, w = self._points[(start + i) % n]
            if w not in dead:
                return w
        return None


def pack_tenants(tenant_bytes: Dict[str, int],
                 capacities: Dict[str, int]
                 ) -> Tuple[Dict[str, str], List[str]]:
    """First-fit-decreasing bin packing of tenants onto workers.

    ``tenant_bytes`` maps tenant -> priced resident+carriage bytes
    (the ``request_bytes_for`` model), ``capacities`` maps worker ->
    HBM budget bytes.  Returns ``(assignment, unplaced)`` where
    ``assignment`` maps tenant -> worker and ``unplaced`` lists the
    tenants no worker can host — the router sheds those explicitly.
    Deterministic: ties break on (bytes desc, tenant name) and worker
    order is sorted by name.
    """
    remaining = {w: int(c) for w, c in sorted(capacities.items())}
    assignment: Dict[str, str] = {}
    unplaced: List[str] = []
    order = sorted(tenant_bytes.items(),
                   key=lambda kv: (-int(kv[1]), kv[0]))
    for tenant, nbytes in order:
        nbytes = int(nbytes)
        placed = False
        for w in remaining:
            if nbytes <= remaining[w]:
                assignment[tenant] = w
                remaining[w] -= nbytes
                placed = True
                break
        if not placed:
            unplaced.append(tenant)
    return assignment, unplaced

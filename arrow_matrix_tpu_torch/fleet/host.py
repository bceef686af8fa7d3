"""Host fault domains + shared-nothing router quorum.

The port's copy of ``arrow_matrix_tpu/fleet/host.py``.  The fleet
rehearses a multi-host failure surface on one machine by grouping
workers into **host fault domains** (spawn env ``AMT_HOST_ID`` — the
router assigns contiguous blocks, mirroring how a per-host mesh slice
would split the device axis).  A domain is the unit of correlated
failure: ``FleetRouter.kill_host`` SIGKILLs every worker in one domain
at once (the kill-a-host chaos rung), and the wire transport is chosen
by domain topology — same domain rides shm descriptors, cross-domain
rides raw framing, exactly the split a real deployment has.

:func:`plan_host_mesh` is pure: it produces the per-rank spawn env of
one global job (``AMT_FLEET_COORDINATOR`` / ``AMT_FLEET_NUM_PROCESSES``
/ ``AMT_FLEET_PROCESS_ID``, with ``AMT_HOST_ID`` stamped per rank),
the same dicts as the JAX package's.  A worker spawned with such an
env joins that one ``torch.distributed`` job as its rank
(``fleet.worker.maybe_init_distributed``).

:class:`RouterQuorum` is the shared-nothing router story: N routers
run the SAME deterministic placement machinery (sha256 consistent-hash
ring + first-fit-decreasing packing — no process randomness anywhere)
over the same worker set, so they agree on every placement *without
coordinating*.  :meth:`RouterQuorum.verify_agreement` PROVES it
(byte-identical ring choices and packing assignments per router, and
no tenant double-admitted onto different workers — which is what
would overrun an HBM budget that each router individually respects).
Clients hash requests across live routers; when one dies
(:meth:`fail_router`), its accepted-but-unfinished tickets are
resubmitted through survivors — idempotent because all workers share
one checkpoint directory with per-request keys, so the survivor's
worker RESUMES rather than recomputes and results stay bit-identical.
Zero accepted-request loss is the acceptance bar (the fleet gate's
quorum scenario).

Concurrency: quorum state is guarded by ``_lock`` (node
``router_quorum``); member submits happen under it — the declared
``router_quorum -> fleet_router`` edge — which keeps failover atomic
against concurrent submits (a request routed to a router in the same
instant it is declared failed is either in ``_by_router`` and fails
over, or routed to a survivor; never dropped).  Placement-plan wire
calls (``plan_packing``) run with NO quorum lock held (RC4).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from arrow_matrix_tpu_torch.fleet.router import FleetRouter
from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.serve import request as rq
from arrow_matrix_tpu_torch.sync import guarded_by, witnessed


def host_of(rank: int, num_ranks: int, num_hosts: int) -> str:
    """The host domain of one rank under contiguous-block slicing —
    the same split ``FleetRouter(hosts=H)`` applies to workers and a
    real deployment applies to a device axis."""
    if not (0 <= rank < num_ranks):
        raise ValueError(f"rank {rank} outside [0, {num_ranks})")
    if num_hosts < 1 or num_hosts > num_ranks:
        raise ValueError(f"num_hosts must be in [1, {num_ranks}], "
                         f"got {num_hosts}")
    return f"host-{rank * num_hosts // num_ranks}"


def plan_host_mesh(num_hosts: int, procs_per_host: int, *,
                   coordinator: str = "127.0.0.1",
                   port: int = 0) -> List[Dict[str, str]]:
    """Per-rank spawn env for a ``num_hosts × procs_per_host`` global
    job over the ``AMT_FLEET_*`` env hooks.  Rank r of the one global
    job lives in domain ``host-{r // procs_per_host}``; every rank
    shares the coordinator (rank 0's host in real life).  Pure: the
    caller spawns one process per entry, and each joins the one job
    (``fleet.worker.maybe_init_distributed``)."""
    if num_hosts < 1 or procs_per_host < 1:
        raise ValueError("num_hosts and procs_per_host must be >= 1")
    total = num_hosts * procs_per_host
    return [{"AMT_FLEET_COORDINATOR": f"{coordinator}:{int(port)}",
             "AMT_FLEET_NUM_PROCESSES": str(total),
             "AMT_FLEET_PROCESS_ID": str(r),
             "AMT_HOST_ID": host_of(r, total, num_hosts)}
            for r in range(total)]


class QuorumDisagreement(RuntimeError):
    """Two quorum routers produced different placement decisions for
    the same input — the shared-nothing premise is broken (or a router
    saw a different membership view), and serving must stop LOUDLY
    before tenants are double-admitted."""


@guarded_by("_lock", node="router_quorum",
            attrs=("_failed", "_by_router", "_rr", "failovers"))
class RouterQuorum:
    """N shared-nothing routers over one worker fleet (see module
    docstring).  ``routers`` maps name -> :class:`FleetRouter`; every
    member must be attached to the SAME worker set (checked)."""

    def __init__(self, routers: Dict[str, FleetRouter]):
        if len(routers) < 2:
            raise ValueError(f"a quorum needs >= 2 routers, got "
                             f"{len(routers)}")
        views = {name: tuple(sorted(r.workers))
                 for name, r in routers.items()}
        if len(set(views.values())) != 1:
            raise ValueError(f"quorum routers see different worker "
                             f"sets: {views}")
        self.routers = dict(routers)
        self._lock = witnessed("router_quorum", threading.Lock())
        self._failed: set = set()
        # name -> list of (request, ticket): the accepted requests
        # each member is responsible for, consulted on failover.
        self._by_router: Dict[str, List[tuple]] = {
            name: [] for name in routers}
        self._rr = 0
        self.failovers = 0
        flight.record("fleet", "quorum_up",
                      routers=sorted(routers),
                      workers=list(views[next(iter(views))]))

    # -- agreement proof ---------------------------------------------------

    def live_routers(self) -> List[str]:
        with self._lock:
            return sorted(set(self.routers) - self._failed)

    def verify_agreement(self, tenants: List[str],
                         tenant_ks: Optional[Dict[str, int]] = None
                         ) -> dict:
        """Prove the shared-nothing premise on live members: every
        router, asked independently, places each tenant on the same
        worker (ring/pins/packing — whatever its ``_place`` resolves),
        and — when ``tenant_ks`` is given — computes byte-identical
        FFD packings with no tenant admitted onto two different
        workers (the double-admit that would overrun a budget each
        router individually respects).  Wire calls for packing run
        with no quorum lock held.  Returns the consensus document;
        raises :class:`QuorumDisagreement` on any split."""
        live = self.live_routers()
        if not live:
            raise QuorumDisagreement("no live routers")
        placements: Dict[str, Dict[str, Optional[str]]] = {
            name: {t: self.routers[name]._place(t) for t in tenants}
            for name in live}
        ref_name = live[0]
        ref = placements[ref_name]
        for name in live[1:]:
            if placements[name] != ref:
                diffs = {t: (ref[t], placements[name][t])
                         for t in tenants
                         if placements[name][t] != ref[t]}
                raise QuorumDisagreement(
                    f"ring placement split between {ref_name} and "
                    f"{name}: {diffs}")
        packing = None
        if tenant_ks:
            plans = {name: self.routers[name].plan_packing(tenant_ks)
                     for name in live}
            ref_plan = plans[ref_name]
            for name in live[1:]:
                if plans[name]["assignment"] \
                        != ref_plan["assignment"] \
                        or sorted(plans[name]["unplaced"]) \
                        != sorted(ref_plan["unplaced"]):
                    raise QuorumDisagreement(
                        f"packing split between {ref_name} and "
                        f"{name}: {plans[name]} vs {ref_plan}")
            # No double-admit: across every router's plan, each tenant
            # landed on exactly one worker, so the per-worker byte sum
            # any single plan respects is the byte sum the FLEET sees.
            owners: Dict[str, set] = {}
            for plan in plans.values():
                for tenant, wid in plan["assignment"].items():
                    owners.setdefault(tenant, set()).add(wid)
            double = {t: sorted(ws) for t, ws in owners.items()
                      if len(ws) > 1}
            if double:
                raise QuorumDisagreement(
                    f"double-admitted tenants: {double}")
            packing = ref_plan
        doc = {"routers": live, "tenants": list(tenants),
               "placement": ref, "packing": packing,
               "agreed": True}
        flight.record("fleet", "quorum_agreement",
                      routers=live, tenants=len(tenants),
                      packed=bool(packing))
        return doc

    # -- client fan-in + failover ------------------------------------------

    def submit(self, request: rq.Request) -> rq.Ticket:
        """Route one request through a live member (round-robin —
        deterministic given submission order).  Holding the quorum
        lock across the member submit (declared ``router_quorum ->
        fleet_router`` edge) makes failover atomic: a router is never
        both 'failed' and accepting."""
        with self._lock:
            live = sorted(set(self.routers) - self._failed)
            if not live:
                raise RuntimeError("no live router in the quorum")
            name = live[self._rr % len(live)]
            self._rr += 1
            ticket = self.routers[name].submit(request)
            self._by_router[name].append((request, ticket))
        return ticket

    def fail_router(self, name: str) -> List[str]:
        """Take one member out (the router-death drill) and fail its
        accepted-but-unfinished requests over to survivors.  Requeue
        is idempotent — workers share per-request checkpoint keys, so
        a request the dead router's dispatch thread already ran
        resumes its checkpoint instead of recomputing, and
        :meth:`results` dedupes by request id.  Returns the failed-
        over request ids (zero accepted-request loss = every one of
        them reaches a terminal state through a survivor)."""
        if name not in self.routers:
            raise ValueError(f"unknown router {name!r}")
        moved: List[str] = []
        with self._lock:
            if name in self._failed:
                return []
            self._failed.add(name)
            survivors = sorted(set(self.routers) - self._failed)
            if not survivors:
                raise RuntimeError(
                    f"router {name} was the last quorum member")
            orphans = [(req, t) for req, t in self._by_router[name]
                       if not t.done]
            for i, (req, _t) in enumerate(orphans):
                succ = survivors[i % len(survivors)]
                clone = rq.Request(
                    request_id=req.request_id, tenant=req.tenant,
                    x=req.x, iterations=req.iterations,
                    deadline_s=req.deadline_s,
                    traffic_class=req.traffic_class)
                ticket = self.routers[succ].submit(clone)
                self._by_router[succ].append((clone, ticket))
                moved.append(req.request_id)
            self.failovers += len(moved)
        flight.record("fleet", "router_failed", router=name,
                      failed_over=moved)
        return moved

    def drain(self, timeout_s: Optional[float] = None) -> None:
        for name in self.live_routers():
            self.routers[name].drain(timeout_s=timeout_s)

    def results(self) -> Dict[str, rq.Ticket]:
        """request_id -> final ticket, deduped across members: a
        completed outcome wins over any other copy of the same request
        (a failed-over request can terminate twice — bit-identically,
        which the fleet gate checks — and must count once)."""
        final: Dict[str, rq.Ticket] = {}
        with self._lock:
            per_router = {name: list(pairs) for name, pairs
                          in self._by_router.items()}
        for pairs in per_router.values():
            for req, ticket in pairs:
                cur = final.get(req.request_id)
                if cur is None or (cur.status != rq.COMPLETED
                                   and ticket.status == rq.COMPLETED):
                    final[req.request_id] = ticket
        return final

    def summary(self) -> dict:
        results = self.results()
        counts: Dict[str, int] = {}
        for t in results.values():
            counts[str(t.status)] = counts.get(str(t.status), 0) + 1
        with self._lock:
            failed = sorted(self._failed)
            accepted = {name: len(pairs) for name, pairs
                        in self._by_router.items()}
        return {"routers": sorted(self.routers),
                "failed_routers": failed,
                "accepted_per_router": accepted,
                "failovers": self.failovers,
                "requests": len(results),
                "status_counts": counts,
                "lost_requests": sorted(
                    rid for rid, t in results.items()
                    if not t.done)}

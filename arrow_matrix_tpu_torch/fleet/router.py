"""The fleet front end: placement, dispatch, health, requeue, report.

The port's copy of ``arrow_matrix_tpu/fleet/router.py``.
:class:`FleetRouter` owns N :class:`WorkerHandle`\\ s — spawned local
``python -m arrow_matrix_tpu_torch.fleet.worker`` processes, each
serving on the router's device (the card unless ``device="cpu"``), or
attached in-process workers — and routes tenant requests over the
fleet wire:

* **Spawn**: the workers are started together and then awaited, so N
  workers build their operators in parallel.  On the card the workers
  share one HBM budget: with no explicit ``hbm_budget_mb`` the router
  reads the card's budget once, before any worker allocates
  (``obs/comm.hbm_budget_bytes``: ``AMT_HBM_GB``, else half the card's
  free memory), and gives each of its N workers an equal 1/N share, so
  the workers' budgets sum to at most the card's.  On the CPU each
  worker reads its own budget, as in the JAX package.

* **Placement** uses the pricing admission already trusts:
  consistent hashing (:class:`~arrow_matrix_tpu_torch.fleet.placement
  .ConsistentHashRing`) for shared-graph tenants, or first-fit-
  decreasing bin-packing (:func:`~arrow_matrix_tpu_torch.fleet.placement
  .pack_tenants`) of ``request_bytes_for`` prices — fetched from the
  workers' own admission model via the ``price`` op — against worker
  HBM headroom.  A tenant no worker can host is shed EXPLICITLY
  (``fleet_capacity``), never queued into a stall.
* **Dispatch** is one thread per in-flight ticket; the wire's one-
  connection-per-op discipline means a worker death surfaces as a
  wire error on exactly the requests it was running.
* **Death & requeue**: a wire failure is a health QUESTION — the
  :class:`~arrow_matrix_tpu_torch.fleet.health.HealthMonitor` probes with
  per-worker jittered backoff, and only a full streak of missed
  heartbeats buries the worker.  Its accepted-but-unfinished requests
  then requeue onto ring survivors.  Requeue is idempotent because
  all workers share one checkpoint directory with per-request keys:
  the survivor RESUMES the dead worker's sha256-verified checkpoint
  (prints the ``resumed request`` line the gates grep) instead of
  recomputing, and the result stays bit-identical to a fault-free
  single-process replay — the acceptance bar of the port's
  ``tools/fleet_gate.py``.
* **Report**: ``fleet_summary()`` pools every worker's RAW latency
  samples through the mergeable :class:`~arrow_matrix_tpu_torch.obs.metrics
  .Histogram`, so fleet p50/p90/p99 are exact pooled quantiles, not
  approximations; ``fold_ledgers()`` folds each worker's run-dir
  ledger store into one chained fleet history (kind ``fleet``).

Fault seam: every submit passes ``faults.inject("fleet.router.submit")``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import select
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from arrow_matrix_tpu_torch import faults
from arrow_matrix_tpu_torch.fleet import shm as shm_mod
from arrow_matrix_tpu_torch.fleet import wire
from arrow_matrix_tpu_torch.fleet.health import HealthMonitor
from arrow_matrix_tpu_torch.fleet.placement import (
    ConsistentHashRing,
    pack_tenants,
)
from arrow_matrix_tpu_torch.ledger import store as ledger_store
from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.obs import xray as xray_mod
from arrow_matrix_tpu_torch.obs.metrics import Histogram
from arrow_matrix_tpu_torch.obs.tracer import Tracer
from arrow_matrix_tpu_torch.sync import guarded_by, witnessed
from arrow_matrix_tpu_torch.serve import request as rq
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device

#: Explicit-shed reason when no live worker can host a request — the
#: fleet extension of the degradation ladder: losing capacity sheds,
#: it never stalls.
SHED_FLEET_CAPACITY = "fleet_capacity"


def _repo_pythonpath(env: Dict[str, str]) -> str:
    """PYTHONPATH that keeps ``arrow_matrix_tpu_torch`` importable in a
    spawned worker even when the repo isn't installed."""
    import arrow_matrix_tpu_torch

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(arrow_matrix_tpu_torch.__file__)))
    old = env.get("PYTHONPATH", "")
    parts = [p for p in old.split(os.pathsep) if p]
    if root not in parts:
        parts.insert(0, root)
    return os.pathsep.join(parts)


@dataclasses.dataclass
class WorkerHandle:
    """One fleet worker as the router sees it: an address, optionally
    the spawned process, the spawn handshake metadata, its host fault
    domain (``host_id``, from the spawn env / READY announce), and the
    wire transport the router resolved for it (same host → ``shm``,
    cross host → ``raw``, unknown/attached → ``json``)."""

    worker_id: str
    host: str
    port: int
    proc: Optional[subprocess.Popen] = None
    log_path: Optional[str] = None
    obs_dir: Optional[str] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    transport: str = "json"

    @property
    def host_id(self) -> Optional[str]:
        return self.meta.get("host_id")

    def call(self, obj: Any, *, timeout_s: float = 30.0,
             stats: Optional[Dict[str, Any]] = None,
             shm_pool: Optional[shm_mod.SegmentPool] = None) -> Any:
        transport = self.transport if (self.transport != "shm"
                                       or shm_pool is not None) \
            else "json"
        return wire.request_call(self.host, self.port, obj,
                                 timeout_s=timeout_s, stats=stats,
                                 transport=transport,
                                 shm_pool=shm_pool)

    @property
    def pid(self) -> Optional[int]:
        if self.proc is not None:
            return self.proc.pid
        return self.meta.get("pid")

    def kill(self) -> None:
        """SIGKILL the spawned process (the chaos scenarios' hammer);
        a no-op for attached in-process workers."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()

    def reap(self, timeout_s: float = 10.0) -> Optional[int]:
        if self.proc is None:
            return None
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(timeout=timeout_s)


def worker_budgets(device: torch.device, workers: int,
                   hbm_budget_mb: float = 0.0) -> tuple:
    """``(mb, card)``: each spawned worker's ``--hbm_budget_mb`` and the
    card's budget it was cut from (None when nothing was cut).  An
    explicit budget (> 0) is every worker's own, as in the JAX package;
    so is 0 on the CPU (each worker then reads its own).  On the card,
    0 splits the card's budget, read once here before any worker
    allocates, into ``workers`` equal shares (whole bytes, exact in MiB
    as a float), so the workers' budgets sum to at most the card's."""
    if hbm_budget_mb > 0 or device.type != "cuda":
        return float(hbm_budget_mb), None
    from arrow_matrix_tpu_torch.obs.comm import hbm_budget_bytes

    card = hbm_budget_bytes(device=device)
    return (card // max(int(workers), 1)) / 2**20, card


def spawn_worker(worker_id: str, *, vertices: int, width: int,
                 seed: int, fmt: str = "fold",
                 queue_capacity: int = 64,
                 hbm_budget_mb: float = 0.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 2,
                 obs_dir: Optional[str] = None,
                 window_s: float = 0.25,
                 host_id: Optional[str] = None,
                 extra_env: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None,
                 ready_timeout_s: float = 600.0) -> WorkerHandle:
    """Spawn one worker process and complete the stdout handshake
    (:func:`launch_worker`, then :func:`await_worker`)."""
    pending = launch_worker(
        worker_id, vertices=vertices, width=width, seed=seed, fmt=fmt,
        queue_capacity=queue_capacity, hbm_budget_mb=hbm_budget_mb,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        obs_dir=obs_dir, window_s=window_s, host_id=host_id,
        extra_env=extra_env, device=device)
    return await_worker(pending, ready_timeout_s=ready_timeout_s)


def launch_worker(worker_id: str, *, vertices: int, width: int,
                  seed: int, fmt: str = "fold",
                  queue_capacity: int = 64,
                  hbm_budget_mb: float = 0.0,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 2,
                  obs_dir: Optional[str] = None,
                  window_s: float = 0.25,
                  host_id: Optional[str] = None,
                  extra_env: Optional[Dict[str, str]] = None,
                  device: DeviceLike = None) -> dict:
    """Start one worker process (``python -m
    arrow_matrix_tpu_torch.fleet.worker --device <device>``) without
    waiting for it; :func:`await_worker` completes the handshake.

    Everything the worker prints (including the scheduler's ``resumed
    request`` lines the gates grep) is copied to
    ``<obs_dir>/worker.log``.  ``host_id`` assigns the worker's host
    fault domain via the spawn env (``AMT_HOST_ID``) — the worker
    echoes it back in the READY announce, so the router's domain map is
    what the workers actually believe.  ``extra_env`` lands ON TOP of
    the inherited environment — the fleet gate arms victim workers with
    an ``AMT_FAULT_PLAN`` kill plan this way.
    """
    dev = resolve_device(device)
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.fleet.worker",
           "--worker_id", worker_id,
           "--vertices", str(int(vertices)),
           "--width", str(int(width)),
           "--seed", str(int(seed)),
           "--fmt", fmt,
           "--queue", str(int(queue_capacity)),
           "--hbm_budget_mb", repr(float(hbm_budget_mb)),
           "--checkpoint_every", str(int(checkpoint_every)),
           "--window_s", str(float(window_s)),
           "--device", str(dev)]
    if checkpoint_dir:
        cmd += ["--checkpoint_dir", checkpoint_dir]
    if obs_dir:
        os.makedirs(obs_dir, exist_ok=True)
        cmd += ["--obs_dir", obs_dir]
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo_pythonpath(env)
    env["PYTHONUNBUFFERED"] = "1"
    if host_id is not None:
        env["AMT_HOST_ID"] = str(host_id)
    env.update(extra_env or {})

    log_path = (os.path.join(obs_dir, "worker.log")
                if obs_dir else os.devnull)
    log_fh = open(log_path, "w", encoding="utf-8")
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=log_fh, text=True)
    log_fh.close()   # the child holds the stderr fd now
    return {"worker_id": worker_id, "proc": proc, "log_path": log_path,
            "obs_dir": obs_dir}


def await_worker(pending: dict,
                 ready_timeout_s: float = 600.0) -> WorkerHandle:
    """Wait for a launched worker's ``FLEET_WORKER_READY {json}`` (sent
    once its server is up and its TCP port is bound) and return its
    handle; kills the process and raises if it never comes."""
    worker_id, proc = pending["worker_id"], pending["proc"]
    log_path, obs_dir = pending["log_path"], pending["obs_dir"]
    deadline = time.monotonic() + ready_timeout_s
    ready = None
    assert proc.stdout is not None
    while time.monotonic() < deadline:
        r, _, _ = select.select([proc.stdout], [], [], 0.25)
        if not r:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        if not line:
            break
        _append_log(log_path, line)
        if line.startswith("FLEET_WORKER_READY "):
            ready = json.loads(line[len("FLEET_WORKER_READY "):])
            break
    if ready is None:
        proc.kill()
        proc.wait()
        raise RuntimeError(
            f"worker {worker_id} never announced readiness within "
            f"{ready_timeout_s:.0f}s (see {log_path})")

    # Keep draining the child's stdout into the log so the pipe never
    # fills and the resume lines are greppable after the run.
    def _drain():
        for line in proc.stdout:
            _append_log(log_path, line)

    threading.Thread(target=_drain, daemon=True,
                     name=f"fleet-log-{worker_id}").start()
    return WorkerHandle(worker_id=worker_id, host="127.0.0.1",
                        port=int(ready["port"]), proc=proc,
                        log_path=log_path, obs_dir=obs_dir,
                        meta=dict(ready))


def _append_log(log_path: str, line: str) -> None:
    if log_path == os.devnull:
        return
    with open(log_path, "a", encoding="utf-8") as fh:
        fh.write(line)


@guarded_by("_lock", node="fleet_router",
            attrs=("_dead", "_deaths", "_tickets", "_threads",
                   "_pack_assignment", "_pack_unplaced", "_pins",
                   "_counts", "requeues", "migrations",
                   "_wire_totals", "_wire_frames", "_clock_offsets"))
class FleetRouter:
    """Places, dispatches, watches, requeues, reports (see the module
    docstring).  Construct with ``spawn=`` worker count to spawn local
    processes, or ``handles=`` to attach workers already serving
    (tests run :func:`~arrow_matrix_tpu_torch.fleet.worker.serve_worker` on
    a thread and attach it).

    Concurrency (graft-sync): every submit spawns a ``_dispatch``
    daemon thread, so all routing state is guarded by ``_lock``.
    Health folds, wire calls, and worker probes run with the lock
    released — ``fleet_router -> health_monitor`` is a declared edge,
    and a probe's backoff sleeps must never serialize the fleet (RC4).
    """

    def __init__(self, *, spawn: int = 0,
                 handles: Optional[List[WorkerHandle]] = None,
                 vertices: int = 128, width: int = 16, seed: int = 11,
                 fmt: str = "fold", queue_capacity: int = 64,
                 hbm_budget_mb: float = 0.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 2,
                 run_dir: Optional[str] = None,
                 window_s: float = 0.25,
                 placement: str = "ring",
                 hosts: int = 1,
                 transport: str = "auto",
                 health: Optional[HealthMonitor] = None,
                 worker_env: Optional[Dict[str, Dict[str, str]]] = None,
                 submit_timeout_s: float = 300.0,
                 max_dispatch_attempts: Optional[int] = None,
                 device: DeviceLike = None,
                 name: str = "fleet",
                 verbose: bool = False):
        if placement not in ("ring", "pack"):
            raise ValueError(f"placement must be 'ring' or 'pack', "
                             f"got {placement!r}")
        if spawn and handles:
            raise ValueError("pass spawn= or handles=, not both")
        if transport not in ("auto", "json") + wire.TRANSPORTS:
            raise ValueError(f"transport must be 'auto' or one of "
                             f"{wire.TRANSPORTS}, got {transport!r}")
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        self.name = name
        self.verbose = verbose
        self.run_dir = run_dir
        self.placement = placement
        self.checkpoint_dir = checkpoint_dir
        self.submit_timeout_s = float(submit_timeout_s)
        # The router's own host fault domain: it rides with domain 0
        # unless the spawn env says otherwise (a quorum peer on
        # another "host" sees every domain-0 worker as cross-host).
        self.host_id = os.environ.get("AMT_HOST_ID", "host-0")
        self.transport_mode = transport
        self.shm: Optional[shm_mod.SegmentPool] = None
        self.health = health or HealthMonitor(timeout_s=5.0,
                                              max_failures=3)
        self._lock = witnessed("fleet_router", threading.RLock())
        self._dead: set = set()
        self._deaths: List[dict] = []
        self._tickets: List[rq.Ticket] = []
        self._threads: List[threading.Thread] = []
        self._pack_assignment: Dict[str, str] = {}
        self._pack_unplaced: set = set()
        self._pins: Dict[str, str] = {}
        self._counts: Dict[str, int] = {}
        self.requeues = 0
        self.migrations = 0
        # graft-xray: the router's own trace (dispatch/rpc spans), its
        # wire cost ledger (per-round-trip frames + running totals —
        # the byte-conservation invariant obs_gate checks), and the
        # per-worker clock offsets from the xray_ping handshake.
        self.tracer = Tracer(name="router")
        self._wire_totals: Dict[str, float] = {
            "frames": 0, "bytes_out": 0, "bytes_in": 0,
            "payload_bytes": 0, "shm_bytes": 0,
            "serialize_ms": 0.0, "wire_ms": 0.0}
        self._wire_frames: List[dict] = []
        self._clock_offsets: Dict[str, dict] = {}
        self.started_s = time.perf_counter()

        self.workers: Dict[str, WorkerHandle] = {}
        #: The spawned workers' device (None for attached handles), and
        #: the card's budget their shares were cut from (None unless
        #: the router split it).
        self.device: Optional[torch.device] = None
        self.card_budget_bytes: Optional[int] = None
        if handles:
            for h in handles:
                self.workers[h.worker_id] = h
        else:
            n = max(int(spawn), 1)
            hosts = min(int(hosts), n)
            env_map = worker_env or {}
            self.device = resolve_device(device)
            budget_mb, self.card_budget_bytes = worker_budgets(
                self.device, n, hbm_budget_mb)
            pending = []
            try:
                for i in range(n):
                    wid = f"worker-{i}"
                    obs_dir = (os.path.join(run_dir, wid)
                               if run_dir else None)
                    extra = dict(env_map.get(wid) or {})
                    if self.transport_mode in ("auto", "shm"):
                        extra.setdefault("AMT_SHM", "1")
                    pending.append(launch_worker(
                        wid, vertices=vertices, width=width, seed=seed,
                        fmt=fmt, queue_capacity=queue_capacity,
                        hbm_budget_mb=budget_mb,
                        checkpoint_dir=checkpoint_dir,
                        checkpoint_every=checkpoint_every,
                        obs_dir=obs_dir, window_s=window_s,
                        # Contiguous blocks: workers 0..n/H-1 are
                        # host-0 and so on — the slicing a real
                        # per-host mesh would use (fleet/host.py
                        # mirrors it).
                        host_id=f"host-{i * hosts // n}",
                        extra_env=extra, device=self.device))
                # All launched first: the workers build in parallel.
                for p in pending:
                    self.workers[p["worker_id"]] = await_worker(p)
            except BaseException:
                for p in pending:
                    if p["proc"].poll() is None:
                        p["proc"].kill()
                        p["proc"].wait()
                raise
        if not self.workers:
            raise ValueError("a fleet needs at least one worker")
        self._resolve_transports()
        self.ring = ConsistentHashRing(self.workers)
        self.n_rows = None
        for h in self.workers.values():
            n_rows = h.meta.get("n_rows")
            if n_rows is None:
                try:
                    hello = self._call(h, {"op": "hello"},
                                       timeout_s=30.0)
                    h.meta.update(hello)
                    n_rows = hello.get("n_rows")
                except (OSError, wire.WireError):
                    continue
            self.n_rows = int(n_rows)
        self.measure_clock_offsets()
        flight.record("fleet", "router_up", fleet=self.name,
                      workers=sorted(self.workers),
                      placement=self.placement)

    # -- host fault domains + transport resolution (graft-host) ------------

    def _resolve_transports(self) -> None:
        """Pick each worker's wire transport from host-domain
        topology: same domain as the router → shm descriptors, other
        domain → raw framing, no domain metadata (attached handles,
        older workers) → the original json wire.  A fixed
        ``transport=`` overrides for every worker.  One shared
        SegmentPool is created iff some worker rides shm."""
        want_shm = False
        for h in self.workers.values():
            if self.transport_mode == "auto":
                if h.host_id is None:
                    h.transport = "json"
                elif h.host_id == self.host_id \
                        and h.meta.get("shm"):
                    h.transport = "shm"
                else:
                    h.transport = "raw"
            else:
                h.transport = self.transport_mode
            want_shm = want_shm or h.transport == "shm"
        if want_shm and self.shm is None:
            self.shm = shm_mod.SegmentPool(
                slots=max(16, 4 * len(self.workers)),
                name=f"amtr_{os.getpid()}")

    def host_map(self) -> Dict[str, List[str]]:
        """host_id -> sorted worker ids (workers without a domain
        group under ``host-?``)."""
        domains: Dict[str, List[str]] = {}
        for wid in sorted(self.workers):
            hid = self.workers[wid].host_id or "host-?"
            domains.setdefault(hid, []).append(wid)
        return domains

    def kill_host(self, host_id: str) -> List[str]:
        """SIGKILL every worker in one host fault domain AT ONCE —
        the kill-a-host chaos rung.  Like :meth:`kill_worker`, the
        deaths are DISCOVERED through the wire + heartbeat ladder,
        never short-circuited here.  Returns the victim worker ids."""
        victims = self.host_map().get(host_id, [])
        if not victims:
            raise ValueError(f"unknown host domain {host_id!r} "
                             f"(have {sorted(self.host_map())})")
        for wid in victims:
            self.workers[wid].kill()
        flight.record("fleet", "host_killed", host=host_id,
                      workers=victims)
        return victims

    def live_hosts(self) -> List[str]:
        with self._lock:
            dead = set(self._dead)
        return sorted({h.host_id or "host-?"
                       for wid, h in self.workers.items()
                       if wid not in dead})

    def readmit(self, worker_id: str,
                handle: Optional[WorkerHandle] = None) -> WorkerHandle:
        """Rejoin a buried worker WITHOUT rebuilding the router: a new
        host restarted it (same id, possibly a new port/process) and
        vouches for it.  Replaces the handle when a new one is given,
        clears the dead mark (the ring still carries the id — dead
        workers are excluded at lookup, not removed), resolves the
        new handle's transport, and flips health through its explicit
        :meth:`~arrow_matrix_tpu_torch.fleet.health.HealthMonitor.readmit`
        path — the only way back from a sticky dead verdict."""
        if worker_id not in self.workers:
            raise ValueError(f"unknown worker {worker_id!r}")
        if handle is not None:
            if handle.worker_id != worker_id:
                raise ValueError(
                    f"handle is for {handle.worker_id!r}, not "
                    f"{worker_id!r}")
            self.workers[worker_id] = handle
        self._resolve_transports()
        self.health.readmit(worker_id)
        with self._lock:
            self._dead.discard(worker_id)
        flight.record("fleet", "worker_rejoined", worker=worker_id,
                      host=self.workers[worker_id].host_id)
        if self.verbose:
            print(f"[graft-fleet {self.name}] worker {worker_id} "
                  f"readmitted", flush=True)
        return self.workers[worker_id]

    # -- wire accounting + clock alignment (graft-xray) --------------------

    def _fold_wire_stats_locked(self, st: Dict[str, Any]) -> None:
        self._wire_frames.append(st)
        tot = self._wire_totals
        tot["frames"] += 2       # request + response frames
        tot["bytes_out"] += st["bytes_out"]
        tot["bytes_in"] += st["bytes_in"]
        tot["payload_bytes"] += st.get("payload_bytes", 0)
        tot["shm_bytes"] += st.get("shm_bytes", 0)
        tot["serialize_ms"] += st["serialize_ms"]
        tot["wire_ms"] += st["wire_ms"]

    def _call(self, handle: WorkerHandle, obj: Any, *,
              timeout_s: float = 30.0) -> Any:
        """A worker call with wire accounting: every successful round
        trip's measured bytes/serialize/wire cost lands in the
        router's per-frame list and running totals."""
        st: Dict[str, Any] = {}
        reply = handle.call(obj, timeout_s=timeout_s, stats=st,
                            shm_pool=self.shm)
        if st:
            st["worker"] = handle.worker_id
            with self._lock:
                self._fold_wire_stats_locked(st)
        return reply

    def measure_clock_offsets(self, pings: int = 5) -> Dict[str, dict]:
        """Estimate each worker's wall-clock offset vs the router via
        ``pings`` ``xray_ping`` round trips, keeping the minimum-RTT
        sample (offset = worker_clock − router_midpoint — the classic
        NTP-style bound; same-host it is ~0).  Measured once at startup
        so a worker that later dies still has its offset for trace
        merging."""
        offsets: Dict[str, dict] = {}
        for wid in sorted(self.workers):
            handle = self.workers[wid]
            best: Optional[dict] = None
            for _ in range(max(int(pings), 1)):
                t0 = time.time_ns()
                try:
                    reply = self._call(handle, {"op": "xray_ping"},
                                       timeout_s=10.0)
                except (OSError, wire.WireError):
                    break
                t1 = time.time_ns()
                if not (isinstance(reply, dict) and reply.get("ok")
                        and reply.get("t_ns") is not None):
                    break
                rtt = t1 - t0
                off = int(reply["t_ns"]) - (t0 + t1) // 2
                if best is None or rtt < best["rtt_ns"]:
                    best = {"offset_ns": off, "rtt_ns": rtt}
            if best is not None:
                offsets[wid] = best
        with self._lock:
            self._clock_offsets.update(offsets)
        return offsets

    # -- placement ---------------------------------------------------------

    def plan_packing(self, tenant_ks: Dict[str, int]) -> dict:
        """Bin-pack per-tenant graphs: price each tenant's width-k
        request with the workers' OWN admission model (the ``price``
        op → ``request_bytes_for``), pack against per-worker HBM
        headroom, and pin the assignment for subsequent submits.
        Unplaced tenants shed explicitly at submit time."""
        pricer = self._any_live_handle()
        if pricer is None:
            raise RuntimeError("no live worker to price tenants")
        tenant_bytes = {}
        for tenant, k in sorted(tenant_ks.items()):
            reply = self._call(pricer, {"op": "price", "k": int(k)})
            tenant_bytes[tenant] = int(reply.get("bytes", 0))
        capacities = {}
        for wid, h in self.workers.items():
            if wid in self._dead:
                continue
            reply = self._call(h, {"op": "hello"})
            capacities[wid] = int(reply.get("headroom_bytes", 0))
        assignment, unplaced = pack_tenants(tenant_bytes, capacities)
        with self._lock:
            self._pack_assignment = dict(assignment)
            self._pack_unplaced = set(unplaced)
        flight.record("fleet", "packing_planned",
                      assignment=assignment, unplaced=list(unplaced),
                      tenant_bytes=tenant_bytes,
                      capacities=capacities)
        return {"assignment": assignment, "unplaced": list(unplaced),
                "tenant_bytes": tenant_bytes,
                "capacities": capacities}

    def _any_live_handle(self) -> Optional[WorkerHandle]:
        # Snapshot under the lock: _dispatch threads mutate _dead
        # concurrently, and iterating a set while another thread adds
        # to it raises RuntimeError.
        with self._lock:
            dead = set(self._dead)
        for wid in sorted(self.workers):
            if wid not in dead:
                return self.workers[wid]
        return None

    def _place(self, tenant: str) -> Optional[str]:
        with self._lock:
            dead = set(self._dead)
            # A migrate() pin wins over ring and packing; a pin whose
            # worker died falls through to normal re-homing.
            pin = self._pins.get(tenant)
            if pin is not None and pin not in dead:
                return pin
            if self.placement == "pack":
                wid = self._pack_assignment.get(tenant)
                if wid is None or wid in dead:
                    # A packed tenant whose worker died re-homes via
                    # the ring like everyone else; a tenant that never
                    # packed sheds.
                    if tenant in self._pack_unplaced:
                        return None
                    return self.ring.lookup(tenant, exclude=dead)
                return wid
        return self.ring.lookup(tenant, exclude=dead)

    # -- dispatch ----------------------------------------------------------

    def submit(self, request: rq.Request) -> rq.Ticket:
        """Route one request into the fleet; returns immediately with
        a ticket that completes (or sheds/fails, explicitly) from the
        dispatch thread."""
        faults.inject("fleet.router.submit", target=request.tenant)
        ticket = rq.Ticket(request)
        ticket.submitted_s = time.monotonic()
        with self._lock:
            self._tickets.append(ticket)
        t = threading.Thread(target=self._dispatch, args=(ticket,),
                             daemon=True,
                             name=f"fleet-dispatch-"
                                  f"{request.request_id}")
        with self._lock:
            self._threads.append(t)
        t.start()
        return ticket

    def _count(self, key: str) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1

    def _dispatch(self, ticket: rq.Ticket) -> None:
        req = ticket.request
        # Mint the fleet-level trace id here — the root of this
        # request's distributed trace.  Every frame to a worker is
        # stamped with it, every router span inherits it through the
        # request context, and the ticket keeps it for the report.
        trace_id = xray_mod.new_trace_id()
        ticket.trace = {"trace_id": trace_id}
        with flight.request_context(req.request_id, req.tenant,
                                    trace_id=trace_id), \
                self.tracer.span("dispatch"):
            self._dispatch_attempts(ticket, trace_id)

    def _dispatch_attempts(self, ticket: rq.Ticket,
                           trace_id: str) -> None:
        req = ticket.request
        max_attempts = (3 * len(self.workers) + 1)
        attempt = 0
        while True:
            attempt += 1
            if attempt > max_attempts:
                ticket._finish(rq.FAILED, reason="fleet_retry_"
                                                 "exhausted")
                self._count("failed")
                flight.record("fleet", "retry_exhausted",
                              request=req.request_id,
                              tenant=req.tenant, attempts=attempt - 1)
                return
            wid = self._place(req.tenant)
            if wid is None:
                # The degradation-ladder extension: lost capacity is
                # an explicit shed, never a stall.
                ticket._finish(rq.SHED, reason=SHED_FLEET_CAPACITY)
                self._count("shed")
                flight.record("fleet", "shed_capacity",
                              request=req.request_id,
                              tenant=req.tenant)
                return
            handle = self.workers[wid]
            ticket.worker_id = wid
            try:
                with self.tracer.span("rpc", worker=wid,
                                      attempt=attempt) as span_args:
                    st: Dict[str, Any] = {}
                    reply = handle.call(
                        {"op": "submit",
                         "reply_transport": handle.transport,
                         "xray": {"trace_id": trace_id,
                                  "parent_span": "dispatch",
                                  "send_ns": time.time_ns()},
                         "request": {"request_id": req.request_id,
                                     "tenant": req.tenant, "x": req.x,
                                     "iterations": req.iterations,
                                     "deadline_s": req.deadline_s}},
                        timeout_s=self.submit_timeout_s, stats=st,
                        shm_pool=self.shm)
                    if st:
                        span_args.update(
                            serialize_ms=st["serialize_ms"],
                            wire_ms=st["wire_ms"],
                            bytes_out=st["bytes_out"],
                            bytes_in=st["bytes_in"])
                        st["worker"] = wid
                        with self._lock:
                            self._fold_wire_stats_locked(st)
            except (OSError, wire.WireError, shm_mod.ShmError) as e:
                self._on_worker_failure(wid, f"{type(e).__name__}: "
                                             f"{e}")
                with self._lock:
                    self.requeues += 1
                ticket.requeues = getattr(ticket, "requeues", 0) + 1
                flight.record("fleet", "requeue",
                              request=req.request_id,
                              tenant=req.tenant, from_worker=wid)
                continue
            if not (isinstance(reply, dict) and reply.get("ok")):
                err = (reply or {}).get("error") \
                    if isinstance(reply, dict) else str(reply)
                self.health.record_failure(wid, f"op error: {err}")
                ticket.requeues = getattr(ticket, "requeues", 0) + 1
                continue
            self.health.record_ok(wid)
            status = reply.get("status")
            ticket.faults_seen = int(reply.get("faults_seen") or 0)
            ticket.recoveries = int(reply.get("recoveries") or 0)
            ticket.resumed_step = reply.get("resumed_step")
            ticket.worker_latency_s = reply.get("latency_s")
            if reply.get("served_class"):
                ticket.served_class = reply["served_class"]
            if status == rq.COMPLETED:
                ticket.result = reply.get("result")
                ticket._finish(rq.COMPLETED)
                self._count("completed")
                return
            if status in (rq.SHED, rq.REJECTED, rq.FAILED):
                ticket._finish(status, reason=reply.get("reason"),
                               error=reply.get("error"))
                self._count(status)
                return
            ticket._finish(rq.FAILED, reason="worker_protocol",
                           error=f"unexpected status {status!r}")
            self._count("failed")
            return

    def _on_worker_failure(self, worker_id: str, error: str) -> None:
        """A wire failure is a health question: probe with the
        worker's jittered backoff; only a dead verdict buries it and
        re-homes its tenants."""
        with self._lock:
            if worker_id in self._dead:
                return
        handle = self.workers[worker_id]
        h = self.health.probe(worker_id, handle.host, handle.port)
        if h.alive:
            return
        with self._lock:
            if worker_id in self._dead:
                return
            self._dead.add(worker_id)
            death = {"worker_id": worker_id,
                     "host_id": handle.host_id,
                     "error": error,
                     "health": h.snapshot(),
                     "exit_code": (handle.proc.poll()
                                   if handle.proc else None)}
            self._deaths.append(death)
        flight.record("fleet", "worker_dead", worker=worker_id,
                      host=handle.host_id, error=error)
        if self.verbose:
            print(f"[graft-fleet {self.name}] worker {worker_id} "
                  f"declared dead ({error}); requeueing its work "
                  f"onto survivors", flush=True)

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Wait until every submitted ticket reaches a terminal
        state."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            left = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            t.join(timeout=left)

    # -- chaos helpers -----------------------------------------------------

    def kill_worker(self, worker_id: str) -> None:
        """SIGKILL one spawned worker (tests/gates); the death is
        DISCOVERED through the wire + heartbeats like any real crash,
        not short-circuited here."""
        self.workers[worker_id].kill()

    def live_workers(self) -> List[str]:
        with self._lock:
            return sorted(set(self.workers) - self._dead)

    # -- tenant migration --------------------------------------------------

    def migrate(self, tenant: str, to_worker: Optional[str] = None,
                *, scratch_budget_bytes: int = 1 << 20,
                dry_run: bool = False) -> dict:
        """Rebalance ``tenant`` onto ``to_worker`` (default: the ring's
        next live candidate) via checkpoint handoff on the shared
        sha256-verified checkpoint dir.

        Every checkpoint the tenant's requests have written is handed
        off through a staged :func:`~arrow_matrix_tpu_torch.parallel.reshard
        .handoff_plan` — loaded (sha-verified), copied stage by stage
        under the scratch budget (each stage crossing the
        ``reshard.stage`` fault seam, so kill-mid-migration is a
        testable scenario), and re-saved atomically under its original
        layout tag.  A kill anywhere leaves the source checkpoint
        intact; rerunning the migration lands bit-identical (pure row
        copies).  Then the tenant is PINNED to ``to_worker`` — every
        subsequent placement (new submits and requeues alike) lands
        there, and the destination resumes the handed-off checkpoints
        instead of recomputing.

        ``dry_run`` builds and describes the staged plans (per-stage
        bytes included) without rewriting any checkpoint or moving the
        pin — the ``graft_fleet migrate --dry-run`` output.
        """
        from arrow_matrix_tpu_torch.parallel.reshard import (
            apply_plan_host,
            handoff_plan,
            host_rows,
        )
        from arrow_matrix_tpu_torch.utils.checkpoint import (
            checkpoint_layout_tag,
            list_checkpoints,
            load_state,
            save_state,
        )

        from_worker = self._place(tenant)
        if from_worker is None:
            raise ValueError(f"tenant {tenant!r} has no live "
                             f"placement to migrate from")
        if to_worker is None:
            with self._lock:
                exclude = set(self._dead) | {from_worker}
            to_worker = self.ring.lookup(tenant, exclude=exclude)
        if to_worker is None:
            raise ValueError(f"no live destination worker for tenant "
                             f"{tenant!r} (fleet of "
                             f"{len(self.workers)}, "
                             f"{len(self._dead)} dead)")
        if to_worker not in self.workers:
            raise ValueError(f"unknown worker {to_worker!r}")
        with self._lock:
            if to_worker in self._dead:
                raise ValueError(f"destination worker {to_worker!r} "
                                 f"is dead")
        if to_worker == from_worker:
            raise ValueError(f"tenant {tenant!r} already lives on "
                             f"{to_worker!r}")

        with self._lock:
            request_ids = sorted({
                t.request.request_id for t in self._tickets
                if t.request.tenant == tenant})
        handoffs: List[dict] = []
        total_stages = 0
        if self.checkpoint_dir and request_ids:
            want = {f"ck_{rid}" for rid in request_ids}
            for stem in list_checkpoints(self.checkpoint_dir):
                if os.path.basename(stem) not in want:
                    continue
                tag = checkpoint_layout_tag(stem)
                try:
                    got = load_state(stem, layout=tag)
                except Exception as e:  # noqa: BLE001 — a corrupt
                    # checkpoint must not strand the tenant; the
                    # destination recomputes that request instead.
                    flight.record("fleet", "migrate_checkpoint_skipped",
                                  tenant=tenant, path=stem,
                                  error=f"{type(e).__name__}: {e}")
                    continue
                if got is None:
                    continue
                state, step = got
                x = host_rows(state)
                rows = int(x.shape[0])
                k = int(math.prod(x.shape[1:])) if x.ndim > 1 else 1
                plan = handoff_plan(
                    rows, k, scratch_budget_bytes,
                    itemsize=int(x.dtype.itemsize),
                    src_tag=from_worker, dst_tag=to_worker)
                if not dry_run:
                    y = torch.from_numpy(apply_plan_host(plan, x))
                    if state.dtype == torch.bfloat16:
                        y = y.view(torch.bfloat16)
                    save_state(stem, y, step, layout=tag)
                handoffs.append({
                    "checkpoint": os.path.basename(stem),
                    "rows": rows, "k": k, "step": int(step),
                    "n_stages": plan.n_stages,
                    "stage_bytes": [plan.stage_device_bytes(i)
                                    for i in range(plan.n_stages)],
                    "moved_bytes": plan.moved_bytes,
                    "max_stage_scratch_bytes":
                        plan.max_stage_scratch_bytes,
                    "plan": plan.describe(),
                })
                total_stages += plan.n_stages

        if not dry_run:
            with self._lock:
                self._pins[tenant] = to_worker
                self.migrations += 1
            flight.record("fleet", "tenant_migrated", tenant=tenant,
                          from_worker=from_worker, to_worker=to_worker,
                          checkpoints=len(handoffs),
                          stages=total_stages)
            print(f"[graft-fleet {self.name}] migrated tenant "
                  f"{tenant}: {from_worker} -> {to_worker}, "
                  f"{len(handoffs)} checkpoint(s) handed off through "
                  f"{total_stages} staged plan step(s)", flush=True)
        return {"tenant": tenant, "from_worker": from_worker,
                "to_worker": to_worker, "dry_run": bool(dry_run),
                "scratch_budget_bytes": int(scratch_budget_bytes),
                "checkpoints": handoffs,
                "total_stages": total_stages,
                "moved_bytes": sum(h["moved_bytes"]
                                   for h in handoffs)}

    # -- reporting ---------------------------------------------------------

    def fleet_summary(self) -> dict:
        """The merged fleet SLO report.  Quantiles are EXACT: every
        worker ships its raw per-request latency samples (``summary``
        op) and they are pooled through one mergeable Histogram —
        ``latency_ms.p99`` is the nearest-rank p99 of the union of
        samples, the acceptance bar the fleet gate checks."""
        worker_reports: Dict[str, dict] = {}
        pooled = Histogram(name="fleet_latency_ms")
        for wid in sorted(self.workers):
            handle = self.workers[wid]
            with self._lock:
                dead = wid in self._dead
            if dead:
                health = self.health.snapshot()
                worker_reports[wid] = {
                    "alive": False,
                    "health": health.get(wid)}
                continue
            try:
                reply = self._call(handle, {"op": "summary"},
                                   timeout_s=30.0)
            except (OSError, wire.WireError) as e:
                worker_reports[wid] = {"alive": False,
                                       "error": f"{type(e).__name__}"
                                                f": {e}"}
                continue
            samples = [float(v) for v in
                       reply.get("latency_samples_ms") or []]
            h = Histogram(name=f"latency_ms:{wid}")
            h.values.extend(samples)
            pooled.merge(h)
            worker_reports[wid] = {
                "alive": True,
                "summary": reply.get("summary"),
                "latency_samples_ms": samples,
                "kernel_launches": reply.get("kernel_launches"),
                "device_memory": reply.get("device_memory"),
                "pulse_ring": reply.get("pulse_ring"),
                "ledger_dir": reply.get("ledger_dir"),
            }
        with self._lock:
            tickets = list(self._tickets)
            counts = dict(self._counts)
            deaths = [dict(d) for d in self._deaths]
            requeues = self.requeues
            migrations = self.migrations
            pins = dict(self._pins)
            dead_workers = sorted(self._dead)
            wire_totals = dict(self._wire_totals)
            wire_frames = [dict(f) for f in self._wire_frames]
            clock_offsets = {k: dict(v)
                             for k, v in self._clock_offsets.items()}
        wall = time.perf_counter() - self.started_s
        completed = counts.get("completed", 0)
        shed_reasons: Dict[str, int] = {}
        for t in tickets:
            if t.status in (rq.SHED, rq.REJECTED) and t.reason:
                shed_reasons[t.reason] = \
                    shed_reasons.get(t.reason, 0) + 1
        router_lat = Histogram(name="router_latency_ms")
        router_lat.values.extend(
            [t.latency_s * 1e3 for t in tickets
             if t.status == rq.COMPLETED and t.latency_s is not None])
        return {
            "fleet": self.name,
            "placement": self.placement,
            "router_host": self.host_id,
            "hosts": self.host_map(),
            "live_hosts": self.live_hosts(),
            "transports": {wid: h.transport
                           for wid, h in sorted(self.workers.items())},
            "shm_pool": (self.shm.stats() if self.shm is not None
                         else None),
            "device": (str(self.device) if self.device is not None
                       else None),
            "card_budget_bytes": self.card_budget_bytes,
            "num_workers": len(self.workers),
            "live_workers": self.live_workers(),
            "dead_workers": dead_workers,
            "deaths": deaths,
            "requests": len(tickets),
            "completed": completed,
            "failed": counts.get("failed", 0),
            "shed": counts.get("shed", 0),
            "rejected": counts.get("rejected", 0),
            "shed_reasons": shed_reasons,
            "requeues": requeues,
            "migrations": migrations,
            "tenant_pins": pins,
            "wall_s": wall,
            "requests_per_s": (completed / wall) if wall > 0
            else None,
            # Exact pooled quantiles over every worker's raw samples.
            "latency_ms": pooled.summary(),
            "router_latency_ms": router_lat.summary(),
            # graft-xray wire cost ledger: per-round-trip frames plus
            # running totals (summing the frames MUST reproduce the
            # totals — obs_gate's byte-conservation check).
            "wire": {"totals": wire_totals, "frames": wire_frames},
            "clock_offsets_ns": clock_offsets,
            "health": self.health.snapshot(),
            "workers": worker_reports,
        }

    def fold_ledgers(self, directory: Optional[str] = None) -> int:
        """Fold every worker's run-dir-local ledger store into ONE
        chained fleet history (kind ``fleet``) under ``directory``
        (default ``<run_dir>/ledger``); returns the number of folded
        records.  Each folded record keeps the origin worker, kind,
        and record id in its payload and its device stamp (platform,
        device kind), so the per-worker provenance survives the
        merge."""
        if directory is None:
            if not self.run_dir:
                raise ValueError("fold_ledgers needs a directory "
                                 "(router has no run_dir)")
            directory = os.path.join(self.run_dir, "ledger")
        target = ledger_store.Ledger(directory)
        folded = 0
        for wid in sorted(self.workers):
            handle = self.workers[wid]
            if not handle.obs_dir:
                continue
            src_dir = os.path.join(handle.obs_dir, "ledger")
            src = ledger_store.Ledger(src_dir)
            for recd in src.read_all():
                if not isinstance(recd, dict):
                    continue
                target.record(
                    "fleet", str(recd.get("metric")),
                    recd.get("value"),
                    unit=recd.get("unit"),
                    structure_hash=recd.get("structure_hash"),
                    host_load=recd.get("host_load"),
                    git_rev=recd.get("git_rev"),
                    platform=recd.get("platform"),
                    device_kind=recd.get("device_kind"),
                    knobs={"origin_worker": wid,
                           **(recd.get("knobs") or {})},
                    payload={"origin_kind": recd.get("kind"),
                             "origin_record_id":
                                 recd.get("record_id"),
                             **(recd.get("payload") or {})})
                folded += 1
        return folded

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Graceful stop: shutdown op to every live worker (closing
        their pulse rings + run-dir ledgers + worker summaries), then
        reap; SIGKILL anything that lingers."""
        for wid in sorted(self.workers):
            handle = self.workers[wid]
            with self._lock:
                dead = wid in self._dead
            if not dead:
                try:
                    self._call(handle, {"op": "shutdown"},
                               timeout_s=timeout_s)
                except (OSError, wire.WireError):
                    pass
            handle.reap(timeout_s=timeout_s)
        if self.shm is not None:
            # Leak/tear detection stays LOUD in the report (flight
            # event + stderr) but must not mask the shutdown itself:
            # a request that died mid-flight legitimately strands its
            # pin, and close() reclaims the segments either way.
            problems = self.shm.close(strict=False)
            for p in problems:
                print(f"[graft-fleet {self.name}] shm: {p}",
                      file=sys.stderr, flush=True)
        flight.record("fleet", "router_down", fleet=self.name,
                      dead=sorted(self._dead))

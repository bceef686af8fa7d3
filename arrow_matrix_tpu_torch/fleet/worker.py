"""One fleet worker: a full ArrowServer behind a threaded TCP front.

The port's copy of ``arrow_matrix_tpu/fleet/worker.py``.  Spawned as
``python -m arrow_matrix_tpu_torch.fleet.worker`` (the router does
this), the worker builds the resident Barabasi-Albert operator on its
device (the card unless ``--device cpu``; it never falls back to the
CPU), stands up a complete
:class:`~arrow_matrix_tpu_torch.serve.ArrowServer` — supervisor
retries, HBM admission, checkpoint-resume, pulse ring, run-dir ledger
— and serves the fleet wire ops on an ephemeral TCP port.  The bound
port is announced on stdout as one line::

    FLEET_WORKER_READY {"worker_id": ..., "port": ..., "pid": ...}

which is the router's spawn handshake (no port files, no races).

Ops: ``hello`` / ``health`` (heartbeat), ``price`` (the admission
price of a width-k request), ``submit`` (one request, answered when it
reaches a terminal state — ThreadingTCPServer gives each in-flight
request its own connection thread), ``xray_ping`` (the clock-offset
handshake), ``summary`` (SLO census + RAW latency samples, so the
router's fleet quantiles pool exactly, and the process's kernel
launch counts and device memory), ``shutdown``.

Robustness seams: ``AMT_FAULT_PLAN`` is read at import, so a plan in
the spawn env arms this process — a ``kill`` plan on ``*.step``
SIGKILLs the worker mid-batch deterministically (the fleet gate's
scenario), and ``fleet.worker.submit`` / ``fleet.worker.health`` give
plans the worker-side seams.  Retry jitter is re-seeded per worker id
(``RetryPolicy.for_worker``) so N workers never retry in lockstep.
The checkpoint directory is SHARED fleet-wide and keys are
per-request (``max_batch_k=0``), which is what makes requeue-on-death
idempotent: a survivor replaying a dead worker's request resumes its
sha256-verified checkpoint instead of recomputing.

:func:`maybe_init_distributed` reads the ``AMT_FLEET_COORDINATOR`` /
``AMT_FLEET_NUM_PROCESSES`` / ``AMT_FLEET_PROCESS_ID`` triple that
``fleet/host.plan_host_mesh`` writes: unset it is a no-op; set, the
worker joins one ``torch.distributed`` job at the coordinator's address
as that rank.
"""

from __future__ import annotations

import argparse
import json
import os
import socketserver
import sys
import threading
import time
from typing import Optional

import numpy as np

from arrow_matrix_tpu_torch import faults
from arrow_matrix_tpu_torch.faults.policy import RetryPolicy
from arrow_matrix_tpu_torch.fleet import shm
from arrow_matrix_tpu_torch.fleet import wire
from arrow_matrix_tpu_torch.ledger import store as ledger_store
from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.obs import xray as xray_mod
from arrow_matrix_tpu_torch.obs.tracer import Tracer
from arrow_matrix_tpu_torch.serve import request as rq
from arrow_matrix_tpu_torch.serve.loadgen import ba_executor_factory
from arrow_matrix_tpu_torch.serve.scheduler import ArrowServer, ExecConfig
from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device

#: The environment triple of one rank of a global job.
DISTRIBUTED_ENV = ("AMT_FLEET_COORDINATOR", "AMT_FLEET_NUM_PROCESSES",
                   "AMT_FLEET_PROCESS_ID")


def maybe_init_distributed(verbose: bool = False, device=None) -> bool:
    """Join one ``torch.distributed`` job when the
    ``AMT_FLEET_COORDINATOR`` (``host:port``) / ``AMT_FLEET_NUM_PROCESSES``
    / ``AMT_FLEET_PROCESS_ID`` triple is set (``fleet/host.plan_host_mesh``
    writes it); a no-op returning False otherwise.  The rendezvous is the
    coordinator's TCP address (``parallel/mesh.init_distributed``); the
    backend comes from the rank's device (``device``: the card unless
    "cpu"): NCCL only when the machine has a card for every rank, else
    gloo.  Returns True once joined."""
    coord = os.environ.get("AMT_FLEET_COORDINATOR")
    nproc = os.environ.get("AMT_FLEET_NUM_PROCESSES")
    pid = os.environ.get("AMT_FLEET_PROCESS_ID")
    if not (coord and nproc and pid):
        return False
    import torch

    from arrow_matrix_tpu_torch.parallel.mesh import (
        init_distributed,
        rank_device,
        set_rank_device,
    )

    world, rank = int(nproc), int(pid)
    dev = rank_device(rank, device)
    one_card_a_rank = (dev.type == "cuda"
                       and torch.cuda.device_count() >= world)
    backend = "nccl" if one_card_a_rank else "gloo"
    set_rank_device(dev)
    init_distributed(rank, world, backend, dev,
                     init_method=f"tcp://{coord}")
    if verbose:
        print(f"[graft-fleet] torch.distributed up: rank {rank}/{world} "
              f"via {coord} over {backend} on {dev}", flush=True)
    return True


def kernel_launches() -> dict:
    """This process's kernel launch counts so far: K1, K2, K3, K4 (row
    gathers) and K4 gather-adds, as the kernels' wrappers count them
    (zero on the CPU, where the plain versions run)."""
    from arrow_matrix_tpu_torch.ops import (
        cuda_blocks,
        cuda_gather,
        cuda_sell,
    )

    return {"K1": cuda_sell.LAUNCHES, "K2": cuda_blocks.LAUNCHES_K2,
            "K3": cuda_blocks.LAUNCHES_K3, "K4": cuda_gather.LAUNCHES,
            "K4 add": cuda_gather.LAUNCHES_ADD}


def device_memory(device) -> Optional[dict]:
    """This process's memory on ``device`` as its caching allocator
    counts it (bytes in tensors now and at peak, bytes reserved now and
    at peak); None on the CPU.  The CUDA context comes on top."""
    if device.type != "cuda":
        return None
    import torch

    return {"allocated": torch.cuda.memory_allocated(device),
            "max_allocated": torch.cuda.max_memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device),
            "max_reserved": torch.cuda.max_memory_reserved(device)}


class FleetWorker:
    """The serving half of one fleet process: owns the ArrowServer
    and answers wire ops.  Separated from ``main()`` so tests can run a
    worker in-process."""

    def __init__(self, worker_id: str, *, vertices: int = 128,
                 width: int = 16, seed: int = 11, fmt: str = "fold",
                 queue_capacity: int = 64,
                 hbm_budget_bytes: Optional[int] = None,
                 max_batch_k: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 2,
                 obs_dir: Optional[str] = None,
                 window_s: float = 0.25,
                 host_id: Optional[str] = None,
                 shm_slots: int = 0,
                 device: DeviceLike = None,
                 verbose: bool = False):
        tic = time.perf_counter()
        self.worker_id = worker_id
        self.verbose = verbose
        self.obs_dir = obs_dir
        self.monitor = None
        self.device = resolve_device(device)
        # The worker's host fault domain (spawn env AMT_HOST_ID) and,
        # when enabled, its reply-side segment pool — replies ride shm
        # descriptors back to a same-host router.  Reply publishes are
        # unpinned: the worker cannot know when the remote reader is
        # done, so slots recycle on demand and the generation stamp is
        # the (loud) safety net.
        self.host_id = host_id
        self.shm = (shm.SegmentPool(slots=int(shm_slots),
                                    name=f"amtw{os.getpid()}")
                    if shm_slots > 0 else None)
        # One tracer per worker process; the scheduler and Supervisor
        # emit their spans into it, each stamped with the fleet-level
        # trace context entered at the wire (op_submit).
        self.tracer = Tracer(name=worker_id)
        factory, self.n_rows = ba_executor_factory(vertices, width,
                                                   seed, fmt=fmt,
                                                   device=self.device)
        policy = RetryPolicy(jitter=0.5).for_worker(worker_id)
        self.server = ArrowServer(
            factory, ExecConfig(),
            hbm_budget_bytes=hbm_budget_bytes,
            queue_capacity=queue_capacity,
            policy=policy,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            max_batch_k=max_batch_k,
            tracer=self.tracer,
            name=worker_id, verbose=verbose)
        if obs_dir:
            from arrow_matrix_tpu_torch.obs import pulse as pulse_mod

            os.makedirs(obs_dir, exist_ok=True)
            self.monitor = pulse_mod.PulseMonitor(
                window_s=window_s, name=worker_id,
                ring_path=os.path.join(obs_dir, "pulse_ring.json"),
                ledger_dir=os.path.join(obs_dir, "ledger"))
            self.server.attach_pulse(self.monitor)
        self.build_s = time.perf_counter() - tic
        self.started_s = time.perf_counter()
        self.server.start()

    # -- wire ops ----------------------------------------------------------

    def op_hello(self, msg: dict) -> dict:
        acct = self.server.accountant
        return {"ok": True, "worker_id": self.worker_id,
                "pid": os.getpid(), "n_rows": self.n_rows,
                "host_id": self.host_id,
                "shm": self.shm is not None,
                "device": str(self.device),
                "build_s": self.build_s,
                "budget_bytes": int(acct.budget_bytes),
                "headroom_bytes": int(acct.headroom_bytes())}

    def op_price(self, msg: dict) -> dict:
        """Admission price of a width-``k`` request on THIS worker —
        the same ``request_bytes_for`` model the admission controller
        charges, exported so the router's bin-packing placement prices
        tenants with the pricing admission already trusts."""
        from arrow_matrix_tpu_torch.serve.admission import (
            request_price_bytes,
        )

        k = int(msg.get("k", 1))
        executor = self.server._executors.get(self.server.base_config)
        price = request_price_bytes(
            executor, k, itemsize=self.server.itemsize,
            repl=self.server.base_config.repl)
        acct = self.server.accountant
        return {"ok": True, "worker_id": self.worker_id, "k": k,
                "bytes": int(price or 0),
                "budget_bytes": int(acct.budget_bytes),
                "headroom_bytes": int(acct.headroom_bytes())}

    def op_health(self, msg: dict) -> dict:
        faults.inject("fleet.worker.health", target=self.worker_id)
        return {"ok": True, "worker_id": self.worker_id,
                "pid": os.getpid(), "counts": self.server.counts()}

    def op_submit(self, msg: dict) -> dict:
        req = msg.get("request") or {}
        tenant = str(req.get("tenant"))
        faults.inject("fleet.worker.submit", target=tenant)
        x = req.get("x")
        if not isinstance(x, np.ndarray):
            return {"ok": False,
                    "error": "submit carries no feature array"}
        # Enter the fleet-level trace context stamped on the frame by
        # the router: every span / flight event / Supervisor attempt
        # this request triggers carries its trace_id from here on.
        xr = msg.get("xray") or {}
        with flight.request_context(str(req.get("request_id")), tenant,
                                    trace_id=xr.get("trace_id"),
                                    parent_span=xr.get("parent_span")), \
                self.tracer.span("worker_submit",
                                 send_ns=xr.get("send_ns")):
            ticket = self.server.submit(rq.Request(
                request_id=str(req.get("request_id")), tenant=tenant,
                x=x, iterations=int(req.get("iterations", 1)),
                deadline_s=req.get("deadline_s")))
            ticket.wait()
        reply = {"ok": True, "worker_id": self.worker_id,
                 "request_id": ticket.request.request_id,
                 "tenant": tenant, "status": ticket.status,
                 "reason": ticket.reason, "error": ticket.error,
                 "latency_s": ticket.latency_s,
                 "faults_seen": ticket.faults_seen,
                 "recoveries": ticket.recoveries,
                 "resumed_step": ticket.resumed_step,
                 "served_class": getattr(ticket, "served_class", None)}
        if ticket.status == rq.COMPLETED:
            reply["result"] = ticket.result
        return reply

    def op_xray_ping(self, msg: dict) -> dict:
        """Clock-offset handshake: answer with this process's wall
        clock in ns.  The router brackets the call with its own clock
        and estimates the offset from the minimum-RTT ping."""
        return {"ok": True, "worker_id": self.worker_id,
                "t_ns": time.time_ns(), "pid": os.getpid()}

    def op_summary(self, msg: dict) -> dict:
        return {"ok": True, "worker_id": self.worker_id,
                "pid": os.getpid(),
                "summary": self.server.summary(),
                "latency_samples_ms": self.server.latency_samples_ms(),
                "kernel_launches": kernel_launches(),
                "device_memory": device_memory(self.device),
                "obs_dir": self.obs_dir,
                "pulse_ring": (os.path.join(self.obs_dir,
                                            "pulse_ring.json")
                               if self.obs_dir else None),
                "ledger_dir": (os.path.join(self.obs_dir, "ledger")
                               if self.obs_dir else None)}

    def handle(self, msg: dict) -> dict:
        op = msg.get("op") if isinstance(msg, dict) else None
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            return {"ok": False, "error": f"unknown op: {op!r}"}
        try:
            return fn(msg)
        except Exception as e:
            # An injected error (or any op bug) becomes a structured
            # failure reply — the ROUTER decides whether that worker
            # is dying; one bad op must not kill the process.
            return {"ok": False,
                    "error": f"{type(e).__name__}: {e}"}

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> dict:
        """Shut the server down, close the pulse ring, persist the
        worker's SLO census + raw samples and a run-dir ledger record
        stamped with the worker's device; returns the written census."""
        self.server.shutdown(wait=True)
        wall = time.perf_counter() - self.started_s
        census = {"worker_id": self.worker_id,
                  "wall_s": wall,
                  "build_s": self.build_s,
                  "device": str(self.device),
                  "kernel_launches": kernel_launches(),
                  "device_memory": device_memory(self.device),
                  "summary": self.server.summary(),
                  "latency_samples_ms":
                      self.server.latency_samples_ms()}
        if self.monitor is not None:
            self.monitor.close()
        if self.shm is not None:
            # Reply segments are unpinned by design, so a clean close
            # reports no leaks; anything it DOES report is real.
            for p in self.shm.close(strict=False):
                print(f"[graft-fleet {self.worker_id}] shm: {p}",
                      file=sys.stderr, flush=True)
        if self.obs_dir:
            xray_mod.save_process_trace(
                self.tracer,
                os.path.join(self.obs_dir, "xray_trace.json"),
                self.worker_id)
            atomic_write_json(
                os.path.join(self.obs_dir, "worker_summary.json"),
                census, indent=2, sort_keys=True)
            completed = census["summary"]["completed"]
            ledger_store.record(
                "fleet", "worker_requests_per_s",
                (completed / wall) if wall > 0 else None,
                directory=os.path.join(self.obs_dir, "ledger"),
                unit="req/s",
                knobs={"worker_id": self.worker_id},
                payload={key: census["summary"][key] for key in
                         ("completed", "failed", "shed", "rejected",
                          "faults_seen", "recoveries")},
                **ledger_store.device_stamp(self.device))
        return census


def serve_worker(worker: FleetWorker, *, host: str = "127.0.0.1",
                 port: int = 0, announce=None) -> None:
    """Run the wire front for ``worker`` until a ``shutdown`` op:
    binds (``port=0`` → ephemeral), calls ``announce(bound_port)``,
    then serves.  Blocks the calling thread."""
    done = threading.Event()

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                msg = wire.recv_msg(self.request, role="server")
            except (OSError, wire.WireError):
                return
            if isinstance(msg, dict) and msg.get("op") == "shutdown":
                reply = {"ok": True, "worker_id": worker.worker_id}
                try:
                    wire.send_msg(self.request, reply, role="server")
                except (OSError, wire.WireError):
                    pass
                done.set()
                return
            reply = worker.handle(msg)
            # Mirror the transport the router asked for: shm replies
            # ride this worker's own (unpinned) segment pool, raw
            # replies the scatter-gather framing; anything else is
            # the original json wire.
            want = (msg.get("reply_transport")
                    if isinstance(msg, dict) else None)
            transport = "json"
            pool = None
            if want == "shm" and worker.shm is not None:
                transport, pool = "shm", worker.shm
            elif want == "raw":
                transport = "raw"
            try:
                wire.send_msg(self.request, reply, role="server",
                              transport=transport, shm_pool=pool,
                              pin=False)
            except (OSError, wire.WireError, shm.ShmError):
                pass

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as srv:
        bound = srv.server_address[1]
        if announce is not None:
            announce(bound)
        t = threading.Thread(target=srv.serve_forever,
                             kwargs={"poll_interval": 0.05},
                             daemon=True)
        t.start()
        done.wait()
        srv.shutdown()
        t.join(timeout=5.0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m arrow_matrix_tpu_torch.fleet.worker",
        description="One fleet worker process (spawned by FleetRouter; "
                    "announces FLEET_WORKER_READY on stdout).")
    p.add_argument("--worker_id", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 binds an ephemeral port (default)")
    p.add_argument("--vertices", type=int, default=128)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--fmt", default="fold")
    p.add_argument("--queue", type=int, default=64)
    p.add_argument("--hbm_budget_mb", type=float, default=0.0,
                   help="0 uses the device's own budget")
    p.add_argument("--max_batch_k", type=int, default=0,
                   help="keep 0: per-request checkpoint keys are "
                        "what makes cross-worker requeue idempotent")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every", type=int, default=2)
    p.add_argument("--obs_dir", default=None)
    p.add_argument("--window_s", type=float, default=0.25)
    p.add_argument("--shm_slots", type=int, default=16,
                   help="reply-side segment pool size (armed only "
                        "when the spawn env sets AMT_SHM=1)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card; raises without "
                        "one) or 'cpu'")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    maybe_init_distributed(verbose=args.verbose, device=args.device)
    if args.obs_dir:
        # The flight ring flushes eagerly per event, so when this
        # process dies by SIGKILL mid-batch its completed spans are
        # already on disk — xray recovers the partial trace from
        # exactly this artifact.
        os.makedirs(args.obs_dir, exist_ok=True)
        flight.install(os.path.join(args.obs_dir, "flight.json"))
    budget = (int(args.hbm_budget_mb * 2**20)
              if args.hbm_budget_mb > 0 else None)
    # Spawn env: the host fault domain this process belongs to, and
    # whether to stand up the reply-side shm pool (the router only
    # uses it for same-domain workers, but arming is cheap).
    host_id = os.environ.get("AMT_HOST_ID")
    shm_slots = (args.shm_slots
                 if os.environ.get("AMT_SHM") == "1" else 0)
    worker = FleetWorker(
        args.worker_id, vertices=args.vertices, width=args.width,
        seed=args.seed, fmt=args.fmt, queue_capacity=args.queue,
        hbm_budget_bytes=budget, max_batch_k=args.max_batch_k,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        obs_dir=args.obs_dir, window_s=args.window_s,
        host_id=host_id, shm_slots=shm_slots, device=args.device,
        verbose=args.verbose)

    def announce(port: int) -> None:
        print("FLEET_WORKER_READY " + json.dumps(
            {"worker_id": args.worker_id, "port": port,
             "pid": os.getpid(), "host_id": host_id,
             "shm": worker.shm is not None,
             "device": str(worker.device),
             "build_s": worker.build_s}), flush=True)

    try:
        serve_worker(worker, host=args.host, port=args.port,
                     announce=announce)
    finally:
        worker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The multi-process ArrowServer fleet.

The port's copy of ``arrow_matrix_tpu/fleet``: N worker processes, each
a full :class:`~arrow_matrix_tpu_torch.serve.ArrowServer` on the card
(or, when asked, the CPU), behind one router.

  * :mod:`~arrow_matrix_tpu_torch.fleet.wire` — length-prefixed frames
    over a socket, three transports (base64 JSON, raw buffers,
    shared-memory descriptors), with fault seams at
    ``fleet.wire.send`` / ``fleet.wire.recv``; payloads are numpy, and
    a torch tensor is refused;
  * :mod:`~arrow_matrix_tpu_torch.fleet.shm` — the same-host
    shared-memory segment pool, generation-stamped descriptors, and the
    reusable receive buffers;
  * :mod:`~arrow_matrix_tpu_torch.fleet.worker` — one spawned process
    (``python -m arrow_matrix_tpu_torch.fleet.worker``) serving the
    wire ops; retry jitter seeded per worker id;
  * :mod:`~arrow_matrix_tpu_torch.fleet.health` — heartbeat-based
    worker health with timeout and per-worker jittered backoff;
  * :mod:`~arrow_matrix_tpu_torch.fleet.placement` — tenant placement:
    a consistent-hash ring, and first-fit-decreasing packing against
    per-worker budgets;
  * :mod:`~arrow_matrix_tpu_torch.fleet.router` — the front end:
    places, dispatches, watches, requeues a dead worker's unfinished
    requests onto survivors (which resume its checkpoints), migrates
    tenants, and reports exact pooled quantiles; on the card its
    workers share one HBM budget;
  * :mod:`~arrow_matrix_tpu_torch.fleet.host` — host fault domains and
    the shared-nothing router quorum.

Gate: ``arrow_matrix_tpu_torch/tools/fleet_gate.py``.  CLI: ``python -m
arrow_matrix_tpu_torch.cli.graft_fleet``.
"""

from arrow_matrix_tpu_torch.fleet.health import HealthMonitor, WorkerHealth
from arrow_matrix_tpu_torch.fleet.placement import (
    ConsistentHashRing,
    pack_tenants,
)
from arrow_matrix_tpu_torch.fleet.router import FleetRouter, WorkerHandle
from arrow_matrix_tpu_torch.fleet.shm import BufferRing, SegmentPool
from arrow_matrix_tpu_torch.fleet.wire import (
    WireError,
    decode_payload,
    encode_payload,
    measure_transports,
    recv_msg,
    recv_msg_stats,
    request_call,
    send_msg,
)

__all__ = [
    "BufferRing",
    "ConsistentHashRing",
    "FleetRouter",
    "HealthMonitor",
    "SegmentPool",
    "WireError",
    "WorkerHandle",
    "WorkerHealth",
    "decode_payload",
    "encode_payload",
    "measure_transports",
    "pack_tenants",
    "recv_msg",
    "recv_msg_stats",
    "request_call",
    "send_msg",
]

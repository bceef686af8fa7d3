"""The fleet's data plane: the first modules of a multi-process server.

The port's copy of the parts of ``arrow_matrix_tpu/fleet`` that the
worker processes and the router stand on:

  * :mod:`~arrow_matrix_tpu_torch.fleet.wire` — length-prefixed frames
    over a socket, three transports (base64 JSON, raw buffers,
    shared-memory descriptors), with fault seams at
    ``fleet.wire.send`` / ``fleet.wire.recv``; payloads are numpy, and
    a torch tensor is refused;
  * :mod:`~arrow_matrix_tpu_torch.fleet.shm` — the same-host
    shared-memory segment pool, generation-stamped descriptors, and the
    reusable receive buffers;
  * :mod:`~arrow_matrix_tpu_torch.fleet.health` — heartbeat-based
    worker health with timeout and per-worker jittered backoff;
  * :mod:`~arrow_matrix_tpu_torch.fleet.placement` — tenant placement:
    a consistent-hash ring, and first-fit-decreasing packing against
    per-worker budgets.

The worker, the host, the router and ``graft_fleet`` are not ported
yet (ROADMAP.md Queue A, "Runtime: fleet/").
"""

from arrow_matrix_tpu_torch.fleet.health import HealthMonitor, WorkerHealth
from arrow_matrix_tpu_torch.fleet.placement import (
    ConsistentHashRing,
    pack_tenants,
)
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
    "HealthMonitor",
    "SegmentPool",
    "WireError",
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

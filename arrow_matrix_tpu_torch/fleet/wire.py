"""The fleet wire protocol: length-prefixed frames over TCP, stdlib only.

The port's copy of ``arrow_matrix_tpu/fleet/wire.py``: the same
behaviour and on-wire or on-disk forms.

Payloads are numpy: a ``torch.Tensor`` anywhere in a message is refused
with a ``TypeError`` before a byte is sent, so the wire never copies a
device tensor to the host (and waits for its device) on its own; copy
it to the host first (``t.cpu().numpy()``).

One frame is an 8-byte big-endian unsigned length followed by that
many payload bytes.  Three transports share the framing (the receiver
auto-detects, so mixed fleets interoperate):

* **json** (the original wire): the payload is UTF-8 JSON; numpy
  arrays ride inside as ``{"__nd__": 1, "dtype": ..., "shape": [...],
  "data": <base64>}`` envelopes (:func:`encode_payload` /
  :func:`decode_payload` walk nested containers).  Exact but
  copy-heavy: base64 costs ~1.33x the payload plus an encode/decode
  pass.
* **raw** (cross-host): the header's top bit (:data:`RAW_FLAG`) marks
  a composite payload — a 4-byte JSON length, the JSON (arrays
  replaced by ``{"__rawnd__": i, "offset", "nbytes", ...}``
  placeholders), then the concatenated raw array buffers, scatter-
  gathered on send (``sendmsg``) and received into the preallocated
  reusable buffers of :class:`~arrow_matrix_tpu_torch.fleet.shm.BufferRing`
  — no base64, no megabyte JSON walk, no per-frame allocation.
* **shm** (same-host): arrays are published into a
  :class:`~arrow_matrix_tpu_torch.fleet.shm.SegmentPool` and the JSON frame
  carries ~200 B generation-stamped *descriptors*
  (:mod:`arrow_matrix_tpu_torch.fleet.shm`); the receiver attaches the
  segment and memcpys out.  A descriptor whose segment was recycled
  fails LOUDLY (generation stamp) and surfaces here as a
  :class:`WireError` — the router requeues, it never reads another
  payload's bytes.

All three are bit-exact: a decoded array is identical to the encoded
one, which is what lets the fleet gate compare fleet results
byte-for-byte against a single-process replay.

Fault seams: every frame send/receive passes through
``faults.inject("fleet.wire.send")`` / ``("fleet.wire.recv")``, so an
``AMT_FAULT_PLAN`` can hang, error, or SIGKILL a process AT the wire —
the seam where a real network partition or a dying peer shows up.  A
torn or oversized frame raises :class:`WireError`, never a silent
truncation; the router treats any wire failure as a worker-health
question, not an answer.

Instrumentation: every frame is measured from inside the
wire (numba-mpi's argument — measure comm in the runtime, not around
it).  ``serialize_ms`` (encode/decode + JSON), ``frame_bytes``
(actual socket bytes), ``payload_bytes`` (logical ndarray bytes the
frame moves), ``shm_bytes`` (the slice of payload riding shared
memory), and ``wire_ms`` (socket time; on recv split into header wait
vs payload transfer) are recorded per message kind into the
process-global ``MetricsRegistry`` and returned to callers that want
per-call accounting (``request_call(..., stats=...)`` — the router's
wire ledger).  The per-transport ``serialize_ms`` / ``frame_bytes``
deltas are exactly what :func:`measure_transports` benches and the
ledger's ``serialize_ms_per_mb_*`` records gate: replacing base64
must SHOW UP as a gated drop.  A frame within
:data:`NEAR_LIMIT_FRACTION` of ``MAX_FRAME_BYTES`` is delivered but
complains LOUDLY (:class:`WireNearLimitWarning` + a flight event + a
counter): the warn-before-wedge rung below the hard refusal.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from arrow_matrix_tpu_torch import faults
from arrow_matrix_tpu_torch.fleet import shm as shm_mod

#: Frame header: one 8-byte big-endian unsigned payload length.
_HEADER = struct.Struct(">Q")

#: Raw-framing JSON-section length prefix (inside the frame payload).
_RAW_JSON_HEADER = struct.Struct(">I")

#: Refuse frames beyond this (a corrupted header would otherwise ask
#: for exabytes and wedge the reader in recv).
MAX_FRAME_BYTES = 1 << 30

#: Top bit of the frame length marks a raw-framed composite payload.
#: Unambiguous: lengths above MAX_FRAME_BYTES are refused, so the high
#: bits of a legitimate json-framed length are always zero.
RAW_FLAG = 1 << 63

#: Fraction of ``MAX_FRAME_BYTES`` at which a frame is still delivered
#: but warns loudly — the operator hears about a wedge-in-waiting
#: before the hard limit turns it into a failed request.
NEAR_LIMIT_FRACTION = 0.99

#: Arrays below this ride inline (base64) even on the shm transport:
#: a descriptor plus two memcpys costs more than 1 KiB of base64.
SHM_MIN_BYTES = 1024

#: The valid transport names (``auto`` resolves at the router from
#: host-domain topology: same host → shm, cross host → raw).
TRANSPORTS = ("json", "raw", "shm")


class WireError(RuntimeError):
    """A framing-level failure: torn frame, oversized length, closed
    peer mid-frame, undecodable payload, or a dead shm descriptor."""


class WireNearLimitWarning(RuntimeWarning):
    """A frame came within ``NEAR_LIMIT_FRACTION`` of
    ``MAX_FRAME_BYTES``: the next growth step wedges the wire."""


#: Long-lived threads (router dispatch loops) reuse one BufferRing per
#: thread for raw-frame receives; short-lived connection handlers pay
#: one allocation.
_thread_local = threading.local()


def _default_ring() -> shm_mod.BufferRing:
    ring = getattr(_thread_local, "ring", None)
    if ring is None:
        ring = _thread_local.ring = shm_mod.BufferRing()
    return ring


def _frame_kind(obj: Any) -> str:
    """The message kind a frame is accounted under (its ``op``)."""
    if isinstance(obj, dict) and obj.get("op") is not None:
        return str(obj.get("op"))
    return "?"


def _account(stats: Dict[str, Any], role: Optional[str]) -> None:
    """Record one frame's measurements into the process-global metrics
    registry.  Telemetry must never take down the wire it observes, so
    any failure here is swallowed."""
    try:
        from arrow_matrix_tpu_torch.obs import metrics as metrics_mod

        reg = metrics_mod.get_registry()
        labels = {"op": stats["op"], "dir": stats["dir"]}
        if role is not None:
            labels["role"] = role
        reg.record("wire_frame_bytes", float(stats["frame_bytes"]),
                   **labels)
        reg.record("wire_serialize_ms", stats["serialize_ms"], **labels)
        reg.record("wire_ms", stats["wire_ms"], **labels)
    except Exception:  # graft-lint: disable=R8 — telemetry
        pass


def _refuse_tensor(obj: Any) -> None:
    """Raise ``TypeError`` for a torch tensor (no tensor can exist while
    torch is not imported)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(obj, torch.Tensor):
        raise TypeError(
            f"a torch.Tensor ({tuple(obj.shape)}, {obj.dtype}, on "
            f"{obj.device}) cannot ride the wire: its payloads are "
            f"numpy arrays; copy it to the host first "
            f"(t.detach().cpu().numpy())")


def _refuse_tensors(obj: Any) -> None:
    """:func:`_refuse_tensor` over a whole message tree, before a send
    publishes any segment or writes any byte."""
    if isinstance(obj, dict):
        for v in obj.values():
            _refuse_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _refuse_tensors(v)
    else:
        _refuse_tensor(obj)


def encode_payload(obj: Any, *,
                   pool: Optional[shm_mod.SegmentPool] = None,
                   pin: bool = True,
                   published: Optional[List[dict]] = None) -> Any:
    """Recursively replace ndarrays with transport envelopes.

    Without a ``pool``: base64 envelopes (the json transport).  With a
    ``pool``: arrays of at least :data:`SHM_MIN_BYTES` become shm
    descriptors (published with ``pin``; each descriptor is also
    appended to ``published`` so the caller can release after the
    round trip), smaller arrays stay base64.  Lists, tuples, and dict
    values are walked; everything else passes through for
    ``json.dumps`` to judge."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        if pool is not None and a.nbytes >= SHM_MIN_BYTES:
            desc = pool.publish(a, pin=pin)
            if published is not None:
                published.append(desc)
            return desc
        return {"__nd__": 1, "dtype": str(a.dtype),
                "shape": list(a.shape),
                "data": base64.b64encode(a.tobytes()).decode("ascii")}
    if isinstance(obj, dict):
        return {k: encode_payload(v, pool=pool, pin=pin,
                                  published=published)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_payload(v, pool=pool, pin=pin,
                               published=published) for v in obj]
    _refuse_tensor(obj)
    return obj


def decode_payload(obj: Any,
                   meter: Optional[Dict[str, float]] = None) -> Any:
    """Inverse of :func:`encode_payload`: rebuild ndarrays
    bit-identically from base64 envelopes and shm descriptors.  A dead
    descriptor (recycled generation, torn write, vanished segment)
    raises :class:`WireError` — LOUD, requeue-able, never silently
    another payload's bytes.  ``meter`` (when given) accumulates
    ``shm_bytes``."""
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            raw = base64.b64decode(obj["data"])
            return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])) \
                .reshape(obj["shape"]).copy()
        if shm_mod.is_descriptor(obj):
            try:
                arr = shm_mod.read_descriptor(obj)
            except shm_mod.ShmError as e:
                raise WireError(f"shm descriptor resolution failed: "
                                f"{e}") from e
            if meter is not None:
                meter["shm_bytes"] = meter.get("shm_bytes", 0.0) \
                    + float(arr.nbytes)
            return arr
        return {k: decode_payload(v, meter=meter)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_payload(v, meter=meter) for v in obj]
    return obj


def _extract_raw(obj: Any, buffers: List[np.ndarray],
                 offset: List[int]) -> Any:
    """Raw-framing encode walk: pull ndarrays out into ``buffers`` and
    leave ``{"__rawnd__": i, "offset", ...}`` placeholders (offsets
    are into the concatenated buffer section of the frame)."""
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        idx = len(buffers)
        placeholder = {"__rawnd__": idx, "dtype": str(a.dtype),
                       "shape": list(a.shape),
                       "nbytes": int(a.nbytes),
                       "offset": int(offset[0])}
        buffers.append(a)
        offset[0] += a.nbytes
        return placeholder
    if isinstance(obj, dict):
        return {k: _extract_raw(v, buffers, offset)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_extract_raw(v, buffers, offset) for v in obj]
    return obj


def _resolve_raw(obj: Any, section: memoryview) -> Any:
    """Raw-framing decode walk: rebuild ndarrays from the received
    buffer section (one copy out of the reusable ring slab)."""
    if isinstance(obj, dict):
        if obj.get("__rawnd__") is not None:
            off = int(obj["offset"])
            nbytes = int(obj["nbytes"])
            if off + nbytes > len(section):
                raise WireError(
                    f"raw frame placeholder overruns the buffer "
                    f"section ({off}+{nbytes} > {len(section)})")
            arr = np.frombuffer(section[off:off + nbytes],
                                dtype=np.dtype(str(obj["dtype"])))
            return arr.reshape(obj.get("shape", [-1])).copy()
        return {k: _resolve_raw(v, section) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve_raw(v, section) for v in obj]
    return obj


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise WireError(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    got = 0
    n = len(view)
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            raise WireError(f"peer closed mid-frame ({got}/{n} bytes)")
        got += k


def _near_limit_check(nbytes: int, kind: str) -> None:
    if nbytes > MAX_FRAME_BYTES:
        raise WireError(f"frame of {nbytes} B exceeds the "
                        f"{MAX_FRAME_BYTES} B wire limit")
    if nbytes >= NEAR_LIMIT_FRACTION * MAX_FRAME_BYTES:
        warnings.warn(
            f"wire frame of {nbytes} B (op={kind!r}) is within "
            f"{100 * (1 - NEAR_LIMIT_FRACTION):.0f}% of the "
            f"{MAX_FRAME_BYTES} B limit — the next growth step wedges "
            f"the wire", WireNearLimitWarning, stacklevel=3)
        try:
            from arrow_matrix_tpu_torch.obs import flight, metrics as metrics_mod

            flight.record("wire", "near_frame_limit", op=kind,
                          frame_bytes=nbytes, limit=MAX_FRAME_BYTES)
            metrics_mod.get_registry().counter(
                "wire_near_limit_total", op=kind).inc()
        except Exception:  # graft-lint: disable=R8 — telemetry
            pass


def _sendmsg_all(sock: socket.socket, parts: List[Any]) -> None:
    """Scatter-gather send of ``parts`` (bytes/memoryviews) without
    concatenating — the raw transport's zero-extra-copy send.  Falls
    back to joined ``sendall`` where ``sendmsg`` is unavailable."""
    send = getattr(sock, "sendmsg", None)
    if send is None:
        sock.sendall(b"".join(bytes(p) for p in parts))
        return
    views = [memoryview(p) if not isinstance(p, memoryview) else p
             for p in parts]
    total = sum(len(v) for v in views)
    sent = 0
    while sent < total:
        k = send(views)
        sent += k
        if sent >= total:
            break
        # Advance past fully sent views; slice the partial one.
        while views and k >= len(views[0]):
            k -= len(views[0])
            views.pop(0)
        if views and k:
            views[0] = views[0][k:]
    if not total:
        send([b""])


def send_msg(sock: socket.socket, obj: Any, *,
             role: Optional[str] = None,
             transport: str = "json",
             shm_pool: Optional[shm_mod.SegmentPool] = None,
             pin: bool = True) -> Dict[str, Any]:
    """Send one framed message (arrays encoded per ``transport``).

    Returns the frame's measurement record: ``{"op", "dir": "send",
    "frame_bytes", "payload_bytes", "shm_bytes", "serialize_ms",
    "wire_ms", "transport"}`` (also observed into the process-global
    metrics registry, labeled with ``role`` when one is given).  On
    the shm transport the record additionally carries ``shm_descs`` —
    the descriptors published (``pin``\\ ned) for this frame, which
    the caller releases once the round trip ends
    (:func:`request_call` does).  Within 1% of the frame limit the
    message still goes out but warns loudly; beyond the limit it
    raises :class:`WireError`."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, "
                         f"got {transport!r}")
    if transport == "shm" and shm_pool is None:
        raise ValueError("transport='shm' needs a shm_pool")
    _refuse_tensors(obj)
    faults.inject("fleet.wire.send",
                  target=str(obj.get("op")) if isinstance(obj, dict)
                  else None)
    kind = _frame_kind(obj)
    payload_bytes = shm_mod.payload_nbytes(obj)

    if transport == "raw":
        buffers: List[np.ndarray] = []
        off = [0]
        t0 = time.perf_counter()
        skeleton = _extract_raw(obj, buffers, off)
        blob = json.dumps(skeleton).encode("utf-8")
        serialize_ms = (time.perf_counter() - t0) * 1e3
        raw_bytes = off[0]
        nbytes = _RAW_JSON_HEADER.size + len(blob) + raw_bytes
        _near_limit_check(nbytes, kind)
        t1 = time.perf_counter()
        parts: List[Any] = [_HEADER.pack(nbytes | RAW_FLAG),
                            _RAW_JSON_HEADER.pack(len(blob)), blob]
        parts += [memoryview(a.view(np.uint8).reshape(-1))
                  for a in buffers if a.nbytes]
        _sendmsg_all(sock, parts)
        wire_ms = (time.perf_counter() - t1) * 1e3
        stats = {"op": kind, "dir": "send", "frame_bytes": nbytes,
                 "payload_bytes": payload_bytes, "shm_bytes": 0,
                 "serialize_ms": serialize_ms, "wire_ms": wire_ms,
                 "transport": "raw"}
        _account(stats, role)
        return stats

    published: List[dict] = []
    t0 = time.perf_counter()
    encoded = encode_payload(
        obj, pool=shm_pool if transport == "shm" else None,
        pin=pin, published=published)
    blob = json.dumps(encoded).encode("utf-8")
    serialize_ms = (time.perf_counter() - t0) * 1e3
    nbytes = len(blob)
    _near_limit_check(nbytes, kind)
    t1 = time.perf_counter()
    try:
        sock.sendall(_HEADER.pack(nbytes) + blob)
    except OSError:
        # A frame that never left must not leak its segment pins.
        if shm_pool is not None:
            for desc in published:
                shm_pool.release(desc)
        raise
    wire_ms = (time.perf_counter() - t1) * 1e3
    stats = {"op": kind, "dir": "send", "frame_bytes": nbytes,
             "payload_bytes": payload_bytes,
             "shm_bytes": sum(int(d.get("nbytes", 0))
                              for d in published),
             "serialize_ms": serialize_ms, "wire_ms": wire_ms,
             "transport": transport}
    if transport == "shm":
        stats["shm_descs"] = published
    _account(stats, role)
    return stats


def recv_msg_stats(sock: socket.socket, *,
                   role: Optional[str] = None,
                   ring: Optional[shm_mod.BufferRing] = None
                   ) -> Tuple[Any, Dict[str, Any]]:
    """Receive one framed message (any transport — the header flag and
    payload envelopes self-describe), returning ``(msg, stats)``.

    ``stats["wire_ms"]`` is the payload transfer time AFTER the header
    arrived; the wait for the first header byte is reported separately
    as ``wait_ms`` (on a client it is dominated by the server's think
    time, which must not be booked as transfer cost).
    ``serialize_ms`` is the decode + ndarray rebuild time (for shm
    frames that includes the segment memcpys).  Raw frames land in
    ``ring`` (default: a per-thread reusable ring)."""
    faults.inject("fleet.wire.recv")
    t0 = time.perf_counter()
    header = _recv_exact(sock, _HEADER.size)
    t1 = time.perf_counter()
    (word,) = _HEADER.unpack(header)
    is_raw = bool(word & RAW_FLAG)
    length = word & ~RAW_FLAG
    if length > MAX_FRAME_BYTES:
        raise WireError(f"frame header asks for {length} B (> "
                        f"{MAX_FRAME_BYTES} B) — corrupted stream")
    if is_raw:
        if ring is None:
            ring = _default_ring()
        if length < _RAW_JSON_HEADER.size:
            raise WireError(f"raw frame of {length} B cannot hold its "
                            f"JSON length prefix")
        jl_buf = _recv_exact(sock, _RAW_JSON_HEADER.size)
        (json_len,) = _RAW_JSON_HEADER.unpack(jl_buf)
        body = int(length) - _RAW_JSON_HEADER.size
        if json_len > body:
            raise WireError(f"raw frame JSON length {json_len} B "
                            f"overruns the {body} B frame body — "
                            f"corrupted stream")
        blob = _recv_exact(sock, int(json_len))
        section = ring.take(body - int(json_len))
        _recv_exact_into(sock, section)
        t2 = time.perf_counter()
        try:
            msg = _resolve_raw(json.loads(blob.decode("utf-8")),
                               memoryview(section))
        except (ValueError, UnicodeDecodeError) as e:
            raise WireError(f"undecodable raw frame payload: {e}") \
                from e
        stats = {"op": _frame_kind(msg), "dir": "recv",
                 "frame_bytes": int(length),
                 "payload_bytes": shm_mod.payload_nbytes(msg),
                 "shm_bytes": 0,
                 "wait_ms": (t1 - t0) * 1e3,
                 "wire_ms": (t2 - t1) * 1e3,
                 "serialize_ms": (time.perf_counter() - t2) * 1e3,
                 "transport": "raw"}
        _account(stats, role)
        return msg, stats

    blob = _recv_exact(sock, int(length))
    t2 = time.perf_counter()
    meter: Dict[str, float] = {}
    try:
        msg = decode_payload(json.loads(blob.decode("utf-8")),
                             meter=meter)
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"undecodable frame payload: {e}") from e
    shm_bytes = int(meter.get("shm_bytes", 0))
    stats = {"op": _frame_kind(msg), "dir": "recv",
             "frame_bytes": int(length),
             "payload_bytes": shm_mod.payload_nbytes(msg),
             "shm_bytes": shm_bytes,
             "wait_ms": (t1 - t0) * 1e3,
             "wire_ms": (t2 - t1) * 1e3,
             "serialize_ms": (time.perf_counter() - t2) * 1e3,
             "transport": "shm" if shm_bytes else "json"}
    _account(stats, role)
    return msg, stats


def recv_msg(sock: socket.socket, *, role: Optional[str] = None,
             ring: Optional[shm_mod.BufferRing] = None) -> Any:
    """Receive one framed message (arrays decoded automatically)."""
    msg, _ = recv_msg_stats(sock, role=role, ring=ring)
    return msg


def request_call(host: str, port: int, obj: Any, *,
                 timeout_s: Optional[float] = 30.0,
                 stats: Optional[Dict[str, Any]] = None,
                 transport: str = "json",
                 shm_pool: Optional[shm_mod.SegmentPool] = None) -> Any:
    """One request/response round trip on a fresh connection (the
    router's unit of interaction: connection state never outlives an
    operation, so a dead worker surfaces as a connect/recv error on
    the NEXT op, not as a half-open socket wedge).

    On the shm transport the request's published segments are pinned
    for exactly the duration of the round trip and released on every
    exit path — the pool's refcount discipline; a send that died
    mid-call must not leak its pins.

    When a ``stats`` dict is passed it is filled (on success) with the
    round trip's wire accounting: ``op``, ``transport``, ``bytes_out``
    / ``bytes_in`` / ``frame_bytes`` (request, response, sum),
    ``payload_bytes`` / ``shm_bytes`` (logical ndarray bytes moved /
    the slice that rode shared memory), combined ``serialize_ms`` and
    ``wire_ms`` (send + payload transfer — the response's header-wait,
    i.e. the server's think time, is reported apart as ``wait_ms``)."""
    out: Dict[str, Any] = {}
    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout_s) as sock:
            out = send_msg(sock, obj, role="client",
                           transport=transport, shm_pool=shm_pool)
            reply, back = recv_msg_stats(sock, role="client")
    finally:
        if shm_pool is not None:
            for desc in out.get("shm_descs", ()):
                shm_pool.release(desc)
    if stats is not None:
        stats.update({
            "op": out["op"],
            "transport": out.get("transport", transport),
            "bytes_out": out["frame_bytes"],
            "bytes_in": back["frame_bytes"],
            "frame_bytes": out["frame_bytes"] + back["frame_bytes"],
            "payload_bytes": out.get("payload_bytes", 0)
            + back.get("payload_bytes", 0),
            "shm_bytes": out.get("shm_bytes", 0)
            + back.get("shm_bytes", 0),
            "serialize_ms": out["serialize_ms"] + back["serialize_ms"],
            "wire_ms": out["wire_ms"] + back["wire_ms"],
            "wait_ms": back["wait_ms"],
        })
    return reply


def measure_transports(nbytes: int = 1 << 20, *, repeats: int = 3
                       ) -> Dict[str, Dict[str, float]]:
    """Bench one ``nbytes`` float32 array through each transport over
    a loopback socketpair; returns per-transport
    ``{"serialize_ms_per_mb", "frame_bytes", "wire_ms"}`` (medians of
    ``repeats``).  This is the measurement behind the ledger's
    ``serialize_ms_per_mb_{shm,base64,raw}`` records — the gate-able
    proof that the shm path beats base64."""
    arr = np.arange(max(int(nbytes) // 4, 1),
                    dtype=np.float32)
    mb = arr.nbytes / float(1 << 20)
    results: Dict[str, Dict[str, float]] = {}
    pool = shm_mod.SegmentPool(slots=4, slot_bytes=arr.nbytes,
                               name="amtbench")
    try:
        for transport in TRANSPORTS:
            ser: List[float] = []
            frames: List[float] = []
            wires: List[float] = []
            for _ in range(max(int(repeats), 1)):
                a, b = socket.socketpair()
                got: Dict[str, Any] = {}

                def _reader(sock=b, got=got):
                    msg, st = recv_msg_stats(sock)
                    got["msg"], got["stats"] = msg, st

                t = threading.Thread(target=_reader, daemon=True)
                t.start()
                st = {}
                try:
                    st = send_msg(
                        a, {"op": "bench", "x": arr},
                        transport=transport,
                        shm_pool=pool if transport == "shm" else None)
                    t.join(timeout=30.0)
                finally:
                    for desc in st.get("shm_descs", ()):
                        pool.release(desc)
                    a.close()
                    b.close()
                back = got.get("stats") or {}
                ser.append((st["serialize_ms"]
                            + back.get("serialize_ms", 0.0)) / mb)
                frames.append(float(st["frame_bytes"]))
                wires.append(st["wire_ms"]
                             + back.get("wire_ms", 0.0))
                if not np.array_equal(got.get("msg", {}).get("x"),
                                      arr):
                    raise WireError(
                        f"transport {transport!r} round trip is not "
                        f"bit-identical")
            ser.sort()
            frames.sort()
            wires.sort()
            mid = len(ser) // 2
            results[transport] = {
                "serialize_ms_per_mb": ser[mid],
                "frame_bytes": frames[mid],
                "wire_ms": wires[mid],
            }
    finally:
        pool.close(strict=False)
    # The json transport is the base64 wire; alias for the ledger.
    results["base64"] = results["json"]
    return results

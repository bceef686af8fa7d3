"""Zero-copy same-host data plane: shared-memory segments + descriptors.

The port's copy of ``arrow_matrix_tpu/fleet/shm.py``: the same
behaviour and on-wire or on-disk forms.

The fleet wire's base64-JSON envelopes cost ~1.33x the payload in
bytes AND a full encode/decode pass per frame — on one host that is
pure waste, because sender and receiver share a kernel.  This module
replaces the *array payloads* of same-host frames with
``multiprocessing.shared_memory`` segments: the sender memcpys the
array into a pooled segment and ships a ~200 B JSON *descriptor*
(``{"__shm__": 1, "segment", "generation", "dtype", "shape",
"nbytes"}``); the receiver attaches the segment by name, validates,
and copies the array out.  One memcpy each way, no base64, no JSON
walk over megabytes — ``serialize_ms`` per frame-MB drops by orders of
magnitude.

Safety is LOUD, never silent:

* **Generation stamps.**  Segments are recycled round-robin; every
  ``publish`` bumps a pool-wide generation counter and stamps it into
  the segment header.  A reader holding a descriptor for a since-
  recycled segment sees ``header.generation != descriptor.generation``
  and gets :class:`ShmGenerationError` — never another request's
  bytes.  (The wire turns it into a :class:`~arrow_matrix_tpu_torch.fleet
  .wire.WireError`, so the router requeues instead of corrupting.)
* **Torn-write detection.**  ``publish`` stamps the header with a
  tear sentinel *before* copying the payload and with the real
  generation only *after* — a writer SIGKILLed mid-copy leaves the
  sentinel behind, and both readers and ``close()`` call it torn.
* **Leak detection on close.**  ``close()`` reports every segment
  still pinned (a descriptor shipped but never released) and every
  torn header, and raises :class:`ShmLeakError` under
  ``strict=True`` — a leaked segment is an fd + pages the OS holds
  until reboot, the one failure mode shm must never hide.

:class:`BufferRing` is the cross-host half: raw-frame receives land in
preallocated reusable buffers instead of fresh allocations per frame
(see ``wire.py``'s raw framing).

Concurrency: the pool is shared by every dispatch thread
of a router (or every connection thread of a worker), so slot state is
guarded by ``_lock`` (node ``shm_pool``).  The payload memcpy happens
inside the critical section on purpose: it is a bounded memory move,
not blocking I/O (RC4 forbids socket/subprocess waits under a lock,
not memcpys), and keeping reserve + stamp + copy atomic with respect
to recycling is exactly what makes the generation discipline sound.
"""

from __future__ import annotations

import dataclasses
import os
import secrets
import struct
import threading
from multiprocessing import shared_memory
from typing import Any, List

import numpy as np

from arrow_matrix_tpu_torch.sync import guarded_by, witnessed

#: Segment header: magic, generation, payload nbytes.
_SHM_HEADER = struct.Struct(">4sQQ")

_MAGIC = b"AMTS"

#: Generation value stamped while a payload copy is in flight; a
#: header still carrying it is a torn write (writer died mid-copy).
TEAR_SENTINEL = (1 << 64) - 1

#: Default slot payload capacity; slots grow (recreate) on demand.
DEFAULT_SLOT_BYTES = 1 << 20

#: Default number of pooled segments.  Must exceed the number of
#: descriptors that can be simultaneously un-read (in-flight replies),
#: or readers start seeing generation errors — loud, recoverable, but
#: a sign the pool is undersized.
DEFAULT_SLOTS = 8


class ShmError(RuntimeError):
    """Base class for shared-memory data plane failures."""


class ShmGenerationError(ShmError):
    """A descriptor's segment was recycled (or torn) before the read:
    the generation stamp in the segment header no longer matches the
    descriptor.  The payload MUST NOT be used."""


class ShmLeakError(ShmError):
    """``close(strict=True)`` found leaked (still-pinned) or torn
    segments."""


def is_descriptor(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get("__shm__") == 1


@dataclasses.dataclass
class _Slot:
    """One pooled segment as the owner sees it."""

    seg: shared_memory.SharedMemory
    generation: int = 0
    refs: int = 0
    nbytes: int = 0        # last published payload size


@guarded_by("_lock", node="shm_pool",
            attrs=("_slots", "_generation", "_next", "_closed",
                   "published", "released", "grown"))
class SegmentPool:
    """Refcounted pool of shared-memory segments (see module
    docstring).  One pool per *sending* process: the router pools its
    request payloads, each worker pools its reply payloads.  Readers
    never need a pool — :func:`read_descriptor` attaches by name.

    ``publish(arr, pin=True)`` reserves a free slot (recycling the
    oldest unpinned one), stamps generation + payload, and returns the
    descriptor.  ``pin=True`` holds a reference until ``release`` —
    the request path, where the sender knows when the round trip ends.
    ``pin=False`` marks the slot immediately recyclable — the reply
    path, where the sender cannot know when the remote reader is done
    and the generation stamp is the safety net.
    """

    def __init__(self, *, slots: int = DEFAULT_SLOTS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES,
                 name: str = "amt"):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self._lock = witnessed("shm_pool", threading.Lock())
        self._prefix = f"{name}_{secrets.token_hex(4)}"
        self._slot_bytes = int(slot_bytes)
        self._max_slots = int(slots)
        self._slots: List[_Slot] = []
        self._generation = 0
        self._next = 0
        self._closed = False
        self.published = 0
        self.released = 0
        self.grown = 0

    # -- internals (call with the lock held) -------------------------------

    def _new_slot_locked(self, payload_bytes: int) -> _Slot:
        cap = max(self._slot_bytes, int(payload_bytes))
        seg = shared_memory.SharedMemory(
            create=True, size=_SHM_HEADER.size + cap,
            name=f"{self._prefix}_{len(self._slots)}_"
                 f"{secrets.token_hex(2)}")
        slot = _Slot(seg=seg)
        self._slots.append(slot)
        return slot

    def _reserve_locked(self, payload_bytes: int) -> _Slot:
        need = _SHM_HEADER.size + int(payload_bytes)
        n = len(self._slots)
        # Round-robin over existing unpinned slots, preferring one
        # already big enough; grow (recreate) an unpinned slot that is
        # too small.
        for i in range(n):
            idx = (self._next + i) % n
            slot = self._slots[idx]
            if slot.refs:
                continue
            self._next = (idx + 1) % max(n, 1)
            if slot.seg.size < need:
                old = slot.seg
                old.close()
                old.unlink()
                slot.seg = shared_memory.SharedMemory(
                    create=True, size=need,
                    name=f"{self._prefix}_g{idx}_"
                         f"{secrets.token_hex(2)}")
                self.grown += 1
            return slot
        if n < self._max_slots:
            return self._new_slot_locked(payload_bytes)
        raise ShmError(
            f"segment pool exhausted: all {n} slots pinned "
            f"(undersized pool for the in-flight window)")

    # -- the data plane ----------------------------------------------------

    def publish(self, arr: np.ndarray, *, pin: bool = True) -> dict:
        """Copy ``arr`` into a pooled segment; return its descriptor."""
        a = np.ascontiguousarray(arr)
        payload = a.view(np.uint8).reshape(-1) if a.nbytes else \
            np.empty(0, dtype=np.uint8)
        with self._lock:
            if self._closed:
                raise ShmError("publish on a closed segment pool")
            slot = self._reserve_locked(a.nbytes)
            self._generation += 1
            gen = self._generation
            buf = slot.seg.buf
            # Tear sentinel first: a SIGKILL between here and the
            # final stamp leaves proof of the torn write.
            buf[:_SHM_HEADER.size] = _SHM_HEADER.pack(
                _MAGIC, TEAR_SENTINEL, a.nbytes)
            if a.nbytes:
                buf[_SHM_HEADER.size:_SHM_HEADER.size + a.nbytes] = \
                    payload.tobytes()
            buf[:_SHM_HEADER.size] = _SHM_HEADER.pack(
                _MAGIC, gen, a.nbytes)
            slot.generation = gen
            slot.nbytes = a.nbytes
            slot.refs = 1 if pin else 0
            self.published += 1
            seg_name = slot.seg.name
        return {"__shm__": 1, "segment": seg_name, "generation": gen,
                "dtype": str(a.dtype), "shape": list(a.shape),
                "nbytes": int(a.nbytes), "pid": os.getpid()}

    def release(self, desc: dict) -> bool:
        """Drop the pin a ``publish(pin=True)`` took.  Stale
        descriptors (slot since recycled) release nothing and return
        False — the recycler already reclaimed the reference."""
        if not is_descriptor(desc):
            return False
        with self._lock:
            for slot in self._slots:
                if (slot.seg.name == desc.get("segment")
                        and slot.generation == desc.get("generation")
                        and slot.refs > 0):
                    slot.refs -= 1
                    self.released += 1
                    return True
        return False

    def stats(self) -> dict:
        with self._lock:
            return {"slots": len(self._slots),
                    "pinned": sum(1 for s in self._slots if s.refs),
                    "published": self.published,
                    "released": self.released,
                    "grown": self.grown,
                    "generation": self._generation}

    def close(self, *, strict: bool = True) -> List[str]:
        """Unlink every segment; detect leaks + torn writes (module
        docstring).  Returns the problem list; raises
        :class:`ShmLeakError` listing them when ``strict``."""
        problems: List[str] = []
        with self._lock:
            if self._closed:
                return []
            self._closed = True
            for slot in self._slots:
                if slot.refs > 0:
                    problems.append(
                        f"leaked segment {slot.seg.name}: "
                        f"{slot.refs} unreleased pin(s) "
                        f"(generation {slot.generation}, "
                        f"{slot.nbytes} B)")
                try:
                    magic, gen, _ = _SHM_HEADER.unpack_from(
                        slot.seg.buf, 0)
                    if magic == _MAGIC and gen == TEAR_SENTINEL:
                        problems.append(
                            f"torn segment {slot.seg.name}: header "
                            f"carries the tear sentinel (writer died "
                            f"mid-copy)")
                except (struct.error, ValueError):
                    problems.append(f"torn segment {slot.seg.name}: "
                                    f"unreadable header")
                try:
                    slot.seg.close()
                    slot.seg.unlink()
                except (OSError, FileNotFoundError):
                    pass
            self._slots = []
        if problems:
            try:
                from arrow_matrix_tpu_torch.obs import flight

                flight.record("shm", "close_problems",
                              problems=problems)
            except Exception:  # graft-lint: disable=R8 — telemetry
                pass
            if strict:
                raise ShmLeakError("; ".join(problems))
        return problems


def _attach(name: str, *,
            owner_is_self: bool = False) -> shared_memory.SharedMemory:
    """Attach an existing segment WITHOUT adopting its lifetime: on
    CPython < 3.13 attaching registers the segment with the resource
    tracker, which would unlink it when *this* process exits — the
    owner's job, not the reader's.  Same-process reads skip the
    unregister: the tracker's registry is a set, so attaching added
    nothing and unregistering would strip the OWNER's entry (the later
    unlink then double-unregisters, noisily)."""
    seg = shared_memory.SharedMemory(name=name, create=False)
    if not owner_is_self:
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:  # graft-lint: disable=R8 — best-effort
            pass
    return seg


def read_descriptor(desc: dict) -> np.ndarray:
    """Resolve a descriptor to its array (one memcpy out of the
    segment).  LOUD on every corruption mode: missing segment, bad
    magic, torn header, recycled generation, truncated payload."""
    if not is_descriptor(desc):
        raise ShmError(f"not a shm descriptor: {str(desc)[:80]}")
    name = str(desc.get("segment"))
    want_gen = int(desc.get("generation", -1))
    nbytes = int(desc.get("nbytes", 0))
    try:
        seg = _attach(name,
                      owner_is_self=desc.get("pid") == os.getpid())
    except FileNotFoundError as e:
        raise ShmGenerationError(
            f"segment {name} is gone (pool closed or recycled "
            f"before the read)") from e
    try:
        try:
            magic, gen, hdr_bytes = _SHM_HEADER.unpack_from(seg.buf, 0)
        except struct.error as e:
            raise ShmGenerationError(
                f"segment {name}: header unreadable") from e
        if magic != _MAGIC:
            raise ShmGenerationError(
                f"segment {name}: bad magic {magic!r} (not an AMT "
                f"segment)")
        if gen == TEAR_SENTINEL:
            raise ShmGenerationError(
                f"segment {name}: torn write (writer died mid-copy)")
        if gen != want_gen:
            raise ShmGenerationError(
                f"segment {name}: generation {gen} != descriptor "
                f"{want_gen} — segment was recycled; refusing to "
                f"return another payload's bytes")
        if hdr_bytes != nbytes:
            raise ShmGenerationError(
                f"segment {name}: header says {hdr_bytes} B, "
                f"descriptor says {nbytes} B — truncated or torn")
        if seg.size < _SHM_HEADER.size + nbytes:
            raise ShmGenerationError(
                f"segment {name}: {seg.size} B segment cannot hold "
                f"the {nbytes} B payload")
        raw = bytes(seg.buf[_SHM_HEADER.size:_SHM_HEADER.size + nbytes])
    finally:
        seg.close()
    arr = np.frombuffer(raw, dtype=np.dtype(str(desc["dtype"])))
    return arr.reshape(desc.get("shape", [-1])).copy()


class BufferRing:
    """Preallocated receive buffers for raw framing (single-threaded:
    one ring per connection/socket, never shared — the wire's
    one-connection-per-op discipline makes that natural).  ``take(n)``
    returns a writable memoryview of exactly ``n`` bytes backed by a
    pooled slab, recycling round-robin and growing a slab only when a
    frame exceeds every existing one."""

    def __init__(self, *, slots: int = 4,
                 slot_bytes: int = DEFAULT_SLOT_BYTES):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self._slabs = [bytearray(int(slot_bytes))
                       for _ in range(int(slots))]
        self._next = 0
        self.takes = 0
        self.grown = 0

    def take(self, nbytes: int) -> memoryview:
        n = int(nbytes)
        idx = self._next
        self._next = (self._next + 1) % len(self._slabs)
        if len(self._slabs[idx]) < n:
            self._slabs[idx] = bytearray(n)
            self.grown += 1
        self.takes += 1
        return memoryview(self._slabs[idx])[:n]


def payload_nbytes(obj: Any) -> int:
    """Total ndarray payload bytes in a message tree — the logical
    bytes a transport must move, used by the wire's per-path
    accounting (``payload_bytes`` in frame stats)."""
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if is_descriptor(obj):
        return int(obj.get("nbytes", 0))
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            # A base64 envelope: count the decoded size.
            return (len(obj.get("data", "")) * 3) // 4
        return sum(payload_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(payload_nbytes(v) for v in obj)
    return 0

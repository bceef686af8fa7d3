"""The port's fleet data plane (``arrow_matrix_tpu_torch.fleet``: wire,
shm, placement, health) against the JAX package's: frames round-trip
bit for bit on every transport and cross between the packages both
ways; torn frames, the exact header boundary and oversized headers are
refused loudly; a torch tensor in a payload is refused before a byte is
sent; the shared-memory pool's loud failure modes match the JAX tests';
the hash ring and the bin packing give the same answers; and the health
monitor's streak, backoff and readmission follow the same schedule."""

import socket
import threading

import numpy as np
import pytest
import torch

from arrow_matrix_tpu import faults as jfaults
from arrow_matrix_tpu.fleet import health as jhealth
from arrow_matrix_tpu.fleet import placement as jplacement
from arrow_matrix_tpu.fleet import shm as jshm
from arrow_matrix_tpu.fleet import wire as jwire
from arrow_matrix_tpu_torch import faults as pfaults
from arrow_matrix_tpu_torch.fleet import health as phealth
from arrow_matrix_tpu_torch.fleet import placement as pplacement
from arrow_matrix_tpu_torch.fleet import shm
from arrow_matrix_tpu_torch.fleet import wire
from arrow_matrix_tpu_torch.obs import metrics as metrics_mod

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    jfaults.clear_plan()
    pfaults.clear_plan()
    yield
    jfaults.clear_plan()
    pfaults.clear_plan()


def _message(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    x[0, 0], x[0, 1] = -0.0, np.nan
    return {"op": "submit", "x": x,
            "nested": [{"y": x[:2].astype(np.float64)}, 3, "s",
                       {"z": rng.integers(-9, 9, (5,), dtype=np.int8)}],
            "small": np.arange(3, dtype=np.int64),
            "empty": np.zeros((0, 4), np.float32),
            "f": 0.125, "none": None}


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def _pair(send_mod, recv_mod, msg, transport, pool=None):
    """``msg`` sent by ``send_mod`` and received by ``recv_mod`` over a
    socket pair (the receive in a thread: a frame can exceed the
    socket's buffer)."""
    a, b = socket.socketpair()
    got = {}

    def reader():
        got["msg"], got["stats"] = recv_mod.recv_msg_stats(b)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        st = send_mod.send_msg(a, msg, transport=transport, shm_pool=pool)
        t.join(30)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()
        if pool is not None:
            for desc in st.get("shm_descs", ()):
                pool.release(desc)
    return got["msg"], st, got["stats"]


@pytest.mark.parametrize("transport", ["json", "raw", "shm"])
@pytest.mark.parametrize("direction", ["port->port", "port->jax",
                                       "jax->port"])
def test_round_trips_are_bit_identical_across_packages(transport,
                                                       direction):
    sender, receiver = {"port->port": (wire, wire),
                        "port->jax": (wire, jwire),
                        "jax->port": (jwire, wire)}[direction]
    pool_mod = shm if sender is wire else jshm
    pool = (pool_mod.SegmentPool(slots=4, name="tpw")
            if transport == "shm" else None)
    msg = _message(seed=len(direction) + len(transport))
    try:
        got, st, back = _pair(sender, receiver, msg, transport, pool)
    finally:
        if pool is not None:
            assert pool.close(strict=True) == []
    _same(got, msg)
    assert st["frame_bytes"] == back["frame_bytes"] > 0
    assert st["payload_bytes"] == sum(
        a.nbytes for a in (msg["x"], msg["nested"][0]["y"],
                           msg["nested"][3]["z"], msg["small"],
                           msg["empty"]))
    if transport == "shm":
        assert st["shm_bytes"] == msg["x"].nbytes == back["shm_bytes"]


def test_frames_encode_the_same_bytes_as_jax():
    msg = _message(seed=3)
    assert wire.encode_payload(msg) == jwire.encode_payload(msg)
    _same(wire.decode_payload(jwire.encode_payload(msg)), msg)
    _same(jwire.decode_payload(wire.encode_payload(msg)), msg)
    assert shm.payload_nbytes(msg) == jshm.payload_nbytes(msg)


def test_a_torch_tensor_is_refused_before_a_byte_is_sent():
    for transport in ("json", "raw", "shm"):
        a, b = socket.socketpair()
        pool = shm.SegmentPool(slots=2, name="tpt")
        try:
            msg = {"op": "submit", "x": np.ones((64, 64), np.float32),
                   "rows": [torch.ones(4, 2)]}
            with pytest.raises(TypeError, match="copy it to the host"):
                wire.send_msg(a, msg, transport=transport, shm_pool=pool)
            b.setblocking(False)
            with pytest.raises(BlockingIOError):
                b.recv(1)               # nothing was sent
        finally:
            a.close()
            b.close()
            assert pool.close(strict=True) == []    # nothing pinned
    with pytest.raises(TypeError, match="torch.Tensor"):
        wire.encode_payload({"x": torch.zeros(3)})


def test_torn_frames_and_the_exact_header_boundary_are_loud():
    cases = [(b"\x00\x00\x00", "mid-frame"),
             (wire._HEADER.pack(64)[:7], r"mid-frame \(7/8"),
             (wire._HEADER.pack(64), r"mid-frame \(0/64"),
             (wire._HEADER.pack(64 | wire.RAW_FLAG), "mid-frame"),
             (wire._HEADER.pack(2 | wire.RAW_FLAG), "length prefix")]
    for raw, pattern in cases:
        for mod in (wire, jwire):
            a, b = socket.socketpair()
            try:
                a.sendall(raw)
                a.close()
                with pytest.raises(mod.WireError, match=pattern):
                    mod.recv_msg(b)
            finally:
                b.close()


def test_oversized_header_and_undecodable_payload_are_refused():
    a, b = socket.socketpair()
    try:
        a.sendall(wire._HEADER.pack(wire.MAX_FRAME_BYTES + 1))
        with pytest.raises(wire.WireError, match="corrupted"):
            wire.recv_msg(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(wire._HEADER.pack(5) + b"{torn")
        with pytest.raises(wire.WireError, match="undecodable"):
            wire.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_near_limit_warns_and_oversize_refuses(monkeypatch):
    old = metrics_mod.get_registry()
    reg = metrics_mod.MetricsRegistry()
    metrics_mod.set_registry(reg)
    msg = {"op": "pad", "pad": "x" * 1000}
    blob = len(wire.json.dumps(wire.encode_payload(msg)).encode("utf-8"))
    a, b = socket.socketpair()
    try:
        monkeypatch.setattr(wire, "MAX_FRAME_BYTES", blob)
        with pytest.warns(wire.WireNearLimitWarning):
            wire.send_msg(a, msg)
        assert wire.recv_msg(b)["pad"] == msg["pad"]
        monkeypatch.setattr(wire, "MAX_FRAME_BYTES", blob - 1)
        with pytest.raises(wire.WireError, match="exceeds"):
            wire.send_msg(a, msg)
    finally:
        a.close()
        b.close()
        metrics_mod.set_registry(old)
    counters = {c["labels"].get("op"): c["value"]
                for c in reg.snapshot()["counters"]
                if c["name"] == "wire_near_limit_total"}
    assert counters.get("pad") == 1


def test_fault_seams_fire_at_the_wire():
    pfaults.set_plan({"scenario": "error", "site": "fleet.wire.send",
                      "after": 0})
    a, b = socket.socketpair()
    try:
        with pytest.raises(pfaults.FaultInjected):
            wire.send_msg(a, {"op": "ping"})
    finally:
        a.close()
        b.close()


def test_request_call_round_trip_with_stats():
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def serve_one():
        conn, _ = srv.accept()
        with conn:
            msg = wire.recv_msg(conn)
            wire.send_msg(conn, {"op": "reply", "y": msg["x"] * 2})

    t = threading.Thread(target=serve_one, daemon=True)
    t.start()
    pool = shm.SegmentPool(slots=2, name="tpr")
    try:
        stats = {}
        x = np.arange(1024, dtype=np.float32)
        reply = wire.request_call("127.0.0.1", port, {"op": "ask", "x": x},
                                  stats=stats, transport="shm",
                                  shm_pool=pool)
        t.join(30)
        assert reply["y"].tobytes() == (x * 2).tobytes()
        assert stats["op"] == "ask" and stats["shm_bytes"] == x.nbytes
        assert stats["frame_bytes"] == stats["bytes_out"] + \
            stats["bytes_in"]
    finally:
        srv.close()
        assert pool.close(strict=True) == []     # released on return


def test_measure_transports_is_bit_exact():
    res = wire.measure_transports(1 << 16, repeats=1)
    assert set(res) == {"json", "raw", "shm", "base64"}
    assert res["shm"]["frame_bytes"] < res["raw"]["frame_bytes"] < \
        res["json"]["frame_bytes"]


# -- shm: the JAX tests' loud failure modes ----------------------------------

def test_shm_round_trip_and_cross_package_descriptor():
    pool = shm.SegmentPool(slots=2, name="t_rt")
    try:
        x = (np.arange(4096, dtype=np.float32).reshape(64, 64)
             * np.float32(0.25))
        desc = pool.publish(x)
        assert shm.is_descriptor(desc) and jshm.is_descriptor(desc)
        for mod in (shm, jshm):
            got = mod.read_descriptor(desc)
            assert got.dtype == x.dtype and got.shape == x.shape
            assert got.tobytes() == x.tobytes()
        assert pool.release(desc)
        assert not pool.release(desc)
    finally:
        pool.close()


def test_shm_recycled_generation_is_loud():
    pool = shm.SegmentPool(slots=1, name="t_gen")
    try:
        stale = pool.publish(np.ones(8, dtype=np.float32), pin=False)
        pool.publish(np.zeros(8, dtype=np.float32), pin=False)
        with pytest.raises(shm.ShmGenerationError, match="recycled"):
            shm.read_descriptor(stale)
        with pytest.raises(jshm.ShmGenerationError, match="recycled"):
            jshm.read_descriptor(stale)
        with pytest.raises(wire.WireError, match="descriptor"):
            wire.decode_payload({"x": stale})
    finally:
        pool.close()


def test_shm_torn_write_is_loud_on_read_and_close():
    pool = shm.SegmentPool(slots=1, name="t_torn")
    desc = pool.publish(np.ones(8, dtype=np.float32))
    slot = pool._slots[0]
    slot.seg.buf[:shm._SHM_HEADER.size] = shm._SHM_HEADER.pack(
        shm._MAGIC, shm.TEAR_SENTINEL, 32)
    with pytest.raises(shm.ShmGenerationError, match="torn write"):
        shm.read_descriptor(desc)
    problems = pool.close(strict=False)
    assert any("torn segment" in p for p in problems)
    assert any("leaked segment" in p for p in problems)


def test_shm_leak_is_loud_under_strict_close():
    pool = shm.SegmentPool(slots=2, name="t_leak")
    pool.publish(np.ones(16, dtype=np.float32))
    with pytest.raises(shm.ShmLeakError, match="leaked segment"):
        pool.close(strict=True)
    assert pool.close(strict=True) == []


def test_shm_pool_exhaustion_is_loud_not_silent():
    pool = shm.SegmentPool(slots=1, name="t_full")
    try:
        pool.publish(np.ones(8, dtype=np.float32))
        with pytest.raises(shm.ShmError, match="exhausted"):
            pool.publish(np.ones(8, dtype=np.float32))
    finally:
        pool.close(strict=False)
    with pytest.raises(ValueError):
        shm.SegmentPool(slots=0)


def test_buffer_ring_recycles_and_grows():
    ring = shm.BufferRing(slots=2, slot_bytes=16)
    a = ring.take(8)
    a[:] = b"\x01" * 8
    b = ring.take(8)
    assert ring.takes == 2 and ring.grown == 0
    c = ring.take(64)
    assert len(c) == 64 and ring.grown == 1
    assert bytes(b[:1]) == b"\x00"


# -- placement ---------------------------------------------------------------

def test_hash_ring_owners_equal_jax():
    tenants = [f"t{i}" for i in range(200)]
    workers = ["w0", "w1", "w2", "w3"]
    ours, theirs = (pplacement.ConsistentHashRing(workers),
                    jplacement.ConsistentHashRing(list(reversed(workers))))
    assert {t: ours.lookup(t) for t in tenants} == \
        {t: theirs.lookup(t) for t in tenants}
    for ex in (("w1",), ("w0", "w3"), tuple(workers)):
        assert [ours.lookup(t, exclude=ex) for t in tenants] == \
            [theirs.lookup(t, exclude=ex) for t in tenants]
    ours.remove("w2")
    theirs.remove("w2")
    before = {t: ours.lookup(t) for t in tenants}
    assert before == {t: theirs.lookup(t) for t in tenants}
    assert "w2" not in set(before.values())
    assert pplacement.ConsistentHashRing().lookup("t") is None


def test_pack_tenants_equals_jax():
    rng = np.random.default_rng(11)
    cases = [({"big": 80, "mid": 60, "small": 30}, {"w0": 100, "w1": 64}),
             ({"t": 1}, {"w0": 0, "w1": 10}),
             ({"big": 5}, {"w0": 0}),
             ({"huge": 1000, "ok": 10}, {"w0": 64, "w1": 32}),
             ({"b": 10, "a": 10, "c": 10}, {"w0": 20, "w1": 10})]
    for _ in range(20):
        tenants = {f"t{i}": int(v) for i, v in
                   enumerate(rng.integers(1, 100, rng.integers(1, 12)))}
        budgets = {f"w{i}": int(v) for i, v in
                   enumerate(rng.integers(0, 200, rng.integers(1, 5)))}
        cases.append((tenants, budgets))
    for tenants, budgets in cases:
        assert pplacement.pack_tenants(tenants, budgets) == \
            jplacement.pack_tenants(tenants, budgets)


# -- health: the same schedule -----------------------------------------------

def _health_story(mod):
    clock = [0.0]
    hm = mod.HealthMonitor(max_failures=3, clock=lambda: clock[0],
                           sleep=lambda s: None)
    out = []
    hm.record_failure("w0", "boom")
    hm.record_failure("w0", "boom")
    out.append(hm.alive_workers())
    hm.record_ok("w0")
    out.append(hm.state["w0"].consecutive_failures)
    clock[0] = 7.0
    for _ in range(3):
        hm.record_failure("w0", "down")
    out.append((hm.dead_workers(), hm.state["w0"].declared_dead_s))
    hm.record_ok("w0")
    out.append(hm.dead_workers())
    clock[0] = 11.0
    h = hm.readmit("w0")
    out.append((h.alive, h.consecutive_failures, h.last_error,
                h.declared_dead_s, h.readmissions, h.readmitted_s))
    for _ in range(3):
        hm.record_failure("w0", "blip")
    out.append((hm.dead_workers(), hm.readmit("w0").readmissions))
    hm.record_failure("w1", "x")
    snap = hm.snapshot()
    out.append(sorted(snap))
    out.append({k: {f: v for f, v in rec.items()} for k, rec in
                snap.items()})
    return out


def test_health_streak_and_readmission_equal_jax():
    ours, theirs = _health_story(phealth), _health_story(jhealth)
    assert ours == theirs
    assert ours[0] == ["w0"] and ours[2] == (["w0"], 7.0)
    assert ours[4] == (True, 0, None, None, 1, 11.0)


def test_health_probe_backoff_equals_jax(monkeypatch):
    def down_with(mod):
        def down(host, port, obj, *, timeout_s=None):
            raise mod.WireError("connection refused")
        return down

    monkeypatch.setattr(phealth.wire, "request_call", down_with(wire))
    monkeypatch.setattr(jhealth.wire, "request_call", down_with(jwire))

    def ladder(mod, worker_id):
        sleeps = []
        hm = mod.HealthMonitor(max_failures=3, sleep=sleeps.append)
        h = hm.probe(worker_id, "127.0.0.1", 1)
        assert not h.alive and h.consecutive_failures == 3
        return sleeps

    s0 = ladder(phealth, "worker-0")
    assert s0 == ladder(jhealth, "worker-0") == ladder(phealth, "worker-0")
    assert s0 != ladder(phealth, "worker-1")
    assert len(s0) == 2
    assert ladder(phealth, "worker-1") == ladder(jhealth, "worker-1")


def test_health_probe_succeeds_against_a_live_peer():
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def answer():
        conn, _ = srv.accept()
        with conn:
            msg = wire.recv_msg(conn)
            wire.send_msg(conn, {"ok": True, "echo": msg.get("op")})

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    try:
        hm = phealth.HealthMonitor(max_failures=2, sleep=lambda s: None)
        h = hm.probe("w0", "127.0.0.1", port)
        t.join(30)
        assert h.alive and h.consecutive_failures == 0
        assert hm.alive_workers() == ["w0"]
    finally:
        srv.close()

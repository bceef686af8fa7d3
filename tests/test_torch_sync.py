"""The port's lock-order witness (``arrow_matrix_tpu_torch.sync``), the
JAX package's cases: off by default at zero overhead, raising on an
inverted acquisition order (declared or observed), the Condition
protocol, flock vertices; the declared order equal to the JAX
package's; and a threaded stress of the port's server under the
witness (submitter threads against the always-on worker), with every
request completed, the metrics registry's counts exact and no order
violation."""

import threading

import pytest
import torch

from arrow_matrix_tpu import sync as jsync
from arrow_matrix_tpu_torch import serve as pserve
from arrow_matrix_tpu_torch import sync
from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.obs.metrics import Histogram, MetricsRegistry

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _witness_restored():
    prev = sync.witness_registry()
    sync.disable_witness()
    yield
    if prev is not None:
        sync.enable_witness(prev)
    else:
        sync.disable_witness()


@pytest.fixture
def witness():
    yield sync.enable_witness()
    sync.disable_witness()


def test_witness_off_by_default_is_zero_overhead():
    assert sync.witness_registry() is None
    lock = threading.Lock()
    assert sync.witnessed("arrow_server", lock) is lock
    cm = sync.flock_witness("sidecar")
    assert cm is sync.flock_witness("preempt_registry")
    with cm:
        pass


@pytest.mark.parametrize("declared", [True, False])
def test_witness_raises_on_an_inverted_order(witness, declared):
    la = sync.witnessed("a", threading.Lock())
    lb = sync.witnessed("b", threading.Lock())
    if declared:
        witness.declare("a", "b")
    with la:
        with lb:
            pass
    with lb:
        with pytest.raises(sync.LockOrderViolation,
                           match="declared" if declared else "observed"):
            la.acquire()
    snap = witness.snapshot()
    assert snap["violations"]
    assert snap["observed_edges"] == ([] if declared else [("a", "b")])


def test_witness_reentrancy_and_bad_declarations():
    reg = sync.enable_witness()
    lr = sync.witnessed("r", threading.RLock())
    with lr:
        with lr:
            pass
    assert reg.snapshot()["reentries"] == 1
    with pytest.raises(ValueError, match="contradicts"):
        sync.LockRegistry(declared=(("a", "b"), ("b", "a")))
    with pytest.raises(ValueError, match="self-edge"):
        sync.LockRegistry(declared=(("a", "a"),))


def test_witness_condition_protocol_round_trips(witness):
    cond = threading.Condition(sync.witnessed("cond", threading.RLock()))
    box = {"ready": False}
    done = threading.Event()

    def waiter():
        with cond:
            while not box["ready"]:
                cond.wait(timeout=30)
        done.set()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    with cond:
        box["ready"] = True
        cond.notify_all()
    assert done.wait(30)
    t.join(30)
    assert not t.is_alive()
    snap = witness.snapshot()
    assert snap["violations"] == [] and len(snap["threads"]) == 2


def test_flock_witness_is_a_graph_vertex(witness):
    inner = sync.witnessed("inner", threading.Lock())
    with sync.flock_witness("sidecar"):
        with inner:
            pass
    with inner:
        with pytest.raises(sync.LockOrderViolation):
            with sync.flock_witness("sidecar"):
                pass


def test_declared_order_equals_the_jax_package():
    assert sync.DECLARED_ORDER == jsync.DECLARED_ORDER
    assert sync.FLOCK_NODES == jsync.FLOCK_NODES
    snap = sync.LockRegistry().snapshot()
    assert sorted(tuple(e) for e in snap["declared_edges"]) == \
        sorted(sync.DECLARED_ORDER)


def test_threaded_server_stress_under_witness(monkeypatch):
    """Three submitter threads against the always-on worker, with a
    metrics registry and a flight recorder, the witness armed and a
    short switch interval: every request completes, the completed
    counter and the latency histogram count each request once, and the
    witness saw several threads and no violation."""
    import sys

    registry = sync.enable_witness()
    rec = flight.FlightRecorder(None, capacity=10_000)
    flight.set_recorder(rec)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    metrics = MetricsRegistry()
    try:
        fac, n = pserve.ba_executor_factory(64, 16, 5, device="cpu")
        srv = pserve.ArrowServer(fac, pserve.ExecConfig(),
                                 queue_capacity=64, registry=metrics,
                                 max_batch_k=8)
        srv.start()
        trace = pserve.synthetic_trace(n, tenants=4, requests=24, k=2,
                                       iterations=2, seed=7)
        tickets, lock = [], threading.Lock()

        def submitter(chunk):
            for r in chunk:
                t = srv.submit(r)
                with lock:
                    tickets.append(t)

        threads = [threading.Thread(target=submitter, args=(trace[i::3],))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for t in tickets:
            assert t.wait(120)
        srv.shutdown(wait=True, timeout=120)
    finally:
        sys.setswitchinterval(old)
        flight.set_recorder(None)
        sync.disable_witness()
    assert [t.status for t in tickets] == ["completed"] * 24
    assert srv.summary()["completed"] == 24
    done = sum(c["value"] for c in metrics.snapshot()["counters"]
               if c["name"] == "serve_completed")
    assert done == 24
    lat = metrics.histogram("serve_latency_ms", server="serve")
    assert isinstance(lat, Histogram) and len(lat.values) == 24
    snap = registry.snapshot()
    assert snap["violations"] == [], snap["violations"]
    assert len(snap["threads"]) >= 3


# -- the lock-discipline analyzer (analysis/sync.py) --------------------------

import glob
import os

from arrow_matrix_tpu.analysis import sync as jgraft_sync
from arrow_matrix_tpu_torch.analysis import sync as graft_sync

FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "sync",
    "rc*_*.py")))


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_analyzer_findings_equal_jax_on_each_fixture(path):
    """Both analyzers give the same (rule, line) findings on every
    planted-violation fixture, and the port's fires the fixture's rule."""
    ours = graft_sync.analyze_paths([path])
    theirs = jgraft_sync.analyze_paths([path])
    key = lambda rep: sorted((f.rule, f.line) for f in rep.findings)
    assert key(ours) == key(theirs)
    assert graft_sync.verify_fixture(path)[0]


def _contracts(report, prefix):
    return sorted(
        (c["path"].split(prefix + os.sep, 1)[-1], c["class"], c["node"],
         c["lock"], tuple(c["attrs"]), tuple(c["callbacks"]))
        for c in graft_sync.build_manifest(report)["contracts"])


def test_contracts_and_lock_graph_equal_jax():
    """The port's ``@guarded_by`` contracts and lock-graph edges are the
    JAX package's over its own tree, the path prefix aside; the one
    difference is the server's decision outbox (``_outbox``), guarded
    like the rest of its state: rank 0's decisions sent to the other
    ranks of a mesh in lockstep."""
    ours = graft_sync.analyze_package()
    theirs = jgraft_sync.analyze_package()
    mine = _contracts(ours, "arrow_matrix_tpu_torch")
    ref = _contracts(theirs, "arrow_matrix_tpu")
    assert len(mine) == len(ref) == 10
    for a, b in zip(mine, ref):
        if a[1] == "ArrowServer":
            assert set(a[4]) - set(b[4]) == {"_outbox"}
            assert set(b[4]) <= set(a[4])
            a, b = a[:4] + a[5:], b[:4] + b[5:]
        assert a == b
    om = graft_sync.build_manifest(ours)
    tm = jgraft_sync.build_manifest(theirs)
    assert om["lock_graph"] == tm["lock_graph"]
    assert om["ok"] and ours.findings == []


def test_sync_manifest_check_and_selftest(capsys):
    assert graft_sync.main(["--check"]) == 0
    assert "sync proof passed" in capsys.readouterr().out
    ok, lines = graft_sync.selftest()
    assert ok, lines
    rep = graft_sync.analyze_package()
    scheduler = [c for c in rep.contracts if c.cls == "ArrowServer"]
    assert scheduler and "_outbox" in scheduler[0].attrs

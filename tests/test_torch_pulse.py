"""The port's live telemetry (``arrow_matrix_tpu_torch.obs.pulse``)
against the JAX package's: one event stream under one injected clock
through both monitors gives the same windows and edges, the same bounded
idle-gap fill, the same burn hysteresis and callbacks, the same
crash-readable ring and the same exposition text (apart from the
monitor's wall-clock creation stamp); the validators and
``merge_rings`` agree; the scrape endpoint serves the ring; and a CPU
``ArrowServer`` with a monitor attached (the lock-order witness armed)
keeps its series equal to its SLO report and stamps every serve span
with its request id."""

import json
import sys
import threading
import urllib.request

import pytest
import torch

from arrow_matrix_tpu.obs import flight as jflight
from arrow_matrix_tpu.obs import pulse as jpulse
from arrow_matrix_tpu.obs.metrics import Histogram as JHistogram
from arrow_matrix_tpu_torch import faults as pfaults
from arrow_matrix_tpu_torch import serve as pserve
from arrow_matrix_tpu_torch import sync
from arrow_matrix_tpu_torch.faults import RetryPolicy
from arrow_matrix_tpu_torch.ledger import Ledger
from arrow_matrix_tpu_torch.obs import Tracer
from arrow_matrix_tpu_torch.obs import flight as pflight
from arrow_matrix_tpu_torch.obs import pulse as ppulse
from arrow_matrix_tpu_torch.obs.metrics import Histogram

torch.set_num_threads(2)

N, WIDTH, K, SEED = 64, 16, 2, 5
PKGS = {"jax": jpulse, "port": ppulse}


@pytest.fixture(autouse=True)
def _clean_state():
    pfaults.clear_plan()
    prev = sync.witness_registry()
    sync.disable_witness()
    yield
    pfaults.clear_plan()
    if prev is not None:
        sync.enable_witness(prev)
    else:
        sync.disable_witness()


@pytest.fixture(scope="module")
def factory():
    return pserve.ba_executor_factory(N, WIDTH, SEED, fmt="fold",
                                      device="cpu")


def _mon(mod, **kw):
    now = [0.0]
    kw.setdefault("window_s", 1.0)
    return mod.PulseMonitor(clock=lambda: now[0], **kw), now


#: Event streams: (time, event, data); ("advance", t) rotates without an
#: event; ("close", t) seals the monitor.
STREAMS = {
    "edges": [(0.0, "completed", {"latency_ms": 1.0}),
              (0.999, "completed", {"latency_ms": 2.0}),
              (1.0, "completed", {"latency_ms": 3.0}),
              ("close", 1.5)],
    "gap": [(0.0, "completed", {"latency_ms": 1.0}),
            (1000.0, "completed", {"latency_ms": 2.0}),
            ("close", 1000.25)],
    "partial": [(0.25, "completed", {"latency_ms": 1.0}),
                ("close", 0.5)],
    "mixed": [
        (0.0, "submitted", {"tenant": "t0", "traffic_class": "exact"}),
        (0.1, "admitted", {"tenant": "t0", "traffic_class": "exact",
                           "queue_depth": 3}),
        (0.2, "submitted", {"tenant": "t1", "traffic_class": "approx"}),
        (0.3, "shed", {"tenant": "t1", "traffic_class": "approx"}),
        (0.4, "rejected", {"tenant": "t2"}),
        (0.9, "completed", {"tenant": "t0", "traffic_class": "exact",
                            "latency_ms": 12.5, "queue_depth": 1}),
        (1.2, "supervised", {"faults": 2, "recoveries": 1}),
        (1.3, "resumed_request", {"request": "r1"}),
        (1.4, "degraded", {"tenant": "t0"}),
        (2.5, "completed", {"tenant": "t1", "traffic_class": "approx",
                            "latency_ms": 7.25}),
        (2.6, "failed", {"tenant": "t1", "traffic_class": "approx"}),
        ("advance", 4.0),
        (4.1, "completed", {"tenant": "t0", "latency_ms": 3.0}),
        ("close", 4.6)],
    "burn": [(float(i), "supervised", {"faults": f, "recoveries": f})
             for i, f in enumerate([1, 0, 4, 5, 3, 0, 0])]
    + [("close", 7.0)],
}


def _drive(mod, stream, **kw):
    hits = []
    kw.setdefault("watchdog", mod.SloWatchdog(
        mod.default_rules(target_p99_ms=10.0, max_faults_per_window=0.0),
        on_burn=lambda rule, w, ev: hits.append((rule.name, w["window"]))))
    m, now = _mon(mod, name="parity", **kw)
    for step in stream:
        if step[0] == "advance":
            now[0] = step[1]
            m.advance()
        elif step[0] == "close":
            now[0] = step[1]
            m.close("done")
        else:
            now[0] = step[0]
            m.observe(step[1], **step[2])
    return m, hits


def _stampless(doc):
    out = json.loads(json.dumps(doc))
    out["meta"].pop("created_unix")
    return out


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_one_stream_gives_the_same_documents(name, tmp_path):
    got = {}
    for pkg, mod in PKGS.items():
        ring = str(tmp_path / f"{pkg}.json")
        m, hits = _drive(mod, STREAMS[name], ring_path=ring)
        with open(ring, encoding="utf-8") as fh:
            on_disk = json.load(fh)
        assert mod.validate_ring(on_disk) == []
        assert mod.validate_exposition(m.exposition_text()) == []
        got[pkg] = (_stampless(m.snapshot()), _stampless(on_disk),
                    m.exposition_text(), m.series(), m.totals_dict(),
                    hits, m.dropped_windows)
    assert got["port"] == got["jax"]
    snap = got["port"][0]
    assert snap["closed"] == "done"
    if name == "edges":
        assert [w["window"] for w in snap["windows"]] == [0, 1]
        assert [w["completed"] for w in snap["windows"]] == [2, 1]
        assert snap["windows"][1]["latency_ms"]["max"] == 3.0
    if name == "gap":
        assert len(snap["windows"]) <= ppulse._MAX_GAP_FILL + 3
        assert snap["dropped_windows"] > 0
        assert snap["totals"]["completed"] == 2
    if name == "partial":
        (w,) = snap["windows"]
        assert w["duration_s"] == 0.5 and w["requests_per_s"] == 2.0
    if name == "burn":
        events = [(e["event"], e["window"]) for e in snap["burn_events"]]
        assert events == [("slo_burn", 3), ("slo_burn_cleared", 5)]
        assert got["port"][5] == [("fault_rate", 3)]
    if name == "mixed":
        t = snap["totals"]
        assert (t["completed"], t["shed"], t["rejected"], t["failed"],
                t["faults_seen"], t["resumed"]) == (3, 1, 1, 1, 2, 1)
        assert set(t["per_class"]) == {"approx", "exact"}


def test_merged_latency_is_exactly_pooled():
    m, now = _mon(ppulse)
    pooled = Histogram()
    for i, ms in enumerate([3.0, 1.0, 4.0, 1.5, 9.0, 2.6]):
        now[0] = float(i)
        m.observe("completed", latency_ms=ms)
        pooled.observe(ms)
    merged = m.merged_latency()
    assert sorted(merged.values) == sorted(pooled.values)
    jpooled = JHistogram()
    for v in pooled.values:
        jpooled.observe(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert merged.quantile(q) == pooled.quantile(q) == \
            jpooled.quantile(q)


def test_merged_latency_after_close_counts_each_sample_once():
    """The JAX monitor's merged_latency pools the sealed window twice
    after close(); the port's counts each sample once, before and after."""
    got = {}
    for pkg, mod in PKGS.items():
        m, now = _mon(mod)
        for i, ms in enumerate([3.0, 1.0, 4.0]):
            now[0] = 0.6 * i
            m.observe("completed", latency_ms=ms)
        before = sorted(m.merged_latency().values)
        now[0] = 1.5
        m.close()
        got[pkg] = (before, sorted(m.merged_latency().values))
    assert got["port"] == ([1.0, 3.0, 4.0], [1.0, 3.0, 4.0])
    assert got["jax"][0] == got["port"][0]
    assert len(got["jax"][1]) == 4      # the reference's double count


def test_burn_callback_and_flight_event(tmp_path):
    events = {}
    for pkg, (mod, flight) in {"jax": (jpulse, jflight),
                               "port": (ppulse, pflight)}.items():
        rec = flight.FlightRecorder(str(tmp_path / f"{pkg}.json"))
        flight.set_recorder(rec)
        try:
            hits = []
            wd = mod.SloWatchdog(
                [mod.BurnRule.fault_rate(0.0, min_windows=1),
                 mod.BurnRule.p99_latency(5.0, min_windows=1)],
                on_burn=lambda rule, w, ev: hits.append(
                    (rule.name, w["window"], ev["value"])))
            wd.on_window({"window": 0, "faults_seen": 3,
                          "latency_ms": {"p99": 9.0}})
            wd.on_window({"window": 1, "faults_seen": 0,
                          "latency_ms": {"p99": None}})
            events[pkg] = (hits, wd.events, wd.burning(),
                           [(e["kind"], e["name"]) for e in rec.events])
        finally:
            flight.set_recorder(None)
    assert events["port"] == events["jax"]
    assert events["port"][0] == [("fault_rate", 0, 3.0),
                                 ("p99_latency", 0, 9.0)]
    assert ("slo_burn", "fault_rate") in events["port"][3]
    with pytest.raises(ValueError):
        ppulse.BurnRule("r", "x", 1.0, min_windows=0)
    with pytest.raises(ValueError):
        ppulse.PulseMonitor(window_s=0)


def test_ring_is_crash_readable_without_close(tmp_path):
    docs = {}
    for pkg, mod in PKGS.items():
        ring = tmp_path / f"{pkg}_ring.json"
        m, now = _mon(mod, ring_path=str(ring))
        for i in range(3):
            now[0] = float(i)
            m.observe("completed", tenant="t0", latency_ms=1.0 + i)
        now[0] = 3.0
        m.advance()
        docs[pkg] = _stampless(mod.load_ring(str(ring)))
    assert docs["port"] == docs["jax"]
    doc = docs["port"]
    assert ppulse.validate_ring(doc) == []
    assert doc["closed"] is None
    assert [w["window"] for w in doc["windows"]] == [0, 1, 2]
    assert doc["totals"]["per_tenant"]["t0"]["completed"] == 3


@pytest.mark.parametrize("text", [
    'pulse_requests_total{status="ok" 12\nnot a line\n',
    "# HELP x\n",
    "pulse_requests_total 1",
    "",
])
def test_validators_agree_on_bad_input(text):
    assert ppulse.validate_exposition(text) == \
        jpulse.validate_exposition(text)
    assert ppulse.validate_exposition(text)


@pytest.mark.parametrize("doc", [
    "not a dict",
    {},
    {"schema": 1, "kind": "pulse_ring", "windows": "x"},
    {"schema": 2, "kind": "other", "windows": [{"window": 1},
                                                {"window": 0}],
     "totals": {}, "burn_events": None},
])
def test_ring_validators_agree_on_bad_documents(doc):
    assert ppulse.validate_ring(doc) == jpulse.validate_ring(doc)
    assert ppulse.validate_ring(doc)


def _ring(mod, latencies, shed=0):
    m, now = _mon(mod)
    for i, ms in enumerate(latencies):
        now[0] = float(i)
        m.observe("completed", latency_ms=ms)
    for _ in range(shed):
        m.observe("shed")
    m.close()
    return _stampless(m.snapshot())


def test_merge_rings_equals_jax_and_is_exactly_pooled():
    a, b = [3.0, 1.0, 4.0, 1.5], [9.0, 2.6, 5.3]
    docs = {pkg: [_ring(mod, a, shed=2), _ring(mod, b)]
            for pkg, mod in PKGS.items()}
    assert docs["port"] == docs["jax"]
    merged = ppulse.merge_rings(docs["port"])
    assert merged == jpulse.merge_rings(docs["jax"])
    assert merged["problems"] == [] and merged["totals"]["shed"] == 2
    pooled = Histogram()
    for v in a + b:
        pooled.observe(v)
    lat = merged["totals"]["latency_ms"]
    assert lat["count"] == 7
    for q, field in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
        assert lat[field] == pooled.quantile(q)
    # tampered rings: a window without samples, a pooled != streamed one
    no_samples = json.loads(json.dumps(docs["port"][0]))
    del next(w for w in no_samples["windows"]
             if w["latency_ms"]["count"])["latency_ms"]["samples"]
    tampered = json.loads(json.dumps(docs["port"][1]))
    next(w for w in tampered["windows"]
         if w["latency_ms"]["count"])["latency_ms"]["samples"] = [999.0]
    for bad in ([no_samples], [tampered], [no_samples, tampered]):
        ours, theirs = ppulse.merge_rings(bad), jpulse.merge_rings(bad)
        assert ours == theirs and ours["problems"]
    assert ppulse.ring_latency_histogram(no_samples)[1] == \
        jpulse.ring_latency_histogram(no_samples)[1]


def test_endpoint_scrapes_metrics_ring_and_health():
    m, now = _mon(ppulse)
    m.observe("completed", tenant="t0", latency_ms=1.0)
    now[0] = 1.0
    m.advance()
    ep = ppulse.PulseEndpoint(m, port=0).start()
    try:
        assert ep.port > 0
        with urllib.request.urlopen(f"{ep.url}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert ppulse.validate_exposition(text) == []
        assert text == m.exposition_text()
        with urllib.request.urlopen(f"{ep.url}/pulse.json",
                                    timeout=10) as resp:
            doc = json.loads(resp.read().decode())
        assert ppulse.validate_ring(doc) == []
        assert doc["totals"]["completed"] == 1
        with urllib.request.urlopen(f"{ep.url}/healthz",
                                    timeout=10) as resp:
            assert resp.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{ep.url}/nope", timeout=10)
    finally:
        ep.stop()


def test_served_series_matches_its_slo_report(factory, tmp_path):
    """A CPU server with a monitor attached: one window per request,
    the pooled stream equal to the report (the JAX test's assertions),
    HBM sampled from the accountant, the ledger record at close."""
    fac, n_rows = factory
    now = [0.0]
    mon = ppulse.PulseMonitor(window_s=1.0, clock=lambda: now[0],
                              name="report", ledger_dir=str(tmp_path))
    srv = pserve.ArrowServer(fac, pserve.ExecConfig(),
                             policy=RetryPolicy(backoff_s=0.001),
                             name="report")
    assert srv.attach_pulse(mon) is mon
    trace = pserve.synthetic_trace(n_rows, tenants=2, requests=4, k=K,
                                   iterations=2, seed=SEED)
    tickets = []
    for r in trace:
        tickets.append(srv.submit(r))
        srv.drain()
        now[0] += 1.0
        mon.advance()
    mon.close("test done")
    report = pserve.slo_summary(srv, tickets, now[0], pulse=mon)
    pt = report["pulse"]
    assert pt["totals"]["completed"] == report["completed"] == 4
    assert [w["completed"] for w in pt["windows"][:4]] == [1, 1, 1, 1]
    for q in ("p50", "p90", "p99"):
        assert pt["totals"]["latency_ms"][q] == pytest.approx(
            report["latency_ms"][q], abs=1e-2)
    assert ppulse.validate_ring(mon.snapshot()) == []
    assert pt["totals"]["hbm"]["occupancy"] is not None
    assert pt["window_s"] == 1.0 and pt["ring_path"] is None
    (rec,) = Ledger(str(tmp_path)).read_all()
    assert rec["kind"] == "pulse" and rec["payload"]["closed"] == \
        "test done"
    assert (rec["platform"], rec["device_kind"]) == ("cpu", "cpu")
    assert mon.ledger_record == rec


def test_slo_burn_walks_the_tenants_down_the_ladder(factory):
    fac, n_rows = factory
    now = [0.0]
    mon = ppulse.PulseMonitor(
        window_s=1.0, clock=lambda: now[0],
        watchdog=ppulse.SloWatchdog([ppulse.BurnRule.p99_latency(
            1e-9, min_windows=1)]))
    srv = pserve.ArrowServer(fac, pserve.ExecConfig(repl=2),
                             policy=RetryPolicy(backoff_s=0.001))
    srv.attach_pulse(mon)
    assert mon.watchdog.on_burn == srv._on_slo_burn
    pserve.run_trace(srv, pserve.synthetic_trace(
        n_rows, tenants=2, requests=2, k=4, iterations=1, seed=SEED))
    now[0] = 1.0
    mon.advance()
    burns = [e for e in mon.burn_events if e["event"] == "slo_burn"]
    assert [e["rule"] for e in burns] == ["p99_latency"]
    tenants = srv.summary()["tenants"]
    assert tenants and all(t["rung"] == 1 for t in tenants.values())
    assert all(t["degradations"][0]["reason"] == "slo_burn:p99_latency"
               for t in tenants.values())


def test_threaded_server_with_pulse_under_the_witness(factory):
    """The always-on worker, three submitter threads and scrapes of the
    endpoint, with the lock-order witness armed (objects built after
    it): every request completes, every serve span carries its request
    id, the monitor's pooled latency equals the server's samples, and
    the witness saw no inversion."""
    fac, n_rows = factory
    registry = sync.enable_witness()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    tracer = Tracer("witnessed")
    mon = ppulse.PulseMonitor(window_s=0.05, name="witnessed",
                              watchdog=ppulse.SloWatchdog())
    srv = pserve.ArrowServer(fac, pserve.ExecConfig(), queue_capacity=64,
                             tracer=tracer, max_batch_k=8,
                             policy=RetryPolicy(backoff_s=0.001))
    srv.attach_pulse(mon)
    ep = ppulse.PulseEndpoint(mon, port=0).start()
    tickets, lock = [], threading.Lock()
    try:
        srv.start()
        trace = pserve.synthetic_trace(n_rows, tenants=4, requests=12,
                                       k=2, iterations=2, seed=7)

        def submitter(chunk):
            for r in chunk:
                t = srv.submit(r)
                with lock:
                    tickets.append(t)
                with urllib.request.urlopen(f"{ep.url}/metrics",
                                            timeout=10) as resp:
                    resp.read()

        threads = [threading.Thread(target=submitter,
                                    args=(trace[i::3],))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for t in tickets:
            assert t.wait(120)
        srv.shutdown(wait=True, timeout=120)
        mon.close()
    finally:
        ep.stop()
        sys.setswitchinterval(old)
        sync.disable_witness()
    assert [t.status for t in tickets] == ["completed"] * 12
    snap = registry.snapshot()
    assert snap["violations"] == []
    assert len(snap["threads"]) >= 2
    names = {s.name for s in tracer.spans}
    assert {"admission", "batch", "attempt", "finalize"} <= names
    for s in tracer.spans:
        assert s.args.get("request_id"), f"span {s.name!r} lacks request_id"
    pooled = mon.merged_latency()
    assert len(pooled.values) == 12
    assert sorted(round(v, 3) for v in srv.latency_samples_ms()) == \
        sorted(pooled.values)
    assert mon.totals_dict()["latency_ms"]["count"] == 12
    assert ppulse.validate_ring(mon.snapshot()) == []

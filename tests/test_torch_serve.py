"""The port's serving runtime (``arrow_matrix_tpu_torch.serve``) against
the JAX package's on the CPU: one seeded trace through both servers over
the same Barabasi-Albert fold (the JAX tests' fixture, n = 64, width
16), with equal admission censuses, terminal states, attempts and
degradations, and results within ``relative_tolerance``; within the
port, batched results and the column schedules equal the plain run bit
for bit; the ladder, the trace generator, the SLO report and the
admission price."""

import types

import numpy as np
import pytest
import torch

from arrow_matrix_tpu import faults as jfaults
from arrow_matrix_tpu import serve as jserve
from arrow_matrix_tpu.faults import RetryPolicy as JPolicy
from arrow_matrix_tpu.obs import memview as jmemview
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu_torch import faults as pfaults
from arrow_matrix_tpu_torch import serve as pserve
from arrow_matrix_tpu_torch.faults import RetryPolicy as PPolicy
from arrow_matrix_tpu_torch.obs import memview as pmemview
from arrow_matrix_tpu_torch.ops.worklist import THREADS
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

torch.set_num_threads(2)

N, WIDTH, K, SEED = 64, 16, 2, 5


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    jfaults.clear_plan()
    pfaults.clear_plan()
    yield
    jfaults.clear_plan()
    pfaults.clear_plan()


@pytest.fixture(scope="module")
def pkgs():
    """Both packages' serving modules over their own BA factory of the
    same graph."""
    return {
        "jax": types.SimpleNamespace(
            serve=jserve, faults=jfaults, Policy=JPolicy, memview=jmemview,
            factory=jserve.ba_executor_factory(N, WIDTH, SEED, fmt="fold")),
        "port": types.SimpleNamespace(
            serve=pserve, faults=pfaults, Policy=PPolicy, memview=pmemview,
            factory=pserve.ba_executor_factory(N, WIDTH, SEED, fmt="fold",
                                               device="cpu")),
    }


def _trace(p, requests=4, tenants=2, iterations=2, k=K, **kw):
    return p.serve.synthetic_trace(p.factory[1], tenants=tenants,
                                   requests=requests, k=k,
                                   iterations=iterations, seed=SEED, **kw)


def _server(p, base=None, **kw):
    kw.setdefault("policy", p.Policy(backoff_s=0.001))
    return p.serve.ArrowServer(p.factory[0], base or p.serve.ExecConfig(),
                               **kw)


def _price(p):
    ex = p.factory[0](p.serve.ExecConfig())
    resident = p.memview.predicted_bytes_for(ex, 0) or 0
    return resident, p.serve.request_price_bytes(ex, K)


def scenario_at_budget(p):
    resident, price = _price(p)
    srv = _server(p, hbm_budget_bytes=resident + price)
    return srv, p.serve.run_trace(srv, _trace(p, requests=2))


def scenario_zero_headroom(p):
    resident, _ = _price(p)
    srv = _server(p, hbm_budget_bytes=resident)
    return srv, p.serve.run_trace(srv, _trace(p, requests=3))


def scenario_burst(p):
    srv = _server(p, queue_capacity=2)
    tickets = [srv.submit(r) for r in _trace(p, requests=6)]
    srv.drain()
    return srv, tickets


def scenario_deadline(p):
    srv = _server(p)
    return srv, p.serve.run_trace(srv, _trace(p, requests=2,
                                              deadline_s=1e-9))


def scenario_after_shutdown(p):
    srv = _server(p, queue_capacity=4)
    srv.start()
    srv.shutdown(wait=True)
    return srv, [srv.submit(_trace(p, requests=1)[0])]


def scenario_worker_thread(p):
    srv = _server(p, queue_capacity=8)
    srv.start()
    try:
        tickets = p.serve.run_trace(srv, _trace(p, requests=3))
    finally:
        srv.shutdown(wait=True)
    return srv, tickets


def scenario_batched(p):
    srv = _server(p, max_batch_k=4 * K)
    return srv, p.serve.run_trace(srv, _trace(p, requests=4))


def scenario_degrade(p):
    """Retries exhausted on the base rung (overlap S=2): the tenant
    degrades to S=1 and the request completes there."""
    p.faults.set_plan({"scenario": "error", "site": "multi_level.step",
                       "after": 0, "count": 2})
    try:
        srv = _server(p, p.serve.ExecConfig(overlap_slabs=2),
                      policy=p.Policy(max_retries=1, backoff_s=0.001),
                      degrade_after=1)
        tickets = p.serve.run_trace(srv, _trace(p, requests=1, tenants=1))
    finally:
        p.faults.clear_plan()
    return srv, tickets


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_at_budget, scenario_zero_headroom, scenario_burst,
    scenario_deadline, scenario_after_shutdown, scenario_worker_thread,
    scenario_batched, scenario_degrade)}


def _census(srv, tickets):
    s = srv.summary()
    top = {k: s[k] for k in ("submitted", "admitted", "completed", "failed",
                             "shed", "rejected", "batches",
                             "batched_requests", "faults_seen",
                             "recoveries")}
    tenants = {name: (t["completed"], t["failed"], t["shed"],
                      t["rejected"], t["rung"], t["config"],
                      [(d["from"], d["to"], d["reason"])
                       for d in t["degradations"]])
               for name, t in s["tenants"].items()}
    states = [(t.request.request_id, t.status, t.reason, t.attempts,
               t.faults_seen, t.recoveries) for t in tickets]
    return top, tenants, states


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_census_and_results_equal_the_jax_server(pkgs, name):
    (js, jt), (ps, pt) = (SCENARIOS[name](pkgs[w]) for w in ("jax",
                                                             "port"))
    assert _census(ps, pt) == _census(js, jt)
    ex = pkgs["port"].factory[0](pserve.ExecConfig())
    done = 0
    for a, b in zip(pt, jt):
        assert (a.result is None) == (b.result is None)
        if a.result is None:
            continue
        done += 1
        assert a.result.shape == (N, a.request.k)
        tol = relative_tolerance(ex.nnz / N, a.request.iterations)
        assert relative_error(a.result, b.result) <= tol
    if name in ("at_budget", "worker_thread", "batched", "degrade"):
        assert done > 0


def test_degraded_result_equals_the_base_rung_bit_for_bit(pkgs):
    p = pkgs["port"]
    srv, ref = _server(p, p.serve.ExecConfig(overlap_slabs=2)), None
    ref = p.serve.run_trace(srv, _trace(p, requests=1, tenants=1))
    _, tickets = scenario_degrade(p)
    assert tickets[0].status == "completed" and tickets[0].attempts == 2
    assert tickets[0].exec_config == p.serve.ExecConfig()
    assert tickets[0].result.tobytes() == ref[0].result.tobytes()


def test_batching_bit_identical(pkgs):
    p = pkgs["port"]
    solo_srv = _server(p)
    solo = p.serve.run_trace(solo_srv, _trace(p, requests=4))
    batched_srv, batched = scenario_batched(p)
    assert solo_srv.batches == 4 and batched_srv.batches < 4
    assert batched_srv.batched_requests == 4
    for a, b in zip(solo, batched):
        assert a.status == b.status == "completed"
        assert a.result.tobytes() == b.result.tobytes()


@pytest.mark.parametrize("repl,slabs", [(2, 1), (4, 1), (1, 2), (1, 4),
                                       (2, 2), (4, 2)])
def test_column_schedule_equals_repl_1_bit_for_bit(pkgs, repl, slabs):
    p = pkgs["port"]
    cfg = p.serve.ExecConfig(repl=repl, overlap_slabs=slabs)
    got = p.serve.run_trace(_server(p, cfg, max_batch_k=16),
                            _trace(p, requests=4, k=8, iterations=3))
    want = p.serve.run_trace(_server(p), _trace(p, requests=4, k=8,
                                               iterations=3))
    for a, b in zip(got, want):
        assert a.status == b.status == "completed"
        assert a.exec_config == cfg
        assert a.result.tobytes() == b.result.tobytes()


def test_a_width_the_rung_cannot_split_runs_on_the_last_rung(pkgs):
    p = pkgs["port"]
    srv = _server(p, p.serve.ExecConfig(repl=2, overlap_slabs=2))
    (t,) = p.serve.run_trace(srv, _trace(p, requests=1, k=2))
    assert t.status == "completed"
    assert t.exec_config == p.serve.ExecConfig()


def test_ladder_and_divisibility_equal_jax():
    for kw in ({}, {"repl": 2}, {"overlap_slabs": 4},
               {"repl": 2, "overlap_slabs": 2},
               {"kernel": "pallas_sell", "repl": 2, "overlap_slabs": 2}):
        ours = pserve.degradation_ladder(pserve.ExecConfig(**kw))
        theirs = jserve.degradation_ladder(jserve.ExecConfig(**kw))
        assert [vars(c) for c in ours] == [vars(c) for c in theirs]
        for k in range(0, 17):
            assert pserve.ExecConfig(**kw).accepts_k(k) == \
                jserve.ExecConfig(**kw).accepts_k(k)
    assert pserve.degradation_ladder(pserve.ExecConfig()) == \
        (pserve.ExecConfig(),)


def test_synthetic_trace_is_byte_identical_to_jax():
    for kw in ({}, {"k": 16, "requests": 9, "tenants": 3, "seed": 7},
               {"deadline_s": 0.5}):
        ours = pserve.synthetic_trace(100, **kw)
        theirs = jserve.synthetic_trace(100, **kw)
        assert [(r.request_id, r.tenant, r.iterations, r.deadline_s,
                 r.traffic_class, r.x.dtype, r.x.tobytes()) for r in ours] \
            == [(r.request_id, r.tenant, r.iterations, r.deadline_s,
                 r.traffic_class, r.x.dtype, r.x.tobytes()) for r in theirs]


def test_slo_summary_has_the_jax_fields(pkgs, tmp_path):
    reports = {}
    for w in ("jax", "port"):
        p = pkgs[w]
        srv = _server(p)
        tickets = p.serve.run_trace(srv, _trace(p, requests=3))
        reports[w] = p.serve.slo_summary(srv, tickets, wall_s=1.0)
    ours, theirs = reports["port"], reports["jax"]
    assert set(ours) == set(theirs)
    assert ours["completed"] == theirs["completed"] == 3
    assert ours["requests_per_s"] == 3.0 and ours["pulse"] is None
    assert set(ours["per_tenant"]) == set(theirs["per_tenant"])
    assert ours["latency_ms"]["p50"] <= ours["latency_ms"]["p99"]
    import json

    path = pserve.write_serve_artifacts(str(tmp_path), ours)
    with open(path, encoding="utf-8") as fh:
        assert json.load(fh)["completed"] == 3


def test_request_price_is_the_carriage_counted_by_hand(pkgs):
    """The work list is priced at its widest lane layout (8 rows a CTA);
    every row of the tiny fold fits one chunk, so each non-empty tier
    takes ceil(n_t / 8) items and nothing splits.  The price is the
    work-list tables (a 64-byte row a tier, 16 bytes an item) and three
    carriages (entry state, step input, step output), each in whole
    512-byte allocator blocks, and the finite check's five one-block
    scalars."""
    ex = pkgs["port"].factory[0](pserve.ExecConfig())
    p_rows = THREADS // 32
    items = sum(-(-int(c.shape[1]) // p_rows) for c in ex.sell.cols
                if c.shape[1] > 0)
    assert max(int(c.shape[0]) for c in ex.sell.cols) <= 128
    rows = ex.total_rows
    block = lambda b: -(-b // 512) * 512

    def want(itemsize):
        return (block(len(ex.sell.cols) * 64) + block(items * 16)
                + 3 * block(rows * K * itemsize) + 5 * 512)

    assert pserve.request_price_bytes(ex, K) == want(4)
    assert ex.carriage_hbm_bytes(K) == want(4)
    assert ex.predicted_hbm_bytes(K) - ex.predicted_hbm_bytes(0) == want(4)
    assert ex.predicted_hbm_bytes(0) == ex.sell.device_nbytes()
    # repl is the JAX planning multiplier of the whole model.
    assert pserve.request_price_bytes(ex, K, repl=2) == 2 * want(4)
    # bf16 carriage (the approx class): 2-byte carriages.
    assert pserve.request_price_bytes(ex, K, itemsize=2) == want(2)


def test_server_runs_on_the_levels_and_fold_the_jax_package_built(
        pkgs, tmp_path):
    """The JAX package's fold, exported and loaded by the port
    (``load_folded``), served by the port: the same census as the JAX
    server over its own executor."""
    from arrow_matrix_tpu.decomposition import arrow_decomposition
    from arrow_matrix_tpu.utils import barabasi_albert

    levels = arrow_decomposition(barabasi_albert(N, 3, seed=SEED), WIDTH,
                                 max_levels=10, block_diagonal=True,
                                 seed=SEED)
    JaxArrow(levels, WIDTH, fmt="fold").export_folded(str(tmp_path))

    def port_factory(cfg):
        return MultiLevelArrow.load_folded(
            str(tmp_path), device="cpu", repl=cfg.repl,
            overlap_slabs=cfg.overlap_slabs)

    def jax_factory(cfg):
        return JaxArrow(levels, WIDTH, fmt="fold", repl=cfg.repl,
                        overlap_slabs=cfg.overlap_slabs)

    runs = {}
    for w, fac in (("port", port_factory), ("jax", jax_factory)):
        p = types.SimpleNamespace(**vars(pkgs[w]))
        p.factory = (fac, N)
        srv = _server(p, p.serve.ExecConfig(repl=2), max_batch_k=8)
        runs[w] = (srv, p.serve.run_trace(srv, _trace(p, requests=5)))
    assert _census(*runs["port"]) == _census(*runs["jax"])
    nnz = runs["port"][0]._build_executor(pserve.ExecConfig(repl=2)).nnz
    for a, b in zip(runs["port"][1], runs["jax"][1]):
        assert relative_error(a.result, b.result) <= relative_tolerance(
            nnz / N, 2)


def test_policy_equals_jax_and_validates():
    for kw in ({}, {"max_retries": 3, "backoff_s": 0.1, "jitter": 0.5,
                    "seed": 7},
               {"max_retries": 4, "backoff_factor": 3.0, "jitter": 1.0,
                "seed": 123}):
        ours, theirs = PPolicy(**kw), JPolicy(**kw)
        for salt in ("", "a", "gate:r0001+r0002:it3"):
            assert ours.schedule(salt) == theirs.schedule(salt)
        assert ours.for_worker("w7") == PPolicy(
            **vars(theirs.for_worker("w7")))
    for bad in ({"max_retries": -1}, {"jitter": 1.5},
                {"backoff_factor": 0.5}):
        with pytest.raises(ValueError):
            PPolicy(**bad)


def test_unported_parts_raise_naming_their_roadmap_item(pkgs, tmp_path,
                                                       capsys):
    """A tune plan the port cannot apply (no backend, no structure) is a
    loud miss, never a silent default.  Live resharding on one device
    behaves as the JAX package's: a grow target of another replication
    grows with nothing to migrate (the fold carries one copy whatever
    ``repl``), the base rung then runs the grown executor, a second grow
    is a no-op, and pressure toward a server with no target grows
    nothing (grows on a mesh of ranks: tests/test_torch_mesh_serve.py)."""
    from arrow_matrix_tpu_torch.tune import TunePlanMiss

    p = pkgs["port"]
    with pytest.warns(TunePlanMiss, match="backend"):
        srv = _server(p, tune_plan={"candidate": "fold"})
    assert srv.tune_plan is None
    lines = []
    for name in ("jax", "port"):
        q = pkgs[name]
        srv = _server(q, grow_config=q.serve.ExecConfig(repl=2),
                      checkpoint_dir=str(tmp_path / name))
        assert srv.note_slo_pressure("test", direction="grow") == ["*"]
        assert srv.grow() and srv.grows == 1
        assert srv._executor_for(q.serve.ExecConfig())[1] == \
            q.serve.ExecConfig(repl=2)
        assert _server(q).note_slo_pressure("t", direction="grow") == []
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if "grew to" in ln])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert "0 checkpoint(s) migrated through 0 staged plan step(s)" in \
        lines[1][0]


def test_attach_pulse_feeds_the_monitor_like_jax(pkgs):
    """The same trace through both servers, each with a monitor on a
    frozen clock: the same event counts per tenant reach both, and the
    HBM gauge is sampled from each server's accountant."""
    from arrow_matrix_tpu.obs import pulse as jpulse
    from arrow_matrix_tpu_torch.obs import pulse as ppulse

    totals = {}
    for name, mod in (("jax", jpulse), ("port", ppulse)):
        p = pkgs[name]
        mon = mod.PulseMonitor(window_s=1.0, clock=lambda: 0.0,
                               watchdog=mod.SloWatchdog())
        srv = _server(p, max_batch_k=2 * K)
        assert srv.attach_pulse(mon) is mon and srv.pulse is mon
        assert mon.watchdog.on_burn == srv._on_slo_burn
        p.serve.run_trace(srv, _trace(p, requests=4, tenants=2))
        mon.close()
        t = mon.totals_dict()
        assert t["hbm"]["in_use_bytes"] is not None
        assert t["latency_ms"]["count"] == 4
        totals[name] = {key: t[key] for key in (
            "submitted", "admitted", "completed", "failed", "shed",
            "rejected", "degraded", "faults_seen")}
        totals[name]["per_tenant"] = {
            tn: rec["completed"] for tn, rec in t["per_tenant"].items()}
    assert totals["port"] == totals["jax"]
    assert totals["port"]["completed"] == 4


def test_a_failing_monitor_never_takes_the_server_down(pkgs):
    p = pkgs["port"]

    class Broken:
        watchdog = None

        def observe(self, event, **data):
            raise RuntimeError("telemetry down")

    srv = _server(p)
    srv.attach_pulse(Broken())
    tickets = p.serve.run_trace(srv, _trace(p, requests=2))
    assert [t.status for t in tickets] == ["completed"] * 2


def test_smoke_serve_on_the_cpu_gives_the_jax_summary(tmp_path):
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.obs import pulse as ppulse

    import json
    import os

    ours = pserve.smoke_serve(str(tmp_path / "port"), n=N, width=WIDTH,
                              device="cpu")
    theirs = jserve.smoke_serve(str(tmp_path / "jax"), n=N, width=WIDTH)
    assert set(ours) == set(theirs)
    assert set(ours["pulse"]) == set(theirs["pulse"])
    assert set(ours["latency_ms"]) == set(theirs["latency_ms"])
    for key in ("requests", "completed", "failed", "shed", "rejected",
                "batches", "batched_requests"):
        assert ours[key] == theirs[key], key
    assert ours["completed"] == ours["requests"] == 4
    run = str(tmp_path / "port")
    with open(os.path.join(run, "serve_summary.json")) as fh:
        assert json.load(fh)["ledger_record_id"] == \
            ours["ledger_record_id"] is not None
    assert ppulse.validate_ring(ppulse.load_ring(
        os.path.join(run, "pulse_ring.json"))) == []
    with open(os.path.join(run, "pulse_metrics.prom")) as fh:
        assert ppulse.validate_exposition(fh.read()) == []
    lg = Ledger(os.path.join(run, "ledger"))
    assert lg.validate() == []
    kinds = {r["kind"]: r for r in lg.read_all()}
    assert set(kinds) == {"pulse", "serve"}
    assert kinds["serve"]["record_id"] == ours["ledger_record_id"]
    for rec in kinds.values():
        assert (rec["platform"], rec["device_kind"]) == ("cpu", "cpu")


def test_slo_pressure_degrades_every_named_tenant(pkgs):
    p = pkgs["port"]
    srv = _server(p, p.serve.ExecConfig(repl=2, overlap_slabs=2))
    p.serve.run_trace(srv, _trace(p, requests=2, tenants=2, k=4))
    assert srv.note_slo_pressure("test") == sorted(srv.summary()["tenants"])
    assert all(t["rung"] == 1 for t in srv.summary()["tenants"].values())


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.ba_executor_factory(N, WIDTH, SEED)


@pytest.mark.parametrize("n,width,seed", [(64, 16, 5), (4096, 64, 11)])
def test_factory_cache_loads_the_same_decomposition(tmp_path, monkeypatch,
                                                    n, width, seed):
    """With ``AMT_BA_CACHE_DIR`` the factory computes and saves the
    decomposition once, then loads it; every executor over it gives the
    computed decomposition's bits."""
    from arrow_matrix_tpu_torch.utils import random_dense

    def three_steps():
        factory, _ = pserve.ba_executor_factory(n, width, seed, device="cpu")
        ml = factory(pserve.ExecConfig())
        x = ml.set_features(random_dense(ml.n, 4, seed=7))
        return np.asarray(ml.gather_result(ml.run(x, 3)))

    monkeypatch.delenv("AMT_BA_CACHE_DIR", raising=False)
    computed = three_steps()
    monkeypatch.setenv("AMT_BA_CACHE_DIR", str(tmp_path))
    first = three_steps()
    done = [f for f in tmp_path.iterdir() if f.name.endswith(".complete")]
    assert len(done) == 1
    loaded = three_steps()
    assert computed.tobytes() == first.tobytes() == loaded.tobytes()

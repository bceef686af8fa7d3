"""The port's tuning layer (``arrow_matrix_tpu_torch/tune``) and the
fold executor options against the JAX package on the same seeded
inputs: the structure hash and the ``plan="auto"`` key, the structural
candidates and their prune reasons, the fold through K1's knobs within
``relative_tolerance`` of the JAX fold, every order-keeping knob point
bit-equal to the default through the plain twin, a plan file the JAX
package wrote refused loudly, the search with CPU children and its
zero-child hit, the gate, the CLI, the server's ``tune_plan`` and the
factory's ``plan``.  Nothing here gates on CPU timing."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.parallel import MultiLevelArrow as JMultiLevelArrow
from arrow_matrix_tpu.tune import plan as jplan
from arrow_matrix_tpu.tune import space as jspace
from arrow_matrix_tpu_torch import tune as ptune
from arrow_matrix_tpu_torch.ops import cuda_sell, sell, worklist
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.tune import (
    TunePlan,
    TunePlanMiss,
    load_levels_from_source,
)
from arrow_matrix_tpu_torch.tune import gate as pgate
from arrow_matrix_tpu_torch.tune import plan as pplan
from arrow_matrix_tpu_torch.tune import space as pspace
from arrow_matrix_tpu_torch.tune.fingerprint import (
    structure_fingerprint,
    structure_hash,
)
from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _children_use_two_threads(monkeypatch):
    """The race's CPU children (subprocesses) take two threads each, as
    this process does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


#: Structural candidates: the reference's names and prune reasons.
STRUCTURAL = ("default", "fold_tight", "fold_coarse", "ell_one_tier", "hyb",
              "overlap2", "repl2", "bf16", "int8")


def _source(n, width=16, seed=3):
    return {"kind": "ba", "n": n, "m": 3, "width": width, "seed": seed,
            "max_levels": 4}


@pytest.fixture(scope="module")
def ba512():
    levels, width = load_levels_from_source(_source(512, 32))
    return levels, width


def test_tune_exports_the_reference_all():
    from arrow_matrix_tpu import tune as jtune

    assert set(jtune.__all__) <= set(ptune.__all__)
    for name in ptune.__all__:
        assert hasattr(ptune, name), name
    assert ptune.PLAN_VERSION == jplan.PLAN_VERSION


def test_hash_and_the_auto_key_equal_jax(ba512, tmp_path, monkeypatch):
    levels, width = ba512
    h = structure_hash(levels, width)
    from arrow_matrix_tpu.tune.fingerprint import structure_hash as jhash

    assert h == jhash(levels, width)
    seen = {}
    monkeypatch.setattr(jplan, "load_plan",
                        lambda hh, k, d=None, quiet=False:
                        seen.setdefault("jax", hh))
    jplan.resolve_plan("auto", levels=levels, width=width, plan_k=16)
    plan = dataclasses.replace(TunePlan(structure_hash=h, k=16),
                               kernel="pallas_sell", batch=4)
    pplan.save_plans(h, {16: plan}, directory=str(tmp_path))
    got = pplan.resolve_plan("auto", levels=levels, width=width, plan_k=16,
                             directory=str(tmp_path))
    assert seen["jax"] == h and got == plan
    assert os.path.basename(pplan.plan_path(h, str(tmp_path))) == \
        os.path.basename(jplan.plan_path(h, str(tmp_path)))


@pytest.mark.parametrize("n", [96, 512])
@pytest.mark.parametrize("k", [8, 16, 128])
@pytest.mark.parametrize("budget", [None, 1 << 12])
def test_structural_candidates_and_prune_reasons_equal_jax(n, k, budget):
    levels, width = load_levels_from_source(_source(n, 32))
    fp = structure_fingerprint(levels, width)
    b = budget if budget is not None else 1 << 40
    ours, opruned = pspace.enumerate_candidates(fp, k, budget_bytes=b,
                                                allow_int8=True)
    theirs, tpruned = jspace.enumerate_candidates(fp, k, budget_bytes=b,
                                                  allow_int8=True)
    got = {c.name: c for c in ours}
    want = {c.name: c for c in theirs}
    for name in STRUCTURAL:
        assert (name in got) == (name in want), name
        assert opruned.get(name) == tpruned.get(name), name
        if name in got:
            assert got[name].build == want[name].build
            assert got[name].eligible == want[name].eligible
    if budget is not None and k % 2 == 0:
        assert opruned["repl2"].startswith("HBM certificate")
    assert "no meaning on the port's fold" in opruned["chunk_4096"]
    assert pspace.predicted_operator_bytes(fp, k) == \
        jspace.predicted_operator_bytes(fp, k)
    knobs = {c.name for c in pspace.knob_candidates(False)}
    assert knobs <= set(got) | set(opruned)
    assert {c.name for c in ours if not c.eligible} >= {
        "pallas_sell_chunk64", "pallas_sell_chunk256", "pallas_sell_bf16",
        "bf16"}


def test_restrict_and_the_approx_class_follow_jax(ba512):
    levels, width = ba512
    fp = structure_fingerprint(levels, width)
    for cls in ("exact", "approx"):
        ours, op = pspace.enumerate_candidates(
            fp, 16, budget_bytes=1 << 40, traffic_class=cls,
            restrict=["default", "bf16", "hyb"])
        theirs, tp = jspace.enumerate_candidates(
            fp, 16, budget_bytes=1 << 40, traffic_class=cls,
            restrict=["default", "bf16", "hyb"])
        assert [(c.name, c.eligible) for c in ours] == \
            [(c.name, c.eligible) for c in theirs]
    with pytest.raises(ValueError, match="traffic class"):
        pspace.enumerate_candidates(fp, 16, traffic_class="fast")


@pytest.mark.parametrize("opts", [
    {}, {"batch": 4}, {"batch": 8, "ctas_per_sm": 1},
    {"chunk_slots": 64, "batch": 4}, {"chunk_slots": 256},
    "synth"])
@pytest.mark.parametrize("k", [4, 16])
def test_the_fold_through_k1s_knobs_matches_jax(ba512, opts, k):
    levels, width = ba512
    if opts == "synth":
        from arrow_matrix_tpu_torch.tune.synth import synthesize_schedule

        opts = {"schedule": synthesize_schedule(
            structure_fingerprint(levels, width))}
    x = np.random.default_rng(k).standard_normal(
        (512, k)).astype(np.float32)
    ours = MultiLevelArrow(levels, width, fmt="fold", kernel="pallas_sell",
                           kernel_opts=opts, device="cpu")
    theirs = JMultiLevelArrow(levels, width, fmt="fold")
    y = ours.gather_result(ours.run(ours.set_features(x), 3))
    want = theirs.gather_result(theirs.run(theirs.set_features(x), 3))
    nnz = sum(lvl.matrix.nnz for lvl in levels)
    assert relative_error(y, np.asarray(want)) <= \
        relative_tolerance(nnz / 512, 3)
    default = MultiLevelArrow(levels, width, fmt="fold", device="cpu")
    d = default.gather_result(default.run(default.set_features(x), 3))
    if opts.get("chunk_slots", 128) == 128:
        # Every tier here holds at most 128 slots: one chunk a row.
        assert np.array_equal(y, d)


def _hub_operator(binary):
    """A multi-tier operator with a 2,000-slot hub row (16 chunks of 125,
    split across CTAs at k = 128)."""
    rng = np.random.default_rng(7)
    shapes = ((0, 9), (8, 300), (40, 60), (300, 4), (2000, 1))
    n = sum(n_t for _, n_t in shapes)
    cols, deg, vals = [], [], []
    for m_t, n_t in shapes:
        d = rng.integers(max(m_t - 3, 0), m_t + 1, n_t).astype(np.int32)
        c = rng.integers(0, n, (m_t, n_t)).astype(np.int32)
        pad = np.arange(m_t)[:, None] >= d[None, :]
        c[pad] = 0
        cols.append(c)
        deg.append(d)
        vals.append(np.where(pad, 0.0, rng.uniform(-1, 1, (m_t, n_t)))
                    .astype(np.float32))
    starts = np.cumsum([0] + [n_t for _, n_t in shapes[:-1]])
    return sell.sell_from_arrays(cols, None if binary else vals,
                                 deg if binary else None, n, starts,
                                 device="cpu")


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_order_keeping_knob_points_are_bit_equal_through_the_twin(binary, k,
                                                                  dtype):
    import itertools

    m = _hub_operator(binary)
    rng = np.random.default_rng(k)
    x = (torch.from_numpy(rng.integers(-127, 128, (m.n_rows, k)).astype(
        np.int8)) if dtype == torch.int8 else
        torch.from_numpy(rng.uniform(-1, 1, (m.n_rows, k)).astype(
            np.float32)).to(dtype))
    base = cuda_sell.sell_spmm_cuda(m, x, worklist.DEFAULT_OPTS)
    for b, ctas in itertools.product(worklist.BATCH_CHOICES,
                                     worklist.CTAS_PER_SM_CHOICES):
        opts = worklist.LaunchOpts(batch=b, ctas_per_sm=ctas)
        assert opts.keeps_order()
        assert torch.equal(cuda_sell.sell_spmm_cuda(m, x, opts), base)
    for cs in (64, 256):
        other = cuda_sell.sell_spmm_cuda(
            m, x, worklist.LaunchOpts(chunk_slots=cs))
        assert not worklist.LaunchOpts(chunk_slots=cs).keeps_order()
        assert relative_error(other.float().numpy(),
                              base.float().numpy()) <= 2e-2


def test_a_jax_written_plan_is_refused_loudly(ba512, tmp_path, monkeypatch):
    levels, width = ba512
    h = structure_hash(levels, width)
    jp = jplan.TunePlan(structure_hash=h, k=16, kernel="pallas_sell",
                        row_block=128, ring=4, candidate="pallas_sell_rb128")
    jplan.save_plans(h, {16: jp}, directory=str(tmp_path))
    with pytest.warns(TunePlanMiss, match="backend.*row_block"):
        assert pplan.load_plan(h, 16, str(tmp_path)) is None
    monkeypatch.setenv("AMT_TUNE_PLAN_DIR", str(tmp_path))
    with pytest.warns(TunePlanMiss, match="TPU knobs"):
        ex = MultiLevelArrow(levels, width, fmt="fold", plan="auto",
                             plan_k=16, device="cpu")
    assert ex.tune_plan is None and ex.kernel == "xla"
    with pytest.warns(TunePlanMiss):
        assert pplan.resolve_plan(jp.to_dict()) is None
    # The port's own save replaces the other backend's entries.
    ours = TunePlan(structure_hash=h, k=128, kernel="pallas_sell", batch=4)
    pplan.save_plans(h, {128: ours}, directory=str(tmp_path))
    with open(pplan.plan_path(h, str(tmp_path))) as fh:
        assert sorted(json.load(fh)["plans"]) == ["128"]


def test_a_plan_replaces_the_knobs_and_explicit_opts_win(ba512):
    levels, width = ba512
    h = structure_hash(levels, width)
    plan = TunePlan(structure_hash=h, k=16, kernel="pallas_sell", batch=4,
                    ctas_per_sm=1, overlap_slabs=2)
    ex = MultiLevelArrow(levels, width, plan=plan,
                         kernel_opts={"batch": 8}, device="cpu")
    assert ex.folded and ex.kernel == "pallas_sell" and ex.tune_plan == plan
    assert ex.kernel_opts["batch"] == 8 and \
        ex.kernel_opts["ctas_per_sm"] == 1 and ex.overlap_slabs == 2
    assert [g.opts.batch for g in ex.launch_groups(torch.float32)] == [8]
    with pytest.raises(ValueError, match="int8"):
        MultiLevelArrow(levels, width, fmt="fold", feature_dtype="int8",
                        kernel="pallas_sell", kernel_opts={
                            "schedule": [{"tier": 1, "carriage": "bf16"}]},
                        device="cpu")


def test_smoke_tune_then_a_zero_child_hit_then_the_gate(tmp_path):
    rep = ptune.smoke_tune(str(tmp_path))
    assert rep["ok"] and rep["children_spawned"] == 3
    assert set(rep["results"]) == {"default", "fold_tight", "pallas_sell"}
    for r in rep["results"].values():
        assert r.get("error") is None and r["ms"] > 0
    assert rep["results"]["default"]["bit_identical"] is True
    assert rep["plan"]["bit_identical"] and rep["plan"]["backend"] == \
        pplan.BACKEND
    again = ptune.smoke_tune(str(tmp_path))
    assert again["cache_hit"] and again["children_spawned"] == 0
    plans = os.path.join(str(tmp_path), "tune_plans")
    assert pgate.run_gate(directory=plans, timing=False, device="cpu",
                          quiet=True) == 0
    # A tampered hash is caught.
    (path,) = [os.path.join(plans, f) for f in os.listdir(plans)
               if f.endswith(".json")]
    with open(path) as fh:
        doc = json.load(fh)
    doc["structure_hash"] = "0" * 16
    with open(path, "w") as fh:
        json.dump(doc, fh)
    res = pgate.check_structure(doc["context"]["source"], directory=plans,
                                timing=False, device="cpu", quiet=True)
    assert not res["ok"] and "hash drift" in res["failures"][0]
    assert pgate.run_gate(directory=plans, timing=False, device="cpu",
                          quiet=True) == 1


def test_graft_tune_cli_and_the_gate_tool(tmp_path, capsys):
    from arrow_matrix_tpu_torch.cli import graft_tune
    from arrow_matrix_tpu_torch.tools import tune_gate

    d = str(tmp_path / "plans")
    argv = ["search", "--ba", "96,16,5", "--max_levels", "4", "--k", "8",
            "--restrict", "default", "--restrict", "pallas_sell_batch4",
            "--plan-dir", d, "--device", "cpu", "--run-dir",
            str(tmp_path / "runs"), "--ledger-dir", str(tmp_path / "l"),
            "--quiet"]
    assert graft_tune.main(argv) == 0
    assert "k=8:" in capsys.readouterr().out
    assert graft_tune.main(["show", "--plan-dir", d]) == 0
    assert "winners" in capsys.readouterr().out
    assert graft_tune.main(["check", "--plan-dir", d, "--no-timing",
                            "--device", "cpu", "--quiet"]) == 0
    assert tune_gate.main(["--plan-dir", d, "--no-timing", "--device",
                           "cpu", "--quiet"]) == 0
    assert graft_tune.main(["show", "nope", "--plan-dir", d]) == 1


def test_the_server_applies_a_plan_and_degrades_to_xla(tmp_path):
    from arrow_matrix_tpu_torch import faults, serve
    from arrow_matrix_tpu_torch.obs import flight

    levels, width = load_levels_from_source(
        {"kind": "ba", "n": 128, "m": 3, "width": 16, "seed": 5,
         "max_levels": 10})
    h = structure_hash(levels, width)
    plan = TunePlan(structure_hash=h, k=8, kernel="pallas_sell", batch=4,
                    candidate="pallas_sell_batch4", bit_identical=True)
    factory, n = serve.ba_executor_factory(128, 16, 5, plan=plan,
                                           device="cpu")
    ex = factory(plan.exec_config())
    assert ex.kernel == "pallas_sell" and ex.kernel_opts["batch"] == 4
    trace = serve.synthetic_trace(n, tenants=1, requests=2, k=8,
                                  iterations=3, seed=1)
    rec = flight.FlightRecorder(None)
    prior = flight.get_recorder()
    flight.set_recorder(rec)
    try:
        srv = serve.ArrowServer(factory, tune_plan=plan, name="tuned")
        tickets = serve.run_trace(srv, trace)
    finally:
        flight.set_recorder(prior)
    (ev,) = [e for e in rec.snapshot()["events"]
             if e["name"] == "tune_plan_applied"]
    assert ev["data"]["candidate"] == "pallas_sell_batch4"
    assert [c.kernel for c in srv.ladder] == ["pallas_sell", "xla"]
    assert all(t.status == "completed" for t in tickets)
    faults.set_plan({"scenario": "error", "site": "multi_level.step",
                     "after": 0, "count": 2})
    try:
        walk = serve.ArrowServer(
            factory, tune_plan=plan, degrade_after=1, name="walk",
            policy=faults.RetryPolicy(max_retries=1, backoff_s=0.0))
        (t,) = serve.run_trace(walk, trace[:1])
    finally:
        faults.clear_plan()
    d = walk.summary()["tenants"]["tenant0"]["degradations"]
    assert [(x["from"]["kernel"], x["to"]["kernel"]) for x in d] == \
        [("pallas_sell", "xla")]
    assert t.result.tobytes() == tickets[0].result.tobytes()


def test_plan_round_trips_and_knob_dicts():
    p = TunePlan(structure_hash="ab", k=16, kernel="pallas_sell",
                 chunk_slots=64, schedule=[{"tier": 1, "batch": 4}])
    assert TunePlan.from_dict(p.to_dict()) == p
    assert p.kernel_opts() == {"chunk_slots": 64, "batch": None,
                               "ctas_per_sm": 2,
                               "schedule": [{"tier": 1, "batch": 4}]}
    assert set(p.build_kwargs()) == set(jplan.TunePlan(
        structure_hash="ab", k=16).build_kwargs())
    assert TunePlan.from_dict({"structure_hash": "ab", "k": 1}).backend \
        is None
    with pytest.raises(ValueError, match="unknown plan"):
        pplan.resolve_plan("tuned")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pplan.resolve_plan(None) is None


def test_a_failing_child_is_one_error_not_the_race(tmp_path):
    from arrow_matrix_tpu_torch.tune.search import race
    from arrow_matrix_tpu_torch.tune.space import Candidate

    cfg = {"source": _source(96), "k": 4, "iters": 1, "device": "cpu"}
    res = race([Candidate("bad", build={"kernel": "mosaic"}),
                Candidate("default")], cfg, timeout_s=120.0,
               log_dir=str(tmp_path))
    assert "unknown kernel" in res["bad"]["error"]
    assert res["default"]["ms"] > 0 and res["default"]["k1_launches"] == 0
    assert sorted(os.listdir(tmp_path)) == ["bad.stderr", "default.stderr"]

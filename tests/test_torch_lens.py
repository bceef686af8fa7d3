"""The port's lens and cost model (``arrow_matrix_tpu_torch.obs.lens``,
``obs/costmodel.py``) against the JAX package's: the static tier
counters, the fit and the predictions equal the reference's (within
1e-12 relative) on the same fingerprints and on the committed
``bench_results/lens/ba_256_3_profile.json`` (read only); the port
fold's realized tier rows equal the JAX fold's; a profile on the CPU
checks clean with the committed profile's static tiers; attribution,
the gap explanation and the ratios equal the reference's on one
document; the ``pallas`` kernel (K1 at its knob points) and its
load-depth sweep carry the JAX document's keys and statics, and the
sweep's waits price the shallow point as the JAX model prices
``ring=1``; the constants are the gate's; the port's lens gate passes
the committed pairs and trips on the planted fixture."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.decomposition import arrow_decomposition as jdecompose
from arrow_matrix_tpu.obs import costmodel as jcm
from arrow_matrix_tpu.obs import lens as jlens
from arrow_matrix_tpu.tune.fingerprint import (
    structure_fingerprint as jfingerprint,
)
from arrow_matrix_tpu_torch.obs import costmodel as pcm
from arrow_matrix_tpu_torch.obs import lens as plens
from arrow_matrix_tpu_torch.tools import lens_gate
from arrow_matrix_tpu_torch.tune import load_levels_from_source
from arrow_matrix_tpu_torch.tune.fingerprint import structure_fingerprint
from arrow_matrix_tpu_torch.utils import barabasi_albert

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENS = os.path.join(REPO, "bench_results", "lens")
BA_256_3 = {"kind": "ba", "n": 256, "m": 3, "width": 32, "seed": 0,
            "max_levels": 10}
BA_64 = {"kind": "ba", "n": 64, "m": 3, "width": 16, "seed": 0,
         "max_levels": 10}


def _load(name):
    with open(os.path.join(LENS, name), encoding="utf-8") as fh:
        return json.load(fh)


def _levels(n=1200, m=3, width=64, seed=5):
    return jdecompose(barabasi_albert(n, m, seed=seed), width,
                      max_levels=10, block_diagonal=True, seed=seed)


def _close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def _same_model(ours, theirs, rel=1e-12):
    assert ours.structure_hash == theirs.structure_hash
    assert ours.platform == theirs.platform
    assert set(ours.coeffs) == set(theirs.coeffs)
    for fam, c in theirs.coeffs.items():
        for r, v in c.items():
            assert _close(ours.coeffs[fam][r], v, rel), (fam, r)
    assert ours.dma_wait_ms == theirs.dma_wait_ms


# ---------------------------------------------------------------------------
# Static counters and the fit
# ---------------------------------------------------------------------------

SCHEDULE = [{"tier": 0, "row_block": 64, "carriage": "bf16"},
            {"tier": 2, "row_block": 128, "ring": 1}]


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("fd", [None, "bf16", "int8"])
@pytest.mark.parametrize("schedule", [None, SCHEDULE])
def test_tier_counters_equal_jax(k, fd, schedule):
    fp = structure_fingerprint(_levels(), 64)
    ours = pcm.tier_counters(fp, k, feature_dtype=fd, schedule=schedule)
    theirs = jcm.tier_counters(fp, k, kernel="xla", feature_dtype=fd,
                               schedule=schedule)
    assert ours == theirs
    assert [c["padded_slots"] for c in ours] == pcm.ladder_padded_slots(fp)
    for c in ours:
        assert c["family"].split(":")[1].split("@")[0] == \
            pcm.tier_family(c["slot_width"])


def test_family_bounds_and_stream_bytes_equal_jax():
    for w in (0, 1, 7, 8, 9, 63, 64, 65, 2048):
        assert pcm.tier_family(w) == jcm.tier_family(w)
        for rows, k in ((0, 4), (217, 64), (1000, 16)):
            for item in (1, 2, 4):
                for g in (1, 8):
                    assert pcm.tier_stream_bytes(w, rows, k, itemsize=item,
                                                 granule=g) == \
                        jcm.tier_stream_bytes(w, rows, k, itemsize=item,
                                              granule=g)
    assert pcm.GRANULE == jcm.GRANULE
    assert pcm.ITEMSIZE == jcm.ITEMSIZE
    assert pcm.schedule_family("xla", 9, 64) == \
        jcm.schedule_family("xla", 9, 64)


def test_fit_and_predictions_equal_jax_on_the_committed_profile():
    profile = _load("ba_256_3_profile.json")
    ours = plens.fit_from_profile(profile)
    theirs = jlens.fit_from_profile(profile)
    _same_model(ours, theirs)
    for fds in (("f32",), ("bf16",)):
        _same_model(plens.fit_from_profile(profile, dtypes=fds),
                    jlens.fit_from_profile(profile, dtypes=fds))
    # The fit on the raw points, and the committed model's own numbers.
    pts = [t for e in profile["dtypes"].values() for t in e["tiers"]
           if t.get("measured_ms") and not t.get("below_resolution")]
    _same_model(pcm.fit_cost_model(pts, structure_hash="h",
                                   platform="cpu"),
                jcm.fit_cost_model(pts, structure_hash="h",
                                   platform="cpu"))
    committed = _load("ba_256_3_model.json")
    _same_model(pcm.CostModel.from_dict(committed),
                jcm.CostModel.from_dict(committed))
    assert pcm.CostModel.from_dict(committed).to_dict() == \
        jcm.CostModel.from_dict(committed).to_dict()
    levels, width = load_levels_from_source(BA_256_3)
    fp = structure_fingerprint(levels, width)
    for model in (ours, pcm.CostModel.from_dict(committed)):
        jmodel = jcm.CostModel.from_dict(model.to_dict())
        for k in (4, 16, 64, 128):
            for fd in (None, "bf16"):
                assert _close(
                    pcm.predict_iter_ms(fp, k, model, feature_dtype=fd),
                    jcm.predict_iter_ms(fp, k, jmodel, kernel="xla",
                                        feature_dtype=fd))
            assert _close(
                pcm.predict_candidate_ms(model, fp, k,
                                         {"feature_dtype": "bf16"}),
                jcm.predict_candidate_ms(jmodel, fp, k,
                                         {"feature_dtype": "bf16"}))
        assert _close(plens.predict_profile_iter_ms(profile, model),
                      jlens.predict_profile_iter_ms(profile, jmodel))


def test_unseen_family_and_version_skew_as_jax():
    model = pcm.fit_cost_model([{"family": "xla:tail", "nnz": 500,
                                 "rows": 100, "streamed_bytes": 4096,
                                 "measured_ms": 0.05}])
    jmodel = jcm.CostModel.from_dict(model.to_dict())
    for fam in ("xla:head", "xla:tail@rb64", "pallas:mid", "other"):
        assert _close(model.predict_point(fam, 500, 100, 4096),
                      jmodel.predict_point(fam, 500, 100, 4096))
    assert pcm.CostModel("h", "cpu").predict_point("xla:tail", 1, 1, 1) \
        == 0.0
    with pytest.raises(ValueError, match="version"):
        pcm.CostModel.from_dict(dict(model.to_dict(), version=2))


def test_pallas_and_ring_sweep_raise_with_the_title(monkeypatch):
    """The lens's 'pallas' kernel and its load-depth sweep no longer
    raise with a ROADMAP title: they profile K1 at its knob points.
    What raises is a knob point K1's contract refuses, before anything
    is built.  The cost model prices K1 with its knobs ("pallas"), each
    tier's family refined by the batch it runs at."""
    fp = structure_fingerprint(_levels(), 64)
    model = pcm.CostModel("h", "cpu", coeffs={
        "xla:tail": {"nnz": 1e-6, "rows": 1e-6, "streamed_bytes": 1e-9}})
    k1 = pcm.tier_counters(fp, 16, kernel="pallas",
                           kernel_opts={"batch": 4})
    xla = pcm.tier_counters(fp, 16)
    assert [c["streamed_bytes"] for c in k1] == \
        [c["streamed_bytes"] for c in xla]
    assert all(c["family"].startswith("pallas:") and "@b4" in c["family"]
               for c in k1)
    assert all(c["family"].endswith("@b8")
               for c in pcm.tier_counters(fp, 16, kernel="pallas"))
    assert all(c["k1_ctas"] >= c["k1_items"]
               >= (c["rows"] > 0 and c["slot_width"] > 0)
               for c in k1)
    assert pcm.predict_iter_ms(fp, 16, model, kernel="pallas") > 0.0
    assert pcm.predict_candidate_ms(
        model, fp, 16, {"kernel": "pallas_sell"}) > 0.0
    levels, width = load_levels_from_source(BA_64)
    doc = plens.profile_fold(levels, width, 8, kernel="pallas",
                             ring_sweep=True, iters=2, device="cpu",
                             clock=SimulatedCard(monkeypatch))
    assert doc["kernel"] == "pallas"
    sweep = dict(doc["sweep"])
    assert sweep.pop("bit_equal_tiers") > 0
    assert sweep == {"knob": "batch", "deep": 8, "shallow": 4}
    for call, words in (
            (lambda: plens.profile_fold(levels, width, 8, kernel="pallas",
                                        kernel_opts={"batch": 3},
                                        device="cpu"), "batch=3"),
            (lambda: plens.profile_fold(levels, width, 8, kernel="pallas",
                                        kernel_opts={"ring": 1},
                                        device="cpu"), "ring"),
            (lambda: plens.profile_fold(levels, width, 8,
                                        kernel="mosaic", device="cpu"),
             "unknown kernel")):
        with pytest.raises(ValueError, match=words):
            call()
    with pytest.raises(ValueError, match="unknown kernel"):
        pcm.tier_counters(fp, 16, kernel="mosaic")
    with pytest.raises(ValueError, match="carriages"):
        plens.profile_fold(_levels(), 64, 8, feature_dtypes=("int8",),
                           device="cpu")


def _keys_of(doc):
    """(document, dtype entry, tier) key sets of a profile."""
    entry = doc["dtypes"]["f32"]
    return (set(doc), set(entry),
            set().union(*(set(t) for t in entry["tiers"])))


def test_pallas_sweep_profile_has_the_jax_keys_and_statics(monkeypatch):
    """A 'pallas' profile with the sweep at BA 64 (width 16) carries
    every key of the JAX package's document (``ring1_ms`` and
    ``dma_wait_ms`` a tier, the family waits), adds only ``sweep`` and
    the launch counts, and its tiers' static counters equal JAX's
    ``_tier_static`` over the same SELL operator; each tier alone gave
    the same bits at batch 4 and 8."""
    from arrow_matrix_tpu.parallel.multi_level import (
        MultiLevelArrow as JMultiLevelArrow,
    )

    levels, width = load_levels_from_source(BA_64)
    ours = plens.profile_fold(levels, width, 8, kernel="pallas",
                              ring_sweep=True, iters=2, device="cpu",
                              clock=SimulatedCard(monkeypatch))
    theirs = jlens.profile_fold(levels, width, 8, kernel="pallas",
                                ring_sweep=True, iters=2)
    for mine, ref, extra in zip(_keys_of(ours), _keys_of(theirs),
                                ({"sweep"}, {"launches"},
                                 {"launches", "sweep_launches"})):
        assert ref <= mine and mine - ref <= extra, (mine, ref)
    jsell = JMultiLevelArrow(levels, width, fmt="fold").blocks[0]
    tiers = ours["dtypes"]["f32"]["tiers"]
    assert len(tiers) == len(jsell.cols)
    static = ("rows", "nnz", "slots", "slot_width", "padded_slots")
    for t, row in enumerate(tiers):
        ref = jlens._tier_static(jsell, t, 8, kernel="pallas",
                                 feature_dtype=None)
        assert {f: row[f] for f in static} == {f: ref[f] for f in static}
        assert row["family"] == ref["family"] + "@b8"
        if row["slot_width"]:
            assert row["dma_wait_ms"] >= 0.0
            assert row["ring1_ms"] > 0.0
            assert row["sweep_launches"] >= 0
    assert ours["sweep"]["bit_equal_tiers"] == sum(
        1 for t in tiers if t["slot_width"])
    assert set(ours["dtypes"]["f32"]["dma_wait_ms"]) == {
        t["family"] for t in tiers if t["slot_width"]}
    # A scheduled profile, or one already at batch 4, skips the sweep.
    for opts in ({"batch": 4}, {"schedule": [{"tier": 0, "batch": 4}]}):
        doc = plens.profile_fold(levels, width, 8, kernel="pallas",
                                 kernel_opts=opts, ring_sweep=True,
                                 iters=2, device="cpu")
        assert "sweep" not in doc
        assert doc["dtypes"]["f32"]["dma_wait_ms"] == {}
        assert doc["dtypes"]["f32"]["tiers"][0]["family"].endswith("@b4")


def test_the_sweep_waits_fit_and_price_the_shallow_point(monkeypatch):
    """On a clock where batch 4 costs a planted share more, the sweep's
    waits come out of the fit per family and ``predict_iter_ms`` at
    ``ring=1`` or ``batch=4`` adds them to the deep prediction."""
    levels, width = load_levels_from_source(BA_64)
    card = SimulatedCard(monkeypatch, shallow_extra=0.25)
    doc = plens.profile_fold(levels, width, 8, kernel="pallas",
                             ring_sweep=True, iters=2, device="cpu",
                             clock=card)
    model = plens.fit_from_profile(doc)
    assert model.dma_wait_ms == doc["dtypes"]["f32"]["dma_wait_ms"]
    assert all(w > 0.0 for w in model.dma_wait_ms.values())
    fp = structure_fingerprint(levels, width)
    deep = pcm.predict_iter_ms(fp, 8, model, kernel="pallas")
    waits = sum(model.dma_wait_ms[t["family"]]
                for t in doc["dtypes"]["f32"]["tiers"] if t["slot_width"])
    for kw in ({"ring": 1}, {"kernel_opts": {"batch": 4}}):
        assert _close(pcm.predict_iter_ms(fp, 8, model, kernel="pallas",
                                          **kw), deep + waits)
    assert _close(pcm.predict_candidate_ms(
        model, fp, 8, {"kernel": "pallas_sell"}, {"batch": 4}),
        deep + waits)
    assert pcm.predict_iter_ms(fp, 8, model, ring=1) == \
        pcm.predict_iter_ms(fp, 8, model)


def test_predict_ring1_adds_the_planted_wait_as_jax():
    """On one model document with planted waits, ``ring=1`` (and a
    scheduled tier at ring 1 or batch 4) adds to the prediction exactly
    what the JAX package's ``predict_iter_ms`` adds."""
    fp = structure_fingerprint(_levels(), 64)
    doc = {"version": 1, "kind": "lens_cost_model", "structure_hash": "h",
           "platform": "cpu",
           "coeffs": {f"pallas:{fam}": {"nnz": 1e-6, "rows": 2e-6,
                                        "streamed_bytes": 0.0}
                      for fam in ("tail", "mid", "head")},
           "dma_wait_ms": {"pallas:tail": 0.125, "pallas:mid": 0.5}}
    ours, theirs = pcm.CostModel.from_dict(doc), jcm.CostModel.from_dict(doc)

    def added(cm, model, **kw):
        return (cm.predict_iter_ms(fp, 16, model, kernel="pallas", **kw)
                - cm.predict_iter_ms(fp, 16, model, kernel="pallas"))

    want = added(jcm, theirs, ring=1)
    assert want > 0.0
    assert _close(added(pcm, ours, ring=1), want)
    assert _close(added(pcm, ours, kernel_opts={"batch": 4}), want)
    assert _close(pcm.predict_iter_ms(fp, 16, ours, kernel="pallas"),
                  jcm.predict_iter_ms(fp, 16, theirs, kernel="pallas"))
    tier = next(t for t, w in enumerate(fp["ladder"]["slot_width"])
                if 0 < w <= 8)
    one = added(jcm, theirs, schedule=[{"tier": tier, "ring": 1}])
    assert one == 0.125
    assert _close(added(pcm, ours, schedule=[{"tier": tier, "ring": 1}]),
                  one)
    assert _close(added(pcm, ours, schedule=[{"tier": tier, "batch": 4}]),
                  one)
    assert added(pcm, ours, kernel_opts={"batch": 8}) == 0.0


def test_meta_wave_count_and_dma_copies_count_by_hand():
    """K1's gathered-load counters over its launch meta, against a count
    made by hand: tier (3 slots x 5 rows) is one chunk, 5 x ceil(3/8)
    batches; tier (200 x 2) is two chunks of 100, 2 x 2 x ceil(100/8);
    a zero-slot tier issues none."""
    from arrow_matrix_tpu_torch.ops.worklist import LaunchOpts, k1_meta

    shapes, starts = [(3, 5), (200, 2), (0, 4)], [0, 5, 7]
    for batch, waves in ((8, 5 + 2 * 2 * 13), (4, 5 + 2 * 2 * 25)):
        meta = k1_meta(shapes, starts, 11, 11, 16, "f32", True, True,
                       LaunchOpts(batch=batch))
        assert pcm.meta_wave_count(meta) == waves
        assert pcm.meta_dma_copies(meta) == 3 * 5 + 200 * 2
    wide = k1_meta(shapes, starts, 11, 11, 256, "f32", True, True)
    assert wide["col_blocks"] == 2
    assert pcm.meta_wave_count(wide) == 2 * (5 + 2 * 2 * 13)


def test_constants_equal_the_gate_and_jax():
    from arrow_matrix_tpu_torch.ledger import gate

    assert gate.LENS_RATIO_MIN == plens.LENS_RATIO_MIN
    assert gate.LENS_RATIO_MAX == plens.LENS_RATIO_MAX
    for name in ("LENS_PROFILE_SCHEMA", "LENS_COVERAGE_TOL",
                 "LENS_RATIO_MIN", "LENS_RATIO_MAX",
                 "LENS_RESOLUTION_FRAC"):
        assert getattr(plens, name) == getattr(jlens, name), name
    assert pcm.COSTMODEL_VERSION == jcm.COSTMODEL_VERSION


# ---------------------------------------------------------------------------
# The profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fd", [None, "bf16"])
@pytest.mark.parametrize("k", [8, 64])
def test_tier_static_rows_equal_the_jax_folds(fd, k):
    from arrow_matrix_tpu.parallel.multi_level import (
        MultiLevelArrow as JMultiLevelArrow,
    )
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    for levels, width in ((_levels(), 64),
                          (_levels(500, 4, 32, 1), 32)):
        ours = MultiLevelArrow(levels, width, fmt="fold", device="cpu")
        theirs = JMultiLevelArrow(levels, width, fmt="fold")
        sell, jsell = ours.sell, theirs.blocks[0]
        assert len(sell.cols) == len(jsell.cols)
        for t in range(len(sell.cols)):
            assert plens._tier_static(sell, t, k, kernel="xla",
                                      feature_dtype=fd) == \
                jlens._tier_static(jsell, t, k, kernel="xla",
                                   feature_dtype=fd)


def test_tier_prefix_is_the_fold_restricted_to_its_rows():
    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    exe = MultiLevelArrow(_levels(), 64, fmt="fold", device="cpu")
    x = exe.set_features(np.random.default_rng(0).standard_normal(
        (exe.n, 4)).astype(np.float32))
    full = sell_spmm_cuda(exe.sell, x)
    for t in exe.sell.live_tiers():
        p = plens.tier_prefix(exe.sell, t)
        assert p.x_rows == exe.total_rows
        out = sell_spmm_cuda(p, x)
        assert out.shape[0] == p.n_rows
        assert torch.equal(out, full[:p.n_rows])


class SimulatedCard:
    """A clock that advances only with K1's products, by the bytes each
    gathers (slots x k x itemsize at 1e12 B/s) plus 2 us a product: the
    lens's bookkeeping on the CPU without the host's timing noise.  A
    product at batch 4 takes ``shallow_extra`` more of that time."""

    def __init__(self, monkeypatch, shallow_extra=0.0):
        from arrow_matrix_tpu_torch.ops import cuda_sell
        from arrow_matrix_tpu_torch.parallel import multi_level

        self.t = 0.0
        real = cuda_sell.sell_spmm_cuda

        def k1(m, x, opts=None):
            dt = m.n_slots * x.shape[1] * x.element_size() * 1e-12 + 2e-6
            if opts is not None and opts.batch == 4:
                dt *= 1.0 + shallow_extra
            self.t += dt
            return real(m, x, opts)

        monkeypatch.setattr(cuda_sell, "sell_spmm_cuda", k1)
        monkeypatch.setattr(multi_level, "sell_spmm_cuda", k1)

    def __call__(self):
        return self.t


def test_profile_on_the_cpu_checks_clean_with_the_committed_statics(
        monkeypatch):
    levels, width = load_levels_from_source(BA_256_3)
    committed = _load("ba_256_3_profile.json")
    static = ("tier", "family", "rows", "nnz", "slots", "slot_width",
              "padded_slots", "streamed_bytes")
    # On the host's wall clock: the document is whole.
    wall = plens.profile_fold(levels, width, 64,
                              feature_dtypes=("f32", "bf16"), iters=5,
                              device="cpu")
    for fd in ("f32", "bf16"):
        entry = wall["dtypes"][fd]
        assert entry["full_ms"] > 0 and entry["coverage"] > 0
        assert entry["launches"] == 0        # the plain version on the CPU
        assert all(t["measured_ms"] >= 0 for t in entry["tiers"]
                   if t["slot_width"] > 0)
    # On a clock that advances with K1's work alone, it checks clean.
    card = SimulatedCard(monkeypatch)
    profile = plens.profile_fold(levels, width, 64,
                                 feature_dtypes=("f32", "bf16"), iters=5,
                                 device="cpu", clock=card)
    model = plens.fit_from_profile(profile)
    assert plens.check_profile(profile, model) == []
    assert profile["structure_hash"] == committed["structure_hash"]
    assert (profile["platform"], profile["device_kind"]) == ("cpu", "cpu")
    assert profile["kernel"] == committed["kernel"] == "xla"
    for fd in ("f32", "bf16"):
        entry = profile["dtypes"][fd]
        assert entry["dma_wait_ms"] == {}
        assert entry["coverage"] == pytest.approx(1.0, abs=1e-3)
        for ours, theirs in zip(entry["tiers"],
                                committed["dtypes"][fd]["tiers"]):
            assert {f: ours[f] for f in static} == \
                {f: theirs[f] for f in static}
        for w in (wall, profile):
            assert [{f: t[f] for f in static}
                    for t in w["dtypes"][fd]["tiers"]] == \
                [{f: t[f] for f in static} for t in entry["tiers"]]
        # Each tier's share is its bytes' share (the first also pays the
        # product's fixed cost).
        live = [t for t in entry["tiers"] if t["slot_width"] > 0]
        for t in live[1:]:
            assert t["measured_ms"] == pytest.approx(
                t["streamed_bytes"] * 1e-9, rel=1e-6)


def test_bookkeeping_equals_jax_on_one_document():
    profile = _load("ba_256_3_profile.json")
    model = plens.fit_from_profile(profile)
    jmodel = jlens.fit_from_profile(profile)
    for fd in ("f32", "bf16"):
        assert plens.attribution_fractions(profile, fd) == \
            jlens.attribution_fractions(profile, fd)
    ours, theirs = plens.ratio_points(profile, model), \
        jlens.ratio_points(profile, jmodel)
    assert [(p["dtype"], p["tier"], p["family"]) for p in ours] == \
        [(p["dtype"], p["tier"], p["family"]) for p in theirs]
    for a, b in zip(ours, theirs):
        assert _close(a["ratio"], b["ratio"], 1e-9)
    for m, jm in ((None, None), (model, jmodel)):
        a = plens.explain_gap(profile, model=m)
        b = jlens.explain_gap(profile, model=jm)
        assert (a["dominant"], a["dominant_segment"], a["note"]) == \
            (b["dominant"], b["dominant_segment"], b["note"])
        assert a["per_level"] == b["per_level"]
    assert plens.check_profile(profile, model) == \
        jlens.check_profile(profile, jmodel) == []
    bad = copy.deepcopy(profile)
    bad["dtypes"]["f32"]["coverage"] = 0.5
    bad["dtypes"]["f32"]["tiers"][0]["measured_ms"] *= 5.0
    assert plens.check_profile(bad, model) == \
        jlens.check_profile(bad, jmodel)
    assert plens.check_profile(dict(profile, schema=2)) == \
        jlens.check_profile(dict(profile, schema=2))


def test_record_profile_stamps_the_profile_and_pins_ratio_load(tmp_path):
    from arrow_matrix_tpu_torch.ledger import Ledger

    profile = dict(_load("ba_256_3_profile.json"), platform="gpu",
                   device_kind="NVIDIA H100 80GB HBM3")
    model = plens.fit_from_profile(profile)
    d = str(tmp_path / "ledger")
    ids = plens.record_profile(profile, model, directory=d)
    led = Ledger(d)
    assert led.validate() == []
    recs = led.read_all()
    assert ids == [r["record_id"] for r in recs]
    assert {r["kind"] for r in recs} == {"lens"}
    for r in recs:
        assert (r["platform"], r["device_kind"]) == (
            "gpu", "NVIDIA H100 80GB HBM3")
        assert r["structure_hash"] == profile["structure_hash"]
        if r["unit"] == "ratio":
            assert r["host_load"] is None
    # The same metrics as the reference's emitter.
    jd = str(tmp_path / "jax")
    jlens.record_profile(profile, jlens.fit_from_profile(profile),
                         directory=jd)
    from arrow_matrix_tpu.ledger import Ledger as JLedger

    assert [r["metric"] for r in recs] == \
        [r["metric"] for r in JLedger(jd).read_all()]


# ---------------------------------------------------------------------------
# The gate tool and the xray consumer
# ---------------------------------------------------------------------------

def test_lens_gate_selftest_committed_pairs_and_fixture():
    assert lens_gate.selftest() == 0
    assert lens_gate.main([]) == 0
    path = os.path.join(REPO, "tests", "fixtures", "lens",
                        "miscalibrated.json")
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    problems = lens_gate.check_pair(doc["profile"], doc["model"])
    assert any("ratio" in p for p in problems)
    assert any("cover" in p for p in problems)
    assert lens_gate.main(["--fixture", path]) == 1
    assert lens_gate.main(["--fixtures"]) == 0
    profile = _load("ba_256_3_profile.json")
    model = _load("ba_256_3_model.json")
    assert any("structure hash mismatch" in p for p in lens_gate.check_pair(
        dict(profile, structure_hash="other"), model))


def test_lens_gate_refresh_writes_only_its_own_directory(tmp_path,
                                                         monkeypatch):
    committed = {n: open(os.path.join(LENS, n), "rb").read()
                 for n in os.listdir(LENS)}
    import functools

    monkeypatch.setattr(lens_gate, "REFRESH_K", 16)
    monkeypatch.setattr(plens, "profile_fold", functools.partial(
        plens.profile_fold, clock=SimulatedCard(monkeypatch)))
    out = tmp_path / "lens_torch"
    rc = lens_gate.refresh(ledger_dir=str(tmp_path / "ledger"),
                           device="cpu", out_dir=str(out))
    assert rc == 0
    assert sorted(os.listdir(out)) == ["ba_256_3_model.json",
                                       "ba_256_3_profile.json"]
    assert lens_gate.main(["--profile", str(out / "ba_256_3_profile.json"),
                           "--model", str(out / "ba_256_3_model.json")]) == 0
    assert {n: open(os.path.join(LENS, n), "rb").read()
            for n in os.listdir(LENS)} == committed
    assert lens_gate.TORCH_LENS_DIR.endswith(
        os.path.join("bench_results", "lens_torch"))


def test_xray_compute_split_by_the_lens_equals_jax():
    from arrow_matrix_tpu.obs.xray import subdivide_compute as jsub
    from arrow_matrix_tpu_torch.obs.xray import subdivide_compute

    profile = _load("ba_256_3_profile.json")
    cp = {"per_class": {"exact": {"segments_mean_ms":
                                  {"compute": 10.0, "wire": 1.0}},
                        "approx": {"segments_mean_ms": {"compute": 4.0}}}}
    fr = {"exact": plens.attribution_fractions(profile, "f32"),
          "approx": plens.attribution_fractions(profile, "bf16")}
    jfr = {"exact": jlens.attribution_fractions(profile, "f32"),
           "approx": jlens.attribution_fractions(profile, "bf16")}
    assert subdivide_compute(cp, fr) == jsub(cp, jfr)


def test_fingerprint_of_the_committed_profile_is_the_jax_one():
    levels, width = load_levels_from_source(BA_256_3)
    from arrow_matrix_tpu.tune.search import (
        load_levels_from_source as jload,
    )

    jl, jw = jload(BA_256_3)
    assert structure_fingerprint(levels, width) == jfingerprint(jl, jw)

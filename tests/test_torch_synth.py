"""Schedule synthesis (``arrow_matrix_tpu_torch/tune/synth.py``) against
the JAX package's: the same (tier, m_t, rows, family, carriage) from
``synthesize_schedule`` under both policies, the same generated
candidates and eligibility; the families' K1 knobs keep the sum order,
so the exact schedule equals the default fold bit for bit; the program
store persists, registers and certifies a program."""

import json

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.tune import synth as jsynth
from arrow_matrix_tpu_torch.analysis import kernels as kcert
from arrow_matrix_tpu_torch.ops import kernel_contract
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.tune import load_levels_from_source
from arrow_matrix_tpu_torch.tune import synth as psynth
from arrow_matrix_tpu_torch.tune.fingerprint import (
    fingerprint_hash,
    structure_fingerprint,
)

torch.set_num_threads(2)

KEYS = ("tier", "m_t", "rows", "family", "carriage")
#: (n, width, seed) of the seeded BA structures.
BA = ((96, 16, 3), (512, 32, 3), (1200, 64, 5), (2000, 32, 9))


def _fp(n, width, seed, **kw):
    levels, width = load_levels_from_source(
        {"kind": "ba", "n": n, "m": 3, "width": width, "seed": seed,
         "max_levels": 10})
    return levels, width, structure_fingerprint(levels, width, **kw)


@pytest.mark.parametrize("n,width,seed", BA)
@pytest.mark.parametrize("policy", ["exact", "mixed"])
def test_schedules_equal_jax(n, width, seed, policy):
    _, _, fp = _fp(n, width, seed)
    ours = psynth.synthesize_schedule(fp, carriage_policy=policy)
    theirs = jsynth.synthesize_schedule(fp, carriage_policy=policy)
    assert [tuple(e[k] for k in KEYS) for e in ours] == \
        [tuple(e[k] for k in KEYS) for e in theirs]
    for e in ours:
        assert {k: e[k] for k in psynth.FAMILY_POLICY[e["family"]]} == \
            psynth.FAMILY_POLICY[e["family"]]
    with pytest.raises(ValueError, match="policy"):
        psynth.synthesize_schedule(fp, carriage_policy="fast")


@pytest.mark.parametrize("traffic", ["exact", "approx"])
def test_generated_candidates_equal_jax(traffic):
    _, _, fp = _fp(1200, 64, 5)
    ours = psynth.synth_candidates(fp, traffic_class=traffic)
    theirs = jsynth.synth_candidates(fp, traffic_class=traffic)
    assert [(c.name, c.build, c.eligible) for c in ours] == \
        [(c.name, c.build, c.eligible) for c in theirs]


def test_families_and_bands_equal_jax():
    for w in (1, 7, 8, 9, 63, 64, 65, 4000):
        assert psynth.ladder_family(w) == jsynth.ladder_family(w)
    assert (psynth.TAIL_WIDTH, psynth.MID_WIDTH) == \
        (jsynth.TAIL_WIDTH, jsynth.MID_WIDTH)
    assert set(psynth.FAMILY_POLICY) == set(jsynth.FAMILY_POLICY)
    # Every family keeps the default chunk: the sum order.
    assert {p["chunk_slots"] for p in psynth.FAMILY_POLICY.values()} == {128}


@pytest.mark.parametrize("n,width,seed", BA[:3])
def test_the_exact_schedule_equals_the_default_fold_bit_for_bit(n, width,
                                                                seed):
    levels, width, fp = _fp(n, width, seed)
    sched = psynth.synthesize_schedule(fp)
    ex = MultiLevelArrow(levels, width, fmt="fold", kernel="pallas_sell",
                         kernel_opts={"schedule": sched}, device="cpu")
    live = [g for g in ex.launch_groups(torch.float32)
            if any(min(ex.sell.cols[t].shape) > 0 for t in g.tiers)]
    assert len(live) == len({psynth.ladder_family(e["m_t"]) for e in sched})
    # K1 at its default knobs: on the CPU both run the work list's twin
    # (the "xla" fold's plain version sums a row in one reduction).
    base = MultiLevelArrow(levels, width, fmt="fold", kernel="pallas_sell",
                           device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (n, 16)).astype(np.float32)
    y = ex.gather_result(ex.run(ex.set_features(x), 2))
    assert np.array_equal(y, base.gather_result(
        base.run(base.set_features(x), 2)))
    mixed = MultiLevelArrow(levels, width, fmt="fold", kernel="pallas_sell",
                            kernel_opts={"schedule": psynth.synthesize_schedule(
                                fp, carriage_policy="mixed")},
                            device="cpu")
    z = mixed.gather_result(mixed.step(mixed.set_features(x)))
    w = base.gather_result(base.step(base.set_features(x)))
    assert np.linalg.norm(z - w) <= 2e-2 * np.linalg.norm(w)


def test_the_store_persists_registers_and_certifies(tmp_path, monkeypatch):
    store = tmp_path / "synth_programs.json"
    monkeypatch.setenv("AMT_SYNTH_STORE", str(store))
    _, _, fp = _fp(512, 32, 3)
    h = fingerprint_hash(fp)
    sched = psynth.synthesize_schedule(fp)
    name = psynth.persist_program(fp, h, 16, sched)
    try:
        assert name == psynth.program_name(h) == f"k1_synth_{h[:8]}"
        doc = json.loads(store.read_text())
        assert doc["version"] == psynth.STORE_VERSION
        prog = doc["programs"][name]
        assert prog["schedule"] == sched and prog["k"] == 16
        assert psynth.register_persisted_programs(str(store)) == [name]
        entry = next(e for e in kernel_contract.registered_kernels()
                     if e.name == name)
        rec = kcert.certify_entry(entry)
        assert rec["ok"], rec["findings"][:3]
        assert entry.contract.knob_values("batch") == tuple(sorted(
            {e["batch"] for e in sched}))
    finally:
        kernel_contract.unregister_kernel(name)
    store.write_text(json.dumps({"version": 9, "programs": {}}))
    with pytest.raises(ValueError, match="version skew"):
        psynth.load_store(str(store))
    assert psynth.load_store(str(tmp_path / "none.json"))["programs"] == {}


def test_the_committed_store_is_empty_and_readable():
    doc = psynth.load_store(psynth.DEFAULT_STORE_PATH)
    assert doc == {"version": 1, "programs": {}}

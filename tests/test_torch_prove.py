"""The port's collective prover (``arrow_matrix_tpu_torch/analysis/
prove.py``) against the JAX package's (``arrow_matrix_tpu/analysis/
prove.py``).

* The port proves every entry of the JAX manifest on 4 gloo ranks at
  the same scale: the same 20 entries and the same 4 skips with their
  reasons, each contract equal to the one ``bench_cache/hlo_manifest.
  json`` records field by field (the collective kinds and the notes
  excepted: the port names the kinds it issues), each rule verdict
  equal, and the counted payload bytes equal to JAX's ``auto_bytes``
  where the two programs issue the same collectives (``BYTES_DIFFER``
  lists the others, each with its reason, held to its band; a
  ``SellMultiLevel`` level whose body has no slot broadcasts no X_0, as
  XLA drops the psum nothing reads).
* JAX's ``prove_entry`` also runs live for two entries.
* Every rule H1-H7 (and H4') fails on a planted violation.
* The reshard gate's ``reshard_h7`` passes, and the fresh manifest does
  not drift from the checked-in one.
"""

import json
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.analysis import prove as jprove
from arrow_matrix_tpu_torch.analysis import prove
from arrow_matrix_tpu_torch.analysis.contracts import CollectiveContract
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.utils import commstats

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MANIFEST = os.path.join(REPO, "bench_cache", "hlo_manifest.json")

#: Entries whose counted payload differs from JAX's ``auto_bytes``, with
#: the port's value and why (PERF.md §6 lists them too).
BYTES_DIFFER = {
    "spmm_15d[c=1,S=1]": (
        4096, "the port counts every round's broadcast (4 x 1024 B); the "
              "HLO counts each psum of the round loop's body once"),
    "multi_level_a2a[c=1,S=1]": (
        12032, "JAX's lowered HLO holds only the explicit a2a (5888 B, "
               "equal to the port's); its broadcasts, head reductions and "
               "halos are GSPMD's and appear compiled only (23296 B)"),
    "multi_level_a2a[c=1,S=2]": (
        12032, "as multi_level_a2a[c=1,S=1]"),
}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4, backend="gloo", device="cpu", threads=1)
    yield p
    p.close()


@pytest.fixture(scope="module")
def manifest(pool):
    return prove.run_prove(device="cpu", write=False, pool=pool)


@pytest.fixture(scope="module")
def jax_manifest():
    with open(JAX_MANIFEST, encoding="utf-8") as fh:
        return json.load(fh)


def _by_name(m):
    return {e["entry"]: e for e in m["entries"]}


def test_same_entries_and_skips_as_jax(manifest, jax_manifest):
    assert manifest["ok"], [e["entry"] for e in manifest["entries"]
                            if not e["ok"]]
    assert [e["entry"] for e in manifest["entries"]] == \
        [e["entry"] for e in jax_manifest["entries"]]
    assert len(manifest["entries"]) == 20
    assert manifest["skipped"] == jax_manifest["skipped"]
    assert manifest["scale"] == jax_manifest["scale"]


def test_no_drift_against_the_checked_in_manifest(manifest):
    with open(prove.DEFAULT_MANIFEST, encoding="utf-8") as fh:
        checked_in = json.load(fh)
    assert prove.manifest_drift(checked_in, manifest) == []


ENTRIES = [e["entry"] for e in json.load(open(JAX_MANIFEST))["entries"]]


@pytest.mark.parametrize("name", ENTRIES)
def test_contract_equals_jax_field_by_field(manifest, jax_manifest, name):
    ours = dict(_by_name(manifest)[name]["contract"])
    theirs = dict(_by_name(jax_manifest)[name]["contract"])
    for key in ("lowered_kinds", "compiled_kinds", "notes"):
        ours.pop(key)
        theirs.pop(key)
    assert ours == theirs


@pytest.mark.parametrize("name", ENTRIES)
def test_rule_verdicts_equal_jax(manifest, jax_manifest, name):
    ours = {r: v["status"] for r, v in _by_name(manifest)[name]
            ["rules"].items()}
    theirs = {r: v["status"] for r, v in _by_name(jax_manifest)[name]
              ["rules"].items()}
    assert ours == theirs


@pytest.mark.parametrize("name", ENTRIES)
def test_counted_bytes_against_jax_auto_bytes(manifest, jax_manifest, name):
    e = _by_name(manifest)[name]
    ours = e["measured"]["auto_bytes"]
    theirs = _by_name(jax_manifest)[name]["measured"]["auto_bytes"]
    # Every rank counts the same payload (the executors are SPMD).
    assert len(set(e["measured"]["per_rank_auto_bytes"])) == 1
    if name in BYTES_DIFFER:
        assert ours == BYTES_DIFFER[name][0] != theirs
        assert e["rules"]["H2"]["status"] == "pass"
        lo, hi = e["contract"]["ratio_band"]
        assert lo <= ours / e["contract"]["step_bytes"] <= hi
    else:
        assert ours == theirs
    assert e["measured"]["merge_bytes"] == \
        _by_name(jax_manifest)[name]["measured"]["merge_bytes"]


@pytest.mark.parametrize("name", ["sell_multi[c=2,S=2]",
                                  "reshard[shuffle,d4]"])
def test_jax_prove_entry_live(manifest, name):
    s = prove.PROVE_SCALE
    for jname, contract, programs in jprove._entries(
            s["n"], s["width"], s["k"], s["n_dev"]):
        if jname == name:
            live = jprove.prove_entry(jname, contract, programs, s["k"])
            break
    ours = _by_name(manifest)[name]
    assert live["ok"] and ours["ok"]
    assert {r: v["status"] for r, v in live["rules"].items()} == \
        {r: v["status"] for r, v in ours["rules"].items()}
    want = BYTES_DIFFER.get(name, (live["measured"]["auto_bytes"],))[0]
    assert ours["measured"]["auto_bytes"] == want
    assert ours["measured"]["merge_bytes"] == live["measured"]["merge_bytes"]
    if name.startswith("reshard"):
        assert ours["measured"]["stage_scratch_bytes"] == \
            live["measured"]["stage_scratch_bytes"]


def test_every_step_collective_is_counted_and_declared(manifest):
    for e in manifest["entries"]:
        assert e["measured"]["hidden"] == [], e["entry"]
        declared = set(e["contract"]["lowered_kinds"])
        assert set(e["measured"]["kinds"]) <= declared, e["entry"]


# -- planted violations -------------------------------------------------------

def _contract(**kw):
    base = dict(algorithm="planted", step_bytes=1024, reduce_bytes=0,
                repl=1, overlap_slabs=1, dtype="f32",
                lowered_kinds=("all-to-all",),
                compiled_kinds=("all-to-all",), ratio_band=(0.5, 2.0))
    base.update(kw)
    return CollectiveContract(**base)


def test_h1_fails_on_an_undeclared_kind_and_a_hidden_collective():
    obs = prove.fixture_observation([("all-gather", (32, 8), "f32")])
    assert prove.check_h1(obs, _contract())["status"] == "fail"
    assert prove.live_hidden_collective()["status"] == "fail"
    good = prove.fixture_observation([("all-to-all", (32, 8), "f32")])
    assert prove.check_h1(good, _contract())["status"] == "pass"


def test_h2_fails_outside_the_band():
    obs = prove.fixture_observation([("all-to-all", (128, 8), "f32")])
    assert prove.check_h2(obs["payload_bytes"], "counted",
                          _contract())["status"] == "fail"
    assert prove.check_h2(1, "counted", _contract(step_bytes=0))[
        "status"] == "fail"
    assert prove.check_h2(1024, "counted", _contract())["status"] == "pass"


def test_h3_fails_on_a_wrong_slab_and_a_wrong_merge():
    c = _contract(repl=2, reduce_bytes=2048)
    wide = prove.fixture_observation([("all-to-all", (32, 8), "f32")])
    assert prove.check_h3(wide, c, 8)["status"] == "fail"
    slab = prove.fixture_observation([("all-to-all", (32, 4), "f32")])
    assert prove.check_h3(slab, c, 8, merge_bytes=1024)["status"] == "fail"
    assert prove.check_h3(slab, c, 8, merge_bytes=2048)["status"] == "pass"


def test_h4_fails_on_f64_and_on_a_float_widening():
    x = torch.ones(4, 4)
    _, obs = prove.observe(lambda: x.double().sum())
    assert prove.check_h4(obs, _contract())["status"] == "fail"
    b = torch.ones(4, 4, dtype=torch.bfloat16)
    _, obs = prove.observe(lambda: b.float() * 2)
    assert prove.check_h4(obs, _contract())["status"] == "fail"
    _, obs = prove.observe(lambda: x * 2)
    assert prove.check_h4(obs, _contract())["status"] == "pass"


def test_h4_prime_fails_on_full_precision_operands_of_an_approx_class():
    c = _contract(dtype="bf16")
    f32 = prove.fixture_observation([("all-to-all", (32, 8), "f32")])
    assert prove.check_h4(f32, c)["status"] == "fail"
    bf16 = prove.fixture_observation([("all-to-all", (32, 8), "bf16")])
    bf16["converts"] = [("bf16", "f32")]   # the declared accumulation
    assert prove.check_h4(bf16, c)["status"] == "pass"


class _Carried:
    """A toy executor: ``run`` as the executors write it, or keeping
    every step's input (the planted H5 violation)."""

    def __init__(self, keep):
        self.keep = keep
        self.history = []

    def step(self, x):
        return x * 2

    def run(self, x, iterations):
        for _ in range(iterations):
            if self.keep:
                self.history.append(x)
            x = self.step(x)
        return x


def test_h5_fails_on_a_run_that_keeps_every_input():
    c = _contract(donated_params=(0,))
    bad = prove.run_lifetimes(_Carried(True), lambda: torch.ones(8), "step")
    assert prove.check_h5(bad, c)["status"] == "fail"
    good = prove.run_lifetimes(_Carried(False), lambda: torch.ones(8),
                               "step")
    assert prove.check_h5(good, c)["status"] == "pass"
    assert prove.check_h5(None, c)["status"] == "fail"
    assert prove.check_h5(None, _contract())["status"] == "skip"


def test_h6_fails_on_a_transposed_copy_and_over_budget():
    x = torch.ones(16, 8)
    _, obs = prove.observe(lambda: x.t().contiguous())
    assert prove.check_h6(obs, _contract())["status"] == "fail"
    _, obs = prove.observe(lambda: [x.clone() for _ in range(9)])
    assert obs["copies"] == 9
    assert prove.check_h6(obs, _contract())["status"] == "fail"
    assert prove.check_h6(obs, _contract(hot_copy_budget=9))[
        "status"] == "pass"


def test_h6_does_not_count_a_kernel_twin_s_own_copies():
    from arrow_matrix_tpu_torch.ops.kernel_span import kernel_call

    x = torch.ones(16, 8)
    twin = kernel_call(lambda: x.t().contiguous())
    _, obs = prove.observe(twin)
    assert obs["copies"] == 0 and obs["transposed_copies"] == 0


def test_h7_fails_on_an_over_budget_stage():
    c = _contract(scratch_budget_bytes=256)
    assert prove.check_h7([128, 200], c)["status"] == "fail"
    assert prove.check_h7([128, 64], c)["status"] == "pass"
    assert prove.check_h7(None, c)["status"] == "fail"


def test_selftest_trips_on_the_planted_surprise():
    assert prove.selftest()
    broken = prove.verify_fixture(prove._SELFTEST_BROKEN)
    assert all(broken[r]["status"] == "fail" for r in ("H1", "H2", "H3"))


def test_commstats_logs_each_operand():
    commstats.start_log()
    t = torch.zeros(4, 3, dtype=torch.bfloat16)
    commstats.record("all-to-all", 18, 4, t)
    commstats.record("broadcast", 24, 2, t, payload=10)
    log = commstats.stop_log()
    assert [(r["kind"], r["shape"], r["dtype"], r["payload"]) for r in log] \
        == [("all-to-all", (4, 3), "bfloat16", 24),
            ("broadcast", (4, 3), "bfloat16", 10)]
    assert commstats.stop_log() == []
    assert not commstats.in_layer()
    with commstats.issuing():
        assert commstats.in_layer()


def test_reshard_gate_h7_half():
    from arrow_matrix_tpu_torch.tools import reshard_gate

    assert reshard_gate.scenario_reshard_h7(device="cpu") == []


def test_fold_contract_is_the_jax_executors():
    from arrow_matrix_tpu.parallel.multi_level import (
        MultiLevelArrow as JMulti,
    )
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.parallel.multi_level import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils.graphs import barabasi_albert

    levels = arrow_decomposition(barabasi_albert(96, 3, seed=2), 16,
                                 max_levels=3, block_diagonal=True, seed=1)
    for kw in ({}, {"repl": 2}, {"feature_dtype": "bf16"}):
        ours = MultiLevelArrow(levels, 16, fmt="fold", device="cpu", **kw)
        theirs = JMulti(levels, 16, fmt="fold", **kw)
        assert ours.collective_contract(8).to_json() == \
            theirs.collective_contract(8).to_json()
    np.testing.assert_equal(ours.ideal_comm_bytes(8), 0)


@pytest.mark.parametrize("hosts,devices,measured,pattern,band", [
    (2, 8, "ideal", "ring", None),            # tests/test_host.py:95-99
    (2, 8, "3x", "ring", None),
    (1, 8, 0, "ring", None),
    (1, 8, 100, "ring", None),
    (4, 8, "ideal", "alltoall", None),
    (4, 8, "3x", "alltoall", (0.1, 4.0)),
    (8, 8, 0, "alltoall", None)])             # a slice of zero measured
def test_check_host_bytes_follows_jax(hosts, devices, measured, pattern,
                                      band):
    """graft-host's H2 across hosts (``check_host_bytes``, kept out of
    ``RULE_IDS``): the JAX function's verdict and words on the same
    contract and bytes."""
    ours, theirs = prove.fixture_contract(), jprove.fixture_contract()
    ideal = ours.inter_host_bytes(hosts, devices, pattern=pattern)
    assert ideal == theirs.inter_host_bytes(hosts, devices, pattern=pattern)
    m = {"ideal": ideal, "3x": 3 * ideal}.get(measured, measured)
    got = prove.check_host_bytes(ours, hosts, devices, m, pattern, band)
    assert got == jprove.check_host_bytes(theirs, hosts, devices, m,
                                          pattern, band)
    want = {(2, "ideal"): "pass", (2, "3x"): "fail", (1, 0): "pass",
            (1, 100): "fail", (4, "ideal"): "pass", (4, "3x"): "pass",
            (8, 0): "fail" if ideal else "pass"}[(hosts, measured)]
    assert got["status"] == want, got
    assert prove.RULE_IDS == jprove.RULE_IDS

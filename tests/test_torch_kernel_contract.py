"""The Hopper kernel contract (``ops/kernel_contract.py``) and its
certifier (``analysis/kernels.py``): K1-K4 certify clean under KC1-KC5
and equal the committed manifest; a planted broken meta fires each rule
(and hypothesis over random tier shapes keeps KC1 and KC5 honest); the
contract's knobs mirror ``ops/worklist.py`` and the ``.cu``; tune
candidates are certified before any child; the registry keeps the JAX
module's names and meanings."""

import copy
import json
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from arrow_matrix_tpu.ops import kernel_contract as jkc
from arrow_matrix_tpu_torch.analysis import kernels as kcert
from arrow_matrix_tpu_torch.ops import (
    cuda_blocks,
    cuda_gather,
    cuda_sell,
    kernel_contract,
    worklist,
)

torch.set_num_threads(2)

SRC = open(os.path.join(os.path.dirname(cuda_sell.__file__), os.pardir,
                        "csrc", "sell_tier_spmm.cu")).read()


@pytest.fixture(scope="module")
def builtins():
    return kernel_contract.builtin_kernels()


def test_the_registry_keeps_the_jax_names():
    for name in ("KernelContract", "KernelEntry", "register_kernel",
                 "unregister_kernel", "registered_kernels",
                 "builtin_kernels", "CARRIAGE_ITEMSIZE",
                 "WIDE_ACCUM_DTYPES"):
        assert hasattr(kernel_contract, name), name
        assert hasattr(jkc, name), name
    assert kernel_contract.CARRIAGE_ITEMSIZE == jkc.CARRIAGE_ITEMSIZE
    assert kernel_contract.WIDE_ACCUM_DTYPES == jkc.WIDE_ACCUM_DTYPES


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_k1_to_k4_certify_clean(builtins, idx):
    rec = kcert.certify_entry(builtins[idx])
    assert rec["ok"], rec["findings"][:5]
    assert [rec["rules"][r]["status"] for r in kcert.RULE_IDS] == \
        ["pass"] * 5
    assert rec["points"] > 0 and rec["witness"]


def test_the_committed_manifest_has_no_drift():
    with open(kcert.DEFAULT_MANIFEST) as fh:
        committed = json.load(fh)
    fresh = kcert.run_kernels(write=False,
                              entries=kernel_contract.builtin_kernels())
    assert kcert.manifest_drift(committed, fresh) == []
    assert fresh["ok"] and fresh["counts"]["rules_pass"] == 15


def test_selftest_passes():
    ok, lines = kcert.selftest()
    assert ok, lines


@pytest.mark.parametrize("rule", kcert.RULE_IDS)
def test_a_planted_meta_fires_its_rule(rule):
    fired = {f.rule for f in kcert.check_meta(kcert.planted_metas()[rule])}
    assert rule in fired


@pytest.mark.parametrize("rule", ["KC1", "KC4"])
def test_a_planted_source_fires_its_rule(rule):
    contract = cuda_sell.kcert_entry().contract
    metas = [kcert._good_k1_meta()]
    assert kcert.analyze_kernel_source(SRC, contract, metas) == []
    fired = {f.rule for f in kcert.analyze_kernel_source(
        kcert.planted_sources()[rule], contract, metas)}
    assert rule in fired


@pytest.mark.parametrize("rule", kcert.RULE_IDS)
def test_a_planted_fixture_file_fires_its_rule(rule, tmp_path):
    path = tmp_path / f"{rule.lower()}_planted.json"
    path.write_text(json.dumps({"metas": [kcert.planted_metas()[rule]]}))
    ok, detail = kcert.verify_fixture(str(path))
    assert ok, detail
    clean = tmp_path / f"{rule.lower()}_clean.json"
    clean.write_text(json.dumps({"metas": [kcert._good_k1_meta()],
                                 "source": SRC}))
    assert not kcert.verify_fixture(str(clean))[0]
    assert kcert.main(["--fixture", str(path)]) == 0


def test_the_cli_checks_and_self_tests(capsys):
    assert kcert.main(["--selftest"]) == 0
    assert kcert.main(["--check"]) == 0
    assert "kernel certification passed" in capsys.readouterr().out
    from arrow_matrix_tpu_torch.analysis.__main__ import main as amain

    assert amain(["lint"]) == 0


@st.composite
def tier_ladders(draw):
    n = draw(st.integers(1, 6))
    shapes = [(draw(st.sampled_from([0, 1, 3, 8, 40, 129, 300, 1100])),
               draw(st.integers(0, 60))) for _ in range(n)]
    return shapes


def _starts(shapes):
    out, r = [], 0
    for _, n_t in shapes:
        out.append(r)
        r += n_t
    return out, r


@settings(max_examples=40, deadline=None)
@given(shapes=tier_ladders(), k=st.sampled_from([1, 4, 16, 20, 128, 200]),
       carriage=st.sampled_from(["f32", "bf16", "int8"]),
       cs=st.sampled_from(worklist.CHUNK_SLOTS_CHOICES),
       batch=st.sampled_from(worklist.BATCH_CHOICES),
       ctas=st.sampled_from(worklist.CTAS_PER_SM_CHOICES))
def test_random_ladders_certify_and_a_broken_item_fires(shapes, k, carriage,
                                                        cs, batch, ctas):
    starts, rows = _starts(shapes)
    item = kernel_contract.CARRIAGE_ITEMSIZE[carriage]
    opts = worklist.LaunchOpts(chunk_slots=cs, batch=batch,
                               ctas_per_sm=ctas)
    meta = worklist.k1_meta(shapes, starts, rows, rows, k, carriage, True,
                            k * item % 16 == 0, opts)
    assert kcert.check_meta(meta) == []
    if not meta["items"]:
        return
    gone = copy.deepcopy(meta)
    gone["items"].pop(0)                  # a row's item dropped
    fired = {f.rule for f in kcert.check_meta(gone)}
    assert fired & {"KC5", "KC3"}
    moved = copy.deepcopy(meta)
    moved["items"][0][1] += 10_000        # an item off its tier
    assert "KC1" in {f.rule for f in kcert.check_meta(moved)}


def test_the_order_depends_on_s_alone_across_k_and_knobs():
    metas = cuda_sell.kcert_metas()
    assert kcert.order_invariance(metas, "K1") == []
    s = {}
    for m in metas:
        key = json.dumps(m["chunk_slots"])
        s.setdefault(key, [r[4] for r in m["tiers"]])
        assert [r[4] for r in m["tiers"]] == s[key]
    assert s[json.dumps(64)] != s[json.dumps(128)]
    bad = copy.deepcopy(metas[:2])
    bad[1]["tiers"][6][4] += 1
    assert kcert.order_invariance(bad, "K1")


def test_the_contract_mirrors_the_worklist_and_the_source():
    c = cuda_sell.kcert_entry().contract
    assert c.knob_values("batch") == worklist.BATCH_CHOICES
    assert c.knob_values("chunk_slots") == worklist.CHUNK_SLOTS_CHOICES
    assert c.knob_values("ctas_per_sm") == worklist.CTAS_PER_SM_CHOICES
    assert set(worklist.KNOBS) == {name for name, _ in c.knobs}
    assert c.threads == worklist.THREADS and c.accum_dtype == "f32"
    assert c.supports_k(1) and c.supports_k(20) and not c.supports_k(0)
    assert c.vector_loads(4, 4) and not c.vector_loads(20, 2)
    assert c.vector_loads(16, 1)
    assert "__launch_bounds__(kThreads, MINB)" in SRC
    assert "ctas_per_sm != 1 && ctas_per_sm != 2" in SRC
    assert "if (batch != 4 && batch != 8) return -4;" in SRC
    for b in worklist.BATCH_CHOICES:
        assert f"case {b}:" in SRC
    assert "case 16:" not in SRC
    dense = cuda_blocks.kcert_entry().contract
    assert dense.dynamic_smem_bytes <= kernel_contract.SM90_SMEM_PER_CTA
    assert cuda_gather.kcert_entry().contract.threads == 256


@pytest.mark.parametrize("opts,ok", [
    ({}, True), ({"batch": 4, "ctas_per_sm": 1}, True),
    ({"chunk_slots": 64, "batch": 8}, True),
    ({"batch": 16}, False), ({"item_order": "row"}, False),
    ({"schedule": [{"tier": 1, "batch": 4}, {"tier": 5,
                                            "carriage": "bf16"}]}, True),
    ({"batch": 32}, False), ({"chunk_slots": 100}, False),
    ({"ctas_per_sm": 3}, False), ({"ring": 2}, False),
    ({"schedule": [{"tier": 99, "batch": 4}]}, False),
    ({"schedule": [{"tier": 1, "carriage": "int8"}]}, False)])
def test_candidates_are_certified_before_any_child(opts, ok):
    why = kcert.certify_candidate_opts(opts, 16)
    assert (why is None) == ok, why
    if not ok:
        assert why.startswith("kcert: ")
    assert kcert.certify_candidate_opts({"batch": 16}, 16,
                                        feature_dtype="int8")
    assert kcert.certify_candidate_opts({"batch": 8}, 16,
                                        feature_dtype="int8") is None


def test_a_registered_kernel_is_certified_with_the_builtins():
    base = cuda_sell.kcert_entry()
    shapes = ((8, 40), (300, 3))
    starts, rows = _starts(shapes)
    entry = kernel_contract.KernelEntry(
        contract=kernel_contract.KernelContract(
            name="planted_k1", module="tests", kind="k1_worklist",
            source=base.contract.source, threads=256,
            accum_decls=base.contract.accum_decls),
        metas=lambda: [worklist.k1_meta(shapes, starts, rows, rows, 16,
                                        "f32", True, True)],
        source_path=base.source_path)
    kernel_contract.register_kernel(entry)
    try:
        names = [e.name for e in kernel_contract.registered_kernels()]
        assert names[:3] == ["sell_tier_spmm", "arrow_blocks_spmm",
                             "granule_gather"] and "planted_k1" in names
        assert kcert.certify_entry(entry)["ok"]
    finally:
        kernel_contract.unregister_kernel("planted_k1")
    assert "planted_k1" not in [e.name for e in
                                kernel_contract.registered_kernels()]


def test_hopper_counters_read_the_launch_meta():
    from arrow_matrix_tpu_torch.obs import costmodel as cm

    meta = kcert._good_k1_meta()
    assert cm.meta_grid_programs(meta) == len(meta["items"]) \
        * meta["col_blocks"]
    assert cm.meta_stream_bytes(meta) == (8 * 40 + 40 * 12 + 2000 * 2) \
        * 128 * 4
    assert cm.meta_padded_rows(meta) == 54
    assert cm.meta_split_partials(meta) == meta["n_parts"] > 0
    assert cm.meta_smem_bytes(meta) == 4 * 256 * 4
    assert re.match(r"k=128,f32,cs=128,b=8,ctas=2",
                    kcert.point_label(meta))

"""Collective accounting of the port (``utils/commstats.py``,
``obs/comm.py``, ``analysis/contracts.py``) against the JAX package's
formulas: the moved-row bound, the formatting, the planner, the
exposed-time model and the contract value."""

import numpy as np
import pytest

from arrow_matrix_tpu.analysis import contracts as jcontracts
from arrow_matrix_tpu.obs import comm as jcomm
from arrow_matrix_tpu.utils import commstats as jstats
from arrow_matrix_tpu_torch.analysis import contracts as pcontracts
from arrow_matrix_tpu_torch.obs import comm as pcomm
from arrow_matrix_tpu_torch.utils import commstats as pstats


@pytest.mark.parametrize("total,n_dev,levels,k", [
    (1024, 8, 3, 4), (999, 4, 2, 16), (4096, 16, 5, 1), (64, 1, 2, 8)])
def test_ideal_routing_bytes_matches_jax(total, n_dev, levels, k):
    rng = np.random.default_rng(total)
    perms = [rng.permutation(total) for _ in range(levels)]
    assert pstats.ideal_routing_bytes(perms, n_dev, k) \
        == jstats.ideal_routing_bytes(perms, n_dev, k)


def test_collective_stats_counts_one_call_and_formats():
    def step():
        pstats.record("all-to-all", 96, 4)
        pstats.record("gather", 32, 4)
        pstats.record_staged(256)

    pstats.record("broadcast", 1, 2)
    st = pstats.collective_stats(step)
    assert st["broadcast"]["count"] == 0
    assert st["all-to-all"] == {"count": 1, "bytes": 96, "group": 4}
    assert st["total_bytes"] == 128 and st["host_staged_bytes"] == 256
    text = pstats.format_stats(st)
    assert "all-to-all" in text and "TOTAL" in text and "host staged" in text
    jst = {kind: {"count": 0, "bytes": 0} for kind in jstats.COLLECTIVE_OPS}
    jst["all-to-all"] = {"count": 1, "bytes": 96}
    jst["total_bytes"] = 96
    assert jstats.format_stats(jst).splitlines()[1] \
        == pstats.format_stats({**st, "gather": {"count": 0, "bytes": 0},
                                "total_bytes": 96,
                                "host_staged_bytes": 0}).splitlines()[1]


@pytest.mark.parametrize("measured,slabs", [(0, 1), (45_000_000, 1),
                                            (45_000_000, 4), (123, 2)])
def test_exposed_comm_ms_matches_jax(measured, slabs):
    assert pcomm.exposed_comm_ms(measured, slabs) \
        == jcomm.exposed_comm_ms(measured, slabs)


@pytest.mark.parametrize("kw", [
    dict(n_dev=8, k=8, base_hbm_bytes=100, budget_bytes=1000,
         exchange_bytes=1 << 20),
    dict(n_dev=8, k=8, base_hbm_bytes=100, budget_bytes=1000,
         exchange_bytes=0),
    dict(n_dev=6, k=8, base_hbm_bytes=100, budget_bytes=1000,
         exchange_bytes=1 << 20),
    dict(n_dev=8, k=7, base_hbm_bytes=100, budget_bytes=1000,
         exchange_bytes=1 << 20),
    dict(n_dev=8, k=8, base_hbm_bytes=400, budget_bytes=1000,
         exchange_bytes=1 << 20, reduce_bytes=1 << 30, iterations=2),
    dict(n_dev=8, k=8, base_hbm_bytes=100, budget_bytes=150,
         exchange_bytes=1 << 20)])
def test_auto_repl_matches_jax(kw):
    assert pcomm.auto_repl(quiet=True, **kw) \
        == jcomm.auto_repl(quiet=True, **kw)


def test_auto_repl_degrades_loudly(monkeypatch, capsys):
    monkeypatch.setenv("AMT_HBM_GB", "0.0000001")
    plan = pcomm.auto_repl(8, 8, base_hbm_bytes=100, exchange_bytes=1 << 20)
    assert plan["c"] == 1 and plan["degraded"] is True
    assert "DEGRADED" in capsys.readouterr().err


def test_bytes_for_and_account_collectives():
    class Exe:
        def ideal_comm_bytes(self, k, itemsize=4):
            return 10 * k * itemsize

        def reduce_comm_bytes(self, k, itemsize=4):
            return 3 * k * itemsize

    for mod in (pcomm, jcomm):
        assert mod.ideal_bytes_for(Exe(), 8, 2) == 160
        assert mod.reduce_bytes_for(Exe(), 8) == 96
        assert mod.ideal_bytes_for(object(), 8) is None
        assert mod.reduce_bytes_for(object(), 8) == 0
    rep = pcomm.account_collectives(
        "t", lambda: pstats.record("all-to-all", 320, 4), ideal_bytes=160,
        overlap_slabs=2, repl=2, reduce_bytes=96)
    assert rep["measured_bytes"] == 320 and rep["ratio"] == 2.0
    assert rep["source"] == "counted" and rep["repl"] == 2
    assert rep["exposed_comm_ms"] == round(
        jcomm.exposed_comm_ms(320, 2), 6)
    assert set(rep) >= {"algorithm", "collectives", "ideal_bytes",
                        "overlap_slabs", "reduce_bytes",
                        "host_staged_bytes"}


def test_collective_contract_is_the_jax_value():
    kw = dict(algorithm="sell_multi", step_bytes=1000, reduce_bytes=10,
              repl=2, overlap_slabs=2, dtype="f32",
              lowered_kinds=("all-to-all", "gather"),
              compiled_kinds=("all-to-all",), ratio_band=(0.25, 4.0),
              donated_params=(0,), hot_copy_budget=32, notes="n")
    p, j = pcontracts.CollectiveContract(**kw), \
        jcontracts.CollectiveContract(**kw)
    assert p.to_json() == j.to_json()
    assert p.expected_slab(128) == j.expected_slab(128)
    for hosts, devs, pattern in ((1, 4, "ring"), (2, 8, "ring"),
                                 (2, 8, "alltoall")):
        assert p.inter_host_bytes(hosts, devs, pattern) \
            == j.inter_host_bytes(hosts, devs, pattern)
    with pytest.raises(ValueError, match="repl must be"):
        pcontracts.CollectiveContract(**{**kw, "repl": 0})

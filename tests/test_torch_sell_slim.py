"""The port's padding-free mesh executors (``parallel/sell_slim.py``)
against the JAX package's on a mesh of the same size.

Host cases hold the port's packing (tier ladders, each device's SELL
stacks, carried maps, route tables) byte for byte against JAX's.  Rank
cases run the port's executors on gloo ranks on the CPU (a module-scoped
pool of 4, and one of 2) and hold their global results against the JAX
executor on the conftest's virtual CPU devices, within
``relative_tolerance``, mirroring ``tests/test_sell_slim.py`` and the
2.5D cases of ``tests/test_repl.py``.
"""

import os
import re
import sys

import numpy as np
import pytest
from scipy import sparse

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decomp
from arrow_matrix_tpu.decomposition.decompose import decomposition_spmm
from arrow_matrix_tpu.parallel import make_mesh as jax_mesh
from arrow_matrix_tpu.parallel import sell_slim as jss
from arrow_matrix_tpu_torch.ops.ell import align_up
from arrow_matrix_tpu_torch.parallel import sell_slim as pss
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.parallel.routing import build_route
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_mesh_jobs"


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=120) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", timeout_s=120) as pool:
        yield pool


def _levels(n, width, seed, max_levels=3, m=4, weight=None):
    a = barabasi_albert(n, m, seed=seed)
    if weight is not None:
        a = (a * weight).tocsr().astype(np.float32)
    return a, jax_decomp(a, width, max_levels=max_levels,
                         block_diagonal=True, seed=seed)


def _tol(a, steps=1):
    return relative_tolerance(a.nnz / a.shape[0], steps)


def _jax_multi(levels, width, n_dev, x, steps=1, **kw):
    sm = jss.SellMultiLevel(levels, width, jax_mesh((n_dev,), ("blocks",)),
                            **kw)
    return sm, sm.gather_result(sm.run(sm.set_features(x), steps))


# -- host cases: the packing, byte for byte -----------------------------------

@pytest.mark.parametrize("max_deg,growth,align", [
    (100, 1.5, 8), (0, 1.5, 8), (7, 1.3, 1), (4096, 1.5, 8), (33, 1.2, 2)])
def test_degree_ladder_matches_jax(max_deg, growth, align):
    assert pss.degree_ladder(max_deg, growth, align) \
        == jss.degree_ladder(max_deg, growth, align)


@pytest.mark.parametrize("ladder", [None, "default", "tight", (1.2, 2),
                                    "bogus", (1.0, 8), (1.5, 0), 3])
def test_resolve_ladder_matches_jax(ladder):
    try:
        want = jss.resolve_ladder(ladder)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            pss.resolve_ladder(ladder)
        return
    assert pss.resolve_ladder(ladder) == want


def _fields(ops):
    """A JAX SlimLevelOps as numpy."""
    def stack(s):
        return ([np.asarray(c) for c in s.cols],
                [np.asarray(d) for d in s.deg],
                None if s.data is None else [np.asarray(d) for d in s.data])

    return {"body": stack(ops.body), "head": stack(ops.head),
            "head_unsort": np.asarray(ops.head_unsort),
            "orig_pos": np.asarray(ops.orig_pos),
            "body_order": np.asarray(ops.body_order),
            "rows_out": ops.rows_out, "shard_len": ops.shard_len,
            "width": ops.width, "hops": ops.hops, "rem": ops.rem,
            "binary": ops.binary}


def _assert_level_equal(port, jf):
    for name in ("body", "head"):
        ps = getattr(port, name)
        cols, deg, data = jf[name]
        assert len(ps.cols) == len(cols)
        for a, b in zip(ps.cols, cols):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(ps.deg, deg):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (ps.data is None) == (data is None)
        for a, b in zip(ps.data or (), data or ()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for name in ("head_unsort", "orig_pos", "body_order"):
        assert np.array_equal(getattr(port, name), jf[name]), name
    for name in ("rows_out", "shard_len", "hops", "rem", "binary"):
        assert getattr(port, name) == jf[name], name


def _multi_hop_matrix(n=256):
    """A level whose far entries reach past the neighbouring shard at 4
    devices (reach ~1.5 shards: two hops, the farthest sliced)."""
    a = sparse.lil_matrix((n, n), dtype=np.float32)
    a[200, 100] = 2.0    # 100 rows below its shard [192, 256)
    a[10, 250] = 3.0     # a head row: covered by the head operator
    a[100, 101] = 1.0
    a[70, 150] = 0.5
    return a.tocsr()


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("case", ["binary", "weighted", "multi_hop",
                                  "whole_graph"])
def test_level_packing_equals_jax(n_dev, case):
    """Each device's body and head stacks, orderings, halo hops and the
    farthest hop's rows equal JAX's build_slim_level."""
    w = 32
    if case == "multi_hop":
        matrix = _multi_hop_matrix()
    elif case == "whole_graph":
        matrix = barabasi_albert(384, 3, seed=13).astype(np.float32)
    else:
        _, levels = _levels(640, w, seed=9, weight=None if case == "binary"
                            else 0.25)
        matrix = levels[0].matrix
    jsrc = jss._SliceSource(matrix, n_dev, w)
    binary = jsrc.resolve_binary("auto")
    jops = jss.build_slim_level(jsrc, w, jax_mesh((n_dev,), ("blocks",)),
                                "blocks", np.float32, binary)
    port = pss.build_slim_level(matrix, w, n_dev, np.float32, binary)
    _assert_level_equal(port, _fields(jops))
    if case == "multi_hop" and n_dev == 4:
        assert port.hops == 2 and 0 < port.rem < port.shard_len


def test_per_host_packing_equals_the_whole():
    """A rank packs only its shard (``materialize``, the reach agreed
    over the ranks): its slice equals the whole build's, every global
    decision agrees, and the other shards stay zero."""
    a = barabasi_albert(512, 4, seed=11).astype(np.float32)
    whole = pss.build_slim_level(a, 32, 4, np.float32, False)
    reach = pss._banded_reach(pss._SliceSource(a, 4, 32), 32)
    for d in range(4):
        part = pss.build_slim_level(a, 32, 4, np.float32, False,
                                    materialize={d}, reach=reach)
        assert (part.hops, part.rem) == (whole.hops, whole.rem)
        assert np.array_equal(part.body_order, whole.body_order)
        others = [e for e in range(4) if e != d]
        for cw, cp in zip(whole.body.cols, part.body.cols):
            assert np.array_equal(cw[d], cp[d])
            assert not np.any(cp[others])
        for gw, gp in zip(whole.body.data, part.body.data):
            assert np.array_equal(gw[d], gp[d])


@pytest.mark.parametrize("n_dev", [2, 4])
def test_route_tables_equal_jax(n_dev):
    """The a2a tables of every inter-level reordering equal JAX's field
    by field, built in memory and streamed in chunks."""
    w = 32
    _, levels = _levels(768, w, seed=13)
    jm, _ = _jax_multi(levels, w, n_dev, random_dense(768, 2, seed=1),
                       routing="a2a")
    n = levels[0].matrix.shape[0]
    shard_len = max(align_up(-(-n // n_dev), w), w)
    total = shard_len * n_dev
    ops = [pss.build_slim_level(lvl.matrix, w, n_dev, np.float32, True,
                                shard_len=shard_len) for lvl in levels]
    oop, tables = pss.carried_route_tables(levels, ops, shard_len, total)
    assert np.array_equal(oop, jm._orig_of_pos0)
    for (f, b), jf, jb in zip(tables, jm.fwd, jm.bwd):
        for (idx, pad, src_total, _), jr in ((f, jf), (b, jb)):
            for chunk in (None, 97):
                rt = build_route(idx, n_dev, src_total=src_total,
                                 pad_mask=pad, stream_chunk=chunk)
                for name in ("local_src", "local_dst", "send_idx",
                             "recv_dst"):
                    got, want = getattr(rt, name), np.asarray(
                        getattr(jr, name))
                    assert got.dtype == want.dtype
                    assert np.array_equal(got, want), (name, chunk)
                assert (rt.rows_src, rt.rows_dst, rt.n_dev) == (
                    jr.rows_src, jr.rows_dst, jr.n_dev)


def test_validation_errors_match_jax():
    """The JAX constructor's ValueErrors, before any collective."""
    class Stub:
        axis_names = ("blocks", "repl")
        shape = {"blocks": 2, "repl": 2}

    _, levels = _levels(256, 32, seed=1, max_levels=2)
    cases = [dict(routing="bogus"),
             dict(overlap_slabs=2, feat_axis="feat"),
             dict(repl_axis="nope"), dict(repl_axis="blocks"),
             dict(repl_axis="repl", routing="gather"),
             dict(repl_axis="repl", feat_axis="feat")]
    for kw in cases:
        with pytest.raises(ValueError) as err:
            pss.SellMultiLevel(levels, 32, Stub(), **kw)
        assert str(err.value)[:30] in _jax_error(levels, kw)
    with pytest.raises(ValueError, match="int8 carriage is a fold-path"):
        pss.SellMultiLevel(levels, 32, Stub(), feature_dtype="int8")


def _jax_error(levels, kw) -> str:
    mesh = jax_mesh((2, 2), ("blocks", "repl"))
    try:
        jss.SellMultiLevel(levels, 32, mesh, **kw)
    except ValueError as e:
        return str(e)
    raise AssertionError(f"JAX accepted {kw}")


# -- rank cases ---------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [2, 4])
def test_sell_slim_matches_jax_and_golden(pool2, pool4, n_dev):
    pool = pool2 if n_dev == 2 else pool4
    _, levels = _levels(1024, 64, seed=3, max_levels=4)
    lvl = levels[0]
    x = random_dense(lvl.matrix.shape[0], 8, seed=1)
    d = jss.SellSlim(lvl.matrix, 64, jax_mesh((n_dev,), ("blocks",)))
    want = d.gather_result(d.spmm(d.set_features(x)))
    got = pool.run(JOBS, "sell_slim", lvl.matrix, 64, x, 1, {})[0]
    assert got["binary"] is True
    tol = _tol(lvl.matrix)
    assert relative_error(got["out"], want) <= tol
    assert relative_error(got["out"], lvl.matrix @ x) <= tol


def test_sell_slim_weighted_and_iterated(pool4):
    _, levels = _levels(640, 32, seed=9)
    aw = (levels[0].matrix * 0.25).tocsr().astype(np.float32)
    x = random_dense(640, 4, seed=2)
    got = pool4.run(JOBS, "sell_slim", aw, 32, x, 3, {})[0]
    assert got["binary"] is False
    want = x
    for _ in range(3):
        want = aw @ want
    assert relative_error(got["out"], want) <= _tol(aw, 3)


@pytest.mark.parametrize("case", ["far_entries", "whole_graph"])
def test_sell_slim_multi_hop_halos_cover_far_entries(pool4, case):
    """Entries far outside the shard grow the halo reach: two hops (the
    farthest carrying only the rows the region needs), or whole-shard
    relays capped at the ring; the result is exact all the same."""
    a = (_multi_hop_matrix() if case == "far_entries"
         else barabasi_albert(768, 4, seed=13).astype(np.float32))
    w = 32
    x = random_dense(a.shape[0], 4, seed=0)
    got = pool4.run(JOBS, "sell_slim", a, w, x, 1, {})[0]
    assert got["hops"] >= (2 if case == "far_entries" else 1)
    d = jss.SellSlim(a, w, jax_mesh((4,), ("blocks",)))
    assert (got["hops"], got["rem"]) == (d.ops.hops, d.ops.rem)
    permute = got["stats"]["collective-permute"]
    assert permute["count"] == got["hops"]
    if case == "far_entries":
        # Rank 0 sends its successor whole shards on the inner hops and
        # only ``rem`` rows on the farthest (shard 64 rows, k = 4, f32).
        assert permute["bytes"] == ((got["hops"] - 1) * 64
                                    + got["rem"]) * 4 * 4
    assert relative_error(got["out"], a @ x) <= _tol(a)


def test_sell_multi_level_matches_jax(pool4):
    a, levels = _levels(1024, 64, seed=7)
    x = random_dense(1024, 8, seed=3)
    jm, want = _jax_multi(levels, 64, 4, x)
    got = pool4.run(JOBS, "sell_multi", levels, 64, x, 1, {})[0]
    tol = _tol(a)
    assert relative_error(got["out"], want) <= tol
    assert relative_error(got["out"], decomposition_spmm(levels, x)) <= tol
    assert got["ideal"] == jm.ideal_comm_bytes(8)
    assert got["contract"]["step_bytes"] == jm.ideal_comm_bytes(8)
    live = jss._live(jm._orig_of_pos0, 1024)
    assert got["mask"] == np.count_nonzero(live[:got["rows_local"]])
    assert got["report"] == jm.shard_report()


def test_sell_multi_level_iterated_weighted(pool4):
    a, levels = _levels(640, 32, seed=11, weight=0.25)
    x = random_dense(640, 4, seed=5)
    got = pool4.run(JOBS, "sell_multi", levels, 32, x, 3, {})[0]
    assert got["binary"] is False
    want = x
    for _ in range(3):
        want = a @ want
    assert relative_error(got["out"], want) <= _tol(a, 3)


def test_routing_modes_and_overlap_give_the_same_bits(pool4):
    """a2a and gather routing, and two overlap slabs, copy the same rows
    into the same sums: the results are equal bit for bit."""
    a, levels = _levels(768, 32, seed=13)
    x = random_dense(768, 8, seed=3)
    outs = [pool4.run(JOBS, "sell_multi", levels, 32, x, 2, kw)[0]
            for kw in ({}, {"routing": "gather"}, {"overlap_slabs": 2})]
    for o in outs[1:]:
        assert np.array_equal(o["out"], outs[0]["out"])
    assert relative_error(outs[0]["out"], a @ (a @ x)) <= _tol(a, 2)
    a2a, gather = outs[0]["stats"], outs[1]["stats"]
    assert a2a["all-gather"]["count"] == 0
    assert gather["all-to-all"]["count"] == 0
    assert a2a["all-to-all"]["bytes"] < gather["all-gather"]["bytes"]


def test_sell_multi_level_k128(pool4):
    a, levels = _levels(1024, 32, seed=31, m=3)
    x = random_dense(1024, 128, seed=2)
    _, want = _jax_multi(levels, 32, 4, x, routing="a2a")
    got = pool4.run(JOBS, "sell_multi", levels, 32, x, 1, {})[0]
    assert relative_error(got["out"], want) <= _tol(a)


def test_sell_multi_level_from_artifact(pool4, tmp_path):
    """Memmapped triplet levels stream into the shards."""
    from arrow_matrix_tpu_torch.io import (
        as_levels,
        load_decomposition,
        load_level_widths,
        save_decomposition,
    )

    a, levels = _levels(600, 64, seed=5, m=3)
    base = str(tmp_path / "g")
    save_decomposition(levels, base)
    widths = load_level_widths(base, 64)
    streamed = as_levels(load_decomposition(base, 64, mem_map=True),
                         widths if widths is not None else 64,
                         materialize=False)
    assert not hasattr(streamed[0].matrix, "nnz")
    x = random_dense(600, 8, seed=2)
    got = pool4.run(JOBS, "sell_multi", streamed, 64, x, 1, {})[0]
    assert got["binary"] is True
    assert relative_error(got["out"], decomposition_spmm(levels, x)) \
        <= _tol(a)


@pytest.mark.parametrize("routing", ["gather", "a2a"])
def test_sell_multi_level_feat_axis(pool4, routing):
    a, levels = _levels(512, 32, seed=41, max_levels=2, m=3)
    x = random_dense(512, 8, seed=2)
    got = pool4.run(JOBS, "sell_multi", levels, 32, x, 1,
                    {"routing": routing, "feat_axis": "feat"}, (2, 2),
                    ("blocks", "feat"))[0]
    assert relative_error(got["out"], decomposition_spmm(levels, x)) \
        <= _tol(a)


def test_bf16_carriage_halves_the_exchanged_bytes(pool4):
    """A bf16 carriage stays within 2e-2 of the golden and moves half
    the bytes of the f32 carriage in every exchange and halo."""
    a = barabasi_albert(768, 4, seed=13).astype(np.float32)
    x = random_dense(768, 8, seed=2)
    f32 = pool4.run(JOBS, "sell_slim", a, 32, x, 1, {})[0]
    b16 = pool4.run(JOBS, "sell_slim", a, 32, x, 1,
                    {"feature_dtype": "bf16"})[0]
    assert f32["hops"] > 0
    assert relative_error(b16["out"], a @ x) < 2e-2
    for kind in ("collective-permute", "broadcast", "gather"):
        assert b16["stats"][kind]["bytes"] * 2 == f32["stats"][kind]["bytes"]
    _, levels = _levels(1024, 64, seed=7)
    xm = random_dense(1024, 8, seed=1)
    m32 = pool4.run(JOBS, "sell_multi", levels, 64, xm, 1, {})[0]
    m16 = pool4.run(JOBS, "sell_multi", levels, 64, xm, 1,
                    {"feature_dtype": "bf16"})[0]
    assert m16["stats"]["total_bytes"] * 2 == m32["stats"]["total_bytes"]
    assert relative_error(m16["out"], decomposition_spmm(levels, xm)) < 2e-2


def test_tight_ladder_matches_default_with_fewer_slots(pool4):
    a, levels = _levels(512, 32, seed=23)
    x = random_dense(512, 8, seed=5)
    base = pool4.run(JOBS, "sell_multi", levels, 32, x, 1, {})[0]
    tight = pool4.run(JOBS, "sell_multi", levels, 32, x, 1,
                      {"ladder": "tight"})[0]
    assert relative_error(tight["out"], base["out"]) <= _tol(a)
    slots = lambda lad: sum(
        o.body.n_slots + o.head.n_slots for o in
        (pss.build_slim_level(lvl.matrix, 32, 4, np.float32, True,
                              ladder=lad) for lvl in levels))
    assert slots("tight") < slots("default")


def test_repl_2_5d_equals_c1_at_the_same_block_count(pool2, pool4):
    """2.5D at a fixed block count B=2: c=2 replicas on a (2, 2) grid
    equal the 2-rank c=1 run bit for bit, with half the per-step bytes
    in every exchange (each replica group moves its k/2 slab)."""
    a, levels = _levels(512, 32, seed=3)
    x = random_dense(512, 8, seed=4)
    c1 = pool2.run(JOBS, "sell_multi", levels, 32, x, 2, {})[0]
    c2 = pool4.run(JOBS, "sell_multi", levels, 32, x, 2,
                   {"repl_axis": "repl"}, (2, 2), ("blocks", "repl"))[0]
    assert np.array_equal(c1["out"], c2["out"])
    for kind in ("all-to-all", "broadcast", "gather"):
        assert c2["stats"][kind]["bytes"] * 2 == c1["stats"][kind]["bytes"]
    assert c2["contract"]["repl"] == 2
    assert c2["contract"]["reduce_bytes"] > 0
    assert relative_error(c2["out"], a @ (a @ x)) <= _tol(a, 2)


def test_merge_carries_is_a_bit_exact_resume_state(pool4):
    a, levels = _levels(512, 32, seed=3)
    x = random_dense(512, 8, seed=4)
    two, resumed = pool4.run(JOBS, "sell_multi_resumed", levels, 32, x,
                             {"repl_axis": "repl"}, (2, 2),
                             ("blocks", "repl"))[0]
    assert np.array_equal(two, resumed)


def test_port_step_over_jax_packing(pool4):
    """The port's level step driven over exactly JAX's packing (the
    arrays converted by ``convert.shard_stack_from_numpy``) gives JAX's
    result."""
    a = barabasi_albert(768, 4, seed=13).astype(np.float32)
    d = jss.SellSlim(a, 32, jax_mesh((4,), ("blocks",)))
    x = random_dense(768, 8, seed=2)
    want = d.gather_result(d.spmm(d.set_features(x)))
    carried = jss._scatter_carried(x, d._oop, 768)
    got = pool4.run(JOBS, "jax_packing_step", _fields(d.ops), carried, 1)[0]
    assert relative_error(jss._gather_carried(got, d._oop, 768), want) \
        <= _tol(a)


def test_sell_slim_repl_equals_c1_and_reports(pool2, pool4):
    """SellSlim's 2.5D mode: c=2 replicas on a (blocks=2, repl=2) grid
    equal the 2-rank c=1 run bit for bit; the per-device load report is
    JAX's."""
    a = barabasi_albert(512, 4, seed=3).astype(np.float32)
    x = random_dense(512, 8, seed=4)
    c1 = pool2.run(JOBS, "sell_slim", a, 32, x, 2, {})[0]
    c2 = pool4.run(JOBS, "sell_slim", a, 32, x, 2, {"repl_axis": "repl"},
                   (2, 2), ("blocks", "repl"))[0]
    assert np.array_equal(c1["out"], c2["out"])
    assert relative_error(c1["out"], a @ (a @ x)) <= _tol(a, 2)
    d = jss.SellSlim(a, 32, jax_mesh((2,), ("blocks",)))
    assert c1["report"] == d.shard_report()

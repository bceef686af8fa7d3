"""The per-level executors' routing through K4: ``multi_level_spmm``
routes forward by ``row_gather`` and aggregates backward by one
``row_gather_add_`` a level pair (their plain versions on the CPU), the
flat ELL head's unsort is a ``row_gather`` too, and a step stays within
``relative_tolerance`` of the JAX ``MultiLevelArrow`` and the scipy
golden, for fmt ell, hyb, auto and dense, block-diagonal and banded, at
ragged n and odd k.  On the CPU the routed step equals the step routed
by ``index_select`` bit for bit (the same plain calls)."""

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu_torch.decomposition import (
    arrow_decomposition,
    decomposition_spmm,
)
from arrow_matrix_tpu_torch.ops import cuda_ell, cuda_gather
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow, multi_level
from arrow_matrix_tpu_torch.parallel.multi_level import (
    level_spmm,
    resolve_chunk,
)
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)

FORMATS = ["ell", "hyb", "auto", "dense"]


@pytest.fixture(scope="module")
def ten_levels():
    """BA n = 1500 (ragged), m = 6, at width 8: ten block-diagonal
    levels."""
    levels = arrow_decomposition(barabasi_albert(1500, 6, seed=1), 8,
                                 max_levels=10, block_diagonal=True,
                                 seed=0)
    assert len(levels) == 10
    return levels


def _executor(levels, width, fmt, banded=False, **kw):
    if fmt == "auto":
        # Room for the first level dense, the rest ELL.
        rows = MultiLevelArrow(levels, width, fmt="ell", banded=banded,
                               device="cpu").total_rows
        kw["dense_budget"] = rows * width * (5 if banded else 3) * 4 + 1
    return MultiLevelArrow(levels, width, fmt=fmt, banded=banded,
                           device="cpu", **kw)


def _index_select_step(exe, x):
    """One step of ``exe`` with the routing by ``index_select`` and an
    add: the executor's step before K4 carried it."""
    total, k = x.shape
    partials, cur = [], x
    for i, (blk, w) in enumerate(zip(exe.blocks, exe.widths)):
        if i:
            cur = cur.index_select(0, exe.fwd[i - 1])
        partials.append(level_spmm(blk, cur, w, resolve_chunk(
            exe.chunk, blk, total, k, exe.gather_budget)))
    agg = partials[-1]
    for i in range(len(exe.blocks) - 1, 0, -1):
        agg = partials[i - 1].add_(agg.index_select(0, exe.bwd[i - 1]))
    return agg


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def counted(*args):
        calls[name] = calls.get(name, 0) + 1
        return real(*args)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("fmt", FORMATS)
def test_step_routes_through_the_row_gather(ten_levels, monkeypatch, fmt):
    exe = _executor(ten_levels, 8, fmt)
    if fmt == "auto":
        assert exe.fmts[0] == "dense" and "ell" in exe.fmts
    assert exe.fwd.dtype == exe.bwd.dtype == torch.int32
    assert exe.fwd.shape == exe.bwd.shape == (9, exe.total_rows)
    calls = {}
    _spy(monkeypatch, multi_level, "row_gather", calls)
    _spy(monkeypatch, multi_level, "row_gather_add_", calls)
    x = exe.set_features(random_dense(1500, 3, seed=4))
    y = exe.run(x, 2)
    assert calls == {"row_gather": 18, "row_gather_add_": 18}
    want = _index_select_step(exe, _index_select_step(exe, x))
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    golden = decomposition_spmm(ten_levels, decomposition_spmm(
        ten_levels, random_dense(1500, 3, seed=4)))
    assert relative_error(exe.gather_result(y), golden) <= \
        relative_tolerance(exe.nnz / 1500, 2)


def test_flat_heads_unsort_by_the_row_gather(ten_levels, monkeypatch):
    """The card's form of an ELL level (K1 operators, run here through
    K1's plain version) puts each flat head back in row order with one
    row gather: 9 routing gathers and 10 unsorts a step."""
    exe = _executor(ten_levels, 8, "ell", head_fmt="flat")
    assert exe.head_layouts() == ["flat"] * 10
    calls = {}
    _spy(monkeypatch, multi_level, "row_gather", calls)
    _spy(monkeypatch, multi_level, "row_gather_add_", calls)
    heads = {}
    _spy(monkeypatch, cuda_ell, "row_gather", heads)
    monkeypatch.setattr(multi_level, "arrow_spmm_ell_cuda",
                        lambda blk, xb, chunk=None:
                        cuda_ell.arrow_spmm_k1(blk, xb))
    before = (cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD)
    x = random_dense(1500, 3, seed=5)
    got = exe.gather_result(exe.step(exe.set_features(x)))
    assert calls == {"row_gather": 9, "row_gather_add_": 9}
    assert heads == {"row_gather": 10}
    assert all(blk.k1["head_inv"].dtype == torch.int32
               for blk in exe.blocks)
    # The CPU runs the plain versions: no kernel launched.
    assert (cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD) == before
    assert relative_error(got, decomposition_spmm(ten_levels, x)) <= \
        relative_tolerance(exe.nnz / 1500)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,k,block_diagonal", [(777, 3, True),
                                                (1000, 5, False)])
def test_routed_step_matches_jax(fmt, n, k, block_diagonal):
    width = 16
    levels = arrow_decomposition(barabasi_albert(n, 3, seed=2), width,
                                 max_levels=4,
                                 block_diagonal=block_diagonal, seed=0)
    assert len(levels) > 1
    banded = not block_diagonal
    ours = _executor(levels, width, fmt, banded=banded)
    theirs = JaxArrow(levels, width, fmt=fmt, banded=banded,
                      **({"dense_budget": ours.dense_budget}
                         if fmt == "auto" else {}))
    assert ours.fmts == theirs.fmts
    assert np.array_equal(ours.fwd.numpy(), np.asarray(theirs.fwd))
    assert np.array_equal(ours.bwd.numpy(), np.asarray(theirs.bwd))
    x = random_dense(n, k, seed=6)
    got = ours.gather_result(ours.step(ours.set_features(x)))
    want = np.asarray(theirs.gather_result(
        theirs.step(theirs.set_features(x))))
    tol = relative_tolerance(ours.nnz / n)
    assert relative_error(got, want) <= tol
    assert relative_error(got, decomposition_spmm(levels, x)) <= tol


# -- the mesh's routed exchanges (parallel/routing.py) -------------------------

import os as _os
import sys as _sys

from arrow_matrix_tpu.parallel import routing as _jrouting
from arrow_matrix_tpu_torch.parallel import routing as _prouting
from arrow_matrix_tpu_torch.parallel.launch import RankPool

_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

_TABLES = {
    "random": lambda rng, n: rng.permutation(n),
    "identity": lambda rng, n: np.arange(n),
    "shift": lambda rng, n: np.roll(np.arange(n), n // 8),
}


@pytest.fixture(scope="module")
def route_pool():
    with RankPool(4, device="cpu", timeout_s=60) as pool:
        yield pool


def _rect_case(rng, total=1024, src_total=768):
    table = rng.integers(0, src_total, total)
    pad = rng.random(total) < 0.2
    return table, src_total, pad


def _assert_tables_equal(port, jax_rt):
    for name in ("local_src", "local_dst", "send_idx", "recv_dst"):
        got, want = getattr(port, name), np.asarray(getattr(jax_rt, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert (port.rows_src, port.rows_dst, port.n_dev) == (
        jax_rt.rows_src, jax_rt.rows_dst, jax_rt.n_dev)


@pytest.mark.parametrize("case", sorted(_TABLES) + ["rectangular"])
@pytest.mark.parametrize("chunk", [None, 100])
def test_build_route_equals_jax(case, chunk):
    rng = np.random.default_rng(7)
    if case == "rectangular":
        table, src_total, pad = _rect_case(rng)
    else:
        table, src_total, pad = _TABLES[case](rng, 1024), None, None
    kw = dict(src_total=src_total, pad_mask=pad, stream_chunk=chunk)
    _assert_tables_equal(_prouting.build_route(table, 4, **kw),
                         _jrouting.build_route(table, 4, **kw))


def test_build_route_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="divisible"):
        _prouting.build_route(np.arange(10), 8)
    with pytest.raises(ValueError, match="outside"):
        _prouting.build_route(np.full(16, 20), 4)


def test_split_route_stages_equals_jax():
    rng = np.random.default_rng(3)
    table = rng.permutation(1024)
    p = _prouting.split_route_stages(_prouting.build_route(table, 4), 8,
                                     2 * 4 * 8 * 4 * 5)
    j = _jrouting.split_route_stages(_jrouting.build_route(table, 4), 8,
                                     2 * 4 * 8 * 4 * 5)
    assert p.n_stages == j.n_stages > 1
    for ps, js in zip(p.stages, j.stages):
        _assert_tables_equal(ps, js)
    assert p.device_bytes_per_exchange(8) == j.device_bytes_per_exchange(8)
    with pytest.raises(ValueError, match="cannot carry one"):
        _prouting.split_route_stages(_prouting.build_route(table, 4), 8, 8)


@pytest.mark.parametrize("case", sorted(_TABLES) + ["rectangular"])
@pytest.mark.parametrize("routing,add", [("a2a", False), ("a2a", True),
                                         ("gather", False),
                                         ("gather", True)])
def test_routed_take_equals_the_table_bit_for_bit(route_pool, case,
                                                  routing, add):
    """Every exchange copies bits: ``x[table]`` exactly (plus a base of
    ones for the backward form), the padding destinations zero, and an
    identity route has no slot to send."""
    rng = np.random.default_rng(11)
    if case == "rectangular":
        table, src_total, pad = _rect_case(rng)
    else:
        table, src_total, pad = _TABLES[case](rng, 1024), 1024, None
    x = rng.standard_normal((src_total, 5)).astype(np.float32)
    x[3, 1] = -0.0
    got = route_pool.run("_torch_mesh_jobs", "routed", table, src_total,
                         pad, x, routing, add)[0]
    want = x[table]
    if pad is not None and routing == "a2a":
        want[pad] = 0.0
    if add:
        want = np.float32(1.0) + want
    assert np.array_equal(got["out"].view(np.int32), want.view(np.int32))
    if case == "identity" and routing == "a2a":
        assert got["slots"] == 0
        assert got["stats"]["total_bytes"] == 0     # no collective at all


def test_staged_take_equals_the_one_shot(route_pool):
    rng = np.random.default_rng(5)
    table = rng.permutation(1024)
    x = rng.standard_normal((1024, 8)).astype(np.float32)
    one = route_pool.run("_torch_mesh_jobs", "routed", table, 1024, None, x,
                         "a2a", False)[0]
    staged = route_pool.run("_torch_mesh_jobs", "routed", table, 1024, None,
                            x, "a2a", False, 8)[0]
    assert np.array_equal(staged["out"], one["out"])
    assert np.array_equal(one["out"], x[table])


def test_route_tables_from_jax_arrays_drive_the_exchange():
    """``convert.route_tables_from_numpy`` takes a JAX RouteTables's
    arrays: the same tables as the port's build, the same rank tables."""
    from arrow_matrix_tpu_torch.convert import route_tables_from_numpy

    rng = np.random.default_rng(9)
    table, src_total, pad = _rect_case(rng)
    j = _jrouting.build_route(table, 4, src_total=src_total, pad_mask=pad)
    got = route_tables_from_numpy(j.local_src, j.local_dst, j.send_idx,
                                  j.recv_dst, j.rows_src, j.rows_dst,
                                  j.n_dev)
    want = _prouting.build_route(table, 4, src_total=src_total,
                                 pad_mask=pad)
    _assert_tables_equal(got, j)
    for d in range(4):
        a, b = (_prouting.rank_route(got, d, "cpu"),
                _prouting.rank_route(want, d, "cpu"))
        assert torch.equal(a.send, b.send) and torch.equal(a.unpack,
                                                           b.unpack)

"""``SellSpaceShared`` (``parallel/sell_space.py``) on gloo ranks against
the JAX executor on its CPU devices, the decomposition golden, the
time-shared ``SellMultiLevel`` and under iteration, mirroring
``tests/test_sell_space.py``: bf16, weighted and forced-weighted, three
uneven levels, the feature axis, a directed graph.  Each rank's packed
share (the tiers unified over every level and device), the composed
tables and the head unsorts equal JAX's byte for byte; the transposed
step equals the dense matrix of the whole step, transposed."""

import os
import sys

import numpy as np
import pytest
from scipy import sparse

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decomp
from arrow_matrix_tpu.decomposition.decompose import decomposition_spmm
from arrow_matrix_tpu.parallel import SellSpaceShared as JaxSellSpace
from arrow_matrix_tpu.parallel import make_mesh as jax_mesh
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.parallel.sell_space import SellSpaceShared
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_mesh_jobs"
LIMIT = 240
SPACE = ((2, 2), ("lvl", "blocks"))


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=120) as pool:
        yield pool


def _run(pool, *args):
    return pool.run(JOBS, *args, job_timeout_s=LIMIT)


def two_levels(n=1024, width=64, m=4, seed=7, dseed=2):
    a = barabasi_albert(n, m, seed=seed)
    levels = jax_decomp(a, width, max_levels=2, block_diagonal=True,
                        seed=dseed)
    assert len(levels) == 2
    return a, levels


def _assert_packing_equals_jax(got, js):
    """Every rank's share of the unified stacks, its carried positions,
    the head unsorts and the composed tables equal JAX's."""
    for r in got:
        sh = r["share"]
        s = sh["index"]
        for name in ("body", "head"):
            stack = getattr(js, name)
            cols, deg, data = sh[name]
            assert len(cols) == len(stack.cols)
            for a, b in zip(cols, stack.cols):
                b = np.asarray(b)[s]
                assert a.dtype == b.dtype and np.array_equal(a, b), name
            for a, b in zip(deg, stack.deg):
                assert np.array_equal(a, np.asarray(b)[s]), name
            assert (data is None) == (stack.data is None)
            for a, b in zip(data or (), stack.data or ()):
                b = np.asarray(b)[s]
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert np.array_equal(sh["orig_pos"], np.asarray(js.orig_pos)[s])
        assert np.array_equal(sh["head_unsort"], np.asarray(js.head_unsort))
        assert (sh["rows_out"], sh["hops"]) == (js.rows_out, js.hops)
    for name in ("bwd0", "fwd0"):
        mine, theirs = got[0][name], np.asarray(getattr(js, name))
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)


def test_bf16_carriage_matches_golden(pool4):
    """feature_dtype='bf16': the carriage is bf16, the gathered result
    f32, within bf16 rounding (2e-2) of the golden."""
    n, width = 1024, 64
    _, levels = two_levels(n, width)
    x = random_dense(n, 8, seed=3)
    got = _run(pool4, "space_step", "sell_space", levels, width, x, 1,
               {"feature_dtype": "bf16"}, *SPACE)
    assert got[0]["dtype"] == "torch.bfloat16"
    out = got[0]["out"]
    assert out.dtype == np.float32
    want = decomposition_spmm(levels, x)
    assert np.linalg.norm(out - want) / np.linalg.norm(want) < 2e-2


def test_matches_golden_time_shared_and_jax(pool4):
    """One step against the golden (1e-4) and the time-shared
    SellMultiLevel on 4 ranks (rtol 1e-4, atol 1e-5); the packing, the
    tables, the cost model and the load report are JAX's on the same
    mesh shape; the mask counts level 0's live rows once."""
    n, width = 1024, 64
    _, levels = two_levels(n, width)
    x = random_dense(n, 8, seed=3)
    got = _run(pool4, "space_step", "sell_space", levels, width, x, 1, {},
               *SPACE)
    assert all(r["binary"] for r in got)
    np.testing.assert_allclose(got[0]["out"], decomposition_spmm(levels, x),
                               rtol=1e-4, atol=1e-4)
    ref = _run(pool4, "sell_multi", levels, width, x, 1, {})[0]["out"]
    np.testing.assert_allclose(got[0]["out"], ref, rtol=1e-4, atol=1e-5)
    js = JaxSellSpace(levels, width, jax_mesh(*SPACE))
    _assert_packing_equals_jax(got, js)
    assert got[0]["ideal"] == js.ideal_comm_bytes(8)
    assert got[0]["report"] == js.shard_report()
    live = int(np.asarray(js.carried_mask()).sum())
    assert sum(r["mask"] for r in got) == live
    assert [r["mask"] > 0 for r in got] == [True, True, False, False]


def test_iterated_weighted_run(pool4):
    """Weighted matrices, 3 chained steps against 3 host applications
    (the orderings round-trip through the tables every step)."""
    n, width = 640, 32
    a = (barabasi_albert(n, 4, seed=11) * 0.25).tocsr().astype(np.float32)
    levels = jax_decomp(a, width, max_levels=2, block_diagonal=True, seed=5)
    assert len(levels) == 2
    x = random_dense(n, 4, seed=9)
    got = _run(pool4, "space_step", "sell_space", levels, width, x, 3, {},
               *SPACE)
    assert not got[0]["binary"]
    want = x
    for _ in range(3):
        want = decomposition_spmm(levels, want)
    np.testing.assert_allclose(got[0]["out"], want, rtol=1e-3, atol=1e-3)
    _assert_packing_equals_jax(got, JaxSellSpace(levels, width,
                                                 jax_mesh(*SPACE)))


def test_binary_forced_weighted_bit_identical(pool4):
    """binary=False stores explicit values; on 0/1 adjacency the result
    equals the degree-mask layout's bit for bit."""
    n, width = 512, 32
    _, levels = two_levels(n, width, seed=13)
    x = random_dense(n, 4, seed=2)
    b = _run(pool4, "space_step", "sell_space", levels, width, x, 1, {},
             *SPACE)
    w = _run(pool4, "space_step", "sell_space", levels, width, x, 1,
             {"binary": False}, *SPACE)
    assert b[0]["binary"] and not w[0]["binary"]
    np.testing.assert_array_equal(b[0]["out"], w[0]["out"])


def test_three_levels_uneven_groups():
    """K=3 on a (3, 2) mesh of 6 ranks: converged and grown levels
    sharing the unified tier shapes and halo reach; the packing is
    JAX's."""
    n, width = 768, 32
    a = barabasi_albert(n, 3, seed=17)
    levels = jax_decomp(a, width, max_levels=3, block_diagonal=True,
                        seed=4)[:3]
    assert len(levels) == 3
    x = random_dense(n, 4, seed=6)
    mesh = ((3, 2), ("lvl", "blocks"))
    with RankPool(6, device="cpu", timeout_s=120) as pool6:
        got = _run(pool6, "space_step", "sell_space", levels, width, x, 1,
                   {}, *mesh)
    np.testing.assert_allclose(got[0]["out"], decomposition_spmm(levels, x),
                               rtol=1e-4, atol=1e-4)
    _assert_packing_equals_jax(got, JaxSellSpace(levels, width,
                                                 jax_mesh(*mesh)))


def test_feat_axis_three_axis_mesh(pool4):
    """Levels x block rows x feature columns on a (2, 1, 2) mesh: the
    k-tiling composes with the concurrent groups."""
    n, width = 512, 32
    _, levels = two_levels(n, width, seed=23)
    x = random_dense(n, 8, seed=4)
    got = _run(pool4, "space_step", "sell_space", levels, width, x, 1,
               {"feat_axis": "feat"}, (2, 1, 2), ("lvl", "blocks", "feat"))
    np.testing.assert_allclose(got[0]["out"], decomposition_spmm(levels, x),
                               rtol=1e-4, atol=1e-4)
    assert got[0]["launches"] == got[1]["launches"]


def test_directed_graph_space_shared(pool4):
    n, width = 512, 32
    a = barabasi_albert(n, 3, seed=43, directed=True)
    assert (abs(a - a.T)).nnz > 0
    levels = jax_decomp(a, width, max_levels=2, block_diagonal=True, seed=2)
    assert len(levels) == 2
    x = random_dense(n, 4, seed=1)
    got = _run(pool4, "space_step", "sell_space", levels, width, x, 1, {},
               *SPACE)
    np.testing.assert_allclose(got[0]["out"], decomposition_spmm(levels, x),
                               rtol=1e-4, atol=1e-4)


class _Stub:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def test_mesh_level_mismatch_raises():
    """The JAX class's refusals, before any collective: a ``lvl`` axis
    that is not one slice a level, a ``feat_axis`` the mesh lacks, and
    the int8 carriage (the mesh executors carry f32 or bf16)."""
    _, levels = two_levels(512, 32, seed=19)
    with pytest.raises(ValueError, match="lvl"):
        SellSpaceShared(levels, 32, _Stub((4, 1), ("lvl", "blocks")))
    with pytest.raises(ValueError, match="feat_axis='feat' requires"):
        SellSpaceShared(levels, 32, _Stub((2, 2), ("lvl", "blocks")),
                        feat_axis="feat")
    with pytest.raises(ValueError, match="int8 carriage"):
        SellSpaceShared(levels, 32, _Stub((2, 2), ("lvl", "blocks")),
                        feature_dtype="int8")


# -- the transposed step -----------------------------------------------------

@pytest.mark.parametrize("graph", ["directed", "dinv_a", "sym"])
def test_transposed_step_is_the_whole_step_transposed(pool4, graph):
    """The transposed step of the K-copy step against the dense matrix
    of the whole forward step (every unit vector of the global carriage,
    K copies and tier padding included), transposed; each group packs
    its level transposed on the directed graph and ``D⁻¹A`` and nothing
    on the symmetric one."""
    n = 128
    a = barabasi_albert(n, 3, seed=43, directed=True).astype(np.float32)
    if graph == "dinv_a":
        deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
        a = (sparse.diags(1.0 / deg) @ a).tocsr().astype(np.float32)
    elif graph == "sym":
        a = barabasi_albert(n, 3, seed=1).astype(np.float32)
    levels = jax_decomp(a, 16, max_levels=2, block_diagonal=True, seed=2)
    got = _run(pool4, "space_dense", "sell_space", levels, 16, 5, 3, {},
               *SPACE)
    dense, g = got[0]["dense"], got[0]["g"]
    assert relative_error(got[0]["got"], dense.T @ g) <= relative_tolerance(
        a.nnz / n, 1)
    for r, res in enumerate(got):
        assert res["packed"] == ([] if graph == "sym" else [r // 2])
        assert (res["bytes"] == 0) == (graph == "sym")

"""The port's comparison baselines (``parallel/spmm_1d.py``,
``parallel/spmm_15d.py``) against the JAX package's on a mesh of the
same size.

The counterparts of ``tests/test_baselines.py`` (and of the prime n=47
ragged case of ``tests/test_mesh_sizes.py``): the port's executors run
on gloo ranks on the CPU (module-scoped pools of 4, 3 and 2), the JAX
executors on the conftest's virtual CPU devices at the same mesh shape.
Every result is within ``rtol=atol=1e-5`` of ``a @ x`` (the iterated
cases keep the JAX tests' 1e-4); every rank's packed arrays and
exchange tables equal the JAX shard of its slice or cell byte for byte;
``ideal_comm_bytes``, ``predicted_hbm_bytes`` and ``shard_report`` equal
JAX's values.
"""

import os
import sys

import numpy as np
import pytest
from scipy import sparse

from arrow_matrix_tpu.parallel.mesh import make_mesh as jax_mesh
from arrow_matrix_tpu.parallel.spmm_15d import SpMM15D as JaxSpMM15D
from arrow_matrix_tpu.parallel.spmm_1d import MatrixSlice1D as JaxSlice1D
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.parallel.spmm_15d import largest_replication
from arrow_matrix_tpu_torch.parallel.spmm_1d import equal_slices
from arrow_matrix_tpu_torch.utils.graphs import random_csr, random_dense

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_baseline_jobs"
JOB_S = 120


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool3():
    with RankPool(3, device="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", timeout_s=60) as pool:
        yield pool


@pytest.fixture
def pools(pool4, pool3, pool2):
    return {4: pool4, 3: pool3, 2: pool2}


def _random_square(n, nnz_per_row, seed):
    return random_csr(n, n, nnz_per_row, seed=seed).astype(np.float32)


def _scaled(a):
    return (a / max(abs(a).sum(axis=1).max(), 1.0)).tocsr().astype(
        np.float32)


def _run_1d(pool, a, x, steps=1, **kw):
    return pool.run(JOBS, "slice_1d", a, x, steps, kw, job_timeout_s=JOB_S)


def _run_15d(pool, a, x, grid, steps=1, **kw):
    return pool.run(JOBS, "spmm_15d", a, x, steps, grid, kw,
                    job_timeout_s=JOB_S)


def _check_1d_against_jax(ranks, jax_exe, k):
    """Every rank's packing and tables equal JAX's shard of its slice;
    the reports equal JAX's."""
    assert ranks[0]["slices"] == jax_exe.slices
    for d, r in enumerate(ranks):
        assert r["slot"] == jax_exe.slot and r["l_rows"] == jax_exe.l_rows
        for name in ("l_cols", "l_data", "nl_cols", "nl_data"):
            want = np.asarray(getattr(jax_exe, name))[d]
            got = r["packed"][name]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == want.tobytes(), name
        want = np.asarray(jax_exe.send_idx)[d, 0]
        assert r["packed"]["send_idx"].tobytes() == want.tobytes()
        assert r["ideal"] == jax_exe.ideal_comm_bytes(k)
        assert r["hbm"] == jax_exe.predicted_hbm_bytes(k)
    _same_report(ranks[0]["report"], jax_exe.shard_report())


def _check_15d_against_jax(ranks, jax_exe, k):
    cols = np.asarray(jax_exe.a_cols)
    data = np.asarray(jax_exe.a_data)
    for r in ranks:
        i, j = r["cell"]
        assert r["rounds"] == jax_exe.rounds
        assert r["packed"]["a_cols"].tobytes() == cols[i, j].tobytes()
        assert r["packed"]["a_data"].tobytes() == data[i, j].tobytes()
        assert r["packed"]["a_cols"].shape == cols[i, j].shape
        assert r["ideal"] == jax_exe.ideal_comm_bytes(k)
        assert r["hbm"] == jax_exe.predicted_hbm_bytes(k)
    _same_report(ranks[0]["report"], jax_exe.shard_report())


def _same_report(got, want):
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, float):
            assert got[key] == pytest.approx(v), key
        else:
            assert got[key] == v, key


# -- SpMM15D ------------------------------------------------------------------

class TestSpMM15D:
    @pytest.mark.parametrize("grid", [(4, 1), (2, 2), (2, 1)])
    @pytest.mark.parametrize("n,k", [(64, 8), (97, 5)])
    def test_matches_host(self, pools, grid, n, k):
        c = grid[1]
        a = _random_square(n, 4, seed=n + c)
        x = random_dense(n, k, seed=1)
        ranks = _run_15d(pools[grid[0] * grid[1]], a, x, grid)
        np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_15d_against_jax(
            ranks, JaxSpMM15D(a, jax_mesh(grid, ("rows", "repl"))), k)
        # One broadcast a round, and with c > 1 one all-reduce.
        st = ranks[0]["stats"]
        assert st["broadcast"]["count"] == (grid[0] > 1) * ranks[0]["rounds"]
        assert st["all-reduce"]["count"] == int(c > 1)
        assert ranks[0]["launches"] == {"K1": ranks[0]["rounds"], "K4": 0,
                                        "K4 add": 0}

    @pytest.mark.parametrize("implicit_ones", [False, True])
    def test_memmapped_triplet_build_matches_scipy(self, pool4, tmp_path,
                                                   implicit_ones):
        """Built from a memmapped npy CSR triplet, bit-identical to the
        in-memory build (and to JAX's)."""
        a = _random_square(96, 4, seed=17)
        if implicit_ones:
            a.data[:] = 1.0
        np.save(tmp_path / "d.npy", a.data)
        np.save(tmp_path / "i.npy", a.indices)
        np.save(tmp_path / "p.npy", a.indptr)
        triplet = (
            None if implicit_ones
            else np.load(tmp_path / "d.npy", mmap_mode="r"),
            np.load(tmp_path / "i.npy", mmap_mode="r"),
            np.load(tmp_path / "p.npy", mmap_mode="r"))
        x = random_dense(96, 4, seed=3)
        mem = _run_15d(pool4, a, x, (2, 2))
        mm = _run_15d(pool4, triplet, x, (2, 2))
        for r_mem, r_mm in zip(mem, mm):
            for name in ("a_cols", "a_data"):
                assert (r_mm["packed"][name].tobytes()
                        == r_mem["packed"][name].tobytes())
        np.testing.assert_allclose(mm[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_15d_against_jax(
            mm, JaxSpMM15D(triplet, jax_mesh((2, 2), ("rows", "repl"))), 4)

    def test_replicas_identical(self, pool4):
        a = _random_square(64, 3, seed=3)
        x = random_dense(64, 4, seed=2)
        ranks = _run_15d(pool4, a, x, (2, 2))
        by_cell = {r["cell"]: r["block"] for r in ranks}
        for i in range(2):
            assert by_cell[(i, 0)].tobytes() == by_cell[(i, 1)].tobytes()

    def test_iterated(self, pool4):
        a = _scaled(_random_square(48, 3, seed=5))
        x = random_dense(48, 4, seed=4)
        ranks = _run_15d(pool4, a, x, (2, 2), steps=4)
        want = x
        for _ in range(4):
            want = a @ want
        np.testing.assert_allclose(ranks[0]["out"], want, rtol=1e-4,
                                   atol=1e-5)

    def test_replication_validation(self, pool4, pool2):
        """rows not divisible by repl (the reference's P % c**2 rule)
        raises on every rank, as JAX's (2, 4) grid does."""
        a = _random_square(32, 3, seed=1)
        with pytest.raises(ValueError):
            JaxSpMM15D(a, jax_mesh((2, 4), ("rows", "repl")))
        for pool, grid in ((pool4, (1, 4)), (pool2, (1, 2))):
            msgs = pool.run(JOBS, "refused", "15d", a, grid, {},
                            job_timeout_s=JOB_S)
            assert all(m and "not divisible by replication" in m
                       for m in msgs)

    def test_largest_replication(self):
        for n_dev in (1, 4, 8, 16, 6):
            from arrow_matrix_tpu.parallel.spmm_15d import (
                largest_replication as jax_largest,
            )

            assert largest_replication(n_dev) == jax_largest(n_dev)
        assert largest_replication(16) == 4


# -- MatrixSlice1D ------------------------------------------------------------

class TestMatrixSlice1D:
    @pytest.mark.parametrize("n_dev", [2, 3, 4])
    @pytest.mark.parametrize("n,k,seed", [(64, 8, 0), (97, 5, 1), (33, 3, 2)])
    def test_matches_host(self, pools, n_dev, n, k, seed):
        a = _random_square(n, 4, seed=seed)
        x = random_dense(n, k, seed=seed)
        ranks = _run_1d(pools[n_dev], a, x)
        np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_1d_against_jax(ranks, JaxSlice1D(
            a, jax_mesh((n_dev,), ("slices",))), k)
        r0 = ranks[0]
        if r0["slot"]:
            # One fixed-slot all-to-all a step, of (P-1) slots of k f32.
            a2a = r0["stats"]["all-to-all"]
            assert a2a["count"] == 1
            assert a2a["bytes"] == (n_dev - 1) * r0["slot"] * k * 4
            assert r0["launches"]["K4"] == 1

    @pytest.mark.parametrize("n_dev", [2, 3, 4])
    def test_prime_rows_all_sizes(self, pools, n_dev):
        """The prime row count of ``test_mesh_sizes.py``: ragged slices
        on every mesh size."""
        n, k = 47, 4
        a = _random_square(n, 4, seed=n_dev)
        x = random_dense(n, k, seed=4)
        ranks = _run_1d(pools[n_dev], a, x)
        np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_1d_against_jax(ranks, JaxSlice1D(
            a, jax_mesh((n_dev,), ("slices",))), k)

    def test_per_slice_sources_match_global_build(self, pool4, tmp_path):
        """Built from per-slice npz files (each rank loads only its own;
        the metadata summed over the ranks) == the global-matrix build,
        table for table."""
        n, k = 97, 5
        a = _random_square(n, 4, seed=21)
        x = random_dense(n, k, seed=21)
        ref = _run_1d(pool4, a, x)
        paths = []
        for d, (lo, hi) in enumerate(ref[0]["slices"]):
            p = str(tmp_path / f"g.part.4.slice.{d}.npz")
            sparse.save_npz(p, a[lo:hi].tocsr())
            paths.append(p)
        got = _run_1d(pool4, paths, x)
        assert got[0]["slices"] == ref[0]["slices"]
        for r_got, r_ref in zip(got, ref):
            assert r_got["slot"] == r_ref["slot"]
            for name, arr in r_ref["packed"].items():
                assert r_got["packed"][name].tobytes() == arr.tobytes(), name
        np.testing.assert_allclose(got[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_1d_against_jax(got, JaxSlice1D(
            paths, jax_mesh((4,), ("slices",))), k)

    def test_per_slice_sources_unequal_with_empty(self, pool4):
        """Per-slice sources with ragged and zero-row slices, the slices
        derived from the sources' row counts."""
        n, k = 33, 4
        bounds = [0, 0, 5, 21, 33]
        a = _random_square(n, 5, seed=9)
        x = random_dense(n, k, seed=9)
        sources = [a[bounds[i]:bounds[i + 1]].tocsr() for i in range(4)]
        ranks = _run_1d(pool4, sources, x)
        assert ranks[0]["slices"] == [(0, 0), (0, 5), (5, 21), (21, 33)]
        np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_1d_against_jax(ranks, JaxSlice1D(
            sources, jax_mesh((4,), ("slices",))), k)

    def test_per_slice_sources_width_mismatch_raises(self, pool4):
        a = _random_square(64, 4, seed=3)
        srcs = [a[lo:hi, :32].tocsr() for lo, hi in equal_slices(64, 4)]
        with pytest.raises(ValueError):
            JaxSlice1D(srcs, jax_mesh((4,), ("slices",)))
        msgs = pool4.run(JOBS, "refused", "1d", srcs, 4, {},
                         job_timeout_s=JOB_S)
        assert all(m and "total rows" in m for m in msgs)

    def test_identity(self, pool4):
        n, k = 40, 6
        a = sparse.identity(n, format="csr", dtype=np.float32)
        x = random_dense(n, k, seed=3)
        ranks = _run_1d(pool4, a, x)
        np.testing.assert_allclose(ranks[0]["out"], x, rtol=1e-6, atol=1e-6)
        # No off-slice columns: no exchange slots, no exchange, no pack.
        assert all(r["slot"] == 0 for r in ranks)
        assert ranks[0]["stats"]["total_bytes"] == 0
        assert ranks[0]["launches"]["K4"] == 0
        _check_1d_against_jax(ranks, JaxSlice1D(
            a, jax_mesh((4,), ("slices",))), k)

    def test_unequal_slices_with_empty(self, pool4):
        n, k = 33, 4
        bounds = [0, 0, 5, 21, 33]
        slices = [(bounds[i], bounds[i + 1]) for i in range(4)]
        a = _random_square(n, 5, seed=7)
        x = random_dense(n, k, seed=7)
        ranks = _run_1d(pool4, a, x, slices=slices)
        np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_1d_against_jax(ranks, JaxSlice1D(
            a, jax_mesh((4,), ("slices",)), slices=slices), k)

    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("nnz_per_row", [1, 3, 8])
    def test_density_sweep(self, pool4, seed, nnz_per_row):
        n, k = 56, 4
        a = _random_square(n, nnz_per_row, seed=seed)
        x = random_dense(n, k, seed=seed)
        ranks = _run_1d(pool4, a, x)
        np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-5,
                                   atol=1e-5)
        _check_1d_against_jax(ranks, JaxSlice1D(
            a, jax_mesh((4,), ("slices",))), k)

    def test_iterated(self, pool4):
        n, k = 64, 4
        a = _scaled(_random_square(n, 3, seed=9))
        x = random_dense(n, k, seed=9)
        ranks = _run_1d(pool4, a, x, steps=3)
        want = x
        for _ in range(3):
            want = a @ want
        np.testing.assert_allclose(ranks[0]["out"], want, rtol=1e-4,
                                   atol=1e-5)


def test_matrix_slice_1d_auto_chunk_and_validation(pool4):
    """chunk='auto' sizes the plain version's gather bound from the free
    memory net of the resident blocks and still computes exactly; bad
    fractions are refused on every rank."""
    a = random_csr(256, 256, 6, seed=5)
    x = random_dense(256, 8, seed=1)
    ranks = _run_1d(pool4, a, x, chunk="auto")
    assert ranks[0]["chunk"][0] == "auto" and ranks[0]["chunk"][1] > 0
    np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-4, atol=1e-5)
    for frac in (0.0, 1.5):
        msgs = pool4.run(JOBS, "refused", "1d", a, 4,
                         dict(chunk="auto", memory_fraction=frac),
                         job_timeout_s=JOB_S)
        assert all(m and "memory_fraction" in m for m in msgs)


def test_spmm_15d_auto_chunk(pool4):
    a = random_csr(256, 256, 6, seed=8)
    x = random_dense(256, 8, seed=2)
    ranks = _run_15d(pool4, a, x, (2, 2), chunk="auto")
    np.testing.assert_allclose(ranks[0]["out"], a @ x, rtol=1e-4, atol=1e-5)
    msgs = pool4.run(JOBS, "refused", "15d", a, (2, 2),
                     dict(chunk="auto", memory_fraction=2.0),
                     job_timeout_s=JOB_S)
    assert all(m and "memory_fraction" in m for m in msgs)


@pytest.mark.parametrize("chunk", [8, 16])
def test_explicit_chunk_bounds_the_plain_gather(pool4, chunk):
    """An explicit slot chunk (the plain version's gather bound) gives
    the same result as one gather of every slot."""
    a = _random_square(80, 24, seed=13)
    x = random_dense(80, 4, seed=13)
    whole = _run_1d(pool4, a, x)[0]["out"]
    got = _run_1d(pool4, a, x, chunk=chunk)[0]["out"]
    np.testing.assert_allclose(got, whole, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, a @ x, rtol=1e-5, atol=1e-5)


def test_slice_padding_tool_counts_the_built_slot_counts(pool4):
    """``tools/slice_padding`` reads the shared slot counts off the
    sparsity pattern; a built ``MatrixSlice1D`` packs exactly those."""
    from arrow_matrix_tpu_torch.tools.slice_padding import slice_needs
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    a = barabasi_albert(512, 4, seed=7).astype(np.float32)
    got = slice_needs(a, 4)
    ranks = _run_1d(pool4, a, random_dense(512, 4, seed=0))
    assert ranks[0]["packed"]["l_cols"].shape[1] == got["m_l"]
    assert ranks[0]["packed"]["nl_cols"].shape[1] == got["m_nl"]
    assert got["needs"][0][0] > got["needs"][-1][0]    # the hub slice
    rows = ranks[0]["l_rows"]
    assert got["padded_bytes"] == 4 * rows * (got["m_l"] + got["m_nl"]) * 8

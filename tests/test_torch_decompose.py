"""The port's own copies of the decomposer and the artifact I/O against
the JAX package: identical levels for one seed, and the same files
written and read in both directions."""

import filecmp
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decompose
from arrow_matrix_tpu.io import as_levels as jax_as_levels
from arrow_matrix_tpu.io import load_decomposition as jax_load
from arrow_matrix_tpu.io import save_decomposition as jax_save
from arrow_matrix_tpu.utils import numerics as jax_numerics
from arrow_matrix_tpu_torch.decomposition import (
    arrow_decomposition,
    decomposition_spmm,
    reconstruct,
)
from arrow_matrix_tpu_torch.io import (
    as_levels,
    load_decomposition,
    load_level_widths,
    save_decomposition,
)
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)


def _same_levels(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.arrow_width == b.arrow_width
        assert np.array_equal(a.permutation, b.permutation)
        for field in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(a.matrix, field),
                                  getattr(b.matrix, field))


@pytest.mark.parametrize("block_diagonal", [True, False])
def test_levels_identical_to_jax_numpy_backend(block_diagonal):
    a = barabasi_albert(512, 3, seed=11)
    ours = arrow_decomposition(a, 32, max_levels=10,
                               block_diagonal=block_diagonal, seed=4)
    theirs = jax_decompose(a, 32, max_levels=10,
                           block_diagonal=block_diagonal, seed=4,
                           backend="numpy")
    _same_levels(ours, theirs)
    assert (reconstruct(ours) != a).nnz == 0


def test_native_backend_runs_and_equals_jax():
    a = barabasi_albert(512, 3, seed=11)
    ours = arrow_decomposition(a, 32, max_levels=10, block_diagonal=True,
                               seed=4, backend="native")
    theirs = jax_decompose(a, 32, max_levels=10, block_diagonal=True,
                           seed=4, backend="native")
    _same_levels(ours, theirs)
    assert (reconstruct(ours) != a).nnz == 0


def test_committed_artifact_loads_in_the_port(ba_256_3_base):
    ours = load_decomposition(ba_256_3_base, 32, block_diagonal=True)
    theirs = jax_load(ba_256_3_base, 32, block_diagonal=True)
    widths = load_level_widths(ba_256_3_base, 32, True)
    ours, theirs = as_levels(ours, widths), jax_as_levels(theirs, widths)
    _same_levels(ours, theirs)
    x = random_dense(256, 8, seed=1)
    a = reconstruct(ours)
    assert relative_error(decomposition_spmm(ours, x), a @ x) <= \
        relative_tolerance(a.nnz / 256)


def test_port_artifact_is_the_jax_artifact(tmp_path):
    a = barabasi_albert(300, 3, seed=2)
    levels = arrow_decomposition(a, 32, max_levels=4, block_diagonal=True,
                                 seed=1)
    save_decomposition(levels, str(tmp_path / "ours" / "g"))
    jax_save(levels, str(tmp_path / "theirs" / "g"))
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "ours", tmp_path / "theirs", names, shallow=False)
    assert not mismatch and not errors
    loaded = jax_as_levels(jax_load(str(tmp_path / "ours" / "g"), 32),
                           load_level_widths(str(tmp_path / "ours" / "g"),
                                             32))
    _same_levels(levels, loaded)


def test_numerics_match_jax():
    for nnz, iters in ((1, 1), (16.0, 1), (16.0, 10), (300.5, 3)):
        assert relative_tolerance(nnz, iters) == \
            jax_numerics.relative_tolerance(nnz, iters)
    x, y = random_dense(20, 3, seed=0), random_dense(20, 3, seed=1)
    assert relative_error(x, y) == jax_numerics.relative_error(x, y)


# -- the reference's decomposition inputs: erdos_renyi, grid_graph -----------

@pytest.mark.parametrize("n,p,seed,directed", [
    (64, 0.1, 0, False), (128, 0.2, 3, False), (300, 0.05, 11, False),
    (128, 0.2, 3, True), (17, 0.5, None, False)])
def test_erdos_renyi_bytes_equal_jax(n, p, seed, directed):
    from arrow_matrix_tpu.utils.graphs import erdos_renyi as jax_er
    from arrow_matrix_tpu_torch.utils import erdos_renyi

    if seed is None:           # unseeded draws differ: compare shapes
        assert erdos_renyi(n, p).shape == jax_er(n, p).shape == (n, n)
        return
    ours, theirs = (f(n, p, seed=seed, directed=directed)
                    for f in (erdos_renyi, jax_er))
    for field in ("indptr", "indices", "data"):
        assert getattr(ours, field).tobytes() == \
            getattr(theirs, field).tobytes()
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape


@pytest.mark.parametrize("side", [1, 2, 5, 32, 100])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_graph_bytes_equal_jax(side, dtype):
    from arrow_matrix_tpu.utils.graphs import grid_graph as jax_grid
    from arrow_matrix_tpu_torch.utils import grid_graph

    ours, theirs = grid_graph(side, dtype), jax_grid(side, dtype)
    for field in ("indptr", "indices", "data"):
        assert getattr(ours, field).tobytes() == \
            getattr(theirs, field).tobytes()
    assert ours.dtype == theirs.dtype and ours.shape == (side * side,) * 2


def _scrambled_grid(side):
    from arrow_matrix_tpu_torch.utils import grid_graph

    g = grid_graph(side)
    shuf = np.random.default_rng(3).permutation(g.shape[0])
    return g[shuf][:, shuf].tocsr()


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_banded_grid_is_one_identity_level(backend):
    """``tests/test_decomposition.py::test_banded_input_fast_path``: the
    row-major grid is one identity-permutation level; the JAX levels."""
    from arrow_matrix_tpu_torch.utils import grid_graph

    a = grid_graph(32)
    levels = arrow_decomposition(a, 64, max_levels=8, block_diagonal=True,
                                 seed=0, backend=backend)
    assert len(levels) == 1
    np.testing.assert_array_equal(levels[0].permutation, np.arange(1024))
    assert levels[0].arrow_width <= 64
    _same_levels(levels, jax_decompose(a, 64, max_levels=8,
                                       block_diagonal=True, seed=0,
                                       backend=backend))
    x = random_dense(1024, 4, seed=1)
    np.testing.assert_allclose(decomposition_spmm(levels, x),
                               np.asarray(a @ x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_scrambled_grid_is_one_rcm_level(backend):
    """``tests/test_decomposition.py::test_bandable_input_rcm_fast_path``:
    a scrambled grid is re-banded into one level; the JAX levels."""
    gs = _scrambled_grid(32)
    levels = arrow_decomposition(gs, 64, max_levels=8, block_diagonal=True,
                                 seed=0, backend=backend)
    assert len(levels) == 1
    coo = levels[0].matrix.tocoo()
    assert int(np.abs(coo.row.astype(np.int64) - coo.col).max()) <= 64
    _same_levels(levels, jax_decompose(gs, 64, max_levels=8,
                                       block_diagonal=True, seed=0,
                                       backend=backend))
    x = random_dense(gs.shape[0], 4, seed=1)
    np.testing.assert_allclose(decomposition_spmm(levels, x),
                               np.asarray(gs @ x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_last_level_keeps_every_nonzero(backend):
    """``tests/test_decomposition.py::test_last_level_keeps_everything``
    on the port's ``erdos_renyi``; the JAX levels."""
    from arrow_matrix_tpu_torch.utils import erdos_renyi

    a = erdos_renyi(128, 0.2, seed=3)
    levels = arrow_decomposition(a, 16, max_levels=2, block_diagonal=True,
                                 seed=0, backend=backend)
    assert len(levels) <= 2
    assert sum(lv.matrix.nnz for lv in levels) == a.nnz
    _same_levels(levels, jax_decompose(a, 16, max_levels=2,
                                       block_diagonal=True, seed=0,
                                       backend=backend))


@pytest.mark.parametrize("graph", ["ba", "grid", "scrambled"])
def test_inverse_permutation_equals_jax(graph):
    """``ArrowLevel.inverse_permutation`` on every level, beside JAX's,
    and it inverts the permutation."""
    from arrow_matrix_tpu_torch.utils import grid_graph

    a = {"ba": lambda: barabasi_albert(300, 3, seed=2),
         "grid": lambda: grid_graph(16),
         "scrambled": lambda: _scrambled_grid(16)}[graph]()
    ours = arrow_decomposition(a, 24, max_levels=4, block_diagonal=True,
                               seed=1)
    theirs = jax_decompose(a, 24, max_levels=4, block_diagonal=True, seed=1,
                           backend="numpy")
    for x, y in zip(ours, theirs):
        inv = x.inverse_permutation
        assert np.array_equal(inv, y.inverse_permutation)
        assert np.array_equal(x.permutation[inv], np.arange(a.shape[0]))

"""The port's native (C++) decomposer against the JAX package's: the same
source, the same random draws, so every order, structure and level is
equal array for array; and its build lands in the port's ``_build/``."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import sparse

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decompose
from arrow_matrix_tpu.decomposition import native as jax_native
from arrow_matrix_tpu_torch.decomposition import (
    arrow_decomposition,
    decomposition_spmm,
    native,
    reconstruct,
)
from arrow_matrix_tpu_torch.decomposition.decompose import resolved_backend
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
    symmetrize,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _needs_the_native_library():
    if not (native.available() and jax_native.available()):
        pytest.skip(f"native decomposer unavailable: {native.load_error()}")


def _sym(n, m, seed):
    return symmetrize(barabasi_albert(n, m, seed=seed))


def _degenerate():
    """The graphs of the JAX package's degenerate-graph test: no edges,
    and two disjoint components."""
    empty = sparse.csr_matrix((16, 16), dtype=np.float32)
    two = sparse.block_diag([_sym(40, 2, 2), _sym(30, 2, 3)], format="csr")
    return [empty, two]


GRAPHS = {"ba777": lambda: _sym(777, 3, 1), "ba3001": lambda: _sym(3001, 4, 5),
          "empty": lambda: _degenerate()[0], "two": lambda: _degenerate()[1]}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_orders_equal_jax(graph):
    a = GRAPHS[graph]()
    for seed in (0, 9):
        assert np.array_equal(
            native.random_forest_order(a, np.random.default_rng(seed)),
            jax_native.random_forest_order(a, np.random.default_rng(seed)))
    for base in (2, 16):
        assert np.array_equal(native.bfs_order(a, base),
                              jax_native.bfs_order(a, base))
    deg = np.diff(a.indptr)
    active = np.argsort(-deg, kind="stable")[min(4, a.shape[0]):]
    ours = native.random_forest_order_masked(a, active,
                                             np.random.default_rng(3), 8)
    theirs = jax_native.random_forest_order_masked(
        a, active, np.random.default_rng(3), 8)
    assert np.array_equal(ours, theirs)
    assert np.array_equal(np.sort(ours), np.arange(active.size))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_symmetrize_structure_equals_jax(graph):
    a = GRAPHS[graph]()
    directed = sparse.triu(a, format="csr")      # asymmetric input
    for m in (a, directed):
        ours = native.symmetrize_structure(m)
        theirs = jax_native.symmetrize_structure(m)
        assert np.array_equal(ours[0], theirs[0])
        assert np.array_equal(ours[1], theirs[1])
        want = symmetrize(m)
        assert np.array_equal(ours[0], want.indptr.astype(np.int64))
        assert np.array_equal(ours[1], want.indices.astype(np.int32))


@pytest.mark.parametrize("block_diagonal,prune",
                         [(True, True), (False, True), (True, False)])
def test_level_split_weighted_with_duplicates_equals_jax(block_diagonal,
                                                          prune):
    rng = np.random.default_rng(2)
    n, width, nnz = 3001, 128, 30_000
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    rows[:500], cols[:500] = rows[500:1000], cols[500:1000]   # duplicates
    vals = rng.standard_normal(nnz)
    a = sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))  # not summed
    a.has_canonical_format = False
    inv = np.argsort(rng.permutation(n)).astype(np.int32)
    lvl, rest = native.level_split(a, inv, width, block_diagonal, prune)
    jlvl, jrest = jax_native.level_split(a, inv, width, block_diagonal,
                                         prune)
    assert lvl.data.dtype == np.float64
    for ours, theirs in ((lvl, jlvl), (rest, jrest)):
        for field in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(ours, field),
                                  getattr(theirs, field))
    # Together they keep every edge of A.
    p = np.argsort(inv)
    back = sparse.csr_matrix(
        (lvl.tocoo().data, (p[lvl.tocoo().row], p[lvl.tocoo().col])),
        shape=(n, n)) + rest
    assert abs(back - a).max() < 1e-12


def test_threads_do_not_change_the_output(monkeypatch):
    """Above the C++'s parallel threshold (2^16 rows) 1 and 4 threads
    give the same arrays, equal to the JAX package's."""
    a = _sym(1 << 17, 3, 9)
    deg = np.diff(a.indptr)
    middle = np.argsort(-deg, kind="stable")[256:]
    middle = middle[deg[middle] > 0]
    runs = []
    for threads in ("1", "4"):
        monkeypatch.setenv("AMT_DECOMP_THREADS", threads)
        runs.append((native.random_forest_order_masked(
            a, middle, np.random.default_rng(4)),
            native.symmetrize_structure(a)))
    theirs = jax_native.random_forest_order_masked(
        a, middle, np.random.default_rng(4))
    (o1, s1), (o4, s4) = runs
    assert np.array_equal(o1, o4) and np.array_equal(o1, theirs)
    assert np.array_equal(s1[0], s4[0]) and np.array_equal(s1[1], s4[1])


@pytest.mark.parametrize("block_diagonal", [True, False])
def test_native_levels_byte_equal_jax(block_diagonal):
    a = barabasi_albert(3001, 4, seed=7)
    ours = arrow_decomposition(a, 64, max_levels=12,
                               block_diagonal=block_diagonal, seed=5,
                               backend="native")
    theirs = jax_decompose(a, 64, max_levels=12,
                           block_diagonal=block_diagonal, seed=5,
                           backend="native")
    assert len(ours) == len(theirs) > 1
    for x, y in zip(ours, theirs):
        assert x.arrow_width == y.arrow_width
        assert np.array_equal(x.permutation, y.permutation)
        for field in ("indptr", "indices", "data"):
            assert getattr(x.matrix, field).tobytes() == \
                getattr(y.matrix, field).tobytes()
    assert (reconstruct(ours) != a).nnz == 0
    xs = random_dense(3001, 4, seed=1)
    assert relative_error(decomposition_spmm(ours, xs), a @ xs) <= \
        relative_tolerance(a.nnz / 3001)


def test_auto_resolves_to_native_and_unknown_backend_raises():
    assert resolved_backend("auto") == "native"
    assert resolved_backend("numpy") == "numpy"
    a = barabasi_albert(777, 3, seed=1)
    auto = arrow_decomposition(a, 32, max_levels=6, seed=2, backend="auto")
    nat = arrow_decomposition(a, 32, max_levels=6, seed=2, backend="native")
    assert all(np.array_equal(x.permutation, y.permutation)
               for x, y in zip(auto, nat))
    with pytest.raises(ValueError, match="unknown backend 'julia'"):
        arrow_decomposition(a, 8, backend="julia")
    with pytest.raises(ValueError, match="unknown backend"):
        jax_decompose(a, 8, backend="julia")


def test_library_builds_into_the_ports_build_directory():
    path = native.lib_path()
    assert native.available()
    assert os.path.dirname(path) == os.path.join(
        REPO, "arrow_matrix_tpu_torch", "_build")
    assert os.path.exists(path)
    src_dir = os.path.join(REPO, "arrow_matrix_tpu_torch", "decomposition",
                           "_native")
    assert os.listdir(src_dir) == ["fast_decomp.cpp"]


def test_copied_source_equals_the_jax_source():
    assert filecmp.cmp(
        os.path.join(REPO, "arrow_matrix_tpu_torch", "decomposition",
                     "_native", "fast_decomp.cpp"),
        os.path.join(REPO, "arrow_matrix_tpu", "decomposition", "_native",
                     "fast_decomp.cpp"), shallow=False)


BUILD_CHILD = r"""
import sys
from arrow_matrix_tpu_torch.decomposition import native
native.BUILD_DIR = sys.argv[1]
assert native.available(), native.load_error()
import numpy as np
from arrow_matrix_tpu_torch.utils import barabasi_albert, symmetrize
a = symmetrize(barabasi_albert(300, 3, seed=1))
order = native.random_forest_order(a, np.random.default_rng(0))
print(int(np.sort(order).sum()))
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_CHILD,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(sum(range(300)))
    libs = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert len(libs) == 1 and not any(f.endswith(".tmp")
                                      for f in os.listdir(tmp_path))

"""The port's HYB (split ELL) level and ``fmt="hyb"`` executor against
the JAX package: ``hyb_from_csr`` array for array, the plain product and
K1's form against the JAX ``hyb_spmm``, and whole decompositions over 2
steps against the JAX ``MultiLevelArrow`` and the scipy golden."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from scipy import sparse

from arrow_matrix_tpu.ops import hyb as jax_hyb
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu_torch.decomposition import (
    ArrowLevel,
    arrow_decomposition,
    decomposition_spmm,
)
from arrow_matrix_tpu_torch.ops import cuda_ell, hyb
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)

FIELDS = ("light_cols", "light_data", "light_deg", "heavy_idx",
          "heavy_cols", "heavy_data", "heavy_deg")


def _hub_graph(n, seed, weighted, hub=300):
    """BA(n, 3) with row/column 0 joined to ``hub`` others (a heavy
    row), ones or weights off the bf16 grid."""
    a = barabasi_albert(n, 3, seed=seed).tolil()
    a[0, 1:hub + 1] = 1
    a[1:hub + 1, 0] = 1
    a = a.tocsr()
    if weighted:
        a.data = np.random.default_rng(seed).uniform(
            0.5, 1.5, a.nnz).astype(np.float32)
    return a


def _assert_level_equal(ours, theirs):
    assert ours.n_rows == theirs.n_rows and ours.binary == theirs.binary
    for f in FIELDS:
        got, want = getattr(ours, f), getattr(theirs, f)
        assert (got is None) == (want is None), f
        if got is None:
            continue
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16)), f
            continue
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f


@pytest.mark.parametrize("n", [777, 1000])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("heavy_cap", [None, 4, 0])
def test_hyb_from_csr_is_array_equal_to_jax(n, weighted, heavy_cap):
    a = _hub_graph(n, seed=n, weighted=weighted)
    ours = hyb.hyb_from_csr(a, pad_rows_to=1024, heavy_cap=heavy_cap,
                            device="cpu")
    theirs = jax_hyb.hyb_from_csr(a, pad_rows_to=1024, heavy_cap=heavy_cap)
    _assert_level_equal(ours, theirs)
    # heavy_cap=0 puts every row in the light ELL.
    assert (ours.heavy_idx.shape[0] > 0) == (heavy_cap != 0)
    got, want = hyb.hyb_stats(ours), jax_hyb.hyb_stats(theirs)
    assert got == want
    x = random_dense(1024, 5, seed=1)
    want = np.asarray(jax_hyb.hyb_spmm(theirs, jnp.asarray(x)))
    tol = relative_tolerance(300)
    for chunk in (None, 8):
        got = hyb.hyb_spmm(ours, torch.from_numpy(x), chunk=chunk,
                           heavy_chunk=chunk)
        assert relative_error(got.numpy(), want) <= tol
    got = cuda_ell.hyb_spmm_k1(ours, torch.from_numpy(x))
    assert relative_error(got.numpy(), want) <= tol
    assert relative_error(got[:n].numpy(), a @ x[:n]) <= tol


def test_hyb_from_a_triplet_and_in_bf16_follows_jax():
    a = _hub_graph(500, seed=3, weighted=True)
    triplet = (a.data, a.indices, a.indptr)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        ours = hyb.hyb_from_csr(triplet, dtype=dtype, device="cpu")
        theirs = jax_hyb.hyb_from_csr(triplet, dtype=dtype)
        _assert_level_equal(ours, theirs)
    ones = (None, a.indices, a.indptr)       # implicit ones: binary
    ours = hyb.hyb_from_csr(ones, device="cpu")
    _assert_level_equal(ours, jax_hyb.hyb_from_csr(ones))
    assert ours.binary
    with pytest.raises(ValueError, match="non-unit"):
        hyb.hyb_from_csr(a, binary=True, device="cpu")


def test_light_slots_follow_jax():
    rng = np.random.default_rng(0)
    for size in (0, 1, 5, 1000):
        degrees = rng.integers(0, 300, size)
        for cap in (0, 3, 512, 5000):
            assert hyb.choose_light_slots(degrees, cap) == \
                jax_hyb.choose_light_slots(degrees, cap)


def test_a_level_without_heavy_rows():
    a = sparse.random(300, 300, density=0.01, random_state=1,
                      dtype=np.float32).tocsr()
    ours = hyb.hyb_from_csr(a, device="cpu")
    theirs = jax_hyb.hyb_from_csr(a)
    _assert_level_equal(ours, theirs)
    assert ours.heavy_idx.shape == (0,) and not ours.binary
    x = torch.from_numpy(random_dense(300, 3, seed=2))
    assert "heavy" not in cuda_ell.hyb_operands(ours)
    assert relative_error(cuda_ell.hyb_spmm_k1(ours, x).numpy(),
                          a @ x.numpy()) <= relative_tolerance(8)


@pytest.mark.parametrize("n,width,k,block_diagonal,weighted", [
    (777, 32, 3, True, False),
    (1000, 64, 5, False, True),
    (1000, 32, 33, True, True),
    (777, 64, 5, False, False),
])
def test_hyb_executor_matches_jax_over_two_steps(n, width, k,
                                                 block_diagonal, weighted):
    a = barabasi_albert(n, 3, seed=4)
    levels = arrow_decomposition(a, width, max_levels=3,
                                 block_diagonal=block_diagonal, seed=0)
    if weighted:
        rng = np.random.default_rng(5)
        levels = [ArrowLevel(lvl.matrix.astype(np.float32) * 1.0,
                             lvl.permutation, lvl.arrow_width)
                  for lvl in levels]
        for lvl in levels:
            lvl.matrix.data = rng.uniform(0.5, 1.5, lvl.matrix.nnz).astype(
                np.float32)
    x = random_dense(n, k, seed=6)
    ours = MultiLevelArrow(levels, width, fmt="hyb",
                           banded=not block_diagonal, device="cpu")
    theirs = JaxArrow(levels, width, fmt="hyb", banded=not block_diagonal)
    assert ours.fmts == theirs.fmts == ["hyb"] * len(levels)
    assert ours.total_rows == theirs.total_rows
    assert ours.head_layouts() == [None] * len(levels)
    for ob, tb in zip(ours.blocks, theirs.blocks):
        _assert_level_equal(ob, tb)
    run = (lambda e: e.gather_result(e.run(e.set_features(x), 2)))
    got = run(ours)
    tol = relative_tolerance(ours.nnz / n, 2)
    assert relative_error(got, run(theirs)) <= tol
    golden = decomposition_spmm(levels, decomposition_spmm(levels, x))
    assert relative_error(got, golden) <= tol


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_hyb_spmm_t_matches_jax(k, weighted):
    """The feature-major HYB product ``(level @ x_t.T).T`` against JAX's
    ``hyb_spmm_t``, with heavy rows, binary and weighted."""
    a = _hub_graph(900, seed=5, weighted=weighted)
    ours = hyb.hyb_from_csr(a, pad_rows_to=1024, device="cpu")
    theirs = jax_hyb.hyb_from_csr(a, pad_rows_to=1024)
    assert ours.heavy_idx.shape[0] > 0 and ours.binary == (not weighted)
    x_t = random_dense(k, 1024, seed=k)
    want = np.asarray(jax_hyb.hyb_spmm_t(theirs, jnp.asarray(x_t)))
    tol = relative_tolerance(300)
    for chunk in (None, 8):
        got = hyb.hyb_spmm_t(ours, torch.from_numpy(x_t), chunk=chunk,
                             heavy_chunk=chunk)
        assert tuple(got.shape) == want.shape == (k, 1024)
        assert relative_error(got.numpy(), want) <= tol
    assert relative_error(got[:, :900].numpy().T,
                          a @ x_t[:, :900].T) <= tol

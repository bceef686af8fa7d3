"""The port's dense executor ``MultiLevelArrow(fmt="dense")`` against
the JAX package's (XLA einsums and Pallas kernels in interpret mode) and
the scipy golden, on BA n=512 m=3 at width 64."""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from arrow_matrix_tpu.ops import arrow_blocks as jax_blocks
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu.parallel.multi_level import (
    compose_routing as jax_compose_routing,
)
from arrow_matrix_tpu_torch.convert import arrow_blocks_from_numpy
from arrow_matrix_tpu_torch.decomposition import (
    ArrowLevel,
    arrow_decomposition,
    decomposition_spmm,
)
from arrow_matrix_tpu_torch.ops import arrow_blocks
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow, compose_routing
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

from helpers import arrow_csr

torch.set_num_threads(2)

N, WIDTH = 512, 64

# (block_diagonal decomposition, banded tiling)
LAYOUTS = [(True, False), (False, True)]


@pytest.fixture(scope="module")
def graph():
    return barabasi_albert(N, 3, seed=4)


def _levels(graph, block_diagonal, max_levels=3):
    return arrow_decomposition(graph, WIDTH, max_levels=max_levels,
                               block_diagonal=block_diagonal, seed=0)


def _nnz(levels):
    return sum(lvl.matrix.nnz for lvl in levels)


def _run(executor, x, iters):
    return executor.gather_result(executor.run(executor.set_features(x),
                                               iters))


def _golden(levels, x, iters):
    for _ in range(iters):
        x = decomposition_spmm(levels, x)
    return x


@pytest.mark.parametrize("block_diagonal,banded", LAYOUTS)
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_ten_iterations_match_jax_and_scipy(graph, block_diagonal, banded,
                                            kernel):
    levels = _levels(graph, block_diagonal)
    x = random_dense(N, 16, seed=3)
    ours = MultiLevelArrow(levels, WIDTH, fmt="dense", banded=banded,
                           device="cpu")
    theirs = JaxArrow(levels, WIDTH, fmt="dense", banded=banded,
                      kernel=kernel)
    assert ours.total_rows == theirs.total_rows
    assert ours.widths == theirs.widths
    assert [b.banded for b in ours.blocks] == \
        [b.banded for b in theirs.blocks]
    got = _run(ours, x, 10)
    tol = relative_tolerance(_nnz(levels) / N, 10)
    assert relative_error(got, _run(theirs, x, 10)) <= tol
    assert relative_error(got, _golden(levels, x, 10)) <= tol


@pytest.mark.parametrize("block_diagonal,banded", LAYOUTS)
def test_routing_tables_and_masks_equal_jax(graph, block_diagonal, banded):
    levels = _levels(graph, block_diagonal)
    ours = MultiLevelArrow(levels, WIDTH, fmt="dense", banded=banded,
                           device="cpu")
    theirs = JaxArrow(levels, WIDTH, fmt="dense", banded=banded)
    assert np.array_equal(ours.perm0, theirs.perm0)
    assert ours.fwd.dtype == ours.bwd.dtype == torch.int32
    assert np.array_equal(ours.fwd.numpy(), np.asarray(theirs.fwd))
    assert np.array_equal(ours.bwd.numpy(), np.asarray(theirs.bwd))
    perms = [lvl.permutation for lvl in levels]
    for got, want in zip(compose_routing(perms, ours.total_rows),
                         jax_compose_routing(perms, ours.total_rows)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    mask = ours.real_row_mask()
    assert mask.shape == (ours.total_rows, 1) and mask.dtype == torch.float32
    assert np.array_equal(mask.numpy(), np.asarray(theirs.real_row_mask()))
    with pytest.raises(ValueError, match="fmt='fold'"):
        ours.carried_mask()
    with pytest.raises(ValueError, match="fmt='fold'"):
        ours.export_folded("unused")


@pytest.mark.parametrize("block_diagonal,banded", LAYOUTS)
def test_bf16_blocks_within_2e2_of_jax(graph, block_diagonal, banded):
    levels = _levels(graph, block_diagonal)
    # Weighted values off the bf16 grid, so the block rounding shows.
    rng = np.random.default_rng(5)
    weighted = []
    for lvl in levels:
        m = lvl.matrix.copy()
        m.data = rng.uniform(0.5, 1.5, m.nnz).astype(np.float32)
        weighted.append(ArrowLevel(m, lvl.permutation, lvl.arrow_width))
    x = random_dense(N, 16, seed=4)
    ours = MultiLevelArrow(weighted, WIDTH, fmt="dense", banded=banded,
                           dtype="bf16", device="cpu")
    theirs = JaxArrow(weighted, WIDTH, fmt="dense", banded=banded,
                      dtype="bf16", kernel="pallas")
    for ob, tb in zip(ours.blocks, theirs.blocks):
        assert ob.dtype == torch.bfloat16
        assert np.array_equal(
            ob.diag_data.view(torch.int16).numpy().view(np.uint16),
            np.asarray(tb.diag_data).view(np.uint16))
    got = _run(ours, x, 1)
    assert relative_error(got, _run(theirs, x, 1)) <= 2e-2
    assert relative_error(got, _golden(weighted, x, 1)) <= 2e-2
    assert relative_error(got, _golden(weighted, x, 1)) > 1e-5


def test_grown_last_level_steps_correctly():
    # BA m=6 at width 32 cut at two levels: the last level's achieved
    # width grows to 159, tiled banded at 160.
    a = barabasi_albert(N, 6, seed=4)
    levels = arrow_decomposition(a, 32, max_levels=2, block_diagonal=True,
                                 seed=0)
    assert levels[-1].arrow_width > 32
    x = random_dense(N, 8, seed=6)
    ours = MultiLevelArrow(levels, 32, fmt="dense", device="cpu")
    theirs = JaxArrow(levels, 32, fmt="dense", kernel="pallas")
    assert ours.widths == theirs.widths == [32, 160]
    assert ours.total_rows == theirs.total_rows
    assert ours.total_rows % 160 == 0
    assert ours.blocks[-1].banded and not ours.blocks[0].banded
    tol = relative_tolerance(_nnz(levels) / N, 3)
    got = _run(ours, x, 3)
    assert relative_error(got, _golden(levels, x, 3)) <= tol
    assert relative_error(got, _run(theirs, x, 3)) <= tol


def test_single_level_steps_with_empty_routing(graph):
    levels = _levels(graph, True, max_levels=1)
    assert len(levels) == 1
    ours = MultiLevelArrow(levels, WIDTH, fmt="dense", device="cpu")
    assert ours.fwd.shape == ours.bwd.shape == (0, ours.total_rows)
    x = random_dense(N, 8, seed=7)
    assert relative_error(_run(ours, x, 2), _golden(levels, x, 2)) <= \
        relative_tolerance(_nnz(levels) / N, 2)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_arrow_blocks_from_numpy_round_trips_jax_blocks(banded, dtype):
    a = arrow_csr(4, 16, banded=banded, seed=8)
    theirs = jax_blocks.arrow_blocks_from_csr(a, 16, banded=banded,
                                              fmt="dense", dtype=dtype)
    stacks = [np.asarray(theirs.head_data), np.asarray(theirs.diag_data),
              np.asarray(theirs.col_data)]
    if banded:
        stacks += [np.asarray(theirs.lo_data), np.asarray(theirs.hi_data)]
    if dtype is ml_dtypes.bfloat16:     # as bits, the port's bf16 input
        stacks = [s.view(np.uint16) for s in stacks]
    got = arrow_blocks_from_numpy(*stacks, width=16, banded=banded,
                                  device="cpu")
    want = arrow_blocks.arrow_blocks_from_csr(a, 16, banded=banded,
                                              dtype=dtype, device="cpu")
    assert (got.n_blocks, got.width, got.banded) == (4, 16, banded)
    for name, t in want.stacks().items():
        assert torch.equal(getattr(got, f"{name}_data"), t), name
    x = random_dense(64, 4, seed=9).reshape(4, 16, 4)
    assert np.allclose(
        arrow_blocks.arrow_spmm(got, torch.from_numpy(x)).numpy(),
        np.asarray(jax_blocks.arrow_spmm(theirs, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="banded"):
        arrow_blocks_from_numpy(*stacks[:3], width=16, banded=True,
                                device="cpu")


@pytest.mark.parametrize("block_diagonal,banded", LAYOUTS)
def test_auto_with_room_for_every_level_is_the_dense_executor(
        graph, block_diagonal, banded):
    """The default format densifies every level the budget holds: with
    room for all of them it builds the dense executor, bit for bit, and
    with none the ELL one, as the JAX class resolves them."""
    levels = _levels(graph, block_diagonal)
    x = random_dense(N, 5, seed=11)
    dense = MultiLevelArrow(levels, WIDTH, fmt="dense", banded=banded,
                            device="cpu")
    roomy = MultiLevelArrow(levels, WIDTH, banded=banded,
                            dense_budget=1 << 40, device="cpu")
    none = MultiLevelArrow(levels, WIDTH, banded=banded, dense_budget=0,
                           device="cpu")
    assert roomy.fmts == ["dense"] * len(levels) == JaxArrow(
        levels, WIDTH, banded=banded, dense_budget=1 << 40).fmts
    assert none.fmts == ["ell"] * len(levels) == JaxArrow(
        levels, WIDTH, banded=banded, dense_budget=0).fmts
    assert np.array_equal(_run(roomy, x, 2), _run(dense, x, 2))
    assert relative_error(_run(none, x, 2), _golden(levels, x, 2)) <= \
        relative_tolerance(_nnz(levels) / N, 2)


def test_feature_dtype_needs_the_fold_format(graph):
    levels = _levels(graph, True)
    with pytest.raises(ValueError, match="feature_dtype is implemented "
                                         "for fmt='fold'"):
        MultiLevelArrow(levels, WIDTH, fmt="dense", feature_dtype="bf16",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown fmt"):
        MultiLevelArrow(levels, WIDTH, fmt="sparse", device="cpu")
    fold = MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu")
    with pytest.raises(ValueError, match="dense carriage"):
        fold.real_row_mask()


def test_dense_needs_the_card_unless_asked_for_the_cpu(graph):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLevelArrow(_levels(graph, True), WIDTH, fmt="dense")

"""``SpaceSharedArrow`` (``parallel/space_shared.py``) on gloo ranks
against the JAX executor on its CPU devices, the time-shared path and
the scipy golden, mirroring ``tests/test_space_shared.py``; the stacked
layout (``stack_arrow_blocks``) and the composed tables byte for byte
against JAX's; and the transposed step against the dense matrix of the
whole step, K-copy map included."""

import os
import sys

import numpy as np
import pytest
import torch
from scipy import sparse

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decomp
from arrow_matrix_tpu.decomposition.decompose import decomposition_spmm
from arrow_matrix_tpu.ops import arrow_blocks as jax_blocks
from arrow_matrix_tpu.parallel import make_mesh as jax_mesh
from arrow_matrix_tpu.parallel.space_shared import (
    SpaceSharedArrow as JaxSpace,
    stack_arrow_blocks as jax_stack,
)
from arrow_matrix_tpu_torch.ops.arrow_blocks import arrow_blocks_from_csr
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.parallel.space_shared import (
    SpaceSharedArrow,
    space_tables,
    stack_arrow_blocks,
)
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)
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


def _problem(n=512, w=32, max_levels=2, seed=0):
    a = barabasi_albert(n, 3, seed=seed)
    return a, jax_decomp(a, w, max_levels=max_levels, block_diagonal=True,
                         seed=seed)


def _tol(levels, iters=1):
    nnz = sum(lvl.matrix.nnz for lvl in levels)
    return relative_tolerance(nnz / levels[0].matrix.shape[0], iters)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_space_shared_matches_golden(pool4, fmt):
    """One step on a (lvl=2, blocks=2) mesh against the golden and the
    JAX executor on the same mesh shape; the tables are JAX's, byte for
    byte."""
    _, levels = _problem()
    x = random_dense(512, 8, seed=1)
    got = _run(pool4, "space_step", "space", levels, 32, x, 1,
               {"fmt": fmt}, *SPACE)
    want = decomposition_spmm(levels, x)
    assert relative_error(got[0]["out"], want) < _tol(levels)
    js = JaxSpace(levels, 32, mesh=jax_mesh(*SPACE), fmt=fmt)
    assert got[0]["fmt"] == js.fmt and got[0]["width"] == js.width
    jgot = js.gather_result(js.step(js.set_features(x)))
    assert relative_error(got[0]["out"], jgot) < _tol(levels)
    for name in ("bwd0", "fwd0"):
        mine, theirs = got[0][name], np.asarray(getattr(js, name))
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)


def test_space_shared_matches_time_shared_iterated(pool4):
    _, levels = _problem()
    x = random_dense(512, 8, seed=2)
    iters = 4
    got = _run(pool4, "space_step", "space", levels, 32, x, iters, {},
               *SPACE)[0]["out"]
    ml = MultiLevelArrow(levels, 32, device="cpu")
    time_shared = ml.gather_result(ml.run(ml.set_features(x), iters))
    want = x.copy()
    for _ in range(iters):
        want = decomposition_spmm(levels, want)
    assert relative_error(got, want) < _tol(levels, iters)
    assert relative_error(time_shared, want) < _tol(levels, iters)


def test_space_shared_four_groups_grown_last_level(pool4):
    """K=4 levels on a (4, 1) mesh at a narrow base width: the uniform
    banded tiling captures every level's nonzeros (checked at
    construction) and the step is the golden's."""
    _, levels = _problem(w=16, max_levels=4)
    assert len(levels) == 4
    x = random_dense(512, 4, seed=3)
    got = _run(pool4, "space_step", "space", levels, 16, x, 1,
               {"fmt": "ell"}, (4, 1), ("lvl", "blocks"))
    assert relative_error(got[0]["out"], decomposition_spmm(levels, x)) \
        < _tol(levels)


class _Stub:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def test_space_shared_explicit_mesh_and_validation():
    """A mesh whose ``lvl`` axis does not match the level count is
    refused with the JAX class's words, before any collective."""
    _, levels = _problem()
    with pytest.raises(ValueError) as want:
        JaxSpace(levels, 32, mesh=jax_mesh((4, 2), ("lvl", "blocks")))
    with pytest.raises(ValueError) as got:
        SpaceSharedArrow(levels, 32, mesh=_Stub((4, 1), ("lvl", "blocks")))
    assert "one slice per level" in str(got.value)
    assert str(got.value).replace("4", "") == str(want.value).replace(
        "4", "")
    with pytest.raises(ValueError, match="empty decomposition"):
        SpaceSharedArrow([], 32, mesh=_Stub((1, 1), ("lvl", "blocks")))


def test_directed_level_matrices(pool4):
    rng = np.random.default_rng(0)
    n = 256
    a = sparse.random(n, n, density=0.02, random_state=rng, format="csr",
                      dtype=np.float32)
    levels = jax_decomp(a, 32, max_levels=2, block_diagonal=True, seed=0)
    x = random_dense(n, 8, seed=4)
    got = _run(pool4, "space_step", "space", levels, 32, x, 1, {}, *SPACE)
    assert relative_error(got[0]["out"], decomposition_spmm(levels, x)) \
        < _tol(levels)


# -- the stacked layout and the tables, on the host ---------------------------

def _bits(t):
    """An array's bits (bf16 as int16)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("fmt,head_fmt,dtype", [
    ("dense", "auto", "f32"), ("dense", "auto", "bf16"),
    ("ell", "flat", "f32"), ("ell", "ell", "f32")])
def test_stack_arrow_blocks_equals_jax(fmt, head_fmt, dtype):
    """Per-level blocks stacked on a leading level axis, each ELL slot
    axis padded to the largest (the flat head's padding at the dummy
    row): the arrays equal the JAX function's, field by field."""
    _, levels = _problem(n=384, max_levels=3)
    w = max(32, *(lvl.arrow_width for lvl in levels))
    w = -(-w // 32) * 32
    nb = max(-(-lvl.matrix.shape[0] // w) for lvl in levels)
    jdt = {"f32": np.float32, "bf16": "bfloat16"}[dtype]
    mine = stack_arrow_blocks([
        arrow_blocks_from_csr(lvl.matrix, w, banded=True, pad_blocks_to=nb,
                              dtype=dtype, fmt=fmt, head_fmt=head_fmt,
                              device="cpu") for lvl in levels])
    theirs = jax_stack([
        jax_blocks.arrow_blocks_from_csr(lvl.matrix, w, banded=True,
                                         pad_blocks_to=nb, dtype=jdt,
                                         fmt=fmt, head_fmt=head_fmt)
        for lvl in levels])
    for name, t in mine.tensors().items():
        want = getattr(theirs, name)
        assert want is not None, name
        assert tuple(t.shape) == tuple(np.asarray(want).shape), name
        assert np.array_equal(_bits(t), _bits(want)), name
    for name in ("width", "n_blocks", "banded", "fmt", "head_flat"):
        assert getattr(mine, name) == getattr(theirs, name), name


def test_stack_refuses_levels_that_disagree():
    _, levels = _problem(n=384, max_levels=2)
    a = arrow_blocks_from_csr(levels[0].matrix, 64, banded=True,
                              pad_blocks_to=8, device="cpu")
    b = arrow_blocks_from_csr(levels[1].matrix, 64, banded=False,
                              pad_blocks_to=8, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        stack_arrow_blocks([a, b])


def test_tables_equal_jax_for_three_levels():
    _, levels = _problem(n=768, max_levels=3)
    js = JaxSpace(levels, 32, mesh=jax_mesh((3, 2), ("lvl", "blocks")))
    perm0, bwd0, fwd0 = space_tables(levels, js.total_rows)
    assert np.array_equal(perm0, js.perm0)
    for mine, name in ((bwd0, "bwd0"), (fwd0, "fwd0")):
        theirs = np.asarray(getattr(js, name))
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)


# -- the transposed step -----------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    n = 128
    a = barabasi_albert(n, 3, seed=43, directed=True).astype(np.float32)
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    mats = {"directed": a,
            "dinv_a": (sparse.diags(1.0 / deg) @ a).tocsr().astype(
                np.float32),
            "sym": barabasi_albert(n, 3, seed=1).astype(np.float32)}
    return {k: jax_decomp(m, 16, max_levels=2, block_diagonal=True, seed=2)
            for k, m in mats.items()}


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("graph", ["directed", "dinv_a", "sym"])
def test_transposed_step_is_the_whole_step_transposed(pool4, graphs, fmt,
                                                      graph):
    """The transposed step of the K-copy step, ``x̄[h] = B_hᵀ F_h Σ_g G_g
    ȳ[g]``, against the dense matrix of the whole forward step (the
    step of every unit vector of the global carriage, K copies
    included), transposed; each group packs its level transposed on the
    directed graph and ``D⁻¹A``, nothing on the symmetric one."""
    levels = graphs[graph]
    got = _run(pool4, "space_dense", "space", levels, 16, 5, 3,
               {"fmt": fmt}, *SPACE)
    dense, g = got[0]["dense"], got[0]["g"]
    nnz = sum(lvl.matrix.nnz for lvl in levels)
    assert relative_error(got[0]["got"], dense.T @ g) <= relative_tolerance(
        nnz / levels[0].matrix.shape[0], 1)
    for r, res in enumerate(got):
        assert res["packed"] == ([] if graph == "sym" else [r // 2])
        assert (res["bytes"] == 0) == (graph == "sym")

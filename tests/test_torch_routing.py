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

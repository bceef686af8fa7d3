"""``MultiLevelArrow(mesh=)`` on gloo ranks (``parallel/arrow_layout.py``)
against the JAX executor on a mesh of the same size, mirroring
``tests/test_parallel.py``: slim and wide, dense and ELL (flat and
per-block heads), banded and block-diagonal, gather and a2a routing,
the staged exchange; and the JAX class's ``ValueError``s for options
that do not go together, word for word."""

import os
import sys

import numpy as np
import pytest

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decomp
from arrow_matrix_tpu.decomposition.decompose import decomposition_spmm
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu.parallel import make_mesh as jax_mesh
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.parallel.arrow_layout import (
    MeshMultiLevelArrow,
    check_mesh_options,
)
from arrow_matrix_tpu_torch.parallel.launch import RankPool
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
def problem():
    n, width = 480, 32
    a = barabasi_albert(n, 4, seed=11)
    bd = jax_decomp(a, width, max_levels=4, block_diagonal=True, seed=1)
    banded = jax_decomp(a, width, max_levels=4, block_diagonal=False, seed=1)
    return a, {True: bd, False: banded}, random_dense(n, 8, seed=6)


def _tol(a, steps=1):
    return relative_tolerance(a.nnz / a.shape[0], steps)


@pytest.mark.parametrize("fmt,head_fmt", [("dense", "auto"),
                                          ("ell", "ell"), ("ell", "flat"),
                                          ("auto", "auto")])
@pytest.mark.parametrize("block_diagonal", [True, False])
@pytest.mark.parametrize("routing", ["gather", "a2a"])
def test_slim_matches_jax(pool4, problem, fmt, head_fmt, block_diagonal,
                          routing):
    a, levels, x = problem
    lv = levels[block_diagonal]
    kw = dict(fmt=fmt, head_fmt=head_fmt, banded=not block_diagonal,
              routing=routing)
    jm = JaxArrow(lv, 32, mesh=jax_mesh((4,), ("blocks",)), **kw)
    want = jm.gather_result(jm.step(jm.set_features(x)))
    got = pool4.run(JOBS, "multi_level", lv, 32, x, 1, kw)[0]
    assert got["fmts"] == list(jm.fmts)
    # The load report, counted from the levels' CSR, is JAX's.
    assert got["report"] == jm.shard_report()
    assert relative_error(got["out"], want) <= _tol(a)
    assert relative_error(got["out"], decomposition_spmm(lv, x)) <= _tol(a)
    if routing == "a2a":
        assert got["stats"]["all-gather"]["count"] == 0


@pytest.mark.parametrize("fmt,head_fmt", [("dense", "auto"),
                                          ("ell", "flat")])
def test_single_device_members_refuse_on_a_mesh(pool4, problem, fmt,
                                                head_fmt):
    """The members of the single-device fold that have no mesh form (its
    product, knobs and per-level packing) raise naming the single-device
    executor on every rank, ``export_folded`` in the JAX package's words,
    and ``load_folded`` keeps its single-device meaning; the transposed
    operator has a mesh form: over the symmetric BA levels it packs
    nothing and its step is the step, bit for bit; the head layouts name
    each level's, and the carriage model prices this rank's rows."""
    _, levels, _ = problem
    lv = levels[True]
    jm = JaxArrow(lv, 32, mesh=jax_mesh((4,), ("blocks",)), fmt=fmt,
                  head_fmt=head_fmt)
    for r in pool4.run(JOBS, "mesh_members", lv, 32,
                       dict(fmt=fmt, head_fmt=head_fmt)):
        refused = r["refused"]
        assert sorted(refused) == ["export_folded", "fold_product",
                                   "launch_groups", "pack_level"]
        assert refused.pop("export_folded") == \
            "export_folded requires fmt='fold'"
        assert all(msg and "belongs to the single-device executor" in msg
                   for msg in refused.values()), refused
        assert r["loaded"] == ("MultiLevelArrow", True, "cpu")
        assert r["packed"] == [] and r["transposed_is_step"]
        assert r["head_layouts"] == [
            None if f != "ell" else head_fmt for f in jm.fmts]
        assert r["kernel_bytes"] == 0
        assert r["carriage"] == 2 * r["rows_local"] * 16 * 4


@pytest.mark.parametrize("fmt", ["auto", "ell"])
def test_wide_layout_golden_and_jax(pool4, problem, fmt):
    """layout='wide' on an (arm=2, blocks=2) grid: one step and a
    3-step run match JAX's wide executor and the golden."""
    a, levels, x = problem
    lv = levels[True]
    kw = dict(fmt=fmt, layout="wide")
    jm = JaxArrow(lv, 32, mesh=jax_mesh((2, 2), ("arm", "blocks")), **kw)
    want = jm.gather_result(jm.run(jm.set_features(x), 3))
    got = pool4.run(JOBS, "multi_level", lv, 32, x, 3, kw, (2, 2),
                    ("arm", "blocks"))[0]
    assert relative_error(got["out"], want) <= _tol(a, 3)
    golden = x
    for _ in range(3):
        golden = decomposition_spmm(lv, golden)
    assert relative_error(got["out"], golden) <= _tol(a, 3)


def test_wide_matches_slim(pool4, problem):
    a, levels, x = problem
    lv = levels[False]
    slim = pool4.run(JOBS, "multi_level", lv, 32, x, 1,
                     dict(banded=True))[0]
    wide = pool4.run(JOBS, "multi_level", lv, 32, x, 1,
                     dict(banded=True, layout="wide"), (2, 2),
                     ("arm", "blocks"))[0]
    assert relative_error(wide["out"], slim["out"]) <= _tol(a)


def test_staged_exchange_equals_one_shot(pool4, problem):
    """exchange_scratch_budget splits every a2a exchange into stages:
    the same bits as the one-shot exchange."""
    a, levels, x = problem
    lv = levels[True]
    one = pool4.run(JOBS, "multi_level", lv, 32, x, 1,
                    dict(routing="a2a"))[0]
    staged = pool4.run(JOBS, "multi_level", lv, 32, x, 1,
                       dict(routing="a2a", exchange_k=8,
                            exchange_scratch_budget=2 * 4 * 8 * 4 * 3))[0]
    assert np.array_equal(one["out"], staged["out"])
    assert staged["stats"]["all-to-all"]["count"] \
        > one["stats"]["all-to-all"]["count"]


class _Stub:
    """A mesh's shape and names, for the checks that run before any
    collective."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("mesh_shape,kw", [
    (None, dict(layout="wide")),
    (((4,), ("blocks",)), dict(layout="wide")),
    (((2, 2), ("arm", "blocks")), dict(layout="wide", routing="a2a")),
    (((2, 2), ("arm", "blocks")), dict(layout="wide", kernel="pallas")),
    (None, dict(layout="chubby")),
    (None, dict(routing="a2a")),
    (None, dict(routing="bogus")),
    (((4,), ("blocks",)), dict(fmt="fold")),
    (((4,), ("blocks",)), dict(fmt="hyb")),
    (((4,), ("blocks",)), dict(head_fmt="gell")),
    (((4,), ("blocks",)), dict(repl=2, fmt="fold")),
    (((4,), ("blocks",)), dict(repl=2)),
])
def test_validation_errors_word_for_word(problem, mesh_shape, kw):
    """The options that do not go together raise the JAX class's
    ValueError, with its words."""
    _, levels, _ = problem
    lv = levels[True]
    jmesh = None if mesh_shape is None else jax_mesh(*mesh_shape)
    with pytest.raises(ValueError) as want:
        JaxArrow(lv, 32, mesh=jmesh, **kw)
    pmesh = None if mesh_shape is None else _Stub(*mesh_shape)
    with pytest.raises(ValueError) as got:
        MultiLevelArrow(lv, 32, mesh=pmesh, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_a_mesh_builds_the_mesh_executor():
    assert MultiLevelArrow.__new__(MultiLevelArrow, mesh=_Stub(
        (4,), ("blocks",))).__class__ is MeshMultiLevelArrow
    with pytest.raises(ValueError, match="requires a mesh"):
        check_mesh_options(None, "auto", "a2a", "slim", "auto", 1, "xla",
                           "arm")


def _gcn_levels():
    """``tests/test_torch_models_mesh.py::_gcn_case``'s levels (BA n=320,
    m=4, seed 21, width 32, 3 levels)."""
    a = barabasi_albert(320, 4, seed=21)
    return jax_decomp(a, 32, max_levels=3, block_diagonal=True, seed=2)


@pytest.mark.parametrize("kw", [
    dict(fmt="ell", routing="a2a"),
    dict(fmt="dense", routing="a2a"),
    dict(fmt="ell", routing="a2a", exchange_k=128,
         exchange_scratch_budget=2 * 4 * 128 * 4 * 3),
    dict(fmt="dense", routing="a2a", exchange_k=16,
         exchange_scratch_budget=2 * 4 * 16 * 4 * 5),
    dict(fmt="ell", routing="gather")],
    ids=["ell-a2a", "dense-a2a", "ell-staged", "dense-staged", "gather"])
def test_request_price_holds_the_exchange_scratch(pool4, kw):
    """A request's admission price (``carriage_hbm_bytes``) and the a2a
    send + receive scratch in it (``exchange_scratch_bytes``) equal the
    JAX executor's on every rank at k = 16 and 128, one-shot and staged;
    zero scratch under gather routing."""
    lv = _gcn_levels()
    jm = JaxArrow(lv, 32, mesh=jax_mesh((4,), ("blocks",)), **kw)
    got = pool4.run(JOBS, "hbm_price", lv, 32, kw, (16, 128))
    for k in (16, 128):
        want = (jm.exchange_scratch_bytes(k), jm.carriage_hbm_bytes(k))
        assert [r[k][:2] for r in got] == [want] * 4
        if kw["routing"] == "gather":
            assert want[0] == 0
    if "exchange_k" not in kw and kw["routing"] == "a2a":
        # ROADMAP's record of the reference on this case.
        assert [got[0][k][1] for k in (16, 128)] == [36_352, 290_816]


def test_one_rank_has_no_exchange_scratch(pool4):
    """On a mesh of one rank every row is local: no scratch, and the
    price is the carriage alone (the JAX executor's on one device)."""
    lv = _gcn_levels()
    kw = dict(fmt="ell", routing="a2a")
    jm = JaxArrow(lv, 32, mesh=jax_mesh((1,), ("blocks",)), **kw)
    got = pool4.run(JOBS, "hbm_price", lv, 32, kw, (16, 128), (0,))
    assert got[1:] == [None] * 3
    for k in (16, 128):
        assert got[0][k][:2] == (0, jm.carriage_hbm_bytes(k))
        assert jm.exchange_scratch_bytes(k) == 0

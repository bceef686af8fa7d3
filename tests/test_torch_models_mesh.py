"""The models of ``models/propagation.py`` through the port's mesh
executors on gloo ranks, against the JAX package on its CPU devices and
the host goldens, mirroring ``tests/test_models.py``'s mesh cases
(power iteration on the sell executors, the GCN train step over
``MultiLevelArrow(mesh=)``, the carried models on ``SellMultiLevel`` and
``SellSpaceShared``, PageRank and label propagation, CG).

Three faults of the models on a mesh are pinned here on their smallest
inputs: rank-local reductions (power iteration gave each rank its own
eigenvalue), the carried models reading a missing ``device``, and a
train step over ``MultiLevelArrow(mesh=)`` dying inside a collective
under grad mode.  Every rank job runs under a time limit: ranks that
disagree about a scalar would hang in their next collective, not fail.

The transposed step of every mesh executor (the backward of its step)
is held against the dense ``Aᵀ g`` on a directed graph and on
``D⁻¹A``; symmetric levels pack nothing.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import sparse

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decomp
from arrow_matrix_tpu.models import propagation as J
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu.parallel import SellMultiLevel as JaxSellMulti
from arrow_matrix_tpu.parallel import make_mesh as jax_mesh
from arrow_matrix_tpu_torch.models import propagation as P
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_mesh_jobs"
#: Seconds a rank job may take before the pool stops every rank.
LIMIT = 240
WIDTH = 8
SLIM = (None, ("blocks",))
SPACE = ((2, 2), ("lvl", "blocks"))


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=120) as pool:
        yield pool


def _run(pool, *args):
    return pool.run(JOBS, *args, job_timeout_s=LIMIT)


def _small(n=128, seed=0):
    """``tests/test_models.py``'s problem: BA m=3 at width 8, 2 levels."""
    a = barabasi_albert(n, 3, seed=seed)
    levels = jax_decomp(a, WIDTH, max_levels=2, block_diagonal=True,
                        seed=seed)
    assert len(levels) == 2
    return a, levels


def _same_on_every_rank(results, key):
    for r in results[1:]:
        a, b = r[key], results[0][key]
        if isinstance(a, list):
            assert len(a) == len(b)
            for u, v in zip(a, b):
                assert np.array_equal(u, v), key
        else:
            assert np.array_equal(a, b), key


# -- the collective the models' reductions run through ------------------------

@pytest.mark.parametrize("axes", [None, "lvl", ("lvl", "blocks")])
def test_all_reduce_sum_gives_every_rank_the_same_bits(pool4, axes):
    """The ordered all-reduce on a (lvl=2, blocks=2) grid: the sum over
    the named lines, added in rank order (over two axes, the first
    axis's sums added in the second's order), equal bit for bit on
    every rank of a line, f32 and bf16; one all-reduce counted an axis
    a call."""
    got = _run(pool4, "all_reduce_sum", (2, 2), ("lvl", "blocks"), axes)
    base = np.arange(6, dtype=np.float32).reshape(2, 3) + np.float32(0.1)
    t = [base * np.float32(1.0 + r / 3.0) for r in range(4)]
    if axes is None:
        want = [((t[0] + t[1]) + t[2]) + t[3]] * 4
    elif axes == "lvl":        # rank r's line: r % 2, then r % 2 + 2
        want = [t[r % 2] + t[r % 2 + 2] for r in range(4)]
    else:
        want = [(t[0] + t[2]) + (t[1] + t[3])] * 4
    n_axes = 2 if isinstance(axes, tuple) else 1
    for r, g in enumerate(got):
        assert np.array_equal(g["out"], want[r])
        assert g["stats"]["all-reduce"]["count"] == 2 * n_axes
        line = [q for q in range(4) if np.array_equal(want[q], want[r])]
        for q in line:
            assert np.array_equal(got[q]["bf16"], g["bf16"])


# -- fault 1: the reductions are the whole mesh's -----------------------------

@pytest.mark.parametrize("kind,mesh", [("sell", SLIM),
                                       ("sell_space", SPACE)])
def test_power_iteration_gives_one_eigenvalue(pool4, kind, mesh):
    """``tests/test_models.py::test_power_iteration_on_sell_orchestrations``
    on 4 gloo ranks (BA n=96, m=3, seed 4, width 8, 2 levels, 150
    iterations): one eigenvalue on every rank, bit for bit, within 1e-2
    of the dense one, and the JAX executor's within the same gate."""
    n = 96
    a, levels = _small(n, seed=4)
    w = np.linalg.eigvalsh(a.toarray())
    lam_true = w[np.argmax(np.abs(w))]
    x0 = np.ones((n, 1), np.float32)
    got = _run(pool4, "model_run", kind, levels, WIDTH, "power", (x0, 150),
               {}, *mesh)
    lams = [r["lam"] for r in got]
    assert len(set(lams)) == 1, lams
    _same_on_every_rank(got, "v")
    lam, v = got[0]["lam"], got[0]["v"]
    assert abs(lam - lam_true) / abs(lam_true) < 1e-2
    res = np.linalg.norm(a @ v - lam * v) / (abs(lam) * np.linalg.norm(v))
    assert res < 5e-2
    if kind == "sell":
        _, jlam = J.power_iteration(
            JaxSellMulti(levels, WIDTH, jax_mesh((4,), ("blocks",))), x0,
            iterations=150)
        assert abs(lam - jlam) / abs(jlam) < 1e-2


def _cg_problem():
    """``tests/test_models.py``'s CG system, its sizes kept: BA n=4096,
    m=4, symmetrized, width 256, 2 levels, k=4."""
    from arrow_matrix_tpu.utils.graphs import symmetrize
    import scipy.sparse.linalg as spla

    n, width, k = 4096, 256, 4
    a = symmetrize(barabasi_albert(n, 4, seed=8)).astype(np.float32)
    levels = jax_decomp(a, width, max_levels=2, block_diagonal=True, seed=8)
    shift = float(a.sum(axis=1).max()) + 1.0
    b = np.random.default_rng(1).standard_normal((n, k)).astype(np.float32)
    want = spla.spsolve((shift * sparse.identity(n, format="csr",
                                                 dtype=np.float32)
                         + a).tocsc(), b)
    return levels, width, b, shift, want


@pytest.mark.parametrize("kind,kw,mesh", [
    ("sell", {"routing": "a2a"}, SLIM), ("sell_space", {}, SPACE)])
def test_conjugate_gradient_stops_together(pool4, kind, kw, mesh):
    """CG on sell/a2a and sell-space at the reference's sizes and gate
    (1e-4 against scipy's direct solve, 80 iterations, ``tol=1e-7``):
    every rank gets the same residual norm and the same solution, so
    with ``tol > 0`` they stop at the same iteration."""
    levels, width, b, shift, want = _cg_problem()
    got = _run(pool4, "model_run", kind, levels, width, "cg",
               (b, shift, 80, 1e-7), kw, *mesh)
    assert len({r["rnorm"] for r in got}) == 1
    _same_on_every_rank(got, "x")
    err = np.linalg.norm(got[0]["x"] - want) / np.linalg.norm(want)
    assert err < 1e-4, err


# -- fault 2: the carried models on the sell executors ------------------------

@pytest.mark.parametrize("kind,mesh", [("sell", SLIM),
                                       ("sell_space", SPACE)])
@pytest.mark.parametrize("model", ["sgc", "gcn"])
def test_carried_models_on_feature_major_executors(pool4, kind, mesh,
                                                   model):
    """``test_sgc_carried_on_feature_major_executors`` and
    ``test_gcn_carried_on_feature_major_executors`` (BA n=128, m=3,
    seed 0): the carried model builds on the mesh executor and predicts
    within 1e-4 of the flat model of the same seed on one device; its
    fit (SGC on sell, GCN through sell-space, as the reference trains
    them) converges, with the same losses and parameters, bit for bit,
    on every rank."""
    n = 128
    _, levels = _small(n)
    x = random_dense(n, 8, seed=2)
    dims = (8, 12, 4)
    flat_exe = MultiLevelArrow(levels, WIDTH, device="cpu")
    flat = (P.SGCModel(flat_exe, 8, 4, hops=2, seed=0) if model == "sgc"
            else P.GCNModel(flat_exe, dims=dims, seed=0))
    want = flat.predict(x)
    y = np.random.default_rng(5).standard_normal((n, 4)).astype(np.float32)
    trains = (model, kind) in (("sgc", "sell"), ("gcn", "sell_space"))
    margs = (8, 4, 2) if model == "sgc" else (dims,)
    got = _run(pool4, "model_run", kind, levels, WIDTH,
               f"{model}_carried", (x, y, margs, 60 if trains else 0), {},
               *mesh)
    for r in got:
        np.testing.assert_allclose(r["pred"], want, rtol=1e-4, atol=1e-4)
    if trains:
        losses = got[0]["losses"]
        assert losses[-1] < 0.5 * losses[0], losses[::15]
        _same_on_every_rank(got, "losses")
        _same_on_every_rank(got, "params")


def test_pagerank_and_labelprop_on_carried_executors(pool4):
    """``test_pagerank_and_labelprop_on_carried_executors``: the carried
    drivers on sell and sell-space match the flat drivers on one device
    (the teleport and seed vectors ride ``set_features``, K copies
    included)."""
    n = 96
    a, _ = _small(n, seed=5)
    deg = np.maximum(np.asarray(a.sum(axis=0)).ravel(), 1.0)
    a_norm = (a @ sparse.diags(1.0 / deg)).tocsr().astype(np.float32)
    levels = jax_decomp(a_norm, WIDTH, max_levels=2, block_diagonal=True,
                        seed=5)
    flat = MultiLevelArrow(levels, WIDTH, device="cpu")
    rng = np.random.default_rng(1)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    seeds = rng.random(n) < 0.2
    want_pr = P.pagerank(flat, 0.85, 30)
    want_lp = P.label_propagation(flat, labels, seeds, iterations=10)
    for kind, mesh in (("sell", SLIM), ("sell_space", SPACE)):
        pr = _run(pool4, "model_run", kind, levels, WIDTH, "pagerank",
                  (0.85, 30), {}, *mesh)
        np.testing.assert_allclose(pr[0]["out"], want_pr, rtol=1e-4,
                                   atol=1e-6)
        lp = _run(pool4, "model_run", kind, levels, WIDTH, "labelprop",
                  (labels, seeds, 10), {}, *mesh)
        np.testing.assert_allclose(lp[0]["out"], want_lp, rtol=1e-4,
                                   atol=1e-5)
        _same_on_every_rank(lp, "out")


# -- fault 3: training through MultiLevelArrow(mesh=) -------------------------

def _gcn_case():
    """``tests/test_models.py::test_gcn_forward_matches_dense_golden``'s
    sharded training (BA n=320, m=4, seed 21, width 32, 3 levels)."""
    n, width = 320, 32
    a = barabasi_albert(n, 4, seed=21)
    levels = jax_decomp(a, width, max_levels=3, block_diagonal=True, seed=2)
    return a, levels, width, random_dense(n, 8, seed=4), \
        random_dense(n, 4, seed=5)


@pytest.mark.parametrize("kw,mesh", [
    (dict(fmt="ell"), SLIM),
    (dict(fmt="dense", routing="a2a"), SLIM),
    (dict(fmt="ell", layout="wide"), ((2, 2), ("arm", "blocks")))],
    ids=["ell", "dense-a2a", "wide-ell"])
def test_gcn_train_step_over_the_mesh(pool4, kw, mesh):
    """A GCN train step over ``MultiLevelArrow(mesh=)`` (5 Adam steps from
    the JAX package's ``gcn_init(key(0))``): the first step's loss and
    gradients, summed over the mesh, within ``relative_tolerance`` of
    ``jax.grad`` of the JAX step over the JAX mesh executor; the loss
    falls; losses and parameters equal bit for bit on every rank after
    every step."""
    a, levels, width, x, y = _gcn_case()
    params = J.gcn_init(jax.random.key(0), [8, 16, 4])
    np_params = [(np.asarray(p.w), np.asarray(p.b)) for p in params]
    got = _run(pool4, "gcn_train", "arrow", levels, width, x, y, np_params,
               5, kw, *mesh)
    losses = got[0]["losses"]
    assert losses[-1] < losses[0], losses
    _same_on_every_rank(got, "losses")
    _same_on_every_rank(got, "params")
    assert got[0]["transposed"] == []      # BA levels are symmetric

    # The reference's gradient over its gather routing: the routing
    # moves rows, so it is the same function as a2a's.
    jkw = {k: v for k, v in kw.items() if k != "routing"}
    jm = JaxArrow(levels, width, mesh=jax_mesh(*mesh) if mesh[0]
                  else jax_mesh((4,), ("blocks",)), **jkw)
    xs, ys = jm.set_features(x), jm.set_features(y)
    mask = jnp.asarray(np.asarray(jm.real_row_mask())[:, 0])
    ops = (jm.fwd, jm.bwd, jm.blocks, tuple(jm.widths))

    def loss(ps):
        per_row = jnp.sum((J.gcn_forward(ps, xs, *ops) - ys) ** 2, axis=-1)
        return jnp.sum(per_row * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    want_loss, want = jax.value_and_grad(loss)(params)
    tol = relative_tolerance(a.nnz / a.shape[0], 3)
    assert relative_error(losses[0], float(want_loss)) <= tol
    for (dw, db), p in zip(got[0]["grads"], want):
        assert relative_error(dw, np.asarray(p.w)) <= tol
        assert relative_error(db, np.asarray(p.b)) <= tol


# -- the transposed step of every time-shared mesh executor -------------------

@pytest.fixture(scope="module")
def graphs():
    """name -> (matrix, 3-level decomposition): a directed BA graph, the
    row-normalized ``D⁻¹A`` of it (both pack every level transposed),
    and the undirected BA adjacency (packs none)."""
    n = 256
    a = barabasi_albert(n, 3, seed=43, directed=True).astype(np.float32)
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    mats = {"directed": a,
            "dinv_a": (sparse.diags(1.0 / deg) @ a).tocsr().astype(
                np.float32),
            "sym": barabasi_albert(n, 3, seed=1).astype(np.float32)}
    return {k: (m, jax_decomp(m, 32, max_levels=3, block_diagonal=True,
                              seed=2)) for k, m in mats.items()}


EXECUTORS = [
    ("sell", {}, SLIM), ("sell", {"routing": "gather"}, SLIM),
    ("sell", {"repl_axis": "repl"}, ((2, 2), ("blocks", "repl"))),
    ("sell", {"feature_dtype": "bf16"}, SLIM),
    ("slim", {}, SLIM),
    ("arrow", {"fmt": "dense"}, SLIM),
    ("arrow", {"fmt": "ell", "routing": "a2a"}, SLIM),
    ("arrow", {"fmt": "ell", "head_fmt": "flat", "banded": True}, SLIM),
    ("arrow", {"fmt": "dense", "layout": "wide"},
     ((2, 2), ("arm", "blocks"))),
    ("arrow", {"fmt": "ell", "layout": "wide"},
     ((2, 2), ("arm", "blocks"))),
]


def _exe_id(case):
    kind, kw, _ = case
    return kind + "".join(f"-{v}" for v in kw.values())


@pytest.mark.parametrize("case", EXECUTORS, ids=_exe_id)
@pytest.mark.parametrize("graph", ["directed", "dinv_a", "sym"])
def test_transposed_step_is_the_dense_transpose(pool4, graphs, case,
                                                graph):
    """``gather_result(transposed_step(set_features(g)))`` equals
    ``Aᵀ g`` within ``relative_tolerance`` on every time-shared mesh
    executor; every level is packed transposed on the directed graph
    and on ``D⁻¹A``, none on the symmetric one (0 bytes); the build is
    kept."""
    kind, kw, mesh = case
    a, levels = graphs[graph]
    if kind == "slim":      # one level, in its own coordinates
        levels = levels[:1]
        a = sparse.csr_matrix(levels[0].matrix)
    g = random_dense(a.shape[0], 4, seed=3)
    want = a.T @ g
    got = _run(pool4, "transposed_step", kind, levels, 32, g, kw, *mesh)
    assert relative_error(got[0]["out"], want) <= relative_tolerance(
        a.nnz / a.shape[0], 1)
    for r in got:
        assert r["same"]
        if graph == "sym":
            assert r["packed"] == [] and r["bytes"] == 0
        else:
            assert r["packed"] == list(range(len(levels)))
            assert r["bytes"] > 0

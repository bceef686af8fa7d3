"""The model families of ``arrow_matrix_tpu_torch/models`` against the
JAX package's ``arrow_matrix_tpu/models/propagation.py``.

The same decomposition (the port's decomposer; the JAX executors take
its levels) goes into both packages' executors, and the JAX models'
initial parameters are carried across with ``convert.load_jax_params``.
Then, per model:

* forward (``predict``) against the JAX ``predict``;
* the gradient of the masked MSE against ``jax.grad`` of the same loss,
  on every per-level format (``auto``, ``ell``, ``hyb``, ``dense``
  block-diagonal and banded) and on the fold, for a symmetric
  decomposition (BA adjacency: the backward reuses the forward operator)
  and an asymmetric one (``D⁻¹A``, and on the fold also a directed
  graph, whose transposed pack sorts its rows differently);
* five Adam steps against five ``optax.adam`` steps.

Tolerances.  Both sides sum in f32 in different orders, so forwards and
gradients are held to the repo's gate ``relative_tolerance(nnz/n, s)``
(``64 eps_f32 sqrt(nnz/n) s``), ``s`` the SpMM products the compared
value depends on (forward and backward); the dense layers add sums of a
few hundred f32 terms, well inside the factor 64.  Adam: both compute
``m̂ / (√v̂ + eps)`` with ``eps = 1e-8`` (optax: ``lr * m̂ / (√v̂ + eps)``
with ``m̂ = m / (1 - β₁ᵗ)``; torch: ``lr / (1 - β₁ᵗ) * m / (√v /
√(1 - β₂ᵗ) + eps)``), the same value rounded differently, a few ulps of
an update of size ``lr``; over five steps the parameters agree within
``5e-6`` absolute (five updates of at most ``lr = 1e-2`` each, each to
a relative 1e-4 that also covers the gradients' order differences) and
the losses within ``1e-5`` relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import sparse

import arrow_matrix_tpu.models.propagation as J
import arrow_matrix_tpu_torch.models.propagation as P
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu_torch.convert import load_jax_params
from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)

N, WIDTH = 300, 16
K_IN, HIDDEN, K_OUT = 6, 5, 3
HOPS, ALPHA = 3, 0.15

#: Per-level formats: (fmt, banded); hyb has no block tiling.
FLAT = [("auto", False), ("auto", True), ("ell", False), ("ell", True),
        ("hyb", False), ("dense", False), ("dense", True)]

#: Products a model's forward crosses, and its gradient's backward.
FORWARD = {"sgc": HOPS, "gcn": 2, "appnp": HOPS}
BACKWARD = {"sgc": 0, "gcn": 1, "appnp": HOPS}


@pytest.fixture(scope="module")
def problems():
    """kind -> (matrix, block-diagonal levels, banded levels): "sym" the
    BA adjacency, "asym" its row normalization ``D⁻¹A``, "directed" a
    binary directed graph keeping 70% of its entries."""
    a = barabasi_albert(N, 3, seed=1).astype(np.float32)
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    coo = a.tocoo()
    keep = np.random.default_rng(2).random(coo.nnz) < 0.7
    mats = {"sym": a,
            "asym": (sparse.diags(1.0 / deg) @ a).tocsr().astype(
                np.float32),
            "directed": sparse.csr_matrix(
                (coo.data[keep], (coo.row[keep], coo.col[keep])),
                shape=a.shape)}
    return {kind: (m, *(arrow_decomposition(m, WIDTH, max_levels=3,
                                            block_diagonal=bd, seed=0)
                        for bd in (True, False)))
            for kind, m in mats.items()}


def _pair(problems, kind, fmt, banded=False, **kw):
    """(port executor on the CPU, JAX executor) over the same levels."""
    m, bd_levels, banded_levels = problems[kind]
    levels = banded_levels if banded else bd_levels
    if fmt == "fold":
        return (MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu",
                                **kw),
                JaxArrow(levels, WIDTH, fmt="fold", **kw))
    ours = MultiLevelArrow(levels, WIDTH, fmt="ell" if fmt == "auto"
                           else fmt, banded=banded, device="cpu")
    if fmt == "auto":
        # Room for the first level dense, the rest ELL.
        budget = ours.total_rows * WIDTH * (5 if banded else 3) * 4 + 1
        ours = MultiLevelArrow(levels, WIDTH, banded=banded, device="cpu",
                               dense_budget=budget)
        theirs = JaxArrow(levels, WIDTH, banded=banded,
                          dense_budget=budget)
        assert ours.fmts == theirs.fmts
        assert ours.fmts[0] == "dense" and set(ours.fmts[1:]) == {"ell"}
        return ours, theirs
    return ours, JaxArrow(levels, WIDTH, fmt=fmt, banded=banded)


def _np_params(params):
    """JAX ``SGCParams`` (or a list) -> numpy ``(w, b)`` pair(s)."""
    if isinstance(params, list):
        return [_np_params(p) for p in params]
    return np.asarray(params.w), np.asarray(params.b)


def _flat_models(ours, theirs):
    """{name: (port model, JAX model, JAX forward(params, x))}."""
    ops = (theirs.fwd, theirs.bwd, theirs.blocks, tuple(theirs.widths))
    out = {
        "sgc": (P.SGCModel(ours, K_IN, K_OUT, hops=HOPS),
                J.SGCModel(theirs, K_IN, K_OUT, hops=HOPS, seed=1),
                lambda ps, x: J.sgc_forward(ps, x, *ops, HOPS)),
        "gcn": (P.GCNModel(ours, (K_IN, HIDDEN, K_OUT)),
                J.GCNModel(theirs, (K_IN, HIDDEN, K_OUT), seed=2),
                lambda ps, x: J.gcn_forward(ps, x, *ops)),
        "appnp": (P.APPNPModel(ours, K_IN, K_OUT, hops=HOPS, alpha=ALPHA),
                  J.APPNPModel(theirs, K_IN, K_OUT, hops=HOPS,
                               alpha=ALPHA, seed=3),
                  lambda ps, x: J.appnp_forward(ps, x, *ops, HOPS, ALPHA)),
    }
    for mine, jm, _ in out.values():
        load_jax_params(mine, _np_params(jm.params))
    return out


def _carried_models(ours, theirs):
    """{name: (port model, JAX model, JAX forward(params, xt))}; the
    forwards take the carriage the fit trains on (SGC: propagated)."""
    ops = theirs.step_operands()
    sgc = J.SGCCarried(theirs, K_IN, K_OUT, hops=HOPS, seed=1)
    gcn = J.GCNCarried(theirs, (K_IN, HIDDEN, K_OUT), seed=2)
    appnp = J.APPNPCarried(theirs, K_IN, K_OUT, hops=HOPS, alpha=ALPHA,
                           seed=3)
    out = {
        "sgc": (P.SGCCarried(ours, K_IN, K_OUT, hops=HOPS), sgc,
                J._sgc_head),
        "gcn": (P.GCNCarried(ours, (K_IN, HIDDEN, K_OUT)), gcn,
                lambda ps, xt: gcn._forward(ps, xt, ops)),
        "appnp": (P.APPNPCarried(ours, K_IN, K_OUT, hops=HOPS,
                                 alpha=ALPHA), appnp,
                  lambda ps, xt: appnp._forward(ps, xt, ops)),
    }
    for mine, jm, _ in out.values():
        load_jax_params(mine, _np_params(jm.params))
    return out


def _jax_flat_grads(forward, params, theirs, x, y):
    xs, ys = theirs.set_features(x), theirs.set_features(y)
    mask = theirs.real_row_mask()[:, 0]

    def loss(ps):
        per_row = jnp.sum((forward(ps, xs) - ys) ** 2, axis=-1)
        return jnp.sum(per_row * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    return jax.value_and_grad(loss)(params)


def _jax_carried_grads(name, forward, jm, theirs, x, y):
    xt = (jm.propagate(x) if name == "sgc"
          else theirs.set_features(x.astype(np.float32)))
    yt = theirs.set_features(y.astype(np.float32))
    mask = theirs.carried_mask()

    def loss(ps):
        per = ((forward(ps, xt) - yt) ** 2).sum(axis=0, keepdims=True)
        return (per * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    return jax.value_and_grad(loss)(jm.params)


def _port_grads(name, model, ours, x, y):
    """(loss, [(dw, db) a layer]) of the port model's masked MSE."""
    if ours.folded:
        xt = (model.propagate(x) if name == "sgc"
              else ours.set_features(x))
        mask = ours.carried_mask()
    else:
        xt = ours.set_features(x)
        mask = ours.real_row_mask()
    model.zero_grad()
    loss = P.masked_mse(model(xt), ours.set_features(y), mask)
    loss.backward()
    heads = (model.params if isinstance(model.params, torch.nn.ModuleList)
             else [model.params])
    return float(loss.detach()), [(h.w.grad.numpy(), h.b.grad.numpy())
                         for h in heads]


def _check_grads(name, got, want, row_nnz):
    loss, grads = got
    want_loss, want_grads = want
    want_grads = _np_params(want_grads)
    if not isinstance(want_grads, list):
        want_grads = [want_grads]
    tol = relative_tolerance(row_nnz, FORWARD[name] + BACKWARD[name])
    assert relative_error(loss, float(want_loss)) <= tol
    for (dw, db), (jw, jb) in zip(grads, want_grads):
        assert relative_error(dw, jw) <= tol, (name, "w")
        assert relative_error(db, jb) <= tol, (name, "b")


@pytest.mark.parametrize("kind", ["sym", "asym"])
@pytest.mark.parametrize("fmt,banded", FLAT,
                         ids=[f + ("-banded" if b else "") for f, b in FLAT])
def test_flat_models_forward_and_gradients(problems, kind, fmt, banded):
    ours, theirs = _pair(problems, kind, fmt, banded)
    row_nnz = problems[kind][0].nnz / N
    x = random_dense(N, K_IN, seed=4)
    y = random_dense(N, K_OUT, seed=5)
    for name, (mine, jm, forward) in _flat_models(ours, theirs).items():
        got = mine.predict(x)
        assert got.shape == (N, K_OUT) and np.isfinite(got).all()
        assert relative_error(got, jm.predict(x)) <= relative_tolerance(
            row_nnz, FORWARD[name]), name
        _check_grads(name, _port_grads(name, mine, ours, x, y),
                     _jax_flat_grads(forward, jm.params, theirs, x, y),
                     row_nnz)
    # Symmetric levels reuse the forward operator; asymmetric ones are
    # packed transposed (by the first backward: GCN's or APPNP's).
    packed = ours.transposed().packed
    assert packed == ([] if kind == "sym"
                      else list(range(len(ours.levels))))


@pytest.mark.parametrize("kind", ["sym", "asym", "directed"])
def test_carried_models_forward_and_gradients(problems, kind):
    ours, theirs = _pair(problems, kind, "fold")
    row_nnz = problems[kind][0].nnz / N
    x = random_dense(N, K_IN, seed=4)
    y = random_dense(N, K_OUT, seed=5)
    for name, (mine, jm, forward) in _carried_models(ours, theirs).items():
        got = mine.predict(x)
        assert relative_error(got, jm.predict(x)) <= relative_tolerance(
            row_nnz, FORWARD[name]), name
        _check_grads(name, _port_grads(name, mine, ours, x, y),
                     _jax_carried_grads(name, forward, jm, theirs, x, y),
                     row_nnz)
    assert ours.transposed().packed == ([] if kind == "sym" else [0])


def _adam_params_close(mine, jax_params):
    heads = (mine.params if isinstance(mine.params, torch.nn.ModuleList)
             else [mine.params])
    want = _np_params(jax_params)
    want = want if isinstance(want, list) else [want]
    for h, (w, b) in zip(heads, want):
        np.testing.assert_allclose(h.w.detach().numpy(), w, rtol=0,
                                   atol=5e-6)
        np.testing.assert_allclose(h.b.detach().numpy(), b, rtol=0,
                                   atol=5e-6)


@pytest.mark.parametrize("name", ["sgc", "gcn", "appnp"])
def test_flat_adam_steps_match_optax(problems, name):
    """Five steps of the train-step factories (``torch.optim.Adam(lr=
    1e-2)``) against the JAX ones (``optax.adam(1e-2)``) on the
    asymmetric decomposition in ``hyb``: losses and parameters."""
    ours, theirs = _pair(problems, "asym", "hyb")
    mine, jm, _ = _flat_models(ours, theirs)[name]
    x, y = random_dense(N, K_IN, seed=6), random_dense(N, K_OUT, seed=7)
    opt = torch.optim.Adam(mine.parameters(), lr=1e-2)
    jopt = optax.adam(1e-2)
    widths = tuple(theirs.widths)
    step, jstep = {
        "sgc": (P.make_train_step(ours, HOPS, opt),
                J.make_train_step(widths, HOPS, jopt)),
        "gcn": (P.make_gcn_train_step(ours, opt),
                J.make_gcn_train_step(widths, jopt)),
        "appnp": (P.make_appnp_train_step(ours, HOPS, ALPHA, opt),
                  J.make_appnp_train_step(widths, HOPS, ALPHA, jopt)),
    }[name]
    xs, ys, mask = (ours.set_features(x), ours.set_features(y),
                    ours.real_row_mask())
    jx, jy = theirs.set_features(x), theirs.set_features(y)
    jmask = theirs.real_row_mask()[:, 0]
    params, state = jm.params, jopt.init(jm.params)
    losses, jlosses = [], []
    for _ in range(5):
        losses.append(float(step(mine.params, xs, ys, mask)))
        params, state, loss = jstep(params, state, jx, jy, jmask,
                                    theirs.fwd, theirs.bwd, theirs.blocks)
        jlosses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    _adam_params_close(mine, params)


@pytest.mark.parametrize("name", ["sgc", "gcn", "appnp"])
def test_carried_fit_matches_jax_fit(problems, name):
    """``fit(steps=5)`` with the default optimizer on both sides (torch
    Adam 1e-2, optax.adam 1e-2), on the directed graph's fold."""
    ours, theirs = _pair(problems, "directed", "fold")
    mine, jm, _ = _carried_models(ours, theirs)[name]
    x, y = random_dense(N, K_IN, seed=6), random_dense(N, K_OUT, seed=7)
    losses = mine.fit(x, y, steps=5)
    jlosses = jm.fit(x, y, steps=5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    _adam_params_close(mine, jm.params)


def test_fit_takes_an_optimizer_factory(problems):
    ours, _ = _pair(problems, "sym", "fold")
    model = P.GCNCarried(ours, (K_IN, HIDDEN, K_OUT))
    made = []

    def sgd(params):
        made.append(torch.optim.SGD(params, lr=1e-3))
        return made[-1]

    x, y = random_dense(N, K_IN, seed=6), random_dense(N, K_OUT, seed=7)
    losses = model.fit(x, y, steps=3, optimizer=sgd)
    assert len(made) == 1 and len(losses) == 3
    assert {id(p) for g in made[0].param_groups for p in g["params"]} == \
        {id(p) for p in model.parameters()}


def test_loaded_fold_trains_like_its_export(problems, tmp_path):
    """A ``load_folded`` executor (no levels) trains bit for bit as the
    executor it was exported from: the same tiers forward, and the same
    transposed pack, rebuilt from the tiers, backward."""
    ours, _ = _pair(problems, "directed", "fold")
    ours.export_folded(str(tmp_path))
    loaded = MultiLevelArrow.load_folded(str(tmp_path), device="cpu")
    x, y = random_dense(N, K_IN, seed=8), random_dense(N, K_OUT, seed=9)
    a = P.GCNCarried(ours, (K_IN, HIDDEN, K_OUT), seed=4)
    b = P.GCNCarried(loaded, (K_IN, HIDDEN, K_OUT), seed=4)
    assert a.fit(x, y, steps=4) == b.fit(x, y, steps=4)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert loaded.transposed().packed == [0]


def _pagerank_levels(problems):
    """The column-normalized ``A D⁻¹`` decomposed (pagerank's input)."""
    a = problems["sym"][0]
    deg = np.maximum(np.asarray(a.sum(axis=0)).ravel(), 1.0)
    an = (a @ sparse.diags(1.0 / deg)).tocsr().astype(np.float32)
    return arrow_decomposition(an, WIDTH, max_levels=3,
                               block_diagonal=True, seed=0)


def _labels():
    rng = np.random.default_rng(1)
    return (np.eye(3, dtype=np.float32)[rng.integers(0, 3, N)],
            rng.random(N) < 0.2)


@pytest.mark.parametrize("fmt", ["auto", "ell", "hyb", "dense", "fold"])
def test_solvers_match_jax(problems, fmt):
    """pagerank and label propagation (their carried forms on the fold),
    power iteration, and on the fold CG, against the JAX functions.
    The iterations are contractions (damping 0.85, a row-stochastic
    operator, a normalized power step, CG on a diagonally dominant
    system), so f32 order differences do not grow: 1e-5 relative."""
    labels, seed_mask = _labels()
    pr_levels = _pagerank_levels(problems)
    lp_levels = problems["asym"][1]
    sym_levels = problems["sym"][1]

    def build(levels):
        if fmt == "fold":
            return (MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu"),
                    JaxArrow(levels, WIDTH, fmt="fold"))
        kw = {"fmt": fmt} if fmt != "auto" else {}
        return (MultiLevelArrow(levels, WIDTH, device="cpu", **kw),
                JaxArrow(levels, WIDTH, **kw))

    def close(got, want):
        assert relative_error(got, want) <= 1e-5

    ours, theirs = build(pr_levels)
    if fmt == "fold":
        close(P.pagerank_carried(ours, iterations=30),
              J.pagerank_carried(theirs, iterations=30))
    else:
        close(P.pagerank(ours, iterations=30),
              J.pagerank(theirs, iterations=30))
    ours, theirs = build(lp_levels)
    if fmt == "fold":
        close(P.label_propagation_carried(ours, labels, seed_mask, 15),
              J.label_propagation_carried(theirs, labels, seed_mask, 15))
    else:
        close(P.label_propagation(ours, labels, seed_mask, 15),
              J.label_propagation(theirs, labels, seed_mask, 15))
    ours, theirs = build(sym_levels)
    x0 = np.ones((N, 1), np.float32)
    v, lam = P.power_iteration(ours, x0, iterations=40)
    jv, jlam = J.power_iteration(theirs, x0, iterations=40)
    close(v, jv)
    assert abs(lam - jlam) <= 1e-5 * abs(jlam)
    if fmt == "fold":
        b = random_dense(N, 4, seed=10)
        shift = float(problems["sym"][0].sum(axis=1).max()) + 1.0
        got, rnorm = P.conjugate_gradient(ours, b, shift=shift,
                                          iterations=30)
        want, jrnorm = J.conjugate_gradient(theirs, b, shift=shift,
                                            iterations=30)
        close(got, want)
        # The residual norm is near 0 after 30 iterations: absolute.
        assert abs(rnorm - jrnorm) <= 1e-5 * np.linalg.norm(b)
        got1, _ = P.conjugate_gradient(ours, b[:, 0], shift=shift,
                                       iterations=200, tol=1e-6)
        want1 = np.linalg.solve(
            shift * np.eye(N) + problems["sym"][0].toarray(), b[:, 0])
        assert got1.shape == (N,)
        assert relative_error(got1, want1) <= 1e-5


def test_power_iteration_eigenpair(problems):
    """The dominant eigenpair of the symmetric adjacency (the JAX
    package's test, on the port): 150 iterations."""
    a = problems["sym"][0]
    for fmt in ("ell", "fold"):
        exe = MultiLevelArrow(problems["sym"][1], WIDTH, fmt=fmt,
                              device="cpu")
        v, lam = P.power_iteration(exe, np.ones((N, 1), np.float32),
                                   iterations=150)
        w = np.linalg.eigvalsh(a.toarray())
        lam_true = w[np.argmax(np.abs(w))]
        assert abs(lam - lam_true) / abs(lam_true) < 1e-2
        res = np.linalg.norm(a @ v - lam * v) / (abs(lam)
                                                 * np.linalg.norm(v))
        assert res < 5e-2


def test_bf16_fold_matches_jax(problems):
    """A bf16 fold carriage does what the JAX package's does: every model
    and solver runs, a step writes bf16, and the values agree with the
    JAX package's within 2e-2 (a bf16 step output summed in another
    order can round one bf16 ulp, 2^-8, apart)."""
    ours, theirs = _pair(problems, "asym", "fold", feature_dtype="bf16")
    x, y = random_dense(N, K_IN, seed=11), random_dense(N, K_OUT, seed=12)
    for name, (mine, jm, _) in _carried_models(ours, theirs).items():
        assert relative_error(mine.predict(x), jm.predict(x)) <= 2e-2
        np.testing.assert_allclose(mine.fit(x, y, steps=2),
                                   jm.fit(x, y, steps=2), rtol=2e-2)
    labels, seed_mask = _labels()
    for got, want in (
            (P.pagerank_carried(ours, iterations=5),
             J.pagerank_carried(theirs, iterations=5)),
            (P.label_propagation_carried(ours, labels, seed_mask, 5),
             J.label_propagation_carried(theirs, labels, seed_mask, 5)),
            (P.power_iteration(ours, np.ones((N, 1), np.float32), 5)[0],
             J.power_iteration(theirs, np.ones((N, 1), np.float32), 5)[0]),
            (P.conjugate_gradient(ours, y, shift=50.0, iterations=5)[0],
             J.conjugate_gradient(theirs, y, shift=50.0, iterations=5)[0])):
        assert relative_error(got, want) <= 2e-2


def test_int8_fold_raises_like_jax(problems):
    """On the int8 ``(q, scale)`` carriage every model and solver raises
    (a TypeError or AttributeError on the pair), as the JAX package's
    do."""
    ours, _ = _pair(problems, "sym", "fold", feature_dtype="int8")
    x, y = random_dense(N, K_IN, seed=13), random_dense(N, K_OUT, seed=14)
    labels, seed_mask = _labels()
    calls = [
        lambda: P.SGCCarried(ours, K_IN, K_OUT).fit(x, y, steps=1),
        lambda: P.GCNCarried(ours, (K_IN, K_OUT)).fit(x, y, steps=1),
        lambda: P.APPNPCarried(ours, K_IN, K_OUT).predict(x),
        lambda: P.pagerank_carried(ours, iterations=1),
        lambda: P.label_propagation_carried(ours, labels, seed_mask, 1),
        lambda: P.power_iteration(ours, np.ones((N, 1), np.float32), 1),
        lambda: P.conjugate_gradient(ours, y, shift=9.0, iterations=1),
    ]
    for call in calls:
        with pytest.raises((TypeError, AttributeError)):
            call()


def test_guards_raise_as_in_jax(problems):
    """The JAX package's guards (``tests/test_sell.py``
    ``test_fold_rejected_by_propagation_models``, ``tests/test_models.py``
    feature-major and fold checks): the same ValueErrors."""
    fold, _ = _pair(problems, "sym", "fold")
    flat, _ = _pair(problems, "sym", "ell")
    labels, seed_mask = _labels()
    for call in (lambda: P.pagerank(fold, iterations=1),
                 lambda: P.label_propagation(fold, labels, seed_mask, 1),
                 lambda: P.SGCModel(fold, K_IN, K_OUT),
                 lambda: P.GCNModel(fold, (K_IN, K_OUT)),
                 lambda: P.APPNPModel(fold, K_IN, K_OUT),
                 fold.real_row_mask):
        with pytest.raises(ValueError, match="fold"):
            call()
    for call in (lambda: P.SGCCarried(flat, K_IN, K_OUT),
                 lambda: P.GCNCarried(flat, (K_IN, K_OUT)),
                 lambda: P.APPNPCarried(flat, K_IN, K_OUT),
                 lambda: P.pagerank_carried(flat, iterations=1),
                 lambda: P.label_propagation_carried(flat, labels,
                                                     seed_mask, 1),
                 lambda: P.conjugate_gradient(flat, labels, shift=9.0)):
        with pytest.raises(ValueError, match="feature-major"):
            call()
    with pytest.raises(ValueError, match="carried_mask is defined"):
        flat.carried_mask()
    # The messages are the JAX package's, word for word.
    for check in ("_check_not_folded", "_check_carried"):
        for multi in (fold, flat):
            try:
                getattr(J, check)(multi, "X")
                want = None
            except ValueError as e:
                want = str(e)
            try:
                getattr(P, check)(multi, "X")
                got = None
            except ValueError as e:
                got = str(e)
            assert got == want


def test_every_public_name_of_the_jax_module():
    names = {n for n, v in vars(J).items()
             if not n.startswith("_")
             and getattr(v, "__module__", None) == J.__name__}
    names |= {"_check_not_folded", "_check_carried"}
    assert {"SGCParams", "sgc_init", "sgc_forward", "SGCModel",
            "make_train_step", "gcn_init", "gcn_forward",
            "make_gcn_train_step", "GCNModel", "SGCCarried", "GCNCarried",
            "pagerank_carried", "label_propagation_carried",
            "power_iteration", "pagerank", "label_propagation",
            "appnp_forward", "APPNPModel", "make_appnp_train_step",
            "APPNPCarried", "conjugate_gradient"} <= names
    missing = sorted(n for n in names if not hasattr(P, n))
    assert not missing, missing
    import arrow_matrix_tpu_torch.models as models

    assert set(models.__all__) <= set(dir(P))


def test_init_is_lecun_normal_from_a_generator():
    """``sgc_init``: ``(k_in, k_out)`` normals over sqrt(k_in) from the
    given generator (the same seed gives the same weights), zero bias;
    ``gcn_init`` draws the layers in order from one generator."""
    g = torch.Generator().manual_seed(0)
    p = P.sgc_init(g, 400, 300)
    assert p.w.shape == (400, 300) and not p.b.any()
    w = p.w.detach()
    assert abs(float(w.std()) * np.sqrt(400) - 1.0) < 0.01
    assert abs(float(w.mean())) < 1e-3
    q = P.sgc_init(torch.Generator().manual_seed(0), 400, 300)
    assert torch.equal(p.w, q.w)
    layers = P.gcn_init(torch.Generator().manual_seed(0), [400, 300, 7])
    assert torch.equal(layers[0].w, p.w)
    assert [tuple(layer.w.shape) for layer in layers] == [(400, 300),
                                                          (300, 7)]


def test_load_jax_params_checks_shapes(problems):
    ours, _ = _pair(problems, "sym", "ell")
    sgc = P.SGCModel(ours, K_IN, K_OUT)
    w = np.ones((K_IN, K_OUT), np.float32)
    load_jax_params(sgc, (w, np.full(K_OUT, 2.0, np.float32)))
    assert torch.equal(sgc.params.w, torch.ones(K_IN, K_OUT))
    assert torch.equal(sgc.params.b, torch.full((K_OUT,), 2.0))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(sgc, (w.T, np.zeros(K_OUT, np.float32)))
    gcn = P.GCNModel(ours, (K_IN, HIDDEN, K_OUT))
    with pytest.raises(ValueError, match="list of 2"):
        load_jax_params(gcn, (w, np.zeros(K_OUT, np.float32)))


def test_models_stay_in_their_package():
    """The models module imports torch, numpy and nothing of JAX (the
    isolation test walks the package; this names the new module)."""
    path = P.__file__
    assert os.path.basename(os.path.dirname(path)) == "models"
    src = open(path, encoding="utf-8").read()
    assert "import jax" not in src and "arrow_matrix_tpu." not in src

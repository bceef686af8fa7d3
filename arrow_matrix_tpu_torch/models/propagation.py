"""Iterated-propagation models on the multi-level arrow SpMM.

Port of ``arrow_matrix_tpu/models/propagation.py``, with every public
name of that module.  Each model runs the executor's step
(``MultiLevelArrow.step``, which is ``step_fn(x, *step_operands())``),
and a gradient that crosses a propagation crosses it through the step's
backward, one step over the transposed operator
(``parallel/autograd.py``): on the card K1-K4 run both ways.

Carriages.  The per-level executors carry flat ``(total_rows, k)``
features in level-0 order and mask padding rows with ``real_row_mask``;
the fold carries ``(total_rows, k)`` too, row-major in sorted order
(the JAX package's fold carries ``(k, positions)``), and its loss and
reductions are weighted by ``carried_mask`` ``(total_rows, 1)``.  So
the carried heads are ``x @ w + b`` where the JAX package writes
``w.T @ xt + b[:, None]``, and the flat and carried forwards are one
function each (``gcn_forward``, ``appnp_forward``); the ``*Carried``
classes differ from their flat siblings in their guard and their mask.
A bf16 fold carriage behaves as in the JAX package: a step of it
writes bf16, and the states that the JAX code promotes to f32 (by an
f32 weight, mask or strongly typed f32 scalar) are promoted here by an
explicit ``.float()`` (torch's scalars do not promote); the int8
``(q, scale)`` carriage is a pair, not an array, and every model and
solver raises on it, as in the JAX package.

In PyTorch's idiom: parameters live in ``nn.Module``\\ s (``SGCParams``:
``w``, ``b``), initialised LeCun-normal from an explicit
``torch.Generator`` (seeded by the ``seed`` arguments; the numbers
differ from ``jax.random``'s, so tests carry JAX's parameters across
with ``convert.load_jax_params``); training uses ``torch.optim``: the
train-step factories take an optimizer built over the parameters and
step it in place, and ``fit(..., optimizer=)`` takes a factory from
parameters to an optimizer, by default ``torch.optim.Adam(lr=1e-2)``
(the JAX default ``optax.adam(1e-2)``).  The loss is the JAX masked MSE:
per-row squared error summed over features, times the mask, over
``max(sum(mask), 1)``.

The JAX functions take the step's operands (``fwd, bwd, blocks,
widths, chunk``) so that one jit trace serves any decomposition of the
same shapes; eager PyTorch traces nothing, so the port's functions take
the executor, whose step carries the backward.  For the same reason the
JAX module's jit caches (the ``lru_cache`` of
``_make_carried_train_step``, the per-instance ``_train_steps``, the
module-level jitted bodies) have no counterpart and are dropped.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

#: An optimizer factory: parameters -> ``torch.optim.Optimizer``.
OptimizerFactory = Callable[..., torch.optim.Optimizer]


class SGCParams(nn.Module):
    """Dense readout head: logits = X_prop @ w + b."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # A bf16 carriage is read in the weights' dtype (f32).
        return x.to(self.w.dtype) @ self.w + self.b


def _check_not_folded(multi, what: str) -> None:
    """The flat propagation drivers compose per-level SpMMs with
    ``real_row_mask``; the folded mode carries another order and is
    masked by ``carried_mask`` instead — reject it up front rather than
    mask the wrong rows (fold is the ``*Carried`` classes' executor)."""
    if getattr(multi, "folded", False):
        raise ValueError(
            f"{what} does not support fmt='fold' (feature-major "
            f"step/run-only execution); build the MultiLevelArrow with "
            f"fmt='auto'/'hyb'/'ell'/'dense' instead")


def _check_carried(multi, what: str) -> None:
    """Mirror of _check_not_folded for the opposite mistake: a flat
    executor has no ``carried_mask``."""
    if not getattr(multi, "carries_feature_major", False):
        raise ValueError(
            f"{what} needs a feature-major executor (fmt='fold' "
            f"MultiLevelArrow, SellMultiLevel, or SellSpaceShared); "
            f"for the flat layouts use the non-Carried sibling class")


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def default_optimizer(params) -> torch.optim.Optimizer:
    """The ``fit`` default: Adam at 1e-2 (the JAX ``optax.adam(1e-2)``;
    propagated features carry degree^hops magnitudes, which blow
    fixed-step SGD up on power-law graphs)."""
    return torch.optim.Adam(params, lr=1e-2)


def _reduce_axes(multi):
    """The mesh axes whose ranks split ``multi``'s carriage, or None for
    an executor on one device."""
    axes = getattr(multi, "reduce_axes", None)
    return None if axes is None else axes()


def mesh_sum(multi, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks that split ``multi``'s carriage, with
    the same bits on every rank (``parallel/collectives.py:
    all_reduce_sum``); ``t`` itself on one device.  The JAX package's
    reductions of a sharded array are whole-array ones; on ranks each
    holds its share, so a whole-array reduction ends here."""
    axes = _reduce_axes(multi)
    if axes is None:
        return t
    from arrow_matrix_tpu_torch.parallel.collectives import all_reduce_sum

    return all_reduce_sum(t, multi.mesh, axes)


def masked_mse(out: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor, multi=None) -> torch.Tensor:
    """Per-row squared error summed over features, times ``mask`` (one
    weight a row, any shape of ``rows`` elements), over
    ``max(sum(mask), 1)``.

    On a mesh (``multi`` an executor with one) the count is the whole
    mesh's and so is the value, equal on every rank; the gradient is
    this rank's share of it (its rows' terms), which
    :func:`_optimizer_step` sums over the mesh."""
    per_row = ((out - y) ** 2).sum(dim=-1)
    m = mask.reshape(-1)
    if _reduce_axes(multi) is None:
        return (per_row * m).sum() / torch.clamp(m.sum(), min=1.0)
    den = torch.clamp(mesh_sum(multi, m.sum().detach()), min=1.0)
    local = (per_row * m).sum() / den
    # The whole mesh's value, with this rank's gradient: the added term
    # is exactly zero.
    return mesh_sum(multi, local.detach()) + (local - local.detach())


def _optimizer_step(optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[[], torch.Tensor],
                    multi=None) -> torch.Tensor:
    """One step of ``optimizer`` on ``loss_fn()``; returns the loss before
    the update (as ``jax.value_and_grad`` then ``optax`` do).  On a mesh
    the gradients of the parameters (replicated: every rank holds the
    same) are summed over the mesh first, in one ordered all-reduce, so
    every rank takes the same step and the parameters stay equal bit for
    bit (XLA's autodiff does this sum for the JAX package)."""
    optimizer.zero_grad()
    loss = loss_fn()
    loss.backward()
    if _reduce_axes(multi) is not None:
        params = [p for group in optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        if params:
            flat = mesh_sum(multi, torch.cat(
                [p.grad.reshape(-1) for p in params]))
            at = 0
            for p in params:
                n = p.grad.numel()
                p.grad.copy_(flat[at:at + n].view_as(p.grad))
                at += n
    optimizer.step()
    return loss.detach()


def _fit(module: nn.Module, loss_fn: Callable[[], torch.Tensor],
         steps: int, optimizer: Optional[OptimizerFactory],
         multi=None) -> List[float]:
    opt = (optimizer or default_optimizer)(module.parameters())
    return [float(_optimizer_step(opt, loss_fn, multi))
            for _ in range(steps)]


def sgc_init(generator: torch.Generator, k_in: int, k_out: int,
             dtype=torch.float32, device=None) -> SGCParams:
    """LeCun-normal head init from ``generator`` (the ``(k_in, k_out)``
    weights are drawn on the CPU, then moved to ``device``)."""
    w = torch.randn((k_in, k_out), generator=generator, dtype=dtype) \
        / torch.sqrt(torch.tensor(k_in, dtype=dtype))
    return SGCParams(w.to(device), torch.zeros((k_out,), dtype=dtype,
                                               device=device))


def sgc_forward(params: SGCParams, x: torch.Tensor, multi,
                hops: int) -> torch.Tensor:
    """K propagation hops through the decomposition, then the dense
    head."""
    for _ in range(hops):
        x = multi.step(x)
    return params(x)


class SGCModel(nn.Module):
    """Simplified graph convolution over an arrow decomposition.

    The adjacency is fixed (it is the decomposed graph, owned by the
    :class:`MultiLevelArrow`); only the head parameters train — the
    defining property of SGC.
    """

    def __init__(self, multi, k_in: int, k_out: int, hops: int = 2,
                 seed: int = 0):
        super().__init__()
        _check_not_folded(multi, "SGCModel")
        self.multi = multi
        self.hops = hops
        self.params = sgc_init(_generator(seed), k_in, k_out,
                               device=multi.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: flat (total_rows, k_in) in level-0 order -> logits
        (total_rows, k_out)."""
        return sgc_forward(self.params, x, self.multi, self.hops)

    def predict(self, x_original: np.ndarray) -> np.ndarray:
        """Host (n, k_in) features in original row order -> host logits."""
        m = self.multi
        with torch.no_grad():
            return m.gather_result(self(m.set_features(x_original)))


def make_train_step(multi, hops: int,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """Masked-MSE training step for the SGC head.

    Returns ``train_step(params, x, y, mask) -> loss``: one step of
    ``optimizer`` (built over ``params``' parameters), in place; the loss
    is the one before the update.  ``mask`` is a per-row weight (zero for
    padding rows: ``multi.real_row_mask()``).
    """

    def train_step(params, x, y, mask):
        return _optimizer_step(optimizer, lambda: masked_mse(
            sgc_forward(params, x, multi, hops), y, mask, multi), multi)

    return train_step


# ---------------------------------------------------------------------------
# GCN: per-layer weights with a nonlinearity between propagation hops
# (SGC collapses to one head exactly because it drops these).


def gcn_init(generator: torch.Generator, dims: Sequence[int],
             dtype=torch.float32, device=None) -> nn.ModuleList:
    """Per-layer LeCun-normal init; ``dims`` = [k_in, h1, ..., k_out]."""
    return nn.ModuleList(sgc_init(generator, d_in, d_out, dtype, device)
                         for d_in, d_out in zip(dims[:-1], dims[1:]))


def gcn_forward(params: Sequence[SGCParams], x: torch.Tensor,
                multi) -> torch.Tensor:
    """Each layer: propagate through the decomposition, then a dense
    layer; ReLU between layers, raw logits out of the last.  The same
    function on the flat and the fold carriage."""
    for i, p in enumerate(params):
        x = p(multi.step(x))
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def make_gcn_train_step(multi, optimizer: torch.optim.Optimizer
                        ) -> Callable:
    """Masked-MSE training step over the per-layer GCN weights (same
    contract as ``make_train_step``)."""

    def train_step(params, x, y, mask):
        return _optimizer_step(optimizer, lambda: masked_mse(
            gcn_forward(params, x, multi), y, mask, multi), multi)

    return train_step


class GCNModel(nn.Module):
    """Multi-layer GCN over a fixed decomposed adjacency: the deep
    counterpart of :class:`SGCModel` (which is its 1-head collapse)."""

    def __init__(self, multi, dims: Sequence[int], seed: int = 0):
        super().__init__()
        _check_not_folded(multi, "GCNModel")
        self.multi = multi
        self.params = gcn_init(_generator(seed), list(dims),
                               device=multi.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gcn_forward(self.params, x, self.multi)

    def predict(self, x_original: np.ndarray) -> np.ndarray:
        m = self.multi
        with torch.no_grad():
            return m.gather_result(self(m.set_features(x_original)))


# ---------------------------------------------------------------------------
# The carried (fold) models.


class SGCCarried(nn.Module):
    """SGC on the fold carriage.

    SGC's defining property (only the dense head trains) makes the
    propagation a fixed preprocessing: ``X_prop = A^hops X`` runs once
    on the executor, then the head fits on carried positions, the loss
    weighted by ``carried_mask`` so pad positions don't dilute the
    denominator and drag the output bias toward zero.
    """

    def __init__(self, multi, k_in: int, k_out: int, hops: int = 2,
                 seed: int = 0):
        super().__init__()
        _check_carried(multi, "SGCCarried")
        self.multi = multi
        self.hops = hops
        self.params = sgc_init(_generator(seed), k_in, k_out,
                               device=multi.device)

    def propagate(self, x_host: np.ndarray) -> torch.Tensor:
        """Host (n, k_in) -> carried ``(positions, k_in)`` after ``hops``
        applications of the decomposed operator."""
        xt = self.multi.set_features(x_host.astype(np.float32))
        return self.multi.run(xt, self.hops) if self.hops else xt

    def forward(self, xp: torch.Tensor) -> torch.Tensor:
        return self.params(xp)

    def predict(self, x_original: np.ndarray) -> np.ndarray:
        """Host (n, k_in) original order -> host (n, k_out) logits."""
        with torch.no_grad():
            return self.multi.gather_result(self(self.propagate(x_original)))

    def fit(self, x_host: np.ndarray, y_host: np.ndarray, *,
            steps: int = 100,
            optimizer: Optional[OptimizerFactory] = None) -> List[float]:
        """Masked-MSE fit of the head on carried positions; returns the
        per-step losses."""
        xp = self.propagate(x_host)
        yt = self.multi.set_features(y_host.astype(np.float32))
        mask = self.multi.carried_mask()
        return _fit(self, lambda: masked_mse(self(xp), yt, mask,
                                             self.multi), steps,
                    optimizer, self.multi)


class GCNCarried(nn.Module):
    """GCN on the fold carriage: per-layer weights with ReLU between
    propagation steps, gradients flowing through the executor's step
    (its backward, the transposed step), so the same kernels that serve
    inference backpropagate.  The loss is masked by ``carried_mask`` like
    :class:`SGCCarried`."""

    def __init__(self, multi, dims: Sequence[int], seed: int = 0):
        super().__init__()
        _check_carried(multi, "GCNCarried")
        self.multi = multi
        self.params = gcn_init(_generator(seed), list(dims),
                               device=multi.device)

    def forward(self, xt: torch.Tensor) -> torch.Tensor:
        return gcn_forward(self.params, xt, self.multi)

    def predict(self, x_original: np.ndarray) -> np.ndarray:
        m = self.multi
        with torch.no_grad():
            return m.gather_result(self(m.set_features(
                x_original.astype(np.float32))))

    def fit(self, x_host: np.ndarray, y_host: np.ndarray, *,
            steps: int = 100,
            optimizer: Optional[OptimizerFactory] = None) -> List[float]:
        """Masked-MSE fit of every layer; propagation recomputes inside
        each step (the weights sit between hops — GCN's defining
        difference from SGC)."""
        m = self.multi
        xt = m.set_features(x_host.astype(np.float32))
        yt = m.set_features(y_host.astype(np.float32))
        mask = m.carried_mask()
        return _fit(self, lambda: masked_mse(self(xt), yt, mask, m), steps,
                    optimizer, m)


def pagerank_carried(multi, damping: float = 0.85,
                     iterations: int = 50) -> np.ndarray:
    """PageRank on the fold: ``r := d * A_norm r + (1-d)/n`` like
    :func:`pagerank`, with the teleport vector scattered through
    ``set_features``, which places it at every live carried position, so
    the iteration needs no masking."""
    _check_carried(multi, "pagerank_carried")
    n = multi.n
    r = multi.set_features(np.full((n, 1), 1.0 / n, np.float32))
    tele = multi.set_features(
        np.full((n, 1), (1.0 - damping) / n, np.float32))
    for _ in range(iterations):
        # JAX's f32 damping promotes a bf16 step to f32.
        r = damping * multi.step(r).float() + tele
    return multi.gather_result(r)


def label_propagation_carried(multi, labels: np.ndarray,
                              seed_mask: np.ndarray,
                              iterations: int = 20) -> np.ndarray:
    """Label propagation on the fold: ``Y := A_norm Y`` then clamp seed
    rows, like :func:`label_propagation` (same default iteration count);
    the seed values and the seed indicator travel through
    ``set_features``, so clamping is positionwise arithmetic on the
    carriage."""
    _check_carried(multi, "label_propagation_carried")
    labels = labels.astype(np.float32)
    y = multi.set_features(labels)
    seeds = multi.set_features(labels * seed_mask[:, None])
    m = multi.set_features(seed_mask[:, None].astype(np.float32))
    for _ in range(iterations):
        y = torch.where(m > 0, seeds, multi.step(y))
    return multi.gather_result(y)


def _normalize(y: torch.Tensor, m, multi=None) -> torch.Tensor:
    """y / ||y * m|| in f32.  ``m`` is 1.0 for layouts whose pads are
    zero, or the carried mask; on a mesh the norm is the whole mesh's."""
    v = y * m
    if _reduce_axes(multi) is None:
        norm = torch.linalg.vector_norm(v)
    else:
        norm = torch.sqrt(mesh_sum(multi, (v.float() ** 2).sum()))
    return y.float() / torch.clamp(norm, min=1e-30)


def _rayleigh(x: torch.Tensor, y: torch.Tensor, m,
              multi=None) -> torch.Tensor:
    xm, ym = (x * m).reshape(-1), (y * m).reshape(-1)
    dots = mesh_sum(multi, torch.stack([torch.dot(xm, ym),
                                        torch.dot(xm, xm)]))
    return dots[0] / torch.clamp(dots[1], min=1e-30)


def power_iteration(multi, x0: np.ndarray,
                    iterations: int = 50) -> tuple[np.ndarray, float]:
    """Dominant eigenpair by normalized iterated SpMM.

    Returns (eigenvector in original row order, Rayleigh-quotient
    eigenvalue estimate).  ``x0``: host (n, 1) start vector.  Uses only
    ``multi.step`` plus whole-array reductions, so it runs on every
    executor: the per-level ones (pads stay zero) and the fold, whose
    ``carried_mask`` weights the reductions.
    """
    m = multi.carried_mask() if multi.carries_feature_major else 1.0
    x = multi.set_features(x0.astype(np.float32))
    for _ in range(iterations):
        x = _normalize(multi.step(x), m, multi)
    # One more multiply for the Rayleigh quotient x^T A x / x^T x.
    y = multi.step(x)
    lam = float(_rayleigh(x, y, m, multi))
    return multi.gather_result(x), lam


def pagerank(multi, damping: float = 0.85,
             iterations: int = 50) -> np.ndarray:
    """PageRank by damped iterated SpMM: r := d * A_norm r + (1-d)/n.

    ``multi`` must hold the *column-normalized* adjacency (build the
    decomposition from ``A @ D^{-1}``); this function runs the iteration,
    it does not normalize.
    """
    _check_not_folded(multi, "pagerank")
    n = multi.n
    r = multi.set_features(np.full((n, 1), 1.0 / n, dtype=np.float32))
    # Padding rows stay zero: the teleport mass is masked to real rows.
    mask = multi.real_row_mask()
    teleport = float(np.float32((1.0 - damping) / n))
    for _ in range(iterations):
        r = damping * multi.step(r) + teleport * mask
    return multi.gather_result(r)


def label_propagation(multi, labels: np.ndarray, seed_mask: np.ndarray,
                      iterations: int = 20) -> np.ndarray:
    """Semi-supervised label propagation with clamped seeds.

    labels: host (n, c) one-hot (or soft) labels; seed_mask: (n,) bool —
    True rows are clamped to their labels every iteration.
    ``multi`` should hold a row-normalized adjacency for convergence.
    """
    _check_not_folded(multi, "label_propagation")
    y = multi.set_features(labels.astype(np.float32))
    seeds = multi.set_features(
        (labels * seed_mask[:, None]).astype(np.float32))
    clamp = multi.set_features(seed_mask.astype(np.float32)[:, None])
    for _ in range(iterations):
        y = clamp * seeds + (1.0 - clamp) * multi.step(y)
    return multi.gather_result(y)


# ---------------------------------------------------------------------------
# APPNP (Gasteiger et al., "Predict then Propagate", ICLR 2019): one
# trainable prediction head, then personalized-PageRank propagation
#   Z := (1 - alpha) * A_hat Z + alpha * H,   Z_0 = H = head(X)
# which decouples model depth from propagation range.


def appnp_forward(params: SGCParams, x: torch.Tensor, multi, hops: int,
                  alpha: float) -> torch.Tensor:
    """APPNP forward on the flat or the fold carriage: head first, then
    ``hops`` personalized-PageRank steps (the gradient of the head
    crosses every step)."""
    h = params(x)
    z = h
    for _ in range(hops):
        z = (1 - alpha) * multi.step(z)
        z = z + alpha * h
    return z


class APPNPModel(nn.Module):
    """APPNP over the flat executors (mirrors :class:`SGCModel`)."""

    def __init__(self, multi, k_in: int, k_out: int, hops: int = 10,
                 alpha: float = 0.1, seed: int = 0):
        super().__init__()
        _check_not_folded(multi, "APPNPModel")
        self.multi = multi
        self.hops = hops
        self.alpha = alpha
        self.params = sgc_init(_generator(seed), k_in, k_out,
                               device=multi.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return appnp_forward(self.params, x, self.multi, self.hops,
                             self.alpha)

    def predict(self, x_original: np.ndarray) -> np.ndarray:
        m = self.multi
        with torch.no_grad():
            return m.gather_result(self(m.set_features(x_original)))


def make_appnp_train_step(multi, hops: int, alpha: float,
                          optimizer: torch.optim.Optimizer) -> Callable:
    """Masked-MSE train step for the APPNP head (same contract as
    ``make_train_step``); unlike SGC the head sits under the hops, so
    dL/dW crosses every SpMM."""

    def train_step(params, x, y, mask):
        return _optimizer_step(optimizer, lambda: masked_mse(
            appnp_forward(params, x, multi, hops, alpha), y, mask, multi),
            multi)

    return train_step


class APPNPCarried(nn.Module):
    """APPNP on the fold carriage: the head applies row-major, the
    propagation runs through the executor's step with gradients crossing
    it (the :class:`GCNCarried` property), and ``carried_mask`` weights
    the loss."""

    def __init__(self, multi, k_in: int, k_out: int, hops: int = 10,
                 alpha: float = 0.1, seed: int = 0):
        super().__init__()
        _check_carried(multi, "APPNPCarried")
        self.multi = multi
        self.hops = hops
        self.alpha = alpha
        self.params = sgc_init(_generator(seed), k_in, k_out,
                               device=multi.device)

    def forward(self, xt: torch.Tensor) -> torch.Tensor:
        return appnp_forward(self.params, xt, self.multi, self.hops,
                             self.alpha)

    def predict(self, x_original: np.ndarray) -> np.ndarray:
        m = self.multi
        with torch.no_grad():
            return m.gather_result(self(m.set_features(
                x_original.astype(np.float32))))

    def fit(self, x_host: np.ndarray, y_host: np.ndarray, *,
            steps: int = 100,
            optimizer: Optional[OptimizerFactory] = None) -> List[float]:
        m = self.multi
        xt = m.set_features(x_host.astype(np.float32))
        yt = m.set_features(y_host.astype(np.float32))
        mask = m.carried_mask()
        return _fit(self, lambda: masked_mse(self(xt), yt, mask, m), steps,
                    optimizer, m)


# ---------------------------------------------------------------------
# Conjugate gradient on the SpMM operator: solving (shift*I + A) x = b
# exercises exactly one SpMM plus axpy/dot per iteration.


def _cg_iter(multi, x, r, p, rz, shift: float, mask):
    """One CG iteration in carried layout; the reductions are masked by
    ``carried_mask`` and summed in float32 (on a mesh, over the whole
    mesh: every rank gets the same scalars, so with ``tol > 0`` all
    ranks stop at the same iteration).  A bf16 ``p`` (the first
    iteration's, on a bf16 carriage) is stepped as it is and promoted to
    f32 everywhere else, as the JAX package's f32 shift promotes it."""
    ap = shift * p.float() + multi.step(p).float()
    p = p.float()
    denom = mesh_sum(multi, (p * ap * mask).sum(dtype=torch.float32))
    alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
    x = x + alpha * p
    r = r - alpha * ap
    rz_new = mesh_sum(multi, (r * r * mask).sum(dtype=torch.float32))
    beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
    p = r + beta * p
    return x, r, p, rz_new


def conjugate_gradient(multi, b: np.ndarray, *, shift: float,
                       iterations: int = 50,
                       tol: float = 0.0) -> tuple[np.ndarray, float]:
    """Solve ``(shift*I + A) x = b`` by CG on the fold.

    ``A`` is the executor's (symmetric) operator; ``shift`` must make
    ``shift*I + A`` positive definite — for a symmetric adjacency any
    ``shift > max degree`` suffices (strict diagonal dominance).
    ``b`` is (n, k); each feature column is an independent system (the
    dots reduce over carried positions per column and sum: one shared
    step).  Returns ``(x, final_residual_norm)`` with ``x`` gathered to
    host order.

    ``tol`` > 0 stops early when ||r|| / ||b|| drops below it (checked
    on host once per iteration — one scalar fetch; pass 0 to run a fixed
    count with no host syncs).
    """
    _check_carried(multi, "conjugate_gradient")
    b = np.asarray(b, dtype=np.float32)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    bt = multi.set_features(b)
    mask = multi.carried_mask()
    x = torch.zeros_like(bt)
    r = bt
    p = bt
    rz = mesh_sum(multi, (r * r * mask).sum(dtype=torch.float32))
    # Host syncs only in tol mode: the fixed-count path stays
    # asynchronous until the final gather.
    b_norm = float(torch.sqrt(rz)) if tol > 0.0 else None
    for _ in range(iterations):
        x, r, p, rz = _cg_iter(multi, x, r, p, rz, shift, mask)
        if tol > 0.0 and float(torch.sqrt(rz)) <= tol * max(b_norm, 1e-30):
            break
    out = multi.gather_result(x)
    if squeeze:
        out = out[:, 0]
    return out, float(torch.sqrt(rz))

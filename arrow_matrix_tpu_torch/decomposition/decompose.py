"""Offline arrow decomposition of a sparse matrix (host side).

The port's own copy of ``arrow_matrix_tpu/decomposition/decompose.py``
with both of its backends: numpy/scipy (``linearize.py``, the default)
and the C++ kernels (``native.py``).  Decomposes a square sparse matrix ``A`` into
levels ``B_0..B_{K-1}`` with permutations ``sigma_0..sigma_{K-1}`` such
that ``A = sum_i P_i^T B_i P_i``.  Each ``B_i`` is arrow-shaped:
nonzeros only in the first ``width`` rows, the first ``width`` columns,
and a band (or the block diagonal) of width ``width``.

Per level: prune the ``width`` highest-degree vertices to the front,
linearize the rest by random-spanning-forest DFS, keep the edges that
fit the arrow, recurse on the remainder.  For one seed and backend the
levels and permutations are identical to the JAX package's.
``AMT_DECOMP_PROFILE=1`` prints each phase's seconds to stderr.
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
from scipy import sparse

from arrow_matrix_tpu_torch.decomposition.linearize import (
    bfs_order,
    random_forest_order,
)
from arrow_matrix_tpu_torch.utils.graphs import symmetrize

BACKENDS = ("auto", "native", "numpy")


@contextmanager
def _phase(label: str):
    """Phase timer of the offline pipeline: with ``AMT_DECOMP_PROFILE``
    set, prints the phase's wall seconds to stderr."""
    if not os.environ.get("AMT_DECOMP_PROFILE"):
        yield
        return
    t0 = time.perf_counter()
    yield
    print(f"[decomp] {label}: {time.perf_counter() - t0:.2f}s",
          file=sys.stderr, flush=True)


@dataclass
class ArrowLevel:
    """One level of an arrow decomposition.

    matrix:       the permuted, arrow-shaped sparse matrix B_i (CSR).
    permutation:  sigma_i; ``permutation[r]`` is the original index of
                  row r of ``matrix``.
    arrow_width:  the width bound satisfied by ``matrix`` (the last level
                  may exceed the requested width).
    """

    matrix: sparse.csr_matrix
    permutation: np.ndarray
    arrow_width: int

    @property
    def nonzero_rows(self) -> int:
        """Number of structurally nonzero rows/cols."""
        sym = self.matrix + self.matrix.T
        return int(np.count_nonzero(np.diff(sym.tocsr().indptr)))

    @property
    def inverse_permutation(self) -> np.ndarray:
        """``inverse_permutation[v]`` is the row of ``matrix`` that holds
        original vertex ``v``."""
        return np.argsort(self.permutation)


def achieved_width(coo_rows: np.ndarray, coo_cols: np.ndarray,
                   width: int) -> int:
    """Smallest band width >= ``width`` covering all edges outside the
    arrow head (rows/cols < width are head edges and always covered)."""
    outside = (coo_rows >= width) & (coo_cols >= width)
    if not np.any(outside):
        return width
    return max(width,
               int(np.max(np.abs(coo_rows[outside] - coo_cols[outside]))))


def _resolve_backend(backend: str):
    """The linearization functions ``(bfs, forest)`` of ``backend``:
    "numpy" the scipy/csgraph ones (``linearize.py``), "native" the C++
    kernels (``native.py``; an error if they do not build or load),
    "auto" native when it loads and numpy otherwise.  This picks a host
    decomposer; it has nothing to do with the device."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "numpy":
        return bfs_order, random_forest_order
    from arrow_matrix_tpu_torch.decomposition import native

    if native.available():
        return native.bfs_order, native.random_forest_order
    if backend == "native":
        raise RuntimeError(
            f"backend='native' requested but the native decomposer "
            f"failed to build/load: {native.load_error()}")
    return bfs_order, random_forest_order


def resolved_backend(backend: str) -> str:
    """"native" or "numpy": what ``backend`` runs on this host."""
    _, forest = _resolve_backend(backend)
    return "numpy" if forest is random_forest_order else "native"


def _linear_order(a: sparse.csr_matrix, width: int, deterministic: bool,
                  rng: np.random.Generator,
                  backend: str = "auto") -> np.ndarray:
    """Level ordering: width highest-degree vertices first, then the
    forest-linearized middle, then zero-degree singletons."""
    n = a.shape[0]
    bfs_fn, forest_fn = _resolve_backend(backend)
    from arrow_matrix_tpu_torch.decomposition import native as _native

    # The all-native path: the symmetric structure without values (no
    # scipy A + A.T) feeding the masked forest kernel, no submatrix
    # built.  The structure equals symmetrize()'s, so the levels equal
    # the native backend's through scipy.
    native_path = (not deterministic
                   and forest_fn is _native.random_forest_order
                   and n < np.iinfo(np.int32).max)
    with _phase("symmetrize"):
        if native_path:
            sym = _native.symmetrize_structure(a)   # (indptr, indices)
            deg = np.diff(sym[0])
        else:
            sym = symmetrize(a)
            deg = np.diff(sym.indptr)

    with _phase("degree-argsort"):
        by_degree = np.argsort(-deg, kind="stable")
    head = by_degree[:width]
    tail = by_degree[width:]
    tail_deg = deg[tail]
    middle = tail[tail_deg > 0]
    singletons = tail[tail_deg == 0]

    if middle.size:
        if native_path:
            with _phase("forest-native"):
                sub_order = _native.random_forest_order_masked(
                    sym, middle, rng, base_size=min(width - 1, 16))
        else:
            sub = sym[middle][:, middle]
            if deterministic:
                sub_order = bfs_fn(sub)
            else:
                sub_order = forest_fn(sub, rng,
                                      base_size=min(width - 1, 16))
        middle_order = middle[sub_order]
    else:
        middle_order = middle

    order = np.concatenate([head, middle_order, singletons])
    if order.size != n:
        raise AssertionError(f"linear order covers {order.size} of {n} rows")
    return order.astype(np.int64)


def _single_banded_level(a: sparse.csr_matrix,
                         perm: np.ndarray | None,
                         arrow_width: int) -> ArrowLevel:
    """One-level decomposition of an (optionally reordered) banded
    matrix, reported at the REQUESTED width (the artifact file names
    use the level-0 width)."""
    if perm is None:
        b = a.copy()
        perm = np.arange(a.shape[0], dtype=np.int64)
    else:
        b = a[perm][:, perm].tocsr()
    b.sum_duplicates()
    b.sort_indices()
    return ArrowLevel(matrix=b, permutation=perm, arrow_width=arrow_width)


def arrow_decomposition(a: sparse.spmatrix,
                        arrow_width: int = 512,
                        max_levels: int = 2,
                        block_diagonal: bool = False,
                        prune: bool = True,
                        seed: int | None = None,
                        backend: str = "numpy",
                        band_detect: bool = True) -> list[ArrowLevel]:
    """Compute an arrow decomposition of a square sparse matrix.

    :param a: square sparse matrix (any scipy format; values preserved).
    :param arrow_width: desired head / band / block width.  The last
        level keeps all remaining edges and may report a larger
        ``arrow_width``.
    :param max_levels: maximum number of levels.
    :param block_diagonal: if True, in-level edges must fall in
        width-by-width blocks on the diagonal; otherwise a band.
    :param prune: place the ``arrow_width`` highest-degree vertices first.
    :param seed: RNG seed for the random-spanning-forest linearization.
    :param backend: linearization implementation: "numpy" (scipy/
        csgraph, the default), "native" (the C++ kernels of
        ``native.py``) or "auto" (native when it loads).  The two use
        different random streams, so for one seed the levels depend on
        the backend; the default is "numpy" so that seeded results never
        depend on the toolchain.
    :param band_detect: return ONE level for banded/bandable inputs
        (identity or reverse-Cuthill-McKee order within the width).
    """
    a = a.tocsr()
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"matrix must be square, got {a.shape}")
    if arrow_width > a.shape[0]:
        raise ValueError(
            f"arrow_width {arrow_width} exceeds matrix side {a.shape[0]}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")

    if a.nnz and band_detect:
        coo = a.tocoo()
        bw = achieved_width(coo.row.astype(np.int64),
                            coo.col.astype(np.int64), 0)
        if bw <= arrow_width:
            return [_single_banded_level(a, None, arrow_width)]
        # Bandable under reverse Cuthill-McKee?  Cheap necessary
        # condition first: a band of half-width w holds <= 2w+1 entries
        # per symmetric row.
        row_deg = np.diff(a.indptr)
        col_deg = np.bincount(coo.col, minlength=a.shape[0])
        ub = int((row_deg + col_deg).max())
        if ub <= 2 * (2 * arrow_width + 1):
            sym = symmetrize(a)
            max_deg = int(np.diff(sym.indptr).max()) if sym.nnz else 0
            if max_deg <= 2 * arrow_width + 1:
                from scipy.sparse import csgraph

                rcm = np.asarray(csgraph.reverse_cuthill_mckee(
                    sym, symmetric_mode=True), dtype=np.int64)
                inv = np.argsort(rcm)
                bw = achieved_width(inv[coo.row], inv[coo.col], 0)
                if bw <= arrow_width:
                    return [_single_banded_level(a, rcm, arrow_width)]

    rng = np.random.default_rng(seed)
    levels: list[ArrowLevel] = []
    _decompose(a, arrow_width, levels, max_levels, block_diagonal, prune,
               rng, backend)
    return levels


def _decompose(a: sparse.csr_matrix, width: int, levels: list[ArrowLevel],
               max_levels: int, block_diagonal: bool, prune: bool,
               rng: np.random.Generator, backend: str = "auto") -> None:
    n = a.shape[0]
    last = len(levels) + 1 >= max_levels

    with _phase("linear-order-total"):
        order = _linear_order(a, width, deterministic=last, rng=rng,
                              backend=backend)
    with _phase("inv-argsort"):
        inv = np.argsort(order)
        if n < np.iinfo(np.int32).max:
            inv = inv.astype(np.int32)

    if not last:
        # The fused native split: one C++ pass in place of the
        # tocoo/gather/select/two-CSR-build chain below, equal to it on
        # duplicate-free inputs.  Its in-level edges satisfy the band or
        # block criterion, so the level's width is `width`.
        from arrow_matrix_tpu_torch.decomposition import native as _native

        if (backend in ("auto", "native") and _native.available()
                and n < np.iinfo(np.int32).max):
            try:
                with _phase("native-level-split"):
                    b, rest_m = _native.level_split(
                        a, inv, width, block_diagonal, prune)
                levels.append(ArrowLevel(b, order, width))
                if rest_m is not None:
                    _decompose(rest_m, width, levels, max_levels,
                               block_diagonal, prune, rng, backend)
                return
            except _native.LevelSplitUnsupported:
                pass   # the numpy path below covers the degenerate cases

    with _phase("coo-permute"):
        coo = a.tocoo()
        r = inv[coo.row]  # positions in the new order
        c = inv[coo.col]

    if not last:
        with _phase("edge-select"):
            if block_diagonal:
                in_level = (r // width) == (c // width)
            else:
                in_level = np.abs(r - c) <= width
            if prune:
                in_level |= (r < width) | (c < width)
            if not np.any(in_level):
                in_level = np.ones(r.size, dtype=bool)
            rest = ~in_level

        with _phase("level-csr-build"):
            b = sparse.csr_matrix(
                (coo.data[in_level], (r[in_level], c[in_level])),
                shape=(n, n))
            b.sum_duplicates()
            b.sort_indices()
        # The all-False fallback above keeps every edge, so the level's
        # width bound is whatever those edges achieve.
        levels.append(ArrowLevel(b, order,
                                 achieved_width(r[in_level], c[in_level],
                                                width)))
        if np.any(rest):
            # Remainder keeps original indexing; recursion re-linearizes.
            with _phase("rest-csr-build"):
                a_rest = sparse.csr_matrix(
                    (coo.data[rest], (coo.row[rest], coo.col[rest])),
                    shape=(n, n))
            _decompose(a_rest, width, levels, max_levels, block_diagonal,
                       prune, rng, backend)
    else:
        # Last level: keep everything, report the width actually achieved.
        with _phase("level-csr-build"):
            b = sparse.csr_matrix((coo.data, (r, c)), shape=(n, n))
            b.sum_duplicates()
            b.sort_indices()
        levels.append(ArrowLevel(b, order, achieved_width(r, c, width)))


def reconstruct(levels: list[ArrowLevel]) -> sparse.csr_matrix:
    """Un-permute and sum all levels: returns sum_i P_i^T B_i P_i,
    which must equal the decomposed matrix (the core invariant)."""
    n = levels[0].matrix.shape[0]
    total = sparse.csr_matrix((n, n), dtype=levels[0].matrix.dtype)
    for lvl in levels:
        p = lvl.permutation
        coo = lvl.matrix.tocoo()
        total = total + sparse.csr_matrix(
            (coo.data, (p[coo.row], p[coo.col])), shape=(n, n))
    total.sum_duplicates()
    total.sort_indices()
    return total.tocsr()


def decomposition_spmm(levels: list[ArrowLevel],
                       x: np.ndarray) -> np.ndarray:
    """Golden host-side SpMM through the decomposition:
    ``A @ X = sum_i (B_i @ X[sigma_i])[inv sigma_i]``.

    The scatter ``out[sigma_i] += partial`` adds the same values in the
    same level order as the JAX package's ``partial[inv sigma_i]``
    gather (bit-identical), without an argsort per level per call."""
    out = np.zeros_like(x)
    for lvl in levels:
        out[lvl.permutation] += lvl.matrix @ x[lvl.permutation]
    return out

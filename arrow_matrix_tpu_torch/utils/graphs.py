"""Synthetic graph / matrix generators (host side, numpy/scipy).

The port's own copy of ``arrow_matrix_tpu/utils/graphs.py``.  Same numpy
generator, same draws: a seed
gives byte-identical arrays in both packages, which is what lets the
tests feed one input to both.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse


def symmetrize(a: sparse.spmatrix) -> sparse.csr_matrix:
    """Structural symmetrization: pattern of A + A^T with unit-ish data.

    Used for linearization, which operates on the undirected structure of
    (possibly directed) input graphs.
    """
    a = a.tocsr()
    s = (a + a.T).tocsr()
    s.sum_duplicates()
    s.sort_indices()
    return s


def barabasi_albert(n: int, m: int, seed: int | None = None,
                    directed: bool = False) -> sparse.csr_matrix:
    """Barabasi-Albert preferential-attachment graph as a CSR adjacency.

    Each new vertex attaches to ``m`` distinct existing vertices chosen
    proportionally to their current degree (the classic repeated-nodes
    construction).  Undirected graphs get both edge directions.
    """
    if n < m + 1:
        raise ValueError(f"need n > m (got n={n}, m={m})")
    rng = np.random.default_rng(seed)

    # Preallocated endpoint pool: every accepted edge contributes both of
    # its endpoints, so uniform sampling from the filled prefix is
    # degree-proportional sampling.
    pool = np.empty(2 * m * n, dtype=np.int64)
    # Seed star over the first m+1 vertices: every vertex starts with
    # degree >= 1.
    pool[0:2 * m:2] = np.arange(m)
    pool[1:2 * m:2] = m
    fill = 2 * m

    row = np.empty(m * n, dtype=np.int64)
    col = np.empty(m * n, dtype=np.int64)
    row[:m] = np.arange(m)
    col[:m] = m
    e = m

    for v in range(m + 1, n):
        # Rejection-sample m *distinct* degree-proportional targets;
        # dedup keeps first-seen order (sorted-unique truncation would
        # bias toward low vertex ids).
        picks = pool[rng.integers(0, fill, size=2 * m)]
        while np.unique(picks).size < m:
            picks = np.concatenate(
                [picks, pool[rng.integers(0, fill, size=2 * m)]])
        _, first = np.unique(picks, return_index=True)
        tgt = picks[np.sort(first)][:m]
        row[e:e + m] = v
        col[e:e + m] = tgt
        e += m
        pool[fill:fill + m] = v
        pool[fill + m:fill + 2 * m] = tgt
        fill += 2 * m

    row = row[:e]
    col = col[:e]
    data = np.ones(row.size, dtype=np.float32)
    a = sparse.csr_matrix((data, (row, col)), shape=(n, n))
    if not directed:
        a = a + a.T
    a = a.tocsr()
    a.data[:] = 1.0
    a.sum_duplicates()
    a.sort_indices()
    return a


def erdos_renyi(n: int, p: float, seed: int | None = None,
                directed: bool = False) -> sparse.csr_matrix:
    """G(n, p) random graph as CSR adjacency (no self loops)."""
    rng = np.random.default_rng(seed)
    a = sparse.random(n, n, density=p, format="coo", random_state=rng,
                      data_rvs=lambda k: np.ones(k, dtype=np.float32))
    mask = a.row != a.col
    a = sparse.csr_matrix((a.data[mask], (a.row[mask], a.col[mask])),
                          shape=(n, n))
    if not directed:
        a = a + a.T
        a = a.tocsr()
        a.data[:] = 1.0
    a.sum_duplicates()
    a.sort_indices()
    return a


def random_csr(rows: int, cols: int, nnz_per_row: int,
               seed: int | None = None, dtype=np.float32) -> sparse.csr_matrix:
    """Random CSR with a fixed number of nonzeros per row, uniform
    [-1, 1) values (the same draws as the JAX package's)."""
    rng = np.random.default_rng(seed)
    nnz_per_row = min(nnz_per_row, cols)
    indices = np.empty((rows, nnz_per_row), dtype=np.int64)
    for r in range(rows):
        indices[r] = rng.choice(cols, size=nnz_per_row, replace=False)
    indptr = np.arange(rows + 1, dtype=np.int64) * nnz_per_row
    data = rng.uniform(-1.0, 1.0, size=rows * nnz_per_row).astype(dtype)
    a = sparse.csr_matrix((data, indices.ravel(), indptr), shape=(rows, cols))
    a.sum_duplicates()
    a.sort_indices()
    return a


def random_dense(rows: int, cols: int, seed: int | None = None,
                 dtype=np.float32) -> np.ndarray:
    """Uniform [-1, 1) dense matrix."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=(rows, cols)).astype(dtype)


def grid_graph(side: int, dtype=np.float32) -> sparse.csr_matrix:
    """``side`` x ``side`` 2-D lattice adjacency (4 neighbours), the
    canonical planar graph, the class the paper's communication bound is
    proved for.  Under a row-major order the adjacency is banded with
    bandwidth ``side``, so the arrow decomposition ends after one level
    at width >= ``side``."""
    eye = sparse.identity(side, dtype=dtype, format="csr")
    line = sparse.diags([1, 1], [-1, 1], shape=(side, side),
                        dtype=dtype, format="csr")
    a = sparse.kron(eye, line) + sparse.kron(line, eye)
    a = a.tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return a.astype(dtype)

"""Shared CLI plumbing: flag parsing and matrix loading.

The port's copy of the host half of ``arrow_matrix_tpu/cli/common.py``:
``str2bool``, ``load_sparse_matrix`` (``.npz``, ``.mtx``, ``.mat``
including MATLAB v7.3 through h5py), ``random_adjacency`` and
``normalize_scale``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy import sparse


def str2bool(v) -> bool:
    """Boolean flag parser (yes/no, true/false, t/f, y/n, 1/0)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def load_sparse_matrix(path: str, dtype=np.float32) -> sparse.csr_matrix:
    """Load a sparse matrix from .npz (scipy), .mtx (matrix market) or
    .mat (MATLAB), by extension, as canonical CSR of ``dtype``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        m = sparse.load_npz(path)
    elif ext in (".mtx", ".mm"):
        from scipy.io import mmread

        m = mmread(path)
    elif ext == ".mat":
        m = _load_matlab(path)
    else:
        raise ValueError(f"unsupported matrix format {ext!r} "
                         f"(expected .npz, .mtx, or .mat)")
    m = sparse.csr_matrix(m).astype(dtype)
    m.sum_duplicates()
    m.sort_indices()
    return m


def _load_matlab(path: str) -> sparse.spmatrix:
    from scipy.io import loadmat

    try:
        contents = loadmat(path)
    except NotImplementedError:
        return _load_matlab_hdf5(path)   # v7.3 files are HDF5
    for v in contents.values():
        if sparse.issparse(v):
            return v
    raise ValueError(f"no sparse matrix found in {path}")


def _load_matlab_hdf5(path: str) -> sparse.spmatrix:
    """MATLAB v7.3 (HDF5) sparse matrix through h5py: a group with CSC
    datasets ``data``/``ir``/``jc`` and the row count in its
    ``MATLAB_sparse`` attribute; ``Problem/A`` (the SuiteSparse
    layout) first, then the first sparse-tagged group."""
    try:
        import h5py
    except ImportError:
        raise ValueError(
            f"{path} is a MATLAB v7.3 (HDF5) file and h5py is not "
            f"available; convert it to .npz or .mtx first")

    def as_csc(node):
        jc = np.asarray(node["jc"], dtype=np.int64)
        ir = np.asarray(node["ir"], dtype=np.int64)
        data = (np.asarray(node["data"]) if "data" in node
                else np.ones(ir.size, dtype=np.float32))
        n_rows = int(node.attrs["MATLAB_sparse"])
        return sparse.csc_matrix((data, ir, jc), shape=(n_rows, jc.size - 1))

    with h5py.File(path, "r") as f:
        if ("Problem" in f and "A" in f["Problem"]
                and "MATLAB_sparse" in f["Problem"]["A"].attrs):
            return as_csc(f["Problem"]["A"])
        found = []

        def visit(name, node):
            if isinstance(node, h5py.Group) and "MATLAB_sparse" in node.attrs:
                found.append(name)

        f.visititems(visit)
        if found:
            return as_csc(f[found[0]])
    raise ValueError(f"no MATLAB sparse matrix found in HDF5 file {path}")


def random_adjacency(vertices: int, edges: int, seed: int,
                     dtype=np.float32) -> sparse.csr_matrix:
    """Random graph with about ``edges`` nonzeros (a fixed count a
    row)."""
    from arrow_matrix_tpu_torch.utils.graphs import random_csr

    nnz_per_row = max(1, edges // max(vertices, 1))
    return random_csr(vertices, vertices, nnz_per_row,
                      seed=seed).astype(dtype)


def normalize_scale(a: sparse.csr_matrix) -> sparse.csr_matrix:
    """Scale so that iterated SpMM stays bounded (the benchmark loops
    feed the output back as the next input)."""
    s = max(abs(a).sum(axis=1).max(), 1.0)
    return (a / s).tocsr().astype(a.dtype)

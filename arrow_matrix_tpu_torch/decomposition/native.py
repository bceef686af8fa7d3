"""ctypes loader for the native linearization kernels (host C++).

The port's copy of ``arrow_matrix_tpu/decomposition/native.py``.  The
shared library is built from ``_native/fast_decomp.cpp`` (the same
source as the JAX package's, byte for byte, so that one seed draws the
same random numbers in both) with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` at first use, and loaded with ``ctypes``.

It is built into ``arrow_matrix_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by the hash of the source and the
flags, as ``ops/_build.py`` keys the kernel libraries, never next to
the source.  The build writes a ``mkstemp`` name and ``os.replace``\\ s
it into place, so processes that build at once never load a
half-written library.  ``AMT_DECOMP_THREADS`` caps the C++ thread pool
(the C++ reads it).

Public surface:

    available() -> bool
    load_error() -> Exception | None
    random_forest_order(adj_sym, rng, base_size) -> order
    random_forest_order_masked(adj_sym, active, rng, base_size) -> order
    symmetrize_structure(a) -> (indptr, indices)
    level_split(a, inv, width, block_diagonal, prune) -> (level, rest)
    bfs_order(adj_sym, base_size) -> order

Both backends satisfy the decomposition invariants; their random
orders differ (different random streams), as the reference's Julia and
Python decomposers differ.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
from scipy import sparse

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "_native", "fast_decomp.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: Exception | None = None


def lib_path() -> str:
    """Where the library for the current source and flags lives."""
    with open(SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libfast_decomp_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native decomposer build failed "
                f"({' '.join(cmd)}):\n{proc.stderr}")
        # mkstemp creates 0600; other users of a shared checkout load it.
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    for suffix, idxp in (("", i64p), ("_i32", i32p)):
        f = getattr(lib, "amt_random_forest_order" + suffix)
        f.argtypes = [ctypes.c_int64, i64p, idxp, ctypes.c_uint64,
                      ctypes.c_int64, i64p]
        f.restype = ctypes.c_int
        f = getattr(lib, "amt_random_forest_order_masked" + suffix)
        f.argtypes = [ctypes.c_int64, i64p, idxp, ctypes.c_uint64,
                      ctypes.c_int64, ctypes.c_int64, i64p, i64p]
        f.restype = ctypes.c_int
        f = getattr(lib, "amt_bfs_order" + suffix)
        f.argtypes = [ctypes.c_int64, i64p, idxp, ctypes.c_int64, i64p]
        f.restype = ctypes.c_int
        f = getattr(lib, "amt_symmetrize_structure" + suffix)
        f.argtypes = [ctypes.c_int64, i64p, idxp, i64p, i32p]
        f.restype = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    for isuf, idxp in (("i32", i32p), ("i64", i64p)):
        for vsuf, valp in (("f32", f32p), ("f64", f64p)):
            f = getattr(lib, f"amt_level_split_{isuf}_{vsuf}")
            f.argtypes = [ctypes.c_int64, i64p, idxp, valp, i32p,
                          ctypes.c_int64, ctypes.c_int, ctypes.c_int, i64p,
                          i32p, valp, i64p, i32p, valp, i64p]
            f.restype = ctypes.c_int


def _load() -> ctypes.CDLL | None:
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        except Exception as e:   # no compiler, failed build or load
            _load_error = e
        return _lib


def available() -> bool:
    """True when the native library is (or can be) loaded."""
    return _load() is not None


def load_error() -> Exception | None:
    """The build or load failure, for the errors of backend='native'."""
    _load()
    return _load_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decomposer unavailable: {_load_error}")
    return lib


def _csr_native(adj_or_pair) -> tuple[np.ndarray, np.ndarray]:
    """(indptr int64, indices int32 or int64) for the native calls;
    int32 indices pass through uncopied (the ``_i32`` entry points)."""
    if isinstance(adj_or_pair, tuple):
        indptr, indices = adj_or_pair
    else:
        indptr, indices = adj_or_pair.indptr, adj_or_pair.indices
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    if indices.dtype == np.int32:
        indices = np.ascontiguousarray(indices)
    else:
        indices = np.ascontiguousarray(indices, dtype=np.int64)
    return indptr, indices


def _idx_fn(lib, name: str, indices: np.ndarray):
    return getattr(lib, name + ("_i32" if indices.dtype == np.int32 else ""))


def _ptr(a: np.ndarray):
    if a.dtype == np.int32:
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def random_forest_order(adj_sym: sparse.csr_matrix,
                        rng: np.random.Generator,
                        base_size: int = 16) -> np.ndarray:
    """Random-spanning-forest linearization (the contract of
    ``linearize.random_forest_order``)."""
    lib = _require()
    n = adj_sym.shape[0]
    out = np.empty(n, dtype=np.int64)
    if n == 0:
        return out
    indptr, indices = _csr_native(adj_sym)
    seed = int(rng.integers(0, 2**63 - 1))
    rc = _idx_fn(lib, "amt_random_forest_order", indices)(
        n, _ptr(indptr), _ptr(indices), seed, int(base_size), _ptr(out))
    if rc != 0:
        raise RuntimeError(f"native random_forest_order failed (rc={rc})")
    return out


def random_forest_order_masked(adj_sym, active: np.ndarray,
                               rng: np.random.Generator,
                               base_size: int = 16) -> np.ndarray:
    """Forest order of the induced submatrix ``adj_sym[active][:,
    active]`` (positions into ``active``) without building it: one
    O(n + m) native pass.  ``adj_sym`` is a CSR matrix or the raw
    ``(indptr, indices)`` pair of :func:`symmetrize_structure`."""
    lib = _require()
    indptr, indices = _csr_native(adj_sym)
    n = int(indptr.size - 1)
    k = int(active.size)
    out = np.empty(k, dtype=np.int64)
    if k == 0:
        return out
    act = np.ascontiguousarray(active, dtype=np.int64)
    seed = int(rng.integers(0, 2**63 - 1))
    rc = _idx_fn(lib, "amt_random_forest_order_masked", indices)(
        n, _ptr(indptr), _ptr(indices), seed, int(base_size), k,
        _ptr(act), _ptr(out))
    if rc != 0:
        raise RuntimeError(
            "native random_forest_order_masked failed "
            f"(rc={rc}: invalid subset or non-permutation output)")
    return out


def symmetrize_structure(a: sparse.csr_matrix
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Sorted, deduplicated CSR structure of ``A + A^T`` as a raw
    ``(indptr int64, indices int32)`` pair (no values: the linear order
    reads only the pattern).  Rows of ``a`` need not be canonical.
    Requires n < 2^31."""
    lib = _require()
    n = a.shape[0]
    if n >= np.iinfo(np.int32).max:
        raise ValueError(f"native symmetrize requires n < 2^31, got {n}")
    indptr, indices = _csr_native(a)
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(max(2 * int(indptr[-1]), 1), dtype=np.int32)
    sym_nnz = _idx_fn(lib, "amt_symmetrize_structure", indices)(
        n, _ptr(indptr), _ptr(indices), _ptr(out_indptr),
        _ptr(out_indices))
    if sym_nnz < 0:
        raise RuntimeError(f"native symmetrize failed (rc={sym_nnz})")
    return out_indptr, out_indices[:sym_nnz]


class LevelSplitUnsupported(Exception):
    """The fused native split does not cover this input (dtype,
    n >= 2^31, or the all-False selection): the caller takes the numpy
    path."""


def level_split(a: sparse.csr_matrix, inv: np.ndarray, width: int,
                block_diagonal: bool, prune: bool
                ) -> tuple[sparse.csr_matrix, sparse.csr_matrix | None]:
    """One level's edge routing in one native pass: ``(level, rest)``,
    ``level`` canonical CSR in permuted coordinates, ``rest`` CSR in the
    original coordinates (not canonical) or None when every edge fit the
    level.  Raises :class:`LevelSplitUnsupported` for inputs the kernel
    does not cover."""
    lib = _require()
    n = a.shape[0]
    if n >= np.iinfo(np.int32).max:
        raise LevelSplitUnsupported(f"n={n} >= 2^31")
    if a.data.dtype == np.float32:
        vsuf, vdt, vct = "f32", np.float32, ctypes.c_float
    elif a.data.dtype == np.float64:
        vsuf, vdt, vct = "f64", np.float64, ctypes.c_double
    else:
        raise LevelSplitUnsupported(f"dtype {a.data.dtype}")
    indptr, indices = _csr_native(a)
    isuf = "i32" if indices.dtype == np.int32 else "i64"
    data = np.ascontiguousarray(a.data, dtype=vdt)
    inv32 = np.ascontiguousarray(inv, dtype=np.int32)
    nnz = int(indptr[-1])
    lvl_indptr = np.empty(n + 1, dtype=np.int64)
    lvl_indices = np.empty(max(nnz, 1), dtype=np.int32)
    lvl_data = np.empty(max(nnz, 1), dtype=vdt)
    rest_indptr = np.empty(n + 1, dtype=np.int64)
    rest_indices = np.empty(max(nnz, 1), dtype=np.int32)
    rest_data = np.empty(max(nnz, 1), dtype=vdt)
    counts = np.zeros(2, dtype=np.int64)
    valp = ctypes.POINTER(vct)
    fn = getattr(lib, f"amt_level_split_{isuf}_{vsuf}")
    rc = fn(n, _ptr(indptr), _ptr(indices), data.ctypes.data_as(valp),
            _ptr(inv32), int(width), int(bool(block_diagonal)),
            int(bool(prune)), _ptr(lvl_indptr), _ptr(lvl_indices),
            lvl_data.ctypes.data_as(valp), _ptr(rest_indptr),
            _ptr(rest_indices), rest_data.ctypes.data_as(valp),
            _ptr(counts))
    if rc == 4:
        raise LevelSplitUnsupported("all-False selection fallback")
    if rc != 0:
        raise RuntimeError(f"native level_split failed (rc={rc})")
    ln, rn = int(counts[0]), int(counts[1])
    # Copy the trims: a slice would keep the full-nnz buffers alive
    # through the whole recursion.
    lvl = sparse.csr_matrix(
        (lvl_data[:ln].copy(), lvl_indices[:ln].copy(), lvl_indptr),
        shape=(n, n))
    # The kernel emits canonical rows (sorted, deduplicated).
    lvl.has_canonical_format = True
    lvl.has_sorted_indices = True
    if rn == 0:
        return lvl, None
    rest = sparse.csr_matrix(
        (rest_data[:rn].copy(), rest_indices[:rn].copy(), rest_indptr),
        shape=(n, n))
    return lvl, rest


def bfs_order(adj_sym: sparse.csr_matrix, base_size: int = 2) -> np.ndarray:
    """Deterministic per-component BFS linearization."""
    lib = _require()
    n = adj_sym.shape[0]
    out = np.empty(n, dtype=np.int64)
    if n == 0:
        return out
    indptr, indices = _csr_native(adj_sym)
    rc = _idx_fn(lib, "amt_bfs_order", indices)(
        n, _ptr(indptr), _ptr(indices), int(base_size), _ptr(out))
    if rc != 0:
        raise RuntimeError(f"native bfs_order failed (rc={rc})")
    return out

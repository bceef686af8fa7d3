"""Decomposition artifact I/O (the port's own copy of
``arrow_matrix_tpu/io/graphio.py``).

It reads and writes the same files as the JAX package — the npy-triplet
scheme with its sha256 sidecar manifest:

    {base}_B_{width}_{i}[_bd]_indptr.npy
    {base}_B_{width}_{i}[_bd]_indices.npy
    {base}_B_{width}_{i}[_bd]_data.npy        (optional; absent => ones)
    {base}_B_{width}_{i}[_bd]_permutation.npy
    {base}_B_{width}_0[_bd]_nnzrows.npy
    {base}_B_{width}_0[_bd]_widths.npy
    {base}_B_{width}[_bd]_manifest.json

and the legacy single-file scheme (``save_decomposition_npz``, read by
``load_decomposition`` when no triplets exist, ``convert_decomposition``
between the two):

    {base}_B_{width}_{i}[_bd].npz
    {base}_B_{width}_{i}[_bd]_permutation.npy

so an artifact written by either package loads in the other.
"""

from __future__ import annotations

import enum
import glob as _glob
import hashlib
import json
import os
import re
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
from scipy import sparse

from arrow_matrix_tpu_torch.decomposition.decompose import ArrowLevel
from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json


class FileKind(enum.Enum):
    npz = 1
    indptr = 2
    indices = 3
    data = 4
    permutation = 5
    nnzrows = 6
    widths = 7
    manifest = 8


_SUFFIX = {
    FileKind.npz: ".npz",
    FileKind.indptr: "_indptr.npy",
    FileKind.indices: "_indices.npy",
    FileKind.data: "_data.npy",
    FileKind.permutation: "_permutation.npy",
    FileKind.nnzrows: "_nnzrows.npy",
    FileKind.widths: "_widths.npy",
    FileKind.manifest: "_manifest.json",
}


def format_path(base: str, width: Optional[int], index: Optional[int],
                block_diagonal: bool, kind: FileKind) -> str:
    """The artifact path scheme shared with the JAX package."""
    path = f"{base}_B"
    if width is not None:
        path += f"_{width}"
    if index is not None:
        path += f"_{index}"
    if block_diagonal:
        path += "_bd"
    return path + _SUFFIX[kind]


_DISCOVERY_WARNED: set = set()


def _discover_level_width(base: str, width: Optional[int], index: int,
                          block_diagonal: bool) -> Optional[int]:
    """Width under which level ``index``'s files exist on disk: the
    exact width first, then any LARGER width (a writer that names each
    level by its achieved width stores a grown last level there)."""
    exact = format_path(base, width, index, block_diagonal, FileKind.indptr)
    if os.path.exists(exact):
        return width
    if width is None:
        return None
    bd = "_bd" if block_diagonal else ""
    pattern = f"{_glob.escape(base)}_B_*_{index}{bd}_indptr.npy"
    rx = re.compile(re.escape(base) + r"_B_(\d+)_" + re.escape(str(index))
                    + bd + r"_indptr\.npy$")
    widths = sorted(int(m.group(1)) for p in _glob.glob(pattern)
                    if (m := rx.match(p)) and int(m.group(1)) > width)
    if widths:
        if (base, index) not in _DISCOVERY_WARNED:
            _DISCOVERY_WARNED.add((base, index))
            warnings.warn(
                f"level {index} of {base!r} found under achieved width "
                f"{widths[0]} (requested {width})", stacklevel=3)
        return widths[0]
    return None


# A loaded level matrix: an in-memory CSR or a (data, indices, indptr)
# triplet of (possibly memory-mapped) arrays; data None means ones.
CsrLike = Union[sparse.csr_matrix,
                Tuple[Optional[np.ndarray], np.ndarray, np.ndarray]]


# -- artifact integrity ------------------------------------------------------

class ArtifactIntegrityError(RuntimeError):
    """A decomposition artifact fails its sha256 sidecar manifest —
    truncated, corrupted, or missing."""


MANIFEST_VERSION = 1

VERIFY_ENV = "AMT_VERIFY_ARTIFACTS"


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while block := fh.read(chunk):
            h.update(block)
    return h.hexdigest()


def manifest_path(base: str, width: Optional[int],
                  block_diagonal: bool = True) -> str:
    """Sidecar manifest path for an artifact set (one per base+width)."""
    return format_path(base, width, None, block_diagonal, FileKind.manifest)


def write_manifest(base: str, width: Optional[int], paths: List[str],
                   block_diagonal: bool = True) -> str:
    """Write the sha256 sidecar manifest covering ``paths`` (keyed by
    basename); returns the manifest path."""
    files: Dict[str, Dict[str, Any]] = {}
    for p in paths:
        files[os.path.basename(p)] = {"sha256": _sha256_file(p),
                                      "bytes": os.path.getsize(p)}
    doc = {"version": MANIFEST_VERSION, "files": files}
    mp = manifest_path(base, width, block_diagonal)
    atomic_write_json(mp, doc, indent=1, sort_keys=True)
    return mp


def verify_manifest(base: str, width: Optional[int],
                    block_diagonal: bool = True) -> bool:
    """Verify every file the sidecar manifest lists: False when no
    manifest exists, True when all hashes check out, and
    :class:`ArtifactIntegrityError` naming the offending file otherwise."""
    mp = manifest_path(base, width, block_diagonal)
    if not os.path.exists(mp):
        return False
    with open(mp, encoding="utf-8") as fh:
        doc = json.load(fh)
    directory = os.path.dirname(mp) or "."
    for name in sorted(doc.get("files", {})):
        rec = doc["files"][name]
        p = os.path.join(directory, name)
        if not os.path.exists(p):
            if name.endswith(_SUFFIX[FileKind.data]):
                continue   # absent data file = implicit unit weights
            raise ArtifactIntegrityError(
                f"artifact file {p} is listed in manifest {mp} but "
                f"missing on disk")
        size = os.path.getsize(p)
        if "bytes" in rec and size != int(rec["bytes"]):
            raise ArtifactIntegrityError(
                f"artifact file {p} is {size} bytes but manifest {mp} "
                f"records {int(rec['bytes'])} — truncated or overwritten")
        digest = _sha256_file(p)
        if digest != rec["sha256"]:
            raise ArtifactIntegrityError(
                f"artifact file {p} fails sha256 verification against "
                f"manifest {mp}")
    return True


def _verify_default(mem_map: bool) -> bool:
    """Verify-on-load policy: on unless memory-mapping;
    ``AMT_VERIFY_ARTIFACTS=0`` disables, ``=1`` forces."""
    env = os.environ.get(VERIFY_ENV, "")
    if env == "0":
        return False
    if env == "1":
        return True
    return not mem_map


def save_decomposition(levels: List[ArrowLevel], base: str,
                       block_diagonal: bool = True,
                       dtype=np.float32) -> None:
    """Write npy CSR triplets + permutations for every level, all named
    by the level-0 width; true per-level widths go to ``_widths.npy``;
    the sha256 manifest is written last."""
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    width0 = levels[0].arrow_width if levels else 0
    written: List[str] = []

    def _save(path, arr):
        np.save(path, arr)
        written.append(path)

    for i, lvl in enumerate(levels):
        m = lvl.matrix.tocsr().astype(dtype)
        m.sum_duplicates()
        m.sort_indices()
        _save(format_path(base, width0, i, block_diagonal, FileKind.indptr),
              m.indptr)
        _save(format_path(base, width0, i, block_diagonal, FileKind.indices),
              m.indices)
        _save(format_path(base, width0, i, block_diagonal, FileKind.data),
              m.data)
        _save(format_path(base, width0, i, block_diagonal,
                          FileKind.permutation),
              np.asarray(lvl.permutation, dtype=np.int64))
    nnz_rows = np.asarray([l.nonzero_rows for l in levels], dtype=np.int64)
    _save(format_path(base, width0, 0, block_diagonal, FileKind.nnzrows),
          nnz_rows)
    widths = np.asarray([l.arrow_width for l in levels], dtype=np.int64)
    _save(format_path(base, width0, 0, block_diagonal, FileKind.widths),
          widths)
    write_manifest(base, width0, written, block_diagonal)


def load_level_widths(base: str, width: Optional[int],
                      block_diagonal: bool = True) -> Optional[np.ndarray]:
    """Per-level achieved widths: the ``_widths.npy`` metadata file, or
    the widths embedded in the per-level file names; None if neither."""
    p = format_path(base, width, 0, block_diagonal, FileKind.widths)
    if os.path.exists(p):
        return np.load(p)
    if width is None:
        return None
    widths, i = [], 0
    while (w := _discover_level_width(base, width, i,
                                      block_diagonal)) is not None:
        widths.append(int(w))
        i += 1
        if w != width:
            break  # a discovered width is the grown last level
    return np.asarray(widths, dtype=np.int64) if widths else None


def save_decomposition_npz(levels: List[ArrowLevel], base: str,
                           block_diagonal: bool = True,
                           dtype=np.float32) -> None:
    """The legacy single-file scheme: one scipy ``.npz`` per level and
    its permutation, all named by the level-0 width (so the loader's
    single-width enumeration finds a grown last level too)."""
    width0 = levels[0].arrow_width if levels else 0
    for i, lvl in enumerate(levels):
        m = lvl.matrix.tocsr().astype(dtype)
        sparse.save_npz(format_path(base, width0, i, block_diagonal,
                                    FileKind.npz), m)
        np.save(format_path(base, width0, i, block_diagonal,
                            FileKind.permutation),
                np.asarray(lvl.permutation, dtype=np.int64))


def load_decomposition(base: str, width: Optional[int] = None,
                       block_diagonal: bool = True,
                       mem_map: bool = False,
                       with_permutation: bool = True,
                       verify: Optional[bool] = None,
                       ) -> List[Tuple[CsrLike, Optional[np.ndarray]]]:
    """Load all levels of a decomposition: the npy triplets, or the
    legacy npz files when no triplet exists.

    With ``mem_map`` each CSR triplet stays on disk (memory-mapped).
    Missing ``_data`` files mean implicit unit values.  ``verify=None``
    follows :func:`_verify_default`.  The fault hook
    ``io.load_decomposition`` (target: ``base``) runs first.
    """
    from arrow_matrix_tpu_torch import faults

    faults.inject("io.load_decomposition", target=base)
    if verify is None:
        verify = _verify_default(mem_map)
    if verify:
        verify_manifest(base, width, block_diagonal)
    out: List[Tuple[CsrLike, Optional[np.ndarray]]] = []
    meta = format_path(base, width, 0, block_diagonal, FileKind.widths)
    n_levels_bound = (int(np.load(meta).size) if os.path.exists(meta)
                      else None)
    i = 0
    while n_levels_bound is None or i < n_levels_bound:
        w_i = _discover_level_width(base, width, i, block_diagonal)
        if w_i is None and width is not None:
            break
        p_indptr = format_path(base, w_i, i, block_diagonal, FileKind.indptr)
        if not os.path.exists(p_indptr):
            break
        loader = ((lambda f: np.lib.format.open_memmap(f, mode="r"))
                  if mem_map else np.load)
        indptr = loader(p_indptr)
        indices = loader(format_path(base, w_i, i, block_diagonal,
                                     FileKind.indices))
        p_data = format_path(base, w_i, i, block_diagonal, FileKind.data)
        if os.path.exists(p_data):
            data = loader(p_data)
        elif mem_map:
            data = None
        else:
            data = np.ones(indices.size, dtype=np.float32)
        n = indptr.size - 1  # square adjacency: column count not stored
        matrix: CsrLike = ((data, indices, indptr) if mem_map
                           else sparse.csr_matrix((data, indices, indptr),
                                                  shape=(n, n)))
        perm = None
        if with_permutation:
            perm = np.load(format_path(base, w_i, i, block_diagonal,
                                       FileKind.permutation))
        out.append((matrix, perm))
        i += 1
        if w_i is not None and width is not None and w_i != width:
            break   # a glob-discovered level is the grown LAST level

    if not out:
        out = _load_decomposition_npz(base, width, block_diagonal,
                                      with_permutation)
    if not out:
        raise FileNotFoundError(
            f"no decomposition artifacts found for base={base!r} "
            f"width={width} block_diagonal={block_diagonal} (checked npy "
            f"triplets and legacy npz; note levels are saved under the "
            f"level-0 width, which for max_levels=1 is the *achieved* "
            f"width, not the requested one)")
    return out


def _load_decomposition_npz(base, width, block_diagonal, with_permutation):
    out = []
    i = 0
    while True:
        p = format_path(base, width, i, block_diagonal, FileKind.npz)
        if not os.path.exists(p):
            break
        m = sparse.load_npz(p)
        perm = None
        if with_permutation:
            perm = np.load(format_path(base, width, i, block_diagonal,
                                       FileKind.permutation))
        out.append((m, perm))
        i += 1
    return out


def as_levels(loaded: List[Tuple[CsrLike, Optional[np.ndarray]]],
              widths: Union[int, np.ndarray, List[int]],
              materialize: bool = True) -> List[ArrowLevel]:
    """Wrap loader output back into ArrowLevel objects.  ``widths`` is
    one width for all levels or a per-level array; ``materialize=False``
    keeps memmapped triplets as triplets."""
    if np.isscalar(widths):
        widths = [int(widths)] * len(loaded)
    levels = []
    for (m, perm), w in zip(loaded, widths):
        if materialize and not isinstance(m, sparse.csr_matrix):
            n = m[2].size - 1
            data = (np.ones(np.asarray(m[1]).size, dtype=np.float32)
                    if m[0] is None else np.asarray(m[0]))
            m = sparse.csr_matrix((data, np.asarray(m[1]),
                                   np.asarray(m[2])), shape=(n, n))
        levels.append(ArrowLevel(m, perm, int(w)))
    return levels


def convert_decomposition(base: str, width: Optional[int] = None,
                          block_diagonal: bool = True,
                          to: str = "npy") -> int:
    """Convert a stored decomposition between the legacy ``.npz``
    scheme and the npy triplets: ``to="npy"`` reads npz levels and
    writes triplets, ``to="npz"`` the reverse, one level in memory at a
    time.  The permutation files are shared by both schemes.  Returns
    the number of levels converted."""
    if to not in ("npy", "npz"):
        raise ValueError(f"unknown target format {to!r}")

    def path(i, kind):
        return format_path(base, width, i, block_diagonal, kind)

    src_kind = FileKind.npz if to == "npy" else FileKind.indptr
    i = 0
    while os.path.exists(path(i, src_kind)):
        if to == "npy":
            m = sparse.load_npz(path(i, FileKind.npz)).tocsr()
            m.sum_duplicates()
            m.sort_indices()
            np.save(path(i, FileKind.indptr), m.indptr)
            np.save(path(i, FileKind.indices), m.indices)
            np.save(path(i, FileKind.data), m.data)
        else:
            indptr = np.load(path(i, FileKind.indptr))
            indices = np.load(path(i, FileKind.indices))
            p_data = path(i, FileKind.data)
            data = (np.load(p_data) if os.path.exists(p_data)
                    else np.ones(indices.size, dtype=np.float32))
            n = indptr.size - 1
            sparse.save_npz(path(i, FileKind.npz),
                            sparse.csr_matrix((data, indices, indptr),
                                              shape=(n, n)))
        i += 1
    if i == 0:
        raise FileNotFoundError(
            f"no decomposition found for base={base!r} width={width} in "
            f"the {'npz' if to == 'npy' else 'npy-triplet'} scheme")
    return i


def num_rows(matrix: CsrLike) -> int:
    if sparse.issparse(matrix):
        return matrix.shape[0]
    return len(matrix[2]) - 1


def num_nonzeros(matrix: CsrLike) -> int:
    """Stored-entry count for either CsrLike form: scipy ``.nnz``, or
    the size of the triplet's indices array (data may be None for
    binary matrices, so the indices array is the one reliable count)."""
    if sparse.issparse(matrix):
        return int(matrix.nnz)
    return int(np.asarray(matrix[1]).size)


def nnz_per_row(matrix: CsrLike) -> np.ndarray:
    if sparse.issparse(matrix):
        return np.diff(matrix.tocsr().indptr)
    indptr = matrix[2]
    return np.asarray(indptr[1:]) - np.asarray(indptr[:-1])


def csr_row_range(matrix: CsrLike, row_start: int, row_stop: int,
                  ncols: int, dtype=np.float32) -> sparse.csr_matrix:
    """Rows [row_start, row_stop) of a CSR / (memmapped) triplet as a
    (row_stop-row_start, ncols) CSR: only the touched row range is read;
    rows past the matrix end come out empty; data None means implicit
    ones.  Not canonicalized (the callers decide)."""
    n = num_rows(matrix)
    lo_r, hi_r = min(row_start, n), min(row_stop, n)
    if sparse.issparse(matrix):
        m = matrix.tocsr()
        data, indices, indptr = m.data, m.indices, m.indptr
    else:
        data, indices, indptr = matrix
    if lo_r >= hi_r:
        return sparse.csr_matrix((row_stop - row_start, ncols),
                                 dtype=dtype)
    i0, i1 = int(indptr[lo_r]), int(indptr[hi_r])
    ip = np.full(row_stop - row_start + 1, i1 - i0, dtype=np.int64)
    ip[:hi_r - row_start + 1] = np.asarray(indptr[lo_r:hi_r + 1],
                                           dtype=np.int64) - i0
    idx = np.asarray(indices[i0:i1])
    vals = (np.ones(i1 - i0, dtype=dtype) if data is None
            else np.asarray(data[i0:i1], dtype=dtype))
    return sparse.csr_matrix((vals, idx, ip),
                             shape=(row_stop - row_start, ncols),
                             dtype=dtype)


def load_block(matrix: CsrLike, row_start: int, row_stop: int,
               col_start: int, col_stop: int, block_size: int,
               dtype=np.float32) -> sparse.csr_matrix:
    """One width-by-width block of a CSR (possibly memmapped triplet),
    padded with empty rows and columns to ``block_size`` square; only
    the touched row range is read."""
    n = num_rows(matrix)
    row_stop = min(row_stop, n)
    rows = csr_row_range(matrix, row_start, row_stop, n, dtype=dtype)
    block = rows[:, col_start:min(col_stop, n)]

    pad_rows = block_size - block.shape[0]
    pad_cols = block_size - block.shape[1]
    if pad_rows > 0 or pad_cols > 0:
        indptr_padded = np.pad(block.indptr, (0, max(pad_rows, 0)),
                               mode="edge")
        block = sparse.csr_matrix((block.data, block.indices, indptr_padded),
                                  shape=(block_size, block_size), dtype=dtype)
    block.sum_duplicates()
    block.sort_indices()
    return block


def number_of_blocks(matrix: CsrLike, width: int) -> int:
    """Blocks per side after truncating trailing all-zero rows *and*
    columns (the column extent is scanned in chunks)."""
    counts = nnz_per_row(matrix)
    nz = np.nonzero(counts)[0]
    extent = 0 if nz.size == 0 else int(nz[-1]) + 1
    indices = (matrix.tocsr().indices if sparse.issparse(matrix)
               else matrix[1])
    nnz = int(indices.shape[0])
    step = 1 << 24
    for lo in range(0, nnz, step):
        chunk = np.asarray(indices[lo:lo + step])
        if chunk.size:
            extent = max(extent, int(chunk.max()) + 1)
    return max(1, -(-extent // width))


def arrow_block_coords(n_blocks: int, banded: bool) -> List[Tuple[int, int]]:
    """Coordinates of the structurally nonzero blocks of an arrow matrix:
    the head row ``(0, j)``, the head column ``(i, 0)``, the diagonal
    ``(i, i)`` and, when banded, the off-diagonals ``(i, i +- 1)`` (not
    into the head), in the JAX package's order."""
    coords = [(0, j) for j in range(n_blocks)]
    for i in range(1, n_blocks):
        coords += [(i, 0), (i, i)]
        if banded:
            if i - 1 >= 1:
                coords.append((i, i - 1))
            if i + 1 < n_blocks:
                coords.append((i, i + 1))
    return coords

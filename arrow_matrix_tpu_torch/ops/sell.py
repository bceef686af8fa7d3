"""SELL (sliced-ELL): the padding-bounded general SpMM operator.

A power-law degree distribution defeats plain ELL (every row pays the
hub degree).  Sorting rows by degree and cutting the sorted order into
*tiers* at geometric degree boundaries bounds the padded slots to
``growth`` times the nonzeros:

  * the row sort is composed into the carried feature order once on the
    host (``order``), and the operator is conjugated into sorted
    coordinates, so it costs nothing at run time;
  * each tier is one slot-major ``(m_t, n_t)`` ELL block (``ops/ell.py``);
    tiers are contiguous runs of the sorted order, so each writes its
    own row range of one output — no scatter anywhere.

Binary matrices (graph adjacency) drop the value arrays for per-row
degrees.  The packing (``sell_from_csr``) is numpy and produces the
same arrays, byte for byte, as ``arrow_matrix_tpu.ops.sell``; the
arrays then move to the device as torch tensors.

This module holds the plain products: :func:`sell_spmm` (row-major, the
port's carriage) and :func:`sell_spmm_t` (feature-major ``(k, n)``, the
JAX package's signature).  The hand-written kernel is
``ops/cuda_sell.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.io.graphio import CsrLike, num_rows
from arrow_matrix_tpu_torch.ops.ell import (
    SLOT_ALIGN,
    ell_tier_spmm,
    out_dtype_for,
)
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class SellMatrix:
    """A matrix in sorted sliced-ELL form, in *sorted* coordinates.

    Row i of this operator is row ``order[i]`` of the source matrix and
    column indices are remapped the same way.  Tier t covers sorted rows
    ``[row_starts[t], row_starts[t] + n_t)`` with ``m_t, n_t =
    cols[t].shape``.

    ``x_rows`` is the row count of the features the operator multiplies
    (None: ``n_rows``, a square operator); a rectangular one (an ELL
    stack of one arrow level, the arrow head) gathers from more rows
    than it writes.

    ``plans`` caches K1's work lists on the device by (k, carriage,
    vecload, launch knobs) (``ops/cuda_sell.py:plan_for``), and
    ``subsets`` the operators of some of its tiers, one per launch of a
    per-tier schedule (``ops/cuda_sell.py:tier_subset``).  They hold
    pointers to the tier tensors, so no constructor or
    ``dataclasses.replace`` takes them: every new operator starts with
    none.
    """

    cols: Tuple[torch.Tensor, ...]                    # (m_t, n_t) int32
    data: Optional[Tuple[torch.Tensor, ...]] = None   # (m_t, n_t) weighted
    deg: Optional[Tuple[torch.Tensor, ...]] = None    # (n_t,) int32 binary
    n_rows: int = 0
    row_starts: Tuple[int, ...] = ()
    x_rows: Optional[int] = None
    plans: dict = field(default_factory=dict, init=False, repr=False,
                        compare=False)
    subsets: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)

    @property
    def binary(self) -> bool:
        return self.data is None

    @property
    def device(self) -> torch.device:
        return self.cols[0].device

    @property
    def n_slots(self) -> int:
        """Total padded gather slots."""
        return sum(int(c.shape[0]) * int(c.shape[1]) for c in self.cols)

    def live_tiers(self) -> list:
        """Indices of the tiers a product launches on (``m_t, n_t > 0``)."""
        return [t for t, c in enumerate(self.cols)
                if c.shape[0] > 0 and c.shape[1] > 0]

    def device_nbytes(self) -> int:
        return nbytes_of(self)

    def to(self, device: DeviceLike) -> "SellMatrix":
        dev = resolve_device(device)
        move = (lambda ts: None if ts is None
                else tuple(t.to(dev) for t in ts))
        return SellMatrix(cols=move(self.cols), data=move(self.data),
                          deg=move(self.deg), n_rows=self.n_rows,
                          row_starts=self.row_starts, x_rows=self.x_rows)


def nbytes_of(*objs) -> int:
    """Bytes of the arrays among ``objs`` (tensors, :class:`SellMatrix`
    operators, None), each array counted once however often it
    appears."""
    seen = {}
    for o in objs:
        if isinstance(o, SellMatrix):
            arrays = [t for ts in (o.cols, o.data, o.deg) if ts for t in ts]
        else:
            arrays = [o] if isinstance(o, torch.Tensor) else []
        for t in arrays:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def resolve_binary(binary: Union[str, bool], data,
                   nnz: Optional[int] = None,
                   chunk: int = 1 << 24) -> bool:
    """One binary-mode rule: ``data is None`` (implicit ones) is always
    binary; "auto" detects all-ones values; forcing ``True`` on
    non-unit values is an error.  ``nnz`` bounds the inspected prefix.
    The scan is chunked with early exit."""
    if data is None:
        return True
    if binary is False:
        return False

    def all_ones() -> bool:
        end = len(data) if nnz is None else nnz
        for off in range(0, end, chunk):
            if not np.all(np.asarray(data[off:min(off + chunk, end)])
                          == 1.0):
                return False
        return True

    if binary == "auto":
        return all_ones()
    if not all_ones():
        raise ValueError("binary=True but the matrix has non-unit values")
    return True


def tier_boundaries(sorted_aligned_deg: np.ndarray,
                    growth: float = 1.2) -> list[int]:
    """Tier start indices over ascending aligned degrees: a new tier
    starts whenever the degree exceeds ``growth`` times the tier's
    first degree (so within-tier ELL padding is < growth), with the
    zero-degree prefix always its own tier."""
    starts = [0]
    n = sorted_aligned_deg.size
    if n == 0:
        return starts
    tier_min = int(sorted_aligned_deg[0])
    change = np.flatnonzero(np.diff(sorted_aligned_deg)) + 1
    for i in change:
        d = int(sorted_aligned_deg[i])
        if d > growth * tier_min:
            starts.append(int(i))
            tier_min = d
    return starts


def align_up_vec(x: np.ndarray, align: int) -> np.ndarray:
    return -(-x // align) * align


def sell_pack_numpy(matrix: CsrLike, pad_rows_to: Optional[int] = None,
                    dtype=np.float32, binary: Union[str, bool] = "auto",
                    growth: float = 1.2, slot_align: int = SLOT_ALIGN,
                    conjugate: bool = True):
    """Host half of :func:`sell_from_csr`: returns ``(cols, data, deg,
    n_rows, row_starts, order)`` as numpy arrays (``data`` None when
    binary, ``deg`` None when weighted).  ``conjugate=False`` sorts the
    rows alone and keeps the column indices: the packing of a
    rectangular operator, whose features are not carried sorted."""
    n = num_rows(matrix)
    total = max(pad_rows_to or n, n)
    if isinstance(matrix, sparse.csr_matrix):
        data, indices, indptr = matrix.data, matrix.indices, matrix.indptr
    else:
        data, indices, indptr = matrix
    indptr = np.asarray(indptr, dtype=np.int64)
    degrees = np.zeros(total, dtype=np.int64)
    degrees[:n] = np.diff(indptr)
    is_binary = resolve_binary(binary, data, nnz=int(indptr[-1]))

    order = np.argsort(degrees, kind="stable").astype(np.int64)
    inv_order = np.argsort(order).astype(np.int32)
    aligned = (align_up_vec(degrees[order], slot_align)
               if slot_align > 1 else degrees[order])
    starts = tier_boundaries(aligned, growth) + [total]

    nnz = int(indptr[-1])
    all_cols = np.asarray(indices[:nnz])
    if conjugate:
        all_cols = inv_order[all_cols]
    else:
        all_cols = all_cols.astype(np.int32)
    all_data = (None if is_binary
                else (np.ones(nnz, dtype=dtype) if data is None
                      else np.asarray(data[:nnz]).astype(dtype, copy=False)))

    cols_t, data_t, deg_t = [], [], []
    for lo, hi in zip(starts[:-1], starts[1:]):
        rows = order[lo:hi]                       # source row ids, asc deg
        degs = degrees[rows]
        m_t = int(aligned[hi - 1])                # max aligned deg in tier
        n_t = hi - lo
        cols = np.zeros((m_t, n_t), dtype=np.int32)
        vals = None if is_binary else np.zeros((m_t, n_t), dtype=dtype)
        if m_t and degs.sum():
            # Vectorized fill: flat (slot, tier-local row) coordinates.
            live = degs > 0
            live_rows = rows[live]
            live_degs = degs[live]
            src0 = indptr[live_rows]
            span = np.repeat(src0, live_degs)
            slot = (np.arange(span.size)
                    - np.repeat(np.cumsum(live_degs) - live_degs,
                                live_degs))
            tloc = np.repeat(np.flatnonzero(live), live_degs)
            src = span + slot
            cols[slot, tloc] = all_cols[src]
            if not is_binary:
                vals[slot, tloc] = all_data[src]
        cols_t.append(cols)
        if is_binary:
            deg_t.append(degs.astype(np.int32))
        else:
            data_t.append(vals)
    return (cols_t, None if is_binary else data_t,
            deg_t if is_binary else None, total,
            tuple(int(s) for s in starts[:-1]), order)


def sell_from_arrays(cols, data=None, deg=None, n_rows: int = 0,
                     row_starts=(), device: DeviceLike = None
                     ) -> SellMatrix:
    """A :class:`SellMatrix` on ``device`` from per-tier host arrays."""
    dev = resolve_device(device)

    def put(arrays):
        if arrays is None:
            return None
        # from_numpy shares memory: copy read-only (memmapped, JAX)
        # arrays first.
        return tuple(torch.from_numpy(
            np.require(a, requirements=("C", "W"))).to(dev)
            for a in arrays)

    return SellMatrix(cols=put(cols), data=put(data), deg=put(deg),
                      n_rows=int(n_rows),
                      row_starts=tuple(int(s) for s in row_starts))


def sell_from_csr(matrix: CsrLike, pad_rows_to: Optional[int] = None,
                  dtype=np.float32, binary: Union[str, bool] = "auto",
                  growth: float = 1.2, slot_align: int = SLOT_ALIGN,
                  device: DeviceLike = None
                  ) -> tuple[SellMatrix, np.ndarray]:
    """Pack a CSR (or triplet) into sorted sliced-ELL on ``device``.

    Returns ``(sell, order)``: ``order[i]`` is the source row stored at
    sorted position i; the operator is conjugated (rows AND columns)
    into sorted coordinates, so features carried as ``y[i] =
    x[order[i]]`` give ``A @ x`` as ``sell @ y`` with no permutation.
    """
    cols, data, deg, total, starts, order = sell_pack_numpy(
        matrix, pad_rows_to, dtype, binary, growth, slot_align)
    return sell_from_arrays(cols, data, deg, total, starts,
                            device=device), order


def _tier_weights(m: SellMatrix, t: int):
    return (None if m.data is None else m.data[t],
            None if m.deg is None else m.deg[t])


def sell_spmm(m: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain ``m @ x`` row-major: ``x`` (n_rows, k) -> (n_rows, k) in
    ``out_dtype_for(x.dtype)``; each tier writes its own row range of
    one preallocated output (zero-slot tiers are zero rows)."""
    k = x.shape[1]
    out = torch.zeros((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                      device=x.device)
    for t in m.live_tiers():
        lo = m.row_starts[t]
        n_t = m.cols[t].shape[1]
        data, deg = _tier_weights(m, t)
        ell_tier_spmm(m.cols[t], x, data=data, deg=deg,
                      out=out[lo:lo + n_t])
    return out


def sell_spmm_t(m: SellMatrix, x_t: torch.Tensor) -> torch.Tensor:
    """Feature-major twin with the JAX package's signature: ``x_t``
    (k, n_rows) -> (k, n_rows)."""
    return sell_spmm(m, x_t.T.contiguous()).T.contiguous()


def sell_stats(m: SellMatrix) -> dict:
    """Per-tier (rows, nnz, slots)."""
    per_tier = []
    for t, c in enumerate(m.cols):
        m_t, n_t = int(c.shape[0]), int(c.shape[1])
        slots = m_t * n_t
        if m.deg is not None:
            nnz = int(m.deg[t].sum())
        else:
            nnz = int(torch.count_nonzero(m.data[t]))
        per_tier.append({"rows": n_t, "nnz": nnz, "slots": slots})
    return {
        "n_tiers": len(per_tier),
        "rows": [t["rows"] for t in per_tier],
        "nnz": [t["nnz"] for t in per_tier],
        "slots": [t["slots"] for t in per_tier],
    }

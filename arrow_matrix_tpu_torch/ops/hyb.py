"""HYB (split ELL): one whole level as a light ELL plus a heavy ELL.

Counterpart of ``arrow_matrix_tpu/ops/hyb.py``.  One power-law hub row
would pad every row of a plain ELL to the hub's degree, so the level's
rows are split by degree:

  * light rows (degree <= m0): one slot-major ``(m0, rows)`` ELL over
    global columns;
  * heavy rows (the few hubs): their own ``(m_h, h)`` ELL and the list
    of their row indices, merged into the output by one add at those
    rows (their light slots are empty, so the add is exact).

m0 is the smallest aligned slot count that leaves at most
``heavy_cap`` rows heavy.  The host packing (:func:`hyb_from_csr`) is
the JAX package's, array for array.

Both partitions are already in K1's form (one slot-major tier each), so
on the card each is one launch of the hand-written kernel
(``ops/cuda_ell.py:hyb_spmm_cuda``); :func:`hyb_spmm` is the plain
version.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional, Union

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.io.graphio import CsrLike, num_rows
from arrow_matrix_tpu_torch.ops.arrow_blocks import resolve_block_dtype
from arrow_matrix_tpu_torch.ops.ell import (
    SLOT_ALIGN,
    align_up,
    ell_tier_spmm,
)
from arrow_matrix_tpu_torch.ops.sell import nbytes_of, resolve_binary
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class HybLevel:
    """One matrix in split-ELL form on a device.  Binary matrices carry
    ``*_deg`` and no ``*_data``; weighted ones ``*_data`` (zero in
    padding) and no ``*_deg``.

    ``k1`` caches the partitions as K1 operators with their work lists
    (``ops/cuda_ell.py:hyb_operands``); no constructor takes it.
    """

    light_cols: torch.Tensor                   # (m0, rows) int32
    heavy_idx: torch.Tensor                    # (h,) int32, sorted
    heavy_cols: torch.Tensor                   # (m_h, h) int32
    light_data: Optional[torch.Tensor] = None  # (m0, rows)
    heavy_data: Optional[torch.Tensor] = None  # (m_h, h)
    light_deg: Optional[torch.Tensor] = None   # (rows,) int32
    heavy_deg: Optional[torch.Tensor] = None   # (h,) int32
    n_rows: int = 0
    k1: dict = field(default_factory=dict, init=False, repr=False,
                     compare=False)

    @property
    def binary(self) -> bool:
        return self.light_data is None

    def tensors(self) -> dict:
        return {f.name: t for f in fields(self)
                if isinstance(t := getattr(self, f.name), torch.Tensor)}

    def device_nbytes(self) -> int:
        """Bytes of the level's arrays and of its K1 operators, each
        array once."""
        return nbytes_of(*self.tensors().values(), *self.k1.values())


def choose_light_slots(degrees: np.ndarray, heavy_cap: int,
                       align: int = SLOT_ALIGN) -> int:
    """Smallest aligned slot count m0 with at most ``heavy_cap`` rows of
    degree > m0."""
    if degrees.size == 0:
        return 0
    cap = min(max(heavy_cap, 0), degrees.size - 1)
    kth = np.partition(degrees, degrees.size - 1 - cap)[
        degrees.size - 1 - cap]
    return align_up(max(int(kth), 1), align)


def hyb_from_csr(matrix: CsrLike, pad_rows_to: Optional[int] = None,
                 dtype=np.float32, heavy_cap: Optional[int] = None,
                 binary: Union[str, bool] = "auto",
                 device: DeviceLike = None) -> HybLevel:
    """Split a CSR (or memmapped triplet) into a :class:`HybLevel` on
    ``device`` (the card unless ``"cpu"`` is asked for).

    ``pad_rows_to`` appends empty rows; ``heavy_cap`` bounds the heavy
    list (default rows / 256, at least 512); ``binary`` picks the
    implicit-ones layout ("auto": detect all-ones values).  ``dtype`` is
    the value arrays' (float32; "bf16" rounds them once)."""
    dev = resolve_device(device)
    n = num_rows(matrix)
    total = max(pad_rows_to or n, n)
    if isinstance(matrix, sparse.csr_matrix):
        data, indices, indptr = matrix.data, matrix.indices, matrix.indptr
    else:
        data, indices, indptr = matrix
    indptr = np.asarray(indptr, dtype=np.int64)
    degrees = np.diff(indptr)
    is_binary = resolve_binary(binary, data, nnz=int(indptr[-1]))
    if heavy_cap is None:
        heavy_cap = max(512, total // 256)
    m0 = choose_light_slots(degrees, heavy_cap)

    heavy_mask = degrees > m0
    heavy_rows = np.flatnonzero(heavy_mask)
    h = heavy_rows.size

    nnz = int(indptr[-1])
    all_cols = np.asarray(indices[:nnz])
    all_data = (None if is_binary
                else (np.ones(nnz, dtype=np.float32) if data is None
                      else np.asarray(data[:nnz]).astype(np.float32,
                                                         copy=False)))

    light_cols = np.zeros((m0, total), dtype=np.int32)
    light_data = None if is_binary else np.zeros((m0, total),
                                                 dtype=np.float32)
    light_counts = np.where(heavy_mask, 0, degrees)
    if light_counts.sum():
        d_light = degrees[~heavy_mask]
        starts = np.repeat(indptr[:-1][~heavy_mask], d_light)
        slot = (np.arange(starts.size)
                - np.repeat(np.cumsum(d_light) - d_light, d_light))
        flat = np.repeat(np.arange(n)[~heavy_mask], d_light)
        src = starts + slot
        light_cols[slot, flat] = all_cols[src]
        if not is_binary:
            light_data[slot, flat] = all_data[src]

    if h:
        m_h = align_up(int(degrees[heavy_rows].max()), SLOT_ALIGN)
        heavy_cols = np.zeros((m_h, h), dtype=np.int32)
        heavy_data = None if is_binary else np.zeros((m_h, h),
                                                     dtype=np.float32)
        for out_i, r in enumerate(heavy_rows):
            lo, hi = int(indptr[r]), int(indptr[r + 1])
            heavy_cols[:hi - lo, out_i] = all_cols[lo:hi]
            if not is_binary:
                heavy_data[:hi - lo, out_i] = all_data[lo:hi]
    else:
        heavy_cols = np.zeros((0, 0), dtype=np.int32)
        heavy_data = None if is_binary else np.zeros((0, 0),
                                                     dtype=np.float32)
    light_deg = heavy_deg = None
    if is_binary:
        light_deg = np.zeros(total, dtype=np.int32)
        light_deg[:n] = light_counts
        heavy_deg = degrees[heavy_rows].astype(np.int32)

    vdtype = resolve_block_dtype(dtype)

    def put(a, dt=None):
        if a is None:
            return None
        t = torch.from_numpy(a)
        return (t if dt is None else t.to(dt)).to(dev)

    return HybLevel(
        light_cols=put(light_cols), light_data=put(light_data, vdtype),
        light_deg=put(light_deg),
        heavy_idx=put(heavy_rows.astype(np.int32)),
        heavy_cols=put(heavy_cols), heavy_data=put(heavy_data, vdtype),
        heavy_deg=put(heavy_deg), n_rows=total)


def hyb_spmm(level: HybLevel, x: torch.Tensor,
             chunk: Optional[int] = None,
             heavy_chunk: Optional[int] = None) -> torch.Tensor:
    """Plain ``level @ x``: x ``(n_rows, k)`` row-major -> ``(n_rows,
    k)`` in x's dtype (float32 sums); the light ELL, then the heavy
    rows added at ``heavy_idx``.  ``chunk``/``heavy_chunk`` bound the
    gathers' intermediate (slots at a time)."""
    out = ell_tier_spmm(level.light_cols, x, data=level.light_data,
                        deg=level.light_deg, chunk=chunk)
    if level.heavy_idx.shape[0]:
        heavy = ell_tier_spmm(level.heavy_cols, x, data=level.heavy_data,
                              deg=level.heavy_deg, chunk=heavy_chunk)
        out.index_add_(0, level.heavy_idx.long(), heavy)
    return out


def hyb_spmm_t(level: HybLevel, x_t: torch.Tensor,
               chunk: Optional[int] = None,
               heavy_chunk: Optional[int] = None) -> torch.Tensor:
    """``(level @ x_t.T).T`` on feature-major ``(k, n_rows)`` features,
    the JAX package's signature.  A CUDA ``x_t`` runs the level's two K1
    operators (``ops/cuda_ell.py:hyb_spmm_k1``); a CPU one the plain
    :func:`hyb_spmm` (``chunk``/``heavy_chunk`` bound its gathers)."""
    x = x_t.T.contiguous()
    if x.device.type == "cpu":
        out = hyb_spmm(level, x, chunk=chunk, heavy_chunk=heavy_chunk)
    else:
        from arrow_matrix_tpu_torch.ops.cuda_ell import hyb_spmm_k1

        out = hyb_spmm_k1(level, x)
    return out.T.contiguous()


def hyb_stats(h: HybLevel) -> dict:
    """(rows, nnz, slots) of the light and heavy partitions: the two
    products the layout launches."""
    def part(cols, data, deg, rows):
        slots = int(cols.shape[0]) * int(cols.shape[1])
        if deg is not None:
            nnz = int(deg.sum())
        elif data is not None:
            nnz = int(torch.count_nonzero(data))
        else:
            nnz = slots
        return {"rows": int(rows), "nnz": nnz, "slots": slots}

    light = part(h.light_cols, h.light_data, h.light_deg,
                 h.light_cols.shape[1])
    heavy = part(h.heavy_cols, h.heavy_data, h.heavy_deg,
                 h.heavy_idx.shape[0])
    return {"rows": [light["rows"], heavy["rows"]],
            "nnz": [light["nnz"], heavy["nnz"]],
            "slots": [light["slots"], heavy["slots"]],
            "light": light, "heavy": heavy}

"""Slot-major ELL: the plain PyTorch product of one SELL tier.

A tier is an ELL block stored slot-major: ``cols`` is ``(m, rows)``
int32, so slot ``j`` of every row is one contiguous run (the layout the
CUDA kernel reads coalesced across a warp's rows).  Padding slots point
at column 0 with weight 0.  The product is

    out[r, :] = sum_j w[j, r] * x[cols[j, r], :]

with ``w = data`` (weighted) or ``w[j, r] = j < deg[r]`` (binary:
implicit-ones graph adjacency, no value array).  Features are carried
row-major ``(n, k)``; accumulation is float32 whatever the carriage.

:func:`ell_tier_spmm` is the plain version of the hand-written kernel
``csrc/sell_tier_spmm.cu`` (wrapper: ``ops/cuda_sell.py``); the CPU
tests run it, and ``chip_smoke.py`` holds the kernel against it on the
card.

The block formats of one arrow level live here too, as the JAX
package's ``ops/ell.py`` has them:

* dense: :func:`dense_pack_stack` packs sparse blocks into one ``(b, w,
  w)`` stack; :func:`dense_spmm_batched` is its plain batched product;
* ELL: the host packers (:func:`ell_pack`, :func:`ell_pack_stack`,
  :func:`ell_pack_stack_binary`) give row-major ``(b, rows, m)`` stacks
  of block-local columns, the same arrays byte for byte as the JAX
  package's; :func:`ell_spmm` and :func:`ell_spmm_batched` are their
  plain products;
* flat COO (the arrow head's skewed rows): :func:`csr_flat_pack`,
  :func:`flat_pack_stack` and the plain scatter-add
  :func:`csr_flat_spmm`.

Each of these products is the function K1 computes,
``out[r] = sum_j w[j, r] * x[cols[j, r]]``.  :func:`ell_stack_tier`
turns a block-local ELL stack into K1's form, one slot-major tier over
global columns, so that on the card an ELL stack is one K1 launch
(``ops/cuda_ell.py``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

# Pad the ELL slot axis to a multiple of this (the packing default the
# JAX package uses; kept so both packages build identical operators).
SLOT_ALIGN = 8

# Upper bound on the gathered (slots x rows x k) f32 intermediate of the
# plain version, in elements: 2^27 (512 MiB) keeps a full-size operator
# at k=128 inside device memory.
GATHER_ELEMENTS = 1 << 27


def align_up(x: int, align: int) -> int:
    return -(-x // align) * align


def block_index_dtype(width: int):
    """Index dtype of block-LOCAL columns and rows: int16 whenever every
    value (columns below ``width``, and the flat head's dummy row
    ``width``) fits, else int32 (the JAX package's rule)."""
    return np.int16 if width < np.iinfo(np.int16).max else np.int32


def out_dtype_for(x_dtype: torch.dtype) -> torch.dtype:
    """Result dtype of a tier product: the carriage dtype, except that
    an int8 table (a pre-quantized ``q``) returns its f32 sums."""
    return torch.float32 if x_dtype == torch.int8 else x_dtype


def _slot_sums(c: torch.Tensor, x: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """``sum_j w[j, r] x[c[j, r]]`` (rows, k) in float32 for a run of
    slots ``c`` (s, rows), reduced along a contiguous slot axis: each
    output element's sum then runs over its own slots in an order that
    depends on their count alone, not on k or the rows beside it."""
    s, rows = c.shape
    k = x.shape[1]
    g = x.index_select(0, c.reshape(-1).long()).reshape(s, rows, k).float()
    return (g * w[:, :, None]).permute(1, 2, 0).contiguous().sum(-1)


def ell_tier_sums(cols: torch.Tensor, x: torch.Tensor,
                  data: Optional[torch.Tensor] = None,
                  deg: Optional[torch.Tensor] = None,
                  first_slot: int = 0,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """The float32 sums of :func:`ell_tier_spmm`, before the result is
    rounded to its dtype.  ``cols`` (and ``data``) may be a run of slots
    of a tier starting at slot ``first_slot``: a binary row then takes
    its slots below ``deg[r]`` counted from the tier's first slot.

    ``chunk=None`` (the default) sums every slot of a row in one
    reduction and cuts the rows instead to keep the intermediate under
    :data:`GATHER_ELEMENTS`: a feature column of the result then has
    the same bits whatever k (the serving runtime's batches and column
    slabs rely on it).  An explicit ``chunk`` gathers that many slots at
    a time and adds the chunks in order."""
    m, rows = cols.shape
    k = x.shape[1]
    if data is None and deg is None and m > 0:
        raise ValueError("binary ELL (data=None) requires deg")
    acc = torch.zeros((rows, k), dtype=torch.float32, device=x.device)
    if m == 0 or rows == 0:
        return acc

    def weights(lo, hi, r0, r1):
        if data is not None:
            return data[lo:hi, r0:r1].float()
        slot = torch.arange(first_slot + lo, first_slot + hi,
                            device=x.device)[:, None]
        return (slot < deg[None, r0:r1]).float()

    if chunk is None:
        step = max(1, GATHER_ELEMENTS // max(m * k, 1))
        for r0 in range(0, rows, step):
            r1 = min(r0 + step, rows)
            acc[r0:r1] = _slot_sums(cols[:, r0:r1], x,
                                    weights(0, m, r0, r1))
        return acc
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        acc += _slot_sums(cols[lo:hi], x, weights(lo, hi, 0, rows))
    return acc


def ell_tier_spmm(cols: torch.Tensor, x: torch.Tensor,
                  data: Optional[torch.Tensor] = None,
                  deg: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """Plain ``out[r] = sum_j w[j, r] * x[cols[j, r]]`` for one tier.

    :param cols: (m, rows) int32 column indices, slot-major.
    :param x:    (n, k) features, f32 / bf16 / int8, row-major.
    :param data: (m, rows) f32 weights (0 in padding), or None.
    :param deg:  (rows,) int32 valid-slot counts (binary mode).
    :param out:  optional (rows, k) destination of the result dtype.
    :param chunk: slots gathered at a time (see :func:`ell_tier_sums`;
        None: every slot at once, rows cut to bound the intermediate).
    :returns: (rows, k) in :func:`out_dtype_for` ``(x.dtype)``.
    """
    res = ell_tier_sums(cols, x, data=data, deg=deg, chunk=chunk).to(
        out_dtype_for(x.dtype))
    if out is None:
        return res
    out.copy_(res)
    return out


def ell_spmm_t(cols: torch.Tensor, x_t: torch.Tensor,
               data: Optional[torch.Tensor] = None,
               deg: Optional[torch.Tensor] = None,
               chunk: Optional[int] = None) -> torch.Tensor:
    """Slot-major, feature-major ELL product with the JAX package's
    signature: ``out_t[:, r] = sum_j w[j, r] * x_t[:, cols[j, r]]``.

    :param cols: (m, rows) integer column indices, 0 in padding slots.
    :param x_t:  (k, n_cols) features, feature-major.
    :param data: (m, rows) weights (0 in padding), or None for binary.
    :param deg:  (rows,) valid-slot counts (binary only).
    :param chunk: slots gathered at a time by the plain version.
    :returns: (k, rows), feature-major.

    A CUDA ``x_t`` runs K1 over the tier (``ops/cuda_ell.py:one_tier``,
    one launch; ``chunk`` does not apply); a CPU one the plain
    :func:`ell_tier_spmm`."""
    m, rows = cols.shape
    if data is None and deg is None and m > 0:
        raise ValueError("binary ELL (data=None) requires deg")
    x = x_t.T.contiguous()
    if x.device.type == "cpu":
        return ell_tier_spmm(cols, x, data=data, deg=deg,
                             chunk=chunk).T.contiguous()
    if m == 0:
        # An empty tier is not launched (CUDA refuses an empty grid).
        return torch.zeros((x_t.shape[0], rows),
                           dtype=out_dtype_for(x.dtype), device=x.device)
    from arrow_matrix_tpu_torch.ops.cuda_ell import one_tier
    from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda

    op = one_tier(cols.to(torch.int32).contiguous(), data,
                  None if deg is None else deg.to(torch.int32),
                  x_rows=x.shape[0])
    return sell_spmm_cuda(op, x).T.contiguous()


def dense_pack_stack(mats: List[Optional[sparse.spmatrix]],
                     dtype: torch.dtype = torch.float32,
                     rows: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Pack sparse blocks (None = structurally empty) into one dense
    ``(b, rows, rows)`` tensor of ``dtype``.

    Every value is cut to float32 and then rounded once to ``dtype``
    (round to nearest even for bfloat16), as the JAX package's packer
    does, so the stacks agree bit for bit.  Without ``device`` the
    stack is densified in numpy and returned on the CPU; with it, only
    the nonzeros cross to ``device`` and are scattered into a zeroed
    stack there, so the host never holds the dense stack.
    """
    shapes = [m.shape for m in mats if m is not None]
    if not shapes and rows is None:
        raise ValueError("no non-empty blocks and no explicit row count")
    rows = rows if rows is not None else shapes[0][0]
    if device is not None:
        return _dense_scatter_stack(mats, dtype, rows, device)
    out = np.zeros((len(mats), rows, rows), dtype=np.float32)
    for i, m in enumerate(mats):
        if m is None or m.nnz == 0:
            continue
        if m.dtype == np.float32:
            m.toarray(out=out[i])     # no temporary block
        else:
            out[i] = m.toarray()
    return torch.from_numpy(out).to(dtype)


def _dense_scatter_stack(mats, dtype: torch.dtype, rows: int,
                         device) -> torch.Tensor:
    """:func:`dense_pack_stack` on ``device``: the blocks' nonzeros at
    their flat positions in the stack, written into zeros there."""
    flat, vals = [], []
    for i, m in enumerate(mats):
        if m is None or m.nnz == 0:
            continue
        m = m.tocsr()
        if not m.has_canonical_format:       # toarray sums duplicates
            m = m.copy()
            m.sum_duplicates()
        r = np.repeat(np.arange(m.shape[0], dtype=np.int64),
                      np.diff(m.indptr))
        flat.append((i * rows + r) * rows + m.indices)
        vals.append(np.asarray(m.data, dtype=np.float32))
    out = torch.zeros((len(mats), rows, rows), dtype=dtype, device=device)
    if flat:
        idx = torch.from_numpy(np.concatenate(flat)).to(device)
        v = torch.from_numpy(np.concatenate(vals)).to(dtype).to(device)
        out.view(-1)[idx] = v
    return out


def dense_spmm_batched(data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain batched dense block product ``(b, w, w) @ (b, w, k) ->
    (b, w, k)``: float32 sums whatever the block dtype, the result in
    ``x``'s dtype."""
    return torch.bmm(data.float(), x.float()).to(x.dtype)


# -- ELL stacks of arrow blocks (host packers: the JAX package's, byte for
# -- byte) -------------------------------------------------------------------

def _stack_rows(mats, rows: Optional[int]) -> int:
    shapes = [m.shape for m in mats if m is not None]
    if not shapes and rows is None:
        raise ValueError("no non-empty blocks and no explicit row count")
    return rows if rows is not None else shapes[0][0]


def _stack_slots(mats, align: int) -> int:
    """The shared slot count of a stack: its longest row, aligned."""
    need = 0
    for m in mats:
        if m is None:
            continue
        counts = np.diff(m.tocsr().indptr)
        if counts.size:
            need = max(need, int(counts.max()))
    return align_up(need, align) if need else 0


def ell_pack(m: sparse.spmatrix, max_nnz: Optional[int] = None,
             dtype=np.float32, with_data: bool = True,
             index_dtype=np.int32
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Row-major ELL ``(cols, data)`` of a sparse matrix: ``(rows,
    max_nnz)`` arrays, padding at column 0 with value 0 (``data`` None
    when ``with_data`` is False)."""
    csr = m.tocsr()
    csr.sum_duplicates()
    csr.sort_indices()
    counts = np.diff(csr.indptr)
    need = int(counts.max()) if counts.size and counts.max() > 0 else 0
    if max_nnz is None:
        max_nnz = need
    if need > max_nnz:
        raise ValueError(f"row has {need} nnz > max_nnz={max_nnz}")
    rows = csr.shape[0]
    cols = np.zeros((rows, max_nnz), dtype=index_dtype)
    data = np.zeros((rows, max_nnz), dtype=dtype) if with_data else None
    if csr.nnz:
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        row = np.repeat(np.arange(rows), counts)
        cols[row, slot] = csr.indices
        if with_data:
            data[row, slot] = csr.data
    return cols, data


def ell_pack_stack(mats: List[Optional[sparse.spmatrix]], dtype=np.float32,
                   align: int = SLOT_ALIGN, rows: Optional[int] = None,
                   index_dtype=np.int32, slots: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Equal-shaped sparse blocks (None = empty) -> stacked ELL ``(cols,
    data)``, each ``(b, rows, m)`` with one slot count m (the longest
    row of any block, aligned; ``slots`` when given: a budget agreed
    over a whole stack of which ``mats`` is a part)."""
    rows = _stack_rows(mats, rows)
    m_slots = _stack_slots(mats, align) if slots is None else int(slots)
    cols = np.zeros((len(mats), rows, m_slots), dtype=index_dtype)
    data = np.zeros((len(mats), rows, m_slots), dtype=dtype)
    for i, m in enumerate(mats):
        if m is None or m.nnz == 0:
            continue
        cols[i], data[i] = ell_pack(m, max_nnz=m_slots, dtype=dtype,
                                    index_dtype=index_dtype)
    return cols, data


def ell_pack_stack_binary(mats: List[Optional[sparse.spmatrix]],
                          rows: Optional[int] = None,
                          align: int = SLOT_ALIGN,
                          index_dtype=np.int32, slots: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Binary twin of :func:`ell_pack_stack`: ``(cols (b, rows, m), deg
    (b, rows) int32)``, no value array (the caller has checked that
    every value is one)."""
    rows = _stack_rows(mats, rows)
    m_slots = _stack_slots(mats, align) if slots is None else int(slots)
    cols = np.zeros((len(mats), rows, m_slots), dtype=index_dtype)
    deg = np.zeros((len(mats), rows), dtype=np.int32)
    for i, m in enumerate(mats):
        if m is None or m.nnz == 0:
            continue
        csr = m.tocsr()
        cols[i], _ = ell_pack(csr, max_nnz=m_slots, with_data=False,
                              index_dtype=index_dtype)
        deg[i] = np.diff(csr.indptr).astype(np.int32)
    return cols, deg


def csr_flat_pack(m: sparse.spmatrix, pad_to: Optional[int] = None,
                  dtype=np.float32, align: int = SLOT_ALIGN,
                  index_dtype=np.int32
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat COO ``(rows, cols, data)`` sorted by row, padded to a nonzero
    budget; padding entries sit in the dummy row ``m.shape[0]`` at
    column 0 (the scatter drops them)."""
    coo = m.tocoo()
    order = np.argsort(coo.row, kind="stable")
    r = coo.row[order].astype(index_dtype)
    c = coo.col[order].astype(index_dtype)
    d = coo.data[order].astype(dtype)
    nnz = r.size
    budget = pad_to if pad_to is not None else align_up(max(nnz, 1), align)
    if nnz > budget:
        raise ValueError(f"nnz {nnz} exceeds budget {budget}")
    rows_pad = np.full(budget, m.shape[0], dtype=index_dtype)
    cols_pad = np.zeros(budget, dtype=index_dtype)
    data_pad = np.zeros(budget, dtype=dtype)
    rows_pad[:nnz] = r
    cols_pad[:nnz] = c
    data_pad[:nnz] = d
    return rows_pad, cols_pad, data_pad


def flat_pack_stack(mats: List[Optional[sparse.spmatrix]], dtype=np.float32,
                    align: int = SLOT_ALIGN, rows: Optional[int] = None,
                    index_dtype=np.int32, budget: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Equal-shaped sparse blocks -> stacked flat COO ``(rows, cols,
    data)``, each ``(b, B)`` with one nonzero budget B (the fullest
    block's, aligned, or ``budget`` when given); padding entries point
    at the dummy row ``rows``."""
    n_rows = _stack_rows(mats, rows)
    if budget is None:
        need = max((int(m.nnz) for m in mats if m is not None),
                   default=0)
        budget = align_up(need, align) if need else 0
    r = np.full((len(mats), budget), n_rows, dtype=index_dtype)
    c = np.zeros((len(mats), budget), dtype=index_dtype)
    d = np.zeros((len(mats), budget), dtype=dtype)
    for i, m in enumerate(mats):
        if m is None or m.nnz == 0:
            continue
        r[i], c[i], d[i] = csr_flat_pack(m, pad_to=budget, dtype=dtype,
                                         index_dtype=index_dtype)
    return r, c, d


def auto_chunk(rows: int, k: int, m: int, budget_bytes: int,
               itemsize: int = 4, lanes: int = 1) -> Optional[int]:
    """Slot chunk that bounds the plain ELL gathers' intermediate
    (``rows x chunk x k`` elements) to ``budget_bytes``; None when every
    slot fits at once.  ``lanes`` pads k as a device's tiling would (1
    on the card and the CPU, which pad nothing).  Aligned down to
    :data:`SLOT_ALIGN`, which is also the least chunk."""
    if m == 0 or rows <= 0 or k <= 0:
        return None
    k_phys = max(k, lanes)
    if rows * m * k_phys * itemsize <= budget_bytes:
        return None
    c = int(budget_bytes // (rows * k_phys * itemsize))
    c = max(c - c % SLOT_ALIGN, SLOT_ALIGN)
    return None if c >= m else c


def ell_slot_stats(cols, data=None, deg=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-entry (nnz, slots) over the leading axis of a stacked ELL
    packing: ``deg`` counts exactly, ``data`` counts nonzero values, and
    with neither the stack is taken as full."""
    cols = np.asarray(cols)
    nb = cols.shape[0]
    slots = np.full(nb, int(np.prod(cols.shape[1:], dtype=np.int64)),
                    dtype=np.int64)
    if deg is not None:
        nnz = np.asarray(deg).reshape(nb, -1).sum(axis=1, dtype=np.int64)
    elif data is not None:
        nnz = np.count_nonzero(
            np.asarray(data).reshape(nb, -1), axis=1).astype(np.int64)
    else:
        nnz = slots.copy()
    return nnz, slots


def flat_slot_stats(rows, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-entry (nnz, slots) of a flat COO stack: the real nonzeros are
    the entries below the dummy row ``n_rows``."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None]
    nnz = (rows < n_rows).sum(axis=1, dtype=np.int64)
    slots = np.full(rows.shape[0], rows.shape[1], dtype=np.int64)
    return nnz, slots


# -- their plain products (row-major torch tensors, float32 sums) ------------

def _gather_sums(cols: torch.Tensor, data: Optional[torch.Tensor],
                 deg: Optional[torch.Tensor], x_flat: torch.Tensor,
                 base: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    """``acc[b, r] = sum_j w[b, r, j] * x_flat[base[b] + cols[b, r, j]]``
    in float32, ``chunk`` slots at a time: cols ``(b, rows, m)``."""
    b, rows, m = cols.shape
    k = x_flat.shape[1]
    acc = torch.zeros((b, rows, k), dtype=torch.float32,
                      device=x_flat.device)
    step = max(1, m if chunk is None else min(chunk, m))
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        idx = cols[:, :, lo:hi].long() + base.view(b, 1, 1)
        g = x_flat.index_select(0, idx.reshape(-1)).reshape(
            b, rows, hi - lo, k).float()
        if data is not None:
            w = data[:, :, lo:hi].float()
        else:
            slot = torch.arange(lo, hi, device=x_flat.device)
            w = (slot[None, None, :] < deg[:, :, None]).float()
        acc += torch.einsum("brm,brmk->brk", w, g)
    return acc


def _check_weights(data, deg, m: int) -> None:
    if data is None and deg is None and m > 0:
        raise ValueError("binary ELL (data=None) requires deg")


def ell_spmm(cols: torch.Tensor, data: Optional[torch.Tensor],
             x: torch.Tensor, chunk: Optional[int] = None,
             deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain row-major ELL product ``out[r] = sum_j data[r, j] *
    x[cols[r, j]]`` (binary: ``data=None`` and ``deg``, slot j of row r
    counts iff ``j < deg[r]``): cols ``(rows, m)``, x ``(n, k)`` ->
    ``(rows, k)`` in x's dtype, float32 sums, ``chunk`` slots at a time
    (None: all)."""
    rows, m = cols.shape
    _check_weights(data, deg, m)
    base = torch.zeros(1, dtype=torch.int64, device=x.device)
    return _gather_sums(cols[None], None if data is None else data[None],
                        None if deg is None else deg[None], x, base,
                        chunk)[0].to(x.dtype)


def ell_spmm_batched(cols: torch.Tensor, data: Optional[torch.Tensor],
                     x: torch.Tensor, chunk: Optional[int] = None,
                     deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`ell_spmm` per block: cols/data ``(b, rows, m)`` (binary:
    deg ``(b, rows)``), x ``(b, n, k)`` -> ``(b, rows, k)``."""
    b, rows, m = cols.shape
    _check_weights(data, deg, m)
    n, k = x.shape[1], x.shape[2]
    base = torch.arange(b, device=x.device) * n
    return _gather_sums(cols, data, deg, x.reshape(b * n, k), base,
                        chunk).to(x.dtype)


def ell_spmm_shared(cols: torch.Tensor, data: Optional[torch.Tensor],
                    x0: torch.Tensor, chunk: Optional[int] = None,
                    deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`ell_spmm` of every block against one operand: cols/data
    ``(b, rows, m)``, x0 ``(n, k)`` -> ``(b, rows, k)``."""
    b = cols.shape[0]
    _check_weights(data, deg, cols.shape[2])
    base = torch.zeros(b, dtype=torch.int64, device=x0.device)
    return _gather_sums(cols, data, deg, x0, base, chunk).to(x0.dtype)


def csr_flat_spmm(rows: torch.Tensor, cols: torch.Tensor,
                  data: Optional[torch.Tensor], x: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """Plain scatter-add product over a flat nonzero list: ``out[rows[e]]
    += data[e] * x[cols[e]]`` into ``n_rows`` rows plus one dummy row
    that absorbs the padding (``data=None``: binary, every entry one).
    x ``(n, k)`` -> ``(n_rows, k)`` in x's dtype, float32 sums."""
    g = x.index_select(0, cols.long()).float()
    contrib = g if data is None else data.float()[:, None] * g
    out = torch.zeros((n_rows + 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, rows.long(), contrib)
    return out[:n_rows].to(x.dtype)


# -- K1's form of an ELL stack ------------------------------------------------

def ell_stack_tier(cols: torch.Tensor, offsets: torch.Tensor,
                   data: Optional[torch.Tensor] = None,
                   deg: Optional[torch.Tensor] = None):
    """A stack of block-local ELL blocks as one K1 tier: ``cols (b, w,
    m)`` (any integer dtype) with block i's columns shifted by
    ``offsets[i]`` into the flat row space -> ``(cols (m, b*w) int32
    slot-major, data (m, b*w) float32 or None, deg (b*w,) int32 or
    None)``, on the stack's device.  Row ``i*w + r`` of the tier is row
    r of block i; its padding slots gather row ``offsets[i]`` with weight
    zero (weighted) or are never read (binary)."""
    b, w, m = cols.shape
    glob = cols.long() + offsets.to(cols.device).long().view(b, 1, 1)
    tier = glob.permute(2, 0, 1).reshape(m, b * w).to(
        torch.int32).contiguous()
    d = None if data is None else data.float().permute(2, 0, 1).reshape(
        m, b * w).contiguous()
    g = None if deg is None else deg.reshape(b * w).to(
        torch.int32).contiguous()
    return tier, d, g

"""The arrow blocks of one level and their plain single-device product.

Counterpart of ``arrow_matrix_tpu/ops/arrow_blocks.py``.  An arrow
matrix of ``nb`` block-rows of width ``w`` has nonzero blocks only at
(0, j), (i, 0), (i, i) and, in banded mode, (i, i+-1).  Each kind is one
stack with a leading block axis:

    head:  block j holds A_0j   (the head row)
    diag:  block i holds A_ii   (zero at i = 0)
    col:   block i holds A_i0   (zero at i = 0)
    lo/hi: banded only, block i holds A_i,i-1 / A_i,i+1 (zero where the
           block does not exist: lo at 0 and 1, hi at 0 and nb-1)

One product ``C = B @ X`` with X blocked like the rows, ``(nb, w, k)``:

    C_0 = sum_j A_0j X_j
    C_i = A_ii X_i + A_i0 X_0 [+ A_i,i-1 X_{i-1} + A_i,i+1 X_{i+1}]

Two block formats, as in the JAX package:

* ``fmt="dense"``: ``(nb, w, w)`` stacks; :func:`column_spmm` (the C_i,
  i >= 1) and :func:`head_spmm` (C_0) are the plain versions of the
  hand-written kernels K2 and K3 (``csrc/arrow_blocks_spmm.cu``,
  wrapper ``ops/cuda_blocks.py``);
* ``fmt="ell"``: ``(nb, w, m)`` stacks of block-local columns (int16
  below width 32767), ``*_data`` values or, binary, ``*_deg`` degrees;
  the head is one of three layouts: a per-block ELL stack, a flat COO
  list per block (``head_flat``: the head rows are the pruned hubs,
  whose degrees would pad an ELL by orders of magnitude), or one ELL of
  the ``w`` head rows over global columns (``head_gell``).  On the card
  every ELL stack and head runs through K1 (``ops/cuda_ell.py``).

:func:`arrow_spmm` is the plain product of either format (float32 sums
whatever the block dtype).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.io.graphio import (
    CsrLike,
    csr_row_range,
    load_block,
    num_nonzeros,
    num_rows,
    number_of_blocks,
)
from arrow_matrix_tpu_torch.ops.ell import (
    SLOT_ALIGN,
    align_up,
    block_index_dtype,
    csr_flat_spmm,
    dense_pack_stack,
    ell_pack,
    ell_pack_stack,
    ell_pack_stack_binary,
    ell_slot_stats,
    ell_spmm,
    ell_spmm_batched,
    ell_spmm_shared,
    flat_pack_stack,
    flat_slot_stats,
)
from arrow_matrix_tpu_torch.ops.sell import nbytes_of, resolve_binary
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device

#: Block-storage dtypes by name.
BLOCK_DTYPES = {"f32": torch.float32, "float32": torch.float32,
                "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}

STACKS = ("head", "diag", "col", "lo", "hi")

#: Head layouts of an ELL level ("auto" picks flat or ell by size).
HEAD_FORMATS = ("auto", "flat", "ell", "gell")


def resolve_block_dtype(dtype) -> torch.dtype:
    """Block-storage dtype: "f32"/"bf16" (or their long names), a torch
    dtype among those, or a numpy dtype named float32 or bfloat16 (the
    JAX package's ``np.float32`` / ``ml_dtypes.bfloat16``).  bf16 halves
    the resident block bytes; every product still sums in float32."""
    if isinstance(dtype, torch.dtype):
        name = {torch.float32: "f32", torch.bfloat16: "bf16"}.get(dtype)
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    try:
        return BLOCK_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown block dtype {dtype!r} (expected 'f32' "
                         f"or 'bf16')") from None


def scipy_safe_dtype(dtype):
    """The dtype a block passes through scipy.sparse at: ``dtype`` when
    scipy can hold it, else float32 (scipy has no bf16; the packers
    round to the storage dtype once).  Takes numpy or torch dtypes."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.float32
        dtype = torch.empty(0, dtype=dtype).numpy().dtype.type
    try:
        sparse.csr_matrix((0, 0), dtype=dtype)
        return dtype
    except (TypeError, ValueError):
        return np.float32


@dataclass
class ArrowBlocks:
    """The stacks of one arrow level on a device, in the JAX package's
    field names.

    Dense (``fmt="dense"``): ``*_data`` are ``(nb, w, w)`` and the other
    arrays None.  ELL (``fmt="ell"``): ``*_cols`` ``(nb, w, m)``
    block-local columns, with ``*_data`` (weighted) or ``*_deg`` ``(nb,
    w)`` (binary); ``lo``/``hi`` only when ``banded``.  The ELL head is
    per-block ELL like the other stacks, or flat COO (``head_flat``:
    ``head_rows``/``head_cols``/``head_data`` ``(nb, B)``, padding in the
    dummy row ``w``, no values when binary), or global-row ELL
    (``head_gell``: ``head_cols`` ``(w, m)`` over global columns, with
    ``head_data`` or ``head_deg`` ``(w,)``).

    ``k1`` caches the ELL stacks and head as K1 operators with their
    work lists (``ops/cuda_ell.py:k1_operands``); no constructor takes
    it.
    """

    head_cols: Optional[torch.Tensor] = None
    head_data: Optional[torch.Tensor] = None
    diag_cols: Optional[torch.Tensor] = None
    diag_data: Optional[torch.Tensor] = None
    col_cols: Optional[torch.Tensor] = None
    col_data: Optional[torch.Tensor] = None
    lo_cols: Optional[torch.Tensor] = None
    lo_data: Optional[torch.Tensor] = None
    hi_cols: Optional[torch.Tensor] = None
    hi_data: Optional[torch.Tensor] = None
    head_rows: Optional[torch.Tensor] = None
    head_deg: Optional[torch.Tensor] = None
    diag_deg: Optional[torch.Tensor] = None
    col_deg: Optional[torch.Tensor] = None
    lo_deg: Optional[torch.Tensor] = None
    hi_deg: Optional[torch.Tensor] = None
    width: int = 0
    n_blocks: int = 0
    banded: bool = False
    fmt: str = "dense"
    head_flat: bool = False
    head_gell: bool = False
    k1: dict = field(default_factory=dict, init=False, repr=False,
                     compare=False)

    @property
    def dtype(self) -> torch.dtype:
        """The value dtype (float32 for binary ELL, which has none)."""
        return (torch.float32 if self.diag_data is None
                else self.diag_data.dtype)

    @property
    def binary(self) -> bool:
        return self.diag_data is None

    @property
    def n_rows(self) -> int:
        return self.width * self.n_blocks

    def stacks(self) -> Dict[str, torch.Tensor]:
        """The value stacks present, by name (head, diag, col[, lo, hi])."""
        return {name: t for name in STACKS
                if (t := getattr(self, f"{name}_data")) is not None}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every array of the level, by field name."""
        return {f.name: t for f in fields(self)
                if isinstance(t := getattr(self, f.name), torch.Tensor)}

    def device_nbytes(self) -> int:
        """Bytes of the level's arrays and of its K1 operators, each
        array once (on the card an ELL stack is also held as int32
        global columns, twice the int16 index bytes of its stack)."""
        return nbytes_of(*self.tensors().values(), *self.k1.values())

    def to(self, device: DeviceLike) -> "ArrowBlocks":
        dev = resolve_device(device)
        kw = {f.name: getattr(self, f.name) for f in fields(self)
              if f.init}
        for name, t in self.tensors().items():
            kw[name] = t.to(dev)
        return ArrowBlocks(**kw)


def stack_coords(nb: int, nb_padded: int, banded: bool
                 ) -> Dict[str, List[Optional[Tuple[int, int]]]]:
    """Per-stack block coordinates, None for structurally empty slots
    (the block layout of the JAX package's ``_stack_coords``)."""
    coords = {
        "head": [(0, j) if j < nb else None for j in range(nb_padded)],
        "diag": [None] + [(i, i) if i < nb else None
                          for i in range(1, nb_padded)],
        "col": [None] + [(i, 0) if i < nb else None
                         for i in range(1, nb_padded)],
    }
    if banded:
        coords["lo"] = [None, None] + [(i, i - 1) if i < nb else None
                                       for i in range(2, nb_padded)]
        coords["hi"] = [None] + [(i, i + 1) if i + 1 < nb else None
                                 for i in range(1, nb_padded)]
    return coords


def resolve_blocks_binary(matrix: CsrLike, fmt: str, binary) -> bool:
    """Level-wide binary decision of the block formats: implicit-ones
    triplets are binary, "auto" detects all-ones values; dense blocks
    always carry values."""
    if fmt == "dense":
        return False
    if isinstance(matrix, sparse.csr_matrix):
        return resolve_binary(binary, matrix.data, nnz=matrix.nnz)
    data, _, indptr = matrix
    return resolve_binary(binary, data, nnz=int(np.asarray(indptr[-1])))


def gell_head_pack(matrix: CsrLike, width: int, binary: bool = False
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], int,
                              Optional[np.ndarray]]:
    """The head rows [0, width) as ONE ``(width, m)`` ELL over global
    columns: ``(cols int32, data f32 or None, nnz, deg (width,) int32 or
    None)``; m is the longest head row, aligned (the JAX package's
    ``_gell_head_pack``)."""
    n = num_rows(matrix)
    if isinstance(matrix, sparse.csr_matrix):
        data, indices, indptr = matrix.data, matrix.indices, matrix.indptr
    else:
        data, indices, indptr = matrix
    w_eff = min(width, n)
    hi = int(indptr[w_eff])
    sub_indptr = np.asarray(indptr[:w_eff + 1], dtype=np.int64)
    if w_eff < width:
        sub_indptr = np.pad(sub_indptr, (0, width - w_eff), mode="edge")
    sub_data = (np.ones(hi, dtype=np.float32) if data is None
                else np.asarray(data[:hi]))
    sub = sparse.csr_matrix((sub_data, np.asarray(indices[:hi]),
                             sub_indptr), shape=(width, n))
    counts = np.diff(sub.indptr)
    need = int(counts.max()) if counts.size and counts.max() > 0 else 0
    m = align_up(need, SLOT_ALIGN) if need else 0
    cols, packed = ell_pack(sub, max_nnz=m, dtype=np.float32)
    if binary:
        return cols, None, hi, counts.astype(np.int32)
    return cols, packed, hi, None


def choose_flat_head_from_stats(nb: int, width: int, max_row_nnz: int,
                                max_block_nnz: int, dtype,
                                head_fmt: str) -> bool:
    """The flat-vs-ELL head decision: "flat" and "ell" as named; "auto"
    picks flat when its footprint is at least 4x smaller.  ``dtype`` is
    the value dtype (its itemsize enters the footprints)."""
    if head_fmt == "flat":
        return True
    if head_fmt == "ell":
        return False
    if head_fmt != "auto":
        raise ValueError(f"unknown head format {head_fmt!r}")
    itemsize = resolve_block_dtype(dtype).itemsize
    ell = nb * width * align_up(max_row_nnz, SLOT_ALIGN) * (4 + itemsize)
    flat = nb * align_up(max_block_nnz, SLOT_ALIGN) * (8 + itemsize)
    return flat * 4 <= ell


def head_stats(matrix: CsrLike, width: int, nb: int) -> Tuple[int, int]:
    """(longest row, fullest block) over the head blocks A_0j, loading
    only those blocks."""
    max_row = max_nnz = 0
    for j in range(nb):
        b = load_block(matrix, 0, width, j * width, (j + 1) * width, width)
        counts = np.diff(b.indptr)
        if counts.size:
            max_row = max(max_row, int(counts.max()))
        max_nnz = max(max_nnz, int(b.nnz))
    return max_row, max_nnz


def choose_flat_head(head, width: int, dtype, head_fmt: str) -> bool:
    """:func:`choose_flat_head_from_stats` over loaded head blocks."""
    max_row = max_nnz = 0
    for m in head:
        if m is None or m.nnz == 0:
            continue
        counts = np.diff(m.tocsr().indptr)
        if counts.size:
            max_row = max(max_row, int(counts.max()))
        max_nnz = max(max_nnz, int(m.nnz))
    return choose_flat_head_from_stats(len(head), width, max_row, max_nnz,
                                       dtype, head_fmt)


def arrow_blocks_from_csr(matrix: CsrLike, width: int,
                          banded: bool = False,
                          pad_blocks_to: Optional[int] = None,
                          dtype=torch.float32,
                          check: bool = True,
                          fmt: str = "dense",
                          head_fmt: str = "auto",
                          binary="auto",
                          device: DeviceLike = None) -> ArrowBlocks:
    """Tile an arrow-shaped CSR (or memmapped triplet) into stacks on
    ``device`` (the card unless ``"cpu"`` is asked for).

    Trailing all-zero block rows and columns are truncated;
    ``pad_blocks_to`` appends empty block-rows so every level of a
    decomposition can share one flat row count.  A dense stack is
    written on the device from its blocks' nonzeros; an ELL stack is
    packed on the host, moved to the device and dropped before the
    next, so the host holds one ELL stack at a time.  The packed arrays
    are the JAX package's, byte for byte.

    ``fmt`` is "dense" (the port's default: ``(nb, w, w)`` stacks) or
    "ell"; under "ell" (only), ``head_fmt`` picks the head: "flat", "ell",
    "gell", or "auto" (flat when its footprint is at least 4x smaller
    than ELL's).  ``binary`` ("auto", True, False) drops the ELL value
    arrays of an all-ones matrix for degrees; dense blocks always carry
    values.  ``dtype`` is the value dtype, float32 or bf16.

    With ``check`` the tiling verifies that the arrow-pattern blocks
    capture every nonzero: a matrix wider than ``width`` (a
    decomposition's grown last level) raises instead of losing entries.
    Needs a canonical (duplicate-free) input, as the loaders give.
    """
    if fmt not in ("dense", "ell"):
        raise ValueError(f"unknown block format {fmt!r}")
    if fmt == "ell" and head_fmt not in HEAD_FORMATS:
        raise ValueError(f"unknown head format {head_fmt!r}")
    dev = resolve_device(device)
    dtype = resolve_block_dtype(dtype)
    nb = number_of_blocks(matrix, width)
    nb_padded = max(pad_blocks_to or nb, nb)
    is_binary = resolve_blocks_binary(matrix, fmt, binary)
    idt = block_index_dtype(width)
    captured = 0

    def blk(ij):
        nonlocal captured
        if ij is None:
            return None
        i, j = ij
        # Cut at float32 for either storage dtype (scipy cannot hold
        # bf16); the packers round once.
        b = load_block(matrix, i * width, (i + 1) * width,
                       j * width, (j + 1) * width, width,
                       dtype=scipy_safe_dtype(dtype))
        captured += b.nnz
        return b

    def put(a, values=False):
        if a is None:
            return None
        t = torch.from_numpy(a)
        return (t.to(dtype) if values else t).to(dev)

    def pack(mats) -> dict:
        """The stack's arrays on the device: data (dense or weighted
        ELL), cols (ELL), deg (binary ELL)."""
        if fmt == "dense":
            return {"data": dense_pack_stack(mats, dtype=dtype, rows=width,
                                             device=dev)}
        if is_binary:
            cols, deg = ell_pack_stack_binary(mats, rows=width,
                                              index_dtype=idt)
            return {"cols": put(cols), "deg": put(deg)}
        cols, data = ell_pack_stack(mats, rows=width, index_dtype=idt)
        return {"cols": put(cols), "data": put(data, values=True)}

    kw = {}
    head_flat = False
    head_gell = fmt == "ell" and head_fmt == "gell"
    coords = stack_coords(nb, nb_padded, banded)
    if head_gell:
        cols, data, nnz, deg = gell_head_pack(matrix, width,
                                              binary=is_binary)
        captured += nnz
        kw.update(head_cols=put(cols), head_data=put(data, values=True),
                  head_deg=put(deg))
    else:
        head = [blk(ij) for ij in coords["head"]]
        head_flat = fmt == "ell" and choose_flat_head(head, width, dtype,
                                                      head_fmt)
        if head_flat:
            rows, cols, data = flat_pack_stack(head, rows=width,
                                               index_dtype=idt)
            kw.update(head_rows=put(rows), head_cols=put(cols),
                      head_data=None if is_binary
                      else put(data, values=True))
        else:
            kw.update({f"head_{k}": v for k, v in pack(head).items()})
        del head
    for name in STACKS[1:]:
        if name in coords:
            kw.update({f"{name}_{k}": v for k, v in pack(
                [blk(ij) for ij in coords[name]]).items()})

    if check:
        total = num_nonzeros(matrix)
        if captured != total:
            raise ValueError(
                f"arrow tiling captured {captured} of {total} nonzeros: "
                f"the matrix has entries outside the "
                f"{'banded' if banded else 'block-diagonal'} arrow "
                f"pattern at width {width} / {nb} blocks (did the last "
                f"level's achieved width exceed the requested width?)")
    return ArrowBlocks(width=width, n_blocks=nb_padded, banded=banded,
                       fmt=fmt, head_flat=head_flat, head_gell=head_gell,
                       **kw)


def load_stack_blocks(matrix: CsrLike, width: int,
                      cs: List[Optional[Tuple[int, int]]]
                      ) -> List[Optional[sparse.csr_matrix]]:
    """The blocks at coordinates ``cs`` (None for a structurally empty
    slot), each cut from the CSR or triplet at float32 (scipy cannot
    hold bf16; the packers round once): only these blocks are read."""
    return [None if ij is None else load_block(
        matrix, ij[0] * width, (ij[0] + 1) * width, ij[1] * width,
        (ij[1] + 1) * width, width, dtype=np.float32) for ij in cs]


def shard_range(nb_padded: int, mesh, axis: str) -> Tuple[int, int]:
    """``(first block row, block rows)`` of this rank's contiguous share
    of ``nb_padded`` block rows over the mesh's ``axis``."""
    n_dev = mesh.shape[axis]
    if nb_padded % n_dev:
        raise ValueError(f"{nb_padded} blocks not divisible by {n_dev} "
                         f"devices on axis {axis!r}; pass pad_blocks_to "
                         f"a multiple of the device count")
    per = nb_padded // n_dev
    return mesh.axis_index(axis) * per, per


def arrow_blocks_streamed(matrix: CsrLike, width: int, mesh,
                          axis: str = "blocks",
                          n_blocks: Optional[int] = None,
                          pad_blocks_to: Optional[int] = None,
                          banded: bool = False,
                          dtype=torch.float32,
                          check: bool = True,
                          fmt: str = "ell",
                          head_fmt: str = "auto",
                          binary="auto") -> ArrowBlocks:
    """This rank's block rows of one level, packed as the JAX package's
    ``arrow_blocks_streamed`` packs the whole level and shards it over
    ``axis``: every array of the result equals the matching rows of the
    JAX global arrays, byte for byte.  ``matrix`` is a CSR or a
    (memmapped) ``(data, indices, indptr)`` triplet, and the rank reads
    only its own blocks; its host memory is one stack of its shard.

    Pass 1 loads the rank's blocks one stack at a time and keeps, of
    each stack, its longest row (and of the head, its fullest block);
    the ranks then agree the stacks' slot budgets (the longest row of
    the whole stack, aligned) and the captured-nonzero sum through
    ``parallel/collectives.py``, both counted.  The capture check then
    raises on every rank alike.  Pass 2 packs the rank's rows at the
    agreed budgets and moves each stack to ``mesh.device`` before the
    next is packed.  ``n_blocks`` of the result is the rank's block-row
    count (its first block row is :func:`shard_range`'s).  Collective:
    every rank of ``axis`` calls it with the same arguments."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll

    if fmt not in ("ell", "dense"):
        raise ValueError(f"unknown block format {fmt!r}")
    dev = torch.device(mesh.device)
    dtype = resolve_block_dtype(dtype)
    nb = n_blocks if n_blocks is not None else number_of_blocks(matrix,
                                                                width)
    nb_padded = max(pad_blocks_to or nb, nb)
    b0, nb_l = shard_range(nb_padded, mesh, axis)
    coords = {name: cs[b0:b0 + nb_l] for name, cs in
              stack_coords(nb, nb_padded, banded).items()}
    is_binary = resolve_blocks_binary(matrix, fmt, binary)
    idt = block_index_dtype(width)

    # Pass 1: the rank's needs, one stack's blocks at a time.
    need: Dict[str, int] = {}
    captured = head_nnz = 0
    for name, cs in coords.items():
        need[name] = 0
        for b in load_stack_blocks(matrix, width, cs):
            if b is None:
                continue
            captured += b.nnz
            counts = np.diff(b.indptr)
            if counts.size:
                need[name] = max(need[name], int(counts.max()))
            if name == "head":
                head_nnz = max(head_nnz, int(b.nnz))
    # The whole stack's budgets, agreed over the ranks.
    for name in coords:
        need[name] = coll.all_reduce_max(need[name], mesh, axis)
    head_nnz = coll.all_reduce_max(head_nnz, mesh, axis)
    captured = coll.all_reduce_int_sum(captured, mesh, axis)
    slots = {name: align_up(v, SLOT_ALIGN) if v else 0
             for name, v in need.items()}
    # The flat-or-ELL head by the eager pack's own rule.
    head_flat = fmt == "ell" and choose_flat_head_from_stats(
        nb_padded, width, need["head"], head_nnz, dtype, head_fmt)
    if check:
        total = num_nonzeros(matrix)
        if captured != total:
            raise ValueError(
                f"arrow tiling captured {captured} of {total} nonzeros: "
                f"the matrix has entries outside the "
                f"{'banded' if banded else 'block-diagonal'} arrow "
                f"pattern at width {width} / {nb} blocks")

    def put(a, values=False):
        t = torch.from_numpy(a)
        return (t.to(dtype) if values else t).to(dev)

    # Pass 2: the rank's rows at the agreed budgets.
    kw = {}
    for name, cs in coords.items():
        mats = load_stack_blocks(matrix, width, cs)
        if name == "head" and head_flat:
            budget = align_up(head_nnz, SLOT_ALIGN) if head_nnz else 0
            rows, cols, data = flat_pack_stack(mats, rows=width,
                                               index_dtype=idt,
                                               budget=budget)
            kw.update(head_rows=put(rows), head_cols=put(cols),
                      head_data=None if is_binary
                      else put(data, values=True))
        elif fmt == "dense":
            kw[f"{name}_data"] = dense_pack_stack(mats, dtype=dtype,
                                                  rows=width, device=dev)
        elif is_binary:
            cols, deg = ell_pack_stack_binary(mats, rows=width,
                                              index_dtype=idt,
                                              slots=slots[name])
            kw.update({f"{name}_cols": put(cols), f"{name}_deg": put(deg)})
        else:
            cols, data = ell_pack_stack(mats, rows=width, index_dtype=idt,
                                        slots=slots[name])
            kw.update({f"{name}_cols": put(cols),
                       f"{name}_data": put(data, values=True)})
        del mats
    return ArrowBlocks(width=width, n_blocks=nb_l, banded=banded, fmt=fmt,
                       head_flat=head_flat, **kw)


# -- the plain product -------------------------------------------------------

def column_spmm(diag: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                lo: Optional[torch.Tensor] = None,
                hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every dense block row but the head: ``C_b = A_bb X_b + A_b0 X_0
    [+ A_b,b-1 X_{b-1} + A_b,b+1 X_{b+1}]`` for b >= 1, each product
    summed in float32; block 0 (the head row's) comes out zero.

    diag/col (and lo/hi, banded) ``(nb, w, w)``; x ``(nb, w, k)`` ->
    ``(nb, w, k)`` in x's dtype.
    """
    nb, w, k = x.shape
    acc = torch.zeros((nb, w, k), dtype=torch.float32, device=x.device)
    acc[1:] = column_rows_spmm(diag[1:], col[1:], x, 1,
                               None if lo is None else lo[1:],
                               None if hi is None else hi[1:])
    return acc.to(x.dtype)


def column_rows_spmm(diag: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                     first: int, lo: Optional[torch.Tensor] = None,
                     hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The block rows ``b = first .. first + rows - 1`` of the operand
    ``x (nb, w, k)``: ``out[z] = A_bb X_b + A_b0 X_0 [+ A_b,b-1 X_{b-1} +
    A_b,b+1 X_{b+1}]`` with ``b = first + z``, the last term only where
    ``b + 1 < nb``; each product summed in float32.

    diag/col (and lo/hi, banded) ``(rows, w, w)``: the blocks of those
    rows only -> ``(rows, w, k)`` float32.  ``first >= 1``: block 0 of
    the operand is X_0.
    """
    rows, nb = diag.shape[0], x.shape[0]
    if first < 1 or first + rows > nb:
        raise ValueError(f"block rows {first}..{first + rows - 1} outside "
                         f"the operand's 1..{nb - 1}")
    xf = x.float()
    acc = torch.bmm(diag.float(), xf[first:first + rows])
    acc += torch.matmul(col.float(), xf[0])
    if lo is not None:
        acc += torch.bmm(lo.float(), xf[first - 1:first + rows - 1])
        n_hi = max(0, min(rows, nb - first - 1))
        acc[:n_hi] += torch.bmm(hi[:n_hi].float(),
                                xf[first + 1:first + 1 + n_hi])
    return acc


def head_spmm(head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The dense head row ``C_0 = sum_b A_0b X_b``: head ``(nb, w, w)``,
    x ``(nb, w, k)`` -> ``(w, k)`` in x's dtype, summed in float32."""
    return torch.bmm(head.float(), x.float()).sum(dim=0).to(x.dtype)


def block_spmm(fmt: str, cols: Optional[torch.Tensor],
               data: Optional[torch.Tensor], x: torch.Tensor,
               chunk: Optional[int] = None,
               deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-block product of a stack: ``(b, ...)`` blocks x ``(b, w, k)``
    -> ``(b, w, k)`` (binary ELL stacks: data None, deg ``(b, w)``)."""
    if fmt == "dense":
        return torch.bmm(data.float(), x.float()).to(x.dtype)
    return ell_spmm_batched(cols, data, x, chunk=chunk, deg=deg)


def block_spmm_shared(fmt: str, cols: Optional[torch.Tensor],
                      data: Optional[torch.Tensor], x0: torch.Tensor,
                      chunk: Optional[int] = None,
                      deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-block product of a stack against one operand X_0: ``(b,
    ...)`` blocks x ``(w, k)`` -> ``(b, w, k)``."""
    if fmt == "dense":
        return torch.matmul(data.float(), x0.float()).to(x0.dtype)
    return ell_spmm_shared(cols, data, x0, chunk=chunk, deg=deg)


def head_block_spmm(blocks: ArrowBlocks, x: torch.Tensor,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """Per-block head contributions ``A_0j X_j``, ``(nb, w, k)``; their
    sum over the block axis is C_0.  Flat heads scatter-add per block
    (each block's padding into its own dummy row); ELL and dense heads
    go through :func:`block_spmm`.  A gell head has no per-block form."""
    if blocks.head_gell:
        raise ValueError("gell heads gather from the whole feature array "
                         "and have no per-block form (arrow_spmm takes "
                         "them directly)")
    if not blocks.head_flat:
        return block_spmm(blocks.fmt, blocks.head_cols, blocks.head_data,
                          x, chunk=chunk, deg=blocks.head_deg)
    nb, w, k = x.shape
    blk = torch.arange(nb, device=x.device)[:, None]
    cols = blocks.head_cols.long() + blk * w
    rows = blocks.head_rows.long() + blk * (w + 1)
    data = None if blocks.head_data is None else blocks.head_data.reshape(-1)
    # Block j's rows are [j (w + 1), (j + 1)(w + 1)), its padding in
    # the last of them.
    out = csr_flat_spmm(rows.reshape(-1), cols.reshape(-1), data,
                        x.reshape(nb * w, k), nb * (w + 1))
    return out.view(nb, w + 1, k)[:, :w]


def arrow_spmm(blocks: ArrowBlocks, x: torch.Tensor,
               chunk: Optional[int] = None) -> torch.Tensor:
    """One level's product, plain: x ``(nb, w, k)`` blocked like the rows
    -> ``(nb, w, k)`` in x's dtype (the JAX ``arrow_spmm``).  ``chunk``
    bounds the ELL gathers' intermediate (slots at a time)."""
    nb, w, k = x.shape
    if nb != blocks.n_blocks or w != blocks.width:
        raise ValueError(f"x must be ({blocks.n_blocks}, {blocks.width}, "
                         f"k), got {tuple(x.shape)}")
    if blocks.fmt == "dense":
        c = column_spmm(blocks.diag_data, blocks.col_data, x,
                        blocks.lo_data, blocks.hi_data)
        c[0] = head_spmm(blocks.head_data, x)
        return c
    if blocks.head_gell:
        c0 = ell_spmm(blocks.head_cols, blocks.head_data,
                      x.reshape(nb * w, k), chunk=chunk,
                      deg=blocks.head_deg)
    else:
        c0 = head_block_spmm(blocks, x, chunk=chunk).sum(dim=0)
    c = block_spmm(blocks.fmt, blocks.diag_cols, blocks.diag_data, x,
                   chunk=chunk, deg=blocks.diag_deg)
    c = c + block_spmm_shared(blocks.fmt, blocks.col_cols, blocks.col_data,
                              x[0], chunk=chunk, deg=blocks.col_deg)
    if blocks.banded:
        zeros = x.new_zeros((1, w, k))
        c = c + block_spmm(blocks.fmt, blocks.lo_cols, blocks.lo_data,
                           torch.cat([zeros, x[:-1]]), chunk=chunk,
                           deg=blocks.lo_deg)
        c = c + block_spmm(blocks.fmt, blocks.hi_cols, blocks.hi_data,
                           torch.cat([x[1:], zeros]), chunk=chunk,
                           deg=blocks.hi_deg)
    c[0] = c0
    return c


# -- host helpers ------------------------------------------------------------

def block_features(x: np.ndarray, width: int, n_blocks: int) -> np.ndarray:
    """Pad (n, k) host features with zero rows and reshape to the
    blocked (nb, w, k) layout."""
    n, k = x.shape
    total = width * n_blocks
    if n > total:
        x = x[:total]
    elif n < total:
        x = np.pad(x, ((0, total - n), (0, 0)))
    return x.reshape(n_blocks, width, k)


def unblock_features(x, n: int) -> np.ndarray:
    """Inverse of :func:`block_features`: (nb, w, k) -> host (n, k)."""
    arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return arr.reshape(-1, arr.shape[-1])[:n]


def block_row_stats(blocks: ArrowBlocks) -> dict:
    """Per-block-row (rows, nnz, slots) over the padded block grid, as
    the JAX package counts them: every stored value of a dense block and
    every slot of an ELL row is a slot; diag/col/lo/hi entry i lies on
    block row i, the whole head (any layout) on block row 0."""
    nb = blocks.n_blocks
    nnz = np.zeros(nb, dtype=np.int64)
    slots = np.zeros(nb, dtype=np.int64)
    host = {name: (t.float() if t.dtype == torch.bfloat16 else t)
            .cpu().numpy() for name, t in blocks.tensors().items()}

    def stack_stats(name):
        cols, data, deg = (host.get(f"{name}_{a}")
                           for a in ("cols", "data", "deg"))
        if blocks.fmt == "dense":
            if data is None:
                return None
            e_nnz = np.count_nonzero(data.reshape(data.shape[0], -1),
                                     axis=1).astype(np.int64)
            return e_nnz, np.full(data.shape[0],
                                  int(np.prod(data.shape[1:])), np.int64)
        if cols is None:
            return None
        return ell_slot_stats(cols, data, deg)

    for name in STACKS[1:]:
        st = stack_stats(name)
        if st is not None:
            n = min(len(st[0]), nb)
            nnz[:n] += st[0][:n]
            slots[:n] += st[1][:n]
    if blocks.head_flat:
        h_nnz, h_slots = flat_slot_stats(host["head_rows"], blocks.width)
        nnz[0] += int(h_nnz.sum())
        slots[0] += int(h_slots.sum())
    elif blocks.head_gell:
        cols = host["head_cols"]
        slots[0] += int(cols.size)
        if "head_deg" in host:
            nnz[0] += int(host["head_deg"].sum())
        else:
            nnz[0] += int(np.count_nonzero(host["head_data"]))
    else:
        st = stack_stats("head")
        if st is not None:
            nnz[0] += int(st[0].sum())
            slots[0] += int(st[1].sum())
    rows = np.full(nb, blocks.width, dtype=np.int64)
    return {"rows": rows, "nnz": nnz, "slots": slots}


def block_row_stats_from_csr(matrix: CsrLike, width: int,
                             banded: bool = False,
                             pad_blocks_to: Optional[int] = None,
                             fmt: str = "dense", head_flat: bool = False,
                             binary: bool = False, dtype=torch.float32,
                             chunk_rows: int = 1 << 16) -> dict:
    """:func:`block_row_stats` of the level :func:`arrow_blocks_from_csr`
    packs from ``matrix`` (its head an ELL or flat stack; ``head_flat``
    and ``binary`` as it resolved them), counted from the CSR
    ``chunk_rows`` rows at a time without packing a stack: a dense or
    ELL entry holds ``w*w`` or ``w*m`` slots (m the stack's longest row,
    aligned), a flat head ``nb`` budgets of its fullest block."""
    dtype = resolve_block_dtype(dtype)
    nb = number_of_blocks(matrix, width)
    nb_pad = max(pad_blocks_to or nb, nb)
    n = num_rows(matrix)
    head, diag, col, lo, hi = range(len(STACKS))
    longest = np.zeros(len(STACKS), dtype=np.int64)
    head_block = np.zeros(nb_pad, dtype=np.int64)
    nnz = np.zeros(nb_pad, dtype=np.int64)
    for r0 in range(0, min(n, nb * width), chunk_rows):
        r1 = min(r0 + chunk_rows, n, nb * width)
        part = csr_row_range(matrix, r0, r1, n)
        rows = np.repeat(np.arange(r0, r1, dtype=np.int64),
                         np.diff(part.indptr))
        bi = rows // width
        bj = part.indices.astype(np.int64) // width
        cat = np.full(rows.size, -1, dtype=np.int64)
        body = bi > 0
        cat[bi == 0] = head
        cat[body & (bj == bi)] = diag
        cat[body & (bj == 0)] = col
        if banded:
            cat[(bi >= 2) & (bj == bi - 1)] = lo
            cat[body & (bj == bi + 1)] = hi
        keep = cat >= 0
        in_head = cat == head
        body_kept = keep & ~in_head
        per_row = np.bincount(
            (rows[body_kept] - r0) * len(STACKS) + cat[body_kept],
            minlength=(r1 - r0) * len(STACKS))
        longest = np.maximum(longest,
                             per_row.reshape(r1 - r0, -1).max(axis=0))
        # The head's rows are cut at its blocks' edges.
        if in_head.any():
            _, counts = np.unique(rows[in_head] * nb_pad + bj[in_head],
                                  return_counts=True)
            longest[head] = max(int(longest[head]), int(counts.max()))
        head_block += np.bincount(bj[in_head], minlength=nb_pad)
        # A degree counts every stored entry, a value array (dense,
        # weighted ELL) its values nonzero in the storage dtype, a flat
        # head every entry below its dummy row.
        counted = keep
        if not binary:
            live = torch.from_numpy(part.data.astype(np.float32)).to(
                dtype).ne(0).numpy()
            counted = keep & (live | (in_head & head_flat))
        nnz += np.bincount(bi[counted], minlength=nb_pad)
    stacks = [diag, col] + ([lo, hi] if banded else [])
    if fmt == "dense":
        per_entry = len(stacks) * width * width
        head_slots = nb_pad * width * width
    else:
        per_entry = sum(width * align_up(int(longest[s]), SLOT_ALIGN)
                        for s in stacks)
        fullest = int(head_block.max()) if nb_pad else 0
        head_slots = (nb_pad * align_up(fullest, SLOT_ALIGN) if head_flat
                      else nb_pad * width
                      * align_up(int(longest[head]), SLOT_ALIGN))
    slots = np.full(nb_pad, per_entry, dtype=np.int64)
    if nb_pad:
        slots[0] += head_slots
    return {"rows": np.full(nb_pad, width, dtype=np.int64), "nnz": nnz,
            "slots": slots}

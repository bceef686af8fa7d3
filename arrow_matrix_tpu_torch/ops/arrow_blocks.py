"""Dense arrow blocks of one level and their plain single-device product.

Counterpart of the dense subset of ``arrow_matrix_tpu/ops/arrow_blocks.py``.
An arrow matrix of ``nb`` block-rows of width ``w`` has nonzero blocks
only at (0, j), (i, 0), (i, i) and, in banded mode, (i, i+-1).  Each
kind is one dense ``(nb, w, w)`` stack with a leading block axis:

    head:  block j holds A_0j   (the head row)
    diag:  block i holds A_ii   (zero at i = 0)
    col:   block i holds A_i0   (zero at i = 0)
    lo/hi: banded only, block i holds A_i,i-1 / A_i,i+1 (zero where the
           block does not exist: lo at 0 and 1, hi at 0 and nb-1)

One product ``C = B @ X`` with X blocked like the rows, ``(nb, w, k)``:

    C_0 = sum_j A_0j X_j
    C_i = A_ii X_i + A_i0 X_0 [+ A_i,i-1 X_{i-1} + A_i,i+1 X_{i+1}]

:func:`column_spmm` (the C_i, i >= 1), :func:`head_spmm` (C_0) and
:func:`arrow_spmm` (both) are the plain PyTorch versions of the
hand-written kernels ``csrc/arrow_blocks_spmm.cu`` (wrapper:
``ops/cuda_blocks.py``): float32 sums whatever the block dtype.  The
ELL block format and the flat/gell heads of the JAX package are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from arrow_matrix_tpu_torch.io.graphio import (
    CsrLike,
    load_block,
    num_nonzeros,
    number_of_blocks,
)
from arrow_matrix_tpu_torch.ops.ell import dense_pack_stack
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device

FORMATS_TODO = ("is not ported yet; see ROADMAP.md Queue A, 'remaining "
                "single-device formats'")

#: Block-storage dtypes by name.
BLOCK_DTYPES = {"f32": torch.float32, "float32": torch.float32,
                "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}

STACKS = ("head", "diag", "col", "lo", "hi")


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


@dataclass
class ArrowBlocks:
    """The dense ``(nb, w, w)`` stacks of one arrow level on a device;
    ``lo_data``/``hi_data`` are None unless ``banded``."""

    head_data: torch.Tensor
    diag_data: torch.Tensor
    col_data: torch.Tensor
    lo_data: Optional[torch.Tensor] = None
    hi_data: Optional[torch.Tensor] = None
    width: int = 0
    n_blocks: int = 0
    banded: bool = False
    fmt: str = "dense"

    @property
    def dtype(self) -> torch.dtype:
        return self.diag_data.dtype

    def stacks(self) -> Dict[str, torch.Tensor]:
        """The stacks present, by name (head, diag, col[, lo, hi])."""
        return {name: t for name in STACKS
                if (t := getattr(self, f"{name}_data")) is not None}

    def device_nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.stacks().values())

    def to(self, device: DeviceLike) -> "ArrowBlocks":
        dev = resolve_device(device)
        kw = {f.name: getattr(self, f.name) for f in fields(self)}
        for name, t in self.stacks().items():
            kw[f"{name}_data"] = t.to(dev)
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


def arrow_blocks_from_csr(matrix: CsrLike, width: int,
                          banded: bool = False,
                          pad_blocks_to: Optional[int] = None,
                          dtype=torch.float32,
                          check: bool = True,
                          fmt: str = "dense",
                          head_fmt: str = "auto",
                          device: DeviceLike = None) -> ArrowBlocks:
    """Tile an arrow-shaped CSR (or memmapped triplet) into dense stacks
    on ``device`` (the card unless ``"cpu"`` is asked for).

    Trailing all-zero block rows and columns are truncated;
    ``pad_blocks_to`` appends empty block-rows so every level of a
    decomposition can share one flat row count.  Each stack is packed
    on the host, moved to the device and dropped before the next, so
    the host holds one stack at a time.

    With ``check`` the tiling verifies that the arrow-pattern blocks
    capture every nonzero: a matrix wider than ``width`` (a
    decomposition's grown last level) raises instead of losing entries.
    Needs a canonical (duplicate-free) input, as the loaders give.

    Only ``fmt="dense"`` is ported; ``head_fmt`` "auto" is then the
    dense head, as in the JAX package.
    """
    if fmt != "dense":
        raise NotImplementedError(f"fmt={fmt!r} {FORMATS_TODO}")
    if head_fmt not in ("auto", "dense"):
        raise NotImplementedError(f"head_fmt={head_fmt!r} {FORMATS_TODO}")
    dev = resolve_device(device)
    dtype = resolve_block_dtype(dtype)
    nb = number_of_blocks(matrix, width)
    nb_padded = max(pad_blocks_to or nb, nb)
    captured = 0

    def blk(ij):
        nonlocal captured
        if ij is None:
            return None
        i, j = ij
        # Cut at float32 whatever the storage dtype (scipy cannot hold
        # bf16); dense_pack_stack rounds once when it packs.
        b = load_block(matrix, i * width, (i + 1) * width,
                       j * width, (j + 1) * width, width, dtype=np.float32)
        captured += b.nnz
        return b

    kw = {}
    for name, coords in stack_coords(nb, nb_padded, banded).items():
        kw[f"{name}_data"] = dense_pack_stack(
            [blk(ij) for ij in coords], dtype=dtype, rows=width).to(dev)

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
                       **kw)


# -- the plain product -------------------------------------------------------

def column_spmm(diag: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                lo: Optional[torch.Tensor] = None,
                hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every block row but the head: ``C_b = A_bb X_b + A_b0 X_0
    [+ A_b,b-1 X_{b-1} + A_b,b+1 X_{b+1}]`` for b >= 1, each product
    summed in float32; block 0 (the head row's) comes out zero.

    diag/col (and lo/hi, banded) ``(nb, w, w)``; x ``(nb, w, k)`` ->
    ``(nb, w, k)`` in x's dtype.
    """
    nb, w, k = x.shape
    xf = x.float()
    acc = torch.zeros((nb, w, k), dtype=torch.float32, device=x.device)
    acc[1:] = torch.bmm(diag[1:].float(), xf[1:])
    acc[1:] += torch.matmul(col[1:].float(), xf[0])
    if lo is not None:
        acc[1:] += torch.bmm(lo[1:].float(), xf[:-1])
        acc[1:-1] += torch.bmm(hi[1:-1].float(), xf[2:])
    return acc.to(x.dtype)


def head_spmm(head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The head row ``C_0 = sum_b A_0b X_b``: head ``(nb, w, w)``, x
    ``(nb, w, k)`` -> ``(w, k)`` in x's dtype, summed in float32."""
    return torch.bmm(head.float(), x.float()).sum(dim=0).to(x.dtype)


def arrow_spmm(blocks: ArrowBlocks, x: torch.Tensor) -> torch.Tensor:
    """One level's product, plain: x ``(nb, w, k)`` blocked like the rows
    -> ``(nb, w, k)`` (the dense branch of the JAX ``arrow_spmm``)."""
    nb, w, k = x.shape
    if nb != blocks.n_blocks or w != blocks.width:
        raise ValueError(f"x must be ({blocks.n_blocks}, {blocks.width}, "
                         f"k), got {tuple(x.shape)}")
    c = column_spmm(blocks.diag_data, blocks.col_data, x,
                    blocks.lo_data, blocks.hi_data)
    c[0] = head_spmm(blocks.head_data, x)
    return c


# -- host helpers --------------------------------------------------------------

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
    the JAX package counts them for dense blocks: every stored value is
    a slot; diag/col/lo/hi entry i lies on block row i, the whole head
    on block row 0."""
    nb = blocks.n_blocks
    nnz = np.zeros(nb, dtype=np.int64)
    slots = np.zeros(nb, dtype=np.int64)
    per_block = blocks.width * blocks.width
    for name, t in blocks.stacks().items():
        e_nnz = (t.reshape(t.shape[0], -1) != 0).sum(dim=1).cpu().numpy()
        if name == "head":
            nnz[0] += int(e_nnz.sum())
            slots[0] += per_block * t.shape[0]
        else:
            nnz += e_nnz.astype(np.int64)
            slots += per_block
    rows = np.full(nb, blocks.width, dtype=np.int64)
    return {"rows": rows, "nnz": nnz, "slots": slots}

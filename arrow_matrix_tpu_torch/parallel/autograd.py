"""The backward of an executor's step.

A step ``y = A x`` is linear in ``x``, so its backward saves no tensor:
it is ``Aᵀ g``, one step over the transposed operator.  In the JAX
package the gradient is XLA's autodiff of the jnp step; the port's step
runs hand-written kernels that autograd cannot cross, so
:class:`StepFunction` supplies the backward, and on the card that
backward runs the same kernels (K1-K4) over transposed operators.  CPU
tensors go through the same Function, whose backward then runs the
plain versions.

Per-level formats.  The step is ``sum_i S_i B_i R_i x``: ``R_i`` routes
level-0 rows to level i by ``fwd``, ``S_i = R_iᵀ`` aggregates back by
``bwd`` (``multi_level.py:multi_level_spmm``).  Its transpose is
``sum_i S_i B_iᵀ R_i``: the same routing tables and K4 calls over the
transposed level operators.  An arrow matrix transposed is an arrow
matrix of the same width (head row and column block swap, lo and hi
swap), so ``B_iᵀ`` is packed by the level's own packer in the level's
own format (``MultiLevelArrow.fmts``, not resolved again), width and
tiling.  A flat or "auto" ELL head layout is resolved for the
transposed head by the same rule, so it may differ from the forward's.

The fold.  In carriage coordinates the operator is ``S = Q F Qᵀ`` (F
the folded CSR, Q the degree sort).  ``Sᵀ`` is rebuilt on the host from
the SELL tiers (so an executor made by ``load_folded`` trains too) and
packed into SELL tiers sorted by its own row degrees with its column ids
kept as carriage positions; K1 over that pack is followed by one K4 row
gather that puts its rows back into the carriage order.

Mesh executors.  The algebra is the per-level one on every rank:
``sum_i S_i B_iᵀ R_i`` over the same routing tables and K4 exchanges,
with each rank's level shards transposed.  ``MultiLevelArrow(mesh=)``
packs ``B_iᵀ``'s shard by its own shard packer (same slim or wide
layout, width and tiling).  A ``SellMultiLevel`` level is a tiered
packing in carried coordinates: ``Mᵀ``'s slim packing sorts its rows by
its own degrees, so its carriage is another ordering of the same shard's
rows, reached by a local K4 gather each way
(``sell_slim.SlimTransposed``).  The space-shared executors' step is
not time-shared; their transpose is in ``parallel/space_shared.py``.
:func:`transpose_levels` decides symmetry from each level's global
matrix, which every rank holds, so the ranks agree.

Symmetric operators.  Where a level's matrix (the fold: ``S``) equals
its transpose, values too, the backward runs the forward operator
itself and packs nothing; every level of an undirected graph's
decomposition is symmetric.  The transposed operator is built lazily,
at the first backward (or :meth:`MultiLevelArrow.transposed`), so a
caller that never differentiates pays nothing; its host seconds and
device bytes are recorded on it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from scipy import sparse
from torch.autograd.function import once_differentiable

from arrow_matrix_tpu_torch.ops.ell import SLOT_ALIGN
from arrow_matrix_tpu_torch.ops.sell import (
    SellMatrix,
    nbytes_of,
    sell_from_arrays,
    sell_pack_numpy,
)


@dataclass
class Transposed:
    """``Aᵀ`` of one executor, in the executor's own formats.

    ``blocks`` (per-level formats): level i's ``B_iᵀ``, or ``B_i`` itself
    where it is symmetric.  ``sell`` and ``inv`` (fold): the pack of
    ``Sᵀ`` and the int32 permutation that puts its product back in
    carriage order; both None where ``S`` is symmetric.  ``packed``
    lists the levels packed anew (the fold: ``[0]`` or ``[]``);
    ``seconds`` and ``device_bytes`` are what building them cost.
    """

    blocks: Optional[list] = None
    sell: Optional[SellMatrix] = None
    inv: Optional[torch.Tensor] = None
    packed: List[int] = field(default_factory=list)
    seconds: float = 0.0
    device_bytes: int = 0


def as_csr(matrix) -> sparse.csr_matrix:
    """A level's matrix (scipy CSR or memmapped ``(data, indices,
    indptr)`` triplet, ``data`` None for implicit ones) as a square
    scipy CSR."""
    if isinstance(matrix, sparse.csr_matrix):
        return matrix
    data, indices, indptr = matrix
    indptr = np.asarray(indptr, dtype=np.int64)
    n, nnz = indptr.shape[0] - 1, int(indptr[-1])
    vals = (np.ones(nnz, np.float32) if data is None
            else np.asarray(data[:nnz]))
    return sparse.csr_matrix((vals, np.asarray(indices[:nnz]), indptr),
                             shape=(n, n))


def is_symmetric(m: sparse.csr_matrix) -> bool:
    """``m == mᵀ``, pattern and values."""
    return m.shape[0] == m.shape[1] and (m != m.T).nnz == 0


def sell_to_csr(sell: SellMatrix) -> sparse.csr_matrix:
    """The operator a SELL pack holds, as a host CSR in its own (sorted)
    coordinates: binary rows stop at their degree, weighted padding has
    weight 0 and is dropped."""
    rows, cols, vals = [], [], []
    for t in sell.live_tiers():
        c = sell.cols[t].cpu().numpy()
        m_t, n_t = c.shape
        if sell.binary:
            deg = sell.deg[t].cpu().numpy()
            live = np.arange(m_t)[:, None] < deg[None, :]
            vals.append(np.ones(int(live.sum()), np.float32))
        else:
            d = sell.data[t].cpu().numpy()
            live = d != 0
            vals.append(d[live].astype(np.float32))
        r = sell.row_starts[t] + np.arange(n_t, dtype=np.int64)
        rows.append(np.broadcast_to(r[None, :], (m_t, n_t))[live])
        cols.append(c[live].astype(np.int64))
    n = sell.n_rows
    if not rows:
        return sparse.csr_matrix((n, n), dtype=np.float32)
    return sparse.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows),
                                np.concatenate(cols))), shape=(n, n))


def transpose_fold(sell: SellMatrix, binary: bool) -> tuple:
    """``(sell_t, inv)`` of the fold operator ``sell``: ``Sᵀ`` packed in
    SELL tiers sorted by its own row degrees over carriage columns
    (``conjugate=False``), and the int32 table with ``(Sᵀ g)[c] =
    (sell_t @ g)[inv[c]]``; ``(None, None)`` when ``S`` is symmetric."""
    s = sell_to_csr(sell)
    if is_symmetric(s):
        return None, None
    cols, data, deg, n_rows, starts, order = sell_pack_numpy(
        s.T.tocsr(), pad_rows_to=sell.n_rows, binary=binary,
        slot_align=SLOT_ALIGN, conjugate=False)
    dev = sell.device
    sell_t = sell_from_arrays(cols, data, deg, n_rows, starts, device=dev)
    inv = torch.from_numpy(np.argsort(order).astype(np.int32)).to(dev)
    return sell_t, inv


def transpose_levels(matrices, forward: list, pack, device) -> Transposed:
    """``Transposed`` of a per-level operator (see the module
    docstring): level i's forward operator ``forward[i]`` where its
    global matrix ``matrices[i]`` is symmetric, values too, else
    ``pack(i, Mᵀ)``, an operator with ``device_nbytes()``.  The decision
    reads the global level matrix, so every rank of a mesh makes the
    same one."""
    tic = time.perf_counter()
    out = Transposed(blocks=[])
    for i, (matrix, op) in enumerate(zip(matrices, forward)):
        m = as_csr(matrix)
        if is_symmetric(m):
            out.blocks.append(op)
            continue
        blk = pack(i, m.T.tocsr())
        out.blocks.append(blk)
        out.packed.append(i)
        out.device_bytes += blk.device_nbytes()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    out.seconds = time.perf_counter() - tic
    return out


def build_transposed(exe) -> Transposed:
    """Build ``Aᵀ`` of the executor ``exe`` (see the module docstring),
    timing the host work and the uploads.  A per-level executor names
    its level matrices and its packer of a transposed level
    (``level_matrices()``, ``pack_transposed(i, Mᵀ)``)."""
    if not exe.folded:
        return transpose_levels(exe.level_matrices(), exe.blocks,
                                exe.pack_transposed, exe.device)
    tic = time.perf_counter()
    out = Transposed()
    out.sell, out.inv = transpose_fold(exe.sell, exe.binary)
    if out.sell is not None:
        out.packed = [0]
        out.device_bytes = nbytes_of(out.sell, out.inv)
    if exe.device.type == "cuda":
        torch.cuda.synchronize(exe.device)
    out.seconds = time.perf_counter() - tic
    return out


class StepFunction(torch.autograd.Function):
    """``y = exe.raw_step(x, *operands)`` with the backward ``g ->
    exe.transposed_step(g)``, in f32.  Nothing is saved for the
    backward: the step is linear.  The raw step may update its partial
    products in place (the routing's fused gather-add); autograd sees
    only ``x`` and ``y``."""

    @staticmethod
    def forward(ctx, x, exe, operands):
        ctx.exe = exe
        ctx.dtype = x.dtype
        return exe.raw_step(x, *operands)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        # In f32 whatever the carriage (a bf16 step writes bf16); the
        # gradient of a bf16 input is rounded to bf16 once.
        return ctx.exe.transposed_step(
            g.float().contiguous()).to(ctx.dtype), None, None

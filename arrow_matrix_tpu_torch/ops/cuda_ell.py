"""ELL and HYB levels on the card, through K1.

The JAX package computes its ELL, flat-COO and HYB products in XLA
(``ops/ell.py:ell_spmm``, ``csr_flat_spmm``; ``ops/hyb.py:hyb_spmm_t``),
as gathers into a ``(rows, chunk, k)`` intermediate.  Each of them is
the function the hand-written kernel K1 computes, ``out[r] = sum_j
w[j, r] * x[cols[j, r]]`` (``csrc/sell_tier_spmm.cu``, wrapper
``ops/cuda_sell.py``), so on the card each runs as K1 over an operator
in K1's form, with no intermediate:

* an ELL stack of ``nb`` blocks is one slot-major ``(m, nb*w)`` tier
  over global columns (``ops/ell.py:ell_stack_tier``), block i's
  columns shifted by :func:`stack_offsets`; its product is the stack's
  per-block products laid end to end, ``(nb*w, k)``;
* the per-block ELL head is such a tier too, summed over its blocks;
* the gell head is one tier of ``w`` rows;
* the flat head is regrouped by row into the ``(w, nb*w)`` CSR it came
  from and packed into degree-sorted SELL tiers (``ops/sell.py``; the
  head rows are the pruned hubs, so their degrees are skewed), whose
  result is put back in row order by one row gather (K4,
  ``ops/cuda_gather.py``);
* the two partitions of a HYB level are one tier each; the heavy rows
  are added at their unique, sorted rows (one add per element, so the
  result does not depend on the order of the adds).

Binary stacks are not glued into one tier: K1's binary rows stop at
``deg[r]``, and padding inside a row's slot prefix would be read.  So a
level makes one K1 product per stack, each one launch, or two where a
row is split across CTAs.  The operators and their work lists are built
once, at first use, and cached on the level (``ArrowBlocks.k1``,
``HybLevel.k1``).

For CPU tensors the ``*_cuda`` entry points run the plain versions
(``ops/arrow_blocks.py:arrow_spmm``, ``ops/hyb.py:hyb_spmm``);
:func:`arrow_spmm_k1` and :func:`hyb_spmm_k1` run the K1 form on any
device (on the CPU through K1's plain version), which the CPU tests use
to hold the form against the reference.  There is no fallback on the
card: a failed build or launch raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.ops.arrow_blocks import (
    STACKS,
    ArrowBlocks,
    arrow_spmm,
)
from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
from arrow_matrix_tpu_torch.ops.ell import ell_stack_tier
from arrow_matrix_tpu_torch.ops.hyb import HybLevel, hyb_spmm
from arrow_matrix_tpu_torch.ops.sell import (
    SellMatrix,
    sell_from_arrays,
    sell_pack_numpy,
)


def stack_offsets(name: str, nb: int, w: int) -> torch.Tensor:
    """First global row of the X block each block of stack ``name``
    multiplies: head and diag ``i*w``, col 0, lo ``(i-1)*w``, hi
    ``(i+1)*w``, clamped into ``[0, (nb-1) w]`` (a clamped block is an
    empty one: lo at 0, hi at nb-1)."""
    i = torch.arange(nb, dtype=torch.int64)
    shift = {"head": 0, "diag": 0, "lo": -1, "hi": 1}
    if name == "col":
        return torch.zeros(nb, dtype=torch.int64)
    return (i + shift[name]).clamp(0, nb - 1) * w


def one_tier(cols: torch.Tensor, data: Optional[torch.Tensor],
             deg: Optional[torch.Tensor], x_rows: int) -> SellMatrix:
    """A slot-major ``(m, rows)`` tier as a one-tier K1 operator over
    features of ``x_rows`` rows (weights as K1 takes them: float32 data
    or int32 degrees)."""
    return SellMatrix(cols=(cols,),
                      data=None if data is None else (data.float(),),
                      deg=None if deg is None else (deg,),
                      n_rows=int(cols.shape[1]), row_starts=(0,),
                      x_rows=x_rows)


def flat_head_operator(blocks: ArrowBlocks):
    """The flat head as K1 operator: ``(sell, inv)``, where ``sell`` is
    the ``(w, nb*w)`` head CSR in degree-sorted SELL tiers over global
    columns and ``inv`` the int32 permutation that puts its result back
    in row order."""
    nb, w = blocks.n_blocks, blocks.width
    dev = blocks.head_cols.device
    rows = blocks.head_rows.cpu().numpy().astype(np.int64)
    cols = (blocks.head_cols.cpu().numpy().astype(np.int64)
            + (np.arange(nb, dtype=np.int64) * w)[:, None])
    live = rows < w
    binary = blocks.head_data is None
    vals = (np.ones(int(live.sum()), np.float32) if binary
            else blocks.head_data.float().cpu().numpy()[live])
    csr = sparse.csr_matrix((vals, (rows[live], cols[live])),
                            shape=(w, nb * w))
    c, d, g, n_rows, starts, order = sell_pack_numpy(
        (None if binary else csr.data, csr.indices, csr.indptr),
        pad_rows_to=w, binary=binary, conjugate=False)
    sell = sell_from_arrays(c, d, g, n_rows, starts, device=dev)
    sell.x_rows = nb * w
    inv = torch.from_numpy(np.argsort(order).astype(np.int32)).to(dev)
    return sell, inv


def k1_operands(blocks: ArrowBlocks) -> dict:
    """The ELL level's stacks and head as K1 operators, built at first
    use and cached on ``blocks.k1``: one per stack present (diag, col,
    lo, hi), "head", and for a flat head "head_inv" (see
    :func:`flat_head_operator`)."""
    if blocks.fmt != "ell":
        raise ValueError(f"K1 takes ELL levels, not fmt={blocks.fmt!r}")
    if blocks.k1:
        return blocks.k1
    nb, w = blocks.n_blocks, blocks.width
    total = nb * w
    ops = {}
    for name in STACKS:
        cols = getattr(blocks, f"{name}_cols")
        if cols is None or (name == "head" and (blocks.head_flat
                                                or blocks.head_gell)):
            continue
        tier = ell_stack_tier(cols, stack_offsets(name, nb, w),
                              data=getattr(blocks, f"{name}_data"),
                              deg=getattr(blocks, f"{name}_deg"))
        ops[name] = one_tier(*tier, x_rows=total)
    if blocks.head_gell:
        data = blocks.head_data
        ops["head"] = one_tier(
            blocks.head_cols.T.contiguous(),
            None if data is None else data.T.contiguous(),
            blocks.head_deg, x_rows=total)
    elif blocks.head_flat:
        ops["head"], ops["head_inv"] = flat_head_operator(blocks)
    blocks.k1.update(ops)
    return blocks.k1


def arrow_spmm_k1(blocks: ArrowBlocks, x: torch.Tensor) -> torch.Tensor:
    """One ELL level's product through its K1 operators: x ``(nb, w,
    k)`` -> ``(nb, w, k)``, ``c = diag; c += col; c += lo; c += hi``,
    then block 0 set to the head row, in the JAX ``arrow_spmm``'s
    order."""
    nb, w, k = x.shape
    if nb != blocks.n_blocks or w != blocks.width:
        raise ValueError(f"x must be ({blocks.n_blocks}, {blocks.width}, "
                         f"k), got {tuple(x.shape)}")
    ops = k1_operands(blocks)
    flat = x.reshape(nb * w, k)
    c = sell_spmm_cuda(ops["diag"], flat)
    for name in STACKS[2:]:
        if name in ops:
            c += sell_spmm_cuda(ops[name], flat)
    head = sell_spmm_cuda(ops["head"], flat)
    if blocks.head_flat:
        head = row_gather(head, ops["head_inv"])
    elif not blocks.head_gell:
        head = head.view(nb, w, k).sum(dim=0)
    c[:w] = head
    return c.view(nb, w, k)


def arrow_spmm_ell_cuda(blocks: ArrowBlocks, x: torch.Tensor,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """One ELL level's product: through K1 (:func:`arrow_spmm_k1`) for a
    CUDA ``x``; for a CPU ``x`` the plain ``arrow_spmm`` (``chunk``
    bounds its gathers)."""
    if x.device.type == "cpu":
        return arrow_spmm(blocks, x, chunk=chunk)
    return arrow_spmm_k1(blocks, x)


def hyb_operands(level: HybLevel) -> dict:
    """The HYB level's partitions as K1 operators, cached on
    ``level.k1``: "light", and "heavy" with "heavy_idx" (int64) when the
    level has heavy rows."""
    if not level.k1:
        ops = {"light": one_tier(level.light_cols, level.light_data,
                                 level.light_deg, x_rows=level.n_rows)}
        if level.heavy_idx.shape[0]:
            ops["heavy"] = one_tier(level.heavy_cols, level.heavy_data,
                                    level.heavy_deg, x_rows=level.n_rows)
            ops["heavy_idx"] = level.heavy_idx.long()
        level.k1.update(ops)
    return level.k1


def hyb_spmm_k1(level: HybLevel, x: torch.Tensor) -> torch.Tensor:
    """``level @ x`` through its K1 operators: x ``(n_rows, k)`` ->
    ``(n_rows, k)``; the heavy rows added at their unique rows."""
    ops = hyb_operands(level)
    out = sell_spmm_cuda(ops["light"], x)
    if "heavy" in ops:
        out.index_add_(0, ops["heavy_idx"], sell_spmm_cuda(ops["heavy"], x))
    return out


def hyb_spmm_cuda(level: HybLevel, x: torch.Tensor,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """``level @ x``: through K1 (:func:`hyb_spmm_k1`) for a CUDA ``x``;
    for a CPU ``x`` the plain ``hyb_spmm`` (``chunk`` bounds its
    gathers)."""
    if x.device.type == "cpu":
        return hyb_spmm(level, x, chunk=chunk, heavy_chunk=chunk)
    return hyb_spmm_k1(level, x)

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

The dense block format lives here too: :func:`dense_pack_stack` packs
sparse blocks into one ``(b, w, w)`` stack and
:func:`dense_spmm_batched` is its plain batched product.
"""

from __future__ import annotations

from typing import List, Optional

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


def out_dtype_for(x_dtype: torch.dtype) -> torch.dtype:
    """Result dtype of a tier product: the carriage dtype, except that
    an int8 table (a pre-quantized ``q``) returns its f32 sums."""
    return torch.float32 if x_dtype == torch.int8 else x_dtype


def ell_tier_sums(cols: torch.Tensor, x: torch.Tensor,
                  data: Optional[torch.Tensor] = None,
                  deg: Optional[torch.Tensor] = None,
                  first_slot: int = 0) -> torch.Tensor:
    """The float32 sums of :func:`ell_tier_spmm`, before the result is
    rounded to its dtype.  ``cols`` (and ``data``) may be a run of slots
    of a tier starting at slot ``first_slot``: a binary row then takes
    its slots below ``deg[r]`` counted from the tier's first slot."""
    m, rows = cols.shape
    k = x.shape[1]
    if data is None and deg is None and m > 0:
        raise ValueError("binary ELL (data=None) requires deg")
    acc = torch.zeros((rows, k), dtype=torch.float32, device=x.device)
    chunk = max(1, GATHER_ELEMENTS // max(rows * k, 1))
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        c = cols[lo:hi]
        g = x.index_select(0, c.reshape(-1).long()).reshape(
            hi - lo, rows, k).float()
        if data is not None:
            w = data[lo:hi].float()
        else:
            slot = torch.arange(first_slot + lo, first_slot + hi,
                                device=x.device)[:, None]
            w = (slot < deg[None, :]).float()
        acc += (g * w[:, :, None]).sum(dim=0)
    return acc


def ell_tier_spmm(cols: torch.Tensor, x: torch.Tensor,
                  data: Optional[torch.Tensor] = None,
                  deg: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain ``out[r] = sum_j w[j, r] * x[cols[j, r]]`` for one tier.

    :param cols: (m, rows) int32 column indices, slot-major.
    :param x:    (n, k) features, f32 / bf16 / int8, row-major.
    :param data: (m, rows) f32 weights (0 in padding), or None.
    :param deg:  (rows,) int32 valid-slot counts (binary mode).
    :param out:  optional (rows, k) destination of the result dtype.
    :returns: (rows, k) in :func:`out_dtype_for` ``(x.dtype)``.
    """
    res = ell_tier_sums(cols, x, data=data, deg=deg).to(
        out_dtype_for(x.dtype))
    if out is None:
        return res
    out.copy_(res)
    return out


def dense_pack_stack(mats: List[Optional[sparse.spmatrix]],
                     dtype: torch.dtype = torch.float32,
                     rows: Optional[int] = None) -> torch.Tensor:
    """Pack sparse blocks (None = structurally empty) into one dense
    ``(b, rows, rows)`` CPU tensor of ``dtype``.

    Densifies at float32 in numpy, then rounds once to ``dtype``
    (round to nearest even for bfloat16), as the JAX package's packer
    does, so the stacks agree bit for bit.
    """
    shapes = [m.shape for m in mats if m is not None]
    if not shapes and rows is None:
        raise ValueError("no non-empty blocks and no explicit row count")
    rows = rows if rows is not None else shapes[0][0]
    out = np.zeros((len(mats), rows, rows), dtype=np.float32)
    for i, m in enumerate(mats):
        if m is None or m.nnz == 0:
            continue
        if m.dtype == np.float32:
            m.toarray(out=out[i])     # no temporary block
        else:
            out[i] = m.toarray()
    return torch.from_numpy(out).to(dtype)


def dense_spmm_batched(data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain batched dense block product ``(b, w, w) @ (b, w, k) ->
    (b, w, k)``: float32 sums whatever the block dtype, the result in
    ``x``'s dtype."""
    return torch.bmm(data.float(), x.float()).to(x.dtype)

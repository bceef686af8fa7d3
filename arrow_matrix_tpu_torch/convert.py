"""Carry state across from the JAX package.

The "weights" of this system are its packed operators (the fold
operator: per-tier SELL arrays plus the carried permutation; the dense
arrow blocks of each level) and the parameters of its models.  Four
ways in:

  * :func:`sell_from_numpy` turns the arrays of a JAX ``SellMatrix``
    (as numpy, via ``np.asarray``) into the port's ``SellMatrix``;
  * :func:`from_jax_export` loads a directory written by the JAX
    package's ``MultiLevelArrow.export_folded`` — the same format the
    port writes, so this is ``MultiLevelArrow.load_folded``;
  * :func:`arrow_blocks_from_numpy` turns the dense stacks of a JAX
    ``ArrowBlocks`` into the port's ``ArrowBlocks``;
  * :func:`load_jax_params` copies a JAX model's parameters (``SGCParams``
    ``w``/``b`` as numpy) into a port model (``models/propagation.py``);
  * :func:`shard_stack_from_numpy` builds the port's ``SellShardStack``
    (one level's body or head tiers of every device, or one device's
    slice of them) from a JAX ``SellShardStack``'s per-device arrays,
    and :func:`route_tables_from_numpy` the port's ``RouteTables`` from
    a JAX ``RouteTables``'s: with them a test drives the port's mesh
    step over exactly JAX's packing.

Nothing here imports JAX: the caller hands over numpy arrays or a path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from arrow_matrix_tpu_torch.ops.arrow_blocks import ArrowBlocks
from arrow_matrix_tpu_torch.ops.sell import SellMatrix, sell_from_arrays
from arrow_matrix_tpu_torch.parallel.multi_level import MultiLevelArrow
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device


def sell_from_numpy(cols: Sequence[np.ndarray],
                    deg: Optional[Sequence[np.ndarray]] = None,
                    data: Optional[Sequence[np.ndarray]] = None,
                    row_starts: Sequence[int] = (), n_rows: int = 0,
                    device: DeviceLike = None) -> SellMatrix:
    """A port ``SellMatrix`` on ``device`` from a JAX ``SellMatrix``'s
    per-tier arrays: ``cols`` (m_t, n_t) int32, and ``deg`` (n_t,)
    int32 for a binary operator or ``data`` (m_t, n_t) f32 for a
    weighted one."""
    if (deg is None) == (data is None):
        raise ValueError("pass exactly one of deg (binary) or data "
                         "(weighted)")
    as_np = (lambda arrays: None if arrays is None
             else [np.asarray(a) for a in arrays])
    return sell_from_arrays(as_np(cols), as_np(data), as_np(deg),
                            n_rows=n_rows, row_starts=row_starts,
                            device=device)


def from_jax_export(in_dir: str, feature_dtype="keep",
                    device: DeviceLike = None) -> MultiLevelArrow:
    """A fold executor from a JAX ``export_folded`` directory."""
    return MultiLevelArrow.load_folded(in_dir, feature_dtype=feature_dtype,
                                       device=device)


def _stack(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One dense stack: float32 as it is; bfloat16 given either as its
    uint16 bit pattern or as an array whose dtype is named bfloat16
    (``ml_dtypes``, which the port does not import)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    if a.dtype not in (np.uint16, np.float32):
        raise ValueError(f"dense stacks are float32 or bfloat16, got "
                         f"{a.dtype}")
    # A copy: the caller's array may be read-only (a JAX array's is).
    t = torch.from_numpy(np.array(a, order="C"))
    if a.dtype == np.uint16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def arrow_blocks_from_numpy(head: np.ndarray, diag: np.ndarray,
                            col: np.ndarray, lo: Optional[np.ndarray] = None,
                            hi: Optional[np.ndarray] = None, *, width: int,
                            banded: bool,
                            device: DeviceLike = None) -> ArrowBlocks:
    """A port ``ArrowBlocks`` on ``device`` from a JAX dense
    ``ArrowBlocks``'s stacks (``np.asarray`` of ``head_data``,
    ``diag_data``, ``col_data`` and, banded, ``lo_data``/``hi_data``),
    each ``(nb, w, w)`` float32 or bfloat16 (see :func:`_stack`)."""
    if banded != (lo is not None) or (lo is None) != (hi is None):
        raise ValueError("banded blocks need lo and hi; block-diagonal "
                         "blocks take neither")
    dev = resolve_device(device)
    stacks = [None if a is None else _stack(a, dev)
              for a in (head, diag, col, lo, hi)]
    shape = tuple(stacks[0].shape)
    if len(shape) != 3 or shape[1:] != (width, width) or any(
            t is not None and (tuple(t.shape) != shape
                               or t.dtype != stacks[0].dtype)
            for t in stacks):
        raise ValueError(f"stacks must all be (nb, {width}, {width}) of "
                         f"one dtype")
    head_t, diag_t, col_t, lo_t, hi_t = stacks
    return ArrowBlocks(head_data=head_t, diag_data=diag_t, col_data=col_t,
                       lo_data=lo_t, hi_data=hi_t, width=width,
                       n_blocks=shape[0], banded=banded)


def load_jax_params(model, params) -> None:
    """Copy JAX parameters into the port model ``model`` in place (any
    module whose ``params`` is an ``SGCParams`` or a list of them).
    ``params`` is one ``(w, b)`` pair of numpy arrays (``np.asarray`` of a
    JAX ``SGCParams``' fields: ``w`` ``(k_in, k_out)``, ``b`` ``(k_out,)``)
    for SGC and APPNP models, a list of pairs, one a layer, for GCN
    models."""
    heads = model.params
    if isinstance(heads, nn.ModuleList):
        if not isinstance(params, list) or len(params) != len(heads):
            raise ValueError(f"a GCN model takes a list of {len(heads)} "
                             f"(w, b) pairs, one a layer")
        pairs = list(params)
    else:
        heads, pairs = [heads], [params]
    with torch.no_grad():
        for head, (w, b) in zip(heads, pairs):
            for dst, src in ((head.w, w), (head.b, b)):
                src = np.asarray(src, dtype=np.float32)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"parameter of shape {src.shape}, "
                                     f"the model's is {tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(np.array(src)))


def shard_stack_from_numpy(cols: Sequence[np.ndarray],
                           deg: Sequence[np.ndarray],
                           data: Optional[Sequence[np.ndarray]] = None,
                           device_index: Optional[int] = None):
    """A port ``SellShardStack`` from a JAX ``SellShardStack``'s arrays
    (``np.asarray`` of each ``cols[t]``, ``deg[t]`` and, weighted,
    ``data[t]``: ``(n_dev, m_t, n_t)`` / ``(n_dev, n_t)``).  Each array
    may also be one device's shard (leading axis 1, as a multi-process
    JAX run addresses it): pass its ``device_index`` and the stack holds
    that device's tiers at that index, the devices before it zero."""
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellShardStack

    def put(arrays):
        out = []
        for a in arrays:
            a = np.asarray(a)
            if device_index is not None:
                full = np.zeros((device_index + 1,) + a.shape[1:], a.dtype)
                full[device_index] = a[0]
                a = full
            out.append(np.ascontiguousarray(a))
        return tuple(out)

    return SellShardStack(cols=put(cols), deg=put(deg),
                          data=None if data is None else put(data))


def route_tables_from_numpy(local_src: np.ndarray, local_dst: np.ndarray,
                            send_idx: np.ndarray, recv_dst: np.ndarray,
                            rows_src: int, rows_dst: int, n_dev: int):
    """A port ``RouteTables`` from a JAX ``RouteTables``'s arrays and
    static fields (int32 tables, the same layout)."""
    from arrow_matrix_tpu_torch.parallel.routing import RouteTables

    def i32(a):
        return np.ascontiguousarray(np.asarray(a), dtype=np.int32)

    return RouteTables(local_src=i32(local_src), local_dst=i32(local_dst),
                       send_idx=i32(send_idx), recv_dst=i32(recv_dst),
                       rows_src=int(rows_src), rows_dst=int(rows_dst),
                       n_dev=int(n_dev))

"""K1, the SELL kernel: wrapper of ``csrc/sell_tier_spmm.cu``.

Counterpart of ``arrow_matrix_tpu/ops/pallas_sell.py``: a fused
gather -> multiply -> accumulate over the tiers of a SELL operator, f32
sums whatever the carriage (f32, bf16, or a pre-quantized int8 table
whose per-feature scale the caller applies outside the kernel).

One product is one launch over every tier, plus one for the split rows
when the operator has any (``ops/worklist.py``).  The work list and its
tables on the device are built once per (operator, k, carriage) and
kept on the :class:`~arrow_matrix_tpu_torch.ops.sell.SellMatrix`; the
operator's tensors are checked then, not per product.

For CUDA tensors the wrapper checks x and out, launches on PyTorch's
current stream, raises on a launch error, and adds each launch to
:data:`LAUNCHES`.  For CPU tensors it runs the plain version
(``ops/sell.py:sell_spmm``, ``ops/ell.py:ell_tier_spmm``).  There is no
fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from arrow_matrix_tpu_torch.ops import _build
from arrow_matrix_tpu_torch.ops.ell import ell_tier_spmm, out_dtype_for
from arrow_matrix_tpu_torch.ops.sell import SellMatrix, sell_spmm
from arrow_matrix_tpu_torch.ops.worklist import (
    TIER_FIELDS,
    WorkList,
    build_worklist,
)

#: Kernel launches made by this process: one per product, two when the
#: operator has split rows.
LAUNCHES = 0

#: Carriage code of the C interface, by feature dtype.
CARRIAGES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: ctypes argument types of ``sell_spmm``: carriage, binary, vecload;
#: tiers, items, rows, x, out, part; n_items, n_rows, k, group; stream.
ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])

_INT32_MAX = 2**31 - 1
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("sell_tier_spmm").sell_spmm
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: tuple, device: torch.device) -> None:
    """Raise ValueError unless ``t`` is on ``device``, of ``dtype`` and
    ``shape``, and contiguous (what a kernel's raw pointer needs)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@dataclass
class DevicePlan:
    """A work list with its tables on the card."""

    wl: WorkList
    tiers: torch.Tensor    # (T, 8) int64: TIER_FIELDS, pointers included
    items: torch.Tensor    # (I, 4) int32
    rows: torch.Tensor     # (R, 3) int32
    covers_all: bool       # the tiers write every row of the output


def _check_tiers(m: SellMatrix, dev: torch.device) -> None:
    if (m.data is None) == (m.deg is None):
        raise ValueError("pass exactly one of data (weighted) or deg "
                         "(binary)")
    if len(m.row_starts) != len(m.cols):
        raise ValueError("one row start per tier")
    for t, cols in enumerate(m.cols):
        if cols.dim() != 2:
            raise ValueError(f"cols[{t}] must be 2-D")
        m_t, n_t = cols.shape
        if max(m_t, n_t, m.row_starts[t] + n_t) > _INT32_MAX:
            raise ValueError("tier dimensions must fit in int32")
        if m.row_starts[t] + n_t > m.n_rows:
            raise ValueError(f"tier {t} ends past the operator's "
                             f"{m.n_rows} rows")
        check_operand(f"cols[{t}]", cols, torch.int32, (m_t, n_t), dev)
        if m.data is not None:
            check_operand(f"data[{t}]", m.data[t], torch.float32,
                          (m_t, n_t), dev)
        else:
            check_operand(f"deg[{t}]", m.deg[t], torch.int32, (n_t,), dev)


def build_plan(m: SellMatrix, k: int, dtype: torch.dtype,
               vecload: bool) -> DevicePlan:
    """Check the operator's tensors and put the work list of ``m`` at
    ``k`` features of ``dtype`` on its device."""
    dev = m.device
    _check_tiers(m, dev)
    wl = build_worklist([tuple(c.shape) for c in m.cols], m.row_starts, k,
                        dtype.itemsize, vecload=vecload)
    weights = m.deg if m.data is None else m.data
    table = torch.zeros((len(m.cols), len(TIER_FIELDS)), dtype=torch.int64)
    for t, cols in enumerate(m.cols):
        table[t, 0] = cols.data_ptr() if cols.numel() else 0
        table[t, 1] = weights[t].data_ptr() if weights[t].numel() else 0
    table[:, 2:7] = torch.from_numpy(wl.tiers)
    return DevicePlan(wl=wl, tiers=table.to(dev),
                      items=torch.from_numpy(wl.items).to(dev),
                      rows=torch.from_numpy(wl.rows).to(dev),
                      covers_all=sum(int(c.shape[1]) for c in m.cols)
                      == m.n_rows)


def plan_for(m: SellMatrix, k: int, dtype: torch.dtype,
             vecload: bool) -> DevicePlan:
    """The cached plan of ``m`` at (k, dtype, vecload), built at first
    use."""
    key = (k, dtype, vecload)
    plan = m.plans.get(key)
    if plan is None:
        plan = m.plans[key] = build_plan(m, k, dtype, vecload)
    return plan


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        lib = _build.load("sell_tier_spmm")
        lib.sell_error_string.restype = ctypes.c_char_p
        lib.sell_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"sell_spmm launch failed: "
            f"{lib.sell_error_string(code).decode()} (code {code}; {what})")


def _check_x(x: torch.Tensor, n_rows: Optional[int]) -> int:
    """Check a CUDA carriage ``x`` (of ``n_rows`` rows unless None);
    returns k."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in CARRIAGES:
        raise ValueError(f"unsupported carriage {x.dtype}; the kernel "
                         f"serves {tuple(CARRIAGES)}")
    if x.dim() != 2 or n_rows not in (None, x.shape[0]):
        raise ValueError(f"x must be ({n_rows or 'n'}, k), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if max(x.shape) > _INT32_MAX:
        raise ValueError("x's dimensions must fit in int32")
    return x.shape[1]


def _vecload(x: torch.Tensor) -> bool:
    return (x.shape[1] * x.element_size()) % 16 == 0 \
        and x.data_ptr() % 16 == 0


def launch(plan: DevicePlan, binary: bool, x: torch.Tensor,
           out: torch.Tensor, vecload: bool) -> torch.Tensor:
    """Run ``plan`` over ``x`` into ``out`` (checked by the caller)."""
    global LAUNCHES
    wl = plan.wl
    k = x.shape[1]
    # Freed on return while the kernels may still run: the caching
    # allocator hands it out again only to work queued after them on
    # this stream.
    part = (torch.empty((wl.n_parts, k), dtype=torch.float32,
                        device=x.device) if wl.n_parts else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _kernel()(CARRIAGES[x.dtype], int(binary), int(vecload),
                         plan.tiers.data_ptr(),
                         plan.items.data_ptr(), plan.rows.data_ptr(),
                         x.data_ptr(), out.data_ptr(),
                         None if part is None else part.data_ptr(),
                         len(wl.items), len(wl.rows), k, wl.group, stream)
    _raise_on(code, f"{len(wl.tiers)} tiers, {len(wl.items)} items, "
                    f"k={k} {x.dtype}")
    LAUNCHES += wl.launches
    return out


def sell_spmm_cuda(m: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` row-major through K1: ``x`` (x_rows, k) -> (n_rows, k)
    in ``out_dtype_for(x.dtype)``, one launch over every tier (two with
    split rows); ``x_rows`` is ``m.n_rows`` unless the operator is
    rectangular.  CPU tensors take the plain ``ops.sell.sell_spmm``."""
    if x.device.type == "cpu":
        return sell_spmm(m, x)
    k = _check_x(x, m.n_rows if m.x_rows is None else m.x_rows)
    if x.device != m.device:
        raise ValueError(f"x is on {x.device}, the operator on {m.device}")
    if k == 0:
        return torch.empty((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                           device=x.device)
    vecload = _vecload(x)
    plan = plan_for(m, k, x.dtype, vecload)
    # Rows no tier covers (none, as the packer builds operators) are
    # zero, as in the plain version.
    alloc = torch.empty if plan.covers_all else torch.zeros
    out = alloc((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                device=x.device)
    return launch(plan, m.binary, x, out, vecload)


def sell_tier_spmm(cols: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
                   data: Optional[torch.Tensor] = None,
                   deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[r] = sum_j w[j, r] * x[cols[j, r]]`` for one tier, written
    into ``out`` (n_t, k) of dtype ``out_dtype_for(x.dtype)``: K1 over a
    one-tier work list (built anew at every call).

    cols (m_t, n_t) int32 slot-major; x (n, k) f32 / bf16 / int8
    row-major; ``data`` (m_t, n_t) f32 for a weighted tier, or ``deg``
    (n_t,) int32 for a binary one.
    """
    if x.device.type == "cpu":
        return ell_tier_spmm(cols, x, data=data, deg=deg, out=out)
    if (data is None) == (deg is None):
        raise ValueError("pass exactly one of data (weighted) or deg "
                         "(binary)")
    if cols.dim() != 2:
        raise ValueError("cols must be 2-D")
    k = _check_x(x, None)
    n_t = cols.shape[1]
    check_operand("out", out, out_dtype_for(x.dtype), (n_t, k), x.device)
    one = SellMatrix(cols=(cols,),
                     data=None if data is None else (data,),
                     deg=None if deg is None else (deg,),
                     n_rows=n_t, row_starts=(0,))
    if one.device != x.device:
        raise ValueError(f"cols is on {one.device}, x on {x.device}")
    if k == 0 or n_t == 0:
        return out
    vecload = _vecload(x)
    return launch(build_plan(one, k, x.dtype, vecload), deg is not None, x,
                  out, vecload)


def quantize_features(x: torch.Tensor):
    """Symmetric per-feature int8 quantization of row-major ``(n, k)``
    features: ``q = round(x / scale)`` with ``scale = max|x| / 127`` per
    feature column.  Returns ``(q int8 (n, k), scale f32 (1, k))`` —
    the scale is ``(1, k)`` here where the JAX package's feature-major
    twin returns ``(k, 1)``.  SpMM is separable per feature column, so
    ``scale * (A @ q)`` reconstructs ``A @ x`` up to the rounding of q."""
    xf = x.float()
    amax = xf.abs().amax(dim=0, keepdim=True)                   # (1, k)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale

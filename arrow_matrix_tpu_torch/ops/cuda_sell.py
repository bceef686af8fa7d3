"""The SELL tier kernel: wrapper of ``csrc/sell_tier_spmm.cu``.

Counterpart of ``arrow_matrix_tpu/ops/pallas_sell.py``: a fused
gather -> multiply -> accumulate over one SELL tier, f32 sums whatever
the carriage (f32, bf16, or a pre-quantized int8 table whose
per-feature scale the caller applies outside the kernel).

For CUDA tensors the wrapper checks device, dtype, shape and
contiguity, launches the kernel on PyTorch's current stream, raises on
a launch error, and adds one to :data:`LAUNCHES`.  For CPU tensors it
runs the plain version (``ops/ell.py:ell_tier_spmm``).  There is no
fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from arrow_matrix_tpu_torch.ops import _build
from arrow_matrix_tpu_torch.ops.ell import ell_tier_spmm, out_dtype_for
from arrow_matrix_tpu_torch.ops.sell import SellMatrix, sell_spmm

#: Kernel launches made by this process (one per live tier per product).
LAUNCHES = 0

#: Carriage code of the C interface, by feature dtype.
CARRIAGES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_INT32_MAX = 2**31 - 1
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("sell_tier_spmm").sell_tier_spmm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
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


def sell_tier_spmm(cols: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
                   data: Optional[torch.Tensor] = None,
                   deg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[r] = sum_j w[j, r] * x[cols[j, r]]`` for one tier, written
    into ``out`` (n_t, k) of dtype ``out_dtype_for(x.dtype)``.

    cols (m_t, n_t) int32 slot-major; x (n, k) f32 / bf16 / int8
    row-major; ``data`` (m_t, n_t) f32 for a weighted tier, or ``deg``
    (n_t,) int32 for a binary one.  Needs ``m_t, n_t > 0``.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return ell_tier_spmm(cols, x, data=data, deg=deg, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (data is None) == (deg is None):
        raise ValueError("pass exactly one of data (weighted) or deg "
                         "(binary)")
    if x.dtype not in CARRIAGES:
        raise ValueError(f"unsupported carriage {x.dtype}; the kernel "
                         f"serves {tuple(CARRIAGES)}")
    if cols.dim() != 2 or x.dim() != 2:
        raise ValueError("cols and x must be 2-D")
    m_t, n_t = cols.shape
    n, k = x.shape
    if m_t == 0 or n_t == 0 or k == 0:
        raise ValueError(f"empty tier ({m_t} slots, {n_t} rows, k={k}): "
                         f"the caller skips it")
    if max(m_t, n_t, k, n) > _INT32_MAX:
        raise ValueError("tier dimensions must fit in int32")
    dev = x.device
    check_operand("cols", cols, torch.int32, (m_t, n_t), dev)
    check_operand("x", x, x.dtype, (n, k), dev)
    check_operand("out", out, out_dtype_for(x.dtype), (n_t, k), dev)
    if data is not None:
        check_operand("data", data, torch.float32, (m_t, n_t), dev)
        w = data
    else:
        check_operand("deg", deg, torch.int32, (n_t,), dev)
        w = deg
    vecload = int((k * x.element_size()) % 16 == 0
                  and x.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _kernel()(CARRIAGES[x.dtype], int(data is None), vecload,
                         cols.data_ptr(), w.data_ptr(), x.data_ptr(),
                         out.data_ptr(), m_t, n_t, k, stream)
    if code != 0:
        lib = _build.load("sell_tier_spmm")
        lib.sell_error_string.restype = ctypes.c_char_p
        lib.sell_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"sell_tier_spmm launch failed: "
            f"{lib.sell_error_string(code).decode()} (code {code}; "
            f"m_t={m_t} n_t={n_t} k={k} {x.dtype})")
    LAUNCHES += 1
    return out


def sell_spmm_cuda(m: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` row-major through the kernel: ``x`` (n_rows, k) ->
    (n_rows, k) in ``out_dtype_for(x.dtype)``.  One launch per live
    tier, each writing its row range of one preallocated output; the
    zero-slot tiers' rows are zeroed.  CPU tensors take the plain
    ``ops.sell.sell_spmm``."""
    if x.device.type == "cpu":
        return sell_spmm(m, x)
    if x.dim() != 2 or x.shape[0] != m.n_rows:
        raise ValueError(f"x must be ({m.n_rows}, k), got "
                         f"{tuple(x.shape)}")
    k = x.shape[1]
    out = torch.empty((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                      device=x.device)
    for t, cols in enumerate(m.cols):
        m_t, n_t = cols.shape
        lo = m.row_starts[t]
        if n_t == 0:
            continue
        if m_t == 0:
            out[lo:lo + n_t].zero_()
            continue
        sell_tier_spmm(cols, x, out[lo:lo + n_t],
                       data=None if m.data is None else m.data[t],
                       deg=None if m.deg is None else m.deg[t])
    return out


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

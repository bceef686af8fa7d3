"""The granule gather kernel (K4): wrapper of ``csrc/granule_gather.cu``.

Counterpart of ``make_pallas_granule(...).run`` in
``tools/pallas_gather_probe.py``: ``x[idx]`` from granule-packed
features through waves of async copies of whole 512-byte lines.

For CUDA tensors the wrapper checks device, dtype, shape, contiguity,
16-byte alignment and the blocking, launches the kernel on PyTorch's
current stream, raises on a launch error, and adds one to
:data:`LAUNCHES`.  For CPU tensors it runs the plain version
(``ops/gather.py:granule_gather_plain``).  There is no fallback: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from arrow_matrix_tpu_torch.ops import _build
from arrow_matrix_tpu_torch.ops.cuda_sell import check_operand
from arrow_matrix_tpu_torch.ops.gather import C, LANES, granule_gather_plain

#: Kernel launches made by this process (one per call on the card).
LAUNCHES = 0

#: Shared memory a CTA may take on Hopper; the kernel stages one wave.
SMEM_LIMIT = 232_448
LINE_BYTES = LANES * 4

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("granule_gather").granule_gather
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def granule_gather(x_packed: torch.Tensor, idx: torch.Tensor,
                   block: int = 1024, wave: int = 32) -> torch.Tensor:
    """``out.reshape(S, 16)[s] = x[idx[s]]``, returned as ``(S / 8,
    128)`` f32, from granule-packed ``x_packed (n / 8, 128)`` f32 (see
    ``ops.gather.pack_granules``) and ``idx (S,)`` int32.

    ``block`` slots per CTA (a grid step of the TPU kernel), ``wave``
    line copies in flight; needs ``S % block == 0``, ``block % 8 == 0``,
    ``block % wave == 0`` and ``wave`` lines (512 B each) within a CTA's
    shared memory.  The kernel does not check that ``idx`` lies in
    ``[0, n)``: an index outside reads outside ``x``.  The kernel copies
    each row's bits; the plain version (CPU tensors) selects by a mask
    and a sum, which turns ``-0.0`` into ``+0.0``.
    """
    global LAUNCHES
    if x_packed.dim() != 2 or x_packed.shape[1] != LANES:
        raise ValueError(f"x_packed must be (n / {C}, {LANES}), got "
                         f"{tuple(x_packed.shape)}")
    if idx.dim() != 1:
        raise ValueError("idx must be 1-D")
    slots = idx.shape[0]
    if block <= 0 or wave <= 0 or block % C or block % wave:
        raise ValueError(f"block = {block} must be a positive multiple of "
                         f"{C} and of wave = {wave}")
    if slots == 0 or slots % block:
        raise ValueError(f"S = {slots} slots must be a positive multiple "
                         f"of block = {block}")
    if wave * LINE_BYTES > SMEM_LIMIT:
        raise ValueError(f"wave = {wave} lines of {LINE_BYTES} B exceed a "
                         f"CTA's {SMEM_LIMIT} B of shared memory")
    dev = x_packed.device
    check_operand("x_packed", x_packed, torch.float32,
                  tuple(x_packed.shape), dev)
    check_operand("idx", idx, torch.int32, (slots,), dev)
    if dev.type == "cpu":
        return granule_gather_plain(x_packed, idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((slots // C, LANES), dtype=torch.float32, device=dev)
    if x_packed.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("x_packed and out must be 16-byte aligned "
                         "(cp.async copies 16 bytes at a time)")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _kernel()(x_packed.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), slots, block, wave, stream)
    if code != 0:
        lib = _build.load("granule_gather")
        lib.granule_error_string.restype = ctypes.c_char_p
        lib.granule_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"granule_gather launch failed: "
            f"{lib.granule_error_string(code).decode()} (code {code}; "
            f"S={slots} block={block} wave={wave})")
    LAUNCHES += 1
    return out

"""K4, the row gather: wrapper of ``csrc/granule_gather.cu``.

Counterpart of ``make_pallas_granule(...).run`` in
``tools/pallas_gather_probe.py``, which gathers ``x[idx]`` through
512-byte granule lines.  On the card K4 gathers rows, and has a fused
form that adds them to a base in place:

* :func:`row_gather` -- ``out[s] = x[idx[s]]``: the executors' forward
  routing and the flat ELL head's unsort; ``x`` may come in two parts
  (``x2``: the rows ``[x; x2]`` read where they lie, as a mesh exchange
  gathers from its own rows and the slots it received);
* :func:`row_gather_add_` -- ``base[s] += x[idx[s]]``: the executors'
  backward aggregation;
* :func:`granule_gather` -- the probe's entry, the row gather on the
  ``(n, 16)`` view of granule-packed lines.

For CUDA tensors the wrappers check device, dtype, shape, contiguity
and aliasing, launch on PyTorch's current stream, raise on a launch
error, and add one to :data:`LAUNCHES` (gathers) or
:data:`LAUNCHES_ADD` (gather-adds).  The kernel picks its 16-byte
vector body where ``k % 4 == 0`` and the pointers are 16-byte aligned,
else its scalar body.  For CPU tensors the wrappers run the plain
versions (``ops/gather.py``).  There is no fallback: a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from arrow_matrix_tpu_torch.ops import _build
from arrow_matrix_tpu_torch.ops.cuda_sell import check_operand
from arrow_matrix_tpu_torch.ops.gather import (
    C,
    K,
    LANES,
    row_gather_add_plain,
    row_gather_plain,
)
from arrow_matrix_tpu_torch.ops.kernel_span import kernel_call

#: Row gather launches made by this process (one per call on the card).
LAUNCHES = 0
#: Gather-add launches made by this process (one per call on the card).
LAUNCHES_ADD = 0

#: ctypes argument types of ``row_gather``: x1, x2, split, idx, out,
#: slots, k, add, stream.
ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("granule_gather").row_gather
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(x: torch.Tensor, idx: torch.Tensor, x2=None) -> None:
    """Raise ValueError unless ``x`` (and ``x2``) are contiguous ``(n,
    k)`` f32 and ``idx`` contiguous ``(S,)`` int32 on ``x``'s device."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, k), got {tuple(x.shape)}")
    if idx.dim() != 1:
        raise ValueError("idx must be 1-D")
    check_operand("x", x, torch.float32, tuple(x.shape), x.device)
    if x2 is not None:
        if x2.dim() != 2:
            raise ValueError(f"x2 must be (n2, k), got {tuple(x2.shape)}")
        check_operand("x2", x2, torch.float32, (x2.shape[0], x.shape[1]),
                      x.device)
    check_operand("idx", idx, torch.int32, (idx.shape[0],), x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    lo, hi = a.data_ptr(), a.data_ptr() + a.numel() * a.element_size()
    b_lo = b.data_ptr()
    return b_lo < hi and lo < b_lo + b.numel() * b.element_size()


def _launch(x: torch.Tensor, x2, idx: torch.Tensor, out: torch.Tensor,
            add: bool) -> None:
    slots, k = out.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _kernel()(x.data_ptr(),
                         (x if x2 is None else x2).data_ptr(), x.shape[0],
                         idx.data_ptr(), out.data_ptr(), slots, k, int(add),
                         stream)
    if code != 0:
        lib = _build.load("granule_gather")
        lib.row_gather_error_string.restype = ctypes.c_char_p
        lib.row_gather_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"row_gather launch failed: "
            f"{lib.row_gather_error_string(code).decode()} (code {code}; "
            f"S={slots} k={k} add={add})")


@kernel_call
def row_gather(x: torch.Tensor, idx: torch.Tensor,
               x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = x[idx[s]]``: ``(S, k)`` from ``x (n, k)`` and ``idx
    (S,)`` int32, any ``k`` for f32 rows; bf16 rows of even ``k`` are
    moved as the f32 pairs of their bits (the mesh executors' bf16
    carriage; odd ``k`` only on the CPU).  With ``x2 (n2, k)`` of
    ``x``'s dtype the source is the rows ``[x; x2]`` (index ``n + j`` is
    ``x2[j]``), read in place.  The kernel copies each row's bits and
    does not check that ``idx`` lies in ``[0, n + n2)``: an index
    outside reads outside the source (the plain version raises)."""
    global LAUNCHES
    if x.dtype == torch.bfloat16 and x.dim() == 2:
        if x.shape[1] % 2 == 0:
            pairs = lambda t: t.contiguous().view(torch.float32)
            return row_gather(pairs(x), idx, None if x2 is None
                              else pairs(x2)).view(torch.bfloat16)
        if x.device.type != "cpu":
            raise ValueError(f"bf16 rows move as f32 pairs: k must be "
                             f"even, got {x.shape[1]}")
        return row_gather_plain(_joined(x, x2), idx)
    _check(x, idx, x2)
    if x.device.type == "cpu":
        return row_gather_plain(_joined(x, x2), idx)
    out = torch.empty((idx.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    if out.numel():
        _launch(x, x2, idx, out, add=False)
        LAUNCHES += 1
    return out


@kernel_call
def row_gather_add_(base: torch.Tensor, x: torch.Tensor, idx: torch.Tensor,
                    x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``base[s] += x[idx[s]]`` in place, one f32 addition with the base
    first (``base + x[idx]``, bit for bit); returns ``base``.  ``base``
    is contiguous ``(S, k)`` f32 and may not overlap the source.
    Indices and ``x2`` as in :func:`row_gather`."""
    global LAUNCHES_ADD
    _check(x, idx, x2)
    check_operand("base", base, torch.float32,
                  (idx.shape[0], x.shape[1]), x.device)
    if any(_overlaps(base, t) for t in (x, x2) if t is not None):
        raise ValueError("base overlaps x: the gather-add writes base "
                         "while it reads x")
    if x.device.type == "cpu":
        return row_gather_add_plain(base, _joined(x, x2), idx)
    if base.numel():
        _launch(x, x2, idx, base, add=True)
        LAUNCHES_ADD += 1
    return base


def _joined(x: torch.Tensor, x2: Optional[torch.Tensor]) -> torch.Tensor:
    """The rows ``[x; x2]`` (the plain versions' one source)."""
    return x if x2 is None else torch.cat([x, x2])


@kernel_call
def granule_gather(x_packed: torch.Tensor, idx: torch.Tensor
                   ) -> torch.Tensor:
    """The probe's entry: ``out.reshape(S, 16)[s] = x[idx[s]]``, returned
    as ``(S / 8, 128)`` f32, from granule-packed ``x_packed (n / 8,
    128)`` f32 (see ``ops.gather.pack_granules``) and ``idx (S,)``
    int32, ``S % 8 == 0``: :func:`row_gather` on the ``(n, 16)`` view of
    the same memory."""
    if x_packed.dim() != 2 or x_packed.shape[1] != LANES:
        raise ValueError(f"x_packed must be (n / {C}, {LANES}), got "
                         f"{tuple(x_packed.shape)}")
    if idx.dim() != 1:
        raise ValueError("idx must be 1-D")
    if idx.shape[0] % C:
        raise ValueError(f"S = {idx.shape[0]} slots is not a multiple of "
                         f"{C} (the output is packed in granule lines)")
    check_operand("x_packed", x_packed, torch.float32,
                  tuple(x_packed.shape), x_packed.device)
    return row_gather(x_packed.view(-1, K), idx).view(-1, LANES)


# -- the Hopper kernel contract (ops/kernel_contract.py) ---------------------

#: Threads of a CTA and rows a thread group gathers at once
#: (``csrc/granule_gather.cu``'s ``kThreads`` and ``kBatch``).
THREADS = 256
BATCH = 8


def gather_meta(slots: int, x_rows: int, k: int, add: bool) -> dict:
    """The literal description of one K4 launch gathering ``slots`` rows
    of ``k`` f32 features from ``x_rows`` rows (``add``: the fused
    gather-add): what ``analysis/kernels.py`` checks."""
    vecload = k % 4 == 0
    width = k // 4 if vecload else k
    lanes = 1
    while lanes < width and lanes < 32:
        lanes *= 2
    rows_per_cta = (THREADS // lanes) * BATCH
    words = 4 if vecload else 1
    return {"kernel": "granule_gather", "kind": "row_gather",
            "slots": slots, "x_rows": x_rows, "k": k, "add": add,
            "vecload": vecload, "width": width, "lanes": lanes,
            "batch": BATCH, "threads": THREADS, "ctas_per_sm": 1,
            "grid": -(-slots // rows_per_cta), "static_smem": 0,
            "dynamic_smem": 0,
            # src offsets (2 a row), live flags, the rows and the bases.
            "regs_demand": 16 + BATCH * (3 + words * (2 if add else 1)),
            "adds_per_element": 1 if add else 0, "accum_dtype": "f32"}


def kcert_metas() -> list:
    """K4 metas: both bodies (k % 4 == 0 or not), gather and gather-add,
    short and ragged slot counts."""
    return [gather_meta(slots, 1000, k, add)
            for slots in (1, 255, 4096, 10_007)
            for k in (1, 3, 4, 16, 36, 128)
            for add in (False, True)]


def kcert_witness():
    """KC1 boundary witness -> (ok, detail): every index at the last row
    of x, through the plain gather and gather-add, equal to numpy."""
    import numpy as np

    x = torch.from_numpy(np.linspace(-1, 1, 64 * 20, dtype=np.float32)
                         .reshape(64, 20))
    idx = torch.full((300,), 63, dtype=torch.int32)
    got = row_gather_plain(x, idx)
    base = torch.ones((300, 20))
    added = row_gather_add_plain(base.clone(), x, idx)
    if not (torch.equal(got, x[63].expand(300, 20))
            and torch.equal(added, 1.0 + x[63].expand(300, 20))):
        return False, "boundary gather != the last row"
    return True, "every index at the last row: gather and gather-add exact"


def kcert_entry():
    """K4's certifiable entry (``ops/kernel_contract.builtin_kernels``)."""
    import os

    from arrow_matrix_tpu_torch.ops.kernel_contract import (
        KernelContract,
        KernelEntry,
    )

    contract = KernelContract(
        name="granule_gather",
        module="arrow_matrix_tpu_torch.ops.cuda_gather",
        kind="row_gather",
        source="csrc/granule_gather.cu",
        threads=THREADS, ctas_per_sm=(1,),
        knobs=(("add", (False, True)),),
        ks=(1, 4, 16, 128),
        carriage_dtypes=("f32",),
        accum_dtype="f32",
        accum_decls=("__device__ __forceinline__ float add(float a, "
                     "float b) { return a + b; }",
                     "float4 add(float4 a, float4 b)"))
    return KernelEntry(contract=contract, metas=kcert_metas,
                       source_path=os.path.join(_build.CSRC_DIR,
                                                "granule_gather.cu"),
                       witness=kcert_witness)

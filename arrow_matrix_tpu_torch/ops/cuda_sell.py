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
(``ops/sell.py:sell_spmm``, ``ops/ell.py:ell_tier_spmm``; with launch
knobs, the work list's twin ``ops/worklist.py:sell_spmm_worklist``).
There is no fallback: a failed build or launch raises.

Launch knobs.  ``sell_spmm_cuda(m, x, opts)`` takes K1's knobs
(``ops/worklist.py:LaunchOpts``); :func:`launch_groups` turns a fold
executor's ``kernel_opts`` (uniform knobs, and a per-tier ``schedule``)
into launches over disjoint tier sets, one for each (batch,
ctas_per_sm, carriage), which :func:`sell_spmm_k1` runs into one
output.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from arrow_matrix_tpu_torch.ops import _build
from arrow_matrix_tpu_torch.ops.ell import ell_tier_spmm, out_dtype_for
from arrow_matrix_tpu_torch.ops.kernel_span import kernel_call
from arrow_matrix_tpu_torch.ops.sell import SellMatrix, sell_spmm
from arrow_matrix_tpu_torch.ops.worklist import (
    CHUNK_SLOTS,
    DEFAULT_OPTS,
    KNOBS,
    TIER_FIELDS,
    LaunchOpts,
    WorkList,
    build_worklist,
    sell_spmm_worklist,
)
from arrow_matrix_tpu_torch.utils.buildstats import bump

#: Kernel launches made by this process: one per product, two when the
#: operator has split rows.
LAUNCHES = 0

#: Carriage code of the C interface, by feature dtype.
CARRIAGES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: ctypes argument types of ``sell_spmm``: carriage, binary, vecload;
#: tiers, items, rows, x, out, part; n_items, n_rows, k, group, batch,
#: ctas_per_sm; stream.
ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])

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
    opts: LaunchOpts
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
               vecload: bool, opts: LaunchOpts = DEFAULT_OPTS) -> DevicePlan:
    """Check the operator's tensors and put the work list of ``m`` at
    ``k`` features of ``dtype`` with the knobs ``opts`` on its device."""
    dev = m.device
    bump("plans")
    _check_tiers(m, dev)
    wl = build_worklist([tuple(c.shape) for c in m.cols], m.row_starts, k,
                        dtype.itemsize, vecload=vecload, opts=opts)
    weights = m.deg if m.data is None else m.data
    table = torch.zeros((len(m.cols), len(TIER_FIELDS)), dtype=torch.int64)
    for t, cols in enumerate(m.cols):
        table[t, 0] = cols.data_ptr() if cols.numel() else 0
        table[t, 1] = weights[t].data_ptr() if weights[t].numel() else 0
    table[:, 2:7] = torch.from_numpy(wl.tiers)
    return DevicePlan(wl=wl, opts=opts, tiers=table.to(dev),
                      items=torch.from_numpy(wl.items).to(dev),
                      rows=torch.from_numpy(wl.rows).to(dev),
                      covers_all=sum(int(c.shape[1]) for c in m.cols)
                      == m.n_rows)


def plan_for(m: SellMatrix, k: int, dtype: torch.dtype,
             vecload: bool, opts: LaunchOpts = DEFAULT_OPTS) -> DevicePlan:
    """The cached plan of ``m`` at (k, dtype, vecload, opts), built at
    first use (the default knobs keep the key of a plan without
    them)."""
    key = (k, dtype, vecload) if opts == DEFAULT_OPTS \
        else (k, dtype, vecload, opts)
    plan = m.plans.get(key)
    if plan is None:
        plan = m.plans[key] = build_plan(m, k, dtype, vecload, opts)
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
                         len(wl.items), len(wl.rows), k, wl.group,
                         plan.opts.batch_for(x.element_size()),
                         plan.opts.ctas_per_sm, stream)
    _raise_on(code, f"{len(wl.tiers)} tiers, {len(wl.items)} items, "
                    f"k={k} {x.dtype}")
    LAUNCHES += wl.launches
    return out


@kernel_call
def sell_spmm_cuda(m: SellMatrix, x: torch.Tensor,
                   opts: Optional[LaunchOpts] = None) -> torch.Tensor:
    """``m @ x`` row-major through K1: ``x`` (x_rows, k) -> (n_rows, k)
    in ``out_dtype_for(x.dtype)``, one launch over every tier (two with
    split rows); ``x_rows`` is ``m.n_rows`` unless the operator is
    rectangular.  ``opts`` are K1's launch knobs (None: the defaults).
    CPU tensors take the plain ``ops.sell.sell_spmm``, or with ``opts``
    the work list's twin (whose chunk sums follow ``chunk_slots``)."""
    if x.device.type == "cpu":
        if opts is None:
            return sell_spmm(m, x)
        wl = build_worklist([tuple(c.shape) for c in m.cols], m.row_starts,
                            x.shape[1], x.element_size(),
                            vecload=x.shape[1] * x.element_size() % 16 == 0,
                            opts=opts)
        return sell_spmm_worklist(m, x, wl)
    k = _check_x(x, m.n_rows if m.x_rows is None else m.x_rows)
    if x.device != m.device:
        raise ValueError(f"x is on {x.device}, the operator on {m.device}")
    if k == 0:
        return torch.empty((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                           device=x.device)
    vecload = _vecload(x)
    plan = plan_for(m, k, x.dtype, vecload, opts or DEFAULT_OPTS)
    # Rows no tier covers (none, as the packer builds operators) are
    # zero, as in the plain version.
    alloc = torch.empty if plan.covers_all else torch.zeros
    out = alloc((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                device=x.device)
    return launch(plan, m.binary, x, out, vecload)


# -- launch groups: a fold executor's kernel_opts --------------------------

#: Keys of a per-tier schedule entry: K1's per-tier knobs, the carriage,
#: and the synthesis provenance (``tune/synth.py``), which steers nothing.
SCHEDULE_KNOBS = ("chunk_slots", "batch", "ctas_per_sm", "carriage")
SCHEDULE_PROVENANCE = ("tier", "m_t", "rows", "family")
#: Carriages a schedule entry may name (int8 quantizes the whole table).
SCHEDULE_CARRIAGES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: The JAX package's TPU knobs, which K1 has no use for.
TPU_KNOBS = ("row_block", "wave", "ring", "smem_cols_budget")


@dataclass(frozen=True)
class LaunchGroup:
    """One K1 launch of a fold product: the operator's ``tiers`` it
    covers, its knobs, and its carriage (None: the carriage of x)."""

    tiers: Tuple[int, ...]
    opts: LaunchOpts
    carriage: Optional[torch.dtype] = None


def _check_keys(d: dict, allowed: Sequence[str], what: str) -> None:
    bad = sorted(set(d) - set(allowed))
    if not bad:
        return
    tpu = [b for b in bad if b in TPU_KNOBS]
    hint = (f"; {tpu} are the JAX package's TPU knobs (VMEM tiles, DMA "
            f"rings), which K1 has no use for" if tpu else "")
    raise ValueError(f"unknown {what} {bad}: K1 takes {list(allowed)}"
                     f"{hint}")


def schedule_entries(schedule, n_tiers: int) -> dict:
    """``{tier: entry}`` of a per-tier schedule (a list of entries with
    a ``tier`` key, or a dict keyed by tier); raises ``ValueError`` for
    a tier out of range, a tier named twice or an unknown key."""
    items = (schedule.items() if isinstance(schedule, dict)
             else ((e.get("tier") if isinstance(e, dict) else None, e)
                   for e in schedule))
    out = {}
    for tier, e in items:
        if not isinstance(e, dict) or tier is None:
            raise ValueError(f"a schedule entry is a dict with a 'tier': "
                             f"{e!r}")
        t = int(tier)
        if not 0 <= t < n_tiers:
            raise ValueError(f"schedule tier {t} outside the operator's "
                             f"{n_tiers} tiers")
        if t in out:
            raise ValueError(f"schedule names tier {t} twice")
        _check_keys(e, SCHEDULE_KNOBS + SCHEDULE_PROVENANCE,
                    "schedule keys")
        if e.get("carriage", "f32") not in SCHEDULE_CARRIAGES:
            raise ValueError(
                f"tier {t}: carriage {e.get('carriage')!r} is not "
                f"schedulable (the int8 (q, scale) pair quantizes the "
                f"whole table; pass feature_dtype='int8' instead)")
        out[t] = e
    return out


def launch_groups(kernel_opts: Optional[dict], n_tiers: int,
                  carriage: torch.dtype) -> Tuple[LaunchGroup, ...]:
    """The K1 launches of a fold product under ``kernel_opts`` (uniform
    knobs ``chunk_slots``/``batch``/``ctas_per_sm``, a
    per-tier ``schedule``, and ``feature_dtype``, which names the
    executor's carriage) over an operator of ``n_tiers`` tiers at the
    executor's ``carriage``: one launch for each distinct (batch,
    ctas_per_sm, carriage) of the tiers, in tier order of first
    appearance.  Every knob is checked against the contract here."""
    opts = dict(kernel_opts or {})
    _check_keys(opts, KNOBS + ("schedule", "feature_dtype"),
                "kernel_opts")
    sched = schedule_entries(opts.pop("schedule", None) or [], n_tiers)
    opts.pop("feature_dtype", None)
    if carriage == torch.int8 and any("carriage" in e
                                      for e in sched.values()):
        raise ValueError(
            "int8 (q, scale) carriage quantizes the whole feature table; "
            "per-tier schedule carriage overrides cannot apply on top of "
            "it")
    uniform = LaunchOpts(**opts)
    groups: dict = {}
    chunks = []
    for t in range(n_tiers):
        e = sched.get(t, {})
        c = SCHEDULE_CARRIAGES[e["carriage"]] if "carriage" in e else None
        if c == carriage:
            c = None
        batch = e.get("batch", uniform.batch)
        ctas = e.get("ctas_per_sm", uniform.ctas_per_sm)
        chunks.append(int(e.get("chunk_slots", uniform.chunk_of(t))))
        groups.setdefault((batch, ctas, c), []).append(t)
    out = []
    for (batch, ctas, c), tiers in groups.items():
        sub_chunks = tuple(chunks[t] for t in tiers)
        chunk = (sub_chunks[0] if len(set(sub_chunks)) == 1
                 else sub_chunks)
        lo = LaunchOpts(chunk_slots=chunk, batch=batch, ctas_per_sm=ctas)
        lo.check(len(tiers))
        out.append(LaunchGroup(tuple(tiers), lo, c))
    return tuple(out)


def tier_subset(m: SellMatrix, tiers: Tuple[int, ...]) -> SellMatrix:
    """The operator of ``m``'s ``tiers`` alone (the same rows and
    columns; the other tiers' rows are not written), cached on ``m``."""
    if tiers == tuple(range(len(m.cols))):
        return m
    sub = m.subsets.get(tiers)
    if sub is None:
        pick = (lambda ts: None if ts is None
                else tuple(ts[t] for t in tiers))
        sub = m.subsets[tiers] = SellMatrix(
            cols=pick(m.cols), data=pick(m.data), deg=pick(m.deg),
            n_rows=m.n_rows, row_starts=tuple(m.row_starts[t] for t in tiers),
            x_rows=m.n_rows if m.x_rows is None else m.x_rows)
    return sub


@kernel_call
def sell_spmm_k1(m: SellMatrix, x: torch.Tensor,
                 groups: Sequence[LaunchGroup]) -> torch.Tensor:
    """``m @ x`` through the K1 launches ``groups`` (:func:`launch_groups`)
    into one output of ``out_dtype_for(x.dtype)``: a launch at x's
    carriage writes its tiers' rows in place, a launch at another
    carriage runs on a converted copy of x and its rows are copied over,
    and a group of zero-slot tiers launches nothing (the output starts
    at zero).  CPU tensors take the twin of each launch."""
    if len(groups) == 1 and groups[0].carriage is None \
            and len(groups[0].tiers) == len(m.cols):
        return sell_spmm_cuda(m, x, groups[0].opts)
    k = x.shape[1]
    out = torch.zeros((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                      device=x.device)
    for g in groups:
        if all(min(m.cols[t].shape) == 0 for t in g.tiers):
            continue              # zero-slot tiers: their rows stay zero
        sub = tier_subset(m, g.tiers)
        xc = x if g.carriage is None else x.to(g.carriage)
        if x.device.type == "cuda" and out_dtype_for(xc.dtype) == out.dtype:
            _check_x(xc, m.n_rows if m.x_rows is None else m.x_rows)
            if k:
                vecload = _vecload(xc)
                launch(plan_for(sub, k, xc.dtype, vecload, g.opts),
                       sub.binary, xc, out, vecload)
            continue
        part = sell_spmm_cuda(sub, xc, g.opts)
        for t in g.tiers:
            r0, n_t = m.row_starts[t], m.cols[t].shape[1]
            out[r0:r0 + n_t] = part[r0:r0 + n_t].to(out.dtype)
    return out


@kernel_call
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


# -- the Hopper kernel contract (ops/kernel_contract.py) ---------------------

def _contract():
    from arrow_matrix_tpu_torch.ops import kernel_contract as kc
    from arrow_matrix_tpu_torch.ops import worklist as wlm

    return kc.KernelContract(
        name="sell_tier_spmm",
        module="arrow_matrix_tpu_torch.ops.cuda_sell",
        kind="k1_worklist",
        source="csrc/sell_tier_spmm.cu",
        threads=wlm.THREADS,
        ctas_per_sm=wlm.CTAS_PER_SM_CHOICES,
        # The shared array ``red``: VEC floats a thread, VEC 16 at int8.
        static_smem_bytes=16 * wlm.THREADS * 4,
        dynamic_smem_bytes=0,
        knobs=(("batch", wlm.BATCH_CHOICES),
               ("chunk_slots", wlm.CHUNK_SLOTS_CHOICES),
               ("ctas_per_sm", wlm.CTAS_PER_SM_CHOICES)),
        ks=(1, 16, 20, 128),
        carriage_dtypes=tuple(CARRIAGE_NAMES.values()),
        accum_dtype="f32",
        accum_decls=("float acc[VEC];", "float acc = __ldg(part + first * k + c);",
                     "__shared__ float red[VEC * kThreads];",
                     "float* __restrict__ part"))


#: Carriage names of the contract, by dtype.
CARRIAGE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.int8: "int8"}

#: The certifier's operator: a zero-slot tier, bulk tiers, a mid tier,
#: hub tiers and a 6,000-slot hub row (phase 3's ladder, rows cut).
KCERT_SHAPES = ((0, 37), (8, 400), (16, 300), (40, 120), (72, 70),
                (700, 6), (2_000, 2), (6_000, 1))


def kcert_points():
    """(k, carriage, vecload, LaunchOpts) of every certified K1 point:
    every knob point of the contract at k = 16 and 128 (16-byte loads)
    for each carriage, and the default knobs at k = 1 and 20 (the scalar
    path)."""
    import itertools

    from arrow_matrix_tpu_torch.ops import worklist as wlm

    points = []
    for carriage, item in (("f32", 4), ("bf16", 2), ("int8", 1)):
        for k in (16, 128):
            for cs, b, ctas in itertools.product(
                    wlm.CHUNK_SLOTS_CHOICES, wlm.BATCH_CHOICES,
                    wlm.CTAS_PER_SM_CHOICES):
                points.append((k, carriage, True, LaunchOpts(
                    chunk_slots=cs, batch=b, ctas_per_sm=ctas)))
        for k in (1, 20):
            points.append((k, carriage, k * item % 16 == 0, DEFAULT_OPTS))
    return points


def kcert_metas(shapes=KCERT_SHAPES, points=None) -> list:
    """K1's launch metas (``ops/worklist.py:k1_meta``) at every point of
    :func:`kcert_points` over the operator of ``shapes``, binary at the
    16-byte points and weighted on the scalar path."""
    from arrow_matrix_tpu_torch.ops.worklist import k1_meta

    starts, r = [], 0
    for _, n_t in shapes:
        starts.append(r)
        r += n_t
    return [k1_meta(shapes, starts, r, r, k, carriage, vecload, vecload,
                    opts)
            for k, carriage, vecload, opts in (points or kcert_points())]


def kcert_witness():
    """KC1 boundary witness -> (ok, detail): an operator whose every
    slot points at the last row of x, through the work list's twin at
    each carriage and k in {16, 20, 128}, against the plain product;
    finite and equal (one bf16 ulp)."""
    import numpy as np

    from arrow_matrix_tpu_torch.ops.sell import sell_from_arrays
    from arrow_matrix_tpu_torch.ops.worklist import sell_spmm_worklist

    shapes = ((3, 40), (200, 3))
    n = sum(n_t for _, n_t in shapes)
    cols = [np.full(s, n - 1, np.int32) for s in shapes]
    deg = [np.full(s[1], s[0], np.int32) for s in shapes]
    m = sell_from_arrays(cols, None, deg, n, [0, 40], device="cpu")
    rng = np.random.default_rng(0)
    try:
        for k in (16, 20, 128):
            xf = torch.from_numpy(rng.uniform(-1, 1, (n, k)).astype(
                np.float32))
            for x in (xf, xf.to(torch.bfloat16),
                      torch.from_numpy(rng.integers(-127, 128, (n, k))
                                       .astype(np.int8))):
                for opts in (DEFAULT_OPTS, LaunchOpts(chunk_slots=64)):
                    # The certifier's witness: one list per probed point.
                    wl = build_worklist(  # graft-lint: disable=R2
                        [tuple(c.shape) for c in m.cols], m.row_starts, k,
                        x.element_size(),
                        vecload=k * x.element_size() % 16 == 0, opts=opts)
                    got = sell_spmm_worklist(m, x, wl).float()
                    want = sell_spmm(m, x).float()
                    if not bool(torch.isfinite(got).all()):
                        return False, f"non-finite boundary output (k={k})"
                    tol = 1e-2 if x.dtype == torch.bfloat16 else 1e-5
                    if not torch.allclose(got, want, rtol=tol, atol=tol):
                        return False, (f"boundary twin != plain at k={k} "
                                       f"{x.dtype} {opts}")
    except (IndexError, RuntimeError) as exc:
        return False, f"boundary run raised: {exc!r}"
    return True, ("every slot at the last row: the work list's twin equals "
                  "the plain product at k 16/20/128, f32/bf16/int8")


def kcert_entry():
    """K1's certifiable entry (``ops/kernel_contract.builtin_kernels``)."""
    import os

    from arrow_matrix_tpu_torch.ops.kernel_contract import KernelEntry

    return KernelEntry(contract=_contract(), metas=kcert_metas,
                       source_path=os.path.join(_build.CSRC_DIR,
                                                "sell_tier_spmm.cu"),
                       witness=kcert_witness)

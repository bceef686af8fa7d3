"""The single-device executors: iterated ``X := A @ X`` through a
whole arrow decomposition.

Counterpart of the single-device slices of
``arrow_matrix_tpu/parallel/multi_level.py``: ``fmt`` "fold", "dense",
"ell", "hyb" and "auto" (the default, as in the reference).

Fold.  On one device the inter-level permutation exchanges buy
nothing, so the host composes every level into ONE operator in level-0
coordinates (exact: ``A = sum_i P_i^T B_i P_i`` and the levels
partition the edge set), sorts its rows by degree and packs it into
SELL tiers (``ops/sell.py``).  A step is one product through that
operator: one launch of the hand-written kernel K1 over every tier, two
when the operator has rows split across CTAs (``ops/cuda_sell.py``,
``ops/worklist.py``; the work list is built at the first step at each
k and carriage).

Per level (dense, ELL, HYB).  Every level keeps its own operator: dense
``(nb_i, w_i, w_i)`` arrow block stacks, ELL arrow block stacks
(``ops/arrow_blocks.py``), or a whole-level split ELL
(``ops/hyb.py``); "auto" makes levels dense while their cumulative
footprint fits ``dense_budget`` and the rest ELL.  A step routes the
carriage forward from level to level with the composed permutation
tables, runs each level's product, and aggregates the partial products
backward in the same order as the JAX package.  On the card a dense
level runs the hand-written kernels K3 (head row) and K2 (every other
block row) (``ops/cuda_blocks.py``), every ELL stack, ELL head and HYB
partition runs K1 (``ops/cuda_ell.py``), and the routing runs K4
(``ops/cuda_gather.py``): a row gather forward, a fused gather-add
backward, over int32 tables.

Carriage.  Features are carried **row-major** ``(total_rows, k)`` on
the device, in level-0 order (fold: sorted level-0 order): a gathered
row is then one contiguous ``k * itemsize`` load.  (The JAX package's
fold carries ``(k, total_rows)`` because of the TPU's (8, 128)
tiling.)  The public
comparison points keep the JAX shapes: ``gather_result`` returns a host
``(n, k)`` array in original row order, and ``export_folded`` writes
the same directory as the JAX package.

Column schedule.  ``repl`` (c, the fold only) and ``overlap_slabs``
(S) split a step along the features, as the JAX executor does: c
column groups of ``k / c`` features, each cut into S slabs, each slab
one product (one K1 product over ``k / (c S)`` columns for the fold).
A slab of the row-major carriage is a strided view, so each is copied
once into a contiguous tensor, and the slabs' results are concatenated
once per step.  SpMM is separable per feature column and K1 sums each
output element in an order fixed by the operator alone, so every
schedule equals ``repl=1`` bit for bit.  These are the rungs of the
serving runtime's degradation ladder (``serve/scheduler.py``).

HBM model.  :meth:`MultiLevelArrow.predicted_hbm_bytes` counts the
device tensors of a supervised run at a feature width: the operator,
K1's work-list tables and its split-row float32 workspace, three
carriages (the entry state a supervisor keeps for rollback, a step's
input and its output) and the column schedule's slab copies; :meth:`carriage_hbm_bytes` is its part that grows with k,
the serving runtime's admission price.

Kernels and plans.  ``kernel`` is the JAX class's argument: "xla" (the
default) runs the fold through K1 at its default knobs, "pallas_sell"
(``fmt="fold"`` only) runs K1 with ``kernel_opts`` honoured: its launch
knobs (``ops/worklist.py:LaunchOpts``) and a per-tier ``schedule``,
one K1 launch for each distinct (batch, ctas_per_sm, carriage) of the
tiers (``ops/cuda_sell.py:launch_groups``); "pallas" is the dense
levels' K2/K3 and needs a dense level.  ``plan`` (a ``TunePlan``, its
dict, or "auto": the structure's cached plan, ``tune/plan.py``)
replaces the knob arguments, and explicit ``kernel_opts`` beat the
plan's; a miss warns ``TunePlanMiss`` and runs the arguments given.

Faults.  ``step`` passes its input through the fault hook
``faults.on_step("multi_level.step", x)`` (on the int8 pair, through
its scale), one ``None`` check when no plan is set.

The int8 carriage is a symmetric per-feature pair ``(q, scale)``:
``q`` int8 ``(total_rows, k)`` and ``scale`` f32 ``(1, k)`` (``(k, 1)``
in the JAX package).  SpMM is separable per feature column, so the
scale rides outside the kernel and the only error is the per-step
requantization.

Gradients.  ``step`` and ``step_fn`` go through
``parallel/autograd.py:StepFunction``: the backward of a step is one
step over the transposed operator (:meth:`MultiLevelArrow.transposed`),
which on the card runs the same kernels, so a model whose gradient
crosses a propagation trains through K1-K4.  The int8 carriage takes no
gradient.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.decomposition.decompose import ArrowLevel
from arrow_matrix_tpu_torch.io.graphio import (
    num_nonzeros,
    num_rows,
    number_of_blocks,
)
from arrow_matrix_tpu_torch.ops.arrow_blocks import (
    HEAD_FORMATS,
    ArrowBlocks,
    arrow_blocks_from_csr,
    block_row_stats,
    resolve_block_dtype,
)
from arrow_matrix_tpu_torch.ops.cuda_blocks import arrow_spmm_cuda
from arrow_matrix_tpu_torch.ops.cuda_ell import (
    arrow_spmm_ell_cuda,
    hyb_spmm_cuda,
    hyb_operands,
    k1_operands,
)
from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather, row_gather_add_
from arrow_matrix_tpu_torch.ops.cuda_sell import (
    launch_groups,
    sell_spmm_cuda,
    sell_spmm_k1,
    tier_subset,
)
from arrow_matrix_tpu_torch.ops.worklist import LaunchOpts, build_worklist
from arrow_matrix_tpu_torch.ops.ell import SLOT_ALIGN, auto_chunk
from arrow_matrix_tpu_torch.ops.hyb import HybLevel, hyb_from_csr, hyb_stats
from arrow_matrix_tpu_torch.ops.sell import (
    SellMatrix,
    resolve_binary,
    sell_from_arrays,
    sell_pack_numpy,
    sell_stats,
)
from arrow_matrix_tpu_torch.parallel.autograd import (
    StepFunction,
    Transposed,
    build_transposed,
)
from arrow_matrix_tpu_torch.parallel.routing import (
    overlap_slices,
    repl_slab_width,
)
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device
from arrow_matrix_tpu_torch.utils.platform import (
    device_memory_budget,
    gather_budget_for,
)

#: Executor formats: the fold, and the per-level ones.
FORMATS = ("auto", "dense", "ell", "hyb", "fold")
#: Kernels of the executor (the JAX class's names): "xla" is K1 at its
#: defaults on the fold, "pallas_sell" K1 with its knobs, "pallas" the
#: dense levels' K2/K3.
KERNELS = ("xla", "pallas", "pallas_sell")

#: Carriage dtypes by name; None is f32.
FEATURE_DTYPES = {None: torch.float32, "f32": torch.float32,
                  "float32": torch.float32, "bf16": torch.bfloat16,
                  "bfloat16": torch.bfloat16, "int8": torch.int8}

# The name the export's meta.json records for each carriage (numpy's
# dtype names, as the JAX package writes them).
_META_NAMES = {torch.bfloat16: "bfloat16", torch.int8: "int8"}

_INV_127 = float(np.float32(1.0) / np.float32(127.0))

#: The CUDA caching allocator's block granularity: every tensor takes a
#: multiple of 512 bytes of device memory.
ALLOC_BLOCK = 512
#: Device bytes of the supervisor's finite check: the min and max of
#: ``torch.aminmax`` and the three one-element masks that test them.
FINITE_CHECK_BYTES = 5 * ALLOC_BLOCK


def alloc_bytes(nbytes: int) -> int:
    """Device bytes a tensor of ``nbytes`` takes (whole allocator
    blocks)."""
    return -(-int(nbytes) // ALLOC_BLOCK) * ALLOC_BLOCK


def resolve_feature_dtype(feature_dtype) -> torch.dtype:
    """Carriage dtype of a request: None/"f32" -> float32, "bf16",
    "int8" (the quantized pair), or a torch dtype among those."""
    if isinstance(feature_dtype, torch.dtype):
        if feature_dtype not in FEATURE_DTYPES.values():
            raise ValueError(f"unsupported feature dtype {feature_dtype}")
        return feature_dtype
    try:
        return FEATURE_DTYPES[feature_dtype]
    except KeyError:
        raise ValueError(f"unknown feature_dtype {feature_dtype!r} "
                         f"(expected None, 'f32', 'bf16' or 'int8')"
                         ) from None


def pad_to_multiple(n: int, unit: int) -> int:
    """Smallest multiple of ``unit`` that is >= n."""
    return -(-n // unit) * unit


def pad_permutation(perm: np.ndarray, total: int) -> np.ndarray:
    """Extend a permutation of [0, n) to [0, total) with an identity
    tail (padding rows are zero and permute among themselves)."""
    n = perm.size
    if n > total:
        raise ValueError(f"permutation length {n} exceeds padded rows "
                         f"{total}")
    return np.concatenate([perm.astype(np.int64),
                           np.arange(n, total, dtype=np.int64)])


def gather_host_rows(x: np.ndarray, index: np.ndarray) -> torch.Tensor:
    """``x[index]`` on the host as a CPU tensor, the rows whose index is
    ``len(x)`` or more zero (padding), through torch's threaded row
    gather (numpy's fancy indexing copies on one core)."""
    with warnings.catch_warnings():
        # A read-only array (a memmap, a broadcast) is only read here.
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(x))
    idx = torch.from_numpy(np.ascontiguousarray(index, dtype=np.int64))
    pad = idx >= src.shape[0]
    out = src.index_select(0, idx.clamp(max=src.shape[0] - 1))
    if bool(pad.any()):
        out[pad] = 0
    return out


def compose_routing(perms: Sequence[np.ndarray], total: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Routing tables between consecutive levels, each ``(K-1, total)``
    int32 (``(0, total)`` for one level):

      ``fwd[i-1]`` maps level-(i-1)-ordered rows to level-i order:
          ``x_i = x_{i-1}[fwd[i-1]]``, ``fwd[i-1] = inv(s_{i-1})[s_i]``;
      ``bwd[i-1]`` maps level-i-ordered rows to level-(i-1) order:
          ``agg_{i-1} += agg_i[bwd[i-1]]``, ``bwd[i-1] = inv(s_i)[s_{i-1}]``.
    """
    padded = [pad_permutation(np.asarray(p), total) for p in perms]
    fwd, bwd = [], []
    for i in range(1, len(padded)):
        inv_prev = np.argsort(padded[i - 1])
        inv_cur = np.argsort(padded[i])
        fwd.append(inv_prev[padded[i]])
        bwd.append(inv_cur[padded[i - 1]])
    if not fwd:
        return (np.zeros((0, total), np.int32),) * 2
    return (np.stack(fwd).astype(np.int32), np.stack(bwd).astype(np.int32))


def resolve_chunk(chunk, blk, total_rows: int, k: int,
                  gather_budget: int) -> Optional[int]:
    """A level's slot chunk for the plain ELL and HYB gathers: explicit
    values pass through; "auto" is the largest that keeps the
    intermediate in ``gather_budget`` (the reference's rule, with no
    lane padding).  Dense levels take none; K1 on the card needs none
    (it materializes no intermediate)."""
    if chunk != "auto":
        return chunk
    if isinstance(blk, HybLevel):
        return auto_chunk(total_rows, k, blk.light_cols.shape[0],
                          gather_budget)
    if blk.fmt != "ell":
        return None
    dims = [blk.diag_cols.shape[-1], blk.col_cols.shape[-1]]
    if not blk.head_flat:
        dims.append(blk.head_cols.shape[-1])
    if blk.banded:
        dims += [blk.lo_cols.shape[-1], blk.hi_cols.shape[-1]]
    return auto_chunk(total_rows, k, max(dims), gather_budget)


def level_spmm(blk, x: torch.Tensor, width: int,
               chunk: Optional[int] = None) -> torch.Tensor:
    """One level's product on the flat ``(total, k)`` carriage in the
    level's order: a dense level through K2/K3, an ELL level or a HYB
    level through K1 (plain versions for CPU tensors; ``chunk`` bounds
    their gathers)."""
    total, k = x.shape
    if isinstance(blk, HybLevel):
        return hyb_spmm_cuda(blk, x, chunk=chunk)
    xb = x.view(total // width, width, k)
    if blk.fmt == "dense":
        return arrow_spmm_cuda(blk, xb).view(total, k)
    return arrow_spmm_ell_cuda(blk, xb, chunk=chunk).view(total, k)


def multi_level_spmm(x: torch.Tensor, fwd: torch.Tensor, bwd: torch.Tensor,
                     blocks: Sequence, widths: Sequence[int],
                     chunk="auto", gather_budget: int = 1 << 30
                     ) -> torch.Tensor:
    """One decomposition-wide product on the flat ``(total, k)`` carriage
    in level-0 order: route forward (``x_i = x_{i-1}[fwd[i-1]]``), one
    product per level (:func:`level_spmm`), then aggregate backward
    (``agg = partial_{i-1} + agg[bwd[i-1]]``, in place into the
    partial), in the JAX package's order.  The routing is K4's row
    gather and fused gather-add over the int32 tables ``fwd``/``bwd``
    (their plain versions for CPU tensors)."""
    total, k = x.shape
    partials = []
    x_cur = x
    for i, (blk, w) in enumerate(zip(blocks, widths)):
        if i > 0:
            x_cur = row_gather(x_cur, fwd[i - 1])
        partials.append(level_spmm(
            blk, x_cur, w,
            resolve_chunk(chunk, blk, total, k, gather_budget)))
    agg = partials[-1]
    for i in range(len(blocks) - 1, 0, -1):
        agg = row_gather_add_(partials[i - 1], agg, bwd[i - 1])
    return agg


def _block_unit_stats(blk) -> dict:
    """Per-unit (rows, nnz, slots) of one packed operator, by its type:
    an arrow block grid (block rows), SELL tiers, or a HYB split."""
    if isinstance(blk, ArrowBlocks):
        return block_row_stats(blk)
    if isinstance(blk, SellMatrix):
        return sell_stats(blk)
    if isinstance(blk, HybLevel):
        return hyb_stats(blk)
    raise TypeError(f"no unit stats for {type(blk).__name__}")


def column_schedule(k: int, repl: int, overlap_slabs: int) -> list:
    """The step's feature slabs ``[(lo, hi), ...]`` at width ``k``:
    ``repl`` column groups of ``k / repl`` outermost, each cut into
    ``overlap_slabs`` equal slabs (the JAX executor's order); raises
    ``ValueError`` when a count does not divide its width."""
    kc = repl_slab_width(k, repl)
    return [(j * kc + lo, j * kc + hi)
            for j in range(max(int(repl), 1))
            for lo, hi in overlap_slices(kc, overlap_slabs)]


def by_slabs(fn, x: torch.Tensor, slabs: list) -> torch.Tensor:
    """``fn`` over each feature slab of the row-major ``x`` (copied once
    into a contiguous tensor), the results concatenated along the
    features; ``fn(x)`` itself for one slab."""
    if len(slabs) == 1:
        return fn(x)
    return torch.cat([fn(x[:, lo:hi].contiguous()) for lo, hi in slabs],
                     dim=1)


def resolve_levels_binary(levels, binary) -> bool:
    """Decomposition-wide binary decision: "auto" is True iff every
    level is implicit-ones or all-ones."""
    if binary is False:
        return False
    out = True
    for lvl in levels:
        m = lvl.matrix
        if isinstance(m, sparse.csr_matrix):
            out &= resolve_binary(binary, m.data, nnz=m.nnz)
        else:
            data, _, indptr = m
            out &= resolve_binary(binary, data,
                                  nnz=int(np.asarray(indptr[-1])))
    return out


def requantize(z: torch.Tensor):
    """One int8 requantization of an f32 step result ``z`` (rows, k):
    ``(q int8, scale f32 (1, k))`` by the JAX package's rule
    (``fold_step_q``): ``q = clip(round(z * (127 / amax)))`` per
    feature, ``scale = amax / 127`` (0 for an all-zero feature)."""
    amax = z.abs().amax(dim=0, keepdim=True)
    pos = amax > 0.0
    safe = torch.where(pos, amax, torch.ones_like(amax))
    # A true division: ``127.0 / safe`` would be reciprocal-times-127 in
    # torch, one more rounding than the reference's quotient.
    q = torch.clamp(torch.round(z * (torch.full_like(safe, 127.0) / safe)),
                    -127.0, 127.0).to(torch.int8)
    # ``amax / 127`` as XLA compiles the reference: a product with the
    # f32 reciprocal of the constant (bit-identical scales).
    scale = torch.where(pos, amax * _INV_127, torch.zeros_like(amax))
    return q, scale


class MultiLevelArrow:
    """A whole decomposition on one device.

    ``MultiLevelArrow(levels, width, *, fmt="auto", banded=False,
    dtype=np.float32, chunk="auto", dense_budget=None, head_fmt="auto",
    binary="auto", feature_dtype=None, fold_growth=1.2,
    fold_align=None, device=None)``: the arguments after ``width`` are
    keyword-only, in the JAX class's names.  ``device=None`` means the
    card (raises without one); ``"cpu"`` runs the plain PyTorch versions
    of the kernels.  ``set_features`` -> ``step``/``run`` ->
    ``gather_result``.

    ``fmt``:

    * "fold" folds every level into one SELL operator;
      ``feature_dtype`` picks its carriage (f32, bf16, int8) and
      ``fold_growth`` / ``fold_align`` its packing;
    * "dense" keeps each level's dense arrow blocks, stored in ``dtype``
      (float32, or "bf16" for half the bytes; sums stay float32);
    * "ell" keeps each level's ELL arrow blocks, the head in
      ``head_fmt`` ("flat", "ell", "gell"; "auto" is resolved per level
      as the reference resolves it on its accelerator: on the card gell
      while ``w * longest head row * (4 + itemsize)`` fits in
      ``dense_budget // 8``, else, as on the CPU, flat when it is at
      least 4x smaller than ELL);
    * "hyb" keeps each level as one split ELL (light and heavy rows);
    * "auto" (default) makes levels dense while the cumulative
      ``total_rows * w * stacks * itemsize`` fits in ``dense_budget``
      (default: half the device's free memory), the rest ELL.

    Levels are tiled ``banded`` or block-diagonal; a level whose achieved
    width exceeds ``width``, and the last level, are tiled banded at
    their own width.  ``binary`` ("auto", True, False) drops the values
    of an all-ones decomposition for degrees.  ``chunk`` ("auto", an int
    or None) bounds the plain ELL/HYB gathers' intermediate; the kernels
    need none.  Every format but the fold carries float32.

    The models' interface is the JAX class's: ``step_fn`` and
    ``step_operands()`` (``step(x) == step_fn(x, *step_operands())``),
    ``carries_feature_major`` (the fold), ``carried_mask`` and
    ``real_row_mask``; ``step`` is differentiable, its backward
    :meth:`transposed_step` over :meth:`transposed`.

    ``repl`` (c, the fold only) and ``overlap_slabs`` (S) are the column
    schedule of a step (module docstring): a width k then needs c | k
    and S | k/c.

    ``kernel``, ``kernel_opts``, ``plan`` and ``plan_k`` are the fold
    executor options (module docstring, "Kernels and plans"); the knobs
    of ``kernel_opts`` apply under ``kernel="pallas_sell"`` and are
    checked under every kernel (the ``"xla"`` rung of a server's ladder
    runs K1 at its defaults whatever the plan's knobs).

    ``mesh`` (a ``parallel/mesh.py`` mesh of ranks) builds the
    multi-device executor, ``parallel/arrow_layout.py:
    MeshMultiLevelArrow`` (with ``axis``, ``routing`` "gather" or "a2a",
    ``layout`` "slim" or "wide", ``arm_axis``); without one, "a2a" and
    "wide" raise the JAX class's ``ValueError``.
    """

    def __new__(cls, levels=None, width=None, *, mesh=None, **kwargs):
        if mesh is not None and cls is MultiLevelArrow:
            from arrow_matrix_tpu_torch.parallel.arrow_layout import (
                MeshMultiLevelArrow,
            )

            return super().__new__(MeshMultiLevelArrow)
        return super().__new__(cls)

    def __init__(self, levels: List[ArrowLevel], width: int, *,
                 mesh=None, banded: bool = False, dtype=np.float32,
                 chunk="auto", fmt: str = "auto",
                 dense_budget: Optional[int] = None, kernel: str = "xla",
                 routing: str = "gather", head_fmt: str = "auto",
                 binary="auto", feature_dtype=None, layout: str = "slim",
                 fold_growth: float = 1.2,
                 fold_align: Optional[int] = None,
                 overlap_slabs: int = 1, repl: int = 1, plan=None,
                 plan_k: Optional[int] = None,
                 kernel_opts: Optional[dict] = None,
                 device: DeviceLike = None):
        from arrow_matrix_tpu_torch.parallel.arrow_layout import (
            check_mesh_options,
        )

        check_mesh_options(None, fmt, routing, layout, head_fmt, repl,
                           kernel, "arm")
        # A resolved plan replaces the knob arguments; explicit
        # kernel_opts beat the plan's (a caller overriding one knob
        # keeps the rest).  A miss warns TunePlanMiss and keeps them.
        self.tune_plan = None
        self.kernel_opts = dict(kernel_opts) if kernel_opts else {}
        if plan is not None:
            from arrow_matrix_tpu_torch.tune.plan import resolve_plan

            resolved = resolve_plan(
                plan, levels=levels, width=width, dtype=dtype,
                growth=fold_growth, slot_align=fold_align, binary=binary,
                plan_k=plan_k)
            if resolved is not None:
                self.tune_plan = resolved
                bk = resolved.build_kwargs()
                fmt, kernel, chunk = bk["fmt"], bk["kernel"], bk["chunk"]
                fold_growth, fold_align = bk["fold_growth"], bk["fold_align"]
                feature_dtype = bk["feature_dtype"]
                overlap_slabs, repl = bk["overlap_slabs"], bk["repl"]
                self.kernel_opts = {**resolved.kernel_opts(),
                                    **self.kernel_opts}
        if fmt not in FORMATS:
            raise ValueError(f"unknown fmt {fmt!r} (expected one of "
                             f"{FORMATS})")
        if feature_dtype is not None and fmt != "fold":
            raise ValueError(
                "feature_dtype is implemented for fmt='fold' (the "
                "single-chip headline path); other formats carry f32")
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}")
        if kernel == "pallas_sell" and fmt != "fold":
            raise ValueError(
                "kernel='pallas_sell' is the fused fold kernel (K1 with "
                "kernel_opts, ops/cuda_sell.py); it requires fmt='fold'")
        self.kernel = kernel
        if overlap_slabs < 1:
            raise ValueError(f"overlap_slabs must be >= 1, got "
                             f"{overlap_slabs}")
        if repl < 1:
            raise ValueError(f"repl must be >= 1, got {repl}")
        if repl > 1 and fmt != "fold":
            raise ValueError(
                f"repl={repl} requires fmt='fold' (the single-device "
                f"column-group schedule), got fmt={fmt!r}")
        self.repl = int(repl)
        self.overlap_slabs = int(overlap_slabs)
        if head_fmt not in HEAD_FORMATS:
            raise ValueError(f"unknown head_fmt {head_fmt!r}")
        if not levels:
            raise ValueError("empty decomposition")
        self.device = resolve_device(device)
        self.feature_dtype = resolve_feature_dtype(feature_dtype)
        self.fmt = fmt
        self.folded = fmt == "fold"
        self.width = width
        self.chunk = chunk
        self.n = num_rows(levels[0].matrix)
        if dense_budget is None:
            dense_budget = device_memory_budget(self.device)
        self.dense_budget = int(dense_budget)

        # Per-level block widths as in the JAX executor: a level whose
        # achieved width exceeds the base width, and the last level
        # (whose structure is a band even in block-diagonal mode), are
        # tiled banded at their achieved width rounded up to a multiple
        # of the base width; banded tiling at block width W covers every
        # |r - c| <= W entry.
        widths, bandeds = [], []
        for i, lvl in enumerate(levels):
            if lvl.arrow_width > width or i == len(levels) - 1:
                widths.append(-(-lvl.arrow_width // width) * width)
                bandeds.append(True)
            else:
                widths.append(width)
                bandeds.append(banded)
        self.widths = widths
        # Same padded row count as the JAX executor on one device: a
        # multiple of the widest level block width.
        max_rows = max(number_of_blocks(lvl.matrix, w) * w
                       for lvl, w in zip(levels, widths))
        self.total_rows = pad_to_multiple(max_rows, max(widths))
        self.binary = resolve_levels_binary(levels, binary)
        self._transposed: Optional[Transposed] = None
        if self.folded:
            self.fmts = ["fold"]
            self._init_folded(levels, fold_growth, fold_align)
            # Checks every knob (and the int8 rule) under every kernel.
            self._groups = {self.feature_dtype: launch_groups(
                self.kernel_opts, len(self.sell.cols), self.feature_dtype)}
        else:
            launch_groups({k: v for k, v in self.kernel_opts.items()
                           if k != "schedule"}, 0, torch.float32)
            self._init_levels(levels, bandeds, dtype, head_fmt)
        if self.kernel == "pallas" and "dense" not in self.fmts:
            raise ValueError(
                "kernel='pallas' but no level resolved to the dense block "
                "format (the pallas kernels cover dense only; raise "
                "dense_budget or pass fmt='dense')")

    def _level_formats(self, bandeds, itemsize: int) -> List[str]:
        """Each level's format: ``fmt`` itself, or for "auto" dense
        while the cumulative dense footprint (``total_rows * w * stacks
        * itemsize``; 3 stacks, 5 banded) fits ``dense_budget``, then
        ELL (the reference's rule)."""
        if self.fmt != "auto":
            return [self.fmt] * len(self.widths)
        left = self.dense_budget
        fmts = []
        for w, bd in zip(self.widths, bandeds):
            need = self.total_rows * w * (5 if bd else 3) * itemsize
            if need <= left:
                left -= need
                fmts.append("dense")
            else:
                fmts.append("ell")
        return fmts

    def _head_format(self, matrix, w: int, head_fmt: str,
                     itemsize: int) -> str:
        """``head_fmt`` of an ELL level: "auto" on the card is gell while
        ``w * longest head row * (4 + itemsize)`` fits in
        ``dense_budget // 8`` (a gather streams; the flat head is a
        scatter), else the size rule; on the CPU the size rule, as the
        reference resolves it off its accelerator."""
        if head_fmt != "auto" or self.device.type != "cuda":
            return head_fmt
        indptr = (matrix.indptr if isinstance(matrix, sparse.csr_matrix)
                  else matrix[2])
        w_eff = min(w, indptr.shape[0] - 1)
        counts = np.diff(np.asarray(indptr[:w_eff + 1]))
        need = int(counts.max()) if counts.size else 0
        gell_bytes = w * need * (4 + itemsize)
        return "gell" if gell_bytes <= self.dense_budget // 8 else "auto"

    def _init_levels(self, levels, bandeds, dtype, head_fmt) -> None:
        """Build every level's operator on the device, all padded to the
        shared flat row count, and compose the routing tables (the JAX
        single-device non-fold ``__init__``).  One level is built,
        uploaded and its host arrays dropped before the next; on the
        card each ELL and HYB level's K1 operators are built here too,
        so no step does set-up work.  The levels are kept (a reference,
        no copy) for the transposed operator of the backward."""
        total = self.total_rows
        self.dtype = resolve_block_dtype(dtype)
        self.fmts = self._level_formats(bandeds, self.dtype.itemsize)
        self.levels = list(levels)
        self.bandeds = list(bandeds)
        self.head_fmt = head_fmt
        self.blocks = [self.pack_level(i, lvl.matrix)
                       for i, lvl in enumerate(levels)]
        fwd, bwd = compose_routing([lvl.permutation for lvl in levels],
                                   total)
        self.fwd = torch.from_numpy(fwd).to(self.device)
        self.bwd = torch.from_numpy(bwd).to(self.device)
        self.perm0 = pad_permutation(np.asarray(levels[0].permutation),
                                     total)
        self.inv_perm0 = np.argsort(self.perm0)
        self.nnz = sum(num_nonzeros(lvl.matrix) for lvl in levels)
        self.gather_budget = gather_budget_for(self.dense_budget)

    def pack_level(self, i: int, matrix):
        """Level ``i``'s operator for ``matrix`` (the level's matrix, or
        its transpose) in the level's format, width and tiling, on the
        device; an ELL head in ``head_fmt`` resolved for ``matrix``; on
        the card with its K1 operators built."""
        w, f, total = self.widths[i], self.fmts[i], self.total_rows
        if f == "hyb":
            blk = hyb_from_csr(matrix, pad_rows_to=total, dtype=self.dtype,
                               binary=self.binary, device=self.device)
        else:
            hf = (self._head_format(matrix, w, self.head_fmt,
                                    self.dtype.itemsize)
                  if f == "ell" else "auto")
            blk = arrow_blocks_from_csr(
                matrix, w, pad_blocks_to=total // w, banded=self.bandeds[i],
                dtype=self.dtype, fmt=f, head_fmt=hf, binary=self.binary,
                device=self.device)
        if self.device.type == "cuda" and f == "hyb":
            hyb_operands(blk)
        elif self.device.type == "cuda" and f == "ell":
            k1_operands(blk)
        return blk

    def level_matrices(self) -> list:
        """Each level's global matrix (what :meth:`transposed` reads)."""
        return [lvl.matrix for lvl in self.levels]

    def pack_transposed(self, i: int, matrix):
        """Level ``i``'s operator for ``matrix``, a level's transpose:
        :meth:`pack_level` on one device."""
        return self.pack_level(i, matrix)

    def _init_folded(self, levels, growth: float,
                     slot_align: Optional[int]) -> None:
        """Compose all levels into one CSR in level-0 coordinates, pack
        it into degree-sorted SELL tiers, and compose the sort into the
        carried order (the JAX ``_init_folded``, step for step)."""
        total = self.total_rows
        perms = [pad_permutation(np.asarray(lvl.permutation), total)
                 for lvl in levels]
        perm0 = perms[0]
        inv_perm0 = np.argsort(perm0)

        rows_l, cols_l, data_l = [], [], []
        implicit_ones = True
        for lvl, p in zip(levels, perms):
            mp = inv_perm0[p]          # level-i index -> level-0 index
            if isinstance(lvl.matrix, sparse.csr_matrix):
                coo = lvl.matrix.tocoo()
                r, c, d = coo.row, coo.col, coo.data
            else:
                d, indices, indptr = lvl.matrix
                indptr = np.asarray(indptr, dtype=np.int64)
                nnz = int(indptr[-1])
                r = np.repeat(np.arange(indptr.size - 1),
                              np.diff(indptr)).astype(np.int64)
                c = np.asarray(indices[:nnz])
                if d is not None:
                    d = np.asarray(d[:nnz])
            rows_l.append(mp[r])
            cols_l.append(mp[c])
            if d is None:
                data_l.append(np.ones(len(rows_l[-1]), dtype=np.float32))
            else:
                implicit_ones = False
                data_l.append(np.asarray(d, dtype=np.float32))

        folded = sparse.csr_matrix(
            (np.concatenate(data_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(total, total))
        folded.sum_duplicates()
        folded.sort_indices()
        if implicit_ones and not np.all(folded.data == 1.0):
            raise AssertionError(
                "edge-disjoint levels folded to duplicate positions")
        self.nnz = int(folded.nnz)

        cols, data, deg, n_rows, starts, order = sell_pack_numpy(
            folded, pad_rows_to=total, binary=self.binary, growth=growth,
            slot_align=SLOT_ALIGN if slot_align is None else slot_align)
        self.sell = sell_from_arrays(cols, data, deg, n_rows, starts,
                                     device=self.device)
        self.perm0 = perm0[order]
        self.inv_perm0 = np.argsort(self.perm0)

    # -- features ----------------------------------------------------------

    @property
    def int8(self) -> bool:
        return self.feature_dtype == torch.int8

    @property
    def carries_feature_major(self) -> bool:
        """The carried-layout capability flag the models key on (the
        ``*Carried`` classes and the solvers that mask by
        ``carried_mask``): True for ``fmt="fold"``.  The JAX name is
        kept; the port's fold carriage is row-major ``(total_rows, k)``
        where the JAX package's is feature-major ``(k, positions)``."""
        return self.folded

    def set_features(self, x_original: np.ndarray):
        """Host (n, k) features in original row order -> the device
        carriage: (total_rows, k) in sorted level-0 order, in the
        carriage dtype; for int8 the pair ``(q, scale (1, k))``."""
        x_original = np.asarray(x_original)
        n, k = x_original.shape
        if n != self.n:
            raise ValueError(f"expected {self.n} rows, got {n}")
        feat = gather_host_rows(x_original, self.perm0)
        if self.int8:
            xf = feat.float().numpy()
            amax = np.max(np.abs(xf), axis=0, keepdims=True)
            safe = np.where(amax > 0.0, amax, 1.0)
            q = np.clip(np.rint(xf * (127.0 / safe)),
                        -127.0, 127.0).astype(np.int8)
            scale = np.where(amax > 0.0, amax / 127.0,
                             0.0).astype(np.float32)
            return (torch.from_numpy(q).to(self.device),
                    torch.from_numpy(scale).to(self.device))
        # Converted on the host: the card holds only the carriage.
        return feat.float().to(self.feature_dtype).to(self.device)

    def gather_result(self, c) -> np.ndarray:
        """Device carriage -> host (n, k) f32 array in original order."""
        if isinstance(c, tuple):
            q, scale = c
            arr = (q.float() * scale.float()).cpu().numpy()
        else:
            # Copied to the host first: no float32 copy on the card.
            arr = c.detach().cpu().float().numpy()
        return gather_host_rows(arr, self.inv_perm0[:self.n]).numpy()

    def _row_mask(self, dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(
            (self.perm0 < self.n).astype(dtype)[:, None]).to(self.device)

    def carried_mask(self) -> torch.Tensor:
        """(total_rows, 1) f32 mask of the folded row-major carriage: 1
        where a position holds a real original row (``(1, total_rows)``
        in the JAX package's feature-major carriage)."""
        if not self.folded:
            raise ValueError(
                "carried_mask is defined for fmt='fold'; the per-level "
                "formats' carriage uses real_row_mask")
        return self._row_mask()

    def real_row_mask(self, dtype=np.float32) -> torch.Tensor:
        """(total_rows, 1) mask of the per-level formats' carriage (the
        dense carriage of the JAX package: level-0 order), in the numpy
        ``dtype``: 1 for rows backed by an original matrix row
        (``perm0[r] < n``), 0 for padding."""
        if self.folded:
            raise ValueError(
                "real_row_mask is defined for the dense carriage of the "
                "per-level formats; fmt='fold' uses carried_mask")
        return self._row_mask(dtype)

    def head_layouts(self) -> List[Optional[str]]:
        """Each level's head layout: "gell", "flat" or "ell" for an ELL
        level, None for the others."""
        return [None if not isinstance(b, ArrowBlocks) or b.fmt != "ell"
                else "gell" if b.head_gell
                else "flat" if b.head_flat else "ell"
                for b in getattr(self, "blocks", ())]

    # -- iteration ---------------------------------------------------------

    def step_operands(self) -> tuple:
        """The device operands of one step: ``(fwd, bwd, blocks)`` per
        level as in the JAX package, ``(sell,)`` for the fold;
        ``step(x) == step_fn(x, *step_operands())``."""
        if self.folded:
            return (self.sell,)
        return (self.fwd, self.bwd, self.blocks)

    @property
    def step_fn(self):
        """The step callable, ``step(x) == step_fn(x, *step_operands())``
        (the JAX pair, for callers that thread the operands).  Its
        backward is this executor's transposed step, so it takes this
        executor's own operands and raises ``ValueError`` on others."""
        return self._step_fn

    def _step_fn(self, x, *operands):
        own = self.step_operands()
        if len(operands) != len(own) or any(
                a is not b for a, b in zip(operands, own)):
            raise ValueError(
                "step_fn takes this executor's step_operands(): its "
                "backward is the transpose of this executor's operator")
        if isinstance(x, tuple):           # the int8 pair: no gradient
            return self.raw_step(x, *operands)
        return StepFunction.apply(x, self, operands)

    def raw_step(self, x, *operands):
        """The step's kernels on ``operands``, with no autograd: the
        per-level product and routing, or the fold's K1 product (int8:
        then requantized)."""
        if not self.folded:
            fwd, bwd, blocks = operands
            return by_slabs(
                lambda xs: multi_level_spmm(
                    xs, fwd, bwd, blocks, self.widths, chunk=self.chunk,
                    gather_budget=self.gather_budget),
                x.contiguous(), self.slabs(x.shape[1]))
        (sell,) = operands
        if isinstance(x, tuple):
            q, scale = x
            z = by_slabs(lambda qs: self.fold_product(sell, qs), q,
                         self.slabs(q.shape[1]))
            return requantize(z * scale)
        return by_slabs(lambda xs: self.fold_product(sell, xs),
                        x.contiguous(), self.slabs(x.shape[1]))

    def launch_groups(self, dtype: torch.dtype) -> tuple:
        """K1's launches of a fold product at carriage ``dtype`` under
        ``kernel_opts`` (``ops/cuda_sell.py:launch_groups``)."""
        groups = self.__dict__.setdefault("_groups", {})
        if dtype not in groups:
            groups[dtype] = launch_groups(self.kernel_opts,
                                          len(self.sell.cols), dtype)
        return groups[dtype]

    def fold_product(self, sell: SellMatrix, x: torch.Tensor) -> torch.Tensor:
        """One K1 product of the fold: at the default knobs under
        ``kernel="xla"``, through the launches of ``kernel_opts`` under
        ``"pallas_sell"``."""
        if getattr(self, "kernel", "xla") == "pallas_sell":
            return sell_spmm_k1(sell, x, self.launch_groups(x.dtype))
        return sell_spmm_cuda(sell, x)

    def slabs(self, k: int) -> list:
        """The step's feature slabs at width ``k`` (module docstring);
        ``[(0, k)]`` with neither ``repl`` nor ``overlap_slabs``."""
        return column_schedule(k, getattr(self, "repl", 1),
                               getattr(self, "overlap_slabs", 1))

    def step(self, x):
        """One iteration ``X := A @ X`` on the carriage, differentiable
        in ``x`` (its backward is :meth:`transposed_step`).  The input
        passes the fault hook ``multi_level.step`` first (for the int8
        pair, its scale)."""
        from arrow_matrix_tpu_torch.faults import on_step as _fault_hook

        if isinstance(x, tuple):
            q, scale = x
            x = (q, _fault_hook("multi_level.step", scale))
        else:
            x = _fault_hook("multi_level.step", x)
        return self._step_fn(x, *self.step_operands())

    def transposed(self) -> Transposed:
        """``Aᵀ`` in this executor's formats, built at the first call
        (``parallel/autograd.py``): symmetric levels (the fold: a
        symmetric operator) reuse the forward operator and pack
        nothing."""
        if self._transposed is None:
            self._transposed = build_transposed(self)
        return self._transposed

    def transposed_step(self, g: torch.Tensor) -> torch.Tensor:
        """``Aᵀ g`` on the f32 carriage, with no autograd: the step's
        routing over the transposed levels, or for the fold K1 over the
        pack of ``Sᵀ`` and one K4 row gather back into carriage order."""
        t = self.transposed()
        if not self.folded:
            return self.raw_step(g, self.fwd, self.bwd, t.blocks)
        if t.sell is None:
            return self.raw_step(g, self.sell)
        return row_gather(sell_spmm_cuda(t.sell, g), t.inv)

    def run(self, x, iterations: int, donate: bool = False):
        """``iterations`` chained steps, past the fault hook (as the
        JAX executor's one-program ``run`` is).  ``donate`` is the
        reference's signature: an eager loop holds each step's input
        only until the next step has read it, whatever its value."""
        del donate
        for _ in range(iterations):
            x = self._step_fn(x, *self.step_operands())
        return x

    # -- the communication contract -----------------------------------------

    def ideal_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Paper cost model for one step at width ``k``: one device
        exchanges nothing (the mesh executor, ``parallel/arrow_layout``,
        prices its routing)."""
        return 0

    def reduce_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """2.5D merge bytes: 0 (the fold's ``repl`` column groups
        concatenate disjoint slabs)."""
        return 0

    def collective_contract(self, k: int, itemsize: int = None):
        """Static communication promise (the JAX executor's, field by
        field): one device issues no collective; the carriage is
        argument 0 of ``run``, which holds each step's input only until
        the next step has read it (``donated_params``); the copy budget
        grows by one 8-copy set per scheduled tier."""
        from arrow_matrix_tpu_torch.analysis.contracts import (
            CollectiveContract,
        )

        if itemsize is None:
            itemsize = self.feature_dtype.itemsize
        repl = getattr(self, "repl", 1)
        slabs = getattr(self, "overlap_slabs", 1)
        schedule = self.kernel_opts.get("schedule") or ()
        return CollectiveContract(
            algorithm="multi_level",
            step_bytes=self.ideal_comm_bytes(k, itemsize),
            reduce_bytes=self.reduce_comm_bytes(k, itemsize),
            repl=repl, overlap_slabs=slabs,
            dtype={torch.float32: "f32", torch.bfloat16: "bf16",
                   torch.int8: "int8"}[self.feature_dtype],
            lowered_kinds=(), compiled_kinds=(),
            ratio_band=(0.25, 4.0),
            donated_params=(0,),
            hot_copy_budget=(16 + 8 * len(schedule)) * slabs,
            h3_exempt=("single-chip fold repl is a column-group "
                       "schedule over ZERO collectives: there is no "
                       "exchange to carry a slab and no merge to price "
                       "(disjoint slabs concatenate)" if repl > 1 else ""),
            notes="flat row-major carriage: the routed a2a moves "
                  "(rows, k) slices, so the ÷c slab law lives in the "
                  "SELL feature-major executors")

    # -- the HBM model -------------------------------------------------------

    def operator_bytes(self) -> int:
        """Device bytes of the resident operator: the SELL tiers
        (column indices and degrees or values) of the fold, or every
        level's blocks and the routing tables."""
        if self.folded:
            return self.sell.device_nbytes()
        return (sum(b.device_nbytes() for b in self.blocks)
                + self.fwd.nbytes + self.bwd.nbytes)

    def kernel_bytes(self, k: int, itemsize: int = 4) -> int:
        """Device bytes of K1 at width ``k`` (fold only, 0 else): its
        work list's tables on the card (kept on the operator) and its
        split-row float32 workspace at this step's slab width (live
        during a launch).  The work list is priced at the widest lane
        layout (32 lanes a row, 8 rows a CTA), which has the most items
        and split rows of any width, so the prices of requests batched
        together cover the batch's own work list."""
        if not self.folded or k <= 0:
            return 0
        cache = self.__dict__.setdefault("_kernel_bytes", {})
        if (k, itemsize) not in cache:
            cache[(k, itemsize)] = self._count_kernel_bytes(k, itemsize)
        return cache[(k, itemsize)]

    def _count_kernel_bytes(self, k: int, itemsize: int) -> int:
        lo, hi = self._model_slabs(k)[0]
        width = hi - lo
        groups = ((None,) if getattr(self, "kernel", "xla") != "pallas_sell"
                  else self.launch_groups(self.feature_dtype))
        total = 0
        for g in groups:
            m = self.sell if g is None else tier_subset(self.sell, g.tiers)
            item = itemsize if g is None or g.carriage is None \
                else g.carriage.itemsize
            # The HBM model's host sizing, once per launch group.
            widest = build_worklist(  # graft-lint: disable=R2
                [tuple(c.shape) for c in m.cols], m.row_starts,
                32 * (16 // item), item,
                opts=LaunchOpts() if g is None else g.opts)
            total += (alloc_bytes(len(m.cols) * 8 * 8)
                      + alloc_bytes(widest.items.nbytes)
                      + alloc_bytes(widest.rows.nbytes)
                      + alloc_bytes(widest.n_parts * width * 4))
            if g is not None and g.carriage is not None:
                # The converted carriage and the launch's own output.
                total += 2 * alloc_bytes(self.total_rows * width * item)
        return total

    def _model_slabs(self, k: int) -> list:
        """The slabs the model prices at width ``k``: the step's, or
        for a width its schedule cannot split (which a server runs on
        its ladder's last rung) the plain step's one."""
        try:
            return self.slabs(k) if k > 0 else [(0, 0)]
        except ValueError:
            return [(0, k)]

    def predicted_hbm_bytes(self, k: int, itemsize: int = 4,
                            repl: int = 1) -> int:
        """Static HBM model of a supervised run at feature width ``k``
        of ``itemsize`` bytes: the operator, K1's work-list tables and
        workspace (:meth:`kernel_bytes`), three carriages of
        ``total_rows x k`` (the entry state kept for rollback, a step's
        input and its output), the finite check's scalars, and under a
        column schedule the slabs' results before their concatenation
        and one slab's copy; each tensor in whole allocator blocks
        (:data:`ALLOC_BLOCK`).
        A width the schedule cannot split is priced as the plain step.
        ``repl`` is the JAX package's planning multiplier: the model
        times ``repl``."""
        rows = self.total_rows
        slabs = self._model_slabs(k)
        carriage = 0
        if k > 0:
            carriage = 3 * alloc_bytes(rows * k * itemsize) \
                + FINITE_CHECK_BYTES
        if len(slabs) > 1:
            width = slabs[0][1] - slabs[0][0]
            carriage += (len(slabs) + 1) * alloc_bytes(
                rows * width * itemsize)
        base = (self.operator_bytes() + self.kernel_bytes(k, itemsize)
                + carriage)
        return base * max(int(repl), 1)

    def carriage_hbm_bytes(self, k: int, itemsize: int = 4,
                           repl: int = 1) -> int:
        """The part of the model that a width ``k`` adds on top of the
        resident operator (``predicted_hbm_bytes(k) -
        predicted_hbm_bytes(0)``): one request's admission price."""
        return (self.predicted_hbm_bytes(k, itemsize, repl)
                - self.predicted_hbm_bytes(0, itemsize, repl))

    def reshard_layout(self, repl: int = 1,
                       tag_base: str = "multi_level"):
        """This executor's carriage as a :class:`~.reshard.Layout`: the
        padded rows in level-0 order (``perm0``) on one device, with the
        JAX package's tag.  ``repl`` is the replica-expanded view of a
        planned 2.5D growth; the fold's column schedule carries one
        copy, so the layout it runs is ``repl=1``."""
        import dataclasses

        from arrow_matrix_tpu_torch.parallel.reshard import (
            Layout,
            layout_tag,
        )

        lay = Layout(total_rows=int(self.total_rows), n_dev=1,
                     repl=max(int(repl), 1))
        return dataclasses.replace(lay, tag=layout_tag(tag_base, lay))

    def shard_report(self) -> dict:
        """Load report over the executor's compute units
        (``obs/imbalance.py`` schema): the SELL tiers of the fold
        ("tier" units), the block rows of the per-level formats
        ("block-row"; a HYB level gives its light and heavy parts)."""
        from arrow_matrix_tpu_torch.obs.imbalance import summarize_units

        rows: list = []
        nnz: list = []
        slots: list = []
        for blk in ([self.sell] if self.folded else self.blocks):
            st = _block_unit_stats(blk)
            rows.extend(int(v) for v in st["rows"])
            nnz.extend(int(v) for v in st["nnz"])
            slots.extend(int(v) for v in st["slots"])
        units = "tier" if self.folded else "block-row"
        return summarize_units(rows, nnz, slots, units=units)

    # -- the packed operator on disk ---------------------------------------

    def export_folded(self, out_dir: str) -> None:
        """Write the packed operator (per-tier SELL arrays, carried
        permutation, meta.json) in the JAX package's directory format,
        so either package's ``load_folded`` reads it."""
        if not self.folded:
            raise ValueError("export_folded requires fmt='fold'")
        os.makedirs(out_dir, exist_ok=True)
        sell = self.sell
        np.save(os.path.join(out_dir, "perm0.npy"), self.perm0)
        for t, cols in enumerate(sell.cols):
            np.save(os.path.join(out_dir, f"cols_{t}.npy"),
                    cols.cpu().numpy())
            if sell.binary:
                np.save(os.path.join(out_dir, f"deg_{t}.npy"),
                        sell.deg[t].cpu().numpy())
            else:
                np.save(os.path.join(out_dir, f"data_{t}.npy"),
                        sell.data[t].cpu().numpy())
        meta = {"n": int(self.n), "total_rows": int(self.total_rows),
                "binary": bool(sell.binary),
                "n_tiers": len(sell.cols),
                "row_starts": [int(s) for s in sell.row_starts],
                "n_slots": int(sell.n_slots),
                "feature_dtype": _META_NAMES.get(self.feature_dtype)}
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)

    @classmethod
    def load_folded(cls, in_dir: str, feature_dtype="keep",
                    device: DeviceLike = None, repl: int = 1,
                    overlap_slabs: int = 1, kernel: str = "xla",
                    kernel_opts: Optional[dict] = None
                    ) -> "MultiLevelArrow":
        """Rebuild a fold executor from an ``export_folded`` directory
        (written by either package) without the decomposition.
        ``feature_dtype="keep"`` uses the exported carriage; ``repl``
        and ``overlap_slabs`` its column schedule; ``kernel`` ("xla" or
        "pallas_sell") and ``kernel_opts`` K1's launches, as in the
        constructor."""
        if kernel not in ("xla", "pallas_sell"):
            raise ValueError(f"a fold runs kernel 'xla' or 'pallas_sell', "
                             f"not {kernel!r}")
        with open(os.path.join(in_dir, "meta.json")) as f:
            meta = json.load(f)
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.kernel, self.tune_plan = kernel, None
        self.kernel_opts = dict(kernel_opts) if kernel_opts else {}
        self.fmt = "fold"
        self.fmts = ["fold"]
        self.folded = True
        self._transposed = None
        if repl < 1 or overlap_slabs < 1:
            raise ValueError("repl and overlap_slabs must be >= 1")
        self.repl, self.overlap_slabs = int(repl), int(overlap_slabs)
        self.n = meta["n"]
        self.total_rows = meta["total_rows"]
        self.binary = meta["binary"]
        self.width = None
        if feature_dtype == "keep":
            feature_dtype = meta["feature_dtype"]
        self.feature_dtype = resolve_feature_dtype(feature_dtype)
        self.perm0 = np.load(os.path.join(in_dir, "perm0.npy"))
        self.inv_perm0 = np.argsort(self.perm0)
        cols, deg, data = [], [], []
        for t in range(meta["n_tiers"]):
            cols.append(np.load(os.path.join(in_dir, f"cols_{t}.npy")))
            if meta["binary"]:
                deg.append(np.load(os.path.join(in_dir, f"deg_{t}.npy")))
            else:
                data.append(np.load(os.path.join(in_dir,
                                                 f"data_{t}.npy")))
        self.sell = sell_from_arrays(
            cols, None if meta["binary"] else data,
            deg if meta["binary"] else None, meta["total_rows"],
            meta["row_starts"], device=self.device)
        self.nnz = (int(sum(int(d.sum()) for d in deg)) if meta["binary"]
                    else int(sum(np.count_nonzero(d) for d in data)))
        self.launch_groups(self.feature_dtype)     # checks every knob
        return self

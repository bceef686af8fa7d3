"""Arrow block layouts on a mesh: the slim and wide steps, and
``MultiLevelArrow(mesh=)``.

The port of ``arrow_matrix_tpu/parallel/arrow_layout.py`` and of the mesh
parts of ``parallel/multi_level.py``, one process a shard
(``parallel/mesh.py``).  One level's block rows are split in contiguous
shares over the ``blocks`` axis; each rank packs only its own (and the
head blocks ``A_0b`` of its block columns), as dense ``(w, w)`` blocks
or block-local ELL, exactly as ``ops/arrow_blocks.py`` packs them.

**Slim step** (:func:`slim_block_step`): X_0 broadcast from the first
rank; the head partial ``sum_b A_0b X_b`` over the rank's blocks (K3
for dense blocks, K1 for ELL), summed on the first rank in rank order;
for banded levels the edge blocks of the neighbours (one hop each way,
the chain ends zero); the rank's column blocks ``C_b = A_bb X_b + A_b0
X_0 [+ A_b,b-1 X_b-1 + A_b,b+1 X_b+1]`` (K2 for dense blocks, K1 for
ELL stacks); the first rank writes C_0 over its first block.

K2 multiplies ``X_0`` from block 0 of its operand and a block's
neighbours from the blocks beside it, so a rank's operand is extended
to ``[X_0; X_prev; own blocks; X_next]`` (``[X_0; own blocks]`` block
diagonal), one ``torch.cat`` a level, and K2 runs over the operand's
block rows of the rank's own blocks (``column_rows_spmm``): the stacks
hold those blocks only.  The first rank's first block is the head
row's, so its stacks start at its second; the last rank's last block
has no right neighbour, so its K2 operand ends before ``X_next``.  ELL
stacks run as K1 tiers over the same extended operand, each block's
columns shifted to its operand block (``ops/ell.py:ell_stack_tier``).

**Wide step** (:func:`wide_block_step`, a ``(arm=2, blocks)`` mesh):
arm 0 ranks compute the column blocks, arm 1 ranks the head partials;
the head reduction runs over the whole mesh; arm 0's result is then
broadcast to arm 1 so the carriage stays replicated over the arm axis.

``MultiLevelArrow(mesh=)`` (:class:`MeshMultiLevelArrow`) carries X
row-major ``(total_rows / P, k)`` a rank in level-0 order (each level
views it as ``(nb_i / P, w_i, k)``), routes it between levels by
all-gather and K4 (``routing="gather"``) or by the a2a tables (K4 pack,
all-to-all, K4 unpack), and aggregates backward in the JAX order.  Its
step is differentiable: the backward is the same step over each rank's
shards of the transposed levels (``parallel/autograd.py``), packed by
the forward's shard packer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from arrow_matrix_tpu_torch.io.graphio import (
    num_nonzeros,
    num_rows,
    number_of_blocks,
)
from arrow_matrix_tpu_torch.ops.arrow_blocks import (
    ArrowBlocks,
    block_row_stats,
    head_stats,
    choose_flat_head_from_stats,
    load_stack_blocks,
    resolve_block_dtype,
    resolve_blocks_binary,
    stack_coords,
)
from arrow_matrix_tpu_torch.ops.cuda_blocks import (
    column_rows_spmm,
    head_spmm,
)
from arrow_matrix_tpu_torch.ops.cuda_ell import flat_head_operator, one_tier
from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
from arrow_matrix_tpu_torch.ops.ell import (
    block_index_dtype,
    dense_pack_stack,
    ell_pack_stack,
    ell_pack_stack_binary,
    ell_stack_tier,
    flat_pack_stack,
)
from arrow_matrix_tpu_torch.ops.sell import nbytes_of
from arrow_matrix_tpu_torch.parallel import collectives as coll
from arrow_matrix_tpu_torch.parallel.mesh import Mesh, fetch_replicated
from arrow_matrix_tpu_torch.parallel.multi_level import MultiLevelArrow

COLUMN_STACKS = ("diag", "col", "lo", "hi")


@dataclass
class ShardBlocks:
    """One level's share of a rank (module docstring).

    ``first`` is the operand position of the rank's first block (1
    block-diagonal, 2 banded) and ``ext`` the operand's block count;
    ``skip`` is 1 on the first rank (its first block is the head row's)
    and ``last`` marks the last rank.  Dense: ``head`` ``(nb_local, w,
    w)`` and the column stacks ``(nb_local - skip, w, w)`` (the rank's
    blocks after the skipped one) in ``stacks``.  ELL: ``ops`` holds the K1 operators
    of the column stacks over the extended operand, "head" over the
    rank's own rows (per-block ELL, summed over blocks after the
    product, or flat with "head_inv" to put its rows in order)."""

    fmt: str
    width: int
    banded: bool
    nb_local: int
    first: int
    ext: int
    skip: int = 0
    last: bool = False
    head_flat: bool = False
    stacks: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)
    captured: int = 0

    def device_nbytes(self) -> int:
        return nbytes_of(*self.stacks.values(), *self.ops.values())

    @property
    def column_rows(self) -> int:
        """Block rows K2 computes on this rank (dense)."""
        return self.nb_local - self.skip

    @property
    def column_operand(self) -> int:
        """Blocks of the operand K2 reads: the extended operand, less
        ``X_next`` on the last rank of a banded level."""
        return self.ext - int(self.banded and self.last)


def build_shard_blocks(matrix, width: int, nb_padded: int, d: int,
                       n_dev: int, banded: bool, dtype, fmt: str,
                       head_flat: bool, binary: bool,
                       device) -> ShardBlocks:
    """Rank ``d``'s share of one level on ``device``: its block rows
    ``[d nb/P, (d + 1) nb/P)`` and the head blocks of those block
    columns, packed as ``ops/arrow_blocks.py`` packs them.  Only those
    blocks are read (``ops/arrow_blocks.load_stack_blocks``, the streamed
    pack's loader), from a CSR or a memmapped triplet alike; each
    stack's ELL slots are the rank's own longest row (the K1 operators
    need no global budget, unlike ``arrow_blocks_streamed``'s arrays)."""
    dev = torch.device(device)
    dtype = resolve_block_dtype(dtype)
    nb = number_of_blocks(matrix, width)
    if nb_padded % n_dev:
        raise ValueError(f"{nb_padded} blocks not divisible by {n_dev} "
                         f"devices")
    nb_l = nb_padded // n_dev
    b0 = d * nb_l
    first = 2 if banded else 1
    ext = nb_l + (3 if banded else 1)
    coords = stack_coords(nb, nb_padded, banded)
    sb = ShardBlocks(fmt=fmt, width=width, banded=banded, nb_local=nb_l,
                     first=first, ext=ext, skip=int(d == 0),
                     last=d == n_dev - 1, head_flat=head_flat)

    mine = {name: load_stack_blocks(matrix, width,
                                    coords[name][b0:b0 + nb_l])
            for name in ("head",) + COLUMN_STACKS if name in coords}
    sb.captured = sum(b.nnz for mats in mine.values() for b in mats
                      if b is not None)
    if fmt == "dense":
        sb.stacks["head"] = dense_pack_stack(mine["head"], dtype=dtype,
                                             rows=width, device=dev)
        for name in COLUMN_STACKS:
            if name in mine:
                sb.stacks[name] = dense_pack_stack(
                    mine[name][sb.skip:], dtype=dtype, rows=width,
                    device=dev)
        return sb

    idt = block_index_dtype(width)

    def tier_op(mats, offsets, x_rows):
        if binary:
            cols, deg = ell_pack_stack_binary(mats, rows=width,
                                              index_dtype=idt)
            data = None
        else:
            cols, data = ell_pack_stack(mats, rows=width, index_dtype=idt)
            data = torch.from_numpy(data).to(dtype).to(dev)
            deg = None
        t = ell_stack_tier(torch.from_numpy(cols).to(dev),
                           torch.as_tensor(offsets, dtype=torch.int64),
                           data=data,
                           deg=None if deg is None
                           else torch.from_numpy(deg).to(dev))
        return one_tier(*t, x_rows=x_rows)

    own = np.arange(nb_l, dtype=np.int64)
    shift = {"diag": 0, "lo": -1, "hi": 1}
    for name in COLUMN_STACKS:
        if name in mine:
            offsets = (np.zeros(nb_l, np.int64) if name == "col"
                       else (first + own + shift[name]) * width)
            sb.ops[name] = tier_op(mine[name], offsets, ext * width)
    if head_flat:
        rows, cols, data = flat_pack_stack(mine["head"], rows=width,
                                           index_dtype=idt)
        local = ArrowBlocks(
            head_rows=torch.from_numpy(rows).to(dev),
            head_cols=torch.from_numpy(cols).to(dev),
            head_data=None if binary
            else torch.from_numpy(data).to(dtype).to(dev),
            width=width, n_blocks=nb_l, fmt="ell", head_flat=True)
        sb.ops["head"], sb.ops["head_inv"] = flat_head_operator(local)
    else:
        sb.ops["head"] = tier_op(mine["head"], own * width, nb_l * width)
    return sb


def head_partial(sb: ShardBlocks, x: torch.Tensor) -> torch.Tensor:
    """``sum_b A_0b X_b`` over the rank's blocks: x ``(nb_local * w, k)``
    -> ``(w, k)`` f32 (K3 dense, K1 ELL)."""
    w, k = sb.width, x.shape[1]
    if sb.fmt == "dense":
        return head_spmm(sb.stacks["head"], x.view(sb.nb_local, w, k))
    h = sell_spmm_cuda(sb.ops["head"], x)
    if sb.head_flat:
        return row_gather(h, sb.ops["head_inv"])
    return h.view(sb.nb_local, w, k).sum(dim=0)


def column_blocks(sb: ShardBlocks, x_ext: torch.Tensor) -> torch.Tensor:
    """The rank's column blocks from the extended operand ``(ext, w,
    k)`` -> ``(nb_local * w, k)`` f32 (K2 dense, K1 ELL)."""
    w, k = sb.width, x_ext.shape[2]
    if sb.fmt == "dense":
        s = sb.stacks
        c = x_ext.new_empty((sb.nb_local, w, k))
        if sb.skip:
            c[0].zero_()       # the head row's: the first rank writes C_0
        if sb.column_rows:
            column_rows_spmm(s["diag"], s["col"],
                             x_ext[:sb.column_operand], sb.first + sb.skip,
                             s.get("lo"), s.get("hi"), out=c[sb.skip:])
        return c.view(sb.nb_local * w, k)
    flat = x_ext.reshape(sb.ext * w, k)
    c = sell_spmm_cuda(sb.ops["diag"], flat)
    for name in COLUMN_STACKS[1:]:
        if name in sb.ops:
            c += sell_spmm_cuda(sb.ops[name], flat)
    return c


def _extended(sb: ShardBlocks, xb: torch.Tensor, x0: torch.Tensor,
              mesh: Mesh, axis: str) -> torch.Tensor:
    """``[X_0; X_prev; own; X_next]`` (banded; ``[X_0; own]`` else)."""
    if not sb.banded:
        return torch.cat([x0[None], xb])
    w, k = sb.width, xb.shape[2]
    from_prev, from_next = coll.shift(xb[-1], xb[0], mesh, axis, (w, k),
                                      (w, k), xb.dtype)
    return torch.cat([x0[None], from_prev[None], xb, from_next[None]])


def _x0(xb: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    first = mesh.axis_index(axis) == 0
    x0 = xb[0].clone() if first else xb.new_empty(xb.shape[1:])
    return coll.broadcast(x0, mesh, axis)


def slim_block_step(sb: ShardBlocks, x: torch.Tensor, mesh: Mesh,
                    axis: str) -> torch.Tensor:
    """One level's slim step on this rank: ``x`` its ``(nb_local * w,
    k)`` rows -> the same rows of ``A x``."""
    w, k = sb.width, x.shape[1]
    x = x.contiguous()
    xb = x.view(sb.nb_local, w, k)
    x0 = _x0(xb, mesh, axis)
    c0 = coll.reduce_to_first(head_partial(sb, x), mesh, axis)
    c = column_blocks(sb, _extended(sb, xb, x0, mesh, axis))
    if c0 is not None:
        c[:w] = c0
    return c


def wide_block_step(sb: ShardBlocks, x: torch.Tensor, mesh: Mesh,
                    arm_axis: str, block_axis: str) -> torch.Tensor:
    """One level's wide step on this rank of a ``(arm=2, blocks)`` mesh
    (module docstring): arm 0 the column blocks, arm 1 the head
    partials, the reduction over the whole mesh, arm 0's rows broadcast
    to arm 1."""
    w, k = sb.width, x.shape[1]
    x = x.contiguous()
    xb = x.view(sb.nb_local, w, k)
    column_arm = mesh.axis_index(arm_axis) == 0
    x0 = _x0(xb, mesh, block_axis)
    part = (head_partial(sb, x) if not column_arm
            else x.new_zeros((w, k)))
    c0 = coll.reduce_to_first(part, mesh, None)
    if column_arm:
        c = column_blocks(sb, _extended(sb, xb, x0, mesh, block_axis))
        if c0 is not None:
            c[:w] = c0
    else:
        c = x.new_empty(x.shape)
    return coll.broadcast(c, mesh, arm_axis)


def shard_launch_counts(sb: ShardBlocks, k: int, role: str = "slim"
                        ) -> dict:
    """Kernel launches of one level's step on this rank on the card:
    "K2"/"K3" (dense) or "K1" (ELL: each stack and the head, 1 or 2 a
    product) and "K4" (a flat head's unsort); ``role`` "column" or
    "head" for a wide rank."""
    from arrow_matrix_tpu_torch.parallel.sell_slim import k1_launches

    out = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    col, head = role in ("slim", "column"), role in ("slim", "head")
    if sb.fmt == "dense":
        out["K2"] += int(col and sb.column_rows > 0)
        out["K3"] += int(head)
        return out
    if col:
        out["K1"] += sum(k1_launches(sb.ops[n], k, torch.float32)
                         for n in COLUMN_STACKS if n in sb.ops)
    if head:
        out["K1"] += k1_launches(sb.ops["head"], k, torch.float32)
        out["K4"] += int(sb.head_flat)
    return out


def arrow_blocks_shard_report(blocks: ArrowBlocks,
                              n_dev: Optional[int] = None) -> dict:
    """Load report of one arrow level under the contiguous block-row
    sharding (``obs/imbalance.py`` schema).  With ``n_dev`` the block
    rows add up into the equal contiguous shares the ranks hold, so the
    max/mean ratio is the ranks' compute skew; without it each unit is
    one block row (the paper's imbalance bound: the block width caps
    every unit)."""
    from arrow_matrix_tpu_torch.obs.imbalance import summarize_units

    st = block_row_stats(blocks)
    rows, nnz, slots = st["rows"], st["nnz"], st["slots"]
    units = "block-row"
    if n_dev and n_dev > 1:
        per = -(-len(nnz) // n_dev)

        def agg(a):
            a = np.asarray(a, dtype=np.int64)
            return [int(a[d * per:(d + 1) * per].sum())
                    for d in range(n_dev)]

        rows, nnz, slots = agg(rows), agg(nnz), agg(slots)
        units = "device"
    return summarize_units(rows, nnz, slots, units=units)


def check_mesh_options(mesh, fmt: str, routing: str, layout: str,
                       head_fmt: str, repl: int, kernel: str,
                       arm_axis: str) -> None:
    """The JAX ``MultiLevelArrow``'s ``ValueError``s for options that do
    not go together with (or without) a mesh, word for word."""
    if routing not in ("gather", "a2a"):
        raise ValueError(f"unknown routing {routing!r}")
    if head_fmt == "gell" and mesh is not None:
        raise ValueError(
            "head_fmt='gell' is the single-chip head layout (its "
            "gather reads the whole feature array); use 'flat', "
            "'ell' or 'auto' on a mesh")
    if fmt in ("hyb", "fold") and mesh is not None:
        raise ValueError(
            f"fmt={fmt!r} is a single-chip whole-level kernel (the "
            "arrow block structure exists to shape communication; "
            "within one chip a general split-ELL SpMM replaces it, "
            "the way the reference's per-rank cuSPARSE CSRMM does "
            "— sp2cp.py:6-16); use 'auto'/'dense'/'ell' on a mesh")
    if routing == "a2a" and mesh is None:
        raise ValueError("routing='a2a' requires a mesh")
    if layout not in ("slim", "wide"):
        raise ValueError(f"unknown layout {layout!r} "
                         f"(expected 'slim' or 'wide')")
    if layout == "wide":
        if mesh is None:
            raise ValueError(
                "layout='wide' needs a (arm=2, blocks) mesh — the "
                "reference's 2t-1-rank row/column split "
                "(arrow_mpi.py:31-69); on one chip use 'slim'")
        if arm_axis not in mesh.axis_names \
                or mesh.shape[arm_axis] != 2:
            raise ValueError(
                f"layout='wide' needs mesh axis {arm_axis!r} of "
                f"size 2, got axes {dict(mesh.shape)}")
        if kernel == "pallas":
            raise ValueError(
                "layout='wide' runs the XLA shard_map step; the "
                "fused pallas kernels cover the slim layout")
        if routing == "a2a":
            raise ValueError(
                "layout='wide' composes with routing='gather' (the "
                "a2a tables are built for the 1-axis slim feature "
                "sharding)")
    if repl > 1 and mesh is not None:
        raise ValueError(
            "repl>1 on a mesh is the SellMultiLevel/SellSlim "
            "repl_axis mode (build the mesh with make_repl_mesh); "
            "MultiLevelArrow supports repl on the single-chip "
            "fold path only")


def _single_device(name: str):
    """A member of the single-device executor with no mesh form: it
    raises, naming the single-device fold it belongs to."""
    def refuse(*args, **kwargs):
        raise ValueError(
            f"MultiLevelArrow(mesh=).{name} belongs to the single-device "
            f"executor (the fold and its one-device packing); a mesh "
            f"packs each rank's shards (pack_transposed) and steps them "
            f"with collectives")
    refuse.__name__ = name
    return refuse


class MeshMultiLevelArrow(MultiLevelArrow):
    """``MultiLevelArrow(levels, width, mesh=...)``: a decomposition on a
    mesh of ranks (module docstring).  Every rank builds it from the
    same levels and packs its own shards; ``set_features`` takes the
    global host array and keeps this rank's rows, ``step``/``run`` run
    the local steps and their collectives, and ``gather_result`` returns
    the global result on every rank.  The step is differentiable as on
    one device (``parallel/autograd.py:StepFunction``: its collectives
    run inside the Function, its backward is :meth:`transposed_step`
    over this rank's transposed shards and the same routing)."""

    def __init__(self, levels, width: int, *, mesh, axis: str = "blocks",
                 banded: bool = False, dtype=np.float32, chunk="auto",
                 fmt: str = "auto", dense_budget=None, kernel: str = "xla",
                 routing: str = "gather", head_fmt: str = "auto",
                 binary="auto", feature_dtype=None, layout: str = "slim",
                 arm_axis: str = "arm", fold_growth: float = 1.2,
                 fold_align=None, overlap_slabs: int = 1, repl: int = 1,
                 plan=None, plan_k=None, kernel_opts=None,
                 exchange_scratch_budget: int = 0, exchange_k=None,
                 device=None):
        import warnings

        from arrow_matrix_tpu_torch.parallel.multi_level import (
            compose_routing,
            pad_permutation,
            pad_to_multiple,
            resolve_feature_dtype,
            resolve_levels_binary,
        )
        from arrow_matrix_tpu_torch.parallel.routing import (
            build_route,
            gather_table,
            shard_route,
            shard_staged,
            split_route_stages,
        )
        from arrow_matrix_tpu_torch.utils import commstats
        from arrow_matrix_tpu_torch.utils.platform import (
            device_memory_budget,
        )

        del chunk, fold_growth, fold_align, kernel_opts, device
        if not levels:
            raise ValueError("empty decomposition")
        self.tune_plan = None
        self.kernel_opts = {}
        if plan is not None:
            warnings.warn(
                "tune plans target the single-chip fold path; "
                "ignoring plan= on a mesh "
                "(SellSlim/SellMultiLevel consume plans for the "
                "mesh executors)", UserWarning, stacklevel=2)
        dtype = resolve_block_dtype(dtype)
        if feature_dtype is not None and fmt != "fold":
            raise ValueError(
                "feature_dtype is implemented for fmt='fold' (the "
                "single-chip headline path); other formats carry f32")
        check_mesh_options(mesh, fmt, routing, layout, head_fmt, repl,
                           kernel, arm_axis)
        if fmt not in ("auto", "dense", "ell"):
            raise ValueError(f"unknown fmt {fmt!r}")
        self.exchange_scratch_budget = int(exchange_scratch_budget)
        self._exchange_k = exchange_k if exchange_k is not None else plan_k
        if self.exchange_scratch_budget > 0:
            if routing != "a2a":
                raise ValueError(
                    "exchange_scratch_budget bounds the explicit a2a "
                    "exchange; routing='gather' leaves the exchange to "
                    "GSPMD where no budget can be enforced")
            if self._exchange_k is None:
                raise ValueError(
                    "exchange_scratch_budget needs the feature width to "
                    "size stages — pass exchange_k (or plan_k)")
        if kernel not in ("xla", "pallas", "pallas_sell"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if kernel == "pallas_sell":
            raise ValueError(
                "kernel='pallas_sell' is the fused fold kernel (K1 with "
                "kernel_opts, ops/cuda_sell.py); it requires fmt='fold'")
        if overlap_slabs < 1:
            raise ValueError(f"overlap_slabs must be >= 1, got "
                             f"{overlap_slabs}")
        self.mesh, self.axis, self.arm_axis = mesh, axis, arm_axis
        self.layout, self.routing, self.kernel = layout, routing, kernel
        self.overlap_slabs, self.repl = int(overlap_slabs), 1
        self.feature_dtype = resolve_feature_dtype(None)
        self.device = mesh.device
        self.width, self.banded, self.chunk = width, banded, "auto"
        self.folded = False
        self._transposed = None
        self.head_fmt = head_fmt
        self._matrices = [lvl.matrix for lvl in levels]
        self.n = num_rows(levels[0].matrix)
        n_dev = mesh.shape[axis]
        if dense_budget is None:
            dense_budget = device_memory_budget(mesh.device) * n_dev
        self.dense_budget = int(dense_budget)

        widths, bandeds = [], []
        for i, lvl in enumerate(levels):
            if lvl.arrow_width > width or i == len(levels) - 1:
                widths.append(-(-lvl.arrow_width // width) * width)
                bandeds.append(True)
            else:
                widths.append(width)
                bandeds.append(banded)
        self.widths, self.bandeds = widths, bandeds
        max_rows = max(number_of_blocks(lvl.matrix, w) * w
                       for lvl, w in zip(levels, widths))
        self.total_rows = pad_to_multiple(max_rows, n_dev * max(widths))
        self.rows_local = self.total_rows // n_dev
        self.binary = resolve_levels_binary(levels, binary)
        self.dtype = dtype
        self.fmt = fmt
        self.fmts = self._level_formats(bandeds, dtype.itemsize)
        if kernel == "pallas" and "dense" not in self.fmts:
            raise ValueError(
                "kernel='pallas' but no level resolved to the dense block "
                "format (the pallas kernels cover dense only; raise "
                "dense_budget or pass fmt='dense')")
        self.nnz = sum(num_nonzeros(lvl.matrix) for lvl in levels)
        self.perm0 = pad_permutation(np.asarray(levels[0].permutation),
                                     self.total_rows)
        self.inv_perm0 = np.argsort(self.perm0)
        self.blocks = []
        self._packing = []
        if not mesh.member:
            # A rank outside the mesh holds no shard: it keeps the
            # carriage's layout (reshard_layout, perm0) and nothing else.
            self.fwd, self.bwd, self._ideal_route_units = [], [], 0
            return
        d = mesh.axis_index(axis)
        # Each level's global packing (width, padded blocks, banded, fmt,
        # flat head, binary): what its load report counts.
        captured = 0
        for lvl, w, bd, f in zip(levels, widths, bandeds, self.fmts):
            nb_pad = self.total_rows // w
            flat = False
            if f == "ell":
                max_row, max_nnz = head_stats(
                    lvl.matrix, w, number_of_blocks(lvl.matrix, w))
                flat = choose_flat_head_from_stats(
                    nb_pad, w, max_row, max_nnz, dtype, head_fmt)
            is_bin = (f == "ell"
                      and resolve_blocks_binary(lvl.matrix, f, self.binary))
            sb = build_shard_blocks(lvl.matrix, w, nb_pad, d, n_dev, bd,
                                    dtype, f, flat, is_bin, mesh.device)
            self._packing.append((w, nb_pad, bd, f, flat, is_bin))
            captured += sb.captured
            self.blocks.append(sb)
        # The tiling must capture every nonzero: the ranks' counts add up.
        got = coll.all_reduce_int_sum(captured, mesh, axis)
        if got != self.nnz:
            raise ValueError(
                f"arrow tiling captured {got} of {self.nnz} "
                f"nonzeros: a level has entries outside its arrow "
                f"pattern")
        fwd, bwd = compose_routing([lvl.permutation for lvl in levels],
                                   self.total_rows)
        padded = [pad_permutation(np.asarray(lvl.permutation),
                                  self.total_rows) for lvl in levels]
        self._ideal_route_units = commstats.ideal_routing_bytes(
            padded, n_dev, 1, itemsize=1)

        def compile_route(t):
            if routing == "gather":
                return gather_table(t, mesh, axis)
            r = build_route(t, n_dev)
            if self.exchange_scratch_budget > 0:
                return shard_staged(split_route_stages(
                    r, int(self._exchange_k),
                    self.exchange_scratch_budget), mesh, axis)
            return shard_route(r, mesh, axis)

        self.fwd = [compile_route(t) for t in fwd]
        self.bwd = [compile_route(t) for t in bwd]

    # The single-device fold's members have no mesh form;
    # ``export_folded`` refuses as the JAX package's does (the level
    # formats have no packed operator on disk).
    pack_level = _single_device("pack_level")
    launch_groups = _single_device("launch_groups")
    fold_product = _single_device("fold_product")

    @staticmethod
    def load_folded(in_dir: str, **kwargs) -> MultiLevelArrow:
        """The single-device fold of an ``export_folded`` directory (a
        packed fold has no mesh form)."""
        return MultiLevelArrow.load_folded(in_dir, **kwargs)

    def reshard_layout(self, repl: int = 1,
                       tag_base: str = "multi_level"):
        """This executor's carriage as a :class:`~.reshard.Layout`: the
        padded rows in level-0 order, sharded over the mesh's block
        axis, with the JAX package's tag (``layout_tag``)."""
        from arrow_matrix_tpu_torch.parallel.reshard import (
            Layout,
            layout_tag,
        )

        lay = Layout(total_rows=int(self.total_rows),
                     n_dev=int(self.mesh.shape[self.axis]),
                     repl=max(int(repl), 1))
        return dataclasses.replace(lay, tag=layout_tag(tag_base, lay))

    def level_matrices(self) -> list:
        """Each level's global matrix, which every rank holds."""
        return self._matrices

    def pack_transposed(self, i: int, matrix) -> ShardBlocks:
        """This rank's share of ``matrix`` (level ``i``'s transpose) in
        the level's format, width, tiling and layout; an ELL head laid
        out flat or per block by the forward's rule, applied to
        ``matrix``."""
        sb = self.blocks[i]
        w = self.widths[i]
        nb_pad = self.total_rows // w
        flat = False
        if sb.fmt == "ell":
            max_row, max_nnz = head_stats(matrix, w,
                                          number_of_blocks(matrix, w))
            flat = choose_flat_head_from_stats(
                nb_pad, w, max_row, max_nnz, self.dtype, self.head_fmt)
        is_bin = (sb.fmt == "ell"
                  and resolve_blocks_binary(matrix, sb.fmt, self.binary))
        return build_shard_blocks(matrix, w, nb_pad,
                                  self.mesh.axis_index(self.axis),
                                  self.mesh.shape[self.axis], sb.banded,
                                  self.dtype, sb.fmt, flat, is_bin,
                                  self.mesh.device)

    def reduce_axes(self) -> tuple:
        """The mesh axes a whole-carriage reduction sums over: the block
        axis (the wide layout's carriage is a copy on each arm)."""
        return (self.axis,)

    def head_layouts(self) -> list:
        """Each level's head layout on this rank: "flat" or "ell" for an
        ELL level, None for a dense one."""
        return [None if b.fmt != "ell" else "flat" if b.head_flat
                else "ell" for b in self.blocks]

    def set_features(self, x_original: np.ndarray) -> torch.Tensor:
        """Host (n, k) original order -> this rank's ``(total_rows / P,
        k)`` f32 rows of the level-0 ordered carriage on its device."""
        x_original = np.asarray(x_original)
        n, k = x_original.shape
        if n != self.n:
            raise ValueError(f"expected {self.n} rows, got {n}")
        d = self.mesh.axis_index(self.axis)
        R = self.rows_local
        rows = self.perm0[d * R:(d + 1) * R]
        feat = np.zeros((R, k), dtype=np.float32)
        live = rows < n
        feat[live] = x_original[rows[live]]
        return torch.from_numpy(feat).to(self.mesh.device)

    def gather_result(self, c: torch.Tensor) -> np.ndarray:
        """This rank's rows -> the global host (n, k) f32 result in
        original order, on every rank (one all-gather)."""
        full = fetch_replicated(c.float(), self.mesh, self.axis)
        return full[self.inv_perm0][:self.n]

    def _level(self, sb: ShardBlocks, x: torch.Tensor) -> torch.Tensor:
        if self.layout == "wide":
            return wide_block_step(sb, x, self.mesh, self.arm_axis,
                                   self.axis)
        return slim_block_step(sb, x, self.mesh, self.axis)

    def raw_step(self, x, fwd, bwd, blocks) -> torch.Tensor:
        """The step's kernels and collectives on this rank's rows, over
        ``blocks`` (the forward shards, or the transposed ones)."""
        from arrow_matrix_tpu_torch.parallel.multi_level import by_slabs
        from arrow_matrix_tpu_torch.parallel.routing import take

        def one(xs):
            partials = []
            x_cur = xs
            for i, sb in enumerate(blocks):
                if i > 0:
                    x_cur = take(x_cur, fwd[i - 1], self.mesh, self.axis)
                partials.append(self._level(sb, x_cur))
            agg = partials[-1]
            for i in range(len(blocks) - 1, 0, -1):
                agg = take(agg, bwd[i - 1], self.mesh, self.axis,
                           add_to=partials[i - 1])
            return agg

        return by_slabs(one, x.contiguous(), self.slabs(x.shape[1]))

    def step_operands(self) -> tuple:
        return (self.fwd, self.bwd, self.blocks)

    def launch_counts(self, k: int, transposed: bool = False) -> dict:
        """Kernel launches of one step (``transposed``: of one transposed
        step) on this rank at width ``k`` on the card: K1, K2, K3, "K4"
        (gathers) and "K4 add" (backward unpacks)."""
        from arrow_matrix_tpu_torch.parallel.routing import RankRoute

        slabs = self.slabs(k)
        ks = slabs[0][1] - slabs[0][0]
        role = "slim"
        if self.layout == "wide":
            role = "column" if self.mesh.axis_index(self.arm_axis) == 0 \
                else "head"
        out = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K4 add": 0}
        blocks = self.transposed().blocks if transposed else self.blocks
        for sb in blocks:
            for name, v in shard_launch_counts(sb, ks, role).items():
                out[name] += v
        for r in self.fwd + self.bwd:
            if isinstance(r, RankRoute):
                out["K4"] += int(r.slots > 0)
        out["K4"] += len(self.fwd)
        out["K4 add"] += len(self.bwd)
        return {name: v * len(slabs) for name, v in out.items()}

    def ideal_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Paper cost model, the JAX package's: the routed rows that
        change device, both directions (the levels' O(width) head
        exchanges are counted by the collective layer, not modelled)."""
        return self._ideal_route_units * k * itemsize

    def reduce_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        return 0

    def collective_contract(self, k: int, itemsize: int = 4):
        """Static communication promise: the routed exchanges
        (all-to-all; all-gather under ``routing="gather"``), each
        level's head reduction (a gather to rank 0), X_0 broadcast and
        halos.  The band is the JAX executor's under a2a; the gather
        routing all-gathers the whole carriage and has a wider one.
        ``run`` holds each step's input only until the next step has
        read it (``donated_params``)."""
        from arrow_matrix_tpu_torch.analysis.contracts import (
            CollectiveContract,
        )

        route = "all-to-all" if self.routing == "a2a" else "all-gather"
        kinds = (route, "gather", "broadcast", "collective-permute")
        return CollectiveContract(
            algorithm="multi_level",
            step_bytes=self.ideal_comm_bytes(k, itemsize),
            reduce_bytes=0, repl=1, overlap_slabs=self.overlap_slabs,
            dtype="f32", lowered_kinds=kinds, compiled_kinds=kinds,
            ratio_band=(0.25, 4.0) if self.routing == "a2a"
            else (0.25, 64.0),
            donated_params=(0,),
            hot_copy_budget=16 * self.overlap_slabs,
            notes="flat row-major carriage: the routed a2a moves "
                  "(rows, k) slices, so the ÷c slab law lives in the "
                  "SELL feature-major executors")

    def operator_bytes(self) -> int:
        """Device bytes of this rank's blocks and route tables."""
        tables = 0
        for r in self.fwd + self.bwd:
            for name in ("send", "unpack", "idx"):
                t = getattr(r, name, None)
                if t is not None:
                    tables += t.numel() * t.element_size()
        return sum(b.device_nbytes() for b in self.blocks) + tables

    def exchange_scratch_bytes(self, k: int, itemsize: int = 4) -> int:
        """Peak send + receive scratch of one routing exchange at width
        ``k`` on this rank: a one-shot exchange holds its padded send
        payload and the received copy at once; a :class:`~arrow_matrix_
        tpu_torch.parallel.routing.StagedRoute` bounds it to one stage's.
        Zero under ``routing="gather"`` (the all-gather's buffer is
        judged by ``obs/comm``, not priced here) and with no exchange
        (one rank: every row is local)."""
        if self.routing != "a2a" or not self.fwd:
            return 0
        return max(2 * r.device_bytes_per_exchange(k, itemsize)
                   for r in self.fwd + self.bwd)

    def predicted_hbm_bytes(self, k: int, itemsize: int = 4,
                            repl: int = 1) -> int:
        """This rank's blocks and route tables, its carried input and
        output at width ``k``, and the peak exchange scratch
        (:meth:`exchange_scratch_bytes`)."""
        if not self.mesh.member:
            return 0
        base = (self.operator_bytes() + 2 * self.rows_local * k * itemsize
                + self.exchange_scratch_bytes(k, itemsize))
        return base * max(int(repl), 1)

    def carriage_hbm_bytes(self, k: int, itemsize: int = 4,
                           repl: int = 1) -> int:
        """What a width ``k`` adds to this rank's model: one request's
        admission price on this rank."""
        return (self.predicted_hbm_bytes(k, itemsize, repl)
                - self.predicted_hbm_bytes(0, itemsize, repl))

    def shard_report(self) -> dict:
        """Load report over the block rows of every level (the JAX
        package's units, ``obs/imbalance.py`` schema), counted from each
        level's CSR as its global packing would hold it, without packing
        it: the same on every rank, with no collective."""
        from arrow_matrix_tpu_torch.obs.imbalance import summarize_units
        from arrow_matrix_tpu_torch.ops.arrow_blocks import (
            block_row_stats_from_csr,
        )

        rows: list = []
        nnz: list = []
        slots: list = []
        for m, (w, nb_pad, bd, f, flat, is_bin) in zip(self._matrices,
                                                      self._packing):
            st = block_row_stats_from_csr(
                m, w, banded=bd, pad_blocks_to=nb_pad, fmt=f,
                head_flat=flat, binary=is_bin, dtype=self.dtype)
            rows.extend(int(v) for v in st["rows"])
            nnz.extend(int(v) for v in st["nnz"])
            slots.extend(int(v) for v in st["slots"])
        return summarize_units(rows, nnz, slots, units="block-row")

    def real_row_mask(self, dtype=np.float32) -> torch.Tensor:
        """(total_rows / P, 1) mask of this rank's rows: 1 for rows
        backed by an original matrix row."""
        d = self.mesh.axis_index(self.axis)
        R = self.rows_local
        m = (self.perm0[d * R:(d + 1) * R] < self.n).astype(dtype)[:, None]
        return torch.from_numpy(m).to(self.mesh.device)

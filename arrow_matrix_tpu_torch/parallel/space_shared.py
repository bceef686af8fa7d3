"""Space-shared multi-matrix execution: K levels on disjoint rank groups.

The port of ``arrow_matrix_tpu/parallel/space_shared.py``, one process a
shard (``parallel/mesh.py``).  The K arrow matrices of one decomposition
run at once on disjoint groups of ranks, the reference's per-matrix
communicators (arrow/arrow_dec_mpi.py:106-177): the mesh is ``("lvl",
"blocks")``, one ``lvl`` slice per level, and ``blocks`` splits a
level's block rows within its group.  Rank ``(g, d)`` packs only level
g's share d.

All levels are tiled at ONE banded block width (the largest level width,
rounded up to a multiple of the base width), so every level has the
layout of the JAX package's stacked ``(K, nb, w, ...)`` blocks
(:func:`stack_arrow_blocks` builds that stack on the host).  A level's
step on its group is the slim banded step of ``parallel/arrow_layout.py``
(K2/K3 for ``fmt="dense"``, K1 for ``"ell"``).

**The exchanges.**  The reference's chains of K-1 backward and forward
hops collapse to composed tables, as in the JAX package:
``bwd0[g] = inv(σ_g)[σ_0]`` takes level g's partial into level-0 order
and ``fwd0[g] = inv(σ_0)[σ_g]`` takes the aggregate into level g's.  On
the ranks each is a routed exchange within the level group (K4 pack,
all-to-all, K4 unpack; ``parallel/routing.py``), and the sum over the
groups is an ordered all-reduce over the ``lvl`` line
(``parallel/collectives.py:all_reduce_sum``), so every group holds the
same aggregate bits.

The carriage is ``(K, total, k)`` in the JAX package: level g's copy in
level-g order.  Rank ``(g, d)`` holds its rows ``[d R, (d + 1) R)`` of
level g's copy, ``(R, k)`` row-major.

**The transposed step.**  The step is ``y[g] = F_g Σ_h G_h B_h x[h]``
(``F``/``G`` the gathers by ``fwd0``/``bwd0``); both are permutations of
the live rows, each the other's transpose, so its transpose is
``x̄[h] = B_hᵀ F_h Σ_g G_g ȳ[g]``: the same two exchanges and sum, then
the level's transposed shard last (``parallel/autograd.py``: symmetric
levels reuse the forward shard and pack nothing).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from arrow_matrix_tpu_torch.io.graphio import (
    num_nonzeros,
    num_rows,
    number_of_blocks,
)
from arrow_matrix_tpu_torch.ops.arrow_blocks import (
    ArrowBlocks,
    choose_flat_head_from_stats,
    head_stats,
    resolve_block_dtype,
    resolve_blocks_binary,
)
from arrow_matrix_tpu_torch.parallel import collectives as coll
from arrow_matrix_tpu_torch.parallel.arrow_layout import (
    ShardBlocks,
    build_shard_blocks,
    shard_launch_counts,
    slim_block_step,
)
from arrow_matrix_tpu_torch.parallel.mesh import Mesh, make_mesh
from arrow_matrix_tpu_torch.parallel.multi_level import (
    pad_permutation,
    pad_to_multiple,
    resolve_levels_binary,
)
from arrow_matrix_tpu_torch.parallel.routing import (
    RankRoute,
    build_route,
    shard_route,
    take,
)


def stack_arrow_blocks(blocks_list: List[ArrowBlocks]) -> ArrowBlocks:
    """Stack per-level ArrowBlocks into one with a leading level axis,
    padding each ELL slot axis to the max across levels (the JAX
    function, array for array; the flat head's padding points at the
    dummy row ``width``)."""
    first = blocks_list[0]
    out = {}
    for f in dataclasses.fields(first):
        if not f.init:
            continue
        vals = [getattr(b, f.name) for b in blocks_list]
        is_arr = [isinstance(v, torch.Tensor) for v in vals]
        if any(is_arr) and not all(is_arr):
            raise ValueError(
                f"levels disagree on optional field {f.name!r} "
                f"(present on some levels, absent on others — build all "
                f"levels with the same banded/head_fmt settings)")
        if not is_arr[0]:
            if any(v != vals[0] for v in vals):
                raise ValueError(
                    f"levels disagree on static field {f.name!r}: {vals}")
            out[f.name] = vals[0]
            continue
        m = max(v.shape[-1] for v in vals)
        fill = first.width if f.name == "head_rows" else 0
        padded = []
        for v in vals:
            p = torch.full(tuple(v.shape[:-1]) + (m,), fill, dtype=v.dtype,
                           device=v.device)
            p[..., :v.shape[-1]] = v
            padded.append(p)
        out[f.name] = torch.stack(padded)
    return ArrowBlocks(**out)


def space_tables(levels, total_rows: int) -> tuple:
    """``(perm0, bwd0, fwd0)`` of the module docstring: level 0's padded
    permutation and the (K, total) int32 composed tables, equal to the
    JAX executor's."""
    perms = [pad_permutation(np.asarray(lvl.permutation), total_rows)
             for lvl in levels]
    invs = [np.argsort(p) for p in perms]
    k_levels = len(levels)
    bwd0 = np.stack([invs[g][perms[0]] for g in range(k_levels)])
    fwd0 = np.stack([invs[0][perms[g]] for g in range(k_levels)])
    return perms[0], bwd0.astype(np.int32), fwd0.astype(np.int32)


def default_space_mesh(k_levels: int, lvl_axis: str, axis: str,
                       device=None) -> Mesh:
    """One rank group a level, the rest of the world on the block axis
    (the JAX executors' default mesh)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % k_levels != 0:
        raise ValueError(
            f"{world} devices not divisible by {k_levels} levels; "
            f"pass an explicit mesh")
    return make_mesh((k_levels, world // k_levels), (lvl_axis, axis),
                     device=device)


def check_space_mesh(mesh: Mesh, lvl_axis: str, k_levels: int) -> None:
    """The JAX executors' refusal of a mesh without one ``lvl`` slice a
    level."""
    if mesh.shape[lvl_axis] != k_levels:
        raise ValueError(
            f"mesh axis {lvl_axis!r} has size {mesh.shape[lvl_axis]}, "
            f"need one slice per level ({k_levels})")


def space_shared_spmm(x: torch.Tensor, bwd0, fwd0, blocks: ShardBlocks,
                      mesh: Mesh, lvl_axis: str = "lvl",
                      axis: str = "blocks") -> torch.Tensor:
    """One space-shared iteration ``X := A @ X`` on rank ``(g, d)``:
    ``x`` its ``(R, k)`` rows of level g's copy -> the same rows of the
    next copy.  The level's slim banded step, its partial routed into
    level-0 order by ``bwd0`` (this rank's route), the ordered sum over
    the ``lvl`` line, the aggregate routed into level g's order by
    ``fwd0``."""
    c = slim_block_step(blocks, x, mesh, axis)
    agg = coll.all_reduce_sum(take(c, bwd0, mesh, axis), mesh, lvl_axis)
    return take(agg, fwd0, mesh, axis)


def space_transposed_spmm(g: torch.Tensor, bwd0, fwd0, blocks: ShardBlocks,
                          mesh: Mesh, lvl_axis: str = "lvl",
                          axis: str = "blocks") -> torch.Tensor:
    """The transpose of :func:`space_shared_spmm` (module docstring):
    ``g`` routed into level-0 order by ``bwd0``, summed over the ``lvl``
    line, routed into level g's order by ``fwd0``, then the level's
    transposed shard ``blocks``."""
    agg = coll.all_reduce_sum(take(g, bwd0, mesh, axis), mesh, lvl_axis)
    return slim_block_step(blocks, take(agg, fwd0, mesh, axis), mesh, axis)


def route_launches(routes) -> int:
    """K4 launches of one take through each of ``routes``: a pack when
    the route has cross-rank slots, and the unpack."""
    return sum(int(r.slots > 0) + 1 for r in routes
               if isinstance(r, RankRoute))


class SpaceSharedArrow:
    """K decomposition levels running concurrently on disjoint rank
    groups of a ("lvl", "blocks") mesh (module docstring).

    ``SpaceSharedArrow(levels, width, mesh=None, lvl_axis="lvl",
    axis="blocks", dtype=np.float32, fmt="auto", dense_budget=None,
    chunk="auto", binary="auto")``: the JAX class's arguments.  Every
    rank builds it from the same levels and packs its own shard;
    ``set_features`` takes the global host array, ``gather_result``
    returns the global result on every rank.  The step is
    differentiable (``parallel/autograd.py:StepFunction``).
    """

    carries_feature_major = False

    def __init__(self, levels, width: int, mesh: Optional[Mesh] = None,
                 lvl_axis: str = "lvl", axis: str = "blocks",
                 dtype=np.float32, fmt: str = "auto",
                 dense_budget: Optional[int] = None, chunk="auto",
                 binary="auto"):
        from arrow_matrix_tpu_torch.utils.platform import (
            device_memory_budget,
        )

        del chunk
        if not levels:
            raise ValueError("empty decomposition")
        k_levels = len(levels)
        if mesh is None:
            mesh = default_space_mesh(k_levels, lvl_axis, axis)
        check_space_mesh(mesh, lvl_axis, k_levels)
        self.mesh, self.lvl_axis, self.axis = mesh, lvl_axis, axis
        self.k_levels = k_levels
        self.n = num_rows(levels[0].matrix)
        w = max(width, *(lvl.arrow_width for lvl in levels))
        w = -(-w // width) * width
        self.width = w
        n_dev = mesh.shape[axis]
        max_rows = max(number_of_blocks(lvl.matrix, w) * w
                       for lvl in levels)
        self.total_rows = pad_to_multiple(max_rows, n_dev * w)
        self.rows_local = self.total_rows // n_dev
        nb = self.total_rows // w
        dtype = resolve_block_dtype(dtype)
        self.dtype = dtype
        if dense_budget is None:
            dense_budget = (device_memory_budget(mesh.device) * k_levels
                            * n_dev)
        if fmt == "auto":
            dense_bytes = (k_levels * self.total_rows * w * 5
                           * dtype.itemsize)
            fmt = "dense" if dense_bytes <= dense_budget else "ell"
        if fmt not in ("dense", "ell"):
            raise ValueError(f"unknown fmt {fmt!r} (expected 'auto', "
                             f"'dense' or 'ell')")
        self.fmt = fmt
        # One head layout for every level (the JAX stack needs one):
        # flat where any level's own choice would be flat.
        self.head_flat = fmt == "ell" and any(
            choose_flat_head_from_stats(
                nb, w, *head_stats(lvl.matrix, w,
                                   number_of_blocks(lvl.matrix, w)),
                dtype, "auto")
            for lvl in levels)
        self.binary = resolve_levels_binary(levels, binary)
        self.level = mesh.axis_index(lvl_axis)
        self._matrix = levels[self.level].matrix
        self.blocks = self._pack(self._matrix)
        got = coll.all_gather(torch.tensor([self.blocks.captured],
                                           dtype=torch.int64,
                                           device=mesh.device), mesh, axis)
        nnz = num_nonzeros(self._matrix)
        if int(got.sum()) != nnz:
            raise ValueError(
                f"arrow tiling captured {int(got.sum())} of {nnz} "
                f"nonzeros of level {self.level}: a level has entries "
                f"outside its banded pattern at width {w}")
        self.perm0, self.bwd0, self.fwd0 = space_tables(levels,
                                                        self.total_rows)
        self.inv_perm0 = np.argsort(self.perm0)
        g = self.level
        self.bwd_route = shard_route(build_route(self.bwd0[g], n_dev),
                                     mesh, axis)
        self.fwd_route = shard_route(build_route(self.fwd0[g], n_dev),
                                     mesh, axis)
        self._transposed = None

    def _pack(self, matrix) -> ShardBlocks:
        is_bin = (self.fmt == "ell"
                  and resolve_blocks_binary(matrix, self.fmt, self.binary))
        return build_shard_blocks(
            matrix, self.width, self.total_rows // self.width,
            self.mesh.axis_index(self.axis), self.mesh.shape[self.axis],
            True, self.dtype, self.fmt, self.head_flat, is_bin,
            self.mesh.device)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def reduce_axes(self) -> tuple:
        """The mesh axes a whole-carriage reduction sums over (every
        group's copy counts, as in the JAX package's whole-array
        reductions over ``(K, total, k)``)."""
        return (self.lvl_axis, self.axis)

    # -- the carriage ------------------------------------------------------

    def set_features(self, x_original: np.ndarray) -> torch.Tensor:
        """Host (n, k) original order -> this rank's ``(R, k)`` f32 rows
        of level g's copy, in level-g order."""
        x_original = np.asarray(x_original)
        n, k = x_original.shape
        if n != self.n:
            raise ValueError(f"expected {self.n} rows, got {n}")
        padded = np.zeros((self.total_rows, k), dtype=np.float32)
        padded[:n] = x_original
        d, R = self.mesh.axis_index(self.axis), self.rows_local
        rows = self.perm0[self.fwd0[self.level][d * R:(d + 1) * R]]
        return torch.from_numpy(np.ascontiguousarray(padded[rows])).to(
            self.mesh.device)

    def gather_result(self, c: torch.Tensor) -> np.ndarray:
        """This rank's rows -> the global host (n, k) f32 result in
        original order, on every rank (level 0's copy is the canonical
        aggregate: gathered in group 0, broadcast over ``lvl``)."""
        full = coll.all_gather(c.float().contiguous(), self.mesh,
                               self.axis)
        coll.broadcast(full, self.mesh, self.lvl_axis)
        return full.cpu().numpy()[self.inv_perm0][:self.n]

    # -- the step -------------------------------------------------------

    def step_operands(self) -> tuple:
        """This rank's operands of a step: the two routes and its
        shard."""
        return (self.bwd_route, self.fwd_route, self.blocks)

    def raw_step(self, x: torch.Tensor, bwd0, fwd0, blocks) -> torch.Tensor:
        return space_shared_spmm(x.contiguous(), bwd0, fwd0, blocks,
                                 self.mesh, self.lvl_axis, self.axis)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One iteration on this rank's rows, differentiable in ``x``."""
        from arrow_matrix_tpu_torch.parallel.autograd import StepFunction

        return StepFunction.apply(x, self, self.step_operands())

    @property
    def step_fn(self):
        """``step(x) == step_fn(x, *step_operands())``."""
        from arrow_matrix_tpu_torch.parallel.autograd import StepFunction

        return lambda x, *operands: StepFunction.apply(x, self, operands)

    def run(self, x: torch.Tensor, iterations: int,
            donate: bool = False) -> torch.Tensor:
        del donate
        for _ in range(iterations):
            x = self.step(x)
        return x

    def transposed(self):
        """This rank's level transposed, built at the first call: its
        forward shard where the level is symmetric (``packed == []``),
        else the transpose's shard in the same format, width, banded
        tiling and head layout (``packed == [g]``)."""
        from arrow_matrix_tpu_torch.parallel.autograd import (
            transpose_levels,
        )

        if self._transposed is None:
            t = transpose_levels([self._matrix], [self.blocks],
                                 lambda i, mt: self._pack(mt),
                                 self.mesh.device)
            t.packed = [self.level] if t.packed else []
            self._transposed = t
        return self._transposed

    def transposed_step(self, g: torch.Tensor) -> torch.Tensor:
        """``Sᵀ g`` of the whole step, K-copy map included (module
        docstring), with no autograd."""
        (blocks,) = self.transposed().blocks
        return space_transposed_spmm(g.contiguous(), self.bwd_route,
                                     self.fwd_route, blocks, self.mesh,
                                     self.lvl_axis, self.axis)

    def launch_counts(self, k: int, transposed: bool = False) -> dict:
        """Kernel launches of one step (``transposed``: of one transposed
        step) on this rank at width ``k`` on the card: the level's K1
        (ELL) or K2/K3 (dense), and K4 for the two routed exchanges (a
        flat head's unsort too)."""
        blocks = self.transposed().blocks[0] if transposed else self.blocks
        out = shard_launch_counts(blocks, k, "slim")
        out["K4"] += route_launches((self.bwd_route, self.fwd_route))
        out["K4 add"] = 0
        return out

    def operator_bytes(self) -> int:
        """Device bytes of this rank's shard and route tables."""
        tables = sum(t.numel() * t.element_size()
                     for r in (self.bwd_route, self.fwd_route)
                     for t in (r.send, r.unpack))
        return self.blocks.device_nbytes() + tables


__all__ = ["SpaceSharedArrow", "space_shared_spmm", "space_tables",
           "space_transposed_spmm", "stack_arrow_blocks"]

"""Space-shared feature-major execution: K levels on disjoint rank
groups in the padding-free SELL layouts.

The port of ``arrow_matrix_tpu/parallel/sell_space.py``, one process a
shard (``parallel/mesh.py``): the concurrent mode of
``parallel/space_shared.py`` on the layouts of ``parallel/sell_slim.py``.
The mesh is ``("lvl", "blocks")`` (with ``feat_axis``, a third axis
splitting the features); rank ``(g, d)`` packs level g's share d.

**One packing for every group.**  As in the JAX package, every level's
body and head shares go through ONE ``_pack_shard_tiers`` call over the
flattened ``(level, device)`` share list (index ``g * n_dev + d``): the
tier ladders and tier row counts are shared by every level and device,
and every group runs the largest halo reach over the levels.  A rank
packs its own share's entries and only the row degrees of the others
(``sell_slim._slim_shares`` with ``materialize``), so its arrays equal
its slice of the JAX package's, byte for byte; the reach is agreed over
the whole mesh.

**The exchanges** are the composed tables of the JAX executor:
``bwd0[g]`` takes level-0 carried positions from level g's (a gather of
level g's partial into level-0 order) and ``fwd0[g]`` level-g positions
from level-0 ones; both compose the level permutations and the tier
orderings.  On the ranks each is a routed exchange within the level
group (K4 pack, all-to-all, K4 unpack; tier-padding destinations come
out zero), and the sum over the groups is the ordered all-reduce over
the ``lvl`` line.

The carriage is ``(k, K * total_out)`` feature-major in the JAX package,
all K carried orderings materialized; rank ``(g, d)`` holds its
``(rows_out, k)`` rows of level g's ordering.  ``carried_mask`` is 1 on
level 0's live positions only (group 0), so whole-state reductions
count each row once.

**The transposed step** is that of ``space_shared.py``: the two
exchanges and the sum, then the level's transposed shard (its own slim
packing of ``Mᵀ`` between two local K4 gathers,
``sell_slim.SlimTransposed``; the forward shard where the level is
symmetric).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from arrow_matrix_tpu_torch.io.graphio import num_rows
from arrow_matrix_tpu_torch.ops.ell import align_up
from arrow_matrix_tpu_torch.parallel import collectives as coll
from arrow_matrix_tpu_torch.parallel.mesh import Mesh
from arrow_matrix_tpu_torch.parallel.multi_level import (
    pad_permutation,
    resolve_feature_dtype,
)
from arrow_matrix_tpu_torch.parallel.routing import build_route, shard_route, take
from arrow_matrix_tpu_torch.parallel.sell_slim import (
    SlimLevelOps,
    _banded_reach,
    _carried_maps,
    _gather_carried,
    _hops_rem,
    _int8_refused,
    _MeshExecutor,
    _pack_shard_tiers,
    _positions_inv,
    _remap_body_cols,
    _remap_head_cols,
    _slim_shares,
    _SliceSource,
    _stats_of,
    degree_ladder,
    k1_launches,
    level_step,
    rank_slim_level,
    resolve_ladder,
    slim_transposed,
)
from arrow_matrix_tpu_torch.parallel.space_shared import (
    check_space_mesh,
    default_space_mesh,
    route_launches,
)


def pack_space_levels(srcs, width: int, n_dev: int, dtype, binary: bool,
                      ladder=None, materialize: Optional[set] = None,
                      reach: Optional[int] = None) -> dict:
    """The JAX constructor's host packing over ``n_dev`` shards a level
    (module docstring): ``body``/``head`` stacks over the flattened
    share axis, ``body_order``, ``rows_out``, ``hops``/``rem``,
    ``head_unsort`` (K, w), ``orig_pos`` (K n_dev, L).  ``materialize``
    lists the flattened shares whose entries are packed (default all);
    ``reach`` is the agreed halo reach (default: scanned here)."""
    w = width
    k_levels = len(srcs)
    L = srcs[0].shard_len

    def level_mat(g):
        return (None if materialize is None
                else {d for d in range(n_dev) if g * n_dev + d in materialize})

    if reach is None:
        reach = max(_banded_reach(s, w, shard_ids=level_mat(g))
                    for g, s in enumerate(srcs))
    hops, rem = _hops_rem(reach, L, n_dev)
    shares = [_slim_shares(s, w, hops, materialize=level_mat(g))
              for g, s in enumerate(srcs)]
    body_flat = [s for body, _ in shares for s in body]
    head_flat = [s for _, head in shares for s in head]
    growth, align = resolve_ladder(ladder)
    ladder_body = degree_ladder(max(
        (int(np.diff(s.indptr).max()) if s.nnz else 0)
        for s in body_flat), growth, align)
    head_degs = [sum(np.diff(h.indptr) for h in heads)
                 for _, heads in shares]
    ladder_head = degree_ladder(max(
        (int(d.max()) if d.size else 0) for d in head_degs),
        growth, align)
    body, body_order, rows_out = _pack_shard_tiers(
        body_flat, ladder_body, binary, dtype)
    head, head_order, _ = _pack_shard_tiers(
        head_flat, ladder_head, binary, dtype,
        shared_degrees=[head_degs[g] for g in range(k_levels)
                        for _ in range(n_dev)])
    for g in range(k_levels):
        grp = head_order[g * n_dev:(g + 1) * n_dev]
        if not np.array_equal(body_order[g * n_dev, :w], np.arange(w)):
            raise AssertionError(
                f"level {g}: device 0's head rows must lead its "
                f"tiered ordering")
        if not np.all(grp[0] == grp):
            raise AssertionError(
                f"level {g}: head tier ordering must be "
                f"device-independent within the group")
    inv = _positions_inv(body_order, L)
    body = _remap_body_cols(body, inv, L, rows_out, w, hops,
                            materialize=materialize)
    head = _remap_head_cols(head, inv, L, rows_out,
                            materialize=materialize)
    # Tier unification across groups leaves -1 padding interleaved in a
    # group's head tiers, so the unsort is built slot by slot.
    head_unsort = np.zeros((k_levels, w), dtype=np.int32)
    for g in range(k_levels):
        ho = head_order[g * n_dev]
        live = ho >= 0
        head_unsort[g, ho[live]] = np.flatnonzero(live).astype(np.int32)
    return dict(body=body, head=head, body_order=body_order,
                rows_out=rows_out, hops=hops, rem=rem,
                head_unsort=head_unsort, orig_pos=inv.astype(np.int32),
                shard_len=L)


def space_route_tables(levels, body_order: np.ndarray, n_dev: int,
                       shard_len: int) -> tuple:
    """``(orig_of_pos, bwd0, fwd0)``: each level's carried ordering
    (original row a position, -1 at tier padding) and the (K, T) int32
    composed tables, equal to the JAX executor's."""
    k_levels = len(levels)
    total = shard_len * n_dev
    oops, poos = [], []
    for g, lvl in enumerate(levels):
        perm = pad_permutation(np.asarray(lvl.permutation), total)
        oop, poo = _carried_maps(
            perm, body_order[g * n_dev:(g + 1) * n_dev], shard_len, total)
        oops.append(oop)
        poos.append(poo)
    T = oops[0].size
    bwd0 = np.zeros((k_levels, T), dtype=np.int64)
    fwd0 = np.zeros((k_levels, T), dtype=np.int64)
    oop0, poo0 = oops[0], poos[0]
    for g in range(k_levels):
        idx = np.where(oop0 >= 0, poos[g][np.minimum(oop0, total - 1)], 0)
        bwd0[g] = np.maximum(idx, 0)
        idxf = np.where(oops[g] >= 0,
                        poo0[np.minimum(oops[g], total - 1)], 0)
        fwd0[g] = np.maximum(idxf, 0)
    return oops, bwd0.astype(np.int32), fwd0.astype(np.int32)


class SellSpaceShared(_MeshExecutor):
    """K decomposition levels concurrent on disjoint rank groups of a
    ("lvl", "blocks") mesh, in the padding-free SELL layouts (module
    docstring).

    ``SellSpaceShared(levels, width, mesh=None, lvl_axis="lvl",
    axis="blocks", dtype=np.float32, binary="auto", feat_axis=None,
    feature_dtype=None, ladder=None)``: the JAX class's arguments.
    ``set_features`` / ``step`` / ``run`` / ``gather_result`` as the
    other executors; the step is differentiable.
    """

    def __init__(self, levels, width: int, mesh: Optional[Mesh] = None,
                 lvl_axis: str = "lvl", axis: str = "blocks",
                 dtype=np.float32, binary="auto",
                 feat_axis: Optional[str] = None, feature_dtype=None,
                 ladder=None):
        self.feature_dtype = resolve_feature_dtype(feature_dtype)
        if self.feature_dtype == torch.int8:
            raise _int8_refused()
        if not levels:
            raise ValueError("empty decomposition")
        self.feat_axis = feat_axis
        if feat_axis is not None and (mesh is None
                                      or feat_axis not in mesh.shape):
            raise ValueError(
                f"feat_axis={feat_axis!r} requires an explicit mesh "
                f"containing that axis (e.g. make_mesh((K, b, f), "
                f"('lvl', 'blocks', {feat_axis!r})))")
        k_levels = len(levels)
        if mesh is None:
            mesh = default_space_mesh(k_levels, lvl_axis, axis)
        check_space_mesh(mesh, lvl_axis, k_levels)
        self.mesh, self.lvl_axis, self.axis = mesh, lvl_axis, axis
        self.k_levels = k_levels
        n_dev = mesh.shape[axis]
        w = width
        self.n = num_rows(levels[0].matrix)
        L = max(align_up(-(-self.n // n_dev), w), w)
        srcs = [_SliceSource(lvl.matrix, n_dev, w, shard_len=L)
                for lvl in levels]
        if binary is False:
            self.binary = False
        else:
            self.binary = all(s.resolve_binary(binary) for s in srcs)
        self.level = g = mesh.axis_index(lvl_axis)
        d = mesh.axis_index(axis)
        share = g * n_dev + d
        # One program runs every group in the JAX package: the largest
        # reach over every level, agreed over the whole mesh.
        reach = coll.all_reduce_max(
            _banded_reach(srcs[g], w, shard_ids={d}), mesh, None)
        packed = pack_space_levels(srcs, w, n_dev, dtype, self.binary,
                                   ladder=ladder, materialize={share},
                                   reach=reach)
        self.width, self.shard_len, self.n_dev = w, L, n_dev
        self.rows_out = self.rows_local = packed["rows_out"]
        self.hops = packed["hops"]
        self.total_out = self.rows_out * n_dev
        self.ops = SlimLevelOps(
            body=packed["body"], head=packed["head"],
            head_unsort=packed["head_unsort"][g],
            orig_pos=packed["orig_pos"], body_order=packed["body_order"],
            rows_out=self.rows_out, shard_len=L, n_dev=n_dev, width=w,
            hops=self.hops, rem=packed["rem"],
            binary=self.binary).to_rank(share, mesh.device)
        self.head_unsort = packed["head_unsort"]
        self._orig_of_pos, self.bwd0, self.fwd0 = space_route_tables(
            levels, packed["body_order"], n_dev, L)
        self._oop = self._orig_of_pos[g]
        self.bwd_route = shard_route(build_route(
            self.bwd0[g], n_dev, pad_mask=self._orig_of_pos[0] < 0),
            mesh, axis)
        self.fwd_route = shard_route(build_route(
            self.fwd0[g], n_dev, pad_mask=self._oop < 0), mesh, axis)
        self._ladder, self._dtype = ladder, dtype
        self._matrix = levels[g].matrix
        self._transposed = None

        from arrow_matrix_tpu_torch.utils import commstats

        padded = [pad_permutation(np.asarray(lvl.permutation), L * n_dev)
                  for lvl in levels]
        self._ideal_route_units = sum(
            commstats.ideal_routing_bytes([padded[0], padded[h]],
                                          n_dev, 1, itemsize=1)
            for h in range(1, k_levels))

    # -- the carriage --------------------------------------------------

    def reduce_axes(self) -> tuple:
        """The mesh axes a whole-carriage reduction sums over (the mask
        keeps level 0's copy only)."""
        return (self.lvl_axis,) + super().reduce_axes()

    def gather_result(self, c: torch.Tensor) -> np.ndarray:
        """This rank's carriage -> the global host (n, k) f32 result in
        original order, on every rank (level 0's copy is the canonical
        aggregate: gathered in group 0, broadcast over ``lvl``)."""
        c = c.float().contiguous()
        full = coll.all_gather(c, self.mesh, self.axis)
        if self.feat_axis is not None:
            f = self.mesh.shape[self.feat_axis]
            parts = coll.all_gather(full, self.mesh, self.feat_axis)
            full = parts.view(f, *full.shape).permute(1, 0, 2).reshape(
                full.shape[0], f * full.shape[1]).contiguous()
        coll.broadcast(full, self.mesh, self.lvl_axis)
        return _gather_carried(full.cpu().numpy(), self._orig_of_pos[0],
                               self.n)

    def carried_mask(self) -> torch.Tensor:
        """(rows_out, 1) f32 mask of this rank's carriage: level 0's live
        positions only (``(1, K total_out)`` in the JAX package); the
        other groups carry copies and are masked out whole."""
        if self.level != 0:
            return torch.zeros((self.rows_out, 1), dtype=torch.float32,
                               device=self.mesh.device)
        return super().carried_mask()

    # -- the step ------------------------------------------------------

    def step_operands(self) -> tuple:
        """This rank's operands of a step: its level, the two routes."""
        return (self.ops, self.bwd_route, self.fwd_route)

    def _level_ops(self) -> list:
        return [self.ops]

    def _chain(self, x: torch.Tensor, levels: list) -> torch.Tensor:
        """The level's slim step, its partial routed into level-0 order,
        the ordered sum over ``lvl`` (in f32), routed into this level's
        order."""
        mesh, axis = self.mesh, self.axis
        c = level_step(levels[0], x, mesh, axis)
        c0 = take(c, self.bwd_route, mesh, axis)
        agg = coll.all_reduce_sum(c0.float(), mesh, self.lvl_axis)
        return take(agg.to(c.dtype), self.fwd_route, mesh, axis)

    def level_matrices(self) -> list:
        return [self._matrix]

    def pack_transposed(self, i: int, matrix):
        """This rank's share of ``matrix`` (its level's transpose),
        packed on its own over the level group by the slim packer at the
        level's width and shard length (the forward's unified tiers are
        a constraint of one SPMD program, not of the transposed
        operator)."""
        src = _SliceSource(matrix, self.n_dev, self.width,
                           shard_len=self.shard_len)
        t = rank_slim_level(src, self.width, self.mesh, self.axis,
                            self._dtype, self.binary, ladder=self._ladder)
        return slim_transposed(self.ops, t, self.mesh.device)

    def transposed(self):
        t = super().transposed()
        if t.packed == [0]:
            t.packed = [self.level]
        return t

    def transposed_step(self, g: torch.Tensor) -> torch.Tensor:
        """``Sᵀ g`` of the whole step, K-copy map included
        (``space_shared.py``): the two exchanges and the sum over
        ``lvl``, then the level's transposed shard."""
        (op,) = self.transposed().blocks
        mesh, axis = self.mesh, self.axis
        g = g.contiguous()
        agg = coll.all_reduce_sum(take(g, self.bwd_route, mesh, axis),
                                  mesh, self.lvl_axis)
        return level_step(op, take(agg, self.fwd_route, mesh, axis), mesh,
                          axis)

    # -- reports ------------------------------------------------------

    def launch_counts(self, k: int, transposed: bool = False) -> dict:
        """Kernel launches of one step (``transposed``: of one transposed
        step, in f32) on this rank at width ``k`` on the card: K1 (the
        level's body and head), K4 (its halo gather, the head unsort on
        the group's first rank, the two routed exchanges; a level packed
        transposed, its two ordering moves)."""
        if self.feat_axis is not None:
            k //= self.mesh.shape[self.feat_axis]
        o, dt, moves = self.ops, self.feature_dtype, 0
        if transposed:
            (o,), dt = self.transposed().blocks, torch.float32
            if not isinstance(o, SlimLevelOps):
                o, moves = o.ops, 2
        first = self.mesh.axis_index(self.axis) == 0
        return {"K1": (k1_launches(o.dev["body"], k, dt)
                       + k1_launches(o.dev["head"], k, dt)),
                "K4": (int(o.hops > 0) + int(first) + moves
                       + route_launches((self.bwd_route, self.fwd_route))),
                "K4 add": 0}

    def _local_stats(self) -> tuple:
        return _stats_of([self.ops])

    def device_nbytes(self) -> int:
        """Bytes of this rank's device operators."""
        return self.ops.rank_nbytes()

    def ideal_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Paper cost model for one space-shared step at width ``k``: the
        star-shaped cross-group routing plus each group's O(width) head
        exchange."""
        per_level_head = max(self.n_dev - 1, 0) * self.width
        return (self._ideal_route_units
                + self.k_levels * per_level_head) * k * itemsize

    def predicted_hbm_bytes(self, k: int, itemsize: int = 4) -> int:
        """This rank's device operators and route tables plus its carried
        input and output at width ``k``."""
        tables = sum(t.numel() * t.element_size()
                     for r in (self.bwd_route, self.fwd_route)
                     for t in (r.send, r.unpack))
        return (self.device_nbytes() + tables
                + 2 * self.rows_out * k * itemsize)

    def shard_report(self) -> dict:
        """Per-(level, device) load report (``obs/imbalance.py``
        schema), each rank's own counts gathered over ``blocks`` and
        ``lvl``."""
        from arrow_matrix_tpu_torch.obs.imbalance import summarize_units

        mine = torch.tensor([self._local_stats()], dtype=torch.int64,
                            device=self.mesh.device)
        got = coll.all_gather(mine, self.mesh, self.axis)
        got = coll.all_gather(got, self.mesh, self.lvl_axis)
        got = got.cpu().numpy().reshape(-1, 3)
        return summarize_units(got[:, 0], got[:, 1], got[:, 2],
                               units="level-shard")


__all__ = ["SellSpaceShared", "pack_space_levels", "space_route_tables"]

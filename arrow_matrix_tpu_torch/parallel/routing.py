"""Table-driven permutation routing between the ranks of a mesh.

The port of ``arrow_matrix_tpu/parallel/routing.py``.  All data-dependent
routing is compiled once on the host into static index tables (the
reference's precomputed Alltoallv tables); an exchange is then a fixed
shape ``all_to_all`` plus local row gathers:

* rows that stay on their rank are copied locally;
* rows that cross ranks ride one all-to-all with per-pair slot budgets
  padded to the largest pair count ``S``; padding slots read a zero
  dummy row and land nowhere.

:func:`build_route` (with its streamed twin above
``AMT_ROUTE_STREAM_MIN`` rows) gives tables equal to the JAX package's,
field by field.  The carriage is row-major ``(rows, k)``, so a table
index is a row.  On a rank the exchange (:func:`routed_take`) is:

1. the pack, one K4 row gather of the send slots from ``[local rows;
   a zero row]``;
2. :func:`~arrow_matrix_tpu_torch.parallel.collectives.all_to_all`
   (none when ``S == 0``) into a buffer led by the zero row;
3. the unpack, one K4 row gather (or gather-add) through a table built
   on the host that gives each destination row its source in ``[local
   rows; the zero row; received slots]``.  JAX scatters the received
   slots with the dummy row absorbing the padding; the port turns that
   scatter into a gather, so padding can never land on a live row and
   every exchange copies bits.

K4 reads its source in two parts, the local rows and the zero row (with
the received slots behind it), where they lie: no exchange copies the
rank's rows.

``routing="gather"`` is an all-gather of the carried rows and one local
K4 gather (:func:`gather_take`).  The feature-axis splits
(``overlap_slices``, ``repl_slab_width``) and the 2.5D slab helpers are
here too.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather, row_gather_add_
from arrow_matrix_tpu_torch.utils.buildstats import bump


@dataclass
class RouteTables:
    """Static routing tables for one permutation exchange ``out[j] =
    x[table[j]]`` on a row-sharded (total, k) array, host numpy arrays
    with a leading device axis (the JAX class's fields, byte for byte).
    Padding slots gather from the per-device dummy row (local index R)
    and scatter into it (dropped on exit)."""

    local_src: np.ndarray   # (n_dev, L)        local gather sources
    local_dst: np.ndarray   # (n_dev, L)        local gather destinations
    send_idx: np.ndarray    # (n_dev, n_dev, S) rows device s sends to d
    recv_dst: np.ndarray    # (n_dev, n_dev, S) where rows from s land on d
    rows_src: int = 0
    rows_dst: int = 0
    n_dev: int = 0

    @property
    def rows_per_dev(self) -> int:   # permutation-exchange convenience
        assert self.rows_src == self.rows_dst
        return self.rows_src

    @property
    def slots(self) -> int:
        """Slots a device pair (``S``)."""
        return int(self.send_idx.shape[-1])

    def device_bytes_per_exchange(self, k: int, itemsize: int = 4) -> int:
        """all_to_all payload bytes per device (the padded volume)."""
        return self.send_idx.shape[1] * self.send_idx.shape[2] * k * itemsize

    def unpack(self, d: int) -> np.ndarray:
        """Device ``d``'s unpack table: ``(rows_dst,)`` int64, the source
        of each destination row in ``[local rows (R); dummy (1); received
        slots (n_dev * S)]``, -1 where no row lands."""
        r_src, r_dst, S = self.rows_src, self.rows_dst, self.slots
        out = np.full(r_dst, -1, dtype=np.int64)
        live = self.local_dst[d] < r_dst
        out[self.local_dst[d][live]] = self.local_src[d][live]
        recv = self.recv_dst[d].reshape(-1)
        got = recv < r_dst
        out[recv[got]] = r_src + 1 + np.flatnonzero(got)
        return out


# Streaming kicks in automatically above 2^24 rows (where the
# in-memory build's ~13 x 8 B x total scratch reaches ~1.7 GB) with
# 2^22-row chunks; AMT_ROUTE_STREAM_MIN overrides for tests.
_STREAM_MIN = int(os.environ.get("AMT_ROUTE_STREAM_MIN", 1 << 24))
_STREAM_CHUNK = 1 << 22


def _avail_bytes() -> Optional[int]:
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return None


def _slots_within_groups(keys: np.ndarray) -> np.ndarray:
    """For sorted group keys, the running index of each element within
    its group (vectorized; O(len))."""
    if keys.size == 0:
        return keys.astype(np.int64)
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    group_of = np.cumsum(np.r_[False, keys[1:] != keys[:-1]])
    return np.arange(keys.size) - starts[group_of]


def _build_route_streamed(table: np.ndarray, n_dev: int, src_total: int,
                          pad_mask: Optional[np.ndarray], r_src: int,
                          r_dst: int, chunk: int) -> RouteTables:
    """Chunked two-pass table build: scratch bounded to O(chunk).

    Pass 1 counts per-device local rows and per-(src,dst) cross rows;
    pass 2 re-derives each chunk and scatters into the final tables
    with RUNNING per-group fill counters.  Every group receives its
    entries in globally ascending j, the order of the in-memory build,
    so the tables are elementwise identical for any chunk size."""
    total = table.size

    def derive(lo: int, hi: int, count_only: bool = False):
        t = table[lo:hi]
        j = np.arange(lo, hi, dtype=np.int64)
        dst_dev = j // r_dst
        if pad_mask is None:
            live = None
            src_dev = t // r_src
        else:
            live = ~np.asarray(pad_mask[lo:hi], dtype=bool)
            src_dev = np.where(live, t // r_src, dst_dev)
        checked = t if live is None else t[live]
        if not ((checked >= 0) & (checked < src_total)).all():
            raise ValueError("gather table entries outside [0, src_total)")
        if count_only:   # pass 1 discards the offsets — skip the work
            return dst_dev, src_dev, None, None
        if live is None:
            src_off = t % r_src
        else:
            src_off = np.where(live, t % r_src, r_src)
        return dst_dev, src_dev, src_off, j % r_dst

    loc_counts = np.zeros(n_dev, dtype=np.int64)
    pair_counts = np.zeros(n_dev * n_dev, dtype=np.int64)
    for lo in range(0, total, chunk):
        hi = min(total, lo + chunk)
        dst_dev, src_dev, _, _ = derive(lo, hi, count_only=True)
        is_local = dst_dev == src_dev
        loc_counts += np.bincount(dst_dev[is_local], minlength=n_dev)
        pair_counts += np.bincount(
            (src_dev * n_dev + dst_dev)[~is_local],
            minlength=n_dev * n_dev)

    l_max = int(loc_counts.max()) if loc_counts.size else 0
    s_max = int(pair_counts.max())
    out_bytes = 4 * (2 * n_dev * l_max + 2 * n_dev * n_dev * s_max)
    avail = _avail_bytes()
    if avail is not None and out_bytes > 0.8 * avail:
        import warnings

        warnings.warn(
            f"build_route (streamed) at {total} rows: the OUTPUT tables "
            f"need ~{out_bytes / 2**30:.0f} GB but only "
            f"{avail / 2**30:.0f} GB is free — shard the exchange "
            f"(feat_axis / per-level meshes) or use a fatter build host")
    local_src = np.full((n_dev, l_max), r_src, dtype=np.int32)
    local_dst = np.full((n_dev, l_max), r_dst, dtype=np.int32)
    send_idx = np.full((n_dev, n_dev, s_max), r_src, dtype=np.int32)
    recv_dst = np.full((n_dev, n_dev, s_max), r_dst, dtype=np.int32)

    fill_loc = np.zeros(n_dev, dtype=np.int64)
    fill_pair = np.zeros(n_dev * n_dev, dtype=np.int64)
    for lo in range(0, total, chunk):
        hi = min(total, lo + chunk)
        dst_dev, src_dev, src_off, dst_off = derive(lo, hi)
        is_local = dst_dev == src_dev
        loc = np.nonzero(is_local)[0]
        if loc.size:
            dev = dst_dev[loc]            # ascending (j-contiguous chunk)
            slot = fill_loc[dev] + _slots_within_groups(dev)
            local_src[dev, slot] = src_off[loc]
            local_dst[dev, slot] = dst_off[loc]
            fill_loc += np.bincount(dev, minlength=n_dev)
        cross = np.nonzero(~is_local)[0]
        if cross.size:
            pair = (src_dev[cross] * n_dev + dst_dev[cross])
            if hi - lo <= (1 << 32):
                order = np.argsort((pair << 32) | cross)
            else:
                order = np.lexsort((cross, pair))
            cross = cross[order]
            pair = pair[order]
            slot = fill_pair[pair] + _slots_within_groups(pair)
            s, d = src_dev[cross], dst_dev[cross]
            send_idx[s, d, slot] = src_off[cross]
            recv_dst[d, s, slot] = dst_off[cross]
            fill_pair += np.bincount(pair, minlength=n_dev * n_dev)

    return RouteTables(local_src=local_src, local_dst=local_dst,
                       send_idx=send_idx, recv_dst=recv_dst,
                       rows_src=r_src, rows_dst=r_dst, n_dev=n_dev)


def build_route(table: np.ndarray, n_dev: int,
                src_total: Optional[int] = None,
                pad_mask: Optional[np.ndarray] = None,
                stream_chunk: Optional[int] = None) -> RouteTables:
    """Compile a global gather table ``out[j] = x[table[j]]`` into
    RouteTables (the JAX function, table for table).

    ``src_total`` supports rectangular exchanges between carried
    orderings of different padded lengths (SellMultiLevel).  Destination
    positions flagged by ``pad_mask`` (tier padding, never consumed) are
    routed from the LOCAL dummy row instead of their table entry, so
    they cost no cross-device slots and come out zero.  Above
    ``_STREAM_MIN`` rows (or when ``stream_chunk`` is given) the build
    streams in j-order chunks with the same result."""
    from arrow_matrix_tpu_torch.faults import inject as _fault_hook

    _fault_hook("routing.build_route")
    bump("routes")
    table = np.asarray(table, dtype=np.int64)
    total = table.size
    if src_total is None:
        src_total = total
    if total % n_dev != 0 or src_total % n_dev != 0:
        raise ValueError(f"{total}/{src_total} rows not divisible by "
                         f"{n_dev} devices")
    r_dst = total // n_dev
    r_src = src_total // n_dev
    if stream_chunk is None and total >= _STREAM_MIN:
        stream_chunk = _STREAM_CHUNK
    if stream_chunk is not None and total > stream_chunk:
        return _build_route_streamed(table, n_dev, src_total, pad_mask,
                                     r_src, r_dst, stream_chunk)
    est_bytes = 13 * 8 * total
    avail = _avail_bytes()
    if avail is not None and est_bytes > 0.8 * avail:
        import warnings

        warnings.warn(
            f"build_route at {total} rows needs ~{est_bytes / 2**30:.0f}"
            f" GB of host scratch but only {avail / 2**30:.0f} GB is "
            f"free — shard the exchange or use a fatter build host")

    live = np.ones(total, dtype=bool) if pad_mask is None else ~np.asarray(
        pad_mask, dtype=bool)
    if not ((table[live] >= 0) & (table[live] < src_total)).all():
        raise ValueError("gather table entries outside [0, src_total)")
    idx_dt = np.int32 if max(total, src_total) < np.iinfo(np.int32).max \
        else np.int64
    j = np.arange(total, dtype=idx_dt)
    dst_dev = (j // r_dst).astype(idx_dt, copy=False)
    src_dev = np.where(live, table // r_src, 0).astype(idx_dt,
                                                      copy=False)
    src_off = (table % r_src).astype(idx_dt, copy=False)
    dst_off = (j % r_dst).astype(idx_dt, copy=False)
    if pad_mask is not None:
        src_dev = np.where(live, src_dev, dst_dev).astype(idx_dt,
                                                         copy=False)
        src_off = np.where(live, src_off, r_src).astype(idx_dt,
                                                        copy=False)
    is_local = dst_dev == src_dev

    loc = np.nonzero(is_local)[0]          # already ascending in j
    loc_counts = np.bincount(dst_dev[loc], minlength=n_dev)
    l_max = int(loc_counts.max()) if loc.size else 0
    local_src = np.full((n_dev, l_max), r_src, dtype=np.int32)
    local_dst = np.full((n_dev, l_max), r_dst, dtype=np.int32)
    if loc.size:
        slot = _slots_within_groups(dst_dev[loc])
        local_src[dst_dev[loc], slot] = src_off[loc]
        local_dst[dst_dev[loc], slot] = dst_off[loc]

    cross = np.nonzero(~is_local)[0]
    send_idx = np.full((n_dev, n_dev, 0), r_src, dtype=np.int32)
    recv_dst = np.full((n_dev, n_dev, 0), r_dst, dtype=np.int32)
    if cross.size:
        pair = (src_dev[cross].astype(np.int64) * n_dev
                + dst_dev[cross])
        if cross[-1] < (1 << 32):
            order = np.argsort((pair << 32) | cross.astype(np.int64))
        else:
            order = np.lexsort((cross, pair))
        cross = cross[order]
        s, d = src_dev[cross], dst_dev[cross]
        slot = _slots_within_groups(s * n_dev + d)
        s_max = int(slot.max()) + 1
        send_idx = np.full((n_dev, n_dev, s_max), r_src, dtype=np.int32)
        recv_dst = np.full((n_dev, n_dev, s_max), r_dst, dtype=np.int32)
        send_idx[s, d, slot] = src_off[cross]
        recv_dst[d, s, slot] = dst_off[cross]

    return RouteTables(local_src=local_src, local_dst=local_dst,
                       send_idx=send_idx, recv_dst=recv_dst,
                       rows_src=r_src, rows_dst=r_dst, n_dev=n_dev)


@dataclass
class RankRoute:
    """One rank's share of a :class:`RouteTables`, on its device:
    ``send`` ``(n_dev * S,)`` int32 rows of ``[local rows; zero row]``
    to pack (slots for rank d at ``[d S, (d + 1) S)``), and the unpack
    table as int32 (``unpack``: unset rows read the zero row R)."""

    send: torch.Tensor
    unpack: torch.Tensor
    unpack_host: np.ndarray        # -1 where no row lands (staged init)
    rows_src: int
    rows_dst: int
    n_dev: int
    slots: int
    _init: dict = field(default_factory=dict, repr=False)

    def device_bytes_per_exchange(self, k: int, itemsize: int = 4) -> int:
        """all_to_all payload bytes of this rank (the padded volume)."""
        return self.n_dev * self.slots * k * itemsize

    def unpack_onto_init(self) -> torch.Tensor:
        """The unpack table over ``[local; zero; received; init rows]``:
        rows no slot writes keep the init carriage's row."""
        if "t" not in self._init:
            base = self.rows_src + 1 + self.n_dev * self.slots
            u = self.unpack_host.copy()
            unset = u < 0
            u[unset] = base + np.flatnonzero(unset)
            self._init["t"] = torch.from_numpy(u.astype(np.int32)).to(
                self.send.device)
        return self._init["t"]


def shard_route(route: RouteTables, mesh, axis: str = "blocks") -> RankRoute:
    """This rank's tables of ``route`` (its position on ``axis``) on its
    device."""
    d = mesh.axis_index(axis)
    return rank_route(route, d, mesh.device)


def rank_route(route: RouteTables, d: int, device) -> RankRoute:
    """Device ``d``'s :class:`RankRoute` of ``route`` on ``device``."""
    u = route.unpack(d)
    dense = np.where(u < 0, route.rows_src, u)
    send = route.send_idx[d].reshape(-1).astype(np.int32)
    dev = torch.device(device)
    return RankRoute(send=torch.from_numpy(send).to(dev),
                     unpack=torch.from_numpy(dense.astype(np.int32)).to(dev),
                     unpack_host=u, rows_src=route.rows_src,
                     rows_dst=route.rows_dst, n_dev=route.n_dev,
                     slots=route.slots)


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                add_to: Optional[torch.Tensor] = None,
                src2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[src; src2][idx]`` through K4 (``add_to + ...`` in place for an
    f32 ``add_to`` through K4's gather-add; a bf16 one adds after the
    gather)."""
    if add_to is None:
        return row_gather(src, idx, src2)
    if add_to.dtype == torch.float32:
        return row_gather_add_(add_to, src, idx, src2)
    return add_to.add_(row_gather(src, idx, src2))


def routed_take(x: torch.Tensor, route: RankRoute, mesh,
                axis: str = "blocks", add_to: Optional[torch.Tensor] = None,
                init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[j] = x[table[j]]`` for this rank's destination rows (module
    docstring): ``x`` is the rank's ``(rows_src, k)`` share.  ``add_to``
    (the backward aggregation) receives ``add_to + out`` in place;
    ``init`` seeds the rows no slot of this route writes (a staged
    sub-exchange)."""
    from arrow_matrix_tpu_torch.parallel.collectives import all_to_all

    if x.shape[0] != route.rows_src:
        raise ValueError(f"x has {x.shape[0]} rows, the route reads "
                         f"{route.rows_src}")
    x = x.contiguous()
    # [zero row; received slots]: the source's second part.
    tail = x.new_empty((1 + route.n_dev * route.slots,) + x.shape[1:])
    tail[0].zero_()
    if route.slots > 0:
        payload = gather_rows(x, route.send, src2=tail[:1])
        all_to_all(payload, mesh, axis, out=tail[1:])
    if init is not None:
        return gather_rows(x, route.unpack_onto_init(), add_to,
                           src2=torch.cat([tail, init]))
    return gather_rows(x, route.unpack, add_to, src2=tail)


@dataclass
class GatherTable:
    """``routing="gather"``: this rank's rows of a global gather table
    (int32, on its device) over the all-gathered carriage."""

    idx: torch.Tensor


def gather_table(table: np.ndarray, mesh, axis: str) -> GatherTable:
    """This rank's destination rows of the global ``table``."""
    n_dev = mesh.shape[axis]
    d = mesh.axis_index(axis)
    r_dst = table.size // n_dev
    mine = np.asarray(table[d * r_dst:(d + 1) * r_dst], dtype=np.int32)
    return GatherTable(torch.from_numpy(mine).to(mesh.device))


def gather_take(x: torch.Tensor, table: GatherTable, mesh,
                axis: str = "blocks",
                add_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[j] = x[table[j]]`` over an all-gather of the carriage (the
    JAX package's GSPMD-lowered gather), then one K4 gather."""
    from arrow_matrix_tpu_torch.parallel.collectives import all_gather

    full = all_gather(x.contiguous(), mesh, axis)
    return gather_rows(full, table.idx, add_to)


def take(x: torch.Tensor, table, mesh, axis: str = "blocks",
         add_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch: :class:`RankRoute` -> routed exchange; :class:`
    StagedRoute` -> its stages; :class:`GatherTable` -> all-gather then
    gather."""
    if isinstance(table, StagedRoute):
        out = staged_routed_take(x, table, mesh, axis)
        return out if add_to is None else add_to.add_(out)
    if isinstance(table, RankRoute):
        return routed_take(x, table, mesh, axis, add_to=add_to)
    return gather_take(x, table, mesh, axis, add_to=add_to)


@dataclass
class StagedRoute:
    """A permutation exchange split into stages whose all-to-all payload
    (send + recv) fits ``scratch_budget_bytes`` at feature width
    ``budget_k``.  Stage 0 carries the local gather; later stages have
    empty local tables and a disjoint slice of the cross-device slots.
    Every destination row is written by exactly one stage, so the staged
    result equals the one-shot exchange bit for bit.  Host tables;
    :func:`shard_staged` gives a rank's."""

    stages: tuple
    rows_src: int = 0
    rows_dst: int = 0
    n_dev: int = 0
    scratch_budget_bytes: int = 0
    budget_k: int = 0

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def device_bytes_per_exchange(self, k: int, itemsize: int = 4) -> int:
        """Peak per-stage all_to_all payload bytes per device."""
        return max((s.device_bytes_per_exchange(k, itemsize)
                    for s in self.stages), default=0)


def split_route_stages(route: RouteTables, k: int,
                       scratch_budget_bytes: int,
                       itemsize: int = 4) -> StagedRoute:
    """Split one compiled route into bounded-scratch stages (the JAX
    function): a stage's scratch is ``2 x n_dev x S_stage x k x
    itemsize`` per device; raises when the budget cannot carry one slot
    per device pair."""
    n_dev = route.n_dev
    S = route.slots
    slot_bytes = 2 * n_dev * k * itemsize
    s_stage = int(scratch_budget_bytes) // slot_bytes
    if s_stage < 1:
        raise ValueError(
            f"scratch budget {scratch_budget_bytes} B cannot carry one "
            f"exchange slot per device pair at k={k} (needs "
            f"{slot_bytes} B: n_dev={n_dev} rows sent + received) — "
            f"raise the budget or narrow k; refusing to emit an "
            f"over-budget stage")

    def sub(lo: int, hi: int, with_local: bool) -> RouteTables:
        width = 0 if with_local else int(route.local_src.shape[-1])
        return replace(route, local_src=route.local_src[:, width:],
                       local_dst=route.local_dst[:, width:],
                       send_idx=route.send_idx[:, :, lo:hi],
                       recv_dst=route.recv_dst[:, :, lo:hi])

    bounds = list(range(0, max(S, 1), s_stage)) or [0]
    stages = tuple(
        sub(lo, min(lo + s_stage, S), with_local=(i == 0))
        for i, lo in enumerate(bounds))
    return StagedRoute(stages=stages, rows_src=route.rows_src,
                       rows_dst=route.rows_dst, n_dev=n_dev,
                       scratch_budget_bytes=int(scratch_budget_bytes),
                       budget_k=int(k))


def shard_staged(sroute: StagedRoute, mesh, axis: str = "blocks"
                 ) -> StagedRoute:
    """This rank's stages (:class:`RankRoute` each) of ``sroute``."""
    return replace(sroute, stages=tuple(shard_route(s, mesh, axis)
                                        for s in sroute.stages))


def staged_routed_take(x: torch.Tensor, sroute: StagedRoute, mesh,
                       axis: str = "blocks") -> torch.Tensor:
    """Run a rank's :class:`StagedRoute` as sequential sub-exchanges:
    stage 0 one-shot, each later stage writing only its own rows over
    the running result (``init``): pure row copies, equal to the
    one-shot exchange bit for bit."""
    acc = routed_take(x, sroute.stages[0], mesh, axis)
    for st in sroute.stages[1:]:
        acc = routed_take(x, st, mesh, axis, init=acc)
    return acc


def overlap_slices(k: int, overlap_slabs: int) -> list:
    """Bounds ``[(lo, hi), ...]`` of ``overlap_slabs`` equal contiguous
    slabs of ``k`` features; raises ``ValueError`` unless the count
    divides ``k``."""
    s = int(overlap_slabs)
    if s <= 1:
        return [(0, k)]
    if s > k or k % s:
        raise ValueError(
            f"overlap_slabs={s} must divide the feature width k={k} "
            f"(equal static sub-slabs; pick S from the divisors of k)")
    step = k // s
    return [(i * step, (i + 1) * step) for i in range(s)]


def repl_slab_width(k: int, repl: int) -> int:
    """Width ``k / c`` of the column group each of ``repl`` groups owns
    (group j: ``[j k/c, (j + 1) k/c)``); raises ``ValueError`` unless
    ``c`` divides ``k``."""
    c = int(repl)
    if c <= 1:
        return int(k)
    if c > k or k % c:
        raise ValueError(
            f"repl={c} must divide the feature width k={k} "
            f"(each replica group owns an equal static column slab)")
    return k // c


def repl_slab_take(x: torch.Tensor, mesh, repl_axis: str) -> torch.Tensor:
    """``(rows, k)`` -> ``(rows, k/c)``: the feature slab this rank's
    replica group owns (copied contiguous)."""
    c = mesh.shape[repl_axis]
    kc = repl_slab_width(x.shape[1], c)
    j = mesh.axis_index(repl_axis)
    return x[:, j * kc:(j + 1) * kc].contiguous()


def repl_slab_scatter(slab: torch.Tensor, k: int, mesh,
                      repl_axis: str) -> torch.Tensor:
    """``(rows, k/c)`` -> ``(rows, k)``: the slab at its columns, zeros
    elsewhere (the partial carriage the merge combines)."""
    c = mesh.shape[repl_axis]
    kc = slab.shape[1]
    if kc * c != k:
        raise ValueError(f"slab width {kc} x repl={c} != k={k}")
    j = mesh.axis_index(repl_axis)
    out = slab.new_zeros((slab.shape[0], k))
    out[:, j * kc:(j + 1) * kc] = slab
    return out


def repl_merge(x: torch.Tensor, mesh, repl_axis: str) -> torch.Tensor:
    """The replicas' partial carriages merged into the full one on every
    rank of the replica line: an all-gather over ``repl_axis``, then
    each group's owned slab copied into place (bit copies; the JAX
    package's masked psum adds c - 1 zeros to each element)."""
    from arrow_matrix_tpu_torch.parallel.collectives import all_gather

    c = mesh.shape[repl_axis]
    if c == 1:
        return x
    rows, k = x.shape
    kc = repl_slab_width(k, c)
    parts = all_gather(x.contiguous(), mesh, repl_axis).view(c, rows, k)
    out = torch.empty_like(x)
    for j in range(c):
        out[:, j * kc:(j + 1) * kc] = parts[j, :, j * kc:(j + 1) * kc]
    return out

"""Padding-free mesh executors: SellSlim and SellMultiLevel.

The port of ``arrow_matrix_tpu/parallel/sell_slim.py``, one process a
shard (``parallel/mesh.py``).  Each rank's share of a level is **two
SELL operators** over its local operand, packed on the host exactly as
the JAX package packs them (the arrays are equal to JAX's byte for
byte):

* a *body*: its rows of at least ``w`` (the block diagonal or band and
  the head-column arm), over the operand ``[own rows; X_0; lo halos;
  hi halos]``;
* a *head*: the rows ``[0, w)`` over its own rows, whose partials are
  summed into C_0 on the first rank.

Rows are tier-grouped by degree per shard under one shared degree
ladder, the tier row counts padded to the maximum over ranks, rank 0's
head rows leading the zero tier; the per-shard ordering is composed
into the carried permutation on the host.  Torch ranks need not run one
program, but equal shapes keep the packing JAX's and the a2a slot count
fixed.

**Carriage.**  The port carries X row-major ``(rows_out, k)`` a rank
(its share of the global ``(total_out, k)``, as its fold carries
``(rows, k)``); JAX carries feature-major ``(k, total)``.  Every index
of JAX's carried maps is an index of rows here: ``orig_pos``, the halo
slices, the body's column remap and the route tables.
``gather_result`` gives JAX's global result.

**A level step on a rank** (:func:`slim_level_step`): X_0 broadcast
from the first rank (none when the level's body has no slot: the JAX
step's product then reads nothing of X_0, and XLA drops that psum); the
halo chains (``hops`` hops to each side, the
inner ones relaying whole shards, the farthest only the ``rem`` rows
the region can reference; chain ends zero); the body product through
K1 over ``[x; X_0; lo...; hi...]`` (one ``torch.cat``); the head
partial through K1; the partials summed on rank 0 in rank order,
unsorted by one K4 gather and written over rank 0's head rows.

**SellMultiLevel** chains K levels: X in level 0's carried ordering,
routed forward into each level's ordering, every level's slim step,
partials aggregated backward; the routes are explicit a2a tables
(``routing="a2a"``, the default: K4 pack, all-to-all, K4 unpack) or an
all-gather and a K4 gather (``"gather"``).  ``repl_axis`` (2.5D on a
``make_repl_mesh`` grid), ``feat_axis`` and ``overlap_slabs`` split a
step along the features as the JAX executor does.

On the card every product is K1 (``ops/cuda_sell.py``: one launch over
all tiers of an operator, two with split rows) and every row move K4
(``ops/cuda_gather.py``); for CPU tensors the wrappers run their plain
versions.  A rank never falls back to the CPU: its device is the card
unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.io.graphio import CsrLike, num_rows
from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
from arrow_matrix_tpu_torch.ops.ell import (
    SLOT_ALIGN,
    align_up,
    block_index_dtype,
)
from arrow_matrix_tpu_torch.ops.sell import SellMatrix, nbytes_of
from arrow_matrix_tpu_torch.ops.worklist import DEFAULT_OPTS, build_worklist
from arrow_matrix_tpu_torch.parallel import collectives as coll
from arrow_matrix_tpu_torch.parallel.mesh import Mesh
from arrow_matrix_tpu_torch.parallel.multi_level import (
    pad_permutation,
    resolve_feature_dtype,
)
from arrow_matrix_tpu_torch.parallel.routing import (
    build_route,
    gather_table,
    overlap_slices,
    repl_merge,
    repl_slab_scatter,
    repl_slab_take,
    shard_route,
    take,
)


def degree_ladder(max_deg: int, growth: float = 1.5,
                  align: int = SLOT_ALIGN) -> list:
    """Fixed tier thresholds [0, align, align*g, ...] >= max_deg —
    device-independent, so every shard shares one tier shape."""
    ladder = [0]
    t = align
    while ladder[-1] < max_deg:
        ladder.append(t)
        t = align_up(max(int(t * growth), t + 1), align)
    return ladder


def resolve_ladder(ladder) -> Tuple[float, int]:
    """(growth, align) for the shared degree ladder: "default" (1.5,
    SLOT_ALIGN), "tight" (1.3, 1), or an explicit (growth, align)
    pair."""
    if ladder in (None, "default"):
        return (1.5, SLOT_ALIGN)
    if ladder == "tight":
        return (1.3, 1)
    if isinstance(ladder, str) or not hasattr(ladder, "__len__") \
            or len(ladder) != 2:
        raise ValueError(
            f"unknown ladder {ladder!r}: expected 'default', 'tight', "
            f"or a (growth, align) pair")
    growth, align = ladder
    if not float(growth) > 1.0 or int(align) < 1:
        raise ValueError(f"bad ladder {ladder!r}: need growth > 1 "
                         f"and align >= 1")
    return (float(growth), int(align))


@dataclass
class SellShardStack:
    """Per-device-stacked tiered SELL operators (leading device axis),
    host numpy arrays equal to the JAX package's.

    ``cols[t]``: (n_dev, m_t, n_t) column indices into the local
    operand; ``deg[t]``: (n_dev, n_t) int32 valid-slot counts (always
    present); ``data[t]``: (n_dev, m_t, n_t) values or None (binary).
    """

    cols: Tuple[np.ndarray, ...]
    deg: Tuple[np.ndarray, ...]
    data: Optional[Tuple[np.ndarray, ...]] = None

    def device_nbytes(self) -> int:
        arrays = list(self.cols) + list(self.deg) + list(self.data or ())
        return sum(a.size * a.dtype.itemsize for a in arrays)

    @property
    def n_slots(self) -> int:
        """Total padded gather slots across devices and tiers."""
        return sum(int(np.prod(c.shape)) for c in self.cols)

    def shard_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-device-shard (nnz, slots) summed over tiers, from the
        degree masks (filled for the shards this process packed)."""
        n_dev = int(self.cols[0].shape[0]) if self.cols else 0
        nnz = np.zeros(n_dev, dtype=np.int64)
        slots = np.zeros(n_dev, dtype=np.int64)
        for t, c in enumerate(self.cols):
            slots += int(np.prod(c.shape[1:], dtype=np.int64))
            nnz += np.asarray(self.deg[t]).sum(axis=1, dtype=np.int64)
        return nnz, slots

    def rank_operator(self, d: int, x_rows: int, device) -> SellMatrix:
        """Device ``d``'s slice as a K1 operator on ``device``: its
        tiers with rows (int32 columns), ``n_rows`` the shared tier row
        count, over an operand of ``x_rows`` rows."""
        dev = torch.device(device)
        starts = np.concatenate([[0], np.cumsum(
            [c.shape[2] for c in self.cols])]).astype(np.int64)
        keep = [t for t, c in enumerate(self.cols) if c.shape[2] > 0]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        cols = tuple(put(self.cols[t][d].astype(np.int32)) for t in keep)
        if self.data is None:
            data, deg = None, tuple(put(self.deg[t][d]) for t in keep)
        else:
            data = tuple(put(self.data[t][d].astype(np.float32))
                         for t in keep)
            deg = None
        return SellMatrix(cols=cols, data=data, deg=deg,
                          n_rows=int(starts[-1]),
                          row_starts=tuple(int(starts[t]) for t in keep),
                          x_rows=int(x_rows))


def _pack_shard_tiers(shares: list, ladder: list, binary: bool, dtype,
                      shared_degrees=None):
    """Tier-group each device's share rows by degree under the shared
    ladder (the JAX function): returns (stack, order, rows_out) where
    ``order[d, i]`` is the share row stored at tiered position i of
    device d (-1 padding) and ``rows_out`` = sum of shared tier row
    counts.  ``shared_degrees`` keys the buckets on a device-independent
    degree vector (the head operator), or a list of vectors, one per
    share."""
    n_dev = len(shares)
    degs = [np.diff(s.indptr) for s in shares]
    if shared_degrees is not None:
        per_share = (list(shared_degrees)
                     if isinstance(shared_degrees, (list, tuple))
                     else [shared_degrees] * n_dev)
        bucket = [np.searchsorted(ladder, sd, side="left")
                  for sd in per_share]
    else:
        bucket = [np.searchsorted(ladder, d, side="left") for d in degs]
    orders = [np.argsort(b, kind="stable") for b in bucket]
    n_buckets = len(ladder)
    counts = np.zeros((n_dev, n_buckets), dtype=np.int64)
    for d in range(n_dev):
        np.add.at(counts[d], bucket[d], 1)
    shared = counts.max(axis=0)
    rows_out = int(shared.sum())

    order = np.full((n_dev, rows_out), -1, dtype=np.int64)
    tier_starts = np.concatenate([[0], np.cumsum(shared)])
    for d in range(n_dev):
        sorted_bucket = bucket[d][orders[d]]
        for b in range(n_buckets):
            lo_i = np.searchsorted(sorted_bucket, b, side="left")
            hi_i = np.searchsorted(sorted_bucket, b + 1, side="left")
            rows_b = orders[d][lo_i:hi_i]
            order[d, tier_starts[b]:tier_starts[b] + rows_b.size] = rows_b

    cols_t, deg_t, data_t = [], [], []
    for b in range(n_buckets):
        m_t = ladder[b]
        n_t = int(shared[b])
        lo = int(tier_starts[b])
        cols = np.zeros((n_dev, m_t, n_t), dtype=np.int32)
        deg = np.zeros((n_dev, n_t), dtype=np.int32)
        vals = None if binary else np.zeros((n_dev, m_t, n_t), dtype=dtype)
        for d in range(n_dev):
            s = shares[d]
            if getattr(s, "indices", None) is None:
                continue   # _DegreesOnly: a shard another rank packs
            rows_b = order[d, lo:lo + n_t]
            live = np.flatnonzero(rows_b >= 0)
            if live.size == 0 or m_t == 0:
                continue
            r_live = rows_b[live]
            degs_live = (s.indptr[r_live + 1] - s.indptr[r_live]).astype(
                np.int64)
            deg[d, live] = degs_live
            nz = degs_live > 0
            if not nz.any():
                continue
            starts_src = s.indptr[r_live[nz]]
            d_nz = degs_live[nz]
            span = np.repeat(starts_src, d_nz)
            slot = (np.arange(span.size)
                    - np.repeat(np.cumsum(d_nz) - d_nz, d_nz))
            tloc = np.repeat(live[nz], d_nz)
            src = span + slot
            cols[d, slot, tloc] = s.indices[src]
            if not binary:
                vals[d, slot, tloc] = s.data[src]
        cols_t.append(cols)
        deg_t.append(deg)
        if not binary:
            data_t.append(vals)
    stack = SellShardStack(cols=tuple(cols_t), deg=tuple(deg_t),
                           data=tuple(data_t) if not binary else None)
    return stack, order, rows_out


def as_canonical_csr(matrix: CsrLike) -> sparse.csr_matrix:
    """CSR (or memmapped triplet) -> canonical (duplicate-summed,
    sorted) f32 CSR; binary detection runs on its values."""
    if isinstance(matrix, sparse.csr_matrix):
        a = matrix
    else:
        data, indices, indptr = matrix
        indptr = np.asarray(indptr, dtype=np.int64)
        nnz = int(indptr[-1])
        vals = (np.ones(nnz, dtype=np.float32) if data is None
                else np.asarray(data[:nnz]))
        a = sparse.csr_matrix(
            (vals, np.asarray(indices[:nnz]), indptr),
            shape=(indptr.size - 1, indptr.size - 1))
    a = a.tocsr().astype(np.float32)
    a.sum_duplicates()
    a.sort_indices()
    return a


def as_padded_csr(a: sparse.csr_matrix, total: int) -> sparse.csr_matrix:
    """Canonical CSR padded to (total, total)."""
    if a.shape[0] > total:
        raise ValueError(f"matrix has {a.shape[0]} rows > padded {total}")
    a_pad = a.copy()
    a_pad.resize((total, total))
    return a_pad


class _SliceSource:
    """Canonical row-slice access over an in-memory CSR or a memmapped
    npy triplet, padded to (total, total): the builders consume row
    ranges only, so a triplet streams at O(slice nnz) host memory."""

    def __init__(self, matrix: CsrLike, n_dev: int, width: int,
                 shard_len: Optional[int] = None):
        if sparse.issparse(matrix):
            a = as_canonical_csr(matrix)
            self.n = a.shape[0]
            self.nnz = int(a.nnz)
            self._trip = None
            self._binary_data = a.data
        else:
            data, indices, indptr = matrix
            self.n = len(indptr) - 1
            self.nnz = int(np.asarray(indptr[-1]))
            self._trip = (data, indices, indptr)
            self._binary_data = data
        self.n_dev = n_dev
        if shard_len is None:
            shard_len = max(align_up(-(-self.n // n_dev), width), width)
        self.shard_len = shard_len
        self.total = shard_len * n_dev
        if self.n > self.total:
            raise ValueError(
                f"matrix has {self.n} rows > padded {self.total}")
        self._csr = (as_padded_csr(a, self.total)
                     if sparse.issparse(matrix) else None)

    def resolve_binary(self, binary) -> bool:
        from arrow_matrix_tpu_torch.ops.sell import resolve_binary

        return resolve_binary(binary, self._binary_data, nnz=self.nnz)

    def row_degrees(self, lo: int, hi: int) -> np.ndarray:
        """Per-row nnz of padded rows [lo, hi) without materializing the
        slice."""
        if self._csr is not None:
            return np.diff(self._csr.indptr[lo:hi + 1]).astype(np.int64)
        _, _, indptr = self._trip
        out = np.zeros(hi - lo, dtype=np.int64)
        top = min(hi, self.n)
        if top > lo:
            seg = np.asarray(indptr[lo:top + 1], dtype=np.int64)
            out[:top - lo] = np.diff(seg)
        return out

    def rows(self, lo: int, hi: int) -> sparse.csr_matrix:
        """Canonical CSR of padded rows [lo, hi) x [0, total)."""
        if self._csr is not None:
            return self._csr[lo:hi]
        from arrow_matrix_tpu_torch.io.graphio import csr_row_range

        out = csr_row_range(self._trip, lo, hi, self.total)
        nnz0 = out.nnz
        out.sum_duplicates()
        out.sort_indices()
        if out.nnz != nnz0:
            raise ValueError(
                f"triplet rows [{lo}, {hi}) contain duplicate entries; "
                f"canonicalize the artifact first")
        return out


def _banded_reach(src: _SliceSource, w: int, shard_ids=None) -> int:
    """Raw halo reach in ROWS: how far body columns stray outside the
    owning shard (head-arm columns excluded), over the shards
    ``shard_ids`` (default all)."""
    L, n_dev = src.shard_len, src.n_dev
    reach = 0
    for d in (range(n_dev) if shard_ids is None else sorted(shard_ids)):
        lo = d * L
        coo = src.rows(lo, lo + L).tocoo()
        rows_g = coo.row + lo
        g = coo.col
        outside = (rows_g >= w) & (g >= w) & ((g < lo) | (g >= lo + L))
        if outside.any():
            go = g[outside]
            reach = max(reach,
                        int(np.maximum(lo - go, go - (lo + L) + 1).max()))
    return reach


def _hops_rem(reach: int, L: int, n_dev: int) -> Tuple[int, int]:
    """(hops, rem) from a raw row reach: ``hops`` whole-shard exchange
    steps, of which the FARTHEST carries only ``rem`` <= L rows."""
    if reach <= 0:
        return 0, 0
    hops_raw = -(-reach // L)
    hops = min(hops_raw, n_dev - 1)
    if hops_raw > n_dev - 1 or hops == 0:
        return hops, L if hops else 0
    rem = reach - (hops - 1) * L
    rem = min(align_up(rem, SLOT_ALIGN), L)
    return hops, rem


class _DegreesOnly:
    """Row-degree stand-in for a body share another rank packs: enough
    for the shared tier shapes and orderings, no entry data."""

    __slots__ = ("indptr",)
    indices = None

    def __init__(self, degrees: np.ndarray):
        self.indptr = np.concatenate(
            [[0], np.cumsum(degrees, dtype=np.int64)])

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def _slim_shares(src: _SliceSource, w: int, hops: int,
                 materialize: Optional[set] = None) -> Tuple[list, list]:
    """Per-device (body, head) shares via prioritized column
    categorization: local shard > head arm > halos; anything else is out
    of pattern and raises.  Body share columns: [0, L) local, [L, L+w)
    head arm, then the lo/hi halo regions of width hops*L each.  Shards
    outside ``materialize`` get :class:`_DegreesOnly` stand-ins."""
    L, n_dev = src.shard_len, src.n_dev
    H = hops * L
    head_block = src.rows(0, w)
    body_shares, head_shares = [], []
    for d in range(n_dev):
        lo, hi = d * L, (d + 1) * L
        head_shares.append(head_block[:, lo:hi].tocsr())
        if materialize is not None and d not in materialize:
            degrees = src.row_degrees(lo, hi)
            if d == 0:
                degrees = degrees.copy()
                degrees[:w] = 0          # head rows live in the head op
            body_shares.append(_DegreesOnly(degrees))
            continue
        rows = src.rows(lo, hi).tocoo()
        r, g, v = rows.row, rows.col, rows.data
        if d == 0:
            keep = (r + lo) >= w
            r, g, v = r[keep], g[keep], v[keep]
        local = (g >= lo) & (g < hi)
        head_arm = ~local & (g < w)
        lo_h = ~local & ~head_arm & (g >= lo - H) & (g < lo)
        hi_h = ~local & ~head_arm & (g >= hi) & (g < hi + H)
        cat = local | head_arm | lo_h | hi_h
        if not cat.all():
            raise ValueError(
                f"shard {d} has {int((~cat).sum())} nonzeros outside "
                f"the slim pattern at width {w} / {hops}-hop halos "
                f"(head rows/arm + shard +- reach)")
        mapped = np.where(
            local, g - lo,
            np.where(head_arm, L + g,
                     np.where(lo_h, L + w + (g - (lo - H)),
                              L + w + H + (g - hi))))
        share = sparse.csr_matrix(
            (v, (r, mapped)), shape=(L, L + w + 2 * H))
        share.sum_duplicates()
        share.sort_indices()
        body_shares.append(share)
    return body_shares, head_shares


def _carried_maps(perm: np.ndarray, body_order: np.ndarray, L: int,
                  total: int) -> Tuple[np.ndarray, np.ndarray]:
    """Carried-position <-> original-row maps for one level's tiered
    ordering: position p (device d, tiered slot) holds level row
    r = d*L + body_order[d, slot], i.e. original row perm[r]; -1 slots
    are tier padding.  Returns (orig_of_pos (T,), pos_of_orig (total,)),
    both int32, -1 where undefined."""
    n_dev, rows_out = body_order.shape
    if max(total, rows_out * n_dev) >= 2**31:
        raise ValueError(
            f"carried maps exceed int32 range "
            f"(total={total}, positions={rows_out * n_dev})")
    oop = np.full(rows_out * n_dev, -1, dtype=np.int32)
    for d in range(n_dev):
        src = body_order[d]
        live = src >= 0
        oop[d * rows_out + np.flatnonzero(live)] = perm[
            d * L + src[live]]
    poo = np.full(total, -1, dtype=np.int32)
    live = oop >= 0
    poo[oop[live]] = np.flatnonzero(live)
    return oop, poo


def _live(oop: np.ndarray, n: int) -> np.ndarray:
    """Positions of a carried ordering that hold a real original row."""
    return (oop >= 0) & (oop < n)


def _scatter_carried(x: np.ndarray, oop: np.ndarray, n: int) -> np.ndarray:
    """Host (n, k) original-order features -> (T, k) carried ordering
    (tier padding and rows past n stay zero)."""
    feat = np.zeros((oop.size, x.shape[1]), dtype=x.dtype)
    live = _live(oop, n)
    feat[live] = x[oop[live]]
    return feat


def _gather_carried(c: np.ndarray, oop: np.ndarray, n: int) -> np.ndarray:
    """(T, k) carried-order result -> host (n, k) original order."""
    out = np.zeros((n, c.shape[-1]), dtype=c.dtype)
    live = _live(oop, n)
    out[oop[live]] = c[live]
    return out


def _positions_inv(body_order: np.ndarray, L: int) -> np.ndarray:
    """inv[d, r] = tiered position of share row r on share d."""
    n_shares = body_order.shape[0]
    inv = np.zeros((n_shares, L), dtype=np.int64)
    for d in range(n_shares):
        live = body_order[d] >= 0
        inv[d, body_order[d][live]] = np.flatnonzero(live)
    return inv


def _local_operand_width(rows_out: int, w: int, hops: int, L: int) -> int:
    """Rows of the operand a rank's body product gathers from:
    [tiered rows | X_0 (w) | lo halos hops*L | hi halos hops*L]."""
    return rows_out + w + 2 * hops * L


def _remap_body_cols(body: SellShardStack, inv: np.ndarray, L: int,
                     rows_out: int, w: int, hops: int,
                     materialize: Optional[set] = None) -> SellShardStack:
    """Body column remap: share column c -> [0, L): local -> tiered
    position; [L, L+w): head -> R + (c-L); halos pass through past R.
    Indices narrow to int16 whenever the operand fits."""
    R = rows_out
    idx_dtype = block_index_dtype(_local_operand_width(rows_out, w,
                                                       hops, L))
    remapped = []
    for c in body.cols:
        out = np.zeros(c.shape, dtype=idx_dtype)
        for d in range(c.shape[0]):
            if materialize is not None and d not in materialize:
                continue
            cd = c[d].astype(np.int64)
            local = inv[d, np.minimum(cd, L - 1)]
            out[d] = np.where(cd < L, local, R + (cd - L)).astype(idx_dtype)
        remapped.append(out)
    return SellShardStack(cols=tuple(remapped), deg=body.deg, data=body.data)


def _remap_head_cols(head: SellShardStack, inv: np.ndarray, L: int,
                     rows_out: int,
                     materialize: Optional[set] = None) -> SellShardStack:
    idx_dtype = block_index_dtype(rows_out)
    remapped_head = []
    for c in head.cols:
        out = np.zeros(c.shape, dtype=idx_dtype)
        for d in range(c.shape[0]):
            if materialize is not None and d not in materialize:
                continue
            out[d] = inv[d, np.minimum(c[d], L - 1)].astype(idx_dtype)
        remapped_head.append(out)
    return SellShardStack(cols=tuple(remapped_head), deg=head.deg,
                          data=head.data)


@dataclass
class SlimLevelOps:
    """One level's host packing (every device's arrays, the JAX
    ``SlimLevelOps`` fields as numpy) and, once :meth:`to_rank` ran,
    this rank's device operators."""

    body: SellShardStack
    head: SellShardStack
    head_unsort: np.ndarray       # (w,) int32
    orig_pos: np.ndarray          # (n_dev, L) int32
    body_order: np.ndarray        # (n_dev, rows_out)
    rows_out: int
    shard_len: int
    n_dev: int
    width: int
    hops: int
    rem: int
    binary: bool
    rank: Optional[int] = None
    dev: dict = field(default_factory=dict, repr=False)

    @property
    def total_out(self) -> int:
        return self.rows_out * self.n_dev

    @property
    def operand_rows(self) -> int:
        return _local_operand_width(self.rows_out, self.width, self.hops,
                                    self.shard_len)

    def device_nbytes(self) -> int:
        return (self.body.device_nbytes() + self.head.device_nbytes()
                + self.orig_pos.size * self.orig_pos.dtype.itemsize)

    def to_rank(self, d: int, device) -> "SlimLevelOps":
        """Place device ``d``'s operators on ``device`` (K1's body and
        head, the halo gather table, the head unsort)."""
        dev = torch.device(device)
        self.rank = d
        self.dev = {
            "body": self.body.rank_operator(d, self.operand_rows, dev),
            "head": self.head.rank_operator(d, self.rows_out, dev),
            "orig_pos": torch.from_numpy(
                self.orig_pos[d].astype(np.int32)).to(dev),
            "head_unsort": torch.from_numpy(
                self.head_unsort.astype(np.int32)).to(dev)}
        return self

    def rank_nbytes(self) -> int:
        """Bytes of this rank's device operators."""
        return nbytes_of(self.dev["body"], self.dev["head"],
                         self.dev["orig_pos"], self.dev["head_unsort"])


def build_slim_level(matrix, width: int, n_dev: int, dtype, binary: bool,
                     shard_len: Optional[int] = None, ladder=None,
                     materialize: Optional[set] = None,
                     reach: Optional[int] = None) -> SlimLevelOps:
    """One level's host packing over ``n_dev`` shards (the JAX
    ``build_slim_level``).  ``materialize`` lists the shards whose body
    entries are packed (default all; the others keep zero pages);
    ``reach``, when given, is the halo reach every rank agreed on (a
    rank scans only its own shard)."""
    w = width
    src = (matrix if isinstance(matrix, _SliceSource)
           else _SliceSource(matrix, n_dev, w, shard_len=shard_len))
    L = src.shard_len
    if reach is None:
        reach = _banded_reach(src, w, shard_ids=materialize)
    hops, rem = _hops_rem(reach, L, n_dev)
    body_shares, head_shares = _slim_shares(src, w, hops,
                                            materialize=materialize)

    growth, align = resolve_ladder(ladder)
    ladder_body = degree_ladder(
        max((int(np.diff(s.indptr).max()) if s.nnz else 0)
            for s in body_shares), growth, align)
    head_glob_deg = sum(np.diff(h.indptr) for h in head_shares)
    ladder_head = degree_ladder(
        int(head_glob_deg.max()) if head_glob_deg.size else 0,
        growth, align)

    body, body_order, rows_out = _pack_shard_tiers(
        body_shares, ladder_body, binary, dtype)
    head, head_order, _ = _pack_shard_tiers(
        head_shares, ladder_head, binary, dtype,
        shared_degrees=head_glob_deg)

    if not np.array_equal(body_order[0, :w], np.arange(w)):
        raise AssertionError(
            "device 0's head rows must lead its tiered ordering "
            "(stable zero-tier sort invariant)")

    inv = _positions_inv(body_order, L)
    body = _remap_body_cols(body, inv, L, rows_out, w, hops,
                            materialize=materialize)
    head = _remap_head_cols(head, inv, L, rows_out,
                            materialize=materialize)

    if not np.all(head_order[0] == head_order):
        raise AssertionError("head tier ordering must be "
                             "device-independent")
    head_unsort = np.argsort(head_order[0][:w])[:w].astype(np.int32)
    return SlimLevelOps(
        body=body, head=head, head_unsort=head_unsort,
        orig_pos=inv.astype(np.int32), body_order=body_order,
        rows_out=rows_out, shard_len=L, n_dev=n_dev, width=w, hops=hops,
        rem=rem, binary=binary)


def rank_slim_level(src: _SliceSource, width: int, mesh: Mesh, axis: str,
                    dtype, binary: bool, ladder=None) -> SlimLevelOps:
    """This rank's level: the reach agreed over ``axis`` (each rank
    scans its own shard), its shard packed, its operators on its
    device."""
    d = mesh.axis_index(axis)
    reach = coll.all_reduce_max(
        _banded_reach(src, width, shard_ids={d}), mesh, axis)
    ops = build_slim_level(src, width, src.n_dev, dtype, binary,
                           ladder=ladder, materialize={d}, reach=reach)
    return ops.to_rank(d, mesh.device)


def slim_level_step(ops: SlimLevelOps, x: torch.Tensor, mesh: Mesh,
                    axis: str) -> torch.Tensor:
    """One level's slim step on this rank (module docstring): ``x`` its
    ``(rows_out, k)`` carriage -> ``(rows_out, k)``."""
    w, L, k = ops.width, ops.shard_len, x.shape[1]
    first = mesh.axis_index(axis) == 0
    x = x.contiguous()
    # The body's shapes are every device's, so the ranks of the line
    # agree on whether any slot reads X_0.
    if ops.body.n_slots:
        x0 = x[:w].clone() if first else x.new_empty((w, k))
        coll.broadcast(x0, mesh, axis)
    else:
        x0 = x.new_zeros((w, k))
    parts = [x, x0]
    if ops.hops:
        mine = row_gather(x, ops.dev["orig_pos"])           # (L, k)
        rem = ops.rem if ops.rem > 0 else L
        lo_chain, hi_chain = [], []
        cur_lo = cur_hi = mine
        for j in range(ops.hops):
            if j == ops.hops - 1 and rem < L:
                got_lo, got_hi = coll.shift(
                    cur_lo[L - rem:], cur_hi[:rem], mesh, axis,
                    (rem, k), (rem, k), x.dtype)
                zpad = x.new_zeros((L - rem, k))
                lo_chain.append(torch.cat([zpad, got_lo]))
                hi_chain.append(torch.cat([got_hi, zpad]))
            else:
                cur_lo, cur_hi = coll.shift(cur_lo, cur_hi, mesh, axis,
                                            (L, k), (L, k), x.dtype)
                lo_chain.append(cur_lo)
                hi_chain.append(cur_hi)
        parts += list(reversed(lo_chain)) + hi_chain
    z = torch.cat(parts)
    out = sell_spmm_cuda(ops.dev["body"], z)
    c0 = coll.reduce_to_first(sell_spmm_cuda(ops.dev["head"], x), mesh,
                              axis)
    if first:
        out[:w] = row_gather(c0, ops.dev["head_unsort"])
    return out


@dataclass
class SlimTransposed:
    """This rank's share of a level's transpose (``parallel/autograd.py``):
    ``ops`` the slim packing of ``Mᵀ`` (its own tier ordering), ``into``
    the int32 rows of ``[forward carriage; a zero row]`` that give its
    carriage, and ``back`` those of ``[its result; a zero row]`` that
    give the forward ordering's rows.  Both orderings permute the rows
    of one shard, so the two moves are local K4 gathers."""

    ops: SlimLevelOps
    into: torch.Tensor
    back: torch.Tensor

    def device_nbytes(self) -> int:
        return self.ops.rank_nbytes() + nbytes_of(self.into, self.back)


def slim_transposed(fwd: SlimLevelOps, t: SlimLevelOps,
                    device) -> SlimTransposed:
    """The moves between the forward level's carried ordering (share
    ``fwd.rank`` of its packing) and that of its transpose ``t`` (share
    ``t.rank``), one shard's rows both; tier padding reads the zero
    row."""
    d, e, L = fwd.rank, t.rank, fwd.shard_len
    inv_f = _positions_inv(fwd.body_order[d:d + 1], L)[0]
    inv_t = _positions_inv(t.body_order[e:e + 1], L)[0]
    rows_t, rows_f = t.body_order[e], fwd.body_order[d]
    into = np.where(rows_t >= 0, inv_f[np.maximum(rows_t, 0)], fwd.rows_out)
    back = np.where(rows_f >= 0, inv_t[np.maximum(rows_f, 0)], t.rows_out)
    dev = torch.device(device)
    return SlimTransposed(
        ops=t, into=torch.from_numpy(into.astype(np.int32)).to(dev),
        back=torch.from_numpy(back.astype(np.int32)).to(dev))


def level_step(op, x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """One level's step on this rank: the forward packing's
    (:func:`slim_level_step`), or a transpose's in its own ordering
    between two K4 row gathers."""
    if isinstance(op, SlimLevelOps):
        return slim_level_step(op, x, mesh, axis)
    zero = x.new_zeros((1, x.shape[1]))
    y = slim_level_step(op.ops, row_gather(x, op.into, zero), mesh, axis)
    return row_gather(y, op.back, zero)


def k1_launches(op: SellMatrix, k: int, dtype: torch.dtype) -> int:
    """K1's launches for one product of ``op`` at width ``k`` (1, or 2
    with rows split across CTAs), from its work list; 0 for no rows."""
    if k == 0 or not op.cols:
        return 0
    item = torch.empty((), dtype=dtype).element_size()
    vec = (k * item) % 16 == 0
    wl = build_worklist([tuple(c.shape) for c in op.cols], op.row_starts,
                        k, item, vecload=vec, opts=DEFAULT_OPTS)
    return wl.launches


def _int8_refused() -> ValueError:
    return ValueError(
        "int8 carriage is a fold-path capability (its (q, scale) carry "
        "pair has no sharded exchange story yet); the mesh executors "
        "carry f32 or bf16")


def _resolve_repl(mesh: Mesh, axis: str, repl_axis: Optional[str],
                  feat_axis: Optional[str] = None) -> int:
    """Validate a 2.5D replica axis request and return its factor c
    (1 when ``repl_axis is None``)."""
    if repl_axis is None:
        return 1
    if repl_axis not in mesh.axis_names:
        raise ValueError(
            f"repl_axis={repl_axis!r} is not a mesh axis "
            f"{tuple(mesh.axis_names)}; build the 2-D mesh with "
            f"make_repl_mesh(n_dev, c)")
    if repl_axis == axis:
        raise ValueError(
            f"repl_axis={repl_axis!r} must differ from the block "
            f"axis {axis!r}")
    if feat_axis is not None:
        raise ValueError(
            "repl_axis composes with feat_axis=None: the k-tiling "
            "axis already shards the feature rows across devices; "
            "the replica groups split them across exchange rounds")
    return int(mesh.shape[repl_axis])


def _dtype_name(feature_dtype: torch.dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[feature_dtype]


class _MeshExecutor:
    """What SellSlim and SellMultiLevel share: the carriage, the column
    schedule, gathering, and the reports."""

    mesh: Mesh
    axis: str
    feat_axis: Optional[str] = None
    repl_axis: Optional[str] = None
    repl: int = 1
    overlap_slabs: int = 1
    n: int
    feature_dtype: torch.dtype
    _oop: np.ndarray
    rows_local: int

    carries_feature_major = True

    @property
    def device(self) -> torch.device:
        """This rank's device (its mesh's)."""
        return self.mesh.device

    def reduce_axes(self) -> tuple:
        """The mesh axes a whole-carriage reduction sums over: the ones
        that split the carriage (the block axis, and ``feat_axis``)."""
        return (self.axis,) + ((self.feat_axis,) if self.feat_axis
                               else ())

    def level_matrices(self) -> list:
        """Each level's global matrix, which every rank holds."""
        return self._matrices

    def pack_transposed(self, i: int, matrix) -> SlimTransposed:
        """This rank's share of ``matrix`` (level ``i``'s transpose):
        the level's packer at its width, shard length, ladder and
        carriage, over the block axis, with the moves between the two
        orderings."""
        o = self._level_ops()[i]
        src = _SliceSource(matrix, o.n_dev, self.width,
                           shard_len=o.shard_len)
        t = rank_slim_level(src, self.width, self.mesh, self.axis,
                            self._dtype, self.binary, ladder=self._ladder)
        return slim_transposed(o, t, self.mesh.device)

    def transposed(self):
        """``Aᵀ`` on this rank, built at the first call
        (``parallel/autograd.py:transpose_levels``): symmetric levels
        reuse their forward shards and pack nothing."""
        from arrow_matrix_tpu_torch.parallel.autograd import (
            transpose_levels,
        )

        if getattr(self, "_transposed", None) is None:
            self._transposed = transpose_levels(
                self.level_matrices(), self._level_ops(),
                self.pack_transposed, self.mesh.device)
        return self._transposed

    def transposed_step(self, g: torch.Tensor) -> torch.Tensor:
        """``Aᵀ g`` on this rank's f32 carriage, with no autograd: the
        step's routing over the transposed levels, under the same column
        schedule."""
        levels = self.transposed().blocks
        return self._schedule(lambda gs: self._chain(gs, levels), g)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One iteration ``X := A @ X`` on this rank's carriage, past the
        fault hook ``sell_slim.step``, differentiable in ``x`` (its
        backward is :meth:`transposed_step`; the collectives run inside
        the autograd Function)."""
        from arrow_matrix_tpu_torch.faults import on_step as _fault_hook
        from arrow_matrix_tpu_torch.parallel.autograd import StepFunction

        x = _fault_hook("sell_slim.step", x)
        return StepFunction.apply(x, self, self.step_operands())

    def raw_step(self, x: torch.Tensor, *operands) -> torch.Tensor:
        """The step's kernels and collectives, with no autograd."""
        levels = self._level_ops()
        return self._schedule(lambda xs: self._chain(xs, levels), x)

    @property
    def step_fn(self):
        """``step(x) == step_fn(x, *step_operands())``."""
        from arrow_matrix_tpu_torch.parallel.autograd import StepFunction

        return lambda x, *operands: StepFunction.apply(x, self, operands)

    def _feature_slice(self, k: int) -> slice:
        if self.feat_axis is None:
            return slice(0, k)
        f = self.mesh.shape[self.feat_axis]
        if k % f:
            raise ValueError(f"feat_axis of {f} ranks must divide k={k}")
        j = self.mesh.axis_index(self.feat_axis)
        return slice(j * (k // f), (j + 1) * (k // f))

    def set_features(self, x: np.ndarray) -> torch.Tensor:
        """Host (n, k) original order -> this rank's (rows_out, k)
        carriage (its rows of the carried ordering; its feature slice
        under ``feat_axis``) on its device, in the carriage dtype."""
        x = np.asarray(x)
        n, k = x.shape
        if n != self.n:
            raise ValueError(f"expected {self.n} rows, got {n}")
        d = self.mesh.axis_index(self.axis)
        R = self.rows_local
        feat = _scatter_carried(x, self._oop[d * R:(d + 1) * R], n)
        feat = np.ascontiguousarray(feat[:, self._feature_slice(k)],
                                    dtype=np.float32)
        return torch.from_numpy(feat).to(self.feature_dtype).to(
            self.mesh.device)

    def merge_carries(self, c: torch.Tensor) -> torch.Tensor:
        """The canonical carriage: under ``repl_axis`` the replicas'
        partial carriages merged (:func:`~.routing.repl_merge`),
        identity otherwise."""
        if self.repl > 1:
            return repl_merge(c, self.mesh, self.repl_axis)
        return c

    def gather_result(self, c: torch.Tensor) -> np.ndarray:
        """This rank's carriage -> the global host (n, k) f32 result in
        original row order, on every rank (the JAX ``fetch_replicated``
        and the unsort)."""
        c = self.merge_carries(c).float().contiguous()
        full = coll.all_gather(c, self.mesh, self.axis)
        if self.feat_axis is not None:
            f = self.mesh.shape[self.feat_axis]
            parts = coll.all_gather(full, self.mesh, self.feat_axis)
            full = parts.view(f, *full.shape).permute(1, 0, 2).reshape(
                full.shape[0], f * full.shape[1])
        return _gather_carried(full.cpu().numpy(), self._oop, self.n)

    def carried_mask(self) -> torch.Tensor:
        """(rows_out, 1) f32 validity mask of this rank's carriage: 1
        where a position holds a real original row, 0 at tier padding
        (``(1, total_out)`` feature-major in the JAX package)."""
        d = self.mesh.axis_index(self.axis)
        R = self.rows_local
        m = _live(self._oop[d * R:(d + 1) * R], self.n)
        return torch.from_numpy(m.astype(np.float32)[:, None]).to(
            self.mesh.device)

    def _schedule(self, step, x: torch.Tensor) -> torch.Tensor:
        """``step`` under the column schedule: each replica group's slab
        (``repl_axis``) in ``overlap_slabs`` sub-slabs."""
        k = x.shape[1]
        xs = repl_slab_take(x, self.mesh, self.repl_axis) \
            if self.repl > 1 else x
        slabs = overlap_slices(xs.shape[1], self.overlap_slabs)
        if len(slabs) == 1:
            out = step(xs.contiguous())
        else:
            out = torch.cat([step(xs[:, lo:hi].contiguous())
                             for lo, hi in slabs], dim=1)
        if self.repl > 1:
            out = repl_slab_scatter(out, k, self.mesh, self.repl_axis)
        return out

    def run(self, x: torch.Tensor, iterations: int,
            donate: bool = False) -> torch.Tensor:
        """``iterations`` chained steps (``donate`` is the reference's
        signature: an eager loop keeps no old carriage)."""
        del donate
        for _ in range(iterations):
            x = self.step(x)
        return x

    def shard_report(self) -> dict:
        """Per-device load report (``obs/imbalance.py`` schema), the
        ranks' own counts all-gathered."""
        from arrow_matrix_tpu_torch.obs.imbalance import summarize_units

        mine = torch.tensor([self._local_stats()], dtype=torch.int64)
        n_dev = self.mesh.shape[self.axis]
        got = coll.all_gather(mine.to(self.mesh.device), self.mesh,
                              self.axis).cpu().numpy().reshape(n_dev, 3)
        return summarize_units(got[:, 0], got[:, 1], got[:, 2],
                               units="device")


def _stats_of(ops: List[SlimLevelOps]) -> Tuple[int, int, int]:
    rows = nnz = slots = 0
    for o in ops:
        d = o.rank
        for stack in (o.body, o.head):
            s_nnz, s_slots = stack.shard_stats()
            nnz += int(s_nnz[d])
            slots += int(s_slots[d])
        rows += o.rows_out
    return rows, nnz, slots


def _resolve_tune_plan(plan, plan_k, **kw):
    from arrow_matrix_tpu_torch.tune.plan import resolve_plan

    return resolve_plan(plan, plan_k=plan_k, **kw)


class SellSlim(_MeshExecutor):
    """One arrow matrix distributed over a mesh axis in padding-free
    layouts (module docstring): ``set_features`` / ``spmm`` /
    ``gather_result``."""

    def __init__(self, matrix: CsrLike, width: int, mesh: Mesh,
                 axis: str = "blocks", dtype=np.float32,
                 binary="auto", feature_dtype=None, ladder=None,
                 overlap_slabs: int = 1,
                 repl_axis: Optional[str] = None,
                 plan=None, plan_k: Optional[int] = None):
        self.tune_plan = None
        if plan is not None:
            resolved = _resolve_tune_plan(plan, plan_k)
            if resolved is not None:
                self.tune_plan = resolved
                ladder = (resolved.fold_growth,
                          SLOT_ALIGN if resolved.fold_align is None
                          else resolved.fold_align)
                overlap_slabs = resolved.overlap_slabs
                feature_dtype = resolved.feature_dtype
        self.repl_axis = repl_axis
        self.repl = _resolve_repl(mesh, axis, repl_axis)
        src = _SliceSource(matrix, mesh.shape[axis], width)
        is_binary = src.resolve_binary(binary)
        self.feature_dtype = resolve_feature_dtype(feature_dtype)
        if self.feature_dtype == torch.int8:
            raise _int8_refused()
        self.n = src.n
        self.binary = is_binary
        self.mesh = mesh
        self.axis = axis
        self.width = width
        self.ladder = resolve_ladder(ladder)
        self._ladder, self._dtype = ladder, dtype
        self._matrices = [matrix]
        ops = rank_slim_level(src, width, mesh, axis, dtype, is_binary,
                              ladder=ladder)
        self.ops = ops
        self.body, self.head = ops.body, ops.head
        self.body_order = ops.body_order
        self.rows_out, self.shard_len = ops.rows_out, ops.shard_len
        self.rows_local = ops.rows_out
        self.n_dev = ops.n_dev
        self.total_out = ops.total_out
        self._oop, _ = _carried_maps(
            np.arange(self.shard_len * self.n_dev), ops.body_order,
            self.shard_len, self.shard_len * self.n_dev)
        self.overlap_slabs = int(overlap_slabs)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """One distributed SpMM step on this rank's carriage,
        differentiable in ``x`` (its backward is the transposed step)."""
        from arrow_matrix_tpu_torch.parallel.autograd import StepFunction

        return StepFunction.apply(x, self, self.step_operands())

    step = spmm

    def step_operands(self) -> tuple:
        """This rank's operands of a step: its level."""
        return (self.ops,)

    def _level_ops(self) -> list:
        return [self.ops]

    def _chain(self, x: torch.Tensor, levels: list) -> torch.Tensor:
        return level_step(levels[0], x, self.mesh, self.axis)

    def _local_stats(self) -> Tuple[int, int, int]:
        return _stats_of([self.ops])

    def launch_counts(self, k: int, transposed: bool = False) -> dict:
        """Kernel launches of one step (``transposed``: of one transposed
        step, in f32) on this rank at width ``k`` on the card: {"K1",
        "K4", "K4 add"}."""
        ops = self.transposed().blocks if transposed else [self.ops]
        return _launch_counts(ops, [], [], self.mesh, self.axis,
                              self._slab_k(k), torch.float32 if transposed
                              else self.feature_dtype, self._products())

    def _slab_k(self, k: int) -> int:
        kc = k // max(self.repl, 1)
        return kc // max(self.overlap_slabs, 1)

    def _products(self) -> int:
        return max(self.overlap_slabs, 1)

    def ideal_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Paper cost model for one slim step at feature width ``k``:
        the head-partial reduction every non-root device contributes,
        O(width) rows, ÷c under 2.5D replication."""
        return (max(self.n_dev - 1, 0) * self.width
                * (k // max(self.repl, 1)) * itemsize)

    def reduce_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Per-device bytes of the 2.5D merge at gather time; 0 when
        repl == 1."""
        if self.repl <= 1:
            return 0
        return self.rows_out * k * itemsize

    def collective_contract(self, k: int, itemsize: int = None):
        """Static communication promise: the head-partial reduction (a
        gather to rank 0 in the port), the X_0 broadcast and the halo
        exchange, each carrying the k/(c·S) slab."""
        from arrow_matrix_tpu_torch.analysis.contracts import (
            CollectiveContract,
        )

        if itemsize is None:
            itemsize = self.feature_dtype.itemsize
        return CollectiveContract(
            algorithm="sell_slim",
            step_bytes=self.ideal_comm_bytes(k, itemsize),
            reduce_bytes=self.reduce_comm_bytes(k, itemsize),
            repl=self.repl,
            overlap_slabs=self.overlap_slabs,
            dtype=_dtype_name(self.feature_dtype),
            lowered_kinds=("gather", "broadcast", "collective-permute"),
            compiled_kinds=("gather", "broadcast", "collective-permute"),
            ratio_band=(0.25, 4.0),
            notes="the port counts each rank's wire bytes; the ideal "
                  "counts (n_dev-1)*width logical rows")

    def predicted_hbm_bytes(self, k: int, itemsize: int = 4,
                            repl: int = 1) -> int:
        """This rank's device operators plus its carried input and
        output at width ``k`` (``repl`` the 2.5D planning multiplier)."""
        base = self.ops.rank_nbytes() + 2 * self.rows_out * k * itemsize
        return base * max(int(repl), 1)


def _launch_counts(ops, fwd, bwd, mesh, axis, k: int, dtype,
                   products: int) -> dict:
    """Launches of one step on this rank on the card (see
    SellMultiLevel.launch_counts)."""
    from arrow_matrix_tpu_torch.parallel.routing import (
        GatherTable,
        RankRoute,
    )

    first = mesh.axis_index(axis) == 0
    k1 = k4 = k4_add = 0
    for o in ops:
        if isinstance(o, SlimTransposed):   # its two ordering moves
            o = o.ops
            k4 += 2
        k1 += (k1_launches(o.dev["body"], k, dtype)
               + k1_launches(o.dev["head"], k, dtype))
        k4 += int(o.hops > 0) + int(first)
    for routes, adds in ((fwd, False), (bwd, True)):
        for r in routes:
            if isinstance(r, RankRoute):
                k4 += int(r.slots > 0)
            elif not isinstance(r, GatherTable):
                raise TypeError(f"no launch count for {type(r).__name__}")
            if adds and dtype == torch.float32:
                k4_add += 1
            else:
                k4 += 1
    return {"K1": k1 * products, "K4": k4 * products,
            "K4 add": k4_add * products}


def carried_route_tables(levels, ops: List[SlimLevelOps], shard_len: int,
                         total: int) -> tuple:
    """Level 0's carried ordering (original row of each position, -1 at
    tier padding) and, for each pair of adjacent levels, the global
    gather tables of the forward and backward reorderings: ``(idx int32,
    pad mask, source positions, source rows a rank)``, each destination
    position's source position (tier-padding destinations point at 0
    and are flagged).  The JAX constructor's tables, on the host."""
    def maps_for(i: int):
        perm = pad_permutation(np.asarray(levels[i].permutation), total)
        return _carried_maps(perm, ops[i].body_order, shard_len, total)

    def table(dst_oop, src_poo, src_i):
        idx = np.where(dst_oop >= 0,
                       src_poo[np.minimum(dst_oop, total - 1)], 0)
        return (np.maximum(idx, 0).astype(np.int32), dst_oop < 0,
                ops[src_i].total_out, ops[src_i].rows_out)

    oop_cur, poo_cur = maps_for(0)
    oop0, tables = oop_cur, []
    for i in range(1, len(levels)):
        oop_next, poo_next = maps_for(i)
        tables.append((table(oop_next, poo_cur, i - 1),
                       table(oop_cur, poo_next, i)))
        oop_cur, poo_cur = oop_next, poo_next
    return oop0, tables


class SellMultiLevel(_MeshExecutor):
    """K decomposition levels on the padding-free layouts: per-level
    slim steps chained by composed reorderings (module docstring).

    ``SellMultiLevel(levels, width, mesh, axis="blocks",
    dtype=np.float32, binary="auto", routing="a2a", feat_axis=None,
    feature_dtype=None, ladder=None, overlap_slabs=1, repl_axis=None,
    plan=None, plan_k=None)``: the JAX class's arguments.  Every rank
    builds it from the same levels and packs its own shards.
    """

    def __init__(self, levels, width: int, mesh: Mesh,
                 axis: str = "blocks", dtype=np.float32, binary="auto",
                 routing: str = "a2a",
                 feat_axis: Optional[str] = None, feature_dtype=None,
                 ladder=None, overlap_slabs: int = 1,
                 repl_axis: Optional[str] = None,
                 plan=None, plan_k: Optional[int] = None):
        self.tune_plan = None
        if plan is not None:
            resolved = _resolve_tune_plan(plan, plan_k, levels=levels,
                                          width=width, dtype=dtype,
                                          binary=binary)
            if resolved is not None:
                self.tune_plan = resolved
                ladder = (resolved.fold_growth,
                          SLOT_ALIGN if resolved.fold_align is None
                          else resolved.fold_align)
                overlap_slabs = resolved.overlap_slabs
                feature_dtype = resolved.feature_dtype
        if routing not in ("gather", "a2a"):
            raise ValueError(f"unknown routing {routing!r}")
        if overlap_slabs > 1 and feat_axis is not None:
            raise ValueError(
                "overlap_slabs composes with feat_axis=None: the "
                "k-tiling axis already splits the feature rows across "
                "devices; the overlap schedule splits them in time")
        self.overlap_slabs = int(overlap_slabs)
        self.routing = routing
        self.feat_axis = feat_axis
        self.repl_axis = repl_axis
        self.repl = _resolve_repl(mesh, axis, repl_axis,
                                  feat_axis=feat_axis)
        if self.repl > 1 and routing == "gather":
            raise ValueError(
                "repl_axis composes with routing='a2a': the GSPMD "
                "gather lowering treats the carried features as "
                "replicated, but the 2.5D slab carriage is divergent "
                "across replica groups (verified corrupt, not just "
                "reordered f32)")
        self.feature_dtype = resolve_feature_dtype(feature_dtype)
        if self.feature_dtype == torch.int8:
            raise _int8_refused()
        if not levels:
            raise ValueError("empty decomposition")
        self.mesh = mesh
        self.axis = axis
        self.width = width
        self.ladder = resolve_ladder(ladder)
        self._ladder, self._dtype = ladder, dtype
        self._matrices = [lvl.matrix for lvl in levels]
        n_dev = mesh.shape[axis]
        self.n = num_rows(levels[0].matrix)
        shard_len = max(align_up(-(-self.n // n_dev), width), width)
        total = shard_len * n_dev
        srcs = [_SliceSource(lvl.matrix, n_dev, width, shard_len=shard_len)
                for lvl in levels]
        if binary is False:
            self.binary = False
        else:
            self.binary = all(s.resolve_binary(binary) for s in srcs)
        self.ops: List[SlimLevelOps] = [
            rank_slim_level(s, width, mesh, axis, dtype, self.binary,
                            ladder=ladder)
            for s in srcs]
        self.rows_local = self.ops[0].rows_out

        self._oop, self._tables = carried_route_tables(
            levels, self.ops, shard_len, total)
        self._compile_routes()

        from arrow_matrix_tpu_torch.utils import commstats

        padded = [pad_permutation(np.asarray(lvl.permutation), total)
                  for lvl in levels]
        self._ideal_route_units = commstats.ideal_routing_bytes(
            padded, n_dev, 1, itemsize=1)

    def _compile_routes(self) -> None:
        n_dev = self.mesh.shape[self.axis]

        def route(idx, pad, src_total_out, src_rows):
            if self.routing == "a2a":
                rt = build_route(idx, n_dev, src_total=src_total_out,
                                 pad_mask=pad)
                return shard_route(rt, self.mesh, self.axis)
            return gather_table(idx, self.mesh, self.axis)

        self.fwd = [route(*f) for f, _ in self._tables]
        self.bwd = [route(*b) for _, b in self._tables]

    def with_routing(self, routing: str) -> "SellMultiLevel":
        """This executor with its reorderings compiled for ``routing``
        ("a2a" or "gather"), sharing its levels (no repacking)."""
        import copy

        if routing not in ("gather", "a2a"):
            raise ValueError(f"unknown routing {routing!r}")
        if self.repl > 1 and routing == "gather":
            raise ValueError("repl_axis composes with routing='a2a'")
        other = copy.copy(self)
        other.routing = routing
        other._compile_routes()
        return other

    def to(self, device) -> "SellMultiLevel":
        """Move this rank's operators and route tables to ``device`` (and
        the mesh's collectives with them): a rank can pack on the host
        with a CPU mesh device and take the card afterwards."""
        dev = torch.device(device)
        for o in self.ops:
            o.to_rank(o.rank, dev)
        self._transposed = None
        for r in self.fwd + self.bwd:
            for name in ("send", "unpack", "idx"):
                if hasattr(r, name):
                    setattr(r, name, getattr(r, name).to(dev))
            if hasattr(r, "_init"):
                r._init.clear()
        self.mesh.device = dev
        return self

    def _level_ops(self) -> list:
        return self.ops

    def _chain(self, x: torch.Tensor, levels: list) -> torch.Tensor:
        """The levels' steps chained by the routes (the forward levels,
        or the transposed ones: the routing is its own transpose)."""
        mesh, axis = self.mesh, self.axis
        x_cur = x
        partials = []
        for i, o in enumerate(levels):
            if i > 0:
                x_cur = take(x_cur, self.fwd[i - 1], mesh, axis)
            partials.append(level_step(o, x_cur, mesh, axis))
        agg = partials[-1]
        for i in range(len(levels) - 1, 0, -1):
            agg = take(agg, self.bwd[i - 1], mesh, axis,
                       add_to=partials[i - 1])
        return agg

    def step_operands(self) -> tuple:
        """This rank's operands of a step: the levels, fwd and bwd."""
        return (self.ops, self.fwd, self.bwd)

    def _local_stats(self) -> Tuple[int, int, int]:
        return _stats_of(self.ops)

    def launch_counts(self, k: int, transposed: bool = False) -> dict:
        """Kernel launches of one step on this rank at width ``k`` on the
        card: "K1" (body and head of every level, 1 or 2 a product),
        "K4" (each level's halo gather and, on the first rank, its head
        unsort; each a2a exchange's pack when it has slots and each
        forward unpack; each "gather" route's gather) and "K4 add" (each
        backward unpack of an f32 carriage), times the overlap slabs.
        ``transposed``: of one transposed step (f32; a level packed
        transposed adds its two ordering moves)."""
        ops = self.transposed().blocks if transposed else self.ops
        return _launch_counts(ops, self.fwd, self.bwd, self.mesh,
                              self.axis, self._slab_k(k),
                              torch.float32 if transposed
                              else self.feature_dtype,
                              max(self.overlap_slabs, 1))

    def _slab_k(self, k: int) -> int:
        if self.feat_axis is not None:
            k //= self.mesh.shape[self.feat_axis]
        kc = k // max(self.repl, 1)
        return kc // max(self.overlap_slabs, 1)

    def exchanges(self) -> int:
        """Routed exchanges a step makes (forward and backward)."""
        return len(self.fwd) + len(self.bwd)

    def ideal_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Paper cost model for one multi-level step at width ``k``:
        inter-level routing (rows that change device, both directions)
        plus each level's O(width) head exchange, ÷c under 2.5D."""
        n_dev = self.mesh.shape[self.axis]
        per_level_head = max(n_dev - 1, 0) * self.width
        return (self._ideal_route_units
                + len(self.ops) * per_level_head) \
            * (k // max(self.repl, 1)) * itemsize

    def reduce_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Per-device bytes of the 2.5D merge at gather time; 0 when
        repl == 1."""
        if self.repl <= 1:
            return 0
        return self.ops[0].rows_out * k * itemsize

    def collective_contract(self, k: int, itemsize: int = None):
        """Static communication promise: the routed exchanges
        (all-to-all; all-gather under ``routing="gather"``), each
        level's head reduction (a gather to rank 0), X_0 broadcast and
        halos, every collective carrying the k/(c·S) slab."""
        from arrow_matrix_tpu_torch.analysis.contracts import (
            CollectiveContract,
        )

        if itemsize is None:
            itemsize = self.feature_dtype.itemsize
        route = "all-to-all" if self.routing == "a2a" else "all-gather"
        kinds = (route, "gather", "broadcast", "collective-permute")
        return CollectiveContract(
            algorithm="sell_multi",
            step_bytes=self.ideal_comm_bytes(k, itemsize),
            reduce_bytes=self.reduce_comm_bytes(k, itemsize),
            repl=self.repl,
            overlap_slabs=self.overlap_slabs,
            dtype=_dtype_name(self.feature_dtype),
            lowered_kinds=kinds,
            compiled_kinds=kinds,
            ratio_band=(0.25, 4.0),
            donated_params=(0,),
            hot_copy_budget=16 * self.overlap_slabs,
            notes="a2a fixed-slot padding sits above the moved-row "
                  "ideal; the band absorbs it")

    def predicted_hbm_bytes(self, k: int, itemsize: int = 4,
                            repl: int = 1) -> int:
        """This rank's device operators and route tables plus its
        carried input and output at width ``k`` (``repl`` the 2.5D
        planning multiplier)."""
        tables = 0
        for r in self.fwd + self.bwd:
            for name in ("send", "unpack", "idx"):
                t = getattr(r, name, None)
                if t is not None:
                    tables += t.numel() * t.element_size()
        base = (sum(o.rank_nbytes() for o in self.ops) + tables
                + 2 * self.ops[0].rows_out * k * itemsize)
        return base * max(int(repl), 1)

"""The work list of K1: every tier of a SELL operator in one launch.

K1 (``csrc/sell_tier_spmm.cu``, wrapper ``ops/cuda_sell.py``) runs one
CTA of :data:`THREADS` threads per *item* of a work list that
:func:`build_worklist` makes once per (operator, k, carriage) on the
host, as a pure function of the tier shapes.  A CTA is cut into thread
groups of ``group`` lanes, each lane holding ``vec`` features of one
row (16 bytes of x when the rows allow 16-byte loads); a group walks
one *chunk* of one row's slots.

Chunks.  A tier's rows of m_t slots are cut into ``S = ceil(m_t /
CHUNK_SLOTS)`` chunks of ``L = ceil(m_t / S)`` slots, so no group walks
more than :data:`CHUNK_SLOTS` slots, whatever the tier and whatever k.

Items, hub tiers first (descending m_t, so the longest rows start
first), each ``(tier, row0, chunk0, part)``.  With ``P = THREADS /
group`` groups a CTA:

* ``S <= P`` (direct, ``part = -1``): the item covers ``P // S`` rows
  from ``row0``, the S chunks of a row on consecutive groups; they add
  their sums in shared memory and write the output row.
* ``S > P`` (split): each row takes ``Q = ceil(S / P)`` items, item q
  covering chunks ``[q P, min((q + 1) P, S))`` (``chunk0 = q P``); it
  writes the sum of each of its blocks of :data:`CHUNK_BLOCK` chunks to
  rows ``part, part + 1, ...`` of a float32 workspace, and a second
  pass adds a row's ``ceil(S / CHUNK_BLOCK)`` block sums in order
  (table ``rows``: output row, first partial, partials).

Order.  A row's chunk sums are added in blocks of :data:`CHUNK_BLOCK`
consecutive chunks (each block in chunk order), then the block sums in
block order, direct or split: the order depends on S alone, never on k
or the carriage, so a feature column of a product equals the same
column of a product at any other k bit for bit (batched requests and
column slabs rely on it).  ``CHUNK_BLOCK`` is the fewest groups of a
CTA (P at 32 lanes), so a split item holds whole blocks.  No atomics:
two runs give the same bits.  Zero-slot tiers get direct items and
write zeros.

:func:`sell_spmm_worklist` is the plain twin: the same chunks, the same
partials and the same order of the chunk sums, in PyTorch.

Launch knobs (:class:`LaunchOpts`, declared by the Hopper kernel
contract ``ops/kernel_contract.py``): ``chunk_slots`` (64, 128, 256;
one value or one a tier) sets ``CHUNK_SLOTS`` and so S, which changes
the order of a row's chunk sums; ``batch`` (slot loads in flight a
lane: 4, 8) and ``ctas_per_sm`` (the launch bound: 1, 2) leave every
sum's order as it is.  A knob value outside the contract raises:
nothing falls back to the default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from arrow_matrix_tpu_torch.ops.ell import ell_tier_sums, out_dtype_for
from arrow_matrix_tpu_torch.utils.buildstats import bump

#: Threads of a K1 CTA (``csrc/sell_tier_spmm.cu:kThreads``).
THREADS = 256
#: Most slots one thread group walks: longer rows are cut into chunks
#: (chosen on the card among 64, 128 and 256; PERF.md).
CHUNK_SLOTS = 128
#: Chunks of one block of a row's sum order (``csrc``'s ``kBlock``):
#: THREADS / 32, the fewest thread groups of a CTA.
CHUNK_BLOCK = THREADS // 32
#: The ``chunk_slots`` values K1 takes (the contract's knob points).
CHUNK_SLOTS_CHOICES = (64, 128, 256)
#: The ``batch`` values K1 takes, at every carriage.
BATCH_CHOICES = (4, 8)
#: The ``ctas_per_sm`` values of K1's launch bound.
CTAS_PER_SM_CHOICES = (1, 2)
#: K1's default launch bound (``__launch_bounds__(kThreads, 2)``).
DEFAULT_CTAS_PER_SM = 2
#: The names of K1's knobs, in a plan's ``kernel_opts``.
KNOBS = ("chunk_slots", "batch", "ctas_per_sm")
#: Columns of the tier table (int64 each; ``csrc``'s ``struct Tier``).
TIER_FIELDS = ("cols", "w", "row0", "m_t", "n_t", "chunk", "split",
               "unused")


def lanes(k: int, itemsize: int, vecload: bool) -> Tuple[int, int, int]:
    """``(vec, group, col_blocks)`` of a launch: features a lane holds
    (16 bytes with 16-byte loads, else 1), lanes of a thread group (a
    power of two up to 32 covering a row), and CTAs along the features
    (more than one only when a row is wider than 32 lanes)."""
    vec = 16 // itemsize if vecload else 1
    per_row = -(-k // vec)
    group = 1
    while group < per_row and group < 32:
        group *= 2
    return vec, group, -(-per_row // group)


def default_batch(itemsize: int) -> int:
    """K1's batch for a carriage of ``itemsize`` bytes: 8, and 4 for
    int8."""
    return 4 if itemsize == 1 else 8


def chunking(m_t: int, chunk_slots: int = CHUNK_SLOTS) -> Tuple[int, int]:
    """``(L, S)``: slots per chunk and chunks per row of a tier of m_t
    slots (``(0, 1)`` for a zero-slot tier), chunks of at most
    ``chunk_slots``."""
    if m_t == 0:
        return 0, 1
    s = -(-m_t // chunk_slots)
    return -(-m_t // s), s


@dataclass(frozen=True)
class LaunchOpts:
    """K1's knobs for one launch.  ``chunk_slots`` is one value or a
    tuple of one a tier; ``batch=None`` is the carriage's default
    (:func:`default_batch`)."""

    chunk_slots: Union[int, Tuple[int, ...]] = CHUNK_SLOTS
    batch: Optional[int] = None
    ctas_per_sm: int = DEFAULT_CTAS_PER_SM

    def chunk_of(self, t: int) -> int:
        c = self.chunk_slots
        return c[t] if isinstance(c, tuple) else c

    def batch_for(self, itemsize: int) -> int:
        return default_batch(itemsize) if self.batch is None else self.batch

    def keeps_order(self) -> bool:
        """Whether every sum keeps the default's order (and bits)."""
        c = self.chunk_slots
        return all(v == CHUNK_SLOTS for v in
                   (c if isinstance(c, tuple) else (c,)))

    def check(self, n_tiers: Optional[int] = None) -> "LaunchOpts":
        """Raise ``ValueError`` unless K1 takes every knob (and, for
        per-tier chunks, ``n_tiers`` tiers); returns self."""
        chunks = (self.chunk_slots if isinstance(self.chunk_slots, tuple)
                  else (self.chunk_slots,))
        if isinstance(self.chunk_slots, tuple) and n_tiers is not None \
                and len(chunks) != n_tiers:
            raise ValueError(f"{len(chunks)} per-tier chunk_slots for "
                             f"{n_tiers} tiers")
        for c in chunks:
            if c not in CHUNK_SLOTS_CHOICES:
                raise ValueError(f"chunk_slots={c!r}: K1 takes "
                                 f"{CHUNK_SLOTS_CHOICES}")
        if self.batch is not None and self.batch not in BATCH_CHOICES:
            raise ValueError(f"batch={self.batch!r}: K1 takes "
                             f"{BATCH_CHOICES}")
        if self.ctas_per_sm not in CTAS_PER_SM_CHOICES:
            raise ValueError(f"ctas_per_sm={self.ctas_per_sm!r}: K1 takes "
                             f"{CTAS_PER_SM_CHOICES}")
        return self


DEFAULT_OPTS = LaunchOpts()


@dataclass(frozen=True)
class WorkList:
    """K1's launch plan for one operator at one (k, carriage)."""

    group: int             # lanes of a thread group
    col_blocks: int        # CTAs along the features (grid y)
    tiers: np.ndarray      # (T, 5) int64: row0, m_t, n_t, L, S
    items: np.ndarray      # (I, 4) int32: tier, row0, chunk0, part
    rows: np.ndarray       # (R, 3) int32: output row, first part, parts
    n_parts: int           # rows of the float32 workspace (block sums)

    @property
    def groups(self) -> int:
        """Thread groups of a CTA (P)."""
        return THREADS // self.group

    @property
    def launches(self) -> int:
        """Kernel launches of one product: the item pass, and the pass
        over the split rows when there are any."""
        return 1 + (len(self.rows) > 0)


def build_worklist(shapes: Sequence[Tuple[int, int]],
                   row_starts: Sequence[int], k: int, itemsize: int,
                   vecload: bool = True,
                   opts: LaunchOpts = DEFAULT_OPTS) -> WorkList:
    """The work list of an operator whose tier t has ``shapes[t] =
    (m_t, n_t)`` and writes output rows ``row_starts[t] + [0, n_t)``,
    at ``k`` features of ``itemsize`` bytes, with the chunks and item
    order of ``opts``.  A pure function of its arguments."""
    if len(shapes) != len(row_starts):
        raise ValueError("one row start per tier")
    opts.check(len(shapes))
    bump("worklists")
    _, group, col_blocks = lanes(k, itemsize, vecload)
    p = THREADS // group
    tiers = np.zeros((len(shapes), 5), np.int64)
    for t, ((m_t, n_t), r0) in enumerate(zip(shapes, row_starts)):
        tiers[t] = (r0, m_t, n_t, *chunking(int(m_t), opts.chunk_of(t)))
    order = sorted(range(len(shapes)), key=lambda t: -int(tiers[t, 1]))
    items, rows = [], []
    n_parts = 0
    for t in order:
        row0, _, n_t, _, s = (int(v) for v in tiers[t])
        if n_t == 0:
            continue
        if s <= p:
            r0 = np.arange(0, n_t, p // s, dtype=np.int64)
            it = np.zeros((r0.size, 4), np.int64)
            it[:, 0], it[:, 1], it[:, 3] = t, r0, -1
            items.append(it)
            continue
        q = -(-s // p)
        blocks = -(-s // CHUNK_BLOCK)          # block sums of a row
        r = np.repeat(np.arange(n_t, dtype=np.int64), q)
        it = np.empty((r.size, 4), np.int64)
        it[:, 0], it[:, 1] = t, r
        it[:, 2] = np.tile(np.arange(q, dtype=np.int64) * p, n_t)
        it[:, 3] = n_parts + r * blocks + it[:, 2] // CHUNK_BLOCK
        items.append(it)
        rw = np.empty((n_t, 3), np.int64)
        rw[:, 0] = row0 + np.arange(n_t)
        rw[:, 1] = n_parts + np.arange(n_t) * blocks
        rw[:, 2] = blocks
        rows.append(rw)
        n_parts += n_t * blocks
    cat = (lambda parts, width: np.concatenate(parts).astype(np.int32)
           if parts else np.zeros((0, width), np.int32))
    return WorkList(group=group, col_blocks=col_blocks,
                    tiers=tiers, items=cat(items, 4), rows=cat(rows, 3),
                    n_parts=n_parts)


def chunk_order_sum(sums: list) -> torch.Tensor:
    """The chunk sums of a row (or of rows alike) added in K1's order:
    blocks of :data:`CHUNK_BLOCK` chunks, each in chunk order, then the
    block sums in block order."""
    total = None
    for b in range(0, len(sums), CHUNK_BLOCK):
        blk = sums[b].clone()
        for c in sums[b + 1:b + CHUNK_BLOCK]:
            blk += c
        total = blk if total is None else total + blk
    return total


def sell_spmm_worklist(m, x: torch.Tensor, wl: WorkList) -> torch.Tensor:
    """Plain twin of K1 over the work list ``wl`` of ``m`` at ``x``'s k
    and carriage: ``m @ x`` row-major, ``x`` (n_rows, k) -> (n_rows, k)
    in ``out_dtype_for(x.dtype)``.

    Each chunk's float32 sum is taken by ``ell_tier_sums``; a direct
    row's chunk sums are added in K1's order (:func:`chunk_order_sum`);
    a split item writes its block sums into its workspace rows, and the
    rows table adds a row's block sums in order: the kernel's order of
    the chunk sums.  (Inside a chunk PyTorch sums in its own order.)"""
    k = x.shape[1]
    out = torch.zeros((m.n_rows, k), dtype=out_dtype_for(x.dtype),
                      device=x.device)
    part = torch.zeros((wl.n_parts, k), dtype=torch.float32,
                       device=x.device)
    items = torch.from_numpy(wl.items.astype(np.int64))
    p = wl.groups
    for t, (row0, m_t, n_t, length, s) in enumerate(wl.tiers.tolist()):
        if n_t == 0 or m_t == 0:
            continue
        data = None if m.data is None else m.data[t]
        deg = None if m.deg is None else m.deg[t]
        sums = [ell_tier_sums(
            m.cols[t][c * length:(c + 1) * length], x,
            data=None if data is None
            else data[c * length:(c + 1) * length],
            deg=deg, first_slot=c * length) for c in range(s)]
        if s <= p:
            out[row0:row0 + n_t] = chunk_order_sum(sums).to(out.dtype)
            continue
        mine = items[items[:, 0] == t]
        for chunk0 in torch.unique(mine[:, 2]).tolist():
            sel = mine[mine[:, 2] == chunk0]
            r = sel[:, 1]
            last = min(chunk0 + p, s)
            for b, c0 in enumerate(range(chunk0, last, CHUNK_BLOCK)):
                acc = sums[c0][r].clone()
                for c in range(c0 + 1, min(c0 + CHUNK_BLOCK, last)):
                    acc += sums[c][r]
                part[sel[:, 3] + b] = acc
    for orow, first, parts in wl.rows.tolist():
        acc = part[first].clone()
        for q in range(1, parts):
            acc += part[first + q]
        out[orow] = acc.to(out.dtype)
    return out


# -- the launch description the certifier reads -----------------------------

#: Registers of a K1 lane beyond its arrays (indices, pointers, loop
#: state): the certifier's register model (KC2).
BASE_REGISTERS = 16


def register_demand(vec: int, batch: int, vecload: bool) -> int:
    """Registers a K1 lane keeps live at once (the certifier's model):
    ``vec`` float accumulators, ``batch`` loaded rows (a 16-byte load is
    four registers, a scalar one one), ``batch`` weights, and
    :data:`BASE_REGISTERS`."""
    return BASE_REGISTERS + vec + batch * ((4 if vecload else 1) + 1)


def k1_meta(shapes: Sequence[Tuple[int, int]], row_starts: Sequence[int],
            n_rows: int, x_rows: int, k: int, carriage: str, binary: bool,
            vecload: bool, opts: LaunchOpts = DEFAULT_OPTS,
            itemsize: Optional[int] = None) -> dict:
    """The literal description of one K1 product (work list and launch)
    at ``k`` features of ``carriage``: what ``analysis/kernels.py``
    checks under KC1-KC5.  The wrapper launches exactly this work list
    (``ops/cuda_sell.py:build_plan`` calls :func:`build_worklist` with
    the same arguments)."""
    if itemsize is None:
        itemsize = {"f32": 4, "bf16": 2, "int8": 1}[carriage]
    wl = build_worklist(shapes, row_starts, k, itemsize, vecload=vecload,
                        opts=opts)
    vec, group, col_blocks = lanes(k, itemsize, vecload)
    batch = opts.batch_for(itemsize)
    chunk = opts.chunk_slots
    return {
        "kernel": "sell_tier_spmm", "kind": "k1_worklist",
        "k": int(k), "carriage": carriage, "itemsize": int(itemsize),
        "binary": bool(binary), "vecload": bool(vecload),
        "vec": vec, "group": group, "col_blocks": col_blocks,
        "threads": THREADS, "ctas_per_sm": opts.ctas_per_sm,
        "batch": batch,
        "chunk_slots": list(chunk) if isinstance(chunk, tuple) else chunk,
        "order_block": CHUNK_BLOCK, "kernel_block": CHUNK_BLOCK,
        "static_smem": vec * THREADS * 4, "dynamic_smem": 0,
        "regs_demand": register_demand(vec, batch, vecload),
        "accum_dtype": "f32",
        "n_rows": int(n_rows), "x_rows": int(x_rows),
        "tiers": wl.tiers.tolist(), "items": wl.items.tolist(),
        "rows": wl.rows.tolist(), "n_parts": int(wl.n_parts),
        "claims_default_order": opts.keeps_order(),
    }

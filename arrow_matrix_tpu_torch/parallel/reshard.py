"""Staged redistribution plans with a bounded scratch a stage.

The port's copy of ``arrow_matrix_tpu/parallel/reshard.py``, the whole
module (it is host code: numpy row-range plans).  A :class:`Layout`
pair compiles into a :class:`ReshardPlan` whose every stage keeps each
device's send plus receive bytes within the declared budget (checked
when the plan is built); the plans, their stages and the
:func:`layout_tag` strings are equal, field by field, to the JAX
package's for the same layouts and budgets.

  * :func:`redistribution_plan` and :func:`handoff_plan` build plans;
  * :func:`apply_plan_host` executes one on a host carriage (numpy),
    stage by stage, each stage crossing the ``reshard.stage`` fault
    seam of the port's ``faults`` (the kill-mid-migration site);
  * :func:`reshard_checkpoint` applies a plan to a layout-tagged
    checkpoint of the port's ``utils/checkpoint.py`` (npz, sha256
    verified): load, apply, save atomically under the destination tag;
  * :func:`plan_route_table` is the plan's global gather table and pad
    mask.  ``parallel/routing.build_route`` compiles it for a mesh and
    ``split_route_stages`` bounds each stage's scratch, which the
    collective prover's H7 (``analysis/prove.py``) and the reshard
    gate's ``reshard_h7`` hold.

``FleetRouter.migrate`` (``fleet/router.py``) hands a tenant's
checkpoints between workers through :func:`handoff_plan` and
:func:`apply_plan_host`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Layout:
    """One carried-feature layout, replica-expanded.

    ``total_rows`` is the padded logical row count (one replica's
    carriage); ``repl`` replicas store ``total_rows * repl`` rows in
    replica-major order (stored row ``j`` = replica ``j // total_rows``,
    logical row ``j % total_rows``).  ``n_dev`` devices shard the
    stored rows contiguously; ``tag`` is the checkpoint
    layout tag this layout carries (checkpoint.load_state verifies it).
    """

    total_rows: int
    n_dev: int = 1
    repl: int = 1
    tag: str = ""

    def __post_init__(self):
        if self.total_rows <= 0 or self.n_dev <= 0 or self.repl <= 0:
            raise ValueError(f"degenerate layout {self}")
        if self.stored_rows % self.n_dev:
            raise ValueError(
                f"stored rows {self.stored_rows} (= {self.total_rows} x "
                f"repl {self.repl}) not divisible by n_dev={self.n_dev}")

    @property
    def stored_rows(self) -> int:
        return self.total_rows * self.repl

    @property
    def rows_per_dev(self) -> int:
        return self.stored_rows // self.n_dev


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One contiguous row-range copy: ``out[dst_start : dst_start+rows]
    = x[src_start : src_start+rows]`` riding the (src_dev -> dst_dev)
    message.  ``src_dev == -1`` marks a zero-fill range (dst padding
    with no source rows)."""

    src_dev: int
    dst_dev: int
    src_start: int
    dst_start: int
    rows: int

    def bytes(self, k: int, itemsize: int) -> int:
        return self.rows * k * itemsize


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """A staged redistribution schedule between two layouts.

    ``stages`` hold only cross-device chunks; ``local_ops`` (same-device
    copies) and ``fill_ops`` (zero-fill of dst padding) cost no message
    scratch and run before stage 0.  Invariant, enforced at build time:
    for every stage, every device's send bytes + recv bytes
    <= ``scratch_budget_bytes``.
    """

    src: Layout
    dst: Layout
    k: int
    itemsize: int
    scratch_budget_bytes: int
    local_ops: Tuple[Chunk, ...]
    fill_ops: Tuple[Chunk, ...]
    stages: Tuple[Tuple[Chunk, ...], ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def is_noop(self) -> bool:
        """True when no rows move or fill — src and dst carriage are
        byte-identical (same layout, identity table)."""
        return (not self.stages and not self.fill_ops
                and all(c.src_start == c.dst_start for c in self.local_ops)
                and self.src.stored_rows == self.dst.stored_rows)

    def stage_device_bytes(self, i: int) -> int:
        """Peak per-device send+recv scratch of stage ``i``."""
        load: dict = {}
        for c in self.stages[i]:
            b = c.bytes(self.k, self.itemsize)
            load[c.src_dev] = load.get(c.src_dev, 0) + b
            load[c.dst_dev] = load.get(c.dst_dev, 0) + b
        return max(load.values(), default=0)

    @property
    def max_stage_scratch_bytes(self) -> int:
        return max((self.stage_device_bytes(i)
                    for i in range(self.n_stages)), default=0)

    @property
    def moved_bytes(self) -> int:
        return sum(c.bytes(self.k, self.itemsize)
                   for st in self.stages for c in st)

    def describe(self) -> str:
        """Human-readable staged schedule (the ``migrate --dry-run``
        output): per-stage chunk counts and peak per-device bytes."""
        lines = [
            f"reshard {self.src.total_rows}x{self.k} "
            f"[n_dev={self.src.n_dev} c={self.src.repl}] -> "
            f"[n_dev={self.dst.n_dev} c={self.dst.repl}]  "
            f"budget={self.scratch_budget_bytes} B",
            f"  local copies: {len(self.local_ops)} chunk(s), "
            f"{sum(c.rows for c in self.local_ops)} row(s); "
            f"zero-fill: {sum(c.rows for c in self.fill_ops)} row(s)",
        ]
        for i, st in enumerate(self.stages):
            lines.append(
                f"  stage {i}: {len(st)} chunk(s), "
                f"{sum(c.rows for c in st)} row(s), peak per-device "
                f"send+recv {self.stage_device_bytes(i)} B")
        if not self.stages:
            lines.append("  no cross-device stages (local-only plan)")
        lines.append(
            f"  total moved {self.moved_bytes} B over {self.n_stages} "
            f"stage(s), max stage scratch "
            f"{self.max_stage_scratch_bytes} B")
        return "\n".join(lines)


def default_table(src: Layout, dst: Layout,
                  perm_map: Optional[np.ndarray] = None) -> np.ndarray:
    """The (stored_dst,) gather table ``out[j] = x[table[j]]`` between
    two replica-expanded layouts: dst logical row ``g`` sources from src
    logical row ``perm_map[g]`` (identity when None) in src replica 0;
    ``-1`` marks dst rows with no source (grown padding -> zero-fill).
    """
    g = np.arange(dst.stored_rows, dtype=np.int64) % dst.total_rows
    if perm_map is None:
        src_logical = g.copy()
    else:
        perm_map = np.asarray(perm_map, dtype=np.int64)
        if perm_map.shape != (dst.total_rows,):
            raise ValueError(
                f"perm_map shape {perm_map.shape} != "
                f"({dst.total_rows},)")
        src_logical = perm_map[g]
    oob = (src_logical < -1) | (src_logical >= src.total_rows)
    if oob.any():
        raise ValueError("perm_map entries outside [-1, src.total_rows)")
    return np.where(src_logical < 0, np.int64(-1), src_logical)


def _compress_runs(dst_rows: np.ndarray, src_rows: np.ndarray,
                   src_dev: np.ndarray, dst_dev: np.ndarray
                   ) -> List[Chunk]:
    """Compress per-row transfers (ascending dst order) into contiguous
    (src_dev, dst_dev, src_start, dst_start, rows) chunks: a run breaks
    when dst or src contiguity breaks or the device pair changes."""
    if dst_rows.size == 0:
        return []
    brk = np.flatnonzero(
        (np.diff(dst_rows) != 1) | (np.diff(src_rows) != 1)
        | (np.diff(src_dev) != 0) | (np.diff(dst_dev) != 0))
    starts = np.r_[0, brk + 1]
    ends = np.r_[brk + 1, dst_rows.size]
    return [Chunk(int(src_dev[s]), int(dst_dev[s]), int(src_rows[s]),
                  int(dst_rows[s]), int(e - s))
            for s, e in zip(starts, ends)]


def redistribution_plan(src: Layout, dst: Layout,
                        scratch_budget_bytes: int, k: int,
                        itemsize: int = 4,
                        table: Optional[np.ndarray] = None,
                        perm_map: Optional[np.ndarray] = None
                        ) -> ReshardPlan:
    """Compile the (src -> dst) redistribution into a staged schedule
    whose every stage keeps per-device send+recv scratch <=
    ``scratch_budget_bytes``.

    ``table`` (stored_dst,) maps each dst stored row to its src stored
    row (-1 = zero-fill); default: :func:`default_table` with the
    optional logical-row ``perm_map``.  Deterministic for fixed inputs:
    chunks are derived in ascending dst order and packed first-fit in
    that order (pinned by tests/test_torch_reshard.py).

    Raises ``ValueError`` loudly when the budget cannot carry even one
    row (``2 * k * itemsize`` bytes: one row sent + one received) —
    never emits an over-budget stage.
    """
    if k <= 0 or itemsize <= 0:
        raise ValueError(f"bad row geometry k={k} itemsize={itemsize}")
    row_bytes = k * itemsize
    if table is None:
        table = default_table(src, dst, perm_map)
    table = np.asarray(table, dtype=np.int64)
    if table.shape != (dst.stored_rows,):
        raise ValueError(
            f"table shape {table.shape} != ({dst.stored_rows},)")
    if ((table < -1) | (table >= src.stored_rows)).any():
        raise ValueError("table entries outside [-1, src.stored_rows)")

    j = np.arange(dst.stored_rows, dtype=np.int64)
    fill = table < 0
    dst_dev_all = j // dst.rows_per_dev
    # Zero-fill ranges: pure dst-side writes, no message scratch.
    fj = j[fill]
    fill_ops = _compress_runs(
        fj, fj, np.full(fj.size, -1, dtype=np.int64), dst_dev_all[fill]
    ) if fj.size else []
    fill_ops = [dataclasses.replace(c, src_start=0) for c in fill_ops]

    live = ~fill
    dj, tj = j[live], table[live]
    s_dev = tj // src.rows_per_dev
    d_dev = dst_dev_all[live]
    is_local = s_dev == d_dev
    local_ops = _compress_runs(dj[is_local], tj[is_local],
                               s_dev[is_local], d_dev[is_local])
    cross = _compress_runs(dj[~is_local], tj[~is_local],
                           s_dev[~is_local], d_dev[~is_local])

    if not cross:
        return ReshardPlan(src, dst, k, itemsize,
                           int(scratch_budget_bytes),
                           tuple(local_ops), tuple(fill_ops), ())

    rows_max = int(scratch_budget_bytes) // (2 * row_bytes)
    if rows_max < 1:
        raise ValueError(
            f"scratch budget {scratch_budget_bytes} B cannot carry even "
            f"one row of width k={k} (needs 2 x {row_bytes} B: one row "
            f"sent + one received) — raise the budget or narrow k; "
            f"refusing to emit an over-budget stage")

    # Split runs to <= rows_max rows per chunk, preserving order.
    chunks: List[Chunk] = []
    for c in cross:
        for off in range(0, c.rows, rows_max):
            n = min(rows_max, c.rows - off)
            chunks.append(Chunk(c.src_dev, c.dst_dev, c.src_start + off,
                                c.dst_start + off, n))

    # Deterministic first-fit stage packing: a chunk of b bytes costs b
    # send scratch on src_dev and b recv scratch on dst_dev; it joins
    # the FIRST stage where both devices stay under budget.
    stages: List[List[Chunk]] = []
    loads: List[dict] = []
    budget = int(scratch_budget_bytes)
    for c in chunks:
        b = c.bytes(k, itemsize)
        for st, load in zip(stages, loads):
            if (load.get(c.src_dev, 0) + b <= budget
                    and load.get(c.dst_dev, 0) + b <= budget):
                st.append(c)
                load[c.src_dev] = load.get(c.src_dev, 0) + b
                load[c.dst_dev] = load.get(c.dst_dev, 0) + b
                break
        else:
            stages.append([c])
            loads.append({c.src_dev: b, c.dst_dev: b})
            if b > budget:   # unreachable (rows_max bound) — belt and
                raise AssertionError(   # braces on the H7 contract
                    f"chunk {c} exceeds budget {budget}")

    plan = ReshardPlan(src, dst, k, itemsize, budget, tuple(local_ops),
                       tuple(fill_ops),
                       tuple(tuple(st) for st in stages))
    assert plan.max_stage_scratch_bytes <= budget
    return plan


def apply_plan_host(plan: ReshardPlan, x: np.ndarray,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """Execute a plan on host carriage: (stored_src, ...) ->
    (stored_dst, ...) numpy, pure row copies (bit-identical under
    replay).  Each stage crosses a ``reshard.stage`` fault-injection
    seam (target = stage index) — the kill-mid-migration scenario's
    SIGKILL site."""
    from arrow_matrix_tpu_torch.faults import inject as _fault_hook

    x = np.asarray(x)
    if x.shape[0] != plan.src.stored_rows:
        raise ValueError(
            f"carriage has {x.shape[0]} rows, plan src stores "
            f"{plan.src.stored_rows}")
    if out is None:
        out = np.zeros((plan.dst.stored_rows,) + x.shape[1:], x.dtype)
    for c in plan.local_ops:
        out[c.dst_start:c.dst_start + c.rows] = \
            x[c.src_start:c.src_start + c.rows]
    # fill_ops are already zero in the fresh output; kept in the plan so
    # describe()/accounting stay honest about grown padding.
    for i, st in enumerate(plan.stages):
        _fault_hook("reshard.stage", target=str(i))
        for c in st:
            out[c.dst_start:c.dst_start + c.rows] = \
                x[c.src_start:c.src_start + c.rows]
    return out


def host_rows(x) -> np.ndarray:
    """A carriage as numpy rows with its bits unchanged: a torch tensor
    goes to the host, a bfloat16 one as its 16-bit patterns (int16),
    which row copies carry bit for bit."""
    import torch

    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(x)


def reshard_checkpoint(src_path: str, dst_path: str, plan: ReshardPlan,
                       src_tag: Optional[str] = None,
                       dst_tag: Optional[str] = None
                       ) -> Optional[Tuple[np.ndarray, int]]:
    """Migrate a layout-tagged checkpoint through a plan: load
    (sha256-verified, src layout tag enforced) -> apply_plan_host ->
    save atomically under the dst tag.  Returns (migrated X as numpy,
    step), or None when no checkpoint exists at ``src_path``.  A
    bfloat16 carriage comes back as its 16-bit patterns (int16) and is
    saved as bfloat16.

    Kill-safety: the src checkpoint is never mutated and save_state is
    atomic (tmp + os.replace), so a SIGKILL at ANY point — including
    mid-stage inside apply_plan_host — leaves either no dst checkpoint
    or a complete one; a resume redoes the migration from src and lands
    bit-identical (pure copies).
    """
    import torch

    from arrow_matrix_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    src_tag = src_tag if src_tag is not None else (plan.src.tag or None)
    dst_tag = dst_tag if dst_tag is not None else (plan.dst.tag or None)
    got = load_state(src_path, layout=src_tag)
    if got is None:
        return None
    x, step = got
    y = apply_plan_host(plan, host_rows(x))
    out = torch.from_numpy(y)
    if x.dtype == torch.bfloat16:
        out = out.view(torch.bfloat16)
    save_state(dst_path, out, step, layout=dst_tag)
    return y, step


def handoff_plan(rows: int, k: int, scratch_budget_bytes: int,
                 itemsize: int = 4, src_tag: str = "",
                 dst_tag: str = "") -> ReshardPlan:
    """A cross-worker checkpoint handoff as a staged plan: the tenant's
    (rows, k) carriage leaves the source worker (device 0) for the
    destination worker (device 1) in identity row order, chunked so no
    stage carries more than ``scratch_budget_bytes`` per endpoint.
    FleetRouter.migrate executes these stages over the shared
    sha256-verified checkpoint dir (each stage crossing the
    ``reshard.stage`` fault seam), so the rebalance is kill-safe and
    byte-accounted like every other reshard.
    """
    if rows <= 0 or k <= 0 or itemsize <= 0:
        raise ValueError(
            f"bad handoff geometry rows={rows} k={k} itemsize={itemsize}")
    src = Layout(rows, n_dev=1, tag=src_tag)
    dst = Layout(rows, n_dev=1, tag=dst_tag)
    row_bytes = k * itemsize
    budget = int(scratch_budget_bytes)
    # The endpoints are distinct workers: a chunk of b bytes costs b on
    # the sender AND b on the receiver, never 2b on one device.
    rows_max = budget // row_bytes
    if rows_max < 1:
        raise ValueError(
            f"scratch budget {budget} B cannot carry even one handoff "
            f"row of width k={k} ({row_bytes} B) — raise the budget or "
            f"narrow k; refusing to emit an over-budget stage")
    chunks = [Chunk(0, 1, off, off, min(rows_max, rows - off))
              for off in range(0, rows, rows_max)]
    stages: List[List[Chunk]] = []
    loads: List[dict] = []
    for c in chunks:
        b = c.bytes(k, itemsize)
        for st, load in zip(stages, loads):
            if (load.get(c.src_dev, 0) + b <= budget
                    and load.get(c.dst_dev, 0) + b <= budget):
                st.append(c)
                load[c.src_dev] = load.get(c.src_dev, 0) + b
                load[c.dst_dev] = load.get(c.dst_dev, 0) + b
                break
        else:
            stages.append([c])
            loads.append({c.src_dev: b, c.dst_dev: b})
    plan = ReshardPlan(src, dst, k, itemsize, budget, (), (),
                       tuple(tuple(st) for st in stages))
    assert plan.max_stage_scratch_bytes <= budget
    return plan


def plan_route_table(plan: ReshardPlan
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A plan's global gather view for on-device execution: the
    (stored_dst,) table ``out[j] = x[table[j]]`` plus the pad mask of
    zero-fill rows — the pair the JAX package's ``routing.build_route``
    compiles for a mesh (rectangular src/dst supported)."""
    table = np.zeros(plan.dst.stored_rows, dtype=np.int64)
    mask = np.ones(plan.dst.stored_rows, dtype=bool)
    for c in plan.local_ops:
        table[c.dst_start:c.dst_start + c.rows] = np.arange(
            c.src_start, c.src_start + c.rows, dtype=np.int64)
        mask[c.dst_start:c.dst_start + c.rows] = False
    for st in plan.stages:
        for c in st:
            table[c.dst_start:c.dst_start + c.rows] = np.arange(
                c.src_start, c.src_start + c.rows, dtype=np.int64)
            mask[c.dst_start:c.dst_start + c.rows] = False
    return table, mask


def layout_tag(base: str, layout: Layout) -> str:
    """Canonical checkpoint layout tag for a resharded carriage:
    ``<base>@rows<total>c<repl>d<n_dev>`` — distinct layouts must never
    share a tag (load_state's tag check is the resume guard)."""
    return (f"{base}@rows{layout.total_rows}"
            f"c{layout.repl}d{layout.n_dev}")

"""PETSc-style 1-D row-partitioned SpMM: the first comparison baseline.

The port of ``arrow_matrix_tpu/parallel/spmm_1d.py``, one process a
slice (``parallel/mesh.py``).  Each rank owns a row slice ``A_d`` and
splits it into a *local* part (columns inside its own row range) and a
*nonlocal* part (columns owned by other slices), packed as row-major
ELL with one slot count over the mesh, exactly as the JAX package packs
them (each rank's arrays are equal to JAX's shard of that slice, byte
for byte).  The exact row-exchange tables come from the sparsity
pattern at build:

* receive patterns: the off-slice columns each slice needs, sorted (so
  grouped by owner), and the nonlocal columns renumbered into the
  ``(n_dev * slot)`` receive buffer;
* send tables: ``send_idx[d]`` the rows this rank ships to slice ``d``,
  padded to ``slot`` rows a pair.

**Sources.**  A scipy matrix is the global view: every rank reads it and
computes every slice's metadata itself, with no exchange.  A sequence is
per-slice sources (scipy matrices, ``.npz`` paths of the reference's
``{name}.part.{P}.slice.{r}.npz`` files, or callables returning either):
each rank loads only its own, and the metadata (row counts, widths,
receive patterns, slot needs) is summed over the mesh on the host side
at build, with one contributor a slice (:func:`_primary`), so no sum
counts a slice twice.

**A step on a rank** (:meth:`MatrixSlice1D.spmm`): K1 over the local
stack first, then the exchange when ``slot > 0`` (every rank agrees:
``slot`` is global): a K4 pack of the ``send_idx`` rows, one
``collectives.all_to_all`` of ``slot`` rows a pair, and K1 over the
nonlocal stack reading the receive buffer in place; the two products
summed in f32.  Each stack is one slot-major K1 tier
(``ops/ell.py:ell_stack_tier``, transposed once at build); a stack with
no slots launches nothing.  For CPU tensors the wrappers run their
plain versions; ``chunk`` bounds that plain version's gathered
intermediate only (K1 needs none).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.ops.cuda_ell import one_tier
from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
from arrow_matrix_tpu_torch.ops.cuda_sell import sell_spmm_cuda
from arrow_matrix_tpu_torch.ops.ell import (
    align_up,
    auto_chunk,
    ell_pack,
    ell_slot_stats,
    ell_stack_tier,
    ell_tier_spmm,
)
from arrow_matrix_tpu_torch.ops.sell import SellMatrix
from arrow_matrix_tpu_torch.parallel import collectives as coll
from arrow_matrix_tpu_torch.parallel.mesh import Mesh


def _primary(mesh: Mesh, axis: str) -> bool:
    """Whether this rank is its slice's one contributor to metadata sums:
    the first rank of the slice's group (coordinate 0 on every other
    axis), as the JAX package's ``_primary_slice_ids``."""
    return all(c == 0 for a, c in zip(mesh.axis_names, mesh.coords)
               if a != axis)


def exchange_sum(arr: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The sum of every rank's ``arr`` (int64, or float64 for floats)
    over the whole mesh, on every rank: the host-side metadata exchange
    of a build (the reference's Alltoall of counts).  Ranks contribute
    zeros where they are not the contributor, so each sum is exact."""
    arr = np.asarray(arr)
    kind = np.float64 if np.issubdtype(arr.dtype, np.floating) else np.int64
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=kind))
    if t.numel() == 0:
        return t.numpy()
    out = coll.all_reduce_sum(t.to(mesh.device), mesh, None)
    return out.cpu().numpy()


def exchange_ragged(mine: dict, lens: np.ndarray, n_dev: int,
                    mesh: Mesh) -> List[np.ndarray]:
    """Owned ragged int64 arrays ``{slice: array}`` -> every slice's array
    on every rank (the reference's Alltoallv of indices), through one
    :func:`exchange_sum` padded to the longest."""
    lens = np.asarray(lens, dtype=np.int64)
    maxlen = int(lens.max()) if lens.size else 0
    mat = np.zeros((n_dev, maxlen), dtype=np.int64)
    for d, arr in mine.items():
        mat[d, :arr.size] = arr
    mat = exchange_sum(mat, mesh)
    return [mat[d, :lens[d]] for d in range(n_dev)]


def _load_slice(src, dtype) -> sparse.csr_matrix:
    """One slice source -> canonical CSR: a scipy matrix, a ``.npz``
    path, or a zero-argument callable returning either."""
    if callable(src):
        src = src()
    if isinstance(src, str):
        src = sparse.load_npz(src)
    if not sparse.issparse(src):
        raise TypeError(
            f"slice source must be a scipy matrix, path, or callable, "
            f"got {type(src).__name__}")
    m = src.tocsr().astype(dtype)
    m.sum_duplicates()
    return m


def equal_slices(n: int, n_dev: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal row ranges (the reference's default
    partition)."""
    bounds = np.linspace(0, n, n_dev + 1).astype(np.int64)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_dev)]


def tier_operator(cols: np.ndarray, data: np.ndarray, x_rows: int,
                  device) -> SellMatrix:
    """A row-major ELL ``(rows, m)`` pack as one slot-major K1 tier over
    ``x_rows`` feature rows, on ``device`` (transposed here, once)."""
    c, d, _ = ell_stack_tier(torch.from_numpy(cols)[None],
                             torch.zeros(1, dtype=torch.int64),
                             data=torch.from_numpy(data)[None])
    return one_tier(c.to(device), d.to(device), None, x_rows)


def tier_product(op: SellMatrix, x: torch.Tensor,
                 chunk: Optional[int] = None) -> torch.Tensor:
    """``op @ x`` (rows, k) in f32: K1 on the card, its plain version on
    the CPU (``chunk`` slots gathered at a time there); an operator
    with no rows or no slots launches nothing and gives zeros."""
    cols = op.cols[0]
    if cols.shape[0] == 0 or cols.shape[1] == 0 or x.shape[1] == 0:
        return torch.zeros((op.n_rows, x.shape[1]), dtype=torch.float32,
                           device=x.device)
    if x.device.type == "cpu" and chunk is not None:
        return ell_tier_spmm(cols, x, data=op.data[0], chunk=chunk)
    return sell_spmm_cuda(op, x)


def tier_launches(op: SellMatrix, k: int) -> int:
    """K1's launches for one :func:`tier_product` of ``op`` at width
    ``k`` in f32 (0 where it launches nothing)."""
    from arrow_matrix_tpu_torch.parallel.sell_slim import k1_launches

    if op.cols[0].shape[0] == 0 or op.cols[0].shape[1] == 0:
        return 0
    return k1_launches(op, k, torch.float32)


def resolve_chunk(chunk, memory_fraction: float, block_bytes: int,
                  n_dev: int, device: torch.device):
    """``chunk`` as the plain version takes it: an int, None, or for
    ``"auto"`` the pair ``("auto", budget_bytes)`` sized from
    ``memory_fraction`` of the device's free memory net of the resident
    blocks (the JAX rule: on the CPU the ranks share one pool, so all
    blocks are netted out and the rest split over the ranks)."""
    if chunk != "auto":
        return chunk
    if not 0 < memory_fraction <= 1:
        raise ValueError(
            f"memory_fraction must be in (0, 1], got {memory_fraction}")
    from arrow_matrix_tpu_torch.utils.platform import device_memory_budget

    budget = device_memory_budget(device, fraction=memory_fraction)
    floor = 1 << 26
    if device.type == "cpu":
        per_dev = max(budget - block_bytes, floor) / max(n_dev, 1)
    else:
        per_dev = max(budget - block_bytes / max(n_dev, 1), floor)
    return ("auto", int(per_dev))


def step_chunk(chunk, rows: int, k: int, m: int) -> Optional[int]:
    """The slot chunk of one plain product at width ``k``."""
    if isinstance(chunk, tuple):
        return auto_chunk(rows, k, m, chunk[1])
    return chunk


class MatrixSlice1D:
    """1-D row-partitioned SpMM with exact-row exchange on a mesh axis
    (module docstring): ``set_features`` / ``spmm`` / ``gather_result``
    on this rank's slice; ``spmm`` keeps the blocked layout, so
    ``x = spmm(x)`` iterates."""

    def __init__(self, a, mesh: Mesh, axis: str = "slices",
                 slices: Optional[Sequence[Tuple[int, int]]] = None,
                 dtype=np.float32, chunk=None,
                 memory_fraction: float = 0.5):
        self.mesh = mesh
        self.axis = axis
        n_dev = mesh.shape[axis]
        self.n_dev = n_dev
        me = mesh.axis_index(axis)
        self.slice_id = me

        if sparse.issparse(a):
            # The global view: every slice's metadata computed here.
            a = a.tocsr().astype(dtype)
            a.sum_duplicates()
            n, nc = a.shape
            if n != nc:
                raise ValueError("iterated SpMM needs a square matrix")
            self.slices = (list(slices) if slices is not None
                           else equal_slices(n, n_dev))
            if len(self.slices) != n_dev:
                raise ValueError(
                    f"{len(self.slices)} slices for {n_dev} devices")
            slabs = {d: a[lo:hi].tocsr()
                     for d, (lo, hi) in enumerate(self.slices)}
            exchange = False
        else:
            sources = list(a)
            if len(sources) != n_dev:
                raise ValueError(
                    f"{len(sources)} slice sources for {n_dev} devices")
            slabs = {me: _load_slice(sources[me], dtype)}
            primary = _primary(mesh, axis)
            # Row counts and widths, one contributor a slice.
            meta = np.zeros((2, n_dev), dtype=np.int64)
            if primary:
                meta[:, me] = slabs[me].shape
            meta = exchange_sum(meta, mesh)
            rows_per, widths = meta[0], meta[1]
            if len(set(widths.tolist())) > 1:
                raise ValueError(
                    f"slice widths disagree: {sorted(set(widths.tolist()))}")
            n = int(rows_per.sum())
            if int(widths[0]) != n:
                raise ValueError(
                    f"slice width {int(widths[0])} != total rows {n} "
                    f"(iterated SpMM needs square)")
            bounds = np.concatenate([[0], np.cumsum(rows_per)])
            self.slices = [(int(bounds[d]), int(bounds[d + 1]))
                           for d in range(n_dev)]
            if slices is not None and list(slices) != self.slices:
                raise ValueError("explicit slices disagree with the "
                                 "per-source row counts")
            exchange = True
            if not primary:
                slabs = {}
        self.n = n
        starts = np.asarray([s for s, _ in self.slices], dtype=np.int64)
        stops = np.asarray([t for _, t in self.slices], dtype=np.int64)
        if starts[0] != 0 or stops[-1] != n or np.any(starts[1:] != stops[:-1]):
            raise ValueError("slices must tile [0, n) contiguously")
        self.l_rows = max(int((stops - starts).max()) if n_dev else 0, 1)

        # Receive patterns: the sorted off-slice columns each slice
        # needs (grouped by owner), and the per-slab ELL slot needs.
        off_mine: dict = {}
        cnt_mine = np.zeros((n_dev, n_dev), dtype=np.int64)  # [src, dst]
        need_mine = np.zeros((2, n_dev), dtype=np.int64)     # local/nonlocal
        for d, slab in slabs.items():
            lo, hi = self.slices[d]
            is_local = (slab.indices >= lo) & (slab.indices < hi)
            off_mine[d] = np.unique(slab.indices[~is_local]).astype(np.int64)
            owners = np.searchsorted(stops, off_mine[d], side="right")
            cnt_mine[:, d] = np.bincount(owners, minlength=n_dev)
            if slab.nnz:
                row_of = np.repeat(np.arange(slab.shape[0], dtype=np.int64),
                                   np.diff(slab.indptr))
                for part, mask in ((0, is_local), (1, ~is_local)):
                    if mask.any():
                        need_mine[part, d] = int(np.bincount(
                            row_of[mask], minlength=slab.shape[0]).max())
        if exchange:
            counts = exchange_sum(cnt_mine, mesh)
            needs = exchange_sum(need_mine, mesh)
            off_all = exchange_ragged(off_mine, counts.sum(axis=0), n_dev,
                                      mesh)
            if me not in slabs:       # a rank that contributed nothing
                slabs[me] = _load_slice(sources[me], dtype)
        else:
            counts, needs = cnt_mine, need_mine
            off_all = [off_mine[d] for d in range(n_dev)]
        # Fixed per-pair slot count (the Alltoallv's ragged counts as one
        # padded slot size), the same on every rank.
        self.slot = int(counts.max()) if counts.size else 0
        slot = self.slot
        self._ideal_route_rows = int(counts.sum()) if counts.size else 0
        cnt_cum = np.concatenate(
            [np.zeros((1, n_dev), np.int64), np.cumsum(counts, axis=0)])

        # This rank's send table: the local rows slice ``me`` ships to
        # each slice d, read off the receive patterns.
        send = np.zeros((n_dev, slot), dtype=np.int32)
        for d in range(n_dev):
            rows = off_all[d][cnt_cum[me, d]:cnt_cum[me + 1, d]]
            send[d, :rows.size] = rows - starts[me]
        self.m_l = m_l = (align_up(int(needs[0].max()), 8)
                          if needs[0].max() else 0)
        self.m_nl = m_nl = (align_up(int(needs[1].max()), 8)
                            if needs[1].max() else 0)

        def split(part: int):
            slab = slabs[me]
            lo, hi = self.slices[me]
            in_range = (slab.indices >= lo) & (slab.indices < hi)
            m = slab.copy()
            m.data = np.where(in_range if part == 0 else ~in_range,
                              slab.data, 0)
            m.eliminate_zeros()
            if part == 0:
                # Local column index == row index within the padded slice.
                return sparse.csr_matrix(
                    (m.data, m.indices - lo, m.indptr),
                    shape=(hi - lo, self.l_rows))
            # Nonlocal columns renumbered into the (n_dev * slot) receive
            # buffer: global row g owned by s at position p of the rows
            # from s lands at s * slot + p.
            needed = off_all[me]
            owners = np.searchsorted(stops, needed, side="right")
            within = (np.arange(needed.size)
                      - cnt_cum[owners, me]) if needed.size else needed
            buf_pos = owners * slot + within
            new_cols = (buf_pos[np.searchsorted(needed, m.indices)]
                        if m.nnz else np.zeros(0, dtype=np.int64))
            return sparse.csr_matrix(
                (m.data, new_cols.astype(np.int64), m.indptr),
                shape=(hi - lo, max(n_dev * slot, 1)))

        def pack(part: int):
            m_slots = m_l if part == 0 else m_nl
            cols = np.zeros((self.l_rows, m_slots), dtype=np.int32)
            data = np.zeros_like(cols, dtype=dtype)
            c, dd = ell_pack(split(part), max_nnz=m_slots, dtype=dtype)
            cols[:c.shape[0]] = c
            data[:dd.shape[0]] = dd
            return cols, data

        # This rank's shard, row-major as JAX's (its ``[d]`` entry).
        self.l_cols, self.l_data = pack(0)
        self.nl_cols, self.nl_data = pack(1)
        self.send_idx = send
        del slabs

        dev = mesh.device
        self.local_op = tier_operator(self.l_cols, self.l_data,
                                      self.l_rows, dev)
        self.nonlocal_op = tier_operator(self.nl_cols, self.nl_data,
                                         max(n_dev * slot, 1), dev)
        self.send_dev = torch.from_numpy(send.reshape(-1)).to(dev)
        block_bytes = n_dev * self.shard_nbytes()
        self.chunk = resolve_chunk(chunk, memory_fraction, block_bytes,
                                   n_dev, dev)

    # -- the step ----------------------------------------------------------

    def shard_nbytes(self) -> int:
        """Bytes of this rank's packed stacks and send table."""
        return int(sum(a.nbytes for a in (self.l_cols, self.l_data,
                                          self.nl_cols, self.nl_data,
                                          self.send_idx)))

    def set_features(self, x: np.ndarray) -> torch.Tensor:
        """Host (n, k) features -> this rank's (l_rows, k) f32 block on
        its device (a ragged slice pads zero rows at its tail)."""
        x = np.asarray(x)
        n, k = x.shape
        if n != self.n:
            raise ValueError(f"expected {self.n} rows, got {n}")
        lo, hi = self.slices[self.slice_id]
        block = np.zeros((self.l_rows, k), dtype=np.float32)
        block[:hi - lo] = x[lo:hi]
        return torch.from_numpy(block).to(self.mesh.device)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """One distributed SpMM on this rank's block (module docstring),
        keeping the blocked layout."""
        x = x.contiguous()
        k = x.shape[1]
        y = tier_product(self.local_op, x,
                         step_chunk(self.chunk, self.l_rows, k, self.m_l))
        if self.slot > 0:
            send = row_gather(x, self.send_dev)       # (n_dev * slot, k)
            recv = coll.all_to_all(send, self.mesh, self.axis)
            y += tier_product(
                self.nonlocal_op, recv,
                step_chunk(self.chunk, self.l_rows, k, self.m_nl))
        return y.to(x.dtype)

    step = spmm

    def step_operands(self) -> tuple:
        """This rank's device operands of a step (what a memory report
        counts beside the features)."""
        return (self.local_op, self.nonlocal_op, self.send_dev)

    def run(self, x: torch.Tensor, iterations: int) -> torch.Tensor:
        for _ in range(iterations):
            x = self.spmm(x)
        return x

    def launch_counts(self, k: int) -> dict:
        """Kernel launches of one step on this rank at width ``k`` on the
        card: K1 over the local stack, and with an exchange the K4 pack
        and K1 over the nonlocal stack."""
        k1 = tier_launches(self.local_op, k)
        k4 = 0
        if self.slot > 0:
            k1 += tier_launches(self.nonlocal_op, k)
            k4 = 1
        return {"K1": k1, "K4": k4, "K4 add": 0}

    def gather_result(self, y: torch.Tensor) -> np.ndarray:
        """Every rank's block -> the host (n, k) result, on every rank."""
        full = coll.all_gather(y.contiguous(), self.mesh, self.axis)
        arr = full.cpu().numpy().reshape(self.n_dev, self.l_rows, -1)
        out = np.empty((self.n, arr.shape[-1]), dtype=arr.dtype)
        for d, (lo, hi) in enumerate(self.slices):
            out[lo:hi] = arr[d, :hi - lo]
        return out

    # -- reports -----------------------------------------------------------

    def ideal_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """Paper cost model for one step at width ``k``: only the rows
        peers actually request move (the reference's Alltoallv
        payload), summed over every slice."""
        return self._ideal_route_rows * k * itemsize

    def collective_contract(self, k: int, itemsize: int = 4):
        """Static communication promise: the step's only exchange is the
        fixed-slot nonlocal-row all-to-all."""
        from arrow_matrix_tpu_torch.analysis.contracts import (
            CollectiveContract,
        )

        return CollectiveContract(
            algorithm="spmm_1d",
            step_bytes=self.ideal_comm_bytes(k, itemsize),
            reduce_bytes=0,
            repl=1,
            overlap_slabs=1,
            dtype="f32",
            lowered_kinds=("all-to-all",),
            compiled_kinds=("all-to-all",),
            ratio_band=(0.05, 2.0),
            notes="the port counts each rank's fixed-slot wire bytes; "
                  "the ideal counts every slice's requested rows")

    def predicted_hbm_bytes(self, k: int, itemsize: int = 4) -> int:
        """This rank's stacks and send table plus its blocked input and
        output (l_rows each) at width ``k``."""
        return self.shard_nbytes() + 2 * self.l_rows * k * itemsize

    def shard_report(self) -> dict:
        """Per-slice load report (``obs/imbalance.py`` schema): rows owned,
        local + nonlocal nonzeros against padded slots, each rank's own
        counts all-gathered."""
        from arrow_matrix_tpu_torch.obs.imbalance import summarize_units

        l_nnz, l_slots = ell_slot_stats(self.l_cols[None],
                                        self.l_data[None])
        nl_nnz, nl_slots = ell_slot_stats(self.nl_cols[None],
                                          self.nl_data[None])
        mine = torch.tensor([[int(l_nnz[0] + nl_nnz[0]),
                              int(l_slots[0] + nl_slots[0])]],
                            dtype=torch.int64)
        got = coll.all_gather(mine.to(self.mesh.device), self.mesh,
                              self.axis).cpu().numpy()
        rows = [hi - lo for lo, hi in self.slices]
        return summarize_units(rows, got[:, 0], got[:, 1], units="device")

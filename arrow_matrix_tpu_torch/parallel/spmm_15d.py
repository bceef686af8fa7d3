"""1.5D A-stationary SpMM: the second comparison baseline.

The port of ``arrow_matrix_tpu/parallel/spmm_15d.py``, one process a
grid cell (``parallel/mesh.py``).  P ranks form a ``(P/c, c)`` grid with
axes ``("rows", "repl")``: rank ``(i, j)`` owns the block of ``A``'s
``i``-th row slab and ``j``-th column slab, split into ``rounds =
P/c**2`` column chunks; X is row-partitioned over the grid rows and
replicated over the ``c`` grid columns.  The packing is JAX's: one
shared slot count, and each rank's ``(rounds, l_ni, m)`` ELL arrays
equal JAX's shard of its cell, byte for byte.

A step on rank ``(i, j)`` (:meth:`SpMM15D.spmm`): for each round ``r``,
block ``q = j * rounds + r`` of X is broadcast over the ``rows`` line
from its owner, grid row ``q`` (``collectives.broadcast(root=q)``: JAX's
masked psum), and K1 multiplies that round's ELL block by it, summed in
f32; then ``collectives.all_reduce_sum`` over ``repl`` adds the ``c``
partials in rank order, so the replicas are bit-identical.  Each round
block is one slot-major K1 tier, transposed once at build.

``_slab_source`` reads a scipy matrix or a memmapped ``(data|None,
indices, indptr)`` triplet slab by slab: a build holds one slab of rows
at a time.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.ops.ell import align_up, ell_pack, ell_slot_stats
from arrow_matrix_tpu_torch.parallel import collectives as coll
from arrow_matrix_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    largest_replication,
)
from arrow_matrix_tpu_torch.parallel.spmm_1d import (
    resolve_chunk,
    step_chunk,
    tier_launches,
    tier_operator,
    tier_product,
)


def _slab_source(a, dtype):
    """``(ni, nk, slab)`` for an in-memory scipy matrix or a memmapped
    triplet ``(data|None, indices, indptr)``: ``slab(lo, hi)`` is rows
    ``[lo, hi)`` as CSR (O(slab nnz) host memory from a triplet)."""
    if sparse.issparse(a):
        a = a.tocsr().astype(dtype)
        a.sum_duplicates()
        ni, nk = a.shape
        return ni, nk, lambda lo, hi: a[lo:hi]
    data, indices, indptr = a
    n = int(indptr.shape[0] - 1)

    def slab(lo, hi):
        s, e = int(indptr[lo]), int(indptr[hi])
        d = (np.ones(e - s, dtype=dtype) if data is None
             else np.asarray(data[s:e], dtype=dtype))
        m = sparse.csr_matrix(
            (d, np.asarray(indices[s:e]),
             np.asarray(indptr[lo:hi + 1]) - s),
            shape=(hi - lo, n))
        m.sum_duplicates()
        return m

    return n, n, slab


class SpMM15D:
    """A-stationary 1.5D partition of one sparse matrix on a ``(rows,
    repl)`` mesh (module docstring): ``set_features`` / ``spmm`` /
    ``as_features`` / ``gather_result`` on this rank's cell."""

    def __init__(self, a, mesh: Mesh, rows_axis: str = "rows",
                 repl_axis: str = "repl", dtype=np.float32, chunk=None,
                 memory_fraction: float = 0.5):
        self.mesh = mesh
        self.rows_axis = rows_axis
        self.repl_axis = repl_axis
        p_div_c = mesh.shape[rows_axis]
        c = mesh.shape[repl_axis]
        if p_div_c % c != 0:
            raise ValueError(
                f"grid rows {p_div_c} not divisible by replication {c} "
                f"(the reference requires P divisible by c**2)")
        self.rounds = p_div_c // c
        self.p_div_c = p_div_c
        self.c = c
        self.row = mesh.axis_index(rows_axis)
        self.col = mesh.axis_index(repl_axis)

        ni, nk, slab_of = _slab_source(a, dtype)
        self.shape = (ni, nk)
        self.l_ni = -(-ni // p_div_c)
        self.l_nkb = -(-nk // p_div_c)

        # Pass 1: the shared slot count, one slab at a time.
        need = 0
        for i in range(p_div_c):
            slab = slab_of(i * self.l_ni, min(ni, (i + 1) * self.l_ni))
            if slab.nnz:
                rows = np.repeat(np.arange(slab.shape[0], dtype=np.int64),
                                 np.diff(slab.indptr))
                chunk_id = np.minimum(slab.indices // self.l_nkb,
                                      p_div_c - 1).astype(np.int64)
                per_cell = np.bincount(
                    rows * p_div_c + chunk_id,
                    minlength=slab.shape[0] * p_div_c)
                need = max(need, int(per_cell.max()))
        self.m_slots = m_slots = align_up(need, 8) if need else 0

        # Pass 2: this rank's cell (i, j), row-major as JAX's shard.
        i, j = self.row, self.col
        slab = slab_of(i * self.l_ni, min(ni, (i + 1) * self.l_ni))
        self.a_cols = np.zeros((self.rounds, self.l_ni, m_slots),
                               dtype=np.int32)
        self.a_data = np.zeros((self.rounds, self.l_ni, m_slots),
                               dtype=dtype)
        for r in range(self.rounds):
            q = j * self.rounds + r
            blk = slab[:, q * self.l_nkb: min(nk, (q + 1) * self.l_nkb)]
            bc, bd = ell_pack(blk, max_nnz=m_slots, dtype=dtype)
            self.a_cols[r, :bc.shape[0]] = bc
            self.a_data[r, :bd.shape[0]] = bd
        del slab

        dev = mesh.device
        self.ops = [tier_operator(self.a_cols[r], self.a_data[r],
                                  self.l_nkb, dev)
                    for r in range(self.rounds)]
        n_dev = p_div_c * c
        self.chunk = resolve_chunk(chunk, memory_fraction,
                                   n_dev * self.shard_nbytes(), n_dev, dev)

    # -- the step ----------------------------------------------------------

    def shard_nbytes(self) -> int:
        """Bytes of this rank's packed round blocks."""
        return int(self.a_cols.nbytes + self.a_data.nbytes)

    def set_features(self, x: np.ndarray) -> torch.Tensor:
        """Host (nk, k) features -> this rank's X block ``(l_nkb, k)``
        (block ``i`` of the grid row, the same on every replica), f32
        on its device."""
        x = np.asarray(x)
        nk, k = x.shape
        if nk != self.shape[1]:
            raise ValueError(f"expected {self.shape[1]} rows, got {nk}")
        lo = self.row * self.l_nkb
        block = np.zeros((self.l_nkb, k), dtype=np.float32)
        part = x[lo:min(nk, lo + self.l_nkb)]
        block[:part.shape[0]] = part
        return torch.from_numpy(block).to(self.mesh.device)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """One distributed SpMM: this rank's X block -> its ``(l_ni, k)``
        result block (module docstring), equal on the c replicas."""
        x = x.contiguous()
        k = x.shape[1]
        chunk = step_chunk(self.chunk, self.l_ni, k, self.m_slots)
        y = None
        for r in range(self.rounds):
            q = self.col * self.rounds + r
            # The root sends its own block; the others receive into a
            # buffer.
            buf = x if self.row == q else torch.empty_like(x)
            coll.broadcast(buf, self.mesh, self.rows_axis, root=q)
            part = tier_product(self.ops[r], buf, chunk)
            y = part if y is None else y.add_(part)
        if self.c > 1:
            y = coll.all_reduce_sum(y, self.mesh, self.repl_axis)
        return y.to(x.dtype)

    step = spmm

    def step_operands(self) -> tuple:
        """This rank's device operands of a step: its round blocks."""
        return tuple(self.ops)

    def as_features(self, y: torch.Tensor) -> torch.Tensor:
        """A result block as the next step's X block (square matrices:
        ``l_ni == l_nkb``; result block i is X block i)."""
        if self.l_ni != self.l_nkb:
            raise ValueError("iterated SpMM needs a square matrix")
        return y

    def run(self, x: torch.Tensor, iterations: int) -> torch.Tensor:
        for _ in range(iterations):
            x = self.spmm(self.as_features(x))
        return x

    def launch_counts(self, k: int) -> dict:
        """Kernel launches of one step on this rank at width ``k`` on the
        card: K1 once a round."""
        return {"K1": sum(tier_launches(op, k) for op in self.ops),
                "K4": 0, "K4 add": 0}

    def gather_result(self, y: torch.Tensor) -> np.ndarray:
        """The result blocks -> the host (ni, k) result, on every rank
        (the grid rows' blocks of this rank's replica)."""
        full = coll.all_gather(y.contiguous(), self.mesh, self.rows_axis)
        return full.cpu().numpy()[:self.shape[0]]

    # -- reports -----------------------------------------------------------

    def ideal_comm_bytes(self, k: int, itemsize: int = 4) -> int:
        """1.5D cost model for one step at width ``k``: every rank
        receives its ``rounds`` broadcast blocks (l_nkb rows), plus the
        replica all-reduce of its l_ni result rows when c > 1."""
        n_dev = self.p_div_c * self.c
        per_dev = self.rounds * self.l_nkb
        if self.c > 1:
            per_dev += self.l_ni
        return n_dev * per_dev * k * itemsize

    def collective_contract(self, k: int, itemsize: int = 4):
        """Static communication promise: a broadcast of each round's X
        block over the grid column and, when c > 1, the replicas'
        all-reduce of the partials."""
        from arrow_matrix_tpu_torch.analysis.contracts import (
            CollectiveContract,
        )

        kinds = ("broadcast", "all-reduce") if self.c > 1 else ("broadcast",)
        return CollectiveContract(
            algorithm="spmm_15d",
            step_bytes=self.ideal_comm_bytes(k, itemsize),
            reduce_bytes=0,
            repl=self.c,
            overlap_slabs=1,
            dtype="f32",
            lowered_kinds=kinds,
            compiled_kinds=kinds,
            ratio_band=(0.02, 1.5),
            h3_exempt="1.5D replication reduces broadcast rounds, not "
                      "slab width; the replica all-reduce is priced "
                      "inside ideal_comm_bytes, not as a deferred merge",
            notes="ideal counts the reference's global logical volume "
                  "(n_dev * rounds * l_nkb rows); the port counts each "
                  "rank's wire bytes")

    def predicted_hbm_bytes(self, k: int, itemsize: int = 4) -> int:
        """This rank's round blocks plus its X block (l_nkb rows) and
        result block (l_ni rows) at width ``k``."""
        return self.shard_nbytes() + (self.l_nkb + self.l_ni) * k * itemsize

    def shard_report(self) -> dict:
        """Per-rank load report over the grid (``obs/imbalance.py``
        schema; rank order is the grid's row-major order): each rank
        owns ``rounds`` ELL blocks of l_ni rows."""
        from arrow_matrix_tpu_torch.obs.imbalance import summarize_units

        nnz, slots = ell_slot_stats(self.a_cols[None], self.a_data[None])
        mine = torch.tensor([[int(nnz[0]), int(slots[0])]],
                            dtype=torch.int64)
        got = coll.all_gather(mine.to(self.mesh.device), self.mesh,
                              None).cpu().numpy()
        n_dev = self.p_div_c * self.c
        rows = np.full(n_dev, self.l_ni, dtype=np.int64)
        return summarize_units(rows, got[:, 0], got[:, 1], units="device")

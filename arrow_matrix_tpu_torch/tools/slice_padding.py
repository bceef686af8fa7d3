"""The 1D baseline's ELL padding on a graph: each slice's slot needs.

``MatrixSlice1D`` (``parallel/spmm_1d.py``) packs every slice's local and
nonlocal rows to one slot count over the mesh: the largest row degree
of any slice, aligned to 8.  On a power-law graph the hub slice sets it
for all.  This prints, for a Barabasi-Albert graph or the CLIs' uniform
random graph cut into equal slices, each slice's local and nonlocal
need, the shared slot counts and the bytes of the padded stacks (4 B an
index, 4 B a value) over all ranks, from the sparsity pattern alone
(nothing is packed):

    python -m arrow_matrix_tpu_torch.tools.slice_padding --ba 1048576,8,7 \\
        --slices 4
    python -m arrow_matrix_tpu_torch.tools.slice_padding \\
        --random 1048576,16777216,42 --slices 4
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def slice_needs(a, n_slices: int) -> dict:
    """Each slice's (local, nonlocal) largest row degree, the shared
    aligned slot counts and the padded stacks' bytes over the ranks."""
    from arrow_matrix_tpu_torch.ops.ell import align_up
    from arrow_matrix_tpu_torch.parallel.spmm_1d import equal_slices

    a = a.tocsr()
    slices = equal_slices(a.shape[0], n_slices)
    needs = []
    for lo, hi in slices:
        s = a[lo:hi]
        local = (s.indices >= lo) & (s.indices < hi)
        row = np.repeat(np.arange(s.shape[0]), np.diff(s.indptr))
        needs.append([int(np.bincount(row[m], minlength=s.shape[0]).max())
                      if m.any() else 0 for m in (local, ~local)])
    m_l = align_up(max(n[0] for n in needs), 8)
    m_nl = align_up(max(n[1] for n in needs), 8)
    rows = max(hi - lo for lo, hi in slices)
    return {"n": int(a.shape[0]), "nnz": int(a.nnz),
            "mean_row": a.nnz / a.shape[0], "slices": n_slices,
            "needs": needs, "m_l": m_l, "m_nl": m_nl,
            "padded_bytes": n_slices * rows * (m_l + m_nl) * 8}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--ba", type=str, help="n,m,seed of a Barabasi-Albert "
                                          "graph")
    g.add_argument("--random", type=str, help="vertices,edges,seed of the "
                                              "CLIs' random_adjacency")
    p.add_argument("--slices", type=int, default=4)
    args = p.parse_args(argv)
    if args.ba:
        from arrow_matrix_tpu_torch.utils import barabasi_albert

        n, m, seed = (int(v) for v in args.ba.split(","))
        a = barabasi_albert(n, m, seed=seed)
    else:
        from arrow_matrix_tpu_torch.cli.common import random_adjacency

        n, e, seed = (int(v) for v in args.random.split(","))
        a = random_adjacency(n, e, seed)
    print(json.dumps(slice_needs(a, args.slices)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``spmm_petsc`` — the 1-D row-partition (PETSc-style) baseline benchmark.

The port of ``arrow_matrix_tpu/cli/spmm_petsc.py`` on ``--devices P``
ranks, one process each (``cli/common.launch_ranks``), a slice a rank
(``parallel/spmm_1d.MatrixSlice1D``).  ``--file`` takes one matrix or a
slice of the reference's ``{name}.part.{P}.slice.{r}.npz`` scheme: when
the slice count equals ``--devices`` each rank loads only its own slice
(per-slice ingest; the normalising scale is summed over the ranks, one
contributor a slice), else the slices are reassembled and the partition
recomputed.  ``--dryrun`` builds the exchange tables and exits.

    python -m arrow_matrix_tpu_torch.cli.spmm_petsc --devices 4 \\
        --vertices 65536 --edges 1048576 --columns 16 --validate

Runs on the card; ``--device cpu`` runs the plain PyTorch versions of
the kernels on gloo ranks.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import time

import numpy as np
from scipy import sparse

from arrow_matrix_tpu_torch.cli.common import (
    add_device_args,
    add_heal_args,
    add_rank_args,
    launch_ranks,
    load_sparse_matrix,
    make_supervisor,
    normalize_scale,
    random_adjacency,
    report_memory,
    str2bool,
)

#: The reference's slice-file naming scheme, shared by the per-slice
#: ingest and the reassembly.
SLICE_RE = re.compile(r"(.*)\.part\.(\d+)\.slice\.(\d+)\.npz$")

def load_slices_or_matrix(path: str) -> sparse.csr_matrix:
    """One matrix file, or any slice of the ``{name}.part.{P}.slice.{r}
    .npz`` scheme (all slices are then reassembled)."""
    m = SLICE_RE.match(path)
    if not m:
        return load_sparse_matrix(path)
    base, p = m.group(1), int(m.group(2))
    paths = sorted(
        glob.glob(f"{base}.part.{p}.slice.*.npz"),
        key=lambda s: int(re.search(r"slice\.(\d+)\.npz$", s).group(1)))
    if len(paths) != p:
        raise SystemExit(f"found {len(paths)} of {p} slice files for {base}")
    return sparse.vstack([sparse.load_npz(f) for f in paths]).tocsr()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SpMM PETSc benchmark.")
    parser.add_argument("-s", "--seed", type=int, default=42)
    parser.add_argument("-f", "--file", type=str, default=None,
                        help="Matrix file, or one slice of the "
                             "reference's .part.P.slice.r.npz scheme.")
    parser.add_argument("-v", "--vertices", type=int, default=100_000,
                        help="Vertices of the random matrix (no --file).")
    parser.add_argument("-e", "--edges", type=int, default=1_000_000)
    parser.add_argument("-c", "--columns", type=int, default=32)
    parser.add_argument("-z", "--iterations", type=int, default=3)
    parser.add_argument("--validate", type=str2bool, nargs="?", default=True)
    parser.add_argument("--dryrun", type=str2bool, nargs="?", default=False,
                        help="Build the exchange tables, print their "
                             "stats, skip the benchmark.")
    parser.add_argument("-m", "--memory", type=float, default=0.5,
                        help="Fraction of the free device memory (net of "
                             "this layout's own blocks) that bounds the "
                             "plain version's gathered intermediate "
                             "(chunk='auto'); K1 needs no chunk.  <= 0 "
                             "disables chunking.")
    parser.add_argument("--carry", type=str2bool, nargs="?",
                        default=False, const=True,
                        help="Carry X across iterations (X := A @ X; the "
                             "1-D partition keeps the blocked layout) "
                             "instead of timing the same input.")
    add_heal_args(parser)
    parser.add_argument("--logdir", type=str, default="./logs")
    parser.add_argument("--comm_report", type=str2bool, nargs="?",
                        default=False, const=True,
                        help="Print one step's collective bytes on rank 0 "
                             "by kind (counted by the collective layer) "
                             "beside the paper model's ideal.")
    parser.add_argument("--mem_report", type=str2bool, nargs="?",
                        default=False, const=True,
                        help="Report one step's device memory against the "
                             "format model's prediction, plus the "
                             "per-slice load-imbalance report.")
    add_device_args(parser)
    add_rank_args(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.checkpoint and not args.carry:
        # A flag error: fail before any build work.
        raise SystemExit("--checkpoint requires --carry (there is no "
                         "iteration state to resume when X is the "
                         "same input every iteration)")
    slice_paths = None
    if args.file:
        m = SLICE_RE.match(args.file)
        if m and int(m.group(2)) == args.devices:
            base, p = m.group(1), int(m.group(2))
            slice_paths = [f"{base}.part.{p}.slice.{r}.npz"
                           for r in range(p)]
            missing = [q for q in slice_paths if not os.path.exists(q)]
            if missing:
                raise SystemExit(f"missing slice files: {missing[:3]}")
    return launch_ranks(args, petsc_rank, slice_paths)


def petsc_rank(ctx, args, slice_paths) -> int:
    """One rank of ``spmm_petsc``: its slice of the matrix, the build,
    ``--validate``, the reports and the timed loop (rank 0 prints and
    writes the log)."""
    import torch

    from arrow_matrix_tpu_torch.obs.comm import (
        account_collectives,
        ideal_bytes_for,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.spmm_1d import (
        MatrixSlice1D,
        _primary,
        exchange_sum,
    )
    from arrow_matrix_tpu_torch.utils import commstats
    from arrow_matrix_tpu_torch.utils import logging as wb
    from arrow_matrix_tpu_torch.utils.graphs import random_dense

    say = print if ctx.rank == 0 else (lambda *a, **k: None)
    n_dev = ctx.world
    mesh = make_mesh((n_dev,), ("slices",))
    me = mesh.axis_index("slices")

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    owned = None
    if slice_paths is not None:
        # Per-slice ingest: this rank reads only its own slice; the global
        # normalising scale is one sum over the ranks (one contributor a
        # slice) of each slice's largest absolute row sum.
        owned = sparse.load_npz(slice_paths[me]).tocsr().astype(np.float32)
        scales = np.zeros(n_dev)
        if owned.nnz and _primary(mesh, "slices"):
            scales[me] = float(abs(owned).sum(axis=1).max())
        scale = max(float(np.max(exchange_sum(scales, mesh))), 1.0)
        owned = (owned / scale).tocsr().astype(np.float32)
        a = [owned if d == me else slice_paths[d] for d in range(n_dev)]
        name = os.path.basename(args.file)
    elif args.file:
        a = normalize_scale(load_slices_or_matrix(args.file))
        name = os.path.basename(args.file)
    else:
        a = normalize_scale(
            random_adjacency(args.vertices, args.edges, args.seed))
        name = f"random_{args.vertices}_{args.edges}"

    wb.init("PETSc_torch_v1", name, config=vars(args))
    with wb.segment("build_time"):
        dist = MatrixSlice1D(
            a, mesh,
            chunk="auto" if args.memory > 0 else None,
            memory_fraction=args.memory if args.memory > 0 else 0.5)
    say(f"{n_dev} slices of <= {dist.l_rows} rows; exchange slot "
        f"{dist.slot} rows/pair ({n_dev} {ctx.backend} rank(s) on "
        f"{ctx.device})")

    def finish():
        out = wb.finish(args.logdir) if ctx.rank == 0 else None
        if out:
            say(f"log written to {out}.json")

    if args.dryrun:
        finish()
        return 0

    x_host = random_dense(dist.n, args.columns, seed=args.seed)
    x = dist.set_features(x_host)

    if args.validate:
        got = dist.gather_result(dist.spmm(x))
        if owned is not None:
            # Per-slice golden: each rank checks the rows of its own
            # slice (the global matrix never exists); the error and the
            # verdict are summed over the ranks.
            lo, hi = dist.slices[me]
            want_d = np.asarray(owned @ x_host)
            prim = _primary(mesh, "slices")
            parts = np.zeros(3)
            if prim:
                parts[0] = float(np.linalg.norm(got[lo:hi] - want_d) ** 2)
                parts[1] = float(np.linalg.norm(want_d) ** 2)
                parts[2] = float(not np.allclose(got[lo:hi], want_d,
                                                 rtol=1e-4, atol=1e-4))
            err_n, err_d, bad = exchange_sum(parts, mesh)
            err = (err_n / max(err_d, 1e-30)) ** 0.5
            ok = bad == 0 and bool(err < 1e-4)
            say(f"validation (each rank its own slice): allclose={ok} "
                f"rel frobenius err={err:.3e}")
        else:
            want = np.asarray(a @ x_host)
            err = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            ok = bool(np.allclose(got, want, rtol=1e-4, atol=1e-4))
            say(f"validation: allclose={ok} rel frobenius err={err:.3e}")
        wb.log({"frobenius_err": float(err)})
        if not ok:
            finish()
            return 1

    dist.spmm(x)                # warm-up
    sync()
    if args.comm_report:
        rep = account_collectives(
            "spmm_1d", lambda: (dist.spmm(x), sync()),
            ideal_bytes=ideal_bytes_for(dist, args.columns))
        say(f"per-iteration collective bytes on rank 0 ({rep['source']} by "
            f"the collective layer):")
        say(commstats.format_stats(rep["collectives"]))
        if rep["ratio"] is not None:
            say(f"measured vs paper-model ideal: {rep['measured_bytes']} / "
                f"{rep['ideal_bytes']} bytes = {rep['ratio']:.2f}x")
    if args.mem_report:
        report_memory("spmm_1d", dist, lambda v, *ops: dist.spmm(v), x,
                      args.columns, say)
    # The layout tag names the rank count: the blocked carriage of
    # another slicing must not resume here.
    sup = make_supervisor(args, "spmm_petsc", carry=args.carry,
                          layout=f"petsc/1d_sliced/ranks{n_dev}",
                          mesh=mesh, mesh_axis="slices")
    start_it = 0
    if args.carry and args.checkpoint:
        state = sup.resume(like=x)
        if state is not None:
            x, start_it = state
            say(f"resumed from {args.checkpoint} at iteration {start_it}")

    def body(xb, it):
        wb.set_iteration_data({"iteration": it})
        sync()
        tic = time.perf_counter()
        yb = dist.spmm(xb)
        sync()
        wb.log({"spmm_time": time.perf_counter() - tic})
        # The 1-D partition keeps the blocked layout: the result is the
        # next carried state directly.
        return yb

    _, ok = sup.run(body, x, start_it, args.iterations)
    s = wb.get_log().summarize().get("spmm_time")
    if s:
        say(f"spmm_time mean {s['mean'] * 1e3:.3f} ms over {s['count']} "
            f"iterations (min {s['min'] * 1e3:.3f}) on {n_dev} "
            f"{ctx.backend} rank(s)")
    finish()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

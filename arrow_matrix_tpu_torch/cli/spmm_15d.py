"""``spmm_15d`` — the 1.5D A-stationary baseline benchmark.

The port of ``arrow_matrix_tpu/cli/spmm_15d.py`` on ``--devices P``
ranks, one process each (``cli/common.launch_ranks``), as a ``(P/c, c)``
grid (``parallel/spmm_15d.SpMM15D``): a random or file matrix (or, with
``--memmap``, an npy CSR triplet read slab by slab), the replication
factor ``c`` (``-r``; ``--repl auto`` plans the largest ``c`` whose
replicated footprint the HBM budget certifies and degrades loudly to
``c = 1``), ``--validate`` against ``A @ X`` on the host, and the timed
loop.

    python -m arrow_matrix_tpu_torch.cli.spmm_15d --devices 4 -r 2 \\
        --vertices 65536 --edges 1048576 --columns 16 --validate

Runs on the card; ``--device cpu`` runs the plain PyTorch versions of
the kernels on gloo ranks.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SpMM 1.5D benchmark.")
    parser.add_argument("-d", "--dataset", nargs="?",
                        choices=["random", "file"], default="random")
    parser.add_argument("-s", "--seed", type=int, default=42)
    parser.add_argument("-v", "--vertices", type=int, default=100_000)
    parser.add_argument("-e", "--edges", type=int, default=1_000_000)
    parser.add_argument("-f", "--file", type=str, default=None,
                        help="Sparse matrix file (.npz/.mtx/.mat), or "
                             "with --memmap the BASE of an npy CSR "
                             "triplet (BASE_indptr.npy, BASE_indices"
                             ".npy, optional BASE_data.npy).")
    parser.add_argument("--memmap", type=str2bool, nargs="?",
                        default=False, const=True,
                        help="Memory-map --file as an npy CSR triplet and "
                             "build slab by slab, never holding the "
                             "matrix in RAM (no normalisation; "
                             "--validate streams the golden).")
    parser.add_argument("-c", "--columns", type=int, default=128,
                        help="Feature columns of X.")
    parser.add_argument("-r", "--replication", type=int, default=0,
                        help="Replication factor c; 0 = the largest valid "
                             "power of two.")
    parser.add_argument("--repl", type=str, default=None,
                        choices=["auto", "1", "2", "4"],
                        help="The replication factor under the SpMM CLIs' "
                             "common flag: an explicit c, or 'auto' for "
                             "the largest structurally valid c whose "
                             "c-fold operator footprint the HBM budget "
                             "certifies (AMT_HBM_GB overrides the "
                             "budget); a budget that rejects every c > 1 "
                             "degrades loudly to c = 1.")
    parser.add_argument("--validate", type=str2bool, nargs="?", default=True)
    parser.add_argument("-m", "--memory", type=float, default=0.5,
                        help="Fraction of the free device memory that "
                             "bounds the plain version's gathered "
                             "intermediate (chunk='auto'); K1 needs no "
                             "chunk.  <= 0 disables chunking.")
    parser.add_argument("-z", "--iterations", type=int, default=10)
    parser.add_argument("--carry", type=str2bool, nargs="?",
                        default=False, const=True,
                        help="Carry X across iterations (X := A @ X; the "
                             "result is gathered and re-distributed "
                             "outside the timed window) instead of timing "
                             "the same input.")
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
                             "per-rank load-imbalance report.")
    add_device_args(parser)
    add_rank_args(parser)
    return parser


def main(argv=None) -> int:
    from arrow_matrix_tpu_torch.parallel.mesh import largest_replication

    args = build_parser().parse_args(argv)
    if args.checkpoint and not args.carry:
        raise SystemExit("--checkpoint requires --carry (there is no "
                         "iteration state to resume when X is the "
                         "same input every iteration)")
    if args.memmap and not args.file:
        raise SystemExit("--memmap requires --file BASE (npy triplet: "
                         "BASE_indptr.npy, ...)")
    if args.dataset == "file" and not args.file:
        raise SystemExit("--dataset file requires --file")
    if args.repl is not None:
        if args.replication:
            raise SystemExit("--repl and -r/--replication set the same "
                             "factor; give one")
        if args.repl != "auto":
            args.replication = int(args.repl)
    n_dev = args.devices
    if args.repl != "auto":
        c = args.replication or largest_replication(n_dev)
        if n_dev % (c * c) != 0:
            raise SystemExit(
                f"device count {n_dev} not divisible by c^2 = {c * c} "
                f"(the reference's divisibility rule)")
        args.replication = c
    return launch_ranks(args, rank_15d)


def load_matrix(args):
    """(matrix or memmapped triplet, name) of the run."""
    if args.memmap:
        def mm(suffix, required=True):
            p = f"{args.file}_{suffix}.npy"
            if not os.path.exists(p):
                if required:
                    raise SystemExit(f"missing triplet member {p}")
                return None
            return np.load(p, mmap_mode="r")

        return ((mm("data", required=False), mm("indices"), mm("indptr")),
                os.path.basename(args.file))
    if args.file:
        return (normalize_scale(load_sparse_matrix(args.file)),
                os.path.basename(args.file))
    return (normalize_scale(random_adjacency(args.vertices, args.edges,
                                             args.seed)),
            f"random_{args.vertices}_{args.edges}")


def plan_repl(args, a, n_dev: int, device) -> int:
    """``--repl auto``: the largest structural c (c <= the largest
    replication, c^2 | P) whose c-fold footprint fits the HBM budget
    (``obs/memview.largest_fitting_repl``), loudly 1 when none > 1 does."""
    from arrow_matrix_tpu_torch.obs.comm import hbm_budget_bytes
    from arrow_matrix_tpu_torch.obs.memview import largest_fitting_repl
    from arrow_matrix_tpu_torch.parallel.mesh import largest_replication

    nnz = int(a.nnz) if hasattr(a, "nnz") else int(a[1].size)
    rows = int(a.shape[0]) if hasattr(a, "shape") else int(a[2].size - 1)
    base_est = (nnz * 8 // max(n_dev, 1)
                + 2 * (-(-rows // max(n_dev, 1))) * args.columns * 4)
    budget = hbm_budget_bytes(device=device)
    structural = [cc for cc in (1, 2, 4, 8)
                  if cc <= largest_replication(n_dev)
                  and n_dev % (cc * cc) == 0]
    c_fit = largest_fitting_repl(base_est, budget, structural)
    if c_fit == 1 and max(structural) > 1:
        print(f"[graft-repl] auto replication DEGRADED to c=1: base "
              f"footprint ~{base_est} B x c exceeds the HBM budget "
              f"{budget / 2**30:.2f} GiB for every structural c "
              f"{structural[1:]} (set AMT_HBM_GB to raise)", file=sys.stderr)
    else:
        print(f"--repl auto plan: c={c_fit} (structural candidates "
              f"{structural}, base ~{base_est} B per device, budget "
              f"{budget / 2**30:.2f} GiB)")
    return c_fit


def rank_15d(ctx, args) -> int:
    """One rank of ``spmm_15d``: the matrix, the replication factor
    (rank 0's plan under ``--repl auto``, agreed by every rank), its grid
    cell, ``--validate``, the reports and the timed loop (rank 0 prints
    and writes the log)."""
    import torch

    from arrow_matrix_tpu_torch.obs.comm import (
        account_collectives,
        ideal_bytes_for,
        reduce_bytes_for,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.spmm_15d import (
        SpMM15D,
        _slab_source,
    )
    from arrow_matrix_tpu_torch.parallel.spmm_1d import exchange_sum
    from arrow_matrix_tpu_torch.utils import commstats
    from arrow_matrix_tpu_torch.utils import logging as wb
    from arrow_matrix_tpu_torch.utils import numerics
    from arrow_matrix_tpu_torch.utils.graphs import random_dense

    say = print if ctx.rank == 0 else (lambda *a, **k: None)
    n_dev = ctx.world

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    a, name = load_matrix(args)
    c = args.replication
    if args.repl == "auto":
        # One plan, rank 0's: free memory differs between ranks that
        # share a card, and the grid must be one.
        world = make_mesh((n_dev,), ("world",))
        mine = np.zeros(1, dtype=np.int64)
        if ctx.rank == 0:
            mine[0] = plan_repl(args, a, n_dev, ctx.device)
        c = int(exchange_sum(mine, world)[0])
    mesh = make_mesh((n_dev // c, c), ("rows", "repl"))
    say(f"grid {n_dev // c} x {c} on {n_dev} {ctx.backend} rank(s) "
        f"({ctx.device})")

    wb.init(f"15D_torch_c_{c}", name, config=vars(args))
    with wb.segment("build_time"):
        dist = SpMM15D(
            a, mesh,
            chunk="auto" if args.memory > 0 else None,
            memory_fraction=args.memory if args.memory > 0 else 0.5)

    def finish():
        out = wb.finish(args.logdir) if ctx.rank == 0 else None
        if out:
            say(f"log written to {out}.json")

    n = dist.shape[1]
    x_host = random_dense(n, args.columns, seed=args.seed)
    x = dist.set_features(x_host)

    if args.validate:
        got = dist.gather_result(dist.spmm(x))
        if args.memmap:
            # A streamed golden: the global matrix never exists in RAM.
            _, _, slab_of = _slab_source(a, np.float32)
            want = np.empty_like(x_host)
            nnz = 0
            step_rows = max(dist.l_ni, 1)
            for lo in range(0, n, step_rows):
                slab = slab_of(lo, min(n, lo + step_rows))
                want[lo:lo + slab.shape[0]] = slab @ x_host
                nnz += int(slab.nnz)
        else:
            want = np.asarray(a @ x_host)
            nnz = a.nnz
        err = numerics.relative_error(got, want)
        tol = numerics.relative_tolerance(nnz / max(n, 1), iters=1)
        ok = bool(np.isfinite(err) and err <= tol)
        say(f"validation: ok={ok} rel frobenius err={err:.3e} "
            f"(gate {tol:.1e}; tolerance per utils/numerics.py)")
        wb.log({"frobenius_err": float(err)})
        if not ok:
            finish()
            return 1

    dist.spmm(x)                # warm-up
    sync()
    if args.comm_report:
        # reduce_bytes stays 0: the replicas' all-reduce is a step's
        # own, already among the counted bytes.
        rep = account_collectives(
            "spmm_15d", lambda: (dist.spmm(x), sync()),
            ideal_bytes=ideal_bytes_for(dist, args.columns), repl=c,
            reduce_bytes=reduce_bytes_for(dist, args.columns))
        say(f"per-iteration collective bytes on rank 0 ({rep['source']} by "
            f"the collective layer):")
        say(commstats.format_stats(rep["collectives"]))
        if rep["ratio"] is not None:
            say(f"measured vs paper-model ideal: {rep['measured_bytes']} / "
                f"{rep['ideal_bytes']} bytes = {rep['ratio']:.2f}x")
    if args.mem_report:
        report_memory("spmm_15d", dist, lambda v, *ops: dist.spmm(v), x,
                      args.columns, say)
    if args.carry and dist.shape[0] != dist.shape[1]:
        say(f"--carry needs a square matrix (X := A @ X); have "
            f"{dist.shape}")
        finish()
        return 2
    # The carriage is block ``row`` of the grid, equal on the replicas:
    # checkpoints gather it over the grid rows.  The tag names the grid.
    sup = make_supervisor(args, "spmm_15d", carry=args.carry,
                          layout=f"15d/c{c}/blocked_input/ranks{n_dev}",
                          mesh=mesh, mesh_axis="rows")
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
        if not args.carry:
            return yb
        # Re-distributed outside the timed window.
        return dist.set_features(dist.gather_result(yb))

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

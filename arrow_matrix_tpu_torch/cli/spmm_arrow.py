"""``spmm_arrow`` — the arrow SpMM benchmark on one device.

The port's counterpart of ``arrow_matrix_tpu/cli/spmm_arrow.py`` on a
single device: with no ``--path``, generate a Barabasi-Albert graph,
decompose it and save the artifact; load it, build the operator on the
device, and run the iteration loop, timing each step and
(``--validate``) checking it against the host golden
``decomposition_spmm``.  ``--fmt fold`` (default on one device, as the
JAX CLI picks it) folds every level into one SELL operator; ``--fmt
dense``, ``ell`` and ``hyb`` keep one operator per level (dense or ELL
arrow blocks, the ELL head in ``--head_fmt``, or split ELL), and
``--fmt auto`` makes levels dense while they fit half the device's
free memory and the rest ELL (banded tiling when ``--blocked false``,
as in the JAX CLI).

    python -m arrow_matrix_tpu_torch.cli.spmm_arrow --vertices 100000 \\
        --width 512 --features 16 --iterations 10 --validate
    python -m arrow_matrix_tpu_torch.cli.spmm_arrow --fmt dense \\
        --vertices 65536 --ba_neighbors 8 --width 2048 --validate
    python -m arrow_matrix_tpu_torch.cli.spmm_arrow --fmt ell \\
        --head_fmt gell --vertices 65536 --width 2048 --validate

The iteration loop runs under the supervisor (``faults/``), with the
JAX CLI's flags: ``--watchdog`` seconds per iteration, ``--max_retries``
with exponential backoff, ``--finite_check`` (NaN/Inf rolls back), and
with ``--carry`` ``--checkpoint`` (every ``--checkpoint_every``
iterations; a rerun resumes from it).

Runs on the card; ``--device cpu`` runs the plain PyTorch version.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from arrow_matrix_tpu_torch.cli.common import add_heal_args, str2bool


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Arrow SpMM benchmark (one device).")
    p.add_argument("-f", "--path", type=str, default=None,
                   help="Decomposition artifact base path (no extension). "
                        "Default: generate a random graph, decompose it "
                        "and benchmark that.")
    p.add_argument("-w", "--width", type=int, default=0,
                   help="Width of the decomposition / block height.")
    p.add_argument("-c", "--features", type=int, default=16,
                   help="Number of feature columns of X.")
    p.add_argument("-z", "--iterations", type=int, default=1,
                   help="Number of SpMM iterations.")
    p.add_argument("-v", "--vertices", type=int, default=10_000,
                   help="Vertices of the generated graph (no --path).")
    p.add_argument("-m", "--ba_neighbors", type=int, default=3,
                   help="Barabasi-Albert attachment count.")
    p.add_argument("-b", "--blocked", type=str2bool, nargs="?",
                   default=True, const=True,
                   help="Block-diagonal decomposition (default true).")
    p.add_argument("--fmt", type=str, default="fold",
                   choices=["fold", "auto", "dense", "ell", "hyb"],
                   help="Operator format: fold (every level in one SELL "
                        "operator, the default on one device); dense "
                        "(each level's dense arrow blocks, through the "
                        "column and head-row kernels); ell (ELL arrow "
                        "blocks) and hyb (one split ELL per level), "
                        "through the SELL kernel; auto (dense while the "
                        "levels fit half the free device memory, then "
                        "ell).")
    p.add_argument("--head_fmt", type=str, default="auto",
                   choices=["auto", "flat", "ell", "gell"],
                   help="Head layout of ELL levels (--fmt ell/auto): "
                        "flat COO, per-block ELL, or one ELL of the head "
                        "rows over global columns (gell); auto: gell on "
                        "the card while it fits, else the smaller of "
                        "flat and ell.")
    p.add_argument("--feature_dtype", type=str, default=None,
                   choices=["f32", "bf16"],
                   help="Carried-feature dtype of --fmt fold: bf16 "
                        "halves the gathered bytes, sums stay f32 (the "
                        "--validate gate widens to 2e-2).")
    p.add_argument("--fold_growth", type=float, default=1.2,
                   help="Tier growth factor: padded slots <= growth x "
                        "nnz.  1.1 with --fold_align 1 is the tight "
                        "packing.")
    p.add_argument("--fold_align", type=int, default=None,
                   help="Slot alignment of the tiers (default 8; 1 = "
                        "none).")
    p.add_argument("--validate", type=str2bool, nargs="?", default=False,
                   const=True,
                   help="Compare each iteration against the host golden.")
    p.add_argument("--carry", type=str2bool, nargs="?", default=False,
                   const=True,
                   help="Carry X across iterations (X := A @ X) instead "
                        "of a fresh random X per iteration.")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="Where the product runs (default: the card).")
    p.add_argument("--seed", type=int, default=42)
    add_heal_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.checkpoint and not args.carry:
        # A flag error: fail before any decomposition work.
        raise SystemExit("--checkpoint requires --carry (there is no "
                         "iteration state to resume when X is fresh "
                         "every iteration)")

    import torch

    from arrow_matrix_tpu_torch.decomposition import (
        arrow_decomposition,
        decomposition_spmm,
    )
    from arrow_matrix_tpu_torch.io import (
        ArtifactIntegrityError,
        as_levels,
        load_decomposition,
        load_level_widths,
        num_rows,
        save_decomposition,
    )
    from arrow_matrix_tpu_torch.cli.common import make_supervisor
    from arrow_matrix_tpu_torch.faults import Abort
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import (
        barabasi_albert,
        random_dense,
        relative_error,
        relative_tolerance,
        resolve_device,
    )

    # The device first: a missing card fails before any host work.
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"spmm_arrow: {e}") from None
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    width = args.width
    if args.path is None:
        width = width or 512
        n = args.vertices
        path = os.path.join(".", f"ba_{n}_{args.ba_neighbors}")
        print(f"generating Barabasi-Albert graph n={n} "
              f"m={args.ba_neighbors}")
        a = barabasi_albert(n, args.ba_neighbors, seed=args.seed)
        levels = arrow_decomposition(a, arrow_width=width, max_levels=10,
                                     block_diagonal=args.blocked,
                                     seed=args.seed)
        save_decomposition(levels, path, block_diagonal=args.blocked)
    else:
        path = args.path
        if not width:
            raise SystemExit("--width is required with --path (it names "
                             "the artifact files)")

    try:
        loaded = load_decomposition(path, width,
                                    block_diagonal=args.blocked)
    except ArtifactIntegrityError as e:
        print(f"artifact integrity check failed: {e}")
        return 1
    widths = load_level_widths(path, width, block_diagonal=args.blocked)
    levels = as_levels(loaded, width if widths is None else widths)
    n = num_rows(levels[0].matrix)

    tic = time.perf_counter()
    if args.fmt != "fold":
        if args.feature_dtype is not None:
            raise SystemExit(f"spmm_arrow: --feature_dtype is a --fmt fold "
                             f"option; the {args.fmt} carriage is f32")
        multi = MultiLevelArrow(levels, width, fmt=args.fmt,
                                head_fmt=args.head_fmt,
                                banded=not args.blocked, device=device)
        print(f"{args.fmt}: {len(levels)} levels, widths {multi.widths}, "
              f"formats {multi.fmts}, heads {multi.head_layouts()}, "
              f"{multi.total_rows} rows, "
              f"{sum(b.device_nbytes() for b in multi.blocks)} B on the "
              f"device ({time.perf_counter() - tic:.3f} s)")
    else:
        multi = MultiLevelArrow(levels, width, fmt="fold",
                                feature_dtype=args.feature_dtype,
                                fold_growth=args.fold_growth,
                                fold_align=args.fold_align, device=device)
        print(f"fold: {len(multi.sell.cols)} tiers, "
              f"{len(multi.sell.live_tiers())} launched per step, "
              f"{multi.sell.n_slots} slots for {multi.nnz} nnz "
              f"({time.perf_counter() - tic:.3f} s)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Untimed warm-up: the kernel's build and first launch stay out of
    # iteration 0's time.
    x = multi.set_features(random_dense(n, args.features, seed=args.seed))
    multi.step(x)
    sync()

    rng = np.random.default_rng(args.seed)
    tol = relative_tolerance(
        sum(lvl.matrix.nnz for lvl in levels) / max(n, 1), iters=1)
    if args.feature_dtype == "bf16":
        tol = max(tol, 2e-2)
    # Layout tag: how X is carried.  A checkpoint written under another
    # executor configuration refuses to resume instead of silently
    # permuting rows.
    sup = make_supervisor(
        args, "spmm_arrow", carry=args.carry,
        layout=f"spmm_arrow/{args.fmt}/{args.feature_dtype or 'f32'}")
    start = 0
    if args.carry and args.checkpoint:
        state = sup.resume(like=x)
        if state is not None:
            x, start = state
            print(f"resumed from {args.checkpoint} at iteration {start}")
    times = []

    def body(x, it):
        if args.carry:
            x_host = multi.gather_result(x) if args.validate else None
        else:
            x_host = random_dense(n, args.features,
                                  seed=int(rng.integers(2**31)))
            x = multi.set_features(x_host)
        sync()
        tic = time.perf_counter()
        y = multi.step(x)
        sync()
        times.append(time.perf_counter() - tic)
        if args.validate:
            got = multi.gather_result(y)
            want = decomposition_spmm(levels, x_host)
            err = relative_error(got, want)
            print(f"iteration {it}: rel err vs host {err:.3e} "
                  f"(gate {tol:.1e})")
            if not np.isfinite(err) or err > tol:
                # A policy failure: never retried, and no checkpoint of
                # this state is written.
                raise Abort(f"validation gate failed at iteration {it}")
        return y

    _, ok = sup.run(body, x, start, args.iterations)
    if not ok:
        print("the supervised loop failed (validation gate, or retries "
              "exhausted)")
        return 1
    if sup.faults_seen:
        print(f"{sup.faults_seen} fault(s) seen, {sup.recoveries} "
              f"recover(ies)")
    if times:
        ms = np.asarray(times) * 1e3
        print(f"spmm_time mean {ms.mean():.3f} ms over {len(ms)} "
              f"iterations (min {ms.min():.3f}) on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``spmm_arrow`` — the arrow SpMM benchmark.

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

``--mem_report`` prints one step's device memory against the
executor's model and its load-imbalance report, ``--trace DIR`` writes a
``torch.profiler`` trace of the iteration loop, ``--obs_dir DIR`` the
loop's span trace and ``metrics.jsonl`` (on one device and under
``--devices P``).  ``--logdir DIR`` (default ``./logs``) receives the
run's log in the JAX package's form (``<run>.<dataset>.<id>.json`` and
``.txt``: the build time, each iteration's time and error), written by
rank 0 on a mesh; ``log_upload`` lists or uploads it.

With ``--devices P`` the ranks of a mesh run one process each
(``parallel/launch.py``): ``--mode time`` (the default) runs the levels
one after the other on the whole mesh (``--fmt sell``:
``SellMultiLevel``; else ``MultiLevelArrow(mesh=)``), ``--mode space``
runs them at once on disjoint rank groups of a (lvl, blocks) mesh
(``--fmt sell``: ``SellSpaceShared``; else ``SpaceSharedArrow``):

    python -m arrow_matrix_tpu_torch.cli.spmm_arrow --devices 4 \
        --mode space --vertices 4096 --width 64 --validate

Runs on the card; ``--device cpu`` runs the plain PyTorch version.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from arrow_matrix_tpu_torch.cli.common import (
    add_heal_args,
    add_rank_args,
    report_memory,
    str2bool,
)


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
    p.add_argument("--fmt", type=str, default=None,
                   choices=["fold", "auto", "dense", "ell", "hyb", "sell"],
                   help="Operator format: fold (every level in one SELL "
                        "operator, the default on one device); sell (the "
                        "padding-free mesh executor SellMultiLevel, the "
                        "default on more); dense "
                        "(each level's dense arrow blocks, through the "
                        "column and head-row kernels); ell (ELL arrow "
                        "blocks) and hyb (one split ELL per level), "
                        "through the SELL kernel; auto (dense while the "
                        "levels fit half the free device memory, then "
                        "ell).")
    add_rank_args(p)
    p.add_argument("--mode", type=str, default="time",
                   choices=["time", "space"],
                   help="Multi-matrix execution mode: time (the levels "
                        "one after the other on the whole mesh); space "
                        "(the levels at once on disjoint rank groups of "
                        "a (lvl, blocks) mesh: SellSpaceShared with --fmt "
                        "sell, the default, else SpaceSharedArrow; "
                        "--devices a multiple of the level count).")
    p.add_argument("--routing", type=str, default=None,
                   choices=["gather", "a2a"],
                   help="Inter-level exchange on a mesh: a2a (explicit "
                        "tables over one all-to-all; the default for "
                        "--fmt sell) or gather (an all-gather of the "
                        "carriage; the default otherwise).")
    p.add_argument("--repl", type=str, default="1",
                   choices=["auto", "1", "2", "4"],
                   help="2.5D replication factor c of --fmt sell on a "
                        "mesh: c replica groups each own a k/c feature "
                        "slab (c divides --devices and --features); "
                        "auto runs the obs/comm model under the HBM "
                        "budget.")
    p.add_argument("-s", "--slim", type=str2bool, nargs="?", default=True,
                   const=True,
                   help="Layout on a mesh: true = slim (default); false = "
                        "wide, on an (arm=2, blocks) mesh (an even "
                        "--devices >= 4, a stacked format, --routing "
                        "gather).")
    p.add_argument("--ladder", type=str, default="default",
                   choices=["default", "tight"],
                   help="Degree ladder of --fmt sell: default (growth "
                        "1.5, align 8) or tight (1.3, 1).")
    p.add_argument("--comm_report", type=str2bool, nargs="?", default=False,
                   const=True,
                   help="Print one step's collective bytes by kind "
                        "(utils/commstats) beside the executor's ideal.")
    p.add_argument("--mem_report", type=str2bool, nargs="?", default=False,
                   const=True,
                   help="Report one step's device memory (arguments, "
                        "outputs, temporaries) against the format "
                        "model's prediction, plus the load-imbalance "
                        "report (obs/memview, obs/imbalance).")
    p.add_argument("--logdir", type=str, default="./logs",
                   help="Write the run's log here (the JAX package's "
                        "form: <run>.<dataset>.<id>.json and .txt; "
                        "log_upload_torch lists or uploads it).  On a "
                        "mesh rank 0 writes it.")
    p.add_argument("--trace", type=str, default=None,
                   help="Write a torch.profiler trace of the iteration "
                        "loop to this directory (Chrome trace JSON, one "
                        "file a rank; the kernels' device time beside "
                        "the host spans).")
    p.add_argument("--obs_dir", type=str, default=None,
                   help="Write this run's observability artifacts to "
                        "this directory: a Perfetto-loadable trace of the "
                        "iteration loop (spmm_arrow.trace.json) and "
                        "metrics.jsonl (each step's time, the memory and "
                        "imbalance reports); rank 0 writes them under "
                        "--devices.")
    p.add_argument("--head_fmt", type=str, default="auto",
                   choices=["auto", "flat", "ell", "gell"],
                   help="Head layout of ELL levels (--fmt ell/auto): "
                        "flat COO, per-block ELL, or one ELL of the head "
                        "rows over global columns (gell); auto: gell on "
                        "the card while it fits, else the smaller of "
                        "flat and ell.")
    p.add_argument("--feature_dtype", type=str, default=None,
                   choices=["f32", "bf16"],
                   help="Carried-feature dtype of --fmt fold or sell: bf16 "
                        "halves the gathered bytes, sums stay f32 (the "
                        "--validate gate widens to 2e-2).")
    p.add_argument("--fold_growth", type=float, default=1.2,
                   help="Tier growth factor: padded slots <= growth x "
                        "nnz.  1.1 with --fold_align 1 is the tight "
                        "packing.")
    p.add_argument("--fold_align", type=int, default=None,
                   help="Slot alignment of the tiers (default 8; 1 = "
                        "none).")
    p.add_argument("--memmap", type=str2bool, nargs="?", default=False,
                   const=True,
                   help="Load the artifact memory-mapped and build the "
                        "executor from the mapped triplets, reading only "
                        "the blocks each rank packs; the host golden of "
                        "--validate materializes the levels.")
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


def check_mesh_flags(args) -> None:
    """Resolve ``--fmt``/``--routing`` as the JAX CLI does (fold on one
    device, sell and a2a on more) and refuse flag combinations before
    any decomposition work."""
    n_dev = args.devices
    if n_dev < 1:
        raise SystemExit("--devices must be >= 1")
    space = args.mode == "space"
    if space:
        # The JAX CLI's refusals of the space-shared mode, in its words.
        if args.repl != "1":
            raise SystemExit(
                "--repl composes with --mode time; the space-shared "
                "mesh spends its extra devices on level groups, not "
                "replicas")
        if not args.slim:
            raise SystemExit(
                "--slim false (wide layout) runs time-shared; "
                "--mode space shards its per-level groups slim-style")
        if args.fmt is not None and args.fmt in ("hyb", "fold"):
            raise SystemExit(
                f"--fmt {args.fmt} is a single-chip kernel; "
                "--mode space runs levels on disjoint device groups — "
                "use --fmt auto/dense/ell (stacked) or sell "
                "(feature-major)")
        if n_dev < 2:
            raise SystemExit(
                "--mode space runs the levels on disjoint rank groups; "
                "pass --devices, a multiple of the level count")
        if args.head_fmt != "auto":
            print(f"warning: --head_fmt {args.head_fmt} applies only to "
                  f"--mode time; the space-shared runtime pre-agrees "
                  f"one head format across levels")
    if args.fmt is None:
        args.fmt = "sell" if (space or n_dev > 1) else "fold"
        print(f"auto-selected --fmt {args.fmt} for {n_dev} device(s) "
              f"(measured-best; override with --fmt)")
    if args.routing is None:
        args.routing = "a2a" if (args.fmt == "sell" and n_dev > 1
                                 and not space) else "gather"
        if args.routing == "a2a":
            print("auto-selected --routing a2a (lowest collective "
                  "volume; override with --routing)")
    if args.fmt in ("hyb", "fold") and n_dev > 1:
        raise SystemExit(
            f"--fmt {args.fmt} is single-chip only; rerun with "
            f"--devices 1 (or pick --fmt auto/dense/ell/sell "
            f"for the {n_dev}-device mesh)")
    if args.fmt == "sell" and n_dev < 2 and not space:
        raise SystemExit(
            "--fmt sell is the mesh orchestration; on one chip "
            "use --fmt fold (same layouts, zero routing)")
    if args.feature_dtype == "bf16" and args.fmt not in ("fold", "sell"):
        raise SystemExit(f"spmm_arrow: --feature_dtype is a --fmt fold option "
                         f"(and of --fmt sell on a mesh); the {args.fmt} "
                         f"carriage is f32")
    if args.repl != "1" and args.fmt != "sell":
        raise SystemExit(f"--repl needs --fmt sell (mesh replica groups); "
                         f"--fmt {args.fmt} has no replica axis here")
    if args.repl not in ("1", "auto"):
        c = int(args.repl)
        if n_dev % c or args.features % c:
            raise SystemExit(
                f"--repl {c} must divide the device count ({n_dev}) and "
                f"--features ({args.features}): each replica group needs "
                f"an equal share of the mesh and of the features")
    if not args.slim:
        if n_dev < 4 or n_dev % 2:
            raise SystemExit("--slim false (the wide layout) needs an "
                             "even --devices >= 4")
        if args.fmt == "sell" or args.routing == "a2a":
            raise SystemExit("--slim false needs a stacked format "
                             "(auto/dense/ell) and --routing gather")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.checkpoint and not args.carry:
        # A flag error: fail before any decomposition work.
        raise SystemExit("--checkpoint requires --carry (there is no "
                         "iteration state to resume when X is fresh "
                         "every iteration)")
    check_mesh_flags(args)
    if args.devices > 1:
        return mesh_main(args)

    import torch

    from arrow_matrix_tpu_torch.decomposition import decomposition_spmm
    from arrow_matrix_tpu_torch.io import ArtifactIntegrityError, num_rows
    from arrow_matrix_tpu_torch.cli.common import make_supervisor
    from arrow_matrix_tpu_torch.faults import Abort
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import (
        random_dense,
        relative_error,
        resolve_device,
    )
    from arrow_matrix_tpu_torch.utils import logging as wb

    # The device first: a missing card fails before any host work.
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"spmm_arrow: {e}") from None
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    path, width = prepare_artifact(args)
    try:
        levels, golden_levels = load_levels(args, path, width)
    except ArtifactIntegrityError as e:
        print(f"artifact integrity check failed: {e}")
        return 1
    n = num_rows(levels[0].matrix)
    wb.init(run_name(args), os.path.basename(path), config=vars(args))

    tic = time.perf_counter()
    if args.fmt != "fold":
        if args.feature_dtype is not None:
            raise SystemExit(f"spmm_arrow: --feature_dtype is a --fmt fold "
                             f"option; the {args.fmt} carriage is f32")
        with wb.segment("build_time"):
            multi = MultiLevelArrow(levels, width, fmt=args.fmt,
                                    head_fmt=args.head_fmt,
                                    banded=not args.blocked, device=device)
        print(f"{args.fmt}: {len(levels)} levels, widths {multi.widths}, "
              f"formats {multi.fmts}, heads {multi.head_layouts()}, "
              f"{multi.total_rows} rows, "
              f"{sum(b.device_nbytes() for b in multi.blocks)} B on the "
              f"device ({time.perf_counter() - tic:.3f} s)")
    else:
        with wb.segment("build_time"):
            multi = MultiLevelArrow(levels, width, fmt="fold",
                                    feature_dtype=args.feature_dtype,
                                    fold_growth=args.fold_growth,
                                    fold_align=args.fold_align,
                                    device=device)
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
    reg, tracer = open_obs(args)
    if args.mem_report:
        mem_report(args, multi, x, reg, print)

    rng = np.random.default_rng(args.seed)
    tol = gate_tolerance(args, levels, n)
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
        wb.set_iteration_data({"iteration": it})
        if args.carry:
            x_host = multi.gather_result(x) if args.validate else None
        else:
            x_host = random_dense(n, args.features,
                                  seed=int(rng.integers(2**31)))
            x = multi.set_features(x_host)
        sync()
        with step_span(tracer, it):
            tic = time.perf_counter()
            y = multi.step(x)
            sync()
            dt = time.perf_counter() - tic
        times.append(dt)
        wb.log({"spmm_time": dt})
        if reg is not None:
            reg.record("iteration_time_ms", dt * 1e3,
                       algorithm="spmm_arrow")
        if args.validate:
            got = multi.gather_result(y)
            want = decomposition_spmm(golden_levels, x_host)
            err = relative_error(got, want)
            wb.log({"frobenius_err": float(err)})
            print(f"iteration {it}: rel err vs host {err:.3e} "
                  f"(gate {tol:.1e})")
            if not np.isfinite(err) or err > tol:
                # A policy failure: never retried, and no checkpoint of
                # this state is written.
                raise Abort(f"validation gate failed at iteration {it}")
        return y

    with traced(args, device):
        _, ok = sup.run(body, x, start, args.iterations)
    close_obs(args, reg, tracer, print)
    out = wb.finish(args.logdir)
    if out:
        print(f"log written to {out}.json")
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


def run_name(args) -> str:
    """The run's name in its log: the JAX CLI's version string, named by
    what runs (banded or block-diagonal tiling, slim or wide, time- or
    space-shared levels; space always tiles banded)."""
    banded = args.mode == "space" or not args.blocked
    return (f"ArrowTPU_v{'Banded' if banded else 'BlockDiagonal'}"
            f"_{'Slim' if args.slim else 'Wide'}"
            f"_{args.mode.capitalize()}Shared")


def load_levels(args, path: str, width: int) -> tuple:
    """``(levels, golden levels)`` of the artifact: CSR levels, or under
    ``--memmap`` the memory-mapped triplets the executors read block by
    block, with the host golden's CSR levels made only when
    ``--validate`` needs them (None otherwise)."""
    from arrow_matrix_tpu_torch.io import (
        as_levels,
        load_decomposition,
        load_level_widths,
    )

    loaded = load_decomposition(path, width, block_diagonal=args.blocked,
                                mem_map=args.memmap)
    widths = load_level_widths(path, width, block_diagonal=args.blocked)
    widths = width if widths is None else widths
    levels = as_levels(loaded, widths, materialize=not args.memmap)
    if not args.memmap:
        return levels, levels
    return levels, (as_levels(loaded, widths) if args.validate else None)


def gate_tolerance(args, levels, n: int) -> float:
    """The one-step ``--validate`` gate: ``relative_tolerance`` at the
    decomposition's nonzeros a row (bf16 carriage: at least 2e-2)."""
    from arrow_matrix_tpu_torch.io import num_nonzeros
    from arrow_matrix_tpu_torch.utils import relative_tolerance

    tol = relative_tolerance(
        sum(num_nonzeros(lvl.matrix) for lvl in levels) / max(n, 1),
        iters=1)
    return max(tol, 2e-2) if args.feature_dtype == "bf16" else tol


def open_obs(args) -> tuple:
    """(registry, tracer) of the run's observability (``--obs_dir``):
    a metrics registry and a span tracer named ``spmm_arrow``; (None,
    None) without the flag, and the loop then opens no span and records
    nothing."""
    if not args.obs_dir:
        return None, None
    from arrow_matrix_tpu_torch.obs import MetricsRegistry, Tracer

    reg = MetricsRegistry(run_dir=args.obs_dir)
    return reg, Tracer("spmm_arrow", registry=reg)


def step_span(tracer, it: int):
    """The tracer's span of iteration ``it``, or a context that does
    nothing without ``--obs_dir``."""
    import contextlib

    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span("step", iteration=it)


def mem_report(args, exe, x, reg, say) -> None:
    """``--mem_report`` over ``exe``'s step at the run's width and
    feature dtype (``common.report_memory``)."""
    report_memory("spmm_arrow", exe, exe.step_fn, x, args.features, say,
                  itemsize=2 if args.feature_dtype == "bf16" else 4,
                  registry=reg)


def traced(args, device):
    """``--trace``: a ``torch.profiler`` context over the iteration loop
    (``utils/logging.trace``, its Chrome trace under the directory), or
    a context that does nothing."""
    import contextlib

    from arrow_matrix_tpu_torch.utils.logging import trace

    if not args.trace:
        return contextlib.nullcontext()
    return trace(args.trace, device=device)


def close_obs(args, reg, tracer, say, writer: bool = True) -> None:
    """``--obs_dir``: the tracer's Chrome trace and the registry's
    ``metrics.jsonl`` (``writer``: this process writes them)."""
    if not args.obs_dir or not writer:
        return
    os.makedirs(args.obs_dir, exist_ok=True)
    tracer.save(os.path.join(args.obs_dir, "spmm_arrow.trace.json"))
    reg.write_jsonl(os.path.join(args.obs_dir, "metrics.jsonl"))
    say(f"observability artifacts in {args.obs_dir} (spmm_arrow.trace.json, "
        f"metrics.jsonl)")


def prepare_artifact(args) -> tuple:
    """(path, width) of the run's artifact: ``--path``, or a generated
    Barabasi-Albert graph decomposed and saved in the cwd."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import save_decomposition
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    if args.path is not None:
        if not args.width:
            raise SystemExit("--width is required with --path (it names "
                             "the artifact files)")
        return args.path, args.width
    width = args.width or 512
    n = args.vertices
    path = os.path.join(".", f"ba_{n}_{args.ba_neighbors}")
    print(f"generating Barabasi-Albert graph n={n} m={args.ba_neighbors}")
    a = barabasi_albert(n, args.ba_neighbors, seed=args.seed)
    levels = arrow_decomposition(a, arrow_width=width, max_levels=10,
                                 block_diagonal=args.blocked, seed=args.seed)
    save_decomposition(levels, path, block_diagonal=args.blocked)
    return path, width


def mesh_main(args) -> int:
    """``--devices P > 1``: the ranks (``cli/common.launch_ranks``), on
    the card unless ``--device cpu``; rank 0 makes the artifact and
    hands its path to the others (:func:`mesh_entry`)."""
    from arrow_matrix_tpu_torch.cli.common import launch_ranks

    try:
        return launch_ranks(args, mesh_entry)
    except SystemExit as e:
        raise SystemExit(f"spmm_arrow: {e}") from None


def mesh_entry(ctx, args) -> int:
    """A rank's start: the artifact made once, on rank 0, its path
    broadcast, then :func:`mesh_rank`."""
    import torch.distributed as dist

    box = list(prepare_artifact(args)) if ctx.rank == 0 else [None, None]
    dist.broadcast_object_list(box, src=0)
    return mesh_rank(ctx, args, *box)


def mesh_rank(ctx, args, path: str, width: int) -> int:
    """One rank of ``spmm_arrow --devices P``: its mesh, its shards of the
    executor, the iteration loop (``--validate`` on every rank against
    the host golden; rank 0 prints), and ``--comm_report``."""
    from arrow_matrix_tpu_torch.io import num_nonzeros, num_rows
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.parallel.mesh import (
        make_mesh,
        make_repl_mesh,
    )
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel

    from arrow_matrix_tpu_torch.utils import logging as wb

    say = print if ctx.rank == 0 else (lambda *a, **k: None)
    n_dev = ctx.world
    levels, golden = load_levels(args, path, width)
    n = num_rows(levels[0].matrix)
    wb.init(run_name(args), os.path.basename(path), config=vars(args))
    if args.mode == "space":
        return space_rank(ctx, args, levels, golden, width, say)
    repl_c = 1
    if args.repl == "auto":
        from arrow_matrix_tpu_torch.obs.comm import auto_repl

        nnz = sum(num_nonzeros(lvl.matrix) for lvl in levels)
        base = nnz * 8 // n_dev + 2 * (-(-n // n_dev)) * args.features * 4
        exch = max(n_dev - 1, 0) * width * args.features * 4 * len(levels)
        repl_c = auto_repl(n_dev, args.features, base,
                           exchange_bytes=exch, quiet=ctx.rank != 0,
                           device=ctx.device)["c"]
    elif args.repl != "1":
        repl_c = int(args.repl)
    tic = time.perf_counter()
    if not args.slim:
        mesh = make_mesh((2, n_dev // 2), ("arm", "blocks"))
    elif repl_c > 1:
        mesh = make_repl_mesh(n_dev, repl_c)
        say(f"2.5D mesh: {n_dev // repl_c} block shards x {repl_c} "
            f"replica groups")
    else:
        mesh = make_mesh((n_dev,), ("blocks",))
    if args.fmt == "sell":
        exe = SellMultiLevel(levels, width, mesh, routing=args.routing,
                             feature_dtype=args.feature_dtype,
                             ladder=args.ladder,
                             repl_axis="repl" if repl_c > 1 else None)
        what = (f"sell: {len(levels)} levels, {exe.rows_local} carried "
                f"rows a rank, halo hops {[o.hops for o in exe.ops]}")
    else:
        exe = MultiLevelArrow(levels, width, mesh=mesh, fmt=args.fmt,
                              head_fmt=args.head_fmt,
                              banded=not args.blocked,
                              layout="slim" if args.slim else "wide",
                              routing=args.routing)
        what = f"{args.fmt}: formats {exe.fmts}, widths {exe.widths}"
    wb.log({"build_time": time.perf_counter() - tic})
    say(f"mesh: {dict(mesh.shape)} over {ctx.backend} ({ctx.world} ranks "
        f"on {ctx.device}); {what}, routing {args.routing} "
        f"({time.perf_counter() - tic:.3f} s)")
    return drive_ranks(ctx, args, exe, levels, golden, n, repl_c, say)


def space_rank(ctx, args, levels, golden, width: int, say) -> int:
    """``--mode space`` in a rank: a (lvl, blocks) mesh with one level
    group a level, ``SellSpaceShared`` (``--fmt sell``) or
    ``SpaceSharedArrow``, then the iteration loop."""
    from arrow_matrix_tpu_torch.io import num_rows
    from arrow_matrix_tpu_torch.parallel import (
        SellSpaceShared,
        SpaceSharedArrow,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    n_dev, k_levels = ctx.world, len(levels)
    if n_dev % k_levels:
        say(f"--mode space needs the device count ({n_dev}) divisible "
            f"by the level count ({k_levels}); rerun with --devices set "
            f"accordingly")
        return 2
    if args.routing != "gather":
        say(f"warning: --routing {args.routing} applies only to --mode "
            f"time; space-shared exchanges are the composed tables and "
            f"the sum over the level groups")
    tic = time.perf_counter()
    mesh = make_mesh((k_levels, n_dev // k_levels), ("lvl", "blocks"))
    if args.fmt == "sell":
        exe = SellSpaceShared(levels, width, mesh,
                              feature_dtype=args.feature_dtype,
                              ladder=args.ladder)
        what = (f"sell space: {exe.rows_out} carried rows a rank, halo "
                f"hops {exe.hops}")
    else:
        exe = SpaceSharedArrow(levels, width, mesh, fmt=args.fmt)
        what = (f"space: {exe.fmt} blocks at banded width {exe.width}, "
                f"{exe.rows_local} rows a rank")
    say(f"mesh: {dict(mesh.shape)} over {ctx.backend} ({ctx.world} ranks "
        f"on {ctx.device}); {what} ({time.perf_counter() - tic:.3f} s)")
    return drive_ranks(ctx, args, exe, levels, golden,
                       num_rows(levels[0].matrix), 1, say)


def drive_ranks(ctx, args, exe, levels, golden, n: int, repl_c: int,
                say) -> int:
    """The iteration loop of a rank: warm-up, ``--comm_report``, the
    timed steps under a supervisor on the executor's mesh (``--carry
    --checkpoint``: every rank resumes from the one shared checkpoint,
    the mesh's first rank writes it), ``--validate`` against the host
    golden on every rank (rank 0 prints)."""
    import torch

    from arrow_matrix_tpu_torch.cli.common import make_supervisor
    from arrow_matrix_tpu_torch.decomposition import decomposition_spmm
    from arrow_matrix_tpu_torch.faults import Abort
    from arrow_matrix_tpu_torch.utils import (
        commstats,
        random_dense,
        relative_error,
    )
    from arrow_matrix_tpu_torch.utils import logging as wb

    def sync():
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    x_host = random_dense(n, args.features, seed=args.seed)
    x = exe.set_features(x_host)
    exe.step(x)                 # warm-up: builds and first launches
    sync()
    reg, tracer = open_obs(args)
    if args.mem_report:
        mem_report(args, exe, x, reg, say)
    if args.comm_report:
        from arrow_matrix_tpu_torch.obs.comm import (
            account_collectives,
            ideal_bytes_for,
            reduce_bytes_for,
        )

        item = 2 if args.feature_dtype == "bf16" else 4
        rep = account_collectives(
            "spmm_arrow", lambda: (exe.step(x), sync()),
            ideal_bytes=ideal_bytes_for(exe, args.features, item),
            overlap_slabs=getattr(exe, "overlap_slabs", 1), repl=repl_c,
            reduce_bytes=reduce_bytes_for(exe, args.features, item))
        say("per-iteration collective bytes on rank 0 (utils/commstats):")
        say(commstats.format_stats(rep["collectives"]))
        ratio = rep["ratio"]
        say(f"ideal {rep['ideal_bytes']} B (ratio "
            f"{'n/a' if ratio is None else f'{ratio:.3f}'}), reduce "
            f"{rep['reduce_bytes']} B, host staged "
            f"{rep['host_staged_bytes']} B, exposed "
            f"{rep['exposed_comm_ms']} ms at the modeled link rate")
    tol = gate_tolerance(args, levels, n)
    rng = np.random.default_rng(args.seed)
    times = []
    # The layout tag names the mode, format, carriage and rank count: a
    # resume on another mesh fails loudly.
    layout = (f"spmm_arrow/{args.mode}/{args.fmt}/"
              f"{args.feature_dtype or 'f32'}/ranks{ctx.world}"
              + (f"/repl{repl_c}" if repl_c > 1 else ""))
    sup = make_supervisor(
        args, "spmm_arrow", carry=args.carry, layout=layout,
        canonicalize=getattr(exe, "merge_carries", None)
        if repl_c > 1 else None, mesh=exe.mesh)
    start = 0
    if args.carry and args.checkpoint:
        state = sup.resume(like=x)
        if state is not None:
            x, start = state
            say(f"resumed from {args.checkpoint} at iteration {start}")

    def body(x, it):
        wb.set_iteration_data({"iteration": it})
        if not args.carry:
            x_host = random_dense(n, args.features,
                                  seed=int(rng.integers(2**31)))
            x = exe.set_features(x_host)
        elif args.validate:
            x_host = exe.gather_result(x)
        sync()
        with step_span(tracer, it):
            tic = time.perf_counter()
            y = exe.step(x)
            sync()
            dt = time.perf_counter() - tic
        times.append(dt)
        wb.log({"spmm_time": dt})
        if reg is not None:
            reg.record("iteration_time_ms", dt * 1e3,
                       algorithm="spmm_arrow")
        if args.validate:
            err = relative_error(exe.gather_result(y),
                                 decomposition_spmm(golden, x_host))
            wb.log({"frobenius_err": float(err)})
            say(f"iteration {it}: rel err vs host {err:.3e} "
                f"(gate {tol:.1e})")
            if not np.isfinite(err) or err > tol:
                # A policy failure: never retried, and no checkpoint of
                # this state is written.
                raise Abort(f"validation gate failed at iteration {it}")
        return y

    with traced(args, ctx.device):
        _, ok = sup.run(body, x, start, args.iterations)
    close_obs(args, reg, tracer, say, writer=ctx.rank == 0)
    out = wb.finish(args.logdir) if ctx.rank == 0 else None
    if out:
        say(f"log written to {out}.json")
    if not ok:
        say("the supervised loop failed (validation gate, or retries "
            "exhausted)")
        return 1
    if times:
        ms = np.asarray(times) * 1e3
        say(f"spmm_time mean {ms.mean():.3f} ms over {len(ms)} iterations "
            f"(min {ms.min():.3f}) on {ctx.world} {ctx.backend} ranks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``arrow_decompose`` — the offline arrow decomposition command line.

The port's counterpart of ``arrow_matrix_tpu/cli/arrow_decompose.py``,
with its flags: load each graph (``.npz``, ``.mtx`` or ``.mat``), run
``arrow_decomposition`` and save the npy-triplet artifact (the files the
JAX package writes), which ``spmm_arrow --path`` loads.

    python -m arrow_matrix_tpu_torch.cli.arrow_decompose \\
        --dataset_dir graphs --dataset_name web.npz --width 2048 \\
        --levels 10 --backend native

Runs on the host only.  ``--backend auto`` (the default) takes the C++
decomposer when it builds and loads (``g++``), numpy otherwise; pin one
for results that are the same on every machine.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

from arrow_matrix_tpu_torch.cli.common import load_sparse_matrix, str2bool


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Arrow decomposition of sparse graphs.")
    parser.add_argument("--width", type=int, default=5_000_000,
                        help="Arrow width (block size).")
    parser.add_argument("--dataset_dir", type=str, default=".",
                        help="Directory containing the graph files.")
    parser.add_argument("--dataset_name", nargs="+", type=str, required=True,
                        help="Graph file names (extension included; "
                             ".npz/.mtx/.mat).")
    parser.add_argument("--levels", type=int, default=10,
                        help="Maximum number of decomposition levels.")
    parser.add_argument("--block_diagonal", type=str2bool, nargs="?",
                        default=True,
                        help="Block-diagonal (vs banded) edge criterion.")
    parser.add_argument("--directed", type=str2bool, nargs="?", default=False,
                        help="Accepted for flag parity; the decomposer "
                             "symmetrizes the structure of asymmetric "
                             "inputs for the linear order by itself.")
    parser.add_argument("--seed", type=int, default=0,
                        help="Linearization RNG seed.")
    parser.add_argument("--visualize", type=str2bool, nargs="?",
                        default=False,
                        help="Save a spy plot of each level (needs "
                             "matplotlib).")
    parser.add_argument("--save_input_graph", type=str2bool, nargs="?",
                        default=False,
                        help="Pickle the parsed input graph next to the "
                             "artifact, and reuse it while it is newer "
                             "than the source file.")
    parser.add_argument("--out_dir", type=str, default=None,
                        help="Output directory (default: dataset_dir).")
    parser.add_argument("--band_detect", type=str2bool, nargs="?",
                        default=True,
                        help="Detect banded/bandable inputs (identity "
                             "or RCM order) and emit ONE level; false "
                             "keeps the plain recursion.")
    parser.add_argument("--backend", type=str, default="auto",
                        choices=["auto", "native", "numpy"],
                        help="Linearization backend: the native C++ "
                             "kernels or the scipy/csgraph "
                             "implementation (auto: native when it "
                             "loads).  The backends draw different "
                             "random streams: pin one for results that "
                             "are the same across machines.")
    return parser


def decompose_one(path: str, args: argparse.Namespace) -> None:
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.io import save_decomposition

    base_name = os.path.splitext(os.path.basename(path))[0]
    out_dir = args.out_dir or args.dataset_dir
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, base_name)

    # The pickled graph is used only when --save_input_graph asked for
    # it, and only while it is newer than the source file (pickle runs
    # code: never load one the user did not ask to create).
    cache = base + ".pickle"
    cache_fresh = (args.save_input_graph and os.path.exists(cache)
                   and (not os.path.exists(path)
                        or os.path.getmtime(cache) > os.path.getmtime(path)))
    if cache_fresh:
        print(f"loading cached graph {cache}")
        with open(cache, "rb") as f:
            a = pickle.load(f)
    else:
        print(f"loading {path}")
        a = load_sparse_matrix(path)
        if args.save_input_graph:
            with open(cache, "wb") as f:
                pickle.dump(a, f)

    print(f"decomposing n={a.shape[0]} nnz={a.nnz} width={args.width} "
          f"levels<={args.levels} block_diagonal={args.block_diagonal}")
    tic = time.perf_counter()
    levels = arrow_decomposition(
        a, arrow_width=args.width, max_levels=args.levels,
        block_diagonal=args.block_diagonal, seed=args.seed,
        backend=args.backend, band_detect=args.band_detect)
    print(f"decomposed into {len(levels)} levels in "
          f"{time.perf_counter() - tic:.1f}s; achieved widths "
          f"{[l.arrow_width for l in levels]}")

    save_decomposition(levels, base, block_diagonal=args.block_diagonal)
    print(f"saved artifact under {base}_B_{levels[0].arrow_width}_*")

    if args.visualize:
        visualize(levels, base)


def visualize(levels, base: str) -> None:
    """Spy-plot each level into ``{base}_decomposition.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(levels),
                             figsize=(4 * len(levels), 4), squeeze=False)
    for ax, lvl in zip(axes[0], levels):
        ax.spy(lvl.matrix, markersize=0.1)
        ax.set_title(f"width {lvl.arrow_width}")
    fig.savefig(base + "_decomposition.png", dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {base}_decomposition.png")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    for name in args.dataset_name:
        decompose_one(os.path.join(args.dataset_dir, name), args)


if __name__ == "__main__":
    main()

"""Shared CLI plumbing: flag parsing, the device, the supervised loop
and matrix loading.

The port's copy of ``arrow_matrix_tpu/cli/common.py``: ``str2bool``,
``add_device_args`` / ``setup_platform`` (``--device`` picks the card,
the default, or ``cpu``; there is no silent fallback), ``add_heal_args``
/ ``make_supervisor`` (the supervised iteration loop's flags),
``load_sparse_matrix`` (``.npz``, ``.mtx``, ``.mat`` including MATLAB
v7.3 through h5py), ``random_adjacency`` and ``normalize_scale``; and
``add_rank_args`` / ``launch_ranks``, the port's multi-process launch
(one process a rank on ``torch.distributed``), in place of the JAX
module's multi-host flags.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
from scipy import sparse


def str2bool(v) -> bool:
    """Boolean flag parser (yes/no, true/false, t/f, y/n, 1/0)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def add_device_args(parser: argparse.ArgumentParser) -> None:
    """``--device``: ``cuda`` (the card, the default) or ``cpu`` (the
    plain PyTorch versions of the kernels)."""
    parser.add_argument(
        "-i", "--device", type=str, default="cuda",
        choices=["cuda", "cpu"],
        help="Where the product runs (default: the card; 'cpu' runs the "
             "plain PyTorch versions of the kernels).")


def add_rank_args(parser: argparse.ArgumentParser) -> None:
    """``--devices`` (ranks of the mesh, one process each) and
    ``--backend`` (nccl: one card a rank; gloo: the CPU, or ranks that
    share a card)."""
    parser.add_argument(
        "--devices", type=int, default=1,
        help="Ranks of the mesh, one process each (started here unless "
             "the env already holds a torchrun-style WORLD_SIZE).")
    parser.add_argument(
        "--backend", type=str, default=None, choices=["nccl", "gloo"],
        help="Process-group backend of the ranks: nccl (one card a rank, "
             "the default on the card) or gloo (the CPU, or ranks "
             "sharing a card).")


def launch_ranks(args: argparse.Namespace, fn, *fn_args) -> int:
    """Run ``fn(ctx, args, *fn_args)`` on ``args.devices`` ranks and
    return the largest of their exit codes: this process as one rank of
    a ``torchrun``-style job when the env holds ``WORLD_SIZE``, else that
    many ranks started here (``parallel/launch.spawn``), on the card
    unless ``--device cpu``."""
    from arrow_matrix_tpu_torch.parallel.launch import (
        RankContext,
        resolve_launch,
        spawn,
    )

    if args.devices < 1:
        raise SystemExit("--devices must be >= 1")
    try:
        backend, _ = resolve_launch(args.devices, args.backend, args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"{e}") from None
    if "WORLD_SIZE" in os.environ:
        from arrow_matrix_tpu_torch.parallel.mesh import (
            initialize_multihost,
            rank_device,
            set_rank_device,
        )

        if int(os.environ["WORLD_SIZE"]) != args.devices:
            raise SystemExit(f"--devices {args.devices} but the env's "
                             f"WORLD_SIZE is {os.environ['WORLD_SIZE']}")
        rank = initialize_multihost(backend=backend, device=args.device)
        dev = rank_device(int(os.environ.get("LOCAL_RANK", rank)),
                          args.device)
        set_rank_device(dev)
        return fn(RankContext(rank, args.devices, dev, backend), args,
                  *fn_args)
    return max(spawn(fn, args.devices, args=(args,) + fn_args,
                     backend=backend, device=args.device))


def setup_platform(args: argparse.Namespace):
    """The ``torch.device`` of ``--device``; exits with a message when
    the card is asked for and there is none."""
    from arrow_matrix_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def add_heal_args(parser: argparse.ArgumentParser,
                  checkpoint_every_default: int = 10) -> None:
    """The supervised run loop's flags (watchdog, bounded retry, finite
    check) and iteration-state checkpointing
    (``utils/checkpoint.py``)."""
    g = parser.add_argument_group(
        "supervised loop", "watchdog, bounded retry, checkpoint resume "
                           "(see faults/)")
    g.add_argument("--checkpoint", type=str, default=None,
                   help="Base path (or, for the server, directory) of "
                        "iteration-state checkpoints (the batch CLI needs "
                        "--carry): X and the iteration counter are saved "
                        "every --checkpoint_every iterations as npz with "
                        "a sha256 sidecar, and a rerun resumes from the "
                        "checkpoint when one exists.")
    g.add_argument("--checkpoint_every", type=int,
                   default=checkpoint_every_default)
    g.add_argument("--watchdog", type=float, default=0.0,
                   help="Per-iteration watchdog seconds (0 disables): an "
                        "iteration past the budget (the kernels' run "
                        "included: the step is synchronised) is a fault, "
                        "retried from its entry state, or escalated when "
                        "it never drains.")
    g.add_argument("--max_retries", type=int, default=2,
                   help="Consecutive faulted attempts of one iteration "
                        "before the run fails (each retry backs off "
                        "exponentially and rolls back to the last "
                        "checkpoint when one exists).")
    g.add_argument("--retry_jitter", type=float, default=0.0,
                   help="±fraction of deterministic, seedable jitter on "
                        "each backoff delay (faults/policy.py).")
    g.add_argument("--finite_check", type=str2bool, nargs="?",
                   default=True, const=True,
                   help="All-finite check on the carried X each "
                        "iteration; NaN/Inf rolls back to the last "
                        "checkpoint (carry mode only).")


def make_supervisor(args: argparse.Namespace, name: str, *,
                    carry: bool, layout: Optional[str] = None,
                    registry=None, canonicalize=None, mesh=None,
                    mesh_axis: str = "blocks"):
    """The supervised loop of a CLI run, from its ``add_heal_args``
    flags (``mesh``: the mesh of ranks whose ``mesh_axis`` shards the
    carriage's rows; its checkpoints and attempt outcomes are shared
    over its ranks)."""
    from arrow_matrix_tpu_torch.faults import RetryPolicy, Supervisor

    return Supervisor(
        name, carry=carry,
        policy=RetryPolicy.from_args(args),
        checkpoint_path=getattr(args, "checkpoint", None),
        checkpoint_every=getattr(args, "checkpoint_every", 0),
        finite_check=bool(getattr(args, "finite_check", True)) and carry,
        layout=layout, registry=registry, canonicalize=canonicalize,
        mesh=mesh, mesh_axis=mesh_axis)


def load_sparse_matrix(path: str, dtype=np.float32) -> sparse.csr_matrix:
    """Load a sparse matrix from .npz (scipy), .mtx (matrix market) or
    .mat (MATLAB), by extension, as canonical CSR of ``dtype``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        m = sparse.load_npz(path)
    elif ext in (".mtx", ".mm"):
        from scipy.io import mmread

        m = mmread(path)
    elif ext == ".mat":
        m = _load_matlab(path)
    else:
        raise ValueError(f"unsupported matrix format {ext!r} "
                         f"(expected .npz, .mtx, or .mat)")
    m = sparse.csr_matrix(m).astype(dtype)
    m.sum_duplicates()
    m.sort_indices()
    return m


def _load_matlab(path: str) -> sparse.spmatrix:
    from scipy.io import loadmat

    try:
        contents = loadmat(path)
    except NotImplementedError:
        return _load_matlab_hdf5(path)   # v7.3 files are HDF5
    for v in contents.values():
        if sparse.issparse(v):
            return v
    raise ValueError(f"no sparse matrix found in {path}")


def _load_matlab_hdf5(path: str) -> sparse.spmatrix:
    """MATLAB v7.3 (HDF5) sparse matrix through h5py: a group with CSC
    datasets ``data``/``ir``/``jc`` and the row count in its
    ``MATLAB_sparse`` attribute; ``Problem/A`` (the SuiteSparse
    layout) first, then the first sparse-tagged group."""
    try:
        import h5py
    except ImportError:
        raise ValueError(
            f"{path} is a MATLAB v7.3 (HDF5) file and h5py is not "
            f"available; convert it to .npz or .mtx first")

    def as_csc(node):
        jc = np.asarray(node["jc"], dtype=np.int64)
        ir = np.asarray(node["ir"], dtype=np.int64)
        data = (np.asarray(node["data"]) if "data" in node
                else np.ones(ir.size, dtype=np.float32))
        n_rows = int(node.attrs["MATLAB_sparse"])
        return sparse.csc_matrix((data, ir, jc), shape=(n_rows, jc.size - 1))

    with h5py.File(path, "r") as f:
        if ("Problem" in f and "A" in f["Problem"]
                and "MATLAB_sparse" in f["Problem"]["A"].attrs):
            return as_csc(f["Problem"]["A"])
        found = []

        def visit(name, node):
            if isinstance(node, h5py.Group) and "MATLAB_sparse" in node.attrs:
                found.append(name)

        f.visititems(visit)
        if found:
            return as_csc(f[found[0]])
    raise ValueError(f"no MATLAB sparse matrix found in HDF5 file {path}")


def random_adjacency(vertices: int, edges: int, seed: int,
                     dtype=np.float32) -> sparse.csr_matrix:
    """Random graph with about ``edges`` nonzeros (a fixed count a
    row)."""
    from arrow_matrix_tpu_torch.utils.graphs import random_csr

    nnz_per_row = max(1, edges // max(vertices, 1))
    return random_csr(vertices, vertices, nnz_per_row,
                      seed=seed).astype(dtype)


def normalize_scale(a: sparse.csr_matrix) -> sparse.csr_matrix:
    """Scale so that iterated SpMM stays bounded (the benchmark loops
    feed the output back as the next input)."""
    s = max(abs(a).sum(axis=1).max(), 1.0)
    return (a / s).tocsr().astype(a.dtype)


def report_memory(algorithm: str, exe, step, x, k: int, say,
                  itemsize: int = 4, registry=None) -> None:
    """``--mem_report``: the device memory of one ``step(x, *operands)``
    of ``exe`` against its own model at width ``k``, and its
    load-imbalance report (on a mesh every rank runs both, the step and
    the report being collective; ``say`` prints on the first rank)."""
    from arrow_matrix_tpu_torch.obs.imbalance import (
        account_imbalance,
        format_imbalance_report,
    )
    from arrow_matrix_tpu_torch.obs.memview import (
        account_memory,
        format_memory_report,
        predicted_bytes_for,
    )

    mem = account_memory(
        algorithm, step, x, *exe.step_operands(),
        predicted_bytes=predicted_bytes_for(exe, k, itemsize=itemsize),
        registry=registry)
    say(format_memory_report(mem))
    imb = account_imbalance(algorithm, exe, registry=registry)
    if imb is not None:
        say(format_imbalance_report(imb))

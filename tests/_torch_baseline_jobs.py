"""Rank jobs of the port's baseline tests (``tests/test_torch_baselines.py``,
``tests/test_torch_obs_smoke.py``).

Each function runs in every rank of a ``parallel/launch.RankPool`` (gloo
on the CPU) and imports only the port; every rank returns its own shard
and reports, rank 0 also the global result.  Not a test module.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def _mesh(shape, names):
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(tuple(shape), tuple(names))


def _reports(ctx, exe, c, k, stats):
    out = exe.gather_result(c)
    res = {"stats": stats, "ideal": exe.ideal_comm_bytes(k),
           "hbm": exe.predicted_hbm_bytes(k),
           "report": exe.shard_report(),
           "launches": exe.launch_counts(k),
           "contract": exe.collective_contract(k).to_json()}
    if ctx.rank == 0:
        res["out"] = out
    return res


def slice_1d(ctx, a, x, steps, kw, n_dev=None):
    """``MatrixSlice1D(a, mesh, **kw)`` on a ``(n_dev,)`` slices mesh:
    ``steps`` steps of ``x``; this rank's packing, tables, one step's
    collective counts and the reports."""
    from arrow_matrix_tpu_torch.parallel.spmm_1d import MatrixSlice1D
    from arrow_matrix_tpu_torch.utils import commstats

    exe = MatrixSlice1D(a, _mesh((n_dev or ctx.world,), ("slices",)), **kw)
    c = exe.set_features(x)
    stats = None
    for s in range(steps):
        if s == 0:
            commstats.reset()
        c = exe.spmm(c)
        if s == 0:
            stats = commstats.snapshot()
    res = _reports(ctx, exe, c, x.shape[1], stats)
    res.update(slices=exe.slices, slot=exe.slot, l_rows=exe.l_rows,
               chunk=exe.chunk,
               packed={name: getattr(exe, name) for name in (
                   "l_cols", "l_data", "nl_cols", "nl_data", "send_idx")})
    return res


def spmm_15d(ctx, a, x, steps, grid, kw):
    """``SpMM15D(a, mesh, **kw)`` on a ``grid`` (rows, repl) mesh:
    ``steps`` chained steps; this rank's packing, its result block (the
    replicas' check), one step's counts and the reports."""
    from arrow_matrix_tpu_torch.parallel.spmm_15d import SpMM15D
    from arrow_matrix_tpu_torch.utils import commstats

    exe = SpMM15D(a, _mesh(grid, ("rows", "repl")), **kw)
    c = exe.set_features(x)
    stats = None
    for s in range(steps):
        if s == 0:
            commstats.reset()
        c = exe.spmm(exe.as_features(c) if s else c)
        if s == 0:
            stats = commstats.snapshot()
    res = _reports(ctx, exe, c, x.shape[1], stats)
    res.update(block=c.numpy(), rounds=exe.rounds, chunk=exe.chunk,
               cell=(exe.row, exe.col),
               packed={"a_cols": exe.a_cols, "a_data": exe.a_data})
    return res


def refused(ctx, which, a, grid_or_n, kw):
    """The ValueError message a build raises on this rank (None when it
    builds)."""
    from arrow_matrix_tpu_torch.parallel.spmm_1d import MatrixSlice1D
    from arrow_matrix_tpu_torch.parallel.spmm_15d import SpMM15D

    try:
        if which == "1d":
            MatrixSlice1D(a, _mesh((grid_or_n,), ("slices",)), **kw)
        else:
            SpMM15D(a, _mesh(grid_or_n, ("rows", "repl")), **kw)
    except ValueError as e:
        return str(e)
    return None


def smoke(ctx, run_dir, kw):
    """``obs/smoke.run_smoke`` in this rank (rank 0 writes ``run_dir``)."""
    from arrow_matrix_tpu_torch.obs.smoke import run_smoke

    return run_smoke(run_dir, n_dev=ctx.world, **kw)

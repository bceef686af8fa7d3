"""Rank jobs of the port's tests of the streamed pack, memmapped
levels, checkpoints on a mesh and serving on a mesh.

Each function runs in every rank of a ``parallel/launch.RankPool`` (gloo
on the CPU) and imports only the port.  A job that must show a refusal
returns its message instead of raising (a raising job stops the pool).
Not a test module.
"""

import os

import numpy as np
import torch

torch.set_num_threads(1)


def _mesh(shape=None, names=("blocks",), ranks=None):
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(None if shape is None else tuple(shape), tuple(names),
                     ranks=ranks)


def _levels(base, width, memmap):
    from arrow_matrix_tpu_torch.io import (
        as_levels,
        load_decomposition,
        load_level_widths,
    )

    loaded = load_decomposition(base, width, mem_map=memmap)
    widths = load_level_widths(base, width)
    return as_levels(loaded, width if widths is None else widths,
                     materialize=not memmap)


# -- the streamed pack and memmapped levels --------------------------------

def streamed(ctx, base, width, level, kw):
    """This rank's ``arrow_blocks_streamed`` of a memmapped level: every
    array as numpy, the head layout and the block-row count."""
    from arrow_matrix_tpu_torch.io import load_decomposition
    from arrow_matrix_tpu_torch.ops.arrow_blocks import (
        arrow_blocks_streamed,
        shard_range,
    )

    triplet = load_decomposition(base, width, mem_map=True)[level][0]
    assert not hasattr(triplet, "nnz")
    mesh = _mesh()
    blk = arrow_blocks_streamed(triplet, width, mesh, **kw)
    return {"arrays": {k: v.cpu().numpy() for k, v in
                       blk.tensors().items()},
            "head_flat": blk.head_flat, "n_blocks": blk.n_blocks,
            "first": shard_range(kw["pad_blocks_to"], mesh, "blocks")[0]}


def streamed_refusal(ctx, base, width, level, kw):
    """The streamed pack's refusal, as text (None when it built)."""
    from arrow_matrix_tpu_torch.io import load_decomposition
    from arrow_matrix_tpu_torch.ops.arrow_blocks import arrow_blocks_streamed

    triplet = load_decomposition(base, width, mem_map=True)[level][0]
    try:
        arrow_blocks_streamed(triplet, kw.pop("build_width"), _mesh(), **kw)
    except ValueError as e:
        return str(e)
    return None


def memmap_step(ctx, base, width, x, kind, kw, shape=None,
                names=("blocks",)):
    """One step of ``kind`` built from memmapped levels and from the
    in-memory levels: both global results on rank 0, and whether this
    rank's carriages are equal bit for bit."""
    from arrow_matrix_tpu_torch.parallel import (
        MultiLevelArrow,
        SellMultiLevel,
        SellSpaceShared,
    )

    mesh = _mesh(shape, names)
    build = {"multi_level": lambda lv: MultiLevelArrow(lv, width, mesh=mesh,
                                                       **kw),
             "sell_multi": lambda lv: SellMultiLevel(lv, width, mesh, **kw),
             "sell_space": lambda lv: SellSpaceShared(lv, width, mesh,
                                                      **kw)}[kind]
    outs, carried = [], []
    for memmap in (True, False):
        levels = _levels(base, width, memmap)
        assert memmap == (not hasattr(levels[0].matrix, "nnz"))
        exe = build(levels)
        c = exe.step(exe.set_features(x))
        carried.append(c.cpu().numpy())
        outs.append(exe.gather_result(c))
    same = carried[0].tobytes() == carried[1].tobytes()
    return {"same": same, "out": outs if ctx.rank == 0 else None}


# -- checkpoints on a mesh ----------------------------------------------------

def _multi(levels, width, mesh, fmt="ell"):
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    return MultiLevelArrow(levels, width, mesh=mesh, fmt=fmt)


def checkpoint_round_trip(ctx, levels, width, x, path, layout):
    """Save a stepped carriage on the mesh, load it back: the rows each
    rank gets, the file's global carriage, and the step."""
    from arrow_matrix_tpu_torch.utils import commstats
    from arrow_matrix_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    mesh = _mesh()
    exe = _multi(levels, width, mesh)
    c = exe.step(exe.set_features(x))
    commstats.reset()
    save_state(path, c, 1, layout=layout, mesh=mesh)
    saved = commstats.snapshot()
    got, step = load_state(path, like=c, layout=layout, mesh=mesh)
    with np.load(path + ".npz") as z:
        full = np.array(z["x"])
    return {"equal": got.cpu().numpy().tobytes() == c.cpu().numpy()
            .tobytes(), "step": step, "full": full if ctx.rank == 0 else None,
            "rows": c.shape[0],
            "counted": sorted(k for k, v in saved.items()
                              if isinstance(v, dict) and v["count"])}


def checkpoint_failing_writer(ctx, path):
    """The writer (rank 0) fails to write: every rank's error text."""
    from arrow_matrix_tpu_torch.utils import checkpoint as ck

    mesh = _mesh()
    if ctx.rank == 0:
        def refuse(*a, **k):
            raise OSError("disk full (injected)")
        np_savez, np.savez = np.savez, refuse
    try:
        ck.save_state(path, torch.ones(4, 2), 3, layout="t", mesh=mesh)
    except RuntimeError as e:
        return str(e)
    finally:
        if ctx.rank == 0:
            np.savez = np_savez
    return None


def checkpoint_other_mesh(ctx, levels, width, x, path):
    """A checkpoint of the 2-rank mesh resumed on a 1-rank mesh: the
    tag's refusal, then (the tag forced equal) the shape's, as text on
    rank 0."""
    from arrow_matrix_tpu_torch.utils.checkpoint import (
        load_state,
        save_state,
    )

    mesh2 = _mesh()
    exe2 = _multi(levels, width, mesh2)
    c = exe2.set_features(x)
    save_state(path, c, 2, layout="spmm_arrow/ranks2", mesh=mesh2)
    mesh1 = _mesh((1,), ranks=(0,))
    if ctx.rank != 0:
        return None
    exe1 = _multi(levels, width, mesh1)
    like = exe1.set_features(x)
    msgs = []
    for layout in ("spmm_arrow/ranks1", "spmm_arrow/ranks2"):
        try:
            load_state(path, like=like, layout=layout, mesh=mesh1)
            msgs.append(None)
        except (RuntimeError, ValueError) as e:
            msgs.append(str(e))
    return msgs


def checkpoint_load_rows(ctx, path, rows, layout):
    """Load a file written elsewhere (the JAX package's) on the mesh:
    each rank's rows."""
    from arrow_matrix_tpu_torch.utils.checkpoint import load_state

    mesh = _mesh()
    like = torch.zeros(rows, 2)
    got, step = load_state(path, like=like, layout=layout, mesh=mesh)
    return got.numpy(), step


# -- serving on a mesh ----------------------------------------------------------

def mesh_serve(ctx, n, width, seed, trace_kw, ck_dir=None, max_batch_k=0,
               threaded=False, fmt="ell"):
    """``ba_executor_factory(mesh=)`` rungs served in lockstep (by
    ``drain()``, or ``threaded`` by each rank's worker thread between
    ``start()`` and ``shutdown()``): every request's result on this
    rank, the builds a rung took, the batches."""
    from arrow_matrix_tpu_torch.serve import (
        ArrowServer,
        ExecConfig,
        ba_executor_factory,
        run_trace,
        synthetic_trace,
    )

    mesh = _mesh()
    factory, n_rows = ba_executor_factory(n, width, seed, fmt=fmt,
                                          mesh=mesh)
    builds = {}

    def counted(cfg):
        builds[str(cfg)] = builds.get(str(cfg), 0) + 1
        return factory(cfg)

    server = ArrowServer(counted, ExecConfig(), checkpoint_dir=ck_dir,
                         max_batch_k=max_batch_k, name="mesh")
    trace = synthetic_trace(n_rows, **trace_kw)
    if threaded:
        server.start()
    tickets = run_trace(server, trace)
    if threaded:
        server.shutdown(wait=True, timeout=60)
        assert not server._thread.is_alive()
    return {"results": {t.request.request_id: t.result for t in tickets},
            "status": [t.status for t in tickets], "builds": builds,
            "lockstep": server.lockstep, "leader": server.leader,
            "batches": server.batches}


def mesh_grow(ctx, ck_dir, n, width, seed, trace_kw, budget,
              via_pressure=False):
    """The reshard gate's run in-process: step-2 checkpoints seeded
    on ranks (0, 1), a server grown to the 4-rank mesh (by ``grow()`` on
    every rank, or ``via_pressure`` by rank 0's
    ``note_slo_pressure(direction="grow")`` while the worker threads
    serve), the trace served; results and resumed steps on every rank,
    rank 0's grow counts."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.serve import (
        ArrowServer,
        ExecConfig,
        ba_executor_factory,
        synthetic_trace,
    )
    from arrow_matrix_tpu_torch.utils.checkpoint import save_state

    mesh2 = _mesh((2,), ranks=(0, 1))
    mesh4 = _mesh()
    fac2, n_rows = ba_executor_factory(n, width, seed, fmt="auto",
                                       mesh=mesh2)
    fac4, _ = ba_executor_factory(n, width, seed, fmt="auto", mesh=mesh4)
    trace = synthetic_trace(n_rows, **trace_kw)
    member = mesh2.member
    ex2 = fac2(ExecConfig())
    if member:
        for r in trace:
            x = ex2.set_features(r.x)
            for _ in range(2):
                x = ex2.step(x)
            save_state(os.path.join(ck_dir, f"ck_{r.request_id}"), x, 2,
                       layout=f"serve/{r.request_id}/k{r.k}"
                              f"/it{r.iterations}", mesh=mesh2)
    coll.barrier()
    server = ArrowServer(fac2, ExecConfig(), name="grow",
                         checkpoint_dir=ck_dir, checkpoint_every=2,
                         max_batch_k=0, grow_factory=fac4,
                         reshard_budget_bytes=budget)
    if via_pressure:
        server.start()
        pressed = server.note_slo_pressure("test", direction="grow")
        assert pressed == (["*"] if ctx.rank == 0 else [])
        tickets = [server.submit(r) for r in trace]
        for t in tickets:
            t.wait()
        server.shutdown(wait=True, timeout=60)
        grown = again = server._grown is not None
    else:
        grown = server.grow(reason="test")
        again = server.grow(reason="test")
        tickets = [server.submit(r) for r in trace]
        server.drain()
    return {"grown": grown and again, "member": member,
            "results": {t.request.request_id: t.result for t in tickets},
            "resumed": [t.resumed_step for t in tickets],
            "migrated": server.checkpoints_resharded,
            "grows": server.grows}


def join_check(ctx):
    """Nothing but the rank's view of its world (a fleet job's)."""
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()

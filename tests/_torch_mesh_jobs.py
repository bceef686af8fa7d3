"""Rank jobs of the port's mesh tests.

Each function runs in every rank of a ``parallel/launch.RankPool`` (gloo
on the CPU) and imports only the port; rank 0 returns the global
results, the others what the test needs of them.  Not a test module.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def _mesh(shape, names):
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(None if shape is None else tuple(shape), tuple(names))


def _finish(ctx, exe, c, extra=lambda: {}):
    """The step's counts, then the extras (``extra()``, which may run
    collectives of their own) and the global result."""
    from arrow_matrix_tpu_torch.utils import commstats

    stats = commstats.snapshot()
    out = exe.gather_result(c)
    res = {"stats": stats}
    res.update(extra())
    if ctx.rank == 0:
        res["out"] = out
    return res


def sell_multi(ctx, levels, width, x, steps, kw, shape=None,
               names=("blocks",)):
    """``SellMultiLevel(levels, width, mesh, **kw)``: ``steps`` steps of
    ``x``, the global result on rank 0, this rank's collective counts of
    the steps and its levels' halo hops."""
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel
    from arrow_matrix_tpu_torch.utils import commstats

    exe = SellMultiLevel(levels, width, _mesh(shape, names), **kw)
    c = exe.set_features(x)
    commstats.reset()
    c = exe.run(c, steps)
    return _finish(ctx, exe, c, lambda: {
        "hops": [o.hops for o in exe.ops], "rem": [o.rem for o in exe.ops],
        "binary": exe.binary, "rows_local": exe.rows_local,
        "ideal": exe.ideal_comm_bytes(x.shape[1]),
        "mask": exe.carried_mask().sum().item(),
        "report": exe.shard_report(),
        "contract": exe.collective_contract(x.shape[1]).to_json()})


def sell_multi_resumed(ctx, levels, width, x, kw, shape, names):
    """Two steps, and one step resumed from the merged (canonical)
    carriage of the first: ``merge_carries`` is a valid resume state."""
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel

    exe = SellMultiLevel(levels, width, _mesh(shape, names), **kw)
    c1 = exe.step(exe.set_features(x))
    two = exe.gather_result(exe.step(c1))
    resumed = exe.gather_result(exe.step(exe.merge_carries(c1)))
    return (two, resumed) if ctx.rank == 0 else None


def sell_slim(ctx, matrix, width, x, steps, kw, shape=None,
              names=("blocks",)):
    """``SellSlim(matrix, width, mesh, **kw)``: ``steps`` steps."""
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellSlim
    from arrow_matrix_tpu_torch.utils import commstats

    exe = SellSlim(matrix, width, _mesh(shape, names), **kw)
    c = exe.set_features(x)
    commstats.reset()
    for _ in range(steps):
        c = exe.spmm(c)
    return _finish(ctx, exe, c, lambda: {
        "hops": exe.ops.hops, "rem": exe.ops.rem, "binary": exe.binary,
        "report": exe.shard_report()})


def multi_level(ctx, levels, width, x, steps, kw, shape=None,
                names=("blocks",)):
    """``MultiLevelArrow(levels, width, mesh=mesh, **kw)``."""
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import commstats

    exe = MultiLevelArrow(levels, width, mesh=_mesh(shape, names), **kw)
    c = exe.set_features(x)
    commstats.reset()
    c = exe.run(c, steps)
    return _finish(ctx, exe, c, lambda: {"fmts": exe.fmts})


def mesh_members(ctx, levels, width, kw):
    """The single-device members of ``MultiLevelArrow(mesh=)``: each
    one's ``NotImplementedError`` message (None where it runs), and the
    members that work on a mesh."""
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    exe = MultiLevelArrow(levels, width, mesh=_mesh(None, ("blocks",)), **kw)
    calls = {"pack_level": lambda: exe.pack_level(0, levels[0].matrix),
             "launch_groups": lambda: exe.launch_groups(None),
             "fold_product": lambda: exe.fold_product(None, None),
             "transposed": exe.transposed,
             "transposed_step": lambda: exe.transposed_step(None),
             "export_folded": lambda: exe.export_folded("unused"),
             "load_folded": lambda: type(exe).load_folded("unused")}
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = None
        except NotImplementedError as e:
            refused[name] = str(e)
    return {"refused": refused, "head_layouts": exe.head_layouts(),
            "kernel_bytes": exe.kernel_bytes(16),
            "carriage": exe.carriage_hbm_bytes(16),
            "rows_local": exe.rows_local}


def routed(ctx, table, src_total, pad, x, routing, add, stages_k=None):
    """The exchange ``out[j] = x[table[j]]`` of a global table over the
    ranks (``routing`` "a2a" or "gather"; ``add`` adds it to a base of
    ones; ``stages_k`` splits the a2a tables into stages of one slot a
    pair at that width); the global result on rank 0, and the route's
    slots a pair."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.utils import commstats
    from arrow_matrix_tpu_torch.parallel.routing import (
        build_route,
        gather_table,
        shard_route,
        shard_staged,
        split_route_stages,
        take,
    )

    mesh = _mesh(None, ("blocks",))
    n_dev, d = ctx.world, ctx.rank
    r_src = src_total // n_dev
    mine = torch.from_numpy(np.ascontiguousarray(
        x[d * r_src:(d + 1) * r_src]))
    if routing == "a2a":
        rt = build_route(table, n_dev, src_total=src_total, pad_mask=pad)
        route = shard_route(rt, mesh)
        if stages_k:
            route = shard_staged(split_route_stages(
                rt, stages_k, 2 * n_dev * stages_k * 4), mesh)
        slots = rt.slots
    else:
        route, slots = gather_table(table, mesh, "blocks"), None
    base = None
    if add:
        base = torch.ones((table.size // n_dev, x.shape[1]),
                          dtype=mine.dtype)
    commstats.reset()
    out = take(mine, route, mesh, add_to=base)
    stats = commstats.snapshot()
    full = coll.all_gather(out.contiguous(), mesh, "blocks")
    return {"out": full.numpy() if d == 0 else None, "slots": slots,
            "stats": stats}


def collectives(ctx):
    """Each collective of the layer on this rank's values (rank r holds
    ``r + 1`` everywhere); the results and this rank's counts."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.utils import commstats

    mesh = _mesh(None, ("blocks",))
    r, p = ctx.rank, ctx.world
    commstats.reset()
    t = torch.full((3, 2), float(r + 1))
    b = t.clone()
    coll.broadcast(b, mesh, "blocks")
    red = coll.reduce_to_first(t * 0.1, mesh, "blocks")
    prev, nxt = coll.shift(t, -t, mesh, "blocks", (3, 2), (3, 2),
                           torch.float32)
    send = torch.arange(p * 2, dtype=torch.float32).view(p * 2, 1) + 100 * r
    got = coll.all_to_all(send, mesh, "blocks")
    gath = coll.all_gather(t[:1].to(torch.bfloat16), mesh, "blocks")
    mx = coll.all_reduce_max(7 * r, mesh, "blocks")
    return {"bcast": b.numpy(), "reduce": None if red is None
            else red.numpy(), "prev": prev.numpy(), "next": nxt.numpy(),
            "a2a": got.numpy(), "gather": gath.float().numpy(), "max": mx,
            "stats": commstats.snapshot(), "world_line": mesh.line(None)}


def grid(ctx, shape, names):
    """This rank's coordinates and lines on a mesh of ``shape``, its share
    of a blocked array along the first axis, and the rows of every rank
    fetched back."""
    from arrow_matrix_tpu_torch.parallel.mesh import (
        fetch_replicated,
        shard_blocked,
    )

    mesh = _mesh(shape, names)
    share = shard_blocked(torch.arange(8 * shape[0]).view(-1, 1), mesh,
                          names[0])
    return {"coords": mesh.coords,
            "lines": {a: mesh.line(a) for a in names},
            "index": {a: mesh.axis_index(a) for a in names},
            "share": share.numpy(),
            "fetched": fetch_replicated(share, mesh, names[0])}


def fail_on(ctx, rank):
    """Raise on ``rank``; the others wait in a collective for it."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll

    if ctx.rank == rank:
        raise RuntimeError("planted failure")
    coll.all_gather(torch.zeros(1), _mesh(None, ("blocks",)), "blocks")
    return ctx.rank


def jax_packing_step(ctx, fields, x_carried, steps):
    """The port's slim level step over JAX's packing of one matrix
    (``fields``: the JAX ``SlimLevelOps`` as numpy, through
    ``convert.shard_stack_from_numpy``), ``steps`` steps of this rank's
    rows of the carried ``x_carried``; the global carried result."""
    from arrow_matrix_tpu_torch.convert import shard_stack_from_numpy
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.parallel.sell_slim import (
        SlimLevelOps,
        slim_level_step,
    )

    mesh = _mesh(None, ("blocks",))
    d = ctx.rank

    def mine(stack):      # this device's arrays, as its JAX shard holds them
        return [None if arrays is None else [a[d:d + 1] for a in arrays]
                for arrays in stack]

    ops = SlimLevelOps(
        body=shard_stack_from_numpy(*mine(fields["body"]), device_index=d),
        head=shard_stack_from_numpy(*mine(fields["head"]), device_index=d),
        head_unsort=fields["head_unsort"], orig_pos=fields["orig_pos"],
        body_order=fields["body_order"], rows_out=fields["rows_out"],
        shard_len=fields["shard_len"], n_dev=ctx.world,
        width=fields["width"], hops=fields["hops"], rem=fields["rem"],
        binary=fields["binary"]).to_rank(ctx.rank, "cpu")
    R = ops.rows_out
    c = torch.from_numpy(np.ascontiguousarray(
        x_carried[ctx.rank * R:(ctx.rank + 1) * R]))
    for _ in range(steps):
        c = slim_level_step(ops, c, mesh, "blocks")
    full = coll.all_gather(c.contiguous(), mesh, "blocks")
    return full.numpy() if ctx.rank == 0 else None

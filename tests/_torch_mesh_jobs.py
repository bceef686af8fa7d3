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
    return _finish(ctx, exe, c, lambda: {"fmts": exe.fmts,
                                         "report": exe.shard_report()})


def hbm_price(ctx, levels, width, kw, ks, ranks=None):
    """``MultiLevelArrow(mesh=)``'s HBM model on every rank (a mesh of
    ``ranks``, default the world): ``{k: (exchange_scratch_bytes,
    carriage_hbm_bytes, predicted_hbm_bytes)}``."""
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(None, ("blocks",), ranks=ranks)
    if not mesh.member:
        return None
    exe = MultiLevelArrow(levels, width, mesh=mesh, **kw)
    return {k: (exe.exchange_scratch_bytes(k), exe.carriage_hbm_bytes(k),
                exe.predicted_hbm_bytes(k)) for k in ks}


def mesh_members(ctx, levels, width, kw):
    """The single-device members of ``MultiLevelArrow(mesh=)``: each
    one's ``ValueError`` message (None where it runs), what
    ``load_folded`` builds from a fold exported by one device, and the
    members that work on a mesh: the transposed operator (what it packed)
    and the transposed step beside the step, bit for bit."""
    import tempfile

    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    exe = MultiLevelArrow(levels, width, mesh=_mesh(None, ("blocks",)), **kw)
    x = exe.set_features(np.random.default_rng(0).standard_normal(
        (exe.n, 4)).astype(np.float32))
    same = bool(torch.equal(exe.transposed_step(x), exe.step(x)))
    calls = {"pack_level": lambda: exe.pack_level(0, levels[0].matrix),
             "launch_groups": lambda: exe.launch_groups(None),
             "fold_product": lambda: exe.fold_product(None, None),
             "export_folded": lambda: exe.export_folded("unused")}
    refused = {}
    for name, call in calls.items():
        try:
            call()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    with tempfile.TemporaryDirectory() as d:
        MultiLevelArrow(levels, width, fmt="fold",
                        device="cpu").export_folded(d)
        fold = type(exe).load_folded(d, device="cpu")
    return {"refused": refused, "head_layouts": exe.head_layouts(),
            "loaded": (type(fold).__name__, fold.folded,
                       fold.device.type),
            "packed": exe.transposed().packed, "transposed_is_step": same,
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


def broadcast_roots(ctx, shape, names, axis):
    """``collectives.broadcast(root=q)`` from every position ``q`` of this
    rank's ``axis`` line (rank r holds ``r + 1``); the values received and
    this rank's counts; a root off the line refused."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.utils import commstats

    mesh = _mesh(shape, names)
    line = mesh.line(axis)
    commstats.reset()
    got = []
    for q in range(len(line)):
        t = torch.full((2, 3), float(ctx.rank + 1))
        coll.broadcast(t, mesh, axis, root=q)
        got.append(t.numpy())
    try:
        coll.broadcast(torch.zeros(1), mesh, axis, root=len(line))
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"line": line, "got": got, "refused": refused,
            "stats": commstats.snapshot()}


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


# -- training through the mesh executors and the space-shared modes -----------

def _executor(kind, levels, width, kw, shape, names):
    """A mesh executor of ``kind``: "sell" (SellMultiLevel), "slim"
    (SellSlim over level 0's matrix), "arrow" (MultiLevelArrow(mesh=)),
    "space" (SpaceSharedArrow) or "sell_space" (SellSpaceShared)."""
    from arrow_matrix_tpu_torch.parallel import (
        MultiLevelArrow,
        SellMultiLevel,
        SellSlim,
        SellSpaceShared,
        SpaceSharedArrow,
    )

    mesh = _mesh(shape, names)
    if kind == "sell":
        return SellMultiLevel(levels, width, mesh, **kw)
    if kind == "slim":
        return SellSlim(levels[0].matrix, width, mesh, **kw)
    if kind == "arrow":
        return MultiLevelArrow(levels, width, mesh=mesh, **kw)
    if kind == "space":
        return SpaceSharedArrow(levels, width, mesh, **kw)
    return SellSpaceShared(levels, width, mesh, **kw)


def all_reduce_sum(ctx, shape, names, axes):
    """``collectives.all_reduce_sum`` of rank-dependent values over
    ``axes``: every rank's result bits and its counts."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.utils import commstats

    mesh = _mesh(shape, names)
    commstats.reset()
    t = (torch.arange(6, dtype=torch.float32).view(2, 3) + 0.1) \
        * np.float32(1.0 + ctx.rank / 3.0)
    out = coll.all_reduce_sum(t, mesh, axes)
    b = coll.all_reduce_sum(t.to(torch.bfloat16), mesh, axes)
    return {"out": out.numpy(), "bf16": b.float().numpy(),
            "stats": commstats.snapshot()}


def space_step(ctx, kind, levels, width, x, steps, kw, shape, names):
    """``steps`` steps of a space-shared executor: the global result and
    the tables on rank 0, this rank's launch counts, its shard's packed
    arrays (SellSpaceShared) and its collective counts of the steps."""
    from arrow_matrix_tpu_torch.utils import commstats

    exe = _executor(kind, levels, width, kw, shape, names)
    c = exe.set_features(x)
    commstats.reset()
    c = exe.run(c, steps)
    stats = commstats.snapshot()
    out = exe.gather_result(c)
    res = {"stats": stats, "launches": exe.launch_counts(x.shape[1]),
           "dtype": str(c.dtype)}
    if kind == "sell_space":
        o = exe.ops
        s = o.rank
        res["share"] = {
            "index": s,
            "body": ([a[s] for a in o.body.cols], [a[s] for a in o.body.deg],
                     None if o.body.data is None
                     else [a[s] for a in o.body.data]),
            "head": ([a[s] for a in o.head.cols], [a[s] for a in o.head.deg],
                     None if o.head.data is None
                     else [a[s] for a in o.head.data]),
            "orig_pos": o.orig_pos[s], "body_order": o.body_order,
            "head_unsort": exe.head_unsort, "rows_out": o.rows_out,
            "hops": o.hops, "rem": o.rem}
        res["binary"] = exe.binary
        res["ideal"] = exe.ideal_comm_bytes(x.shape[1])
        res["report"] = exe.shard_report()
        res["mask"] = float(exe.carried_mask().sum())
    else:
        res["fmt"], res["width"] = exe.fmt, exe.width
        res["head_flat"] = exe.head_flat
    if ctx.rank == 0:
        res.update(out=out, bwd0=exe.bwd0, fwd0=exe.fwd0)
    return res


def _slice(exe, kind):
    """(start, rows) of this rank's rows in the global carried vector of
    a space-shared executor (level-major, then block-major)."""
    g = exe.mesh.axis_index(exe.lvl_axis)
    d = exe.mesh.axis_index(exe.axis)
    if kind == "space":
        return g * exe.total_rows + d * exe.rows_local, exe.rows_local
    return g * exe.total_out + d * exe.rows_out, exe.rows_out


def space_dense(ctx, kind, levels, width, g_seed, k, kw, shape, names):
    """The whole step of a space-shared executor as a dense matrix (its
    forward step applied to the unit vectors of the global carried
    vector, K copies included), and its transposed step of a seeded
    global ``g``; rank 0 returns both with ``g`` and what was packed."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll

    exe = _executor(kind, levels, width, kw, shape, names)
    lo, rows = _slice(exe, kind)
    N = rows * ctx.world
    eye = torch.eye(N, dtype=torch.float32)[lo:lo + rows].contiguous()
    with torch.no_grad():
        s = exe.step(eye)
    dense = coll.all_gather(s.contiguous(), exe.mesh, None)
    g = torch.from_numpy(np.random.default_rng(g_seed).standard_normal(
        (N, k)).astype(np.float32))
    t = exe.transposed_step(g[lo:lo + rows].contiguous())
    got = coll.all_gather(t.contiguous(), exe.mesh, None)
    tr = exe.transposed()
    res = {"packed": tr.packed, "bytes": tr.device_bytes}
    if ctx.rank == 0:
        res.update(dense=dense.numpy(), g=g.numpy(), got=got.numpy())
    return res


def transposed_step(ctx, kind, levels, width, g, kw, shape, names):
    """``gather_result(transposed_step(set_features(g)))`` of a
    time-shared mesh executor over an f32 carriage, the levels it
    packed, and whether a second call reused the build."""
    exe = _executor(kind, levels, width, kw, shape, names)
    # A gradient is f32 whatever the carriage (StepFunction.backward):
    # a bf16 executor's f32 carriage.
    carriage = getattr(exe, "feature_dtype", torch.float32)
    exe.feature_dtype = torch.float32
    c = exe.set_features(g)
    exe.feature_dtype = carriage
    t = exe.transposed_step(c)
    assert t.dtype == torch.float32
    out = exe.gather_result(t)
    tr = exe.transposed()
    res = {"packed": tr.packed, "bytes": tr.device_bytes,
           "seconds": tr.seconds, "same": exe.transposed() is tr}
    if ctx.rank == 0:
        res["out"] = out
    return res


def model_run(ctx, kind, levels, width, what, args, kw, shape, names):
    """A model of ``models/propagation.py`` over a mesh executor, on every
    rank (each rank returns what it computed, to be compared across
    ranks): "power" (eigenvector, eigenvalue), "cg" (solution, residual),
    "sgc_carried"/"gcn_carried" (prediction, fit losses, parameters
    after the fit), "pagerank", "labelprop"."""
    from arrow_matrix_tpu_torch.models import propagation as P

    exe = _executor(kind, levels, width, kw, shape, names)
    if what == "power":
        v, lam = P.power_iteration(exe, *args)
        return {"v": v, "lam": lam}
    if what == "cg":
        b, shift, iters, tol = args
        x, rnorm = P.conjugate_gradient(exe, b, shift=shift,
                                        iterations=iters, tol=tol)
        return {"x": x, "rnorm": rnorm}
    if what in ("sgc_carried", "gcn_carried"):
        x, y, model_args, steps = args
        cls = P.SGCCarried if what == "sgc_carried" else P.GCNCarried
        m = cls(exe, *model_args, seed=0)
        pred = m.predict(x)
        losses = m.fit(x, y, steps=steps) if steps else []
        return {"pred": pred, "losses": losses,
                "params": [p.detach().numpy().copy()
                           for p in m.parameters()]}
    if what == "pagerank":
        return {"out": (P.pagerank_carried(exe, *args)
                        if exe.carries_feature_major
                        else P.pagerank(exe, *args))}
    labels, seeds, iters = args
    fn = (P.label_propagation_carried if exe.carries_feature_major
          else P.label_propagation)
    return {"out": fn(exe, labels, seeds, iterations=iters)}


def gcn_train(ctx, kind, levels, width, x, y, params, steps, kw, shape,
              names):
    """The flat GCN train step (``make_gcn_train_step``, Adam 1e-2) over a
    mesh executor from the given parameters: the first step's loss and
    gradients (summed over the mesh), then ``steps`` steps' losses and
    the parameters after them, on every rank."""
    from arrow_matrix_tpu_torch.convert import load_jax_params
    from arrow_matrix_tpu_torch.models import propagation as P

    exe = _executor(kind, levels, width, kw, shape, names)
    model = P.GCNModel(exe, dims=[params[0][0].shape[0]]
                       + [w.shape[1] for w, _ in params])
    load_jax_params(model, params)
    xs, ys = exe.set_features(x), exe.set_features(y)
    mask = exe.real_row_mask()
    opt = torch.optim.Adam(model.params.parameters(), lr=1e-2)
    grads = {}
    step = P.make_gcn_train_step(exe, opt)
    losses = []
    for i in range(steps):
        if i == 0:
            orig = opt.step

            def first(*a, **k):
                grads["g"] = [(h.w.grad.numpy().copy(),
                               h.b.grad.numpy().copy())
                              for h in model.params]
                return orig(*a, **k)

            opt.step = first
        losses.append(float(step(model.params, xs, ys, mask)))
        if i == 0:
            opt.step = orig
    return {"losses": losses, "grads": grads["g"],
            "params": [p.detach().numpy().copy()
                       for p in model.params.parameters()],
            "transposed": exe.transposed().packed}


def comm_by_mode(ctx, n, width, k):
    """Each execution mode of ``tools/comm_report.py`` built here by its
    constructor and stepped once after a warm-up, the counts set to 0
    just before: this rank's collective counts by mode."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.parallel import (
        MultiLevelArrow,
        SellSpaceShared,
        SpaceSharedArrow,
    )
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel
    from arrow_matrix_tpu_torch.utils import (
        barabasi_albert,
        commstats,
        random_dense,
    )

    levels = arrow_decomposition(barabasi_albert(n, 4, seed=7),
                                 arrow_width=width, max_levels=4,
                                 block_diagonal=True, seed=7)
    blocks = _mesh((ctx.world,), ("blocks",))
    exes = {f"time-shared/{r}": lambda r=r: MultiLevelArrow(
                levels, width, mesh=blocks, routing=r)
            for r in ("gather", "a2a")}
    exes.update({f"sell/{r}": lambda r=r: SellMultiLevel(
                     levels, width, blocks, routing=r)
                 for r in ("gather", "a2a")})
    if ctx.world % len(levels) == 0:
        grid = _mesh((len(levels), ctx.world // len(levels)),
                     ("lvl", "blocks"))
        exes["space-shared"] = lambda: SpaceSharedArrow(levels, width, grid)
        exes["sell/space-shared"] = lambda: SellSpaceShared(levels, width,
                                                            grid)
    x_host = random_dense(n, k, seed=1)
    out = {}
    for mode, build in exes.items():
        exe = build()
        x = exe.set_features(x_host)
        exe.step(x)
        commstats.reset()
        exe.step(x)
        out[mode] = commstats.snapshot()
    return out

"""The shipped graft-lint rules (R1-R9), restated for torch.

The port's copy of ``arrow_matrix_tpu/analysis/rules.py``: every rule
keeps its id and its hazard; a rule that named JAX tracing names the
torch form of the same hazard.

* R1 host-sync-in-step — .item()/.cpu()/.numpy()/.tolist()/float(t) in a
  hot scope
* R2 rebuild-hazard — a kernel library load, a work-list / plan / route
  build or torch.compile inside a loop; compile-then-call
* R3 carried-inputs-kept — a carried run that keeps every step's input
* R4 mesh-axis-consistency — axis names no mesh of the module declares
* R5 dtype-promotion — bare float literals in hot-scope arithmetic
* R6 unguarded-device-get — unbounded .cpu() fetches of card tensors
* R7 unsynced-timing — perf_counter regions with no synchronize
* R8 swallowed-exception — broad except handlers that only discard
* R9 env-read-in-step — AMT_* environment reads on the per-step path

A hot scope is what ``core.ModuleContext`` can prove runs as the step
(captured by ``torch.cuda.graph`` / ``make_graphed_callables``, compiled
by ``torch.compile``, or passed as a ``step_fn``).  Rules are registered
with ``core.register`` and receive a ``ModuleContext``; they yield
``(line, message)`` pairs.  Suppress a deliberate violation inline with
``# graft-lint: disable=Rn`` and a reason.

The R rules are one quarter of the port's static-rule family: H1-H7
(analysis/prove.py) prove each mesh executor's counted collectives,
RC1-RC5 (analysis/sync.py) prove the serving stack's lock discipline,
and KC1-KC5 (analysis/kernels.py) certify the Hopper kernels' contracts.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator, Optional, Tuple

from arrow_matrix_tpu_torch.analysis.core import (
    JIT_WRAPPERS,
    ModuleContext,
    register,
)

# ---------------------------------------------------------------------------
# Shared predicates
# ---------------------------------------------------------------------------

#: Attribute reads that are static (python values) on a tensor.
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                           "itemsize", "nbytes", "n_blocks", "width",
                           "banded", "fmt"})

#: Tensor methods whose results are python values computed on the host
#: from metadata (no transfer).
_STATIC_METHODS = frozenset({"size", "dim", "numel", "element_size",
                             "stride", "is_contiguous"})

#: Calls whose results are static python values.
_STATIC_CALLS = frozenset({"len", "min", "max", "abs", "round", "isinstance",
                           "numpy.prod", "math.prod", "numpy.dtype",
                           "math.ceil", "math.floor", "math.log2"})

#: Tensor methods that copy to the host and block on the card.
_HOST_SYNC_METHODS = frozenset({"item", "cpu", "numpy", "tolist"})


def _is_static_expr(ctx: ModuleContext, node) -> bool:
    """Conservative: True only for expressions that are python values
    (shape arithmetic, dtype metadata, literals)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return True
    if isinstance(node, ast.Subscript):
        return _is_static_expr(ctx, node.value)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(ctx, node.operand)
    if isinstance(node, ast.BinOp):
        return (_is_static_expr(ctx, node.left)
                and _is_static_expr(ctx, node.right))
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_static_expr(ctx, e) for e in node.elts)
    if isinstance(node, ast.Call):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _STATIC_METHODS):
            return True
        full = ctx.resolve(node.func)
        if full in _STATIC_CALLS:
            return True
    return False


def _traced_calls(ctx: ModuleContext) -> Iterator[ast.Call]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and ctx.in_traced_scope(node):
            yield node


def _jit_calls(ctx: ModuleContext) -> Iterator[ast.Call]:
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call)
                and ctx.resolve(node.func) in JIT_WRAPPERS):
            yield node


# ---------------------------------------------------------------------------
# R1 — host-sync-in-step
# ---------------------------------------------------------------------------


@register("R1", "host-sync-in-step",
          "float()/int()/.item()/.cpu()/.numpy()/.tolist() on a tensor in "
          "a hot scope blocks on a card->host copy every step")
def check_host_sync(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """Host syncs in a hot scope.

    ``float(t)``, ``t.item()``, ``t.cpu()`` and friends are fine at build
    time (the packers run on the host), but inside a function captured
    into a CUDA graph they break the capture, and inside a step function
    they serialize every step on a card round trip.  Shape/dtype reads
    (``x.shape``, ``x.size(0)``, ``len(x)``) are metadata and exempt.
    """
    for call in _traced_calls(ctx):
        line = call.lineno
        func = call.func
        if (isinstance(func, ast.Name) and func.id in ("float", "int", "bool")
                and len(call.args) == 1
                and not _is_static_expr(ctx, call.args[0])):
            yield line, (f"{func.id}() on a tensor is a host sync inside "
                         f"a hot scope; keep it a tensor (or compute it "
                         f"from static shape/dtype metadata)")
        elif (isinstance(func, ast.Attribute)
              and func.attr in _HOST_SYNC_METHODS and not call.args):
            yield line, (f".{func.attr}() blocks on a card->host copy "
                         f"inside a hot scope")
        elif ctx.is_numpy_call(call, "asarray") or ctx.is_numpy_call(
                call, "array"):
            yield line, ("np.asarray/np.array inside a hot scope pulls the "
                         "value to the host every step; hoist the "
                         "conversion out of the step")


# ---------------------------------------------------------------------------
# R2 — rebuild-hazard
# ---------------------------------------------------------------------------


def _lru_cached(ctx: ModuleContext, fn) -> bool:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    for deco in fn.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        if ctx.resolve(target) in ("functools.lru_cache", "functools.cache"):
            return True
    return False


#: Build work a step must not redo, by the tail of its resolved name:
#: loading a kernel library, building a K1 work list or plan, compiling
#: a route table.
_REBUILDS = (
    ("ctypes.CDLL", "a kernel library load"),
    ("ctypes.cdll.LoadLibrary", "a kernel library load"),
    ("_build.load", "a kernel library load"),
    ("_build.build", "a kernel library build"),
    ("_build.build_all", "a kernel library build"),
    ("worklist.build_worklist", "a K1 work-list build"),
    ("cuda_sell.build_plan", "a K1 plan build"),
    ("routing.build_route", "a route-table build"),
)


def _rebuild_kind(ctx: ModuleContext, call: ast.Call) -> Optional[str]:
    full = ctx.resolve(call.func) or ""
    if full in JIT_WRAPPERS:
        return f"{full} (a fresh compile)"
    for tail, what in _REBUILDS:
        if full == tail or full.endswith("." + tail):
            return what
    return None


@register("R2", "rebuild-hazard",
          "a kernel library load, a work-list/plan/route build or "
          "torch.compile inside a loop redoes build work every iteration; "
          "compile-then-call drops the compiled callable")
def check_recompile(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """Build work on the per-iteration path.

    The executors load K1-K4's libraries once (``ops/_build.py:load``
    caches them), build each work list and plan once (``cuda_sell.
    plan_for`` caches the plan on its operator) and compile each route
    table at construction.  Doing any of it inside a loop repeats it
    every iteration; ``torch.compile(f)(x)`` in a function body builds a
    fresh compiled callable every call.
    """
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _rebuild_kind(ctx, node)
        if what is None:
            continue
        if ctx.in_loop(node):
            yield node.lineno, (f"{what} inside a loop repeats build work "
                                f"every iteration; hoist it out of the "
                                f"loop (or cache it on the operator)")
    for call in _jit_calls(ctx):
        parent = ctx.parents.get(call)
        encl = ctx.enclosing_function(call)
        if (isinstance(parent, ast.Call) and parent.func is call
                and encl is not None and not _lru_cached(ctx, encl)):
            yield call.lineno, ("compile-then-call in a function body drops "
                                "the compiled callable on return (compiles "
                                "every call); cache the compiled callable")


# ---------------------------------------------------------------------------
# R3 — carried-inputs-kept
# ---------------------------------------------------------------------------


def _bare_names(node) -> set:
    """Names ``node`` is, or holds bare in a list/tuple literal."""
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, (ast.List, ast.Tuple)):
        return {e.id for e in node.elts if isinstance(e, ast.Name)}
    return set()


#: Builtins whose result is a fresh host value, not a carriage.
_HOST_REDUCERS = frozenset({"max", "min", "sum", "abs", "round", "float",
                            "int", "bool", "len", "str", "dict", "list",
                            "tuple", "set", "sorted"})


def _loop_keeps(loop) -> Iterator[Tuple[int, str]]:
    """(line, name) of each carry of ``loop`` that its body also stores:
    ``x = f(x, ...)`` rebinding plus ``keep.append(x)`` /
    ``keep += [x]`` / ``keep[i] = x`` of the same name."""
    carries = set()
    for stmt in ast.walk(loop):
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
                and not (isinstance(stmt.value.func, ast.Name)
                         and stmt.value.func.id in _HOST_REDUCERS)
                and any(isinstance(a, ast.Name)
                        and a.id == stmt.targets[0].id
                        for a in stmt.value.args)):
            carries.add(stmt.targets[0].id)
    # A loop's own target is fresh every iteration, not a carry.
    for sub in ast.walk(loop):
        if isinstance(sub, (ast.For, ast.AsyncFor)):
            carries -= {n.id for n in ast.walk(sub.target)
                        if isinstance(n, ast.Name)}
    if not carries:
        return
    for node in ast.walk(loop):
        stored = set()
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("append", "extend", "insert")
                and node.args):
            stored = _bare_names(node.args[-1])
        elif (isinstance(node, ast.AugAssign)
              and isinstance(node.op, ast.Add)):
            stored = _bare_names(node.value) - _bare_names(node.target)
        elif (isinstance(node, ast.Assign)
              and any(isinstance(t, ast.Subscript) for t in node.targets)):
            stored = _bare_names(node.value)
        for name in sorted(stored & carries):
            yield node.lineno, name


@register("R3", "carried-inputs-kept",
          "a carried run (x = step(x) in a loop) that also stores each "
          "step's x keeps every step's carriage resident")
def check_donation(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """A run that keeps every step's input alive.

    torch has no donation; an eager ``for _ in range(n): x = step(x)``
    frees each step's input once the next step has read it (the
    prover's H5).  Storing each ``x`` as well (a list of every
    carriage, kept for a later look) makes the run's footprint grow with
    its length — at protocol scale the difference between fitting on
    the card and not.  Keep what you need reduced to host scalars, or
    waive a deliberate history with its reason.
    """
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            for line, name in _loop_keeps(node):
                yield line, (f"the carried {name!r} is rebound from "
                             f"itself every iteration and also stored: "
                             f"every step's input stays resident; keep "
                             f"only what the caller needs")


# ---------------------------------------------------------------------------
# R4 — mesh-axis-consistency
# ---------------------------------------------------------------------------

#: The package-default mesh axis, declared by parallel/mesh.py
#: ``make_mesh(axis_names=("blocks",))`` — in scope for any module that
#: imports the mesh helpers.
DEFAULT_MESH_AXES = frozenset({"blocks"})

_MESH_CTORS = frozenset({"Mesh", "make_mesh", "make_hybrid_mesh"})

#: Mesh methods that take an axis name first.
_AXIS_METHODS = frozenset({"line", "group", "axis_index"})

#: Keyword names that take an axis name.
_AXIS_KEYWORDS = frozenset({"axis", "axes", "repl_axis", "feat_axis",
                            "rows_axis", "lvl_axis"})


def _declared_axes(ctx: ModuleContext) -> set:
    axes: set = set()

    def add_strings(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            axes.add(node.value)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                add_strings(e)

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            tail = (ctx.resolve(node.func) or "").rsplit(".", 1)[-1]
            if tail in _MESH_CTORS:
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    add_strings(arg)
            elif tail == "make_repl_mesh":
                axes |= {"blocks", "repl"}
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    add_strings(arg)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            pos_with_default = args.args[len(args.args)
                                         - len(args.defaults):]
            for p, d in list(zip(pos_with_default, args.defaults)) + list(
                    zip(args.kwonlyargs, args.kw_defaults)):
                if d is None:
                    continue
                if p.arg == "axis" or p.arg.endswith("_axis") \
                        or p.arg in ("axis_names", "names"):
                    add_strings(d)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and "axis" in t.id.lower():
                    add_strings(node.value)
    if any(v.startswith("arrow_matrix_tpu_torch.parallel")
           for v in ctx.aliases.values()):
        axes |= DEFAULT_MESH_AXES
    return axes


def _axis_literals(ctx: ModuleContext) -> Iterator[Tuple[int, str]]:
    """(line, name) of each axis-name literal the module uses."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _AXIS_METHODS and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                yield node.lineno, node.args[0].value
            for kw in node.keywords:
                if kw.arg not in _AXIS_KEYWORDS:
                    continue
                elts = (kw.value.elts
                        if isinstance(kw.value, (ast.Tuple, ast.List))
                        else [kw.value])
                for e in elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value,
                                                                  str):
                        yield node.lineno, e.value
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Attribute)
              and node.value.attr == "shape"
              and isinstance(node.slice, ast.Constant)
              and isinstance(node.slice.value, str)):
            yield node.lineno, node.slice.value


@register("R4", "mesh-axis-consistency",
          "every mesh axis-name literal (mesh.line/group/axis_index, "
          "mesh.shape[...], axis= keywords) must be declared by a "
          "make_mesh axis-names literal reachable in the module (or be "
          "the package default 'blocks' from parallel/mesh.py)")
def check_spec_axes(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """Axis names the mesh does not declare.

    ``mesh.line("rowz")`` against a mesh with axes ``("rows", "repl")``
    fails only when the step runs — a ``KeyError`` deep inside the
    collective layer naming neither the executor nor the site.  The
    rule checks every axis-name literal against the names declared in
    the module (``make_mesh`` literals, ``*_axis`` parameter defaults)
    plus the package default axis.  Skipped when the module declares no
    axes at all (no mesh context to check against).
    """
    declared = _declared_axes(ctx)
    if not declared:
        return
    for line, name in _axis_literals(ctx):
        if name not in declared:
            yield line, (f"mesh axis {name!r} is not declared by any mesh "
                         f"in scope (known axes: {sorted(declared)}); a "
                         f"mismatched axis fails only when the step runs")


# ---------------------------------------------------------------------------
# R5 — dtype-promotion
# ---------------------------------------------------------------------------

_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
              ast.Pow)


@register("R5", "dtype-promotion",
          "bare python float literals in hot-scope arithmetic leave the "
          "result dtype to promotion rules (bf16 -> f32 when the literal "
          "becomes a tensor)")
def check_dtype_promotion(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """Python float literals in step arithmetic.

    ``x * 0.5`` with a bf16 ``x`` stays bf16 only because torch treats a
    python scalar as weakly typed; the moment the literal becomes a
    tensor (``torch.tensor(0.5)`` from a config, a float64 numpy scalar)
    the whole carriage silently widens and moves double bytes.  State
    the dtype: ``x * torch.tensor(0.5, dtype=x.dtype)`` or a typed
    scalar.  Integer literals (shape arithmetic, indexing) are exempt.
    """
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, _ARITH_OPS)
                and ctx.in_traced_scope(node)):
            continue
        for lit, other in ((node.left, node.right),
                           (node.right, node.left)):
            if (isinstance(lit, ast.Constant)
                    and isinstance(lit.value, float)
                    and not _is_static_expr(ctx, other)):
                yield node.lineno, (
                    f"bare float literal {lit.value!r} in hot-scope "
                    f"arithmetic relies on scalar promotion; spell the "
                    f"dtype (torch.tensor({lit.value!r}, dtype=x.dtype))")
                break


# ---------------------------------------------------------------------------
# R6 — unguarded-device-get
# ---------------------------------------------------------------------------

#: Methods that put a tensor on a device (``.to`` with a device).
_TO_DEVICE_METHODS = frozenset({"cuda", "to"})

#: Modules allowed to fetch whole card tensors: the mesh's one fetch
#: helper (``fetch_replicated``).
_FETCH_HOMES = ("parallel/mesh.py",)


def _scope_nodes(ctx: ModuleContext):
    """(scope, nodes-in-scope) for the module and every function, where
    a node belongs to the innermost enclosing function only."""
    scopes: dict = {None: []}
    for fn in ast.walk(ctx.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.Lambda)):
            scopes[fn] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Call)):
            scopes.setdefault(ctx.enclosing_function(node), []).append(node)
    for scope, nodes in scopes.items():
        nodes.sort(key=lambda n: (n.lineno, n.col_offset))
        yield scope, nodes


def _puts_on_card(ctx: ModuleContext, call: ast.Call) -> bool:
    """``t.cuda()``, ``t.to("cuda"...)``/``t.to(device=...)`` with a card
    literal, or a torch factory called with ``device="cuda..."``."""
    def card_literal(node) -> bool:
        return (isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and node.value.startswith("cuda"))

    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "cuda":
        return True
    if isinstance(func, ast.Attribute) and func.attr == "to":
        if call.args and card_literal(call.args[0]):
            return True
    for kw in call.keywords:
        if kw.arg == "device" and card_literal(kw.value):
            return True
    return False


def _produces_device_value(ctx: ModuleContext, expr, device_names) -> bool:
    if isinstance(expr, ast.Name):
        return expr.id in device_names
    if isinstance(expr, ast.Call):
        if _puts_on_card(ctx, expr):
            return True
        root = expr.func
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id in device_names:
            return True
        if isinstance(root, ast.Call):
            return _produces_device_value(ctx, root, device_names)
    if isinstance(expr, (ast.Subscript, ast.Attribute)):
        return _produces_device_value(ctx, expr.value, device_names)
    if isinstance(expr, ast.BinOp):
        return (_produces_device_value(ctx, expr.left, device_names)
                or _produces_device_value(ctx, expr.right, device_names))
    return False


@register("R6", "unguarded-device-get",
          ".cpu()/.numpy()/.tolist()/np.asarray on a tensor put on the "
          "card outside parallel/mesh.py is an unbounded card->host fetch")
def check_device_get(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """Unbounded card fetches.

    A whole-carriage ``.cpu()`` of a card tensor copies every byte over
    PCIe and blocks the host; on a mesh it is the wrong answer too (one
    rank's shard, not the array).  The rule tracks names assigned from
    card placements (``.cuda()``, ``.to("cuda")``, a factory with
    ``device="cuda"``) within each function and flags a host fetch of
    them; ``parallel/mesh.py`` (``fetch_replicated``) is the one
    sanctioned home of the raw fetch.
    """
    path = ctx.path.replace("\\", "/")
    if any(path.endswith(home) for home in _FETCH_HOMES):
        return
    for scope, nodes in _scope_nodes(ctx):
        device_names: set = set()
        for node in nodes:
            if isinstance(node, ast.Assign):
                if _produces_device_value(ctx, node.value, device_names):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            device_names.add(t.id)
                else:
                    # Rebinding to a host value clears the mark.
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            device_names.discard(t.id)
            elif isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("cpu", "numpy", "tolist")
                        and not node.args):
                    target = node.func.value
                elif (ctx.is_numpy_call(node, "asarray")
                      or ctx.is_numpy_call(node, "array")) and node.args:
                    target = node.args[0]
                else:
                    continue
                if _produces_device_value(ctx, target, device_names):
                    name = (target.id if isinstance(target, ast.Name)
                            else ast.unparse(target)[:40])
                    yield node.lineno, (
                        f"{name} is fetched from the card whole; route it "
                        f"through parallel/mesh.fetch_replicated or waive "
                        f"it when provably small")


# ---------------------------------------------------------------------------
# R7 — unsynced-timing
# ---------------------------------------------------------------------------

#: Host clocks used to time wall intervals.
_TIMER_CALLS = frozenset({"time.perf_counter", "time.monotonic",
                          "time.time"})


def _is_timer_call(ctx: ModuleContext, node) -> bool:
    return (isinstance(node, ast.Call)
            and ctx.resolve(node.func) in _TIMER_CALLS)


def _is_sync_call(ctx: ModuleContext, node) -> bool:
    """Any spelling of a card barrier: ``torch.cuda.synchronize()``,
    ``event.synchronize()`` / ``stream.synchronize()``, or a helper
    whose name ends in ``synchronize``/``block_until_ready``."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Name) and func.id in ("synchronize",
                                                  "block_until_ready"):
        return True
    if isinstance(func, ast.Attribute) and func.attr in (
            "synchronize", "block_until_ready"):
        return True
    full = ctx.resolve(func) or ""
    return full.endswith(("synchronize", "block_until_ready"))


def _is_replay(node) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
            and node.func.attr == "replay" and not node.args)


@register("R7", "unsynced-timing",
          "a perf_counter region that times a compiled/graphed callable "
          "or a graph replay without torch.cuda.synchronize measures "
          "launch, not execution")
def check_unsynced_timing(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """Timing card work without synchronising.

    Kernel launches are asynchronous: ``t0 = time.perf_counter();
    g.replay(); dt = time.perf_counter() - t0`` measures the launch
    (microseconds) while the card is still working.  The rule tracks
    names assigned from ``torch.compile``/``make_graphed_callables`` and
    graph ``replay()`` calls, finds ``start = perf_counter()`` /
    ``perf_counter() - start`` pairs in the same function, and flags
    such calls inside the region when no synchronize (any spelling)
    appears between start and stop.
    """
    jit_names: set = set()
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and ctx.resolve(node.value.func) in JIT_WRAPPERS):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    jit_names.add(t.id)
    for scope, nodes in _scope_nodes(ctx):
        starts = {}
        for node in nodes:
            if (isinstance(node, ast.Assign)
                    and _is_timer_call(ctx, node.value)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        starts[t.id] = node.lineno
        if not starts:
            continue
        body = ctx.tree if scope is None else scope
        regions = []
        for node in ast.walk(body):
            if (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)
                    and _is_timer_call(ctx, node.left)
                    and isinstance(node.right, ast.Name)
                    and node.right.id in starts
                    and node.lineno > starts[node.right.id]
                    and ctx.enclosing_function(node) is scope):
                regions.append((starts[node.right.id], node.lineno))
        for lo, hi in regions:
            in_region = [c for c in nodes
                         if isinstance(c, ast.Call)
                         and lo < c.lineno <= hi]
            if any(_is_sync_call(ctx, c) for c in in_region):
                continue
            for call in in_region:
                if _is_replay(call) or (isinstance(call.func, ast.Name)
                                        and call.func.id in jit_names):
                    what = ("a graph replay" if _is_replay(call)
                            else f"{call.func.id!r} (a compiled callable)")
                    yield call.lineno, (
                        f"{what} is timed by a perf_counter region with "
                        f"no torch.cuda.synchronize; launches are "
                        f"asynchronous, so this measures the launch, not "
                        f"the card's work — synchronize inside the region")


# ---------------------------------------------------------------------------
# R8 — swallowed-exception (the reference's rule, unchanged)
# ---------------------------------------------------------------------------


@register("R8", "swallowed-exception",
          "a broad `except Exception: pass` in runtime code silently "
          "swallows device errors, injected faults, and watchdog "
          "escapes — recovery must see them")
def check_swallowed_exception(ctx: ModuleContext
                              ) -> Iterable[Tuple[int, str]]:
    """Broad exception handlers whose only action is to discard.

    ``except Exception: pass`` (or bare ``except:``, or a tuple
    containing ``Exception``/``BaseException``, with a body of only
    ``pass``/``continue``/``...``) turns every failure — device OOM,
    injected chaos-gate faults, a supervisor's watchdog escape riding a
    worker thread — into silent success.  The graft-heal contract is
    that every fault is *seen* (flight-recorder event, metrics counter,
    retry) before any decision to continue; a swallow-and-go handler
    around a narrow, documented hazard should name the narrow exception
    type, and a deliberate broad swallow takes an inline waiver
    (``# graft-lint: disable=R8``) stating why.
    """
    broad = {"Exception", "BaseException"}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not node.body or not all(
                isinstance(s, ast.Pass) or isinstance(s, ast.Continue)
                or (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant)
                    and s.value.value is Ellipsis)
                for s in node.body):
            continue
        t = node.type
        types = ([] if t is None
                 else list(t.elts) if isinstance(t, ast.Tuple)
                 else [t])
        names = [(ctx.resolve(nd) or "").rsplit(".", 1)[-1]
                 for nd in types]
        if t is not None and not any(nm in broad for nm in names):
            continue
        caught = ("bare except" if t is None
                  else "except " + "/".join(n for n in names if n))
        yield node.lineno, (
            f"{caught} whose body only discards swallows every "
            f"failure silently — catch the narrow exception this site "
            f"expects, or record the fault (obs.flight / metrics) "
            f"before continuing; a deliberate broad swallow takes an "
            f"inline `# graft-lint: disable=R8` waiver")


# ---------------------------------------------------------------------------
# R9 — env-read-in-step (the reference's rule over hot scopes)
# ---------------------------------------------------------------------------

#: Spellings of an environment read, post alias resolution.
_ENV_GETTERS = frozenset({"os.getenv", "os.environ.get"})


def _env_read_name(ctx: ModuleContext, node) -> Optional[str]:
    """The constant variable name an expression reads from the
    environment, or None when it is not an env read / not constant."""
    if isinstance(node, ast.Call):
        if ctx.resolve(node.func) in _ENV_GETTERS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                return arg.value
    elif isinstance(node, ast.Subscript):
        if ctx.resolve(node.value) == "os.environ":
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                return sl.value
    return None


@register("R9", "env-read-in-step",
          "os.environ/os.getenv reads of AMT_* knobs inside a step "
          "function or a per-iteration loop re-read host state every "
          "step; resolve the knob once at build time")
def check_env_read_in_step(ctx: ModuleContext) -> Iterable[Tuple[int, str]]:
    """AMT_* environment reads on the per-step path.

    The AMT_* knobs are build-time configuration: every shipped read
    happens once at module import or object construction.  Inside a
    function captured into a CUDA graph the value is baked at capture
    time, so flipping the knob later silently does nothing while the
    code reads as if it were live.  Inside a per-iteration loop it is a
    dict probe plus getenv lock on the hot path and drifts the timings
    the obs layer records.  Hoist the read to build time and thread the
    value in; a deliberate per-step read (e.g. a chaos-gate probe) takes
    an inline ``# graft-lint: disable=R9`` waiver stating why.
    """
    for node in ast.walk(ctx.tree):
        name = _env_read_name(ctx, node)
        if name is None or not name.startswith("AMT_"):
            continue
        if ctx.in_traced_scope(node):
            yield node.lineno, (
                f"environment read of {name!r} inside a hot scope is "
                f"baked at capture time (silently stale afterwards); "
                f"hoist it to build time and pass the value in")
        elif (ctx.in_loop(node)
              and ctx.enclosing_function(node) is not None):
            yield node.lineno, (
                f"environment read of {name!r} inside a per-iteration "
                f"loop probes host state every step; resolve the knob "
                f"once before the loop")

"""graft-sync static analyzer: lock-discipline rules RC1-RC5.

The port's copy of ``arrow_matrix_tpu/analysis/sync.py`` (pure
``ast``; only the package it reads and the manifest's home differ).
Third member of the analysis family — graft-lint (R1-R9) audits
single-threaded AST patterns, graft-prove (H1-H7) audits each mesh
executor's counted collectives, graft-sync audits the concurrency
layer between them.  It reads the
``@guarded_by`` contracts declared in :mod:`arrow_matrix_tpu_torch.sync`
straight from the AST (so never-imported code paths are still
checked), builds the package thread-entry graph and lock-acquisition
graph, and proves:

RC1  guarded-attribute mutation: every attribute a contract declares
     guarded is only mutated inside ``with self.<lock>`` (or an alias,
     or a method proven to run under the lock); ``__init__`` is exempt
     (pre-publication).
RC2  lock-order acyclicity: the static acquisition graph — lexically
     nested ``with``-lock blocks package-wide, flock vertices, plus
     the declared partial order (``sync.DECLARED_ORDER``) — has no
     cycle; a cycle is a potential deadlock.  Raw ``fcntl.flock``
     calls outside the single audited primitive
     (``utils/artifacts.flock_acquire``) are RC2 findings too: an
     unregistered flock site is an edge the graph cannot see.
RC3  callback hygiene: a hook the contract names in ``callbacks``
     (user code that may re-enter the package) is never invoked while
     the class lock is held — the rule ``obs/pulse.py`` follows by
     hand, now checked.
RC4  no blocking call under a lock: socket ``recv``/``accept``,
     ``subprocess`` waits, ``Event.wait()`` without timeout,
     ``time.sleep``, zero-arg ``join()``, ``os.fsync`` — none may
     appear in an under-lock region (a Condition's own ``wait`` is
     exempt: it releases the lock).
RC5  shared module state: a mutable module-level binding mutated by a
     function reachable from a secondary thread entry
     (``threading.Thread`` target, ``atexit`` hook, ``sys.excepthook``)
     must be mutated under a lock or flock — main + that entry are two
     writers.

Verdicts land in a drift-detected ``analysis/sync_manifest.json`` of
this package (the collective_manifest.json discipline): ``--check`` recomputes without
writing and fails on any violation OR any drift against the checked-in
manifest.  Waivers mirror graft-lint: ``# graft-sync: disable=RC4`` on
the offending line, ``# graft-sync: disable-file`` anywhere.
"""

from __future__ import annotations

import ast
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULE_IDS = ("RC1", "RC2", "RC3", "RC4", "RC5")

RULE_TITLES = {
    "RC1": "guarded attribute mutated only under its declared lock",
    "RC2": "static lock-acquisition graph is acyclic",
    "RC3": "no contract callback invoked while a lock is held",
    "RC4": "no blocking call under a held lock",
    "RC5": "thread-shared module state is lock-/flock-guarded",
}

DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "sync_manifest.json")

#: Keys the drift comparison ignores (environment, not behavior).
VOLATILE_KEYS = ("timestamp", "python_version", "platform", "generated_by")

_WAIVE_TOKEN = "graft-sync:"
_FLOCK_PRIMITIVE_TOKEN = "graft-sync: flock-primitive"

#: Container-mutating method names treated as writes for RC1/RC5.
_MUTATORS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "merge", "observe", "pop", "popitem", "popleft",
    "remove", "reverse", "rotate", "setdefault", "sort", "update",
})

#: Attribute calls that block (RC4) regardless of arguments.
_BLOCKING_ATTRS = frozenset({
    "accept", "communicate", "fsync", "recv", "recv_into", "recvfrom",
})

#: ``subprocess.<fn>`` calls that block (RC4).
_BLOCKING_SUBPROCESS = frozenset({
    "call", "check_call", "check_output", "run",
})

_LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                             "BoundedSemaphore"})


class Finding:
    """One rule violation at one source location."""

    __slots__ = ("rule", "path", "line", "message")

    def __init__(self, rule: str, path: str, line: int, message: str):
        self.rule = rule
        self.path = path
        self.line = int(line)
        self.message = message

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


class Contract:
    """A ``@guarded_by`` declaration read from the AST."""

    __slots__ = ("path", "cls", "line", "lock", "node", "attrs",
                 "callbacks", "aliases")

    def __init__(self, path: str, cls: str, line: int, lock: str,
                 node: Optional[str], attrs: Tuple[str, ...],
                 callbacks: Tuple[str, ...], aliases: Tuple[str, ...]):
        self.path = path
        self.cls = cls
        self.line = line
        self.lock = lock
        self.node = node or cls
        self.attrs = attrs
        self.callbacks = callbacks
        self.aliases = aliases

    @property
    def lock_names(self) -> Set[str]:
        return {self.lock, *self.aliases}

    def to_json(self) -> dict:
        return {"path": self.path, "class": self.cls, "line": self.line,
                "lock": self.lock, "node": self.node,
                "attrs": list(self.attrs),
                "callbacks": list(self.callbacks),
                "aliases": list(self.aliases)}


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _const_str_tuple(node) -> Tuple[str, ...]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            s = _const_str(elt)
            if s is not None:
                out.append(s)
        return tuple(out)
    return ()


def _decorator_contract(dec) -> Optional[dict]:
    """Parse ``@guarded_by("_lock", node=..., attrs=..., ...)``."""
    if not isinstance(dec, ast.Call):
        return None
    fn = dec.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    if name != "guarded_by" or not dec.args:
        return None
    lock = _const_str(dec.args[0])
    if lock is None:
        return None
    kw = {k.arg: k.value for k in dec.keywords if k.arg}
    return {
        "lock": lock,
        "node": _const_str(kw.get("node")) if "node" in kw else None,
        "attrs": _const_str_tuple(kw.get("attrs")),
        "callbacks": _const_str_tuple(kw.get("callbacks")),
        "aliases": _const_str_tuple(kw.get("aliases")),
    }


class _Module:
    """Parsed module plus the name-resolution scraps the rules need."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.disable_file = any(
            _WAIVE_TOKEN in ln and "disable-file" in ln
            for ln in self.lines)
        # import-alias map: local name -> dotted module ("_time" -> "time")
        self.mod_aliases: Dict[str, str] = {}
        # from-import map: local name -> "module.attr"
        self.from_imports: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.mod_aliases[a.asname or a.name.split(".")[0]] = \
                        a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        # module-level lock variables: NAME = threading.Lock() / RLock()
        # (possibly wrapped in witnessed("node", ...)).
        self.module_locks: Dict[str, str] = {}
        modname = os.path.splitext(os.path.basename(path))[0]
        for stmt in self.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                name = stmt.targets[0].id
                node_name = self._lock_factory_node(stmt.value)
                if node_name is not None:
                    self.module_locks[name] = (
                        node_name if node_name != "" else
                        f"{modname}.{name}")
        # module-level DECLARED_ORDER (fixtures / selftests)
        self.declared_order: List[Tuple[str, str]] = []
        for stmt in self.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "DECLARED_ORDER"
                    and isinstance(stmt.value, (ast.Tuple, ast.List))):
                for elt in stmt.value.elts:
                    pair = _const_str_tuple(elt)
                    if len(pair) == 2:
                        self.declared_order.append((pair[0], pair[1]))

    def _lock_factory_node(self, value) -> Optional[str]:
        """'' for a bare Lock()/RLock() assignment, the witness node
        name for witnessed("node", Lock()), else None."""
        if isinstance(value, ast.Call):
            fn = value.func
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in _LOCK_FACTORIES):
                return ""
            if isinstance(fn, ast.Name) and fn.id in _LOCK_FACTORIES:
                return ""
            if (isinstance(fn, ast.Name) and fn.id == "witnessed"
                    and value.args):
                return _const_str(value.args[0]) or ""
        return None

    def waived(self, line: int, rule: str) -> bool:
        if self.disable_file:
            return True
        if 1 <= line <= len(self.lines):
            text = self.lines[line - 1]
            if _WAIVE_TOKEN in text and f"disable={rule}" in text:
                return True
            # multi-line statements: also honor a waiver on the `with`
            # opening line one above
            if line >= 2:
                prev = self.lines[line - 2]
                if _WAIVE_TOKEN in prev and f"disable={rule}" in prev:
                    return True
        return False

    def resolves_to(self, node, module: str) -> bool:
        """Does ``node`` (the value part of an Attribute) name the
        imported module ``module`` under any alias?"""
        return (isinstance(node, ast.Name)
                and self.mod_aliases.get(node.id) == module)


def _self_attr(node) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _mutation_target_attr(stmt) -> List[Tuple[str, int]]:
    """self-attribute names written by an Assign/AugAssign/AnnAssign/
    Delete statement (direct or through one subscript level)."""
    out: List[Tuple[str, int]] = []
    targets: List = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    for t in targets:
        if isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, ast.Tuple):
            for elt in t.elts:
                sub = elt.value if isinstance(elt, ast.Subscript) else elt
                a = _self_attr(sub)
                if a is not None:
                    out.append((a, stmt.lineno))
            continue
        a = _self_attr(t)
        if a is not None:
            out.append((a, stmt.lineno))
    return out


def _mutator_call_attr(call) -> Optional[Tuple[str, int]]:
    """``self.<attr>.append(...)``-style container mutation."""
    fn = call.func
    if (isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS):
        a = _self_attr(fn.value)
        if a is not None:
            return a, call.lineno
    return None


class _FlockNode:
    """Resolve with-items / calls that mark flock regions."""

    @staticmethod
    def of_withitem(mod: _Module, item) -> Optional[str]:
        expr = item.context_expr
        if not isinstance(expr, ast.Call):
            return None
        fn = expr.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name == "flock_witness" and expr.args:
            arg = _const_str(expr.args[0])
            return f"flock:{arg}" if arg else "flock:?"
        if name == "locked_file":
            return "flock:sidecar"
        return None


class _FunctionScan:
    """Single lexical walk of one function body tracking the stack of
    held lock nodes; collects everything RC1-RC4 need."""

    def __init__(self, mod: _Module, contract: Optional[Contract],
                 class_contracts: Dict[str, Contract]):
        self.mod = mod
        self.contract = contract          # enclosing class's, if any
        self.class_contracts = class_contracts
        self.own_lock_held_depth = 0      # contract lock (incl. aliases)
        # (node_name, is_flock) entries currently open; flock regions
        # contribute RC2 graph edges but do not count as "a held lock"
        # for RC3/RC4 — fsync-under-flock is the crash-consistency
        # point of append_jsonl, not a hazard.
        self.lock_stack: List[Tuple[str, bool]] = []
        self.mutations: List[Tuple[str, int, bool]] = []
        self.callback_calls: List[Tuple[str, int, bool]] = []
        self.blocking: List[Tuple[str, int, bool]] = []
        self.self_calls: List[Tuple[str, int, bool]] = []
        self.edges: List[Tuple[str, str, int]] = []
        self.raw_flock: List[int] = []

    # -- lock-expression resolution -------------------------------------

    def _with_lock_node(self, item) -> Optional[Tuple[str, bool]]:
        """(node_name, is_own_class_lock) for a with-item that acquires
        a known lock, else None."""
        expr = item.context_expr
        a = _self_attr(expr)
        if a is not None and self.contract is not None \
                and a in self.contract.lock_names:
            return self.contract.node, True
        if isinstance(expr, ast.Name) \
                and expr.id in self.mod.module_locks:
            return self.mod.module_locks[expr.id], False
        flock = _FlockNode.of_withitem(self.mod, item)
        if flock is not None:
            return flock, False
        return None

    # -- walk ------------------------------------------------------------

    def scan(self, fn) -> None:
        for stmt in fn.body:
            self._visit(stmt)

    def _under(self) -> bool:
        return self.own_lock_held_depth > 0

    def _visit(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return          # nested defs scanned separately (closures
                            # run later, not under this lock region)
        if isinstance(node, ast.With):
            acquired: List[Tuple[str, bool]] = []
            for item in node.items:
                res = self._with_lock_node(item)
                if res is not None:
                    node_name, own = res
                    for open_node, _fl in self.lock_stack:
                        if open_node != node_name:
                            self.edges.append(
                                (open_node, node_name, node.lineno))
                    self.lock_stack.append(
                        (node_name, node_name.startswith("flock:")))
                    acquired.append(res)
                    if own:
                        self.own_lock_held_depth += 1
                for sub in ([item.context_expr] +
                            ([item.optional_vars]
                             if item.optional_vars else [])):
                    self._visit_expr(sub)
            for stmt in node.body:
                self._visit(stmt)
            for node_name, own in reversed(acquired):
                self.lock_stack.pop()
                if own:
                    self.own_lock_held_depth -= 1
            return
        for attr, line in _mutation_target_attr(node):
            self.mutations.append((attr, line, self._under()))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.expr):
                self._visit_expr(child)
            else:
                self._visit(child)

    def _visit_expr(self, node) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._note_call(sub)

    def _note_call(self, call) -> None:
        mut = _mutator_call_attr(call)
        if mut is not None:
            self.mutations.append((mut[0], mut[1], self._under()))
        a = _self_attr(call.func)
        if a is not None:
            self.self_calls.append((a, call.lineno, self._under()))
            if self.contract is not None \
                    and a in self.contract.callbacks:
                self.callback_calls.append(
                    (a, call.lineno, self._thread_lock_held()))
        self._note_blocking(call)
        self._note_raw_flock(call)

    def _thread_lock_held(self) -> bool:
        return any(not is_flock for _, is_flock in self.lock_stack)

    def _note_blocking(self, call) -> None:
        fn = call.func
        held = self._thread_lock_held()
        desc = None
        if isinstance(fn, ast.Attribute):
            if fn.attr in _BLOCKING_ATTRS:
                desc = f".{fn.attr}()"
            elif fn.attr == "sleep" and (
                    self.mod.resolves_to(fn.value, "time")):
                desc = "time.sleep()"
            elif fn.attr in _BLOCKING_SUBPROCESS and (
                    self.mod.resolves_to(fn.value, "subprocess")):
                desc = f"subprocess.{fn.attr}()"
            elif fn.attr == "join" and not call.args \
                    and not call.keywords \
                    and not isinstance(fn.value, ast.Constant):
                desc = "zero-arg .join()"
            elif fn.attr == "wait":
                recv = _self_attr(fn.value)
                is_own_cond = (recv is not None
                               and self.contract is not None
                               and recv in self.contract.lock_names)
                has_timeout = bool(call.args) or any(
                    k.arg == "timeout" for k in call.keywords)
                if not is_own_cond and not has_timeout:
                    desc = ".wait() without timeout"
        elif isinstance(fn, ast.Name):
            tgt = self.mod.from_imports.get(fn.id)
            if tgt in ("time.sleep", "os.fsync"):
                desc = f"{tgt}()"
        if desc is not None:
            self.blocking.append((desc, call.lineno, held))

    def _note_raw_flock(self, call) -> None:
        fn = call.func
        if (isinstance(fn, ast.Attribute) and fn.attr == "flock"
                and self.mod.resolves_to(fn.value, "fcntl")):
            line = call.lineno
            text = self.mod.lines[line - 1] \
                if 1 <= line <= len(self.mod.lines) else ""
            if _FLOCK_PRIMITIVE_TOKEN not in text:
                self.raw_flock.append(line)


def _iter_functions(tree):
    """Every function in the module exactly once, paired with its
    class when it is a direct class-body method (nested closures —
    thread targets — come through with None: they run later, not under
    their enclosure's lock region)."""
    class_of = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    class_of[id(sub)] = node
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield class_of.get(id(node)), node


class ModuleReport:
    """Everything one module contributes to the package verdict."""

    def __init__(self, mod: _Module):
        self.mod = mod
        self.contracts: List[Contract] = []
        self.findings: List[Finding] = []
        self.edges: List[Tuple[str, str, int]] = []
        self.thread_entries: List[dict] = []
        self.declared_order = list(mod.declared_order)


def _class_contract(mod: _Module, classdef) -> Optional[Contract]:
    for dec in classdef.decorator_list:
        parsed = _decorator_contract(dec)
        if parsed is not None:
            return Contract(mod.path, classdef.name, classdef.lineno,
                            parsed["lock"], parsed["node"],
                            parsed["attrs"], parsed["callbacks"],
                            parsed["aliases"])
    return None


def _under_lock_methods(scans: Dict[str, _FunctionScan]) -> Set[str]:
    """Methods proven to run with the class lock held: the ``*_locked``
    naming convention, plus private methods whose every intra-class
    call site is under the lock (lexically or transitively)."""
    under: Set[str] = {name for name in scans if name.endswith("_locked")}
    # call sites per callee; ``__init__`` call sites are excluded —
    # pre-publication calls run before any other thread can hold a
    # reference, so an unlocked call there does not defeat the proof
    sites: Dict[str, List[Tuple[str, bool]]] = {}
    for caller, scan in scans.items():
        if caller == "__init__":
            continue
        for callee, _line, lexical in scan.self_calls:
            if callee in scans:
                sites.setdefault(callee, []).append((caller, lexical))
    changed = True
    while changed:
        changed = False
        for name, scan in scans.items():
            if name in under or not name.startswith("_") \
                    or name.startswith("__"):
                continue
            callers = sites.get(name)
            if not callers:
                continue
            if all(lexical or caller in under
                   for caller, lexical in callers):
                under.add(name)
                changed = True
    return under


def analyze_module(path: str, source: Optional[str] = None
                   ) -> ModuleReport:
    if source is None:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    mod = _Module(path, source)
    report = ModuleReport(mod)

    class_contracts: Dict[str, Contract] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef):
            c = _class_contract(mod, node)
            if c is not None:
                class_contracts[node.name] = c
                report.contracts.append(c)

    # ---- per-class scans (RC1, RC3) + shared RC2/RC4 collection ----
    all_scans: List[Tuple[Optional[Contract], str, _FunctionScan]] = []
    for classdef in [n for n in mod.tree.body
                     if isinstance(n, ast.ClassDef)]:
        contract = class_contracts.get(classdef.name)
        scans: Dict[str, _FunctionScan] = {}
        for fn in classdef.body:
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            scan = _FunctionScan(mod, contract, class_contracts)
            scan.scan(fn)
            scans[fn.name] = scan
            all_scans.append((contract, fn.name, scan))
        if contract is None:
            continue
        under = _under_lock_methods(scans)
        for name, scan in scans.items():
            if name == "__init__":
                continue
            method_under = name in under
            for attr, line, lexical in scan.mutations:
                if attr in contract.attrs and not lexical \
                        and not method_under \
                        and not mod.waived(line, "RC1"):
                    report.findings.append(Finding(
                        "RC1", mod.path, line,
                        f"{contract.cls}.{attr} is declared guarded by "
                        f"self.{contract.lock} but mutated outside it "
                        f"in {name}()"))
            for cb, line, held in scan.callback_calls:
                if (held or method_under) \
                        and not mod.waived(line, "RC3"):
                    report.findings.append(Finding(
                        "RC3", mod.path, line,
                        f"{contract.cls}.{cb} is a declared callback "
                        f"but invoked while a lock is held in {name}()"))
            for desc, line, held in scan.blocking:
                if (held or method_under) \
                        and not mod.waived(line, "RC4"):
                    report.findings.append(Finding(
                        "RC4", mod.path, line,
                        f"blocking {desc} under a held lock in "
                        f"{contract.cls}.{name}()"))

    # module-level + nested functions (RC2 edges, RC4 under module
    # locks, raw-flock sites)
    for classdef, fn in _iter_functions(mod.tree):
        if classdef is not None:
            continue       # class methods already scanned
        scan = _FunctionScan(mod, None, class_contracts)
        scan.scan(fn)
        all_scans.append((None, fn.name, scan))
        for desc, line, held in scan.blocking:
            if held and not mod.waived(line, "RC4"):
                report.findings.append(Finding(
                    "RC4", mod.path, line,
                    f"blocking {desc} under a held lock in {fn.name}()"))

    for _, _, scan in all_scans:
        report.edges.extend(scan.edges)
        for line in scan.raw_flock:
            if not mod.waived(line, "RC2"):
                report.findings.append(Finding(
                    "RC2", mod.path, line,
                    "raw fcntl.flock outside the audited primitive "
                    "(utils/artifacts.flock_acquire) — an unregistered "
                    "flock site is invisible to the lock graph"))

    _scan_thread_entries(mod, report)
    _check_rc5(mod, report)
    return report


# ---------------------------------------------------------------------------
# Thread-entry graph + RC5
# ---------------------------------------------------------------------------


def _call_name(call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _scan_thread_entries(mod: _Module, report: ModuleReport) -> None:
    """Every secondary entry into this module's code: Thread targets,
    atexit hooks, excepthook assignments."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name == "Thread":
                for k in node.keywords:
                    if k.arg == "target":
                        report.thread_entries.append({
                            "module": mod.path, "kind": "thread",
                            "target": _target_name(k.value),
                            "line": node.lineno})
            elif name == "register" and isinstance(
                    node.func, ast.Attribute) and mod.resolves_to(
                        node.func.value, "atexit") and node.args:
                report.thread_entries.append({
                    "module": mod.path, "kind": "atexit",
                    "target": _target_name(node.args[0]),
                    "line": node.lineno})
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and t.attr == "excepthook"
                        and mod.resolves_to(t.value, "sys")):
                    report.thread_entries.append({
                        "module": mod.path, "kind": "excepthook",
                        "target": _target_name(node.value),
                        "line": node.lineno})


def _target_name(node) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Lambda):
        return "<lambda>"
    return "<expr>"


def _mutable_globals(mod: _Module) -> Set[str]:
    """Module-level names bound to mutable containers, plus names
    rebound via ``global`` inside functions."""
    out: Set[str] = set()
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            v = stmt.value
            mutable = isinstance(v, (ast.Dict, ast.List, ast.Set,
                                     ast.ListComp, ast.DictComp,
                                     ast.SetComp))
            if isinstance(v, ast.Call):
                n = _call_name(v)
                mutable = n in ("dict", "list", "set", "deque",
                                "Counter", "defaultdict", "OrderedDict")
            if mutable:
                out.add(stmt.targets[0].id)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Global):
            out.update(node.names)
    return out


def _check_rc5(mod: _Module, report: ModuleReport) -> None:
    mutables = _mutable_globals(mod)
    if not mutables:
        return
    entry_targets = {e["target"] for e in report.thread_entries
                     if e["module"] == mod.path}
    if not entry_targets:
        return

    # intra-module call graph by simple name (module functions, nested
    # closures, and methods all participate — pragmatic resolution).
    fns: Dict[str, ast.AST] = {}
    calls: Dict[str, Set[str]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns.setdefault(node.name, node)
            out = calls.setdefault(node.name, set())
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    n = _call_name(sub)
                    if n:
                        out.add(n)
    reachable: Set[str] = set()
    frontier = [t for t in entry_targets if t in fns]
    while frontier:
        cur = frontier.pop()
        if cur in reachable:
            continue
        reachable.add(cur)
        frontier.extend(c for c in calls.get(cur, ()) if c in fns)

    lock_names = set(mod.module_locks)
    for name in reachable:
        fn = fns[name]
        # lock depth tracking within this function for guard detection
        self_mutations = _global_mutations(fn, mutables, mod)
        for gname, line, guarded in self_mutations:
            if not guarded and not mod.waived(line, "RC5"):
                report.findings.append(Finding(
                    "RC5", mod.path, line,
                    f"module-level {gname!r} mutated in {name}() which "
                    f"is reachable from a secondary thread entry "
                    f"({', '.join(sorted(entry_targets))}) without a "
                    f"lock or flock guard"))


def _global_mutations(fn, mutables: Set[str], mod: _Module
                      ) -> List[Tuple[str, int, bool]]:
    """(name, line, guarded) for mutations of module globals in fn."""
    out: List[Tuple[str, int, bool]] = []
    declared_global: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared_global.update(node.names)

    def visit(node, depth):
        if isinstance(node, ast.With):
            d = depth
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) \
                        and expr.id in mod.module_locks:
                    d += 1
                elif _FlockNode.of_withitem(mod, item) is not None:
                    d += 1
                elif _self_attr(expr) is not None:
                    d += 1      # any instance lock counts as a guard
            for stmt in node.body:
                visit(stmt, d)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.Delete)):
            targets = (node.targets if isinstance(
                node, (ast.Assign, ast.Delete)) else [node.target])
            for t in targets:
                base = t.value if isinstance(t, ast.Subscript) else t
                if isinstance(base, ast.Name) and base.id in mutables:
                    if isinstance(t, ast.Subscript) \
                            or base.id in declared_global:
                        out.append((base.id, node.lineno, depth > 0))
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _MUTATORS \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in mutables:
                out.append((f.value.id, node.lineno, depth > 0))
        for child in ast.iter_child_nodes(node):
            visit(child, depth)

    for stmt in fn.body:
        visit(stmt, 0)
    return out


# ---------------------------------------------------------------------------
# Package-level assembly: RC2 cycle check + manifest
# ---------------------------------------------------------------------------


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_package_files(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_native")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def _declared_order() -> List[Tuple[str, str]]:
    from arrow_matrix_tpu_torch.sync import DECLARED_ORDER
    return list(DECLARED_ORDER)


def _cycle_findings(edges: List[Tuple[str, str, int, str]],
                    declared: Sequence[Tuple[str, str]]) -> List[Finding]:
    succ: Dict[str, Set[str]] = {}
    where: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for a, b in declared:
        succ.setdefault(a, set()).add(b)
        where.setdefault((a, b), ("<declared>", 0))
    for a, b, line, path in edges:
        if a != b:
            succ.setdefault(a, set()).add(b)
            where.setdefault((a, b), (path, line))
    findings: List[Finding] = []
    # DFS cycle detection with path recovery
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []
    reported: Set[frozenset] = set()

    def dfs(u: str):
        color[u] = GRAY
        stack.append(u)
        for v in sorted(succ.get(u, ())):
            if color.get(v, WHITE) == WHITE:
                dfs(v)
            elif color.get(v) == GRAY:
                cyc = stack[stack.index(v):] + [v]
                key = frozenset(cyc)
                if key not in reported:
                    reported.add(key)
                    path, line = where.get((u, v), ("<unknown>", 0))
                    findings.append(Finding(
                        "RC2", path, line,
                        "lock-acquisition cycle (potential deadlock): "
                        + " -> ".join(cyc)))
        stack.pop()
        color[u] = BLACK

    for node in sorted(succ):
        if color.get(node, WHITE) == WHITE:
            dfs(node)
    return findings


class SyncReport:
    def __init__(self):
        self.findings: List[Finding] = []
        self.contracts: List[Contract] = []
        self.edges: List[Tuple[str, str, int, str]] = []
        self.thread_entries: List[dict] = []
        self.modules = 0
        self.declared: List[Tuple[str, str]] = []

    @property
    def ok(self) -> bool:
        return not self.findings


def analyze_paths(paths: Sequence[str],
                  declared: Optional[Sequence[Tuple[str, str]]] = None,
                  sources: Optional[Dict[str, str]] = None) -> SyncReport:
    report = SyncReport()
    module_declared: List[Tuple[str, str]] = []
    for path in paths:
        src = sources.get(path) if sources else None
        try:
            mr = analyze_module(path, src)
        except SyntaxError as e:
            report.findings.append(Finding(
                "RC2", path, e.lineno or 0, f"unparseable module: {e}"))
            continue
        report.modules += 1
        report.findings.extend(mr.findings)
        report.contracts.extend(mr.contracts)
        report.thread_entries.extend(mr.thread_entries)
        module_declared.extend(mr.declared_order)
        for a, b, line in mr.edges:
            report.edges.append((a, b, line, path))
    report.declared = (list(declared) if declared is not None
                       else module_declared)
    report.findings.extend(_cycle_findings(report.edges, report.declared))
    report.findings.sort(key=lambda f: (f.rule, f.path, f.line))
    return report


def analyze_package(root: Optional[str] = None) -> SyncReport:
    root = root or _package_root()
    return analyze_paths(_iter_package_files(root),
                         declared=_declared_order())


def analyze_source(source: str, path: str = "<fixture>",
                   declared: Optional[Sequence[Tuple[str, str]]] = None
                   ) -> SyncReport:
    """Fixture/selftest entry: analyze one module given as a string."""
    return analyze_paths([path], declared=declared,
                         sources={path: source})


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------


def _res(status: str, detail: str) -> dict:
    return {"status": status, "detail": detail}


def _repo_rel(path: str) -> str:
    """Repo-relative form for manifest paths: the committed manifest
    must not drift just because two machines check the repo out under
    different roots."""
    repo = os.path.dirname(_package_root())
    ap = os.path.abspath(path)
    if ap.startswith(repo + os.sep):
        return os.path.relpath(ap, repo)
    return path


def build_manifest(report: SyncReport) -> dict:
    import datetime
    import platform as _platform

    rules: Dict[str, dict] = {}
    for rule in RULE_IDS:
        hits = [f for f in report.findings if f.rule == rule]
        if hits:
            rules[rule] = _res("fail", "; ".join(
                f.format() for f in hits[:8]) + (
                    f" (+{len(hits) - 8} more)" if len(hits) > 8 else ""))
        else:
            rules[rule] = _res("pass", RULE_TITLES[rule])
    nodes = sorted({c.node for c in report.contracts}
                   | {a for a, *_ in report.edges}
                   | {b for _, b, *_ in report.edges}
                   | {x for pair in report.declared for x in pair})
    edges = sorted({(a, b) for a, b, _, _ in report.edges}
                   | set(report.declared))
    return {
        "generated_by": "python -m arrow_matrix_tpu_torch.analysis sync",
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "python_version": sys.version.split()[0],
        "platform": _platform.platform(),
        "package": "arrow_matrix_tpu_torch",
        "modules": report.modules,
        "rules": rules,
        "contracts": sorted(
            (dict(c.to_json(), path=_repo_rel(c.path))
             for c in report.contracts),
            key=lambda c: (c["path"], c["class"])),
        "lock_graph": {"nodes": nodes,
                       "edges": [list(e) for e in edges]},
        "thread_entries": sorted(
            (dict(e, module=_repo_rel(e["module"]))
             for e in report.thread_entries),
            key=lambda e: (e["module"], e["line"])),
        "findings": [dict(f.to_json(), path=_repo_rel(f.path))
                     for f in report.findings],
        "ok": report.ok,
    }


def manifest_digest(manifest: dict) -> dict:
    """The behavior-only view the drift gate compares: rule statuses,
    contract shapes, the lock graph, and the thread-entry set —
    everything except the volatile environment keys."""
    return {
        "rules": {r: v["status"]
                  for r, v in manifest.get("rules", {}).items()},
        "contracts": {
            f"{c['path']}::{c['class']}": {
                "lock": c["lock"], "node": c["node"],
                "attrs": sorted(c["attrs"]),
                "callbacks": sorted(c["callbacks"]),
                "aliases": sorted(c["aliases"]),
            }
            for c in manifest.get("contracts", ())
        },
        "lock_graph": {
            "nodes": list(manifest.get("lock_graph", {})
                          .get("nodes", ())),
            "edges": [tuple(e) for e in manifest.get("lock_graph", {})
                      .get("edges", ())],
        },
        "thread_entries": sorted(
            f"{e['module']}:{e['kind']}:{e['target']}"
            for e in manifest.get("thread_entries", ())),
        "findings": sorted(
            f"{f['rule']}:{f['path']}:{f['message']}"
            for f in manifest.get("findings", ())),
        "ok": manifest.get("ok"),
    }


def manifest_drift(old: dict, new: dict) -> List[str]:
    """Human-readable differences between two manifests' digests
    (empty = no drift)."""
    a, b = manifest_digest(old), manifest_digest(new)
    problems: List[str] = []
    for rule in sorted(set(a["rules"]) | set(b["rules"])):
        if a["rules"].get(rule) != b["rules"].get(rule):
            problems.append(
                f"rule {rule} changed: {a['rules'].get(rule)} -> "
                f"{b['rules'].get(rule)}")
    for key in sorted(set(a["contracts"]) | set(b["contracts"])):
        if key not in b["contracts"]:
            problems.append(f"contract disappeared: {key}")
        elif key not in a["contracts"]:
            problems.append(f"new unrecorded contract: {key}")
        elif a["contracts"][key] != b["contracts"][key]:
            problems.append(f"contract changed: {key}")
    if a["lock_graph"] != b["lock_graph"]:
        old_e = set(a["lock_graph"]["edges"])
        new_e = set(b["lock_graph"]["edges"])
        for e in sorted(new_e - old_e):
            problems.append(f"new lock-graph edge: {e[0]} -> {e[1]}")
        for e in sorted(old_e - new_e):
            problems.append(f"lock-graph edge disappeared: "
                            f"{e[0]} -> {e[1]}")
        if old_e == new_e:
            problems.append("lock-graph nodes changed")
    if a["thread_entries"] != b["thread_entries"]:
        problems.append("thread-entry graph changed")
    if a["findings"] != b["findings"]:
        problems.append("finding set changed")
    if a["ok"] != b["ok"]:
        problems.append(f"overall ok changed: {a['ok']} -> {b['ok']}")
    return problems


def run_sync(out_path: str = DEFAULT_MANIFEST,
             root: Optional[str] = None, write: bool = True) -> dict:
    """Analyze the whole package; return (and write) the manifest."""
    report = analyze_package(root)
    manifest = build_manifest(report)
    if write:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return manifest


# ---------------------------------------------------------------------------
# Fixtures + selftest
# ---------------------------------------------------------------------------


def fixture_contract(path: str) -> str:
    """Expected rule for a planted-violation fixture, from its
    ``rcN_*.py`` filename."""
    base = os.path.basename(path)
    for rule in RULE_IDS:
        if base.lower().startswith(rule.lower() + "_"):
            return rule
    raise ValueError(
        f"fixture {base!r} does not follow the rcN_<slug>.py convention")


def verify_fixture(path: str) -> Tuple[bool, str]:
    """(ok, detail): the fixture must fire its expected rule."""
    expected = fixture_contract(path)
    report = analyze_paths([path])
    fired = sorted({f.rule for f in report.findings})
    if expected in fired:
        return True, (f"{os.path.basename(path)}: {expected} fired "
                      f"({len(report.findings)} finding(s))")
    return False, (f"{os.path.basename(path)}: expected {expected}, "
                   f"got {fired or 'nothing'}")


_SELFTEST_GOOD = '''
import threading
from arrow_matrix_tpu_torch.sync import guarded_by

@guarded_by("_lock", node="good", attrs=("items", "count"),
            callbacks=("on_done",))
class Good:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []
        self.count = 0
        self.on_done = None

    def add(self, x):
        with self._lock:
            self.items.append(x)
            self.count += 1
        if self.on_done is not None:
            self.on_done(x)
'''

_SELFTEST_BROKEN = {
    "RC1": '''
import threading
from arrow_matrix_tpu_torch.sync import guarded_by

@guarded_by("_lock", node="bad1", attrs=("items",))
class Bad:
    def __init__(self):
        self._lock = threading.Lock()
        self.items = []

    def add(self, x):
        self.items.append(x)
''',
    "RC2": '''
import threading

LOCK_A = threading.Lock()
LOCK_B = threading.Lock()

def forward():
    with LOCK_A:
        with LOCK_B:
            pass

def backward():
    with LOCK_B:
        with LOCK_A:
            pass
''',
    "RC3": '''
import threading
from arrow_matrix_tpu_torch.sync import guarded_by

@guarded_by("_lock", node="bad3", callbacks=("on_done",))
class Bad:
    def __init__(self, on_done):
        self._lock = threading.Lock()
        self.on_done = on_done

    def fire(self):
        with self._lock:
            self.on_done()
''',
    "RC4": '''
import os
import threading
from arrow_matrix_tpu_torch.sync import guarded_by

@guarded_by("_lock", node="bad4")
class Bad:
    def __init__(self):
        self._lock = threading.Lock()

    def flush(self, fd):
        with self._lock:
            os.fsync(fd)
''',
    "RC5": '''
import threading

CACHE = {}

def worker():
    CACHE["k"] = 1

def start():
    t = threading.Thread(target=worker)
    t.start()
''',
}


def selftest() -> Tuple[bool, List[str]]:
    """Inline good/broken twins (no dependence on the tests/ tree — the
    doctor probe runs this from any cwd) plus a runtime-witness
    round trip."""
    lines: List[str] = []
    ok = True

    good = analyze_source(_SELFTEST_GOOD, "<good>")
    if good.findings:
        ok = False
        lines.append("selftest GOOD twin produced findings: " + "; ".join(
            f.format() for f in good.findings))
    else:
        lines.append("good twin clean")
    for rule, src in _SELFTEST_BROKEN.items():
        rep = analyze_source(src, f"<broken-{rule}>")
        fired = {f.rule for f in rep.findings}
        if rule not in fired:
            ok = False
            lines.append(f"selftest broken twin for {rule} did not fire "
                         f"(got {sorted(fired) or 'nothing'})")
        else:
            lines.append(f"{rule} fires on its broken twin")

    # runtime witness round trip: an inverted order must raise, a
    # consistent reentrant one must not.
    import threading as _threading

    from arrow_matrix_tpu_torch.sync import (LockOrderViolation, LockRegistry,
                                       _WitnessLock)

    reg = LockRegistry(declared=(("a", "b"),))
    la = _WitnessLock("a", _threading.RLock(), reg)
    lb = _WitnessLock("b", _threading.RLock(), reg)
    with la:
        with la:            # reentrant: no self-edge
            with lb:
                pass
    try:
        with lb:
            with la:
                pass
        ok = False
        lines.append("witness FAILED to raise on inverted order")
    except LockOrderViolation:
        lines.append("witness raises on inverted acquisition order")
    if reg.reentries < 1:
        ok = False
        lines.append("witness missed the reentrant acquisition")
    return ok, lines


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="graft_sync", description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_MANIFEST)
    ap.add_argument("--root", default=None,
                    help="package root to analyze (default: the "
                         "installed arrow_matrix_tpu_torch)")
    ap.add_argument("--check", action="store_true",
                    help="do not write; fail on any violation OR drift "
                         "against the checked-in manifest")
    ap.add_argument("--selftest", action="store_true",
                    help="run the inline good/broken twins + witness "
                         "round trip and exit")
    ap.add_argument("--fixture", action="append", default=[],
                    help="verify a planted-violation fixture fires its "
                         "expected rule (repeatable)")
    args = ap.parse_args(argv)

    if args.selftest:
        ok, lines = selftest()
        for ln in lines:
            print(ln)
        print("selftest passed" if ok else "SELFTEST FAILED")
        return 0 if ok else 1

    if args.fixture:
        rc = 0
        for path in args.fixture:
            ok, detail = verify_fixture(path)
            print(("ok   " if ok else "FAIL ") + detail)
            rc = rc or (0 if ok else 1)
        return rc

    manifest = run_sync(out_path=args.out, root=args.root,
                        write=not args.check)
    for rule in RULE_IDS:
        v = manifest["rules"][rule]
        mark = "ok  " if v["status"] == "pass" else "FAIL"
        print(f"[{mark}] {rule}: {v['detail']}")
    print(f"contracts: {len(manifest['contracts'])}  "
          f"lock-graph edges: {len(manifest['lock_graph']['edges'])}  "
          f"thread entries: {len(manifest['thread_entries'])}  "
          f"modules: {manifest['modules']}")

    rc = 0 if manifest["ok"] else 1
    if args.check:
        try:
            with open(args.out, encoding="utf-8") as fh:
                checked_in = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"no readable checked-in manifest at {args.out}: {e}")
            return 1
        drift = manifest_drift(checked_in, manifest)
        for d in drift:
            print(f"drift: {d}")
        if drift:
            print(f"sync drift against {args.out} — rerun "
                  f"`python -m arrow_matrix_tpu_torch.analysis sync` and "
                  f"commit the refreshed manifest")
            rc = 1
    else:
        print(f"manifest: {args.out}")
    print("sync proof passed" if rc == 0 else "SYNC PROOF FAILED")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

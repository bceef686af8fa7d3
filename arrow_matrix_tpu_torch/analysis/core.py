"""graft-lint framework: registry, module context, waivers, walking.

The port's copy of ``arrow_matrix_tpu/analysis/core.py``.  The linter
is purely syntactic (``ast``): it never imports the modules it checks,
so it is safe on broken trees, costs milliseconds per file, and cannot
touch the card — the property that lets it run inside tier-1 and inside
``amt_doctor_torch`` unconditionally.

Scope contract: hot-scope rules (R1, R5, R9) apply inside functions
this module can PROVE run every step — a function captured by
``torch.cuda.graph`` (called inside its ``with`` block) or
``make_graphed_callables``, compiled by ``torch.compile``, or passed as
an executor's step function (a ``step_fn=`` argument), closed over
module-local calls and nested defs.  Cross-module capture (a function
graphed by its importer) is out of scope by design; the audit engine
(analysis/audit.py) covers the composed entry points instead.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Findings and registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    rule_id: str
    name: str
    summary: str
    check: Callable  # (ModuleContext) -> Iterable[tuple[int, str]]


#: rule_id -> RuleSpec, populated by the ``register`` decorator.
RULES: dict = {}


def register(rule_id: str, name: str, summary: str):
    """Class/function decorator adding a checker to the registry.

    A checker is ``check(ctx: ModuleContext) -> Iterable[(line, msg)]``.
    """
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = RuleSpec(rule_id, name, summary, fn)
        return fn
    return deco


def rule_table() -> List[RuleSpec]:
    _ensure_rules_loaded()
    return [RULES[k] for k in sorted(RULES)]


def _ensure_rules_loaded() -> None:
    # The rules module registers itself on import; core must not import
    # it at module level (rules imports core for the registry).
    if not RULES:
        import arrow_matrix_tpu_torch.analysis.rules  # noqa: F401


# ---------------------------------------------------------------------------
# Waivers
# ---------------------------------------------------------------------------

#: Inline waiver on the finding's line: ``# graft-lint: disable=R1,R6``
#: (no ``=RULES`` suffix disables every rule for that line).
WAIVER_RE = re.compile(
    r"#\s*graft-lint:\s*disable(?:-file)?(?:=(?P<rules>[A-Za-z0-9, ]+))?")
FILE_WAIVER_RE = re.compile(
    r"#\s*graft-lint:\s*disable-file(?:=(?P<rules>[A-Za-z0-9, ]+))?")


def _parse_rule_list(m) -> frozenset:
    spec = m.group("rules")
    if spec is None:
        return frozenset()          # empty set == every rule
    return frozenset(r.strip() for r in spec.split(",") if r.strip())


def parse_waivers(source: str) -> Tuple[dict, frozenset]:
    """(line -> waived rule-ids, file-level waived rule-ids).

    An empty rule set means "all rules" (bare ``disable``).
    """
    per_line: dict = {}
    file_level: frozenset = None
    for i, text in enumerate(source.splitlines(), start=1):
        if "graft-lint" not in text:
            continue
        fm = FILE_WAIVER_RE.search(text)
        if fm:
            rules = _parse_rule_list(fm)
            file_level = (rules if file_level is None
                          else file_level | rules)
            continue
        m = WAIVER_RE.search(text)
        if m:
            per_line[i] = _parse_rule_list(m)
    return per_line, (file_level if file_level is not None else None)


def _waived(f: Finding, per_line: dict, file_level) -> bool:
    if file_level is not None and (not file_level or f.rule in file_level):
        return True
    rules = per_line.get(f.line)
    if rules is None:
        return False
    return not rules or f.rule in rules


# ---------------------------------------------------------------------------
# Module context (shared pre-analysis the rules build on)
# ---------------------------------------------------------------------------

#: Wrappers whose function-valued arguments run as the step: captured
#: into a CUDA graph, compiled, or vectorized.
TRACE_WRAPPERS = frozenset({
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.vmap", "torch.func.vmap", "torch.func.grad",
    "torch.func.functional_call",
})

#: The subset that builds a compiled (or captured) callable: a cache
#: boundary, the torch form of the reference's jit.
JIT_WRAPPERS = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
})

#: Context managers whose body is captured as the step.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})

#: Keyword names under which a function is handed over as a step.
STEP_KEYWORDS = frozenset({"step_fn"})


class ModuleContext:
    """Parsed module plus the shared analyses every rule consumes."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.parents: dict = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.aliases = self._collect_aliases()
        self.funcs_by_name = self._collect_functions()
        self.traced = self._compute_traced()

    # -- imports / name resolution --------------------------------------

    def _collect_aliases(self) -> dict:
        """local name -> canonical dotted module/object path."""
        aliases: dict = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def dotted(self, node) -> Optional[str]:
        """Source-level dotted name of a Name/Attribute chain."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    def resolve(self, node) -> Optional[str]:
        """Canonical dotted name with import aliases substituted
        (``np.asarray`` -> ``numpy.asarray``, bare ``compile`` imported
        from torch -> ``torch.compile``)."""
        d = self.dotted(node)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        full = self.aliases.get(head, head) + (("." + rest) if rest else "")
        return full

    def is_numpy_call(self, call: ast.Call, attr: str) -> bool:
        """Is ``call`` ``numpy.<attr>(...)`` under any alias?"""
        return self.resolve(call.func) == f"numpy.{attr}"

    # -- functions and hot scopes ----------------------------------------

    def _collect_functions(self) -> dict:
        funcs: dict = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                             ast.Lambda):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        funcs.setdefault(t.id, []).append(node.value)
        return funcs

    def _callable_args(self, call: ast.Call, args=None) -> list:
        """Function-valued argument nodes of a wrapper call (or of
        ``args``): lambdas, local function names, and functools.partial
        wraps."""
        out = []
        if args is None:
            args = list(call.args) + [kw.value for kw in call.keywords]
        for arg in args:
            if isinstance(arg, ast.Lambda):
                out.append(arg)
            elif isinstance(arg, ast.Name) and arg.id in self.funcs_by_name:
                out.append(arg)
            elif (isinstance(arg, ast.Call)
                  and self.resolve(arg.func) == "functools.partial"
                  and arg.args):
                inner = arg.args[0]
                if isinstance(inner, (ast.Lambda, ast.Name)):
                    out.append(inner)
        return out

    def _compute_traced(self) -> set:
        """Fixpoint set of function/lambda nodes that run as the step."""
        traced: set = set()
        pending_names: set = set()
        self.capture_blocks = []

        def mark(node):
            if isinstance(node, ast.Name):
                pending_names.add(node.id)
            elif node is not None:
                traced.add(node)

        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                full = self.resolve(node.func)
                if full in TRACE_WRAPPERS:
                    for fn in self._callable_args(node):
                        mark(fn)
                steps = [kw.value for kw in node.keywords
                         if kw.arg in STEP_KEYWORDS]
                for fn in self._callable_args(node, steps):
                    mark(fn)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(isinstance(it.context_expr, ast.Call)
                       and self.resolve(it.context_expr.func)
                       in CAPTURE_CONTEXTS for it in node.items):
                    self.capture_blocks.append(node)
                    for sub in ast.walk(node):
                        if (isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Name)
                                and sub.func.id in self.funcs_by_name):
                            pending_names.add(sub.func.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for deco in node.decorator_list:
                    target = deco.func if isinstance(deco, ast.Call) else deco
                    full = self.resolve(target)
                    if full in TRACE_WRAPPERS:
                        traced.add(node)
                    elif (isinstance(deco, ast.Call)
                          and full == "functools.partial" and deco.args
                          and self.resolve(deco.args[0]) in TRACE_WRAPPERS):
                        traced.add(node)

        # Close over (a) names marked at wrapper call sites, (b) nested
        # defs inside traced bodies, (c) module-local calls from traced
        # bodies — everything a trace reaches within this module.
        changed = True
        while changed:
            changed = False
            for name in list(pending_names):
                for fn in self.funcs_by_name.get(name, ()):
                    if fn not in traced:
                        traced.add(fn)
                        changed = True
            pending_names.clear()
            for fn in list(traced):
                for sub in ast.walk(fn):
                    if sub is fn:
                        continue
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda)):
                        if sub not in traced:
                            traced.add(sub)
                            changed = True
                    elif (isinstance(sub, ast.Call)
                          and isinstance(sub.func, ast.Name)
                          and sub.func.id in self.funcs_by_name):
                        for g in self.funcs_by_name[sub.func.id]:
                            if g not in traced:
                                traced.add(g)
                                changed = True
        return traced

    def enclosing_function(self, node):
        """Nearest enclosing FunctionDef/Lambda, or None at module level."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def in_traced_scope(self, node) -> bool:
        """Inside a hot scope: a function that runs as the step, or the
        body of a capture block."""
        fn = self.enclosing_function(node)
        while fn is not None:
            if fn in self.traced:
                return True
            fn = self.enclosing_function(fn)
        cur = self.parents.get(node)
        while cur is not None:
            if cur in self.capture_blocks:
                return any(self._within(node, sub) for sub in cur.body)
            cur = self.parents.get(cur)
        return False

    def _within(self, node, root) -> bool:
        cur = node
        while cur is not None:
            if cur is root:
                return True
            cur = self.parents.get(cur)
        return False

    def in_loop(self, node) -> bool:
        """Inside a Python for/while body (within the same function)."""
        cur = self.parents.get(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                      ast.Module)):
            if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
                return True
            cur = self.parents.get(cur)
        return False


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def lint_source(source: str, path: str = "<string>",
                select: Optional[Sequence[str]] = None
                ) -> Tuple[List[Finding], List[Finding]]:
    """Lint one source string -> (findings, waived findings)."""
    _ensure_rules_loaded()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        f = Finding(path, e.lineno or 1, "E0",
                    f"syntax error: {e.msg}")
        return [f], []
    ctx = ModuleContext(path, source, tree)
    rules = [RULES[r] for r in (select or sorted(RULES))]
    raw: List[Finding] = []
    for spec in rules:
        for line, msg in spec.check(ctx):
            raw.append(Finding(path, line, spec.rule_id, msg))
    per_line, file_level = parse_waivers(source)
    findings = [f for f in raw if not _waived(f, per_line, file_level)]
    waived = [f for f in raw if _waived(f, per_line, file_level)]
    findings.sort(key=lambda f: (f.line, f.rule))
    return findings, waived


def lint_file(path: str, select: Optional[Sequence[str]] = None
              ) -> Tuple[List[Finding], List[Finding]]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path, select=select)


def iter_python_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_paths(paths: Iterable[str],
               select: Optional[Sequence[str]] = None
               ) -> Tuple[List[Finding], List[Finding]]:
    """Lint files/directories -> (findings, waived), both sorted."""
    findings: List[Finding] = []
    waived: List[Finding] = []
    for f in iter_python_files(paths):
        got, w = lint_file(f, select=select)
        findings.extend(got)
        waived.extend(w)
    return findings, waived


def findings_to_json(findings: Sequence[Finding],
                     waived: Sequence[Finding]) -> str:
    return json.dumps(
        {"findings": [f.to_json() for f in findings],
         "waived": [f.to_json() for f in waived],
         "count": len(findings)},
        indent=2, sort_keys=True)

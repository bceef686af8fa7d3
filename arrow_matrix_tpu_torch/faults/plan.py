"""Deterministic, seeded fault plans and the injection hooks.

The port's copy of ``arrow_matrix_tpu/faults/plan.py``: the same plan
JSON (in ``AMT_FAULT_PLAN``, as a JSON object or a path to one) drives
either package.  Example::

    AMT_FAULT_PLAN='{"scenario": "hang", "site": "*.step",
                     "after": 2, "hang_s": 1.0}'

Fields:

``scenario``
    ``hang``  — sleep ``hang_s`` seconds at the hook (past a
    supervisor watchdog, a stalled step);
    ``kill``  — ``SIGKILL`` this process mid-iteration (recovery is a
    checkpoint resume in the next process);
    ``error`` — raise :class:`FaultInjected` (a generic transient);
    ``nan``   — poison ``burst`` seeded positions of the carried X with
    NaN (the silent-corruption scenario);
    ``corrupt`` — raise the artifact-integrity error at an I/O hook.

``site``
    fnmatch pattern against hook sites.  The port has two:
    ``multi_level.step`` (``MultiLevelArrow.step``) and
    ``io.load_decomposition``; ``*.step`` matches every step hook.

``after`` / ``count``
    Fire on the ``after``-th matching hit (0-based, counted per site
    and per process) and keep firing for ``count`` hits (default 1).

``seed`` / ``burst``
    The NaN scenario draws ``burst`` flat positions from
    ``numpy.random.default_rng(seed)``.

``target``
    Substring filter on the hook's target (I/O hooks pass the path);
    empty matches everything.

With no plan set every hook is one ``None`` check.  A hook never writes
into the tensor it is given: ``nan`` clones it first, because the
supervisor keeps the step's input for a rollback.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import signal
import time
from typing import Any, Dict, Optional

ENV_VAR = "AMT_FAULT_PLAN"

SCENARIOS = ("hang", "kill", "error", "nan", "corrupt")


class FaultInjected(RuntimeError):
    """A fault deliberately raised by the active plan (scenario
    ``error`` / ``corrupt``) — the supervisor treats it like any other
    transient runtime failure."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One parsed fault plan (see module docstring for field
    semantics)."""

    scenario: str
    site: str = "*"
    after: int = 0
    count: int = 1
    hang_s: float = 1.0
    burst: int = 4
    seed: int = 0
    target: str = ""

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FaultPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(f"unknown fault-plan field(s) {unknown}; "
                             f"known: {sorted(known)}")
        plan = cls(**obj)
        if plan.scenario not in SCENARIOS:
            raise ValueError(f"unknown fault scenario "
                             f"{plan.scenario!r}; one of {SCENARIOS}")
        return plan


def parse_plan(spec: str) -> FaultPlan:
    """Parse a plan from a JSON string or a path to a JSON file."""
    text = spec.strip()
    if not text.startswith("{"):
        with open(text, encoding="utf-8") as fh:
            text = fh.read()
    return FaultPlan.from_json(json.loads(text))


# -- module state -----------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_HITS: Dict[str, int] = {}
_FIRED = 0


def _load_env() -> Optional[FaultPlan]:
    spec = os.environ.get(ENV_VAR)
    return parse_plan(spec) if spec else None


def set_plan(plan) -> None:
    """Install a plan (FaultPlan, plan dict, or None) and reset hit
    counters — the in-process test entry point."""
    global _PLAN, _FIRED
    if isinstance(plan, dict):
        plan = FaultPlan.from_json(plan)
    _PLAN = plan
    _HITS.clear()
    _FIRED = 0


def clear_plan() -> None:
    set_plan(None)


def reload_plan() -> Optional[FaultPlan]:
    """Re-read ``AMT_FAULT_PLAN`` (tests mutate the env mid-process;
    CLI subprocesses get the env read at import time)."""
    set_plan(_load_env())
    return _PLAN


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


# Env is read once at import: a CLI subprocess launched with
# AMT_FAULT_PLAN set is armed before any hook can run.
set_plan(_load_env())


# -- firing -----------------------------------------------------------------


def _matches(site: str, target: Optional[str]) -> bool:
    if _PLAN is None or not fnmatch.fnmatch(site, _PLAN.site):
        return False
    if _PLAN.target and (target is None or _PLAN.target not in target):
        return False
    return True


def _should_fire(site: str) -> bool:
    """Count this matching hit and decide whether the plan fires on it
    (hit counting is per site, so ``*.step`` plans are insensitive to
    how many OTHER hooks the run passes through)."""
    global _FIRED
    hit = _HITS.get(site, 0)
    _HITS[site] = hit + 1
    if _PLAN.after <= hit < _PLAN.after + _PLAN.count:
        _FIRED += 1
        return True
    return False


def _flight_event(site: str, **data) -> None:
    # obs.flight.record is a no-op until a recorder is installed; the
    # import is deferred so plan.py stays stdlib-only on the fast path.
    from arrow_matrix_tpu_torch.obs import flight

    flight.record("fault", f"injected:{_PLAN.scenario}", site=site,
                  **data)


def inject(site: str, target: Optional[str] = None) -> None:
    """The generic injection hook: no-op without a matching armed plan;
    otherwise sleep (hang), die (kill), or raise (error / corrupt)."""
    if _PLAN is None:   # the always-taken production branch
        return
    if not _matches(site, target) or not _should_fire(site):
        return
    scenario = _PLAN.scenario
    _flight_event(site, target=target)
    if scenario == "hang":
        time.sleep(_PLAN.hang_s)
    elif scenario == "kill":
        # Flush anything buffered first: the whole point of the kill
        # scenario is proving the blackbox + checkpoint survive it.
        from arrow_matrix_tpu_torch.obs import flight

        rec = flight.get_recorder()
        if rec is not None:
            rec.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    elif scenario == "corrupt":
        raise FaultInjected(
            f"injected corrupt-artifact fault at {site} "
            f"(target={target!r})")
    elif scenario == "error":
        raise FaultInjected(f"injected transient fault at {site}")
    # scenario "nan" is array-valued and only meaningful at on_step
    # hooks; at a generic site a matching nan plan burns its hit
    # harmlessly (the plan author picked the wrong site).


def on_step(site: str, x):
    """Executor-step hook: like :func:`inject`, but scenario ``nan``
    poisons and returns a copy of the carried feature tensor ``x`` (the
    input is never written: the supervisor keeps it for rollback)."""
    if _PLAN is None:   # the always-taken production branch
        return x
    if not _matches(site, None) or not _should_fire(site):
        return x
    if _PLAN.scenario != "nan":
        # Re-credit the hit consumed above and let the scalar hook
        # re-consume it so hang/kill/error fire identically at step
        # sites.
        _HITS[site] -= 1
        inject(site)
        return x
    _flight_event(site, burst=_PLAN.burst)
    import numpy as np

    rng = np.random.default_rng(_PLAN.seed)
    size = 1
    for d in x.shape:
        size *= int(d)
    flat = rng.integers(0, max(size, 1),
                        size=min(_PLAN.burst, max(size, 1)))
    x = x.clone()
    for i in sorted(set(int(v) for v in flat)):
        x[np.unravel_index(i, tuple(x.shape))] = float("nan")
    return x

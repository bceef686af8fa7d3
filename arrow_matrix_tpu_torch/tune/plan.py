"""Versioned, persisted tuning plans.

The port's copy of ``arrow_matrix_tpu/tune/plan.py``.  A
:class:`TunePlan` is one planned configuration of the fold executor for
one (structure, k): format and tier split, kernel, chunking, carriage,
overlap S, replication c, and K1's launch knobs (``chunk_slots``,
``batch``, ``ctas_per_sm``, a per-tier ``schedule``)
in place of the reference's TPU knobs (``row_block``, ``wave``,
``ring``, ``smem_cols_budget``), with the provenance that justifies it
(measured ms against the default, margin, bit identity, host load,
evaluator) and ``backend``, which names the kernels the knobs are for.

Plans persist as one JSON file per structure hash in the port's own
directory, ``bench_results/tune_plans_torch/`` (gitignored; override
``AMT_TUNE_PLAN_DIR``), with one entry per feature width::

    {"version": 1, "structure_hash": "...", "fingerprint": {...},
     "context": {...}, "plans": {"16": {...}, "128": {...}}}

Consumption (``MultiLevelArrow(plan="auto")``, ``serve/scheduler.
ArrowServer(tune_plan=)``): a hit applies the knobs at no search cost;
a miss, a version skew, or a plan of another backend (a file the JAX
package wrote: the same structure hash, TPU knobs) warns
:class:`TunePlanMiss` and the caller runs its defaults, loudly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional

from arrow_matrix_tpu_torch.utils.artifacts import (
    atomic_write_json,
    locked_file,
)

#: Bump when the plan schema or a knob's meaning changes.
PLAN_VERSION = 1

#: The backend the port's plans are for: K1-K4 on sm_90.
BACKEND = "cuda-sm90"

DEFAULT_PLAN_DIR = os.path.join("bench_results", "tune_plans_torch")


class TunePlanMiss(UserWarning):
    """Warned when ``plan="auto"`` finds no plan the port can apply (no
    file, no entry for the k, version skew, another backend's knobs):
    the executor proceeds on its defaults, loudly."""


def plan_dir(override: Optional[str] = None) -> str:
    """The plan cache: explicit override, else ``AMT_TUNE_PLAN_DIR``,
    else ``bench_results/tune_plans_torch``."""
    if override:
        return override
    return os.environ.get("AMT_TUNE_PLAN_DIR", DEFAULT_PLAN_DIR)


def plan_path(structure_hash: str, directory: Optional[str] = None) -> str:
    return os.path.join(plan_dir(directory), f"{structure_hash}.json")


@dataclass(frozen=True)
class TunePlan:
    """One planned configuration for one (structure, k)."""

    structure_hash: str
    k: int
    version: int = PLAN_VERSION
    #: The kernels the knobs are for; None marks a plan of unknown
    #: origin (a dict without the key, as the JAX package writes them).
    backend: Optional[str] = BACKEND

    # -- knobs (executor build arguments)
    fmt: str = "fold"
    kernel: str = "xla"
    chunk: Any = "auto"
    fold_growth: float = 1.2
    fold_align: Optional[int] = None       # None -> ops/ell.SLOT_ALIGN
    feature_dtype: Optional[str] = None    # None -> f32 carriage
    overlap_slabs: int = 1
    repl: int = 1

    # -- knobs (K1's launch, ops/worklist.py:LaunchOpts)
    chunk_slots: int = 128
    batch: Optional[int] = None            # None -> the carriage's default
    ctas_per_sm: int = 2
    #: A per-tier schedule (``tune/synth.synthesize_schedule``): entries
    #: override the uniform knobs for the tiers they name.
    schedule: Optional[list] = None

    # -- provenance
    candidate: str = "default"
    measured_ms: Optional[float] = None
    default_ms: Optional[float] = None
    margin: Optional[float] = None          # (default - measured)/default
    bit_identical: Optional[bool] = None
    host_load: Optional[Any] = None
    platform: Optional[str] = None
    evaluator: Optional[str] = None         # "cpu-plain" or the card's name
    created_unix: Optional[float] = None

    # -- accuracy class: "exact" plans win on bit identity, "approx"
    # plans on the class tolerance, with their certificate.
    traffic_class: str = "exact"
    certificate: Optional[dict] = None

    def build_kwargs(self) -> Dict[str, Any]:
        """Executor construction overrides (``MultiLevelArrow``
        argument names)."""
        return {"fmt": self.fmt, "kernel": self.kernel, "chunk": self.chunk,
                "fold_growth": self.fold_growth,
                "fold_align": self.fold_align,
                "feature_dtype": self.feature_dtype,
                "overlap_slabs": self.overlap_slabs, "repl": self.repl}

    def kernel_opts(self) -> Dict[str, Any]:
        """K1's launch knobs, as ``MultiLevelArrow(kernel_opts=)`` takes
        them."""
        opts: Dict[str, Any] = {"chunk_slots": self.chunk_slots,
                                "batch": self.batch,
                                "ctas_per_sm": self.ctas_per_sm}
        if self.schedule is not None:
            opts["schedule"] = [dict(e) for e in self.schedule]
        return opts

    def exec_config(self):
        """The serving rung of this plan; the degradation ladder
        (``serve/scheduler.degradation_ladder``) steps its knobs down."""
        from arrow_matrix_tpu_torch.serve.scheduler import ExecConfig

        return ExecConfig(kernel=self.kernel, repl=self.repl,
                          overlap_slabs=self.overlap_slabs,
                          feature_dtype=self.feature_dtype)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunePlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw.setdefault("backend", None)
        return cls(**kw)


def foreign_knobs(d: dict) -> list:
    """The reference's TPU knobs a plan dict carries."""
    from arrow_matrix_tpu_torch.ops.cuda_sell import TPU_KNOBS

    return sorted(k for k in TPU_KNOBS if k in d)


def _backend_miss(d: dict) -> Optional[str]:
    """Why the port cannot apply plan dict ``d``, or None."""
    if d.get("backend") == BACKEND:
        return None
    tpu = foreign_knobs(d)
    return (f"the plan is for backend {d.get('backend')!r}, not "
            f"{BACKEND!r}" + (f" (it carries the JAX package's TPU knobs "
                              f"{tpu})" if tpu else ""))


def load_plan_file(structure_hash: str,
                   directory: Optional[str] = None) -> Optional[dict]:
    """The raw plan file of a structure hash, or None when absent or
    unreadable (the caller warns)."""
    try:
        with open(plan_path(structure_hash, directory),
                  encoding="utf-8") as fh:
            d = json.load(fh)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    return d if isinstance(d, dict) else None


def load_plan(structure_hash: str, k: Optional[int] = None,
              directory: Optional[str] = None,
              quiet: bool = False) -> Optional[TunePlan]:
    """The cached plan of ``(structure_hash, k)``; ``k=None`` takes the
    largest k.  A miss (no file, version skew, no entry for k, another
    backend's plan) warns :class:`TunePlanMiss` unless ``quiet`` and
    returns None."""
    def _miss(why: str) -> None:
        if not quiet:
            warnings.warn(
                f"tune plan miss for {structure_hash}: {why}; running the "
                f"built-in defaults (run `graft_tune search` to populate "
                f"the cache)", TunePlanMiss, stacklevel=3)

    d = load_plan_file(structure_hash, directory)
    if d is None:
        _miss(f"no plan file in {plan_dir(directory)!r}")
        return None
    if int(d.get("version", -1)) != PLAN_VERSION:
        _miss(f"version skew (file v{d.get('version')}, runtime "
              f"v{PLAN_VERSION})")
        return None
    plans = d.get("plans") or {}
    if not plans:
        _miss("plan file has no entries")
        return None
    key = (max(plans, key=int) if k is None else str(int(k)))
    if key not in plans:
        _miss(f"no entry for k={k} (cached k: "
              f"{sorted(int(s) for s in plans)})")
        return None
    entry = dict(plans[key])
    if int(entry.get("version", -1)) != PLAN_VERSION:
        _miss(f"entry version skew for k={key}")
        return None
    why = _backend_miss(entry)
    if why is not None:
        _miss(why)
        return None
    return TunePlan.from_dict(entry)


def save_plans(structure_hash: str, plans: Dict[int, TunePlan],
               fingerprint: Optional[dict] = None,
               directory: Optional[str] = None,
               context: Optional[dict] = None) -> str:
    """Merge ``plans`` (one per k) into the structure's plan file,
    atomically, under the file's lock; returns the path.  Entries for
    other k of this backend are kept; another backend's are dropped."""
    d = plan_dir(directory)
    os.makedirs(d, exist_ok=True)
    path = plan_path(structure_hash, directory)
    with locked_file(path):
        existing = load_plan_file(structure_hash, directory)
        merged: Dict[str, dict] = {}
        if existing and int(existing.get("version", -1)) == PLAN_VERSION:
            merged.update({k: v for k, v in
                           (existing.get("plans") or {}).items()
                           if _backend_miss(v) is None})
        for k, p in plans.items():
            merged[str(int(k))] = p.to_dict()
        atomic_write_json(path, {
            "version": PLAN_VERSION, "structure_hash": structure_hash,
            "fingerprint": fingerprint, "context": context,
            "plans": merged}, indent=2, sort_keys=True)
    return path


def resolve_plan(plan, *, levels=None, width: Optional[int] = None,
                 dtype=None, growth: float = 1.2,
                 slot_align: Optional[int] = None, binary="auto",
                 plan_k: Optional[int] = None,
                 directory: Optional[str] = None) -> Optional[TunePlan]:
    """An executor's ``plan=`` as a :class:`TunePlan`, or None (the
    defaults, after a loud miss).  Takes a TunePlan, a plan dict
    (``TunePlan.to_dict``) or ``"auto"``: hash the levels and look the
    plan up in the cache."""
    if plan is None:
        return None
    if isinstance(plan, TunePlan):
        if int(plan.version) != PLAN_VERSION:
            warnings.warn(f"tune plan version skew (plan v{plan.version}, "
                          f"runtime v{PLAN_VERSION}); ignoring the plan",
                          TunePlanMiss, stacklevel=2)
            return None
        why = _backend_miss(plan.to_dict())
        if why is not None:
            warnings.warn(f"tune plan {plan.structure_hash}: {why}; "
                          f"ignoring the plan", TunePlanMiss, stacklevel=2)
            return None
        return plan
    if isinstance(plan, dict):
        why = _backend_miss(plan)
        if why is not None:
            warnings.warn(f"tune plan {plan.get('structure_hash')}: {why}; "
                          f"ignoring the plan", TunePlanMiss, stacklevel=2)
            return None
        return resolve_plan(TunePlan.from_dict(plan), plan_k=plan_k,
                            directory=directory)
    if plan == "auto":
        if levels is None or width is None:
            raise ValueError("plan='auto' needs the levels and width to hash")
        import numpy as np

        from arrow_matrix_tpu_torch.tune.fingerprint import structure_hash

        h = structure_hash(levels, width,
                           dtype=np.float32 if dtype is None else dtype,
                           growth=growth, slot_align=slot_align,
                           binary=binary)
        return load_plan(h, plan_k, directory)
    raise ValueError(f"unknown plan {plan!r} (expected 'auto', a TunePlan, "
                     f"a plan dict, or None)")

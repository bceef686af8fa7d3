"""Plan-cache gate checks: the port's copy of
``arrow_matrix_tpu/tune/gate.py`` (wrapped by the port's
``tools/tune_gate.py`` and ``graft_tune check``).

A cached plan is a *promise* — "this configuration was bit-identical
to the golden and at least as fast as the default on this structure".
The gate replays the promise and exits nonzero when it no longer
holds:

* **hash integrity** — re-fingerprinting the plan's recorded source
  must reproduce the file's structure hash (catches fingerprint
  drift, artifact edits, and version skew);
* **cache purity** — a ``search()`` on the unchanged structure must
  be a pure cache hit with ZERO bench children spawned;
* **bit-identity replay** — the tuned executor's f32 output must
  still equal the golden, the default fold (K1 on the card), bit for
  bit;
* **no regression** — the tuned configuration must not be more than
  ``rel_tol`` (default 5%) slower than the default on a
  min-of-``repeats`` replay, with a small absolute slack so
  sub-millisecond CPU timing noise cannot fail a healthy plan.

``--refresh`` re-searches (``search(refresh=True)``) before checking.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from arrow_matrix_tpu_torch.tune.fingerprint import (
    fingerprint_hash,
    structure_fingerprint,
)
from arrow_matrix_tpu_torch.tune.plan import (
    PLAN_VERSION,
    TunePlan,
    load_plan_file,
    plan_dir,
)
from arrow_matrix_tpu_torch.tune.search import (
    GOLDEN_SEED,
    _build_executor,
    load_levels_from_source,
    search,
)
from arrow_matrix_tpu_torch.tune.space import Candidate


def _measure_min(multi, x, iters: int, repeats: int) -> float:
    from arrow_matrix_tpu_torch.utils.timing import chained_iteration_ms

    return min(chained_iteration_ms(multi.run, x, iters)
               for _ in range(max(repeats, 1)))


def check_structure(source: dict, *, directory: Optional[str] = None,
                    iters: int = 3, repeats: int = 3,
                    rel_tol: float = 0.05, abs_tol_ms: float = 0.25,
                    refresh: bool = False, timing: bool = True,
                    device=None, quiet: bool = False) -> dict:
    """Run every gate check for one structure's plan file, on
    ``device`` (the card unless ``"cpu"``).

    Returns ``{"ok", "structure_hash", "failures": [...],
    "checks": [...]}`` — ``failures`` is empty iff the plan's promise
    still holds for every cached k.
    """
    from arrow_matrix_tpu_torch.utils.graphs import random_dense

    failures: List[str] = []
    checks: List[str] = []

    def say(msg: str) -> None:
        if not quiet:
            print(f"[tune-gate] {msg}", file=sys.stderr, flush=True)

    levels, width = load_levels_from_source(source)
    fp = structure_fingerprint(levels, width)
    h = fingerprint_hash(fp)
    say(f"structure {h}")

    record = load_plan_file(h, directory)
    if record is None:
        return {"ok": False, "structure_hash": h,
                "failures": [f"no plan file for {h} in "
                             f"{plan_dir(directory)!r}"],
                "checks": checks}
    if record.get("structure_hash") != h:
        failures.append(
            f"hash drift: file says {record.get('structure_hash')}, "
            f"re-fingerprint says {h}")
    if int(record.get("version", -1)) != PLAN_VERSION:
        failures.append(f"version skew: file v{record.get('version')} "
                        f"vs runtime v{PLAN_VERSION}")
    if failures:
        return {"ok": False, "structure_hash": h,
                "failures": failures, "checks": checks}
    checks.append("hash+version")

    ks = sorted(int(s) for s in (record.get("plans") or {}))
    if not ks:
        return {"ok": False, "structure_hash": h,
                "failures": ["plan file has no entries"],
                "checks": checks}

    if refresh:
        for k in ks:
            say(f"refresh: re-searching k={k}")
            p, rep = search(source, k, iters=iters, plan_dir=directory,
                            refresh=True, device=device, quiet=quiet)
            if p is None:
                failures.append(f"refresh search failed for k={k}: "
                                f"{rep.get('error')}")
        if failures:
            return {"ok": False, "structure_hash": h,
                    "failures": failures, "checks": checks}
        record = load_plan_file(h, directory)
        checks.append("refresh")

    default_multi = _build_executor(levels, width, Candidate("default"),
                                    device)
    for k in ks:
        plan = TunePlan.from_dict(record["plans"][str(k)])

        # Cache purity: an unchanged structure must hit, spawning
        # nothing.
        _, rep = search(source, k, plan_dir=directory, device=device,
                        quiet=True)
        if not rep.get("cache_hit") or rep.get("children_spawned"):
            failures.append(
                f"k={k}: second search was not a pure cache hit "
                f"(cache_hit={rep.get('cache_hit')}, "
                f"children={rep.get('children_spawned')})")
        else:
            checks.append(f"k={k}:cache-purity")

        # Bit-identity replay vs the golden default fold.
        x_host = random_dense(fp["n"], k, seed=GOLDEN_SEED)
        xd = default_multi.set_features(x_host)
        golden = np.asarray(
            default_multi.gather_result(default_multi.step(xd)),
            dtype=np.float32)
        tuned = _build_executor(
            levels, width,
            Candidate(plan.candidate, build=plan.build_kwargs(),
                      kernel_opts=plan.kernel_opts()), device)
        xt = tuned.set_features(x_host)
        mine = np.asarray(tuned.gather_result(tuned.step(xt)),
                          dtype=np.float32)
        if plan.bit_identical and not np.array_equal(mine, golden):
            failures.append(f"k={k}: plan {plan.candidate!r} lost "
                            f"bit-identity vs the golden default fold")
        else:
            checks.append(f"k={k}:bit-identity")

        # Regression replay: min-of-N, relative + absolute slack.
        if timing:
            d_ms = _measure_min(default_multi, xd, iters, repeats)
            t_ms = _measure_min(tuned, xt, iters, repeats)
            limit = d_ms * (1.0 + rel_tol) + abs_tol_ms
            say(f"k={k}: tuned {t_ms:.3f} ms vs default {d_ms:.3f} ms "
                f"(limit {limit:.3f})")
            if t_ms > limit:
                failures.append(
                    f"k={k}: tuned plan regressed: {t_ms:.3f} ms vs "
                    f"default {d_ms:.3f} ms (>{rel_tol:.0%} + "
                    f"{abs_tol_ms} ms slack)")
            else:
                checks.append(f"k={k}:no-regression")

    return {"ok": not failures, "structure_hash": h,
            "failures": failures, "checks": checks}


def gate_sources(directory: Optional[str] = None) -> Dict[str, dict]:
    """Every checkable plan file in the cache: hash -> recorded
    source (plans whose file carries no ``context.source`` cannot be
    replayed and are reported as failures by ``run_gate``)."""
    out: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(plan_dir(directory),
                                              "*.json"))):
        h = os.path.splitext(os.path.basename(path))[0]
        record = load_plan_file(h, directory)
        src = ((record or {}).get("context") or {}).get("source")
        out[h] = src
    return out


def run_gate(*, directory: Optional[str] = None,
             hashes: Optional[List[str]] = None,
             iters: int = 3, repeats: int = 3, rel_tol: float = 0.05,
             abs_tol_ms: float = 0.25, refresh: bool = False,
             timing: bool = True, device=None, quiet: bool = False) -> int:
    """Gate every (or the selected) cached plan; returns the process
    exit code (0 = every promise holds)."""
    sources = gate_sources(directory)
    if hashes:
        sources = {h: sources.get(h) for h in hashes}
    if not sources:
        print(f"tune-gate: no plan files in {plan_dir(directory)!r}",
              file=sys.stderr)
        return 1
    rc = 0
    for h, src in sources.items():
        if src is None:
            print(f"tune-gate FAIL {h}: plan file missing or has no "
                  f"replayable context.source", file=sys.stderr)
            rc = 1
            continue
        try:
            res = check_structure(src, directory=directory,
                                  iters=iters, repeats=repeats,
                                  rel_tol=rel_tol,
                                  abs_tol_ms=abs_tol_ms,
                                  refresh=refresh, timing=timing,
                                  device=device, quiet=quiet)
        except Exception as e:  # noqa: BLE001 — one structure's
            # missing/corrupt artifacts must not mask the others.
            print(f"tune-gate FAIL {h}: source not replayable: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            rc = 1
            continue
        if res["ok"]:
            print(f"tune-gate OK {h}: {', '.join(res['checks'])}")
        else:
            rc = 1
            for f in res["failures"]:
                print(f"tune-gate FAIL {h}: {f}", file=sys.stderr)
    return rc

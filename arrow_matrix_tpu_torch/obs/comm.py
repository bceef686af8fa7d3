"""Communication accounting against the paper's cost model, and the
device's HBM budget for planning and admission.

The port of ``arrow_matrix_tpu/obs/comm.py``: ``hbm_budget_bytes``,
``repl_predict_ms`` (the tuner's cost screen), ``exposed_comm_ms``,
``ideal_bytes_for``, ``reduce_bytes_for``, the replication planner
``auto_repl``, and ``account_collectives``, which reads one step's
collectives from ``utils/commstats`` (the port's collective layer
counts what it issues; the JAX package reads HLO text) and sets the
measured bytes beside the executor's ideal.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device


def hbm_budget_bytes(default: Optional[int] = None,
                     device: DeviceLike = None) -> int:
    """Per-device HBM budget: ``AMT_HBM_GB`` (GiB) when set, else
    ``default``, else the device's own budget
    (``utils/platform.device_memory_budget``: half its free memory).
    ``device=None`` is the card (raises without one)."""
    env = os.environ.get("AMT_HBM_GB")
    if env:
        return int(float(env) * 2**30)
    if default is not None:
        return int(default)
    from arrow_matrix_tpu_torch.utils.platform import device_memory_budget

    return int(device_memory_budget(resolve_device(device)))


#: Link rate of the step-time model (the JAX package's constant,
#: ``AMT_LINK_GBPS`` overrides it): a modeled rate that compares
#: candidates and overlap settings with each other, not a measurement.
LINK_BYTES_PER_S = float(os.environ.get("AMT_LINK_GBPS", "45")) * 1e9


def repl_predict_ms(c: int, exchange_bytes: int, n_coll: int = 0,
                    compute_ms: float = 0.0, reduce_bytes: int = 0,
                    iterations: int = 1,
                    link_bytes_per_s: Optional[float] = None,
                    latency_s: float = 1e-6) -> float:
    """The reference's c-parameterized step-time model of the 2.5D
    scheme, ``T(c) = compute + bytes/(c*bw) + n_coll*lat + reduce(c)/bw``
    (``exchange_bytes``/``n_coll`` describe the c=1 step; the merge's
    ``reduce_bytes`` is paid once per gather over ``iterations``): the
    tuner's 3x cost screen."""
    bw = LINK_BYTES_PER_S if link_bytes_per_s is None else link_bytes_per_s
    c = max(int(c), 1)
    wire_s = float(exchange_bytes) / (c * bw)
    lat_s = float(n_coll) * latency_s
    reduce_s = 0.0
    if c > 1 and reduce_bytes:
        reduce_s = float(reduce_bytes) / bw / max(int(iterations), 1)
    return compute_ms + (wire_s + lat_s + reduce_s) * 1e3


def exposed_comm_ms(measured_bytes: int, overlap_slabs: int = 1,
                    link_bytes_per_s: Optional[float] = None) -> float:
    """Modeled milliseconds of collective time a step leaves exposed:
    ``measured_bytes / link_bw`` over the overlap schedule's S slabs
    (only the first slab's exchange cannot hide under compute)."""
    bw = LINK_BYTES_PER_S if link_bytes_per_s is None else link_bytes_per_s
    s = max(int(overlap_slabs), 1)
    return (float(measured_bytes) / bw) * 1e3 / s


def ideal_bytes_for(obj, k: int, itemsize: int = 4) -> Optional[int]:
    """The executor's own paper-model byte count for one iteration at
    feature width ``k``, or None when it has no model."""
    fn = getattr(obj, "ideal_comm_bytes", None)
    if fn is None:
        return None
    return int(fn(k, itemsize=itemsize))


def reduce_bytes_for(obj, k: int, itemsize: int = 4) -> int:
    """Per-device bytes of the 2.5D final merge (paid at gather time),
    from the executor's ``reduce_comm_bytes``; 0 without one."""
    fn = getattr(obj, "reduce_comm_bytes", None)
    if fn is None:
        return 0
    return int(fn(k, itemsize=itemsize))


def auto_repl(n_dev: int, k: int, base_hbm_bytes: int,
              budget_bytes: Optional[int] = None,
              choices=(1, 2, 4), exchange_bytes: int = 0,
              n_coll: int = 0, compute_ms: float = 0.0,
              reduce_bytes: int = 0, iterations: int = 1,
              link_bytes_per_s: Optional[float] = None,
              latency_s: float = 1e-6, quiet: bool = False,
              device: DeviceLike = None) -> Dict[str, Any]:
    """Model-driven replication factor (the JAX planner): a c that
    divides the device count and k and whose ``base_hbm_bytes * c`` fits
    the budget (``hbm_budget_bytes(budget_bytes, device)``) is feasible;
    the feasible c of least :func:`repl_predict_ms` wins, ties to the
    smaller; when the budget rejects every c > 1 the plan degrades to
    c = 1 loudly (stderr and ``"degraded": True``)."""
    budget = hbm_budget_bytes(budget_bytes, device=device)
    feasible, rejected = [], {}
    budget_rejected = False
    for c in sorted(set(int(c) for c in choices)):
        if c < 1:
            rejected[c] = "c must be >= 1"
            continue
        if n_dev % c:
            rejected[c] = f"does not divide n_dev={n_dev}"
            continue
        if k % c:
            rejected[c] = f"does not divide feature width k={k}"
            continue
        need = base_hbm_bytes * c
        if need > budget:
            rejected[c] = (f"predicted {need} B exceeds HBM budget "
                           f"{budget} B")
            budget_rejected = True
            continue
        feasible.append(c)
    if 1 not in feasible:
        feasible.insert(0, 1)
        rejected.pop(1, None)
    predicted = {
        c: repl_predict_ms(c, exchange_bytes, n_coll=n_coll,
                           compute_ms=compute_ms,
                           reduce_bytes=reduce_bytes,
                           iterations=iterations,
                           link_bytes_per_s=link_bytes_per_s,
                           latency_s=latency_s)
        for c in feasible
    }
    best = min(feasible, key=lambda c: (predicted[c], c))
    degraded = best == 1 and budget_rejected
    if degraded and not quiet:
        import sys

        print(f"[graft-repl] auto replication DEGRADED to c=1: the "
              f"HBM predictor rejected every c>1 "
              f"({ {c: r for c, r in rejected.items() if c > 1} }) "
              f"against budget {budget / 2**30:.2f} GiB "
              f"(base footprint {base_hbm_bytes / 2**30:.3f} GiB; "
              f"set AMT_HBM_GB to raise)", file=sys.stderr)
    return {"c": best, "feasible": feasible, "rejected": rejected,
            "predicted_ms": predicted, "budget_bytes": budget,
            "base_hbm_bytes": int(base_hbm_bytes), "degraded": degraded}


def account_collectives(algorithm: str, fn, *args,
                        ideal_bytes: Optional[int] = None,
                        overlap_slabs: int = 1, repl: int = 1,
                        reduce_bytes: Optional[int] = None,
                        registry=None, **kwargs) -> Dict[str, Any]:
    """Account one call of a step ``fn(*args, **kwargs)``: run it once
    with the collective counts at 0 (``utils/commstats.collective_stats``)
    and set this rank's wire bytes beside the ideal.  Returns the JAX
    function's record (``algorithm``, ``collectives``,
    ``measured_bytes``, ``ideal_bytes``, ``ratio``, ``source``
    ("counted"), ``overlap_slabs``, ``exposed_comm_ms``, ``repl``,
    ``reduce_bytes``) plus ``host_staged_bytes``; with a ``registry``
    the same gauges."""
    from arrow_matrix_tpu_torch.utils import commstats

    stats = commstats.collective_stats(fn, *args, **kwargs)
    measured = int(stats["total_bytes"])
    ratio = measured / ideal_bytes if ideal_bytes else None
    exposed_ms = exposed_comm_ms(measured, overlap_slabs)
    if registry is not None:
        registry.gauge("comm_measured_bytes", algorithm=algorithm).set(
            measured)
        if ideal_bytes is not None:
            registry.gauge("comm_ideal_bytes", algorithm=algorithm).set(
                ideal_bytes)
        if ratio is not None:
            registry.gauge("comm_vs_ideal_ratio", algorithm=algorithm).set(
                ratio)
        registry.gauge("comm_exposed_ms", algorithm=algorithm).set(
            exposed_ms)
        registry.gauge("comm_repl", algorithm=algorithm).set(
            max(int(repl), 1))
        registry.gauge("comm_reduce_bytes", algorithm=algorithm).set(
            int(reduce_bytes or 0))
    return {
        "algorithm": algorithm,
        "collectives": stats,
        "measured_bytes": measured,
        "ideal_bytes": ideal_bytes,
        "ratio": ratio,
        "source": "counted",
        "overlap_slabs": max(int(overlap_slabs), 1),
        "exposed_comm_ms": round(exposed_ms, 6),
        "repl": max(int(repl), 1),
        "reduce_bytes": int(reduce_bytes or 0),
        "host_staged_bytes": int(stats["host_staged_bytes"]),
    }

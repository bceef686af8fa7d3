"""Per-unit load-imbalance accounting from packed format metadata.

The port's copy of ``arrow_matrix_tpu/obs/imbalance.py``.  Arrow
decomposition caps every block at ``width`` columns, so the max/mean
compute ratio over the units is bounded by construction; ELL-family
padding can still inflate a unit's gathered slots well past its
nonzeros.  Three metrics per executor, from the packed arrays'
metadata (degrees, values, slot shapes):

  * ``shard_nnz_max_over_mean``  -- the paper's imbalance bound, on the
    units the executor built;
  * ``shard_rows_max_over_mean`` -- row-count skew;
  * ``padded_slot_waste``        -- the share of gathered slots that are
    padding (K1 walks a weighted row's padded slots; PERF.md).

``MultiLevelArrow.shard_report()`` returns the summary below (tiers
under the fold, block rows for the per-level formats);
``account_imbalance`` records it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from arrow_matrix_tpu_torch.obs import flight


def _max_over_mean(values: Sequence[float]) -> Optional[float]:
    arr = np.asarray(values, dtype=np.float64)
    if arr.size == 0:
        return None
    mean = float(arr.mean())
    if mean <= 0:
        return None
    return float(arr.max()) / mean


def summarize_units(rows, nnz, slots, units: str = "shard"
                    ) -> Dict[str, Any]:
    """Imbalance summary over per-unit (rows, nnz, slots) arrays.

    ``units`` names what one entry is ("device", "block-row", "tier",
    "level-shard"): the finest compute granularity the layout exposes.
    """
    rows = [int(v) for v in np.asarray(rows, dtype=np.int64).ravel()]
    nnz = [int(v) for v in np.asarray(nnz, dtype=np.int64).ravel()]
    slots = [int(v) for v in np.asarray(slots, dtype=np.int64).ravel()]
    slots_total = sum(slots)
    nnz_total = sum(nnz)
    padded = [s - z for s, z in zip(slots, nnz)]
    return {
        "units": units,
        "n_units": len(nnz),
        "rows": rows,
        "nnz": nnz,
        "slots": slots,
        # Realized per-unit padding: the report names which tier pays
        # the waste.
        "padded_slots": padded,
        "padded_slot_waste_per_unit": [
            (p / s if s else None) for p, s in zip(padded, slots)],
        "rows_total": sum(rows),
        "nnz_total": nnz_total,
        "slots_total": slots_total,
        "nnz_max_over_mean": _max_over_mean(nnz),
        "rows_max_over_mean": _max_over_mean(rows),
        "padded_slot_waste": ((slots_total - nnz_total) / slots_total
                              if slots_total else None),
    }


def shard_report_for(obj) -> Optional[Dict[str, Any]]:
    """The executor's own load report, or None when it exposes none
    (as ``obs/memview.predicted_bytes_for``)."""
    fn = getattr(obj, "shard_report", None)
    if fn is None:
        return None
    return fn()


def account_imbalance(algorithm: str, obj,
                      registry=None) -> Optional[Dict[str, Any]]:
    """Record one executor's imbalance metrics (gauges in ``registry``,
    one flight event).

    Returns the shard report (with ``algorithm`` added) or None when
    the object has no ``shard_report``.
    """
    rep = shard_report_for(obj)
    if rep is None:
        return None
    rep = dict(rep, algorithm=algorithm)
    if registry is not None:
        registry.gauge("shard_count", algorithm=algorithm).set(
            rep["n_units"])
        registry.gauge("shard_nnz_total", algorithm=algorithm).set(
            rep["nnz_total"])
        registry.gauge("shard_slots_total", algorithm=algorithm).set(
            rep["slots_total"])
        if rep["nnz_max_over_mean"] is not None:
            registry.gauge("shard_nnz_max_over_mean",
                           algorithm=algorithm).set(
                rep["nnz_max_over_mean"])
        if rep["rows_max_over_mean"] is not None:
            registry.gauge("shard_rows_max_over_mean",
                           algorithm=algorithm).set(
                rep["rows_max_over_mean"])
        if rep["padded_slot_waste"] is not None:
            registry.gauge("padded_slot_waste",
                           algorithm=algorithm).set(
                rep["padded_slot_waste"])
    flight.record("imbalance", algorithm,
                  n_units=rep["n_units"],
                  nnz_max_over_mean=rep["nnz_max_over_mean"],
                  padded_slot_waste=rep["padded_slot_waste"])
    return rep


def format_imbalance_report(rep: Dict[str, Any]) -> str:
    """Human-readable lines for the CLIs' ``--mem_report``."""
    def f(v, spec=".3f"):
        return "n/a" if v is None else format(v, spec)

    return "\n".join([
        f"per-shard load balance ({rep['n_units']} {rep['units']}"
        f" units):",
        f"  nnz   total {rep['nnz_total']}, max/mean "
        f"{f(rep['nnz_max_over_mean'])} (paper imbalance bound)",
        f"  rows  total {rep['rows_total']}, max/mean "
        f"{f(rep['rows_max_over_mean'])}",
        f"  slots total {rep['slots_total']}, padding waste "
        f"{f(rep['padded_slot_waste'])}",
    ])

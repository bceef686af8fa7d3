"""Error-vs-iteration curves against the f32 golden.

The port's copy of ``arrow_matrix_tpu/ledger/probe.py``.  The probe
runs the golden trajectory (the default f32 fold executor stepped
``iterations`` times, gathered to the host after every step), replays
the same seeded input through each probed carriage, and records per
iteration the Frobenius, relative Frobenius and max-abs error against
the golden at that iteration.  Everything is seeded, so the curves are
deterministic and the gate can hold a committed curve as a baseline:
the f32 curve is zero by construction (the same executor and input give
the same bits), so a nonzero f32 point is a bit-identity regression.

Carriages: ``f32``, ``bf16`` and ``int8`` are the fold's real
carriages (on the card all three run K1); ``emulate_int8=True`` keeps
the reference's host-side quantize-dequantize emulation.

Each curve is one ledger record (``kind="error_curve"``, ``metric=
f"error_curve_{dtype}"``, ``value`` the final relative Frobenius error,
the curves in ``payload``) keyed by the structure hash, which the JAX
package computes the same way; ``classes.find_certificate`` reads the
card's own curves back from it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

#: Seed of the probe's input.
DEFAULT_SEED = 3

#: Default probe depth.
DEFAULT_ITERATIONS = 8

PROBE_DTYPES = ("f32", "bf16", "int8")


def _quantize_int8(x: np.ndarray) -> np.ndarray:
    """Symmetric per-tensor int8 round trip: the precision an int8
    carriage would keep between steps."""
    amax = float(np.max(np.abs(x)))
    if amax == 0.0:
        return x.copy()
    scale = amax / 127.0
    q = np.clip(np.round(x / scale), -127, 127)
    return (q * scale).astype(np.float32)


def _build(levels, width: int, feature_dtype: Optional[str], device):
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    return MultiLevelArrow(levels, width, fmt="fold",
                           feature_dtype=feature_dtype, device=device)


def _trajectory(multi, x_host: np.ndarray, iterations: int,
                quantize: bool = False) -> List[np.ndarray]:
    """Host-gathered state after every step; ``quantize`` round-trips
    the state through int8 on the host between steps (the emulated int8
    carriage)."""
    out: List[np.ndarray] = []
    x = multi.set_features(x_host)
    for _ in range(iterations):
        x = multi.step(x)
        host = multi.gather_result(x)
        if quantize:
            host = _quantize_int8(host)
            x = multi.set_features(host)
        out.append(np.asarray(host, dtype=np.float32))
    return out


def error_curve(golden: Sequence[np.ndarray],
                probed: Sequence[np.ndarray]) -> Dict[str, List[float]]:
    """Per-iteration error of ``probed`` against ``golden``: Frobenius,
    relative Frobenius (against the golden's norm) and max-abs, as
    plain float lists."""
    fro: List[float] = []
    rel: List[float] = []
    mab: List[float] = []
    for g, p in zip(golden, probed):
        d = p.astype(np.float64) - g.astype(np.float64)
        f = float(np.linalg.norm(d))
        gn = float(np.linalg.norm(g.astype(np.float64)))
        fro.append(f)
        rel.append(f / gn if gn > 0 else f)
        mab.append(float(np.max(np.abs(d))) if d.size else 0.0)
    return {"frobenius": fro, "rel_frobenius": rel, "max_abs": mab}


def error_curves_for_source(source: Dict[str, Any], *, k: int = 4,
                            iterations: int = DEFAULT_ITERATIONS,
                            seed: int = DEFAULT_SEED,
                            dtypes: Sequence[str] = ("f32", "bf16"),
                            ledger=None,
                            emulate_int8: bool = False,
                            device=None) -> List[Dict[str, Any]]:
    """Probe one structure (a ``tune/search.py`` levels source) at each
    carriage on ``device`` (the card unless ``"cpu"``); returns the
    ledger records (appended to ``ledger`` when one is given, otherwise
    built with ``ts_unix=0`` and pinned provenance, so they are
    deterministic), stamped with the device's platform and name."""
    from arrow_matrix_tpu_torch.ledger import store
    from arrow_matrix_tpu_torch.tune.fingerprint import structure_hash
    from arrow_matrix_tpu_torch.tune.search import load_levels_from_source
    from arrow_matrix_tpu_torch.utils import resolve_device

    for dtype in dtypes:
        if dtype not in PROBE_DTYPES:
            raise ValueError(f"unknown probe dtype {dtype!r}; "
                             f"expected one of {PROBE_DTYPES}")
    dev = resolve_device(device)
    stamp = store.device_stamp(dev)
    levels, width = load_levels_from_source(source)
    shash = structure_hash(levels, width)

    from arrow_matrix_tpu_torch.parallel.multi_level import (
        resolve_feature_dtype,
    )

    rng = np.random.default_rng(seed)
    # The row count comes from the golden executor; build it first, then
    # draw the seeded input at its shape.  The fold's packing does not
    # depend on the carriage, so every curve reuses this one executor
    # with its carriage switched.
    multi = _build(levels, width, None, dev)
    n_rows = multi.n
    x0 = rng.standard_normal((n_rows, k)).astype(np.float32)
    golden = _trajectory(multi, x0, iterations)

    records: List[Dict[str, Any]] = []
    for dtype in dtypes:
        emulated = dtype == "int8" and emulate_int8
        multi.feature_dtype = resolve_feature_dtype(
            None if emulated or dtype == "f32" else dtype)
        probed = _trajectory(multi, x0, iterations, quantize=emulated)
        curve = error_curve(golden, probed)
        knobs = {"dtype": dtype, "k": k, "iterations": iterations,
                 "seed": seed, "emulated": emulated, "fmt": "fold"}
        payload = dict(curve)
        payload["source"] = dict(source)
        value = curve["rel_frobenius"][-1] if curve["rel_frobenius"] \
            else None
        if ledger is not None:
            rec = ledger.record(
                "error_curve", f"error_curve_{dtype}", value,
                unit="rel_frobenius", structure_hash=shash,
                knobs=knobs, payload=payload, **stamp)
        else:
            rec = {
                "schema": store.SCHEMA_VERSION,
                "kind": "error_curve",
                "record_id": "",
                "prev": None,
                "ts_unix": 0,
                "metric": f"error_curve_{dtype}",
                "value": value,
                "unit": "rel_frobenius",
                "structure_hash": shash,
                "platform": stamp["platform"],
                "device_kind": stamp["device_kind"],
                "host_load": None,
                "git_rev": None,
                "knobs": knobs,
                "payload": payload,
            }
            rec["record_id"] = store.canonical_record_id(rec)
        records.append(rec)
    return records

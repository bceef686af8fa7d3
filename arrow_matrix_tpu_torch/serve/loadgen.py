"""Deterministic load generation and the SLO report of the server.

The port's copy of ``arrow_matrix_tpu/serve/loadgen.py``.
:func:`synthetic_trace` derives every request (tenant and feature
payload) from ``numpy.random.default_rng(seed)`` exactly as the JAX
package does, so the same seed gives byte-identical requests in both
packages; two runs of one trace through a fault-free server complete
with bit-identical results and identical admission censuses.

:func:`slo_summary` folds the server's census and the tickets'
latencies into the SLO report (requests/s, p50/p90/p99 latency, shed
and rejection counts, HBM occupancy, per-tenant and per-class
breakdowns) with the JAX package's field names.
:func:`ba_executor_factory` builds the resident operator of a
Barabasi-Albert graph and one ``MultiLevelArrow`` per ladder rung, on
the card unless ``device="cpu"``.  ``smoke_serve`` (which needs the
streaming telemetry and the ledger) is not ported yet and raises.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from arrow_matrix_tpu_torch.serve import request as rq
from arrow_matrix_tpu_torch.serve.scheduler import ArrowServer, ExecConfig
from arrow_matrix_tpu_torch.utils.artifacts import atomic_write_json
from arrow_matrix_tpu_torch.utils.device import DeviceLike, resolve_device


def synthetic_trace(n_rows: int, *, tenants: int = 4,
                    requests: int = 16, k: int = 4,
                    iterations: int = 3, seed: int = 0,
                    deadline_s: Optional[float] = None
                    ) -> List[rq.Request]:
    """A reproducible heavy-traffic trace: ``requests`` requests from
    ``tenants`` synthetic tenants, feature payloads and tenant
    assignment both drawn from one seeded generator."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(requests):
        tenant = f"tenant{int(rng.integers(tenants))}"
        x = rng.standard_normal((n_rows, k)).astype(np.float32)
        out.append(rq.Request(request_id=f"r{i:04d}", tenant=tenant,
                              x=x, iterations=iterations,
                              deadline_s=deadline_s))
    return out


def run_trace(server: ArrowServer,
              trace: List[rq.Request]) -> List[rq.Ticket]:
    """Submit the whole trace, then drain synchronously (or, when the
    server's worker thread is running, wait for every ticket) —
    returns the tickets in trace order."""
    tickets = [server.submit(r) for r in trace]
    if server._thread is not None and server._thread.is_alive():
        for t in tickets:
            t.wait()
    else:
        server.drain()
    return tickets


def _pct(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def latency_summary_ms(tickets: List[rq.Ticket]) -> Dict[str, float]:
    lats = [t.latency_s * 1e3 for t in tickets
            if t.status == rq.COMPLETED and t.latency_s is not None]
    if not lats:
        return {"count": 0, "p50": None, "p90": None, "p99": None,
                "mean": None, "max": None}
    return {"count": len(lats),
            "p50": _pct(lats, 0.5), "p90": _pct(lats, 0.9),
            "p99": _pct(lats, 0.99),
            "mean": sum(lats) / len(lats), "max": max(lats)}


def slo_summary(server: ArrowServer, tickets: List[rq.Ticket],
                wall_s: float, pulse=None) -> dict:
    """The serving SLO report (the JAX package's fields).  ``pulse``
    (a streaming telemetry monitor) is not ported yet: the report's
    ``"pulse"`` section is None, and passing one raises."""
    if pulse is not None:
        raise NotImplementedError(
            "a pulse monitor is not ported yet; see ROADMAP.md Queue A, "
            "'Observability and the ledger'")
    base = server.summary()
    per_tenant = {}
    for name, rec in base["tenants"].items():
        mine = [t for t in tickets if t.request.tenant == name]
        rec = dict(rec)
        rec["latency_ms"] = latency_summary_ms(mine)
        per_tenant[name] = rec
    # The per-class mirror of per_tenant — latency
    # quantiles keyed by the class actually served (post-fallback), so
    # an SLO read can tell approx tail latency from exact.
    per_class = {}
    for klass, rec in (base.get("classes") or {}).items():
        mine = [t for t in tickets if t.served_class == klass]
        rec = dict(rec)
        rec["latency_ms"] = latency_summary_ms(mine)
        per_class[klass] = rec
    completed = base["completed"]
    return {
        "server": base["server"],
        "requests": len(tickets),
        "completed": completed,
        "failed": base["failed"],
        "shed": base["shed"],
        "rejected": base["rejected"],
        "wall_s": wall_s,
        "requests_per_s": (completed / wall_s) if wall_s > 0 else None,
        "latency_ms": latency_summary_ms(tickets),
        "hbm": base["hbm"],
        "batches": base["batches"],
        "batched_requests": base["batched_requests"],
        "faults_seen": base["faults_seen"],
        "recoveries": base["recoveries"],
        "checkpoint_corruptions": base["checkpoint_corruptions"],
        "per_tenant": per_tenant,
        "per_class": per_class,
        "class_fallback": base.get("class_fallback", 0),
        "certificates": base.get("certificates", {}),
        "pulse": None,
    }


def write_serve_artifacts(run_dir: str, summary: dict,
                          registry=None) -> str:
    """Persist ``serve_summary.json`` (+ the registry's
    ``metrics.jsonl``) under ``run_dir``; returns the summary path."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "serve_summary.json")
    atomic_write_json(path, summary, indent=2, sort_keys=True)
    if registry is not None:
        registry.write_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    return path


def ba_executor_factory(n: int, width: int, seed: int,
                        fmt: str = "fold", mesh=None,
                        feature_dtype=None, plan=None,
                        plan_k=None, device: DeviceLike = None):
    """Factory of executors over one Barabasi-Albert decomposition
    (``barabasi_albert(n, 3, seed)`` decomposed at ``width``, 10 levels
    at most, block-diagonal, as in the JAX package): the decomposition
    is computed once (the resident operator) and each
    :class:`ExecConfig` rung builds its own ``MultiLevelArrow`` over the
    same levels, on ``device`` (the card unless ``"cpu"``).  Returns
    ``(factory, n_rows)``.  ``mesh`` and ``plan`` are not ported yet and
    raise."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh is not ported yet; see ROADMAP.md Queue A, "
            "'multi-device executors'")
    if plan is not None or plan_k is not None:
        raise NotImplementedError(
            "a tune plan is not ported yet; see ROADMAP.md Queue A, "
            "'Proof and tuning layers'")
    dev = resolve_device(device)
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    a = barabasi_albert(n, 3, seed=seed)
    levels = arrow_decomposition(a, width, max_levels=10,
                                 block_diagonal=True, seed=seed)

    def factory(cfg: ExecConfig):
        from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

        # The rung's class carriage wins over the factory's default: an
        # approx batch builds a reduced-precision executor.
        dtype = feature_dtype
        if getattr(cfg, "feature_dtype", None) is not None:
            dtype = cfg.feature_dtype
        return MultiLevelArrow(levels, width, fmt=fmt, kernel=cfg.kernel,
                               overlap_slabs=cfg.overlap_slabs,
                               repl=cfg.repl, feature_dtype=dtype,
                               device=dev)

    return factory, n


def smoke_serve(run_dir: str, **kwargs) -> dict:
    """The JAX package's smoke run with streaming telemetry and a
    run-local ledger record: not ported yet."""
    raise NotImplementedError(
        "smoke_serve needs the streaming telemetry and the ledger; see "
        "ROADMAP.md Queue A, 'Observability and the ledger'")

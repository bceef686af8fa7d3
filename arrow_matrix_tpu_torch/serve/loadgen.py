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
the card unless ``device="cpu"``.  A summary built with ``pulse=``
embeds the monitor's closed-window series under ``"pulse"``: the
report and the streaming series share one vocabulary
(``obs/pulse.py:SLO_SERIES_FIELDS``), so the two can be diffed field
for field.  :func:`smoke_serve` is one small end-to-end serve run with
a pulse monitor attached and a run-local ledger record.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

from arrow_matrix_tpu_torch.ledger import store as ledger_store
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
    """The serving SLO report (the JAX package's fields); pass the run's
    :class:`~arrow_matrix_tpu_torch.obs.pulse.PulseMonitor` to embed its
    windowed time series under ``"pulse"``."""
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
    pulse_section = None
    if pulse is not None:
        pulse_section = {
            "window_s": pulse.window_s,
            "windows": pulse.series(),
            "totals": pulse.totals_dict(),
            "burn_events": list(pulse.burn_events),
            "dropped_windows": pulse.dropped_windows,
            "ring_path": pulse.ring_path,
        }
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
        "pulse": pulse_section,
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
    ``(factory, n_rows)``.

    ``plan`` (a ``TunePlan``, its dict, or "auto") threads into every
    rung: the rung's ExecConfig still wins on kernel/overlap/repl (the
    ladder must be able to step a tuned knob down), while the plan gives
    the structural knobs (tier split, carriage) and K1's knobs.
    ``mesh`` (a ``parallel/mesh.py`` mesh of ranks) builds every rung as
    ``MultiLevelArrow(levels, width, mesh=mesh, ...)`` on the mesh's
    device: each rank of the job calls the factory, and packs its shard.

    With ``AMT_BA_CACHE_DIR`` set, the decomposition is the one saved
    there (``tools/gather_probe.cached_levels``: computed and saved on
    the first call, loaded after), so that the processes of a fleet load
    one decomposition instead of each computing it; its executors give
    the same bits as the computed decomposition's."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    cache = os.environ.get("AMT_BA_CACHE_DIR")
    if cache:
        from arrow_matrix_tpu_torch.tools.gather_probe import cached_levels

        levels = cached_levels(n, 3, width, seed=seed, max_levels=10,
                               cache_dir=cache, backend="numpy")
    else:
        from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
        from arrow_matrix_tpu_torch.utils import barabasi_albert

        a = barabasi_albert(n, 3, seed=seed)
        levels = arrow_decomposition(a, width, max_levels=10,
                                     block_diagonal=True, seed=seed)
    resolved = None
    if plan is not None:
        from arrow_matrix_tpu_torch.tune.plan import resolve_plan

        resolved = resolve_plan(plan, levels=levels, width=width,
                                plan_k=plan_k)

    def factory(cfg: ExecConfig):
        from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

        kwargs = dict(fmt=fmt, feature_dtype=feature_dtype)
        kernel_opts = None
        if resolved is not None:
            bk = resolved.build_kwargs()
            kwargs.update(fmt=bk["fmt"], chunk=bk["chunk"],
                          fold_growth=bk["fold_growth"],
                          fold_align=bk["fold_align"],
                          feature_dtype=bk["feature_dtype"])
            kernel_opts = resolved.kernel_opts()
        # The rung's class carriage wins over the factory's default and
        # the plan's: an approx batch builds a reduced-precision
        # executor.
        if getattr(cfg, "feature_dtype", None) is not None:
            kwargs["feature_dtype"] = cfg.feature_dtype
        return MultiLevelArrow(levels, width, mesh=mesh,
                               kernel=cfg.kernel,
                               overlap_slabs=cfg.overlap_slabs,
                               repl=cfg.repl, kernel_opts=kernel_opts,
                               device=dev, **kwargs)

    return factory, n


def smoke_serve(run_dir: str, *, n: int = 96, width: int = 16,
                k: int = 2, tenants: int = 2, requests: int = 4,
                iterations: int = 2, seed: int = 3,
                queue_capacity: int = 8,
                hbm_budget_bytes: Optional[int] = None,
                max_batch_k: int = 0, registry=None,
                device: DeviceLike = None) -> dict:
    """One small end-to-end serve run on ``device`` (the card unless
    ``"cpu"``): build a BA operator, serve a deterministic trace with a
    PulseMonitor attached, write the SLO artifacts
    (``serve_summary.json``, ``pulse_ring.json``, ``pulse_metrics.prom``)
    into ``run_dir``, record the report in a ledger under ``run_dir``
    (never the default store), and return the summary with its
    ``ledger_record_id``."""
    from arrow_matrix_tpu_torch.obs import pulse as pulse_mod

    dev = resolve_device(device)
    if registry is None:
        from arrow_matrix_tpu_torch.obs.metrics import MetricsRegistry

        registry = MetricsRegistry(run_dir=run_dir)
    os.makedirs(run_dir, exist_ok=True)
    factory, n_rows = ba_executor_factory(n, width, seed, fmt="fold",
                                          device=dev)
    server = ArrowServer(factory, ExecConfig(),
                         hbm_budget_bytes=hbm_budget_bytes,
                         queue_capacity=queue_capacity,
                         max_batch_k=max_batch_k,
                         registry=registry, name="smoke")
    ledger = os.path.join(run_dir, "ledger")
    monitor = pulse_mod.PulseMonitor(
        window_s=0.25, name="smoke",
        ring_path=os.path.join(run_dir, "pulse_ring.json"),
        ledger_dir=ledger, watchdog=pulse_mod.SloWatchdog())
    server.attach_pulse(monitor)
    trace = synthetic_trace(n_rows, tenants=tenants,
                            requests=requests, k=k,
                            iterations=iterations, seed=seed)
    t0 = time.perf_counter()
    tickets = run_trace(server, trace)
    wall = time.perf_counter() - t0
    monitor.close()
    with open(os.path.join(run_dir, "pulse_metrics.prom"), "w",
              encoding="utf-8") as fh:
        fh.write(monitor.exposition_text())
    summary = slo_summary(server, tickets, wall, pulse=monitor)
    rec = ledger_store.record(
        "serve", "requests_per_s", summary.get("requests_per_s"),
        directory=ledger, unit="req/s",
        knobs={"n": n, "width": width, "k": k, "seed": seed,
               "tenants": tenants, "requests": requests,
               "iterations": iterations,
               "max_batch_k": max_batch_k},
        payload={key: summary[key] for key in
                 ("requests", "completed", "failed", "shed",
                  "rejected", "wall_s", "latency_ms", "batches",
                  "batched_requests") if key in summary},
        **ledger_store.device_stamp(dev))
    summary["ledger_record_id"] = rec["record_id"] if rec else None
    write_serve_artifacts(run_dir, summary, registry=registry)
    return summary

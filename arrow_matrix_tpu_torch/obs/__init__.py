"""Observability of the port.

* :mod:`~arrow_matrix_tpu_torch.obs.flight` — the flight recorder and
  the request-correlation context;
* :mod:`~arrow_matrix_tpu_torch.obs.metrics` — counters, gauges and
  histograms with a ``metrics.jsonl`` sink;
* :mod:`~arrow_matrix_tpu_torch.obs.tracer` — host-side phase spans,
  emitted as Chrome-trace / Perfetto JSON and entered as
  ``torch.profiler.record_function`` ranges, plus the shared timing
  harness;
* :mod:`~arrow_matrix_tpu_torch.obs.pulse` — live serving telemetry:
  sliding-window SLO series, a crash-readable ring, a scrape endpoint
  and the SLO-burn watchdog;
* :mod:`~arrow_matrix_tpu_torch.obs.xray` — per-process trace
  documents merged into one timeline, and the per-class critical path;
* :mod:`~arrow_matrix_tpu_torch.obs.memview` — the executors' static
  HBM model as the admission price, and one call's measured device
  memory beside it;
* :mod:`~arrow_matrix_tpu_torch.obs.imbalance` — per-unit load
  imbalance from the packed operators;
* :mod:`~arrow_matrix_tpu_torch.obs.lens` and
  :mod:`~arrow_matrix_tpu_torch.obs.costmodel` — K1's time per tier of
  the fold and the per-family cost model fitted from it;
* :mod:`~arrow_matrix_tpu_torch.obs.comm` — each executor's counted
  collective bytes against its ideal, its replica merge, the replication
  a budget allows, and the device's HBM budget.
"""

from arrow_matrix_tpu_torch.obs.comm import (
    account_collectives,
    auto_repl,
    hbm_budget_bytes,
    ideal_bytes_for,
    reduce_bytes_for,
)
from arrow_matrix_tpu_torch.obs.costmodel import (
    CostModel,
    fit_cost_model,
    predict_candidate_ms,
    predict_iter_ms,
    tier_counters,
)
from arrow_matrix_tpu_torch.obs.flight import (
    FlightRecorder,
    current_request,
    request_context,
)
from arrow_matrix_tpu_torch.obs.imbalance import (
    account_imbalance,
    format_imbalance_report,
    shard_report_for,
)
from arrow_matrix_tpu_torch.obs.lens import (
    attribution_fractions,
    explain_gap,
    fit_from_profile,
    profile_fold,
    ratio_points,
    record_profile,
)
from arrow_matrix_tpu_torch.obs.memview import (
    account_memory,
    format_memory_report,
    memory_report,
    predicted_bytes_for,
    tree_device_bytes,
)
from arrow_matrix_tpu_torch.obs.metrics import (
    MetricsRegistry,
    get_registry,
    init_registry,
    set_registry,
)
from arrow_matrix_tpu_torch.obs.pulse import (
    BurnRule,
    PulseEndpoint,
    PulseMonitor,
    SloWatchdog,
)
from arrow_matrix_tpu_torch.obs.tracer import (
    Tracer,
    call_time_ms,
    chained_iteration_ms,
    iteration_time_ms,
    timed,
)
from arrow_matrix_tpu_torch.obs.xray import (
    critical_path,
    merge_process_traces,
    merge_run_dir,
    new_trace_id,
    process_trace,
    recover_from_flight,
    subdivide_compute,
)

__all__ = [
    "BurnRule",
    "CostModel",
    "FlightRecorder",
    "MetricsRegistry",
    "PulseEndpoint",
    "PulseMonitor",
    "SloWatchdog",
    "Tracer",
    "account_collectives",
    "account_imbalance",
    "account_memory",
    "attribution_fractions",
    "auto_repl",
    "call_time_ms",
    "chained_iteration_ms",
    "critical_path",
    "current_request",
    "explain_gap",
    "fit_cost_model",
    "fit_from_profile",
    "format_imbalance_report",
    "format_memory_report",
    "get_registry",
    "hbm_budget_bytes",
    "ideal_bytes_for",
    "init_registry",
    "iteration_time_ms",
    "memory_report",
    "merge_process_traces",
    "merge_run_dir",
    "new_trace_id",
    "predict_candidate_ms",
    "predict_iter_ms",
    "predicted_bytes_for",
    "process_trace",
    "profile_fold",
    "ratio_points",
    "record_profile",
    "recover_from_flight",
    "reduce_bytes_for",
    "request_context",
    "set_registry",
    "shard_report_for",
    "subdivide_compute",
    "tier_counters",
    "timed",
    "tree_device_bytes",
]

"""The serving runtime: an always-on, multi-tenant SpMM server.

The port's copy of ``arrow_matrix_tpu/serve``.  The decomposed operator
stays resident on the card while a stream of tenants' requests runs
over it, each under supervision:

  * :mod:`~arrow_matrix_tpu_torch.serve.request` — the request and
    ticket model (every request reaches exactly one terminal state);
  * :mod:`~arrow_matrix_tpu_torch.serve.admission` — the live HBM
    accountant; requests are priced by the executor's static model
    before they are queued and rejected when over budget;
  * :mod:`~arrow_matrix_tpu_torch.serve.scheduler` — the bounded queue,
    the deterministic FIFO scheduler with feature-axis batching, the
    per-request supervisor (watchdog, seeded-backoff retry,
    sha256-verified checkpoint resume) and the degradation ladder
    repl=c -> 1, overlap S -> 1;
  * :mod:`~arrow_matrix_tpu_torch.serve.loadgen` — deterministic
    synthetic traces, the SLO report and the Barabasi-Albert executor
    factory.

CLI: ``python -m arrow_matrix_tpu_torch.cli.graft_serve``.
"""

from arrow_matrix_tpu_torch.serve.admission import (
    HBMAccountant,
    ServeCapacityError,
    request_price_bytes,
)
from arrow_matrix_tpu_torch.serve.loadgen import (
    ba_executor_factory,
    latency_summary_ms,
    run_trace,
    slo_summary,
    smoke_serve,
    synthetic_trace,
    write_serve_artifacts,
)
from arrow_matrix_tpu_torch.serve.request import Request, Ticket
from arrow_matrix_tpu_torch.serve.scheduler import (
    ArrowServer,
    ExecConfig,
    degradation_ladder,
)

__all__ = [
    "ArrowServer",
    "ExecConfig",
    "HBMAccountant",
    "Request",
    "ServeCapacityError",
    "Ticket",
    "ba_executor_factory",
    "degradation_ladder",
    "latency_summary_ms",
    "request_price_bytes",
    "run_trace",
    "slo_summary",
    "smoke_serve",
    "synthetic_trace",
    "write_serve_artifacts",
]

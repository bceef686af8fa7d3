"""Observability of the serving runtime.

* :mod:`~arrow_matrix_tpu_torch.obs.flight` — the flight recorder and
  the request-correlation context;
* :mod:`~arrow_matrix_tpu_torch.obs.metrics` — counters, gauges and
  histograms with a ``metrics.jsonl`` sink;
* :mod:`~arrow_matrix_tpu_torch.obs.memview` — the executors' static
  HBM model as the admission price;
* :mod:`~arrow_matrix_tpu_torch.obs.comm` — the device's HBM budget.
"""

from arrow_matrix_tpu_torch.obs.metrics import MetricsRegistry

__all__ = ["MetricsRegistry"]

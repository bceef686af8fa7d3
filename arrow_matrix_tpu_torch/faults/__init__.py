"""Deterministic fault injection and self-healing supervision.

The port's copy of ``arrow_matrix_tpu/faults``:

  * :mod:`~arrow_matrix_tpu_torch.faults.plan` — a deterministic fault
    plan (``AMT_FAULT_PLAN``: JSON or a path to JSON) driving the
    injection hooks at the port's seams (``MultiLevelArrow.step``, the
    decomposition loader).  With no plan set every hook is one ``None``
    check.
  * :mod:`~arrow_matrix_tpu_torch.faults.policy` — the shared retry
    policy (deterministic seeded jitter).
  * :mod:`~arrow_matrix_tpu_torch.faults.supervisor` — the supervised
    iteration loop: watchdog, bounded retry with backoff, checkpoint
    resume and rollback, and a finite check on the carried X.
"""

from arrow_matrix_tpu_torch.faults.plan import (
    FaultInjected,
    FaultPlan,
    active_plan,
    clear_plan,
    inject,
    on_step,
    reload_plan,
    set_plan,
)
from arrow_matrix_tpu_torch.faults.policy import RetryPolicy
from arrow_matrix_tpu_torch.faults.supervisor import (
    Abort,
    NonFiniteState,
    Supervisor,
    WatchdogStalled,
    WatchdogTimeout,
    state_is_finite,
)

__all__ = [
    "Abort",
    "FaultInjected",
    "FaultPlan",
    "NonFiniteState",
    "RetryPolicy",
    "Supervisor",
    "WatchdogStalled",
    "WatchdogTimeout",
    "active_plan",
    "clear_plan",
    "inject",
    "on_step",
    "reload_plan",
    "set_plan",
    "state_is_finite",
]

"""The device's HBM budget for planning and admission.

The port's copy of ``hbm_budget_bytes`` from
``arrow_matrix_tpu/obs/comm.py``; the rest of that module (collective
byte accounting against the compiled program, the replication planner)
waits for the multi-device executors.
"""

from __future__ import annotations

import os
from typing import Optional

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

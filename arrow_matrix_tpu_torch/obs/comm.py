"""The device's HBM budget for planning and admission.

The port's copies of ``hbm_budget_bytes`` and ``repl_predict_ms`` (the
tuner's cost screen) from ``arrow_matrix_tpu/obs/comm.py``; the rest of
that module (collective byte accounting against the compiled program,
the replication planner) waits for the multi-device executors.
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


#: Link rate of the step-time model (the JAX package's constant: on one
#: card the fold exchanges nothing, so only the model's shape matters).
LINK_BYTES_PER_S = 45e9


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

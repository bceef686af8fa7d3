"""Memory budgets of the device an executor runs on.

The port's copy of ``device_memory_budget`` in
``arrow_matrix_tpu/utils/platform.py`` and of ``gather_budget_for`` in
``arrow_matrix_tpu/parallel/multi_level.py``: the byte budgets that
``MultiLevelArrow(fmt="auto")`` compares dense block footprints with,
and that bound the plain ELL gathers' intermediate.
"""

from __future__ import annotations

import os

import torch


def device_memory_budget(device: torch.device, fraction: float = 0.5,
                         default: int = 4 << 30) -> int:
    """Bytes available for resident block storage on ``device``, from
    the live device rather than a constant: the card's free memory
    (``torch.cuda.mem_get_info``) times ``fraction``; on the CPU the
    available host RAM times ``fraction`` (``sysconf``, the reference's
    rule); ``default`` only when neither is known.  ``fraction`` leaves
    headroom for the features and the kernels' scratch."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(int(free * fraction), 0)
    try:
        free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return max(int(free * fraction), 0)
    except (ValueError, OSError, AttributeError):
        return default


def gather_budget_for(dense_budget: int) -> int:
    """Byte budget of the plain ELL gathers' intermediate, derived from
    the dense-format budget (the reference's rule)."""
    return max(dense_budget // 4, 1 << 27)

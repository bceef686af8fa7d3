"""The executors' static HBM model, read by admission control.

The port's copy of the host half of ``arrow_matrix_tpu/obs/memview.py``:
:func:`tree_device_bytes` (bytes of the tensors in nested containers,
from their metadata), :func:`predicted_bytes_for` and
:func:`request_bytes_for` (an executor's own model of one step at a
feature width, and of one request's carriage on top of its resident
operator: the serving runtime's admission price), and
:func:`largest_fitting_repl`.  The JAX module's ``memory_report`` and
``account_memory`` read a compiled XLA executable's memory analysis and
have no counterpart here yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def tree_device_bytes(*trees) -> int:
    """Total bytes of every tensor (or numpy array) in the given nested
    tuples, lists and dicts, from shape and dtype alone (no transfer).
    Other leaves (None, scalars) count zero; a tensor met twice counts
    once."""
    seen = {}

    def visit(node):
        if isinstance(node, torch.Tensor):
            seen[(node.data_ptr(), node.nbytes)] = node.nbytes
        elif isinstance(node, np.ndarray):
            seen[(id(node), node.nbytes)] = node.nbytes
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                visit(v)

    visit(trees)
    return int(sum(seen.values()))


def predicted_bytes_for(obj, k: int, itemsize: int = 4,
                        repl: int = 1) -> Optional[int]:
    """The executor's own static HBM model for one step at feature width
    ``k``, or None when it has no model.  ``repl`` is passed through
    (executors without the keyword get the model times ``repl``, the
    JAX package's planning convention)."""
    fn = getattr(obj, "predicted_hbm_bytes", None)
    if fn is None:
        return None
    repl = max(int(repl), 1)
    try:
        return int(fn(k, itemsize=itemsize, repl=repl))
    except TypeError:
        return int(fn(k, itemsize=itemsize)) * repl


def request_bytes_for(obj, k: int, itemsize: int = 4,
                      repl: int = 1) -> Optional[int]:
    """The incremental HBM bytes a request of feature width ``k`` adds
    on top of the executor's resident operator: the per-request
    admission price.  ``carriage_hbm_bytes`` answers directly where the
    executor has it; else the model at k minus the model at 0.  None
    when the executor has no model."""
    fn = getattr(obj, "carriage_hbm_bytes", None)
    if fn is not None:
        return int(fn(k, itemsize=itemsize, repl=repl))
    full = predicted_bytes_for(obj, k, itemsize=itemsize, repl=repl)
    base = predicted_bytes_for(obj, 0, itemsize=itemsize, repl=repl)
    if full is None or base is None:
        return None
    return max(int(full) - int(base), 0)


def largest_fitting_repl(base_bytes: int, budget_bytes: int,
                         choices=(1, 2, 4, 8)) -> int:
    """Largest replication factor whose footprint ``base_bytes * c``
    fits ``budget_bytes`` (at least 1)."""
    best = 1
    for c in sorted(set(int(c) for c in choices)):
        if c >= 1 and base_bytes * c <= budget_bytes:
            best = max(best, c)
    return best

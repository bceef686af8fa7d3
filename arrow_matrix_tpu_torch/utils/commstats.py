"""Per-step communication accounting of the mesh executors.

The port's counterpart of ``arrow_matrix_tpu/utils/commstats.py``.  The
JAX package reads its collectives back out of compiled HLO text; the
port issues every collective itself, through one layer
(``parallel/collectives.py``), which records each one here as it runs:
its kind, the size of its group, and its bytes.  ``collective_stats``
runs one call of a step with the counts set to 0 and returns what it
issued.

Bytes of an op are this rank's wire bytes: the larger of what it sends
and what it receives, its own slot excluded (an all-to-all of ``S``
slots a pair over ``P`` ranks moves ``(P - 1) S`` rows each way; a
reduction to the root receives ``P - 1`` partials at the root and sends
one elsewhere).  ``host_staged_bytes`` counts apart the bytes the layer
copied between the card and pinned host buffers, the transport of ranks
that share one card over gloo; they are not wire bytes.

The collective prover (``analysis/prove.py``) reads two more things
here.  :func:`start_log` keeps, until :func:`stop_log`, one record of
each collective: its kind, the shape and dtype of the operand this rank
handed it, and that operand's bytes (``payload``: what XLA's accountant
reads off each collective's shape in the JAX package).  And
:func:`issuing` marks the span in which the collective layer itself
runs, so a ``torch.distributed`` call made outside it can be told
apart as one that bypasses the count.

``ideal_routing_bytes`` (the O(moved rows) bound of the inter-level
routing) and ``format_stats`` are the JAX module's.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

import numpy as np

#: Collective kinds: the JAX accountant's five HLO mnemonics, then the
#: two the port issues that HLO names otherwise (a broadcast from one
#: rank, and a gather of partials to one rank).
COLLECTIVE_OPS = (
    "all-to-all",
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "broadcast",
    "gather",
)

_STATS: Dict[str, Dict[str, int]] = {}
_STAGED = [0]
#: The operand log (None: not logging) and the collective layer's depth.
_LOG: List[Optional[list]] = [None]
_ISSUING = [0]


def reset() -> None:
    """Set every count to 0."""
    _STATS.clear()
    for kind in COLLECTIVE_OPS:
        _STATS[kind] = {"count": 0, "bytes": 0, "group": 0}
    _STAGED[0] = 0


reset()


def record(kind: str, nbytes: int, group_size: int, operand=None,
           payload: Optional[int] = None) -> None:
    """Count one collective of ``kind`` over a group of ``group_size``
    ranks that moved ``nbytes`` wire bytes on this rank; ``operand`` is
    the tensor this rank handed it (logged while :func:`start_log` is
    on), ``payload`` its bytes when they are not the operand's own."""
    entry = _STATS[kind]
    entry["count"] += 1
    entry["bytes"] += int(nbytes)
    entry["group"] = max(entry["group"], int(group_size))
    log = _LOG[0]
    if log is not None and operand is not None:
        log.append({"kind": kind, "shape": tuple(operand.shape),
                    "dtype": str(operand.dtype).replace("torch.", ""),
                    "payload": int(operand.numel() * operand.element_size()
                                   if payload is None else payload),
                    "wire": int(nbytes)})


def start_log() -> None:
    """Start a fresh operand log (module docstring)."""
    _LOG[0] = []


def stop_log() -> list:
    """Stop the operand log and return its records in issue order."""
    log, _LOG[0] = _LOG[0], None
    return log or []


@contextlib.contextmanager
def issuing():
    """The span of one call of the collective layer (module docstring)."""
    _ISSUING[0] += 1
    try:
        yield
    finally:
        _ISSUING[0] -= 1


def in_layer() -> bool:
    """Whether the collective layer is running now."""
    return _ISSUING[0] > 0


def record_staged(nbytes: int) -> None:
    """Count ``nbytes`` copied between the card and pinned host memory."""
    _STAGED[0] += int(nbytes)


def snapshot() -> Dict[str, Any]:
    """The counts so far: ``{kind: {"count", "bytes", "group"}, ...,
    "total_bytes", "host_staged_bytes"}``."""
    stats: Dict[str, Any] = {k: dict(v) for k, v in _STATS.items()}
    stats["total_bytes"] = sum(v["bytes"] for v in _STATS.values())
    stats["host_staged_bytes"] = _STAGED[0]
    return stats


def collective_stats(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once with the counts set to 0 and
    return what it issued (:func:`snapshot`); the counts are left as
    the call made them."""
    reset()
    fn(*args, **kwargs)
    return snapshot()


def ideal_routing_bytes(perms, n_devices: int, k: int,
                        itemsize: int = 4) -> int:
    """O(moved rows) lower bound for one iteration's permutation
    routing: a row contributes iff the forward (and backward) exchange
    moves it to a *different device* than the one holding it, summed
    over adjacent level pairs, for both directions.

    ``perms`` are the padded level permutations over the shared row
    count (level-i order), row-block-sharded over ``n_devices``.
    """
    perms = [np.asarray(p) for p in perms]
    total = perms[0].size
    rows_per_dev = -(-total // n_devices)
    moved = 0
    inv = [np.argsort(p) for p in perms]
    for i in range(1, len(perms)):
        # Position of each level-(i-1) row in level-i order.
        pos = inv[i][perms[i - 1]]
        here = np.arange(total) // rows_per_dev
        there = pos // rows_per_dev
        moved += int(np.count_nonzero(here != there))
    return 2 * moved * k * itemsize  # forward + backward


def format_stats(stats: Dict[str, Any]) -> str:
    lines = [f"{'collective':20s} {'count':>6s} {'bytes':>14s}"]
    for kind in COLLECTIVE_OPS:
        v = stats[kind]
        if v["count"]:
            lines.append(f"{kind:20s} {v['count']:6d} {v['bytes']:14,d}")
    lines.append(f"{'TOTAL':20s} {'':6s} {stats['total_bytes']:14,d}")
    if stats.get("host_staged_bytes"):
        lines.append(f"{'host staged':20s} {'':6s} "
                     f"{stats['host_staged_bytes']:14,d}")
    return "\n".join(lines)

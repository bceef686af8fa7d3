"""Counts of the build work a step must not repeat.

A step of the port compiles nothing, but it could redo what its
executor's constructor did once: load a kernel library
(``ops/_build.py:load``), build a K1 work list
(``ops/worklist.py:build_worklist``) or its device plan
(``ops/cuda_sell.py:build_plan``), or compile a route table
(``parallel/routing.py:build_route``).  Each adds one to its count here,
and the audit (``analysis/audit.py``) reads the counts around a second
same-shape call, the port's form of the reference's "the second call
compiles nothing".
"""

from __future__ import annotations

from typing import Dict

KINDS = ("library_loads", "worklists", "plans", "routes")

_COUNTS: Dict[str, int] = {k: 0 for k in KINDS}


def bump(kind: str) -> None:
    """Count one build of ``kind`` (one of :data:`KINDS`)."""
    _COUNTS[kind] += 1


def snapshot() -> Dict[str, int]:
    """The counts so far."""
    return dict(_COUNTS)

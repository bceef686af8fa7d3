"""Timing on the card: CUDA events, and chained iterations.

:func:`cuda_ms` is the median of CUDA-event timings of single calls;
:func:`chained_iteration_ms` (counterpart of the JAX package's
``obs.chained_iteration_ms``, which ``bench.py:_measure`` calls) times
chains of ``run(x, iters)`` and divides by ``iters``.  On the CPU, which
the tests use, :func:`host_ms` and the same chaining time with the host
clock; those are host numbers, never a device's.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, List


def cuda_runs(fn: Callable, reps: int) -> List[float]:
    """Milliseconds of each of ``reps`` calls of ``fn``, CUDA events
    around each call, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in marks]


def cuda_ms(fn: Callable, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    return statistics.median(cuda_runs(fn, reps))


def host_ms(fn: Callable, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls on the host
    clock, after one warm-up call (for work on the CPU)."""
    fn()
    runs = []
    for _ in range(reps):
        tic = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - tic) * 1e3)
    return statistics.median(runs)


def median_ms(fn: Callable, reps: int, device) -> float:
    """:func:`cuda_ms` for a CUDA ``device``, :func:`host_ms` for the
    CPU."""
    return (cuda_ms if device.type == "cuda" else host_ms)(fn, reps)


def chained_iteration_ms(run: Callable, x, iters: int,
                         reps: int = 7) -> float:
    """ms/iter of ``run(x, iters)``: the median of ``reps`` timed chains
    of ``iters`` iterations, divided by ``iters``.  ``x`` is a tensor or
    a tuple of tensors (the int8 carriage); its device picks the
    clock."""
    first = x[0] if isinstance(x, tuple) else x
    return median_ms(lambda: run(x, iters), reps, first.device) / iters

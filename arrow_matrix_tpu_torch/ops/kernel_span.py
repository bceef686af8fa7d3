"""The span of one kernel wrapper's call.

Each wrapper of K1-K4 (``ops/cuda_sell.py``, ``cuda_gather.py``,
``cuda_blocks.py``) runs inside :func:`kernel_call`: on the card one
launch (or its launch groups), on the CPU its plain twin.  The
collective prover (``analysis/prove.py``) reads the span to count a
step's layout copies outside the kernels' calls only: a twin orders its
sums as the kernel does, with copies of its own that the kernel on the
card does not make.
"""

from __future__ import annotations

import functools

_DEPTH = [0]


def kernel_call(fn):
    """Mark ``fn`` (a kernel wrapper) as one kernel call."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _DEPTH[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH[0] -= 1
    return wrapped


def in_kernel() -> bool:
    """Whether a kernel wrapper is running now."""
    return _DEPTH[0] > 0

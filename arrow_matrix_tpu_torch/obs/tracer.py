"""Phase tracer and the shared device-timing harness.

The port's copy of ``arrow_matrix_tpu/obs/tracer.py``.  Host-side spans
(``Tracer.span``) measure wall time per phase and emit Chrome-trace /
Perfetto JSON; each span also enters ``torch.profiler.record_function``
(where the JAX package enters ``jax.named_scope`` and a profiler
``TraceAnnotation``), so a ``torch.profiler`` capture taken around the
span (``utils/logging.trace``) carries the same phase names on its
host timeline as the tracer's own document.

The timing helpers wait for the device through
``utils/logging.block_until_ready`` (a CUDA tensor synchronizes its
device):

  * :func:`timed` — seconds for one call, result waited for;
  * :func:`iteration_time_ms` — per-iteration ms, waiting around each
    step;
  * :func:`chained_iteration_ms` — ms/iter of a chained run ending in a
    scalar host fetch, with the dispatch round trip subtracted.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

from arrow_matrix_tpu_torch.obs import flight
from arrow_matrix_tpu_torch.utils.logging import block_until_ready


@dataclass
class Span:
    """One completed phase: Chrome-trace complete event ("ph": "X")."""

    name: str
    ts_us: float
    dur_us: float
    tid: int = 0
    args: Dict[str, Any] = field(default_factory=dict)


@contextlib.contextmanager
def _device_annotation(name: str):
    """Enter ``torch.profiler.record_function(name)``: a range on the
    profiler's host timeline when a profile is being taken, one cheap
    call otherwise."""
    import torch

    with torch.profiler.record_function(name):
        yield


class Tracer:
    """Collects spans for one run; serializes to Chrome trace JSON.

    Spans record even when the body raises (try/finally), so a failed
    phase still shows up — with an ``error`` arg — in the trace.
    """

    def __init__(self, name: str = "run", registry=None):
        self.name = name
        self.registry = registry
        self.spans: List[Span] = []
        self._epoch = time.perf_counter()
        # Wall-clock anchor for the monotonic span epoch: a span's
        # absolute time is ``epoch_unix + ts_us/1e6``.  graft-xray uses
        # this to merge per-process traces onto one fleet timeline.
        self.epoch_unix = time.time()

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a phase; nested spans render nested in Perfetto.

        Inside a :func:`~arrow_matrix_tpu_torch.obs.flight.request_context`
        scope the span args carry ``request_id`` (and ``tenant``), so
        one Perfetto track reconstructs a served request end-to-end —
        admission, batch formation, supervised attempts, kernel phases
        — across the threads that handled it (explicit attrs win)."""
        args = dict(attrs)
        ctx = flight.current_request()
        if ctx is not None:
            for k, v in ctx.items():
                args.setdefault(k, v)
        tic = time.perf_counter()
        try:
            with _device_annotation(name):
                yield args
        except BaseException as exc:
            args.setdefault("error", f"{type(exc).__name__}: {exc}")
            raise
        finally:
            toc = time.perf_counter()
            self.spans.append(Span(
                name=name,
                ts_us=(tic - self._epoch) * 1e6,
                dur_us=(toc - tic) * 1e6,
                args=args,
            ))
            if self.registry is not None:
                self.registry.record("span_ms", (toc - tic) * 1e3,
                                     run=self.name, span=name)
            # Mirror into the flight recorder ring (no-op unless
            # installed): the last completed spans name the phase a
            # wedge killed.
            flight.record("span", name, ms=(toc - tic) * 1e3,
                          **({"error": args["error"]}
                             if "error" in args else {}))

    def phase_ms(self) -> Dict[str, float]:
        """Total host ms per span name."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.dur_us / 1e3
        return out

    def to_chrome_trace(self) -> dict:
        events = []
        for s in self.spans:
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": s.ts_us,
                "dur": s.dur_us,
                "pid": 1,
                "tid": s.tid,
                "args": s.args,
            })
        # Chronological order helps Perfetto's importer nest events.
        events.sort(key=lambda e: e["ts"])
        events.insert(0, {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "args": {"name": self.name},
        })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_chrome_trace(), fh, indent=1)
        return path


def timed(fn) -> float:
    """Seconds for one call of ``fn``, blocking on its result so async
    dispatch cannot fake an instant return."""
    t0 = time.perf_counter()
    block_until_ready(fn())
    return time.perf_counter() - t0


def call_time_ms(fn, *args, iters: int = 5, warmup: int = 1,
                 registry=None, name: str = "call", **labels) -> float:
    """Mean ms per call of ``fn(*args)`` with fixed arguments, so every
    profiler times one way.

    Unlike :func:`iteration_time_ms` the output is NOT fed back (the
    per-level launches a profile times take operands of differing
    shapes); every call is individually blocked until ready, so a
    slow first wave cannot hide behind async dispatch.  Records each
    sample into ``registry`` as ``call_time_ms`` when one is given.
    """
    for _ in range(max(warmup, 0)):
        block_until_ready(fn(*args))
    samples: List[float] = []
    for _ in range(max(iters, 1)):
        ms = timed(lambda: fn(*args)) * 1e3
        samples.append(ms)
        if registry is not None:
            registry.record("call_time_ms", ms, call=name, **labels)
    return sum(samples) / len(samples)


def iteration_time_ms(step_fn, x, iters: int, warmup: int = 1,
                      registry=None, name: str = "step",
                      **labels) -> List[float]:
    """Per-iteration device time: block_until_ready around each step.

    Feeds each output back as the next input (the bench's
    ``X := A @ X`` pattern).  Records every sample into ``registry``
    as ``iteration_time_ms`` when one is given.
    """
    for _ in range(max(warmup, 0)):
        x = block_until_ready(step_fn(x))
    out: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        x = block_until_ready(step_fn(x))
        ms = (time.perf_counter() - t0) * 1e3
        out.append(ms)
        if registry is not None:
            registry.record("iteration_time_ms", ms, step=name, **labels)
    return out


def chained_sampler(run_fn, x, iters: int, clock=time.perf_counter):
    """Compile-and-warm a chained measurement, return a zero-arg
    callable producing one ms/iter sample per call.

    Splitting compile/warmup from sampling lets a caller timing MANY
    programs (per-level prefixes) interleave sampling
    sweeps across all of them and take per-program minima: slow host
    load drift then lands on whole sweeps instead of whole programs,
    and the minimum discards it.  ``clock`` reads seconds (the wall
    clock; ``time.process_time`` times work that runs on this process's
    own threads, as the plain versions on the CPU do)."""
    def chain(n: int) -> float:
        t0 = clock()
        xd = run_fn(x, n) if n else x
        xd[0, 0].item()         # a host fetch: waits for the device
        return clock() - t0

    chain(iters)  # compile + warmup at the benchmark length
    rtt = min(chain(0) for _ in range(3))

    def sample() -> float:
        return max((chain(iters) - rtt) / iters, 1e-9) * 1e3

    return sample


def chained_iteration_ms(run_fn, x, iters: int) -> float:
    """ms/iter via a chained run (``run_fn(x, iters)``) ending in a
    scalar host fetch, with the dispatch+fetch round trip subtracted."""
    return chained_sampler(run_fn, x, iters)()

"""The port's tracer (``arrow_matrix_tpu_torch.obs.tracer``) and its
profiler context (``utils/logging.trace``) against the JAX package's
tracer: the same spans, nesting, ``error`` args, request stamps and
Chrome-trace document apart from times; the timing helpers on CPU
tensors; and ``trace(device="cpu")`` writing a profile that holds the
tracer's spans as annotations."""

import json
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu import obs as jobs
from arrow_matrix_tpu.obs import flight as jflight
from arrow_matrix_tpu_torch import obs as pobs
from arrow_matrix_tpu_torch.obs import flight as pflight
from arrow_matrix_tpu_torch.utils import logging as wb

torch.set_num_threads(2)

PKGS = {"jax": (jobs, jflight), "port": (pobs, pflight)}


def _scenario(obs, flight):
    """Nested spans, attrs set inside, a failing span, and spans inside
    a request context (explicit attrs win over the context's keys)."""
    reg = obs.MetricsRegistry()
    tr = obs.Tracer("myrun", registry=reg)
    with tr.span("outer"):
        with tr.span("inner", detail=7) as args:
            args["extra"] = "x"
    with pytest.raises(ValueError):
        with tr.span("fails", step=2):
            raise ValueError("bad phase")
    with flight.request_context("r0001+r0002", tenant="t1"):
        with tr.span("batch", k=128):
            with tr.span("admission", tenant="explicit"):
                pass
    with flight.request_context("r0003", tenant="t2", trace_id="abc"):
        with tr.span("finalize"):
            pass
    return tr, reg


def _timeless(doc):
    out = json.loads(json.dumps(doc))
    for e in out["traceEvents"]:
        e.pop("ts", None)
        e.pop("dur", None)
    return out


def test_spans_and_chrome_trace_equal_jax_apart_from_times():
    (jtr, jreg), (ptr, preg) = (_scenario(*PKGS["jax"]),
                                _scenario(*PKGS["port"]))
    assert [(s.name, s.tid, s.args) for s in ptr.spans] == \
        [(s.name, s.tid, s.args) for s in jtr.spans]
    # nesting: a child span ends before its parent is appended
    assert [s.name for s in ptr.spans] == [
        "inner", "outer", "fails", "admission", "batch", "finalize"]
    outer, inner = ptr.spans[1], ptr.spans[0]
    assert outer.ts_us <= inner.ts_us
    assert inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us
    assert ptr.spans[2].args["error"] == "ValueError: bad phase"
    assert _timeless(ptr.to_chrome_trace()) == \
        _timeless(jtr.to_chrome_trace())
    assert ptr.phase_ms().keys() == jtr.phase_ms().keys()
    assert preg.histogram("span_ms", run="myrun", span="inner").summary(
    )["count"] == jreg.histogram("span_ms", run="myrun",
                                 span="inner").summary()["count"] == 1
    assert abs(ptr.epoch_unix - jtr.epoch_unix) < 60


def test_request_id_is_stamped_inside_request_context():
    tr = pobs.Tracer()
    with tr.span("before"):
        pass
    with pflight.request_context("r0007", tenant="tenant3"):
        with tr.span("inside"):
            with pflight.request_context("r0007"):
                with tr.span("reentered"):
                    pass
    with tr.span("after"):
        pass
    args = {s.name: s.args for s in tr.spans}
    assert args["before"] == args["after"] == {}
    assert args["inside"] == {"request_id": "r0007", "tenant": "tenant3"}
    assert args["reentered"]["request_id"] == "r0007"
    assert args["reentered"]["tenant"] == "tenant3"


def test_spans_mirror_into_the_flight_recorder(tmp_path):
    docs = {}
    for name, (obs, flight) in PKGS.items():
        rec = flight.install(str(tmp_path / f"{name}.json"))
        try:
            _scenario(obs, flight)
        finally:
            flight.set_recorder(None)
        docs[name] = [(e["kind"], e["name"], sorted(e.get("data", {})))
                      for e in rec.snapshot()["events"]
                      if e["kind"] == "span"]
    assert docs["port"] == docs["jax"]
    assert len(docs["port"]) == 6


def test_save_writes_the_document(tmp_path):
    tr, _ = _scenario(*PKGS["port"])
    path = tr.save(str(tmp_path / "sub" / "t.trace.json"))
    with open(path, encoding="utf-8") as fh:
        assert json.load(fh) == json.loads(json.dumps(tr.to_chrome_trace()))


def test_timing_helpers_on_cpu_tensors():
    reg = pobs.MetricsRegistry()
    x = torch.ones(4, 3)
    assert 0.0 <= pobs.timed(lambda: x @ x.T) < 5.0
    calls = []

    def step(t):
        calls.append(float(t[0, 0]))
        return t + 1

    samples = pobs.iteration_time_ms(step, x, iters=3, warmup=1,
                                     registry=reg, algorithm="toy")
    assert len(samples) == 3 and all(s >= 0 for s in samples)
    assert calls == [1.0, 2.0, 3.0, 4.0]
    assert reg.histogram("iteration_time_ms", step="step",
                         algorithm="toy").summary()["count"] == 3
    ms = pobs.call_time_ms(lambda a, b: a @ b, x, x.T, iters=3,
                           registry=reg, name="mm")
    assert ms >= 0
    assert reg.histogram("call_time_ms", call="mm").summary()["count"] == 3

    def run(t, n):
        for _ in range(n):
            t = t * 1.0001
        return t

    assert pobs.chained_iteration_ms(run, torch.ones(8, 8), 4) > 0
    # the JAX helper on the same host callable gives a positive number too
    assert jobs.chained_iteration_ms(
        lambda a, n: a + n, np.ones((2, 2), np.float32), 2) > 0


def test_trace_on_the_cpu_holds_the_spans(tmp_path):
    tr = pobs.Tracer("traced")
    with wb.trace(str(tmp_path / "traces"), device="cpu") as prof:
        with tr.span("outer_phase"):
            with tr.span("inner_phase"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.path) == str(tmp_path / "traces")
    assert os.path.exists(prof.path)
    assert {"outer_phase", "inner_phase"} <= set(prof.annotations)
    assert prof.kernels == [] and prof.device == torch.device("cpu")
    assert prof.wall_us > 0
    with open(prof.path, encoding="utf-8") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"outer_phase", "inner_phase"} <= names


def test_trace_asks_for_the_card_unless_told_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with wb.trace(str(tmp_path / "t")):
            pass
    assert not os.path.exists(str(tmp_path / "t"))
    assert issubclass(wb.ProfilerTraceEmpty, RuntimeError)

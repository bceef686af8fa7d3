"""The port's fleet tracing (``arrow_matrix_tpu_torch.obs.xray``) against
the JAX package's: per-process trace documents, the clock-aligned merge,
flight-ring recovery, a run directory's merge, the per-class critical
path, its compute breakdown, the report and the report diff give the
same output from both packages on the same synthetic documents (drawn
from a seed with numpy), and the pinned segment arithmetic holds."""

import json
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.obs import flight as jflight
from arrow_matrix_tpu.obs import tracer as jtracer
from arrow_matrix_tpu.obs import xray as jxray
from arrow_matrix_tpu_torch.obs import flight as pflight
from arrow_matrix_tpu_torch.obs import tracer as ptracer
from arrow_matrix_tpu_torch.obs import xray as pxray

torch.set_num_threads(2)

PKGS = {"jax": (jxray, jtracer, jflight), "port": (pxray, ptracer, pflight)}
NAMES = ("dispatch", "rpc", "admission", "batch", "checkpoint", "resume",
         "finalize", "attempt")


def _doc(process, epoch, spans, truncated=False):
    return {"schema": 1, "process": process, "pid": 1,
            "epoch_unix": epoch, "truncated": truncated,
            "spans": [{"name": n, "ts_us": ts, "dur_us": d, "tid": 0,
                       "args": dict(a)} for (n, ts, d, a) in spans]}


def _random_docs(seed, workers=3, requests=6):
    """A router and ``workers`` worker docs over ``requests`` requests,
    with batch-shared spans, RPC accounting and traffic classes."""
    rng = np.random.default_rng(seed)
    rids = [f"r{i:03d}" for i in range(requests)]
    router = []
    for rid in rids:
        t0 = float(rng.uniform(0, 1e5))
        router.append(("dispatch", t0, float(rng.uniform(5e4, 9e4)),
                       {"request_id": rid}))
        router.append(("rpc", t0 + float(rng.uniform(1e3, 5e3)),
                       float(rng.uniform(2e4, 4e4)),
                       {"request_id": rid,
                        "serialize_ms": float(rng.uniform(0, 3)),
                        "wire_ms": float(rng.uniform(0, 3))}))
    docs = [_doc("router", 1000.0, router)]
    for w in range(workers):
        spans = []
        mine = rids[w::workers]
        batch = "+".join(mine)
        for rid in mine:
            t = float(rng.uniform(0, 1e5))
            spans.append(("admission", t, float(rng.uniform(100, 900)),
                          {"request_id": rid}))
        t = float(rng.uniform(1e5, 2e5))
        spans.append(("batch", t, float(rng.uniform(1e4, 3e4)),
                      {"request_id": batch,
                       "traffic_class": "approx" if w % 2 else "exact"}))
        spans.append(("checkpoint", t + 10, float(rng.uniform(100, 2e3)),
                      {"request_id": batch}))
        spans.append(("finalize", t + 3e4, float(rng.uniform(50, 500)),
                      {"request_id": batch}))
        docs.append(_doc(f"w{w}", 1000.0 + float(rng.uniform(-0.5, 0.5)),
                         spans, truncated=(w == workers - 1)))
    offsets = {f"w{w}": {"offset_ns": int(rng.integers(-5e8, 5e8))}
               for w in range(workers)}
    offsets["w0"] = int(offsets["w0"]["offset_ns"])    # a bare number
    return docs, offsets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_critical_path_and_reports_equal_jax(seed):
    docs, offsets = _random_docs(seed)
    out = {}
    for pkg, (xr, _, _) in PKGS.items():
        merged = xr.merge_process_traces(list(reversed(docs)),
                                         offsets_ns=offsets)
        classes = {"r000": "approx"}
        cp = xr.critical_path(merged, classes=classes)
        fractions = {"exact": {"L0:fold": 0.75, "other": 0.25},
                     "approx": {"L0:fold": 1.0}}
        sub = xr.subdivide_compute(cp, fractions)
        base = xr.critical_path(xr.merge_process_traces(docs))
        out[pkg] = (merged, cp, sub, xr.format_report(sub),
                    xr.diff_reports(base, cp),
                    xr.diff_reports(cp, base, rel_threshold=0.0,
                                    abs_floor_ms=0.0))
    assert json.dumps(out["port"], sort_keys=True) == \
        json.dumps(out["jax"], sort_keys=True)
    merged, cp = out["port"][0], out["port"][1]
    assert min(e["ts"] for e in merged["traceEvents"] if e["ph"] == "X") \
        == 0.0
    assert merged["xray"]["truncated"] == ["w2"]
    assert set(cp["requests"]) == {f"r{i:03d}" for i in range(6)}
    assert cp["requests"]["r000"]["class"] == "approx"


def _ev(name, ts_us, dur_us, pid, args):
    return {"name": name, "ph": "X", "ts": float(ts_us),
            "dur": float(dur_us), "pid": pid, "tid": 0, "args": args}


def test_critical_path_segment_math_is_pinned():
    rid = "rq1"
    events = [
        _ev("dispatch", 0, 100_000, 0, {"request_id": rid}),
        _ev("rpc", 10_000, 80_000, 0,
            {"request_id": rid, "serialize_ms": 2.0, "wire_ms": 3.0}),
        _ev("admission", 12_000, 1_000, 1, {"request_id": rid}),
        _ev("batch", 20_000, 40_000, 1,
            {"request_id": rid, "traffic_class": "approx"}),
        _ev("checkpoint", 30_000, 5_000, 1, {"request_id": rid}),
        _ev("finalize", 61_000, 2_000, 1, {"request_id": rid}),
    ]
    cp = pxray.critical_path({"traceEvents": events})
    assert cp == jxray.critical_path({"traceEvents": events})
    r = cp["requests"][rid]
    seg = r["segments"]
    assert r["class"] == "approx" and r["total_ms"] == pytest.approx(100.0)
    assert (seg["queue"], seg["admission"], seg["serialize"], seg["wire"]) \
        == pytest.approx((10.0, 1.0, 2.0, 3.0))
    assert (seg["worker_queue"], seg["checkpoint"], seg["compute"],
            seg["response"]) == pytest.approx((7.0, 5.0, 35.0, 12.0))
    shared = [_ev("dispatch", 0, 50_000, 0, {"request_id": "a"}),
              _ev("rpc", 0, 50_000, 0, {"request_id": "a"}),
              _ev("batch", 10_000, 20_000, 1, {"request_id": "a+b"})]
    cp = pxray.critical_path({"traceEvents": shared})
    assert cp == jxray.critical_path({"traceEvents": shared})
    assert cp["requests"]["a"]["segments"]["compute"] == \
        cp["requests"]["b"]["segments"]["compute"] == pytest.approx(10.0)


def test_process_trace_docs_equal_jax_apart_from_times(tmp_path):
    docs = {}
    for pkg, (xr, tr_mod, flight) in PKGS.items():
        tr = tr_mod.Tracer(name="t")
        with flight.request_context("rq9", "t0", trace_id="deadbeef"):
            with tr.span("work", k=4):
                with tr.span("inner"):
                    pass
        doc = xr.process_trace(tr, "w9", truncated=True)
        path = xr.save_process_trace(tr, str(tmp_path / pkg / "x.json"),
                                     "w9")
        with open(path, encoding="utf-8") as fh:
            saved = json.load(fh)
        assert saved["process"] == "w9" and saved["truncated"] is False
        router = xr.save_router_trace(tr, str(tmp_path / pkg / "run"))
        assert os.path.basename(router) == "router_xray.json"
        for s in doc["spans"]:
            s.pop("ts_us")
            s.pop("dur_us")
        doc.pop("epoch_unix")
        docs[pkg] = doc
    assert docs["port"] == docs["jax"]
    assert docs["port"]["pid"] == os.getpid()
    assert docs["port"]["spans"][1]["args"] == {
        "k": 4, "request_id": "rq9", "tenant": "t0",
        "trace_id": "deadbeef"}
    assert len(pxray.new_trace_id()) == 16
    assert pxray.new_trace_id() != pxray.new_trace_id()


def _flight_artifact(flight, path):
    rec = flight.FlightRecorder(path)
    flight.set_recorder(rec)
    try:
        with flight.request_context("rq7", "tz", trace_id="feed"):
            flight.record("span", "batch", ms=12.5)
            flight.record("span", "finalize", ms=0.5, error="x")
        flight.record("fleet", "router_up")    # not a span: ignored
    finally:
        flight.set_recorder(None)
    rec.seal("killed")


def test_recover_from_flight_equals_jax(tmp_path):
    path = str(tmp_path / "flight.json")
    _flight_artifact(pflight, path)
    ours = pxray.recover_from_flight(path, "worker-1")
    assert ours == jxray.recover_from_flight(path, "worker-1")
    assert ours["truncated"] is True and ours["epoch_unix"] == 0.0
    assert [s["name"] for s in ours["spans"]] == ["batch", "finalize"]
    s = ours["spans"][0]
    assert s["args"] == {"request_id": "rq7", "tenant": "tz",
                         "trace_id": "feed", "truncated": True,
                         "recovered_from": "flight_ring"}
    assert s["dur_us"] == pytest.approx(12_500.0)
    assert pxray.recover_from_flight(str(tmp_path / "no.json"), "x") is None
    with open(tmp_path / "bad.json", "w") as fh:
        fh.write("{torn")
    assert pxray.recover_from_flight(str(tmp_path / "bad.json"), "x") is None


def test_merge_run_dir_equals_jax(tmp_path):
    """A run directory: the router's doc, one worker's sealed doc, one
    killed worker's flight ring, and the fleet report's offsets."""
    docs, offsets = _random_docs(5, workers=2)
    run = tmp_path / "run"
    (run / "w0").mkdir(parents=True)
    (run / "w1").mkdir()
    (run / "notes.txt").write_text("not a worker")
    with open(run / "router_xray.json", "w") as fh:
        json.dump(docs[0], fh)
    with open(run / "w0" / "xray_trace.json", "w") as fh:
        json.dump(docs[1], fh)
    _flight_artifact(pflight, str(run / "w1" / "flight.json"))
    with open(run / "fleet_report.json", "w") as fh:
        json.dump({"clock_offsets_ns": offsets}, fh)
    ours = pxray.merge_run_dir(str(run))
    assert ours == jxray.merge_run_dir(str(run))
    assert ours["xray"]["truncated"] == ["w1"]
    assert pxray.merge_run_dir(str(run), report={}) == \
        jxray.merge_run_dir(str(run), report={})
    path = pxray.save_fleet_trace(ours, str(run))
    with open(path) as fh:
        assert json.load(fh) == json.loads(json.dumps(ours))


def _run_dir(tmp_path):
    docs, offsets = _random_docs(7, workers=2)
    run = tmp_path / "run"
    (run / "w0").mkdir(parents=True)
    (run / "w1").mkdir()
    with open(run / "router_xray.json", "w") as fh:
        json.dump(docs[0], fh)
    for w in (0, 1):
        with open(run / f"w{w}" / "xray_trace.json", "w") as fh:
            json.dump(docs[1 + w], fh)
    with open(run / "fleet_report.json", "w") as fh:
        json.dump({"clock_offsets_ns": offsets}, fh)
    return run


def test_report_with_a_lens_profile_splits_compute_as_jax(tmp_path,
                                                           capsys):
    """``graft_xray report --lens PROFILE`` splits each class's compute
    segment by the profile's per-tier attribution (the exact class by
    f32, approx by bf16), as the JAX CLI does."""
    from arrow_matrix_tpu.cli import graft_xray as jcli
    from arrow_matrix_tpu_torch.cli import graft_xray as pcli

    run = _run_dir(tmp_path)
    profile = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_results", "lens",
        "ba_256_3_profile.json")
    outs = {}
    for name, cli in (("port", pcli), ("jax", jcli)):
        out = tmp_path / f"{name}.json"
        assert cli.main(["report", str(run), "--lens", profile, "--out",
                         str(out)]) == 0
        outs[name] = json.loads(out.read_text())
        text = capsys.readouterr().out
        assert json.loads(text.strip().splitlines()[-1])["ok"]
    assert outs["port"] == outs["jax"]
    per_class = outs["port"]["per_class"]
    assert per_class
    for cls, agg in per_class.items():
        split = agg["compute_breakdown_ms"]
        assert any(label.startswith("L0:") for label in split)
        assert sum(split.values()) == pytest.approx(
            agg["segments_mean_ms"]["compute"], rel=1e-4, abs=1e-5)


def test_memory_report_on_the_cpu_reads_the_tensors():
    from arrow_matrix_tpu_torch.obs import MetricsRegistry, memview

    x = torch.ones((32, 16))
    rep = memview.memory_report(lambda v: v @ v.T, x)
    assert rep["source"] == "tensors"
    assert rep["argument_bytes"] == 32 * 16 * 4
    assert rep["output_bytes"] == 32 * 32 * 4
    assert rep["temp_bytes"] is None
    assert rep["total_bytes"] == (32 * 16 + 32 * 32) * 4
    reg = MetricsRegistry()
    acc = memview.account_memory("toy", lambda v: v @ v.T, x,
                                 predicted_bytes=1024, registry=reg)
    assert acc["ratio"] == acc["measured_bytes"] / 1024
    assert reg.gauge("hbm_measured_bytes",
                     algorithm="toy").value == acc["measured_bytes"]
    assert "measured vs format-model prediction" in \
        memview.format_memory_report(acc)
    assert memview.account_memory("toy", lambda v: v, x)["ratio"] is None


def test_memory_report_of_a_fold_step_counts_the_operator():
    from arrow_matrix_tpu_torch.obs import memview
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import barabasi_albert
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition

    levels = arrow_decomposition(barabasi_albert(400, 3, seed=1), 32,
                                 max_levels=10, block_diagonal=True, seed=1)
    exe = MultiLevelArrow(levels, 32, fmt="fold", device="cpu")
    x = exe.set_features(np.ones((exe.n, 8), np.float32))
    rep = memview.memory_report(exe.raw_step, x, exe.sell)
    assert rep["argument_bytes"] == x.nbytes + exe.sell.device_nbytes()
    assert rep["output_bytes"] == x.nbytes
    assert rep["total_bytes"] <= exe.predicted_hbm_bytes(8)

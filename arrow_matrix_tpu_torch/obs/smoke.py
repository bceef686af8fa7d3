"""Reduced-scale smoke run of all five mesh algorithms, with their traces.

The port of ``arrow_matrix_tpu/obs/smoke.py``.  :func:`run_smoke` runs
in every rank of a launched world (``parallel/launch.py``; the world is
``n_dev`` ranks) and rank 0 writes one inspectable run directory:

* ``<algo>.trace.json`` — a Perfetto-loadable phase trace a algorithm
  (build / comm_account / mem_account / warmup / iterate with a span a
  step / gather_result);
* ``metrics.jsonl`` — the registry's events: each step's time
  (``iteration_time_ms``), the counted collective bytes against the
  ideal, the measured device bytes against the prediction, and the
  load-imbalance gauges;
* ``summary.json`` — per algorithm the phase totals, step times, bytes
  against ideal, memory report and imbalance report, with the JAX
  smoke's keys: what ``graft_trace summarize`` and ``diff`` read;
* ``ledger/`` — the run-local ledger record of the smoke's headline.

The adapters build the port's executors with the JAX smoke's generators,
seeds and meshes: ``(n_dev,)`` slices, the ``(n_dev/c, c)`` grid, and
``(kl, n_dev/kl)`` for ``sell_space``; each makes its own mesh (its own
groups).  Collective bytes are this rank's, counted by the collective
layer (``obs/comm.account_collectives``, source ``"counted"``); memory
is ``obs/memview.account_memory``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from arrow_matrix_tpu_torch.obs.comm import (
    account_collectives,
    ideal_bytes_for,
    reduce_bytes_for,
)
from arrow_matrix_tpu_torch.obs.imbalance import account_imbalance
from arrow_matrix_tpu_torch.obs.memview import (
    account_memory,
    predicted_bytes_for,
)
from arrow_matrix_tpu_torch.obs.metrics import MetricsRegistry
from arrow_matrix_tpu_torch.obs.tracer import Tracer
from arrow_matrix_tpu_torch.utils.logging import block_until_ready

ALGORITHMS = ("spmm_1d", "spmm_15d", "sell_slim", "sell_space",
              "multi_level")


def _adapters(n: int, width: int, k: int, n_dev: int,
              algorithms: Iterable[str]):
    """Yield (name, build) pairs; ``build()`` returns ``(obj, x, step,
    operands)``: ``step(x)`` is one feature-carrying iteration and
    ``operands`` the rank's device operands a memory report counts."""
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.utils.graphs import (
        barabasi_albert,
        random_csr,
        random_dense,
    )

    wanted = set(algorithms)
    unknown = wanted - set(ALGORITHMS)
    if unknown:
        raise ValueError(f"unknown algorithms {sorted(unknown)}; "
                         f"choose from {ALGORITHMS}")

    a = random_csr(n, n, 4, seed=7).astype(np.float32)
    x_host = random_dense(n, k, seed=3)
    # The arrow decomposition shared by the slim and arrow paths.
    arrow_state: dict = {}

    def arrow_levels():
        if not arrow_state:
            from arrow_matrix_tpu_torch.decomposition import (
                arrow_decomposition,
            )

            ba = barabasi_albert(n, 4, seed=11)
            arrow_state["ba"] = ba
            arrow_state["levels"] = arrow_decomposition(
                ba, width, max_levels=3, block_diagonal=True, seed=1)
        return arrow_state["ba"], arrow_state["levels"]

    if "spmm_1d" in wanted:
        def build_1d():
            from arrow_matrix_tpu_torch.parallel.spmm_1d import MatrixSlice1D

            d = MatrixSlice1D(a, make_mesh((n_dev,), ("slices",)))
            return d, d.set_features(x_host), d.spmm, d.step_operands()

        yield "spmm_1d", build_1d

    if "spmm_15d" in wanted:
        def build_15d():
            from arrow_matrix_tpu_torch.parallel.spmm_15d import SpMM15D

            c = 2 if n_dev % 4 == 0 else 1
            d = SpMM15D(a, make_mesh((n_dev // c, c), ("rows", "repl")))

            def step(v):
                # A result block re-enters as features (square: n x n).
                return d.spmm(d.as_features(v))

            return d, d.set_features(x_host), step, d.step_operands()

        yield "spmm_15d", build_15d

    if "sell_slim" in wanted:
        def build_slim():
            from arrow_matrix_tpu_torch.parallel.sell_slim import SellSlim

            _, levels = arrow_levels()
            ds = SellSlim(levels[0].matrix, width,
                          make_mesh((n_dev,), ("blocks",)))
            x = ds.set_features(random_dense(levels[0].matrix.shape[0], k,
                                             seed=5))
            return ds, x, ds.spmm, ds.step_operands()

        yield "sell_slim", build_slim

    if "sell_space" in wanted:
        def build_space():
            from arrow_matrix_tpu_torch.parallel.sell_space import (
                SellSpaceShared,
            )

            _, levels = arrow_levels()
            kl = 2 if (len(levels) >= 2 and n_dev % 2 == 0) else 1
            ss = SellSpaceShared(levels[:kl], width,
                                 make_mesh((kl, n_dev // kl),
                                           ("lvl", "blocks")))
            x = ss.set_features(random_dense(ss.n, k, seed=5))
            return ss, x, ss.step, ss.step_operands()

        yield "sell_space", build_space

    if "multi_level" in wanted:
        def build_multi():
            from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

            ba, levels = arrow_levels()
            ml = MultiLevelArrow(levels, width,
                                 mesh=make_mesh((n_dev,), ("blocks",)))
            x = ml.set_features(x_host[:ba.shape[0]])
            return ml, x, ml.step, ml.step_operands()

        yield "multi_level", build_multi


def run_smoke(run_dir: str, n: int = 256, width: int = 32, k: int = 4,
              n_dev: int = 4, iters: int = 3,
              algorithms: Iterable[str] = ALGORITHMS,
              registry: Optional[MetricsRegistry] = None) -> dict:
    """Trace, meter and account each algorithm at reduced scale in this
    rank of an ``n_dev``-rank world; rank 0 writes the run directory.
    Returns the summary dict (rank 0's is the one written)."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_dev:
        raise ValueError(f"run_smoke(n_dev={n_dev}) runs in a world of "
                         f"n_dev ranks; this one has {world}")
    writer = rank == 0
    if writer:
        os.makedirs(run_dir, exist_ok=True)
    reg = registry if registry is not None else MetricsRegistry(
        run_dir if writer else None)
    summary: Dict[str, dict] = {}

    for name, build in _adapters(n, width, k, n_dev, algorithms):
        tracer = Tracer(name=name, registry=reg)

        with tracer.span(f"{name}/build"):
            obj, x, step, operands = build()

        def call(v, *ops):
            return block_until_ready(step(v))

        with tracer.span(f"{name}/comm_account") as span_args:
            rep = account_collectives(
                name, call, x,
                ideal_bytes=ideal_bytes_for(obj, k),
                overlap_slabs=getattr(obj, "overlap_slabs", 1),
                repl=getattr(obj, "repl", 1),
                reduce_bytes=reduce_bytes_for(obj, k),
                registry=reg)
            span_args["measured_bytes"] = rep["measured_bytes"]
            span_args["source"] = rep["source"]

        with tracer.span(f"{name}/mem_account") as span_args:
            mem = account_memory(
                name, call, x, *operands,
                predicted_bytes=predicted_bytes_for(obj, k),
                registry=reg)
            span_args["measured_bytes"] = mem["measured_bytes"]
            span_args["source"] = mem["source"]
            imb = account_imbalance(name, obj, registry=reg)

        with tracer.span(f"{name}/warmup"):
            # Two calls: the second runs the result-feedback path.
            x = block_until_ready(step(x))
            x = block_until_ready(step(x))

        steps_ms: List[float] = []
        with tracer.span(f"{name}/iterate"):
            for i in range(iters):
                t0 = time.perf_counter()
                with tracer.span(f"{name}/step", iteration=i):
                    x = block_until_ready(step(x))
                ms = (time.perf_counter() - t0) * 1e3
                steps_ms.append(ms)
                reg.record("iteration_time_ms", ms, algorithm=name)

        with tracer.span(f"{name}/gather_result"):
            y = obj.gather_result(x)
        reg.gauge("result_norm", algorithm=name).set(
            float(np.linalg.norm(y)))

        trace_file = f"{name}.trace.json"
        if writer:
            tracer.save(os.path.join(run_dir, trace_file))
        summary[name] = {
            "trace": trace_file,
            "phase_ms": tracer.phase_ms(),
            "steps_ms": steps_ms,
            "step_ms_mean": sum(steps_ms) / max(len(steps_ms), 1),
            "measured_bytes": rep["measured_bytes"],
            "ideal_bytes": rep["ideal_bytes"],
            "bytes_vs_ideal": rep["ratio"],
            "comm_source": rep["source"],
            "overlap_slabs": rep["overlap_slabs"],
            "exposed_comm_ms": rep["exposed_comm_ms"],
            "repl": rep["repl"],
            "reduce_bytes": rep["reduce_bytes"],
            "hbm_measured_bytes": mem["measured_bytes"],
            "hbm_predicted_bytes": mem["predicted_bytes"],
            "hbm_vs_predicted": mem["ratio"],
            "hbm_source": mem["source"],
            "memory": mem["report"],
            "imbalance": None if imb is None else {
                key: imb[key] for key in (
                    "units", "n_units", "rows_total", "nnz_total",
                    "slots_total", "nnz_max_over_mean",
                    "rows_max_over_mean", "padded_slot_waste")},
        }

    out = {
        "scale": {"n": n, "width": width, "k": k, "n_dev": n_dev,
                  "iters": iters},
        "algorithms": summary,
    }
    if not writer:
        return out
    # The run's headline (the slowest algorithm's mean step) in a
    # run-dir-local ledger; its record id rides the summary.
    try:
        from arrow_matrix_tpu_torch.ledger import record as _ledger_record

        worst = max((alg["step_ms_mean"] for alg in summary.values()),
                    default=None)
        rec = _ledger_record(
            "smoke", "smoke_step_ms", worst,
            directory=os.path.join(run_dir, "ledger"), unit="ms",
            knobs=dict(out["scale"]),
            payload={name: {"step_ms_mean": alg["step_ms_mean"],
                            "bytes_vs_ideal": alg["bytes_vs_ideal"],
                            "hbm_vs_predicted": alg["hbm_vs_predicted"]}
                     for name, alg in summary.items()})
        out["ledger_record_id"] = rec["record_id"] if rec else None
    except Exception as e:
        print(f"[ledger] smoke record not persisted: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        out["ledger_record_id"] = None
    reg.write_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    with open(os.path.join(run_dir, "summary.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return out


def validate_run_dir(run_dir: str,
                     algorithms: Iterable[str] = ALGORITHMS) -> List[str]:
    """Structural check of a smoke run directory; the problems found
    (empty: valid)."""
    problems: List[str] = []
    spath = os.path.join(run_dir, "summary.json")
    if not os.path.isfile(spath):
        return [f"missing {spath}"]
    try:
        with open(spath, encoding="utf-8") as fh:
            summary = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"unreadable summary.json: {e}"]
    algos = summary.get("algorithms", {})

    for name in algorithms:
        if name not in algos:
            problems.append(f"summary.json missing algorithm {name!r}")
            continue
        rec = algos[name]
        tpath = os.path.join(run_dir, rec.get("trace", f"{name}.trace.json"))
        if not os.path.isfile(tpath):
            problems.append(f"missing trace file {tpath}")
        else:
            try:
                with open(tpath, encoding="utf-8") as fh:
                    trace = json.load(fh)
                events = [e for e in trace.get("traceEvents", ())
                          if e.get("ph") == "X"]
                if not events:
                    problems.append(f"{tpath}: no complete ('X') events")
                for e in events:
                    if not all(f in e for f in ("name", "ph", "ts", "dur")):
                        problems.append(
                            f"{tpath}: malformed event {e!r}")
                        break
                names = {e["name"] for e in events}
                for phase in ("build", "warmup", "iterate", "step",
                              "gather_result", "comm_account",
                              "mem_account"):
                    if f"{name}/{phase}" not in names:
                        problems.append(
                            f"{tpath}: missing span {name}/{phase}")
            except (OSError, ValueError) as e:
                problems.append(f"malformed trace JSON {tpath}: {e}")
        if not rec.get("steps_ms"):
            problems.append(f"summary.json: {name} has no steps_ms")
        if rec.get("hbm_measured_bytes") is None:
            problems.append(
                f"summary.json: {name} has no memory report "
                f"(hbm_measured_bytes)")
        if rec.get("imbalance") is None:
            problems.append(
                f"summary.json: {name} has no imbalance report")

    mpath = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.isfile(mpath):
        problems.append(f"missing {mpath}")
    else:
        seen: Dict[Tuple[str, str], bool] = {}
        try:
            with open(mpath, encoding="utf-8") as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    ev = json.loads(line)
                    algo = ev.get("labels", {}).get("algorithm")
                    if algo:
                        seen[(ev["name"], algo)] = True
        except (ValueError, KeyError) as e:
            problems.append(f"malformed metrics.jsonl: {e}")
        else:
            for name in algorithms:
                for metric in ("iteration_time_ms", "comm_measured_bytes",
                               "hbm_measured_bytes"):
                    if not seen.get((metric, name)):
                        problems.append(
                            f"metrics.jsonl: no {metric} events for {name}")
    return problems

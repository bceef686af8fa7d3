"""The port's protocol benchmark: ``spmm_iter_ms`` on the card.

Counterpart of the root ``bench.py``'s headline race (which stays the
JAX package's).  Measures milliseconds per iteration of ``X := A @ X``
through a whole arrow decomposition on one card at the protocol shape
(Barabasi-Albert n = 2^20, m = 8, width 2048, ``max_levels`` 12, k =
16, 10 chained iterations, then k = 128 on the winner), gated by the
relative Frobenius error of one step against the host golden
``decomposition_spmm`` at ``relative_tolerance(nnz/n, 1)``, and compares
it with the same iterated product through scipy CSR on the host in the
same run.

    python -m arrow_matrix_tpu_torch.bench                # on the card
    python -m arrow_matrix_tpu_torch.bench --device cpu   # on the host

How it runs:

- The parent never touches the card.  It asks a subprocess with a
  timeout whether the card answers (``utils/platform.probe_card``),
  decomposes once (``backend="auto"``: the C++ decomposer when it
  builds, numpy otherwise) into a cache keyed by the backend
  (``tools/gather_probe.cached_levels``; ``AMT_BENCH_CACHE_DIR``,
  default ``arrow_matrix_tpu_torch/_build/cache``), and times the scipy
  baseline.
- Each candidate of the race (``fold``, ``fold_tight``, ``hyb``,
  ``auto``; ``AMT_BENCH_FMT`` names others, comma-separated) builds and
  measures in its own subprocess with a hard timeout, so that a hung
  card costs one candidate.  After a timeout the card is probed again,
  and the race stops as ``accelerator_wedged`` if it does not answer.
- The winner is the fastest candidate within the gate; one more
  subprocess measures it at k = 128, gated on the first 16 columns, and
  the fold's bf16 carriage beside it.
- On the card, the kernel comparison (``AMT_BENCH_COMPARE``: "auto" on
  the card, "1"/"0" force) times each variant of ``COMPARE_VARIANTS``
  at ``COMPARE_CONFIG``.  The reference's ``pallas`` and
  ``pallas_bf16`` variants have no counterpart: on the card the port's
  ``dense`` already runs its hand-written block kernels (K2/K3).
- ``--overlap_slabs 1,2,4`` (``AMT_BENCH_OVERLAP_SWEEP``) and ``--repl
  1,2`` (``AMT_BENCH_REPL_SWEEP``) then measure the winning format at
  each overlap slab count S and the fold at each replication factor c,
  each point in its own subprocess and gated (``overlap_sweep`` and
  ``repl_sweep`` in the line), as the root ``bench.py`` does.
- ``AMT_BENCH_DEADLINE`` (3300 s; 0 turns it off) bounds the whole run.

The device rule differs on purpose from the root ``bench.py``'s
automatic degraded mode: the bench runs on the card; ``--device cpu``
runs it on the host with the plain PyTorch versions of the kernels (the
line then says ``"platform": "cpu", "degraded": true`` and carries no
roofline); with no card and no ``--device cpu`` it prints an ``error``
line and exits non-zero.  It never moves to the CPU by itself.

The last line of stdout is exactly one JSON object in ``bench.py``'s
field names (``metric``, ``value``, ``unit``, ``vs_baseline``, ...),
stamped as the port's ledger records are (``"platform": "gpu"`` and the
card's name on the card); the run exits non-zero iff it has no
``value``.  The same object lands in the port's ledger as one
``kind="bench"`` record (``AMT_LEDGER_DIR``, default
``bench_results/ledger_torch``; ``AMT_LEDGER=0`` turns it off), and it
carries the newest prior on-card capture as ``last_onchip`` (a "gpu"
record only, never the committed TPU captures).  Each candidate and
variant subprocess keeps a flight recorder
(``<cache dir>/flight/<name>.json``, ``AMT_FLIGHT_DIR``); a candidate
killed at its timeout names its file in its error.  ``bytes_per_iter_gb``
is the least the built executor must move an iteration (see
:func:`min_bytes_per_iter`), so ``roofline_frac`` (achieved bytes/s
over the card's peak, looked up by name) is at most 1 by construction.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

_T0 = time.perf_counter()
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Peak device-memory bytes/s by card name (public figures); a card not
#: listed gets no roofline.
PEAK_HBM_BYTES_S = {"H100 80GB HBM3": 3.35e12, "H100 SXM": 3.35e12}

#: Headline-race candidate name -> MultiLevelArrow build arguments.
CANDIDATE_KWARGS = {
    "fold": dict(fmt="fold"),
    "fold_tight": dict(fmt="fold", fold_growth=1.1, fold_align=1),
}
RACE = ("fold", "fold_tight", "hyb", "auto")

#: Kernel-comparison variants: cheap gather-family ones first.
COMPARE_VARIANTS = {
    "fold": dict(fmt="fold"),
    "fold_tight": CANDIDATE_KWARGS["fold_tight"],
    "fold_featbf16": dict(fmt="fold", feature_dtype="bf16"),
    "hyb": dict(fmt="hyb"),
    "ell": dict(fmt="ell"),
    "ell_headgell": dict(fmt="ell", head_fmt="gell"),
    "ell_headflat": dict(fmt="ell", head_fmt="flat"),
    "ell_headell": dict(fmt="ell", head_fmt="ell"),
    "dense": dict(fmt="dense"),
    "dense_bf16": dict(fmt="dense", dtype="bf16"),
}
COMPARE_CONFIG = dict(n=65536, m=8, width=2048, k=16, iters=10)


def _progress(msg: str) -> None:
    """Stage markers on stderr (stdout carries only the JSON line),
    mirrored into the flight recorder where one is installed (the
    candidate and variant subprocesses): its file survives the SIGKILL
    of a timeout, which loses the stderr pipe's tail."""
    print(f"[bench +{time.perf_counter() - _T0:.0f}s] {msg}",
          file=sys.stderr, flush=True)
    mod = sys.modules.get("arrow_matrix_tpu_torch.obs.flight")
    if mod is not None:
        mod.record("progress", msg)


def _flight_path(name: str) -> str:
    """The flight recorder's file of one bench subprocess, known to the
    subprocess that writes it and to the parent that names it on a
    timeout (``AMT_FLIGHT_DIR``, default ``<cache dir>/flight``)."""
    return os.path.join(
        os.environ.get("AMT_FLIGHT_DIR",
                       os.path.join(_cache_dir(), "flight")),
        f"{name}.json")


def _candidate_flight_name(fmt: str, cfg: dict) -> str:
    return (f"candidate_{fmt}_k128" if cfg.get("k128_run")
            else f"candidate_{fmt}")


def _install_flight(name: str):
    """Install the flight recorder in a bench subprocess (a ring of
    progress events flushed to disk as they come).  A failure to install
    it is reported and never costs the measurement."""
    try:
        from arrow_matrix_tpu_torch.obs import flight

        return flight.install(_flight_path(name))
    except Exception as e:
        print(f"[bench] flight recorder unavailable: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return None


def peak_bytes_s(device_kind: str):
    """The card's peak memory bytes/s by name, or None if not listed."""
    for key, rate in PEAK_HBM_BYTES_S.items():
        if key in (device_kind or ""):
            return rate
    return None


def _cache_dir() -> str:
    from arrow_matrix_tpu_torch.tools.gather_probe import CACHE_DIR

    return os.environ.get("AMT_BENCH_CACHE_DIR", CACHE_DIR)


def _bench_config(platform: str, fmt_override=None) -> dict:
    """The benchmark shape, from the platform and the ``AMT_BENCH_*``
    variables the root ``bench.py`` reads, with its defaults; shared by
    the parent and the candidate subprocesses (``AMT_BENCH_CFG``)."""
    degraded = platform == "cpu"
    if os.environ.get("AMT_BENCH_SMALL") == "1":
        cfg = dict(n=1 << 17, m=8, width=2048, k=16, iters=5, fmt="fold")
    elif degraded and os.environ.get("AMT_BENCH_FULL") != "1":
        cfg = dict(n=1 << 20, m=8, width=2048, k=16, iters=10,
                   fmt="fold")
    else:
        cfg = dict(n=1 << 20, m=8, width=2048, k=16, iters=10, fmt="auto")
    cfg["n"] = int(os.environ.get("AMT_BENCH_N", cfg["n"]))
    cfg["fmt"] = fmt_override or os.environ.get("AMT_BENCH_FMT",
                                                cfg["fmt"])
    # Enough levels to converge: at 2^20 / BA-8 the recursion ends after
    # 10 levels, all at the base width.
    cfg["max_levels"] = int(os.environ.get("AMT_BENCH_LEVELS", 12))
    cfg["degraded"] = degraded
    cfg["platform"] = platform
    cfg["k128"] = (cfg["k"] != 128
                   and os.environ.get("AMT_BENCH_K128",
                                      "0" if degraded else "1") == "1")
    # The step's column schedule (MultiLevelArrow's overlap_slabs and,
    # for the fold candidates, repl): S feature slabs, c column groups;
    # each must divide k.  1 is the plain step.
    cfg["overlap_slabs"] = max(
        int(os.environ.get("AMT_BENCH_OVERLAP_SLABS", "1")), 1)
    cfg["repl"] = max(int(os.environ.get("AMT_BENCH_REPL", "1")), 1)
    return cfg


def candidate_kwargs(fmt: str, cfg: dict) -> dict:
    """``MultiLevelArrow`` keywords of candidate ``fmt``: its format
    and packing, ``overlap_slabs`` when above 1, and ``repl`` above 1
    for the fold candidates only (the executor takes it on the fold
    alone, as in the root bench)."""
    kw = dict(CANDIDATE_KWARGS.get(fmt, dict(fmt=fmt)))
    slabs = max(int(cfg.get("overlap_slabs", 1)), 1)
    if slabs > 1:
        kw["overlap_slabs"] = slabs
    repl = max(int(cfg.get("repl", 1)), 1)
    if repl > 1 and kw.get("fmt") == "fold":
        kw["repl"] = repl
    return kw


def _cached_levels(n: int, m: int, width: int, max_levels: int):
    from arrow_matrix_tpu_torch.tools.gather_probe import cached_levels

    return cached_levels(n, m, width, seed=7, max_levels=max_levels,
                         cache_dir=_cache_dir(), backend="auto")


def _operator_bytes(nnz: int, binary: bool) -> int:
    """A 4-byte index a nonzero, and a 4-byte value when weighted."""
    return 4 * nnz * (1 if binary else 2)


def _dense_level_bytes(blocks) -> int:
    """Each structurally nonzero block of a dense level read once: the
    head row's nb blocks, the diagonal and head-column blocks below it,
    and the two off-diagonals when banded."""
    nb, w = blocks.n_blocks, blocks.width
    count = nb + 2 * (nb - 1)
    if blocks.banded:
        count += (nb - 1) + max(nb - 2, 0)
    return count * w * w * blocks.dtype.itemsize


def routing_bytes(multi, k: int) -> tuple:
    """(gather, gather-add) bytes of one step's routing at ``k`` f32
    features: each table's distinct rows read once, its rows written
    once, its 4-byte indices read once; the gather-add also reads its
    base.  (A routing table is a permutation: distinct rows = rows.)"""
    import torch

    gather = add = 0
    for tables, fused in ((multi.fwd, False), (multi.bwd, True)):
        for t in tables:
            s = int(t.shape[0])
            moved = (int(torch.unique(t).numel()) + s) * k * 4 + s * 4
            if fused:
                add += moved + s * k * 4
            else:
                gather += moved
    return gather, add


def min_bytes_per_iter(multi, levels, k: int) -> int:
    """The least bytes one iteration of the built executor ``multi``
    must move at ``k`` f32 features: the operator's nonzeros (a 4-byte
    index each, plus a 4-byte value when weighted; dense levels: every
    stored block once), X read once and the output written once (n rows
    each), for the fold once and for the per-level formats once a level,
    plus the routing between the levels (:func:`routing_bytes`).  Padded
    slots, degrees and reuse from cache are not counted, so no run can
    move fewer bytes."""
    feat = 2 * multi.n * k * 4
    if multi.folded:
        return _operator_bytes(multi.nnz, multi.binary) + feat
    total = 0
    for lvl, blk, fmt in zip(levels, multi.blocks, multi.fmts):
        if fmt == "dense":
            total += _dense_level_bytes(blk) + feat
        else:
            total += _operator_bytes(int(lvl.matrix.nnz), multi.binary) + feat
    return total + sum(routing_bytes(multi, k))


def _launch_counts() -> dict:
    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell

    return {"K1": cuda_sell.LAUNCHES, "K2": cuda_blocks.LAUNCHES_K2,
            "K3": cuda_blocks.LAUNCHES_K3, "K4": cuda_gather.LAUNCHES,
            "K4 add": cuda_gather.LAUNCHES_ADD}


def _child_device(cfg: dict):
    import torch

    from arrow_matrix_tpu_torch.utils import resolve_device

    dev = resolve_device("cpu" if cfg["platform"] == "cpu" else None)
    if dev.type == "cuda":
        # Full-f32 products: the gate is parity with the host result.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def run_one_candidate(fmt: str) -> None:
    """Build and measure ONE race candidate at the configured shape;
    prints one JSON line.  Runs in a subprocess of the race."""
    cfg = json.loads(os.environ["AMT_BENCH_CFG"])
    k128_run = bool(cfg.get("k128_run"))
    _install_flight(_candidate_flight_name(fmt, cfg))
    _progress(f"fmt={fmt} candidate start: n={cfg['n']} "
              f"width={cfg['width']} k={128 if k128_run else cfg['k']} "
              f"platform={cfg['platform']}")
    dev = _child_device(cfg)

    from arrow_matrix_tpu_torch.decomposition import decomposition_spmm
    from arrow_matrix_tpu_torch.parallel.multi_level import (
        MultiLevelArrow,
        resolve_feature_dtype,
    )
    from arrow_matrix_tpu_torch.utils import random_dense, relative_error
    from arrow_matrix_tpu_torch.utils.platform import (
        device_memory_budget,
        host_load,
    )
    from arrow_matrix_tpu_torch.utils.timing import chained_iteration_ms

    levels = _cached_levels(cfg["n"], cfg["m"], cfg["width"],
                            cfg["max_levels"])
    budget = device_memory_budget(dev)
    t0 = time.perf_counter()
    build_kwargs = candidate_kwargs(fmt, cfg)
    multi = MultiLevelArrow(levels, cfg["width"], dense_budget=budget,
                            device=dev, **build_kwargs)
    build_s = time.perf_counter() - t0
    _progress(f"fmt={fmt} built in {build_s:.0f}s; measuring")
    out = {"build_s": round(build_s, 2), "fmts": list(multi.fmts),
           "dense_budget_gb": round(budget / 2**30, 2),
           "host_load": host_load()}
    for key in ("overlap_slabs", "repl"):
        if key in build_kwargs:
            out[key] = build_kwargs[key]
    if k128_run:
        # The secondary width on the winner only.  Gated like k=16, on
        # the first 16 columns (the product is column-separable).
        try:
            x_host = random_dense(cfg["n"], 128, seed=4)
            x = multi.set_features(x_host)
            before = _launch_counts()
            out["k128_ms"] = chained_iteration_ms(multi.run, x,
                                                  cfg["iters"])
            out["k128_launches"] = {k: v - before[k]
                                    for k, v in _launch_counts().items()}
            out["k128_err"] = relative_error(
                multi.gather_result(multi.step(x))[:, :16],
                decomposition_spmm(levels, x_host[:, :16]))
            out["k128_bytes_per_iter"] = min_bytes_per_iter(multi, levels,
                                                            128)
            del x
            if multi.folded:
                # The fold's bf16 carriage on the same build: a
                # diagnostic beside the gated f32 number.
                prior = multi.feature_dtype
                try:
                    multi.feature_dtype = resolve_feature_dtype("bf16")
                    xb = multi.set_features(x_host)
                    out["k128_bf16_ms"] = chained_iteration_ms(
                        multi.run, xb, cfg["iters"])
                finally:
                    multi.feature_dtype = prior
        except Exception as e:   # the secondary number, never the gate
            out["k128_error"] = f"{type(e).__name__}: {str(e)[:200]}"
    else:
        x_host = random_dense(cfg["n"], cfg["k"], seed=3)
        x = multi.set_features(x_host)
        before = _launch_counts()
        out["ms"] = chained_iteration_ms(multi.run, x, cfg["iters"])
        out["launches"] = {k: v - before[k]
                           for k, v in _launch_counts().items()}
        out["err"] = relative_error(multi.gather_result(multi.step(x)),
                                    decomposition_spmm(levels, x_host))
        out["bytes_per_iter"] = min_bytes_per_iter(multi, levels, cfg["k"])
    print(json.dumps(out), flush=True)


def _child_env(extra: dict) -> dict:
    env = dict(os.environ, **extra)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (_PKG_PARENT + os.pathsep + path if path
                         else _PKG_PARENT)
    return env


def _spawn_candidate(fmt: str, cfg: dict, timeout_s: float) -> dict:
    """One candidate subprocess -> its parsed JSON or an error dict;
    every failure (nonzero exit, hang, unusable output) stays in the
    returned dict."""
    from arrow_matrix_tpu_torch.utils.artifacts import parse_last_json_line

    env = _child_env({"AMT_BENCH_CFG": json.dumps(cfg)})
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "arrow_matrix_tpu_torch.bench",
             "--candidate", fmt],
            capture_output=True, text=True, timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired:
        _progress(f"fmt={fmt} timed out after {timeout_s:.0f}s")
        err = {"error": f"timed out after {timeout_s:.0f}s",
               "timed_out": True}
        # The killed child's flight recorder is the only record of how
        # far it got.
        fp = _flight_path(_candidate_flight_name(fmt, cfg))
        if os.path.exists(fp):
            err["flight"] = fp
            _progress(f"fmt={fmt}: its flight recorder is {fp}")
        return err
    if proc.returncode != 0 or not proc.stdout.strip():
        _progress(f"fmt={fmt} FAILED rc={proc.returncode}")
        return {"error": f"rc={proc.returncode}: "
                         f"{proc.stderr.strip()[-400:]}"}
    run = parse_last_json_line(proc.stdout)
    if run is None:
        return {"error": f"unusable child output: "
                         f"{proc.stdout.strip()[-200:]}"}
    if "ms" in run:
        _progress(f"fmt={fmt}: {run['ms']:.4f} ms/iter err={run['err']:.3e}")
    elif "k128_ms" in run:
        _progress(f"fmt={fmt}: k=128 {run['k128_ms']:.4f} ms/iter")
    return run


def _check_wedged(result: dict, cfg: dict, label: str) -> bool:
    """After a timeout on the card, probe it again; record a card that
    no longer answers."""
    if cfg["platform"] == "cpu":
        return False
    from arrow_matrix_tpu_torch.utils.platform import probe_card

    platform, _, err = probe_card(timeout_s=60.0, retries=1)
    if platform != "cpu":
        return False
    result["accelerator_wedged"] = (
        f"card probe failed after {label} timeout: {err}")
    _progress(f"card wedged after {label}")
    return True


def race_candidates(result: dict, cfg: dict, finalize,
                    timeout_s: float = 900.0) -> dict:
    """Run each candidate in its own subprocess, folding every result
    into ``result`` through ``finalize`` as the race runs (a deadline
    mid-race keeps what finished)."""
    if cfg["fmt"] == "auto":
        candidates = list(RACE)
    else:
        candidates = [f.strip() for f in cfg["fmt"].split(",")
                      if f.strip()] or ["fold"]
    runs = {}
    for f in candidates:
        _progress(f"candidate fmt={f}")
        runs[f] = _spawn_candidate(f, cfg, timeout_s)
        timed_out = runs[f].pop("timed_out", False)
        finalize(runs)
        if timed_out and _check_wedged(result, cfg, f"fmt={f}"):
            break
    return runs


def run_bench(result: dict, platform: str, device_kind: str) -> None:
    from arrow_matrix_tpu_torch.decomposition import decomposition_spmm
    from arrow_matrix_tpu_torch.decomposition.decompose import (
        resolved_backend,
    )
    from arrow_matrix_tpu_torch.utils import logging as wb
    from arrow_matrix_tpu_torch.utils import random_dense, relative_tolerance

    cfg = _bench_config(platform)
    n, k, iters = cfg["n"], cfg["k"], cfg["iters"]
    result["config"] = {"n": n, "width": cfg["width"], "features": k,
                        "iterations": iters, "ba_neighbors": cfg["m"]}
    if cfg["degraded"]:
        result["degraded"] = True
    if cfg["overlap_slabs"] > 1:
        result["overlap_slabs"] = cfg["overlap_slabs"]
    if cfg["repl"] > 1:
        result["repl"] = cfg["repl"]
    _progress(f"platform={platform} kind={device_kind} n={n} "
              f"fmt={cfg['fmt']}")
    seg = wb.init("bench", f"ba_n{n}", config=dict(result["config"]))
    with seg.segment("decompose_s"):
        levels = _cached_levels(n, cfg["m"], cfg["width"],
                                cfg["max_levels"])
    result["config"]["decompose_s"] = round(
        seg.entries[-1]["decompose_s"], 2)
    result["config"]["decompose_backend"] = resolved_backend("auto")
    result["config"]["levels"] = len(levels)
    nnz = sum(int(lvl.matrix.nnz) for lvl in levels)
    result["config"]["edges_nnz"] = nnz

    # The host baseline: scipy CSR through the decomposition, in the
    # parent, before the race (the candidates own the card, not the
    # host's cores).
    x_host = random_dense(n, k, seed=3)
    base_iters = 3 if n > (1 << 18) else iters
    _progress(f"decomposition ready in {result['config']['decompose_s']}s "
              f"({result['config']['decompose_backend']}); scipy baseline")
    xb = x_host.copy()
    with seg.segment("scipy_baseline_s"):
        for _ in range(base_iters):
            xb = decomposition_spmm(levels, xb)
    scipy_ms = seg.entries[-1]["scipy_baseline_s"] / base_iters * 1e3
    tol = relative_tolerance(nnz / max(n, 1), 1)
    peak = None if cfg["degraded"] else peak_bytes_s(device_kind)
    _progress(f"scipy baseline {scipy_ms:.0f} ms/iter; racing candidates")

    def finalize(runs: dict) -> None:
        """Fold the race so far into ``result``: every candidate's
        numbers, and the best gated one as the headline."""
        result["device_runs"] = runs
        best = None
        for name, r in runs.items():
            if ("ms" in r and np.isfinite(r["err"]) and r["err"] <= tol
                    and (best is None or r["ms"] < runs[best]["ms"])):
                best = name
        if best is None:
            return
        win = runs[best]
        dev_ms = win["ms"]
        result["config"].update(fmts=win["fmts"], build_s=win["build_s"],
                                dense_budget_gb=win["dense_budget_gb"])
        result["fmt_used"] = best
        by = win["bytes_per_iter"]
        achieved = by / (dev_ms * 1e-3)
        result.update({
            "value": dev_ms,
            "vs_baseline": round(scipy_ms / dev_ms, 3),
            "scipy_cpu_ms": round(scipy_ms, 3),
            "gflops": round(2.0 * nnz * k / (dev_ms * 1e-3) / 1e9, 2),
            "frobenius_err_vs_cpu": win["err"],
            "frobenius_gate": tol,
            "bytes_per_iter_gb": round(by / 2**30, 6),
            "achieved_gbps": round(achieved / 1e9, 1),
        })
        if not cfg["degraded"]:
            result["roofline_model"] = (
                "least bytes of the built executor (operator nonzeros, X "
                "once, output once, routing) over the card's peak")
            result["roofline_frac"] = (round(achieved / peak, 4) if peak
                                       else None)

    runs = race_candidates(result, cfg, finalize)
    if result.get("value") is None:
        outcomes = [(name, r.get("err", r.get("error")))
                    for name, r in runs.items()]
        raise RuntimeError(f"every config failed or missed the correctness "
                           f"gate: {outcomes} vs {tol:.1e}")

    if cfg["k128"] and not result.get("accelerator_wedged"):
        _progress(f"k=128 rerun on winner fmt={result['fmt_used']}")
        rerun = _spawn_candidate(result["fmt_used"],
                                 dict(cfg, k128_run=True), timeout_s=1500.0)
        if "k128_ms" in rerun:
            err128 = rerun.get("k128_err", float("inf"))
            result["k128_err"] = err128
            result["k128_gate"] = tol
            if np.isfinite(err128) and err128 <= tol:
                ms128 = rerun["k128_ms"]
                result["k128_ms"] = ms128
                result["k128_launches"] = rerun.get("k128_launches")
                result["k128_gflops"] = round(
                    2.0 * nnz * 128 / (ms128 * 1e-3) / 1e9, 2)
                result["k128_achieved_gbps"] = round(
                    rerun["k128_bytes_per_iter"] / (ms128 * 1e-3) / 1e9, 1)
                if peak:
                    result["k128_roofline_frac"] = round(
                        rerun["k128_bytes_per_iter"] / (ms128 * 1e-3)
                        / peak, 4)
                if "k128_bf16_ms" in rerun:
                    result["k128_bf16_ms"] = rerun["k128_bf16_ms"]
            else:
                result["k128_error"] = (
                    f"missed correctness gate: {err128} > {tol}")
        elif rerun.get("k128_error") or rerun.get("error"):
            result["k128_error"] = (rerun.get("k128_error")
                                    or rerun.get("error"))
        if rerun.pop("timed_out", False):
            _check_wedged(result, cfg, "k=128 rerun")
    column_sweeps(result, cfg, tol)


def _sweep_points(spec: str, k: int, what: str):
    """(label, value or None, error) of each token of a comma list: a
    positive integer that divides ``k``."""
    for tok in (t.strip() for t in spec.split(",")):
        if not tok:
            continue
        if not tok.isdigit() or int(tok) < 1:
            yield tok, None, "not a positive integer"
        elif k % int(tok):
            yield str(int(tok)), None, f"{what}={int(tok)} does not " \
                                       f"divide k={k}"
        else:
            yield str(int(tok)), int(tok), None


def column_sweeps(result: dict, cfg: dict, tol: float) -> None:
    """The column-schedule sweeps of the root ``bench.py``: the winning
    format again at each overlap slab count S of
    ``AMT_BENCH_OVERLAP_SWEEP`` (``--overlap_slabs``), and the fold at
    each replication factor c of ``AMT_BENCH_REPL_SWEEP`` (``--repl``),
    each point in its own subprocess with its own timeout and gate."""
    k = cfg["k"]
    for env, key, what, field in (
            ("AMT_BENCH_OVERLAP_SWEEP", "overlap_sweep", "S",
             "overlap_slabs"),
            ("AMT_BENCH_REPL_SWEEP", "repl_sweep", "c", "repl")):
        spec = os.environ.get(env, "")
        if not spec or result.get("accelerator_wedged"):
            continue
        fmt = result.get("fmt_used") or "fold"
        if field == "repl" and not str(fmt).startswith("fold"):
            fmt = "fold"          # repl composes with the fold schedule
        sweep = result[key] = {"fmt": fmt}
        for label, value, err in _sweep_points(spec, k, what):
            if err is not None:
                sweep[label] = {"error": err}
                continue
            _progress(f"{key}: fmt={fmt} {what}={value}")
            run = _spawn_candidate(fmt, dict(cfg, k128=False,
                                             **{field: value}),
                                   timeout_s=900.0)
            timed_out = run.pop("timed_out", False)
            point = {kk: run[kk] for kk in ("ms", "err", "error",
                                            "host_load", "launches")
                     if run.get(kk) is not None}
            if "err" in point and np.isfinite(point["err"]) \
                    and point["err"] > tol:
                point["gate_missed"] = tol
            sweep[label] = point
            if timed_out and _check_wedged(result, cfg, f"{what}={value}"):
                break


def run_one_variant(name: str) -> None:
    """Build and measure ONE kernel-comparison variant; prints its
    ms/iter as JSON.  Runs in a subprocess of :func:`kernel_compare`."""
    cfg = json.loads(os.environ["AMT_BENCH_CFG"])
    _install_flight(f"variant_{name}")
    _progress(f"variant={name} start")
    dev = _child_device(cfg)
    from arrow_matrix_tpu_torch.parallel.multi_level import MultiLevelArrow
    from arrow_matrix_tpu_torch.utils import random_dense
    from arrow_matrix_tpu_torch.utils.timing import chained_iteration_ms

    c = COMPARE_CONFIG
    levels = _cached_levels(c["n"], c["m"], c["width"], 2)
    multi = MultiLevelArrow(levels, c["width"], device=dev,
                            **COMPARE_VARIANTS[name])
    x = multi.set_features(random_dense(c["n"], c["k"], seed=3))
    print(json.dumps({"ms": chained_iteration_ms(multi.run, x,
                                                 c["iters"])}), flush=True)


def kernel_compare(cfg: dict, timeout_s: float = 300.0,
                   total_budget_s: float = 900.0,
                   out: dict | None = None) -> dict:
    """ms/iter of each of ``COMPARE_VARIANTS`` at ``COMPARE_CONFIG``, one
    subprocess each with a hard timeout, within a total budget; ``out``
    is filled variant by variant as the sweep runs."""
    from arrow_matrix_tpu_torch.utils.artifacts import parse_last_json_line

    if out is None:
        out = {}
    out["config"] = dict(COMPARE_CONFIG)
    env = _child_env({"AMT_BENCH_CFG": json.dumps(cfg)})
    t_start = time.perf_counter()
    for name in COMPARE_VARIANTS:
        left = total_budget_s - (time.perf_counter() - t_start)
        if left <= 0:
            out[name + "_ms"] = None
            out[name + "_error"] = "compare budget exhausted"
            continue
        _progress(f"kernel variant {name}")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "arrow_matrix_tpu_torch.bench",
                 "--variant", name],
                capture_output=True, text=True,
                timeout=min(timeout_s, left), env=env)
            rec = (parse_last_json_line(proc.stdout)
                   if proc.returncode == 0 else None)
            out[name + "_ms"] = rec.get("ms") if rec else None
            if rec is None:
                out[name + "_error"] = (f"rc={proc.returncode}: "
                                        f"{proc.stderr.strip()[-300:]}")
        except subprocess.TimeoutExpired:
            out[name + "_ms"] = None
            out[name + "_error"] = (f"timed out after "
                                    f"{min(timeout_s, left):.0f}s")
    return out


def _last_onchip_evidence() -> dict | None:
    """Summary of the newest on-card capture of this bench among
    ``bench_results/onchip_*.json`` and ``<cache dir>/onchip_*.json``
    (the root bench's ``_last_onchip_evidence``), labeled as a prior
    capture; None when there is none.

    Only a record whose ``platform`` is "gpu" qualifies: the committed
    ``bench_results/onchip_r3_*.json`` are the JAX package's TPU
    captures, which ``utils/artifacts.record_is_onchip`` accepts (it
    rejects only CPU and degraded records)."""
    import glob

    from arrow_matrix_tpu_torch.utils.artifacts import (
        is_stray_verification_artifact,
        load_last_json_line,
        record_is_onchip,
    )

    paths = [p for p in
             (glob.glob(os.path.join(_PKG_PARENT, "bench_results",
                                     "onchip_*.json"))
              + glob.glob(os.path.join(_cache_dir(), "onchip_*.json")))
             if not is_stray_verification_artifact(p)]
    by_mtime = []
    for p in paths:
        try:
            by_mtime.append((os.path.getmtime(p), p))
        except OSError:
            continue
    for mt, p in sorted(by_mtime, reverse=True):
        d = load_last_json_line(p)
        if (d is None or d.get("metric") != "spmm_iter_ms"
                or not d.get("value") or d.get("platform") != "gpu"
                or not record_is_onchip(d)):
            continue
        keep = ("metric", "value", "unit", "vs_baseline", "platform",
                "device_kind", "fmt_used", "k128_ms", "k128_err",
                "k128_bf16_ms", "frobenius_err_vs_cpu", "frobenius_gate",
                "achieved_gbps", "roofline_frac", "config")
        summary = {k: d[k] for k in keep if k in d}
        if isinstance(summary.get("config"), dict):
            summary["config"] = {k: summary["config"][k]
                                 for k in ("n", "width", "features",
                                           "iterations", "levels")
                                 if k in summary["config"]}
        return {"note": ("most recent on-card capture (a prior run, not "
                         "this invocation's measurement)"),
                "path": p, "captured_unix": int(mt), "summary": summary}
    return None


def _record_in_ledger(result: dict) -> None:
    """Append the run's headline to the port's ledger (``kind="bench"``,
    ``AMT_LEDGER_DIR`` or ``bench_results/ledger_torch``); a failure is
    reported and never blocks the JSON line."""
    try:
        from arrow_matrix_tpu_torch.ledger import bench_metric, record

        record("bench",
               bench_metric(result.get("metric", "spmm_iter_ms"),
                            result.get("config")),
               result.get("value"), unit=result.get("unit"),
               platform=result.get("platform"),
               device_kind=result.get("device_kind"),
               knobs={"config": result.get("config", {}),
                      "fmt_used": result.get("fmt_used")},
               payload={"parsed": result})
    except Exception as e:
        print(f"[ledger] bench record not persisted: "
              f"{type(e).__name__}: {e}", file=sys.stderr)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default=None,
                        help="cuda (default: the card, or an error line "
                             "without one) or cpu (the host, degraded)")
    parser.add_argument("--overlap_slabs", default=None,
                        help="comma list of overlap slab counts S to "
                             "sweep the winning format over after the race "
                             "(sets AMT_BENCH_OVERLAP_SWEEP), e.g. 1,2,4")
    parser.add_argument("--repl", default=None,
                        help="comma list of replication factors c to sweep "
                             "the fold over after the race (sets "
                             "AMT_BENCH_REPL_SWEEP), e.g. 1,2,4")
    parser.add_argument("--candidate", help=argparse.SUPPRESS)
    parser.add_argument("--variant", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.overlap_slabs is not None:
        os.environ["AMT_BENCH_OVERLAP_SWEEP"] = args.overlap_slabs
    if args.repl is not None:
        os.environ["AMT_BENCH_REPL_SWEEP"] = args.repl
    if args.candidate:
        run_one_candidate(args.candidate)
        return 0
    if args.variant:
        run_one_variant(args.variant)
        return 0

    import signal

    deadline = int(os.environ.get("AMT_BENCH_DEADLINE", 3300))
    if deadline > 0:
        def _on_alarm(signum, frame):
            raise TimeoutError(f"bench deadline ({deadline}s) exceeded")

        signal.signal(signal.SIGALRM, _on_alarm)
        signal.alarm(deadline)
    result = {"metric": "spmm_iter_ms", "value": None, "unit": "ms",
              "vs_baseline": None}
    try:
        from arrow_matrix_tpu_torch.utils.platform import host_load

        result["host_load"] = host_load()
        if args.device == "cpu":
            platform, device_kind, card = "cpu", "host", None
        else:
            from arrow_matrix_tpu_torch.utils.device import card_report
            from arrow_matrix_tpu_torch.utils.platform import probe_card

            platform, device_kind, err = probe_card()
            if platform == "cpu":
                raise RuntimeError(
                    f"no card answers ({err}); pass --device cpu to run "
                    f"the bench on the host")
            import torch

            from arrow_matrix_tpu_torch.ledger import device_stamp

            # The card's stamp, as every ledger record of the port has it.
            platform = device_stamp(torch.device("cuda", 0))["platform"]
            card = card_report(torch.device("cuda", 0))
        result.update(platform=platform, device_kind=device_kind, card=card)
        try:
            run_bench(result, platform, device_kind)
        except Exception as e:
            result["error"] = f"{type(e).__name__}: {e}"
        remaining = (deadline - (time.perf_counter() - _T0)
                     if deadline else 1e9)
        compare = os.environ.get("AMT_BENCH_COMPARE", "auto")
        if (not result.get("accelerator_wedged") and remaining > 360
                and os.environ.get("AMT_BENCH_SMALL") != "1"
                and (compare == "1"
                     or (compare == "auto" and platform != "cpu"))):
            try:
                kernel_compare(_bench_config(platform), total_budget_s=min(900.0,
                                                       remaining - 60),
                               out=result.setdefault("kernel_compare", {}))
            except Exception as e:   # diagnostics, not the gate
                result.setdefault("kernel_compare", {})["error"] = (
                    f"{type(e).__name__}: {e}")
    except BaseException as e:
        # A late failure keeps the headline number the race earned.
        result.setdefault("error", f"{type(e).__name__}: {e}")
    if deadline > 0:
        signal.alarm(0)
    try:
        evidence = _last_onchip_evidence()
        if evidence is not None:
            result["last_onchip"] = evidence
    except Exception as e:   # evidence is auxiliary
        print(f"[bench] no last_onchip: {type(e).__name__}: {e}",
              file=sys.stderr)
    _record_in_ledger(result)
    print(json.dumps(result), flush=True)
    return 0 if result.get("value") is not None else 1


if __name__ == "__main__":
    sys.exit(main())

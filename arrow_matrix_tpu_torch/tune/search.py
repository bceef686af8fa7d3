"""The tuning search loop.

The port's copy of ``arrow_matrix_tpu/tune/search.py``.  ``search()``
fingerprints the structure (``tune/fingerprint.py``), returns a cached
plan when there is one (a second search of an unchanged structure spawns
zero children: ``tools/tune_gate.py`` checks it), else enumerates and
prunes the candidates (``tune/space.py``), races the survivors one after
another, each in its own subprocess alone on the device (``python -m
arrow_matrix_tpu_torch.tune --candidate``, on the card unless the search
runs on the CPU; the next children start their Python while the current
one runs, and each waits for a line on its standard input before
touching the device: :func:`race`), and persists the winner as a
:class:`TunePlan`.

The golden is the port's default fold (K1 at its defaults on the card,
its plain version on the CPU), stepped once from a seeded input and
gathered back to original row order in the parent, which exports the
default fold's packed operator for the children whose candidates keep
its packing (they load it instead of folding again).  In the ``exact``
class a candidate wins only when its f32 output equals the golden bit
for bit (the default always does, so a winner exists); the others are
timed and recorded as diagnostics.  In the ``approx`` class a
reduced-precision candidate may win within the class tolerance once its
error curve certifies (``ledger/probe.py``), and the plan carries the
certificate.  Each child reports its ms/iter, its bit identity, its
relative Frobenius error, the K1 launches of one step and of its
whole run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from arrow_matrix_tpu_torch.tune.fingerprint import (
    fingerprint_hash,
    structure_fingerprint,
)
from arrow_matrix_tpu_torch.tune.plan import (
    BACKEND,
    PLAN_VERSION,
    TunePlan,
    load_plan,
    save_plans,
)
from arrow_matrix_tpu_torch.tune.space import Candidate, enumerate_candidates

#: Seed of the bit-identity input (parent and child).
GOLDEN_SEED = 3

#: Where the search keeps its goldens and flight records by default.
DEFAULT_RUN_ROOT = os.path.join("bench_results", "tune_runs_torch")

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_levels_from_source(source: dict):
    """Rebuild a decomposition from its source.  Two kinds:

    * ``{"kind": "ba", "n", "m", "width", "seed", "max_levels"}`` --
      generate a Barabasi-Albert graph and decompose it (both seeded,
      so every process sees the same structure);
    * ``{"kind": "dir", "base", "width"}`` -- load an ``io/graphio.py``
      artifact saved at level-0 width ``width``.

    Returns ``(levels, width)``.
    """
    kind = source.get("kind")
    if kind == "ba":
        from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
        from arrow_matrix_tpu_torch.utils import barabasi_albert

        a = barabasi_albert(int(source["n"]), int(source.get("m", 3)),
                            seed=int(source["seed"]))
        width = int(source["width"])
        levels = arrow_decomposition(
            a, width, max_levels=int(source.get("max_levels", 10)),
            block_diagonal=True, seed=int(source["seed"]))
        return levels, width
    if kind == "dir":
        from arrow_matrix_tpu_torch.io.graphio import (
            as_levels,
            load_decomposition,
            load_level_widths,
        )

        base = source["base"]
        width = source.get("width")
        loaded = load_decomposition(base, width, block_diagonal=True)
        widths = load_level_widths(base, width, True)
        levels = as_levels(loaded, widths)
        return levels, int(np.max(np.asarray(widths)))
    raise ValueError(f"unknown levels source kind {kind!r}")


def _build_executor(levels, width: int, cand: Candidate, device=None):
    """One candidate's fold executor over loaded levels."""
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    kwargs: Dict[str, Any] = {"fmt": "fold"}
    kwargs.update(cand.build)
    return MultiLevelArrow(levels, width,
                           kernel_opts=dict(cand.kernel_opts) or None,
                           device=device, **kwargs)


#: Build keys a candidate may carry and still run on the default fold's
#: packed operator (they change how it runs, not how it is packed).
FOLD_RUN_KEYS = ("kernel", "feature_dtype", "overlap_slabs", "repl")


def golden_output(levels, width: int, x_host: np.ndarray, device=None,
                  fold_dir: Optional[str] = None) -> np.ndarray:
    """The golden: the default fold executor stepped once, gathered back
    to original row order, f32; with ``fold_dir``, its packed operator
    is exported there (``export_folded``) for the children, with the
    input and the golden in its carried order (``x_carried.npy``,
    ``golden_carried.npy``)."""
    multi = _build_executor(levels, width, Candidate("default"), device)
    x = multi.set_features(x_host)
    y = multi.step(x)
    out = np.asarray(multi.gather_result(y), dtype=np.float32)
    if fold_dir is not None:
        multi.export_folded(fold_dir)
        np.save(os.path.join(fold_dir, "x_carried.npy"), x.cpu().numpy())
        np.save(os.path.join(fold_dir, "golden_carried.npy"),
                y.float().cpu().numpy())
    del multi, x, y
    return out


def _check_carried(multi, x_path: str, golden_path: str):
    """(step result, launches, bit identity, relative error) of one step
    of ``multi`` (on the exported fold: the golden's carried order) from
    the exported input, held against the exported golden on the
    device, over the rows that hold a real row."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell

    x = torch.from_numpy(np.load(x_path)).to(multi.feature_dtype)
    x = x.to(multi.device)
    before = cuda_sell.LAUNCHES
    y = multi.step(x)
    launches = cuda_sell.LAUNCHES - before
    real = torch.from_numpy(multi.perm0 < multi.n).to(multi.device)
    mine = y.float()[real]
    want = torch.from_numpy(np.load(golden_path)).to(multi.device)[real]
    same = bool(torch.equal(mine, want))
    rel = 0.0 if same else float(
        torch.linalg.vector_norm(mine.double() - want.double())
        / torch.linalg.vector_norm(want.double()).clamp_min(1e-30))
    return x, launches, same, rel


def _child_executor(cfg: dict, cand: Candidate, dev):
    """A child's executor: on the default fold's exported operator when
    the search exported one and the candidate keeps its packing (the
    same tier arrays, hence the same bits, without decomposing or
    folding again), else built from the levels."""
    from arrow_matrix_tpu_torch.parallel import MultiLevelArrow

    fold_dir = cfg.get("fold_dir")
    if fold_dir and set(cand.build) <= set(FOLD_RUN_KEYS):
        b = cand.build
        return MultiLevelArrow.load_folded(
            fold_dir, feature_dtype=b.get("feature_dtype"), device=dev,
            repl=int(b.get("repl", 1)),
            overlap_slabs=int(b.get("overlap_slabs", 1)),
            kernel=b.get("kernel", "xla"),
            kernel_opts=dict(cand.kernel_opts) or None)
    levels, width = load_levels_from_source(cfg["source"])
    return _build_executor(levels, width, cand, dev)


def _flight_path(name: str) -> str:
    return os.path.join(os.environ.get(
        "AMT_FLIGHT_DIR", os.path.join(DEFAULT_RUN_ROOT, "flight")),
        f"{name}.json")


def candidate_child_main(cfg: dict) -> dict:
    """Body of one candidate subprocess: build, check against the
    parent's golden, count K1's launches of one step, measure ms/iter.
    Returns the dict the caller prints as its last line."""
    t0 = time.perf_counter()
    from arrow_matrix_tpu_torch.obs import flight
    from arrow_matrix_tpu_torch.ops import cuda_sell
    from arrow_matrix_tpu_torch.utils import (
        random_dense,
        relative_error,
        resolve_device,
    )
    from arrow_matrix_tpu_torch.utils.timing import chained_iteration_ms

    name = cfg["candidate"]["name"]
    flight.install(_flight_path(f"tune_{name}"))
    # The previous candidate holds the device until this line comes.
    t_wait = time.perf_counter()
    if sys.stdin is not None:
        sys.stdin.readline()
    t_go = time.perf_counter()
    dev = resolve_device(cfg.get("device"))
    if dev.type == "cuda":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
    cand = Candidate(name, build=cfg["candidate"].get("build") or {},
                     kernel_opts=cfg["candidate"].get("kernel_opts") or {})
    t_build = time.perf_counter()
    multi = _child_executor(cfg, cand, dev)
    build_s = time.perf_counter() - t_build
    k = int(cfg["k"])
    start = cuda_sell.LAUNCHES
    t_check = time.perf_counter()
    fold_dir = cfg.get("fold_dir")
    if fold_dir and set(cand.build) <= set(FOLD_RUN_KEYS) \
            and not multi.int8:
        # On the exported fold: the exported input and golden, held
        # against each other on the device in the carried order.
        x, launches, same, rel = _check_carried(
            multi, os.path.join(fold_dir, "x_carried.npy"),
            os.path.join(fold_dir, "golden_carried.npy"))
    else:
        x = multi.set_features(random_dense(multi.n, k, seed=GOLDEN_SEED))
        before = cuda_sell.LAUNCHES
        mine = np.asarray(multi.gather_result(multi.step(x)),
                          dtype=np.float32)
        launches = cuda_sell.LAUNCHES - before
        same = rel = None
        if cfg.get("golden_path"):
            golden = np.load(cfg["golden_path"])
            same = bool(np.array_equal(mine, golden))
            rel = 0.0 if same else relative_error(mine, golden)
    out = {"name": name, "build_s": round(build_s, 3),
           "k1_launches_per_step": launches, "bit_identical": same,
           "rel_frobenius": rel}
    t_time = time.perf_counter()
    out["ms"] = round(float(chained_iteration_ms(
        multi.run, x, int(cfg.get("iters", 3)))), 6)
    out["k1_launches"] = cuda_sell.LAUNCHES - start
    # Where the child's time went: imports and set-up before the device
    # was free, the wait for it, the build, the step and its check
    # against the golden, the timing.
    out["seconds"] = {"before_wait": round(t_wait - t0, 3),
                      "waited": round(t_go - t_wait, 3),
                      "build": round(build_s, 3),
                      "check": round(t_time - t_check, 3),
                      "timing": round(time.perf_counter() - t_time, 3)}
    return out


#: The line a child waits for on its standard input before it touches
#: the device (``candidate_child_main``).
GO = "go"


def _start_child(cand: Candidate, cfg: dict, log_dir: str):
    """Start one candidate's subprocess (its standard error to a file in
    ``log_dir``); it imports and reads its configuration, then waits for
    :data:`GO` before touching the device.  Returns ``(process, log)``."""
    child_cfg = dict(cfg)
    child_cfg["candidate"] = {"name": cand.name, "build": cand.build,
                              "kernel_opts": cand.kernel_opts}
    env = dict(os.environ, AMT_TUNE_CFG=json.dumps(child_cfg))
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = (_PKG_PARENT + os.pathsep + path if path
                         else _PKG_PARENT)
    os.makedirs(log_dir, exist_ok=True)
    log = open(os.path.join(log_dir, f"{cand.name}.stderr"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.tune", "--candidate",
         cand.name], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=log, text=True, env=env)
    return proc, log


def _read_line(proc: subprocess.Popen, timeout_s: float) -> Optional[str]:
    """The child's result: its first line of standard output that is a
    JSON object ("" at end of output), or None when ``timeout_s``
    passed first."""
    import selectors

    deadline = time.monotonic() + timeout_s
    with selectors.DefaultSelector() as sel:
        sel.register(proc.stdout, selectors.EVENT_READ)
        while True:
            if not sel.select(max(deadline - time.monotonic(), 0.0)):
                return None
            line = proc.stdout.readline()
            if not line or line.lstrip().startswith("{"):
                return line


def _finish_child(cand: Candidate, proc: subprocess.Popen, log,
                  timeout_s: float) -> dict:
    """Let a started child run (send :data:`GO`) and read its result,
    the one line it prints when its measurement is done, or an error
    dict (a failure stays in the returned dict).  The caller reaps the
    child: it may still be exiting when this returns."""
    from arrow_matrix_tpu_torch.utils.artifacts import parse_last_json_line

    try:
        proc.stdin.write(GO + "\n")
        proc.stdin.close()
    except BrokenPipeError:      # it died before the device was free
        pass
    tic = time.perf_counter()
    line = _read_line(proc, timeout_s)
    if line is None:
        proc.kill()
        res: Dict[str, Any] = {"name": cand.name,
                               "error": f"timed out after {timeout_s:.0f}s",
                               "timed_out": True}
        fp = _flight_path(f"tune_{cand.name}")
        if os.path.exists(fp):
            res["flight"] = fp
        return res
    rec = parse_last_json_line(line) if line.strip() else None
    if rec is None or rec.get("error") is not None:
        proc.wait()
        log.seek(0)
        return {"name": cand.name,
                "error": (rec or {}).get("error") or
                f"rc={proc.returncode}: {log.read().strip()[-400:]}"}
    # The child's turn on the device: from GO to its result.
    rec["turn_s"] = round(time.perf_counter() - tic, 3)
    return rec


#: Children a race starts ahead of the one on the device: a child's
#: Python start and imports (seconds) take longer than its turn on the
#: device, so one ahead would leave the device idle between turns.
AHEAD = 4


def race(cands: List[Candidate], cfg: dict, timeout_s: float,
         say=lambda msg: None, ahead: int = AHEAD,
         log_dir: Optional[str] = None,
         before_go=None) -> Dict[str, dict]:
    """Race ``cands`` one after another, each in its own subprocess and
    alone on the device: up to ``ahead`` next children are started
    (Python, their imports) while the current one runs, and each touches
    the device only once the one before it has printed its result.  A
    child's standard error goes to ``log_dir/<name>.stderr``.
    ``before_go`` (the golden the children read) runs once the first
    children are starting, before the first is told to go."""
    import tempfile

    log_dir = log_dir or tempfile.mkdtemp(prefix="tune_children_")
    results: Dict[str, dict] = {}
    started: List[tuple] = []
    try:
        for i, cand in enumerate(cands):
            if i == 0 and before_go is not None:
                started = [_start_child(c, cfg, log_dir)
                           for c in cands[:1 + ahead]]
                before_go()
            while len(started) < min(i + 1 + ahead, len(cands)):
                started.append(_start_child(cands[len(started)], cfg,
                                            log_dir))
            say(f"racing {cand.name}")
            proc, log = started[i]
            r = results[cand.name] = _finish_child(cand, proc, log,
                                                   timeout_s)
            say(f"  {cand.name}: ms={r.get('ms')} "
                f"bit_identical={r.get('bit_identical')} "
                f"k1_launches={r.get('k1_launches_per_step')} "
                f"err={r.get('error')}")
    finally:
        for proc, log in started:
            if proc.poll() is None and proc.stdin and not proc.stdin.closed:
                proc.kill()           # never told to go
            proc.wait()
            proc.stdout.close()
            log.close()
    return results


def _certify_candidate(source: dict, dtype: str, k: int,
                       ledger_dir: Optional[str], device, say):
    """The error-curve certificate of one carriage (recorded in the
    ledger when one is given); None when the probe fails."""
    from arrow_matrix_tpu_torch.classes import certificate_from_record
    from arrow_matrix_tpu_torch.ledger.probe import error_curves_for_source

    try:
        ledger = None
        if ledger_dir is not None:
            from arrow_matrix_tpu_torch.ledger.store import Ledger

            ledger = Ledger(ledger_dir)
        recs = error_curves_for_source(source, k=int(k), dtypes=(dtype,),
                                       ledger=ledger, device=device)
        return certificate_from_record(recs[0])
    except Exception as e:  # noqa: BLE001 -- a failed probe fails the
        say(f"certificate probe failed: {type(e).__name__}: {e}")
        return None          # candidate, never the search


def _plan_from_candidate(cand: Candidate, h: str, k: int) -> TunePlan:
    """A candidate's overrides folded over the default knobs."""
    base = TunePlan(structure_hash=h, k=int(k)).to_dict()
    base.update(cand.build)
    base.update(cand.kernel_opts)
    base["candidate"] = cand.name
    return TunePlan.from_dict(base)


def effective_dtype(c: Candidate) -> Optional[str]:
    """The accuracy-class key of a candidate's carriage: its
    ``feature_dtype``, or for a per-tier schedule its narrowest tier
    carriage."""
    fd = c.build.get("feature_dtype") or c.kernel_opts.get("feature_dtype")
    if fd is None and c.kernel_opts.get("schedule"):
        carrs = {e.get("carriage", "f32")
                 for e in c.kernel_opts["schedule"]}
        for narrow in ("int8", "bf16"):
            if narrow in carrs:
                return narrow
    return fd


def search(source: dict, k: int, *, iters: int = 3,
           timeout_s: float = 240.0, dtype=np.float32,
           plan_dir: Optional[str] = None, refresh: bool = False,
           allow_int8: bool = False,
           restrict: Optional[List[str]] = None,
           run_dir: Optional[str] = None,
           ledger_dir: Optional[str] = None,
           traffic_class: str = "exact",
           extra: Optional[List[Candidate]] = None,
           lens_model=None,
           synth: bool = False,
           budget_bytes: Optional[int] = None,
           device=None,
           quiet: bool = False) -> Tuple[Optional[TunePlan], dict]:
    """Search (or hit in the cache) the plan of one (structure, k).

    Returns ``(plan, report)``; ``report["cache_hit"]`` and
    ``report["children_spawned"]`` are the gate's evidence.
    ``refresh=True`` searches again.  ``device`` is where the golden and
    the children run (the card unless ``"cpu"``).  ``synth=True`` adds
    the synthesized schedules (``tune/synth.py``) and persists the
    exact one that passes the screens; a cache hit returns before
    synthesis.  ``lens_model`` (a ``CostModel`` or its JSON path) arms
    the lens screen; ``budget_bytes`` the HBM certificate's budget.
    """
    from arrow_matrix_tpu_torch.classes import tolerance_for
    from arrow_matrix_tpu_torch.utils import random_dense, resolve_device
    from arrow_matrix_tpu_torch.utils.platform import host_load

    def _say(msg: str) -> None:
        if not quiet:
            print(f"[graft-tune] {msg}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    levels, width = load_levels_from_source(source)
    fp = structure_fingerprint(levels, width, dtype=dtype)
    h = fingerprint_hash(fp)
    _say(f"structure {h} (n={fp['n']}, total_rows={fp['total_rows']}, "
         f"{len(fp['ladder']['rows'])} tiers)")

    if not refresh:
        cached = load_plan(h, k, plan_dir, quiet=True)
        if cached is not None and cached.traffic_class != traffic_class:
            _say(f"cached plan is {cached.traffic_class!r}, search wants "
                 f"{traffic_class!r}: searching again")
            cached = None
        if cached is not None:
            _say(f"cache HIT for k={k}: candidate {cached.candidate!r} "
                 f"({cached.measured_ms} ms, margin {cached.margin})")
            return cached, {
                "structure_hash": h, "k": int(k), "cache_hit": True,
                "children_spawned": 0,
                "lookup_ms": round((time.perf_counter() - t0) * 1e3, 3),
                "plan": cached.to_dict()}

    dev = resolve_device(device)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        import torch

        evaluator = torch.cuda.get_device_name(dev)
    else:
        evaluator = "cpu-plain"

    if isinstance(lens_model, (str, os.PathLike)):
        from arrow_matrix_tpu_torch.obs.costmodel import CostModel

        with open(lens_model, "r", encoding="utf-8") as fh:
            lens_model = CostModel.from_dict(json.load(fh))
    if synth:
        from arrow_matrix_tpu_torch.tune import synth as _synth

        generated = _synth.synth_candidates(fp, traffic_class=traffic_class)
        if generated:
            _say(f"synth: {len(generated)} generated candidate(s): "
                 + "; ".join(
                     f"{c.name} [{_synth.schedule_summary(c.kernel_opts['schedule'])}]"
                     for c in generated))
            extra = list(extra or []) + generated
    cands, pruned = enumerate_candidates(
        fp, k, platform=platform, allow_int8=allow_int8,
        budget_bytes=budget_bytes, restrict=restrict,
        traffic_class=traffic_class, extra=extra, lens_model=lens_model)
    for name, why in pruned.items():
        _say(f"pruned {name}: {why}")

    synth_program = None
    if synth:
        for c in cands:
            if c.name == "synth_ladder":
                synth_program = _synth.persist_program(
                    fp, h, k, c.kernel_opts["schedule"])
                _say(f"synth: persisted generated program {synth_program}")
                break

    run_dir = run_dir or os.path.join(DEFAULT_RUN_ROOT, h)
    os.makedirs(run_dir, exist_ok=True)
    golden_path = os.path.join(run_dir, f"golden_k{int(k)}.npy")
    fold_dir = os.path.join(run_dir, "fold")

    def _golden() -> None:
        # Written while the first children import; they read it after GO.
        x_host = random_dense(fp["n"], int(k), seed=GOLDEN_SEED)
        np.save(golden_path, golden_output(levels, width, x_host, dev,
                                           fold_dir=fold_dir))
        if dev.type == "cuda":
            import torch

            torch.cuda.empty_cache()

    cfg = {"source": source, "k": int(k), "iters": int(iters),
           "golden_path": os.path.abspath(golden_path),
           "fold_dir": os.path.abspath(fold_dir),
           "device": None if dev.type == "cuda" else "cpu"}
    results = race(cands, cfg, timeout_s, _say,
                   log_dir=os.path.join(run_dir, f"children_k{int(k)}"),
                   before_go=_golden)
    del levels

    default_ms = results.get("default", {}).get("ms")

    def _class_ok(c: Candidate) -> bool:
        r = results[c.name]
        if r.get("error") is not None or r.get("ms") is None:
            return False
        if r.get("bit_identical") is True:
            return True
        if traffic_class != "approx":
            return False
        fd = effective_dtype(c)
        rel = r.get("rel_frobenius")
        return fd is not None and rel is not None \
            and rel <= tolerance_for(fd)

    eligible = [c for c in cands if c.eligible and _class_ok(c)]
    certificate = None
    winner = None
    while eligible:
        pick = min(eligible, key=lambda c: results[c.name]["ms"])
        fd = effective_dtype(pick)
        if (traffic_class != "approx" or fd is None
                or results[pick.name].get("bit_identical") is True):
            winner = pick
            break
        cert = _certify_candidate(source, fd, k, ledger_dir,
                                  None if dev.type == "cuda" else "cpu",
                                  _say)
        if cert is not None and cert.covers(cert.iterations):
            winner, certificate = pick, cert
            break
        _say(f"{pick.name}: curve failed to certify (tolerance "
             f"{tolerance_for(fd)}): dropping the candidate")
        eligible.remove(pick)
    if winner is None:
        _say("no eligible candidate (default failed?): no plan saved")
        return None, {
            "structure_hash": h, "k": int(k), "cache_hit": False,
            "children_spawned": len(cands), "results": results,
            "pruned": pruned, "error": "no eligible candidate",
            "synth_program": synth_program}
    w_ms = float(results[winner.name]["ms"])
    margin = (None if not default_ms else
              round((float(default_ms) - w_ms) / float(default_ms), 4))
    plan = TunePlan.from_dict({
        **_plan_from_candidate(winner, h, k).to_dict(),
        "backend": BACKEND, "measured_ms": w_ms, "default_ms": default_ms,
        "margin": margin,
        "bit_identical": results[winner.name].get("bit_identical") is True,
        "host_load": host_load(), "platform": platform,
        "evaluator": evaluator, "created_unix": round(time.time(), 3),
        "traffic_class": traffic_class,
        "certificate": certificate.to_dict() if certificate else None})
    path = save_plans(h, {int(k): plan}, fingerprint=fp, directory=plan_dir,
                      context={"source": source, "iters": int(iters)})
    _say(f"winner {winner.name!r}: {w_ms} ms vs default {default_ms} "
         f"(margin {margin}); saved {path}")
    from arrow_matrix_tpu_torch.ledger import record as ledger_record

    ledger_record(
        "tune", f"tuned_spmm_ms_k{int(k)}", w_ms, unit="ms",
        directory=ledger_dir, structure_hash=h, platform=platform,
        device_kind="host" if platform == "cpu" else evaluator,
        host_load=plan.host_load.get("loadavg_1m")
        if isinstance(plan.host_load, dict) else None,
        knobs={"k": int(k), "candidate": winner.name,
               "kernel": plan.kernel, "fmt": plan.fmt,
               "overlap_slabs": plan.overlap_slabs,
               "feature_dtype": plan.feature_dtype,
               "kernel_opts": plan.kernel_opts(),
               "traffic_class": traffic_class},
        payload={"default_ms": default_ms, "margin": margin,
                 "bit_identical": plan.bit_identical,
                 "evaluator": evaluator, "source": source,
                 "plan_path": path})
    return plan, {
        "structure_hash": h, "k": int(k), "cache_hit": False,
        "children_spawned": len(cands), "results": results,
        "pruned": pruned, "winner": winner.name, "plan": plan.to_dict(),
        "plan_path": path, "synth_program": synth_program,
        "wall_s": round(time.perf_counter() - t0, 3)}


def smoke_tune(run_dir: str, *, n: int = 96, width: int = 16,
               seed: int = 3, k: int = 8, iters: int = 2,
               timeout_s: float = 180.0, plan_dir: Optional[str] = None,
               restrict: Optional[List[str]] = None, device="cpu",
               quiet: bool = True) -> dict:
    """One small end-to-end search on a seeded BA graph (3 children on
    the CPU by default: ``default``, ``fold_tight``, ``pallas_sell``).
    Returns the search report with the plan."""
    if plan_dir is None:
        plan_dir = os.path.join(run_dir, "tune_plans")
    if restrict is None:
        restrict = ["default", "fold_tight", "pallas_sell"]
    source = {"kind": "ba", "n": int(n), "m": 3, "width": int(width),
              "seed": int(seed), "max_levels": 4}
    plan, report = search(source, k, iters=iters, timeout_s=timeout_s,
                          plan_dir=plan_dir, restrict=restrict,
                          run_dir=os.path.join(run_dir, "tune_runs"),
                          ledger_dir=os.path.join(run_dir, "ledger"),
                          device=device, quiet=quiet)
    report["plan_version"] = PLAN_VERSION
    report["ok"] = plan is not None
    return report

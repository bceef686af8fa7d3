"""The lens: per-tier compute profiling of the folded operator.

The port's copy of ``arrow_matrix_tpu/obs/lens.py``.  It profiles one
structure's fold step tier by tier, per carriage dtype, pairs each
measurement with the static counters of ``obs/costmodel.py`` (nnz,
rows and streamed bytes of the realized SELL tiers), and fits and
scores the per-family cost model.  The profile document (schema 1, the
JAX package's) is what everything downstream reads:
``fit_from_profile`` gives a :class:`~.costmodel.CostModel`,
``ratio_points`` the measured/predicted records the ledger bands
(``kind="lens"``), ``attribution_fractions`` the per-tier split of
``graft_xray``'s compute segment, ``explain_gap`` where a dtype pair's
gap lands.

On the card the fold step is one K1 launch over every tier
(``ops/cuda_sell.py``), so a tier cannot be timed alone without
changing the launch.  The lens times the full step and, for each
non-empty tier t, one K1 launch over the sub-operator of tiers 0..t
(a prefix), and attributes tier t the difference between consecutive
prefixes: each prefix pays the same fixed cost of a launch, so the
differences telescope to the full step instead of counting the fixed
cost once per tier.  Every number is a chained measurement
(``obs/tracer.chained_sampler``: ``iters`` launches ending in one
``.item()``, the round trip subtracted), the per-program minimum over
interleaved sweeps.  The port adds the K1 launches each chain made
(counted by the wrapper) as ``launches``: a tier's prefix chain, and a
dtype's two full-step chains.

Kernels.  ``"xla"`` (and ``"auto"``) is the fold's own path, K1 at its
default knobs.  ``"pallas"`` (the reference's name for its fused tier
kernel) is K1 with ``kernel_opts``, through
``MultiLevelArrow(kernel="pallas_sell")``: every prefix and the full
step launch at the profile's knobs, which are checked against the
contract and certified before anything is built.

The load-depth sweep (``ring_sweep``).  The reference re-times every
tier alone at ``ring=1`` against its deep DMA ring.  K1 has no ring;
its analogue is the depth of independent gathered row loads a lane
keeps in flight, the ``batch`` knob.  Each non-empty tier is re-timed
alone at the profile's batch (``deep{t}``) and at batch 4
(``ring1_{t}``), under the reference's keys: ``ring1_ms`` and
``dma_wait_ms`` a tier (the excess at batch 4, the wait the deeper
batch hides), the mean wait a family, and ``sweep`` names what was
swept.  Batch keeps every sum's order, so each tier's result at batch
4 must equal its result at the profile's batch bit for bit: the sweep
checks it and raises if not.  A scheduled profile skips the sweep (its
knobs are per tier already), as does one already at batch 4.  The
sweep's launches (its two chains and the bit check) are a tier's
``sweep_launches``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from arrow_matrix_tpu_torch.obs.costmodel import (
    SHALLOW_BATCH,
    CostModel,
    ITEMSIZE,
    check_kernel,
    fit_cost_model,
    k1_family,
    schedule_family,
    tier_family,
    tier_stream_bytes,
)

LENS_PROFILE_SCHEMA = 1

#: Per-tier attribution must cover the measured full iteration within
#: this relative gap.
LENS_COVERAGE_TOL = 0.10

#: Calibration band for measured/predicted ratios (``ledger/gate.py``
#: declares the same band).
LENS_RATIO_MIN = 0.5
LENS_RATIO_MAX = 2.0

#: A tier whose marginal (prefix-difference) time is under this share
#: of the full iteration is below the differencing resolution: it is
#: tagged ``below_resolution`` and left out of the fit and the ratios
#: (its ms still counts toward attribution and coverage).
LENS_RESOLUTION_FRAC = 0.05

#: Carriages the lens profiles (the int8 pair is two tensors).
LENS_DTYPES = ("f32", "bf16")


def _resolve_kernel(kernel: str) -> str:
    """"auto" is the fold's own path, K1 at its defaults ("xla");
    "pallas" is K1 with the profile's knobs."""
    return check_kernel("xla" if kernel == "auto" else kernel)


def _uniform_opts(kopts: Dict[str, Any]):
    """The profile's uniform K1 knobs as a checked ``LaunchOpts``."""
    from arrow_matrix_tpu_torch.ops.worklist import KNOBS, LaunchOpts

    knobs = {kk: (tuple(v) if isinstance(v, list) else v)
             for kk, v in kopts.items() if kk in KNOBS}
    return LaunchOpts(**knobs).check()


def _tier_static(sell, t: int, k: int, *, kernel: str,
                 feature_dtype: Optional[str],
                 schedule=None, batch: Optional[int] = None
                 ) -> Dict[str, Any]:
    """Static counter row of one realized SELL tier: the fields
    :func:`~.costmodel.tier_counters` derives from the fingerprint, read
    off the operator the profile ran.  Under "pallas" the family is
    refined by the batch tier ``t`` launches at (``pallas:tail@b8``,
    the key ``tier_counters`` prices); under "xla" a ``schedule``
    override for tier ``t`` refines the family by its row block and
    prices its carriage."""
    cols = sell.cols[t]
    m_t, n_t = int(cols.shape[0]), int(cols.shape[1])
    if sell.deg is not None:
        nnz = int(sell.deg[t].sum())
    elif sell.data is not None:
        nnz = int((sell.data[t] != 0).sum())
    else:
        nnz = m_t * n_t
    ov = None
    for e in (schedule or []):
        if int(e.get("tier", -1)) == t:
            ov = e
            break
    if ov is not None:
        feature_dtype = ov.get("carriage", feature_dtype)
    if kernel == "pallas":
        from arrow_matrix_tpu_torch.ops.worklist import default_batch

        b = (ov or {}).get("batch", batch)
        family = k1_family(m_t, default_batch(ITEMSIZE.get(
            feature_dtype, 4)) if b is None else int(b))
    elif ov is None:
        family = f"{kernel}:{tier_family(m_t)}"
    else:
        family = schedule_family(kernel, m_t,
                                 int(ov.get("row_block", 256)))
    return {
        "tier": t,
        "family": family,
        "rows": n_t,
        "nnz": nnz,
        "slots": m_t * n_t,
        "slot_width": m_t,
        "padded_slots": m_t * n_t - nnz,
        "streamed_bytes": tier_stream_bytes(
            m_t, n_t, k, itemsize=ITEMSIZE.get(feature_dtype, 4)),
    }


def _prefix_opts(kopts: Dict[str, Any], j: int) -> Dict[str, Any]:
    """``kopts`` restricted to tiers ``0..j`` (a schedule's later
    entries and per-tier chunks dropped)."""
    out = dict(kopts)
    if out.get("schedule"):
        out["schedule"] = [e for e in out["schedule"]
                           if int(e.get("tier", -1)) <= j]
    if isinstance(out.get("chunk_slots"), (list, tuple)):
        out["chunk_slots"] = tuple(out["chunk_slots"][:j + 1])
    return out


def _single_tier(sell, t: int):
    """Tier ``t`` of ``sell`` alone: its ``n_t`` output rows, reading
    every row of the carriage."""
    from arrow_matrix_tpu_torch.ops.sell import SellMatrix

    return SellMatrix(
        cols=(sell.cols[t],),
        data=(sell.data[t],) if sell.data is not None else None,
        deg=(sell.deg[t],) if sell.deg is not None else None,
        n_rows=int(sell.cols[t].shape[1]), row_starts=(0,),
        x_rows=int(sell.n_rows))


def _tier_launches(sell, *, kernel: str, kernel_opts: Dict[str, Any],
                   dtype, sweep: bool):
    """Yield ``(tier, prefix_fn, deep_fn, shallow_fn)`` per non-empty
    tier: ``prefix_fn`` runs K1 over tiers ``0..tier`` through
    ``ops/cuda_sell.py`` as the fold step launches them (the default
    knobs under "xla", the profile's launch groups under "pallas");
    under ``sweep`` ``deep_fn`` and ``shallow_fn`` run the tier alone
    at the profile's batch and at :data:`~.costmodel.SHALLOW_BATCH`
    (else both None)."""
    import dataclasses

    from arrow_matrix_tpu_torch.ops.cuda_sell import (
        launch_groups,
        sell_spmm_cuda,
        sell_spmm_k1,
    )

    uniform = _uniform_opts(kernel_opts) if kernel == "pallas" else None
    for t, cols in enumerate(sell.cols):
        if cols.shape[0] == 0:
            continue
        prefix = tier_prefix(sell, t)
        if kernel == "pallas":
            groups = launch_groups(_prefix_opts(kernel_opts, t), t + 1,
                                   dtype)
            prefix_fn = (lambda c, p=prefix, g=groups:
                         sell_spmm_k1(p, c, g))
        else:
            prefix_fn = lambda c, p=prefix: sell_spmm_cuda(p, c)  # noqa
        deep_fn = shallow_fn = None
        if sweep:
            single = _single_tier(sell, t)
            deep = dataclasses.replace(uniform,
                                       chunk_slots=uniform.chunk_of(t))
            shallow = dataclasses.replace(deep, batch=SHALLOW_BATCH)
            deep_fn = (lambda c, s=single, o=deep:
                       sell_spmm_cuda(s, c, o))
            shallow_fn = (lambda c, s=single, o=shallow:
                          sell_spmm_cuda(s, c, o))
        yield t, prefix_fn, deep_fn, shallow_fn


def tier_prefix(sell, j: int):
    """The sub-operator of tiers ``0..j`` of ``sell``: its output ends
    where tier ``j`` ends, and it reads every row of the carriage
    (``x_rows`` = the fold's positions)."""
    from arrow_matrix_tpu_torch.ops.sell import SellMatrix

    end = (int(sell.row_starts[j + 1])
           if j + 1 < len(sell.row_starts) else int(sell.n_rows))
    return SellMatrix(
        cols=tuple(sell.cols[:j + 1]),
        data=tuple(sell.data[:j + 1]) if sell.data is not None else None,
        deg=tuple(sell.deg[:j + 1]) if sell.deg is not None else None,
        n_rows=end,
        row_starts=tuple(int(r) for r in sell.row_starts[:j + 1]),
        x_rows=int(sell.n_rows))


def _chain_sampler(raw_fn, x, iters: int, launches: Dict[str, int],
                   name: str, clock, bump: bool = False):
    """Warm one chained measurement of ``raw_fn`` and return its
    zero-argument sampler (ms/iter per call, read on ``clock``).

    A same-shape program (the full fold step) feeds its output back as
    the next carry.  A shape-changing one (a tier prefix), or any with
    ``bump``, adds a runtime-valued, numerically negligible bump of its
    output's last row into the carry in place, so every launch reads
    what the one before it wrote.  The K1 launches of the warm-up and of
    every sample add to ``launches[name]``.
    """
    from arrow_matrix_tpu_torch.obs.tracer import chained_sampler
    from arrow_matrix_tpu_torch.ops import cuda_sell

    def run(x0, n):
        c = x0
        for _ in range(n):
            out = raw_fn(c)
            if not bump and out.shape == c.shape and out.dtype == c.dtype:
                c = out
            else:
                c[:1, :1].add_(out[-1:, :1], alpha=1e-30)
        return c

    def counted(x0, n):
        before = cuda_sell.LAUNCHES
        try:
            return run(x0, n)
        finally:
            launches[name] = (launches.get(name, 0)
                              + cuda_sell.LAUNCHES - before)

    return chained_sampler(counted, x, iters, clock=clock)


def _sweep_min(samplers: Dict[str, Any], repeats: int = 5
               ) -> Dict[str, float]:
    """Minimum ms per program over ``repeats`` interleaved sweeps: host
    drift lands on whole sweeps, and the minimum discards it."""
    best: Dict[str, float] = {}
    for _ in range(max(repeats, 1)):
        for name, sample in samplers.items():
            ms = sample()
            if name not in best or ms < best[name]:
                best[name] = ms
    return best


def profile_fold(levels, width: int, k: int, *,
                 kernel: str = "auto",
                 feature_dtypes: Sequence[str] = ("f32",),
                 iters: int = 20,
                 ring_sweep: bool = False,
                 kernel_opts: Optional[Dict[str, Any]] = None,
                 growth: float = 1.2,
                 fold_align: Optional[int] = None,
                 registry=None, device=None,
                 clock=time.perf_counter) -> Dict[str, Any]:
    """Profile one structure's fold step per tier and carriage dtype.

    Builds the fold executor once per dtype on ``device`` (the card
    unless ``"cpu"``), times the full step, then attributes each tier
    as the difference between K1 over tiers ``0..t`` and over
    ``0..t-1``; ``coverage`` records how well the tiers sum to the full
    step.  The base of the differences, ``chain_floor_ms``, is what the
    bump costs a prefix chain: the full step's chain with the bump less
    the one without.  (The reference times the bump alone; here its
    launches alone are bound by the host, while the prefix chains it
    rides on are bound by the device.)  Every prefix operator and its
    work list are built and warmed before the sweeps.  Under
    ``kernel="pallas"`` every launch runs at ``kernel_opts``, checked
    (``LaunchOpts.check``) and certified
    (``analysis/kernels.certify_candidate_opts``) first: a knob point
    that does not certify raises.  ``ring_sweep`` adds the load-depth
    sweep (module docstring) under "pallas".  ``clock`` is the seconds
    clock every sample reads.  Returns the lens profile document
    (schema 1).
    """
    import torch

    from arrow_matrix_tpu_torch.ledger.store import device_stamp
    from arrow_matrix_tpu_torch.parallel.multi_level import (
        MultiLevelArrow,
        resolve_feature_dtype,
    )
    from arrow_matrix_tpu_torch.tune.fingerprint import (
        fingerprint_hash,
        structure_fingerprint,
    )
    from arrow_matrix_tpu_torch.utils import random_dense, resolve_device

    kernel = _resolve_kernel(kernel)
    kopts = dict(kernel_opts or {})
    for fd in feature_dtypes:
        if fd not in LENS_DTYPES:
            raise ValueError(f"the lens profiles the carriages "
                             f"{LENS_DTYPES}, got {fd!r}")
    if kernel == "pallas":
        from arrow_matrix_tpu_torch.analysis.kernels import (
            certify_candidate_opts,
        )

        uniform = _uniform_opts(kopts)
        for fd in feature_dtypes:
            why = certify_candidate_opts(
                {kk: v for kk, v in kopts.items()
                 if kk != "feature_dtype"}, k, feature_dtype=fd)
            if why is not None:
                raise ValueError(f"kernel_opts {kopts} at k={k} {fd}: "
                                 f"{why}")
    dev = resolve_device(device)
    stamp = device_stamp(dev)
    fp = structure_fingerprint(levels, width, np.float32,
                               growth=growth, slot_align=fold_align)
    doc: Dict[str, Any] = {
        "schema": LENS_PROFILE_SCHEMA,
        "kind": "lens_profile",
        "structure_hash": fingerprint_hash(fp),
        "platform": stamp["platform"],
        "device_kind": stamp["device_kind"],
        "width": int(width),
        "k": int(k),
        "kernel": kernel,
        "iters": int(iters),
        "kernel_opts": kopts,
        "dtypes": {},
    }
    for fd in feature_dtypes:
        feature_dtype = None if fd == "f32" else fd
        dtype = resolve_feature_dtype(feature_dtype)
        deep_batch = (uniform.batch_for(dtype.itemsize)
                      if kernel == "pallas" else None)
        do_ring = (ring_sweep and kernel == "pallas"
                   and not kopts.get("schedule")
                   and deep_batch != SHALLOW_BATCH)
        multi = MultiLevelArrow(
            levels, width, fmt="fold",
            kernel="pallas_sell" if kernel == "pallas" else "xla",
            kernel_opts=kopts or None, feature_dtype=feature_dtype,
            fold_growth=growth, fold_align=fold_align, device=dev)
        doc["n"] = int(multi.n)
        sell = multi.sell
        x = multi.set_features(random_dense(multi.n, k, seed=3))
        launches: Dict[str, int] = {}

        # Every chain is built and warmed first, then all are sampled
        # in interleaved sweeps.  "bumped" is the full step's chain
        # carrying the prefixes' bump: its excess over "full" is the
        # chain's own cost, the base of the telescoping, so that cost
        # never lands on a tier.
        step = lambda c: multi.raw_step(c, sell)   # noqa: E731
        samplers = {
            "full": _chain_sampler(step, x, iters, launches, "full",
                                   clock),
            "bumped": _chain_sampler(step, x, iters, launches, "bumped",
                                     clock, bump=True),
        }
        tier_fns = list(_tier_launches(sell, kernel=kernel,
                                       kernel_opts=kopts, dtype=dtype,
                                       sweep=do_ring))
        equal = 0
        for t, prefix_fn, deep_fn, shallow_fn in tier_fns:
            samplers[f"prefix{t}"] = _chain_sampler(
                prefix_fn, x, iters, launches, f"prefix{t}", clock)
            if not do_ring:
                continue
            if not _same_bits(deep_fn, shallow_fn, x, launches,
                              f"check{t}"):
                raise RuntimeError(
                    f"tier {t}: K1 at batch {SHALLOW_BATCH} differs from "
                    f"batch {deep_batch} ({fd}, k={k}); batch keeps every "
                    f"sum's order, so this is a kernel fault")
            equal += 1
            samplers[f"deep{t}"] = _chain_sampler(
                deep_fn, x, iters, launches, f"deep{t}", clock)
            samplers[f"ring1_{t}"] = _chain_sampler(
                shallow_fn, x, iters, launches, f"ring1_{t}", clock)
        best = _sweep_min(samplers)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        full_ms = best["full"]
        floor_ms = max(best["bumped"] - full_ms, 0.0)
        if registry is not None:
            registry.record("call_time_ms", full_ms,
                            call=f"lens_full_{fd}", dtype=fd)
        tiers: List[Dict[str, Any]] = [
            _tier_static(sell, t, k, kernel=kernel,
                         feature_dtype=feature_dtype,
                         schedule=kopts.get("schedule"),
                         batch=deep_batch)
            for t in range(len(sell.cols))]
        dma_wait: Dict[str, List[float]] = {}
        prev_ms = floor_ms
        for t, *_ in tier_fns:
            cur = best[f"prefix{t}"]
            ms = max(cur - prev_ms, 0.0)
            prev_ms = max(cur, prev_ms)
            tiers[t]["measured_ms"] = float(ms)
            tiers[t]["launches"] = int(launches[f"prefix{t}"])
            if registry is not None:
                registry.record("call_time_ms", ms,
                                call=f"lens_tier{t}_{fd}", dtype=fd)
            if do_ring:
                ms1 = best[f"ring1_{t}"]
                tiers[t]["ring1_ms"] = float(ms1)
                wait = max(float(ms1) - float(best[f"deep{t}"]), 0.0)
                tiers[t]["dma_wait_ms"] = wait
                tiers[t]["sweep_launches"] = int(
                    launches[f"deep{t}"] + launches[f"ring1_{t}"]
                    + launches[f"check{t}"])
                dma_wait.setdefault(tiers[t]["family"], []).append(wait)
        attributed = sum(t.get("measured_ms", 0.0) for t in tiers)
        resolution_ms = max(float(floor_ms),
                            LENS_RESOLUTION_FRAC * float(full_ms))
        for tr in tiers:
            if (tr.get("measured_ms") is not None
                    and tr["measured_ms"] < resolution_ms):
                tr["below_resolution"] = True
        doc["dtypes"][fd] = {
            "full_ms": float(full_ms),
            "chain_floor_ms": float(floor_ms),
            "resolution_ms": float(resolution_ms),
            "attributed_ms": float(attributed),
            "coverage": float(attributed / full_ms) if full_ms else 0.0,
            "tiers": tiers,
            "dma_wait_ms": {f: float(np.mean(v))
                            for f, v in sorted(dma_wait.items())},
            "launches": int(launches["full"] + launches["bumped"]),
        }
        if do_ring:
            doc["sweep"] = {"knob": "batch", "deep": int(deep_batch),
                            "shallow": SHALLOW_BATCH,
                            "bit_equal_tiers": equal}
        del multi, sell, x, samplers
    return doc


def _same_bits(deep_fn, shallow_fn, x, launches: Dict[str, int],
               name: str) -> bool:
    """Whether one tier's K1 result at the deep and the shallow batch
    agree bit for bit on ``x``; their launches add to
    ``launches[name]``."""
    import torch

    from arrow_matrix_tpu_torch.ops import cuda_sell

    before = cuda_sell.LAUNCHES
    try:
        return torch.equal(deep_fn(x), shallow_fn(x))
    finally:
        launches[name] = cuda_sell.LAUNCHES - before


# ---------------------------------------------------------------------------
# Model fit / score over a profile
# ---------------------------------------------------------------------------

def fit_from_profile(profile: Dict[str, Any],
                     dtypes: Optional[Sequence[str]] = None
                     ) -> CostModel:
    """Fit the per-family model from one profile's measured tiers.  By
    default every carriage feeds one joint fit: the f32/bf16 pair varies
    ``streamed_bytes`` at fixed nnz and rows, which separates the byte
    coefficient from the others."""
    points: List[Dict[str, Any]] = []
    waits: Dict[str, List[float]] = {}
    for fd, entry in profile["dtypes"].items():
        if dtypes is not None and fd not in dtypes:
            continue
        for t in entry["tiers"]:
            if t.get("measured_ms") and not t.get("below_resolution"):
                points.append(t)
        for fam, w in entry.get("dma_wait_ms", {}).items():
            waits.setdefault(fam, []).append(float(w))
    return fit_cost_model(
        points,
        structure_hash=str(profile.get("structure_hash", "")),
        platform=str(profile.get("platform", "")),
        dma_wait_ms={f: float(np.mean(v)) for f, v in waits.items()})


def ratio_points(profile: Dict[str, Any], model: CostModel
                 ) -> List[Dict[str, Any]]:
    """Measured/predicted ratio per measured tier (plus one
    full-iteration point per dtype): the calibration metric the ledger
    records and the gate bands."""
    out: List[Dict[str, Any]] = []
    for fd, entry in profile["dtypes"].items():
        total_pred = 0.0
        for t in entry["tiers"]:
            measured = float(t.get("measured_ms") or 0.0)
            if measured <= 0.0 or t.get("below_resolution"):
                continue
            pred = model.predict_point(t["family"], t["nnz"],
                                       t["rows"], t["streamed_bytes"])
            total_pred += pred
            out.append({
                "dtype": fd, "tier": t["tier"], "family": t["family"],
                "measured_ms": measured, "predicted_ms": pred,
                "ratio": measured / pred if pred > 0 else float("inf"),
            })
        full = float(entry["full_ms"])
        if total_pred > 0 and full > 0:
            out.append({
                "dtype": fd, "tier": None, "family": "full",
                "measured_ms": full, "predicted_ms": total_pred,
                "ratio": full / total_pred,
            })
    return out


def attribution_fractions(profile: Dict[str, Any], dtype: str
                          ) -> Dict[str, float]:
    """Per-tier fractions of the measured full iteration for one
    carriage, summing to 1 (what the tiers do not cover lands in
    ``other``): ``graft_xray``'s compute segment is split by these."""
    entry = profile["dtypes"][dtype]
    full = float(entry["full_ms"])
    if full <= 0.0:
        return {}
    out: Dict[str, float] = {}
    for t in entry["tiers"]:
        ms = float(t.get("measured_ms") or 0.0)
        if ms > 0.0:
            out[f"L{t['tier']}:{t['family'].split(':')[1]}"] = ms / full
    covered = sum(out.values())
    if covered > 1.0:  # timing noise: renormalize over the tier sum
        out = {lbl: v / covered for lbl, v in out.items()}
    else:
        out["other"] = 1.0 - covered
    return out


def explain_gap(profile: Dict[str, Any], *, base: str = "f32",
                other: str = "bf16",
                model: Optional[CostModel] = None) -> Dict[str, Any]:
    """Attribute the ``other`` - ``base`` full-iteration gap per tier.

    Names the dominant per-tier delta and, with a model, its segment:
    the gather term (the byte coefficient times the change in streamed
    bytes) against the decode/accumulate residual, or the wait of the
    load-depth sweep (``dma_wait_ms``).
    """
    eb = profile["dtypes"][base]
    eo = profile["dtypes"][other]
    gap = float(eo["full_ms"]) - float(eb["full_ms"])
    deltas: Dict[str, float] = {}
    gather_delta: Dict[str, float] = {}
    for tb, to in zip(eb["tiers"], eo["tiers"]):
        label = f"L{tb['tier']}:{tb['family'].split(':')[1]}"
        d = (float(to.get("measured_ms") or 0.0)
             - float(tb.get("measured_ms") or 0.0))
        if to.get("measured_ms") or tb.get("measured_ms"):
            deltas[label] = d
        if model is not None:
            gamma = model.coeffs.get(to["family"], {}).get(
                "streamed_bytes", 0.0)
            gather_delta[label] = gamma * (
                float(to["streamed_bytes"]) - float(tb["streamed_bytes"]))
    wait_b = sum(eb.get("dma_wait_ms", {}).values())
    wait_o = sum(eo.get("dma_wait_ms", {}).values())
    if wait_b or wait_o:
        deltas["dma_wait"] = wait_o - wait_b
    if not deltas:
        return {"gap_ms": gap, "per_level": {}, "dominant": None,
                "dominant_segment": None, "note": "no measured tiers"}
    dominant = max(deltas, key=lambda lbl: abs(deltas[lbl]))
    if dominant == "dma_wait":
        segment = "dma-wait"
        note = (f"{other} vs {base}: dominant delta is DMA wait "
                f"({deltas[dominant]:+.3f} ms)")
    else:
        segment = "decode/accumulate"
        g = gather_delta.get(dominant)
        if g is not None and abs(g) >= 0.5 * abs(deltas[dominant]) > 0:
            segment = "gather-bytes"
        note = (f"{other} vs {base}: dominant delta at {dominant} "
                f"({deltas[dominant]:+.3f} ms of {gap:+.3f} ms gap), "
                f"segment: {segment}")
    return {"gap_ms": gap, "per_level": deltas,
            "gather_delta_ms": gather_delta or None,
            "dominant": dominant, "dominant_segment": segment,
            "note": note}


def predict_profile_iter_ms(profile: Dict[str, Any], model: CostModel,
                            dtype: str = "f32") -> float:
    """Model-predicted full-iteration ms of one profile point: the sum
    over its static tier counters."""
    entry = profile["dtypes"][dtype]
    return model.predict_tiers(
        [t for t in entry["tiers"] if t["slot_width"] > 0])


# ---------------------------------------------------------------------------
# Ledger emission
# ---------------------------------------------------------------------------

def record_profile(profile: Dict[str, Any],
                   model: Optional[CostModel] = None,
                   directory: Optional[str] = None) -> List[str]:
    """Sink one profile (and, with a model, its calibration ratios) as
    ``kind="lens"`` ledger records stamped with the profile's platform
    and device.  Millisecond metrics carry the live host-load stamp;
    ratio metrics record ``host_load=None`` (a measured/predicted ratio
    is load-invariant)."""
    from arrow_matrix_tpu_torch.ledger import store as ledger_store

    sh = str(profile.get("structure_hash", ""))
    kern = profile.get("kernel", "?")
    if (profile.get("kernel_opts") or {}).get("schedule"):
        # A scheduled profile is a distinct measurement series.
        kern = f"{kern}-synth"
    k = int(profile.get("k", 0))
    ids: List[str] = []

    def _rec(metric, value, unit, **extra):
        rec = ledger_store.record(
            "lens", metric, round(float(value), 6),
            directory=directory, unit=unit, structure_hash=sh,
            platform=profile.get("platform"),
            device_kind=profile.get("device_kind"),
            knobs={"kernel": kern, "k": k,
                   "width": int(profile.get("width", 0)), **extra},
            **({"host_load": None} if unit == "ratio" else {}))
        if rec:
            ids.append(rec["record_id"])

    for fd, entry in profile["dtypes"].items():
        _rec(f"lens_full_ms_{kern}_{fd}_k{k}", entry["full_ms"], "ms",
             feature_dtype=fd)
        for t in entry["tiers"]:
            if t.get("measured_ms"):
                _rec(f"lens_tier{t['tier']}_ms_{kern}_{fd}_k{k}",
                     t["measured_ms"], "ms", feature_dtype=fd,
                     tier=t["tier"], family=t["family"])
        _rec(f"lens_coverage_{kern}_{fd}_k{k}", entry["coverage"],
             "ratio", feature_dtype=fd)
    if model is not None:
        for p in ratio_points(profile, model):
            tier = "full" if p["tier"] is None else f"t{p['tier']}"
            _rec(f"lens_ratio_{kern}_{p['dtype']}_k{k}_{tier}",
                 p["ratio"], "ratio", feature_dtype=p["dtype"],
                 family=p["family"])
    return ids


def check_profile(profile: Dict[str, Any],
                  model: Optional[CostModel] = None,
                  coverage_tol: float = LENS_COVERAGE_TOL
                  ) -> List[str]:
    """Problems with one profile (and model): schema drift, attribution
    that fails to cover the measured iteration, ratios outside the
    calibration band.  Empty means healthy."""
    problems: List[str] = []
    if profile.get("schema") != LENS_PROFILE_SCHEMA:
        problems.append(
            f"lens profile schema {profile.get('schema')} != "
            f"{LENS_PROFILE_SCHEMA}")
        return problems
    if not profile.get("dtypes"):
        problems.append("lens profile has no dtype entries")
    for fd, entry in profile.get("dtypes", {}).items():
        full = float(entry.get("full_ms") or 0.0)
        if not np.isfinite(full) or full <= 0.0:
            problems.append(f"{fd}: non-positive full_ms {full}")
            continue
        cov = float(entry.get("coverage") or 0.0)
        if abs(cov - 1.0) > coverage_tol:
            problems.append(
                f"{fd}: per-level attribution covers {cov:.3f} of the "
                f"measured iteration (|1-cov| > {coverage_tol})")
        measured = [t for t in entry.get("tiers", ())
                    if t.get("measured_ms")]
        if not measured:
            problems.append(f"{fd}: no measured tiers")
    if model is not None:
        for p in ratio_points(profile, model):
            r = p["ratio"]
            if not (LENS_RATIO_MIN <= r <= LENS_RATIO_MAX):
                where = ("full" if p["tier"] is None
                         else f"tier {p['tier']}")
                problems.append(
                    f"{p['dtype']} {where}: measured/predicted ratio "
                    f"{r:.3f} outside [{LENS_RATIO_MIN}, "
                    f"{LENS_RATIO_MAX}]")
    return problems

"""The lens's structure-conditioned compute cost model.

The port's copy of ``arrow_matrix_tpu/obs/costmodel.py``, fitted from
the port's own profiles (``obs/lens.py``): the TPU coefficients do not
carry over.  The structure axis every prediction is conditioned on is
the fingerprint's degree ladder (``tune/fingerprint.py``: per-tier
rows, nnz, slots and slot width).  On top of the static counters sits
a linear model per tier family

    t_tier ~ a * nnz + b * rows + c * streamed_bytes

fitted from one measured profile and keyed by the structure hash.
Tiers are grouped into families by kernel and slot width,
coefficients are clamped nonnegative, and the fit is rescaled so the
predicted family total equals the measured one: the model ranks
candidates and flags drift (the ledger's measured/predicted ratio
band).

Kernels.  ``"xla"`` is the fold's own path, which on the card is K1
(``csrc/sell_tier_spmm.cu``) at its default knobs: it reads one X row
per slot, so its streamed bytes count ``granule = 1``, the same count
as K1's gathered-bytes bound.  ``"pallas"`` (the reference's name for
its fused tier kernel; ``kernel="pallas_sell"`` executors) is K1 with
its launch knobs: the same streamed bytes, families refined by the
knob that sets a launch's register use (``@b<batch>``, the batch the
launch runs at), and per tier K1's launch counters from its work list
(items, CTAs, split partials).  The reference's ``meta_*`` counters
over a TPU call description become Hopper counters over K1's launch
meta (``ops/worklist.py:k1_meta``): CTAs, gathered bytes, shared
memory, rows, split partials.  K1 has no DMA ring; the ring's two
counters become its gathered loads: ``meta_wave_count`` the batches of
independent row loads a launch issues (``batch`` loads in flight a
lane), ``meta_dma_copies`` the row loads themselves (one a slot).

The reference's ring sweep re-times a tier at ``ring=1`` and stores
the excess over the deep ring as its DMA wait.  K1's analogue is its
load depth: the lens re-times a tier at ``batch=4``
(:data:`SHALLOW_BATCH`) against the profile's batch, and the excess is
the wait the deeper batch hides (``dma_wait_ms``, the reference's key).
``predict_iter_ms`` adds it back for a tier priced at the shallow
point: ``ring=1``, or a batch of 4.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

#: The JAX package's granule (rows per packed feature line).  Here it is
#: only the bound between the "tail" and "mid" families, so that the
#: port's families are the reference's.
GRANULE = 8

#: Carriage itemsize per dtype key.
ITEMSIZE = {None: 4, "f32": 4, "bf16": 2, "int8": 1}

#: Slot-width family boundaries: a tier's slot count per row decides
#: which coefficient set prices it.
_FAMILY_BOUNDS = ((0, "zero"), (GRANULE, "tail"), (64, "mid"))

#: The kernels the port prices: K1 at its defaults ("xla") and K1
#: with its launch knobs ("pallas").
KERNELS = ("xla", "pallas")

#: K1's shallow load depth, the analogue of the reference's ``ring=1``:
#: the least ``batch`` it takes (``ops/worklist.py:BATCH_CHOICES``).
SHALLOW_BATCH = 4


def check_kernel(kernel: str) -> str:
    """``kernel`` if the port prices it, else a ValueError."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (expected one of "
                         f"{KERNELS})")
    return kernel


# -- Hopper counters over K1's launch meta (ops/worklist.py:k1_meta) ---------

def meta_grid_programs(meta: Dict[str, Any]) -> int:
    """CTAs one K1 launch runs: its items times its CTAs along the
    features."""
    return len(meta["items"]) * int(meta["col_blocks"])


def meta_stream_bytes(meta: Dict[str, Any]) -> int:
    """Feature bytes the launch gathers: one X row of ``k`` items a
    slot (padding slots included)."""
    return sum(int(m_t) * int(n_t) for _, m_t, n_t, _, _ in meta["tiers"]) \
        * int(meta["k"]) * int(meta["itemsize"])


def meta_wave_count(meta: Dict[str, Any]) -> int:
    """Batches of gathered row loads one K1 launch issues: a thread
    group walks each chunk of a row in batches of ``batch`` slot loads,
    so a tier issues ``rows x chunks x ceil(chunk slots / batch)`` (the
    rows x ``ceil(slots / batch)`` of a tier whose rows are one chunk),
    once for each CTA along the features."""
    batch = int(meta["batch"])
    waves = sum(int(n_t) * int(s) * -(-int(length) // batch)
                for _, m_t, n_t, length, s in meta["tiers"] if int(m_t))
    return waves * int(meta["col_blocks"])


def meta_dma_copies(meta: Dict[str, Any]) -> int:
    """Gathered row loads one K1 launch issues: one X row a slot
    (padding slots included), the slots of its tiers."""
    return sum(int(m_t) * int(n_t) for _, m_t, n_t, _, _ in meta["tiers"])


def meta_smem_bytes(meta: Dict[str, Any]) -> int:
    """Shared memory of one CTA (static plus dynamic)."""
    return int(meta["static_smem"]) + int(meta["dynamic_smem"])


def meta_padded_rows(meta: Dict[str, Any]) -> int:
    """Output rows the launch writes."""
    return sum(int(n_t) for _, _, n_t, _, _ in meta["tiers"])


def meta_split_partials(meta: Dict[str, Any]) -> int:
    """Rows of the f32 workspace the launch writes (block sums of the
    rows split across CTAs); nonzero means a second launch adds them."""
    return int(meta["n_parts"])


def _k1_tier_counters(slot_width: int, rows: int, k: int, itemsize: int,
                      chunk_slots: int) -> Dict[str, int]:
    """K1's launch counters of one tier at its knobs (a one-tier work
    list)."""
    from arrow_matrix_tpu_torch.ops.worklist import (
        LaunchOpts,
        build_worklist,
        lanes,
    )

    if slot_width <= 0 or rows <= 0:
        return {"k1_items": 0, "k1_ctas": 0, "k1_split_partials": 0}
    wl = build_worklist([(slot_width, rows)], [0], k, itemsize,
                        vecload=k * itemsize % 16 == 0,
                        opts=LaunchOpts(chunk_slots=chunk_slots))
    col_blocks = lanes(k, itemsize, k * itemsize % 16 == 0)[2]
    return {"k1_items": len(wl.items),
            "k1_ctas": len(wl.items) * col_blocks,
            "k1_split_partials": int(wl.n_parts)}


def tier_family(slot_width: int) -> str:
    """Width family of one ladder tier: zero / tail / mid / head."""
    for bound, name in _FAMILY_BOUNDS:
        if slot_width <= bound:
            return name
    return "head"


def ladder_padded_slots(fp: Dict[str, Any]) -> List[int]:
    """Per-tier padding (slots - nnz) of the fingerprint's ladder."""
    ladder = fp["ladder"]
    return [int(s) - int(n)
            for s, n in zip(ladder["slots"], ladder["nnz"])]


def tier_stream_bytes(slot_width: int, rows: int, k: int, *,
                      itemsize: int = 4, granule: int = 1) -> int:
    """Modeled gather bytes of one ladder tier at feature width ``k``:
    one X row a slot (``granule == 1``, K1), or a whole ``granule``-row
    line a slot with rows padded to a granule multiple."""
    if slot_width <= 0 or rows <= 0:
        return 0
    rows_pad = -(-rows // granule) * granule if granule > 1 else rows
    return slot_width * rows_pad * granule * k * itemsize


def schedule_family(kernel: str, slot_width: int,
                    row_block: int) -> str:
    """Family key of one scheduled tier: the width family refined by
    its row block (``xla:tail@rb64``).  :meth:`CostModel.predict_point`
    falls back ``@rb`` suffix -> base family -> the kernel's pool."""
    return f"{kernel}:{tier_family(int(slot_width))}@rb{int(row_block)}"


def tier_counters(fp: Dict[str, Any], k: int, *,
                  kernel: str = "xla",
                  feature_dtype: Optional[str] = None,
                  schedule: Optional[List[Dict[str, Any]]] = None,
                  kernel_opts: Optional[Dict[str, Any]] = None
                  ) -> List[Dict[str, Any]]:
    """Static per-tier counters for one (fingerprint, k, kernel,
    carriage) point: the rows the cost model is fitted on and predicts
    from.  Under "xla", ``schedule`` (the reference's per-tier
    overrides) refines a tier's family by its row block and prices its
    own carriage; under "pallas" (K1's knobs) the uniform
    ``kernel_opts`` and the schedule's entries set each tier's batch,
    chunk and carriage, and each tier carries K1's launch counters."""
    check_kernel(kernel)
    if kernel == "pallas":
        return _k1_counters(fp, k, feature_dtype, schedule,
                            kernel_opts or {})
    sched: Dict[int, Dict[str, Any]] = {}
    for e in (schedule or []):
        try:
            sched[int(e["tier"])] = e
        except (KeyError, TypeError, ValueError):
            continue
    ladder = fp["ladder"]
    out = []
    for t, (rows, nnz, slots, w) in enumerate(zip(
            ladder["rows"], ladder["nnz"], ladder["slots"],
            ladder["slot_width"])):
        ov = sched.get(t)
        fd_t = feature_dtype
        if ov is None:
            family = f"{kernel}:{tier_family(int(w))}"
            ring_t = None
        else:
            family = schedule_family(kernel, int(w),
                                     int(ov.get("row_block", 256)))
            fd_t = ov.get("carriage", feature_dtype)
            ring_t = (int(ov["ring"]) if ov.get("ring") is not None
                      else None)
        out.append({
            "tier": t,
            "family": family,
            "rows": int(rows),
            "nnz": int(nnz),
            "slots": int(slots),
            "slot_width": int(w),
            "padded_slots": int(slots) - int(nnz),
            "ring": ring_t,
            "streamed_bytes": tier_stream_bytes(
                int(w), int(rows), k, itemsize=ITEMSIZE.get(fd_t, 4)),
        })
    return out


def k1_family(slot_width: int, batch: int) -> str:
    """Family key of one tier under K1's knobs: the width family refined
    by the batch the launch runs at (``pallas:tail@b8``)."""
    return f"pallas:{tier_family(int(slot_width))}@b{int(batch)}"


def _k1_counters(fp: Dict[str, Any], k: int, feature_dtype: Optional[str],
                 schedule: Optional[List[Dict[str, Any]]],
                 opts: Dict[str, Any]) -> List[Dict[str, Any]]:
    from arrow_matrix_tpu_torch.ops.worklist import default_batch

    sched = {int(e["tier"]): e for e in (schedule or [])
             if isinstance(e, dict) and "tier" in e}
    ladder = fp["ladder"]
    out = []
    for t, (rows, nnz, slots, w) in enumerate(zip(
            ladder["rows"], ladder["nnz"], ladder["slots"],
            ladder["slot_width"])):
        ov = sched.get(t, {})
        fd_t = ov.get("carriage", feature_dtype)
        item = ITEMSIZE.get(fd_t, 4)
        batch = ov.get("batch", opts.get("batch"))
        batch = default_batch(item) if batch is None else int(batch)
        chunk = int(ov.get("chunk_slots", opts.get("chunk_slots", 128)))
        ring = ov.get("ring", opts.get("ring"))
        out.append({
            "tier": t, "family": k1_family(int(w), batch),
            "rows": int(rows),
            "nnz": int(nnz), "slots": int(slots), "slot_width": int(w),
            "padded_slots": int(slots) - int(nnz),
            "ring": None if ring is None else int(ring), "batch": batch,
            "deep_batch": default_batch(item),
            "streamed_bytes": tier_stream_bytes(int(w), int(rows), k,
                                                itemsize=item),
            **_k1_tier_counters(int(w), int(rows), k, item, chunk)})
    return out


# ---------------------------------------------------------------------------
# The fitted model
# ---------------------------------------------------------------------------

COSTMODEL_VERSION = 1

#: Regressor order of one family's coefficient vector.
_REGRESSORS = ("nnz", "rows", "streamed_bytes")


@dataclass
class CostModel:
    """Per-family linear compute model for ONE structure (the JAX
    package's JSON: ``kind="lens_cost_model"``, version 1).

    ``coeffs[family]`` maps each regressor to its ms-per-unit
    coefficient (all >= 0); ``dma_wait_ms[family]`` is a profile's
    measured wait of one tier of that family at the shallow load depth
    (K1 at ``batch=4`` against the profile's batch; the reference's
    ``ring=1`` against its deep ring).
    """

    structure_hash: str
    platform: str
    coeffs: Dict[str, Dict[str, float]] = field(default_factory=dict)
    dma_wait_ms: Dict[str, float] = field(default_factory=dict)
    version: int = COSTMODEL_VERSION

    def predict_point(self, family: str, nnz: int, rows: int,
                      streamed_bytes: int) -> float:
        """Predicted ms of one tier; an unseen family falls back to the
        same-kernel families' mean coefficients (never raises)."""
        c = self.coeffs.get(family)
        if c is None and "@" in family:
            c = self.coeffs.get(family.split("@", 1)[0])
        if c is None:
            prefix = family.split(":", 1)[0] + ":"
            pool = [v for f, v in self.coeffs.items()
                    if f.startswith(prefix)] or list(self.coeffs.values())
            if not pool:
                return 0.0
            c = {r: float(np.mean([v.get(r, 0.0) for v in pool]))
                 for r in _REGRESSORS}
        ms = (c.get("nnz", 0.0) * nnz + c.get("rows", 0.0) * rows
              + c.get("streamed_bytes", 0.0) * streamed_bytes)
        return max(float(ms), 0.0)

    def predict_tiers(self, tiers: List[Dict[str, Any]]) -> float:
        return sum(self.predict_point(t["family"], t["nnz"], t["rows"],
                                      t["streamed_bytes"])
                   for t in tiers)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "kind": "lens_cost_model",
            "structure_hash": self.structure_hash,
            "platform": self.platform,
            "coeffs": {f: dict(c) for f, c in self.coeffs.items()},
            "dma_wait_ms": dict(self.dma_wait_ms),
        }

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "CostModel":
        if doc.get("version") != COSTMODEL_VERSION:
            raise ValueError(
                f"cost model version {doc.get('version')} != runtime "
                f"{COSTMODEL_VERSION}")
        return cls(structure_hash=str(doc.get("structure_hash") or ""),
                   platform=str(doc.get("platform") or ""),
                   coeffs={f: {r: float(v) for r, v in c.items()}
                           for f, c in (doc.get("coeffs") or {}).items()},
                   dma_wait_ms={f: float(v) for f, v in
                                (doc.get("dma_wait_ms") or {}).items()})


def fit_cost_model(points: List[Dict[str, Any]], *,
                   structure_hash: str = "", platform: str = "",
                   dma_wait_ms: Optional[Dict[str, float]] = None
                   ) -> CostModel:
    """Fit per-family coefficients from measured tier points (each with
    ``family``, the regressors and ``measured_ms``): least squares
    through the origin per family, negative coefficients clamped to
    zero, then a rescale so the family's predicted total equals its
    measured total (the per-point measured/predicted ratio is then the
    calibration metric the ledger bands)."""
    by_family: Dict[str, List[Dict[str, Any]]] = {}
    for p in points:
        if float(p.get("measured_ms", 0.0)) <= 0.0:
            continue
        by_family.setdefault(str(p["family"]), []).append(p)
    coeffs: Dict[str, Dict[str, float]] = {}
    for family, pts in sorted(by_family.items()):
        a = np.array([[float(p.get(r, 0.0)) for r in _REGRESSORS]
                      for p in pts], dtype=np.float64)
        y = np.array([float(p["measured_ms"]) for p in pts],
                     dtype=np.float64)
        # Column scaling keeps lstsq honest when bytes are ~1e6x nnz.
        scale = np.maximum(np.abs(a).max(axis=0), 1e-12)
        sol, *_ = np.linalg.lstsq(a / scale, y, rcond=None)
        c = np.maximum(sol / scale, 0.0)
        pred = float((a @ c).sum())
        meas = float(y.sum())
        if pred > 0.0 and meas > 0.0:
            c = c * (meas / pred)
        elif meas > 0.0:
            # Degenerate regressors: price by nnz so the family still
            # predicts something positive.
            nnz_total = max(sum(float(p.get("nnz", 0.0)) for p in pts),
                            1.0)
            c = np.zeros(len(_REGRESSORS))
            c[0] = meas / nnz_total
        coeffs[family] = {r: float(v) for r, v in zip(_REGRESSORS, c)}
    return CostModel(structure_hash=structure_hash, platform=platform,
                     coeffs=coeffs,
                     dma_wait_ms=dict(dma_wait_ms or {}))


def predict_iter_ms(fp: Dict[str, Any], k: int, model: CostModel, *,
                    kernel: str = "xla",
                    feature_dtype: Optional[str] = None,
                    ring: Optional[int] = None,
                    schedule: Optional[List[Dict[str, Any]]] = None,
                    kernel_opts: Optional[Dict[str, Any]] = None
                    ) -> float:
    """Predicted fold-iteration ms for one (structure, k) point: the
    sum of the per-tier family predictions over the static counters.
    Under "pallas" a tier at the shallow load depth (``ring=1``, the
    reference's name, or a uniform or scheduled ``batch`` of
    :data:`SHALLOW_BATCH` below the carriage's default) is priced at its
    deep family, unless the model fitted the shallow one, plus the
    fitted wait of that family (the family key, then the key without
    its ``@`` suffix): the load overlap the deep batch buys."""
    tiers = tier_counters(fp, k, kernel=kernel,
                          feature_dtype=feature_dtype,
                          schedule=schedule, kernel_opts=kernel_opts)
    if kernel != "pallas":
        return model.predict_tiers(tiers)
    total = 0.0
    for t in tiers:
        family = t["family"]
        shallow = (ring == 1 or t.get("ring") == 1
                   or SHALLOW_BATCH == t["batch"] < t["deep_batch"])
        if shallow and family not in model.coeffs:
            family = k1_family(t["slot_width"], t["deep_batch"])
        total += model.predict_point(family, t["nnz"], t["rows"],
                                     t["streamed_bytes"])
        if shallow and t["slot_width"] > 0:
            wait = model.dma_wait_ms.get(family)
            if wait is None:
                wait = model.dma_wait_ms.get(family.split("@", 1)[0], 0.0)
            total += float(wait)
    return total


def predict_candidate_ms(model: CostModel, fp: Dict[str, Any], k: int,
                         build: Dict[str, Any],
                         kernel_opts: Optional[Dict[str, Any]] = None
                         ) -> float:
    """Price one candidate from its build / kernel_opts dicts (the
    ``tune/space.py`` lens screen): ``kernel="pallas_sell"`` candidates
    as "pallas" (K1 with its knobs)."""
    kernel = ("pallas" if build.get("kernel") == "pallas_sell"
              else "xla")
    opts = kernel_opts or {}
    fd = build.get("feature_dtype") or opts.get("feature_dtype")
    uniform = {kk: v for kk, v in opts.items()
               if kk not in ("schedule", "feature_dtype")}
    return predict_iter_ms(fp, k, model, kernel=kernel,
                           feature_dtype=fd, ring=opts.get("ring"),
                           schedule=opts.get("schedule"),
                           kernel_opts=uniform if kernel == "pallas"
                           else None)

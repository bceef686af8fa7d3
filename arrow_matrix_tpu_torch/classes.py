"""Tolerance-certified traffic classes.

The port's copy of ``arrow_matrix_tpu/classes.py``.  Two
declared classes:

* ``exact`` — f32 carriage, the default: every caller that says nothing
  gets it.
* ``approx`` — reduced-precision carriage (bf16; int8 only on explicit
  opt-in) with f32 sums, servable for a structure only under a
  **certificate**: a measured error-versus-iteration curve whose
  relative Frobenius error at the request's iteration count is within
  the class tolerance of the f32 result.

A :class:`Certificate` is derived from a curve record
(:func:`certificate_from_record`), found in a ledger store by structure
hash (:func:`find_certificate`), or passed explicitly; no certificate
(or a curve shorter than the request) means the request is served
``exact``, loudly.

Admission prices carriage at the class itemsize (f32 4, bf16 2, int8
1), so approx requests reserve their true, smaller bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

EXACT = "exact"
APPROX = "approx"

TRAFFIC_CLASSES = (EXACT, APPROX)

#: Carriage bytes per element by declared dtype (None = f32).
DTYPE_ITEMSIZE = {None: 4, "f32": 4, "bf16": 2, "int8": 1}

#: Class tolerance: the relative Frobenius bound (against the f32
#: result at the same iteration) a curve must stay within to certify
#: the class; the JAX package's values.  int8 error compounds per step,
#: so its opt-in tolerance is loose: the curve, not the constant, is the
#: contract a request is admitted against.
BF16_TOLERANCE = 2e-2
INT8_TOLERANCE = 2.5e-1


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One declared accuracy class: the carriage dtype it serves at
    and the error bound a certificate must prove."""

    name: str
    feature_dtype: Optional[str]    # None = f32 carriage
    itemsize: int                   # carriage bytes per element
    tolerance: float                # rel-Frobenius bound vs f32 golden

    @property
    def needs_certificate(self) -> bool:
        return self.feature_dtype is not None


EXACT_CLASS = TrafficClass(EXACT, None, 4, 0.0)
APPROX_BF16 = TrafficClass(APPROX, "bf16", 2, BF16_TOLERANCE)
APPROX_INT8 = TrafficClass(APPROX, "int8", 1, INT8_TOLERANCE)


def resolve_class(name: str, *, int8: bool = False) -> TrafficClass:
    """The :class:`TrafficClass` for a request's declared class name.
    ``approx`` serves bf16 unless the caller explicitly opted into
    int8 carriage (never a default — its error compounds)."""
    if name == EXACT:
        return EXACT_CLASS
    if name == APPROX:
        return APPROX_INT8 if int8 else APPROX_BF16
    raise ValueError(f"unknown traffic class {name!r} "
                     f"(expected one of {TRAFFIC_CLASSES})")


def class_itemsize(dtype: Optional[str]) -> int:
    """Carriage bytes per element for a declared feature dtype — the
    admission price multiplier (obs/memview.request_bytes_for)."""
    try:
        return DTYPE_ITEMSIZE[dtype]
    except KeyError:
        raise ValueError(f"no class itemsize for dtype {dtype!r} "
                         f"(expected one of "
                         f"{sorted(k for k in DTYPE_ITEMSIZE if k)})"
                         ) from None


def tolerance_for(dtype: Optional[str]) -> float:
    """Declared class tolerance by carriage dtype (0.0 = exact)."""
    if dtype in (None, "f32"):
        return 0.0
    if dtype == "bf16":
        return BF16_TOLERANCE
    if dtype == "int8":
        return INT8_TOLERANCE
    raise ValueError(f"no tolerance for dtype {dtype!r}")


@dataclasses.dataclass(frozen=True)
class Certificate:
    """A measured accuracy certificate for one (structure, dtype):
    the ledger error curve plus the tolerance it certifies.

    ``rel_frobenius[i]`` is the measured relative Frobenius error vs
    the f32 fold golden after iteration ``i+1`` — so a request of
    ``iterations <= len(rel_frobenius)`` is covered iff every point of
    its prefix stays within ``tolerance``.  Requests deeper than the
    curve are NOT covered (no extrapolation: the bound is measured,
    not modeled).
    """

    structure_hash: str
    dtype: str
    rel_frobenius: Tuple[float, ...]
    tolerance: float
    record_id: Optional[str] = None
    emulated: bool = False
    seed: Optional[int] = None

    @property
    def iterations(self) -> int:
        return len(self.rel_frobenius)

    def bound_at(self, iterations: int) -> Optional[float]:
        """The certified (max-over-prefix) error bound at a request's
        iteration count, or None when the curve is too short."""
        if iterations < 1 or iterations > self.iterations:
            return None
        return max(self.rel_frobenius[:iterations])

    def covers(self, iterations: int) -> bool:
        b = self.bound_at(iterations)
        return b is not None and b <= self.tolerance

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rel_frobenius"] = list(self.rel_frobenius)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Certificate":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["rel_frobenius"] = tuple(
            float(p) for p in kw.get("rel_frobenius", ()))
        return cls(**kw)


def certificate_from_record(rec: Dict[str, Any],
                            tolerance: Optional[float] = None
                            ) -> Optional[Certificate]:
    """Derive a :class:`Certificate` from one ledger ``error_curve``
    record (``ledger/probe.py`` schema); None when the record carries
    no usable curve."""
    if rec.get("kind") != "error_curve":
        return None
    curve = (rec.get("payload") or {}).get("rel_frobenius")
    if not isinstance(curve, list) or not curve:
        return None
    knobs = rec.get("knobs") or {}
    dtype = knobs.get("dtype")
    if dtype in (None, "f32"):
        return None   # the golden curve certifies nothing
    return Certificate(
        structure_hash=str(rec.get("structure_hash")),
        dtype=str(dtype),
        rel_frobenius=tuple(float(p) for p in curve),
        tolerance=(tolerance_for(dtype) if tolerance is None
                   else float(tolerance)),
        record_id=rec.get("record_id"),
        emulated=bool(knobs.get("emulated", False)),
        seed=knobs.get("seed"))


def find_certificate(structure_hash: str, dtype: str, *,
                     ledger_dir: Optional[str] = None,
                     records: Optional[Sequence[Dict[str, Any]]] = None,
                     tolerance: Optional[float] = None,
                     allow_emulated: bool = False
                     ) -> Optional[Certificate]:
    """The NEWEST usable certificate for ``(structure_hash, dtype)``
    from the ledger in ``ledger_dir`` (the port's default store when
    None), or from an explicit record list.  Emulated curves (the
    pre-real-int8 quantize-dequantize probe) are rejected unless
    explicitly allowed: a certificate must describe the carriage the
    executor actually serves."""
    if records is None:
        from arrow_matrix_tpu_torch.ledger.store import Ledger

        try:
            records = Ledger(ledger_dir).read_all()
        except OSError:
            return None
    best: Optional[Certificate] = None
    for rec in records:
        if rec.get("kind") != "error_curve":
            continue
        if rec.get("structure_hash") != structure_hash:
            continue
        if (rec.get("knobs") or {}).get("dtype") != dtype:
            continue
        cert = certificate_from_record(rec, tolerance)
        if cert is None:
            continue
        if cert.emulated and not allow_emulated:
            continue
        best = cert   # read_all is append-ordered: last wins = newest
    return best


def certified_classes(structure_hash: str, *,
                      ledger_dir: Optional[str] = None,
                      records: Optional[Sequence[Dict[str, Any]]] = None
                      ) -> List[Certificate]:
    """Every usable certificate the ledger (or the records) holds for
    one structure: the serving layer's startup view of what ``approx``
    can serve."""
    out = []
    for dtype in ("bf16", "int8"):
        c = find_certificate(structure_hash, dtype,
                             ledger_dir=ledger_dir, records=records)
        if c is not None:
            out.append(c)
    return out

"""Collective contracts: what each distributed executor promises about
its step's collectives.

The port's copy of ``arrow_matrix_tpu/analysis/contracts.py`` (a plain
frozen value; nothing of it depends on a compiler).  Every mesh
executor of the port exports one (``collective_contract(k)``): the
collective kinds a step may issue, the ideal per-step exchange bytes
(``ideal_comm_bytes``, already divided by the 2.5D replication factor
c) and the measured/ideal band, the replication factor, the overlap
slab count, the priced merge bytes (``reduce_comm_bytes``) and the
carried dtype.  In the port the measured side is counted by the
collective layer (``utils/commstats.py``) instead of being read from
HLO text; the field names keep the reference's ``lowered_kinds`` and
``compiled_kinds`` (both list the kinds the port's step issues).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CollectiveContract:
    """One executor's static communication promise at feature width k."""

    algorithm: str
    #: Ideal per-step exchange bytes (paper cost model; already ÷c).
    step_bytes: int
    #: Once-per-gather 2.5D psum merge bytes (0 when repl == 1).
    reduce_bytes: int
    #: 2.5D replication factor c.
    repl: int
    #: Overlap schedule slab count S (each collective carries k/(c·S)).
    overlap_slabs: int
    #: Carried feature dtype short name ("f32", "bf16", ...).
    dtype: str
    #: Collective kinds the LOWERED (pre-partitioning) step may contain.
    lowered_kinds: Tuple[str, ...]
    #: Collective kinds the COMPILED (post-GSPMD) step may contain.
    compiled_kinds: Tuple[str, ...]
    #: Accepted measured/ideal byte ratio (lo, hi) for H2.
    ratio_band: Tuple[float, float]
    #: Flat HLO parameter numbers the donated entry point must alias
    #: (empty = the executor ships no donated entry point; H5 skips).
    donated_params: Tuple[int, ...] = ()
    #: While-body copies tolerated in the hot loop (XLA's loop copy
    #: insertion is benign up to this; transposes are never allowed).
    hot_copy_budget: int = 8
    #: Non-empty exempts H3 with this rationale (e.g. 1.5D replication
    #: reduces broadcast rounds instead of slab width).
    h3_exempt: str = ""
    #: graft-reshard: declared per-device per-stage send+recv scratch
    #: ceiling for a staged exchange (0 = not a staged program; H7
    #: skips).
    scratch_budget_bytes: int = 0
    #: Free-text pricing notes surfaced in the manifest.
    notes: str = ""

    def __post_init__(self):
        if self.repl < 1:
            raise ValueError(f"repl must be >= 1, got {self.repl}")
        if self.overlap_slabs < 1:
            raise ValueError(
                f"overlap_slabs must be >= 1, got {self.overlap_slabs}")
        lo, hi = self.ratio_band
        if not (0 <= lo <= hi):
            raise ValueError(f"ratio_band must be 0 <= lo <= hi, "
                             f"got {self.ratio_band}")
        if self.step_bytes < 0 or self.reduce_bytes < 0 \
                or self.scratch_budget_bytes < 0:
            raise ValueError("byte counts must be non-negative")

    def expected_slab(self, k: int) -> int:
        """Leading feature dimension every collective in the lowered
        step must carry: the k/(c·S) slab of the 2.5D + overlap
        schedule (the statically-visible form of the ÷c law)."""
        return k // self.repl // self.overlap_slabs

    def inter_host_bytes(self, num_hosts: int, num_devices: int,
                         pattern: str = "ring") -> int:
        """The slice of ``step_bytes`` that crosses a host boundary
        when the global device axis is split into ``num_hosts``
        contiguous blocks (graft-host fault domains).

        Arrow-matrix exchange is neighbor traffic: under ``"ring"``,
        each device sends one hop along the axis, so exactly the
        ``num_hosts`` block-edge hops (of ``num_devices`` total)
        leave their host — the inter-host fraction is ``hosts /
        devices``.  Under ``"alltoall"`` every device pairs with all
        ``num_devices - 1`` others, of which ``num_devices /
        num_hosts - 1`` share its host, so the fraction is
        ``1 - (d/h - 1)/(d - 1)``.  This is a METHOD, not a field:
        host topology is a deployment property, and keeping it out of
        the dataclass keeps ``to_json`` / the checked-in HLO manifest
        byte-stable across host counts."""
        if num_hosts < 1 or num_devices < 1:
            raise ValueError("num_hosts and num_devices must be >= 1")
        if num_devices % num_hosts != 0:
            raise ValueError(
                f"num_devices ({num_devices}) must split evenly over "
                f"num_hosts ({num_hosts})")
        if num_hosts == 1 or num_devices == 1:
            return 0
        if pattern == "ring":
            frac = num_hosts / num_devices
        elif pattern == "alltoall":
            per_host = num_devices // num_hosts
            frac = 1.0 - (per_host - 1) / (num_devices - 1)
        else:
            raise ValueError(f"unknown pattern {pattern!r} "
                             f"(want 'ring' or 'alltoall')")
        return int(round(self.step_bytes * frac))

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["lowered_kinds"] = sorted(self.lowered_kinds)
        rec["compiled_kinds"] = sorted(self.compiled_kinds)
        rec["ratio_band"] = list(self.ratio_band)
        rec["donated_params"] = list(self.donated_params)
        return rec

"""Structure fingerprints and the levels sources the tuning layers use.

The port's part of ``arrow_matrix_tpu/tune``: the structure fingerprint
and its hash (``tune/fingerprint.py``), which key every lens profile,
error curve and certificate, and ``load_levels_from_source``
(``tune/search.py``).  The search, the plan cache, the candidate space
and the schedule synthesis come with ROADMAP.md Queue A, 'Proof and
tuning layers'.
"""

from arrow_matrix_tpu_torch.tune.fingerprint import (
    FINGERPRINT_VERSION,
    fingerprint_hash,
    folded_degrees,
    folded_total_rows,
    structure_fingerprint,
    structure_hash,
)
from arrow_matrix_tpu_torch.tune.search import load_levels_from_source

__all__ = [
    "FINGERPRINT_VERSION",
    "fingerprint_hash",
    "folded_degrees",
    "folded_total_rows",
    "load_levels_from_source",
    "structure_fingerprint",
    "structure_hash",
]

"""graft-tune on the card: structure-specialized K1 tuning with a plan
cache.

The port's copy of ``arrow_matrix_tpu/tune``.  **Search**: fingerprint
the decomposition's structure and race the pruned candidates (the
fold's structural variants and K1's launch knobs, ``tune/space.py``;
synthesized per-tier schedules, ``tune/synth.py``) in subprocesses on
the card.  **Cache**: persist the winner as a versioned
:class:`TunePlan` keyed by the structure hash, in the port's own
directory (``tune/plan.py``).  **Consume**: ``MultiLevelArrow(plan=
"auto")`` and ``ArrowServer(tune_plan=)`` apply it at no search cost,
loudly on a miss.  **Degrade**: the serving ladder steps the tuned
kernel down to ``"xla"``.
"""

from arrow_matrix_tpu_torch.tune.fingerprint import (
    FINGERPRINT_VERSION,
    fingerprint_hash,
    folded_degrees,
    folded_total_rows,
    structure_fingerprint,
    structure_hash,
)
from arrow_matrix_tpu_torch.tune.plan import (
    PLAN_VERSION,
    TunePlan,
    TunePlanMiss,
    load_plan,
    plan_dir,
    plan_path,
    resolve_plan,
    save_plans,
)
from arrow_matrix_tpu_torch.tune.search import (
    load_levels_from_source,
    search,
    smoke_tune,
)
from arrow_matrix_tpu_torch.tune.space import (
    Candidate,
    enumerate_candidates,
)

__all__ = [
    "FINGERPRINT_VERSION",
    "PLAN_VERSION",
    "Candidate",
    "TunePlan",
    "TunePlanMiss",
    "enumerate_candidates",
    "fingerprint_hash",
    "folded_degrees",
    "folded_total_rows",
    "load_levels_from_source",
    "load_plan",
    "plan_dir",
    "plan_path",
    "resolve_plan",
    "save_plans",
    "search",
    "smoke_tune",
    "structure_fingerprint",
    "structure_hash",
]

"""The ledger: the port's append-only, hash-chained record store.

The port's copy of ``arrow_matrix_tpu/ledger``: the store
(``ledger/store.py``: the integrity model, and where the port's store
lives), the drift gate (``ledger/gate.py``), the accuracy probe
(``ledger/probe.py``) and the legacy ``BENCH_r*.json`` bridge
(``ledger/export.py``); ``cli/graft_ledger.py`` is the operator
surface.
"""

from arrow_matrix_tpu_torch.ledger.store import (  # noqa: F401
    DEFAULT_LEDGER_DIR,
    KINDS,
    LEDGER_BASENAME,
    SCHEMA_VERSION,
    Ledger,
    bench_metric,
    canonical_record_id,
    default_ledger,
    device_stamp,
    ledger_dir,
    ledger_path,
    record,
    records_from,
    schema_problems,
)

"""The ledger: the port's append-only, hash-chained record store.

The port's copy of ``arrow_matrix_tpu/ledger`` (the store; the gate,
the export bridge and the accuracy probe are not ported yet).  See
``ledger/store.py`` for the integrity model and where the port's store
lives.
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

"""Drift gate over the port's ledger store (a wrapper of
``arrow_matrix_tpu_torch/ledger/gate.py``).

Exits nonzero on a perf regression (median + MAD band, host-load
normalized), an accuracy-curve regression, a lens miscalibration or
schema drift (an invalid record, a broken hash chain).

    python -m arrow_matrix_tpu_torch.tools.ledger_gate [--check]
        [--rebaseline] [--ledger-dir DIR] [--baseline FILE]
"""

from __future__ import annotations

import sys

from arrow_matrix_tpu_torch.ledger.gate import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

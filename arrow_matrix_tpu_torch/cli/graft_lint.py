"""``graft_lint_torch`` — the analysis CLI as a console entry point.

Thin wrapper exposing ``arrow_matrix_tpu_torch.analysis`` beside
``amt_doctor_torch``: lints the installed package (or explicit paths)
with R1-R9 and serves the audit, prove, sync and kernels subcommands.
"""

from __future__ import annotations

from arrow_matrix_tpu_torch.analysis.__main__ import main

if __name__ == "__main__":
    raise SystemExit(main())

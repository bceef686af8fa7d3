"""Static and dynamic checks of the port: graft-lint, the second-call
audit, graft-prove, graft-sync and graft-kcert.

The port's part of ``arrow_matrix_tpu/analysis``, five engines with the
reference's rule ids:

* **AST pass** (``core`` + ``rules``): R1-R9 over the package source,
  restated for torch where a rule named JAX tracing (a hot scope is a
  function captured into a CUDA graph, compiled, or passed as a step).
* **Second-call audit** (``audit``): each core SpMM entry point's second
  same-shape call loads, builds and keeps nothing and launches what the
  first did (``analysis/compile_manifest.json``).
* **Collective prover** (``prove`` + ``contracts``): H1-H7 over each
  mesh executor's counted collectives and dispatched ops on gloo ranks
  (``analysis/collective_manifest.json``).
* **Lock-discipline analyzer** (``sync``): RC1-RC5 over the port's
  ``@guarded_by`` contracts (``analysis/sync_manifest.json``).
* **Hopper kernel certifier** (``kernels``): KC1-KC5 over each kernel's
  contract (``analysis/kernel_manifest.json``).

Run ``python -m arrow_matrix_tpu_torch.analysis [lint|audit|prove|sync|
kernels]``; ``graft_lint_torch``, ``graft_prove_torch``,
``graft_sync_torch`` and ``graft_kcert_torch`` are the console scripts
(``tools/lint_gate.py``, ``proof_gate.py`` and ``sync_gate.py`` of this
package the CI wrappers).
"""

from arrow_matrix_tpu_torch.analysis.contracts import CollectiveContract
from arrow_matrix_tpu_torch.analysis.core import (
    Finding,
    lint_file,
    lint_paths,
    lint_source,
    rule_table,
)
from arrow_matrix_tpu_torch.analysis.kernels import (
    RULE_IDS,
    certify_all,
    certify_candidate_opts,
    certify_entry,
    check_meta,
    manifest_drift,
    run_kernels,
    selftest,
)

__all__ = [
    "CollectiveContract",
    "Finding",
    "RULE_IDS",
    "certify_all",
    "certify_candidate_opts",
    "certify_entry",
    "check_meta",
    "lint_file",
    "lint_paths",
    "lint_source",
    "manifest_drift",
    "rule_table",
    "run_kernels",
    "selftest",
]

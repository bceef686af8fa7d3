"""Static checks of the port's hand-written kernels.

The port's part of ``arrow_matrix_tpu/analysis``: the Hopper kernel
certifier (``kernels.py``, rules KC1-KC5 over each kernel's contract
``ops/kernel_contract.py`` and its launch metas), run as ``python -m
arrow_matrix_tpu_torch.analysis kernels``.  The lint rules (R1-R9), the
HLO contract prover and the lock-discipline analyzer are not ported
yet (ROADMAP.md Queue A).
"""

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
    "RULE_IDS",
    "certify_all",
    "certify_candidate_opts",
    "certify_entry",
    "check_meta",
    "manifest_drift",
    "run_kernels",
    "selftest",
]

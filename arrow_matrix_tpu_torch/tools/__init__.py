"""The port's tools: the probes of the gather roofline
(``granule_gather_probe``, ``gather_probe``) and the gates of the JAX
package's root ``tools/`` (``chaos_gate``, ``serve_gate``, ``obs_gate``,
``kernel_gate``, ``fleet_gate``, ``reshard_gate``, ``lens_gate``,
``ledger_gate``, ``lint_gate``, ``proof_gate``, ``sync_gate``,
``tune_gate``) and its ``comm_report``, each run as ``python -m
arrow_matrix_tpu_torch.tools.<name>``."""

"""Kernel gate: certify K1-K4 under KC1-KC5 and fail on any finding or
on drift against the committed ``analysis/kernel_manifest.json``.

The port's counterpart of ``tools/kernel_gate.py``, the wrapper around
``python -m arrow_matrix_tpu_torch.analysis kernels --check``
(``analysis/kernels.py``): every hand-written kernel's declared Hopper
contract and its launch metas at every knob point are proven against
the five rules (indices in bounds, shared memory and register budgets,
the order of every sum, f32 accumulation whatever the carriage, each
output row written once), so a kernel regression fails before a card
runs it.  With ``--device cuda`` (the default) the gate then launches
K1 at every certified knob point on the certifier's operator and holds
each result against its work-list twin (f32 within
``relative_tolerance`` of the mean row length, bf16 within 2e-2 relative
Frobenius error, int8 bit for bit: its integer sums are exact in f32);
on the CPU the wrapper runs the twin itself, so that step is skipped
there.

    python -m arrow_matrix_tpu_torch.tools.kernel_gate [--device cpu]
        certify + drift check
    ... --refresh          certify + rewrite the manifest
    ... --fixture F        a planted kcN_<slug>.json must fire its rule
                           (exits nonzero when it does NOT)
    ... --fixtures         every planted twin of the certifier
                           (``analysis/kernels.planted_metas`` and
                           ``planted_sources``), each written as a
                           fixture file and verified to fire its rule
    ... --paths F...       certify these files; nonzero on ANY finding
    ... --selftest         the certifier trips on its broken twins
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def planted_fixtures(directory: str) -> list:
    """Write every planted twin of the certifier to ``directory`` as a
    ``kcN_<slug>.json`` fixture; returns their paths."""
    from arrow_matrix_tpu_torch.analysis import kernels

    paths = []
    good = kernels._good_k1_meta()
    for rule, meta in sorted(kernels.planted_metas().items()):
        paths.append(_write(directory, f"{rule.lower()}_planted_meta.json",
                            {"metas": [meta]}))
    for rule, src in sorted(kernels.planted_sources().items()):
        paths.append(_write(directory,
                            f"{rule.lower()}_planted_source.json",
                            {"metas": [good], "source": src,
                             "contract": "sell_tier_spmm"}))
    return paths


def _write(directory: str, name: str, doc: dict) -> str:
    path = os.path.join(directory, name)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    return path


def device_witness(device) -> list:
    """Problems of K1 on ``device`` at every certified knob point
    (``ops/cuda_sell.kcert_points``) over the certifier's operator,
    against the work list's twin on the host."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_sell import (
        KCERT_SHAPES,
        kcert_points,
        sell_spmm_cuda,
    )
    from arrow_matrix_tpu_torch.ops.sell import sell_from_arrays
    from arrow_matrix_tpu_torch.utils import (
        relative_error,
        relative_tolerance,
    )

    rng = np.random.default_rng(0)
    n = sum(n_t for _, n_t in KCERT_SHAPES)
    starts = np.cumsum([0] + [n_t for _, n_t in KCERT_SHAPES])[:-1]
    cols = [rng.integers(0, n, s).astype(np.int32) for s in KCERT_SHAPES]
    deg = [rng.integers(0, m_t + 1, n_t).astype(np.int32)
           for m_t, n_t in KCERT_SHAPES]
    host = sell_from_arrays(cols, None, deg, n, list(starts), device="cpu")
    card = sell_from_arrays(cols, None, deg, n, list(starts), device=device)
    tol = {"f32": relative_tolerance(sum(int(d.sum()) for d in deg) / n),
           "bf16": 2e-2}
    problems = []
    for k, carriage, _, opts in kcert_points():
        if carriage == "int8":
            x = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(
                np.int8))
        else:
            x = torch.from_numpy(rng.uniform(-1, 1, (n, k)).astype(
                np.float32))
            if carriage == "bf16":
                x = x.to(torch.bfloat16)
        # On host tensors the wrapper runs the work list's twin.
        want = sell_spmm_cuda(host, x, opts).float()
        got = sell_spmm_cuda(card, x.to(device), opts).float().cpu()
        if carriage == "int8":
            ok, what = torch.equal(got, want), "not bit-equal to"
        else:
            err = relative_error(got.numpy(), want.numpy())
            ok = err <= tol[carriage]
            what = f"relative error {err:.3e} (gate {tol[carriage]:.1e}) from"
        if not ok:
            problems.append(f"K1 at k={k} {carriage} {opts}: {what} its "
                            f"twin")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refresh", action="store_true",
                    help="rewrite analysis/kernel_manifest.json instead "
                         "of drift-checking against it")
    ap.add_argument("--fixture", action="append", default=[],
                    help="verify this planted kcN_<slug>.json fires its "
                         "rule (repeatable)")
    ap.add_argument("--fixtures", action="store_true",
                    help="verify every planted twin of the certifier")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="certify these files and exit nonzero on any "
                         "finding (a planted fixture fails the gate)")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the certifier trips on its broken twins")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: K1 at every knob point on the "
                         "card after the certification) or cpu")
    args = ap.parse_args(argv)

    from arrow_matrix_tpu_torch.analysis import kernels

    if args.selftest:
        return kernels.main(["--selftest"])

    if args.paths:
        findings = kernels.certify_paths(args.paths)
        for f in findings:
            print(f.format())
        if findings:
            print(f"kernel gate: {len(findings)} finding(s) in "
                  f"{len(args.paths)} file(s)", file=sys.stderr)
            return 1
        print("kernel gate: paths certify clean", file=sys.stderr)
        return 0

    fixtures = list(args.fixture)
    with tempfile.TemporaryDirectory(prefix="kernel_gate_") as tmp:
        if args.fixtures:
            fixtures.extend(planted_fixtures(tmp))
        if fixtures:
            rc = kernels.main(
                [arg for p in fixtures for arg in ("--fixture", p)])
            if rc != 0:
                print("kernel gate: FIXTURE FAILED TO TRIP ITS RULE — "
                      "the certifier lost a detection", file=sys.stderr)
            return rc

    rc = kernels.main([] if args.refresh else ["--check"])
    if rc != 0:
        print("kernel gate: FAILED (a KC rule is violated or the "
              "manifest drifted — rerun `python -m arrow_matrix_tpu_torch."
              "analysis kernels` and review the diff)", file=sys.stderr)
        return rc
    from arrow_matrix_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    if device.type != "cuda":
        print("kernel gate: ok (K1 on the card skipped: on the CPU the "
              "wrapper runs its twin)", file=sys.stderr)
        return 0
    problems = device_witness(device)
    for p in problems:
        print(f"kernel gate: {p}", file=sys.stderr)
    if problems:
        print("kernel gate: FAILED on the card", file=sys.stderr)
        return 1
    print("kernel gate: ok (K1 at every certified knob point on "
          f"{device} within its twin's tolerance)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

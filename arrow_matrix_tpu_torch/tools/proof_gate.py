"""CI gate over the port's collective prover (the port's copy of the
repo's ``tools/proof_gate.py``).

Re-runs graft-prove (``analysis/prove.py``) and fails on any violated
collective contract OR on drift against the checked-in
``analysis/collective_manifest.json``: a collective that bypasses the
counted layer, a broken ÷c byte contract, a carriage outliving its
step, or a transposed copy in a step fails before it reaches a bench.

Usage:
    python -m arrow_matrix_tpu_torch.tools.proof_gate [--device cpu]
    python -m arrow_matrix_tpu_torch.tools.proof_gate --refresh --device cpu
    python -m arrow_matrix_tpu_torch.tools.proof_gate --selftest
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refresh", action="store_true",
                    help="rewrite the manifest instead of drift-checking "
                         "against it")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the ranks share the card) or cpu")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the checkers trip on a planted surprise "
                         "all-gather and a collective past the counted "
                         "layer")
    args = ap.parse_args(argv)

    from arrow_matrix_tpu_torch.analysis import prove

    if args.selftest:
        ok = prove.selftest()
        print("proof gate selftest:",
              "ok (broken program trips H1-H3)" if ok else "FAILED")
        return 0 if ok else 1
    cli = ["--device", args.device] + ([] if args.refresh else ["--check"])
    rc = prove.main(cli)
    if rc != 0:
        print("proof gate: FAILED (a collective contract is violated or "
              "the manifest drifted — rerun `python -m "
              "arrow_matrix_tpu_torch.analysis prove --device cpu` and "
              "review the diff)", file=sys.stderr)
        return rc
    print("proof gate: ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

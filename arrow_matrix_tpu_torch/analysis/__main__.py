"""graft-lint CLI of the port.

Usage:
  python -m arrow_matrix_tpu_torch.analysis <paths...>      lint (default)
  python -m arrow_matrix_tpu_torch.analysis lint <paths...> lint, explicitly
  python -m arrow_matrix_tpu_torch.analysis audit           second-call audit
  python -m arrow_matrix_tpu_torch.analysis prove           collective proof
  python -m arrow_matrix_tpu_torch.analysis sync            lock discipline
  python -m arrow_matrix_tpu_torch.analysis kernels         kernel certifier
  python -m arrow_matrix_tpu_torch.analysis --list-rules    rule table

``audit`` and ``prove`` run on the card unless given ``--device cpu``.
Exit status: 0 when no (unwaived) findings, 1 otherwise — the CI gate
contract (``tools/lint_gate.py``).  ``--json`` emits machine-readable
findings; waivers are ``# graft-lint: disable=R1`` inline comments.
"""

from __future__ import annotations

import argparse
import os
import sys

from arrow_matrix_tpu_torch.analysis.core import (
    findings_to_json,
    lint_paths,
    rule_table,
)


def _package_dir() -> str:
    import arrow_matrix_tpu_torch

    return os.path.dirname(os.path.abspath(arrow_matrix_tpu_torch.__file__))


def _print_rules() -> None:
    for spec in rule_table():
        print(f"{spec.rule_id}  {spec.name:<24} {spec.summary}")


def run_lint(paths, select=None, as_json=False, quiet=False) -> int:
    findings, waived = lint_paths(paths, select=select)
    if as_json:
        print(findings_to_json(findings, waived))
    else:
        for f in findings:
            print(f.format())
        if not quiet:
            print(f"graft-lint: {len(findings)} finding(s), "
                  f"{len(waived)} waived, "
                  f"{len(rule_table())} rules", file=sys.stderr)
    return 1 if findings else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "audit":
        from arrow_matrix_tpu_torch.analysis.audit import main as audit_main

        return audit_main(argv[1:])
    if argv and argv[0] == "prove":
        from arrow_matrix_tpu_torch.analysis.prove import main as prove_main

        return prove_main(argv[1:])
    if argv and argv[0] == "sync":
        from arrow_matrix_tpu_torch.analysis.sync import main as sync_main

        return sync_main(argv[1:])
    if argv and argv[0] == "kernels":
        from arrow_matrix_tpu_torch.analysis.kernels import (
            main as kcert_main,
        )

        return kcert_main(argv[1:])
    if argv and argv[0] == "lint":
        argv = argv[1:]

    ap = argparse.ArgumentParser(
        prog="graft_lint_torch", description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "installed arrow_matrix_tpu_torch package)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON findings on stdout")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress the summary line")
    args = ap.parse_args(argv)

    if args.list_rules:
        _print_rules()
        return 0
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    paths = args.paths or [_package_dir()]
    return run_lint(paths, select=select, as_json=args.json,
                    quiet=args.quiet)


def gate(argv=None) -> int:
    """Console entry point for CI (``graft_lint_torch`` script / the
    lint gate): lint the installed package, exit non-zero on findings."""
    return main(argv)


if __name__ == "__main__":
    raise SystemExit(main())

"""CI gate over the port's lock-discipline analyzer (the port's copy of
the repo's ``tools/sync_gate.py``).

Re-runs graft-sync (``analysis/sync.py``) over the port's ``@guarded_by``
contracts and fails on any RC1-RC5 violation OR on drift against the
checked-in ``analysis/sync_manifest.json``.

Usage:
    python -m arrow_matrix_tpu_torch.tools.sync_gate            prove + drift
    python -m arrow_matrix_tpu_torch.tools.sync_gate --refresh  rewrite
    python -m arrow_matrix_tpu_torch.tools.sync_gate --fixtures every
        tests/fixtures/sync/rc*_*.py must fire its rule
    python -m arrow_matrix_tpu_torch.tools.sync_gate --paths F...  any
        finding fails
    python -m arrow_matrix_tpu_torch.tools.sync_gate --selftest
"""

import argparse
import glob
import os
import sys

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "fixtures", "sync")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refresh", action="store_true",
                    help="rewrite the manifest instead of drift-checking "
                         "against it")
    ap.add_argument("--fixture", action="append", default=[],
                    help="verify this planted-violation fixture fires its "
                         "expected rule (repeatable)")
    ap.add_argument("--fixtures", action="store_true",
                    help="verify every tests/fixtures/sync/rc*_*.py")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="analyze these files and exit nonzero on any "
                         "finding")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the analyzer trips on its broken twins")
    args = ap.parse_args(argv)

    from arrow_matrix_tpu_torch.analysis import sync as graft_sync

    if args.selftest:
        return graft_sync.main(["--selftest"])
    if args.paths:
        report = graft_sync.analyze_paths(args.paths)
        for f in report.findings:
            print(f.format())
        if report.findings:
            print(f"sync gate: {len(report.findings)} finding(s) in "
                  f"{len(args.paths)} file(s)", file=sys.stderr)
            return 1
        print("sync gate: paths clean", file=sys.stderr)
        return 0
    fixtures = list(args.fixture)
    if args.fixtures:
        fixtures.extend(sorted(glob.glob(
            os.path.join(FIXTURE_DIR, "rc*_*.py"))))
    if fixtures:
        rc = graft_sync.main(
            [arg for p in fixtures for arg in ("--fixture", p)])
        if rc != 0:
            print("sync gate: FIXTURE FAILED TO TRIP ITS RULE — the "
                  "analyzer lost a detection", file=sys.stderr)
        return rc
    rc = graft_sync.main([] if args.refresh else ["--check"])
    if rc != 0:
        print("sync gate: FAILED (a lock-discipline rule is violated or "
              "the manifest drifted — rerun `python -m "
              "arrow_matrix_tpu_torch.analysis sync` and review the diff)",
              file=sys.stderr)
        return rc
    print("sync gate: ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

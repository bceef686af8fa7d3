"""CI gate over the port's graft-tune plan cache (the port's copy of
the repo's ``tools/tune_gate.py``).

Replays every cached TunePlan (or the ``--hash`` selection) against
its recorded source and exits nonzero if any plan lost bit-identity
vs the golden default fold, regressed more than ``--rel-tol`` (default
5%) vs the default configuration, fails the hash/version integrity
check, or if a search on the unchanged structure is not a pure cache
hit (zero bench children).  ``--refresh`` re-searches each structure
before checking.

Usage:
    python -m arrow_matrix_tpu_torch.tools.tune_gate            # the cache
    python -m arrow_matrix_tpu_torch.tools.tune_gate --plan-dir DIR --refresh
    python -m arrow_matrix_tpu_torch.tools.tune_gate --hash 0123abcd...
    ... --device cpu        # replay on the host (default: the card)
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan-dir", default=None,
                    help="plan cache directory (default "
                         "bench_results/tune_plans_torch, or "
                         "$AMT_TUNE_PLAN_DIR)")
    ap.add_argument("--hash", action="append", default=None,
                    help="gate only this structure hash (repeatable)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing replays per side; min is compared")
    ap.add_argument("--rel-tol", type=float, default=0.05)
    ap.add_argument("--abs-tol-ms", type=float, default=0.25)
    ap.add_argument("--refresh", action="store_true",
                    help="re-search each structure before gating")
    ap.add_argument("--no-timing", action="store_true",
                    help="skip the regression replay (identity + "
                         "cache checks only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from arrow_matrix_tpu_torch.tune.gate import run_gate

    return run_gate(directory=args.plan_dir, hashes=args.hash,
                    iters=args.iters, repeats=args.repeats,
                    rel_tol=args.rel_tol, abs_tol_ms=args.abs_tol_ms,
                    refresh=args.refresh, timing=not args.no_timing,
                    device=args.device, quiet=args.quiet)


if __name__ == "__main__":
    sys.exit(main())

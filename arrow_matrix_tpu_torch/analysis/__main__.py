"""``python -m arrow_matrix_tpu_torch.analysis kernels [--check |
--selftest | --fixture F | --paths P...]``: the Hopper kernel
certifier (``analysis/kernels.py``).  The reference's other
subcommands (lint, audit, prove, sync) are not ported yet and exit 2
naming ROADMAP.md Queue A."""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["kernels"]:
        from arrow_matrix_tpu_torch.analysis.kernels import main as kmain

        return kmain(argv[1:])
    print("analysis: only the 'kernels' subcommand is ported; lint "
          "(R1-R9), audit, prove and sync are not ported yet (see "
          "ROADMAP.md Queue A, 'Proof and tuning layers')",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())

"""CI gate over the port's graft-lint (the port's copy of the repo's
``tools/lint_gate.py``).

Lints the port's package (or the given paths) with R1-R9 and exits with
graft-lint's status: 0 clean, 1 findings.  ``--audit`` also runs the
second-call audit (``--device``), ``--prove`` the collective prover in
check mode (``--device``), ``--sync`` the lock-discipline proof in check
mode and ``--kernels`` the kernel certifier in check mode.

Usage:
    python -m arrow_matrix_tpu_torch.tools.lint_gate [--audit] [--prove]
        [--sync] [--kernels] [--device cpu] [paths...]
"""

import sys

from arrow_matrix_tpu_torch.analysis.__main__ import main as graft_lint_main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    extra = []
    for flag in ("--audit", "--prove", "--sync", "--kernels"):
        if flag in argv:
            argv.remove(flag)
            extra.append(flag)
    rc = graft_lint_main(argv)
    if rc != 0:
        print("lint gate: FAILED (fix the findings or waive them with "
              "`# graft-lint: disable=<rule>` and a reason)",
              file=sys.stderr)
        return rc
    steps = {"--audit": (["audit", "--device", device, "--check"],
                         "second-call audit"),
             "--prove": (["prove", "--device", device, "--check"],
                         "collective proof"),
             "--sync": (["sync", "--check"], "lock-discipline proof"),
             "--kernels": (["kernels", "--check"], "kernel certification")}
    for flag in extra:
        cli, what = steps[flag]
        rc = graft_lint_main(cli)
        if rc != 0:
            print(f"lint gate: {what} FAILED", file=sys.stderr)
            return rc
    print("lint gate: ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

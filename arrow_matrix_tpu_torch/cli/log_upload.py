"""``log_upload`` — deferred upload of offline benchmark logs.

The port's copy of ``arrow_matrix_tpu/cli/log_upload.py``, run as
``log_upload_torch`` or ``python -m
arrow_matrix_tpu_torch.cli.log_upload``: scan a log directory for the
runs the benchmark CLIs wrote (``--logdir``), stream each to wandb and
mark it with a ``.logged`` indicator file
(``utils/logging.log_local_runs``).  Without wandb installed it lists
the pending runs (the files remain the record).  Both packages write
the same file form, so each one's ``log_upload`` lists the other's
runs.  It runs on the host only.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Upload offline run logs to W&B.")
    parser.add_argument("-f", "--path", type=str, default="./logs",
                        help="Directory containing run logs.")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.path):
        raise SystemExit(f"{args.path} is not a directory")

    from arrow_matrix_tpu_torch.utils.logging import log_local_runs

    handled = log_local_runs(args.path)
    print(f"{len(handled)} run(s) handled")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

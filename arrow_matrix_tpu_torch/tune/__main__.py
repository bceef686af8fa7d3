"""``python -m arrow_matrix_tpu_torch.tune``: the candidate child
(``--candidate <name>``, its configuration in the ``AMT_TUNE_CFG``
environment JSON, its result as the last line of standard output), and
otherwise the ``graft_tune`` CLI."""

from __future__ import annotations

import json
import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--candidate"]:
        from arrow_matrix_tpu_torch.tune.search import candidate_child_main

        cfg = json.loads(os.environ["AMT_TUNE_CFG"])
        try:
            out = candidate_child_main(cfg)
        except Exception as e:  # noqa: BLE001 -- one line, parent parses
            out = {"name": cfg.get("candidate", {}).get("name"),
                   "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(out), flush=True)
        return 0 if out.get("error") is None else 1
    from arrow_matrix_tpu_torch.cli.graft_tune import main as cli_main

    return cli_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())

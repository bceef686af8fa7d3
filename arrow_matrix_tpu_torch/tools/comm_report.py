"""Per-iteration communication-volume report of the mesh executors.

The port's counterpart of ``tools/comm_report.py``.  Communication
volume is the paper's headline metric.  The JAX report reads the
compiled HLO's collectives back out; the port issues every collective
itself through one counted layer (``parallel/collectives.py``), so the
report runs one step of each execution mode on ``n_dev`` ranks and
reads the counted bytes by kind (``utils/commstats.py``), beside each
executor's own model (``ideal_comm_bytes``) and the inter-level
routing's O(moved rows) bound (``commstats.ideal_routing_bytes``):

* time-shared, ``routing="gather"`` and ``routing="a2a"``
  (``MultiLevelArrow(mesh=)``);
* space-shared (``SpaceSharedArrow``; when ``n_dev`` is a multiple of
  the level count);
* ``sell/gather`` and ``sell/a2a`` (``SellMultiLevel``);
* ``sell/space-shared`` (``SellSpaceShared``; as space-shared).

The ranks are gloo processes on the card (``--device cuda``, the
default; they share it) or on the CPU (``--device cpu``).  Each mode's
block prints rank 0's counts and the sum over the ranks; the last line
is one JSON object ``{mode: {"ranks": [per-rank counts], "ideal":
bytes or null}, "ideal_routing": bytes}``.

    python -m arrow_matrix_tpu_torch.tools.comm_report [n] [width] [k]
        [n_dev] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict

MODES = ("time-shared/gather", "time-shared/a2a", "space-shared",
         "sell/gather", "sell/a2a", "sell/space-shared")


def build_levels(n: int, width: int):
    """The report's decomposition: BA(n, 4, seed 7) in at most 4
    levels (the JAX report's)."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    a = barabasi_albert(n, 4, seed=7)
    return arrow_decomposition(a, arrow_width=width, max_levels=4,
                               block_diagonal=True, seed=7)


def build_mode(mode: str, levels, width: int, n_dev: int):
    """The executor of ``mode`` on a mesh of the ``n_dev`` ranks."""
    from arrow_matrix_tpu_torch.parallel import (
        MultiLevelArrow,
        SellSpaceShared,
        SpaceSharedArrow,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel

    family, _, routing = mode.partition("/")
    if mode.endswith("space-shared"):
        mesh = make_mesh((len(levels), n_dev // len(levels)),
                         ("lvl", "blocks"))
        return (SellSpaceShared(levels, width, mesh) if family == "sell"
                else SpaceSharedArrow(levels, width, mesh))
    mesh = make_mesh((n_dev,), ("blocks",))
    if family == "sell":
        return SellMultiLevel(levels, width, mesh, routing=routing)
    return MultiLevelArrow(levels, width, mesh=mesh, routing=routing)


def modes_for(n_levels: int, n_dev: int) -> tuple:
    """The modes that run on ``n_dev`` ranks: the space-shared ones
    need a multiple of the level count."""
    return tuple(m for m in MODES
                 if not m.endswith("space-shared") or n_dev % n_levels == 0)


def report_rank(ctx, n: int, width: int, k: int) -> Dict[str, Any]:
    """One rank's counts: each mode's step once, after a warm-up step,
    with the counts set to 0 (``commstats.collective_stats``)."""
    from arrow_matrix_tpu_torch.utils import commstats, random_dense

    levels = build_levels(n, width)
    x_host = random_dense(n, k, seed=1)
    out: Dict[str, Any] = {"n_levels": len(levels)}
    for mode in modes_for(len(levels), ctx.world):
        exe = build_mode(mode, levels, width, ctx.world)
        x = exe.set_features(x_host)
        exe.step(x)
        stats = commstats.collective_stats(exe.step, x)
        ideal = getattr(exe, "ideal_comm_bytes", None)
        out[mode] = {"stats": stats,
                     "ideal": None if ideal is None else int(ideal(k))}
        del exe, x
    return out


def ideal_routing(levels, n_dev: int, k: int) -> int:
    """The routing bound over the levels' permutations padded to the
    executors' shared row count."""
    import numpy as np

    from arrow_matrix_tpu_torch.io import number_of_blocks
    from arrow_matrix_tpu_torch.parallel.multi_level import (
        pad_permutation,
        pad_to_multiple,
    )
    from arrow_matrix_tpu_torch.utils import commstats

    widths = [lvl.arrow_width for lvl in levels]
    total = pad_to_multiple(
        max(number_of_blocks(lvl.matrix, w) * w
            for lvl, w in zip(levels, widths)), max(widths))
    perms = [pad_permutation(np.asarray(lvl.permutation), total)
             for lvl in levels]
    return commstats.ideal_routing_bytes(perms, n_dev, k)


def run_report(n: int, width: int, k: int, n_dev: int,
               device=None) -> Dict[str, Any]:
    """Every mode on ``n_dev`` gloo ranks; the report document."""
    from arrow_matrix_tpu_torch.parallel.launch import spawn

    per_rank = spawn(report_rank, n_dev, (n, width, k), backend="gloo",
                     device=device, threads=1)
    doc: Dict[str, Any] = {}
    for mode in MODES:
        if mode in per_rank[0]:
            doc[mode] = {"ranks": [r[mode]["stats"] for r in per_rank],
                         "ideal": per_rank[0][mode]["ideal"]}
    doc["ideal_routing"] = ideal_routing(build_levels(n, width), n_dev, k)
    doc["n_levels"] = per_rank[0]["n_levels"]
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=4096)
    p.add_argument("width", nargs="?", type=int, default=128)
    p.add_argument("k", nargs="?", type=int, default=16)
    p.add_argument("n_dev", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: gloo ranks sharing the card) or "
                        "cpu")
    args = p.parse_args(argv)

    from arrow_matrix_tpu_torch.utils import commstats

    doc = run_report(args.n, args.width, args.k, args.n_dev, args.device)
    print(f"n={args.n} width={args.width} k={args.k} "
          f"ranks={args.n_dev} levels={doc['n_levels']} "
          f"device={args.device}\n")
    for mode in MODES:
        if mode not in doc:
            print(f"== {mode}: skipped ({args.n_dev} ranks are not a "
                  f"multiple of {doc['n_levels']} levels)\n")
            continue
        ranks = doc[mode]["ranks"]
        ideal = doc[mode]["ideal"]
        print(f"== {mode} (rank 0)")
        print(commstats.format_stats(ranks[0]))
        print(f"{'all ranks':20s} {'':6s} "
              f"{sum(r['total_bytes'] for r in ranks):14,d}")
        print(f"{'ideal (executor)':20s} {'':6s} "
              f"{'n/a' if ideal is None else f'{ideal:14,d}'}")
        print(f"{'ideal routing':20s} {'':6s} "
              f"{doc['ideal_routing']:14,d}\n")
    print(json.dumps(doc, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The levels sources of the tuning layers.

Only :func:`load_levels_from_source` of ``arrow_matrix_tpu/tune/
search.py`` is ported here: the lens (``cli/graft_lens.py``) and the
accuracy probe (``ledger/probe.py``) name a structure by the same
source dicts as the JAX package.  The search loop itself (candidate
races, plans) comes with ROADMAP.md Queue A, 'Proof and tuning layers'.
"""

from __future__ import annotations

import numpy as np


def load_levels_from_source(source: dict):
    """Rebuild a decomposition from its source.  Two kinds:

    * ``{"kind": "ba", "n", "m", "width", "seed", "max_levels"}`` --
      generate a Barabasi-Albert graph and decompose it (both seeded,
      so every process sees the same structure);
    * ``{"kind": "dir", "base", "width"}`` -- load an ``io/graphio.py``
      artifact saved at level-0 width ``width``.

    Returns ``(levels, width)``.
    """
    kind = source.get("kind")
    if kind == "ba":
        from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
        from arrow_matrix_tpu_torch.utils import barabasi_albert

        a = barabasi_albert(int(source["n"]), int(source.get("m", 3)),
                            seed=int(source["seed"]))
        width = int(source["width"])
        levels = arrow_decomposition(
            a, width, max_levels=int(source.get("max_levels", 10)),
            block_diagonal=True, seed=int(source["seed"]))
        return levels, width
    if kind == "dir":
        from arrow_matrix_tpu_torch.io.graphio import (
            as_levels,
            load_decomposition,
            load_level_widths,
        )

        base = source["base"]
        width = source.get("width")
        loaded = load_decomposition(base, width, block_diagonal=True)
        widths = load_level_widths(base, width, True)
        levels = as_levels(loaded, widths)
        return levels, int(np.max(np.asarray(widths)))
    raise ValueError(f"unknown levels source kind {kind!r}")

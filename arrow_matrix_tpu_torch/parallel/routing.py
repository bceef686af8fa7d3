"""The feature-axis splits of a step.

The port's copies of ``overlap_slices`` and ``repl_slab_width`` from
``arrow_matrix_tpu/parallel/routing.py`` (plain integer arithmetic):
the column-group (``repl``) and sub-slab (``overlap_slabs``) schedule
of ``MultiLevelArrow.step``.  SpMM is separable per feature column, so
a split never regroups a sum.
"""

from __future__ import annotations


def overlap_slices(k: int, overlap_slabs: int) -> list:
    """Bounds ``[(lo, hi), ...]`` of ``overlap_slabs`` equal contiguous
    slabs of ``k`` features; raises ``ValueError`` unless the count
    divides ``k``."""
    s = int(overlap_slabs)
    if s <= 1:
        return [(0, k)]
    if s > k or k % s:
        raise ValueError(
            f"overlap_slabs={s} must divide the feature width k={k} "
            f"(equal static sub-slabs; pick S from the divisors of k)")
    step = k // s
    return [(i * step, (i + 1) * step) for i in range(s)]


def repl_slab_width(k: int, repl: int) -> int:
    """Width ``k / c`` of the column group each of ``repl`` groups owns
    (group j: ``[j k/c, (j + 1) k/c)``); raises ``ValueError`` unless
    ``c`` divides ``k``."""
    c = int(repl)
    if c <= 1:
        return int(k)
    if c > k or k % c:
        raise ValueError(
            f"repl={c} must divide the feature width k={k} "
            f"(each replica group owns an equal static column slab)")
    return k // c

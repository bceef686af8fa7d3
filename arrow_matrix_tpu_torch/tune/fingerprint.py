"""Canonical structure fingerprint and hash.

The port's copy of ``arrow_matrix_tpu/tune/fingerprint.py``.  A
deterministic record of a decomposition's *structure* -- per-level
rows, nnz and arrow widths, the folded degree ladder at the requested
tier split, the slot histogram and the tier imbalance scalars
(``obs/imbalance.summarize_units``) -- hashed to a short hex key.  It is
derived from the levels on the host with numpy alone: no executor is
built and no device is touched.

The hash equals the JAX package's byte for byte for the same levels
(``tests/test_torch_fingerprint.py``): lens profiles, error curves and
the certificates ``classes.find_certificate`` looks up are keyed by it,
and the ledger joins the two packages' records on it.  The fingerprint
holds plain ints, floats and strings; ratio fields are rounded to 6
places so numpy noise cannot split a hash.

It does not include the feature width ``k``: the operator is
k-independent.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

import numpy as np
import torch
from scipy import sparse

#: Bump when the fingerprint schema changes (equal to the JAX package's).
FINGERPRINT_VERSION = 1

#: numpy's name of each block dtype, as the JAX package records it.
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _per_level_degrees(matrix) -> np.ndarray:
    """Per-row nnz of one level matrix (CSR or CsrLike triplet)."""
    if isinstance(matrix, sparse.csr_matrix):
        indptr = matrix.indptr
    else:
        indptr = matrix[2]
    return np.diff(np.asarray(indptr, dtype=np.int64))


def folded_total_rows(levels, width: int) -> int:
    """The shared flat row count of the one-device build, derived as
    ``MultiLevelArrow.__init__`` derives it, so the ladder is computed
    over exactly the rows the executor packs."""
    from arrow_matrix_tpu_torch.io.graphio import number_of_blocks
    from arrow_matrix_tpu_torch.parallel.multi_level import pad_to_multiple

    widths = []
    for i, lvl in enumerate(levels):
        is_last = i == len(levels) - 1
        if lvl.arrow_width > width or is_last:
            widths.append(-(-lvl.arrow_width // width) * width)
        else:
            widths.append(width)
    unit = max(widths)
    max_rows = max(number_of_blocks(lvl.matrix, w) * w
                   for lvl, w in zip(levels, widths))
    return pad_to_multiple(max_rows, unit)


def folded_degrees(levels, total: int) -> np.ndarray:
    """Per-row nnz of the folded operator in level-0 order: each level's
    row degrees routed through the fold's coordinate map
    ``inv_perm0[pad_permutation(perm)]`` and summed (the levels are
    edge-disjoint, so the sum is the folded degree)."""
    from arrow_matrix_tpu_torch.parallel.multi_level import pad_permutation

    perms = [pad_permutation(np.asarray(lvl.permutation), total)
             for lvl in levels]
    inv_perm0 = np.argsort(perms[0])
    deg = np.zeros(total, dtype=np.int64)
    for lvl, p in zip(levels, perms):
        mp = inv_perm0[p]
        ld = np.zeros(total, dtype=np.int64)
        d = _per_level_degrees(lvl.matrix)
        ld[:d.size] = d
        deg[mp] += ld
    return deg


def structure_fingerprint(levels, width: int, dtype=np.float32,
                          growth: float = 1.2,
                          slot_align: Optional[int] = None,
                          binary="auto") -> dict:
    """The canonical structure record the hash is taken over: the
    ladder the SELL packer builds (ascending aligned degrees, tiers
    split at ``growth``), the slot histogram, the tier imbalance, the
    levels' shapes."""
    from arrow_matrix_tpu_torch.io.graphio import num_rows
    from arrow_matrix_tpu_torch.obs.imbalance import summarize_units
    from arrow_matrix_tpu_torch.ops.ell import SLOT_ALIGN
    from arrow_matrix_tpu_torch.ops.sell import align_up_vec, tier_boundaries
    from arrow_matrix_tpu_torch.parallel.multi_level import (
        resolve_block_dtype,
        resolve_levels_binary,
    )

    if slot_align is None:
        slot_align = SLOT_ALIGN
    dtype_name = _DTYPE_NAMES[resolve_block_dtype(dtype)]
    total = folded_total_rows(levels, width)
    deg = folded_degrees(levels, total)

    sorted_deg = np.sort(deg, kind="stable")
    aligned = (align_up_vec(sorted_deg, slot_align) if slot_align > 1
               else sorted_deg)
    starts = tier_boundaries(aligned, growth) + [total]
    tier_rows, tier_nnz, tier_slots, tier_width = [], [], [], []
    for lo, hi in zip(starts[:-1], starts[1:]):
        m_t = int(aligned[hi - 1]) if hi > lo else 0
        tier_rows.append(int(hi - lo))
        tier_nnz.append(int(sorted_deg[lo:hi].sum()))
        tier_slots.append(m_t * (hi - lo))
        tier_width.append(m_t)

    # Distinct aligned degrees and their row counts.
    vals, counts = np.unique(aligned, return_counts=True)

    imb = summarize_units(tier_rows, tier_nnz, tier_slots, units="tier")

    def _r(v):
        return None if v is None else round(float(v), 6)

    levels_fp = []
    for lvl in levels:
        d = _per_level_degrees(lvl.matrix)
        levels_fp.append({
            "rows": int(num_rows(lvl.matrix)),
            "nnz": int(d.sum()),
            "arrow_width": int(lvl.arrow_width),
        })

    return {
        "version": FINGERPRINT_VERSION,
        "n": int(num_rows(levels[0].matrix)),
        "total_rows": int(total),
        "width": int(width),
        "dtype": dtype_name,
        "binary": bool(resolve_levels_binary(levels, binary)),
        "growth": round(float(growth), 6),
        "slot_align": int(slot_align),
        "levels": levels_fp,
        "ladder": {
            "tier_starts": [int(s) for s in starts[:-1]],
            "rows": tier_rows,
            "nnz": tier_nnz,
            "slots": tier_slots,
            "slot_width": tier_width,
        },
        "slot_hist": {
            "deg": [int(v) for v in vals],
            "count": [int(c) for c in counts],
        },
        "imbalance": {
            "nnz_max_over_mean": _r(imb["nnz_max_over_mean"]),
            "rows_max_over_mean": _r(imb["rows_max_over_mean"]),
            "padded_slot_waste": _r(imb["padded_slot_waste"]),
        },
    }


def fingerprint_hash(fp: dict) -> str:
    """sha256 over the canonical JSON encoding, first 16 hex digits."""
    blob = json.dumps(fp, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def structure_hash(levels, width: int, dtype=np.float32,
                   growth: float = 1.2,
                   slot_align: Optional[int] = None,
                   binary="auto") -> str:
    """Fingerprint and hash in one call."""
    return fingerprint_hash(structure_fingerprint(
        levels, width, dtype=dtype, growth=growth,
        slot_align=slot_align, binary=binary))

"""The port's structure fingerprint (``arrow_matrix_tpu_torch.tune``)
against the JAX package's: ``structure_fingerprint`` equal field by
field and ``fingerprint_hash`` equal byte for byte, on seeded BA
structures (binary and weighted, several tier splits and block dtypes)
and on the BA 256/3 artifact through a ``"dir"`` source; the folded
degrees and row count equal the fold the executor builds; the tier
imbalance report of the fold equals the fingerprint's ladder."""

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.decomposition import arrow_decomposition as jdecompose
from arrow_matrix_tpu.tune import fingerprint as jfp
from arrow_matrix_tpu.tune.search import (
    load_levels_from_source as jload_levels,
)
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.tune import fingerprint as pfp
from arrow_matrix_tpu_torch.tune import load_levels_from_source
from arrow_matrix_tpu_torch.utils import barabasi_albert

torch.set_num_threads(2)

#: (n, m, width, seed) of the seeded BA structures.
BA = ((256, 3, 32, 0), (500, 4, 32, 1), (1200, 3, 64, 5), (700, 8, 64, 2))
#: (dtype, growth, slot_align) of the fingerprint.
SPLITS = (("f32", 1.2, None), ("bf16", 1.2, None), ("f32", 1.1, 1),
          ("f32", 1.5, 4))


def _levels(n, m, width, seed, weighted=False):
    a = barabasi_albert(n, m, seed=seed)
    if weighted:
        rng = np.random.default_rng(seed)
        a = a.tocsr(copy=True)
        a.data = rng.uniform(0.5, 2.0, a.nnz).astype(np.float32)
    return jdecompose(a, width, max_levels=10, block_diagonal=True,
                      seed=seed)


def _assert_same(levels, width, **kw):
    want = jfp.structure_fingerprint(levels, width, **kw)
    got = pfp.structure_fingerprint(levels, width, **kw)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    assert pfp.fingerprint_hash(got) == jfp.fingerprint_hash(want)
    assert pfp.structure_hash(levels, width, **kw) == \
        jfp.structure_hash(levels, width, **kw)
    return got


@pytest.mark.parametrize("n,m,width,seed", BA)
@pytest.mark.parametrize("dtype,growth,slot_align", SPLITS)
def test_fingerprint_and_hash_equal_jax(n, m, width, seed, dtype, growth,
                                        slot_align):
    _assert_same(_levels(n, m, width, seed), width, dtype=dtype,
                 growth=growth, slot_align=slot_align)


def test_weighted_structure_equals_jax_and_is_not_binary():
    levels = _levels(500, 4, 32, 3, weighted=True)
    fp = _assert_same(levels, 32)
    assert fp["binary"] is False
    binary = _assert_same(_levels(500, 4, 32, 3), 32)
    assert binary["binary"] is True
    assert pfp.fingerprint_hash(fp) != pfp.fingerprint_hash(binary)


def test_dir_source_over_the_ba_256_3_artifact_equals_jax(ba_256_3_base):
    src = {"kind": "dir", "base": ba_256_3_base, "width": 32}
    levels, width = load_levels_from_source(src)
    jlevels, jwidth = jload_levels(src)
    assert width == jwidth == 32
    fp = _assert_same(levels, width)
    assert fp == jfp.structure_fingerprint(jlevels, jwidth)
    # The artifact is the BA source it was saved from.
    ba = {"kind": "ba", "n": 256, "m": 3, "width": 32, "seed": 0,
          "max_levels": 10}
    assert pfp.structure_hash(*load_levels_from_source(ba)) == \
        pfp.fingerprint_hash(fp)


def test_ba_source_equals_jax_and_bad_kind_raises():
    src = {"kind": "ba", "n": 300, "m": 3, "width": 32, "seed": 4,
           "max_levels": 10}
    levels, width = load_levels_from_source(src)
    jlevels, jwidth = jload_levels(src)
    assert width == jwidth
    assert pfp.structure_hash(levels, width) == \
        jfp.structure_hash(jlevels, jwidth)
    with pytest.raises(ValueError, match="unknown levels source"):
        load_levels_from_source({"kind": "nope"})


@pytest.mark.parametrize("growth,slot_align", [(1.2, None), (1.1, 1)])
def test_ladder_is_the_fold_the_executor_builds(growth, slot_align):
    levels = _levels(1200, 3, 64, 5)
    fp = pfp.structure_fingerprint(levels, 64, growth=growth,
                                   slot_align=slot_align)
    exe = MultiLevelArrow(levels, 64, fmt="fold", fold_growth=growth,
                          fold_align=slot_align, device="cpu")
    assert fp["total_rows"] == exe.total_rows == \
        pfp.folded_total_rows(levels, 64)
    deg = pfp.folded_degrees(levels, exe.total_rows)
    assert int(deg.sum()) == exe.nnz
    sell = exe.sell
    assert fp["ladder"]["tier_starts"] == list(sell.row_starts)
    assert fp["ladder"]["slot_width"] == [int(c.shape[0]) for c in sell.cols]
    assert fp["ladder"]["rows"] == [int(c.shape[1]) for c in sell.cols]
    # The executor's own tier report is the fingerprint's ladder.
    rep = exe.shard_report()
    assert rep["units"] == "tier"
    assert rep["nnz"] == fp["ladder"]["nnz"]
    assert rep["slots"] == fp["ladder"]["slots"]
    assert round(rep["padded_slot_waste"], 6) == \
        fp["imbalance"]["padded_slot_waste"]


def test_shard_report_equals_jax_for_the_per_level_formats():
    from arrow_matrix_tpu.parallel.multi_level import (
        MultiLevelArrow as JMultiLevelArrow,
    )

    levels = _levels(600, 3, 32, 6)
    for fmt in ("ell", "hyb", "dense", "fold"):
        ours = MultiLevelArrow(levels, 32, fmt=fmt, device="cpu")
        theirs = JMultiLevelArrow(levels, 32, fmt=fmt)
        assert ours.shard_report() == theirs.shard_report(), fmt

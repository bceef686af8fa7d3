"""The port's own copies of the decomposer and the artifact I/O against
the JAX package: identical levels for one seed, and the same files
written and read in both directions."""

import filecmp
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.decomposition import arrow_decomposition as jax_decompose
from arrow_matrix_tpu.io import as_levels as jax_as_levels
from arrow_matrix_tpu.io import load_decomposition as jax_load
from arrow_matrix_tpu.io import save_decomposition as jax_save
from arrow_matrix_tpu.utils import numerics as jax_numerics
from arrow_matrix_tpu_torch.decomposition import (
    arrow_decomposition,
    decomposition_spmm,
    reconstruct,
)
from arrow_matrix_tpu_torch.io import (
    as_levels,
    load_decomposition,
    load_level_widths,
    save_decomposition,
)
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)


def _same_levels(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.arrow_width == b.arrow_width
        assert np.array_equal(a.permutation, b.permutation)
        for field in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(a.matrix, field),
                                  getattr(b.matrix, field))


@pytest.mark.parametrize("block_diagonal", [True, False])
def test_levels_identical_to_jax_numpy_backend(block_diagonal):
    a = barabasi_albert(512, 3, seed=11)
    ours = arrow_decomposition(a, 32, max_levels=10,
                               block_diagonal=block_diagonal, seed=4)
    theirs = jax_decompose(a, 32, max_levels=10,
                           block_diagonal=block_diagonal, seed=4,
                           backend="numpy")
    _same_levels(ours, theirs)
    assert (reconstruct(ours) != a).nnz == 0


def test_native_backend_runs_and_equals_jax():
    a = barabasi_albert(512, 3, seed=11)
    ours = arrow_decomposition(a, 32, max_levels=10, block_diagonal=True,
                               seed=4, backend="native")
    theirs = jax_decompose(a, 32, max_levels=10, block_diagonal=True,
                           seed=4, backend="native")
    _same_levels(ours, theirs)
    assert (reconstruct(ours) != a).nnz == 0


def test_committed_artifact_loads_in_the_port(ba_256_3_base):
    ours = load_decomposition(ba_256_3_base, 32, block_diagonal=True)
    theirs = jax_load(ba_256_3_base, 32, block_diagonal=True)
    widths = load_level_widths(ba_256_3_base, 32, True)
    ours, theirs = as_levels(ours, widths), jax_as_levels(theirs, widths)
    _same_levels(ours, theirs)
    x = random_dense(256, 8, seed=1)
    a = reconstruct(ours)
    assert relative_error(decomposition_spmm(ours, x), a @ x) <= \
        relative_tolerance(a.nnz / 256)


def test_port_artifact_is_the_jax_artifact(tmp_path):
    a = barabasi_albert(300, 3, seed=2)
    levels = arrow_decomposition(a, 32, max_levels=4, block_diagonal=True,
                                 seed=1)
    save_decomposition(levels, str(tmp_path / "ours" / "g"))
    jax_save(levels, str(tmp_path / "theirs" / "g"))
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "ours", tmp_path / "theirs", names, shallow=False)
    assert not mismatch and not errors
    loaded = jax_as_levels(jax_load(str(tmp_path / "ours" / "g"), 32),
                           load_level_widths(str(tmp_path / "ours" / "g"),
                                             32))
    _same_levels(levels, loaded)


def test_numerics_match_jax():
    for nnz, iters in ((1, 1), (16.0, 1), (16.0, 10), (300.5, 3)):
        assert relative_tolerance(nnz, iters) == \
            jax_numerics.relative_tolerance(nnz, iters)
    x, y = random_dense(20, 3, seed=0), random_dense(20, 3, seed=1)
    assert relative_error(x, y) == jax_numerics.relative_error(x, y)

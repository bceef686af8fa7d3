"""The legacy npz artifact scheme of the port's ``io/graphio.py`` against
the JAX package's: files written by either load in the other with equal
levels, and ``convert_decomposition`` writes the same files."""

import filecmp
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.io import as_levels as jax_as_levels
from arrow_matrix_tpu.io import convert_decomposition as jax_convert
from arrow_matrix_tpu.io import load_decomposition as jax_load
from arrow_matrix_tpu.io import save_decomposition_npz as jax_save_npz
from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.io import (
    as_levels,
    convert_decomposition,
    load_decomposition,
    save_decomposition,
    save_decomposition_npz,
)
from arrow_matrix_tpu_torch.utils import barabasi_albert

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def levels():
    a = barabasi_albert(300, 3, seed=2)
    return arrow_decomposition(a, 32, max_levels=4, block_diagonal=True,
                               seed=1)


def _same_files(ours_dir, theirs_dir):
    """The same file names, ``.npy`` files equal byte for byte and
    ``.npz`` archives equal array for array (a zip entry carries the
    time it was written)."""
    names = sorted(os.listdir(theirs_dir))
    assert sorted(os.listdir(ours_dir)) == names
    for name in names:
        a, b = os.path.join(ours_dir, name), os.path.join(theirs_dir, name)
        if not name.endswith(".npz"):
            assert filecmp.cmp(a, b, shallow=False), name
            continue
        with np.load(a) as x, np.load(b) as y:
            assert sorted(x.files) == sorted(y.files)
            for key in x.files:
                assert x[key].dtype == y[key].dtype
                assert np.array_equal(x[key], y[key]), (name, key)


def _same(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.permutation, b.permutation)
        x, y = a.matrix.tocsr(), b.matrix.tocsr()
        x.sort_indices()
        y.sort_indices()
        for field in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(x, field), getattr(y, field))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_artifacts_load_in_both_packages(tmp_path, levels, writer):
    base = str(tmp_path / "g")
    (save_decomposition_npz if writer == "port" else jax_save_npz)(
        levels, base, block_diagonal=True)
    assert not any(f.endswith("_indptr.npy") for f in os.listdir(tmp_path))
    ours = as_levels(load_decomposition(base, 32, block_diagonal=True), 32)
    theirs = jax_as_levels(jax_load(base, 32, block_diagonal=True), 32)
    _same(ours, levels)
    _same(theirs, levels)


def test_npz_writers_write_the_same_files(tmp_path, levels):
    for side in ("ours", "theirs"):
        os.makedirs(tmp_path / side)
    save_decomposition_npz(levels, str(tmp_path / "ours" / "g"))
    jax_save_npz(levels, str(tmp_path / "theirs" / "g"))
    _same_files(tmp_path / "ours", tmp_path / "theirs")


@pytest.mark.parametrize("to", ["npy", "npz"])
def test_convert_writes_the_same_files_as_jax(tmp_path, levels, to):
    for side in ("ours", "theirs"):
        os.makedirs(tmp_path / side)
        base = str(tmp_path / side / "g")
        if to == "npy":
            jax_save_npz(levels, base)
        else:
            save_decomposition(levels, base)
    n_ours = convert_decomposition(str(tmp_path / "ours" / "g"), 32, to=to)
    n_theirs = jax_convert(str(tmp_path / "theirs" / "g"), 32, to=to)
    assert n_ours == n_theirs == len(levels)
    _same_files(tmp_path / "ours", tmp_path / "theirs")
    loaded = as_levels(load_decomposition(str(tmp_path / "ours" / "g"), 32,
                                          verify=False), 32)
    _same(loaded, levels)


def test_convert_rejects_what_it_cannot_do(tmp_path):
    with pytest.raises(ValueError, match="unknown target format"):
        convert_decomposition(str(tmp_path / "g"), 32, to="mat")
    with pytest.raises(FileNotFoundError, match="npz"):
        convert_decomposition(str(tmp_path / "g"), 32, to="npy")


@pytest.mark.parametrize("n_blocks", range(1, 9))
@pytest.mark.parametrize("banded", [False, True])
def test_arrow_block_coords_equal_jax(n_blocks, banded):
    from arrow_matrix_tpu.io import arrow_block_coords as jax_coords
    from arrow_matrix_tpu_torch.io import arrow_block_coords

    got = arrow_block_coords(n_blocks, banded)
    assert got == jax_coords(n_blocks, banded)
    assert len(set(got)) == len(got)

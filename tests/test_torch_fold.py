"""The port's fold executor against the JAX package's
``MultiLevelArrow(fmt="fold")`` (XLA and Pallas-interpret kernels) and
the scipy golden, on one decomposition of BA n=2048 m=4 at width 64."""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu_torch.convert import from_jax_export
from arrow_matrix_tpu_torch.decomposition import (
    ArrowLevel,
    arrow_decomposition,
    decomposition_spmm,
)
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)

N, WIDTH = 2048, 64


@pytest.fixture(scope="module")
def levels():
    a = barabasi_albert(N, 4, seed=1)
    return arrow_decomposition(a, WIDTH, max_levels=10,
                               block_diagonal=True, seed=0)


@pytest.fixture(scope="module")
def weighted_levels(levels):
    rng = np.random.default_rng(5)
    out = []
    for lvl in levels:
        m = lvl.matrix.copy()
        m.data = rng.uniform(0.5, 1.5, m.nnz).astype(np.float32)
        out.append(ArrowLevel(m, lvl.permutation, lvl.arrow_width))
    return out


def _nnz(levels):
    return sum(lvl.matrix.nnz for lvl in levels)


def _run(executor, x, iters):
    return executor.gather_result(executor.run(executor.set_features(x),
                                               iters))


@pytest.mark.parametrize("kernel", ["xla", "pallas_sell"])
def test_ten_iterations_match_jax_and_scipy(levels, kernel):
    x = random_dense(N, 16, seed=3)
    ours = MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu")
    theirs = JaxArrow(levels, WIDTH, fmt="fold", kernel=kernel)
    assert np.array_equal(ours.perm0, theirs.perm0)
    assert ours.total_rows == theirs.total_rows
    got = _run(ours, x, 10)
    golden = x
    for _ in range(10):
        golden = decomposition_spmm(levels, golden)
    tol = relative_tolerance(_nnz(levels) / N, 10)
    assert relative_error(got, _run(theirs, x, 10)) <= tol
    assert relative_error(got, golden) <= tol


def test_bf16_within_2e2_of_jax(levels):
    x = random_dense(N, 16, seed=4)
    ours = MultiLevelArrow(levels, WIDTH, fmt="fold", feature_dtype="bf16",
                           device="cpu")
    theirs = JaxArrow(levels, WIDTH, fmt="fold", feature_dtype="bf16")
    c = ours.set_features(x)
    assert c.dtype == torch.bfloat16 and c.shape == (ours.total_rows, 16)
    got = ours.gather_result(ours.step(c))
    assert relative_error(got, _run(theirs, x, 1)) <= 2e-2
    assert relative_error(got, decomposition_spmm(levels, x)) <= 2e-2


def test_int8_bit_identical_to_jax_on_a_binary_graph(levels):
    x = random_dense(N, 16, seed=6)
    ours = MultiLevelArrow(levels, WIDTH, fmt="fold", feature_dtype="int8",
                           device="cpu")
    theirs = JaxArrow(levels, WIDTH, fmt="fold", feature_dtype="int8")
    assert ours.binary
    q, scale = ours.run(ours.set_features(x), 3)
    qj, sj = theirs.run(theirs.set_features(x), 3)
    assert scale.shape == (1, 16) and q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(qj).T)
    assert np.array_equal(scale.numpy(), np.asarray(sj).T)
    assert np.array_equal(ours.gather_result((q, scale)),
                          theirs.gather_result((qj, sj)))


def test_int8_within_one_step_of_jax_on_a_weighted_graph(weighted_levels):
    x = random_dense(N, 16, seed=7)
    ours = MultiLevelArrow(weighted_levels, WIDTH, fmt="fold",
                           feature_dtype="int8", device="cpu")
    theirs = JaxArrow(weighted_levels, WIDTH, fmt="fold",
                      feature_dtype="int8")
    assert not ours.binary
    q, scale = ours.step(ours.set_features(x))
    qj, sj = theirs.step(theirs.set_features(x))
    got = ours.gather_result((q, scale))
    want = theirs.gather_result((qj, sj))
    step = np.maximum(scale.numpy(), np.asarray(sj).T)
    assert np.all(np.abs(got - want) <= step * (1 + 1e-6))


def test_weighted_f32_matches_scipy(weighted_levels):
    x = random_dense(N, 16, seed=8)
    ours = MultiLevelArrow(weighted_levels, WIDTH, fmt="fold", device="cpu")
    got = _run(ours, x, 2)
    want = decomposition_spmm(weighted_levels,
                              decomposition_spmm(weighted_levels, x))
    assert relative_error(got, want) <= relative_tolerance(
        _nnz(weighted_levels) / N, 2)


@pytest.mark.parametrize("feature_dtype", [None, "bf16"])
def test_export_round_trips_with_jax(levels, tmp_path, feature_dtype):
    ours = MultiLevelArrow(levels, WIDTH, fmt="fold",
                           feature_dtype=feature_dtype, device="cpu")
    theirs = JaxArrow(levels, WIDTH, fmt="fold", feature_dtype=feature_dtype)
    ours.export_folded(str(tmp_path / "ours"))
    theirs.export_folded(str(tmp_path / "theirs"))
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "ours", tmp_path / "theirs", names, shallow=False)
    assert not mismatch and not errors
    assert np.array_equal(np.load(tmp_path / "ours" / "perm0.npy"),
                          theirs.perm0)

    x = random_dense(N, 16, seed=9)
    from_jax = from_jax_export(str(tmp_path / "theirs"), device="cpu")
    assert from_jax.feature_dtype == ours.feature_dtype
    assert np.array_equal(_run(from_jax, x, 2), _run(ours, x, 2))
    into_jax = JaxArrow.load_folded(str(tmp_path / "ours"))
    tol = relative_tolerance(_nnz(levels) / N, 2)
    if feature_dtype is not None:
        tol = 2e-2
    assert relative_error(_run(into_jax, x, 2), _run(ours, x, 2)) <= tol
    meta = json.loads((tmp_path / "ours" / "meta.json").read_text())
    assert meta["n_tiers"] == len(ours.sell.cols)


def test_tight_packing_matches_default(levels):
    x = random_dense(N, 16, seed=10)
    plain = MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu")
    tight = MultiLevelArrow(levels, WIDTH, fmt="fold", fold_growth=1.1,
                            fold_align=1, device="cpu")
    assert tight.sell.n_slots < plain.sell.n_slots
    assert len(tight.sell.cols) > len(plain.sell.cols)
    assert relative_error(_run(tight, x, 3), _run(plain, x, 3)) <= 1e-5


def test_carried_mask_marks_real_rows(levels):
    ours = MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu")
    mask = ours.carried_mask()
    assert mask.shape == (ours.total_rows, 1)
    assert int(mask.sum()) == N
    c = ours.set_features(np.ones((N, 2), np.float32))
    assert torch.equal(c * mask, c)


@pytest.mark.parametrize("kwargs", [
    {"mesh": object(), "fmt": "fold"}, {"routing": "a2a"},
    {"layout": "wide"},
    {"kernel": "pallas_sell"}, {"plan": "auto"},
    {"kernel_opts": {"row_block": 64}}])
def test_unported_options_raise_naming_the_roadmap(levels, kwargs,
                                                   tmp_path, monkeypatch):
    """The multi-device options are ported and refuse what the JAX class
    refuses, with its ValueError: the fold on a mesh, "a2a" without a
    mesh, "wide" without an arm axis; the fold executor options answer
    as the JAX class does: "pallas_sell" needs the fold, a plan miss
    warns, and a TPU knob K1 has no use for raises."""
    from arrow_matrix_tpu_torch.tune import TunePlanMiss

    monkeypatch.setenv("AMT_TUNE_PLAN_DIR", str(tmp_path))
    refused = {"mesh": "fmt='fold' is a single-chip whole-level kernel",
               "routing": "routing='a2a' requires a mesh",
               "layout": "layout='wide' needs a \\(arm=2, blocks\\) mesh"}
    key = next(iter(kwargs))
    if key in refused:
        with pytest.raises(ValueError, match=refused[key]):
            MultiLevelArrow(levels, WIDTH, device="cpu", **kwargs)
    elif "kernel" in kwargs:
        with pytest.raises(ValueError, match="requires fmt='fold'"):
            MultiLevelArrow(levels, WIDTH, device="cpu", **kwargs)
    elif "plan" in kwargs:
        with pytest.warns(TunePlanMiss, match="no plan file"):
            MultiLevelArrow(levels, WIDTH, device="cpu", **kwargs)
    else:
        with pytest.raises(ValueError, match="TPU knobs"):
            MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu",
                            **kwargs)


def test_fold_needs_the_card_unless_asked_for_the_cpu(levels):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLevelArrow(levels, WIDTH, fmt="fold")

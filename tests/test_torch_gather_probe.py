"""The port's gather probes on the CPU: the granule gather probe
(counterpart of ``tests/test_tools.py::test_pallas_gather_probe_cpu_
fixture``), the gather rates, the fold step and the decomposition
cache.  Times taken here are the host's; the tests check only what the
probes compute."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arrow_matrix_tpu_torch.decomposition import decomposition_spmm
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.tools import gather_probe
from arrow_matrix_tpu_torch.utils import (
    random_dense,
    relative_error,
    relative_tolerance,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def test_granule_gather_probe_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m",
         "arrow_matrix_tpu_torch.tools.granule_gather_probe",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["card"] is None
    assert (out["n"], out["slots"], out["block"], out["wave"]) == (
        1 << 14, 1 << 12, 64, 16)
    for name in ("torch_take", "torch_granule", "cuda_granule"):
        assert out["variants"][name]["exact"] is True, out
        assert out["variants"][name]["mslots_s"] > 0
    # A host run writes no verdict and no bound of the card.
    assert "verdict" not in out and "cuda_vs_torch" not in out
    assert "bound_ms" not in out
    assert out["line_bytes"] == out["slots"] * 512
    assert 0 < out["distinct_rows"] <= out["slots"]


def test_gather_rates_are_exact():
    recs = gather_probe.gather_rates(n=1 << 10, m=4, device="cpu",
                                     ks=(16, 128), reps=2)
    assert [(r["k"], r["dtype"], r["order"]) for r in recs] == [
        (k, dt, order) for k in (16, 128) for dt in ("f32", "bf16")
        for order in ("random", "sorted")]
    for r in recs:
        assert r["exact"] is True, r
        assert r["slots"] == 4096 and r["mslots_s"] > 0
        assert r["index_mslots_s"] > 0


@pytest.fixture(scope="module")
def small_levels(tmp_path_factory):
    cache = str(tmp_path_factory.mktemp("cache"))
    return gather_probe.cached_levels(1 << 12, 8, 256, seed=7,
                                      max_levels=12, cache_dir=cache)


@pytest.mark.parametrize("k", [16, 128])
def test_fold_step_agrees_with_plain(small_levels, k):
    levels = small_levels
    multi = MultiLevelArrow(levels, 256, fmt="fold", device="cpu")
    rec = gather_probe.fold_step(k, multi, iters=2)
    row_nnz = multi.nnz / multi.n
    assert gather_probe.fold_gate(rec, row_nnz)
    assert rec["tiers"] == len(multi.sell.cols)
    assert rec["slots"] == multi.sell.n_slots
    assert rec["slots_per_nnz"] >= 1.0
    assert set(rec["carriages"]) == {"f32", "bf16"}
    assert multi.feature_dtype == torch.float32      # restored
    # The fold it timed is the product of the levels.
    x = random_dense(multi.n, k, seed=3)
    got = multi.gather_result(multi.step(multi.set_features(x)))
    assert relative_error(got, decomposition_spmm(levels, x)) <= \
        relative_tolerance(row_nnz)


def test_fold_executor_builds_from_the_cache(tmp_path):
    multi = gather_probe.fold_executor("cpu", 1 << 12, 256,
                                       cache_dir=str(tmp_path))
    assert multi.n == 1 << 12 and multi.folded
    assert multi.device == torch.device("cpu")
    assert any(name.endswith(".complete") for name in os.listdir(tmp_path))
    rec = gather_probe.fold_step(16, multi, iters=1)
    assert gather_probe.fold_gate(rec, multi.nnz / multi.n)


def test_cached_levels_reloads_and_rebuilds(tmp_path, monkeypatch):
    calls = []
    real = gather_probe.arrow_decomposition

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(gather_probe, "arrow_decomposition", counting)
    args = (1 << 10, 3, 64)
    first = gather_probe.cached_levels(*args, seed=1, cache_dir=str(tmp_path))
    assert len(calls) == 1
    sentinels = [f for f in os.listdir(tmp_path) if f.endswith(".complete")]
    assert len(sentinels) == 1
    again = gather_probe.cached_levels(*args, seed=1, cache_dir=str(tmp_path))
    assert len(calls) == 1                            # loaded, not rebuilt
    assert len(again) == len(first)
    x = random_dense(1 << 10, 4, seed=2)
    assert np.array_equal(decomposition_spmm(again, x),
                          decomposition_spmm(first, x))
    os.remove(os.path.join(tmp_path, sentinels[0]))   # a cut-off write
    gather_probe.cached_levels(*args, seed=1, cache_dir=str(tmp_path))
    assert len(calls) == 2


def test_gather_probe_main_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(gather_probe, "CACHE_DIR", str(tmp_path))
    assert gather_probe.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == "cpu" and out["card"] is None
    assert len(out["gather_rates"]) == 12
    assert all(r["exact"] for r in out["gather_rates"])
    assert [f["k"] for f in out["fold"]] == [16, 128]
    assert all(f["gated"] for f in out["fold"])


def test_probes_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.gather_rates(n=64, m=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.fold_step(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.fold_executor(n=1 << 10, width=64)

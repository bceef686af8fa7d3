"""The port's command lines end to end on the CPU: ``spmm_arrow``,
and ``graft_serve --pulse``."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.spmm_arrow",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("extra", [[], ["--carry", "--feature_dtype", "bf16"]])
def test_generate_decompose_fold_validate_on_cpu(tmp_path, extra):
    proc = _run(["--device", "cpu", "--vertices", "1024", "--width", "64",
                 "--features", "16", "--iterations", "2", "--validate",
                 *extra], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    errs = re.findall(r"rel err vs host (\S+) \(gate (\S+)\)", proc.stdout)
    assert len(errs) == 2
    for err, gate in errs:
        assert float(err) <= float(gate)
    assert "spmm_time mean" in proc.stdout
    assert os.path.exists(tmp_path / "ba_1024_3_B_64_bd_manifest.json")

    again = _run(["--device", "cpu", "--path", "ba_1024_3", "--width", "64",
                  "--iterations", "1", "--validate"], tmp_path)
    assert again.returncode == 0, again.stdout + again.stderr


@pytest.mark.parametrize("blocked", ["true", "false"])
def test_dense_format_validates_on_cpu(tmp_path, blocked):
    proc = _run(["--fmt", "dense", "--device", "cpu", "--vertices", "1024",
                 "--width", "64", "--features", "16", "--iterations", "2",
                 "--validate", "--blocked", blocked], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"dense: \d+ levels, widths \[", proc.stdout)
    errs = re.findall(r"rel err vs host (\S+) \(gate (\S+)\)", proc.stdout)
    assert len(errs) == 2
    for err, gate in errs:
        assert float(err) <= float(gate)
    bd = "_bd" if blocked == "true" else ""
    assert os.path.exists(tmp_path / f"ba_1024_3_B_64{bd}_manifest.json")


@pytest.mark.parametrize("fmt,head_fmt", [("ell", "auto"), ("ell", "gell"),
                                          ("hyb", "auto"), ("auto", "flat")])
def test_level_formats_validate_on_cpu(tmp_path, fmt, head_fmt):
    proc = _run(["--fmt", fmt, "--head_fmt", head_fmt, "--device", "cpu",
                 "--vertices", "1024", "--width", "64", "--features", "5",
                 "--iterations", "2", "--validate", "--carry"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    formats = re.search(r"formats (\[[^]]*\])", proc.stdout).group(1)
    want = {"ell": "'ell'", "hyb": "'hyb'", "auto": "'dense'"}[fmt]
    assert want in formats
    if head_fmt == "gell":
        assert "heads ['gell'" in proc.stdout
    errs = re.findall(r"rel err vs host (\S+) \(gate (\S+)\)", proc.stdout)
    assert len(errs) == 2
    for err, gate in errs:
        assert float(err) <= float(gate)


def test_dense_format_rejects_a_feature_dtype(tmp_path):
    proc = _run(["--fmt", "dense", "--device", "cpu", "--vertices", "256",
                 "--width", "32", "--feature_dtype", "bf16"], tmp_path)
    assert proc.returncode != 0
    assert "--feature_dtype is a --fmt fold option" in proc.stderr


def test_without_a_device_it_fails_and_names_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["--vertices", "1024", "--width", "64", "--iterations",
                 "1"], tmp_path)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and "no CUDA device" in proc.stderr
    assert not os.listdir(tmp_path)        # no host work was done


def test_path_needs_a_width(tmp_path):
    proc = _run(["--device", "cpu", "--path", "x"], tmp_path)
    assert proc.returncode != 0 and "--width is required" in proc.stderr


# -- arrow_decompose and the matrix loaders ----------------------------------

def test_arrow_decompose_then_spmm_arrow_validates(tmp_path):
    from scipy import sparse

    from arrow_matrix_tpu_torch.cli import arrow_decompose
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    sparse.save_npz(tmp_path / "tiny.npz", barabasi_albert(300, 3, seed=1))
    arrow_decompose.main(["--dataset_dir", str(tmp_path), "--dataset_name",
                          "tiny.npz", "--width", "32", "--levels", "4",
                          "--seed", "0"])
    produced = os.listdir(tmp_path)
    assert any("_indptr.npy" in p for p in produced)
    assert any("_permutation.npy" in p for p in produced)
    proc = _run(["--device", "cpu", "--path", str(tmp_path / "tiny"),
                 "--width", "32", "--features", "4", "--iterations", "2",
                 "--validate", "true"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    errs = re.findall(r"rel err vs host (\S+) \(gate (\S+)\)", proc.stdout)
    assert errs and all(float(e) <= float(g) for e, g in errs)


@pytest.mark.parametrize("flags", [[], ["--backend", "numpy"],
                                   ["--backend", "native", "--block_diagonal",
                                    "false", "--seed", "3"]])
def test_arrow_decompose_writes_the_jax_artifacts(tmp_path, flags):
    import filecmp

    from scipy import sparse

    from arrow_matrix_tpu.cli import arrow_decompose as jax_cli
    from arrow_matrix_tpu_torch.cli import arrow_decompose
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    sparse.save_npz(tmp_path / "g.npz", barabasi_albert(600, 4, seed=5))
    for side, cli in (("ours", arrow_decompose), ("theirs", jax_cli)):
        cli.main(["--dataset_dir", str(tmp_path), "--dataset_name", "g.npz",
                  "--width", "48", "--levels", "6",
                  "--out_dir", str(tmp_path / side), *flags])
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert len(names) > 5
    assert sorted(os.listdir(tmp_path / "ours")) == names
    _, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "ours", tmp_path / "theirs", names, shallow=False)
    assert not mismatch and not errors


def _write_mat73(path, m):
    """A MATLAB v7.3 file: HDF5 with the 512-byte MATLAB userblock and
    the SuiteSparse ``Problem/A`` group layout."""
    import h5py
    import numpy as np
    from scipy import sparse

    csc = sparse.csc_matrix(m)
    with h5py.File(path, "w", userblock_size=512) as f:
        g = f.create_group("Problem").create_group("A")
        g.create_dataset("data", data=csc.data.astype(np.float64))
        g.create_dataset("ir", data=csc.indices.astype(np.uint64))
        g.create_dataset("jc", data=csc.indptr.astype(np.uint64))
        g.attrs["MATLAB_sparse"] = np.uint64(csc.shape[0])
    header = b"MATLAB 7.3 MAT-file, written by arrow_matrix_tpu_torch tests"
    block = header.ljust(116, b" ") + b"\x00" * 8
    block = block.ljust(124, b" ") + b"\x00\x02IM"
    with open(path, "r+b") as fh:
        fh.write(block.ljust(512, b"\x00"))


@pytest.mark.parametrize("ext", [".mtx", ".npz", ".mat"])
def test_load_sparse_matrix_equals_jax(tmp_path, ext):
    import numpy as np
    from scipy import io as sio
    from scipy import sparse

    from arrow_matrix_tpu.cli.common import load_sparse_matrix as jax_load
    from arrow_matrix_tpu_torch.cli.common import load_sparse_matrix
    from arrow_matrix_tpu_torch.utils import barabasi_albert

    a = barabasi_albert(80, 3, seed=7).astype(np.float64)
    a.data = np.random.default_rng(0).standard_normal(a.nnz)
    path = str(tmp_path / f"g{ext}")
    if ext == ".mtx":
        sio.mmwrite(path, a)
    elif ext == ".npz":
        sparse.save_npz(path, a)
    else:
        pytest.importorskip("h5py")
        _write_mat73(path, a)
    ours, theirs = load_sparse_matrix(path), jax_load(path)
    assert ours.dtype == theirs.dtype == np.float32
    for field in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(ours, field), getattr(theirs, field))
    assert abs(ours - a.astype(np.float32)).max() == 0
    with pytest.raises(ValueError, match="unsupported matrix format"):
        load_sparse_matrix(str(tmp_path / "g.txt"))


def test_cli_helpers_equal_jax():
    import numpy as np

    from arrow_matrix_tpu.cli import common as jax_common
    from arrow_matrix_tpu_torch.cli import common

    for v in ("yes", "True", "0", "n", True, False):
        assert common.str2bool(v) == jax_common.str2bool(v)
    with pytest.raises(Exception):
        common.str2bool("maybe")
    ours = common.random_adjacency(64, 512, seed=3)
    theirs = jax_common.random_adjacency(64, 512, seed=3)
    assert (ours != theirs).nnz == 0
    scaled, jscaled = (common.normalize_scale(ours),
                       jax_common.normalize_scale(theirs))
    assert np.array_equal(scaled.data, jscaled.data)
    assert scaled.dtype == np.float32


def _graft_serve(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("AMT_FAULT_PLAN", None)
    return subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_serve",
         "--vertices", "96", "--width", "16", "--features", "2",
         "--tenants", "2", "--requests", "6", "--iterations", "2",
         "--max_batch_k", "4", "--seed", "3", "--device", "cpu", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_graft_serve_pulse_writes_a_valid_ring_and_trace(tmp_path):
    """``--pulse --pulse_port 0``: the ring, the exposition and the
    request-correlated trace under ``--obs_dir``, the window series in
    ``--results_out``, and every result equal to a run without
    telemetry."""
    import numpy as np

    from arrow_matrix_tpu_torch.obs import pulse

    obs = tmp_path / "obs"
    r = _graft_serve(["--pulse", "--pulse_port", "0", "--slo_p99_ms",
                      "1e6", "--obs_dir", str(obs), "--results_out",
                      str(tmp_path / "pulse.npz")], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "pulse endpoint at http://127.0.0.1:" in r.stdout
    assert "graft-serve: pulse" in r.stdout
    ring = pulse.load_ring(str(obs / "pulse_ring.json"))
    assert pulse.validate_ring(ring) == []
    assert ring["totals"]["completed"] == 6 and ring["closed"]
    with open(obs / "pulse_metrics.prom") as fh:
        assert pulse.validate_exposition(fh.read()) == []
    with open(obs / "serve_trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e["ph"] == "X"]
    assert {"admission", "batch", "finalize"} <= {e["name"] for e in events}
    assert all(e["args"].get("request_id") for e in events)
    with open(obs / "serve_summary.json") as fh:
        assert json.load(fh)["pulse"]["totals"]["completed"] == 6
    r = _graft_serve(["--results_out", str(tmp_path / "plain.npz")],
                     tmp_path)
    assert r.returncode == 0, r.stderr
    with np.load(tmp_path / "pulse.npz") as a, \
            np.load(tmp_path / "plain.npz") as b:
        assert sorted(a.files) == sorted(b.files + ["_pulse_windows"])
        for rid in b.files:
            assert a[rid].tobytes() == b[rid].tobytes()
        windows = json.loads(a["_pulse_windows"].tobytes().decode())
    assert sum(w["completed"] for w in windows) == 6

"""The port's ``spmm_arrow`` command line, end to end on the CPU."""

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

"""The port's accuracy probe (``arrow_matrix_tpu_torch.ledger.probe``)
against the JAX package's on the CPU: the same structure hash, an
all-zero f32 curve, bf16 and int8 curves within ``relative_tolerance``
of the reference's at every point, deterministic records; the curves
written to a store become the certificates ``classes.find_certificate``
returns; the CLI's probe appends them."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.ledger.probe import (
    error_curves_for_source as jcurves,
)
from arrow_matrix_tpu_torch.classes import find_certificate
from arrow_matrix_tpu_torch.ledger import Ledger
from arrow_matrix_tpu_torch.ledger.probe import (
    error_curve,
    error_curves_for_source,
)
from arrow_matrix_tpu_torch.utils import relative_tolerance

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ({"kind": "ba", "n": 256, "m": 3, "width": 32, "seed": 7,
            "max_levels": 10},
           {"kind": "ba", "n": 600, "m": 4, "width": 32, "seed": 2,
            "max_levels": 10})
DTYPES = ("f32", "bf16", "int8")


@pytest.mark.parametrize("source", SOURCES)
def test_curves_equal_jax_within_tolerance(source):
    iterations, k = 6, 4
    ours = error_curves_for_source(source, k=k, iterations=iterations,
                                   dtypes=DTYPES, device="cpu")
    theirs = jcurves(source, k=k, iterations=iterations, dtypes=DTYPES)
    from arrow_matrix_tpu_torch.tune import load_levels_from_source

    levels, _ = load_levels_from_source(source)
    row_nnz = sum(int(lvl.matrix.nnz) for lvl in levels) / source["n"]
    for a, b in zip(ours, theirs):
        assert a["structure_hash"] == b["structure_hash"]
        assert a["metric"] == b["metric"]
        assert a["knobs"] == b["knobs"]
        assert (a["platform"], a["device_kind"]) == ("cpu", "cpu")
        ca, cb = a["payload"]["rel_frobenius"], b["payload"]["rel_frobenius"]
        assert len(ca) == len(cb) == iterations
        for s, (x, y) in enumerate(zip(ca, cb)):
            assert abs(x - y) <= relative_tolerance(row_nnz, s + 1), \
                (a["metric"], s, x, y)
        assert all(np.isfinite(ca))
    f32 = ours[0]["payload"]
    assert f32["rel_frobenius"] == [0.0] * iterations
    assert f32["max_abs"] == [0.0] * iterations
    assert ours[1]["value"] > 0.0 and ours[2]["value"] > 0.0


def test_records_are_deterministic_and_carry_the_source():
    src = SOURCES[0]
    a = error_curves_for_source(src, k=2, iterations=3, device="cpu")
    b = error_curves_for_source(src, k=2, iterations=3, device="cpu")
    assert a == b
    assert [r["metric"] for r in a] == ["error_curve_f32",
                                        "error_curve_bf16"]
    assert a[0]["ts_unix"] == 0 and a[0]["payload"]["source"] == src
    with pytest.raises(ValueError, match="unknown probe dtype"):
        error_curves_for_source(src, dtypes=("f16",), device="cpu")


def test_emulated_int8_as_jax():
    src = SOURCES[0]
    ours = error_curves_for_source(src, k=2, iterations=3, dtypes=("int8",),
                                   emulate_int8=True, device="cpu")
    theirs = jcurves(src, k=2, iterations=3, dtypes=("int8",),
                     emulate_int8=True)
    assert ours[0]["knobs"]["emulated"] is True
    assert np.allclose(ours[0]["payload"]["rel_frobenius"],
                       theirs[0]["payload"]["rel_frobenius"],
                       rtol=1e-5, atol=1e-7)


def test_error_curve_arithmetic():
    g = [np.ones((3, 2), np.float32), np.zeros((3, 2), np.float32)]
    p = [np.full((3, 2), 1.5, np.float32), np.ones((3, 2), np.float32)]
    c = error_curve(g, p)
    assert c["frobenius"] == pytest.approx([np.sqrt(6 * 0.25),
                                            np.sqrt(6.0)])
    assert c["rel_frobenius"][0] == pytest.approx(0.5)
    assert c["rel_frobenius"][1] == pytest.approx(np.sqrt(6.0))
    assert c["max_abs"] == [0.5, 1.0]


def test_curves_in_a_store_are_the_certificates(tmp_path):
    d = str(tmp_path / "ledger")
    src = SOURCES[0]
    recs = error_curves_for_source(src, k=4, iterations=4, dtypes=DTYPES,
                                   ledger=Ledger(d), device="cpu")
    assert Ledger(d).validate() == []
    shash = recs[0]["structure_hash"]
    for dtype, rec in zip(DTYPES[1:], recs[1:]):
        cert = find_certificate(shash, dtype, ledger_dir=d)
        assert cert is not None, dtype
        assert cert.structure_hash == shash
        assert cert.record_id == rec["record_id"]
        assert list(cert.rel_frobenius) == rec["payload"]["rel_frobenius"]
    assert find_certificate("other", "bf16", ledger_dir=d) is None


def test_cli_probe_appends_the_curves(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    d = str(tmp_path / "ledger")
    proc = subprocess.run(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_ledger",
         "--ledger-dir", d, "probe", "--ba", "256,32,7", "--k", "2",
         "--iterations", "3", "--dtypes", "f32,bf16,int8", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "error_curve_f32" in proc.stdout
    assert "final rel_frobenius=0.0000e+00" in proc.stdout
    recs = Ledger(d).read_all()
    assert [r["knobs"]["dtype"] for r in recs] == ["f32", "bf16", "int8"]
    assert {r["platform"] for r in recs} == {"cpu"}

"""The port's command lines end to end on the CPU: ``spmm_arrow`` (with
its observability flags), the baselines ``spmm_petsc`` and ``spmm_15d``
on gloo ranks, ``graft_serve --pulse``, and the lens's and the ledger's
operator surfaces ``graft_lens`` and ``graft_ledger`` (every subcommand,
beside the JAX CLIs' outputs where they compute the same thing)."""

import json
import os
import re
import subprocess
import sys

import numpy as np
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


@pytest.mark.parametrize("extra", [
    ["--fmt", "sell"], ["--repl", "2", "--features", "8", "--comm_report"]])
def test_mesh_sell_validates_on_two_cpu_ranks(tmp_path, extra):
    """``--devices 2 --device cpu --fmt sell --validate``: two gloo ranks
    started by the CLI, every iteration within the gate; without
    ``--fmt`` the format resolves to sell and the routing to a2a, as the
    JAX CLI resolves them on more than one device."""
    proc = _run(["--devices", "2", "--device", "cpu", "--vertices", "1024",
                 "--width", "64", "--features", "16", "--iterations", "2",
                 "--validate", *extra], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "over gloo (2 ranks on cpu)" in proc.stdout
    errs = re.findall(r"rel err vs host (\S+) \(gate (\S+)\)", proc.stdout)
    assert len(errs) == 2
    for err, gate in errs:
        assert float(err) <= float(gate)
    assert "auto-selected --routing a2a" in proc.stdout
    # Rank 0 alone writes the run's log (``--logdir``, default ./logs).
    runs = [f for f in os.listdir(tmp_path / "logs") if f.endswith(".json")]
    assert len(runs) == 1 and "log written to" in proc.stdout
    if "--comm_report" in extra:
        assert "auto-selected --fmt sell" in proc.stdout
        assert "2.5D mesh: 1 block shards x 2 replica groups" in proc.stdout
        assert re.search(r"reduce \d+ B, host staged 0 B", proc.stdout)


def test_mesh_refusals_exit_before_any_work(tmp_path, monkeypatch):
    """Flags that cannot go together (the JAX CLI's refusals of ``--mode
    space`` among them, and a checkpoint without ``--carry``) exit
    before any work on a mesh of ranks."""
    from arrow_matrix_tpu_torch.cli.spmm_arrow import main

    monkeypatch.chdir(tmp_path)
    for args, words in (
            (["--mode", "space", "--repl", "2"],
             "--repl composes with --mode time"),
            (["--mode", "space", "--slim", "false"], "runs time-shared"),
            (["--mode", "space", "--fmt", "hyb"], "single-chip kernel"),
            (["--fmt", "fold"], "single-chip only"),
            (["--checkpoint", "ck"], "--checkpoint requires --carry"),
            (["--slim", "false"], "even --devices >= 4")):
        with pytest.raises(SystemExit, match=words):
            main(["--devices", "2", "--device", "cpu", *args])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("fmt", ["sell", "dense"])
def test_space_mode_validates_on_cpu_ranks(tmp_path, fmt):
    """``--mode space --devices 3``: one rank group a level of the
    3-level decomposition (SellSpaceShared for sell, SpaceSharedArrow
    otherwise), every carried iteration within the gate."""
    proc = _run(["--devices", "3", "--device", "cpu", "--mode", "space",
                 "--fmt", fmt, "--vertices", "1024", "--width", "64",
                 "--features", "8", "--iterations", "2", "--carry",
                 "--validate", "--comm_report"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mesh: {'lvl': 3, 'blocks': 1} over gloo" in proc.stdout
    assert ("sell space:" if fmt == "sell" else "space: dense") \
        in proc.stdout
    errs = re.findall(r"rel err vs host (\S+) \(gate (\S+)\)", proc.stdout)
    assert len(errs) == 2
    for err, gate in errs:
        assert float(err) <= float(gate)
    assert re.search(r"all-reduce\s+1\s", proc.stdout)


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


# ---------------------------------------------------------------------------
# graft_lens and graft_ledger
# ---------------------------------------------------------------------------

class _Run:
    """The outcome of one in-process CLI call."""

    def __init__(self, returncode, stdout, stderr):
        self.returncode, self.stdout, self.stderr = returncode, stdout, \
            stderr

    def last_json(self):
        return json.loads(self.stdout.strip().splitlines()[-1])


@pytest.fixture
def cli(tmp_path, capsys):
    """``cli(module, *args)``: ``python -m module args`` run in this
    process from ``tmp_path`` (no interpreter start-up a call)."""
    import importlib

    def run(module, *args):
        main = importlib.import_module(module).main
        old = os.getcwd()
        capsys.readouterr()
        os.chdir(tmp_path)
        try:
            rc = main([str(a) for a in args])
        except SystemExit as e:
            rc = e.code
        finally:
            os.chdir(old)
        return _Run(rc, *capsys.readouterr())

    return run


LENS = "arrow_matrix_tpu_torch.cli.graft_lens"
LEDGER = "arrow_matrix_tpu_torch.cli.graft_ledger"
JLENS = "arrow_matrix_tpu.cli.graft_lens"
JLEDGER = "arrow_matrix_tpu.cli.graft_ledger"


def test_graft_lens_profile_fit_predict_explain_check(tmp_path, cli,
                                                      monkeypatch):
    import functools

    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.obs import lens
    from test_torch_lens import SimulatedCard

    committed = os.path.join(REPO, "bench_results", "lens",
                             "ba_256_3_profile.json")
    # The samples read a clock that advances with K1's work alone, not
    # the shared host's wall clock.
    monkeypatch.setattr(lens, "profile_fold", functools.partial(
        lens.profile_fold, clock=SimulatedCard(monkeypatch)))
    store = "L"
    r = cli(LENS, "profile", "--ba", "256,32,0", "--k", "16", "--iters",
            "5", "--device", "cpu", "--out", "p.json", "--fit", "m.json",
            "--ledger-dir", store)
    assert r.returncode == 0, r.stderr
    c = cli(LENS, "check", "p.json", "--model", "m.json")
    assert c.returncode == 0, c.stdout + c.stderr
    assert c.last_json() == {"cmd": "check", "ok": True, "problems": []}
    out = r.last_json()
    with open(committed) as fh:
        assert out["structure_hash"] == json.load(fh)["structure_hash"]
    assert out["kernel"] == "xla" and set(out["dtypes"]) == {"f32", "bf16"}
    assert out["records"] == len(Ledger(str(tmp_path / store)).read_all()) > 0
    f = cli(LENS, "fit", "p.json", "--out", "m2.json", "--dtypes", "f32")
    assert f.returncode == 0 and f.last_json()["families"]
    p = cli(LENS, "predict", "m.json", "--ba", "256,32,0", "--k", "16")
    assert p.returncode == 0 and p.last_json()["predicted_ms"] > 0
    e = cli(LENS, "explain", "p.json", "--model", "m.json")
    assert e.returncode == 0 and e.last_json()["dominant"].startswith("L")
    # The JAX CLI reads the port's documents and agrees on the model.
    jp = cli(JLENS, "predict", "m.json", "--ba", "256,32,0", "--k", "16")
    assert jp.returncode == 0, jp.stderr
    assert jp.last_json()["predicted_ms"] == p.last_json()["predicted_ms"]
    jc = cli(JLENS, "check", "p.json", "--model", "m.json")
    assert jc.returncode == 0, jc.stdout + jc.stderr
    # A profile whose tiers cover half the step fails the check.
    with open(tmp_path / "p.json") as fh:
        bad = json.load(fh)
    bad["dtypes"]["f32"]["coverage"] = 0.5
    with open(tmp_path / "bad.json", "w") as fh:
        json.dump(bad, fh)
    b = cli(LENS, "check", "bad.json")
    assert b.returncode == 1 and not b.last_json()["ok"]


@pytest.mark.parametrize("flags", [["--kernel", "pallas"],
                                   ["--kernel", "pallas", "--ring-sweep"]])
def test_graft_lens_reference_options_exit_naming_the_item(
        cli, flags, monkeypatch, tmp_path):
    """``--kernel pallas`` and ``--ring-sweep`` once exited naming a
    ROADMAP item; now they profile K1 at its knob points (the sweep: each
    tier alone at batch 4 against the profile's batch 8), the profile
    checks, and ``predict --ring 1`` adds the fitted waits, as the JAX
    CLI's ``predict`` does on the same documents."""
    import functools

    from arrow_matrix_tpu_torch.obs import lens
    from test_torch_lens import SimulatedCard

    monkeypatch.setattr(lens, "profile_fold", functools.partial(
        lens.profile_fold, clock=SimulatedCard(monkeypatch,
                                               shallow_extra=0.5)))
    r = cli(LENS, "profile", "--ba", "64,16,0", "--device", "cpu",
            "--k", "8", "--iters", "2", "--dtypes", "f32",
            "--out", "p.json", "--fit", "m.json", *flags)
    assert r.returncode == 0, r.stderr
    out = r.last_json()
    assert out["ok"] and out["kernel"] == "pallas"
    with open(tmp_path / "p.json") as fh:
        doc = json.load(fh)
    tiers = [t for t in doc["dtypes"]["f32"]["tiers"] if t["slot_width"]]
    assert all(t["family"].endswith("@b8") for t in tiers)
    if "--ring-sweep" in flags:
        assert out["sweep"]["knob"] == "batch"
        assert out["sweep"]["bit_equal_tiers"] == len(tiers)
        assert all("ring1_ms" in t and "dma_wait_ms" in t for t in tiers)
    else:
        assert "sweep" not in out and doc["dtypes"]["f32"]["dma_wait_ms"] \
            == {}
    deep = cli(LENS, "predict", "m.json", "--ba", "64,16,0", "--k", "8",
               "--kernel", "pallas")
    shallow = cli(LENS, "predict", "m.json", "--ba", "64,16,0", "--k", "8",
                  "--kernel", "pallas", "--ring", "1")
    assert deep.returncode == shallow.returncode == 0
    gap = shallow.last_json()["predicted_ms"] - deep.last_json()[
        "predicted_ms"]
    with open(tmp_path / "m.json") as fh:
        waits = json.load(fh)["dma_wait_ms"]
    assert abs(gap - sum(waits[t["family"]] for t in tiers
                         if t["family"] in waits)) < 1e-5
    assert (gap > 0) == ("--ring-sweep" in flags)
    # Each package's graft_lens reads the other's profile.
    jc = cli(JLENS, "check", "p.json")
    assert jc.returncode == 0, jc.stdout + jc.stderr


def test_graft_ledger_subcommands_on_a_store(tmp_path, cli):
    from arrow_matrix_tpu_torch.ledger import Ledger

    store = ("--ledger-dir", "L")
    rounds = [os.path.join(REPO, f"BENCH_r0{i}.json") for i in (2, 3)]
    r = cli(LEDGER, *store, "ingest", "--bench", *rounds)
    assert r.returncode == 0, r.stderr
    assert "ingested 2 legacy bench rounds" in r.stdout
    r = cli(LEDGER, *store, "probe", "--ba", "96,16,7", "--k", "2",
            "--iterations", "3", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert cli(LEDGER, *store, "check").returncode == 0
    r = cli(LEDGER, *store, "rebaseline")
    assert r.returncode == 0 and "baseline written" in r.stdout
    r = cli(LEDGER, *store, "check")
    assert r.returncode == 0 and "ledger_gate: ok" in r.stdout
    r = cli(LEDGER, *store, "report")
    assert r.returncode == 0 and "error_curve|error_curve_bf16|" in r.stdout
    r = cli(LEDGER, *store, "report", "--json", "--kind", "error_curve")
    assert json.loads(r.stdout)["records"] == 2
    r = cli(LEDGER, *store, "curve", "--dtype", "f32")
    assert r.returncode == 0 and "0.0000e+00" in r.stdout
    r = cli(LEDGER, *store, "diff")
    assert r.returncode == 0, r.stdout + r.stderr
    # export into a directory names the round file there.
    (tmp_path / "out").mkdir()
    r = cli(LEDGER, *store, "export", "--round", "99", "--out", "out")
    assert r.returncode == 0, r.stderr
    doc = json.loads((tmp_path / "out" / "BENCH_r99.json").read_text())
    assert doc["n"] == 99 and len(doc["parsed"]["error_curves"]) == 2
    assert doc["parsed"]["ledger"]["records"] == len(
        Ledger(str(tmp_path / "L")).read_all())
    assert not (tmp_path / "BENCH_r99.json").exists()
    # --out is required: nothing lands in the working directory.
    r = cli(LEDGER, *store, "export", "--round", "98")
    assert r.returncode == 2 and "--out" in r.stderr
    # The JAX CLI exports the port's store to the same bytes.
    r = cli(JLEDGER, *store, "export", "--round", "99", "--out", "jax.json")
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "out" / "BENCH_r99.json").read_bytes()
    # A tampered line fails the check.
    path = tmp_path / "L" / "ledger.jsonl"
    lines = path.read_text().splitlines()
    rec = json.loads(lines[0])
    rec["value"] = 1.0
    lines[0] = json.dumps(rec, separators=(",", ":"))
    path.write_text("\n".join(lines) + "\n")
    assert cli(LEDGER, *store, "check").returncode == 1


# -- the baselines' CLIs and spmm_arrow's observability flags --------------

def _run_module(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", f"arrow_matrix_tpu_torch.{module}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


BASE_ARGS = ["--device", "cpu", "--devices", "4", "--columns", "4"]


def test_spmm_15d_random_validates(tmp_path):
    proc = _run_module("cli.spmm_15d", [
        *BASE_ARGS, "--vertices", "256", "--edges", "1024",
        "--iterations", "2", "--validate", "true",
        "--logdir", str(tmp_path / "logs")], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "grid 2 x 2 on 4 gloo rank(s)" in proc.stdout
    assert "validation: ok=True" in proc.stdout
    assert "spmm_time mean" in proc.stdout
    assert os.listdir(tmp_path / "logs")


def test_spmm_15d_memmap_triplet_validates(tmp_path):
    """``--memmap`` builds from a memmapped npy CSR triplet, slab by slab,
    and validates against the streamed golden."""
    from arrow_matrix_tpu_torch.utils.graphs import barabasi_albert

    a = barabasi_albert(128, 3, seed=7).astype(np.float32).tocsr()
    np.save(tmp_path / "t_data.npy", a.data)
    np.save(tmp_path / "t_indices.npy", a.indices)
    np.save(tmp_path / "t_indptr.npy", a.indptr)
    proc = _run_module("cli.spmm_15d", [
        *BASE_ARGS, "--file", str(tmp_path / "t"), "--memmap", "true",
        "-r", "1", "--iterations", "1", "--validate", "true",
        "--logdir", str(tmp_path / "logs")], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "grid 4 x 1" in proc.stdout
    assert "validation: ok=True" in proc.stdout


def test_spmm_petsc_random_validates(tmp_path):
    proc = _run_module("cli.spmm_petsc", [
        *BASE_ARGS, "--vertices", "256", "--edges", "1024",
        "--iterations", "2", "--validate", "true", "--carry",
        "--logdir", str(tmp_path / "logs")], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "4 slices of <= 64 rows" in proc.stdout
    assert "validation: allclose=True" in proc.stdout


def test_spmm_petsc_dryrun_and_slices(tmp_path):
    """The reference's slice-file scheme, 4 files on 2 ranks: the slices
    are reassembled and the partition recomputed; ``--dryrun`` stops
    after the tables."""
    from scipy import sparse

    from arrow_matrix_tpu_torch.utils.graphs import barabasi_albert

    a = barabasi_albert(64, 2, seed=3).astype(np.float32)
    bounds = np.linspace(0, 64, 5).astype(int)
    for r in range(4):
        sparse.save_npz(tmp_path / f"g.part.4.slice.{r}.npz",
                        a[bounds[r]:bounds[r + 1]])
    proc = _run_module("cli.spmm_petsc", [
        "--file", str(tmp_path / "g.part.4.slice.0.npz"), "--dryrun",
        "true", "--device", "cpu", "--devices", "2",
        "--logdir", str(tmp_path / "logs")], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 slices of <= 32 rows" in proc.stdout
    assert "validation" not in proc.stdout


def test_spmm_petsc_per_slice_ingest_validates(tmp_path):
    """As many slice files as ranks: each rank loads only its own slice
    and validates its rows against its own golden."""
    from scipy import sparse

    from arrow_matrix_tpu_torch.utils.graphs import barabasi_albert

    n = 64
    a = barabasi_albert(n, 2, seed=5).astype(np.float32)
    bounds = np.linspace(0, n, 5).astype(int)
    for r in range(4):
        sparse.save_npz(tmp_path / f"g.part.4.slice.{r}.npz",
                        a[bounds[r]:bounds[r + 1]])
    proc = _run_module("cli.spmm_petsc", [
        *BASE_ARGS, "--file", str(tmp_path / "g.part.4.slice.0.npz"),
        "--iterations", "1", "--validate", "true",
        "--logdir", str(tmp_path / "logs")], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("validation (each rank its own slice): allclose=True"
            in proc.stdout)


@pytest.mark.parametrize("module", ["cli.spmm_15d", "cli.spmm_petsc"])
def test_baseline_comm_reports(tmp_path, module):
    """``--comm_report`` on both baselines: one step's counted bytes by
    kind, the total and the ratio to the paper model's ideal."""
    proc = _run_module(module, [
        *BASE_ARGS, "--vertices", "256", "--edges", "1024",
        "--iterations", "1", "--validate", "true", "--comm_report",
        "--mem_report", "--logdir", str(tmp_path / "logs")], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "collective" in proc.stdout and "TOTAL" in proc.stdout
    assert "measured vs paper-model ideal" in proc.stdout
    assert "per-device call memory" in proc.stdout
    assert "per-shard load balance (4 device units)" in proc.stdout


def test_baseline_refusals_exit_before_any_work(tmp_path, monkeypatch):
    """A checkpoint without ``--carry``, a replication whose square does
    not divide the rank count, and a memmap without a file, exit before
    any rank starts."""
    from arrow_matrix_tpu_torch.cli import spmm_15d, spmm_petsc

    monkeypatch.chdir(tmp_path)
    for main, args, words in (
            (spmm_petsc.main, ["--checkpoint", "ck"],
             "--checkpoint requires --carry"),
            (spmm_15d.main, ["--checkpoint", "ck"],
             "--checkpoint requires --carry"),
            (spmm_15d.main, ["-r", "2"], "not divisible by c\\^2"),
            (spmm_15d.main, ["--memmap"], "--memmap requires --file"),
            (spmm_15d.main, ["--repl", "2", "-r", "2"], "give one")):
        with pytest.raises(SystemExit, match=words):
            main(["--devices", "2", "--device", "cpu", *args])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("devices", ["1", "2"])
def test_spmm_arrow_observability_flags_on_cpu(tmp_path, devices):
    """``--obs_dir``, ``--mem_report`` and ``--trace`` on one device and on
    two gloo ranks: the memory and imbalance reports, the span trace and
    ``metrics.jsonl`` (rank 0's), one profiler trace a rank."""
    proc = _run(["--device", "cpu", "--devices", devices, "--vertices",
                 "512", "--width", "32", "--features", "4", "--iterations",
                 "2", "--validate", "--mem_report", "--obs_dir", "obs",
                 "--trace", "tr"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "per-device call memory" in proc.stdout
    assert "per-shard load balance" in proc.stdout
    trace = json.load(open(tmp_path / "obs" / "spmm_arrow.trace.json"))
    steps = [e for e in trace["traceEvents"] if e.get("name") == "step"]
    assert len(steps) == 2
    events = [json.loads(line) for line in
              open(tmp_path / "obs" / "metrics.jsonl") if line.strip()]
    assert sum(e["name"] == "iteration_time_ms" for e in events) == 2
    assert any(e["name"] == "hbm_measured_bytes" for e in events)
    assert len(os.listdir(tmp_path / "tr")) == int(devices)

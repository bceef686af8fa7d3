"""Checkpoints of a carriage sharded over a mesh of gloo ranks
(``utils/checkpoint.py`` with ``mesh=``) against the JAX package's
multi-process path (``arrow_matrix_tpu/utils/checkpoint.py:213-330``):
the mesh's first rank writes the one file, every rank reads its rows, a
failing writer fails every rank and leaves none waiting, a resume on
another mesh fails by name, and JAX's file loads at equal layout.  Then
JAX's ``tests/test_multihost.py:177`` story through the port's three
CLIs: 2 ranks run 2 iterations with ``--checkpoint_every 1``, 2 fresh
ranks run 4, resume at iteration 2 and validate every iteration."""

import os
import subprocess
import sys

import numpy as np
import pytest

from arrow_matrix_tpu.utils import checkpoint as jck
from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.utils import barabasi_albert, random_dense

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_state_jobs"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", timeout_s=120) as pool:
        yield pool


@pytest.fixture(scope="module")
def problem():
    a = barabasi_albert(300, 3, seed=2)
    levels = arrow_decomposition(a, 32, max_levels=3, block_diagonal=True,
                                 seed=2)
    return levels, random_dense(300, 2, seed=4)


def test_round_trip_on_two_ranks(pool2, problem, tmp_path):
    """The file holds the whole carriage (both ranks' rows in rank
    order); each rank reads back its own rows bit for bit; the save is
    an all-gather and an all-reduce of the writer's outcome, counted."""
    levels, x = problem
    path = str(tmp_path / "ck")
    got = pool2.run(JOBS, "checkpoint_round_trip", levels, 32, x, path,
                    "spmm_arrow/time/ell/f32/ranks2")
    assert all(r["equal"] and r["step"] == 1 for r in got)
    assert got[0]["full"].shape[0] == 2 * got[0]["rows"]
    assert sorted(got[0]["counted"]) == ["all-gather", "all-reduce"]
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.sha256"]


def test_failing_writer_fails_every_rank(pool2, tmp_path):
    """The writer's error reaches every rank through the outcome's
    all-reduce: both raise naming the writer, neither waits, and no
    file is left."""
    msgs = pool2.run(JOBS, "checkpoint_failing_writer",
                     str(tmp_path / "ck"), job_timeout_s=60)
    assert all(m and "failed on rank 0, the mesh's writer" in m
               for m in msgs)
    assert "disk full (injected)" in msgs[0]
    assert not os.path.exists(tmp_path / "ck.npz")


def test_resume_on_another_rank_count_fails_by_name(pool2, problem,
                                                    tmp_path):
    """A 2-rank checkpoint resumed on a 1-rank mesh: the layout tag
    (which names the rank count) refuses, saying both layouts."""
    levels, x = problem
    msgs = pool2.run(JOBS, "checkpoint_other_mesh", levels, 32, x,
                     str(tmp_path / "ck"))[0]
    assert "'spmm_arrow/ranks2'" in msgs[0]
    assert "'spmm_arrow/ranks1'" in msgs[0]
    assert msgs[1] is None or "over 1 ranks" in msgs[1]


def test_jax_file_loads_at_equal_layout(pool2, tmp_path, monkeypatch):
    """A file of the JAX package's npz writer loads on the port's 2-rank
    mesh at equal layout: each rank gets its rows."""
    import jax.numpy as jnp

    monkeypatch.setattr(jck, "_orbax", lambda: None)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    path = str(tmp_path / "ck")
    jck.save_state(path, jnp.asarray(x), 5, layout="multi_level/ell")
    got = pool2.run(JOBS, "checkpoint_load_rows", path, 4,
                    "multi_level/ell")
    for rank, (rows, step) in enumerate(got):
        assert step == 5 and rows.tobytes() == x[4 * rank:4 * rank + 4] \
            .tobytes()


#: Each CLI's flags of the resume story (``--validate`` where the CLI
#: gates every iteration against its host golden).
RESUME_RUNS = {
    "spmm_arrow": ["--vertices", "1024", "--ba_neighbors", "3", "--width",
                   "64", "--features", "4", "--fmt", "sell", "--validate"],
    "spmm_petsc": ["--vertices", "2000", "--edges", "12000", "--columns",
                   "4"],
    "spmm_15d": ["--vertices", "2000", "--edges", "12000", "--columns",
                 "4", "-r", "1"]}


def _pair(module, args, cwd):
    """``module`` on 2 CPU ranks, started (the CLI spawns the ranks)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", f"arrow_matrix_tpu_torch.cli.{module}",
         *args, "--device", "cpu", "--devices", "2"], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Every CLI's two runs (2 then 4 iterations over one checkpoint),
    the three CLIs at once: ``{module: [(rc, stdout, stderr)] * 2}``."""
    dirs = {m: str(tmp_path_factory.mktemp(m)) for m in RESUME_RUNS}
    out = {m: [] for m in RESUME_RUNS}
    for iters in ("2", "4"):
        procs = {m: _pair(m, args + ["--carry", "--checkpoint", "ckpt",
                                     "--checkpoint_every", "1",
                                     "--iterations", iters], dirs[m])
                 for m, args in RESUME_RUNS.items()}
        for m, p in procs.items():
            o, e = p.communicate(timeout=300)
            out[m].append((p.returncode, o, e))
    return out


@pytest.mark.parametrize("module", sorted(RESUME_RUNS))
def test_cli_resume_across_processes(resumed, module):
    """2 ranks, 2 iterations, a checkpoint every iteration; then 2 fresh
    ranks, 4 iterations: they resume at iteration 2 and finish (with
    ``--validate``, every iteration after it within its gate)."""
    (rc1, out1, err1), (rc2, out2, err2) = resumed[module]
    assert rc1 == 0, out1 + err1
    assert rc2 == 0, out2 + err2
    assert "resumed from ckpt at iteration 2" in out2
    if "--validate" in RESUME_RUNS[module]:
        its = [ln.split(":")[0] for ln in out2.splitlines()
               if ln.startswith("iteration ")]
        assert its == ["iteration 2", "iteration 3"]

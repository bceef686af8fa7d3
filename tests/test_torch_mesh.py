"""The port's mesh on torch.distributed (``parallel/mesh.py``,
``parallel/collectives.py``, ``parallel/launch.py``): the JAX mesh
module's arithmetic, the grid of ranks and its groups, each collective
on gloo ranks on the CPU, the backend rules, and a failing rank ending
the whole job."""

import os
import sys
import time

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.parallel import mesh as jmesh
from arrow_matrix_tpu_torch.parallel import mesh as pmesh
from arrow_matrix_tpu_torch.parallel.launch import RankPool, resolve_launch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_mesh_jobs"


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=60) as pool:
        yield pool


@pytest.mark.parametrize("n", list(range(1, 34)) + [64, 128, 1000])
def test_largest_replication_matches_jax(n):
    assert pmesh.largest_replication(n) == jmesh.largest_replication(n)


@pytest.mark.parametrize("nb,n_dev", [(1, 1), (7, 4), (8, 4), (9, 4),
                                      (1000, 16), (0, 3)])
def test_pad_to_multiple_matches_jax(nb, n_dev):
    assert pmesh.pad_to_multiple(nb, n_dev) == jmesh.pad_to_multiple(nb,
                                                                      n_dev)


@pytest.mark.parametrize("n_dev,repl,match", [(8, 0, "must be >= 1"),
                                              (6, 4, "must divide")])
def test_make_repl_mesh_validation(n_dev, repl, match):
    with pytest.raises(ValueError, match=match):
        pmesh.make_repl_mesh(n_dev, repl)
    with pytest.raises(ValueError, match=match):
        jmesh.make_repl_mesh(n_dev, repl)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        pmesh.make_mesh()


def test_backend_rules():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="backend='gloo'"):
        pmesh.check_backend("nccl", cpu, 2)
    with pytest.raises(ValueError, match="unknown backend"):
        pmesh.check_backend("mpi", cpu, 2)
    assert resolve_launch(4, None, "cpu") == ("gloo", "cpu")
    assert pmesh.default_backend(cpu) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_launch(2, None, None)


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """NCCL takes one card a rank: a world larger than the card count
    raises, naming the gloo transport for ranks that share a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card = torch.device("cuda", 0)
    pmesh.check_backend("nccl", card, 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        pmesh.check_backend("nccl", card, 4)
    pmesh.check_backend("gloo", card, 4)


@pytest.mark.parametrize("shape,names", [((4,), ("blocks",)),
                                         ((2, 2), ("blocks", "repl")),
                                         ((2, 2), ("arm", "blocks"))])
def test_grid_coordinates_and_lines(pool4, shape, names):
    """Rank r sits at the row-major position r, and each axis's line is
    the ranks that differ only along it, in coordinate order (the JAX
    mesh's device layout)."""
    got = pool4.run(JOBS, "grid", shape, names)
    grid = np.arange(4).reshape(shape)
    for r, g in enumerate(got):
        coords = np.unravel_index(r, shape)
        assert g["coords"] == tuple(int(c) for c in coords)
        for a, name in enumerate(names):
            idx = list(coords)
            idx[a] = slice(None)
            assert g["lines"][name] == tuple(int(v) for v in
                                             grid[tuple(idx)])
            assert g["index"][name] == coords[a]
        per = 8
        lo = coords[0] * per
        assert np.array_equal(g["share"].ravel(), np.arange(lo, lo + per))
        assert np.array_equal(g["fetched"].ravel(),
                              np.arange(8 * shape[0]))


def test_collectives_on_gloo(pool4):
    """Broadcast from the first rank, the rank-ordered reduction to it,
    the halo shift with zero chain ends, the fixed-slot all-to-all, the
    all-gather (bf16 moved as its bits) and the max, with their counts."""
    got = pool4.run(JOBS, "collectives")
    for r, g in enumerate(got):
        assert np.all(g["bcast"] == 1.0)
        assert np.all(g["prev"] == (r if r > 0 else 0.0))
        assert np.all(g["next"] == (-(r + 2) if r < 3 else 0.0))
        want = np.concatenate([np.arange(2 * r, 2 * r + 2) + 100 * s
                               for s in range(4)]).astype(np.float32)
        assert np.array_equal(g["a2a"].ravel(), want)
        assert np.array_equal(g["gather"][:, 0],
                              np.arange(1, 5, dtype=np.float32))
        assert g["max"] == 21
        assert g["world_line"] == (0, 1, 2, 3)
        st = g["stats"]
        assert st["broadcast"]["count"] == 1
        assert st["all-to-all"]["bytes"] == 3 * 2 * 4
        assert st["gather"]["bytes"] == 3 * 6 * 4 if r == 0 else 6 * 4
    parts = [np.float32(0.1) * np.float32(v) for v in (1, 2, 3, 4)]
    acc = parts[0]
    for p in parts[1:]:
        acc = np.float32(acc + p)
    assert got[0]["reduce"] is not None and got[1]["reduce"] is None
    assert np.all(got[0]["reduce"] == acc)


@pytest.mark.parametrize("shape,names,axis", [
    ((4,), ("rows",), "rows"), ((2, 2), ("rows", "repl"), "rows"),
    ((2, 2), ("rows", "repl"), "repl")])
def test_broadcast_from_every_root(pool4, shape, names, axis):
    """``broadcast(root=q)`` sends the value of the rank at position q of
    the line (the 1.5D round's grid row), for every q of a 4-rank line
    and of both axes of a (2, 2) grid; counted once a call."""
    got = pool4.run(JOBS, "broadcast_roots", shape, names, axis)
    for g in got:
        line = g["line"]
        assert len(g["got"]) == len(line)
        for q, vals in enumerate(g["got"]):
            assert np.all(vals == line[q] + 1.0), (line, q)
        assert g["stats"]["broadcast"]["count"] == len(line)
        assert g["stats"]["broadcast"]["bytes"] == len(line) * 6 * 4
        assert "is not a position" in g["refused"]


def test_a_failing_rank_ends_the_job():
    """A rank that raises makes the pool stop every rank and raise, at
    once, while its siblings wait in a collective."""
    pool = RankPool(3, device="cpu", timeout_s=60)
    tic = time.monotonic()
    with pytest.raises(RuntimeError, match="planted failure"):
        pool.run(JOBS, "fail_on", 1, job_timeout_s=120)
    assert time.monotonic() - tic < 60
    assert pool.closed
    assert not any(p.is_alive() for p in pool._procs)

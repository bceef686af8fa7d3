"""Serving and state on a mesh of gloo ranks: ``ArrowServer`` over
``ba_executor_factory(mesh=)`` rungs in lockstep (rank 0 decides), and
its ``grow`` from 2 ranks to 4 with staged checkpoint migration against
the JAX package's ``ArrowServer.grow`` at ``tools/reshard_gate.py``'s
constants."""

import os
import sys

import numpy as np
import pytest

from arrow_matrix_tpu.parallel.mesh import make_mesh as jax_mesh
from arrow_matrix_tpu.serve import loadgen as jax_loadgen
from arrow_matrix_tpu.serve.scheduler import ArrowServer as JaxServer
from arrow_matrix_tpu.serve.scheduler import ExecConfig as JaxConfig
from arrow_matrix_tpu.utils import checkpoint as jck
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.serve import (
    ArrowServer,
    ExecConfig,
    ba_executor_factory,
    run_trace,
    synthetic_trace,
)
from arrow_matrix_tpu_torch.tools import reshard_gate as gate
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    relative_error,
    relative_tolerance,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_state_jobs"
N, WIDTH, SEED = 256, 32, 5
TRACE = dict(tenants=3, requests=8, k=2, iterations=3, seed=9)


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, device="cpu", timeout_s=120) as pool:
        yield pool


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=120) as pool:
        yield pool


@pytest.fixture(scope="module")
def fold_results():
    """The single-device fold's results of the trace (the reference the
    mesh servers are held to)."""
    factory, n_rows = ba_executor_factory(N, WIDTH, SEED, device="cpu")
    server = ArrowServer(factory, ExecConfig(), name="fold")
    tickets = run_trace(server, synthetic_trace(n_rows, **TRACE))
    return {t.request.request_id: t.result for t in tickets}


def _tol(iterations):
    a = barabasi_albert(N, 3, seed=SEED)
    return relative_tolerance(a.nnz / N, iterations)


@pytest.mark.parametrize("ranks,max_batch_k,threaded", [
    (2, 0, False), (2, 8, False), (4, 0, False), (4, 8, False),
    (2, 8, True)])
def test_mesh_server_serves_in_lockstep(pool2, pool4, fold_results, ranks,
                                        max_batch_k, threaded):
    """Every request completes on every rank; the results are equal
    across ranks bit for bit and within the gate of the single-device
    fold; rank 0 alone leads; each rung's executor is built once on
    every rank; the ranks ran the same batches (also with each rank's
    worker thread serving, rank 0's heartbeat and last decision ending
    the others')."""
    pool = pool2 if ranks == 2 else pool4
    got = pool.run(JOBS, "mesh_serve", N, WIDTH, SEED, TRACE, None,
                   max_batch_k, threaded)
    tol = _tol(TRACE["iterations"])
    assert [r["leader"] for r in got] == [True] + [False] * (ranks - 1)
    assert all(r["lockstep"] for r in got)
    assert len({r["batches"] for r in got}) == 1
    if max_batch_k:
        assert got[0]["batches"] < TRACE["requests"]
    for r in got:
        assert set(r["status"]) == {"completed"}
        assert r["builds"] == {str(ExecConfig()): 1}
        for rid, res in r["results"].items():
            assert res.tobytes() == got[0]["results"][rid].tobytes()
            assert relative_error(res, fold_results[rid]) < tol


def _jax_grow(ck_dir):
    """The JAX package's ArrowServer.grow on the reshard gate's run
    (its npz checkpoint writer): results by request id."""
    import jax

    devs = jax.devices()
    mesh2 = jax_mesh((2,), ("blocks",), devices=np.asarray(devs[:2]))
    mesh4 = jax_mesh((4,), ("blocks",), devices=np.asarray(devs[:4]))
    fac2, n_rows = jax_loadgen.ba_executor_factory(gate.N, gate.WIDTH,
                                                   gate.SEED, fmt="auto",
                                                   mesh=mesh2)
    fac4, _ = jax_loadgen.ba_executor_factory(gate.N, gate.WIDTH, gate.SEED,
                                              fmt="auto", mesh=mesh4)
    trace = jax_loadgen.synthetic_trace(
        n_rows, tenants=gate.TENANTS, requests=gate.REQUESTS, k=gate.K,
        iterations=gate.ITERS, seed=gate.TRACE_SEED)
    ex2 = fac2(JaxConfig())
    for r in trace:
        x = ex2.set_features(r.x)
        for _ in range(2):
            x = ex2.step(x)
        jck.save_state(os.path.join(ck_dir, f"ck_{r.request_id}"),
                       np.asarray(x), 2,
                       layout=f"serve/{r.request_id}/k{r.k}/it{r.iterations}")
    server = JaxServer(fac2, JaxConfig(), name="reshard",
                       checkpoint_dir=ck_dir, checkpoint_every=2,
                       max_batch_k=0, grow_factory=fac4,
                       reshard_budget_bytes=gate.RUN_BUDGET)
    assert server.grow(reason="test")
    tickets = [server.submit(r) for r in trace]
    server.drain()
    assert [t.resumed_step for t in tickets] == [2] * gate.REQUESTS
    return {t.request.request_id: np.asarray(t.result) for t in tickets}


@pytest.mark.parametrize("via_pressure", [False, True])
def test_grow_two_ranks_to_four_like_jax(pool4, tmp_path, monkeypatch,
                                         via_pressure):
    """Step-2 checkpoints seeded on ranks (0, 1), the server grown to 4
    ranks (by ``grow()`` on every rank, or by rank 0's SLO pressure,
    which its next decision carries to every rank): every checkpoint
    migrated through staged plans (a second grow is a no-op), every
    request resumes at iteration 2 on every rank, the ranks' results are
    equal bit for bit and within the gate of the JAX package's grown
    server on the same trace."""
    monkeypatch.setattr(jck, "_orbax", lambda: None)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _jax_grow(str(tmp_path / "jax"))
    trace = dict(tenants=gate.TENANTS, requests=gate.REQUESTS, k=gate.K,
                 iterations=gate.ITERS, seed=gate.TRACE_SEED)
    got = pool4.run(JOBS, "mesh_grow", str(tmp_path / "port"), gate.N,
                    gate.WIDTH, gate.SEED, trace, gate.RUN_BUDGET,
                    via_pressure)
    a = barabasi_albert(gate.N, 3, seed=gate.SEED)
    tol = relative_tolerance(a.nnz / gate.N, gate.ITERS)
    assert [r["member"] for r in got] == [True, True, False, False]
    assert got[0]["migrated"] == gate.REQUESTS and got[0]["grows"] == 1
    for r in got:
        assert r["grown"] and r["resumed"] == [2] * gate.REQUESTS
        for rid, res in r["results"].items():
            assert res.tobytes() == got[0]["results"][rid].tobytes()
            assert relative_error(res, want[rid]) < tol

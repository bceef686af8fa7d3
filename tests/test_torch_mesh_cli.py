"""A mesh of ranks started by the port's entry points: ``graft_serve
--fmt ell`` over 2 gloo ranks killed mid-batch and rerun from its
checkpoints, and the ranks of a fleet job (``fleet/host.plan_host_mesh``
and ``fleet/worker.maybe_init_distributed``) joining one group."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from arrow_matrix_tpu_torch.fleet import host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CHILD = """
import os, sys
sys.path.insert(0, {repo!r})
from arrow_matrix_tpu_torch.fleet.worker import maybe_init_distributed
import torch.distributed as dist
joined = maybe_init_distributed(verbose=True, device="cpu")
t = __import__("torch").ones(1)
dist.all_reduce(t)
print("JOINED", joined, dist.get_world_size(), dist.get_rank(),
      os.environ.get("AMT_HOST_ID"), int(t.item()), flush=True)
dist.destroy_process_group()
"""


def test_plan_host_mesh_processes_join_one_group():
    """Each rank of ``plan_host_mesh(2, 1)`` joins one group through the
    ``AMT_FLEET_*`` env (gloo on the CPU), sees a world of 2 with its own
    host id, and an all-reduce over the group sums both ranks."""
    plan = host.plan_host_mesh(2, 1, port=_free_port())
    procs = []
    for env_extra in plan:
        env = dict(os.environ)
        env.update(env_extra)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-c", CHILD.format(repo=REPO)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (out, err) in enumerate(outs):
        assert f"JOINED True 2 {rank} host-{rank} 2" in out, (out, err)
        assert "over gloo on cpu" in out


def test_graft_serve_ell_kill_and_rerun(tmp_path):
    """``graft_serve --fmt ell --devices 2``: a run SIGKILLed mid-batch
    (every rank at its 12th step) exits non-zero; the rerun resumes its
    checkpoints and every result equals the fault-free run's bit for
    bit."""
    flags = ["--fmt", "ell", "--devices", "2", "--device", "cpu",
             "--backend", "gloo", "--vertices", "256", "--width", "32",
             "--requests", "6", "--tenants", "2", "--iterations", "4",
             "--features", "4"]
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("AMT_FAULT_PLAN", None)

    def run(extra, plan=None):
        e = dict(env)
        if plan is not None:
            e["AMT_FAULT_PLAN"] = json.dumps(plan)
        return subprocess.run(
            [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.graft_serve",
             *flags, *extra], cwd=str(tmp_path), env=e, capture_output=True,
            text=True, timeout=300)

    ck = str(tmp_path / "ck")
    ref = run(["--results_out", "ref.npz"])
    assert ref.returncode == 0, ref.stdout + ref.stderr
    killed = run(["--results_out", "out.npz", "--checkpoint", ck],
                 plan={"scenario": "kill", "site": "*.step", "after": 12})
    assert killed.returncode != 0
    assert not os.path.exists(tmp_path / "out.npz")
    rerun = run(["--results_out", "out.npz", "--checkpoint", ck])
    assert rerun.returncode == 0, rerun.stdout + rerun.stderr
    assert "resumed request" in rerun.stdout
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "out.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 6
        for rid in a.files:
            assert a[rid].tobytes() == b[rid].tobytes()

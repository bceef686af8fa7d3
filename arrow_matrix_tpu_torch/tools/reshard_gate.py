"""Reshard chaos gate of the port: a server grown from 2 ranks to 4
survives a kill in the middle of its checkpoint migration.

The port's counterpart of the JAX package's ``tools/reshard_gate.py``
``kill_mid_migration`` scenario, at its constants.  A run, a subprocess,
starts a world of 4 gloo ranks (``parallel/launch.spawn``; on the card
unless ``--device cpu``).  Ranks 0 and 1 form a 2-rank mesh
(``make_mesh(..., ranks=(0, 1))``) and seed one step-2 checkpoint per
request of the trace on its layout (requests without one only, so a
rerun keeps what a killed run left); then every rank builds an
``ArrowServer`` over the 2-rank rungs, grows it to the 4-rank mesh
(``ArrowServer.grow``: each checkpoint replayed through a staged plan
whose stages are at most ``RUN_BUDGET`` bytes) and serves the trace
to completion in lockstep, rank 0 deciding.

* Run A is fault-free: the bit-identity reference.
* Run B arms ``AMT_FAULT_PLAN`` with a kill on the ``reshard.stage``
  seam at hit ``KILL_AFTER``: rank 0 SIGKILLs itself mid-migration,
  after some checkpoints have migrated, and the launcher stops the job.
* Run C reruns run B's directory fault-free: grow migrates only the
  stragglers (1 <= migrated < all), every request resumes at iteration
  2 (the ``resumed request`` line), none is lost, and every f32 result
  equals run A's bit for bit.

The gate's other half, ``reshard_h7`` (the JAX gate's, at its
constants ``H7_N``, ``H7_NDEV``, ``H7_K``, ``H7_BUDGET``), holds the
bounded-scratch law H7 of the collective prover (``analysis/prove.py``):
the checked-in ``analysis/collective_manifest.json`` must hold two
reshard entries with H7 passing, one of them a replication change; then
on ``H7_NDEV`` gloo ranks every stage of a split route, observed through
the counted collective layer, passes ``check_h7``, and the one-shot
route (the planted violation) must exceed the budget.

Run::

    python -m arrow_matrix_tpu_torch.tools.reshard_gate [workdir] \\
        [--device cpu] [--fast]

(``--fast``: ``reshard_h7`` only.)
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

# The JAX gate's scale: small enough for a CPU run, large enough
# that the 2-rank -> 4-rank migration is staged at the tiny budget.
N, WIDTH, K = 96, 16, 2
TENANTS, REQUESTS, ITERS = 3, 6, 4
SEED, TRACE_SEED = 3, 7
#: Migration scratch budget: at K=2 f32 a row is 8 B, so a stage moves
#: at most 16 rows a rank; each 96-row checkpoint migrates in 2 stages.
RUN_BUDGET = 256
#: reshard.stage hits before rank 0 SIGKILLs itself: hit 9 is checkpoint
#: 5's second stage, inside a cutover, four checkpoints migrated.
KILL_AFTER = 9
#: The ranks of a run's world.
WORLD = 4

# The H7 scenario's scale (the JAX gate's).
H7_N, H7_NDEV, H7_K = 64, 4, 2
#: Small enough that the one-shot route's send+recv overflows it (the
#: planted violation) while every split stage stays within it.
H7_BUDGET = 256


def gate_rank(ctx, run_dir: str, results_npz: str) -> int:
    """One rank of a run (module docstring); returns 0, or 1 when
    a request was lost or did not resume at iteration 2."""
    from arrow_matrix_tpu_torch.parallel import collectives as coll
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.serve.loadgen import (
        ba_executor_factory,
        synthetic_trace,
    )
    from arrow_matrix_tpu_torch.serve.scheduler import (
        ArrowServer,
        ExecConfig,
    )
    from arrow_matrix_tpu_torch.utils.checkpoint import (
        list_checkpoints,
        save_state,
    )

    say = print if ctx.rank == 0 else (lambda *a, **k: None)
    ck_dir = os.path.join(run_dir, "checkpoints")
    os.makedirs(ck_dir, exist_ok=True)
    mesh2 = make_mesh((2,), ("blocks",), ranks=(0, 1))
    mesh4 = make_mesh((WORLD,), ("blocks",))
    fac2, n_rows = ba_executor_factory(N, WIDTH, SEED, fmt="auto",
                                       mesh=mesh2)
    fac4, _ = ba_executor_factory(N, WIDTH, SEED, fmt="auto", mesh=mesh4)
    trace = synthetic_trace(n_rows, tenants=TENANTS, requests=REQUESTS,
                            k=K, iterations=ITERS, seed=TRACE_SEED)
    # Seed a step-2 checkpoint on the 2-rank layout for each request that
    # has none: a rerun keeps the migrated files and the stragglers as
    # the killed run left them.  Rank 0 lists, every rank agrees.
    have = coll.broadcast_object(
        [os.path.basename(p) for p in list_checkpoints(ck_dir)]
        if ctx.rank == 0 else None)
    ex2 = fac2(ExecConfig())
    seeded = 0
    for r in trace:
        if f"ck_{r.request_id}" in have or not mesh2.member:
            continue
        x = ex2.set_features(r.x)
        for _ in range(2):
            x = ex2.step(x)
        save_state(os.path.join(ck_dir, f"ck_{r.request_id}"), x, 2,
                   layout=f"serve/{r.request_id}/k{r.k}/it{r.iterations}",
                   mesh=mesh2)
        seeded += 1
    coll.barrier()
    say(f"[reshard-run] seeded {seeded} step-2 checkpoint(s) on the "
        f"2-rank layout", flush=True)
    server = ArrowServer(fac2, ExecConfig(), name="reshard",
                         checkpoint_dir=ck_dir, checkpoint_every=2,
                         max_batch_k=0, grow_factory=fac4,
                         reshard_budget_bytes=RUN_BUDGET)
    # The staged cutover: an armed reshard.stage kill lands in here.
    if not server.grow(reason="gate"):
        say("[reshard-run] FAIL: grow refused", flush=True)
        return 1
    tickets = [server.submit(r) for r in trace]
    server.drain()
    lost = [t.request.request_id for t in tickets if t.result is None]
    if lost:
        say(f"[reshard-run] FAIL: lost accepted request(s) {lost}",
            flush=True)
        return 1
    not_resumed = [t.request.request_id for t in tickets
                   if t.resumed_step != 2]
    if not_resumed:
        say(f"[reshard-run] FAIL: request(s) {not_resumed} did not "
            f"resume from the migrated step-2 checkpoint", flush=True)
        return 1
    if ctx.rank == 0:
        np.savez(results_npz, **{t.request.request_id: t.result
                                 for t in tickets})
    say(f"[reshard-run] {len(tickets)} request(s) completed, all "
        f"resumed at iteration 2", flush=True)
    return 0


def gate_world(run_dir: str, results_npz: str, device=None) -> int:
    """A run's world: ``WORLD`` gloo ranks on ``device`` (the card
    unless "cpu")."""
    from arrow_matrix_tpu_torch.parallel.launch import spawn

    return max(spawn(gate_rank, WORLD, args=(run_dir, results_npz),
                     backend="gloo", device=device, timeout_s=120,
                     job_timeout_s=600, threads=1))


def _start_run(workdir: str, tag: str, device=None,
                  fault_plan=None):
    """One run's subprocess, started; ``tag`` names its run directory,
    so a rerun under the same tag resumes the earlier run's
    checkpoints."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("AMT_FAULT_PLAN", None)
    if fault_plan is not None:
        env["AMT_FAULT_PLAN"] = json.dumps(fault_plan)
    run_dir = os.path.join(workdir, f"reshard_{tag}")
    os.makedirs(run_dir, exist_ok=True)
    npz = os.path.join(run_dir, "results.npz")
    cmd = [sys.executable, "-m", "arrow_matrix_tpu_torch.tools.reshard_gate",
           "--run", run_dir, npz]
    if device is not None:
        cmd += ["--device", str(device)]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout_s: float = 600.0):
    """(exit code, stdout, stderr) of a run's subprocess."""
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def migrated_count(stdout: str):
    """(checkpoints migrated, plan stages) of the grow line."""
    m = re.search(r"grew to .*?: (\d+) checkpoint\(s\) migrated "
                  r"through (\d+) staged plan step\(s\)", stdout)
    return (int(m.group(1)), int(m.group(2))) if m else (None, None)


def scenario_kill_mid_migration(workdir: str, device=None) -> dict:
    """Runs A, B and C, one after the other; returns ``{"problems":
    [...], "migrated": (A, C), "stages": A's}``."""
    problems = []
    rc_a, out_a, err_a = _finish(_start_run(workdir, "ref", device))
    rc_b, _, _ = _finish(_start_run(
        workdir, "kill", device, fault_plan={"scenario": "kill",
                                             "site": "reshard.stage",
                                             "after": KILL_AFTER}))
    report = {"problems": problems, "migrated": [None, None],
              "stages": None}
    if rc_a != 0:
        problems.append(f"kill_mid_migration: the fault-free run failed "
                        f"(rc={rc_a}):\n{out_a[-2000:]}\n{err_a[-2000:]}")
        return report
    mig_a, stages_a = migrated_count(out_a)
    report["migrated"][0], report["stages"] = mig_a, stages_a
    if mig_a != REQUESTS:
        problems.append(f"kill_mid_migration: the reference grow migrated "
                        f"{mig_a} checkpoint(s), expected {REQUESTS}")
    if stages_a is not None and stages_a <= REQUESTS:
        problems.append(f"kill_mid_migration: the reference migration ran "
                        f"{stages_a} stage(s) for {REQUESTS} checkpoints: "
                        f"not staged, the kill cannot land inside one")
    if rc_b == 0:
        problems.append("kill_mid_migration: the armed run exited 0 — the "
                        "SIGKILL never fired on the reshard.stage seam")
    rc_c, out_c, err_c = _finish(_start_run(workdir, "kill", device))
    if rc_c != 0:
        problems.append(f"kill_mid_migration: the rerun failed "
                        f"(rc={rc_c}):\n{out_c[-2000:]}\n{err_c[-2000:]}")
        return report
    mig_c, _ = migrated_count(out_c)
    report["migrated"][1] = mig_c
    if mig_c is None or not 1 <= mig_c < REQUESTS:
        problems.append(f"kill_mid_migration: the rerun's grow migrated "
                        f"{mig_c} checkpoint(s); the kill should have left "
                        f"between 1 and {REQUESTS - 1} stragglers")
    if "resumed request" not in out_c:
        problems.append("kill_mid_migration: the rerun printed no "
                        "'resumed request' line — requests were "
                        "recomputed, not resumed")
    with np.load(os.path.join(workdir, "reshard_ref", "results.npz")) as a, \
            np.load(os.path.join(workdir, "reshard_kill",
                                 "results.npz")) as c:
        if sorted(a.files) != sorted(c.files):
            problems.append(f"kill_mid_migration: the rerun completed "
                            f"{sorted(c.files)}, the reference "
                            f"{sorted(a.files)}: lost request(s)")
        else:
            for rid in a.files:
                if a[rid].tobytes() != c[rid].tobytes():
                    problems.append(f"kill_mid_migration: the result of "
                                    f"{rid} differs from the fault-free "
                                    f"run's")
    return report


def h7_rank(ctx) -> dict:
    """One rank of ``reshard_h7``: the counted payload of the one-shot
    route and of each stage of its split, on this rank."""
    import torch

    from arrow_matrix_tpu_torch.analysis.prove import observe
    from arrow_matrix_tpu_torch.parallel import routing as routing_mod
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.reshard import (
        Layout,
        plan_route_table,
        redistribution_plan,
    )

    mesh = make_mesh((H7_NDEV,), ("blocks",))
    rng = np.random.default_rng(29)
    src = Layout(H7_N, n_dev=H7_NDEV, tag="gate_src")
    dst = Layout(H7_N, n_dev=H7_NDEV, tag="gate_dst")
    plan = redistribution_plan(src, dst, H7_BUDGET, k=H7_K,
                               perm_map=rng.permutation(H7_N)
                               .astype(np.int64))
    tbl, mask = plan_route_table(plan)
    route = routing_mod.build_route(tbl, H7_NDEV,
                                    src_total=src.stored_rows,
                                    pad_mask=mask)
    sroute = routing_mod.split_route_stages(route, H7_K, H7_BUDGET)
    rows = src.stored_rows // H7_NDEV
    d = mesh.axis_index("blocks")
    x_all = rng.standard_normal((src.stored_rows, H7_K)).astype(np.float32)
    x = torch.from_numpy(x_all[d * rows:(d + 1) * rows].copy()).to(
        mesh.device)

    def payload(rt):
        r = routing_mod.shard_route(rt, mesh, "blocks")
        return observe(lambda: routing_mod.routed_take(
            x, r, mesh, "blocks"))[1]["payload_bytes"]

    return {"one_shot": payload(route),
            "one_shot_bytes": route.device_bytes_per_exchange(H7_K, 4),
            "stages": [payload(st) for st in sroute.stages]}


def scenario_reshard_h7(device=None) -> list:
    """``reshard_h7`` (module docstring); returns its problems."""
    from arrow_matrix_tpu_torch.analysis.contracts import (
        CollectiveContract,
    )
    from arrow_matrix_tpu_torch.analysis.prove import (
        DEFAULT_MANIFEST,
        check_h7,
    )
    from arrow_matrix_tpu_torch.parallel.launch import spawn

    problems = []
    # 1) The proved H7 record the package ships.
    try:
        with open(DEFAULT_MANIFEST, encoding="utf-8") as fh:
            man = json.load(fh)
    except (OSError, ValueError) as e:
        man = {}
        problems.append(f"reshard_h7: no readable {DEFAULT_MANIFEST} "
                        f"({e}) — run `python -m arrow_matrix_tpu_torch."
                        f"analysis prove --device cpu`")
    passed = [e for e in man.get("entries", [])
              if e.get("entry", "").startswith("reshard[")
              and e.get("rules", {}).get("H7", {}).get("status") == "pass"]
    if man and len(passed) < 2:
        problems.append(f"reshard_h7: manifest has {len(passed)} reshard "
                        f"entr(ies) with H7 pass, need >= 2")
    if man and not any("repl" in e["entry"] for e in passed):
        problems.append("reshard_h7: no H7-passing reshard entry covers a "
                        "replication (repl c) change")

    # 2) Live: the split stages must pass, the one-shot route must fail
    #    the same checker (the planted violation).
    per_rank = spawn(h7_rank, H7_NDEV, backend="gloo", device=device,
                     timeout_s=120, job_timeout_s=300, threads=1)
    contract = CollectiveContract(
        algorithm="gate_shuffle",
        step_bytes=per_rank[0]["one_shot_bytes"],
        reduce_bytes=0, repl=1, overlap_slabs=1, dtype="f32",
        lowered_kinds=("all-to-all",), compiled_kinds=("all-to-all",),
        ratio_band=(0.99, 1.01), scratch_budget_bytes=H7_BUDGET)
    for r, res in enumerate(per_rank):
        staged = check_h7(res["stages"], contract)
        if staged["status"] != "pass":
            problems.append(f"reshard_h7: rank {r}: the split route failed "
                            f"the checker it was built to satisfy: "
                            f"{staged['detail']}")
        one_shot = check_h7([res["one_shot"]], contract)
        if one_shot["status"] != "fail":
            problems.append(f"reshard_h7: rank {r}: the one-shot route "
                            f"({res['one_shot']} B) did NOT trip H7 at "
                            f"budget {H7_BUDGET} B — the checker cannot "
                            f"see the memory cliff ({one_shot['detail']})")
        if len(res["stages"]) < 2:
            problems.append(f"reshard_h7: the split produced "
                            f"{len(res['stages'])} stage(s) — the gate "
                            f"scale no longer exercises staging")
    return problems


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if argv and argv[0] == "--run":
        return gate_world(argv[1], argv[2], device)
    fast = "--fast" in argv
    argv = [a for a in argv if a != "--fast"]
    problems = scenario_reshard_h7(device)
    print(f"reshard gate: reshard_h7 "
          f"{'ok' if not problems else 'FAILED'}")
    if not fast:
        workdir = argv[0] if argv else tempfile.mkdtemp(
            prefix="reshard_gate_")
        os.makedirs(workdir, exist_ok=True)
        report = scenario_kill_mid_migration(workdir, device)
        print(f"reshard gate: kill_mid_migration migrated "
              f"{report['migrated'][0]} (run A, {report['stages']} stages) "
              f"then {report['migrated'][1]} (run C) of {REQUESTS} "
              f"checkpoints")
        problems += report["problems"]
    if problems:
        print("RESHARD GATE: FAIL")
        for p in problems:
            print(f"  - {p}")
        return 1
    print("RESHARD GATE: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

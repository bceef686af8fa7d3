"""``chip_smoke.py`` stops every process it starts, and without a card it
exits non-zero and prints no result (both on the CPU)."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Run in a process of its own: it makes itself the reaper of its
# descendants' orphans and stops every process below it.
PROGRAM = r"""
import json, signal, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

# An exited child stays a zombie until it is reaped, whatever SIGCHLD
# disposition this process inherited.
signal.signal(signal.SIGCHLD, signal.SIG_DFL)
cs.adopt_orphans()
subprocess.run(["sh", "-c", "sleep 300 & exit 0"])          # an orphan
kept = [subprocess.Popen(["sh", "-c", "trap '' TERM; sleep 300"]),
        subprocess.Popen(["true"])]                         # never reaped
time.sleep(0.5)
before = cs.descendants()
stopped = cs.stop_descendants(grace_s=1.0)
print(json.dumps({"before": before, "stopped": stopped,
                  "after": cs.descendants()}))
"""


def test_stop_descendants_stops_orphans_and_reaps_the_exited():
    proc = subprocess.run([sys.executable, "-c", PROGRAM, REPO],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    states = sorted(state for _, state in rec["before"])
    # The orphan came to the script; the exited child is a zombie until
    # it is reaped.
    assert "Z" in states and states.count("S") >= 2, rec
    assert "sleep 300" in rec["stopped"], rec
    assert any("trap" in c for c in rec["stopped"]), rec
    assert rec["after"] == [], rec
    assert "still running at the end" in proc.stderr


def test_without_a_card_it_exits_non_zero_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# Phase 13's host goldens made by a process of their own over the graph
# phase 4's host saves equal, bit for bit, the ones computed in the
# script's own process over the decomposition's levels summed.
GOLDENS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import chip_smoke as cs
from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.utils import barabasi_albert

if __name__ == "__main__":
    n, base = 1 << 10, sys.argv[2] + "/ba"
    a = barabasi_albert(n, 8, seed=7)
    np.save(cs.graph_path(base, "indptr"), a.indptr)
    np.save(cs.graph_path(base, "indices"), a.indices)
    open(cs.graph_path(base, "ready"), "w").close()
    host = cs.start_host(cs.models_host, base, n, nice=19)
    levels = arrow_decomposition(a, 128, max_levels=10, block_diagonal=True,
                                 seed=7)
    mat = cs.host_matrix(levels, n)
    same = {"digest": cs.HostGolden(host, base, "digest").result()
            == cs.graph_digest(mat)}
    deg, ops = cs.model_operators(mat)
    inp = cs.model_inputs(n)
    x64, y64 = inp["x"].astype(np.float64), inp["y"].astype(np.float64)
    init = inp["init"]
    want = {("appnp", "sym"): cs.host_model(
                "appnp", ops["a_hat"], ops["a_hat_t"], x64, y64,
                init["appnp"]),
            ("gcn", "asym"): cs.host_model(
                "gcn", ops["a_rn"], ops["a_rn_t"], x64, y64, init["gcn"]),
            "gcn_a": cs.gcn_golden(ops["a"], inp["x"], inp["y"])}
    for key, w in want.items():
        got = cs.HostGolden(host, base, key).result()[0]
        same[str(key)] = bool(
            np.array_equal(got["logits"], w["logits"])
            and all(np.array_equal(p, q)
                    for g, h in zip(got["grads"], w["grads"])
                    for p, q in zip(g, h)))
    for key, op, kw in (
            ("conjugate_gradient", "a",
             dict(b=inp["b"], shift=float(deg.max()) + 1.0)),
            ("pagerank", "a_cn", dict(damping=0.85))):
        got = cs.HostGolden(host, base, key).result()[0]
        same[key] = bool(np.array_equal(
            got, cs.host_solvers(key, ops[op], **kw)))
    done = cs.join_host(*host, "models_host")
    print(json.dumps({"same": same, "keys": sorted(done["seconds"])}))
"""


def test_models_host_goldens_equal_the_in_process_ones(tmp_path):
    script = tmp_path / "goldens.py"
    script.write_text(GOLDENS)
    proc = subprocess.run([sys.executable, str(script), REPO, str(tmp_path)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(rec["same"].values()), rec
    assert len(rec["keys"]) == 9, rec


TRACE = r"""
import json, subprocess, sys, threading, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs

threading.Thread(target=cs.cpu_trace, args=(sys.argv[2], 0.5),
                 daemon=True).start()
spin = subprocess.Popen([sys.executable, "-c",
                         "import time\nt = time.time()\n"
                         "while time.time() - t < 3: pass"])
spin.wait()
time.sleep(0.7)
print(spin.pid)
"""


def test_cpu_trace_names_each_process_and_its_cores(tmp_path):
    path = tmp_path / "trace.jsonl"
    proc = subprocess.run([sys.executable, "-c", TRACE, REPO, str(path)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pid = proc.stdout.strip().splitlines()[-1]
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert any(pid in r.get("new", {}) for r in recs), recs
    busy = [r["procs"].get(pid, 0.0) for r in recs]
    # A process spinning on one core reads as about one core busy.
    assert 0.5 < max(busy) <= 1.2, busy
    assert all(r["run_cores"] >= r["procs"].get(pid, 0.0) for r in recs)

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

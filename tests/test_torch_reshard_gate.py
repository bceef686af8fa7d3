"""The port's reshard gate (``arrow_matrix_tpu_torch/tools/
reshard_gate.py``) as a test: a server grown from 2 gloo ranks to 4 is
killed in the middle of its checkpoint migration, and the rerun migrates
only the stragglers, resumes every request and equals the fault-free
run bit for bit."""

from arrow_matrix_tpu_torch.tools import reshard_gate as gate


def test_reshard_gate_kill_mid_migration(tmp_path):
    """The port's reshard gate on 4 CPU ranks: run C migrates only the
    stragglers of run B's kill, and every result equals run A's."""
    report = gate.scenario_kill_mid_migration(str(tmp_path), device="cpu")
    assert report["problems"] == []
    mig_a, mig_c = report["migrated"]
    assert mig_a == gate.REQUESTS and 1 <= mig_c < gate.REQUESTS
    assert report["stages"] > gate.REQUESTS

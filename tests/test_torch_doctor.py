"""``amt_doctor_torch`` (``arrow_matrix_tpu_torch/cli/doctor.py``): it
has every core probe of the JAX package's doctor but the two tunnel
probes, which it names; on the CPU it exits 0 with ``--device cpu``
and names the missing card."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DOCTOR = os.path.join(REPO, "arrow_matrix_tpu", "cli", "doctor.py")

#: The reference's probes, by the port's name for them.
PORT_NAME = {"probe_accelerator": "probe_card",
             "probe_cpu_pool": "probe_rank_pool",
             "probe_gloo": "probe_collectives"}
#: TPU-tunnel code on ROADMAP.md's not-to-port list.
TUNNEL = {"probe_tunnel_infra", "report_holders_and_registry"}


def _jax_probes():
    tree = ast.parse(open(JAX_DOCTOR, encoding="utf-8").read())
    return [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and (n.name.startswith("probe_") or n.name in TUNNEL)]


def test_every_core_probe_of_the_jax_doctor_is_ported():
    from arrow_matrix_tpu_torch.cli import doctor

    subprocess_probes = {name for name, _ in doctor.PROBES}
    missing = []
    for name in _jax_probes():
        if name in TUNNEL:
            continue
        ours = PORT_NAME.get(name, name)
        short = ours[len("probe_"):]
        if not (hasattr(doctor, ours) or short in subprocess_probes):
            missing.append(name)
    assert missing == []
    assert len(subprocess_probes) == 14
    for name in subprocess_probes:
        assert callable(getattr(doctor, f"_sub_{name}"))


def test_doctor_on_the_cpu_exits_0_and_names_the_missing_card(
        monkeypatch, capsys):
    """The whole report in process, its round trips cut to two: the
    fourteen take about 190 s here (``chip_smoke.py`` phase 24 runs
    them all, on the card)."""
    import torch

    from arrow_matrix_tpu_torch.cli import doctor

    monkeypatch.setattr(doctor, "PROBES", tuple(
        p for p in doctor.PROBES if p[0] in ("serve", "ledger")))
    rc = doctor.main(["--device", "cpu", "--probe-timeout", "30"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "core checks passed" in out
    if not torch.cuda.is_available():
        assert "[warn] card (CUDA device 0, bounded probe): no card" in out
    for name in TUNNEL:
        assert name in out
    for label in ("rank pool (4 gloo ranks on cpu)", "graft-lint",
                  "graft-prove", "graft-serve", "graft-ledger"):
        assert f"[ok  ] {label}" in out, out


@pytest.mark.parametrize("name", ["kcert", "synth"])
def test_a_subprocess_probe_reports_ok(name):
    from arrow_matrix_tpu_torch.cli import doctor

    ok, detail = doctor.run_probe(name, "cpu", timeout_s=180)
    assert ok, detail


def test_a_failing_probe_is_a_fail_line(monkeypatch, capsys):
    from arrow_matrix_tpu_torch.cli import doctor

    def broken(dev):
        raise RuntimeError("planted")

    monkeypatch.setattr(doctor, "_sub_serve", broken)
    assert doctor.child_probe("serve", "cpu") == 0
    assert capsys.readouterr().out.strip() == \
        "PROBE FAIL RuntimeError: planted"

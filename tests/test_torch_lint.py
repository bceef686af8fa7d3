"""The port's graft-lint (``arrow_matrix_tpu_torch/analysis/core.py``,
``rules.py``) and its second-call audit (``analysis/audit.py``).

* R8 and R9 give the same (line, rule) findings as the JAX linter on the
  same snippets (R9 over per-iteration loops, where both packages agree
  on what a hot path is).
* Every other rule, restated for torch, fires on a positive snippet and
  stays quiet on its negative twin; waivers and ``--select`` work.
* The port's own tree lints clean (its waivers are counted).
* The audit's four entry points load, build and keep nothing on the
  second call, and the fresh audit does not drift from the checked-in
  ``analysis/compile_manifest.json``.
"""

import json
import textwrap

import pytest
import torch

from arrow_matrix_tpu.analysis.core import lint_source as jlint
from arrow_matrix_tpu_torch.analysis import audit
from arrow_matrix_tpu_torch.analysis.__main__ import main as amain
from arrow_matrix_tpu_torch.analysis.core import (
    findings_to_json,
    lint_paths,
    lint_source,
    rule_table,
)
from arrow_matrix_tpu_torch.parallel.launch import RankPool

torch.set_num_threads(2)


def _src(text):
    return textwrap.dedent(text).lstrip("\n")


def _hits(source, rule=None):
    found, _ = lint_source(_src(source), select=[rule] if rule else None)
    return [(f.line, f.rule) for f in found]


# -- R8 / R9 parity with the JAX linter ---------------------------------------

PARITY = {
    "R8 bare pass": """
        def f():
            try:
                g()
            except Exception:
                pass
        """,
    "R8 tuple with continue": """
        for x in xs:
            try:
                g(x)
            except (ValueError, BaseException):
                continue
        """,
    "R8 bare except ellipsis": """
        try:
            g()
        except:
            ...
        """,
    "R8 narrow is fine": """
        try:
            g()
        except KeyError:
            pass
        """,
    "R8 broad but handled": """
        try:
            g()
        except Exception as e:
            log(e)
        """,
    "R8 waived": """
        try:
            g()
        except Exception:  # graft-lint: disable=R8 — telemetry
            pass
        """,
    "R9 loop read": """
        import os
        def run(n):
            for _ in range(n):
                k = os.environ.get("AMT_CHUNK")
        """,
    "R9 getenv and subscript in while": """
        import os
        def run(n):
            while n:
                a = os.getenv("AMT_A")
                b = os.environ["AMT_B"]
                n -= 1
        """,
    "R9 build-time read is fine": """
        import os
        CHUNK = os.environ.get("AMT_CHUNK")
        def run(n):
            k = os.environ.get("AMT_CHUNK")
            for _ in range(n):
                pass
        """,
    "R9 other prefix is fine": """
        import os
        def run(n):
            for _ in range(n):
                os.environ.get("HOME")
        """,
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_r8_r9_match_the_jax_linter(name):
    src = _src(PARITY[name])
    ours, _ = lint_source(src, select=["R8", "R9"])
    theirs, _ = jlint(src, select=["R8", "R9"])
    assert [(f.line, f.rule) for f in ours] == \
        [(f.line, f.rule) for f in theirs]


def test_parity_cases_cover_findings():
    fired = {name for name, src in PARITY.items()
             if lint_source(_src(src), select=["R8", "R9"])[0]}
    assert {"R8 bare pass", "R9 loop read",
            "R9 getenv and subscript in while"} <= fired


# -- every other rule: a positive and a negative case --------------------------

CASES = {
    "R1": ("""
        import torch
        def step(x):
            return float(x.sum()) + x.cpu().numpy()[0] + x.item()
        g = torch.cuda.make_graphed_callables(step, (x,))
        """, """
        import torch
        def step(x):
            return x * x.size(0) + len(x.shape)
        g = torch.cuda.make_graphed_callables(step, (x,))
        def build(x):
            return float(x.sum())
        """),
    "R2": ("""
        import torch
        from arrow_matrix_tpu_torch.ops.worklist import build_worklist
        def run(fn, xs):
            for x in xs:
                wl = build_worklist(shapes, starts, 16, 4)
                y = torch.compile(fn)(x)
        """, """
        import torch
        from arrow_matrix_tpu_torch.ops.worklist import build_worklist
        wl = build_worklist(shapes, starts, 16, 4)
        fast = torch.compile(fn)
        def run(xs):
            for x in xs:
                y = fast(x)
        """),
    "R3": ("""
        def run(exe, x, n):
            kept = []
            for _ in range(n):
                kept.append(x)
                x = exe.step(x)
            return x, kept
        """, """
        def run(exe, x, n):
            norms = []
            for _ in range(n):
                x = exe.step(x)
                norms.append(float(x.norm()))
            return x, norms
        """),
    "R4": ("""
        from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh((2, 2), ("rows", "repl"))
        line = mesh.line("rowz")
        """, """
        from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh((2, 2), ("rows", "repl"))
        line = mesh.line("rows")
        g = mesh.group("blocks")
        """),
    "R5": ("""
        import torch
        def step(x):
            return x * 0.5
        g = torch.cuda.make_graphed_callables(step, (x,))
        """, """
        import torch
        def step(x):
            return x * torch.tensor(0.5, dtype=x.dtype)
        g = torch.cuda.make_graphed_callables(step, (x,))
        def build(x):
            return x * 0.5
        """),
    "R6": ("""
        import torch
        def fetch(x):
            y = x.to("cuda")
            z = y * 2
            return z.cpu()
        """, """
        import torch
        def fetch(x):
            y = x.to("cuda")
            z = torch.zeros(3)
            return z.cpu()
        """),
    "R7": ("""
        import time, torch
        def bench(g):
            t0 = time.perf_counter()
            g.replay()
            return time.perf_counter() - t0
        """, """
        import time, torch
        def bench(g):
            t0 = time.perf_counter()
            g.replay()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        """),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_fires_on_its_positive_case(rule):
    positive, _ = CASES[rule]
    assert any(r == rule for _, r in _hits(positive, rule))


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_quiet_on_its_negative_case(rule):
    _, negative = CASES[rule]
    assert _hits(negative, rule) == []


def test_capture_block_body_is_a_hot_scope():
    src = """
        import torch
        def helper(x):
            return x.item()
        with torch.cuda.graph(g):
            y = helper(x)
            z = x.cpu()
        """
    lines = [line for line, _ in _hits(src, "R1")]
    assert 3 in lines and 6 in lines


def test_step_fn_keyword_marks_a_hot_scope():
    src = """
        def my_step(x):
            return x.tolist()
        run_chain(step_fn=my_step)
        """
    assert _hits(src, "R1") == [(2, "R1")]


def test_waivers_and_select():
    src = """
        try:
            g()
        except Exception:  # graft-lint: disable=R8 — telemetry
            pass
        """
    found, waived = lint_source(_src(src))
    assert found == [] and [w.rule for w in waived] == ["R8"]
    filewide = "# graft-lint: disable-file=R8\n" + _src(PARITY["R8 bare pass"])
    assert lint_source(filewide)[0] == []
    out = json.loads(findings_to_json(*lint_source(
        _src(PARITY["R8 bare pass"]))))
    assert out["count"] == 1 and out["findings"][0]["rule"] == "R8"


def test_rule_table_lists_r1_to_r9(capsys):
    assert [s.rule_id for s in rule_table()] == \
        [f"R{i}" for i in range(1, 10)]
    assert amain(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(f"R{i} " in out for i in range(1, 10))


def test_the_port_lints_clean(capsys):
    import arrow_matrix_tpu_torch
    import os

    pkg = os.path.dirname(arrow_matrix_tpu_torch.__file__)
    findings, waived = lint_paths([pkg])
    assert findings == []
    # Each waiver names its reason inline (CHANGES.md counts them).
    assert sorted(w.rule for w in waived) == ["R2"] * 4 + ["R8"] * 8
    assert amain(["lint", "-q"]) == 0
    assert amain(["lint", "--json", pkg]) == 0
    assert json.loads(capsys.readouterr().out)["count"] == 0


# -- the audit -----------------------------------------------------------------

@pytest.fixture(scope="module")
def audited():
    pool = RankPool(4, backend="gloo", device="cpu", threads=1)
    try:
        yield audit.run_audit(device="cpu", write=False, pool=pool)
    finally:
        pool.close()


def test_audit_second_call_builds_and_keeps_nothing(audited):
    names = [e["entry"] for e in audited["entries"]]
    assert names == ["spmm_1d.MatrixSlice1D", "spmm_15d.SpMM15D",
                     "sell_slim.SellSlim", "multi_level.MultiLevelArrow"]
    for e in audited["entries"]:
        assert e["ok"], e
        for second in e["per_rank_second_call"]:
            assert not any(second["builds"].values())
            assert second["resident_bytes"] == 0
        assert e["second_call"]["launches"] == e["first_call"]["launches"]
    assert audited["ok"]


def test_audit_matches_the_checked_in_manifest(audited):
    with open(audit.DEFAULT_MANIFEST, encoding="utf-8") as fh:
        checked_in = json.load(fh)
    assert audit.manifest_drift(checked_in, audited) == []


def test_audit_sees_a_build_and_a_resident_tensor():
    from arrow_matrix_tpu_torch.utils import buildstats

    cache = []

    def leaky():
        buildstats.bump("plans")
        cache.append(torch.ones(64))
        return torch.ones(4)

    rec = audit.audit_entry("leaky", leaky, "cpu")
    assert not rec["ok"]
    assert rec["second_call"]["builds"]["plans"] == 1
    assert rec["second_call"]["resident_bytes"] == 256
    clean = audit.audit_entry("clean", lambda: torch.ones(4) * 2, "cpu")
    assert clean["ok"]

"""The port's ``parallel/reshard.py`` against the JAX package's: over a
grid of layouts, permutations and budgets the plans are equal field by
field (local copies, zero-fills, every stage's chunks, the describe()
text, the scratch accounting), ``apply_plan_host`` and
``handoff_plan`` give the same bits, the route tables and layout tags
are equal, the refusals carry the same messages, and the port's
``reshard_checkpoint`` migrates its own npz checkpoints (f32 and bf16)
bit for bit, with the ``reshard.stage`` fault seam leaving the source
intact."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arrow_matrix_tpu import faults as jfaults
from arrow_matrix_tpu.parallel import reshard as jr
from arrow_matrix_tpu_torch import faults as pfaults
from arrow_matrix_tpu_torch.parallel import reshard as pr
from arrow_matrix_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    jfaults.clear_plan()
    pfaults.clear_plan()
    yield
    jfaults.clear_plan()
    pfaults.clear_plan()


def _fields(plan):
    """A plan as plain tuples, so the two packages' dataclasses
    compare field by field."""
    chunks = lambda cs: tuple(dataclasses.astuple(c) for c in cs)  # noqa: E731
    return {"src": dataclasses.astuple(plan.src),
            "dst": dataclasses.astuple(plan.dst),
            "k": plan.k, "itemsize": plan.itemsize,
            "budget": plan.scratch_budget_bytes,
            "local": chunks(plan.local_ops),
            "fill": chunks(plan.fill_ops),
            "stages": tuple(chunks(st) for st in plan.stages),
            "stage_bytes": [plan.stage_device_bytes(i)
                            for i in range(plan.n_stages)],
            "max_scratch": plan.max_stage_scratch_bytes,
            "moved": plan.moved_bytes, "noop": plan.is_noop,
            "describe": plan.describe()}


#: (src (rows, n_dev, repl), dst (rows, n_dev, repl), k, itemsize,
#: budget, permutation): shards that divide and do not, replica growth
#: and shrink, grown padding (zero-fill), budgets from one row to all.
GRID = [
    ((64, 4, 1), (64, 4, 1), 2, 4, 1 << 20, None),
    ((64, 2, 1), (64, 4, 1), 2, 4, 16, None),
    ((96, 2, 1), (96, 4, 1), 1, 4, 56, "perm"),
    ((96, 2, 1), (96, 4, 1), 1, 4, 256, "perm"),
    ((128, 4, 1), (128, 4, 2), 4, 4, 640, "perm"),
    ((32, 4, 1), (32, 4, 2), 2, 4, 1 << 16, None),
    ((64, 4, 2), (64, 2, 1), 3, 2, 48, None),
    ((60, 3, 1), (72, 4, 1), 2, 4, 64, "grow"),
    ((60, 3, 1), (72, 6, 2), 5, 2, 120, "grow"),
    ((48, 1, 1), (48, 8, 1), 8, 4, 1 << 10, "perm"),
    ((100, 4, 1), (100, 5, 1), 1, 4, 8, "perm"),
]


def _perm(src, dst, how, seed):
    rng = np.random.default_rng(seed)
    if how == "perm":
        return rng.permutation(dst[0]).astype(np.int64)
    if how == "grow":
        # dst rows beyond the source's logical rows are padding (-1).
        perm = np.full(dst[0], -1, dtype=np.int64)
        perm[:src[0]] = rng.permutation(src[0])
        return perm
    return None


@pytest.mark.parametrize("case", range(len(GRID)))
def test_redistribution_plans_equal_jax_field_by_field(case):
    (s, d, k, item, budget, how) = GRID[case]
    perm = _perm(s, d, how, case)
    plans = []
    for mod in (jr, pr):
        src = mod.Layout(s[0], n_dev=s[1], repl=s[2], tag="src")
        dst = mod.Layout(d[0], n_dev=d[1], repl=d[2], tag="dst")
        plans.append(mod.redistribution_plan(src, dst, budget, k,
                                             itemsize=item,
                                             perm_map=perm))
        np.testing.assert_array_equal(
            mod.default_table(src, dst, perm),
            jr.default_table(jr.Layout(*s), jr.Layout(*d), perm))
    want, got = (_fields(p) for p in plans)
    assert got == want
    assert got["max_scratch"] <= budget
    # Same bits through both executors, and the same route tables.
    dtype = np.float32 if item == 4 else np.float16
    x = np.random.default_rng(case).standard_normal(
        (plans[0].src.stored_rows, k)).astype(dtype)
    y_port = pr.apply_plan_host(plans[1], x)
    assert y_port.tobytes() == jr.apply_plan_host(plans[0], x).tobytes()
    for a, b in zip(pr.plan_route_table(plans[1]),
                    jr.plan_route_table(plans[0])):
        np.testing.assert_array_equal(a, b)
    table, mask = pr.plan_route_table(plans[1])
    want_y = np.where(mask[:, None], 0, x[np.where(mask, 0, table)])
    assert y_port.tobytes() == want_y.astype(dtype).tobytes()


@pytest.mark.parametrize("rows,k,budget,item", [
    (100, 2, 64, 4), (37, 3, 128, 4), (1, 1, 4, 4), (4096, 16, 1 << 16, 4),
    (1000, 128, 1 << 20, 2), (513, 7, 29 * 28, 4)])
def test_handoff_plans_equal_jax_and_carry_the_same_bits(rows, k, budget,
                                                         item):
    a = jr.handoff_plan(rows, k, budget, itemsize=item, src_tag="w0",
                        dst_tag="w1")
    b = pr.handoff_plan(rows, k, budget, itemsize=item, src_tag="w0",
                        dst_tag="w1")
    assert _fields(b) == _fields(a)
    assert b.max_stage_scratch_bytes <= budget
    x = np.random.default_rng(rows).standard_normal((rows, k)).astype(
        np.float32 if item == 4 else np.float16)
    y = pr.apply_plan_host(b, x)
    assert y.tobytes() == jr.apply_plan_host(a, x).tobytes() \
        == x.tobytes()


def test_refusals_carry_the_jax_messages():
    for mod in (jr, pr):
        with pytest.raises(ValueError, match="budget"):
            mod.redistribution_plan(mod.Layout(64, n_dev=2),
                                    mod.Layout(64, n_dev=4), 15, k=2)
        with pytest.raises(ValueError, match="row"):
            mod.handoff_plan(64, 2, 7)
        with pytest.raises(ValueError, match="not divisible"):
            mod.Layout(10, n_dev=3)
        with pytest.raises(ValueError, match="degenerate"):
            mod.Layout(0)
        with pytest.raises(ValueError, match="perm_map"):
            mod.default_table(mod.Layout(8), mod.Layout(8),
                              np.arange(4))
        with pytest.raises(ValueError, match="carriage has"):
            mod.apply_plan_host(mod.handoff_plan(8, 1, 64),
                                np.zeros((9, 1), np.float32))


@pytest.mark.parametrize("layout", [(64, 2, 1), (64, 4, 1), (64, 4, 2),
                                    (1 << 20, 1, 1), (96, 8, 3)])
def test_layout_tags_equal_jax(layout):
    rows, n_dev, repl = layout
    assert pr.layout_tag("serve/r0001", pr.Layout(rows, n_dev, repl)) == \
        jr.layout_tag("serve/r0001", jr.Layout(rows, n_dev, repl))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reshard_checkpoint_migrates_the_ports_checkpoint(tmp_path, dtype):
    src_l = pr.Layout(96, n_dev=2, tag=pr.layout_tag("t", pr.Layout(96, 2)))
    dst_l = pr.Layout(96, n_dev=4, repl=2,
                      tag=pr.layout_tag("t", pr.Layout(96, 4, 2)))
    plan = pr.redistribution_plan(src_l, dst_l, 96, k=3,
                                  itemsize=torch.tensor(
                                      [], dtype=dtype).element_size())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (96, 3)).astype(np.float32)).to(dtype)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    ck.save_state(src, x, 7, layout=src_l.tag)
    y, step = pr.reshard_checkpoint(src, dst, plan)
    assert step == 7
    want = jr.apply_plan_host(jr.redistribution_plan(
        jr.Layout(96, 2), jr.Layout(96, 4, 2), 96, 3,
        itemsize=plan.itemsize), pr.host_rows(x))
    assert y.tobytes() == want.tobytes()
    back, step = ck.load_state(dst, layout=dst_l.tag)
    assert step == 7 and back.dtype == dtype
    assert pr.host_rows(back).tobytes() == want.tobytes()
    assert ck.checkpoint_layout_tag(dst) == dst_l.tag
    assert pr.reshard_checkpoint(str(tmp_path / "none"), dst, plan) is None


def test_reshard_stage_fault_leaves_the_source_intact(tmp_path):
    src_l, dst_l = pr.Layout(64, n_dev=2), pr.Layout(64, n_dev=4)
    plan = pr.redistribution_plan(src_l, dst_l, 64, k=2)
    assert plan.n_stages >= 2
    x = torch.arange(128, dtype=torch.float32).reshape(64, 2)
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    ck.save_state(src, x, 3)
    before = open(src + ".npz", "rb").read()
    pfaults.set_plan({"scenario": "error", "site": "reshard.stage",
                      "target": "1"})
    with pytest.raises(pfaults.FaultInjected):
        pr.reshard_checkpoint(src, dst, plan)
    assert not os.path.exists(dst + ".npz")
    assert open(src + ".npz", "rb").read() == before
    pfaults.clear_plan()
    y, _ = pr.reshard_checkpoint(src, dst, plan)
    assert y.tobytes() == pr.apply_plan_host(plan, x.numpy()).tobytes()

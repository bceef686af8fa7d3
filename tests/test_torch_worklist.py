"""K1's work list (``ops/worklist.py``) and its plain twin.

The work list must cover every (tier, row, slot) of an operator exactly
once, split a long row's chunks across CTAs in order, and start with
the hub tiers: checked at the two real ladders of the fold of BA
n = 2^20 and at small ragged ones.  The twin, which adds the chunk sums
in the kernel's order, is held against the JAX package (XLA
``sell_spmm_t`` and the Pallas kernel in interpret mode) on the same
numpy inputs.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import arrow_matrix_tpu_torch
from arrow_matrix_tpu.ops import pallas_sell as jps
from arrow_matrix_tpu.ops import sell as jsell
from arrow_matrix_tpu_torch.ops import cuda_sell, ell, sell, worklist
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)

SRC = (Path(arrow_matrix_tpu_torch.__file__).parent / "csrc"
       / "sell_tier_spmm.cu").read_text()

# The tier ladders (m_t, n_t) of the fold of BA n = 2^20, m = 8, seed 7
# at width 2048 (``chip_smoke.py`` phase 4 logs them): the default
# packing (growth 1.2, align 8) and the tight one (growth 1.1, align 1).
LADDER = [
    (8, 209781), (16, 592386), (24, 130095), (32, 49099), (48, 36334),
    (64, 13182), (80, 6202), (104, 4683), (128, 2275), (160, 1610),
    (200, 1036), (248, 646), (304, 420), (368, 264), (448, 191),
    (544, 126), (656, 70), (792, 52), (960, 34), (1136, 23), (1392, 18),
    (1696, 17), (2064, 10), (2480, 12), (2944, 5), (3504, 1), (4576, 3),
    (5792, 1)]
LADDER_TIGHT = [
    (8, 209781), (9, 152769), (11, 202126), (13, 124509), (15, 82102),
    (17, 56866), (19, 40837), (22, 42763), (25, 29178), (28, 20707),
    (31, 15411), (35, 15007), (39, 10511), (44, 9480), (49, 6812),
    (55, 5937), (61, 4356), (68, 3645), (75, 2780), (83, 2306),
    (92, 1948), (102, 1641), (113, 1316), (125, 1018), (138, 887),
    (152, 670), (168, 564), (185, 451), (204, 371), (225, 318),
    (248, 262), (273, 212), (301, 193), (332, 156), (366, 120),
    (403, 101), (444, 85), (489, 62), (540, 69), (596, 36), (657, 38),
    (721, 27), (800, 30), (882, 19), (974, 13), (1063, 15), (1182, 7),
    (1297, 7), (1432, 10), (1560, 10), (1743, 8), (1890, 3), (2100, 6),
    (2205, 6), (2522, 5), (2648, 2), (2942, 2), (3498, 1), (4573, 3),
    (5787, 1)]

# Small ragged ladders: zero-slot tiers (with and without rows), a tier
# with no rows, short and hub rows, a 6,000-slot hub row.
RAGGED = [(0, 5), (3, 7), (8, 300), (70, 40), (700, 9), (6000, 1), (0, 0)]
ZEROS = [(0, 10), (0, 0), (5, 0), (0, 3)]


def _starts(shapes):
    return [int(s) for s in np.cumsum([0] + [n for _, n in shapes[:-1]])]


def _tasks(wl) -> dict:
    """Every thread group's task, decoded from the items as the kernel
    decodes them: arrays ``item``, ``group``, ``tier``, ``row``
    (tier-local), ``chunk``, ``lo``/``hi`` (its slots ``[lo, hi)``,
    clipped to m_t) and ``part`` (the workspace row of the group's
    block sum, -1 when the group's row is written directly).  Groups
    with no task are left out."""
    p = wl.groups
    it = wl.items.astype(np.int64)
    n = len(it)
    item = np.repeat(np.arange(n), p)
    g = np.tile(np.arange(p), n)
    tier, row0, chunk0, part = (np.repeat(it[:, i], p) for i in range(4))
    _, m_t, n_t, length, s = (wl.tiers[tier, i] for i in range(5))
    direct = part < 0
    safe_s = np.maximum(s, 1)
    cps = np.where(direct, s, np.minimum(p, s - chunk0))
    rows_here = np.where(direct, p // safe_s, 1)
    local = np.where(direct, g // safe_s, 0)
    chunk = np.where(direct, g % safe_s, chunk0 + g)
    row = row0 + local
    live = (local < rows_here) & (row < n_t) & ((chunk - np.where(
        direct, 0, chunk0)) < cps)
    lo = np.minimum(chunk * length, m_t)
    hi = np.minimum(lo + length, m_t)
    part = np.where(direct, -1, part + g // worklist.CHUNK_BLOCK)
    pick = lambda a: a[live]
    return {"item": pick(item), "group": pick(g), "tier": pick(tier),
            "row": pick(row), "chunk": pick(chunk), "lo": pick(lo),
            "hi": pick(hi), "part": pick(part)}


def _check_cover(wl, shapes):
    """Every (tier, row) of the ladder is covered by tasks whose chunks
    run 0, 1, ... S - 1 over contiguous, non-empty slot ranges from 0
    to m_t (one empty task for a zero-slot row), each exactly once; a
    split row's items come in chunk order, their blocks of CHUNK_BLOCK
    chunks on consecutive partials, as the rows table says."""
    t = _tasks(wl)
    m_t = np.array([m for m, _ in shapes], np.int64)
    n_t = np.array([n for _, n in shapes], np.int64)
    order = np.lexsort((t["chunk"], t["row"], t["tier"]))
    tier, row, chunk = t["tier"][order], t["row"][order], t["chunk"][order]
    lo, hi = t["lo"][order], t["hi"][order]
    key = tier * (1 << 32) + row
    first = np.r_[True, key[1:] != key[:-1]]
    last = np.r_[key[1:] != key[:-1], True]
    assert first.sum() == n_t.sum()                 # every row, once
    assert (row < n_t[tier]).all()
    assert (chunk[first] == 0).all() and (lo[first] == 0).all()
    assert (hi[last] == m_t[tier[last]]).all()
    assert (chunk[last] == wl.tiers[tier[last], 4] - 1).all()
    step = ~first
    assert (chunk[step] == chunk[np.r_[step[1:], False]] + 1).all()
    assert (lo[step] == hi[np.r_[step[1:], False]]).all()
    assert ((hi > lo) | (m_t[tier] == 0)).all()     # no empty chunk
    # Split rows: items in chunk order, blocks on consecutive partials.
    split = t["part"] >= 0
    assert np.unique(t["part"][split]).size == wl.n_parts
    per_item = wl.groups // worklist.CHUNK_BLOCK
    for orow, first_part, parts in wl.rows.tolist():
        mine = wl.items[(wl.items[:, 3] >= first_part)
                        & (wl.items[:, 3] < first_part + parts)]
        q = -(-parts // per_item)
        assert mine[:, 3].tolist() == list(range(
            first_part, first_part + parts, per_item))
        assert mine[:, 2].tolist() == [i * wl.groups for i in range(q)]
        got = t["part"][split][np.isin(t["item"][split], np.flatnonzero(
            (wl.items[:, 3] >= first_part)
            & (wl.items[:, 3] < first_part + parts)))]
        assert sorted(set(got.tolist())) == list(range(
            first_part, first_part + parts))
        tr = {(int(a), int(b)) for a, b in mine[:, :2]}
        assert len(tr) == 1
        (ti, r), = tr
        assert orow == wl.tiers[ti, 0] + r


def _check_hub_first(wl):
    m_of_item = wl.tiers[wl.items[:, 0], 1]
    assert (np.diff(m_of_item) <= 0).all()


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("name", ["default", "tight"])
def test_worklist_covers_the_real_ladders(name, k):
    shapes = LADDER if name == "default" else LADDER_TIGHT
    wl = worklist.build_worklist(shapes, _starts(shapes), k, 4)
    _check_cover(wl, shapes)
    _check_hub_first(wl)
    assert wl.launches == 1 + (len(wl.rows) > 0)
    # The hub row (5,792 slots, 46 chunks) fills 46 of a CTA's 64 groups
    # at k=16, and goes across 6 CTAs of 8 groups at k=128.
    assert worklist.chunking(shapes[-1][0]) == (126, 46)
    assert (len(wl.rows) > 0) == (k == 128)
    # No group walks more than CHUNK_SLOTS slots.
    assert (wl.tiers[:, 3] <= worklist.CHUNK_SLOTS).all()


def test_real_ladders_are_the_fold_of_ba_2_20():
    for shapes, tiers, slots in ((LADDER, 28, 21_003_800),
                                 (LADDER_TIGHT, 60, 17_392_857)):
        assert len(shapes) == tiers
        assert sum(m * n for m, n in shapes) == slots
        assert sum(n for _, n in shapes) == 1 << 20
        assert shapes[0] == (8, 209781)
    assert LADDER[-1] == (5792, 1) and LADDER_TIGHT[-1] == (5787, 1)


@pytest.mark.parametrize("k,itemsize,vecload", [
    (16, 4, True), (128, 4, True), (16, 2, True), (128, 2, True),
    (16, 1, True), (64, 1, True), (20, 4, True), (20, 2, False),
    (1, 4, False), (160, 4, True), (8, 4, True)])
@pytest.mark.parametrize("shapes", [RAGGED, ZEROS],
                         ids=["ragged", "zero_slot"])
def test_worklist_covers_ragged_ladders(shapes, k, itemsize, vecload):
    wl = worklist.build_worklist(shapes, _starts(shapes), k, itemsize,
                                 vecload=vecload)
    _check_cover(wl, shapes)
    _check_hub_first(wl)
    vec, group, col_blocks = worklist.lanes(k, itemsize, vecload)
    assert (wl.group, wl.col_blocks) == (group, col_blocks)
    assert group * vec * col_blocks >= k > group * vec * (col_blocks - 1)


@pytest.mark.parametrize("slots", [
    range(1, 129), range(129, 300), (4095, 4096, 4097, 5787, 5792, 99_999),
    (0,)], ids=["one_chunk", "short", "hub", "zero"])
def test_chunks_are_bounded_and_never_empty(slots):
    c = worklist.CHUNK_SLOTS
    for m_t in slots:
        length, s = worklist.chunking(m_t)
        if m_t == 0:
            assert (length, s) == (0, 1)
            continue
        assert length <= c and s * length >= m_t
        assert (s - 1) * length < m_t                # no empty chunk
        assert s == -(-m_t // c)


def test_worklist_is_a_function_of_its_arguments():
    a = worklist.build_worklist(RAGGED, _starts(RAGGED), 128, 4)
    b = worklist.build_worklist(list(RAGGED), tuple(_starts(RAGGED)), 128, 4)
    for f in ("tiers", "items", "rows"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert (a.group, a.col_blocks, a.n_parts) == \
        (b.group, b.col_blocks, b.n_parts)
    with pytest.raises(ValueError, match="one row start per tier"):
        worklist.build_worklist(RAGGED, [0], 16, 4)


def test_lanes_hold_16_bytes():
    assert worklist.lanes(16, 4, True) == (4, 4, 1)
    assert worklist.lanes(128, 4, True) == (4, 32, 1)
    assert worklist.lanes(128, 2, True) == (8, 16, 1)
    assert worklist.lanes(128, 1, True) == (16, 8, 1)
    assert worklist.lanes(16, 1, True) == (16, 1, 1)
    assert worklist.lanes(20, 2, False) == (1, 32, 1)
    assert worklist.lanes(256, 4, True) == (4, 32, 2)


def _graph(weighted: bool, n=1200, seed=2):
    """BA(n, 3) with node 0 joined to every other node: its row of
    n - 1 neighbours spans 10 chunks, on one CTA at k=16 and 64 and
    split across two CTAs at k=128 (f32)."""
    a = barabasi_albert(n, 3, seed=seed)
    hub = sp.csr_matrix((np.ones(n - 1, a.dtype),
                         (np.zeros(n - 1, np.int64), np.arange(1, n))),
                        shape=(n, n))
    a = ((a + hub + hub.T) > 0).astype(a.dtype).tocsr()
    if weighted:
        a = a.astype(np.float32)
        a.data = np.random.default_rng(seed).uniform(
            -1, 1, a.nnz).astype(np.float32)
    return a


def _x_t(k, n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (k, n)).astype(
        np.float32)


def _twin_t(m, x_t):
    """The twin on a feature-major ``(k, n)`` input, feature-major out."""
    x = torch.from_numpy(np.ascontiguousarray(x_t.T))
    wl = worklist.build_worklist([tuple(c.shape) for c in m.cols],
                                 m.row_starts, x.shape[1],
                                 x.element_size())
    return worklist.sell_spmm_worklist(m, x, wl), wl


@pytest.mark.parametrize("k", [16, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_twin_matches_jax_xla_and_pallas(k, weighted):
    a = _graph(weighted)
    ours, _ = sell.sell_from_csr(a, device="cpu")
    theirs, _ = jsell.sell_from_csr(a)
    x_t = _x_t(k, a.shape[0], seed=k)
    # The hub row is split across CTAs at k=128: the second pass runs.
    got, wl = _twin_t(ours, x_t)
    assert (wl.n_parts > 0) == (k == 128)
    got = got.numpy().T
    tol = relative_tolerance(a.nnz / a.shape[0])
    xla = np.asarray(jsell.sell_spmm_t(theirs, jnp.asarray(x_t)))
    pallas = np.asarray(jps.sell_spmm_t_pallas(
        theirs, jnp.asarray(x_t), interpret=True, stream=True, row_block=64,
        wave=8))
    assert relative_error(got, xla) <= tol
    assert relative_error(got, pallas) <= tol


@pytest.mark.parametrize("k", [16, 128])
def test_twin_bf16_within_2e2_of_jax(k):
    a = _graph(True)
    ours, _ = sell.sell_from_csr(a, device="cpu")
    theirs, _ = jsell.sell_from_csr(a)
    x_t = _x_t(k, a.shape[0], seed=3)
    xb = torch.from_numpy(np.ascontiguousarray(x_t.T)).to(torch.bfloat16)
    wl = worklist.build_worklist([tuple(c.shape) for c in ours.cols],
                                 ours.row_starts, k, 2)
    got = worklist.sell_spmm_worklist(ours, xb, wl)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().T
    pallas = np.asarray(jps.sell_spmm_t_pallas(
        theirs, jnp.asarray(x_t), interpret=True, stream=True, row_block=64,
        wave=8, feature_dtype="bf16")).astype(np.float32)
    xla = np.asarray(jsell.sell_spmm_t(theirs, jnp.asarray(x_t)))
    assert relative_error(got, pallas) <= 2e-2
    assert relative_error(got, xla) <= 2e-2


@pytest.mark.parametrize("k", [16, 64])
def test_twin_int8_bit_equal_to_jax_on_a_binary_graph(k):
    a = _graph(False)
    ours, _ = sell.sell_from_csr(a, device="cpu")
    theirs, _ = jsell.sell_from_csr(a)
    q_t = np.random.default_rng(k).integers(
        -127, 128, (k, a.shape[0])).astype(np.int8)
    got, _ = _twin_t(ours, q_t)
    assert got.dtype == torch.float32
    want = np.asarray(jps.sell_spmm_t_pallas(
        theirs, jnp.asarray(q_t), interpret=True, stream=True, row_block=64,
        wave=8, feature_dtype="int8"))
    assert np.array_equal(got.numpy().T, want)
    assert np.array_equal(got.numpy().T, np.asarray(
        jsell.sell_spmm_t(theirs, jnp.asarray(q_t.astype(np.float32)))))


def _hub_operator(weighted: bool, seed=4):
    """One bulk tier and a tier holding one row of 6,000 slots."""
    rng = np.random.default_rng(seed)
    n = 2000
    hub = rng.integers(0, n, (6000, 1)).astype(np.int32)
    bulk = rng.integers(0, n, (8, n - 1)).astype(np.int32)
    cols = [bulk, hub]
    data = [rng.uniform(-1, 1, c.shape).astype(np.float32) for c in cols]
    deg = [np.full(n - 1, 8, np.int32), np.array([5999], np.int32)]
    m = sell.sell_from_arrays(cols, data if weighted else None,
                              None if weighted else deg, n, (0, n - 1),
                              device="cpu")
    return m, torch.from_numpy(rng.uniform(-1, 1, (n, 128)).astype(
        np.float32))


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_twin_splits_a_hub_row_in_order(weighted, k):
    m, x = _hub_operator(weighted)
    x = x[:, :k].contiguous()
    # The hub's 47 chunks: on one CTA of 64 groups at k=16, across 6
    # CTAs of 8 groups at k=128.
    wl = worklist.build_worklist([tuple(c.shape) for c in m.cols],
                                 m.row_starts, k, 4)
    assert worklist.chunking(6000)[1] == 47
    assert len(wl.rows) == (k == 128)
    if len(wl.rows):
        assert wl.rows[0, 2] == 6
    runs = [worklist.sell_spmm_worklist(m, x, wl) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])                 # bit for bit
    hub = ell.ell_tier_spmm(m.cols[1], x,
                            data=None if m.data is None else m.data[1],
                            deg=None if m.deg is None else m.deg[1])
    assert relative_error(runs[0][-1:].numpy(), hub.numpy()) <= \
        relative_tolerance(6000)
    assert relative_error(runs[0].numpy(), sell.sell_spmm(m, x).numpy()) \
        <= relative_tolerance(6000)


def test_kernel_source_mirrors_the_worklist():
    """``ops/worklist.py`` names the kernel's CTA size, tier table and
    chunk; the kernel takes its batch (default 8, 4 for int8) and its
    launch bound as launch knobs, the values ``ops/worklist.py`` lists."""
    assert int(re.search(r"constexpr int kThreads = (\d+);", SRC).group(1)) \
        == worklist.THREADS
    body = SRC[SRC.index("struct Tier {"):]
    body = body[:body.index("};")]
    fields = re.findall(r"\b(\w+)(?:, (\w+))?;", body)
    names = [n for pair in fields for n in pair if n]
    assert tuple(names) == worklist.TIER_FIELDS
    assert "static_assert(sizeof(Tier) == 64" in SRC
    assert len(worklist.TIER_FIELDS) * 8 == 64
    assert f"chunk of at most {worklist.CHUNK_SLOTS} slots" in SRC
    assert "BATCH is 8 by default, and 4 for int8" in SRC
    assert (worklist.default_batch(4), worklist.default_batch(1)) == (8, 4)
    entry = SRC[SRC.index('extern "C"'):]
    assert "int batch, int ctas_per_sm" in entry
    assert "if (batch != 4 && batch != 8) return -4;" in entry
    assert worklist.BATCH_CHOICES == (4, 8)
    assert "ctas_per_sm != 1 && ctas_per_sm != 2" in entry
    assert worklist.CTAS_PER_SM_CHOICES == (1, 2)


def test_ctypes_signature_matches_the_kernel_source():
    params = re.search(r'extern "C" int sell_spmm\(([^)]*)\)',
                       SRC).group(1)
    kinds = [("ptr" if "*" in p else "int") for p in params.split(",")]
    want = ["ptr" if t is __import__("ctypes").c_void_p else "int"
            for t in cuda_sell.ARGTYPES]
    assert kinds == want


def test_plan_is_built_once_and_checks_the_operator():
    a = _graph(False)
    m, _ = sell.sell_from_csr(a, device="cpu")
    plan = cuda_sell.plan_for(m, 16, torch.float32, True)
    assert cuda_sell.plan_for(m, 16, torch.float32, True) is plan
    assert plan.covers_all
    assert plan.tiers.shape == (len(m.cols), len(worklist.TIER_FIELDS))
    assert plan.tiers[:, 0].tolist() == [
        c.data_ptr() if c.numel() else 0 for c in m.cols]
    assert np.array_equal(plan.tiers[:, 2:7].numpy(), plan.wl.tiers)
    bad = sell.SellMatrix(cols=tuple(c.long() for c in m.cols), deg=m.deg,
                          n_rows=m.n_rows, row_starts=m.row_starts)
    with pytest.raises(ValueError, match="must be torch.int32"):
        cuda_sell.build_plan(bad, 16, torch.float32, True)
    short = sell.SellMatrix(cols=m.cols, deg=m.deg[:-1] + (m.deg[-1][:0],),
                            n_rows=m.n_rows, row_starts=m.row_starts)
    with pytest.raises(ValueError, match="must have shape"):
        cuda_sell.build_plan(short, 16, torch.float32, True)
    over = sell.SellMatrix(cols=m.cols, deg=m.deg, n_rows=10,
                           row_starts=m.row_starts)
    with pytest.raises(ValueError, match="ends past"):
        cuda_sell.build_plan(over, 16, torch.float32, True)

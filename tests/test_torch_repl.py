"""The fold's column schedule (``repl`` column groups and
``overlap_slabs`` sub-slabs of ``MultiLevelArrow.step``) and the
executors' HBM model, on the CPU: every schedule equals ``repl=1`` bit
for bit, on every carriage and the per-level formats; the JAX
package's fold with the same schedule agrees within tolerance; the
split helpers and the memory helpers equal the JAX package's; and K1's
sum order (its plain twin over the work list) gives a column the same
bits at every k, direct or split."""

import numpy as np
import pytest
import torch

from arrow_matrix_tpu.obs import comm as jcomm
from arrow_matrix_tpu.obs import memview as jmemview
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu.parallel import routing as jrouting
from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.obs import comm as pcomm
from arrow_matrix_tpu_torch.obs import memview as pmemview
from arrow_matrix_tpu_torch.ops import sell, worklist
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.parallel import routing as prouting
from arrow_matrix_tpu_torch.parallel.multi_level import column_schedule
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)

N, WIDTH = 2048, 64
SCHEDULES = [(2, 1), (4, 1), (1, 2), (1, 4), (2, 2), (2, 4)]


@pytest.fixture(scope="module")
def levels():
    a = barabasi_albert(N, 4, seed=1)
    return arrow_decomposition(a, WIDTH, max_levels=10,
                               block_diagonal=True, seed=0)


@pytest.fixture(scope="module")
def plain(levels):
    return MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu")


def test_split_helpers_equal_jax():
    for k in (1, 2, 6, 8, 16, 128):
        for s in (1, 2, 3, 4, 8, 200):
            for fn in ("overlap_slices", "repl_slab_width"):
                try:
                    want = getattr(jrouting, fn)(k, s)
                except ValueError:
                    with pytest.raises(ValueError):
                        getattr(prouting, fn)(k, s)
                    continue
                assert getattr(prouting, fn)(k, s) == want
    assert column_schedule(8, 2, 2) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert column_schedule(8, 1, 1) == [(0, 8)]


@pytest.mark.parametrize("repl,slabs", SCHEDULES)
@pytest.mark.parametrize("dtype", [None, "bf16", "int8"])
def test_fold_schedule_is_bit_identical(levels, plain, repl, slabs,
                                        dtype):
    ex = MultiLevelArrow(levels, WIDTH, fmt="fold", repl=repl,
                         overlap_slabs=slabs, feature_dtype=dtype,
                         device="cpu")
    assert ex.slabs(16) == column_schedule(16, repl, slabs)
    base = plain if dtype is None else MultiLevelArrow(
        levels, WIDTH, fmt="fold", feature_dtype=dtype, device="cpu")
    x = random_dense(N, 16, seed=3)
    a, b = ex.set_features(x), base.set_features(x)
    for _ in range(3):
        a, b = ex.step(a), base.step(b)
    if isinstance(a, tuple):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    else:
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.parametrize("fmt", ["dense", "ell", "hyb"])
def test_per_level_slabs_are_bit_identical(levels, fmt):
    x = random_dense(N, 8, seed=4)
    a = MultiLevelArrow(levels, WIDTH, fmt=fmt, overlap_slabs=4,
                        device="cpu")
    b = MultiLevelArrow(levels, WIDTH, fmt=fmt, device="cpu")
    ya, yb = a.step(a.set_features(x)), b.step(b.set_features(x))
    assert torch.equal(ya, yb)


def test_schedule_agrees_with_the_jax_fold(levels, plain):
    x = random_dense(N, 16, seed=5)
    ours = MultiLevelArrow(levels, WIDTH, fmt="fold", repl=2,
                           overlap_slabs=2, device="cpu")
    theirs = JaxArrow(levels, WIDTH, fmt="fold", repl=2, overlap_slabs=2)
    got = ours.gather_result(ours.run(ours.set_features(x), 2))
    want = np.asarray(theirs.gather_result(
        theirs.run(theirs.set_features(x), 2)))
    assert relative_error(got, want) <= relative_tolerance(
        plain.nnz / N, 2)


def test_schedule_validation(levels, plain):
    for kw, err in (({"repl": 0}, "repl"), ({"overlap_slabs": 0},
                                            "overlap_slabs"),
                    ({"repl": 2, "fmt": "dense"}, "fmt='fold'")):
        kw = dict({"fmt": "fold"}, **kw)
        with pytest.raises(ValueError, match=err):
            MultiLevelArrow(levels, WIDTH, device="cpu", **kw)
    ex = MultiLevelArrow(levels, WIDTH, fmt="fold", repl=4, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        ex.step(ex.set_features(random_dense(N, 6, seed=1)))


def test_hbm_model_counts_the_device_tensors(levels, plain):
    """At k=16 f32: the operator, the work list's tables at its widest
    lane layout (a 64-byte row a tier, 16 bytes an item, 12 a split
    row) and its split-row workspace at the slab width (n_parts x k/cS x
    4), three carriages and the finite check's five scalars, and under a
    schedule the slabs' results and one slab copy; each tensor in whole
    512-byte allocator blocks."""
    k, rows = 16, plain.total_rows
    block = lambda b: -(-b // 512) * 512
    for repl, slabs in ((1, 1), (2, 2)):
        ex = MultiLevelArrow(levels, WIDTH, fmt="fold", repl=repl,
                             overlap_slabs=slabs, device="cpu")
        ks = k // (repl * slabs)
        wl = worklist.build_worklist([tuple(c.shape) for c in ex.sell.cols],
                                     ex.sell.row_starts, 128, 4)
        assert wl.groups == 8
        kernel = (block(len(ex.sell.cols) * 64) + block(len(wl.items) * 16)
                  + block(len(wl.rows) * 12) + block(wl.n_parts * ks * 4))
        carriage = 3 * block(rows * k * 4) + 5 * 512
        if repl * slabs > 1:
            carriage += (repl * slabs + 1) * block(rows * ks * 4)
        resident = ex.sell.device_nbytes()
        assert resident == sum(c.nbytes for c in ex.sell.cols) + sum(
            d.nbytes for d in ex.sell.deg)
        assert ex.predicted_hbm_bytes(k) == resident + kernel + carriage
        assert ex.carriage_hbm_bytes(k) == kernel + carriage
        assert pmemview.request_bytes_for(ex, k) == kernel + carriage
        assert pmemview.predicted_bytes_for(ex, k, repl=2) == \
            2 * (resident + kernel + carriage)
        # The widest layout covers every width's work list.
        for kk in (4, 16, 64):
            w = worklist.build_worklist(
                [tuple(c.shape) for c in ex.sell.cols], ex.sell.row_starts,
                kk, 4)
            assert len(w.items) <= len(wl.items)
            assert w.n_parts <= wl.n_parts
    dense = MultiLevelArrow(levels, WIDTH, fmt="dense", device="cpu")
    assert dense.predicted_hbm_bytes(0) == sum(
        b.device_nbytes() for b in dense.blocks) + dense.fwd.nbytes \
        + dense.bwd.nbytes
    assert dense.carriage_hbm_bytes(8) == 3 * block(
        dense.total_rows * 8 * 4) + 5 * 512


def test_memory_helpers_equal_jax(monkeypatch):
    for base, budget in ((100, 1000), (300, 1000), (2000, 1000)):
        assert pmemview.largest_fitting_repl(base, budget) == \
            jmemview.largest_fitting_repl(base, budget)
    monkeypatch.setenv("AMT_HBM_GB", "1.5")
    assert pcomm.hbm_budget_bytes(None) == jcomm.hbm_budget_bytes(None) \
        == int(1.5 * 2**30)
    monkeypatch.delenv("AMT_HBM_GB")
    assert pcomm.hbm_budget_bytes(123) == 123
    assert pcomm.hbm_budget_bytes(None, device="cpu") > 0
    t = torch.zeros(4, 4)
    assert pmemview.tree_device_bytes((t, [t, None]), {"a": torch.zeros(
        2, dtype=torch.int8)}, 3) == 64 + 2

    class NoModel:
        pass

    assert pmemview.request_bytes_for(NoModel(), 4) is None


def _hub_operator(weighted: bool, seed=4):
    """One bulk tier and one row of 6,000 slots (47 chunks)."""
    rng = np.random.default_rng(seed)
    n = 2000
    cols = [rng.integers(0, n, (8, n - 1)).astype(np.int32),
            rng.integers(0, n, (6000, 1)).astype(np.int32)]
    data = [rng.uniform(-1, 1, c.shape).astype(np.float32) for c in cols]
    deg = [np.full(n - 1, 8, np.int32), np.array([5999], np.int32)]
    m = sell.sell_from_arrays(cols, data if weighted else None,
                              None if weighted else deg, n, (0, n - 1),
                              device="cpu")
    return m, torch.from_numpy(rng.uniform(-1, 1, (n, 128)).astype(
        np.float32))


@pytest.mark.parametrize("weighted", [False, True])
def test_k1_order_gives_a_column_the_same_bits_at_every_k(weighted):
    """The work-list twin (K1's order of the chunk sums) at k = 128
    (the hub split over 6 CTAs of one block each) against every slab of
    k = 4 and 16 (the hub on one CTA, its 47 chunks added in blocks of
    8) and of k = 32 and 64 (split over 2 and 3 CTAs of several blocks
    each): equal bit for bit; and the plain product, whose sums run over each row's
    slots in one reduction, equal across k too."""
    m, x = _hub_operator(weighted)

    def twin(xs):
        wl = worklist.build_worklist([tuple(c.shape) for c in m.cols],
                                     m.row_starts, xs.shape[1], 4)
        return worklist.sell_spmm_worklist(m, xs, wl), wl

    full, wl128 = twin(x)
    plain = sell.sell_spmm(m, x)
    assert len(wl128.rows) == 1 and wl128.rows[0, 2] == 6
    for k in (4, 16, 32, 64):
        _, wl = twin(x[:, :k].contiguous())
        assert (len(wl.rows) == 0) == (k <= 16)
        for lo in range(0, 128, k):
            xs = x[:, lo:lo + k].contiguous()
            assert torch.equal(twin(xs)[0], full[:, lo:lo + k])
            assert torch.equal(sell.sell_spmm(m, xs), plain[:, lo:lo + k])

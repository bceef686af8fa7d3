"""The CUDA kernels against their plain versions, on the card: K1 (SELL
tier; also on the ELL and HYB levels' operators), K2/K3 (dense arrow
column blocks and head row) and K4 (the row gather and fused gather-add,
the granule probe's entry, and the per-level executors' routing).

These tests need a CUDA device and skip elsewhere.  On a machine with a
card (and without JAX) run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.decomposition import (
    arrow_decomposition,
    decomposition_spmm,
)
from arrow_matrix_tpu_torch.ops import (
    arrow_blocks,
    cuda_blocks,
    cuda_ell,
    cuda_gather,
    cuda_sell,
    sell,
    worklist,
)
from arrow_matrix_tpu_torch.ops.hyb import hyb_from_csr, hyb_spmm, hyb_spmm_t
from arrow_matrix_tpu_torch.ops.gather import (
    granule_gather_plain,
    pack_granules,
    row_gather_add_plain,
    take,
)
from arrow_matrix_tpu_torch.ops.ell import (
    ell_spmm_batched,
    ell_spmm_t,
    ell_stack_tier,
    ell_tier_spmm,
    out_dtype_for,
)
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.parallel.multi_level import (
    level_spmm,
    resolve_chunk,
)
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    bf16_within_one_ulp,
    random_dense,
    relative_error,
    relative_tolerance,
)

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _tier(rng, m_t, n_t, n_table):
    deg = rng.integers(0, m_t + 1, n_t).astype(np.int32)
    pad = np.arange(m_t)[:, None] >= deg[None, :]
    cols = rng.integers(0, n_table, (m_t, n_t)).astype(np.int32)
    cols[pad] = 0
    vals = np.where(pad, 0, rng.uniform(-1, 1, (m_t, n_t))).astype(
        np.float32)
    return cols, deg, vals


@pytest.mark.parametrize("k", [16, 64, 128, 20])
@pytest.mark.parametrize("binary", [True, False])
# 900 slots: the kernel splits each row over several thread groups.
@pytest.mark.parametrize("m_t", [1, 5, 40, 900])
def test_kernel_matches_plain(cuda, k, binary, m_t):
    rng = np.random.default_rng(k)
    cols, deg, vals = _tier(rng, m_t, 1000, 5000)
    c = torch.from_numpy(cols).to(cuda)
    w = (dict(deg=torch.from_numpy(deg).to(cuda)) if binary
         else dict(data=torch.from_numpy(vals).to(cuda)))
    x32 = torch.from_numpy(rng.uniform(-1, 1, (5000, k)).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy(rng.integers(-127, 128, (5000, k)).astype(
        np.int8)).to(cuda)
    tol = relative_tolerance(float(deg.mean()))
    for x in (x32, x32.to(torch.bfloat16), q):
        out = torch.empty((1000, k), dtype=out_dtype_for(x.dtype),
                          device=cuda)
        before = cuda_sell.LAUNCHES
        got = cuda_sell.sell_tier_spmm(c, x, out, **w)
        # One launch over the tier's work list, two when its rows are
        # split across CTAs.
        wl = worklist.build_worklist(
            [(m_t, 1000)], [0], k, x.element_size(),
            vecload=(k * x.element_size()) % 16 == 0)
        assert cuda_sell.LAUNCHES == before + wl.launches
        assert wl.launches == 1 + (worklist.chunking(m_t)[1] > wl.groups)
        want = ell_tier_spmm(c, x, **w)
        torch.cuda.synchronize()
        if x.dtype == torch.int8 and binary:
            assert torch.equal(got, want)
        elif x.dtype == torch.bfloat16:
            assert bf16_within_one_ulp(got, want, float(deg.mean()))
        else:
            assert relative_error(got.cpu().numpy(),
                                  want.cpu().numpy()) <= tol


def test_fold_executor_on_the_card_matches_the_cpu(cuda):
    a = barabasi_albert(4096, 4, seed=1)
    levels = arrow_decomposition(a, 64, max_levels=10, block_diagonal=True,
                                 seed=0)
    x = random_dense(4096, 16, seed=2)
    gpu = MultiLevelArrow(levels, 64, fmt="fold", device=cuda)
    cpu = MultiLevelArrow(levels, 64, fmt="fold", device="cpu")
    before = cuda_sell.LAUNCHES
    got = gpu.gather_result(gpu.run(gpu.set_features(x), 3))
    # One launch per product (two with split rows), whatever the tiers.
    plan = gpu.sell.plans[(16, torch.float32, True)]
    assert len(gpu.sell.cols) > 2 and plan.wl.launches in (1, 2)
    assert cuda_sell.LAUNCHES - before == 3 * plan.wl.launches
    want = cpu.gather_result(cpu.run(cpu.set_features(x), 3))
    golden = x
    for _ in range(3):
        golden = decomposition_spmm(levels, golden)
    tol = relative_tolerance(gpu.nnz / 4096, 3)
    assert relative_error(got, want) <= tol
    assert relative_error(got, golden) <= tol


def _multi_tier(rng, binary, dev):
    """A random operator of ragged tiers: a zero-slot tier, bulk tiers,
    a mid tier, and a hub row of 6,000 slots that K1 splits across
    CTAs; the last row of x is gathered."""
    shapes = [(0, 37), (8, 3000), (16, 900), (72, 130), (700, 11),
              (6000, 1)]
    n = sum(n_t for _, n_t in shapes)
    cols, data, deg, starts = [], [], [], []
    for m_t, n_t in shapes:
        d = rng.integers(m_t // 2, m_t + 1, n_t).astype(np.int32)
        pad = np.arange(m_t)[:, None] >= d[None, :]
        c = rng.integers(0, n, (m_t, n_t)).astype(np.int32)
        c[pad] = 0
        if c.size:
            c[0, 0] = n - 1
        cols.append(c)
        data.append(np.where(pad, 0, rng.uniform(-1, 1, (m_t, n_t))
                             ).astype(np.float32))
        deg.append(d)
        starts.append(sum(s[1] for s in shapes[:len(starts)]))
    return sell.sell_from_arrays(cols, None if binary else data,
                                 deg if binary else None, n, starts,
                                 device=dev)


@pytest.mark.parametrize("k", [16, 64, 128, 20])
@pytest.mark.parametrize("binary", [True, False])
def test_all_tier_launch_matches_twin_and_plain(cuda, k, binary):
    rng = np.random.default_rng(k + binary)
    m = _multi_tier(rng, binary, cuda)
    n = m.n_rows
    x32 = torch.from_numpy(rng.uniform(-1, 1, (n, k)).astype(
        np.float32)).to(cuda)
    q = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(
        np.int8)).to(cuda)
    row_nnz = 6000.0
    for x in (x32, x32.to(torch.bfloat16), q):
        before = cuda_sell.LAUNCHES
        runs = [cuda_sell.sell_spmm_cuda(m, x) for _ in range(2)]
        wl = m.plans[(k, x.dtype, (k * x.element_size()) % 16 == 0)].wl
        # The hub's 47 chunks go across CTAs where a CTA holds fewer
        # groups (f32 at k=128): then a second launch adds them.
        split = worklist.chunking(6000)[1] > wl.groups
        assert split or k != 128 or x.dtype != torch.float32
        assert wl.launches == 1 + split and (wl.n_parts > 0) == split
        assert cuda_sell.LAUNCHES == before + 2 * wl.launches
        twin = worklist.sell_spmm_worklist(m, x, wl)
        want = sell.sell_spmm(m, x)
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])           # bit for bit
        got = runs[0]
        for ref in (twin, want):
            if x.dtype == torch.int8 and binary:
                assert torch.equal(got, ref)
            elif x.dtype == torch.bfloat16:
                assert bf16_within_one_ulp(got, ref, row_nnz)
            else:
                assert relative_error(got.cpu().numpy(),
                                      ref.cpu().numpy()) <= \
                    relative_tolerance(row_nnz)
        assert not got[:37].float().any()              # the zero tier


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    c = torch.zeros((4, 10), dtype=torch.int32, device=cuda)
    deg = torch.zeros(10, dtype=torch.int32, device=cuda)
    x = torch.zeros((20, 16), device=cuda)
    out = torch.empty((10, 16), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sell.sell_tier_spmm(c.t().contiguous().t(), x, out, deg=deg)
    with pytest.raises(ValueError, match="must be torch.int32"):
        cuda_sell.sell_tier_spmm(c.long(), x, out, deg=deg)
    with pytest.raises(ValueError, match="unsupported carriage"):
        cuda_sell.sell_tier_spmm(c, x.double(), out, deg=deg)
    with pytest.raises(ValueError, match="exactly one"):
        cuda_sell.sell_tier_spmm(c, x, out)
    with pytest.raises(ValueError, match="is on"):
        cuda_sell.sell_tier_spmm(c, x, out, deg=deg.cpu())


def _stacks(rng, nb, w, k, dev):
    mats = {name: torch.from_numpy(
        rng.uniform(-1, 1, (nb, w, w)).astype(np.float32)).to(dev)
        for name in ("head", "diag", "col", "lo", "hi")}
    x = torch.from_numpy(rng.uniform(-1, 1, (nb, w, k)).astype(
        np.float32)).to(dev)
    return mats, x


# (3, 48), (33, 200) and k=8 / k=33 / k=160 are off every tile (k=160
# takes two Wide column tiles, the second mostly masked); (5, 100) and
# k=33 take the masked plain loads instead of cp.async (100 is no
# multiple of 8 bf16 values, 33 no multiple of 4 floats); (33, 200)
# splits K3 33 ways.
@pytest.mark.parametrize("nb,w", [(3, 48), (5, 64), (5, 100), (33, 200),
                                  (2, 2048)])
@pytest.mark.parametrize("k", [8, 16, 33, 128, 160])
@pytest.mark.parametrize("banded", [False, True])
def test_block_kernels_match_plain(cuda, nb, w, k, banded):
    rng = np.random.default_rng(nb * w + k)
    mats, x = _stacks(rng, nb, w, k, cuda)
    for dtype in (torch.float32, torch.bfloat16):
        m = {name: t.to(dtype) for name, t in mats.items()}
        lohi = (m["lo"], m["hi"]) if banded else (None, None)
        before = (cuda_blocks.LAUNCHES_K2, cuda_blocks.LAUNCHES_K3)
        got_col = cuda_blocks.column_spmm(m["diag"], m["col"], x, *lohi)
        got_head = cuda_blocks.head_spmm(m["head"], x)
        assert (cuda_blocks.LAUNCHES_K2, cuda_blocks.LAUNCHES_K3) == \
            (before[0] + 1, before[1] + 1)
        want_col = arrow_blocks.column_spmm(m["diag"], m["col"], x, *lohi)
        want_head = arrow_blocks.head_spmm(m["head"], x)
        torch.cuda.synchronize()
        tol = relative_tolerance(w * (4 if banded else 2))
        assert relative_error(got_col.cpu().numpy(),
                              want_col.cpu().numpy()) <= tol
        assert not got_col[0].any()
        assert relative_error(got_head.cpu().numpy(),
                              want_head.cpu().numpy()) <= tol


# K3's split leaves a short last chunk: 65 blocks in 33 chunks of 2 (the
# last holds one), and 33 blocks in 17.
@pytest.mark.parametrize("nb,w,k", [(65, 256, 1024), (33, 2048, 16)])
def test_head_kernel_with_a_short_last_chunk(cuda, nb, w, k):
    chunks = cuda_blocks.head_chunks(nb, w, k)
    assert len(chunks) > 1 and len(chunks[-1]) < len(chunks[0])
    rng = np.random.default_rng(nb + w + k)
    head = torch.from_numpy(rng.uniform(-1, 1, (nb, w, w)).astype(
        np.float32)).to(cuda)
    x = torch.from_numpy(rng.uniform(-1, 1, (nb, w, k)).astype(
        np.float32)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        h = head.to(dtype)
        got = cuda_blocks.head_spmm(h, x)
        want = arrow_blocks.head_spmm(h, x)
        torch.cuda.synchronize()
        assert relative_error(got.cpu().numpy(), want.cpu().numpy()) <= \
            relative_tolerance(nb * w)


@pytest.mark.parametrize("nb,w,k", [(33, 200, 16), (9, 512, 128),
                                    (5, 100, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernels_repeat_bit_for_bit(cuda, nb, w, k, dtype):
    rng = np.random.default_rng(nb * w + k)
    mats, x = _stacks(rng, nb, w, k, cuda)
    m = {name: t.to(dtype) for name, t in mats.items()}
    runs = [(cuda_blocks.column_spmm(m["diag"], m["col"], x, m["lo"],
                                     m["hi"]),
             cuda_blocks.head_spmm(m["head"], x)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("banded", [False, True])
def test_dense_executor_on_the_card_matches_the_cpu(cuda, banded):
    a = barabasi_albert(4096, 4, seed=1)
    levels = arrow_decomposition(a, 64, max_levels=10,
                                 block_diagonal=not banded, seed=0)
    x = random_dense(4096, 16, seed=2)
    gpu = MultiLevelArrow(levels, 64, fmt="dense", banded=banded,
                          device=cuda)
    cpu = MultiLevelArrow(levels, 64, fmt="dense", banded=banded,
                          device="cpu")
    before = (cuda_blocks.LAUNCHES_K2, cuda_blocks.LAUNCHES_K3)
    got = gpu.gather_result(gpu.run(gpu.set_features(x), 3))
    assert cuda_blocks.LAUNCHES_K3 - before[1] == 3 * len(levels)
    assert cuda_blocks.LAUNCHES_K2 - before[0] == 3 * sum(
        b.n_blocks > 1 for b in gpu.blocks)
    want = cpu.gather_result(cpu.run(cpu.set_features(x), 3))
    golden = x
    for _ in range(3):
        golden = decomposition_spmm(levels, golden)
    tol = relative_tolerance(gpu.nnz / 4096, 3)
    assert relative_error(got, want) <= tol
    assert relative_error(got, golden) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_stack_packed_on_the_card_equals_the_host_pack(cuda, dtype):
    """The dense stacks scattered on the card carry the host pack's
    bits, for a whole level's arrow tiling."""
    from arrow_matrix_tpu_torch.ops.ell import dense_pack_stack

    a = barabasi_albert(2048, 4, seed=3)
    level = arrow_decomposition(a, 64, max_levels=10, block_diagonal=True,
                                seed=0)[0].matrix.tocsr()
    mats = [level[i * 64:(i + 1) * 64, 0:64] for i in range(32)] + [None]
    want = dense_pack_stack(mats, dtype=dtype, rows=64)
    got = dense_pack_stack(mats, dtype=dtype, rows=64, device=cuda)
    assert got.device.type == "cuda" and got.dtype == dtype
    assert torch.equal(got.cpu().view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_block_wrappers_reject_what_the_kernels_do_not_take(cuda):
    a = torch.zeros((3, 16, 16), device=cuda)
    x = torch.zeros((3, 16, 4), device=cuda)
    with pytest.raises(ValueError, match="x must be torch.float32"):
        cuda_blocks.head_spmm(a, x.double())
    with pytest.raises(ValueError, match="unsupported block dtype"):
        cuda_blocks.head_spmm(a.half(), x)
    with pytest.raises(ValueError, match="must have shape"):
        cuda_blocks.column_spmm(a, a[:, :8], x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_blocks.column_spmm(a.transpose(1, 2), a, x)
    with pytest.raises(ValueError, match="both lo and hi"):
        cuda_blocks.column_spmm(a, a, x, lo=a)
    with pytest.raises(ValueError, match="is on"):
        cuda_blocks.head_spmm(a.cpu(), x)


# The granule entry's shapes of chip_smoke.py phase 9: (n, S), the
# JAX package's two CPU shapes, the probe's full size and a ragged one.
K4_SHAPES = [(1 << 10, 256), (1 << 14, 1 << 12), (1 << 20, 1 << 21),
             (1000, 360)]


@pytest.mark.parametrize("n,s", K4_SHAPES)
def test_granule_kernel_matches_plain(cuda, n, s):
    rng = np.random.default_rng(n + s)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    x[5] = -0.0
    idx = rng.integers(0, n, size=s, dtype=np.int32)
    idx[:3] = (0, n - 1, 5)
    xp = pack_granules(torch.from_numpy(x).to(cuda))
    it = torch.from_numpy(idx).to(cuda)
    before = cuda_gather.LAUNCHES
    got = cuda_gather.granule_gather(xp, it)
    assert cuda_gather.LAUNCHES == before + 1
    want = granule_gather_plain(xp, it)
    torch.cuda.synchronize()
    assert got.shape == (s // 8, 128)
    assert torch.equal(got, want)                     # by value
    rows = got.view(-1, 16)
    # The kernel copies bits: -0.0 stays -0.0, as in take.
    assert torch.equal(rows.view(torch.int32),
                       take(xp.view(-1, 16), it).view(torch.int32))
    assert bool(torch.signbit(rows[2]).all())


def test_granule_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    xp = torch.zeros((32, 128), device=cuda)
    idx = torch.zeros(256, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        cuda_gather.granule_gather(xp, idx.cpu())
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_gather.granule_gather(xp, idx[:252])
    with pytest.raises(ValueError, match="overlaps x"):
        cuda_gather.row_gather_add_(xp.view(-1, 16)[:256], xp.view(-1, 16),
                                    idx)


def _bits(t):
    return t.view(torch.int32)


def _gather_inputs(dev, n, k, s, seed, misalign):
    """``(x, base, idx)`` on the card: features with a ``-0.0`` row and a
    NaN with a payload, on a view 4 bytes off 16-byte alignment when
    ``misalign`` (the kernel's scalar body)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    x[0] = -0.0
    x.view(torch.int32)[1, 0] = 0x7FC12345
    if misalign:
        buf = torch.empty(n * k + 1, device=dev)
        buf[1:] = x.reshape(-1).to(dev)
        xd = buf[1:].view(n, k)
        assert xd.data_ptr() % 16
    else:
        xd = x.to(dev)
    base = torch.from_numpy(rng.standard_normal((s, k)).astype(
        np.float32)).to(dev)
    idx = rng.integers(0, n, size=s, dtype=np.int32)
    idx[:3] = (0, 1, n - 1)
    return xd, base, torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("k", [1, 3, 4, 16, 36, 128])
@pytest.mark.parametrize("misalign", [False, True])
def test_row_gather_matches_index_select_bit_for_bit(cuda, k, misalign):
    x, base, idx = _gather_inputs(cuda, 5000, k, 20_011, seed=k,
                                  misalign=misalign)
    before = (cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD)
    got = cuda_gather.row_gather(x, idx)
    again = cuda_gather.row_gather(x, idx)
    out = base.clone()
    assert cuda_gather.row_gather_add_(out, x, idx) is out
    out2 = cuda_gather.row_gather_add_(base.clone(), x, idx)
    assert (cuda_gather.LAUNCHES - before[0],
            cuda_gather.LAUNCHES_ADD - before[1]) == (2, 2)
    torch.cuda.synchronize()
    want = x.index_select(0, idx)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(got))
    assert bool(torch.signbit(got[0]).all())          # -0.0 kept
    assert int(_bits(got)[1, 0]) == 0x7FC12345        # the NaN's payload
    assert torch.equal(_bits(out), _bits(base + want))
    assert torch.equal(_bits(out), _bits(
        row_gather_add_plain(base.clone(), x, idx)))
    assert torch.equal(_bits(out2), _bits(out))


def _index_select_step(exe, x):
    """One step of ``exe`` routed by ``index_select`` and an add."""
    total, k = x.shape
    partials, cur = [], x
    for i, (blk, w) in enumerate(zip(exe.blocks, exe.widths)):
        if i:
            cur = cur.index_select(0, exe.fwd[i - 1])
        partials.append(level_spmm(blk, cur, w, resolve_chunk(
            exe.chunk, blk, total, k, exe.gather_budget)))
    agg = partials[-1]
    for i in range(len(exe.blocks) - 1, 0, -1):
        agg = partials[i - 1].add_(agg.index_select(0, exe.bwd[i - 1]))
    return agg


@pytest.mark.parametrize("fmt,head_fmt", [("ell", "gell"), ("ell", "flat"),
                                          ("hyb", "auto"), ("dense", "auto")])
def test_per_level_step_routes_through_k4(cuda, fmt, head_fmt):
    levels = _ell_levels(False)
    x = random_dense(4096, 16, seed=7)
    gpu = MultiLevelArrow(levels, 64, fmt=fmt, head_fmt=head_fmt,
                          device=cuda)
    cpu = MultiLevelArrow(levels, 64, fmt=fmt, head_fmt=head_fmt,
                          device="cpu")
    flat = gpu.head_layouts().count("flat")
    assert flat == (len(levels) if head_fmt == "flat" else 0)
    xd = gpu.set_features(x)
    before = (cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD)
    y = gpu.step(xd)
    torch.cuda.synchronize()
    assert (cuda_gather.LAUNCHES - before[0],
            cuda_gather.LAUNCHES_ADD - before[1]) == (
        len(levels) - 1 + flat, len(levels) - 1)
    assert torch.equal(_bits(y), _bits(_index_select_step(gpu, xd)))
    assert torch.equal(_bits(gpu.step(xd)), _bits(y))
    want = cpu.gather_result(cpu.step(cpu.set_features(x)))
    assert relative_error(gpu.gather_result(y), want) <= \
        relative_tolerance(gpu.nnz / 4096)


def _ell_levels(banded):
    a = barabasi_albert(4096, 4, seed=1)
    return arrow_decomposition(a, 64, max_levels=10,
                               block_diagonal=not banded, seed=0)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("k", [16, 20])
def test_k1_on_a_converted_ell_stack_matches_plain(cuda, binary, k):
    # A 900-slot row: K1 splits it over thread groups and CTAs.
    rng = np.random.default_rng(k)
    b, w, m = 7, 300, 904
    deg = rng.integers(0, 40, (b, w)).astype(np.int32)
    deg[3, 5] = 900
    cols = rng.integers(0, w, (b, w, m)).astype(np.int16)
    pad = np.arange(m)[None, None, :] >= deg[:, :, None]
    cols[pad] = 0
    vals = np.where(pad, 0, rng.uniform(-1, 1, (b, w, m))).astype(
        np.float32)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, w, k)).astype(
        np.float32)).to(cuda)
    offsets = cuda_ell.stack_offsets("diag", b, w)
    c = torch.from_numpy(cols).to(cuda)
    weights = (dict(deg=torch.from_numpy(deg).to(cuda)) if binary
               else dict(data=torch.from_numpy(vals).to(cuda)))
    tier = ell_stack_tier(c, offsets, **weights)
    op = cuda_ell.one_tier(*tier, x_rows=b * w)
    before = cuda_sell.LAUNCHES
    got = cuda_sell.sell_spmm_cuda(op, x.view(b * w, k))
    again = cuda_sell.sell_spmm_cuda(op, x.view(b * w, k))
    assert cuda_sell.LAUNCHES - before == 2 * op.plans[
        (k, torch.float32, k % 4 == 0)].wl.launches
    want = ell_spmm_batched(c, weights.get("data"), x,
                            deg=weights.get("deg"))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert relative_error(got.view(b, w, k).cpu().numpy(),
                          want.cpu().numpy()) <= relative_tolerance(900)


@pytest.mark.parametrize("head_fmt", ["flat", "ell", "gell"])
@pytest.mark.parametrize("banded", [False, True])
def test_ell_executor_on_the_card_matches_the_cpu(cuda, head_fmt, banded):
    levels = _ell_levels(banded)
    x = random_dense(4096, 16, seed=2)
    gpu = MultiLevelArrow(levels, 64, fmt="ell", head_fmt=head_fmt,
                          banded=banded, device=cuda)
    cpu = MultiLevelArrow(levels, 64, fmt="ell", head_fmt=head_fmt,
                          banded=banded, device="cpu")
    assert gpu.head_layouts() == [head_fmt] * len(levels)
    ops = [op for b in gpu.blocks for op in cuda_ell.k1_operands(b).values()
           if isinstance(op, sell.SellMatrix)]
    before = (cuda_sell.LAUNCHES, cuda_blocks.LAUNCHES_K2,
              cuda_blocks.LAUNCHES_K3)
    y = gpu.run(gpu.set_features(x), 3)
    torch.cuda.synchronize()
    per_step = sum(op.plans[(16, torch.float32, True)].wl.launches
                   for op in ops)
    assert cuda_sell.LAUNCHES - before[0] == 3 * per_step
    assert (cuda_blocks.LAUNCHES_K2, cuda_blocks.LAUNCHES_K3) == before[1:]
    got = gpu.gather_result(y)
    want = cpu.gather_result(cpu.run(cpu.set_features(x), 3))
    golden = x
    for _ in range(3):
        golden = decomposition_spmm(levels, golden)
    tol = relative_tolerance(gpu.nnz / 4096, 3)
    assert relative_error(got, want) <= tol
    assert relative_error(got, golden) <= tol
    again = gpu.run(gpu.set_features(x), 3)
    assert torch.equal(y, again)


@pytest.mark.parametrize("binary", [True, False])
def test_feature_major_products_run_k1(cuda, binary):
    """``ell_spmm_t`` and ``hyb_spmm_t`` on the card are K1 launches,
    within the tolerance of their plain versions on the same tensors."""
    rng = np.random.default_rng(7)
    cols, deg, vals = _tier(rng, 24, 5000, 6000)
    x_t = torch.from_numpy(random_dense(128, 6000, seed=2)).to(cuda)
    args = (torch.from_numpy(cols).to(cuda), x_t)
    kw = (dict(deg=torch.from_numpy(deg).to(cuda)) if binary
          else dict(data=torch.from_numpy(vals).to(cuda)))
    before = cuda_sell.LAUNCHES
    got = ell_spmm_t(*args, **kw)
    assert cuda_sell.LAUNCHES > before
    want = ell_spmm_t(*(t.cpu() for t in args),
                      **{n: t.cpu() for n, t in kw.items()})
    assert relative_error(got.cpu().numpy(), want.numpy()) <= \
        relative_tolerance(24)
    a = barabasi_albert(4000, 3, seed=3).tolil()
    a[0, 1:801] = 1
    a[1:801, 0] = 1
    a = a.tocsr()
    if not binary:
        a.data = rng.uniform(0.5, 1.5, a.nnz).astype(np.float32)
    level = hyb_from_csr(a, pad_rows_to=4096, device=cuda)
    x_t = torch.from_numpy(random_dense(16, 4096, seed=4)).to(cuda)
    before = cuda_sell.LAUNCHES
    got = hyb_spmm_t(level, x_t)
    assert cuda_sell.LAUNCHES > before
    want = hyb_spmm(level, x_t.T.contiguous()).T
    assert relative_error(got.cpu().numpy(), want.cpu().numpy()) <= \
        relative_tolerance(800)


def test_hyb_level_on_the_card_matches_plain(cuda):
    # BA with a 3,000-degree hub: heavy rows, one split across CTAs.
    a = barabasi_albert(20000, 3, seed=3).tolil()
    a[0, 1:3001] = 1
    a[1:3001, 0] = 1
    a = a.tocsr()
    level = hyb_from_csr(a, pad_rows_to=20480, device=cuda)
    assert level.heavy_idx.shape[0] > 0
    x = torch.from_numpy(random_dense(20480, 16, seed=4)).to(cuda)
    before = cuda_sell.LAUNCHES
    got = cuda_ell.hyb_spmm_cuda(level, x)
    again = cuda_ell.hyb_spmm_cuda(level, x)
    ops = cuda_ell.hyb_operands(level)
    assert cuda_sell.LAUNCHES - before == 2 * sum(
        ops[name].plans[(16, torch.float32, True)].wl.launches
        for name in ("light", "heavy"))
    want = hyb_spmm(level, x)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert relative_error(got.cpu().numpy(), want.cpu().numpy()) <= \
        relative_tolerance(3000)
    golden = a @ random_dense(20480, 16, seed=4)[:20000]
    assert relative_error(got[:20000].cpu().numpy(), golden) <= \
        relative_tolerance(3000)


def test_auto_executor_on_the_card_runs_k1_and_k2_k3(cuda):
    levels = _ell_levels(False)
    x = random_dense(4096, 16, seed=5)
    budget = 4096 * 64 * 3 * 4 * 2
    gpu = MultiLevelArrow(levels, 64, dense_budget=budget, device=cuda)
    cpu = MultiLevelArrow(levels, 64, dense_budget=budget, device="cpu")
    assert gpu.fmts == cpu.fmts and "dense" in gpu.fmts \
        and "ell" in gpu.fmts
    before = (cuda_sell.LAUNCHES, cuda_blocks.LAUNCHES_K3)
    got = gpu.gather_result(gpu.step(gpu.set_features(x)))
    torch.cuda.synchronize()
    assert cuda_sell.LAUNCHES > before[0]
    assert cuda_blocks.LAUNCHES_K3 - before[1] == gpu.fmts.count("dense")
    want = cpu.gather_result(cpu.step(cpu.set_features(x)))
    assert relative_error(got, want) <= relative_tolerance(gpu.nnz / 4096)


def _scaled_levels(kind):
    """BA 4096 at width 64 (ten block-diagonal levels): "rownorm" the
    row-normalized ``D⁻¹A`` (asymmetric values), "directed" keeping 70%
    of the entries (asymmetric pattern: the fold's transposed pack sorts
    its rows in another order)."""
    a = barabasi_albert(4096, 4, seed=1).astype(np.float32)
    if kind == "rownorm":
        deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
        m = (sparse.diags(1.0 / deg) @ a).tocsr().astype(np.float32)
    else:
        coo = a.tocoo()
        keep = np.random.default_rng(2).random(coo.nnz) < 0.7
        m = sparse.csr_matrix((coo.data[keep], (coo.row[keep],
                                                coo.col[keep])),
                              shape=a.shape)
    return m, arrow_decomposition(m, 64, max_levels=10,
                                  block_diagonal=True, seed=0)


@pytest.mark.parametrize("kind", ["rownorm", "directed"])
@pytest.mark.parametrize("fmt", ["fold", "dense", "ell", "hyb", "auto"])
def test_train_step_through_the_kernels_matches_the_cpu(cuda, kind, fmt):
    """One GCN training step (GCNCarried on the fold) on the card, whose
    backward runs K1-K4 over transposed operators, against the same step
    on the CPU (the plain versions): the loss, every gradient and the
    parameters after one Adam step; and the backward launched the
    format's kernels."""
    from arrow_matrix_tpu_torch.models import GCNCarried, GCNModel
    from arrow_matrix_tpu_torch.models.propagation import masked_mse

    m, levels = _scaled_levels(kind)
    kw = {} if fmt == "fold" else {"dense_budget": 4096 * 64 * 3 * 4 * 2}
    if fmt != "auto":
        kw["fmt"] = fmt
    x = random_dense(4096, 16, seed=5)
    y = random_dense(4096, 4, seed=6)
    res = {}
    for dev in (cuda, "cpu"):
        exe = MultiLevelArrow(levels, 64, device=dev, **kw)
        cls = GCNCarried if exe.folded else GCNModel
        model = cls(exe, (16, 8, 4), seed=3)
        mask = exe.carried_mask() if exe.folded else exe.real_row_mask()
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        xs, ys = exe.set_features(x), exe.set_features(y)
        before = (cuda_sell.LAUNCHES, cuda_blocks.LAUNCHES_K2,
                  cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD)
        opt.zero_grad()
        fwd = model(xs)
        loss = masked_mse(fwd, ys, mask)
        loss.backward()
        grads = [p.grad.cpu().numpy().copy() for p in model.parameters()]
        opt.step()
        if dev == cuda:
            torch.cuda.synchronize()
            delta = [a - b for a, b in zip(
                (cuda_sell.LAUNCHES, cuda_blocks.LAUNCHES_K2,
                 cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD), before)]
            if fmt in ("fold", "ell", "hyb", "auto"):
                assert delta[0] > 0
            if fmt in ("dense", "auto"):
                assert delta[1] > 0
            assert delta[2] > 0
            assert exe.transposed().packed
        res[str(dev)] = (float(loss.detach()), grads,
                         [p.detach().cpu().numpy() for p in
                          model.parameters()])
    (l_gpu, g_gpu, p_gpu), (l_cpu, g_cpu, p_cpu) = (res[str(cuda)],
                                                    res["cpu"])
    tol = relative_tolerance(m.nnz / 4096, 3)
    assert relative_error(l_gpu, l_cpu) <= tol
    for a, b in zip(g_gpu, g_cpu):
        assert relative_error(a, b) <= tol
    for a, b in zip(p_gpu, p_cpu):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fmt", ["fold", "dense", "ell", "hyb"])
def test_transposed_step_on_the_card_matches_scipy(cuda, fmt):
    """``Aᵀ g`` through the kernels over the transposed operators."""
    m, levels = _scaled_levels("directed")
    exe = MultiLevelArrow(levels, 64, fmt=fmt, device=cuda)
    g = random_dense(4096, 16, seed=7)
    got = exe.gather_result(exe.transposed_step(exe.set_features(g)))
    assert relative_error(got, m.T @ g) <= relative_tolerance(
        m.nnz / 4096)


def test_bench_on_the_card_prints_its_contract_line(cuda, tmp_path):
    """``python -m arrow_matrix_tpu_torch.bench`` at n = 2^14: the race of
    fold and hyb on the card, the k=128 rerun, every number gated."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, AMT_BENCH_N=str(1 << 14),
               AMT_BENCH_FMT="fold,hyb", AMT_BENCH_COMPARE="0",
               AMT_BENCH_CACHE_DIR=str(tmp_path / "cache"))
    proc = subprocess.run([sys.executable, "-m",
                           "arrow_matrix_tpu_torch.bench"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["platform"] == "gpu" and line.get("degraded") is None
    assert line["device_kind"] == torch.cuda.get_device_name(0)
    assert line["device_kind"] in line["card"]
    assert np.isfinite(line["value"])
    assert line["frobenius_err_vs_cpu"] <= line["frobenius_gate"]
    assert line["k128_err"] <= line["k128_gate"] and line["k128_ms"] > 0
    assert line["fmt_used"] in ("fold", "hyb")
    assert line["device_runs"][line["fmt_used"]]["launches"]["K1"] > 0


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_column_has_the_same_bits_at_every_k(cuda, binary, dtype):
    """K1 at k = 128 (the 47-chunk hub split over CTAs of one block)
    against every slab of k = 4 and 16 (the hub on one CTA) and 32 and
    64 (split over CTAs of several blocks): each column equal bit for
    bit, the serving runtime's batching and column-slab contract."""
    rng = np.random.default_rng(40 + binary)
    m = _multi_tier(rng, binary, cuda)
    x = torch.from_numpy(rng.uniform(-1, 1, (m.n_rows, 128)).astype(
        np.float32)).to(cuda).to(dtype)
    full = cuda_sell.sell_spmm_cuda(m, x)
    bits = (lambda t: t.view(torch.int16)) if dtype == torch.bfloat16 \
        else (lambda t: t.view(torch.int32))
    for k in (4, 16, 32, 64):
        for lo in range(0, 128, k):
            part = cuda_sell.sell_spmm_cuda(m, x[:, lo:lo + k].contiguous())
            assert torch.equal(bits(part), bits(full[:, lo:lo + k])), (k, lo)


def test_server_with_a_column_schedule_on_the_card(cuda):
    """A small server on the card with base rung repl=2, overlap_slabs=2
    and batching: every request completed with no fault, each result
    equal bit for bit to the plain rung's, within tolerance of the CPU
    server's, and K1 launched c x S products a step."""
    from arrow_matrix_tpu_torch import serve

    def run(device, cfg):
        fac, n = serve.ba_executor_factory(4096, 64, 5, device=device)
        srv = serve.ArrowServer(fac, cfg, max_batch_k=64,
                                policy=serve.scheduler.RetryPolicy(
                                    backoff_s=0.001))
        tickets = serve.run_trace(srv, serve.synthetic_trace(
            n, tenants=4, requests=8, k=16, iterations=3, seed=5))
        assert srv.summary()["faults_seen"] == 0
        assert [t.status for t in tickets] == ["completed"] * 8
        return srv, tickets

    before = cuda_sell.LAUNCHES
    srv, got = run(cuda, serve.ExecConfig(repl=2, overlap_slabs=2))
    assert srv.batches == 2
    ex = srv._build_executor(serve.ExecConfig(repl=2, overlap_slabs=2))
    per = sum(ex.sell.plans[(16, torch.float32, True)].wl.launches
              for _ in range(4))
    assert cuda_sell.LAUNCHES - before == srv.batches * 3 * per
    _, plain = run(cuda, serve.ExecConfig())
    _, cpu = run("cpu", serve.ExecConfig())
    for a, b, c in zip(got, plain, cpu):
        assert a.result.tobytes() == b.result.tobytes()
        assert relative_error(a.result, c.result) <= relative_tolerance(
            ex.nnz / 4096, 3)


def test_profiler_trace_records_k1_launches_by_name(cuda, tmp_path):
    """``utils/logging.trace`` on the card: the profile holds exactly the
    K1 launches the wrapper counted (``sell_kernel`` and, with split
    rows, ``sum_rows_kernel``), the tracer's span as an annotation, and
    kernel time inside the window; a smoke serve on the card stamps its
    ledger records with the card's name."""
    from arrow_matrix_tpu_torch import serve
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.obs import Tracer
    from arrow_matrix_tpu_torch.utils import logging as wb

    a = barabasi_albert(4096, 4, seed=1)
    levels = arrow_decomposition(a, 64, max_levels=10, block_diagonal=True,
                                 seed=0)
    ml = MultiLevelArrow(levels, 64, fmt="fold", device=cuda)
    x = ml.set_features(random_dense(4096, 16, seed=2))
    ml.run(x, 1)
    torch.cuda.synchronize()
    tr = Tracer("profiled")
    before = cuda_sell.LAUNCHES
    with wb.trace(str(tmp_path / "traces")) as prof:
        with tr.span("fold_chain"):
            ml.run(x, 5)
    launched = cuda_sell.LAUNCHES - before
    k1 = [k for k in prof.kernels
          if "sell_kernel" in k["name"] or "sum_rows_kernel" in k["name"]]
    assert launched > 0 and len(k1) == launched
    assert "fold_chain" in prof.annotations
    busy = sum(k["dur"] for k in prof.kernels)
    assert 0 < busy <= prof.wall_us
    summary = serve.smoke_serve(str(tmp_path / "smoke"))
    assert summary["completed"] == summary["requests"]
    recs = Ledger(str(tmp_path / "smoke" / "ledger")).read_all()
    assert {r["kind"] for r in recs} == {"serve", "pulse"}
    for r in recs:
        assert r["platform"] == "gpu"
        assert r["device_kind"] == torch.cuda.get_device_name(0)


def test_lens_profile_on_the_card_counts_k1_per_prefix(cuda, tmp_path):
    """``profile_fold`` on the card: the static tiers equal the CPU
    profile's, every live tier's prefix chain launched K1 (the warm-up
    and 5 sweeps of ``iters``), the document checks and its records are
    stamped with the card."""
    from arrow_matrix_tpu_torch.ledger import Ledger
    from arrow_matrix_tpu_torch.obs import lens
    from arrow_matrix_tpu_torch.tune import load_levels_from_source

    # 2^18 rows: K1's chains are device-bound at k=128 (at 2^14 the
    # launches' host time is the step's).
    levels, width = load_levels_from_source(
        {"kind": "ba", "n": 1 << 18, "m": 8, "width": 2048, "seed": 7,
         "max_levels": 10})
    iters = 10
    prof = lens.profile_fold(levels, width, 128,
                             feature_dtypes=("f32", "bf16"), iters=iters,
                             device=cuda)
    cpu = lens.profile_fold(levels, width, 8, feature_dtypes=("f32",),
                            iters=1, device="cpu")
    assert prof["platform"] == "gpu"
    assert prof["device_kind"] == torch.cuda.get_device_name(0)
    assert prof["structure_hash"] == cpu["structure_hash"]
    static = ("tier", "family", "rows", "nnz", "slots", "slot_width")
    for fd, entry in prof["dtypes"].items():
        assert entry["full_ms"] > 0 and entry["dma_wait_ms"] == {}
        assert entry["launches"] >= 6 * iters
        for t, c in zip(entry["tiers"], cpu["dtypes"]["f32"]["tiers"]):
            if fd == "f32":
                assert {f: t[f] for f in static} == \
                    {f: c[f] for f in static}
            if t["slot_width"] > 0:
                assert t["launches"] >= 6 * iters
    model = lens.fit_from_profile(prof)
    assert lens.check_profile(prof) == []
    d = str(tmp_path / "ledger")
    lens.record_profile(prof, model, directory=d)
    assert {r["platform"] for r in Ledger(d).read_all()} == {"gpu"}


def test_memory_report_of_a_fold_step_on_the_card(cuda):
    """``memory_report`` on the card reads the allocator: the arguments
    (carriage and operator) and the result from their tensors, the
    temporaries from the peak, all within the executor's HBM model."""
    from arrow_matrix_tpu_torch.obs import memview

    a = barabasi_albert(1 << 14, 8, seed=7)
    levels = arrow_decomposition(a, 256, max_levels=10,
                                 block_diagonal=True, seed=7)
    exe = MultiLevelArrow(levels, 256, fmt="fold", device=cuda)
    x = exe.set_features(random_dense(exe.n, 128, seed=3))
    exe.raw_step(x, exe.sell)            # the work list, built once
    rep = memview.memory_report(exe.raw_step, x, exe.sell)
    assert rep["source"] == "cuda_allocator"
    assert rep["argument_bytes"] == x.nbytes + exe.sell.device_nbytes()
    assert rep["output_bytes"] == x.nbytes
    assert rep["temp_bytes"] is not None and rep["temp_bytes"] >= 0
    assert rep["total_bytes"] <= exe.predicted_hbm_bytes(128)


# -- K1's launch knobs (ops/worklist.py:LaunchOpts) ----------------------------

def _knob_operator(cuda, binary):
    rng = np.random.default_rng(14)
    shapes = ((0, 9), (8, 3000), (40, 600), (300, 40), (2000, 3))
    n = sum(n_t for _, n_t in shapes)
    parts = [_tier(rng, m_t, n_t, n) for m_t, n_t in shapes]
    starts = np.cumsum([0] + [n_t for _, n_t in shapes[:-1]])
    return sell.sell_from_arrays(
        [p[0] for p in parts], None if binary else [p[2] for p in parts],
        [p[1] for p in parts] if binary else None, n, starts, device=cuda)


@pytest.mark.parametrize("cs", worklist.CHUNK_SLOTS_CHOICES)
@pytest.mark.parametrize("batch", worklist.BATCH_CHOICES)
@pytest.mark.parametrize("ctas", worklist.CTAS_PER_SM_CHOICES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_k1_at_every_knob_point_matches_its_twin(cuda, cs, batch, ctas,
                                                  dtype):
    opts = worklist.LaunchOpts(chunk_slots=cs, batch=batch,
                               ctas_per_sm=ctas)
    for binary in (True, False):
        m = _knob_operator(cuda, binary)
        for k in (16, 128):
            rng = np.random.default_rng(k)
            x = (torch.from_numpy(rng.integers(-127, 128, (m.n_rows, k))
                                  .astype(np.int8)).to(cuda)
                 if dtype == torch.int8 else
                 torch.from_numpy(rng.uniform(-1, 1, (m.n_rows, k))
                                  .astype(np.float32)).to(cuda).to(dtype))
            got = cuda_sell.sell_spmm_cuda(m, x, opts)
            wl = cuda_sell.plan_for(m, k, x.dtype, True, opts).wl
            twin = worklist.sell_spmm_worklist(m, x, wl)
            assert torch.equal(got, cuda_sell.sell_spmm_cuda(m, x, opts))
            if dtype == torch.bfloat16:
                assert bf16_within_one_ulp(got, twin, 2000.0)
            elif dtype == torch.int8 and binary:
                assert torch.equal(got, twin)
            else:
                assert relative_error(got.cpu().numpy(),
                                      twin.cpu().numpy()) <= \
                    relative_tolerance(2000.0)
            if opts.keeps_order():
                assert torch.equal(got, cuda_sell.sell_spmm_cuda(m, x))


def test_pallas_sell_fold_with_a_schedule_on_the_card(cuda):
    from arrow_matrix_tpu_torch.tune.fingerprint import structure_fingerprint
    from arrow_matrix_tpu_torch.tune.synth import synthesize_schedule

    a = barabasi_albert(4096, 3, seed=2)
    levels = arrow_decomposition(a, 128, max_levels=10,
                                 block_diagonal=True, seed=2)
    sched = synthesize_schedule(structure_fingerprint(levels, 128))
    ex = MultiLevelArrow(levels, 128, fmt="fold", kernel="pallas_sell",
                         kernel_opts={"schedule": sched}, device=cuda)
    base = MultiLevelArrow(levels, 128, fmt="fold", device=cuda)
    x = random_dense(4096, 128, seed=1)
    before = cuda_sell.LAUNCHES
    y = ex.gather_result(ex.step(ex.set_features(x)))
    assert cuda_sell.LAUNCHES - before >= 2
    assert np.array_equal(y, base.gather_result(base.step(
        base.set_features(x))))


def test_mesh_shard_kernels_match_their_twins(cuda):
    """K1 over a rank's body operator (its halo-extended operand ``[own
    rows; X_0; lo halos; hi halos]``, two hops each side) and its head,
    and K4's pack from ``[rows; zero row]`` and unpack from ``[rows;
    zero row; received slots]``, each source in two parts as the
    exchange passes it (its rows, then the zero row and the slots), on
    the card against the plain versions (K4 bit for bit, bf16 rows
    too)."""
    from arrow_matrix_tpu_torch.parallel.routing import (
        build_route,
        rank_route,
    )
    from arrow_matrix_tpu_torch.parallel.sell_slim import build_slim_level

    a = barabasi_albert(2048, 4, seed=13).astype(np.float32)
    ops = build_slim_level(a, 64, 4, np.float32, True)
    assert ops.hops >= 2
    ops.to_rank(2, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for name, rows in (("body", ops.operand_rows), ("head", ops.rows_out)):
        op = ops.dev[name]
        x = torch.rand((rows, 16), device=cuda, generator=gen)
        got = cuda_sell.sell_spmm_cuda(op, x)
        want = sell.sell_spmm(op, x)
        assert relative_error(got.cpu().numpy(), want.cpu().numpy()) \
            <= relative_tolerance(a.nnz / a.shape[0])
    rng = np.random.default_rng(1)
    table = rng.integers(0, 3072, 4096)
    rr = rank_route(build_route(table, 4, src_total=3072,
                                pad_mask=rng.random(4096) < 0.1), 1, cuda)
    for dtype in (torch.float32, torch.bfloat16):
        rows = torch.rand((768, 16), device=cuda, generator=gen).to(dtype)
        tail = torch.cat([torch.zeros((1, 16), device=cuda),
                          torch.rand((4 * rr.slots, 16), device=cuda,
                                     generator=gen)]).to(dtype)
        for idx, x2 in ((rr.send, tail[:1]), (rr.unpack, tail)):
            got = cuda_gather.row_gather(rows, idx, x2)
            want = torch.cat([rows, x2]).index_select(0, idx.long())
            assert torch.equal(got, want)


@pytest.mark.parametrize("banded", [False, True])
def test_k2_over_a_rank_shard_matches_its_twin(cuda, banded):
    """K2 over a mesh rank's block rows (stacks of its own blocks only,
    the operand ``[X_0; X_prev; own; X_next]`` or ``[X_0; own]``): the
    first rank's form (its head block left out), a middle rank's and the
    last rank's (its operand ending before ``X_next``), on the card
    against the plain twin."""
    rng = np.random.default_rng(4)
    nb_l, w, k = 3, 128, 16
    ext = nb_l + (3 if banded else 1)
    first = 2 if banded else 1
    x = torch.from_numpy(rng.standard_normal((ext, w, k))
                         .astype(np.float32)).to(cuda)
    for skip, end in ((1, ext), (0, ext), (0, ext - int(banded))):
        st = {name: torch.from_numpy(
            rng.standard_normal((nb_l - skip, w, w)).astype(np.float32))
            .to(cuda) for name in ("diag", "col", "lo", "hi")}
        lohi = (st["lo"], st["hi"]) if banded else ()
        before = cuda_blocks.LAUNCHES_K2
        got = cuda_blocks.column_rows_spmm(st["diag"], st["col"], x[:end],
                                           first + skip, *lohi)
        assert cuda_blocks.LAUNCHES_K2 == before + 1
        want = arrow_blocks.column_rows_spmm(st["diag"], st["col"],
                                             x[:end], first + skip, *lohi)
        assert relative_error(got.cpu().numpy(), want.cpu().numpy()) \
            <= relative_tolerance(4 * w)


def _two_rank_step(ctx, levels, width, x):
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellMultiLevel

    exe = SellMultiLevel(levels, width, make_mesh((ctx.world,), ("blocks",)))
    before = (cuda_sell.LAUNCHES, cuda_gather.LAUNCHES)
    c = exe.step(exe.set_features(x))
    torch.cuda.synchronize()
    launched = (cuda_sell.LAUNCHES - before[0],
                cuda_gather.LAUNCHES - before[1])
    want = exe.launch_counts(x.shape[1])
    return exe.gather_result(c), launched, (want["K1"], want["K4"]), \
        str(c.device)


def test_two_gloo_ranks_step_on_one_card(cuda):
    """SellMultiLevel on two gloo ranks sharing the card: their tensors
    on the card, K1 and K4 launched as the executor counts them, the
    result within the gate of the host golden."""
    from arrow_matrix_tpu_torch.parallel.launch import spawn

    a = barabasi_albert(4096, 4, seed=3)
    levels = arrow_decomposition(a, 128, max_levels=4, block_diagonal=True,
                                 seed=3)
    x = random_dense(4096, 16, seed=1)
    res = spawn(_two_rank_step, 2, args=(levels, 128, x), backend="gloo",
                job_timeout_s=300)
    out, launched, want, dev = res[0]
    assert dev.startswith("cuda")
    for r in res:
        assert r[1] == r[2] and r[1][0] > 0
    assert relative_error(out, decomposition_spmm(levels, x)) \
        <= relative_tolerance(a.nnz / a.shape[0])


def _launches():
    from arrow_matrix_tpu_torch.ops import cuda_blocks

    return {"K1": cuda_sell.LAUNCHES, "K2": cuda_blocks.LAUNCHES_K2,
            "K3": cuda_blocks.LAUNCHES_K3, "K4": cuda_gather.LAUNCHES,
            "K4 add": cuda_gather.LAUNCHES_ADD}


def _card_and_plain(ctx, kind, levels, width, x, g, kw, shape, names):
    """One mesh executor built twice in each rank, over a mesh on the
    card (its kernels) and over one on the CPU (their plain versions):
    the forward step, its launches beside ``launch_counts``, and the
    transposed step, each gathered on every rank."""
    from arrow_matrix_tpu_torch.parallel import (
        MultiLevelArrow,
        SellMultiLevel,
        SellSpaceShared,
        SpaceSharedArrow,
    )
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for where in ("card", "cpu"):
        mesh = make_mesh(shape, names, device=None if where == "card"
                         else "cpu")
        exe = {"sell": lambda: SellMultiLevel(levels, width, mesh, **kw),
               "arrow": lambda: MultiLevelArrow(levels, width, mesh=mesh,
                                                **kw),
               "space": lambda: SpaceSharedArrow(levels, width, mesh, **kw),
               "sell_space": lambda: SellSpaceShared(levels, width, mesh,
                                                     **kw)}[kind]()
        c = exe.set_features(x)
        exe.transposed()
        torch.cuda.synchronize()
        before = _launches()
        y = exe.step(c)
        torch.cuda.synchronize()
        after = _launches()
        t = exe.transposed_step(exe.set_features(g).float())
        out[where] = {"step": exe.gather_result(y),
                      "t": exe.gather_result(t),
                      "launched": {name: after[name] - before[name]
                                   for name in after},
                      "device": str(y.device)}
        if where == "card":
            out["want"] = exe.launch_counts(x.shape[1])
    return out


@pytest.mark.parametrize("kind,kw,shape,names", [
    ("sell", {}, (4,), ("blocks",)),
    ("arrow", {"fmt": "ell"}, (4,), ("blocks",)),
    ("arrow", {"fmt": "dense", "routing": "a2a"}, (4,), ("blocks",)),
    ("space", {"fmt": "dense"}, (2, 2), ("lvl", "blocks")),
    ("space", {"fmt": "ell"}, (2, 2), ("lvl", "blocks")),
    ("sell_space", {}, (2, 2), ("lvl", "blocks"))])
def test_mesh_backward_and_space_steps_on_the_card(cuda, kind, kw, shape,
                                                   names):
    """On 4 gloo ranks sharing the card, over ``D⁻¹A`` of a directed graph
    (every level packed transposed): each mesh executor's step and
    transposed step on the card against the same executor over a CPU
    mesh (the kernels' plain versions), within the gate; the forward
    step launched its kernels exactly as ``launch_counts`` says."""
    from arrow_matrix_tpu_torch.parallel.launch import spawn

    n = 2048
    a = barabasi_albert(n, 4, seed=43, directed=True).astype(np.float32)
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    a = (sparse.diags(1.0 / deg) @ a).tocsr().astype(np.float32)
    levels = arrow_decomposition(a, 64, max_levels=2, block_diagonal=True,
                                 seed=3)
    x, g = random_dense(n, 16, seed=1), random_dense(n, 16, seed=2)
    res = spawn(_card_and_plain, 4, args=(kind, levels, 64, x, g, kw,
                                          shape, names),
                backend="gloo", job_timeout_s=600)
    tol = relative_tolerance(a.nnz / n)
    for r in res:
        card, plain = r["card"], r["cpu"]
        assert card["device"].startswith("cuda")
        assert relative_error(card["step"], plain["step"]) <= tol
        assert relative_error(card["t"], plain["t"]) <= tol
        for name, v in r["want"].items():
            assert card["launched"][name] == v, (name, card["launched"])
        assert not any(plain["launched"].values())
    assert relative_error(res[0]["card"]["step"],
                          decomposition_spmm(levels, x)) <= tol
    if kind in ("sell", "arrow"):
        assert relative_error(res[0]["card"]["t"], a.T @ g) <= tol


def _baseline_card_and_plain(ctx, kind, a, x, kw, shape, names, steps):
    """One baseline built twice in each rank, over a mesh on the card (K1
    and K4) and over one on the CPU (their plain versions): ``steps``
    chained steps, the launches of the first beside ``launch_counts``,
    and the results gathered on every rank."""
    from arrow_matrix_tpu_torch.parallel import MatrixSlice1D, SpMM15D
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for where in ("card", "cpu"):
        mesh = make_mesh(shape, names, device=None if where == "card"
                         else "cpu")
        exe = (MatrixSlice1D(a, mesh, **kw) if kind == "1d"
               else SpMM15D(a, mesh, **kw))
        c = exe.set_features(x)
        torch.cuda.synchronize()
        before = _launches()
        c = exe.spmm(c)
        torch.cuda.synchronize()
        after = _launches()
        for _ in range(steps - 1):
            c = exe.spmm(c)
        again = exe.spmm(exe.set_features(x))
        out[where] = {"y": exe.gather_result(c),
                      "repeat": exe.gather_result(again),
                      "launched": {name: after[name] - before[name]
                                   for name in after},
                      "device": str(c.device)}
        if where == "card":
            out["want"] = exe.launch_counts(x.shape[1])
    return out


@pytest.mark.parametrize("kind,shape,names,kw", [
    ("1d", (4,), ("slices",), {}),
    ("1d", (4,), ("slices",), {"slices": [(0, 0), (0, 700), (700, 1500),
                                          (1500, 2048)]}),
    ("15d", (4, 1), ("rows", "repl"), {}),
    ("15d", (2, 2), ("rows", "repl"), {})])
def test_baseline_steps_on_the_card_match_their_plain_versions(
        cuda, kind, shape, names, kw):
    """MatrixSlice1D and SpMM15D on 4 gloo ranks sharing the card: a step
    and a chain of 3 against the same executor over a CPU mesh (the
    kernels' plain versions) and against the host, within the gate; K1
    (and the 1D pack, K4) launched as ``launch_counts`` says, nothing
    else; a repeat bit-equal (an empty slice among the ranks)."""
    from arrow_matrix_tpu_torch.parallel.launch import spawn
    from arrow_matrix_tpu_torch.utils.graphs import random_csr

    n = 2048
    a = random_csr(n, n, 16, seed=42).astype(np.float32)
    a = (a / max(abs(a).sum(axis=1).max(), 1.0)).tocsr().astype(np.float32)
    x = random_dense(n, 16, seed=1)
    res = spawn(_baseline_card_and_plain, 4,
                args=(kind, a, x, kw, shape, names, 3), backend="gloo",
                job_timeout_s=600)
    tol3 = relative_tolerance(a.nnz / n, 3)
    want = x
    for _ in range(3):
        want = a @ want
    for r in res:
        card, plain = r["card"], r["cpu"]
        assert card["device"].startswith("cuda")
        assert relative_error(card["y"], plain["y"]) <= tol3
        assert relative_error(card["y"], want) <= tol3
        assert np.array_equal(card["repeat"], res[0]["card"]["repeat"])
        for name in ("K2", "K3", "K4 add"):
            assert card["launched"][name] == 0
        for name, v in r["want"].items():
            assert card["launched"][name] == v, (name, card["launched"])
        assert card["launched"]["K1"] > 0
        assert not any(plain["launched"].values())
    assert relative_error(res[0]["card"]["repeat"], a @ x) \
        <= relative_tolerance(a.nnz / n)


@pytest.mark.parametrize("which", ["identity", "zero"])
def test_a_baseline_stack_with_no_slots_launches_nothing(cuda, which):
    """The identity has no nonlocal part: no exchange, no pack, one K1
    launch a step; a matrix with no nonzeros has no slots at all and
    launches nothing (an empty grid is never launched); both exact."""
    from arrow_matrix_tpu_torch.parallel.launch import spawn

    n = 512
    a = (sparse.identity(n, format="csr", dtype=np.float32)
         if which == "identity" else sparse.csr_matrix((n, n),
                                                       dtype=np.float32))
    x = random_dense(n, 8, seed=3)
    res = spawn(_baseline_card_and_plain, 2,
                args=("1d", a, x, {}, (2,), ("slices",), 1),
                backend="gloo", job_timeout_s=300)
    for r in res:
        card = r["card"]
        assert np.array_equal(card["y"], np.asarray(a @ x))
        assert card["launched"]["K4"] == 0 == r["want"]["K4"]
        assert card["launched"]["K1"] == r["want"]["K1"] \
            == (1 if which == "identity" else 0)

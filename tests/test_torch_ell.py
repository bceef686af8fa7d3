"""The port's ELL block format and ``fmt="ell"`` / ``fmt="auto"``
executors against the JAX package: the host packers byte for byte, the
plain products and K1's form of every stack and head layout against the
JAX XLA products, and whole decompositions over 2 steps against the JAX
``MultiLevelArrow`` and the scipy golden."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from scipy import sparse

from arrow_matrix_tpu.ops import arrow_blocks as jax_blocks
from arrow_matrix_tpu.ops import ell as jax_ell
from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu.parallel.multi_level import (
    gather_budget_for as jax_gather_budget_for,
    resolve_chunk as jax_resolve_chunk,
)
from arrow_matrix_tpu_torch.decomposition import (
    ArrowLevel,
    arrow_decomposition,
    decomposition_spmm,
)
from arrow_matrix_tpu_torch.ops import arrow_blocks, cuda_ell, ell
from arrow_matrix_tpu_torch.ops.arrow_blocks import (
    arrow_blocks_from_csr,
    block_row_stats,
)
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.parallel.multi_level import resolve_chunk
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)
from arrow_matrix_tpu_torch.utils.platform import (
    device_memory_budget,
    gather_budget_for,
)

from helpers import arrow_csr

torch.set_num_threads(2)

HEADS = ["auto", "flat", "ell", "gell"]


def _graph_levels(n, width, block_diagonal, weighted=False, seed=2):
    a = barabasi_albert(n, 3, seed=seed)
    levels = arrow_decomposition(a, width, max_levels=3,
                                 block_diagonal=block_diagonal, seed=0)
    if not weighted:
        return levels
    rng = np.random.default_rng(seed)
    out = []
    for lvl in levels:
        m = lvl.matrix.copy()
        m.data = rng.uniform(0.5, 1.5, m.nnz).astype(np.float32)
        out.append(ArrowLevel(m, lvl.permutation, lvl.arrow_width))
    return out


def _random_blocks(seed, w=16, count=5, skew=False):
    rng = np.random.default_rng(seed)
    mats = [None]
    for i in range(count):
        m = sparse.random(w, w, density=0.2, random_state=rng,
                          dtype=np.float32).tolil()
        if skew and i == 1:
            m[3, :] = rng.uniform(0.5, 1.5, w).astype(np.float32)
        mats.append(m.tocsr())
    mats.append(sparse.csr_matrix((w, w), dtype=np.float32))
    return mats


def _np(t):
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.cpu().numpy()


# -- host packers -------------------------------------------------------------

@pytest.mark.parametrize("index_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("seed", [0, 1])
def test_ell_packers_are_byte_equal_to_jax(index_dtype, seed):
    mats = _random_blocks(seed, skew=True)
    for got, want in (
            (ell.ell_pack(mats[1], index_dtype=index_dtype),
             jax_ell.ell_pack(mats[1], index_dtype=index_dtype)),
            (ell.ell_pack(mats[2], max_nnz=24, with_data=False),
             jax_ell.ell_pack(mats[2], max_nnz=24, with_data=False)),
            (ell.ell_pack_stack(mats, rows=16, index_dtype=index_dtype),
             jax_ell.ell_pack_stack(mats, rows=16,
                                    index_dtype=index_dtype)),
            (ell.ell_pack_stack_binary(mats, rows=16,
                                       index_dtype=index_dtype),
             jax_ell.ell_pack_stack_binary(mats, rows=16,
                                           index_dtype=index_dtype)),
            (ell.flat_pack_stack(mats, rows=16, index_dtype=index_dtype),
             jax_ell.flat_pack_stack(mats, rows=16,
                                     index_dtype=index_dtype)),
            (ell.csr_flat_pack(mats[3], index_dtype=index_dtype),
             jax_ell.csr_flat_pack(mats[3], index_dtype=index_dtype))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
    with pytest.raises(ValueError, match="max_nnz"):
        ell.ell_pack(mats[2], max_nnz=1)
    with pytest.raises(ValueError, match="no non-empty blocks"):
        ell.ell_pack_stack([None, None])
    assert ell.ell_pack_stack([None], rows=4)[0].shape == (1, 4, 0)


def test_index_dtype_chunk_and_stats_follow_jax():
    for w in (16, 2048, 32766, 32767, 40000):
        assert ell.block_index_dtype(w) == jax_ell.block_index_dtype(w)
    for rows, k, m, budget in [(1000, 16, 40, 1 << 20), (4096, 3, 8, 1),
                               (100, 33, 1000, 1 << 16), (10, 5, 0, 1),
                               (1 << 20, 128, 300, 1 << 30),
                               (64, 16, 24, 64 * 16 * 4 * 24)]:
        assert ell.auto_chunk(rows, k, m, budget) == jax_ell.auto_chunk(
            rows, k, m, budget, lanes=1)
    mats = _random_blocks(3)
    cols, data = jax_ell.ell_pack_stack(mats, rows=16)
    bcols, deg = jax_ell.ell_pack_stack_binary(mats, rows=16)
    for args in ((cols, data), (bcols, None, deg), (cols,)):
        for g, w in zip(ell.ell_slot_stats(*args),
                        jax_ell.ell_slot_stats(*args)):
            assert np.array_equal(g, w)
    rows, _, _ = jax_ell.flat_pack_stack(mats, rows=16)
    for g, w in zip(ell.flat_slot_stats(rows, 16),
                    jax_ell.flat_slot_stats(rows, 16)):
        assert np.array_equal(g, w)
    for budget in (1, 1 << 20, 1 << 40):
        assert gather_budget_for(budget) == jax_gather_budget_for(budget)
    assert device_memory_budget(torch.device("cpu")) > 0


# -- plain products -----------------------------------------------------------

@pytest.mark.parametrize("k", [3, 5, 33])
@pytest.mark.parametrize("chunk", [None, 8])
def test_plain_ell_products_match_jax(k, chunk):
    mats = _random_blocks(k, skew=True)
    rng = np.random.default_rng(k)
    x = rng.standard_normal((len(mats), 16, k)).astype(np.float32)
    cols, data = jax_ell.ell_pack_stack(mats, rows=16, index_dtype=np.int16)
    bcols, deg = jax_ell.ell_pack_stack_binary(mats, rows=16)
    tol = relative_tolerance(16)
    t = torch.from_numpy
    got = ell.ell_spmm_batched(t(cols), t(data), t(x), chunk=chunk)
    want = jax_ell.ell_spmm_batched(jnp.asarray(cols), jnp.asarray(data),
                                    jnp.asarray(x), chunk=chunk)
    assert relative_error(_np(got), np.asarray(want)) <= tol
    got = ell.ell_spmm_batched(t(bcols), None, t(x), chunk=chunk,
                               deg=t(deg))
    want = jax_ell.ell_spmm_batched(jnp.asarray(bcols), None,
                                    jnp.asarray(x), chunk=chunk,
                                    deg=jnp.asarray(deg))
    assert relative_error(_np(got), np.asarray(want)) <= tol
    got = ell.ell_spmm_shared(t(cols), t(data), t(x[0]), chunk=chunk)
    want = np.stack([np.asarray(jax_ell.ell_spmm(
        jnp.asarray(c), jnp.asarray(d), jnp.asarray(x[0]), chunk=chunk))
        for c, d in zip(cols, data)])
    assert relative_error(_np(got), want) <= tol
    got = ell.ell_spmm(t(cols[2]), None, t(x[2]), chunk=chunk,
                       deg=t(deg[2]))
    want = jax_ell.ell_spmm(jnp.asarray(cols[2]), None, jnp.asarray(x[2]),
                            chunk=chunk, deg=jnp.asarray(deg[2]))
    assert relative_error(_np(got), np.asarray(want)) <= tol
    r, c, d = jax_ell.csr_flat_pack(mats[2], index_dtype=np.int16)
    for dd in (d, None):
        got = ell.csr_flat_spmm(t(r), t(c), None if dd is None else t(dd),
                                t(x[2]), 16)
        want = jax_ell.csr_flat_spmm(
            jnp.asarray(r), jnp.asarray(c),
            None if dd is None else jnp.asarray(dd), jnp.asarray(x[2]), 16)
        assert relative_error(_np(got), np.asarray(want)) <= tol
    with pytest.raises(ValueError, match="requires deg"):
        ell.ell_spmm(t(cols[2]), None, t(x[2]))


@pytest.mark.parametrize("name", ["head", "diag", "col", "lo", "hi"])
@pytest.mark.parametrize("binary", [True, False])
def test_stack_tier_through_k1s_plain_version_matches_batched(name,
                                                              binary):
    """The converter: one K1 tier over global columns (ell_tier_spmm, K1's
    plain version) gives each block's product with the X block its stack
    reads, as ell_spmm_batched does."""
    nb, w, k = 6, 16, 5
    mats = _random_blocks(7, w=w, count=nb - 2)
    if name == "lo":
        mats[:2] = [None, None]
    if name == "hi":
        mats[0] = mats[-1] = None
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((nb, w, k)).astype(np.float32))
    if binary:
        cols, deg = ell.ell_pack_stack_binary(mats, rows=w,
                                              index_dtype=np.int16)
        weights = dict(deg=torch.from_numpy(deg))
    else:
        cols, data = ell.ell_pack_stack(mats, rows=w, index_dtype=np.int16)
        weights = dict(data=torch.from_numpy(data))
    c = torch.from_numpy(cols)
    tier, d, g = ell.ell_stack_tier(c, cuda_ell.stack_offsets(name, nb, w),
                                    **weights)
    assert tier.dtype == torch.int32 and tier.shape == (cols.shape[2],
                                                        nb * w)
    assert int(tier.min()) >= 0 and int(tier.max()) < nb * w
    got = ell.ell_tier_spmm(tier, x.reshape(nb * w, k), data=d, deg=g)
    shift = {"head": 0, "diag": 0, "lo": -1, "hi": 1, "col": None}[name]
    blocks = torch.stack([
        x[0] if shift is None else
        x[i + shift] if 0 <= i + shift < nb else torch.zeros((w, k))
        for i in range(nb)])
    want = ell.ell_spmm_batched(c, weights.get("data"), blocks,
                                deg=weights.get("deg"))
    assert relative_error(_np(got).reshape(nb, w, k), _np(want)) <= \
        relative_tolerance(w)


# -- ELL arrow blocks ---------------------------------------------------------

def _arrays_equal(ours, theirs):
    for f in ("head_cols", "head_data", "diag_cols", "diag_data",
              "col_cols", "col_data", "lo_cols", "lo_data", "hi_cols",
              "hi_data", "head_rows", "head_deg", "diag_deg", "col_deg",
              "lo_deg", "hi_deg"):
        got, want = getattr(ours, f), getattr(theirs, f)
        assert (got is None) == (want is None), f
        if got is None:
            continue
        want = np.asarray(want)
        if want.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16, f
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16)), f
            continue
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f


@pytest.mark.parametrize("head_fmt", HEADS)
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("banded", [False, True])
def test_ell_blocks_are_byte_equal_to_jax(head_fmt, binary, banded):
    a = arrow_csr(5, 16, banded=banded, seed=3)
    if binary:
        a.data[:] = 1.0
    # A skewed head row, so that "auto" may pick the flat head.
    a = a.tolil()
    a[2, :] = 1.0 if binary else 0.5
    a = a.tocsr()
    ours = arrow_blocks_from_csr(a, 16, banded=banded, pad_blocks_to=6,
                                 fmt="ell", head_fmt=head_fmt,
                                 device="cpu")
    theirs = jax_blocks.arrow_blocks_from_csr(
        a, 16, banded=banded, pad_blocks_to=6, fmt="ell",
        head_fmt=head_fmt)
    assert (ours.head_flat, ours.head_gell, ours.binary) == \
        (theirs.head_flat, theirs.head_gell, theirs.binary)
    assert (ours.n_blocks, ours.width, ours.fmt) == (6, 16, "ell")
    _arrays_equal(ours, theirs)
    stats, jstats = block_row_stats(ours), jax_blocks.block_row_stats(
        theirs)
    for key in ("rows", "nnz", "slots"):
        assert np.array_equal(stats[key], jstats[key]), key
    x = random_dense(96, 5, seed=4).reshape(6, 16, 5)
    want = np.asarray(jax_blocks.arrow_spmm(theirs, jnp.asarray(x)))
    tol = relative_tolerance(16)
    for chunk in (None, 8):
        got = arrow_blocks.arrow_spmm(ours, torch.from_numpy(x),
                                      chunk=chunk)
        assert relative_error(_np(got), want) <= tol
    got = cuda_ell.arrow_spmm_k1(ours, torch.from_numpy(x))
    assert relative_error(_np(got), want) <= tol


def test_ell_blocks_in_bf16_are_byte_equal_to_jax():
    a = arrow_csr(4, 16, seed=9)
    a.data = np.random.default_rng(9).uniform(
        -1, 1, a.nnz).astype(np.float32)
    for head_fmt in ("flat", "gell", "ell"):
        ours = arrow_blocks_from_csr(a, 16, fmt="ell", head_fmt=head_fmt,
                                     dtype="bf16", device="cpu")
        theirs = jax_blocks.arrow_blocks_from_csr(
            a, 16, fmt="ell", head_fmt=head_fmt, dtype=ml_dtypes.bfloat16)
        _arrays_equal(ours, theirs)
        x = random_dense(64, 4, seed=1).reshape(4, 16, 4)
        got = cuda_ell.arrow_spmm_k1(ours, torch.from_numpy(x))
        want = arrow_blocks.arrow_spmm(ours, torch.from_numpy(x))
        assert relative_error(_np(got), _np(want)) <= relative_tolerance(16)


def test_head_decisions_follow_jax():
    levels = _graph_levels(1000, 32, True)
    for lvl in levels:
        for nb in (1, 4):
            assert arrow_blocks.head_stats(lvl.matrix, 32, nb) == \
                jax_blocks.head_stats(lvl.matrix, 32, nb)
    for args in [(8, 32, 40, 90), (8, 32, 4, 90), (31, 64, 200, 250),
                 (2, 16, 0, 0)]:
        for dtype in (np.float32, ml_dtypes.bfloat16):
            for head_fmt in ("auto", "flat", "ell"):
                assert arrow_blocks.choose_flat_head_from_stats(
                    *args, dtype, head_fmt) == \
                    jax_blocks.choose_flat_head_from_stats(
                        *args, dtype, head_fmt)
    with pytest.raises(ValueError, match="unknown head format"):
        arrow_blocks.choose_flat_head_from_stats(1, 1, 1, 1, np.float32,
                                                 "coo")
    with pytest.raises(ValueError, match="gell"):
        arrow_blocks.head_block_spmm(
            arrow_blocks_from_csr(arrow_csr(3, 16), 16, fmt="ell",
                                  head_fmt="gell", device="cpu"),
            torch.zeros((3, 16, 2)))


def test_grown_level_in_ell_raises_without_its_own_width():
    a = arrow_csr(4, 16, banded=True, seed=5)
    with pytest.raises(ValueError, match="captured"):
        arrow_blocks_from_csr(a, 16, banded=False, fmt="ell", device="cpu")
    with pytest.raises(ValueError, match="unknown block format"):
        arrow_blocks_from_csr(a, 16, fmt="coo", device="cpu")


# -- executors ----------------------------------------------------------------

def _two_steps(executor, x):
    return executor.gather_result(executor.run(executor.set_features(x), 2))


@pytest.mark.parametrize("n,width,k,block_diagonal,weighted,head_fmt", [
    (777, 32, 3, True, False, "auto"),
    (777, 32, 5, False, True, "flat"),
    (1000, 64, 33, True, True, "ell"),
    (1000, 32, 5, False, False, "gell"),
    (777, 64, 3, True, False, "gell"),
    (1000, 32, 33, True, False, "flat"),
])
def test_ell_executor_matches_jax_over_two_steps(n, width, k,
                                                 block_diagonal, weighted,
                                                 head_fmt):
    levels = _graph_levels(n, width, block_diagonal, weighted)
    x = random_dense(n, k, seed=7)
    ours = MultiLevelArrow(levels, width, fmt="ell", head_fmt=head_fmt,
                           banded=not block_diagonal, device="cpu")
    theirs = JaxArrow(levels, width, fmt="ell", head_fmt=head_fmt,
                      banded=not block_diagonal)
    assert ours.fmts == theirs.fmts == ["ell"] * len(levels)
    assert ours.widths == theirs.widths
    assert ours.total_rows == theirs.total_rows
    assert ours.binary == theirs.binary == (not weighted)
    assert ours.head_layouts() == [
        "gell" if b.head_gell else "flat" if b.head_flat else "ell"
        for b in theirs.blocks]
    for ob, tb in zip(ours.blocks, theirs.blocks):
        _arrays_equal(ob, tb)
    got = _two_steps(ours, x)
    tol = relative_tolerance(ours.nnz / n, 2)
    assert relative_error(got, _two_steps(theirs, x)) <= tol
    golden = decomposition_spmm(levels, decomposition_spmm(levels, x))
    assert relative_error(got, golden) <= tol


@pytest.mark.parametrize("block_diagonal", [True, False])
@pytest.mark.parametrize("n", [777, 1000])
def test_auto_executor_mixes_dense_and_ell_like_jax(n, block_diagonal):
    width = 32
    levels = _graph_levels(n, width, block_diagonal)
    rows = JaxArrow(levels, width, fmt="ell",
                    banded=not block_diagonal).total_rows
    budget = rows * width * 3 * 4 + 1          # one block-diagonal level
    ours = MultiLevelArrow(levels, width, dense_budget=budget,
                           banded=not block_diagonal, device="cpu")
    theirs = JaxArrow(levels, width, dense_budget=budget,
                      banded=not block_diagonal)
    assert ours.fmt == "auto"
    assert ours.fmts == theirs.fmts
    assert "ell" in ours.fmts
    x = random_dense(n, 5, seed=8)
    got = _two_steps(ours, x)
    tol = relative_tolerance(ours.nnz / n, 2)
    assert relative_error(got, _two_steps(theirs, x)) <= tol
    golden = decomposition_spmm(levels, decomposition_spmm(levels, x))
    assert relative_error(got, golden) <= tol


@pytest.mark.parametrize("budget_levels", [0, 1, 99])
def test_default_build_resolves_like_jax(budget_levels):
    """The pin of the default format: both packages built with only
    (levels, width, dense_budget=B) make the same formats, and the
    port's carriage has the reference's real-row mask."""
    levels = arrow_decomposition(barabasi_albert(256, 3, seed=2), 32,
                                 max_levels=10, block_diagonal=True, seed=0)
    theirs = JaxArrow(levels, 32, fmt="ell")
    budget = budget_levels * theirs.total_rows * 32 * 3 * 4
    ours = MultiLevelArrow(levels, 32, dense_budget=budget, device="cpu")
    theirs = JaxArrow(levels, 32, dense_budget=budget)
    assert ours.fmts == theirs.fmts
    mask = ours.real_row_mask()
    assert mask.shape == (ours.total_rows, 1) and mask.dtype == torch.float32
    assert np.array_equal(mask.numpy(), np.asarray(theirs.real_row_mask()))
    assert ours.real_row_mask(np.float64).dtype == torch.float64
    x = random_dense(256, 4, seed=1)
    c = ours.set_features(x)
    assert torch.equal(ours.run(c, 2, donate=True), ours.run(c, 2))
    with pytest.raises(TypeError):
        MultiLevelArrow(levels, 32, None, device="cpu")


def test_chunk_resolution_and_explicit_chunks_follow_jax():
    levels = _graph_levels(1000, 32, True)
    ours = MultiLevelArrow(levels, 32, fmt="ell", device="cpu")
    theirs = JaxArrow(levels, 32, fmt="ell")
    for budget in (1, 1 << 12, 1 << 30):
        for k in (3, 33):
            for ob, tb in zip(ours.blocks, theirs.blocks):
                assert resolve_chunk("auto", ob, ours.total_rows, k,
                                     budget) == jax_resolve_chunk(
                    "auto", tb, theirs.total_rows, k, budget)
    x = random_dense(1000, 5, seed=9)
    want = _two_steps(ours, x)
    for chunk in (8, None):
        other = MultiLevelArrow(levels, 32, fmt="ell", chunk=chunk,
                                device="cpu")
        assert relative_error(_two_steps(other, x), want) <= \
            relative_tolerance(ours.nnz / 1000, 2)


def test_level_k1_forms_match_the_plain_products():
    """On the CPU every ELL level's K1 form (the card's path, through
    K1's plain version) agrees with the plain product, for each head
    layout the build picks."""
    levels = _graph_levels(1000, 32, False, weighted=True)
    x = torch.from_numpy(random_dense(1024, 6, seed=3))
    for head_fmt in ("flat", "ell", "gell"):
        exe = MultiLevelArrow(levels, 32, fmt="ell", head_fmt=head_fmt,
                              banded=True, device="cpu")
        for blk, w in zip(exe.blocks, exe.widths):
            xb = x[:exe.total_rows].reshape(-1, w, 6)
            got = cuda_ell.arrow_spmm_k1(blk, xb)
            want = arrow_blocks.arrow_spmm(blk, xb)
            assert relative_error(_np(got), _np(want)) <= \
                relative_tolerance(w)
            ops = cuda_ell.k1_operands(blk)
            assert ops is blk.k1 and cuda_ell.k1_operands(blk) is ops
            assert blk.device_nbytes() > sum(
                t.numel() * t.element_size()
                for t in blk.tensors().values())


def _slot_major_tier(seed, m=12, rows=300, n_cols=400):
    """A slot-major ``(m, rows)`` tier: degrees 0..m, padding slots at
    column 0 with weight 0."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, m + 1, rows).astype(np.int32)
    pad = np.arange(m)[:, None] >= deg[None, :]
    cols = np.where(pad, 0, rng.integers(0, n_cols, (m, rows))).astype(
        np.int32)
    data = np.where(pad, 0, rng.uniform(-1, 1, (m, rows))).astype(np.float32)
    return cols, data, deg


@pytest.mark.parametrize("k", [16, 128])
@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("chunk", [None, 5])
def test_ell_spmm_t_matches_jax(k, binary, chunk):
    """The feature-major slot-major product, binary (``deg``) and
    weighted (``data``), against JAX's ``ell_spmm_t`` on the same
    arrays."""
    cols, data, deg = _slot_major_tier(k + binary)
    x_t = random_dense(k, 400, seed=k).astype(np.float32)
    want = np.asarray(jax_ell.ell_spmm_t(
        jnp.asarray(cols), jnp.asarray(x_t),
        data=None if binary else jnp.asarray(data),
        deg=jnp.asarray(deg) if binary else None, chunk=chunk))
    got = ell.ell_spmm_t(torch.from_numpy(cols), torch.from_numpy(x_t),
                         data=None if binary else torch.from_numpy(data),
                         deg=torch.from_numpy(deg) if binary else None,
                         chunk=chunk)
    assert tuple(got.shape) == want.shape == (k, 300)
    assert relative_error(got.numpy(), want) <= relative_tolerance(12)


def test_ell_spmm_t_edges_follow_jax():
    """No slots gives zeros; binary without ``deg`` raises as JAX's."""
    x_t = torch.ones((4, 10))
    empty = torch.zeros((0, 7), dtype=torch.int32)
    got = ell.ell_spmm_t(empty, x_t)
    want = jax_ell.ell_spmm_t(jnp.zeros((0, 7), jnp.int32), jnp.ones((4, 10)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="requires deg"):
        ell.ell_spmm_t(torch.zeros((2, 7), dtype=torch.int32), x_t)
    with pytest.raises(ValueError, match="requires deg"):
        jax_ell.ell_spmm_t(jnp.zeros((2, 7), jnp.int32), jnp.ones((4, 10)))

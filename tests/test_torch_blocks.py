"""The port's dense arrow blocks against the JAX package: the same
blocks cut out of the same matrix, stacks packed byte for byte, and the
plain column / head / whole-level products against the JAX Pallas
kernels (interpret mode on the CPU) and the JAX XLA product."""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch
from scipy import sparse

from arrow_matrix_tpu.io.graphio import load_block as jax_load_block
from arrow_matrix_tpu.ops import arrow_blocks as jax_blocks
from arrow_matrix_tpu.ops.pallas_blocks import (
    arrow_spmm_pallas,
    column_spmm_pallas,
    head_spmm_pallas,
)
from arrow_matrix_tpu_torch.io import load_block, num_nonzeros
from arrow_matrix_tpu_torch.ops import arrow_blocks, cuda_blocks
from arrow_matrix_tpu_torch.ops.arrow_blocks import (
    arrow_blocks_from_csr,
    block_features,
    block_row_stats,
    block_row_stats_from_csr,
    resolve_block_dtype,
    unblock_features,
)
from arrow_matrix_tpu_torch.ops.ell import dense_pack_stack
from arrow_matrix_tpu_torch.utils import relative_error, relative_tolerance

from helpers import arrow_csr

torch.set_num_threads(2)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bytes of a port stack, comparable with a JAX stack's."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 \
        else a.view(np.uint32)


def _weighted_arrow(nb, w, banded, seed):
    """An arrow matrix with values off the bf16 grid (rounding shows)."""
    a = arrow_csr(nb, w, banded=banded, seed=seed)
    a.data = np.random.default_rng(seed).uniform(
        -1.0, 1.0, a.nnz).astype(np.float32)
    return a


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stacks_are_byte_equal_to_jax(banded, dtype):
    a = _weighted_arrow(5, 16, banded, seed=2)
    ours = arrow_blocks_from_csr(a, 16, banded=banded, pad_blocks_to=7,
                                 dtype=dtype, device="cpu")
    theirs = jax_blocks.arrow_blocks_from_csr(
        a, 16, banded=banded, pad_blocks_to=7, fmt="dense",
        dtype=np.float32 if dtype == "f32" else ml_dtypes.bfloat16)
    assert (ours.n_blocks, ours.width, ours.banded) == \
        (theirs.n_blocks, theirs.width, theirs.banded) == (7, 16, banded)
    assert ours.dtype == resolve_block_dtype(dtype)
    names = ("head", "diag", "col") + (("lo", "hi") if banded else ())
    assert sorted(ours.stacks()) == sorted(names)
    for name in names:
        got = _bits(getattr(ours, f"{name}_data"))
        want = _jax_bits(getattr(theirs, f"{name}_data"))
        assert got.shape == want.shape == (7, 16, 16)
        assert np.array_equal(got, want), name
    assert ours.device_nbytes() == theirs.device_nbytes()
    stats, jstats = block_row_stats(ours), jax_blocks.block_row_stats(theirs)
    for key in ("rows", "nnz", "slots"):
        assert np.array_equal(stats[key], jstats[key]), key


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("fmt,head_fmt,values", [
    ("dense", "ell", "weighted"), ("ell", "ell", "weighted"),
    ("ell", "flat", "weighted"), ("ell", "ell", "ones"),
    ("ell", "flat", "ones")])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_row_stats_from_csr_match_the_packed_level(banded, fmt,
                                                         head_fmt, values,
                                                         dtype):
    """The load report counted from the CSR equals the one read off the
    packed level, for every stack layout: explicit zeros, a padded block
    grid and row chunks that cut block rows included."""
    if values == "ones":
        a = arrow_csr(6, 16, banded=banded, seed=4)
        a.data[:] = 1.0
        binary = "auto"
    else:
        a = _weighted_arrow(6, 16, banded, seed=4)
        a.data[::7] = 0.0
        binary = False
    blk = arrow_blocks_from_csr(a, 16, banded=banded, pad_blocks_to=8,
                                dtype=dtype, fmt=fmt, head_fmt=head_fmt,
                                binary=binary, device="cpu")
    assert blk.head_flat == (head_fmt == "flat")
    assert fmt == "dense" or blk.binary == (values == "ones")
    want = block_row_stats(blk)
    for source in (a, (a.data, a.indices, a.indptr)):
        got = block_row_stats_from_csr(
            source, 16, banded=banded, pad_blocks_to=8, fmt=fmt,
            head_flat=blk.head_flat, binary=fmt == "ell" and blk.binary,
            dtype=dtype, chunk_rows=11)
        for key in ("rows", "nnz", "slots"):
            assert np.array_equal(got[key], want[key]), key


def test_load_block_cuts_the_same_blocks_from_csr_and_triplet():
    a = _weighted_arrow(4, 16, True, seed=3)
    # A triplet as a memmapped artifact gives it; the last block is
    # ragged (rows and columns past the end come out empty).
    triplet = (a.data, a.indices, a.indptr)
    for (r0, r1, c0, c1) in [(0, 16, 16, 32), (32, 48, 16, 32),
                             (48, 64, 48, 64), (50, 66, 0, 16)]:
        got = load_block(a, r0, r1, c0, c1, 16)
        got_t = load_block(triplet, r0, r1, c0, c1, 16)
        want = jax_load_block(a, r0, r1, c0, c1, 16)
        assert got.shape == (16, 16)
        for m in (got, got_t):
            assert np.array_equal(m.toarray(), want.toarray())
            assert np.array_equal(m.indptr, want.indptr)
    assert num_nonzeros(a) == num_nonzeros(triplet) == a.nnz


def test_dense_pack_stack_rounds_to_nearest_even_like_jax():
    from arrow_matrix_tpu.ops.ell import dense_pack_stack as jax_pack

    rng = np.random.default_rng(4)
    mats = [None, sparse.random(8, 8, density=0.5, random_state=rng,
                                dtype=np.float32).tocsr(),
            sparse.csr_matrix((8, 8), dtype=np.float32)]
    # Values exactly halfway between two bf16 neighbours round to even.
    mats[1].data[:4] = np.array([1 + 2**-8, 1 + 3 * 2**-8,
                                 -(1 + 2**-8), 2**-130], np.float32)
    got = dense_pack_stack(mats, dtype=torch.bfloat16, rows=8)
    want = jax_pack(mats, dtype=ml_dtypes.bfloat16, rows=8)
    assert np.array_equal(_bits(got), want.view(np.uint16))
    assert np.array_equal(dense_pack_stack(mats, rows=8).numpy(),
                          jax_pack(mats, rows=8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_pack_stack_on_a_device_matches_the_host_pack(dtype):
    """The scatter onto ``device`` gives the host pack's bits: empty and
    absent blocks, a float64 block (cut to float32 first) and one with
    duplicate entries (summed, as ``toarray`` sums them)."""
    rng = np.random.default_rng(11)
    dup = sparse.csr_matrix((np.array([0.5, 0.25, 1.0 + 2**-8], np.float32),
                             np.array([3, 3, 1]), np.array([0, 2, 3, 3, 3,
                                                            3, 3, 3, 3])),
                            shape=(8, 8))
    assert not dup.has_canonical_format
    mats = [None,
            sparse.random(8, 8, density=0.5, random_state=rng,
                          dtype=np.float32).tocsr(),
            sparse.csr_matrix((8, 8), dtype=np.float32),
            sparse.random(8, 8, density=0.3, random_state=rng,
                          dtype=np.float64).tocsr(),
            dup]
    mats[1].data[:2] = np.array([1 + 2**-8, -(1 + 3 * 2**-8)], np.float32)
    want = dense_pack_stack(mats, dtype=dtype, rows=8)
    got = dense_pack_stack(mats, dtype=dtype, rows=8, device="cpu")
    assert got.dtype == dtype and got.shape == (5, 8, 8)
    assert np.array_equal(_bits(got), _bits(want))
    empty = dense_pack_stack([None, None], dtype=dtype, rows=4,
                             device="cpu")
    assert empty.shape == (2, 4, 4) and not empty.any()


def test_tiling_check_catches_entries_outside_the_pattern():
    a = arrow_csr(4, 16, banded=True, seed=5)
    with pytest.raises(ValueError, match="captured"):
        arrow_blocks_from_csr(a, 16, banded=False, device="cpu")
    blocks = arrow_blocks_from_csr(a, 16, banded=False, check=False,
                                   device="cpu")
    assert blocks.lo_data is None and blocks.hi_data is None


def test_block_dtype_names():
    assert resolve_block_dtype(np.float32) == torch.float32
    assert resolve_block_dtype(ml_dtypes.bfloat16) == torch.bfloat16
    assert resolve_block_dtype("bfloat16") == torch.bfloat16
    assert resolve_block_dtype(torch.float32) == torch.float32
    for bad in ("f16", np.float64, torch.float16):
        with pytest.raises(ValueError, match="unknown block dtype"):
            resolve_block_dtype(bad)


def _random_stacks(nb, w, k, seed):
    rng = np.random.default_rng(seed)
    mats = {name: rng.standard_normal((nb, w, w)).astype(np.float32)
            for name in ("head", "diag", "col", "lo", "hi")}
    x = rng.standard_normal((nb, w, k)).astype(np.float32)
    return mats, x


def _jax_shifted(x):
    zeros = jnp.zeros((1,) + x.shape[1:], x.dtype)
    return (jnp.concatenate([zeros, x[:-1]], axis=0),
            jnp.concatenate([x[1:], zeros], axis=0))


@pytest.mark.parametrize("w", [16, 64])
@pytest.mark.parametrize("k", [4, 16])
@pytest.mark.parametrize("banded", [False, True])
def test_plain_products_match_jax_pallas_and_xla(w, k, banded):
    nb = 4
    mats, x = _random_stacks(nb, w, k, seed=w + k)
    t = {name: torch.from_numpy(m) for name, m in mats.items()}
    j = {name: jnp.asarray(m) for name, m in mats.items()}
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    tol = relative_tolerance(w * (4 if banded else 2))

    # K3's function: the head row.
    want_head = np.asarray(head_spmm_pallas(j["head"], xj))
    got_head = arrow_blocks.head_spmm(t["head"], xt).numpy()
    assert relative_error(got_head, want_head) <= tol
    want_head_xla = np.asarray(jnp.einsum("bij,bjk->ik", j["head"], xj))
    assert relative_error(got_head, want_head_xla) <= tol

    # K2's function: every block row but the head (row 0 is K3's).
    if banded:
        x_lo, x_hi = _jax_shifted(xj)
        want = column_spmm_pallas(j["diag"], j["col"], xj, xj[0],
                                  j["lo"], j["hi"], x_lo, x_hi)
        got = arrow_blocks.column_spmm(t["diag"], t["col"], xt, t["lo"],
                                       t["hi"])
    else:
        want = column_spmm_pallas(j["diag"], j["col"], xj, xj[0])
        got = arrow_blocks.column_spmm(t["diag"], t["col"], xt)
    assert relative_error(got[1:].numpy(), np.asarray(want)[1:]) <= tol
    assert not got[0].any()

    # The whole level, on real arrow blocks.
    a = _weighted_arrow(nb, w, banded, seed=k)
    ours = arrow_blocks_from_csr(a, w, banded=banded, device="cpu")
    theirs = jax_blocks.arrow_blocks_from_csr(a, w, banded=banded,
                                              fmt="dense")
    xb = block_features(x.reshape(nb * w, k), w, nb)
    got_level = arrow_blocks.arrow_spmm(ours, torch.from_numpy(xb))
    for want_level in (arrow_spmm_pallas(theirs, jnp.asarray(xb)),
                       jax_blocks.arrow_spmm(theirs, jnp.asarray(xb))):
        assert relative_error(got_level.numpy(),
                              np.asarray(want_level)) <= tol
    golden = a @ x.reshape(nb * w, k)
    assert relative_error(unblock_features(got_level, nb * w),
                          golden) <= tol


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("banded", [False, True])
def test_column_rows_over_rank_shards_match_the_level(n_dev, banded):
    """K2's row range over each rank's operand ``[X_0; X_prev; own;
    X_next]`` (block diagonal ``[X_0; own]``) with only its own blocks,
    the first rank's head block left out and the last rank's operand
    ending before ``X_next`` (the mesh layout of
    ``parallel/arrow_layout.py``): equal to JAX's column product of the
    whole level on those rows, through the plain twin and through the
    wrapper on CPU tensors (no launch counted)."""
    nb, w, k = 8, 16, 4
    mats, x = _random_stacks(nb, w, k, seed=5 + n_dev)
    j = {name: jnp.asarray(m) for name, m in mats.items()}
    xj = jnp.asarray(x)
    if banded:
        x_lo, x_hi = _jax_shifted(xj)
        want = column_spmm_pallas(j["diag"], j["col"], xj, xj[0], j["lo"],
                                  j["hi"], x_lo, x_hi)
    else:
        want = column_spmm_pallas(j["diag"], j["col"], xj, xj[0])
    want = np.asarray(want)
    t = {name: torch.from_numpy(m) for name, m in mats.items()}
    xt = torch.from_numpy(x)
    nb_l = nb // n_dev
    tol = relative_tolerance(w * (4 if banded else 2))
    before = cuda_blocks.LAUNCHES_K2
    for d in range(n_dev):
        b0, skip = d * nb_l, int(d == 0)
        own = xt[b0:b0 + nb_l]
        if banded:
            prev = xt[b0 - 1:b0] if d else torch.zeros((1, w, k))
            nxt = [xt[b0 + nb_l:b0 + nb_l + 1]] if d < n_dev - 1 else []
            operand, first = torch.cat([xt[:1], prev, own] + nxt), 2
        else:
            operand, first = torch.cat([xt[:1], own]), 1
        rows = slice(b0 + skip, b0 + nb_l)
        lohi = (t["lo"][rows], t["hi"][rows]) if banded else ()
        got = arrow_blocks.column_rows_spmm(t["diag"][rows], t["col"][rows],
                                            operand, first + skip, *lohi)
        assert relative_error(got.numpy(), want[rows]) <= tol
        out = torch.full((nb_l - skip, w, k), 7.0)
        cuda_blocks.column_rows_spmm(t["diag"][rows], t["col"][rows],
                                     operand, first + skip, *lohi, out=out)
        assert torch.equal(out, got)
    assert cuda_blocks.LAUNCHES_K2 == before
    with pytest.raises(ValueError, match="outside the operand"):
        arrow_blocks.column_rows_spmm(t["diag"][:3], t["col"][:3], xt[:3], 1)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    mats, x = _random_stacks(3, 16, 4, seed=9)
    t = {name: torch.from_numpy(m) for name, m in mats.items()}
    xt = torch.from_numpy(x)
    before = (cuda_blocks.LAUNCHES_K2, cuda_blocks.LAUNCHES_K3)
    got = cuda_blocks.column_spmm(t["diag"], t["col"], xt, t["lo"], t["hi"])
    assert torch.equal(got, arrow_blocks.column_spmm(
        t["diag"], t["col"], xt, t["lo"], t["hi"]))
    out = torch.full((3, 16, 4), 7.0)
    cuda_blocks.head_spmm(t["head"], xt, out=out[0])
    cuda_blocks.column_spmm(t["diag"], t["col"], xt, out=out)
    blocks = arrow_blocks.ArrowBlocks(
        head_data=t["head"], diag_data=t["diag"], col_data=t["col"],
        width=16, n_blocks=3)
    assert torch.equal(out, cuda_blocks.arrow_spmm_cuda(blocks, xt))
    assert torch.equal(out, arrow_blocks.arrow_spmm(blocks, xt))
    assert (cuda_blocks.LAUNCHES_K2, cuda_blocks.LAUNCHES_K3) == before
    with pytest.raises(ValueError, match=r"x must be \(3, 16, k\)"):
        cuda_blocks.arrow_spmm_cuda(blocks, xt[:2])


def test_blocks_move_between_devices_whole():
    a = arrow_csr(3, 16, banded=True, seed=7)
    blocks = arrow_blocks_from_csr(a, 16, banded=True, dtype="bf16",
                                   device="cpu")
    moved = blocks.to("cpu")
    assert moved.banded and moved.width == 16 and moved.n_blocks == 3
    assert moved.device_nbytes() == 5 * 3 * 16 * 16 * 2
    for name, t in blocks.stacks().items():
        assert torch.equal(getattr(moved, f"{name}_data"), t)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arrow_blocks_from_csr(a, 16, banded=True)


# -- the geometry of the kernels' launches (K3's split), on the CPU ----------

SPLIT_SHAPES = [(1, 2048, 16), (2, 48, 8), (3, 64, 128), (5, 100, 33),
                (32, 2048, 16), (32, 2048, 128), (33, 200, 16),
                (33, 2048, 16), (65, 256, 1024), (512, 2048, 16),
                (512, 2048, 128), (1000, 16, 4), (7, 4096, 4096)]


@pytest.mark.parametrize("nb,w,k", SPLIT_SHAPES)
def test_head_chunks_cover_every_block_once_in_order(nb, w, k):
    chunks = cuda_blocks.head_chunks(nb, w, k)
    assert len(chunks) == cuda_blocks.head_split(nb, w, k) >= 1
    assert [b for c in chunks for b in c] == list(range(nb))
    assert all(len(c) >= 1 for c in chunks)
    # Equal chunks but the last, which may be shorter.
    assert len({len(c) for c in chunks[:-1]}) <= 1
    assert len(chunks[-1]) <= len(chunks[0])


@pytest.mark.parametrize("w,k", [(16, 4), (2048, 16), (2048, 128),
                                 (256, 1024)])
def test_head_split_is_one_for_one_block(w, k):
    assert cuda_blocks.head_split(1, w, k) == 1
    assert cuda_blocks.head_chunks(1, w, k) == [range(1)]


def test_head_split_is_a_function_of_the_shapes_alone():
    import inspect

    assert list(inspect.signature(cuda_blocks.head_split).parameters) == \
        ["nb", "w", "k"]
    first = [cuda_blocks.head_split(*s) for s in SPLIT_SHAPES]
    torch.manual_seed(1)
    np.random.seed(1)
    assert [cuda_blocks.head_split(*s) for s in SPLIT_SHAPES] == first
    # The dense cell (nb = 32, w = 2048): one chunk per block at both k.
    assert cuda_blocks.head_split(32, 2048, 16) == 32
    assert cuda_blocks.head_split(32, 2048, 128) == 32


# The workspace of partials, (S, w, k) float32, at the dense cell (n =
# 2^16, nb = 32) and at nb = 512 (n = 2^20), width 2048: 4 MiB at k=16,
# 32 MiB and 64 MiB at k=128; never over HEAD_WORKSPACE_BYTES (64 MiB).
@pytest.mark.parametrize("nb,k,mib", [(32, 16, 4), (32, 128, 32),
                                      (512, 16, 4), (512, 128, 64)])
def test_head_workspace_stays_bounded(nb, k, mib):
    s = cuda_blocks.head_split(nb, 2048, k)
    assert s * 2048 * k * 4 == mib << 20
    assert s * 2048 * k * 4 <= cuda_blocks.HEAD_WORKSPACE_BYTES == 64 << 20


def test_head_split_fills_the_card_when_it_can():
    for nb, w, k in SPLIT_SHAPES:
        bm, bn = cuda_blocks.tile_shape(k)
        tiles = -(-w // bm) * -(-k // bn)
        s = cuda_blocks.head_split(nb, w, k)
        room = cuda_blocks.HEAD_WORKSPACE_BYTES // (4 * w * k)
        if s < nb and s < room:
            # Only the equal chunks cut the CTAs below about the target.
            assert 2 * s * tiles >= cuda_blocks.HEAD_CTAS


def test_tiles_mirror_the_kernel_source():
    """ops/cuda_blocks.py:TILES names the kernel's configurations."""
    import re
    from pathlib import Path

    import arrow_matrix_tpu_torch

    src = (Path(arrow_matrix_tpu_torch.__file__).parent / "csrc"
           / "arrow_blocks_spmm.cu").read_text()
    cfg = {name: (int(bm), int(bn)) for name, bm, bn in re.findall(
        r"using (\w+) = Cfg<(\d+), (\d+),", src)}
    for fn in ("column_for", "head_for"):
        body = src[src.index(f"cudaError_t {fn}("):]
        body = body[:body.index("\n}\n")]
        picks = re.findall(r"(?:if \(k <= (\d+)\) \{\s*)?return launch_\w+<"
                           r"TA, VEC, (\w+)>", body)
        assert [(None if not k_max else int(k_max), *cfg[name])
                for k_max, name in picks] == list(cuda_blocks.TILES)
    assert cuda_blocks.tile_shape(16) == (64, 16)
    assert cuda_blocks.tile_shape(17) == (128, 64)
    assert cuda_blocks.tile_shape(128) == (128, 128)


@pytest.mark.parametrize("name", ["arrow_column_spmm", "arrow_head_spmm"])
def test_ctypes_signatures_match_the_kernel_source(name):
    """The wrapper's argument types for each C entry point: block dtype
    and vec, then the pointers, then the ints, then the stream."""
    import re
    from pathlib import Path

    import arrow_matrix_tpu_torch

    src = (Path(arrow_matrix_tpu_torch.__file__).parent / "csrc"
           / "arrow_blocks_spmm.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = ["ptr" if "*" in p else "int" for p in params.split(",")]
    ptrs, ints = cuda_blocks._ARGS[name]
    assert kinds == ["int"] * 2 + ["ptr"] * ptrs + ["int"] * ints + ["ptr"]


@pytest.mark.parametrize("jax_dtype,torch_dtype", [
    (np.float32, torch.float32), (np.float64, torch.float64),
    (ml_dtypes.bfloat16, torch.bfloat16)], ids=["f32", "f64", "bf16"])
def test_scipy_safe_dtype_follows_jax(jax_dtype, torch_dtype):
    """The dtype a block passes through scipy at: itself where scipy
    holds it, float32 for bf16; numpy and torch dtypes alike."""
    want = jax_blocks.scipy_safe_dtype(jax_dtype)
    assert arrow_blocks.scipy_safe_dtype(jax_dtype) is want
    assert arrow_blocks.scipy_safe_dtype(torch_dtype) is want


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("n_dev", [None, 1, 2, 3, 4])
def test_arrow_blocks_shard_report_equals_jax(fmt, banded, n_dev):
    """One level's load report per block row, and per device share with
    ``n_dev``, equal to JAX's ``arrow_blocks_shard_report``."""
    from arrow_matrix_tpu.parallel.arrow_layout import (
        arrow_blocks_shard_report as jax_report,
    )
    from arrow_matrix_tpu_torch.parallel.arrow_layout import (
        arrow_blocks_shard_report,
    )

    a = _weighted_arrow(6, 16, banded, seed=4)
    ours = arrow_blocks_from_csr(a, 16, banded=banded, pad_blocks_to=7,
                                 fmt=fmt, device="cpu")
    theirs = jax_blocks.arrow_blocks_from_csr(a, 16, banded=banded,
                                              pad_blocks_to=7, fmt=fmt)
    got = arrow_blocks_shard_report(ours, n_dev)
    assert got == jax_report(theirs, n_dev)
    assert got["units"] == ("device" if n_dev and n_dev > 1
                            else "block-row")

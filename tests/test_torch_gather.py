"""The port's gathers: K4's plain versions (the row gather and the
fused gather-add) against numpy, its wrappers on CPU tensors and what
they reject, and the probe's granule entry against the JAX package's
gather probe (``xla_granule`` and the Pallas kernel in interpret mode)
on the same seeded inputs.  The tolerance is exact equality (a gather
moves values and computes none; the gather-add is one f32 addition,
the same on both sides)."""

import ctypes
import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_matrix_tpu_torch.ops import (
    cuda_gather,
    granule_gather,
    granule_gather_plain,
    pack_granules,
    row_gather,
    row_gather_add_,
    row_gather_add_plain,
    row_gather_plain,
    take,
)
from arrow_matrix_tpu_torch.ops.gather import C, K, LANES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def _jax_probe():
    """``tools/pallas_gather_probe.py`` (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_pallas_gather_probe",
        os.path.join(REPO, "tools", "pallas_gather_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(n, s, seed=5):
    """Seeded features with a row of ``-0.0``, and indices that reach
    row 0, row n - 1 and the ``-0.0`` row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, K)).astype(np.float32)
    idx = rng.integers(0, n, size=s, dtype=np.int32)
    x[3] = -0.0
    idx[:3] = (0, n - 1, 3)
    return x, idx


@pytest.mark.parametrize("n,s,block,wave", [(1 << 10, 256, 64, 16),
                                            (1 << 14, 1 << 12, 64, 16)])
def test_granule_gather_matches_jax(n, s, block, wave):
    jp = _jax_probe()
    x, idx = _inputs(n, s)
    xp = x.reshape(n // C, LANES)
    xla = np.asarray(jp.xla_granule(jnp.asarray(xp), jnp.asarray(idx)))
    pallas = np.asarray(jp.make_pallas_granule(
        n // C, block, wave, interpret=True)(jnp.asarray(xp),
                                             jnp.asarray(idx)))
    xt = torch.from_numpy(x)
    it = torch.from_numpy(idx)
    plain = granule_gather_plain(pack_granules(xt), it).numpy()
    before = cuda_gather.LAUNCHES
    wrapped = granule_gather(pack_granules(xt), it).numpy()
    assert cuda_gather.LAUNCHES == before      # the CPU runs no kernel
    assert plain.shape == pallas.shape == (s // C, LANES)
    for got in (plain, wrapped):
        assert np.array_equal(got.reshape(-1, K), xla)
        assert np.array_equal(got, pallas)
        assert np.array_equal(got.reshape(-1, K), x[idx])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("k", [16, 128])
def test_take_is_row_indexing(dtype, k):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.uniform(-100, 100, (500, k)).astype(
        np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 500, 3000, dtype=np.int32))
    assert torch.equal(take(x, idx), x[idx.long()])


def test_signed_zero_is_pinned():
    """A ``-0.0`` row: the plain select (mask and sum, as the JAX
    package's ``xla_granule`` and interpret-mode Pallas kernel) returns
    ``+0.0``; ``take`` and the CUDA kernel copy the bits.  The two agree
    by value, which is how every comparison of K4 is made."""
    jp = _jax_probe()
    x, idx = _inputs(1 << 10, 256)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    plain = granule_gather_plain(pack_granules(xt), it).view(-1, K)
    taken = take(xt, it)
    xla = np.asarray(jp.xla_granule(jnp.asarray(x.reshape(-1, LANES)),
                                    jnp.asarray(idx)))
    assert np.signbit(taken[2].numpy()).all()
    assert not np.signbit(plain[2].numpy()).any()
    assert not np.signbit(xla[2]).any()
    assert torch.equal(plain, taken)               # equal by value
    assert not torch.equal(plain.view(torch.int32), taken.view(torch.int32))


def test_pack_granules_is_a_view_and_needs_whole_granules():
    x = torch.arange(64 * K, dtype=torch.float32).view(64, K)
    packed = pack_granules(x)
    assert packed.shape == (8, LANES)
    assert packed.data_ptr() == x.data_ptr()
    assert torch.equal(packed[1, K:2 * K], x[9])
    with pytest.raises(ValueError, match="multiple of the granule"):
        pack_granules(torch.zeros(60, K))
    with pytest.raises(ValueError, match=r"must be \(n, 16\)"):
        pack_granules(torch.zeros(64, 8))


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(slots=12), ValueError, "multiple of 8"),    # a part line
    (dict(slots=100), ValueError, "multiple of 8"),
    (dict(slots=4), ValueError, "multiple of 8"),
    # The TPU kernel's grid step and copies in flight steer nothing on
    # the card, so the entry takes neither.
    (dict(slots=256, block=64), TypeError, "block"),
    (dict(slots=256, wave=16), TypeError, "wave"),
])
def test_wrapper_rejects_bad_blocking(kwargs, error, match):
    """The granule entry's one blocking rule: whole granule lines out."""
    kwargs = dict(kwargs)
    xp = torch.zeros(32, LANES)
    idx = torch.zeros(kwargs.pop("slots"), dtype=torch.int32)
    with pytest.raises(error, match=match):
        granule_gather(xp, idx, **kwargs)


def test_wrapper_rejects_bad_operands():
    xp = torch.zeros(32, LANES)
    idx = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be torch.float32"):
        granule_gather(xp.double(), idx)
    with pytest.raises(ValueError, match="must be torch.int32"):
        granule_gather(xp, idx.long())
    with pytest.raises(ValueError, match=r"x_packed must be \(n / 8, 128\)"):
        granule_gather(torch.zeros(256, K), idx)
    with pytest.raises(ValueError, match="contiguous"):
        granule_gather(torch.zeros(LANES, 64).t(), idx)
    with pytest.raises(ValueError, match="1-D"):
        granule_gather(xp, idx.view(16, 16))
    with pytest.raises(ValueError, match="multiple of 8"):
        granule_gather_plain(xp, idx[:12])


# -- K4's row gather and fused gather-add -------------------------------------

def _rows(n, k, s, seed):
    """Seeded ``(n, k)`` f32 features with a row of ``-0.0`` and a NaN
    with a payload, a base ``(s, k)``, and ``s`` indices reaching rows
    0, 1 and n - 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    x[0] = -0.0
    x.view(np.int32)[1, 0] = 0x7FC12345
    base = rng.standard_normal((s, k)).astype(np.float32)
    idx = rng.integers(0, n, size=s, dtype=np.int32)
    idx[:min(s, 3)] = (0, 1, n - 1)[:min(s, 3)]
    return x, base, idx


@pytest.mark.parametrize("k", [1, 3, 16, 128])
@pytest.mark.parametrize("n,s", [(5, 1), (97, 37), (1000, 2053)])
def test_plain_row_gather_and_add_equal_numpy(k, n, s):
    x, base, idx = _rows(n, k, s, seed=k + s)
    xt, bt, it = (torch.from_numpy(a) for a in (x, base.copy(), idx))
    got = row_gather_plain(xt, it).numpy()
    assert np.array_equal(got.view(np.int32), x[idx].view(np.int32))
    out = row_gather_add_plain(bt, xt, it)
    assert out is bt                                  # in place
    assert np.array_equal(out.numpy().view(np.int32),
                          (base + x[idx]).view(np.int32))


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    x, base, idx = _rows(300, 20, 777, seed=1)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    before = (cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD)
    got = row_gather(xt, it)
    assert torch.equal(got.view(torch.int32),
                       row_gather_plain(xt, it).view(torch.int32))
    bt = torch.from_numpy(base.copy())
    assert row_gather_add_(bt, xt, it) is bt
    want = row_gather_add_plain(torch.from_numpy(base), xt, it)
    assert torch.equal(bt.view(torch.int32), want.view(torch.int32))
    assert (cuda_gather.LAUNCHES, cuda_gather.LAUNCHES_ADD) == before
    empty = row_gather(xt, it[:0])
    assert empty.shape == (0, 20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_part_source_reads_the_joined_rows(dtype):
    """``row_gather(x, idx, x2)`` and the gather-add over the rows ``[x;
    x2]`` read where they lie (a mesh exchange's own rows, then its zero
    row and received slots): bit for bit ``[x; x2][idx]``."""
    x, base, idx = _rows(300, 20, 777, seed=2)
    xt = torch.from_numpy(x).to(dtype)
    x2 = torch.from_numpy(_rows(41, 20, 1, seed=3)[0]).to(dtype)
    it = torch.from_numpy(np.concatenate(
        [idx[:700], np.arange(300, 341, dtype=np.int32),
         np.full(36, 300, np.int32)]))
    joined = torch.cat([xt, x2])
    want = joined.index_select(0, it.long())
    got = row_gather(xt, it, x2)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))
    if dtype == torch.float32:
        bt = torch.from_numpy(base.copy())
        assert row_gather_add_(bt, xt, it, x2) is bt
        assert torch.equal(bt.view(torch.int32),
                           (torch.from_numpy(base) + want).view(torch.int32))
        rows = torch.cat([joined, torch.zeros((777, 20))])
        with pytest.raises(ValueError, match="overlaps"):
            row_gather_add_(rows[300:1077], xt, it, rows[300:341])


def test_row_gather_wrappers_reject_what_the_kernel_does_not_take():
    x = torch.zeros(64, 8)
    idx = torch.zeros(40, dtype=torch.int32)
    base = torch.zeros(40, 8)
    with pytest.raises(ValueError, match="x must be torch.float32"):
        row_gather(x.double(), idx)
    with pytest.raises(ValueError, match="x must be torch.float32"):
        row_gather_add_(base, x.to(torch.bfloat16), idx)
    with pytest.raises(ValueError, match="base must be torch.float32"):
        row_gather_add_(base.double(), x, idx)
    with pytest.raises(ValueError, match="contiguous"):
        row_gather(torch.zeros(8, 64).t(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        row_gather_add_(torch.zeros(8, 40).t(), x, idx)
    with pytest.raises(ValueError, match="idx must be torch.int32"):
        row_gather(x, idx.long())
    with pytest.raises(ValueError, match="idx must be torch.int32"):
        row_gather_add_(base, x, idx.long())
    with pytest.raises(ValueError, match="1-D"):
        row_gather(x, idx.view(8, 5))
    with pytest.raises(ValueError, match=r"must be \(n, k\)"):
        row_gather(x.view(-1), idx)
    with pytest.raises(ValueError, match=r"base must have shape \(40, 8\)"):
        row_gather_add_(torch.zeros(41, 8), x, idx)
    with pytest.raises(ValueError, match=r"base must have shape \(40, 8\)"):
        row_gather_add_(torch.zeros(40, 9), x, idx)
    with pytest.raises(ValueError, match="overlaps x"):
        row_gather_add_(x[:40], x, idx)               # base inside x
    big = torch.zeros(80, 8)
    with pytest.raises(ValueError, match="overlaps x"):
        row_gather_add_(big[30:70], big[:64], idx)    # a partial overlap
    row_gather_add_(big[64:], big[:64], idx[:16])     # adjacent: fine


def test_card_asked_for_without_one_raises():
    from arrow_matrix_tpu_torch.tools import granule_gather_probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        granule_gather_probe.run_probe()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        granule_gather_probe.run_probe(device="cuda:0")


def test_ctypes_signature_matches_the_kernel_source():
    """``ops/cuda_gather.py:ARGTYPES`` against the C entry of the
    ``.cu``: a pointer is ``c_void_p``, ``long long`` 64 bits, an ``int``
    32 (a mismatch would cut a pointer or a count)."""
    src = open(os.path.join(REPO, "arrow_matrix_tpu_torch", "csrc",
                            "granule_gather.cu")).read()
    params = re.search(r"int row_gather\(([^)]*)\)", src).group(1)
    kinds = ["ptr" if "*" in p else "i64" if "long long" in p else "i32"
             for p in params.split(",")]
    names = {ctypes.c_void_p: "ptr", ctypes.c_longlong: "i64",
             ctypes.c_int: "i32"}
    assert kinds == [names[t] for t in cuda_gather.ARGTYPES]

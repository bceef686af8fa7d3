"""The port's gathers against the JAX package's gather probe: the plain
version of the granule gather kernel (K4) and its wrapper on CPU
tensors, against ``xla_granule`` and the Pallas kernel in interpret
mode, on the same seeded inputs.  The tolerance is exact equality by
value (a gather moves values; it computes none)."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_matrix_tpu_torch.ops import (
    cuda_gather,
    granule_gather,
    granule_gather_plain,
    pack_granules,
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
    wrapped = granule_gather(pack_granules(xt), it, block, wave).numpy()
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


@pytest.mark.parametrize("kwargs,match", [
    (dict(block=60, wave=12), "multiple of 8"),       # block % 8
    (dict(block=64, wave=24), "multiple of 8"),       # block % wave
    (dict(block=0, wave=16), "multiple of 8"),
    (dict(block=512, wave=16), "multiple of block"),  # S % block
    (dict(block=1024, wave=512), "shared memory"),    # 256 KB a wave
])
def test_wrapper_rejects_bad_blocking(kwargs, match):
    xp = torch.zeros(32, LANES)
    idx = torch.zeros(256, dtype=torch.int32)
    if kwargs["block"] == 1024:
        idx = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        granule_gather(xp, idx, **kwargs)


def test_wrapper_rejects_bad_operands():
    xp = torch.zeros(32, LANES)
    idx = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be torch.float32"):
        granule_gather(xp.double(), idx, 64, 16)
    with pytest.raises(ValueError, match="must be torch.int32"):
        granule_gather(xp, idx.long(), 64, 16)
    with pytest.raises(ValueError, match=r"x_packed must be \(n / 8, 128\)"):
        granule_gather(torch.zeros(256, K), idx, 64, 16)
    with pytest.raises(ValueError, match="contiguous"):
        granule_gather(torch.zeros(LANES, 64).t(), idx, 64, 16)
    with pytest.raises(ValueError, match="1-D"):
        granule_gather(xp, idx.view(16, 16), 64, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        granule_gather_plain(xp, idx[:12])


def test_card_asked_for_without_one_raises():
    from arrow_matrix_tpu_torch.tools import granule_gather_probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        granule_gather_probe.run_probe()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        granule_gather_probe.run_probe(device="cuda:0")

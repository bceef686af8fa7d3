"""The port's iteration-state checkpoints
(``arrow_matrix_tpu_torch.utils.checkpoint``) against the JAX package's
npz form: a flat carriage written by either package loads in the other
with its step and layout tag; a bad sidecar, a layout mismatch and a
fold checkpoint crossing packages (transposed carriages) all fail
loudly; and the batch CLI's supervised ``--carry --checkpoint`` resume
equals an uninterrupted run."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_matrix_tpu.parallel import MultiLevelArrow as JaxArrow
from arrow_matrix_tpu.utils import checkpoint as jck
from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.utils import barabasi_albert
from arrow_matrix_tpu_torch.utils import checkpoint as pck
from arrow_matrix_tpu_torch.utils.checkpoint import CheckpointIntegrityError

torch.set_num_threads(2)


@pytest.fixture
def jax_npz(monkeypatch):
    """The JAX writer's npz path (it picks orbax when installed)."""
    monkeypatch.setattr(jck, "_orbax", lambda: None)


@pytest.fixture(scope="module")
def levels():
    a = barabasi_albert(300, 3, seed=2)
    return arrow_decomposition(a, 32, max_levels=4, block_diagonal=True,
                               seed=2)


def _x(rows=40, k=3, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(
        np.float32)


def test_port_writes_jax_reads(tmp_path, jax_npz):
    x = _x()
    pck.save_state(str(tmp_path / "ck"), torch.from_numpy(x), 7,
                   layout="serve/r0001/k3/it4")
    got, step = jck.load_state(str(tmp_path / "ck"),
                               like=jnp.zeros((40, 3), jnp.float32),
                               layout="serve/r0001/k3/it4")
    assert step == 7 and np.asarray(got).tobytes() == x.tobytes()
    assert jck.checkpoint_meta(str(tmp_path / "ck")) == {
        "version": 1, "step": 7, "layout": "serve/r0001/k3/it4"}


def test_jax_writes_port_reads(tmp_path, jax_npz):
    x = _x(seed=1)
    jck.save_state(str(tmp_path / "ck"), jnp.asarray(x), 3,
                   layout="multi_level/flat")
    like = torch.zeros(40, 3)
    got, step = pck.load_state(str(tmp_path / "ck"), like=like,
                               layout="multi_level/flat")
    assert step == 3 and got.numpy().tobytes() == x.tobytes()
    assert pck.checkpoint_meta(str(tmp_path / "ck"))["layout"] == \
        "multi_level/flat"
    assert pck.checkpoint_layout_tag(str(tmp_path / "ck")) == \
        "multi_level/flat"
    assert pck.list_checkpoints(str(tmp_path), prefix="c") == \
        [str(tmp_path / "ck")]


def test_bad_sidecar_raises_integrity_error(tmp_path):
    pck.save_state(str(tmp_path / "ck"), torch.ones(4, 2), 1)
    with open(tmp_path / "ck.npz.sha256", "w") as fh:
        fh.write("0" * 64 + "\n")
    with pytest.raises(CheckpointIntegrityError, match="sha256"):
        pck.load_state(str(tmp_path / "ck"))


def test_layout_mismatch_and_newer_version_raise(tmp_path):
    pck.save_state(str(tmp_path / "ck"), torch.ones(4, 2), 1,
                   layout="serve/a")
    with pytest.raises(RuntimeError, match="layout"):
        pck.load_state(str(tmp_path / "ck"), layout="serve/b")
    np.savez(str(tmp_path / "new.npz"), x=np.ones((4, 2), np.float32),
             step=np.int64(1), version=np.int64(99), layout=np.str_(""))
    with pytest.raises(RuntimeError, match="version"):
        pck.load_state(str(tmp_path / "new"))


def test_untagged_legacy_loads_and_absent_is_none(tmp_path):
    np.savez(str(tmp_path / "old.npz"), x=np.ones((4, 2), np.float32),
             step=np.int64(3))
    x, step = pck.load_state(str(tmp_path / "old"), layout="anything")
    assert step == 3 and x.shape == (4, 2)
    assert pck.checkpoint_meta(str(tmp_path / "old"))["version"] == 0
    assert pck.load_state(str(tmp_path / "none")) is None


def test_fold_checkpoint_crossing_packages_fails_loudly(tmp_path, levels,
                                                        jax_npz):
    x = _x(300, 4, seed=3)
    ours = MultiLevelArrow(levels, 32, fmt="fold", device="cpu")
    theirs = JaxArrow(levels, 32, fmt="fold")
    ours_x, theirs_x = ours.set_features(x), theirs.set_features(x)
    assert tuple(ours_x.shape) == tuple(theirs_x.shape)[::-1]
    jck.save_state(str(tmp_path / "jax"), theirs_x, 2, layout="fold")
    with pytest.raises(ValueError, match="transposed"):
        pck.load_state(str(tmp_path / "jax"), like=ours_x, layout="fold")
    pck.save_state(str(tmp_path / "port"), ours_x, 2, layout="fold")
    with pytest.raises(ValueError, match="shape"):
        jck.load_state(str(tmp_path / "port"), like=theirs_x,
                       layout="fold")
    # Within a package the fold carriage round-trips.
    got, _ = pck.load_state(str(tmp_path / "port"), like=ours_x,
                            layout="fold")
    assert torch.equal(got, ours_x)


def test_orbax_directory_and_int8_pair_raise(tmp_path):
    os.makedirs(tmp_path / "orbax_ck")
    with pytest.raises(RuntimeError, match="orbax"):
        pck.load_state(str(tmp_path / "orbax_ck"))
    with pytest.raises(ValueError, match="int8"):
        pck.save_state(str(tmp_path / "q"), (torch.zeros(2, 2,
                                                         dtype=torch.int8),
                                             torch.ones(1, 2)), 1)


def test_bf16_carriage_round_trips(tmp_path):
    x = torch.from_numpy(_x(8, 4, seed=5)).to(torch.bfloat16)
    pck.save_state(str(tmp_path / "ck"), x, 4)
    got, step = pck.load_state(str(tmp_path / "ck"),
                               like=torch.zeros(8, 4, dtype=torch.bfloat16))
    assert step == 4 and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


def test_bf16_jax_writes_port_reads_bit_for_bit(tmp_path, jax_npz):
    x = _x(6, 4, seed=6)
    jck.save_state(str(tmp_path / "ck"), jnp.asarray(x, jnp.bfloat16), 2)
    with np.load(str(tmp_path / "ck.npz")) as z:
        assert z["x"].dtype == np.dtype("V2")
    got, step = pck.load_state(str(tmp_path / "ck"),
                               like=torch.zeros(6, 4, dtype=torch.bfloat16))
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    assert step == 2 and got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == want.tobytes()


def test_bf16_port_file_is_the_reference_form_jax_refuses(tmp_path,
                                                          jax_npz):
    """The reference cannot cast its own bf16 npz back (no cast function
    from void); a port file now has that form, so JAX raises where the
    older int16 form came back as numbers (0.12597656 as 15872.0)."""
    x = torch.tensor([[0.12597656, -1.5], [3.0, 0.0]], dtype=torch.bfloat16)
    pck.save_state(str(tmp_path / "ck"), x, 1)
    with np.load(str(tmp_path / "ck.npz")) as z:
        assert z["x"].dtype == np.dtype("V2")
        assert "x_dtype" not in z.files
    with pytest.raises((TypeError, ValueError)):
        jck.load_state(str(tmp_path / "ck"),
                       like=jnp.zeros((2, 2), jnp.bfloat16))


def test_bf16_legacy_int16_file_still_loads(tmp_path):
    x = torch.from_numpy(_x(5, 3, seed=7)).to(torch.bfloat16)
    path = str(tmp_path / "ck")
    np.savez(path + ".npz", x=x.view(torch.int16).numpy(), step=np.int64(3),
             version=np.int64(pck.CHECKPOINT_VERSION), layout=np.str_(""),
             x_dtype=np.str_("bfloat16"))
    pck._write_sha(path + ".npz")
    got, step = pck.load_state(path)
    assert step == 3 and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16))


def test_several_processes_raise_naming_the_roadmap(tmp_path, monkeypatch):
    import torch.distributed as dist

    """Under a job of several processes a checkpoint without a mesh is
    the process's own state: written and read back with no collective
    (a carriage sharded over a mesh passes ``mesh=``, whose path
    tests/test_torch_mesh_state.py holds on gloo ranks)."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    x = torch.arange(6, dtype=torch.float32).view(3, 2)
    pck.save_state(str(tmp_path / "ck"), x, 1, layout="local")
    got, step = pck.load_state(str(tmp_path / "ck"), like=x,
                               layout="local")
    assert step == 1 and torch.equal(got, x)


def _cli(tmp_path, monkeypatch, *extra):
    from arrow_matrix_tpu_torch.cli import spmm_arrow

    monkeypatch.chdir(tmp_path)
    return spmm_arrow.main(["--device", "cpu", "--vertices", "400",
                            "--width", "32", "--features", "4", "--carry",
                            "--seed", "3", *extra])


def test_cli_carry_checkpoint_resume(tmp_path, monkeypatch):
    """Four supervised iterations straight, against two and then a
    rerun to four resuming from the step-2 checkpoint: the final
    checkpoints are equal bit for bit."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert _cli(tmp_path, monkeypatch, "--iterations", "4",
                "--checkpoint", a, "--checkpoint_every", "2") == 0
    assert _cli(tmp_path, monkeypatch, "--iterations", "2",
                "--checkpoint", b, "--checkpoint_every", "2") == 0
    assert pck.load_state(b)[1] == 2
    assert _cli(tmp_path, monkeypatch, "--iterations", "4",
                "--checkpoint", b, "--checkpoint_every", "2",
                "--validate") == 0
    (xa, sa), (xb, sb) = pck.load_state(a), pck.load_state(b)
    assert sa == sb == 4 and torch.equal(xa, xb)


def test_cli_checkpoint_requires_carry(tmp_path, monkeypatch):
    from arrow_matrix_tpu_torch.cli import spmm_arrow

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="requires --carry"):
        spmm_arrow.main(["--device", "cpu", "--checkpoint", "ck"])

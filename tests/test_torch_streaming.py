"""The streamed block pack and memmapped levels on gloo ranks, against
the JAX package (mirroring ``tests/test_streaming.py``):
``arrow_blocks_streamed`` on 4 ranks equals the matching rows of JAX's
``arrow_blocks_streamed`` on a (4,) mesh byte for byte, and refuses a
tiling that loses nonzeros in its words; ``MultiLevelArrow(mesh=)``,
``SellMultiLevel`` and ``SellSpaceShared`` built from memmapped levels
step bit for bit as the in-memory builds, within ``relative_tolerance``
of ``decomposition_spmm``; and ``spmm_arrow --memmap`` validates on one
rank and on two."""

import os
import subprocess
import sys

import numpy as np
import pytest

from arrow_matrix_tpu.decomposition.decompose import (
    arrow_decomposition as jax_decomposition,
)
from arrow_matrix_tpu.decomposition.decompose import decomposition_spmm
from arrow_matrix_tpu.io.graphio import load_decomposition as jax_load
from arrow_matrix_tpu.io.graphio import save_decomposition as jax_save
from arrow_matrix_tpu.ops.arrow_blocks import (
    arrow_blocks_streamed as jax_streamed,
)
from arrow_matrix_tpu.parallel.mesh import make_mesh as jax_mesh
from arrow_matrix_tpu_torch.parallel.launch import RankPool
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
JOBS = "_torch_state_jobs"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 64


@pytest.fixture(scope="module")
def pool4():
    with RankPool(4, device="cpu", timeout_s=120) as pool:
        yield pool


@pytest.fixture(scope="module")
def decomp(tmp_path_factory):
    """JAX's test_streaming fixture: BA 600 (m=3, seed 5) at width 64,
    two block-diagonal levels, saved as npy triplets."""
    a = barabasi_albert(600, 3, seed=5)
    levels = jax_decomposition(a, arrow_width=WIDTH, max_levels=2,
                               block_diagonal=True, seed=5)
    base = str(tmp_path_factory.mktemp("streaming") / "g")
    jax_save(levels, base)
    return a, levels, base


@pytest.mark.parametrize("fmt,banded", [("ell", False), ("ell", True),
                                        ("dense", False)])
def test_streamed_shards_equal_jax_rows(pool4, decomp, fmt, banded):
    """Every rank's arrays are the matching block rows of JAX's global
    arrays, byte for byte (a dense stack has no column array in the
    port; JAX's is empty), with JAX's head layout and slot budgets."""
    _, _, base = decomp
    triplet = jax_load(base, WIDTH, mem_map=True)[0][0]
    want = jax_streamed(triplet, WIDTH, jax_mesh((4,), ("blocks",)),
                        pad_blocks_to=16, banded=banded, fmt=fmt)
    kw = dict(pad_blocks_to=16, banded=banded, fmt=fmt)
    got = pool4.run(JOBS, "streamed", base, WIDTH, 0, kw)
    names = ("head", "diag", "col") + (("lo", "hi") if banded else ())
    leaves = [f"{n}_{leaf}" for n in names
              for leaf in ("cols", "data", "deg")] + ["head_rows"]
    for rank, r in enumerate(got):
        assert r["n_blocks"] == 4 and r["first"] == 4 * rank
        assert r["head_flat"] == bool(want.head_flat)
        for leaf in leaves:
            w = getattr(want, leaf)
            if fmt == "dense" and leaf.endswith("_cols"):
                assert np.asarray(w).shape[1:] == (0, 0)
                assert leaf not in r["arrays"]
                continue
            assert (w is None) == (leaf not in r["arrays"]), leaf
            if w is not None:
                rows = np.asarray(w)[4 * rank:4 * rank + 4]
                mine = r["arrays"][leaf]
                assert mine.dtype == rows.dtype, leaf
                assert mine.shape == rows.shape, leaf
                assert mine.tobytes() == rows.tobytes(), leaf


def test_streamed_capture_refusal(pool4, decomp):
    """A tiling narrower than the level refuses on every rank in JAX's
    words (the ranks' captured counts are summed first)."""
    _, _, base = decomp
    msgs = pool4.run(JOBS, "streamed_refusal", base, WIDTH, 1,
                     dict(build_width=8, pad_blocks_to=80))
    triplet = jax_load(base, WIDTH, mem_map=True)[1][0]
    with pytest.raises(ValueError, match="captured") as e:
        jax_streamed(triplet, 8, jax_mesh((4,), ("blocks",)),
                     pad_blocks_to=80)
    for m in msgs:
        assert m is not None and m.startswith("arrow tiling captured")
        assert m.split(":")[0] == str(e.value).split(":")[0]


@pytest.mark.parametrize("kind,kw,shape,names", [
    ("multi_level", dict(fmt="ell"), None, ("blocks",)),
    ("multi_level", dict(fmt="dense"), None, ("blocks",)),
    ("sell_multi", dict(routing="a2a"), None, ("blocks",)),
    ("sell_space", {}, (2, 2), ("lvl", "blocks"))])
def test_memmapped_levels_step_as_in_memory(pool4, decomp, kind, kw, shape,
                                            names):
    """Built from memmapped triplets, each executor's carriage equals the
    in-memory build's on every rank bit for bit, and its step is within
    the gate of the host golden (JAX ``test_streaming.py:72-135``)."""
    a, levels, base = decomp
    x = random_dense(600, 8, seed=6)
    got = pool4.run(JOBS, "memmap_step", base, WIDTH, x, kind, kw, shape,
                    names)
    assert all(r["same"] for r in got)
    mapped, in_memory = got[0]["out"]
    assert mapped.tobytes() == in_memory.tobytes()
    want = decomposition_spmm(levels, x)
    assert relative_error(mapped, want) < relative_tolerance(
        a.nnz / a.shape[0], 1)


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "arrow_matrix_tpu_torch.cli.spmm_arrow",
         *args], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("devices,fmt", [("1", "fold"), ("1", "ell"),
                                         ("2", "sell")])
def test_spmm_arrow_memmap_validates(decomp, tmp_path, monkeypatch, capsys,
                                     devices, fmt):
    """``spmm_arrow --memmap --validate`` on the saved artifact: every
    iteration within the gate, its printed errors equal the run without
    ``--memmap``, and so is its final carriage (the checkpoint) bit for
    bit.  One rank runs in this process; two ranks are started by the
    CLI in a subprocess (both runs at once)."""
    from arrow_matrix_tpu_torch.cli import spmm_arrow

    _, _, base = decomp
    common = ["--path", base, "--width", str(WIDTH), "--features", "4",
              "--iterations", "2", "--carry", "--validate", "--device",
              "cpu", "--devices", devices, "--fmt", fmt]
    runs = (["--memmap", "--checkpoint", "mapped"],
            ["--checkpoint", "in_memory"])
    outs = []
    if devices == "1":
        monkeypatch.chdir(tmp_path)
        for extra in runs:
            assert spmm_arrow.main(common + extra) == 0
            outs.append(capsys.readouterr().out)
    else:
        procs = [_cli(common + extra, str(tmp_path)) for extra in runs]
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, out + err
            outs.append(out)
    errs = [[ln for ln in out.splitlines() if ln.startswith("iteration ")]
            for out in outs]
    assert len(errs[0]) == 2 and errs[0] == errs[1]
    with np.load(tmp_path / "mapped.npz") as a, \
            np.load(tmp_path / "in_memory.npz") as b:
        assert a["x"].tobytes() == b["x"].tobytes() and int(a["step"]) == 2

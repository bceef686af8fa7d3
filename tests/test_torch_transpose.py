"""The backward of the executors' step: ``MultiLevelArrow.transposed_step``
is ``Aᵀ g``, and the autograd Function around ``step`` returns it as the
gradient.

``transposed_step`` is held against scipy's ``A.T @ g`` for every format
and ELL head layout, block-diagonal and banded, on a symmetric
decomposition (BA adjacency, where every level equals its transpose and
nothing is packed) and an asymmetric one (the row-normalized ``D⁻¹A``,
where every level is packed transposed in its own format).  The gate is
``relative_tolerance(nnz/n, 1)``: one f32 SpMM summed in another order
than scipy's, nothing else.  On the CPU the kernels' plain versions run,
so these exercise the same backward the card runs.
"""

import numpy as np
import pytest
import torch
from scipy import sparse

from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.io import (
    as_levels,
    load_decomposition,
    load_level_widths,
    save_decomposition,
)
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow, autograd
from arrow_matrix_tpu_torch.parallel import multi_level
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    random_dense,
    relative_error,
    relative_tolerance,
)

torch.set_num_threads(2)

N, WIDTH, K = 700, 16, 5

#: (fmt, keyword arguments) of every executor format and head layout.
CASES = [("fold", {}), ("dense", {}), ("hyb", {}), ("auto", {}),
         ("ell", {"head_fmt": "flat"}), ("ell", {"head_fmt": "ell"}),
         ("ell", {"head_fmt": "gell"}), ("ell", {"head_fmt": "auto"})]


#: Each case block-diagonal and banded; the fold has no tiling, so once.
TILED = [(case, banded) for case in CASES
         for banded in ((False,) if case[0] == "fold" else (False, True))]


def _ids(case):
    fmt, kw = case
    return fmt + "".join(f"-{v}" for v in kw.values())


def _tiled_ids(tiled):
    case, banded = tiled
    return _ids(case) + ("-banded" if banded else "")


def _carriage(exe, host):
    """Host (n, k) rows -> the executor's f32 carriage (padding zero)."""
    padded = np.zeros((exe.total_rows, host.shape[1]), np.float32)
    padded[:host.shape[0]] = host
    return torch.from_numpy(padded[exe.perm0])


@pytest.fixture(scope="module")
def graphs():
    """The BA adjacency ("sym"), its row normalization ``D⁻¹A`` ("asym":
    the pattern stays symmetric, the values do not) and a directed graph
    keeping 70% of its entries ("directed": binary, the pattern is
    asymmetric, so its transpose has other row degrees)."""
    a = barabasi_albert(N, 4, seed=1).astype(np.float32)
    deg = np.maximum(np.asarray(a.sum(axis=1)).ravel(), 1.0)
    coo = a.tocoo()
    keep = np.random.default_rng(2).random(coo.nnz) < 0.7
    directed = sparse.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=a.shape)
    return {"sym": a,
            "asym": (sparse.diags(1.0 / deg) @ a).tocsr().astype(
                np.float32),
            "directed": directed}


@pytest.fixture(scope="module")
def decompositions(graphs):
    """Three levels of each graph, block-diagonal and banded."""
    return {(name, bd): arrow_decomposition(
                m, WIDTH, max_levels=3, block_diagonal=bd, seed=0)
            for name, m in graphs.items() for bd in (True, False)}


def _executor(levels, fmt, banded=False, **kw):
    if fmt == "auto":
        # Room for the first level dense, the rest ELL.
        rows = MultiLevelArrow(levels, WIDTH, fmt="ell", device="cpu",
                               banded=banded).total_rows
        kw["dense_budget"] = rows * WIDTH * (5 if banded else 3) * 4 + 1
    if fmt == "fold":
        return MultiLevelArrow(levels, WIDTH, fmt="fold", device="cpu")
    return MultiLevelArrow(levels, WIDTH, fmt=fmt, banded=banded,
                           device="cpu", **kw)


@pytest.mark.parametrize("kind", ["sym", "asym", "directed"])
@pytest.mark.parametrize("tiled", TILED, ids=_tiled_ids)
def test_transposed_step_matches_scipy(graphs, decompositions, kind,
                                       tiled):
    (fmt, kw), banded = tiled
    levels = decompositions[(kind, not banded)]
    a = graphs[kind]
    exe = _executor(levels, fmt, banded=banded, **kw)
    g = random_dense(N, K, seed=3)
    got = exe.gather_result(exe.transposed_step(exe.set_features(g)))
    err = relative_error(got, a.T @ g)
    assert err <= relative_tolerance(a.nnz / N), err
    t = exe.transposed()
    if kind == "sym":
        # Every level of an undirected graph is symmetric: the backward
        # runs the forward operator and packs nothing.
        assert t.packed == [] and t.device_bytes == 0
        assert t.sell is None and t.inv is None
        if not exe.folded:
            assert all(tb is b for tb, b in zip(t.blocks, exe.blocks))
    else:
        assert t.packed == ([0] if exe.folded
                            else list(range(len(levels))))
        assert t.device_bytes > 0
        if not exe.folded:
            assert [b.fmt if hasattr(b, "fmt") else "hyb"
                    for b in t.blocks] == [
                b.fmt if hasattr(b, "fmt") else "hyb" for b in exe.blocks]


@pytest.mark.parametrize("kind", ["sym", "asym", "directed"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_step_gradient_is_the_transposed_step(graphs, decompositions,
                                              kind, case):
    """Autograd through ``step``: for ``L = <step(x), c>`` the gradient
    is ``Aᵀ c`` (scipy), and ``x``'s forward value is ``A x``."""
    fmt, kw = case
    a = graphs[kind]
    exe = _executor(decompositions[(kind, True)], fmt, **kw)
    x = exe.set_features(random_dense(N, K, seed=4)).requires_grad_(True)
    c_host = random_dense(N, K, seed=5)
    y = exe.step(x)
    assert y.requires_grad
    (y * exe.set_features(c_host)).sum().backward()
    tol = relative_tolerance(a.nnz / N)
    assert relative_error(exe.gather_result(y.detach()),
                          a @ random_dense(N, K, seed=4)) <= tol
    assert relative_error(exe.gather_result(x.grad), a.T @ c_host) <= tol
    # Padding rows take no gradient: nothing flows into them.
    pad = torch.from_numpy(exe.perm0 >= exe.n)
    assert not bool(x.grad[pad].any())


def test_symmetric_builds_nothing_and_asymmetric_builds_once(
        decompositions, monkeypatch):
    """The transposed operator is built lazily, at the first backward,
    and once: later backwards reuse it."""
    calls = []
    real = multi_level.build_transposed

    def counted(exe):
        calls.append(exe)
        return real(exe)

    monkeypatch.setattr(multi_level, "build_transposed", counted)
    for kind in ("sym", "asym"):
        for fmt in ("ell", "fold"):
            exe = _executor(decompositions[(kind, True)], fmt)
            x = exe.set_features(random_dense(N, 2, seed=6))
            exe.run(x, 3)                   # serving builds nothing
            assert exe._transposed is None and not calls
            for _ in range(3):
                xg = x.clone().requires_grad_(True)
                exe.run(xg, 2).sum().backward()
            assert calls == [exe]
            t = exe.transposed()
            assert t.seconds > 0.0
            if kind == "sym":
                assert t.packed == [] and t.device_bytes == 0
            else:
                assert t.packed and t.device_bytes > 0
            calls.clear()


def test_fold_transpose_unsorts_into_carriage_order(graphs,
                                                    decompositions):
    """The transposed fold is packed by its own row degrees: for a
    directed graph its sort differs from the forward's, and the K4 row
    gather ``inv`` puts the rows back.  Without the unsort the product
    is wrong, which neither a symmetric operator nor ``D⁻¹A`` (a
    symmetric pattern: the same degrees, so ``inv`` is the identity)
    could show."""
    exe = _executor(decompositions[("asym", True)], "fold")
    assert np.array_equal(exe.transposed().inv.numpy(),
                          np.arange(exe.total_rows))
    exe = _executor(decompositions[("directed", True)], "fold")
    t = exe.transposed()
    inv = t.inv.numpy()
    assert sorted(inv.tolist()) == list(range(exe.total_rows))
    assert not np.array_equal(inv, np.arange(exe.total_rows))
    g = exe.set_features(random_dense(N, K, seed=7))
    sorted_rows = multi_level.sell_spmm_cuda(t.sell, g)
    want = graphs["directed"].T @ random_dense(N, K, seed=7)
    tol = relative_tolerance(graphs["directed"].nnz / N)
    assert relative_error(exe.gather_result(sorted_rows), want) > 100 * tol
    assert relative_error(exe.gather_result(
        sorted_rows[torch.from_numpy(inv.astype(np.int64))]), want) <= tol


def test_loaded_fold_builds_the_same_transpose(decompositions, tmp_path):
    """An executor made by ``load_folded`` has no levels: it rebuilds the
    operator from its SELL tiers, and its backward equals the one of the
    executor it was exported from, bit for bit (the same tiers)."""
    exe = _executor(decompositions[("directed", True)], "fold")
    exe.export_folded(str(tmp_path))
    loaded = MultiLevelArrow.load_folded(str(tmp_path), device="cpu")
    g = exe.set_features(random_dense(N, K, seed=8))
    assert torch.equal(exe.transposed_step(g), loaded.transposed_step(g))
    assert loaded.transposed().packed == [0]


def test_memmapped_levels_transpose(graphs, tmp_path):
    """Levels loaded as memmapped triplets (no scipy matrix) transpose
    too: the level is read into a CSR once, at the first backward."""
    a = graphs["asym"]
    levels = arrow_decomposition(a, WIDTH, max_levels=3,
                                 block_diagonal=True, seed=0)
    base = str(tmp_path / "asym")
    save_decomposition(levels, base, block_diagonal=True)
    loaded = as_levels(load_decomposition(base, WIDTH, block_diagonal=True,
                                          mem_map=True),
                       load_level_widths(base, WIDTH, True),
                       materialize=False)
    assert not isinstance(loaded[0].matrix, sparse.csr_matrix)
    exe = MultiLevelArrow(loaded, WIDTH, fmt="ell", device="cpu")
    g = random_dense(N, K, seed=9)
    got = exe.gather_result(exe.transposed_step(exe.set_features(g)))
    assert relative_error(got, a.T @ g) <= relative_tolerance(a.nnz / N)


def test_transposed_heads_resolve_for_the_transposed_level(
        decompositions):
    """The level's format is kept (``fmts``, not resolved again), and a
    head layout named by the caller is kept too; "auto" resolves for
    the transposed head by the same rule, and here picks the same
    layout as the forward (on the CPU: the flat/ELL size rule)."""
    levels = decompositions[("asym", True)]

    def transposed_heads(exe):
        return ["gell" if b.head_gell else "flat" if b.head_flat else "ell"
                for b in exe.transposed().blocks]

    for head in ("flat", "ell", "gell"):
        exe = _executor(levels, "ell", head_fmt=head)
        assert transposed_heads(exe) == [head] * len(levels)
    exe = _executor(levels, "ell", head_fmt="auto")
    assert transposed_heads(exe) == exe.head_layouts()
    exe = _executor(levels, "auto")
    assert [type(b).__name__ for b in exe.transposed().blocks] == \
        [type(b).__name__ for b in exe.blocks]
    assert [b.fmt for b in exe.transposed().blocks] == exe.fmts


def test_step_fn_is_step_and_takes_only_its_own_operands(decompositions):
    for fmt in ("hyb", "fold"):
        exe = _executor(decompositions[("asym", True)], fmt)
        x = exe.set_features(random_dense(N, K, seed=10))
        assert torch.equal(exe.step(x), exe.step_fn(x, *exe.step_operands()))
        other = _executor(decompositions[("sym", True)], fmt)
        with pytest.raises(ValueError, match="step_operands"):
            exe.step_fn(x, *other.step_operands())
    assert exe.carries_feature_major
    assert not _executor(decompositions[("sym", True)],
                         "dense").carries_feature_major


def test_int8_carriage_steps_without_autograd(decompositions):
    """The int8 pair is stepped and requantized as before; it takes no
    gradient, so the Function is not entered and nothing is built."""
    exe = MultiLevelArrow(decompositions[("asym", True)], WIDTH,
                          fmt="fold", feature_dtype="int8", device="cpu")
    q, scale = exe.step(exe.set_features(random_dense(N, K, seed=11)))
    assert q.dtype == torch.int8 and scale.shape == (1, K)
    assert exe._transposed is None


def test_bf16_carriage_gradient_is_f32_math(graphs, decompositions):
    """A bf16 fold carriage: the step reads and writes bf16 (as the JAX
    package's does); the backward runs in f32, and the gradient to a
    bf16 input is ``Aᵀ g`` rounded to bf16 once (2e-2: bf16's 8-bit
    mantissa)."""
    exe = MultiLevelArrow(decompositions[("asym", True)], WIDTH,
                          fmt="fold", feature_dtype="bf16", device="cpu")
    x = exe.set_features(random_dense(N, K, seed=12)).requires_grad_(True)
    y = exe.step(x)
    assert x.dtype == y.dtype == torch.bfloat16
    c = random_dense(N, K, seed=13)
    (y * _carriage(exe, c)).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    want = graphs["asym"].T @ c
    assert relative_error(exe.gather_result(x.grad), want) <= 2e-2


def test_transpose_helpers():
    """``sell_to_csr`` inverts the SELL packing (binary and weighted),
    and ``is_symmetric`` compares values, not only the pattern."""
    from arrow_matrix_tpu_torch.ops.sell import sell_from_csr

    a = barabasi_albert(300, 3, seed=2).astype(np.float32)
    for m in (a, (sparse.diags(np.arange(1, 301, dtype=np.float32)) @ a)
              .tocsr()):
        sell, order = sell_from_csr(m, device="cpu")
        back = autograd.sell_to_csr(sell)
        inv = np.argsort(order)
        want = m[order][:, order]
        assert (back != want).nnz == 0, inv
    assert autograd.is_symmetric(a.tocsr())
    scaled = (sparse.diags(np.arange(1, 301, dtype=np.float32)) @ a).tocsr()
    assert autograd.is_symmetric(scaled != 0)
    assert not autograd.is_symmetric(scaled)

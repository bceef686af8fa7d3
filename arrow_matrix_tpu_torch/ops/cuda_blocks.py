"""The dense arrow-block kernels K2 and K3: wrapper of
``csrc/arrow_blocks_spmm.cu``.

Counterpart of ``arrow_matrix_tpu/ops/pallas_blocks.py``:
:func:`column_spmm` launches K2 (every block row but the head),
:func:`column_rows_spmm` launches it over a range of an operand's block
rows (a mesh rank's own blocks), :func:`head_spmm` launches K3 (the
head row), and
:func:`arrow_spmm_cuda` composes them into one level's product, K3
writing straight into block 0 of the output K2 fills.  Blocks are
float32 or bfloat16, features and results float32, sums float32.

For CUDA tensors the wrappers check device, dtype, shape and
contiguity, launch on PyTorch's current stream, raise on a launch error
and add one to :data:`LAUNCHES_K2` / :data:`LAUNCHES_K3`.  For CPU
tensors they run the plain versions (``ops/arrow_blocks.py``).  There
is no fallback: a failed build or launch raises.

K3 splits the block axis into the contiguous chunks of
:func:`head_chunks`, one partial sum each, added in chunk order by a
second pass; :func:`head_split` picks the split from ``(nb, w, k)``
alone, so the order of every sum is fixed by the shapes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from arrow_matrix_tpu_torch.ops import _build
from arrow_matrix_tpu_torch.ops import arrow_blocks as plain
from arrow_matrix_tpu_torch.ops.arrow_blocks import ArrowBlocks
from arrow_matrix_tpu_torch.ops.cuda_sell import check_operand
from arrow_matrix_tpu_torch.ops.kernel_span import kernel_call

#: K2 launches made by this process (one per level product with nb > 1).
LAUNCHES_K2 = 0
#: K3 launches made by this process (one per level product).
LAUNCHES_K3 = 0

#: Block-dtype code of the C interface.
BLOCK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: A CTA's tile by feature count: (largest k, rows, feature columns) of
#: the kernels' Narrow, Mid and Wide configurations
#: (``csrc/arrow_blocks_spmm.cu:column_for`` / ``head_for`` choose the
#: same way).
TILES = ((16, 64, 16), (64, 128, 64), (None, 128, 128))
#: K3's split aims at this many CTAs: a Narrow CTA with f32 blocks holds
#: 45 KB of shared memory, so about five fit an SM and some 660 fill the
#: 132 SMs once.
HEAD_CTAS = 1024
#: K3's workspace of partial sums is at most this many bytes.
HEAD_WORKSPACE_BYTES = 64 << 20

_LIB = "arrow_blocks_spmm"
_FNS = {}
#: Pointer and int arguments of each C entry point (after the block
#: dtype code and ``vec``; the stream comes last).
_ARGS = {"arrow_column_spmm": (6, 5), "arrow_head_spmm": (4, 4)}


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        lib = _build.load(_LIB)
        fn = getattr(lib, name)
        ptrs, ints = _ARGS[name]
        fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * ptrs
                       + [ctypes.c_int] * ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tile_shape(k: int) -> tuple:
    """(rows, feature columns) of a K2/K3 CTA at feature count ``k``."""
    return next((bm, bn) for k_max, bm, bn in TILES
                if k_max is None or k <= k_max)


def head_split(nb: int, w: int, k: int) -> int:
    """Partial sums S of K3 for ``(nb, w, k)``: enough CTAs of
    ``S x tiles`` to reach :data:`HEAD_CTAS`, at most ``nb`` and at
    most :data:`HEAD_WORKSPACE_BYTES` of partials, and no empty chunk
    (``S = ceil(nb / ceil(nb / S))``).  S = 1 needs no workspace."""
    bm, bn = tile_shape(k)
    tiles = _ceil_div(w, bm) * _ceil_div(k, bn)
    s = min(nb, _ceil_div(HEAD_CTAS, tiles),
            HEAD_WORKSPACE_BYTES // (4 * w * k))
    if s <= 1:
        return 1
    return _ceil_div(nb, _ceil_div(nb, s))


def head_chunks(nb: int, w: int, k: int) -> list:
    """The contiguous ranges of b whose products K3 sums into each
    partial, in the order pass 2 adds them."""
    chunk = _ceil_div(nb, head_split(nb, w, k))
    return [range(lo, min(nb, lo + chunk)) for lo in range(0, nb, chunk)]


def _dims(x: torch.Tensor) -> tuple:
    if x.dim() != 3:
        raise ValueError(f"x must be (nb, w, k), got {tuple(x.shape)}")
    nb, w, k = x.shape
    if min(nb, w, k) < 1:
        raise ValueError(f"empty operand x {tuple(x.shape)}")
    if max(nb, w, k) > 2**31 - 1:
        raise ValueError("nb, w and k must fit in int32")
    return nb, w, k


def _operands(x: torch.Tensor, blocks: dict, out: Optional[torch.Tensor],
              out_shape: tuple, block_rows: Optional[int] = None):
    """Validate a launch's operands (x already 3-D; the stacks hold
    ``block_rows`` blocks, default x's); returns (block dtype code, vec,
    out), allocating ``out`` when it is None."""
    nb, w, k = x.shape
    dev = x.device
    check_operand("x", x, torch.float32, (nb, w, k), dev)
    dtype = next(iter(blocks.values())).dtype
    if dtype not in BLOCK_DTYPES:
        raise ValueError(f"unsupported block dtype {dtype}; the kernels "
                         f"take {tuple(BLOCK_DTYPES)}")
    for name, t in blocks.items():
        check_operand(name, t, dtype,
                      (nb if block_rows is None else block_rows, w, w), dev)
    if out is None:
        out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    else:
        check_operand("out", out, torch.float32, out_shape, dev)
    # 16-byte copies of every tile, and float4 stores of the output.
    vec = int(w % (16 // dtype.itemsize) == 0 and k % 4 == 0
              and all(t.data_ptr() % 16 == 0
                      for t in (x, out, *blocks.values())))
    return BLOCK_DTYPES[dtype], vec, out


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        lib = _build.load(_LIB)
        lib.arrow_blocks_error_string.restype = ctypes.c_char_p
        lib.arrow_blocks_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.arrow_blocks_error_string(code).decode()} (code {code})")


@kernel_call
def column_spmm(diag: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                lo: Optional[torch.Tensor] = None,
                hi: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: ``out[b] = A_bb X_b + A_b0 X_0 [+ A_b,b-1 X_{b-1} +
    A_b,b+1 X_{b+1}]`` for b >= 1 into ``out`` (nb, w, k) float32.

    diag/col (and lo/hi, banded) ``(nb, w, w)`` float32 or bfloat16; x
    ``(nb, w, k)`` float32.  Block 0 of ``out`` is the head row's: the
    kernel leaves it as it finds it (zero when this function allocates
    ``out``).  CPU tensors take the plain ``arrow_blocks.column_spmm``.
    """
    if x.device.type == "cpu":
        res = plain.column_spmm(diag, col, x, lo, hi)
        if out is None:
            return res
        out[1:] = res[1:]
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (lo is None) != (hi is None):
        raise ValueError("pass both lo and hi (banded) or neither")
    nb, w, k = _dims(x)
    stacks = {"diag": diag, "col": col}
    if lo is not None:
        stacks.update(lo=lo, hi=hi)
    fresh = out is None
    code_dtype, vec, out = _operands(x, stacks, out, (nb, w, k))
    if fresh:
        out[0].zero_()
    if nb == 1:
        return out             # no block row besides the head
    rows = {name: t[1:] for name, t in stacks.items()}
    _column_launch(code_dtype, vec, rows, x, out[1:], 1)
    return out


@kernel_call
def column_rows_spmm(diag: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
                     first: int, lo: Optional[torch.Tensor] = None,
                     hi: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 over the block rows ``b = first .. first + rows - 1`` of the
    operand ``x (nb, w, k)`` float32: ``out[z] = A_bb X_b + A_b0 X_0 [+
    A_b,b-1 X_{b-1} + A_b,b+1 X_{b+1}]`` with ``b = first + z``, the
    last term only where ``b + 1 < nb``.

    diag/col (and lo/hi, banded) ``(rows, w, w)`` float32 or bfloat16
    hold those rows' blocks only; ``out`` ``(rows, w, k)`` float32.
    ``first >= 1`` (block 0 of the operand is X_0).  CPU tensors take
    the plain ``arrow_blocks.column_rows_spmm``."""
    if x.device.type == "cpu":
        res = plain.column_rows_spmm(diag, col, x, first, lo, hi)
        if out is None:
            return res
        out.copy_(res)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (lo is None) != (hi is None):
        raise ValueError("pass both lo and hi (banded) or neither")
    nb, w, k = _dims(x)
    rows = diag.shape[0] if diag.dim() == 3 else 0
    if first < 1 or rows < 1 or first + rows > nb:
        raise ValueError(f"block rows {first}..{first + rows - 1} outside "
                         f"the operand's 1..{nb - 1}")
    stacks = {"diag": diag, "col": col}
    if lo is not None:
        stacks.update(lo=lo, hi=hi)
    code_dtype, vec, out = _operands(x, stacks, out, (rows, w, k),
                                     block_rows=rows)
    _column_launch(code_dtype, vec, stacks, x, out, first)
    return out


def _column_launch(code_dtype: int, vec: int, stacks: dict,
                   x: torch.Tensor, out: torch.Tensor, first: int) -> None:
    """One K2 launch over validated operands: ``stacks`` and ``out``
    hold the block rows ``first ..`` of ``x``."""
    global LAUNCHES_K2
    nb, w, k = x.shape
    rows = out.shape[0]
    lo, hi = stacks.get("lo"), stacks.get("hi")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _kernel("arrow_column_spmm")(
            code_dtype, vec, stacks["diag"].data_ptr(),
            stacks["col"].data_ptr(),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), x.data_ptr(),
            out.data_ptr(), nb, w, k, first, rows, stream)
    _raise_on(code, f"column_blocks_spmm (nb={nb} w={w} k={k} "
                    f"rows {first}..{first + rows - 1} "
                    f"{stacks['diag'].dtype})")
    LAUNCHES_K2 += 1


@kernel_call
def head_spmm(head: torch.Tensor, x: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: ``out = sum_b A_0b X_b`` into ``out`` (w, k) float32.

    head ``(nb, w, w)`` float32 or bfloat16, x ``(nb, w, k)`` float32.
    On the card the sum runs over the chunks of :func:`head_chunks`
    into a ``(S, w, k)`` float32 workspace allocated here, then over the
    partials in order.  CPU tensors take the plain
    ``arrow_blocks.head_spmm``.
    """
    global LAUNCHES_K3
    if x.device.type == "cpu":
        res = plain.head_spmm(head, x)
        if out is None:
            return res
        out.copy_(res)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    nb, w, k = _dims(x)
    code_dtype, vec, out = _operands(x, {"head": head}, out, (w, k))
    parts = head_split(nb, w, k)
    # Freed on return while the kernels may still run: the caching
    # allocator hands it out again only to work queued after them on
    # this stream.
    part = (torch.empty((parts, w, k), dtype=torch.float32, device=x.device)
            if parts > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = _kernel("arrow_head_spmm")(
            code_dtype, vec, head.data_ptr(), x.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), nb, w, k,
            _ceil_div(nb, parts), stream)
    _raise_on(code, f"head_blocks_spmm (nb={nb} w={w} k={k} {head.dtype})")
    LAUNCHES_K3 += 1
    return out


@kernel_call
def arrow_spmm_cuda(blocks: ArrowBlocks, x: torch.Tensor) -> torch.Tensor:
    """One level's product through K3 and K2: x ``(nb, w, k)`` float32
    -> ``(nb, w, k)`` float32, one launch of each (K2 none when nb = 1).
    CPU tensors take the plain ``arrow_blocks.arrow_spmm``."""
    if x.device.type == "cpu":
        return plain.arrow_spmm(blocks, x)
    if blocks.fmt != "dense":
        raise ValueError(f"K2 and K3 take dense blocks, not "
                         f"fmt={blocks.fmt!r} (ELL levels run through "
                         f"ops/cuda_ell.py)")
    nb, w, k = x.shape
    if nb != blocks.n_blocks or w != blocks.width:
        raise ValueError(f"x must be ({blocks.n_blocks}, {blocks.width}, "
                         f"k), got {tuple(x.shape)}")
    out = torch.empty((nb, w, k), dtype=torch.float32, device=x.device)
    head_spmm(blocks.head_data, x, out=out[0])
    return column_spmm(blocks.diag_data, blocks.col_data, x,
                       blocks.lo_data, blocks.hi_data, out=out)


# -- the Hopper kernel contract (ops/kernel_contract.py) ---------------------

#: The kernels' tile configurations, as ``csrc/arrow_blocks_spmm.cu``
#: declares them (``using Narrow = Cfg<...>``): BM, BN, TM, TN, AV, ring
#: buffers with f32 and with bf16 blocks, and the launch bound's CTAs an
#: SM.  The certifier checks the source against this mirror, and
#: :data:`TILES` against it.
CONFIGS = {"Narrow": (64, 16, 4, 4, 4, 4, 3, 4),
           "Mid": (128, 64, 8, 4, 4, 3, 3, 2),
           "Wide": (128, 128, 8, 8, 2, 4, 4, 1)}
#: Contraction depth of one tile (``BK``).
BK = 32
#: The configuration of each row of :data:`TILES`.
TILE_CONFIGS = ("Narrow", "Mid", "Wide")


def ring_bytes(config: str, itemsize: int) -> int:
    """Dynamic shared memory of one CTA of ``config`` with blocks of
    ``itemsize`` bytes: its ring of (block tile, feature tile) buffers
    (``csrc``'s ``struct Ring``)."""
    bm, bn, _, _, _, s32, s16, _ = CONFIGS[config]
    stages = s32 if itemsize == 4 else s16
    a_stride = BK + 16 // itemsize
    return stages * (bm * a_stride * itemsize + BK * bn * 4)


def config_for(k: int) -> str:
    """The configuration K2/K3 launch at ``k`` features."""
    return next(c for (k_max, _, _), c in zip(TILES, TILE_CONFIGS)
                if k_max is None or k <= k_max)


def dense_meta(kernel_pass: str, nb: int, w: int, k: int,
               block_dtype: str) -> dict:
    """The literal description of one K2 (``"column"``) or K3
    (``"head"``) launch over ``(nb, w, w)`` blocks at ``k`` features:
    what ``analysis/kernels.py`` checks."""
    config = config_for(k)
    bm, bn, tm, tn, av, _, _, minb = CONFIGS[config]
    item = 4 if block_dtype == "f32" else 2
    threads = (bn // tn) * (bm // tm)
    tiles = (_ceil_div(w, bm), _ceil_div(k, bn))
    meta = {"kernel": "arrow_blocks_spmm", "kind": "dense_blocks",
            "pass": kernel_pass, "config": config, "bm": bm, "bn": bn,
            "nb": nb, "w": w, "k": k, "block_dtype": block_dtype,
            "threads": threads, "ctas_per_sm": minb, "static_smem": 0,
            "dynamic_smem": ring_bytes(config, item),
            # acc TM x TN, AV block values of TM rows, TN feature values.
            "regs_demand": 24 + tm * tn + av * tm + tn,
            "accum_dtype": "f32", "tiles": list(tiles)}
    if kernel_pass == "column":
        meta["grid"] = [tiles[0], tiles[1], nb - 1]
        meta["writes_blocks"] = list(range(1, nb))
    else:
        chunks = head_chunks(nb, w, k)
        meta["grid"] = [tiles[0], tiles[1], len(chunks)]
        meta["split"] = head_split(nb, w, k)
        meta["chunks"] = [[c.start, c.stop] for c in chunks]
        meta["writes_blocks"] = [0]
    return meta


def kcert_metas() -> list:
    """K2/K3 metas at each tile configuration (k 8, 16, 64, 128, 200),
    both block dtypes, on small and large block counts."""
    metas = []
    for k in (8, 16, 64, 128, 200):
        for dt in ("f32", "bf16"):
            for nb, w in ((3, 48), (33, 200), (64, 2048), (512, 2048)):
                metas.append(dense_meta("column", nb, w, k, dt))
                metas.append(dense_meta("head", nb, w, k, dt))
    return metas


def kcert_witness():
    """KC1 boundary witness -> (ok, detail): the plain K2/K3 products on
    blocks of the largest index (every block nonzero only in its last
    row and column) equal a float64 reference."""
    import numpy as np

    rng = np.random.default_rng(0)
    nb, w, k = 3, 48, 20
    diag = np.zeros((nb, w, w), np.float32)
    diag[:, -1, -1] = 1.0
    col = np.zeros((nb, w, w), np.float32)
    col[:, -1, -1] = 2.0
    head = np.zeros((nb, w, w), np.float32)
    head[:, -1, -1] = 3.0
    x = rng.uniform(-1, 1, (nb, w, k)).astype(np.float32)
    got_c = plain.column_spmm(torch.from_numpy(diag), torch.from_numpy(col),
                              torch.from_numpy(x)).numpy()
    got_h = plain.head_spmm(torch.from_numpy(head),
                            torch.from_numpy(x)).numpy()
    want_c = diag.astype(np.float64) @ x + col.astype(np.float64) @ x[0]
    want_c[0] = 0.0                    # block 0 is the head row's
    want_h = sum(head[b].astype(np.float64) @ x[b] for b in range(nb))
    if not (np.isfinite(got_c).all() and np.isfinite(got_h).all()):
        return False, "non-finite boundary output"
    if not (np.allclose(got_c, want_c, atol=1e-5)
            and np.allclose(got_h, want_h, atol=1e-5)):
        return False, "boundary blocks: plain K2/K3 != float64 reference"
    return True, ("blocks nonzero in the last row and column only: plain "
                  "K2/K3 equal the float64 products")


def kcert_entry():
    """K2/K3's certifiable entry (``ops/kernel_contract.builtin_kernels``)."""
    import os

    from arrow_matrix_tpu_torch.ops.kernel_contract import (
        KernelContract,
        KernelEntry,
    )

    contract = KernelContract(
        name="arrow_blocks_spmm",
        module="arrow_matrix_tpu_torch.ops.cuda_blocks",
        kind="dense_blocks",
        source="csrc/arrow_blocks_spmm.cu",
        threads=max((c[1] // c[3]) * (c[0] // c[2])
                    for c in CONFIGS.values()),
        ctas_per_sm=tuple(sorted({c[7] for c in CONFIGS.values()})),
        static_smem_bytes=0,
        dynamic_smem_bytes=max(ring_bytes(c, i) for c in CONFIGS
                               for i in (4, 2)),
        knobs=(("config", TILE_CONFIGS),),
        ks=(8, 16, 64, 128),
        carriage_dtypes=("f32",),
        accum_dtype="f32",
        accum_decls=("float acc[C::TM][C::TN] = {};",
                     "float s = __ldg(part + i);"))
    return KernelEntry(contract=contract, metas=kcert_metas,
                       source_path=os.path.join(_build.CSRC_DIR,
                                                "arrow_blocks_spmm.cu"),
                       witness=kcert_witness)

"""Gather-rate probes on the card: the cost model of the port's
SELL kernel and of its routing.

Counterpart of ``tools/gather_probe.py``.  Measures the library
gather's rate (``ops.gather.take``, row-major ``index_select``) in
slots/s over the feature count, the carriage dtype and the order of
the indices, K4's row gather beside it in f32, and the fold step (one
K1 product) at the JAX package's protocol shape for k in {16, 128}:

    python -m arrow_matrix_tpu_torch.tools.gather_probe
    python -m arrow_matrix_tpu_torch.tools.gather_probe --device cpu

On the card: gathers of n * 16 slots from n = 2^20 rows, and the fold
of Barabasi-Albert n = 2^20 m = 8 at width 2048 (seed 7, max_levels
12), decomposed once and cached under ``arrow_matrix_tpu_torch/_build/
cache/``.  ``--device cpu`` takes n = 2^12 (width 256) and times with
the host clock.  Prints one line per measurement and a JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
from arrow_matrix_tpu_torch.decomposition.decompose import resolved_backend
from arrow_matrix_tpu_torch.io import (
    as_levels,
    load_decomposition,
    load_level_widths,
    save_decomposition,
)
from arrow_matrix_tpu_torch.ops.cuda_gather import row_gather
from arrow_matrix_tpu_torch.ops.gather import take
from arrow_matrix_tpu_torch.ops.sell import sell_spmm
from arrow_matrix_tpu_torch.parallel import MultiLevelArrow
from arrow_matrix_tpu_torch.utils import (
    barabasi_albert,
    card_report,
    random_dense,
    relative_error,
    relative_tolerance,
    resolve_device,
)
from arrow_matrix_tpu_torch.utils.timing import chained_iteration_ms, median_ms

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_build", "cache")
#: Slots of each gather checked against the host, at most.
CHECKED_SLOTS = 1 << 16


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of an f32 or bf16 tensor, for a bitwise compare."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def gather_rates(n: int = 1 << 20, m: int = 16, device=None,
                 ks=(16, 64, 128), reps: int = 10) -> list:
    """``take`` of ``n * m`` random rows (seed 0) from ``(n, k)``
    features, f32 and bf16, indices random and sorted: one record each
    with ``ms`` (median of ``reps``), ``mslots_s``, ``exact`` (the
    gathered rows of up to :data:`CHECKED_SLOTS` slots equal the host's
    bit for bit), and ``index_ms`` / ``index_mslots_s`` of the same
    gather by advanced indexing, ``x[idx.long()]``; f32 records also
    carry K4's row gather (``ops.cuda_gather.row_gather``): ``k4_ms``,
    ``k4_mslots_s`` and ``k4_exact`` (its rows equal ``take``'s bit for
    bit)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, n, size=n * m, dtype=np.int32)
    orders = {"random": idx, "sorted": np.sort(idx)}
    check = rng.choice(idx.size, size=min(CHECKED_SLOTS, idx.size),
                       replace=False)
    records = []
    for k in ks:
        x32 = torch.from_numpy(rng.standard_normal((n, k)).astype(
            np.float32))
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x_host = x32.to(dtype)
            x = x_host.to(dev)
            for order, ind in orders.items():
                ind_d = torch.from_numpy(ind).to(dev)
                got = take(x, ind_d)[torch.from_numpy(check).to(dev)].cpu()
                want = x_host[torch.from_numpy(ind[check]).long()]
                exact = torch.equal(_bits(got), _bits(want))
                ms = median_ms(lambda: take(x, ind_d), reps, dev)
                # The other PyTorch gather (advanced indexing), timed
                # beside take as a second yardstick.
                ind_l = ind_d.long()
                index_ms = median_ms(lambda: x[ind_l], reps, dev)
                rec = {"k": k, "dtype": dt, "order": order,
                       "slots": int(ind.size), "exact": exact,
                       "ms": ms, "mslots_s": ind.size / ms / 1e3,
                       "index_ms": index_ms,
                       "index_mslots_s": ind.size / index_ms / 1e3}
                del ind_l
                if dtype == torch.float32:
                    rec["k4_exact"] = torch.equal(
                        _bits(row_gather(x, ind_d)), _bits(take(x, ind_d)))
                    k4_ms = median_ms(lambda: row_gather(x, ind_d), reps,
                                      dev)
                    rec.update(k4_ms=k4_ms,
                               k4_mslots_s=ind.size / k4_ms / 1e3)
                records.append(rec)
            del x
    return records


def cache_base(n: int, m: int, width: int, seed: int, max_levels: int,
               backend: str = "numpy", cache_dir: Optional[str] = None
               ) -> str:
    """Artifact base of the cached decomposition of BA ``n`` ``m`` at
    ``width`` (``seed``, ``max_levels``) by ``backend``, resolved to the
    decomposer that runs here ("auto" -> "native" or "numpy"): the two
    backends draw different random forests, so each has its own key."""
    return os.path.join(
        cache_dir or CACHE_DIR,
        f"ba_{n}_{m}_w{width}_s{seed}_L{max_levels}_"
        f"{resolved_backend(backend)}")


def store_levels(levels, base: str) -> None:
    """Save ``levels`` under ``base`` and then its completion sentinel,
    so that a run killed mid-write leaves nothing a later run loads."""
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    if os.path.exists(base + ".complete"):
        os.remove(base + ".complete")
    save_decomposition(levels, base, block_diagonal=True)
    with open(base + ".complete", "w") as fh:
        fh.write(f"{len(levels)} levels\n")


def cached_levels(n: int, m: int, width: int, seed: int,
                  max_levels: int = 4, cache_dir: Optional[str] = None,
                  backend: str = "numpy"):
    """Generate and decompose once per (n, m, width, seed, max_levels,
    backend), then reload the saved artifact from ``cache_dir`` (default
    :data:`CACHE_DIR`; ``bench.py:_cached_levels``); see
    :func:`cache_base` and :func:`store_levels`."""
    base = cache_base(n, m, width, seed, max_levels, backend, cache_dir)
    if os.path.exists(base + ".complete"):
        try:
            loaded = load_decomposition(base, width, block_diagonal=True)
            widths = load_level_widths(base, width, block_diagonal=True)
            return as_levels(loaded, widths if widths is not None
                             else width)
        except FileNotFoundError:
            pass
    a = barabasi_albert(n, m, seed=seed)
    levels = arrow_decomposition(a, arrow_width=width,
                                 max_levels=max_levels,
                                 block_diagonal=True, seed=seed,
                                 backend=backend)
    try:
        store_levels(levels, base)
    except OSError as e:            # the cache is best-effort
        print(f"decomposition cache write failed: {e}", file=sys.stderr)
    return levels


def fold_executor(device=None, n: int = 1 << 20, width: int = 2048,
                  max_levels: int = 12,
                  cache_dir: Optional[str] = None) -> MultiLevelArrow:
    """The fold of BA ``n`` m=8 at ``width`` (seed 7, ``max_levels``),
    its levels from :func:`cached_levels`, on ``device``."""
    dev = resolve_device(device)
    levels = cached_levels(n, 8, width, seed=7, max_levels=max_levels,
                           cache_dir=cache_dir)
    return MultiLevelArrow(levels, width, fmt="fold", device=dev)


def fold_step(k: int, multi: Optional[MultiLevelArrow] = None,
              device=None, iters: int = 10) -> dict:
    """The fold step at ``k`` features: tiers, slots, slots/nnz and
    device bytes of the operator, then for the f32 and bf16 carriages
    of one build the ms/iter of ``iters`` chained steps (median of 7
    chains), M slots/s, and the relative error of one step against the
    plain ``sell_spmm`` on the same operator.  ``multi`` is a built fold
    executor, by default :func:`fold_executor` on ``device``."""
    if multi is None:
        multi = fold_executor(device)
    sell = multi.sell
    rec = {"k": k, "n": multi.n, "tiers": len(sell.cols),
           "live_tiers": len(sell.live_tiers()), "slots": sell.n_slots,
           "slots_per_nnz": sell.n_slots / multi.nnz,
           "device_bytes": sell.device_nbytes(), "carriages": {}}
    x_host = random_dense(multi.n, k, seed=3)
    # One build, both carriages: the feature dtype is read only by
    # set_features, so switching it measures bf16 on the same operator.
    keep = multi.feature_dtype
    try:
        for name, dtype in (("f32", torch.float32),
                            ("bf16", torch.bfloat16)):
            multi.feature_dtype = dtype
            x = multi.set_features(x_host)
            err = relative_error(multi.step(x).float().cpu().numpy(),
                                 sell_spmm(sell, x).float().cpu().numpy())
            ms = chained_iteration_ms(multi.run, x, iters)
            rec["carriages"][name] = {"ms_per_iter": ms,
                                      "mslots_s": sell.n_slots / ms / 1e3,
                                      "rel_err_vs_plain": err}
            del x
    finally:
        multi.feature_dtype = keep
    return rec


def fold_gate(rec: dict, row_nnz: float) -> bool:
    """Whether every carriage of a :func:`fold_step` record agrees with
    the plain product: ``relative_tolerance(row_nnz)`` in f32, 2e-2 in
    bf16 (the kernel and the plain version round their bf16 outputs
    from sums taken in another order)."""
    c = rec["carriages"]
    return (c["f32"]["rel_err_vs_plain"] <= relative_tolerance(row_nnz)
            and c["bf16"]["rel_err_vs_plain"] <= 2e-2)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_report(dev)
    print(f"device: {dev.type} {card or 'cpu (host clock)'}", flush=True)
    n, width = (1 << 12, 256) if dev.type == "cpu" else (1 << 20, 2048)
    rates = gather_rates(n=n, device=dev)
    for r in rates:
        print(f"take k={r['k']:4d} {r['dtype']:4s} {r['order']:6s}: "
              f"{r['ms']:9.4f} ms ({r['mslots_s']:.0f}M slots/s) exact "
              f"{r['exact']}; x[idx] {r['index_ms']:9.4f} ms"
              + (f"; K4 {r['k4_ms']:9.4f} ms ({r['k4_mslots_s']:.0f}M "
                 f"slots/s) exact {r['k4_exact']}" if "k4_ms" in r else ""),
              flush=True)
    folds = []
    multi = fold_executor(dev, n, width)
    for k in (16, 128):
        rec = fold_step(k, multi)
        rec["gated"] = fold_gate(rec, multi.nnz / multi.n)
        folds.append(rec)
        print(f"fold k={k}: tiers={rec['tiers']} slots={rec['slots']} "
              f"({rec['slots_per_nnz']:.2f}x nnz) "
              f"bytes={rec['device_bytes'] / 2**30:.2f} GiB", flush=True)
        for name, c in rec["carriages"].items():
            print(f"fold k={k} feat={name}: {c['ms_per_iter']:.4f} ms/iter "
                  f"({c['mslots_s']:.0f}M slots/s), vs plain "
                  f"{c['rel_err_vs_plain']:.2e}", flush=True)
    print(json.dumps({"metric": "gather_probe", "platform": dev.type,
                      "card": card, "gather_rates": rates, "fold": folds}),
          flush=True)
    return 0 if all(r["exact"] for r in rates) and all(
        f["gated"] for f in folds) else 1


if __name__ == "__main__":
    sys.exit(main())

"""Second-call audit (graft-lint engine 2).

The port's counterpart of ``arrow_matrix_tpu/analysis/audit.py``.  The
reference jit-compiles each core SpMM entry point and asserts that the
second same-shape call compiles nothing.  The port has no compile
cache; what a step could redo instead is its executor's one-time build
work.  So the audit builds each entry point on a world of gloo ranks
(``parallel/launch.RankPool``), calls its step twice with same-shape
inputs, and asserts that the second call

* loads no kernel library (``ops/_build.py:load``),
* builds no K1 work list or plan and compiles no route table
  (``utils/buildstats.py`` counts all four),
* leaves no tensor of its own alive once its output is freed (on the
  card, ``torch.cuda.memory_allocated`` back where it was too), and
* launches exactly as many K1-K4 kernels as the first call.

Each entry's output shape and dtype are recorded, so shape/dtype drift
in the step contract also diffs in review.  Results land in this
package's ``analysis/compile_manifest.json``; ``--check`` recomputes
without writing and fails on a violation or on drift of the entries,
their outputs or their verdicts.  Run standalone: ``python -m
arrow_matrix_tpu_torch.analysis audit [--device cpu] [--check]``.
"""

from __future__ import annotations

import gc
import json
import os
import weakref
from typing import Callable, Dict, List

import numpy as np
import torch

DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "compile_manifest.json")

#: The reference's audit scale.
AUDIT_SCALE = {"n": 512, "width": 64, "k": 8, "n_dev": 4}


def _builds() -> Dict[str, int]:
    from arrow_matrix_tpu_torch.utils import buildstats

    return buildstats.snapshot()


def _launches() -> Dict[str, int]:
    from arrow_matrix_tpu_torch.analysis.prove import _launch_counts_now

    return _launch_counts_now()


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def _outputs_probe():
    """A dispatch mode keeping a weak reference to every tensor an op
    allocates while it is active: an output whose storage is none of
    the op's inputs' (in-place results and views allocate nothing)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def storages(obj):
        return {t.untyped_storage().data_ptr()
                for t in tree_flatten(obj)[0]
                if isinstance(t, torch.Tensor)}

    class Outputs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.refs: List[weakref.ref] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            held = storages((args, kwargs))
            for t in tree_flatten(out)[0]:
                if (isinstance(t, torch.Tensor)
                        and t.untyped_storage().data_ptr() not in held):
                    self.refs.append(weakref.ref(t))
            return out

    return Outputs()


def _alive_bytes(refs) -> int:
    """Bytes of the distinct storages still held by ``refs``' tensors."""
    seen, total = set(), 0
    for r in refs:
        t = r()
        if t is None:
            continue
        st = t.untyped_storage()
        key = (st.data_ptr(), st.nbytes())
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _shape_of(out) -> object:
    if isinstance(out, tuple):
        return [_shape_of(o) for o in out]
    return {"shape": list(out.shape),
            "dtype": str(out.dtype).replace("torch.", "")}


def audit_entry(name: str, call: Callable[[], object], device) -> dict:
    """Two same-shape calls of ``call``; the second one's build, launch
    and resident-memory deltas."""
    on_card = torch.device(device).type == "cuda"
    b0, l0 = _builds(), _launches()
    out = call()
    _sync(device)
    b1, l1 = _builds(), _launches()
    rec = {"entry": name, "output": _shape_of(out)}
    del out
    gc.collect()
    mem0 = torch.cuda.memory_allocated(device) if on_card else None
    probe = _outputs_probe()
    with probe:
        out = call()
    _sync(device)
    b2, l2 = _builds(), _launches()
    del out
    gc.collect()
    rec["first_call"] = {"builds": _delta(b1, b0),
                         "launches": _delta(l1, l0)}
    rec["second_call"] = {"builds": _delta(b2, b1),
                          "launches": _delta(l2, l1),
                          "resident_bytes": _alive_bytes(probe.refs),
                          "memory_allocated_delta": (
                              torch.cuda.memory_allocated(device) - mem0
                              if on_card else None)}
    second = rec["second_call"]
    rec["ok"] = (not any(second["builds"].values())
                 and second["resident_bytes"] == 0
                 and not second["memory_allocated_delta"]
                 and second["launches"] == rec["first_call"]["launches"]
                 and (not on_card
                      or sum(rec["first_call"]["launches"].values()) > 0))
    return rec


# ---------------------------------------------------------------------------
# The audited entry points (run in every rank of the pool)
# ---------------------------------------------------------------------------


def _entries(n: int, width: int, k: int, n_dev: int, device):
    """Build each core SpMM entry point at audit scale (the reference's
    four) and yield ``(name, call)`` pairs."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.utils.graphs import (
        barabasi_albert,
        random_csr,
        random_dense,
    )

    a = random_csr(n, n, 4, seed=7).astype(np.float32)
    x_host = random_dense(n, k, seed=3)

    # parallel/spmm_1d.py — PETSc-style 1-D row partition.
    from arrow_matrix_tpu_torch.parallel.spmm_1d import MatrixSlice1D

    d1 = MatrixSlice1D(a, make_mesh((n_dev,), ("slices",), device=device))
    x1 = d1.set_features(x_host)
    yield "spmm_1d.MatrixSlice1D", lambda: d1.spmm(x1)

    # parallel/spmm_15d.py — A-stationary 1.5D partition.
    from arrow_matrix_tpu_torch.parallel.spmm_15d import SpMM15D

    c = 2 if n_dev % 4 == 0 else 1
    d15 = SpMM15D(a, make_mesh((n_dev // c, c), ("rows", "repl"),
                               device=device))
    x15 = d15.set_features(x_host)
    yield "spmm_15d.SpMM15D", lambda: d15.spmm(x15)

    # Arrow decomposition shared by the slim paths.
    ba = barabasi_albert(n, 4, seed=11)
    levels = arrow_decomposition(ba, width, max_levels=3,
                                 block_diagonal=True, seed=1)
    meshb = make_mesh((n_dev,), ("blocks",), device=device)

    # parallel/sell_slim.py — padding-free distributed slim layout.
    from arrow_matrix_tpu_torch.parallel.sell_slim import SellSlim

    ds = SellSlim(levels[0].matrix, width, meshb)
    xs = ds.set_features(random_dense(levels[0].matrix.shape[0], k, seed=5))
    yield "sell_slim.SellSlim", lambda: ds.spmm(xs)

    # parallel/multi_level.py — the full multi-level arrow operator.
    from arrow_matrix_tpu_torch.parallel.multi_level import MultiLevelArrow

    ml = MultiLevelArrow(levels, width, mesh=meshb)
    xm = ml.set_features(x_host[:ba.shape[0]])
    yield "multi_level.MultiLevelArrow", lambda: ml.step(xm)


def audit_rank(ctx, n: int, width: int, k: int) -> List[dict]:
    """Rank job (``parallel/launch.RankPool``): audit every entry on this
    rank."""
    return [audit_entry(name, call, ctx.device)
            for name, call in _entries(n, width, k, ctx.world, ctx.device)]


def merge_ranks(per_rank) -> List[dict]:
    """Rank 0's record an entry, failed when any rank's is, with each
    rank's second-call resident bytes and launches beside it."""
    out = []
    for i, e0 in enumerate(per_rank[0]):
        es = [r[i] for r in per_rank]
        rec = json.loads(json.dumps(e0))
        rec["ok"] = all(e["ok"] for e in es)
        rec["failed_ranks"] = [r for r, e in enumerate(es) if not e["ok"]]
        rec["per_rank_second_call"] = [e["second_call"] for e in es]
        out.append(rec)
    return out


def manifest_digest(manifest: dict) -> dict:
    """The behavior-only view the drift check compares: each entry's
    output shape/dtype and verdict (device-independent)."""
    return {"scale": manifest.get("scale"),
            "entries": {e["entry"]: {"output": e["output"], "ok": e["ok"]}
                        for e in manifest.get("entries", ())},
            "ok": manifest.get("ok")}


def manifest_drift(old: dict, new: dict) -> List[str]:
    a, b = manifest_digest(old), manifest_digest(new)
    problems = []
    if a["scale"] != b["scale"]:
        problems.append(f"scale changed: {a['scale']} -> {b['scale']}")
    for name in sorted(set(a["entries"]) | set(b["entries"])):
        if a["entries"].get(name) != b["entries"].get(name):
            problems.append(f"entry changed: {name}: "
                            f"{a['entries'].get(name)} -> "
                            f"{b['entries'].get(name)}")
    if a["ok"] != b["ok"]:
        problems.append(f"overall ok changed: {a['ok']} -> {b['ok']}")
    return problems


def run_audit(out_path: str = DEFAULT_MANIFEST, n: int = AUDIT_SCALE["n"],
              width: int = AUDIT_SCALE["width"], k: int = AUDIT_SCALE["k"],
              n_dev: int = AUDIT_SCALE["n_dev"], device="cuda",
              write: bool = True, pool=None) -> dict:
    """Audit every core SpMM entry point on ``n_dev`` gloo ranks (on the
    card unless ``device`` is the CPU); return (and write) the
    manifest.  ``pool``: a live ``RankPool`` of ``n_dev`` gloo ranks."""
    import datetime

    from arrow_matrix_tpu_torch.parallel.launch import RankPool

    own = pool is None
    if own:
        pool = RankPool(n_dev, backend="gloo", device=device)
    try:
        per_rank = pool.run(__name__, "audit_rank", n, width, k,
                            job_timeout_s=900.0)
    finally:
        if own:
            pool.close()
    entries = merge_ranks(per_rank)
    manifest = {
        "generated_by": "python -m arrow_matrix_tpu_torch.analysis audit",
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "torch_version": torch.__version__,
        "platform": torch.device(device).type,
        "n_devices": n_dev,
        "scale": {"n": n, "width": width, "k": k},
        "entries": entries,
        "ok": all(e["ok"] for e in entries),
    }
    if write:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return manifest


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="graft_lint_torch audit", description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_MANIFEST)
    ap.add_argument("--devices", type=int, default=AUDIT_SCALE["n_dev"],
                    help="gloo ranks of the audit's world")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the ranks share the card) or cpu")
    ap.add_argument("--n", type=int, default=AUDIT_SCALE["n"])
    ap.add_argument("--width", type=int, default=AUDIT_SCALE["width"])
    ap.add_argument("--k", type=int, default=AUDIT_SCALE["k"])
    ap.add_argument("--check", action="store_true",
                    help="do not write; fail on any violation OR drift "
                         "against the checked-in manifest")
    args = ap.parse_args(argv)

    from arrow_matrix_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    manifest = run_audit(out_path=args.out, n=args.n, width=args.width,
                         k=args.k, n_dev=args.devices, device=device,
                         write=not args.check)
    for e in manifest["entries"]:
        mark = "ok  " if e["ok"] else "FAIL"
        first, second = e["first_call"], e["second_call"]
        print(f"[{mark}] {e['entry']}: call 2 built "
              f"{sum(second['builds'].values())} (call 1: "
              f"{sum(first['builds'].values())}), left "
              f"{second['resident_bytes']} B resident, launched "
              f"{sum(second['launches'].values())} kernel(s) (call 1: "
              f"{sum(first['launches'].values())}); output {e['output']}")
    rc = 0 if manifest["ok"] else 1
    if args.check:
        try:
            with open(args.out, encoding="utf-8") as fh:
                checked_in = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"no readable checked-in manifest at {args.out}: {e}")
            return 1
        drift = manifest_drift(checked_in, manifest)
        for d in drift:
            print(f"drift: {d}")
        rc = rc or (1 if drift else 0)
    else:
        print(f"manifest: {args.out}")
    print("audit passed" if rc == 0 else "AUDIT FAILED")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""Collective-contract prover over counted collectives (graft-prove).

The port's counterpart of ``arrow_matrix_tpu/analysis/prove.py``.  The
JAX prover lowers each mesh executor and reads its collectives out of
HLO text.  The card has no HLO: the port issues every collective
itself, through one counted layer (``parallel/collectives.py``), so the
"program" of an entry here is one step run on a world of gloo ranks
(``parallel/launch.RankPool``) at :data:`PROVE_SCALE`, read from two
sources while it runs:

* what the collective layer counts (``utils/commstats.py``): each
  collective's kind, this rank's wire bytes, and the shape, dtype and
  bytes of the operand this rank handed it (``payload``, the quantity
  XLA's accountant reads off each collective's shape; H2 prices it);
* the aten ops the step dispatches, seen through a ``TorchDispatchMode``
  around the step (the collective layer's own transport copies excluded).

``torch.distributed``'s collective functions are wrapped for the length
of the step, so a collective that bypasses the counted layer (the torch
form of GSPMD's surprise all-gather) is seen too.  The rules keep the
reference's ids and meanings:

* **H1** every counted kind is declared by the contract, and no
  collective bypasses the counted layer;
* **H2** the counted payload bytes fall within the contract's
  ``ratio_band`` of ``step_bytes``;
* **H3** with repl=c every collective operand carries k/(c·S) feature
  columns (the carriage is row-major, so its last dimension), and the
  merge counts exactly ``reduce_comm_bytes``;
* **H4 / H4'** no f64 in any dispatched op and no float widening
  outside :data:`BENIGN_CONVERTS` (a ``_to_copy``/``copy_`` between
  dtypes, or an op whose float output is wider than a float input); a
  bf16/int8 contract declares its carriage->f32 accumulator widening and
  its collective operands must carry the reduced dtype;
* **H5** torch has no donation: over a 2-step ``run`` no carriage
  outlives the step that read it (weak references to each step's
  input), on the entries whose contract donates argument 0;
* **H6** no transpose-then-copy (a copy reading a tensor whose last
  dimension is strided) and at most ``hot_copy_budget``
  ``copy_``/``clone``/``contiguous`` copies inside the step, outside the
  kernels' calls (``ops/kernel_span.py``: a kernel's plain twin orders
  its sums as the kernel does, with copies the kernel does not make);
* **H7** each stage of a staged route counts at most half the scratch
  budget (its send and receive buffers: twice its payload).

On the card the dispatch mode sees the torch ops around the kernels but
not the ctypes launches: H4 and H6 there read the ops around K1-K4,
and the CPU run, where the kernels' plain twins dispatch, is the full
check.  The card run adds one check the CPU cannot make: each rank's
K1/K4 launches in the step equal its executor's ``launch_counts``.

Results land in ``analysis/collective_manifest.json`` of this package;
its digest holds only fields that do not depend on the device, so a
manifest made on the CPU is checked on the card.  Run standalone:
``python -m arrow_matrix_tpu_torch.analysis prove [--device cpu]
[--check]`` or the ``graft_prove_torch`` console script;
``tools/proof_gate.py`` is the nonzero-exit wrapper.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from arrow_matrix_tpu_torch.analysis.contracts import CollectiveContract
from arrow_matrix_tpu_torch.utils import commstats

RULE_IDS = ("H1", "H2", "H3", "H4", "H5", "H6", "H7")

DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "collective_manifest.json")

#: Prove scale, the reference's: the CLI default, the checked-in manifest
#: and the tier-1 drift test share it.
PROVE_SCALE = {"n": 128, "width": 32, "k": 8, "n_dev": 4}

#: Torch dtype name -> the HLO spelling the rules use.
_HLO_NAME = {"float64": "f64", "float32": "f32", "bfloat16": "bf16",
             "float16": "f16", "int8": "s8", "uint8": "u8", "int16": "s16",
             "int32": "s32", "int64": "s64", "bool": "pred"}

_FLOAT_BYTES = {"f16": 2, "bf16": 2, "f32": 4, "f64": 8}

#: Carriage itemsize by contract dtype name, for the H4' operand check.
_CARRIAGE_BYTES = {"s8": 1, "u8": 1, "int8": 1, "uint8": 1,
                   "f16": 2, "bf16": 2, "f32": 4, "f64": 8}

#: (src, dst) converts that are benign on every backend: index widening
#: and mask materialization, not a carried-value upcast.
BENIGN_CONVERTS = frozenset({
    ("pred", "f32"), ("pred", "s32"),
    ("s8", "s32"), ("u8", "s32"), ("s16", "s32"), ("u16", "s32"),
    ("u32", "s32"), ("s32", "u32"),
})

#: Notes the manifest carries about what the card run can see.
MANIFEST_NOTES = (
    "bytes are the payload of each counted collective (the operand a "
    "rank hands it), never the pinned-host staging of gloo ranks on "
    "the card (host_staged_bytes); on the card the dispatch mode sees "
    "the torch ops around the ctypes kernel launches, not the launches, "
    "so H4/H6 there read the ops around K1-K4 and the CPU run, where "
    "the plain twins dispatch, is the full check")


def _hlo(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return _HLO_NAME.get(name, name)


# ---------------------------------------------------------------------------
# Observing one program
# ---------------------------------------------------------------------------

#: ``torch.distributed`` functions wrapped for the length of a proved
#: step, by the collective kind they issue.
_DIST_KINDS = {
    "all_to_all_single": "all-to-all", "all_to_all": "all-to-all",
    "all_gather": "all-gather", "all_gather_into_tensor": "all-gather",
    "all_gather_single": "all-gather", "all_gather_object": "all-gather",
    "all_reduce": "all-reduce", "reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "broadcast": "broadcast", "broadcast_object_list": "broadcast",
    "gather": "gather", "scatter": "gather",
    "send": "collective-permute", "recv": "collective-permute",
    "batch_isend_irecv": "collective-permute",
}
# ``isend``/``irecv`` stay unwrapped: ``P2POp`` checks them by identity,
# and the layer's halo exchange passes them through ``batch_isend_irecv``
# (wrapped).


def _tensors(obj) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _hidden_payload(name: str, args) -> int:
    if name == "batch_isend_irecv":
        return sum(op.tensor.numel() * op.tensor.element_size()
                   for op in (args[0] if args else ())
                   if getattr(op, "op", None) is not None
                   and "send" in getattr(op.op, "__name__", ""))
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if not ts:
        return 0
    t = ts[-1]
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _watch_dist(hidden: list):
    """Wrap ``torch.distributed``'s collectives: a call made outside the
    counted layer is appended to ``hidden``."""
    import torch.distributed as dist

    saved = {}
    for name, kind in _DIST_KINDS.items():
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def wrapped(*args, _fn=fn, _name=name, _kind=kind, **kwargs):
            if not commstats.in_layer():
                hidden.append({"function": f"dist.{_name}", "kind": _kind,
                               "payload": _hidden_payload(_name, args)})
            return _fn(*args, **kwargs)

        saved[name] = fn
        setattr(dist, name, wrapped)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _op_probe_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    from arrow_matrix_tpu_torch.ops.kernel_span import in_kernel

    class OpProbe(TorchDispatchMode):
        """The step's aten ops outside the collective layer: converts
        and f64 everywhere, copies and copies of transposed views
        outside the kernels' calls (``ops/kernel_span.py``)."""

        def __init__(self):
            super().__init__()
            self.converts: List[Tuple[str, str]] = []
            self.f64_ops: List[str] = []
            self.copies = 0
            self.transposed_copies = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not commstats.in_layer():
                self._note(func, args, kwargs, out)
            return out

        def _note(self, func, args, kwargs, out):
            self.ops += 1
            name = func.overloadpacket.__name__
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            if any(t.dtype == torch.float64 for t in ins + outs):
                self.f64_ops.append(name)
            src = dst = None
            if name == "copy_" and len(args) >= 2 \
                    and isinstance(args[1], torch.Tensor):
                src, dst = args[1], args[0]
            elif name in ("_to_copy", "clone") and ins:
                src, dst = ins[0], (outs[0] if outs else None)
            if src is not None and dst is not None:
                if src.dtype != dst.dtype:
                    self.converts.append((_hlo(src.dtype), _hlo(dst.dtype)))
                elif not in_kernel():
                    self.copies += 1
                    if (src.dim() >= 2 and src.size(-1) > 1
                            and src.stride(-1) != 1 and src.numel() > 1):
                        self.transposed_copies += 1
                return
            fin = [_hlo(t.dtype) for t in ins
                   if t.dim() > 0 and t.is_floating_point()]
            for o in outs:
                if not o.is_floating_point():
                    continue
                d = _hlo(o.dtype)
                narrow = [f for f in fin
                          if _FLOAT_BYTES.get(f, 8) < _FLOAT_BYTES.get(d, 0)]
                if narrow:
                    self.converts.append((min(narrow, key=_FLOAT_BYTES.get),
                                          d))

    return OpProbe


def _launch_counts_now() -> Dict[str, int]:
    from arrow_matrix_tpu_torch.ops import cuda_blocks, cuda_gather, cuda_sell

    return {"K1": cuda_sell.LAUNCHES, "K2": cuda_blocks.LAUNCHES_K2,
            "K3": cuda_blocks.LAUNCHES_K3, "K4": cuda_gather.LAUNCHES,
            "K4 add": cuda_gather.LAUNCHES_ADD}


def observe(fn):
    """Run ``fn()`` once with the counts set to 0, the operand log on,
    ``torch.distributed`` watched and the dispatch probe active; return
    ``(fn's result, observation dict)``."""
    hidden: list = []
    probe = _op_probe_class()()
    before = _launch_counts_now()
    commstats.reset()
    commstats.start_log()
    try:
        with _watch_dist(hidden), probe:
            out = fn()
    finally:
        log = commstats.stop_log()
    after = _launch_counts_now()
    stats = commstats.snapshot()
    kinds: Dict[str, dict] = {}
    for rec in log:
        v = kinds.setdefault(rec["kind"], {"count": 0, "bytes": 0, "wire": 0})
        v["count"] += 1
        v["bytes"] += rec["payload"]
        v["wire"] += rec["wire"]
    obs = {
        "kinds": kinds,
        "payload_bytes": (sum(r["payload"] for r in log)
                          + sum(h["payload"] for h in hidden)),
        "wire_bytes": int(stats["total_bytes"]),
        "host_staged_bytes": int(stats["host_staged_bytes"]),
        "operands": [(r["kind"], list(r["shape"]), _hlo(r["dtype"]))
                     for r in log],
        "hidden": hidden,
        "converts": probe.converts,
        "f64_ops": sorted(set(probe.f64_ops)),
        "copies": probe.copies,
        "transposed_copies": probe.transposed_copies,
        "aten_ops": probe.ops,
        "launches": {k: after[k] - before[k] for k in after},
    }
    return out, obs


def run_lifetimes(exe, make_x, method: str, iterations: int = 2) -> dict:
    """H5's evidence: ``exe.run(x, iterations)`` with ``exe.<method>``
    (what ``run`` calls once a step) spied on; returns how many of the
    steps' inputs are still alive once the caller has dropped its own
    and kept only the result."""
    refs: list = []
    orig = getattr(exe, method)

    def spy(x, *args, **kwargs):
        refs.append([weakref.ref(t) for t in _tensors(x)])
        return orig(x, *args, **kwargs)

    setattr(exe, method, spy)
    try:
        x = make_x()
        out = exe.run(x, iterations)
    finally:
        delattr(exe, method)
    del x
    gc.collect()
    keep = {id(t) for t in _tensors(out)}
    live = [i for i, rs in enumerate(refs)
            if any(r() is not None and id(r()) not in keep for r in rs)]
    return {"steps": len(refs), "live_inputs": live}


# ---------------------------------------------------------------------------
# The rules.  Each returns {"status": "pass"|"fail"|"skip", "detail": str};
# pure functions over observations, so the fixture tests, the gate and
# the doctor share them.
# ---------------------------------------------------------------------------


def _res(status: str, detail: str) -> dict:
    return {"status": status, "detail": detail}


def check_h1(obs: dict, contract: CollectiveContract) -> dict:
    """No unattributed collectives: every counted kind is declared, and
    nothing bypassed the counted layer."""
    present = frozenset(k for k, v in obs["kinds"].items() if v["count"])
    allowed = frozenset(contract.lowered_kinds) & frozenset(
        contract.compiled_kinds)
    bad = []
    extra = present - allowed
    if extra:
        bad.append(f"the step counts undeclared {sorted(extra)} "
                   f"(declared: {sorted(allowed)})")
    if obs["hidden"]:
        calls = sorted({h["function"] for h in obs["hidden"]})
        bad.append(f"{len(obs['hidden'])} collective(s) bypassed the "
                   f"counted layer: {calls}")
    if bad:
        return _res("fail", "; ".join(bad))
    return _res("pass", f"counted={sorted(present)} all declared, none "
                        f"hidden")


def check_h2(measured_bytes: int, source: str,
             contract: CollectiveContract) -> dict:
    """Collective bytes match the contract's ideal within tolerance."""
    if contract.step_bytes == 0:
        if measured_bytes == 0:
            return _res("pass", "zero-comm contract, zero measured")
        return _res("fail",
                    f"contract promises zero communication but the "
                    f"{source} step carries {measured_bytes} collective "
                    f"bytes")
    ratio = measured_bytes / contract.step_bytes
    lo, hi = contract.ratio_band
    if lo <= ratio <= hi:
        return _res("pass",
                    f"{measured_bytes} B ({source}) / ideal "
                    f"{contract.step_bytes} B = {ratio:.3f} in "
                    f"[{lo}, {hi}]")
    return _res("fail",
                f"{measured_bytes} B ({source}) / ideal "
                f"{contract.step_bytes} B = {ratio:.3f} outside "
                f"[{lo}, {hi}]")


def check_host_bytes(contract: CollectiveContract, num_hosts: int,
                     num_devices: int, measured_bytes: int,
                     pattern: str = "ring",
                     band: Optional[Tuple[float, float]] = None) -> dict:
    """H2 across hosts: the measured bytes that cross a host boundary
    match the contract's inter-host slice
    (``CollectiveContract.inter_host_bytes``) within ``band`` (default
    the contract's own ``ratio_band``).  Not in :data:`RULE_IDS`: H1-H7
    hold at the manifest's one fixed scale, while the inter-host slice
    depends on how the deployment splits its ranks over hosts, which
    only the fleet and host gates know."""
    ideal = contract.inter_host_bytes(num_hosts, num_devices,
                                      pattern=pattern)
    if ideal == 0:
        if measured_bytes == 0:
            return _res("pass",
                        f"hosts={num_hosts}: no inter-host slice "
                        f"promised, none measured")
        return _res("fail",
                    f"hosts={num_hosts} promises zero inter-host "
                    f"bytes but {measured_bytes} B crossed a domain "
                    f"boundary")
    lo, hi = band if band is not None else contract.ratio_band
    ratio = measured_bytes / ideal
    detail = (f"{measured_bytes} B inter-host / ideal {ideal} B "
              f"({pattern}, hosts={num_hosts}, devices={num_devices})"
              f" = {ratio:.3f} vs [{lo}, {hi}]")
    return _res("pass" if lo <= ratio <= hi else "fail", detail)


def check_h3(obs: dict, contract: CollectiveContract, k: int,
             merge_bytes: Optional[int] = None) -> dict:
    """The ÷c law: repl=c exchanges carry k/(c·S) feature columns, and
    the merge counts exactly ``reduce_comm_bytes``."""
    if contract.h3_exempt:
        return _res("skip", contract.h3_exempt)
    if contract.repl <= 1:
        if contract.reduce_bytes != 0:
            return _res("fail",
                        f"repl=1 contract declares nonzero merge bytes "
                        f"({contract.reduce_bytes})")
        return _res("pass", "repl=1: no replica merge priced")
    slab = contract.expected_slab(k)
    cols = [shape[-1] for _, shape, _ in obs["operands"] if len(shape) >= 2]
    cols += [-1 for h in obs["hidden"]]
    bad = [c for c in cols if c != slab]
    if bad:
        return _res("fail",
                    f"repl={contract.repl} S={contract.overlap_slabs} "
                    f"expects every collective to carry {slab} feature "
                    f"columns, found {bad} (-1: a collective outside "
                    f"the counted layer)")
    if merge_bytes is not None and merge_bytes != contract.reduce_bytes:
        return _res("fail",
                    f"replica merge carries {merge_bytes} B but the "
                    f"contract prices exactly {contract.reduce_bytes} B")
    return _res("pass",
                f"all collectives carry the k/(c*S)={slab} slab; merge "
                f"prices {contract.reduce_bytes} B"
                + (" (verified)" if merge_bytes is not None else ""))


def check_h4(obs: dict, contract: CollectiveContract) -> dict:
    """No silent dtype upcasts in the step (H4), relaxed per class into
    H4' for a reduced-precision contract: its carriage->f32 accumulator
    widening is declared, and every collective operand carries a dtype
    no wider than the carriage."""
    carriage = contract.dtype
    approx = carriage in _CARRIAGE_BYTES and _CARRIAGE_BYTES[carriage] < 4
    carriage_hlo = {"int8": "s8", "uint8": "u8"}.get(carriage, carriage)
    bad = []
    if obs["f64_ops"] and carriage != "f64":
        bad.append(f"f64 tensors in a {carriage}-carriage step "
                   f"({', '.join(obs['f64_ops'])})")
    for src, dst in obs["converts"]:
        if approx and src == carriage_hlo and dst == "f32":
            continue   # H4': the declared accumulator widening
        if (src in _FLOAT_BYTES and dst in _FLOAT_BYTES
                and _FLOAT_BYTES[dst] > _FLOAT_BYTES[src]
                and (src, dst) not in BENIGN_CONVERTS):
            bad.append(f"float-widening convert {src}->{dst}")
    dtypes = [dt for _, _, dt in obs["operands"]]
    if approx:
        limit = _CARRIAGE_BYTES[carriage]
        wide = sorted({dt for dt in dtypes
                       if _CARRIAGE_BYTES.get(dt, 0) > limit})
        if wide:
            bad.append(f"{carriage}-class collectives carry "
                       f"full-precision operands {wide} — the approx "
                       f"byte band was never earned")
    if bad:
        return _res("fail", "; ".join(sorted(set(bad))))
    if approx:
        n_acc = sum(1 for src, dst in obs["converts"]
                    if src == carriage_hlo and dst == "f32")
        kinds = sorted(set(dtypes)) or ["none"]
        return _res("pass",
                    f"H4'({carriage}): collective operands {kinds}, "
                    f"{n_acc} declared accumulator widening(s), no "
                    f"other upcasts")
    return _res("pass",
                f"no f64, no widening converts "
                f"({len(obs['converts'])} benign convert(s))")


def check_h5(lifetimes: Optional[dict],
             contract: CollectiveContract) -> dict:
    """No carriage outlives the step that read it (torch's form of
    "donated inputs are aliased")."""
    if not contract.donated_params:
        return _res("skip", "no donated entry point shipped")
    if lifetimes is None:
        return _res("fail", "contract declares donated params but no "
                            "run was provided to the prover")
    if lifetimes["steps"] < 2:
        return _res("fail", f"run made {lifetimes['steps']} step(s); the "
                            f"check needs 2")
    if lifetimes["live_inputs"]:
        return _res("fail",
                    f"run keeps the input of step(s) "
                    f"{lifetimes['live_inputs']} alive after the next "
                    f"step has read it — every step's carriage is "
                    f"resident at once")
    return _res("pass", f"{lifetimes['steps']} steps, no input outlives "
                        f"the step that read it")


def check_h6(obs: dict, contract: CollectiveContract) -> dict:
    """No layout-thrash copies in the step."""
    if obs["transposed_copies"]:
        return _res("fail",
                    f"{obs['transposed_copies']} copy(ies) of a transposed "
                    f"view in the step — layout thrash every iteration")
    if obs["copies"] > contract.hot_copy_budget:
        return _res("fail",
                    f"{obs['copies']} copy op(s) in the step exceed the "
                    f"budget of {contract.hot_copy_budget}")
    return _res("pass",
                f"step: {obs['copies']} copy(s) (budget "
                f"{contract.hot_copy_budget}), no transposed copies")


def check_h7(stage_payloads: Optional[Sequence[int]],
             contract: CollectiveContract) -> dict:
    """graft-reshard's bounded-scratch law: every stage of a staged
    exchange keeps its send+recv buffers (twice its counted payload)
    within the declared scratch budget."""
    if contract.scratch_budget_bytes <= 0:
        return _res("skip", "no staged scratch budget declared")
    if not stage_payloads:
        return _res("fail",
                    "contract declares a scratch budget of "
                    f"{contract.scratch_budget_bytes} B but no stage "
                    f"programs were provided to the prover")
    budget = contract.scratch_budget_bytes
    over = []
    peak = 0
    for i, payload in enumerate(stage_payloads):
        scratch = 2 * int(payload)
        peak = max(peak, scratch)
        if scratch > budget:
            over.append(f"stage {i} carries {scratch} B send+recv "
                        f"> budget {budget} B")
    if over:
        return _res("fail", "; ".join(over))
    return _res("pass",
                f"{len(stage_payloads)} stage(s), peak per-rank "
                f"send+recv {peak} B <= budget {budget} B")


def judge(contract: CollectiveContract, obs: dict, k: int,
          merge_bytes: Optional[int] = None,
          lifetimes: Optional[dict] = None,
          stage_payloads: Optional[Sequence[int]] = None) -> dict:
    """H1-H7 over one observed entry."""
    return {
        "H1": check_h1(obs, contract),
        "H2": check_h2(obs["payload_bytes"], "counted", contract),
        "H3": check_h3(obs, contract, k, merge_bytes=merge_bytes),
        "H4": check_h4(obs, contract),
        "H5": check_h5(lifetimes, contract),
        "H6": check_h6(obs, contract),
        "H7": check_h7(stage_payloads, contract),
    }


# ---------------------------------------------------------------------------
# Fixture verification (shared by tests, proof_gate --selftest, doctor)
# ---------------------------------------------------------------------------


def fixture_contract() -> CollectiveContract:
    """The contract the inline fixtures are judged against (the
    reference's): a SELL-style repl=2 step at k=8 (4-column slabs),
    one all-to-all of 128 x 4 f32 rows (2048 B) and one all-reduce of
    64 x 4 (1024 B), merge priced at 2048 B."""
    return CollectiveContract(
        algorithm="fixture_sell_repl2",
        step_bytes=3072, reduce_bytes=2048, repl=2, overlap_slabs=1,
        dtype="f32",
        lowered_kinds=("all-to-all", "all-reduce"),
        compiled_kinds=("all-to-all", "all-reduce"),
        ratio_band=(0.5, 2.0),
        notes="pinned contract for the H1-H3 fixture tests")


def fixture_observation(operands, hidden=()) -> dict:
    """An observation made of ``operands`` ``[(kind, shape, dtype)]``
    (f32 bytes) and ``hidden`` calls, nothing else dispatched."""
    kinds: Dict[str, dict] = {}
    total = 0
    for kind, shape, dt in operands:
        nbytes = int(np.prod(shape)) * _CARRIAGE_BYTES.get(dt, 4)
        v = kinds.setdefault(kind, {"count": 0, "bytes": 0, "wire": 0})
        v["count"] += 1
        v["bytes"] += nbytes
        total += nbytes
    total += sum(h["payload"] for h in hidden)
    return {"kinds": kinds, "payload_bytes": total, "wire_bytes": total,
            "host_staged_bytes": 0,
            "operands": [(k, list(s), d) for k, s, d in operands],
            "hidden": list(hidden), "converts": [], "f64_ops": [],
            "copies": 0, "transposed_copies": 0, "aten_ops": 0,
            "launches": {}}


_SELFTEST_GOOD = [("all-to-all", (128, 4), "f32"),
                  ("all-reduce", (64, 4), "f32")]
_SELFTEST_BROKEN = _SELFTEST_GOOD + [("all-gather", (256, 8), "f32")]


def verify_fixture(operands, contract: Optional[CollectiveContract] = None,
                   k: int = 8, merge_bytes: int = 2048,
                   hidden=()) -> dict:
    """H1-H3 on one fixture observation; ``{"H1", "H2", "H3", "ok"}``."""
    contract = contract or fixture_contract()
    obs = fixture_observation(operands, hidden)
    results = {
        "H1": check_h1(obs, contract),
        "H2": check_h2(obs["payload_bytes"], "fixture", contract),
        "H3": check_h3(obs, contract, k, merge_bytes=merge_bytes),
    }
    results["ok"] = all(r["status"] == "pass" for r in results.values()
                        if isinstance(r, dict))
    return results


@contextlib.contextmanager
def _one_rank_group():
    """A world of one gloo rank in this process for the live selftest
    (the current group when one is up)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="amt_prove_")
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def live_hidden_collective() -> dict:
    """The planted violation of H1 on a live group: a step that calls
    ``dist.all_gather`` directly, past the counted layer; returns the
    H1 verdict."""
    import torch.distributed as dist

    def broken():
        x = torch.ones(4, 2)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        return parts

    with _one_rank_group():
        _, obs = observe(broken)
    contract = CollectiveContract(
        algorithm="selftest", step_bytes=0, reduce_bytes=0, repl=1,
        overlap_slabs=1, dtype="f32", lowered_kinds=(), compiled_kinds=(),
        ratio_band=(0.25, 4.0))
    return check_h1(obs, contract)


def selftest() -> bool:
    """The gate must pass a conforming program and trip on a planted
    surprise all-gather (wrong kind, wrong bytes, wrong slab), and on a
    live ``dist.all_gather`` that bypasses the counted layer."""
    good = verify_fixture(_SELFTEST_GOOD)
    broken = verify_fixture(_SELFTEST_BROKEN)
    fixtures = bool(good["ok"]) and not broken["ok"] and all(
        broken[r]["status"] == "fail" for r in ("H1", "H2", "H3"))
    return fixtures and live_hidden_collective()["status"] == "fail"


# ---------------------------------------------------------------------------
# The proved entry points (run in every rank of the pool)
# ---------------------------------------------------------------------------


def _entries(n: int, width: int, k: int, n_dev: int, device):
    """Build every contracted executor over the (c, S) grid at prove
    scale, as the reference does; yield ``(name, contract, programs)``
    where programs holds zero-argument callables:

    * ``step``: one step (run once to warm, then observed);
    * ``run``: ``(executor, make_x, method)`` for H5's 2-step run;
    * ``merge``: the 2.5D merge, when repl > 1;
    * ``stages``: a staged route's sub-exchanges (H7);
    * ``launch_counts``: the executor's K1-K4 launches of one step.

    Unsupported grid cells are yielded as ``(name, None, reason)``."""
    from arrow_matrix_tpu_torch.decomposition import arrow_decomposition
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh, make_repl_mesh
    from arrow_matrix_tpu_torch.utils.graphs import (
        barabasi_albert,
        random_csr,
        random_dense,
    )

    a = random_csr(n, n, 4, seed=7).astype(np.float32)
    x_host = random_dense(n, k, seed=3)
    ba = barabasi_albert(n, 4, seed=11)
    levels = arrow_decomposition(ba, width, max_levels=3,
                                 block_diagonal=True, seed=1)

    def counts(exe):
        return lambda: exe.launch_counts(k)

    # -- spmm_1d (petsc-style 1-D): no replication/overlap modes -------
    from arrow_matrix_tpu_torch.parallel.spmm_1d import MatrixSlice1D

    d1 = MatrixSlice1D(a, make_mesh((n_dev,), ("slices",), device=device))
    x1 = d1.set_features(x_host)
    yield ("spmm_1d[c=1,S=1]", d1.collective_contract(k), {
        "step": lambda: d1.spmm(x1), "launch_counts": counts(d1)})
    yield ("spmm_1d[c=2]", None,
           "MatrixSlice1D has no replication mode (the 1.5D/SELL "
           "executors carry the 2.5D scheme)")

    # -- spmm_15d (A-stationary 1.5D): c via the mesh repl axis --------
    from arrow_matrix_tpu_torch.parallel.spmm_15d import SpMM15D

    for c in (1, 2):
        d15 = SpMM15D(a, make_mesh((n_dev // c, c), ("rows", "repl"),
                                   device=device))
        x15 = d15.set_features(x_host)
        yield (f"spmm_15d[c={c},S=1]", d15.collective_contract(k), {
            "step": (lambda d, x: lambda: d.spmm(x))(d15, x15),
            "launch_counts": counts(d15)})
    yield ("spmm_15d[S=2]", None,
           "SpMM15D has no overlap schedule (its round loop already "
           "pipelines the broadcast)")

    # -- sell_slim / sell_multi over the full (c, S) grid --------------
    from arrow_matrix_tpu_torch.parallel.sell_slim import (
        SellMultiLevel,
        SellSlim,
    )

    for c in (1, 2):
        if c == 1:
            mesh = make_mesh((n_dev,), ("blocks",), device=device)
            repl_axis = None
        else:
            mesh = make_repl_mesh(n_dev, c, device=device)
            repl_axis = "repl"
        for s in (1, 2):
            ds = SellSlim(levels[0].matrix, width, mesh, overlap_slabs=s,
                          repl_axis=repl_axis)
            xs = ds.set_features(
                random_dense(levels[0].matrix.shape[0], k, seed=5))
            progs = {"step": (lambda d, x: lambda: d.step(x))(ds, xs),
                     "launch_counts": counts(ds)}
            if c > 1:
                progs["merge"] = (lambda d, x: lambda y: d.merge_carries(y)
                                  )(ds, xs)
            yield (f"sell_slim[c={c},S={s}]", ds.collective_contract(k),
                   progs)

            ml = SellMultiLevel(levels, width, mesh, routing="a2a",
                                overlap_slabs=s, repl_axis=repl_axis)
            xm_host = random_dense(ml.n, k, seed=5)
            xm = ml.set_features(xm_host)
            progs = {
                "step": (lambda d, x: lambda: d.step(x))(ml, xm),
                "run": (ml, (lambda d, h: lambda: d.set_features(h))(
                    ml, xm_host), "step"),
                "launch_counts": counts(ml),
            }
            if c > 1:
                progs["merge"] = (lambda d: lambda y: d.merge_carries(y)
                                  )(ml)
            yield (f"sell_multi[c={c},S={s}]", ml.collective_contract(k),
                   progs)

    # -- multi_level: a2a mesh (c=1) and single-device fold (c via repl)
    from arrow_matrix_tpu_torch.parallel.multi_level import MultiLevelArrow

    meshb = make_mesh((n_dev,), ("blocks",), device=device)
    xa_host = x_host[:ba.shape[0]]
    for s in (1, 2):
        ma = MultiLevelArrow(levels, width, mesh=meshb, routing="a2a",
                             overlap_slabs=s)
        xa = ma.set_features(xa_host)
        yield (f"multi_level_a2a[c=1,S={s}]", ma.collective_contract(k), {
            "step": (lambda d, x: lambda: d.step(x))(ma, xa),
            "run": (ma, (lambda d: lambda: d.set_features(xa_host))(ma),
                    "_step_fn"),
            "launch_counts": counts(ma),
        })
    yield ("multi_level_a2a[c=2]", None,
           "MultiLevelArrow repl>1 requires fmt='fold' (mesh "
           "replication is the SellSlim/SellMultiLevel repl_axis mode)")

    def fold_entry(mf):
        xf = mf.set_features(xa_host)
        return {"step": lambda: mf.step(xf),
                "run": (mf, lambda: mf.set_features(xa_host), "_step_fn")}

    for c in (1, 2):
        mf = MultiLevelArrow(levels, width, fmt="fold", repl=c,
                             device=device)
        yield (f"multi_level_fold[c={c},S=1]", mf.collective_contract(k),
               fold_entry(mf))

    # -- graft-classes approx carriage (H4') ---------------------------
    smb = SellMultiLevel(levels, width,
                         make_mesh((n_dev,), ("blocks",), device=device),
                         routing="a2a", feature_dtype="bf16")
    xsb_host = random_dense(smb.n, k, seed=5)
    xsb = smb.set_features(xsb_host)
    yield ("sell_multi[c=1,S=1,bf16]", smb.collective_contract(k), {
        "step": lambda: smb.step(xsb),
        "run": (smb, lambda: smb.set_features(xsb_host), "step"),
        "launch_counts": counts(smb),
    })
    yield ("multi_level_a2a[c=1,S=1,bf16]", None,
           "MultiLevelArrow carries feature_dtype on fmt='fold' only; "
           "the mesh approx carriage is SellMultiLevel's "
           "(feature-major, the executor graft-tune promotes)")

    mfi = MultiLevelArrow(levels, width, fmt="fold", feature_dtype="int8",
                          device=device)
    yield ("multi_level_fold[c=1,S=1,int8]", mfi.collective_contract(k),
           fold_entry(mfi))

    # -- graft-synth generated program: the fold over the schedule the
    # degree ladder synthesizes, through K1's launch groups.
    from arrow_matrix_tpu_torch.tune.fingerprint import structure_fingerprint
    from arrow_matrix_tpu_torch.tune.synth import synthesize_schedule

    sched = synthesize_schedule(
        structure_fingerprint(levels, width, np.float32))
    if sched:
        mfs = MultiLevelArrow(levels, width, fmt="fold",
                              kernel="pallas_sell",
                              kernel_opts={"schedule": sched},
                              device=device)
        yield ("multi_level_fold[c=1,S=1,synth]",
               mfs.collective_contract(k), fold_entry(mfs))
    else:
        yield ("multi_level_fold[c=1,S=1,synth]", None,
               "the prove-scale structure synthesized an empty "
               "schedule (no non-zero ladder tiers)")

    # -- graft-reshard staged redistribution (H7) ----------------------
    yield from _reshard_entries(n, k, n_dev, x_host, device)


#: The reference's staged-redistribution budget at prove scale.
RESHARD_BUDGET = 2048


def _reshard_entries(n: int, k: int, n_dev: int, x_host: np.ndarray,
                     device):
    """The two (src, dst) layout pairs of the reference, one with a
    repl c change: the one-shot route is the entry's step (H1/H2 price
    its exchange), the staged sub-routes are the stages H7 audits."""
    from arrow_matrix_tpu_torch.parallel import routing as routing_mod
    from arrow_matrix_tpu_torch.parallel.mesh import make_mesh
    from arrow_matrix_tpu_torch.parallel.reshard import (
        Layout,
        plan_route_table,
        redistribution_plan,
    )

    rng = np.random.default_rng(13)
    pairs = [
        ("reshard[shuffle,d4]",
         Layout(n, n_dev=n_dev, tag="prove_src"),
         Layout(n, n_dev=n_dev, tag="prove_dst"),
         rng.permutation(n).astype(np.int64)),
        ("reshard[repl1to2,d4]",
         Layout(n, n_dev=n_dev, repl=1, tag="prove_src"),
         Layout(n, n_dev=n_dev, repl=2, tag="prove_dst"),
         None),
    ]
    mesh = make_mesh((n_dev,), ("blocks",), device=device)
    d = mesh.axis_index("blocks")
    for rname, src_lay, dst_lay, perm in pairs:
        plan = redistribution_plan(src_lay, dst_lay, RESHARD_BUDGET, k=k,
                                   perm_map=perm)
        tbl, mask = plan_route_table(plan)
        # One route per proved pair, at build time.
        route = routing_mod.build_route(  # graft-lint: disable=R2
            tbl, n_dev, src_total=src_lay.stored_rows, pad_mask=mask)
        sroute = routing_mod.split_route_stages(route, k, RESHARD_BUDGET)
        rows = src_lay.stored_rows // n_dev
        x = torch.from_numpy(np.ascontiguousarray(
            x_host.astype(np.float32)[d * rows:(d + 1) * rows])).to(
            mesh.device)
        contract = CollectiveContract(
            algorithm=rname,
            step_bytes=route.device_bytes_per_exchange(k, 4),
            reduce_bytes=0, repl=1, overlap_slabs=1, dtype="f32",
            lowered_kinds=("all-to-all",),
            compiled_kinds=("all-to-all",),
            ratio_band=(0.99, 1.01),
            scratch_budget_bytes=RESHARD_BUDGET,
            h3_exempt="redistribution carries full-k rows, not "
                      "replica slabs",
            notes=f"staged (src={src_lay.total_rows}x{src_lay.repl}"
                  f"c -> dst={dst_lay.total_rows}x{dst_lay.repl}c on "
                  f"{n_dev} devices): plan {plan.n_stages} host "
                  f"stage(s), route {sroute.n_stages} device "
                  f"stage(s)")

        def take(rt, _x=x):
            r = routing_mod.shard_route(rt, mesh, "blocks")
            return lambda: routing_mod.routed_take(_x, r, mesh, "blocks")

        yield (rname, contract, {
            "step": take(route),
            "stages": [take(st) for st in sroute.stages],
        })


def prove_entry(name: str, contract: CollectiveContract, programs: dict,
                k: int, on_card: bool) -> dict:
    """Observe one entry's programs on this rank and run H1-H7."""
    programs["step"]()                      # warm: plans, first builds
    out, obs = observe(programs["step"])
    merge_bytes = None
    if "merge" in programs:
        _, m_obs = observe(lambda: programs["merge"](out))
        merge_bytes = m_obs["payload_bytes"]
    lifetimes = None
    if "run" in programs:
        exe, make_x, method = programs["run"]
        lifetimes = run_lifetimes(exe, make_x, method)
    stage_payloads = None
    if "stages" in programs:
        stage_payloads = [observe(st)[1]["payload_bytes"]
                          for st in programs["stages"]]
    del out
    rules = judge(contract, obs, k, merge_bytes=merge_bytes,
                  lifetimes=lifetimes, stage_payloads=stage_payloads)
    launches = {"measured": {kd: v for kd, v in obs["launches"].items()
                             if v}, "expected": None, "status": "skip"}
    if on_card and "launch_counts" in programs:
        want = {kd: v for kd, v in programs["launch_counts"]().items()
                if v}
        launches["expected"] = want
        launches["status"] = ("pass" if launches["measured"] == want
                              else "fail")
    return {
        "entry": name,
        "contract": contract.to_json(),
        "measured": {
            "auto_bytes": obs["payload_bytes"],
            "source": "counted",
            "wire_bytes": obs["wire_bytes"],
            "host_staged_bytes": obs["host_staged_bytes"],
            "kinds": obs["kinds"],
            "hidden": obs["hidden"],
            "merge_bytes": merge_bytes,
            "step_copies": obs["copies"],
            "step_transposed_copies": obs["transposed_copies"],
            "converts": sorted({f"{a}->{b}" for a, b in obs["converts"]}),
            "lifetimes": lifetimes,
            "stage_scratch_bytes": (
                [2 * p for p in stage_payloads]
                if stage_payloads is not None else None),
        },
        "launches": launches,
        "rules": rules,
        "ok": (all(r["status"] in ("pass", "skip") for r in rules.values())
               and launches["status"] != "fail"),
    }


def prove_rank(ctx, n: int, width: int, k: int) -> dict:
    """Rank job (``parallel/launch.RankPool``): prove every entry on this
    rank; ``{"entries": [...], "skipped": [...]}``."""
    entries, skipped = [], []
    on_card = ctx.device.type == "cuda"
    for name, contract, programs in _entries(n, width, k, ctx.world,
                                             ctx.device):
        if contract is None:
            skipped.append({"entry": name, "reason": programs})
            continue
        entries.append(prove_entry(name, contract, programs, k, on_card))
    return {"entries": entries, "skipped": skipped}


def merge_ranks(per_rank: Sequence[dict]) -> Tuple[list, list]:
    """One record an entry from every rank's: rank 0's numbers, each
    rule failed when it fails on any rank (the first such rank's
    detail), each rank's bytes beside them."""
    entries = []
    for i, e0 in enumerate(per_rank[0]["entries"]):
        es = [r["entries"][i] for r in per_rank]
        rec = json.loads(json.dumps(e0))
        for rule in RULE_IDS:
            for r, e in enumerate(es):
                if e["rules"][rule]["status"] == "fail":
                    rec["rules"][rule] = _res(
                        "fail", f"rank {r}: {e['rules'][rule]['detail']}")
                    break
        for r, e in enumerate(es):
            if e["launches"]["status"] == "fail":
                rec["launches"] = dict(e["launches"], rank=r)
                break
        rec["measured"]["per_rank_auto_bytes"] = [
            e["measured"]["auto_bytes"] for e in es]
        rec["measured"]["per_rank_wire_bytes"] = [
            e["measured"]["wire_bytes"] for e in es]
        rec["ok"] = all(e["ok"] for e in es)
        entries.append(rec)
    return entries, per_rank[0]["skipped"]


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

def manifest_digest(manifest: dict) -> dict:
    """The behavior-only view of a manifest the drift gate compares:
    entry names, per-rule statuses, counted payload bytes and merge
    bytes, and the skip ledger — nothing that depends on the device."""
    return {
        "scale": manifest.get("scale"),
        "entries": {
            e["entry"]: {
                "ok": e["ok"],
                "rules": {r: v["status"] for r, v in e["rules"].items()},
                "auto_bytes": e["measured"]["auto_bytes"],
                "merge_bytes": e["measured"]["merge_bytes"],
            }
            for e in manifest.get("entries", ())
        },
        "skipped": {s["entry"]: s["reason"]
                    for s in manifest.get("skipped", ())},
        "ok": manifest.get("ok"),
    }


def manifest_drift(old: dict, new: dict) -> List[str]:
    """Human-readable differences between two manifests' digests
    (empty = no drift)."""
    a, b = manifest_digest(old), manifest_digest(new)
    problems: List[str] = []
    if a["scale"] != b["scale"]:
        problems.append(f"scale changed: {a['scale']} -> {b['scale']}")
    for name in sorted(set(a["entries"]) | set(b["entries"])):
        if name not in b["entries"]:
            problems.append(f"entry disappeared: {name}")
        elif name not in a["entries"]:
            problems.append(f"new unrecorded entry: {name}")
        elif a["entries"][name] != b["entries"][name]:
            problems.append(
                f"entry changed: {name}: {a['entries'][name]} -> "
                f"{b['entries'][name]}")
    for name in sorted(set(a["skipped"]) | set(b["skipped"])):
        if a["skipped"].get(name) != b["skipped"].get(name):
            problems.append(f"skip ledger changed for {name}")
    if a["ok"] != b["ok"]:
        problems.append(f"overall ok changed: {a['ok']} -> {b['ok']}")
    return problems


def run_prove(out_path: str = DEFAULT_MANIFEST,
              n: int = PROVE_SCALE["n"], width: int = PROVE_SCALE["width"],
              k: int = PROVE_SCALE["k"], n_dev: int = PROVE_SCALE["n_dev"],
              device="cuda", write: bool = True, pool=None) -> dict:
    """Prove every contracted entry point on ``n_dev`` gloo ranks (on
    the card unless ``device`` is the CPU; the ranks share it); return
    (and write) the manifest.  ``pool``: a live ``RankPool`` of
    ``n_dev`` gloo ranks to reuse."""
    import datetime

    from arrow_matrix_tpu_torch.parallel.launch import RankPool

    own = pool is None
    if own:
        pool = RankPool(n_dev, backend="gloo", device=device)
    try:
        per_rank = pool.run(__name__, "prove_rank", n, width, k,
                            job_timeout_s=900.0)
    finally:
        if own:
            pool.close()
    entries, skipped = merge_ranks(per_rank)
    manifest = {
        "generated_by": "python -m arrow_matrix_tpu_torch.analysis prove",
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "torch_version": torch.__version__,
        "platform": torch.device(device).type,
        "n_devices": n_dev,
        "scale": {"n": n, "width": width, "k": k},
        "notes": MANIFEST_NOTES,
        "entries": entries,
        "skipped": skipped,
        "ok": all(e["ok"] for e in entries),
    }
    if write:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return manifest


def _format_entry(e: dict) -> str:
    mark = "ok  " if e["ok"] else "FAIL"
    verdicts = " ".join(
        f"{r}:{e['rules'][r]['status']}" for r in RULE_IDS)
    line = (f"[{mark}] {e['entry']}: {e['measured']['auto_bytes']} B "
            f"({e['measured']['source']}) vs ideal "
            f"{e['contract']['step_bytes']} B | {verdicts}")
    if e["launches"]["status"] != "skip":
        line += f" | launches:{e['launches']['status']}"
    for r in RULE_IDS:
        if e["rules"][r]["status"] == "fail":
            line += f"\n       {r}: {e['rules'][r]['detail']}"
    if e["launches"]["status"] == "fail":
        line += (f"\n       launches: {e['launches']['measured']} != "
                 f"launch_counts {e['launches']['expected']}")
    return line


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="graft_prove_torch", description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_MANIFEST)
    ap.add_argument("--devices", type=int, default=PROVE_SCALE["n_dev"],
                    help="gloo ranks of the proving world")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the ranks share the card) or cpu")
    ap.add_argument("--n", type=int, default=PROVE_SCALE["n"])
    ap.add_argument("--width", type=int, default=PROVE_SCALE["width"])
    ap.add_argument("--k", type=int, default=PROVE_SCALE["k"])
    ap.add_argument("--check", action="store_true",
                    help="do not write; fail on any violation OR drift "
                         "against the checked-in manifest")
    args = ap.parse_args(argv)

    from arrow_matrix_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    manifest = run_prove(out_path=args.out, n=args.n, width=args.width,
                         k=args.k, n_dev=args.devices, device=device,
                         write=not args.check)
    for e in manifest["entries"]:
        print(_format_entry(e))
    for s in manifest["skipped"]:
        print(f"[skip] {s['entry']}: {s['reason']}")

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
        if drift:
            print(f"proof drift against {args.out} — rerun "
                  f"`python -m arrow_matrix_tpu_torch.analysis prove "
                  f"--device cpu` and commit the refreshed manifest")
            rc = 1
    else:
        print(f"manifest: {args.out}")
    print("proof passed" if rc == 0 else "PROOF FAILED")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

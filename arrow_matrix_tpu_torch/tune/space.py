"""The discrete plan space and its pruning.

The port's copy of ``arrow_matrix_tpu/tune/space.py``.  The candidates
for one (structure, k) are the structural variants of the fold (the
reference's names and prune reasons: ``default``, ``fold_tight``,
``fold_coarse``, ``ell_one_tier``, ``hyb``, ``overlap2``, ``repl2``,
``bf16``, ``int8``) and, in place of the reference's
``pallas_sell_*`` VMEM/DMA-ring candidates, K1's launch-knob candidates
(``kernel="pallas_sell"`` with ``kernel_opts``; ``ops/worklist.py``).

Pruning happens before any child spawns:

* the HBM certificate (``obs/memview.largest_fitting_repl`` over the
  fingerprint's byte model) rejects replication that cannot fit;
* divisibility (``c | k``, ``S | k/c``), the predicate
  ``serve/scheduler.ExecConfig.accepts_k`` applies at admission;
* the ``repl_predict_ms`` cost screen (3x the default's model);
* the k gate, read from K1's contract (``KernelContract.supports_k``);
* certification: every K1 candidate's launches on this structure's tier
  ladder prove out under KC1-KC5 (``analysis/kernels.
  certify_candidate_opts``), else it is pruned with a ``"kcert: ..."``
  reason;
* the lens screen: with a fitted cost model, a candidate predicted at
  more than 3x the default is pruned with a ``"lens: ..."`` reason.

``chunk_4096`` is pruned on the port: K1 builds no gather intermediate,
so the gather chunk has no meaning on the port's fold.

Eligibility is per traffic class: in the exact class a candidate wins
only bit-identical, so the candidates that change the sum order
(``chunk_slots`` other than 128) or the carriage (bf16, int8) are raced
as diagnostics (``eligible=False``); in the approx class they may win
within the class tolerance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Candidate:
    """One raceable configuration: executor build overrides plus K1's
    launch knobs (see ``TunePlan``)."""

    name: str
    build: Dict[str, Any] = field(default_factory=dict)
    kernel_opts: Dict[str, Any] = field(default_factory=dict)
    eligible: bool = True
    note: str = ""


def predicted_operator_bytes(fp: dict, k: int,
                             feature_itemsize: int = 4) -> int:
    """Footprint model from the fingerprint alone: packed SELL slots
    (int32 cols, plus f32 data unless binary, or int32 degrees) plus one
    carriage: the number the HBM certificate multiplies by c."""
    slots = int(sum(fp["ladder"]["slots"]))
    rows = int(fp["total_rows"])
    cols_b = slots * 4
    data_b = 0 if fp["binary"] else slots * 4
    deg_b = rows * 4 if fp["binary"] else 0
    return cols_b + data_b + deg_b + rows * int(k) * feature_itemsize


def knob_candidates(approx: bool) -> List[Candidate]:
    """K1's launch-knob candidates: each knob of the contract off its
    default, one at a time (``ops/worklist.py``)."""
    k1 = {"kernel": "pallas_sell"}
    order_note = ("changes the order of a row's chunk sums; "
                  + ("tolerance-gated winner" if approx else
                     "diagnostic (never bit-identical to the default)"))
    return [
        Candidate("pallas_sell", build=dict(k1),
                  note="K1 through kernel_opts at its default knobs"),
        Candidate("pallas_sell_chunk64", build=dict(k1),
                  kernel_opts={"chunk_slots": 64}, eligible=approx,
                  note="chunks of at most 64 slots: " + order_note),
        Candidate("pallas_sell_chunk256", build=dict(k1),
                  kernel_opts={"chunk_slots": 256}, eligible=approx,
                  note="chunks of at most 256 slots: " + order_note),
        Candidate("pallas_sell_batch4", build=dict(k1),
                  kernel_opts={"batch": 4},
                  note="4 slot loads in flight a lane"),
        Candidate("pallas_sell_ctas1", build=dict(k1),
                  kernel_opts={"ctas_per_sm": 1},
                  note="launch bound of one CTA an SM (more registers)"),
        Candidate("pallas_sell_bf16",
                  build={"kernel": "pallas_sell", "feature_dtype": "bf16"},
                  eligible=approx,
                  note=("K1, bf16 carriage / f32 sums; tolerance-gated "
                        "winner" if approx else "K1, bf16 carriage "
                        "diagnostic (never f32 bit-identical)")),
    ]


def enumerate_candidates(fp: dict, k: int, *,
                         platform: str = "cpu",
                         allow_int8: bool = False,
                         budget_bytes: Optional[int] = None,
                         restrict: Optional[List[str]] = None,
                         traffic_class: str = "exact",
                         extra: Optional[List[Candidate]] = None,
                         lens_model=None
                         ) -> Tuple[List[Candidate], Dict[str, str]]:
    """The pruned candidate list for one (fingerprint, k): returns
    ``(candidates, pruned)``, ``pruned`` mapping each rejected name to
    its reason.  ``restrict`` narrows the space by name; ``extra``
    appends candidates (generated schedules), which ride the same
    screens; ``lens_model`` arms the lens screen; ``platform`` is
    "cpu" or "gpu" (the evaluator; on the CPU the budget is the host's
    unless ``budget_bytes`` is given)."""
    from arrow_matrix_tpu_torch.classes import TRAFFIC_CLASSES

    if traffic_class not in TRAFFIC_CLASSES:
        raise ValueError(f"unknown traffic class {traffic_class!r} "
                         f"(expected one of {TRAFFIC_CLASSES})")
    approx = traffic_class == "approx"
    from arrow_matrix_tpu_torch.obs.comm import (
        hbm_budget_bytes,
        repl_predict_ms,
    )
    from arrow_matrix_tpu_torch.obs.memview import largest_fitting_repl

    raw: List[Candidate] = [
        Candidate("default", note="the hand-tuned baseline; always raced, "
                                  "trivially bit-identical"),
        Candidate("fold_tight", build={"fold_growth": 1.1, "fold_align": 1},
                  note="minimal padded slots (more tiers)"),
        Candidate("fold_coarse", build={"fold_growth": 1.5},
                  note="fewer tiers, more padding"),
        Candidate("ell_one_tier",
                  build={"fold_growth": 1e9, "fold_align": 1},
                  note="degenerate tier split: one ELL tier (plus the "
                       "zero-degree prefix)"),
        Candidate("hyb", build={"fmt": "hyb"},
                  note="split ELL+COO whole-level kernel"),
        Candidate("chunk_4096", build={"chunk": 4096},
                  note="fixed gather chunk vs the auto budget"),
        *knob_candidates(approx),
        Candidate("overlap2", build={"overlap_slabs": 2},
                  note="S=2 chunked overlap schedule"),
        Candidate("repl2", build={"repl": 2},
                  note="2.5D column groups, c=2"),
        Candidate("bf16", build={"feature_dtype": "bf16"}, eligible=approx,
                  note=("bf16 carriage: approx-class candidate "
                        "(tolerance-gated winner)" if approx else
                        "bf16 carriage diagnostic (never f32 "
                        "bit-identical; cannot win)")),
    ]
    if allow_int8:
        raw.append(Candidate(
            "int8", build={"feature_dtype": "int8"}, eligible=approx,
            note=("opt-in int8 (q, scale) carriage: approx-class candidate"
                  if approx else "opt-in int8-carriage experiment "
                                 "(diagnostic only)")))
    if approx or allow_int8:
        raw.append(Candidate(
            "pallas_sell_int8",
            build={"kernel": "pallas_sell", "feature_dtype": "int8"},
            eligible=approx,
            note=("K1, int8 (q, scale) carriage / f32 sums; "
                  "tolerance-gated winner" if approx else
                  "K1, int8 (q, scale) carriage diagnostic (never f32 "
                  "bit-identical; cannot win)")))
    if extra:
        raw.extend(extra)

    budget = hbm_budget_bytes(budget_bytes,
                              device="cpu" if platform == "cpu" else None)
    base_bytes = predicted_operator_bytes(fp, k)
    default_ms = repl_predict_ms(1, 0, compute_ms=0.0)
    lens_base = 0.0
    if lens_model is not None:
        from arrow_matrix_tpu_torch.obs.costmodel import predict_candidate_ms

        lens_base = predict_candidate_ms(lens_model, fp, k, {}, {})
    shapes = list(zip((int(w) for w in fp["ladder"]["slot_width"]),
                      (int(r) for r in fp["ladder"]["rows"])))

    out, pruned = [], {}
    for c in raw:
        if restrict is not None and c.name not in restrict:
            pruned[c.name] = "not in restricted candidate set"
            continue
        if c.build.get("chunk") is not None:
            pruned[c.name] = ("K1 builds no gather intermediate: the gather "
                              "chunk has no meaning on the port's fold")
            continue
        repl = int(c.build.get("repl", 1))
        slabs = int(c.build.get("overlap_slabs", 1))
        if repl > 1:
            if k % repl:
                pruned[c.name] = f"repl={repl} needs repl | k (k={k})"
                continue
            fit = largest_fitting_repl(base_bytes, budget, choices=(1, repl))
            if fit < repl:
                pruned[c.name] = (f"HBM certificate: {base_bytes} B x{repl} "
                                  f"exceeds budget {budget} B")
                continue
            predicted = repl_predict_ms(repl, 0, compute_ms=default_ms)
            if predicted > 3.0 * max(default_ms, 1e-9):
                pruned[c.name] = (f"cost model: predicted {predicted:.3f} "
                                  f"ms > 3x default")
                continue
        if slabs > 1 and (k // repl) % slabs:
            pruned[c.name] = (f"overlap S={slabs} needs S | (k/c) (k={k}, "
                              f"c={repl})")
            continue
        if c.build.get("kernel") == "pallas_sell":
            from arrow_matrix_tpu_torch.analysis.kernels import (
                certify_candidate_opts,
            )
            from arrow_matrix_tpu_torch.ops.cuda_sell import kcert_entry

            if not kcert_entry().contract.supports_k(k):
                pruned[c.name] = f"K1's contract does not take k={k}"
                continue
            reason = certify_candidate_opts(
                c.kernel_opts, k, feature_dtype=c.build.get("feature_dtype"),
                shapes=shapes)
            if reason is not None:
                pruned[c.name] = reason
                continue
        if lens_model is not None and lens_base > 0.0 \
                and c.name != "default":
            from arrow_matrix_tpu_torch.obs.costmodel import (
                predict_candidate_ms,
            )

            predicted = predict_candidate_ms(lens_model, fp, k, c.build,
                                             c.kernel_opts)
            if predicted > 3.0 * lens_base:
                pruned[c.name] = (f"lens: predicted compute {predicted:.3f} "
                                  f"ms > 3x default {lens_base:.3f} ms")
                continue
        out.append(c)
    return out, pruned

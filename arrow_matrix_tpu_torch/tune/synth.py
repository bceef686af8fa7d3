"""Schedule synthesis: a per-tier K1 schedule from the degree ladder.

The port's copy of ``arrow_matrix_tpu/tune/synth.py``.  It reads the
structure fingerprint's degree ladder and derives a schedule for each
tier instead of choosing among uniform knob settings: each tier gets the
reference's family (``tail``/``mid``/``head`` by its slot width,
:data:`TAIL_WIDTH` and :data:`MID_WIDTH`) and its carriage policy, and
:data:`FAMILY_POLICY` maps the family to K1's knobs, where the
reference maps it to ``(row_block, wave, ring, slab_blocks)``.

A schedule is a parameterized program over the one hand-written K1,
never new kernel source: the executor runs one K1 launch for each
distinct (batch, ctas_per_sm, carriage) of its tiers
(``ops/cuda_sell.py:launch_groups``).  The ``exact`` policy keeps every
tier at f32 and at the default chunk (128 slots), so it keeps the sum
order and can win bit-identical; ``mixed`` narrows the head and mid
tiers to bf16 (approx class only).

The pipeline: :func:`synth_candidates` feeds ``enumerate_candidates
(extra=...)`` (lens screen, certification before any child spawns);
the race keeps the exact win rule; :func:`persist_program` writes the
surviving program into the port's store (``tune/synth_programs.json``,
``AMT_SYNTH_STORE`` overrides) and registers it, and
``ops/kernel_contract.registered_kernels()`` registers the stored
programs in every process (:func:`register_persisted_programs`).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

from arrow_matrix_tpu_torch.ops.kernel_contract import (
    KernelContract,
    KernelEntry,
    register_kernel,
)

STORE_VERSION = 1

#: Degree-ladder family bands (slot width w = the tier's m_t), the bands
#: ``obs/costmodel.tier_family`` prices with.
TAIL_WIDTH = 8
MID_WIDTH = 64

#: K1's knobs for each family.  Tail tiers' rows hold a few slots: a
#: short batch loads no padding past the chunk and holds fewer
#: registers.  Head tiers' rows are long chains of dependent loads: 8
#: in flight a lane under a launch bound of one CTA an SM, which leaves
#: a lane more registers.  Every family keeps the default chunk (128
#: slots), hence the default's sum order.
FAMILY_POLICY: Dict[str, Dict[str, int]] = {
    "tail": {"chunk_slots": 128, "batch": 4, "ctas_per_sm": 2},
    "mid": {"chunk_slots": 128, "batch": 8, "ctas_per_sm": 2},
    "head": {"chunk_slots": 128, "batch": 8, "ctas_per_sm": 1},
}

DEFAULT_STORE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "synth_programs.json")


def store_path(path: Optional[str] = None) -> str:
    if path is not None:
        return path
    return os.environ.get("AMT_SYNTH_STORE", DEFAULT_STORE_PATH)


def ladder_family(width: int) -> str:
    """The family of one tier's slot width (a zero-width tier launches
    nothing and is left to the caller)."""
    if width <= TAIL_WIDTH:
        return "tail"
    if width <= MID_WIDTH:
        return "mid"
    return "head"


def synthesize_schedule(fp: dict, *,
                        carriage_policy: str = "exact") -> List[dict]:
    """The per-tier schedule of a fingerprint's degree ladder: one entry
    per tier with slots and rows, carrying its provenance (``m_t``,
    ``rows``, ``family``) and K1's knobs.  ``carriage_policy="exact"``
    keeps every tier f32; ``"mixed"`` narrows head and mid tiers to
    bf16 and keeps the tail tiers f32."""
    if carriage_policy not in ("exact", "mixed"):
        raise ValueError(f"unknown carriage policy {carriage_policy!r}")
    ladder = fp["ladder"]
    schedule: List[dict] = []
    for t, (w, r) in enumerate(zip(ladder["slot_width"], ladder["rows"])):
        w, r = int(w), int(r)
        if w < 1 or r < 1:
            continue
        fam = ladder_family(w)
        carriage = "bf16" if (carriage_policy == "mixed"
                              and fam != "tail") else "f32"
        schedule.append({"tier": t, "m_t": w, "rows": r, "family": fam,
                         **FAMILY_POLICY[fam], "carriage": carriage})
    return schedule


def schedule_summary(schedule: List[dict]) -> str:
    """One line: ``L1:tail b4/c2 ...`` (``/bf16`` for a bf16 tier)."""
    return " ".join(
        f"L{e['tier']}:{e['family']} b{e['batch']}/c{e['ctas_per_sm']}"
        + ("" if e.get("chunk_slots", 128) == 128
           else f"/s{e['chunk_slots']}")
        + ("/" + e["carriage"] if e.get("carriage", "f32") != "f32" else "")
        for e in schedule)


def program_name(structure_hash: str) -> str:
    return f"k1_synth_{structure_hash[:8]}"


def synth_candidates(fp: dict, *, traffic_class: str = "exact") -> List[Any]:
    """The generated candidates of a fingerprint, for
    ``enumerate_candidates(extra=...)``: ``synth_ladder`` (the exact
    schedule, exact-class eligible) and ``synth_ladder_mixed`` (bf16 on
    head/mid tiers; approx class only)."""
    from arrow_matrix_tpu_torch.tune.space import Candidate

    exact = synthesize_schedule(fp, carriage_policy="exact")
    if not exact:
        return []
    approx = traffic_class == "approx"
    out = [Candidate(
        "synth_ladder", build={"kernel": "pallas_sell"},
        kernel_opts={"schedule": exact},
        note=("generated per-tier schedule from the degree ladder: "
              + schedule_summary(exact)))]
    mixed = synthesize_schedule(fp, carriage_policy="mixed")
    if any(e.get("carriage") == "bf16" for e in mixed):
        out.append(Candidate(
            "synth_ladder_mixed", build={"kernel": "pallas_sell"},
            kernel_opts={"schedule": mixed}, eligible=approx,
            note=("generated mixed-carriage schedule (bf16 head/mid, f32 "
                  "tail): " + schedule_summary(mixed)
                  + ("; tolerance-gated winner" if approx else
                     "; diagnostic (never f32 bit-identical)"))))
    return out


# -- the program store ---------------------------------------------------------

def load_store(path: Optional[str] = None) -> dict:
    p = store_path(path)
    try:
        with open(p, encoding="utf-8") as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return {"version": STORE_VERSION, "programs": {}}
    if not isinstance(doc, dict) or "programs" not in doc:
        raise ValueError(f"synth store {p!r} is not a program store")
    if int(doc.get("version", -1)) != STORE_VERSION:
        raise ValueError(f"synth store version skew: {p!r} carries "
                         f"{doc.get('version')!r}, this build reads "
                         f"{STORE_VERSION}")
    return doc


def synth_program_record(fp: dict, structure_hash: str, k: int,
                         schedule: List[dict]) -> dict:
    """The store record of one generated program: the ladder it was
    derived from (every tier, zero tiers included) and its schedule."""
    ladder = fp["ladder"]
    return {"structure_hash": structure_hash, "k": int(k), "n": int(fp["n"]),
            "binary": bool(fp["binary"]),
            "shapes": [[int(w), int(r)] for w, r in
                       zip(ladder["slot_width"], ladder["rows"])],
            "schedule": [dict(e) for e in schedule],
            "summary": schedule_summary(schedule)}


def persist_program(fp: dict, structure_hash: str, k: int,
                    schedule: List[dict], path: Optional[str] = None) -> str:
    """Merge one generated program into the store (atomic replace) and
    register it in this process; returns its name."""
    p = store_path(path)
    name = program_name(structure_hash)
    doc = load_store(p)
    doc["version"] = STORE_VERSION
    doc["programs"][name] = synth_program_record(fp, structure_hash, k,
                                                 schedule)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                               prefix=".synth_", suffix=".json")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, p)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    register_kernel(entry_from_program(name, doc["programs"][name]))
    return name


def _program_groups(prog: dict):
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_sell import launch_groups

    return launch_groups({"schedule": prog["schedule"]}, len(prog["shapes"]),
                         torch.float32)


def _program_metas(prog: dict) -> List[dict]:
    """K1's launch metas of every launch of one program at its k."""
    from arrow_matrix_tpu_torch.ops.cuda_sell import CARRIAGE_NAMES
    from arrow_matrix_tpu_torch.ops.worklist import k1_meta

    shapes = [tuple(s) for s in prog["shapes"]]
    starts, r = [], 0
    for _, n_t in shapes:
        starts.append(r)
        r += n_t
    metas = []
    k = int(prog["k"])
    for g in _program_groups(prog):
        c = CARRIAGE_NAMES[g.carriage] if g.carriage is not None else "f32"
        item = {"f32": 4, "bf16": 2}[c]
        metas.append(k1_meta([shapes[t] for t in g.tiers],
                             [starts[t] for t in g.tiers], r, r, k, c,
                             bool(prog["binary"]), k * item % 16 == 0,
                             g.opts))
    return metas


def _program_witness(prog: dict):
    """Boundary witness at each launch's knobs: every slot at the last
    row, the work list's twin against the plain product."""
    import numpy as np
    import torch

    from arrow_matrix_tpu_torch.ops.sell import sell_from_arrays, sell_spmm
    from arrow_matrix_tpu_torch.ops.worklist import (
        build_worklist,
        sell_spmm_worklist,
    )

    shapes = ((3, 40), (200, 3))
    n = 43
    m = sell_from_arrays([np.full(s, n - 1, np.int32) for s in shapes], None,
                         [np.full(s[1], s[0], np.int32) for s in shapes], n,
                         [0, 40], device="cpu")
    x = torch.from_numpy(np.linspace(-1, 1, n * 16, dtype=np.float32)
                         .reshape(n, 16))
    groups = _program_groups(prog)
    for g in groups:
        opts = g.opts
        if isinstance(opts.chunk_slots, tuple):
            import dataclasses

            opts = dataclasses.replace(opts, chunk_slots=opts.chunk_slots[0])
        xc = x if g.carriage is None else x.to(g.carriage)
        # Validation at synthesis time, once per launch group.
        shapes = [tuple(c.shape) for c in m.cols]
        wl = build_worklist(  # graft-lint: disable=R2
            shapes, m.row_starts, 16, xc.element_size(), opts=opts)
        got = sell_spmm_worklist(m, xc, wl).float()
        if not bool(torch.isfinite(got).all()) or not torch.allclose(
                got, sell_spmm(m, xc).float(), rtol=1e-2, atol=1e-2):
            return False, f"boundary twin != plain at {opts}"
    return True, (f"{len(groups)} launch(es): every slot at the last row, "
                  f"twin equals the plain product")


def entry_from_program(name: str, prog: dict) -> KernelEntry:
    """A generated program as a certifiable entry: K1's contract
    narrowed to the program's knob values, its launches' metas, and
    K1's source under the source rules."""
    from arrow_matrix_tpu_torch.ops import _build
    from arrow_matrix_tpu_torch.ops.cuda_sell import kcert_entry

    base = kcert_entry().contract
    sched = prog["schedule"]
    values = lambda key, default: tuple(sorted(  # noqa: E731
        {e.get(key, default) for e in sched}))
    contract = KernelContract(
        name=name, module="arrow_matrix_tpu_torch.tune.synth",
        kind="k1_worklist", source=base.source, threads=base.threads,
        ctas_per_sm=values("ctas_per_sm", 2),
        static_smem_bytes=base.static_smem_bytes,
        knobs=(("batch", values("batch", 8)),
               ("chunk_slots", values("chunk_slots", 128)),
               ("ctas_per_sm", values("ctas_per_sm", 2))),
        ks=(int(prog["k"]),),
        carriage_dtypes=values("carriage", "f32"),
        accum_dtype="f32", accum_decls=base.accum_decls)
    return KernelEntry(
        contract=contract, metas=lambda: _program_metas(prog),
        source_path=os.path.join(_build.CSRC_DIR, "sell_tier_spmm.cu"),
        witness=lambda: _program_witness(prog))


def register_persisted_programs(path: Optional[str] = None) -> List[str]:
    """Register every program of the store; returns their names (none
    when the store is absent)."""
    doc = load_store(path)
    for name in sorted(doc["programs"]):
        register_kernel(entry_from_program(name, doc["programs"][name]))
    return sorted(doc["programs"])

"""The Hopper kernel certifier: rules KC1-KC5 over the port's kernels.

The port's counterpart of ``arrow_matrix_tpu/analysis/kernels.py``.
Every hand-written kernel exports a :class:`~arrow_matrix_tpu_torch.ops.
kernel_contract.KernelContract` and *metas*: literal descriptions of
its launches at the contract's knob points, built by the same functions
its wrapper launches from (K1's ``ops/worklist.py:k1_meta`` is the work
list ``build_plan`` uploads).  Each rule is restated for the card:

* **KC1** (bounds): every work-list item's rows and chunks lie inside
  its tier, every tier inside the output, every split partial inside
  the workspace, the lanes cover k, the grid fits; a kernel's tile and
  CTA constants in its ``.cu`` equal the wrapper's mirror; and a
  boundary witness in which every index points at the last row;
* **KC2** (budgets): threads, registers (a per-lane model against the
  launch bound's share of the register file) and static plus dynamic
  shared memory fit sm_90 (227 KB a CTA, 228 KB an SM) at every point;
* **KC3** (sum order; the reference's DMA ring has no counterpart on the
  card): a row's chunk sums are added in blocks of ``CHUNK_BLOCK`` in an
  order that depends on S alone, replayed from the items and the split
  rows of every meta, at every k and knob point; a point that claims
  the default's order has the default's S; K3's partials are contiguous
  block ranges added in order;
* **KC4**: the accumulator is f32, in the meta and in the ``.cu``
  (the contract's accumulator declarations stand in the source, and no
  accumulator is declared in a narrow type);
* **KC5**: every output row (K1), block (K2/K3) or gathered row (K4) is
  written exactly once, directly or by the split-sum pass.

Verdicts go to the port's manifest (``analysis/kernel_manifest.json``,
drift-checked by ``--check``); ``tune/space.py`` calls
:func:`certify_candidate_opts` before any child spawns.

Usage::

    python -m arrow_matrix_tpu_torch.analysis kernels            certify, write
    python -m arrow_matrix_tpu_torch.analysis kernels --check    certify, drift
    python -m arrow_matrix_tpu_torch.analysis kernels --selftest planted twins
    python -m arrow_matrix_tpu_torch.analysis kernels --fixture F  planted file
"""

from __future__ import annotations

import copy
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from arrow_matrix_tpu_torch.ops import kernel_contract as kc
from arrow_matrix_tpu_torch.ops.kernel_contract import (
    WIDE_ACCUM_DTYPES,
    KernelEntry,
    registered_kernels,
)

RULE_IDS = ("KC1", "KC2", "KC3", "KC4", "KC5")

RULE_TITLES = {
    "KC1": "every item, tier, partial and index in bounds; source "
           "constants equal the wrapper's",
    "KC2": "threads, registers and shared memory fit sm_90 at every "
           "knob point",
    "KC3": "a row's chunk sums are added in an order fixed by S alone",
    "KC4": "accumulation in f32 whatever the carriage, in meta and "
           "source",
    "KC5": "every output row written exactly once",
}

DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "kernel_manifest.json")

#: Narrow types no accumulator may be declared in (KC4).
_NARROW = r"(?:__nv_bfloat16|__half|half|int8_t|uint8_t|__nv_fp8\w*)"


class Finding:
    """One rule violation at one (kernel, point)."""

    __slots__ = ("rule", "kernel", "where", "message")

    def __init__(self, rule: str, kernel: str, where: str, message: str):
        self.rule = rule
        self.kernel = kernel
        self.where = where
        self.message = message

    def format(self) -> str:
        return f"{self.kernel}[{self.where}]: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "kernel": self.kernel,
                "where": self.where, "message": self.message}


def point_label(meta: dict) -> str:
    """A short label of one meta's point."""
    kind = meta.get("kind")
    if kind == "k1_worklist":
        return (f"k={meta['k']},{meta['carriage']},cs={meta['chunk_slots']},"
                f"b={meta['batch']},ctas={meta['ctas_per_sm']}")
    if kind == "dense_blocks":
        return (f"{meta['pass']},{meta['config']},nb={meta['nb']},"
                f"w={meta['w']},k={meta['k']},{meta['block_dtype']}")
    if kind == "row_gather":
        return (f"slots={meta['slots']},k={meta['k']},"
                f"{'add' if meta['add'] else 'gather'}")
    return str(kind)


# -- per-meta rules ------------------------------------------------------------

def register_cap(threads: int, ctas: int) -> int:
    """Registers a thread may hold under ``__launch_bounds__(threads,
    ctas)`` on sm_90."""
    return min(kc.SM90_MAX_REGS_PER_THREAD,
               kc.SM90_REGS_PER_SM // max(threads * ctas, 1))


def _budget_findings(meta: dict, add) -> None:
    """KC2 and KC4 (meta side) for any kind."""
    threads, ctas = int(meta["threads"]), int(meta["ctas_per_sm"])
    if threads < 1 or threads > kc.SM90_MAX_THREADS_PER_CTA \
            or threads % 32:
        add("KC2", f"{threads} threads a CTA (sm_90: a multiple of 32 up "
                   f"to {kc.SM90_MAX_THREADS_PER_CTA})")
    if ctas < 1 or ctas > kc.SM90_MAX_CTAS_PER_SM \
            or threads * ctas > kc.SM90_MAX_THREADS_PER_SM:
        add("KC2", f"{ctas} CTAs of {threads} threads an SM exceed "
                   f"sm_90's {kc.SM90_MAX_THREADS_PER_SM} threads")
    static, dyn = int(meta["static_smem"]), int(meta["dynamic_smem"])
    if static > kc.SM90_STATIC_SMEM:
        add("KC2", f"static shared memory {static} B > "
                   f"{kc.SM90_STATIC_SMEM} B")
    if static + dyn > kc.SM90_SMEM_PER_CTA:
        add("KC2", f"shared memory {static + dyn} B a CTA > "
                   f"{kc.SM90_SMEM_PER_CTA} B")
    elif (static + dyn) * ctas > kc.SM90_SMEM_PER_SM:
        add("KC2", f"{ctas} CTAs of {static + dyn} B > "
                   f"{kc.SM90_SMEM_PER_SM} B an SM")
    cap = register_cap(threads, ctas)
    if int(meta["regs_demand"]) > cap:
        add("KC2", f"{meta['regs_demand']} registers a thread > {cap} "
                   f"under __launch_bounds__({threads}, {ctas})")
    if str(meta.get("accum_dtype")) not in WIDE_ACCUM_DTYPES:
        add("KC4", f"accumulator {meta.get('accum_dtype')!r} is narrower "
                   f"than f32")


def canonical_order(s: int, block: int):
    """The sum of chunks 0..s-1 in blocks of ``block``, each in chunk
    order, then the block sums in block order, as a nested tuple."""
    total = None
    for b0 in range(0, s, block):
        blk = b0
        for c in range(b0 + 1, min(b0 + block, s)):
            blk = (blk, c)
        total = blk if total is None else (total, blk)
    return total


def _k1_findings(meta: dict, add) -> None:
    """KC1, KC3 and KC5 of one K1 meta."""
    tiers = np.asarray(meta["tiers"], np.int64).reshape(-1, 5)
    items = np.asarray(meta["items"], np.int64).reshape(-1, 4)
    rows = np.asarray(meta["rows"], np.int64).reshape(-1, 3)
    n_rows, n_parts = int(meta["n_rows"]), int(meta["n_parts"])
    k, vec, group = int(meta["k"]), int(meta["vec"]), int(meta["group"])
    kb, ob = int(meta["kernel_block"]), int(meta["order_block"])
    p = int(meta["threads"]) // group
    cs = meta["chunk_slots"]
    chunk_of = (lambda t: cs[t]) if isinstance(cs, list) else (lambda t: cs)

    # KC1: lanes, grid, tiers.
    if group < 1 or group > 32 or group & (group - 1):
        add("KC1", f"group {group} is not a power of two up to 32")
    if vec * group * int(meta["col_blocks"]) < k:
        add("KC1", f"lanes cover {vec * group * meta['col_blocks']} of "
                   f"{k} features")
    if int(meta["col_blocks"]) > kc.SM90_GRID_Y_MAX:
        add("KC1", f"{meta['col_blocks']} CTAs along the features > "
                   f"{kc.SM90_GRID_Y_MAX}")
    if len(items) > 2**31 - 1:
        add("KC1", f"{len(items)} items exceed the grid")
    for t, (r0, m_t, n_t, length, s) in enumerate(tiers.tolist()):
        if r0 < 0 or r0 + n_t > n_rows:
            add("KC1", f"tier {t} rows [{r0}, {r0 + n_t}) outside the "
                       f"output's {n_rows}")
        if m_t == 0:
            if s != 1:
                add("KC1", f"zero-slot tier {t} has {s} chunks")
            continue
        if length < 1 or length > chunk_of(t) or length * s < m_t \
                or length * (s - 1) >= m_t:
            add("KC1", f"tier {t}: chunks of {length} x {s} do not cut "
                       f"{m_t} slots (chunk_slots {chunk_of(t)})")
    if not len(tiers):
        return
    t_idx = items[:, 0]
    if len(items) and (t_idx.min() < 0 or t_idx.max() >= len(tiers)):
        add("KC1", "an item names a tier out of range")
        return
    n_t = tiers[t_idx, 2]
    s_of = tiers[t_idx, 4]
    direct = items[:, 3] < 0
    bad = (items[:, 1] < 0) | (items[:, 1] >= n_t)
    if bad.any():
        add("KC1", f"{int(bad.sum())} items start outside their tier's "
                   f"rows")
    split = ~direct
    if split.any():
        c0 = items[split, 2]
        if (c0 < 0).any() or (c0 >= s_of[split]).any():
            add("KC1", "a split item's first chunk is outside its row")
        blocks = -(-np.minimum(p, s_of[split] - c0) // kb)
        if (items[split, 3] + blocks > n_parts).any():
            add("KC1", "a split item writes past the workspace")
    if (items[direct, 2] != 0).any():
        add("KC1", "a direct item does not start at chunk 0")
    if len(rows) and ((rows[:, 0] < 0).any() or (rows[:, 0] >= n_rows).any()
                      or (rows[:, 1] < 0).any()
                      or (rows[:, 1] + rows[:, 2] > n_parts).any()):
        add("KC1", "a split row's output or partials are out of range")

    # KC5: every row of every tier written exactly once.
    count = np.zeros(n_rows, np.int64)
    for t in np.unique(t_idx[direct]).tolist():
        r0, m_t, nt, _, s = tiers[t].tolist()
        per = max(p // s, 1) if s <= p else 0
        if per == 0:
            add("KC5", f"tier {t}: direct items for rows of {s} chunks "
                       f"on {p} groups")
            continue
        starts = items[direct & (t_idx == t), 1]
        for j in range(per):
            r = starts + j
            np.add.at(count, r0 + r[r < nt], 1)
    np.add.at(count, rows[:, 0], 1)
    live = np.zeros(n_rows, bool)
    for r0, m_t, nt, _, _ in tiers.tolist():
        live[r0:r0 + nt] = True
    twice = int(((count > 1) & live).sum())
    never = int(((count == 0) & live).sum())
    if twice or never:
        add("KC5", f"{never} rows never written, {twice} written more "
                   f"than once")

    # KC3: the order of every row's chunk sums.
    if split.any() and p % kb:
        add("KC3", f"a split item holds {p} chunks, not whole blocks of "
                   f"{kb}")
    for t, (r0, m_t, nt, _, s) in enumerate(tiers.tolist()):
        if nt and s > 1 and s <= p and kb != ob \
                and canonical_order(s, kb) != canonical_order(s, ob):
            add("KC3", f"tier {t}: direct rows add blocks of {kb}, the "
                       f"order is blocks of {ob}")
    if meta.get("claims_default_order"):
        from arrow_matrix_tpu_torch.ops.worklist import CHUNK_SLOTS, chunking

        for t, (_, m_t, nt, length, s) in enumerate(tiers.tolist()):
            if (length, s) != chunking(m_t, CHUNK_SLOTS):
                add("KC3", f"tier {t} claims the default order but cuts "
                           f"{m_t} slots into {s} chunks")
    if not split.any():
        return
    # Replay the split items: each leader group writes one block sum.
    written: Dict[int, tuple] = {}
    for t, r, c0, part in items[split].tolist():
        s = int(tiers[t, 4])
        cps = min(p, s - c0)
        for lead in range(0, cps, kb):
            expr = c0 + lead
            for c in range(c0 + lead + 1, c0 + min(lead + kb, cps)):
                expr = (expr, c)
            slot = part + lead // kb
            if slot in written:
                add("KC5", f"partial {slot} written twice")
            written[slot] = (t, r, expr)
    for orow, first, parts in rows.tolist():
        got = None
        tier_row = None
        for q in range(parts):
            if first + q not in written:
                add("KC5", f"partial {first + q} of row {orow} never "
                           f"written")
                return
            t, r, expr = written[first + q]
            if tier_row is None:
                tier_row = (t, r)
            elif (t, r) != tier_row:
                add("KC3", f"row {orow} adds partials of another row")
                return
            got = expr if got is None else (got, expr)
        t, r = tier_row
        if int(tiers[t, 0]) + r != orow:
            add("KC5", f"split row {orow} writes tier {t}'s row {r}")
        want = canonical_order(int(tiers[t, 4]), ob)
        if got != want:
            add("KC3", f"row {orow} (tier {t}, S={tiers[t, 4]}) adds its "
                       f"chunk sums out of the order fixed by S")
            return


def _dense_findings(meta: dict, add) -> None:
    """KC1, KC3 and KC5 of one K2/K3 meta."""
    w, k, nb = int(meta["w"]), int(meta["k"]), int(meta["nb"])
    bm, bn = int(meta["bm"]), int(meta["bn"])
    rt, ct, z = (int(v) for v in meta["grid"])
    if rt * bm < w or (rt - 1) * bm >= w or ct * bn < k \
            or (ct - 1) * bn >= k:
        add("KC1", f"a grid of {rt} x {ct} tiles of {bm} x {bn} does not "
                   f"tile ({w}, {k})")
    if max(ct, z) > kc.SM90_GRID_Y_MAX:
        add("KC1", f"grid ({rt}, {ct}, {z}) exceeds sm_90's y/z extent")
    if meta["pass"] == "column":
        if z != nb - 1 or meta["writes_blocks"] != list(range(1, nb)):
            add("KC5", f"the column pass writes blocks "
                       f"{meta['writes_blocks']} over {z} grid slices "
                       f"for {nb} block rows")
        return
    from arrow_matrix_tpu_torch.ops.cuda_blocks import head_split

    chunks = [tuple(c) for c in meta["chunks"]]
    flat = [b for lo, hi in chunks for b in range(lo, hi)]
    if flat != list(range(nb)):
        add("KC3" if sorted(flat) == list(range(nb)) else "KC5",
            f"K3's partials {chunks} are not the block rows 0..{nb - 1} "
            f"in order, each once")
    if any(hi <= lo for lo, hi in chunks):
        add("KC1", "an empty K3 chunk")
    if z != len(chunks) or meta["split"] != head_split(nb, w, k):
        add("KC3", f"K3 splits into {len(chunks)} partials; the shapes "
                   f"fix {head_split(nb, w, k)}")
    if meta["writes_blocks"] != [0]:
        add("KC5", "the head pass writes another block than 0")


def _gather_findings(meta: dict, add) -> None:
    """KC1, KC3 and KC5 of one K4 meta."""
    slots, lanes = int(meta["slots"]), int(meta["lanes"])
    threads, batch = int(meta["threads"]), int(meta["batch"])
    width, k = int(meta["width"]), int(meta["k"])
    groups = threads // lanes
    if width * (4 if meta["vecload"] else 1) != k:
        add("KC1", f"{width} items a row do not hold k={k}")
    if lanes > 32 or lanes & (lanes - 1):
        add("KC1", f"{lanes} lanes a row")
    if int(meta["grid"]) * groups * batch < slots:
        add("KC5", f"{meta['grid']} CTAs gather fewer than {slots} rows")
    if int(meta["grid"]) > 2**31 - 1:
        add("KC1", "the grid exceeds sm_90's x extent")
    cta = np.arange(int(meta["grid"]))[:, None, None]
    g = np.arange(groups)[None, :, None]
    b = np.arange(batch)[None, None, :]
    s = (cta * groups * batch + g + b * groups).ravel()
    s = s[s < slots]
    count = np.bincount(s, minlength=slots)
    if (count != 1).any():
        add("KC5", f"{int((count == 0).sum())} rows never gathered, "
                   f"{int((count > 1).sum())} more than once")
    if int(meta["adds_per_element"]) != (1 if meta["add"] else 0):
        add("KC3", "the gather-add adds each element other than once")


def check_meta(meta: dict) -> List[Finding]:
    """Every per-meta finding of one launch description."""
    findings: List[Finding] = []
    name = str(meta.get("kernel", "?"))
    where = point_label(meta)

    def add(rule: str, msg: str) -> None:
        findings.append(Finding(rule, name, where, msg))

    _budget_findings(meta, add)
    kind = meta.get("kind")
    if kind == "k1_worklist":
        _k1_findings(meta, add)
    elif kind == "dense_blocks":
        _dense_findings(meta, add)
    elif kind == "row_gather":
        _gather_findings(meta, add)
    else:
        add("KC1", f"unknown kernel kind {kind!r}")
    return findings


# -- cross-meta and source rules -----------------------------------------------

def order_invariance(metas: Sequence[dict], name: str) -> List[Finding]:
    """KC3 across K1's metas: metas of one operator and one
    ``chunk_slots`` cut every tier into the same chunks at every k,
    carriage and knob point (so the order of every row is the same)."""
    seen: Dict[tuple, tuple] = {}
    out = []
    for m in metas:
        if m.get("kind") != "k1_worklist":
            continue
        tiers = [tuple(r[1:5]) for r in m["tiers"]]
        key = (tuple((r[1], r[2]) for r in m["tiers"]),
               json.dumps(m["chunk_slots"]))
        if key in seen and seen[key][0] != tiers:
            out.append(Finding(
                "KC3", name, point_label(m),
                f"chunks differ from {seen[key][1]} at the same "
                f"chunk_slots: the order would depend on k or a knob"))
        seen.setdefault(key, (tiers, point_label(m)))
    return out


def _int_const(src: str, name: str) -> Optional[int]:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    return int(m.group(1)) if m else None


def analyze_kernel_source(src: str, entry_contract, metas: Sequence[dict],
                          path: str = "<source>") -> List[Finding]:
    """KC1 (the source's constants against the wrapper's mirror) and KC4
    (accumulator declarations) of one ``.cu``."""
    name = entry_contract.name
    out: List[Finding] = []

    def add(rule, msg):
        out.append(Finding(rule, name, os.path.basename(path), msg))

    for decl in entry_contract.accum_decls:
        if decl not in src:
            add("KC4", f"accumulator declaration {decl!r} not in the source")
    for m in re.finditer(rf"\b{_NARROW}\s+(acc|s|part|red)\b", src):
        add("KC4", f"narrow accumulator {m.group(0)!r}")
    kind = entry_contract.kind
    if kind == "k1_worklist":
        for meta in metas[:1]:
            if _int_const(src, "kThreads") != int(meta["threads"]):
                add("KC1", f"kThreads {_int_const(src, 'kThreads')} != the "
                           f"work list's {meta['threads']}")
            if _int_const(src, "kBlock") != int(meta["kernel_block"]):
                add("KC1", f"kBlock {_int_const(src, 'kBlock')} != the "
                           f"work list's {meta['kernel_block']}")
    elif kind == "dense_blocks":
        from arrow_matrix_tpu_torch.ops.cuda_blocks import BK, CONFIGS, TILES

        found = {m.group(1): tuple(int(v) for v in m.group(2).split(","))
                 for m in re.finditer(r"using (\w+) = Cfg<([\d, ]+)>;", src)}
        if found != CONFIGS:
            add("KC1", f"the source's tile configurations {found} != the "
                       f"wrapper's {CONFIGS}")
        if _int_const(src, "BK") != BK:
            add("KC1", f"BK {_int_const(src, 'BK')} != {BK}")
        if [(bm, bn) for _, bm, bn in TILES] != \
                [CONFIGS[c][:2] for c in ("Narrow", "Mid", "Wide")]:
            add("KC1", "TILES does not mirror the configurations")
    elif kind == "row_gather":
        from arrow_matrix_tpu_torch.ops.cuda_gather import BATCH, THREADS

        if (_int_const(src, "kThreads"), _int_const(src, "kBatch")) != \
                (THREADS, BATCH):
            add("KC1", "kThreads/kBatch differ from the wrapper's")
    return out


# -- certification -------------------------------------------------------------

def certify_entry(entry: KernelEntry) -> dict:
    """KC1-KC5 for one registered kernel; its manifest record."""
    t0 = time.perf_counter()
    findings: List[Finding] = []
    try:
        metas = list(entry.metas())
    except Exception as exc:  # noqa: BLE001 -- a raise is a KC1 finding
        metas = []
        findings.append(Finding("KC1", entry.name, "metas",
                                f"meta enumeration raised: {exc!r}"))
    for meta in metas:
        findings.extend(check_meta(meta))
    findings.extend(order_invariance(metas, entry.name))
    src = entry.source()
    if src is not None:
        findings.extend(analyze_kernel_source(
            src, entry.contract, metas, entry.source_path or "<source>"))
    witness_detail = None
    if entry.witness is not None:
        ok, witness_detail = entry.witness()
        if not ok:
            findings.append(Finding("KC1", entry.name, "witness",
                                    witness_detail))
    rules: Dict[str, dict] = {}
    for rule in RULE_IDS:
        hits = [f for f in findings if f.rule == rule]
        if hits:
            detail = "; ".join(f.format() for f in hits[:8])
            if len(hits) > 8:
                detail += f" (+{len(hits) - 8} more)"
            rules[rule] = {"status": "fail", "detail": detail}
        else:
            rules[rule] = {"status": "pass", "detail": RULE_TITLES[rule]}
    return {"name": entry.name, "module": entry.contract.module,
            "kind": entry.contract.kind,
            "contract": entry.contract.to_json(), "points": len(metas),
            "rules": rules, "witness": witness_detail,
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "findings": [f.to_json() for f in findings],
            "ok": not findings}


def certify_all(entries: Optional[Sequence[KernelEntry]] = None
                ) -> List[dict]:
    return [certify_entry(e)
            for e in (registered_kernels() if entries is None
                      else entries)]


def build_manifest(records: Sequence[dict]) -> dict:
    import datetime
    import platform as _platform

    rules: Dict[str, dict] = {}
    for rule in RULE_IDS:
        failed = [r["name"] for r in records
                  if r["rules"][rule]["status"] == "fail"]
        rules[rule] = ({"status": "fail",
                        "detail": "fails in: " + ", ".join(failed)}
                       if failed else
                       {"status": "pass", "detail": RULE_TITLES[rule]})
    return {
        "generated_by": "python -m arrow_matrix_tpu_torch.analysis kernels",
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "python_version": sys.version.split()[0],
        "platform": _platform.platform(),
        "package": "arrow_matrix_tpu_torch",
        "kernels": sorted(records, key=lambda r: r["name"]),
        "rules": rules,
        "counts": {
            "kernels": len(records),
            "points": sum(r["points"] for r in records),
            "findings": sum(len(r["findings"]) for r in records),
            "rules_pass": sum(1 for r in records for rule in RULE_IDS
                              if r["rules"][rule]["status"] == "pass"),
        },
        "ok": all(r["ok"] for r in records),
    }


def manifest_digest(manifest: dict) -> dict:
    """The behavior-only view the drift check compares: verdicts,
    contracts, point counts, findings (no timestamps or wall times)."""
    return json.loads(json.dumps({
        "rules": {r: v["status"]
                  for r, v in manifest.get("rules", {}).items()},
        "kernels": {
            k["name"]: {
                "kind": k["kind"], "contract": k["contract"],
                "points": k["points"],
                "rules": {r: v["status"] for r, v in k["rules"].items()},
                "findings": sorted(f"{f['rule']}:{f['where']}:{f['message']}"
                                   for f in k.get("findings", ())),
            }
            for k in manifest.get("kernels", ())
        },
        "counts": dict(manifest.get("counts") or {}),
        "ok": manifest.get("ok"),
    }))


def manifest_drift(old: dict, new: dict) -> List[str]:
    """Differences between two manifests' digests (empty: no drift)."""
    a, b = manifest_digest(old), manifest_digest(new)
    problems: List[str] = []
    for rule in sorted(set(a["rules"]) | set(b["rules"])):
        if a["rules"].get(rule) != b["rules"].get(rule):
            problems.append(f"rule {rule} changed: {a['rules'].get(rule)} "
                            f"-> {b['rules'].get(rule)}")
    for name in sorted(set(a["kernels"]) | set(b["kernels"])):
        if name not in b["kernels"]:
            problems.append(f"kernel disappeared: {name}")
        elif name not in a["kernels"]:
            problems.append(f"new unrecorded kernel: {name}")
        else:
            ka, kb_ = a["kernels"][name], b["kernels"][name]
            for key in ("kind", "contract", "points", "rules"):
                if ka[key] != kb_[key]:
                    problems.append(f"kernel {name}: {key} changed")
            if ka["findings"] != kb_["findings"]:
                problems.append(f"kernel {name}: finding set changed")
    if a["counts"] != b["counts"]:
        problems.append(f"verdict counts changed: {a['counts']} -> "
                        f"{b['counts']}")
    if a["ok"] != b["ok"]:
        problems.append(f"overall ok changed: {a['ok']} -> {b['ok']}")
    return problems


def run_kernels(out_path: str = DEFAULT_MANIFEST, write: bool = True,
                entries: Optional[Sequence[KernelEntry]] = None) -> dict:
    """Certify every registered kernel; return (and write) the
    manifest."""
    manifest = build_manifest(certify_all(entries))
    if write:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return manifest


# -- tune-candidate certification (the pruning hook) ---------------------------

def certify_candidate_opts(kernel_opts: Optional[dict], k: int, *,
                           feature_dtype=None,
                           shapes: Optional[Sequence[Tuple[int, int]]] = None
                           ) -> Optional[str]:
    """Certify one tune candidate's K1 options before any child spawns:
    ``None`` when its launches prove out under KC1-KC5 at width ``k``,
    else a ``"kcert: ..."`` prune reason.  ``shapes`` is the operator's
    ``(m_t, n_t)`` ladder (the certifier's operator by default; a
    schedule's ``m_t``/``rows`` entries when it names them)."""
    import torch

    from arrow_matrix_tpu_torch.ops.cuda_sell import (
        CARRIAGE_NAMES,
        KCERT_SHAPES,
        launch_groups,
    )
    from arrow_matrix_tpu_torch.ops.worklist import k1_meta

    opts = dict(kernel_opts or {})
    if feature_dtype is None:
        feature_dtype = opts.get("feature_dtype")
    fd = {None: "f32", "f32": "f32", "float32": "f32", "bf16": "bf16",
          "bfloat16": "bf16", "int8": "int8"}.get(feature_dtype)
    if fd is None:
        return f"kcert: unknown carriage {feature_dtype!r}"
    contract = next(e.contract for e in registered_kernels()
                    if e.name == "sell_tier_spmm")
    if fd not in contract.carriage_dtypes:
        return (f"kcert: carriage {fd!r} outside the contract "
                f"({contract.carriage_dtypes})")
    if not contract.supports_k(k):
        return f"kcert: K1 takes k >= 1 (k={k})"
    sched = opts.get("schedule") or []
    if shapes is None:
        named = {int(e["tier"]): (int(e["m_t"]), int(e["rows"]))
                 for e in sched if "m_t" in e and "rows" in e}
        if named:
            n_tiers = max(named) + 1
            shapes = [named.get(t, (0, 0)) for t in range(n_tiers)]
        else:
            shapes = KCERT_SHAPES
    carriage = {v: k_ for k_, v in CARRIAGE_NAMES.items()}[fd]
    try:
        groups = launch_groups(opts, len(shapes), carriage)
    except (ValueError, TypeError) as exc:
        return f"kcert: {exc}"
    starts, r = [], 0
    for _, n_t in shapes:
        starts.append(r)
        r += n_t
    for g in groups:
        c = CARRIAGE_NAMES[g.carriage or carriage]
        item = torch.tensor([], dtype=g.carriage or carriage).element_size()
        meta = k1_meta([shapes[t] for t in g.tiers],
                       [starts[t] for t in g.tiers], r, r, k, c, True,
                       contract.vector_loads(k, item), g.opts)
        found = check_meta(meta)
        if found:
            f0 = found[0]
            return (f"kcert: tiers {list(g.tiers)[:4]}...: {f0.rule}: "
                    f"{f0.message}")
    return None


# -- planted fixtures and the self-test ----------------------------------------

def _good_k1_meta() -> dict:
    from arrow_matrix_tpu_torch.ops.worklist import k1_meta

    shapes = ((8, 40), (40, 12), (2000, 2))
    return k1_meta(shapes, (0, 40, 52), 54, 54, 128, "f32", True, True)


def planted_metas() -> Dict[str, dict]:
    """One broken K1 meta per rule: each must fire its rule."""
    good = _good_k1_meta()
    broken = {}
    m = copy.deepcopy(good)
    m["items"][0][1] = 10_000                  # a row past its tier
    broken["KC1"] = m
    m = copy.deepcopy(good)
    m["static_smem"] = 200 * 1024              # 200 KB of __shared__
    m["regs_demand"] = 300
    broken["KC2"] = m
    m = copy.deepcopy(good)
    split = [i for i, it in enumerate(m["items"]) if it[3] >= 0]
    a, b = split[0], split[1]                  # a row's two items
    m["items"][a][3], m["items"][b][3] = m["items"][b][3], m["items"][a][3]
    broken["KC3"] = m
    m = copy.deepcopy(good)
    m["accum_dtype"] = "bf16"
    broken["KC4"] = m
    m = copy.deepcopy(good)
    direct = [i for i, it in enumerate(m["items"]) if it[3] < 0]
    m["items"].append(list(m["items"][direct[0]]))   # a row twice
    broken["KC5"] = m
    return broken


def _k1_source() -> str:
    from arrow_matrix_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "sell_tier_spmm.cu"),
              encoding="utf-8") as fh:
        return fh.read()


def planted_sources() -> Dict[str, str]:
    """Broken copies of K1's source: a narrow accumulator (KC4) and a
    kBlock that no longer equals the work list's (KC1)."""
    src = _k1_source()
    return {"KC4": src.replace("float acc[VEC];", "__nv_bfloat16 acc[VEC];"),
            "KC1": src.replace("constexpr int kBlock = 8;",
                               "constexpr int kBlock = 4;")}


def selftest() -> Tuple[bool, List[str]]:
    """The planted twins: the good K1 meta and source are clean and each
    broken one fires its rule."""
    from arrow_matrix_tpu_torch.ops.cuda_sell import kcert_entry

    lines: List[str] = []
    ok = True
    good = check_meta(_good_k1_meta())
    if good:
        ok = False
        lines.append("GOOD meta produced findings: "
                     + "; ".join(f.format() for f in good))
    else:
        lines.append("good meta clean")
    for rule, meta in sorted(planted_metas().items()):
        fired = {f.rule for f in check_meta(meta)}
        ok &= rule in fired
        lines.append(f"{rule} {'fires' if rule in fired else 'DID NOT FIRE'}"
                     f" on its planted meta (fired {sorted(fired)})")
    contract = kcert_entry().contract
    metas = [_good_k1_meta()]
    clean = analyze_kernel_source(_k1_source(), contract, metas)
    if clean:
        ok = False
        lines.append("GOOD source produced findings: "
                     + "; ".join(f.format() for f in clean))
    else:
        lines.append("good source clean")
    for rule, src in sorted(planted_sources().items()):
        fired = {f.rule for f in analyze_kernel_source(src, contract,
                                                       metas)}
        ok &= rule in fired
        lines.append(f"{rule} {'fires' if rule in fired else 'DID NOT FIRE'}"
                     f" on its planted source")
    return ok, lines


def fixture_rule(path: str) -> str:
    """The rule a planted fixture ``kcN_<slug>.json`` must fire."""
    base = os.path.basename(path)
    for rule in RULE_IDS:
        if base.lower().startswith(rule.lower() + "_"):
            return rule
    raise ValueError(f"fixture {base!r} does not follow the "
                     f"kcN_<slug>.json convention")


def certify_paths(paths: Sequence[str]) -> List[Finding]:
    """Certify planted files: JSON ``{"metas": [...], "source": ...,
    "contract": "sell_tier_spmm"}`` (source optional)."""
    from arrow_matrix_tpu_torch.ops.kernel_contract import builtin_kernels

    contracts = {e.name: e.contract for e in builtin_kernels()}
    findings: List[Finding] = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        metas = doc.get("metas") or []
        for meta in metas:
            findings.extend(check_meta(meta))
        findings.extend(order_invariance(metas, os.path.basename(path)))
        if doc.get("source") is not None:
            findings.extend(analyze_kernel_source(
                doc["source"],
                contracts[doc.get("contract", "sell_tier_spmm")], metas,
                path))
    return findings


def verify_fixture(path: str) -> Tuple[bool, str]:
    """(ok, detail): the fixture must fire its rule."""
    expected = fixture_rule(path)
    fired = sorted({f.rule for f in certify_paths([path])})
    if expected in fired:
        return True, f"{os.path.basename(path)}: {expected} fired"
    return False, (f"{os.path.basename(path)}: expected {expected}, got "
                   f"{fired or 'nothing'}")


# -- CLI -----------------------------------------------------------------------

def _print_manifest(manifest: dict) -> None:
    for k in manifest["kernels"]:
        for rule in RULE_IDS:
            v = k["rules"][rule]
            mark = "ok  " if v["status"] == "pass" else "FAIL"
            print(f"[{mark}] {k['name']} {rule}: {v['detail']}")
    counts = manifest["counts"]
    print(f"kernels: {counts['kernels']}  points: {counts['points']}  "
          f"rule verdicts passing: {counts['rules_pass']}/"
          f"{counts['kernels'] * len(RULE_IDS)}")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="analysis kernels", description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_MANIFEST)
    ap.add_argument("--check", action="store_true",
                    help="do not write; fail on any finding or on drift "
                         "from the committed manifest")
    ap.add_argument("--selftest", action="store_true",
                    help="run the planted twins and exit")
    ap.add_argument("--fixture", action="append", default=[],
                    help="a planted kcN_<slug>.json must fire its rule "
                         "(repeatable)")
    ap.add_argument("--paths", nargs="+", default=None,
                    help="certify these JSON meta files; nonzero on any "
                         "finding")
    args = ap.parse_args(argv)

    if args.selftest:
        ok, lines = selftest()
        for ln in lines:
            print(ln)
        print("selftest passed" if ok else "SELFTEST FAILED")
        return 0 if ok else 1
    if args.fixture:
        rc = 0
        for path in args.fixture:
            ok, detail = verify_fixture(path)
            print(("ok   " if ok else "FAIL ") + detail)
            rc = rc or (0 if ok else 1)
        return rc
    if args.paths:
        findings = certify_paths(args.paths)
        for f in findings:
            print(f.format())
        return 1 if findings else 0

    manifest = run_kernels(out_path=args.out, write=not args.check)
    _print_manifest(manifest)
    rc = 0 if manifest["ok"] else 1
    if args.check:
        try:
            with open(args.out, encoding="utf-8") as fh:
                committed = json.load(fh)
        except (OSError, ValueError) as e:
            print(f"no readable committed manifest at {args.out}: {e}")
            return 1
        drift = manifest_drift(committed, manifest)
        for d in drift:
            print(f"drift: {d}")
        if drift:
            print(f"kernel drift against {args.out}: rerun `python -m "
                  f"arrow_matrix_tpu_torch.analysis kernels` and commit "
                  f"the manifest")
            rc = 1
    else:
        print(f"manifest: {args.out}")
    print("kernel certification passed" if rc == 0
          else "KERNEL CERTIFICATION FAILED")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

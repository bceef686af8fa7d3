"""The ledger's record store: one append-only, schema-validated,
hash-chained JSONL file that is the sink of the port's measured numbers.

The port's copy of ``arrow_matrix_tpu/ledger/store.py``, with the same
schema, kinds, canonical JSON and hash chain, so one record gets the
same ``record_id`` in both packages and either package's
:meth:`Ledger.validate` accepts a store the other wrote.

Integrity model:

* **append-only by construction** — records are only ever appended
  (``utils/artifacts.append_jsonl``: serialized first, one write,
  flushed + fsync'd; a crash can tear at most the trailing line);
* **tamper-evident by hash chain** — every record's ``record_id`` is
  the sha256 of its own canonical JSON (sans the id field), and every
  record carries ``prev`` = the preceding record's id.  Editing any
  historical line breaks its own id; deleting or reordering one breaks
  the successor's ``prev`` link.  :meth:`Ledger.validate` walks the
  chain and reports every break;
* **versioned schema** — ``schema`` is checked per record; a record
  from another schema version is a validation problem, never a silent
  reinterpretation.

The port's default store is ``bench_results/ledger_torch/`` (listed in
``.gitignore``), never the JAX package's committed
``bench_results/ledger/``: the two systems' numbers stay apart.
``AMT_LEDGER_DIR`` overrides the directory and ``AMT_LEDGER=0``
disables the module-level :func:`record` hook, as in the JAX package.
A record measured on the card carries :func:`device_stamp`'s
``platform="gpu"`` and the card's name as ``device_kind``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Iterable, List, Optional

from arrow_matrix_tpu_torch.utils.artifacts import append_jsonl, locked_file

#: Bump when the record shape changes; old records then fail
#: validation LOUDLY instead of being silently reinterpreted.
SCHEMA_VERSION = 1

#: The emitter families.  A record's ``kind`` names which subsystem
#: measured it — the coarse query axis (``Ledger.query(kind=...)``).
KINDS = ("bench", "tune", "serve", "pulse", "ladder", "smoke",
         "error_curve", "probe", "fleet", "kcert", "xray", "lens")

DEFAULT_LEDGER_DIR = os.path.join("bench_results", "ledger_torch")
LEDGER_BASENAME = "ledger.jsonl"

#: Fields every record must carry, with their accepted types.  ``None``
#: inside a tuple marks the field as nullable.
_FIELD_TYPES: Dict[str, tuple] = {
    "schema": (int,),
    "kind": (str,),
    "record_id": (str,),
    "prev": (str, None),
    "ts_unix": (int, float),
    "metric": (str,),
    "value": (int, float, None),
    "unit": (str, None),
    "structure_hash": (str, None),
    "platform": (str, None),
    "device_kind": (str, None),
    "host_load": (int, float, None),
    "git_rev": (str, None),
    "knobs": (dict,),
    "payload": (dict,),
}


def ledger_dir(override: Optional[str] = None) -> str:
    """The store directory: explicit override, else ``AMT_LEDGER_DIR``,
    else ``bench_results/ledger_torch``."""
    if override:
        return override
    return os.environ.get("AMT_LEDGER_DIR", DEFAULT_LEDGER_DIR)


def ledger_path(directory: Optional[str] = None) -> str:
    return os.path.join(ledger_dir(directory), LEDGER_BASENAME)


def canonical_record_id(rec: Dict[str, Any]) -> str:
    """``"lr" + sha256(canonical JSON of the record minus record_id)``
    truncated to 16 hex chars.  ``prev`` IS part of the hashed content,
    so the ids form a chain: no historical line can change without
    breaking either its own id or its successor's ``prev``."""
    body = {k: v for k, v in rec.items() if k != "record_id"}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return "lr" + hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def schema_problems(rec: Any, index: Optional[int] = None) -> List[str]:
    """Structural problems of ONE record (empty = valid).  Pure
    function over the parsed object, shared by :meth:`Ledger.validate`
    and the readers of other stores."""
    where = f"record {index}" if index is not None else "record"
    if not isinstance(rec, dict):
        return [f"{where}: not a JSON object"]
    problems = []
    for field, types in _FIELD_TYPES.items():
        if field not in rec:
            problems.append(f"{where}: missing field {field!r}")
            continue
        v = rec[field]
        if v is None:
            if None not in types:
                problems.append(f"{where}: field {field!r} is null")
            continue
        # bool is an int subclass; a True value is never a number here.
        if isinstance(v, bool) or not isinstance(
                v, tuple(t for t in types if t is not None)):
            problems.append(
                f"{where}: field {field!r} has type "
                f"{type(v).__name__}, expected "
                f"{'/'.join(t.__name__ for t in types if t)}")
    if not problems:
        if rec["schema"] != SCHEMA_VERSION:
            problems.append(
                f"{where}: schema version {rec['schema']} != runtime "
                f"{SCHEMA_VERSION}")
        if rec["kind"] not in KINDS:
            problems.append(f"{where}: unknown kind {rec['kind']!r}")
    return problems


def _git_rev() -> Optional[str]:
    """The working tree's short revision, cached for the process.
    ``AMT_GIT_REV`` overrides (hermetic tests, exported environments);
    any git failure degrades to None — provenance, not a requirement."""
    env = os.environ.get("AMT_GIT_REV")
    if env is not None:
        return env or None
    global _GIT_REV_CACHE
    if _GIT_REV_CACHE is _UNSET:
        try:
            proc = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True, timeout=10)
            _GIT_REV_CACHE = (proc.stdout.strip()
                              if proc.returncode == 0
                              and proc.stdout.strip() else None)
        except (OSError, subprocess.SubprocessError):
            _GIT_REV_CACHE = None
    return _GIT_REV_CACHE


_UNSET = object()
_GIT_REV_CACHE: Any = _UNSET


def _default_host_load() -> Optional[float]:
    try:
        from arrow_matrix_tpu_torch.utils.platform import host_load

        return float(host_load()["loadavg_1m"])
    except (ImportError, KeyError, TypeError, ValueError, OSError):
        return None


class Ledger:
    """One JSONL store (see the module docstring for the contract)."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = ledger_dir(directory)
        self.path = ledger_path(directory)

    # -- writing -------------------------------------------------------

    def record(self, kind: str, metric: str,
               value: Optional[float] = None, *,
               unit: Optional[str] = None,
               structure_hash: Optional[str] = None,
               knobs: Optional[Dict[str, Any]] = None,
               payload: Optional[Dict[str, Any]] = None,
               platform: Optional[str] = None,
               device_kind: Optional[str] = None,
               host_load: Any = _UNSET,
               git_rev: Any = _UNSET,
               ts_unix: Optional[float] = None) -> Dict[str, Any]:
        """Append ONE record; returns it (with ``record_id`` set).

        ``host_load`` and ``git_rev`` default to live lookups (1-minute
        loadavg, ``git rev-parse``); pass an explicit value — including
        None — to pin them.  Raises ``ValueError`` on an invalid record
        (unknown kind, unserializable knobs/payload): a ledger line is
        a contract, not a log line.
        """
        # The prev-link read and the append are ONE critical section
        # under the cross-process advisory lock: two fleet workers
        # recording concurrently would otherwise both read the same
        # tail and fork the hash chain (one torn `prev` link).
        with locked_file(self.path):
            rec: Dict[str, Any] = {
                "schema": SCHEMA_VERSION,
                "kind": kind,
                "record_id": "",
                "prev": (self.last_record() or {}).get("record_id"),
                "ts_unix": round(time.time(), 3) if ts_unix is None
                else ts_unix,
                "metric": metric,
                "value": value,
                "unit": unit,
                "structure_hash": structure_hash,
                "platform": platform,
                "device_kind": device_kind,
                "host_load": (_default_host_load()
                              if host_load is _UNSET else host_load),
                "git_rev": _git_rev() if git_rev is _UNSET
                else git_rev,
                "knobs": dict(knobs or {}),
                "payload": dict(payload or {}),
            }
            rec["record_id"] = canonical_record_id(rec)
            problems = schema_problems(rec)
            if problems:
                raise ValueError(f"refusing to append an invalid "
                                 f"ledger record: {problems}")
            append_jsonl(self.path, rec, lock=False)
        return rec

    # -- reading -------------------------------------------------------

    def read_all(self) -> List[Dict[str, Any]]:
        """Every parseable record, in file order.  A torn TRAILING line
        (the one crash window the append contract allows) is skipped
        here and reported by :meth:`validate`."""
        records, _ = self._read_with_problems()
        return records

    def _read_with_problems(self):
        records: List[Dict[str, Any]] = []
        problems: List[str] = []
        if not os.path.exists(self.path):
            return records, problems
        with open(self.path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    problems.append(
                        f"line {i + 1}: torn trailing line (crash "
                        f"mid-append?) — truncate it to repair")
                else:
                    problems.append(f"line {i + 1}: unparseable (the "
                                    f"file was edited in place?)")
                continue
            records.append(rec)
        return records, problems

    def last_record(self) -> Optional[Dict[str, Any]]:
        records = self.read_all()
        return records[-1] if records else None

    def query(self, *, kind: Optional[str] = None,
              metric: Optional[str] = None,
              structure_hash: Optional[str] = None,
              platform: Optional[str] = None
              ) -> List[Dict[str, Any]]:
        out = []
        for rec in self.read_all():
            if not isinstance(rec, dict):
                continue
            if kind is not None and rec.get("kind") != kind:
                continue
            if metric is not None and rec.get("metric") != metric:
                continue
            if (structure_hash is not None
                    and rec.get("structure_hash") != structure_hash):
                continue
            if platform is not None and rec.get("platform") != platform:
                continue
            out.append(rec)
        return out

    # -- integrity -----------------------------------------------------

    def validate(self) -> List[str]:
        """Every schema and chain problem in the store (empty = clean).
        The append-only promise is verified, not assumed: a rewritten
        line fails its own id, a removed/reordered line breaks the
        successor's ``prev`` link."""
        records, problems = self._read_with_problems()
        prev_id: Optional[str] = None
        for i, rec in enumerate(records):
            problems += schema_problems(rec, index=i)
            if not isinstance(rec, dict):
                prev_id = None
                continue
            claimed = rec.get("record_id")
            if isinstance(claimed, str):
                expect = canonical_record_id(rec)
                if claimed != expect:
                    problems.append(
                        f"record {i}: record_id {claimed} does not "
                        f"match its content (expected {expect}) — the "
                        f"line was edited in place")
            if rec.get("prev") != prev_id:
                problems.append(
                    f"record {i}: prev={rec.get('prev')} breaks the "
                    f"chain (expected {prev_id}) — a record was "
                    f"removed, reordered, or appended out of band")
            prev_id = claimed if isinstance(claimed, str) else None
        return problems


def bench_metric(metric: str, config: Optional[Dict[str, Any]]) -> str:
    """The metric name for a bench record: the problem shape rides in
    the name (``spmm_iter_ms_n1048576_w2048``) because bench records
    carry no structure hash — without the shape in the key, rounds
    measured at different scales would share one drift band and the
    gate would flag growth as regression."""
    cfg = config or {}
    n, width = cfg.get("n"), cfg.get("width")
    if n and width:
        return f"{metric}_n{n}_w{width}"
    return metric


def device_stamp(device=None) -> Dict[str, str]:
    """The ``platform`` and ``device_kind`` of a record measured on
    ``device`` (a ``torch.device`` or its name): ``"gpu"`` and
    ``torch.cuda.get_device_name`` on a card, ``"cpu"`` twice on the
    host."""
    import torch

    dev = torch.device(device) if device is not None else torch.device(
        "cpu")
    if dev.type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "device_kind": "cpu"}


def default_ledger() -> Ledger:
    return Ledger()


def record(kind: str, metric: str, value: Optional[float] = None,
           directory: Optional[str] = None,
           **kwargs) -> Optional[Dict[str, Any]]:
    """Module-level emitter hook: append to the DEFAULT store
    (``AMT_LEDGER_DIR`` / ``bench_results/ledger_torch``), or to an explicit
    ``directory`` (smoke runs pass a run-dir-local store so gates and
    tests never dirty the committed ledger).  ``AMT_LEDGER=0``
    disables it (returns None).  Emitters call this at the end of a
    measurement; a failure to persist is reported to stderr and
    returns None — telemetry must never take down the run that
    produced the number."""
    if os.environ.get("AMT_LEDGER", "1") == "0":
        return None
    try:
        return Ledger(directory).record(kind, metric, value, **kwargs)
    except (OSError, ValueError, TypeError) as e:
        print(f"[ledger] failed to append {kind}/{metric} record: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return None


def records_from(paths_or_records: Iterable[Any]) -> List[Dict[str, Any]]:
    """Normalize a mixed list of record dicts / ledger paths into one
    record list (gate + CLI helper)."""
    out: List[Dict[str, Any]] = []
    for item in paths_or_records:
        if isinstance(item, dict):
            out.append(item)
        else:
            lg = Ledger(os.path.dirname(str(item))) \
                if str(item).endswith(".jsonl") else Ledger(str(item))
            if str(item).endswith(".jsonl"):
                lg.path = str(item)
            out.extend(lg.read_all())
    return out

"""Shared predicates and writers of JSON artifacts.

The port's copy of ``arrow_matrix_tpu/utils/artifacts.py``: the one
definition of "the last line of a run's output is its record"
(``parse_last_json_line``), of whether a record was taken on the
accelerator (``record_is_onchip``: unless it says ``degraded`` or
``platform == "cpu"``, so a ``cuda``/``gpu`` line counts as on the
card), of the three-way artifact verdict, and of atomic and appending
JSON writes with their advisory file lock.

The contract:

* an artifact is on-chip evidence unless it is EXPLICITLY
  disqualified — ``degraded`` truthy or ``platform == "cpu"``.  A
  missing ``platform`` field qualifies;
* a missing or unreadable artifact is its own third state
  (``"missing"``), never conflated with "proven degraded".
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
from typing import Any, Optional

try:                            # POSIX; absent on some platforms —
    import fcntl                # locking degrades to a no-op there
except ImportError:             # pragma: no cover
    fcntl = None


#: Filename markers of throwaway verification artifacts.  A smoke run
#: exercising the bench pipeline tags its output (e.g.
#: ``onchip_bench_quick_VERIFYDRIVE.json``); such files are not
#: evidence and must never satisfy an evidence scan, whatever their
#: record says.
STRAY_MARKERS = ("VERIFYDRIVE", "SMOKETEST", "DRYRUN")


def is_stray_verification_artifact(path: str) -> bool:
    """True when the artifact's NAME marks it as verification exhaust
    (see ``STRAY_MARKERS``) — checked case-insensitively against the
    basename so a stray file can't pass as round evidence regardless
    of its payload."""
    base = os.path.basename(path).upper()
    return any(m in base for m in STRAY_MARKERS)


def record_is_onchip(d: dict) -> bool:
    """True unless the record EXPLICITLY disqualifies itself: a truthy
    ``degraded`` flag or ``platform == "cpu"``.  Unlabeled records
    qualify (pre-platform-label artifacts were all real-chip)."""
    return not d.get("degraded") and d.get("platform") != "cpu"


def parse_last_json_line(text: str) -> Optional[dict]:
    """Parse the LAST line of ``text`` as a JSON object (bench children
    and JSON-lines artifacts both commit their record as the final
    line; anything above it — warnings, progress chatter — is noise).
    None when the text is empty, the last line is not JSON, or it is
    JSON but not an object — the caller decides what absence means."""
    try:
        d = json.loads(text.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError, AttributeError,
            TypeError):
        return None
    return d if isinstance(d, dict) else None


def load_last_json_line(path: str) -> Optional[dict]:
    """File-backed :func:`parse_last_json_line`: read ``path`` and
    parse its last line.  None on any read/parse failure."""
    try:
        with open(path, encoding="utf-8") as fh:
            return parse_last_json_line(fh.read())
    except (OSError, UnicodeDecodeError):
        return None


# ---------------------------------------------------------------------------
# Atomic JSON persistence.  The crash-window contract:
#
# * serialization happens BEFORE the target is touched — an
#   unserializable object leaves the existing artifact intact;
# * the tmp file lives in the target's directory (os.replace must not
#   cross filesystems) with a pid+thread-unique name, is flushed and
#   fsync'd before the rename, and the DIRECTORY is fsync'd after it —
#   the rename itself is not durable until the directory entry is;
# * any failure removes the tmp file and re-raises: the caller decides
#   whether persistence is best-effort or mandatory.


def _fsync_dir(directory: str) -> None:
    """Flush a directory entry (the rename durability half of an
    atomic write).  Platforms whose directories cannot be opened
    (Windows) skip — there the rename atomicity is all we get."""
    try:
        fd = os.open(directory or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj: Any, *, indent=None,
                      sort_keys: bool = False,
                      fsync: bool = True) -> str:
    """Atomically (and, by default, durably) write ``obj`` as JSON to
    ``path``; returns ``path``.  See the module comment for the
    crash-window contract.  ``fsync=False`` keeps the atomicity (a
    reader never sees a torn file) but trades the power-cut durability
    for speed — appropriate for high-frequency telemetry rewrites."""
    text = json.dumps(obj, indent=indent, sort_keys=sort_keys)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=d or ".",
        prefix=f".{os.path.basename(path)}.{os.getpid()}."
               f"{threading.get_ident()}.",
        suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            fh.write(text)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(d)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def flock_acquire(handle, *, shared: bool = False,
                  nonblocking: bool = False) -> bool:
    """The package's one ``fcntl.flock`` call: ``handle`` is a file
    object or fd; returns whether the lock was taken (always True for a
    blocking acquire, and trivially True where ``fcntl`` is absent —
    locking degrades to a no-op there).  A nonblocking miss returns
    False instead of raising.  The lock is released when the handle is
    closed."""
    if fcntl is None:           # pragma: no cover
        return True
    flags = fcntl.LOCK_SH if shared else fcntl.LOCK_EX
    if nonblocking:
        flags |= fcntl.LOCK_NB
    try:
        fcntl.flock(handle, flags)  # graft-sync: flock-primitive
    except OSError:
        if nonblocking:
            return False
        raise
    return True


@contextlib.contextmanager
def locked_file(path: str):
    """Advisory cross-process exclusive lock scoped to ``path``:
    ``fcntl.flock`` on a sidecar ``<path>.lock`` file, so N processes
    mutating one shared artifact (a merge-write, an append) serialize instead of losing each other's updates.  The sidecar
    (not the artifact itself) is locked because the artifact is
    replaced by ``os.replace`` during atomic writes, which would
    orphan a lock held on the old inode.

    NOT reentrant: flock blocks between file descriptors even within
    one process, so a holder must not re-acquire (``append_jsonl``'s
    ``lock=False`` exists for exactly that).  On platforms without
    ``fcntl`` this degrades to a no-op — single-process behavior
    there is unchanged.
    """
    if fcntl is None:           # pragma: no cover
        yield
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        flock_acquire(fd)
        yield
    finally:
        os.close(fd)            # close releases the flock


def append_jsonl(path: str, obj: Any, *, fsync: bool = True,
                 lock: bool = True) -> str:
    """Append ``obj`` as one JSON line to ``path`` (created if absent);
    returns the serialized line.  The line is serialized before the
    file is opened and written in one call, then flushed and fsync'd —
    a crash can tear at most the line being appended (trailing partial
    line), never an earlier record.  The write holds the :func:`locked_file`
    advisory lock so two processes cannot interleave partial lines;
    callers already inside the lock pass ``lock=False``."""
    line = json.dumps(obj, sort_keys=False,
                      separators=(",", ":")) + "\n"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    ctx = locked_file(path) if lock else contextlib.nullcontext()
    with ctx:
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(line)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
    return line


def classify_artifact(path: str) -> str:
    """Three-way artifact verdict: ``"onchip"`` (readable record, not
    disqualified), ``"degraded"`` (readable record with an explicit
    CPU/degraded label), or ``"missing"`` (no file / unreadable /
    unparseable — retriable, NOT evidence of a dead card).  A stray
    verification artifact (``is_stray_verification_artifact``)
    classifies as ``"missing"``: it is not evidence either way."""
    if is_stray_verification_artifact(path):
        return "missing"
    if not os.path.exists(path):
        return "missing"
    d = load_last_json_line(path)
    if d is None:
        return "missing"
    return "onchip" if record_is_onchip(d) else "degraded"

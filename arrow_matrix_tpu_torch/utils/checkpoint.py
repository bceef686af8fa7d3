"""Iteration-state checkpoint and resume of the supervised loops.

The port's copy of ``arrow_matrix_tpu/utils/checkpoint.py``, in its
``.npz`` form: ``{x, step, version, layout}`` written atomically, a
sha256 sidecar (``.npz.sha256``) checked on load, and a format version
and layout tag that make a resume under another execution mode fail
loudly instead of silently permuting rows.  Files written by either
package load in the other when the carriage has the same layout: the
per-level formats carry ``(total_rows, k)`` in both.  The fold does
not: the port carries it row-major ``(total_rows, k)``, the JAX package
feature-major ``(k, positions)``, so a fold checkpoint that crosses
packages fails the shape check (and says so); it is never loaded
transposed.

The JAX writer uses orbax when it is installed; an orbax directory
raises here with a message naming the format.  A bfloat16 carriage is
stored as the reference stores it, its 16-bit patterns as 2-byte void
(``|V2``); the older port form (int16 patterns and an ``x_dtype`` key)
still loads.

On a mesh of ranks (``mesh=``, one process a shard) the carriage is
sharded by rows over the mesh's block axis.  Saving all-gathers it
over that axis (the collective of ``parallel/mesh.fetch_replicated``,
kept on the device so a bf16 carriage keeps its bits); the mesh's first
rank writes the
npz and its sidecar, and the write's outcome is shared with every rank
through a counted collective, so a failed writer fails every rank and
no rank is left waiting.  Loading reads the file on every rank (a
shared filesystem is assumed, as in the JAX package) and keeps the
rank's own rows; the ranks agree that each found the same file.  The
callers' layout tags name the rank count, so a resume on another mesh
fails loudly.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

# Checkpoint format version: bump when the saved state's meaning
# changes.  Version 1 adds the version + layout tags themselves;
# untagged checkpoints (version 0) still load but cannot be
# layout-verified.
CHECKPOINT_VERSION = 1


class CheckpointIntegrityError(RuntimeError):
    """The checkpoint's bytes do not match its sha256 sidecar: the
    state on disk was corrupted after it was written (bit rot, a torn
    concurrent writer, an injected ``corrupt`` fault).  Loading it
    would silently poison every subsequent iteration; callers either
    fail loudly (the batch CLI) or discard the checkpoint and recompute
    (the server)."""


def _meta_path(path: str) -> str:
    return path + ".meta.json"


def _write_meta(path: str, step: int, layout: Optional[str]) -> None:
    meta = {"version": CHECKPOINT_VERSION, "step": int(step),
            "layout": layout}
    tmp = _meta_path(path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(meta, fh)
    os.replace(tmp, _meta_path(path))


def _read_meta(path: str) -> Optional[dict]:
    try:
        with open(_meta_path(path), encoding="utf-8") as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None
    except (ValueError, OSError) as e:
        # A malformed/unreadable sidecar degrades the checkpoint to
        # legacy (unverifiable) status with a loud warning — it must
        # never turn a loadable state into a crash.
        print(f"[checkpoint] WARNING: metadata at {_meta_path(path)} "
              f"is unreadable ({type(e).__name__}: {e}); treating the "
              f"checkpoint as legacy/untagged", file=sys.stderr)
        return None


def list_checkpoints(ckpt_dir: str, prefix: str = "ck_") -> list:
    """Stems of every checkpoint under ``ckpt_dir`` with ``prefix``
    (``.npz`` files, and the JAX package's orbax directories, which
    :func:`load_state` refuses by name), sorted.  A stem is what
    ``load_state``/``save_state`` take as ``path``."""
    stems = set()
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return []
    for e in entries:
        p = os.path.join(ckpt_dir, e)
        if not e.startswith(prefix):
            continue
        if e.endswith(".npz"):
            stems.add(p[: -len(".npz")])
        elif os.path.isdir(p):
            stems.add(p)
    return sorted(stems)


def checkpoint_layout_tag(path: str) -> Optional[str]:
    """The layout tag the checkpoint at ``path`` (a stem) was saved
    with, without loading the state; None for untagged/legacy."""
    path = os.path.abspath(path)
    meta = _read_meta(path)
    if meta is not None:
        return meta.get("layout") or None
    npz = path + ".npz"
    if os.path.exists(npz):
        try:
            with np.load(npz) as z:
                if "layout" in z.files:
                    return str(z["layout"]) or None
        except (OSError, ValueError):
            return None
    return None


def _sha_path(npz_path: str) -> str:
    return npz_path + ".sha256"


def _file_sha256(p: str) -> str:
    h = hashlib.sha256()
    with open(p, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_sha(npz_path: str) -> None:
    tmp = _sha_path(npz_path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(_file_sha256(npz_path) + "\n")
    os.replace(tmp, _sha_path(npz_path))


def _verify_sha(npz_path: str) -> None:
    """Raise :class:`CheckpointIntegrityError` when the npz bytes do
    not match the sha256 sidecar; a missing/unreadable sidecar skips
    the check (pre-sidecar checkpoints keep loading)."""
    try:
        with open(_sha_path(npz_path), encoding="utf-8") as fh:
            want = fh.read().strip()
    except (FileNotFoundError, OSError):
        return
    if not want:
        return
    got = _file_sha256(npz_path)
    if got != want:
        raise CheckpointIntegrityError(
            f"checkpoint {npz_path} fails sha256 verification "
            f"(sidecar records {want[:12]}..., file hashes "
            f"{got[:12]}...) — the state on disk was corrupted after "
            f"it was written; delete it (and its .sha256 sidecar) to "
            f"recompute from scratch")


def checkpoint_meta(path: str) -> Optional[dict]:
    """Best-effort ``{"version", "step", "layout"}`` of the checkpoint
    at ``path`` without loading the state, or None when absent or
    unreadable.  Pre-version (legacy) npz checkpoints report
    ``version: 0`` — callers warn loudly and skip layout verification
    instead of crashing (the server's resume contract)."""
    path = os.path.abspath(path)
    try:
        if os.path.isdir(path):
            return _read_meta(path)
        if os.path.exists(path + ".npz"):
            with np.load(path + ".npz") as z:
                if "version" not in z.files:
                    return {"version": 0, "step": int(z["step"]),
                            "layout": None}
                layout = (str(z["layout"]) if "layout" in z.files
                          else "")
                return {"version": int(z["version"]),
                        "step": int(z["step"]),
                        "layout": layout or None}
    except Exception as e:  # noqa: BLE001 — metadata probing must not
        # crash the resume path; the load itself still verifies.
        print(f"[checkpoint] WARNING: cannot read metadata of {path} "
              f"({type(e).__name__}: {e})", file=sys.stderr)
        return None
    return None


def _check_meta(path: str, meta: Optional[dict],
                layout: Optional[str]) -> None:
    """Fail loudly on a version or layout mismatch; tolerate untagged
    (pre-version) checkpoints so old artifacts keep loading."""
    if meta is None:
        return
    version = int(meta.get("version", 0))
    if version > CHECKPOINT_VERSION:
        raise RuntimeError(
            f"checkpoint at {path} has format version {version}, this "
            f"build understands <= {CHECKPOINT_VERSION} — refusing to "
            f"reinterpret a newer checkpoint")
    saved_layout = meta.get("layout")
    if layout is not None and saved_layout is not None \
            and saved_layout != layout:
        raise RuntimeError(
            f"checkpoint at {path} was written with layout "
            f"{saved_layout!r} but the resuming executor carries X as "
            f"{layout!r} — resuming would silently permute rows; "
            f"rebuild the executor with the checkpointing mode or "
            f"delete the checkpoint")


def _orbax_dir(path: str) -> None:
    if os.path.isdir(path):
        raise RuntimeError(
            f"checkpoint at {path} is an orbax directory (the JAX "
            f"package's format when orbax is installed); the port reads "
            f"and writes the npz form only — resume with the JAX "
            f"package, or delete the directory to recompute")


#: A bf16 array on disk: 16-bit patterns as 2-byte void (``|V2``).
_BF16_VOID = np.dtype("V2")


def _write_npz(path: str, arr: np.ndarray, step: int,
               layout: Optional[str]) -> None:
    """The npz, atomically, then its sha256 sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, x=arr, step=np.int64(step),
             version=np.int64(CHECKPOINT_VERSION),
             layout=np.str_(layout or ""))
    os.replace(tmp, path + ".npz")
    # The sidecar AFTER the npz replace: a crash between the two leaves
    # a stale sidecar that fails verification loudly, never a silently
    # wrong state.
    _write_sha(path + ".npz")


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        # The reference's on-disk form of a bf16 array: its 16-bit
        # patterns as 2-byte void, which no loader casts to numbers.
        return t.view(torch.int16).cpu().numpy().view(_BF16_VOID)
    return t.cpu().numpy()


def save_state(path: str, x: torch.Tensor, step: int,
               layout: Optional[str] = None, mesh=None,
               axis: str = "blocks") -> None:
    """Write ``{x, step}`` to ``path + ".npz"`` atomically, then its
    sha256 sidecar.  ``layout`` tags how X is carried (e.g.
    ``"serve/r0001/k16/it10"``); :func:`load_state` verifies it.

    ``mesh``: ``x`` is this rank's rows of a carriage sharded over
    ``axis`` (module docstring); every rank of the mesh calls it."""
    if isinstance(x, tuple):
        raise ValueError("the int8 (q, scale) carriage has no checkpoint "
                         "form; checkpoint an f32 or bf16 carriage")
    path = os.path.abspath(path)
    _orbax_dir(path)
    if mesh is None:
        _write_npz(path, _host_array(x), step, layout)
        return
    from arrow_matrix_tpu_torch.parallel import collectives as coll

    mesh.require_member()
    full = coll.all_gather(x.detach().contiguous(), mesh, axis)
    write_err: Optional[BaseException] = None
    if mesh.rank == mesh.ranks[0]:                 # one writer
        try:
            _write_npz(path, _host_array(full), step, layout)
        except Exception as e:   # noqa: BLE001 — any failure of the
            # writer must still reach the agreement below, or every
            # other rank waits in a collective the writer never joins.
            write_err = e
    # The outcome, shared: it doubles as the barrier after which any
    # rank may read the file.
    if coll.all_reduce_max(int(write_err is not None), mesh, None):
        raise RuntimeError(
            f"checkpoint write of {path} (step {step}) failed on rank "
            f"{mesh.ranks[0]}, the mesh's writer"
            + (f": {type(write_err).__name__}: {write_err}"
               if write_err is not None else "")) from write_err


def _read_npz(path: str, layout: Optional[str]):
    """``(array, step, bf16)`` of the npz at ``path``, verified."""
    _verify_sha(path + ".npz")
    with np.load(path + ".npz") as z:
        meta = None
        if "version" in z.files:
            saved_layout = str(z["layout"]) if "layout" in z.files else ""
            meta = {"version": int(z["version"]),
                    "layout": saved_layout or None}
        _check_meta(path, meta, layout)
        arr, step = np.array(z["x"]), int(z["step"])
        # Older port files carry bf16 as int16 patterns plus x_dtype.
        legacy = "x_dtype" in z.files and str(z["x_dtype"]) == "bfloat16"
    bf16 = legacy or arr.dtype == _BF16_VOID
    if arr.dtype == _BF16_VOID:
        arr = arr.view(np.int16)
    return arr, step, bf16


def load_state(path: str, like: Optional[torch.Tensor] = None,
               layout: Optional[str] = None, mesh=None,
               axis: str = "blocks"):
    """Read ``(x, step)`` from ``path``; None when there is none.

    ``like`` (the resuming executor's fresh carriage) gives the expected
    shape, dtype and device: a different shape raises (an executor built
    differently, or a fold checkpoint of the other package, must not
    reinterpret rows).  ``layout`` is verified against the saved tag;
    untagged checkpoints skip the check.  Without ``like`` the state
    comes back as a CPU tensor.

    ``mesh``: every rank of the mesh reads the file and keeps its own
    rows over ``axis`` (``like`` is its rows); a rank that finds no file
    or fails while the others read one raises on every rank."""
    path = os.path.abspath(path)
    _orbax_dir(path)
    if mesh is not None:
        return _load_on_mesh(path, like, layout, mesh, axis)
    if not os.path.exists(path + ".npz"):
        return None
    arr, step, bf16 = _read_npz(path, layout)
    return _as_state(path, arr, step, bf16, like, layout)


def _as_state(path, arr, step, bf16, like, layout):
    x = torch.from_numpy(arr)
    if bf16:
        x = x.view(torch.bfloat16)
    if like is not None:
        if tuple(x.shape) != tuple(like.shape):
            turned = (x.dim() == 2
                      and tuple(x.shape) == tuple(like.shape)[::-1])
            raise ValueError(
                f"checkpoint X has shape {tuple(x.shape)}, executor "
                f"expects {tuple(like.shape)}"
                + (" — the transposed layout: a fold checkpoint of the "
                   "other package (feature-major (k, positions) against "
                   "the port's row-major (total_rows, k)); it is never "
                   "loaded transposed" if turned else "")
                + " — resume with the same mode/format the checkpoint "
                  "was written with")
        x = x.to(device=like.device, dtype=like.dtype)
    from arrow_matrix_tpu_torch.obs import flight

    flight.record("heal", "resumed", path=path, step=step, layout=layout)
    return x, step


def _load_on_mesh(path, like, layout, mesh, axis):
    from arrow_matrix_tpu_torch.parallel import collectives as coll

    mesh.require_member()
    n_dev = mesh.shape[axis]
    got, err = None, None
    try:
        if os.path.exists(path + ".npz"):
            arr, step, bf16 = _read_npz(path, layout)
            rows = (like.shape[0] if like is not None
                    else arr.shape[0] // n_dev)
            if like is not None and (arr.shape[0] != rows * n_dev
                                     or arr.shape[1:] != like.shape[1:]):
                raise ValueError(
                    f"checkpoint X has shape {arr.shape}, the executor "
                    f"carries {rows * n_dev} rows of {tuple(like.shape[1:])}"
                    f" over {n_dev} ranks ({tuple(like.shape)} a rank) — "
                    f"a carriage of another mesh or mode; resume with the "
                    f"rank count and format it was written with")
            i = mesh.axis_index(axis)
            got = (np.ascontiguousarray(arr[i * rows:(i + 1) * rows]),
                   step, bf16)
    except Exception as e:   # noqa: BLE001 — shared below, then raised
        err = e
    # 0: found, 1: none, 2: failed; the ranks must agree.
    mine = 2 if err is not None else 0 if got is not None else 1
    worst = coll.all_reduce_max(mine, mesh, None)
    least = -coll.all_reduce_max(-mine, mesh, None)
    if err is not None:
        raise err
    if worst == 2:
        raise RuntimeError(f"checkpoint {path} failed to load on another "
                           f"rank of the mesh")
    if worst != least:
        raise RuntimeError(
            f"checkpoint {path} is present on some ranks of the mesh and "
            f"absent on others: the ranks need one shared filesystem")
    if got is None:
        return None
    part = (None if like is None else
            torch.empty(like.shape, dtype=like.dtype, device=like.device))
    return _as_state(path, got[0], got[1], got[2], part, layout)

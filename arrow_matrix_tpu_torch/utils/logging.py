"""Named-segment timing log with a file sink.

The port's copy of ``arrow_matrix_tpu/utils/logging.py``: every layer
appends named wall-clock measurements with ``log({...})`` or
``segment(name)``; ``finish()`` writes them to
``./logs/{algorithm}.{dataset}.{uuid}.{json,txt}``; ``log_local_runs``
uploads finished runs to wandb when it is installed (and lists them
otherwise), under an exclusive lock file.

Device time is the CUDA events' (``utils/timing.py``), not these host
segments; ``trace()`` takes a ``torch.profiler`` trace of the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any


@dataclass
class SegmentLog:
    """In-memory list of measurement dicts merged with iteration context."""

    algorithm: str = "arrow_tpu"
    dataset: str = "unknown"
    config: dict = field(default_factory=dict)
    entries: list = field(default_factory=list)
    _iteration_data: dict = field(default_factory=dict)

    def set_iteration_data(self, data: dict) -> None:
        self._iteration_data = dict(data)

    def log(self, measurements: dict) -> None:
        entry = dict(self._iteration_data)
        entry.update(measurements)
        self.entries.append(entry)

    @contextlib.contextmanager
    def segment(self, name: str):
        """Context manager timing a named host-side segment in seconds.
        Logs in ``finally`` so a raising body still records the
        measurement (the time-to-failure is part of the run record)."""
        tic = time.perf_counter()
        try:
            yield
        finally:
            self.log({name: time.perf_counter() - tic})

    def finish(self, log_dir: str = "./logs") -> str | None:
        if not self.entries and not self.config:
            return None
        os.makedirs(log_dir, exist_ok=True)
        run_id = uuid.uuid4().hex[:12]
        base = os.path.join(log_dir, f"{self.algorithm}.{self.dataset}.{run_id}")
        with open(base + ".json", "w") as f:
            json.dump({"algorithm": self.algorithm, "dataset": self.dataset,
                       "config": self.config, "entries": self.entries}, f, indent=1)
        with open(base + ".txt", "w") as f:
            f.write(f"{self.algorithm} {self.dataset}\n{self.config}\n")
            for e in self.entries:
                f.write(f"{e}\n")
        return base

    def summarize(self) -> dict[str, dict[str, float]]:
        """Per-segment mean/min/max/count over all entries."""
        stats: dict[str, list[float]] = {}
        for e in self.entries:
            for k, v in e.items():
                if isinstance(v, (int, float)) and k != "iteration":
                    stats.setdefault(k, []).append(float(v))
        return {
            k: {"mean": sum(v) / len(v), "min": min(v), "max": max(v),
                "count": len(v)}
            for k, v in stats.items()
        }


_GLOBAL = SegmentLog()


def get_log() -> SegmentLog:
    return _GLOBAL


def init(algorithm: str, dataset: str, config: dict | None = None) -> SegmentLog:
    """Reset the global log for a new run."""
    global _GLOBAL
    _GLOBAL = SegmentLog(algorithm=algorithm, dataset=dataset,
                         config=dict(config or {}))
    return _GLOBAL


def log(measurements: dict) -> None:
    _GLOBAL.log(measurements)


def set_iteration_data(data: dict) -> None:
    _GLOBAL.set_iteration_data(data)


def finish(log_dir: str = "./logs") -> str | None:
    return _GLOBAL.finish(log_dir)


def segment(name: str):
    return _GLOBAL.segment(name)


class ProfilerTraceEmpty(RuntimeError):
    """A profile of a CUDA device ended holding no device kernel event:
    the profiler did not trace the card, and a CPU-only trace would
    pass for a device timeline."""


@dataclass
class ProfileTrace:
    """What :func:`trace` captured: the Chrome trace's ``path``, the
    device kernel events (``name``, ``ts``, ``dur`` in us), the memory
    copies and sets on the device, the host annotations (the tracer's
    span names), and the host wall time of the window in us (from entry
    to the device synchronize at exit)."""

    device: Any
    path: str = ""
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    annotations: list = field(default_factory=list)
    wall_us: float = 0.0


@contextlib.contextmanager
def trace(log_dir: str = "./traces", device=None):
    """Device-side profiling: a ``torch.profiler.profile`` context that
    writes a Chrome trace (Perfetto) under ``log_dir`` on exit.

    The counterpart of the reference's ``jax.profiler.trace`` context.
    On the card (the default) it records CPU and CUDA activity, waits
    for the device at exit, and raises :class:`ProfilerTraceEmpty` when
    the profile holds no device kernel event; it never stands in a
    CPU-only trace for a device one.  ``device="cpu"`` records the host
    alone.  Yields a :class:`ProfileTrace`, filled at exit.

    Usage: ``with trace("./traces") as t: multi.step(x)``.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from arrow_matrix_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = ProfileTrace(device=dev)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        tic = time.perf_counter()
        yield out
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.wall_us = (time.perf_counter() - tic) * 1e6
    out.path = os.path.join(
        log_dir, f"trace.{os.getpid()}.{uuid.uuid4().hex[:8]}.json")
    prof.export_chrome_trace(out.path)
    with open(out.path, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        rec = {"name": e.get("name", ""), "ts": float(e.get("ts", 0.0)),
               "dur": float(e.get("dur", 0.0))}
        if cat == "kernel":
            out.kernels.append(rec)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            out.copies.append(rec)
        elif cat == "user_annotation":
            out.annotations.append(rec["name"])
    if dev.type == "cuda" and not out.kernels:
        raise ProfilerTraceEmpty(
            f"torch.profiler traced {dev} but recorded no device kernel "
            f"event ({len(events)} events, written to {out.path}); the "
            f"profiler's CUDA tracing (CUPTI) is not working here")


def _acquire_lock(lock_path: str, attempts: int = 20,
                  stale_s: float = 600.0) -> bool:
    """Exclusive-create lockfile with randomized exponential backoff,
    serializing uploads of jobs that share a filesystem.  A lock older than
    ``stale_s`` is treated as abandoned (holder killed before its
    cleanup ran) and broken."""
    import random

    delay = 0.1
    for _ in range(attempts):
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            try:
                if time.time() - os.path.getmtime(lock_path) > stale_s:
                    # Claim the stale lock by atomic rename: exactly one
                    # contender wins (unlinking in place would race —
                    # a second contender could remove the winner's
                    # *fresh* lock).  Losers fall through to backoff.
                    claimed = f"{lock_path}.stale.{uuid.uuid4().hex}"
                    try:
                        os.rename(lock_path, claimed)
                    except OSError:
                        pass
                    else:
                        os.unlink(claimed)
                        continue
            except OSError:
                pass  # holder released it between the checks
            time.sleep(delay * (1.0 + random.random()))
            delay = min(delay * 2, 5.0)
    return False


def log_local_runs(log_dir: str = "./logs") -> list[str]:
    """Upload offline run files to wandb, marking each with a
    ``.logged`` indicator so reruns skip it.

    Without wandb installed, lists the pending runs and uploads
    nothing (the files are the record either way).
    Returns the list of run base paths uploaded (or pending, when
    wandb is absent).
    """
    try:
        import wandb
    except ImportError:
        wandb = None

    handled = []
    for name in sorted(os.listdir(log_dir)):
        if not name.endswith(".json"):
            continue
        base = os.path.join(log_dir, name[:-len(".json")])
        indicator = base + ".logged"
        if os.path.exists(indicator):
            continue
        with open(base + ".json") as f:
            run = json.load(f)
        if not run.get("entries"):
            continue
        if wandb is None:
            print(f"pending (wandb not installed): {base}")
            handled.append(base)
            continue
        lock = os.path.join(log_dir, ".wandb.lock")
        if not _acquire_lock(lock):
            print(f"could not acquire wandb lock for {base}; retry later")
            continue
        try:
            # One run's upload failure must not abort the remaining
            # runs; it stays un-marked so the next invocation retries.
            try:
                wandb.init(project="spmm-tpu", name=run["algorithm"],
                           config=run.get("config", {}),
                           tags=[run["algorithm"], run["dataset"]])
                for item in run["entries"]:
                    wandb.log(item)
            except Exception as e:
                print(f"upload failed for {base}: {e}")
                continue
            finally:
                try:
                    wandb.finish()
                except Exception:  # graft-lint: disable=R8 — best effort
                    pass
            with open(indicator, "w"):
                pass
            handled.append(base)
        finally:
            os.unlink(lock)
    return handled


def block_until_ready(x: Any) -> Any:
    """Wait until the work that produces ``x`` has finished: a CUDA
    tensor (or a tuple or list holding one) synchronizes its device;
    anything else is returned as it is."""
    import torch

    items = x if isinstance(x, (tuple, list)) else (x,)
    for t in items:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
    return x

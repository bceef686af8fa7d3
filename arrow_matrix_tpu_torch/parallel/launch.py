"""Starting the ranks of a mesh job.

:func:`spawn` runs ``fn(mesh_ctx, *args)`` on ``world`` ranks, one
spawned process each, which meet through a ``FileStore`` in a fresh
directory (no fixed port: many jobs may start at once on one machine).
Each rank joins the default group with a timeout, runs the function and
sends its result back.  A rank that raises, or exits, makes the
launcher stop its siblings and raise: a failing rank ends the whole job
with an error, and no rank is left waiting in a collective (each group
has its own timeout, and the launcher's join has one).

:class:`RankPool` keeps ``world`` such ranks alive and feeds them jobs,
so a test module starts its ranks once.  A job is named by its module
and function (imported in each rank) and gets the rank's
:class:`RankContext`.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import torch

from arrow_matrix_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    check_backend,
    default_backend,
    init_distributed,
    rank_device,
    set_rank_device,
)


@dataclass
class RankContext:
    """What a job gets in its rank: the rank, the world, the device and
    the backend (build meshes with ``parallel.mesh.make_mesh``)."""

    rank: int
    world: int
    device: torch.device
    backend: str


def resolve_launch(world: int, backend: Optional[str], device) -> tuple:
    """(backend, device kind) of a launch: the CPU when asked for, else
    the card; the backend defaults to nccl on the card (gloo when the
    world is larger than the card count must be asked for) and gloo on
    the CPU.  Raises for a combination that cannot run."""
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        dev = rank_device(0, device)
    backend = backend or default_backend(dev)
    check_backend(backend, dev, world)
    return backend, dev.type


def _rank_main(rank: int, world: int, backend: str, kind: str,
               store_path: str, timeout_s: float, threads: Optional[int],
               conn) -> None:
    """A spawned rank: join, then run the jobs sent on ``conn`` until a
    ``None`` job; each answer is ``("ok", result)`` or ``("error",
    traceback text)``."""
    import torch.distributed as dist

    # Unless told, the ranks share the machine's cores.
    torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // world))
    dev = rank_device(rank, "cpu" if kind == "cpu" else None)
    set_rank_device(dev)
    store = dist.FileStore(store_path, world)
    try:
        init_distributed(rank, world, backend, dev, store=store,
                         timeout_s=timeout_s)
        ctx = RankContext(rank, world, dev, backend)
        while True:
            job = conn.recv()
            if job is None:
                break
            module, name, args = job
            try:
                fn = getattr(importlib.import_module(module), name)
                conn.send(("ok", fn(ctx, *args)))
            except BaseException:
                conn.send(("error", traceback.format_exc()))
                raise
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # graft-lint: disable=R8 — a rank tearing down
                pass
        conn.close()


class RankPool:
    """``world`` live ranks fed jobs (module docstring).

    ``RankPool(world, backend=None, device=None, timeout_s=..., threads=1)``;
    ``run(module, name, *args, job_timeout_s=...)`` runs
    ``module.name(ctx, *args)`` on every rank and returns the list of
    results in rank order (``submit`` then ``collect``: the caller may
    work while the ranks do).  A job that fails on any rank, or outlives
    its time limit, stops every rank and raises ``RuntimeError``; the
    pool is then closed.  ``close()`` stops the ranks."""

    def __init__(self, world: int, backend: Optional[str] = None,
                 device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 threads: Optional[int] = 1):
        self.world = int(world)
        self.backend, kind = resolve_launch(self.world, backend, device)
        if kind == "cuda":
            # Once here, not in every rank at the same time.
            from arrow_matrix_tpu_torch.ops import _build

            _build.build_all()
        self._dir = tempfile.mkdtemp(prefix="amt_ranks_")
        store = os.path.join(self._dir, "store")
        ctx = multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        for r in range(self.world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main,
                            args=(r, self.world, self.backend, kind, store,
                                  timeout_s, threads, child),
                            name=f"amt-rank-{r}", daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self.closed = False

    def run(self, module: str, name: str, *args,
            job_timeout_s: float = 600.0) -> List[Any]:
        self.submit(module, name, *args)
        return self.collect(job_timeout_s)

    def submit(self, module: str, name: str, *args) -> None:
        """Send a job to every rank without waiting (:meth:`collect`
        waits for it)."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        self._job = f"{module}.{name}"
        for c in self._conns:
            c.send((module, name, args))

    def collect(self, job_timeout_s: float = 600.0) -> List[Any]:
        """The results of the job :meth:`submit` sent, in rank order."""
        results: List[Any] = [None] * self.world
        pending = set(range(self.world))
        deadline = time.monotonic() + job_timeout_s
        errors = []
        while pending:
            for r in sorted(pending):
                c = self._conns[r]
                if c.poll(0.02):
                    try:
                        status, value = c.recv()
                    except EOFError:
                        status, value = "error", "the rank exited"
                    pending.discard(r)
                    if status == "ok":
                        results[r] = value
                    else:
                        errors.append((r, value))
                elif not self._procs[r].is_alive():
                    pending.discard(r)
                    errors.append((r, f"exited with code "
                                      f"{self._procs[r].exitcode}"))
            if errors:
                break
            if time.monotonic() > deadline:
                errors.append((sorted(pending), f"no answer within "
                                                f"{job_timeout_s} s"))
                break
        if errors:
            self.close(force=True)
            r, text = errors[0]
            raise RuntimeError(f"rank {r} failed in {self._job}: {text}")
        return results

    def close(self, force: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        if not force:
            for c in self._conns:
                try:
                    c.send(None)
                except (BrokenPipeError, OSError):
                    pass
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        for c in self._conns:
            c.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)


def spawn(fn: Callable, world: int, args: Sequence = (),
          backend: Optional[str] = None, device=None,
          timeout_s: float = DEFAULT_TIMEOUT_S,
          job_timeout_s: float = 3600.0,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(ctx, *args)`` on ``world`` fresh ranks and return their
    results in rank order; ``fn`` must be importable by its module and
    name.  Any failing rank stops the job and raises ``RuntimeError``."""
    module = fn.__module__
    if module == "__main__":       # ``python -m pkg.mod``: its real name
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        module = spec.name if spec is not None else module
    with RankPool(world, backend=backend, device=device,
                  timeout_s=timeout_s, threads=threads) as pool:
        return pool.run(module, fn.__qualname__, *args,
                        job_timeout_s=job_timeout_s)


__all__ = ["RankContext", "RankPool", "resolve_launch", "spawn"]

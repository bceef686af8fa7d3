"""The mesh on ``torch.distributed``: one process per shard.

The JAX package runs one controller over P devices under ``shard_map``
(``arrow_matrix_tpu/parallel/mesh.py``).  The port runs one process per
shard, a rank of a ``torch.distributed`` process group, and keeps the
JAX names: every rank builds the same executor from the same levels and
packs only its own shard; collectives run over the groups of a
:class:`Mesh`.

A :class:`Mesh` is this rank's view of a named grid of ranks: its
coordinates, its device, and one process group per axis, the line of
ranks through it along that axis.  Rank ``r`` sits at the row-major
position ``r`` of the grid, as the JAX mesh reshapes its device list.
``dist.new_group`` is collective, so :func:`make_mesh` creates every
line's group on every rank, in the same order.

Devices and backends.  A rank's device is ``cuda:{local_rank %
torch.cuda.device_count()}`` unless the caller asks for ``"cpu"``; the
backend is ``nccl`` on the card and ``gloo`` on the CPU unless named.
NCCL refuses two ranks on one card, so a world larger than the card
count with ``backend="nccl"`` raises.  Ranks that share one card run
over gloo with their tensors on the card; the collective layer
(``parallel/collectives.py``) copies what gloo cannot move on the card
through pinned host buffers and counts it.  That transport is chosen by
the caller, never substituted for a failed NCCL.

Every group is created with a timeout, so a rank left waiting in a
collective by a dead sibling raises instead of hanging; the launcher
(``parallel/launch.py``) then stops the whole job.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: Seconds a collective may wait before its group raises.
DEFAULT_TIMEOUT_S = 300.0


def rank_device(local_rank: int, device=None) -> torch.device:
    """This rank's device: ``"cpu"`` when asked for, else the card
    ``cuda:{local_rank % device_count}`` (raises without one)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a rank asked for the card but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run the ranks on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    return torch.device("cuda", int(local_rank) % torch.cuda.device_count())


def default_backend(device: torch.device) -> str:
    """``nccl`` for a rank on the card, ``gloo`` on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def check_backend(backend: str, device: torch.device, world: int) -> None:
    """Raise unless ``backend`` can run ``world`` ranks on ``device``'s
    kind: NCCL needs one card a rank."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (expected 'nccl' "
                         f"or 'gloo')")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend='nccl' runs ranks on the card; use "
                             "backend='gloo' for ranks on the CPU")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"backend='nccl' needs one card a rank, but the world has "
                f"{world} ranks and this machine {cards} card(s); use "
                f"backend='gloo' to run ranks that share a card")


def init_distributed(rank: int, world: int, backend: str,
                     device: torch.device, store=None,
                     init_method: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group as ``rank`` of ``world`` over
    ``backend`` (rendezvous through ``store`` or ``init_method``; the
    env's ``MASTER_ADDR``/``MASTER_PORT`` when neither is given).  A
    failed NCCL init raises: nothing is retried over gloo."""
    check_backend(backend, device, world)
    kwargs = dict(backend=backend, rank=int(rank), world_size=int(world),
                  timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kwargs["store"] = store
    elif init_method is not None:
        kwargs["init_method"] = init_method
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)


def initialize_multihost(backend: Optional[str] = None, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join a job started by a ``torchrun``-style launcher from the env
    (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``); returns this rank.  The counterpart of the JAX
    package's ``initialize_multihost``."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(local, device)
    init_distributed(rank, world, backend or default_backend(dev), dev,
                     init_method="env://", timeout_s=timeout_s)
    return rank


class Mesh:
    """This rank's place in a named grid of ranks (module docstring).

    ``shape`` maps each axis name to its size, in order (the JAX
    ``mesh.shape``); ``axis_names`` the names; ``coords`` this rank's
    coordinates; ``device`` its device and ``backend`` the group's.
    ``group(axis)`` is the process group of the line through this rank
    along ``axis`` and ``line(axis)`` its global ranks, in coordinate
    order (``axis=None``: the whole mesh, the default group);
    ``axis_index(axis)`` is this rank's position on it.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int, device: torch.device, backend: str,
                 groups: Dict[str, object], lines: Dict[str, Tuple[int, ...]],
                 ranks: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.world = int(np.prod(shape))
        #: The global ranks of the mesh, in grid order; ``member`` says
        #: whether this process is one of them.  A process outside the
        #: mesh holds no shard: it has no coordinates and no groups.
        self.ranks = tuple(int(r) for r in (ranks if ranks is not None
                                            else range(self.world)))
        self.member = self.rank in self.ranks
        self.coords = (tuple(int(c) for c in np.unravel_index(
            self.ranks.index(self.rank), tuple(shape)))
            if self.member else None)
        self.device = device
        self.backend = backend
        self._groups = groups
        self._lines = lines

    def axis_index(self, axis: str) -> int:
        self.require_member()
        return self.coords[self.axis_names.index(axis)]

    def require_member(self) -> None:
        """Raise unless this process is one of the mesh's ranks."""
        if not self.member:
            raise ValueError(
                f"rank {self.rank} is not one of this mesh's ranks "
                f"{self.ranks}: it holds no shard of the mesh")

    def group(self, axis: str):
        return self._groups[axis]

    def line(self, axis: str) -> Tuple[int, ...]:
        return self._lines[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}"
                + ("" if self.member else " (not a member)")
                + f", device={self.device}, backend={self.backend!r})")


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("blocks",),
              device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """This rank's :class:`Mesh` over the default process group (which
    must be initialized): ``shape`` defaults to ``(len(ranks),)``, a 1-D
    mesh named ``blocks``.  ``ranks`` are the global ranks the grid
    holds, in grid order (default: the whole world); a process outside
    them gets a mesh with ``member`` False and no shard.  Collective:
    every rank of the world calls it with the same arguments (each
    line's group is created on every rank, in the same order).
    ``device`` is this rank's device (default: its card, or the CPU
    under a gloo group started for the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_distributed / initialize_multihost, or "
                           "a rank started by parallel/launch.py)")
    world = dist.get_world_size()
    rank = dist.get_rank()
    ranks = tuple(range(world)) if ranks is None else tuple(
        int(r) for r in ranks)
    if len(set(ranks)) != len(ranks) or not all(
            0 <= r < world for r in ranks):
        raise ValueError(f"mesh ranks {ranks} must be distinct ranks of "
                         f"the world of {world}")
    if shape is None:
        shape = (len(ranks),)
    shape = tuple(int(s) for s in shape)
    if len(axis_names) != len(shape):
        raise ValueError(
            f"mesh shape {shape} has {len(shape)} dimension(s) "
            f"but axis_names {tuple(axis_names)} names "
            f"{len(axis_names)} — one name per mesh dimension required")
    if int(np.prod(shape)) != len(ranks):
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} "
                         f"ranks, the mesh has {len(ranks)} (the process "
                         f"group {world})")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else _gloo_device())
    device = torch.device(device)
    grid = np.asarray(ranks, dtype=np.int64).reshape(shape)
    groups, lines = {}, {}
    timeout = datetime.timedelta(seconds=timeout_s)
    for a, name in enumerate(axis_names):
        moved = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in moved:
            line = tuple(int(r) for r in line)
            # Collective: every rank creates every line's group, in order.
            g = dist.new_group(list(line), timeout=timeout)
            if rank in line:
                groups[name], lines[name] = g, line
    # The whole mesh: ``line(None)`` (the default group when the mesh
    # is the world).
    whole = None
    if len(ranks) != world:
        whole = dist.new_group(list(ranks), timeout=timeout)
    if rank in ranks:
        groups[None], lines[None] = whole, ranks
    return Mesh(shape, axis_names, rank, device, backend, groups, lines,
                ranks=ranks)


_RANK_DEVICE = [None]


def set_rank_device(device) -> None:
    """Record the device of this rank's gloo ranks (the launcher sets
    it, so :func:`make_mesh` finds it)."""
    _RANK_DEVICE[0] = None if device is None else torch.device(device)


def _gloo_device() -> torch.device:
    dev = _RANK_DEVICE[0]
    return torch.device("cpu") if dev is None else dev


def make_repl_mesh(n_dev: int, repl: int,
                   axis_names: Sequence[str] = ("blocks", "repl"),
                   device=None) -> Mesh:
    """2-D ``(blocks, repl)`` mesh for the 2.5D executors: ``n_dev //
    repl`` block shards x ``repl`` replica groups; each replica group
    (a column of the grid) holds a complete copy of the operator and
    exchanges within itself.  ``repl=1`` is the 1-D layout with a
    trailing axis of extent 1."""
    repl = int(repl)
    if repl < 1:
        raise ValueError(f"repl={repl} must be >= 1")
    if n_dev % repl != 0:
        raise ValueError(
            f"repl={repl} must divide the device count n_dev={n_dev} "
            f"(each replica group needs an equal share of the mesh)")
    return make_mesh((n_dev // repl, repl), tuple(axis_names), device=device)


def make_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                     axis_names: Sequence[str], device=None) -> Mesh:
    """The JAX hybrid mesh's axis order on ranks: the leading axes span
    nodes (the JAX package's DCN), the trailing ones the cards of a node
    (its ICI).  Ranks are numbered node by node, so the grid is the
    elementwise product of the two shapes, node-major."""
    if len(ici_shape) != len(dcn_shape):
        raise ValueError("ici_shape and dcn_shape need one entry per axis")
    shape = tuple(int(a) * int(b) for a, b in zip(ici_shape, dcn_shape))
    return make_mesh(shape, axis_names, device=device)


def largest_replication(n_dev: int) -> int:
    """Largest power-of-two c with c**2 <= n_dev that yields a valid
    grid, i.e. n_dev divisible by c**2."""
    c = 1
    while (2 * c) ** 2 <= n_dev and n_dev % ((2 * c) ** 2) == 0:
        c *= 2
    return c


def pad_to_multiple(nb: int, n_dev: int) -> int:
    """Smallest block count >= nb divisible by the device count."""
    return -(-nb // n_dev) * n_dev


def shard_blocked(x, mesh: Mesh, axis: str = "blocks"):
    """This rank's contiguous share of a blocked ``(nb, ...)`` array
    (its leading axis split over ``axis``)."""
    nb = x.shape[0]
    n_dev = mesh.shape[axis]
    if nb % n_dev != 0:
        raise ValueError(f"{nb} blocks not divisible by {n_dev} devices "
                         f"on axis {axis!r}; pad with pad_blocks_to")
    per = nb // n_dev
    i = mesh.axis_index(axis)
    return x[i * per:(i + 1) * per]


def fetch_replicated(local: torch.Tensor, mesh: Mesh,
                     axis: str = "blocks") -> np.ndarray:
    """The global array whose rows are sharded over ``axis`` (each
    rank's ``local`` share, in rank order), as a host numpy array on
    every rank: one all-gather."""
    from arrow_matrix_tpu_torch.parallel.collectives import all_gather

    full = all_gather(local.contiguous(), mesh, axis)
    return full.detach().cpu().numpy()

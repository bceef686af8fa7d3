"""The collective layer of the mesh executors.

Every collective of the port runs through this module, which counts it
(``utils/commstats.py``: kind, group size, wire bytes).  What each JAX
collective of the executors becomes:

* the masked-psum broadcasts -> :func:`broadcast` from one rank of the
  line (the arrow executors' X_0 from the first; the 1.5D round ``q``
  from grid row ``q``);
* the head psum -> :func:`reduce_to_first`: a gather of the partials to
  the group's first rank, summed there in rank order (rank 0 first), so
  a result has the same bits on gloo and NCCL and in every repeat (it
  differs from XLA's psum order only within the executors' tolerance);
* the halo ``ppermute`` chains -> :func:`shift`: a send to each
  neighbour on the axis and a receive from each, the chain ends zero;
* the routed ``lax.all_to_all`` -> :func:`all_to_all` over fixed slots;
* the GSPMD gathers and ``fetch_replicated`` -> :func:`all_gather`;
* the models' whole-array reductions, the gradients of replicated
  parameters and the space-shared sum over level groups ->
  :func:`all_reduce_sum`: an all-gather of the terms, added in rank
  order on every rank (the same bits everywhere).

A group of one rank calls no collective.  Non-reducing collectives move
a bf16 tensor as float16 (the same bits: NCCL has no int16, and both
backends copy float16 without arithmetic).

Ranks that share one card run over gloo with their tensors on the card.
Torch's backend table lists broadcast and all-reduce for gloo on CUDA
tensors, and only those two are handed to gloo on the card
(:data:`GLOO_CUDA_OPS`).  Every other collective is staged by
:func:`_staged`, the one place that copies through pinned host buffers,
and its copies are counted as ``host_staged_bytes``.  Torch's gloo also
takes CUDA tensors for all-gather, gather and all-to-all, copying them
through host memory itself (``chip_smoke.py`` phase 20 probes the three
on the card and prints what it finds).  They are staged here all the
same: the copies are then counted, and one transport serves every
exchange of the executors, the halo's send/recv included, which the
table does not list for gloo on CUDA.  It is the transport of a world
larger than the card count, not a fallback: the kernels still run on the
card, and a NCCL group is never swapped for gloo.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from arrow_matrix_tpu_torch.parallel.mesh import Mesh
from arrow_matrix_tpu_torch.utils import commstats

# The all-gather into one tensor (renamed in recent torch releases).
_ALL_GATHER = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)

#: Collectives handed to gloo on CUDA tensors (torch's backend table);
#: the others are staged (module docstring).
GLOO_CUDA_OPS = ("broadcast", "all_reduce")


def _layer(fn):
    """Run ``fn`` inside :func:`commstats.issuing`: the span in which
    the layer's own ``torch.distributed`` calls and copies run."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with commstats.issuing():
            return fn(*args, **kwargs)
    return wrapped


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives move it: bf16 viewed as float16 (a
    non-reducing op copies bits)."""
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(mesh: Mesh, op: str, ins: List[torch.Tensor],
            outs: List[torch.Tensor], run) -> None:
    """Run ``run(ins, outs)`` (a collective reading ``ins`` and writing
    ``outs``), through pinned host copies when the mesh's backend cannot
    move these tensors on their device (gloo on the card, for any ``op``
    outside :data:`GLOO_CUDA_OPS`); the copies both ways are counted
    as ``host_staged_bytes``."""
    on_card = any(t.device.type == "cuda" for t in ins + outs)
    if not (mesh.backend == "gloo" and on_card and op not in GLOO_CUDA_OPS):
        run(ins, outs)
        return
    h_ins = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in ins]
    for h, t in zip(h_ins, ins):
        h.copy_(t)
    h_outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in outs]
    run(h_ins, h_outs)
    for t, h in zip(outs, h_outs):
        t.copy_(h)
    commstats.record_staged(sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs))


@_layer
def broadcast(t: torch.Tensor, mesh: Mesh, axis: str,
              root: int = 0) -> torch.Tensor:
    """``t`` of the rank at position ``root`` of this rank's ``axis``
    line (``mesh.line(axis)[root]``), on every rank of it (in place into
    ``t``, which must be contiguous)."""
    line = mesh.line(axis)
    if not 0 <= root < len(line):
        raise ValueError(f"broadcast root {root} is not a position of a "
                         f"line of {len(line)} ranks")
    if len(line) == 1:
        return t
    w = _wire(t)

    def run(ins, outs):
        if outs[0] is not ins[0]:
            outs[0].copy_(ins[0])
        dist.broadcast(outs[0], src=line[root], group=mesh.group(axis))

    _staged(mesh, "broadcast", [w], [w], run)
    commstats.record("broadcast", _nbytes(t), len(line), t)
    return t


@_layer
def reduce_to_first(t: torch.Tensor, mesh: Mesh, axis: str
                    ) -> Optional[torch.Tensor]:
    """The sum over the ``axis`` line of every rank's ``t``, on the
    line's first rank (None elsewhere), added in rank order from the
    first rank's term: a gather of the partials, then a sum there."""
    line = mesh.line(axis)
    if len(line) == 1:
        return t.clone()
    first = mesh.rank == line[0]
    parts = (torch.empty((len(line),) + tuple(t.shape), dtype=t.dtype,
                         device=t.device) if first else None)
    src = _wire(t.contiguous())

    def run(ins, outs):
        dist.gather(ins[0], gather_list=(list(outs[0].unbind(0))
                                         if first else None),
                    dst=line[0], group=mesh.group(axis))

    _staged(mesh, "gather", [src], [_wire(parts)] if first else [], run)
    commstats.record("gather", _nbytes(t) * ((len(line) - 1) if first
                                             else 1), len(line), t)
    if not first:
        return None
    acc = parts[0].clone()
    for i in range(1, len(line)):
        acc += parts[i]
    return acc


@_layer
def shift(to_next: Optional[torch.Tensor], to_prev: Optional[torch.Tensor],
          mesh: Mesh, axis: str, shape_from_prev: Tuple[int, ...],
          shape_from_next: Tuple[int, ...], dtype: torch.dtype,
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop of the halo chains along ``axis``: this rank sends
    ``to_next`` to its successor and ``to_prev`` to its predecessor, and
    returns ``(from_prev, from_next)``; the chain ends receive zeros of
    the given shapes."""
    line = mesh.line(axis)
    i = line.index(mesh.rank)
    dev = mesh.device
    from_prev = torch.zeros(shape_from_prev, dtype=dtype, device=dev)
    from_next = torch.zeros(shape_from_next, dtype=dtype, device=dev)
    if len(line) == 1:
        return from_prev, from_next
    sends, recvs = [], []
    ins, outs = [], []
    if i + 1 < len(line):
        ins.append(_wire(to_next.contiguous()))
        sends.append(line[i + 1])
        outs.append(_wire(from_next))
        recvs.append(line[i + 1])
    if i > 0:
        ins.append(_wire(to_prev.contiguous()))
        sends.append(line[i - 1])
        outs.append(_wire(from_prev))
        recvs.append(line[i - 1])

    def run(h_ins, h_outs):
        group = mesh.group(axis)
        ops = [dist.P2POp(dist.isend, t, peer, group)
               for t, peer in zip(h_ins, sends)]
        ops += [dist.P2POp(dist.irecv, t, peer, group)
                for t, peer in zip(h_outs, recvs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _staged(mesh, "collective-permute", ins, outs, run)
    commstats.record("collective-permute",
                     max(sum(_nbytes(t) for t in ins),
                         sum(_nbytes(t) for t in outs)), len(line),
                     from_prev, _nbytes(from_prev) + _nbytes(from_next))
    return from_prev, from_next


@_layer
def all_to_all(send: torch.Tensor, mesh: Mesh, axis: str,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-slot exchange along ``axis``: ``send`` (P * S, ...) holds S
    rows for each rank of the line in rank order; returns the (P * S,
    ...) rows received, S from each rank in rank order (into ``out``,
    contiguous and of ``send``'s shape, when given)."""
    line = mesh.line(axis)
    recv = torch.empty_like(send) if out is None else out
    if len(line) == 1:
        return recv.copy_(send)

    def run(ins, outs):
        dist.all_to_all_single(outs[0], ins[0], group=mesh.group(axis))

    _staged(mesh, "all_to_all", [_wire(send.contiguous())], [_wire(recv)],
            run)
    commstats.record("all-to-all",
                     _nbytes(send) * (len(line) - 1) // len(line), len(line),
                     send)
    return recv


@_layer
def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` (same shape) along ``axis``, concatenated on
    dim 0 in rank order, on every rank of the line."""
    line = mesh.line(axis)
    if len(line) == 1:
        return t.clone()
    out = torch.empty((len(line) * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)

    def run(ins, outs):
        _ALL_GATHER(outs[0], ins[0], group=mesh.group(axis))

    _staged(mesh, "all_gather", [_wire(t.contiguous())], [_wire(out)], run)
    commstats.record("all-gather", _nbytes(t) * (len(line) - 1), len(line),
                     t)
    return out


@_layer
def all_reduce_sum(t: torch.Tensor, mesh: Mesh,
                   axes=None) -> torch.Tensor:
    """The sum of every rank's ``t`` over the lines of ``axes`` (one
    axis name, a sequence of them taken in turn, or None for the whole
    mesh), on every rank, with the same bits on every rank and backend:
    an all-gather of the terms, added in rank order from the first
    rank's term.  Summed over several axes in turn, every rank adds the
    same partial sums in the same order.  Counted as one all-reduce an
    axis."""
    if axes is None or isinstance(axes, str):
        axes = (axes,)
    out = t.contiguous()
    for axis in axes:
        line = mesh.line(axis)
        if len(line) == 1:
            continue
        flat = out.reshape(1, -1)
        parts = torch.empty((len(line), flat.shape[1]), dtype=out.dtype,
                            device=out.device)

        def run(ins, outs):
            _ALL_GATHER(outs[0], ins[0], group=mesh.group(axis))

        _staged(mesh, "all_gather", [_wire(flat)], [_wire(parts)], run)
        commstats.record("all-reduce", _nbytes(out) * (len(line) - 1),
                         len(line), out)
        acc = parts[0].clone()
        for i in range(1, len(line)):
            acc += parts[i]
        out = acc.view(out.shape)
    return out if out is not t else t.clone()


def _line(mesh: Optional[Mesh], axis):
    """(global ranks, group, host-side device) of ``mesh``'s ``axis``
    line, or of the whole default group when ``mesh`` is None; the
    device is the rank's card under NCCL, else the CPU (gloo moves host
    tensors)."""
    if mesh is None:
        line = tuple(range(dist.get_world_size()))
        group, backend = None, dist.get_backend()
        dev = (torch.device("cuda", torch.cuda.current_device())
               if backend == "nccl" else torch.device("cpu"))
        return line, group, dev
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    return mesh.line(axis), mesh.group(axis), dev


@_layer
def all_reduce_max(value: int, mesh: Optional[Mesh], axis=None) -> int:
    """The largest of every rank's integer ``value`` along ``axis`` (a
    host-side agreement: the builds' halo reach, the streamed pack's
    slot budgets, a checkpoint write's outcome); ``mesh`` None: over the
    whole default group."""
    line, group, dev = _line(mesh, axis)
    if len(line) == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    commstats.record("all-reduce", 8, len(line), t)
    return int(t.item())


@_layer
def all_reduce_int_sum(value: int, mesh: Optional[Mesh], axis=None) -> int:
    """The sum of every rank's integer ``value`` along ``axis`` (exact:
    integers; the streamed pack's captured-nonzero count)."""
    line, group, dev = _line(mesh, axis)
    if len(line) == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    commstats.record("all-reduce", 8, len(line), t)
    return int(t.item())


@_layer
def broadcast_object(obj, mesh: Optional[Mesh] = None, axis=None,
                     root: int = 0):
    """The JSON value ``obj`` of the rank at position ``root`` of the
    line, on every rank of it (``mesh`` None: the whole default group):
    its length, then its UTF-8 bytes, two counted broadcasts.  The other
    ranks pass anything (None); what they pass is not read."""
    import json

    line, group, dev = _line(mesh, axis)
    if len(line) == 1:
        return obj
    me = dist.get_rank()
    payload = (json.dumps(obj).encode() if me == line[root] else b"")
    n = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=line[root], group=group)
    buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(dev)
           if me == line[root]
           else torch.empty(int(n.item()), dtype=torch.uint8, device=dev))
    if buf.numel():
        dist.broadcast(buf, src=line[root], group=group)
    commstats.record("broadcast", 8 + buf.numel(), len(line), buf,
                     8 + buf.numel())
    return json.loads(bytes(buf.cpu().numpy()).decode())


def barrier(mesh: Optional[Mesh] = None, axis=None) -> None:
    """Every rank of the line (``mesh`` None: the default group) waits
    for the others: a counted one-integer all-reduce."""
    all_reduce_max(0, mesh, axis)

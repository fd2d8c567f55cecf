"""The partition mesh's collectives (counterpart of
``repro/engine/compat.py``, which keeps the reference's ``shard_map`` shim).

Plain functions over a :class:`~repro_torch.launch.mesh.PartitionMesh`,
each the counterpart of one ``lax`` collective the reference's engine
calls inside ``shard_map``:

  :func:`pmean`       ``lax.pmean``: one ``all_reduce`` (SUM) over the
                      tensors packed into one buffer, then ``/ P``
  :func:`psum`        ``lax.psum``
  :func:`all_gather`  ``lax.all_gather``: each tensor as a ``(P, ...)``
                      stack, all of them packed into one byte buffer, so a
                      call is one collective whatever the dtypes
  :func:`all_to_all`  ``lax.all_to_all(split_axis=0, concat_axis=0)`` on a
                      ``(P, maxS, D)`` send block, through
                      ``all_to_all_single`` on its contiguous
                      ``(P * maxS, D)`` view
  :func:`ring_exchange`  the reference's chunked ``ppermute`` ring: P - 1
                      steps of ``batch_isend_irecv``
  :func:`exchange_start`  either schedule started and returned unwaited,
                      as a :class:`PendingExchange` (the overlapped
                      forward's exchange, which XLA's async collectives
                      start early in the reference)
  :func:`barrier`     no ``lax`` counterpart (one program has no ranks to
                      wait for): every rank waits until all have arrived,
                      which the pipeline's checkpoints need

Under gloo on a CUDA device (``mesh.staged``) every collective stages its
operands through pinned host buffers: the choice follows the backend's
name and nothing else.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["pmean", "psum", "all_gather", "all_to_all", "ring_exchange",
           "exchange", "exchange_start", "PendingExchange", "barrier"]


def _to_wire(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.contiguous()
    if not mesh.staged:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _from_wire(t: torch.Tensor, mesh) -> torch.Tensor:
    return t.to(mesh.device, non_blocking=True) if mesh.staged else t


def _empty_wire(shape, dtype, mesh) -> torch.Tensor:
    if mesh.staged:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=mesh.device)


def psum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks (a new tensor)."""
    w = _to_wire(t, mesh)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=mesh.group)
    return _from_wire(w, mesh)


def pmean(tensors, mesh) -> list[torch.Tensor]:
    """Each tensor's mean over the ranks: ONE ``all_reduce`` over the
    tensors flattened into one buffer (they share a dtype), then ``/ P``.
    Elementwise this is the ``sum / P`` of the reference's ``pmean``; the
    order of the sum over ranks is the collective's."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    total = psum(flat, mesh) / mesh.world
    out, off = [], 0
    for t in tensors:
        out.append(total[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def all_gather(tensors, mesh) -> list[torch.Tensor]:
    """Every rank's copy of each tensor, stacked ``(P, *shape)``, in rank
    order.  The tensors travel as the bytes of one packed buffer, so a
    call is one collective for any mix of dtypes and the result is
    bitwise what each rank held."""
    tensors = [t.detach().contiguous() for t in tensors]
    raw = [t.reshape(-1).view(torch.uint8) for t in tensors]
    packed = _to_wire(torch.cat(raw) if raw else torch.empty(0), mesh)
    parts = [_empty_wire(packed.shape, torch.uint8, mesh)
             for _ in range(mesh.world)]
    dist.all_gather(parts, packed, group=mesh.group)
    rows = _from_wire(torch.stack(parts), mesh)       # (P, bytes)
    out, off = [], 0
    for t, r in zip(tensors, raw):
        # a dense copy of its own, so the view is aligned for any dtype
        chunk = rows.new_empty((mesh.world, r.numel()))
        chunk.copy_(rows[:, off:off + r.numel()])
        out.append(chunk.view(t.dtype).view(mesh.world, *t.shape))
        off += r.numel()
    return out


def all_to_all(sent: torch.Tensor, mesh) -> torch.Tensor:
    """``sent[q]`` (this rank's rows for rank q, ``(P, ...)``) to rank q:
    returns ``recv`` with ``recv[q]`` = the rows rank q sent here."""
    return exchange_start(sent, mesh).wait()


def _ring_steps(w: torch.Tensor, recv: torch.Tensor, mesh,
                chunks: int) -> list:
    """The ring's point-to-point ops, one list per step k = 1 .. P-1 (rank
    p sends its block for (p + k) mod P there and receives (p - k) mod P's
    block, split along the slot axis into ``min(chunks, maxS)`` pieces);
    copies the self block in place first."""
    P, S = w.shape[0], w.shape[1]
    p = mesh.rank
    nc = max(1, min(int(chunks), S))
    bounds = [round(c * S / nc) for c in range(nc + 1)]
    recv[p].copy_(w[p])
    steps = []
    for k in range(1, P):
        dst, src = (p + k) % P, (p - k) % P
        ops = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            ops.append(dist.P2POp(dist.isend, w[dst, lo:hi], dst,
                                  group=mesh.group))
            ops.append(dist.P2POp(dist.irecv, recv[src, lo:hi], src,
                                  group=mesh.group))
        steps.append(ops)
    return steps


def ring_exchange(sent: torch.Tensor, mesh, chunks: int) -> torch.Tensor:
    """:func:`all_to_all` as the reference's ring (its ``_exchange`` with
    ``ring_chunks >= 1``): the self block is copied in place, then the
    P - 1 steps of :func:`_ring_steps` run one after the other, each its
    own ``batch_isend_irecv``.  Pure data movement, so ``recv`` is bitwise
    :func:`all_to_all`'s."""
    w = _to_wire(sent, mesh)
    recv = _empty_wire(w.shape, w.dtype, mesh)
    for ops in _ring_steps(w, recv, mesh, chunks):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(recv, mesh)


def exchange(sent: torch.Tensor, mesh, ring_chunks: int = 0) -> torch.Tensor:
    """The halo exchange's schedule: one all_to_all (``ring_chunks`` 0) or
    the ring of ``ring_chunks`` chunks a step; either delivers the same
    bytes."""
    if ring_chunks <= 0:
        return all_to_all(sent, mesh)
    return ring_exchange(sent, mesh, ring_chunks)


class PendingExchange:
    """An exchange in flight: it holds the wire buffers (the send block,
    and the recv block the collective writes) until :meth:`wait`, which
    waits for every request and returns ``recv`` on the mesh's device.
    Nothing may read ``recv`` before that: under NCCL the wait orders the
    collective's stream before the current one, and under gloo on a card
    the copy back to the card is issued only after it."""

    def __init__(self, works, wire, recv, mesh):
        self._works, self._wire, self._recv = works, wire, recv
        self._mesh = mesh

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        recv, self._works, self._wire = self._recv, (), None
        return _from_wire(recv, self._mesh)


def exchange_start(sent: torch.Tensor, mesh,
                   ring_chunks: int = 0) -> PendingExchange:
    """:func:`exchange` started and not waited on: the all_to_all with
    ``async_op=True``, or every step of the ring posted at once as one
    ``batch_isend_irecv`` whose requests come back unwaited.  The bytes
    delivered are :func:`exchange`'s.  Under gloo on a card the send block
    is copied to pinned host memory before the call returns."""
    w = _to_wire(sent, mesh)
    recv = _empty_wire(w.shape, w.dtype, mesh)
    if ring_chunks <= 0:
        P = w.shape[0]
        works = [dist.all_to_all_single(recv.view(P, -1), w.view(P, -1),
                                        group=mesh.group, async_op=True)]
    else:
        ops = [op for step in _ring_steps(w, recv, mesh, ring_chunks)
               for op in step]
        works = dist.batch_isend_irecv(ops) if ops else []
    return PendingExchange(works, w, recv, mesh)


def barrier(mesh) -> None:
    """Return once every rank of the mesh has called it."""
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)

"""``staged``: a ``torch.distributed`` backend that carries card tensors
through pinned host buffers over a gloo group, so that a world of several
ranks can share one card.

NCCL refuses two ranks on one card, and gloo carries only some collectives
for CUDA tensors; DTensor (the sharded LLM steps, ``launch/steps.py`` with a
mesh) needs ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce`` and ``all_to_all_single`` on card tensors.  This backend
copies each card operand into a pinned host buffer, runs the collective on
the host copies over an inner ``ProcessGroupGloo``, and copies the results
back onto the card.  It follows the rule ``engine/compat.py``'s
``mesh.staged`` follows for the partition mesh: it is chosen by its name
(``init_process_group("staged")``, or ``spawn_partition_world(...,
backend="staged")``) for a world of more than one rank on one card, never
because something else failed.  CPU tensors go to gloo as they are, so a
CPU world can run on it too.

Every collective adds the bytes of its inputs and of its outputs to
:func:`staged_bytes` (what the host copies move on a card: a gather's input
and the gathered output, a reduce-scatter's full input and its chunk, an
all-reduce's or an all-to-all's tensor twice), counted by the kind of the
collective; :func:`reset_staged_bytes` zeroes the counts.  These are the
bytes staged between host and card, not what gloo sends: a reduce-scatter
runs as a gloo all-reduce of the whole input.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["BACKEND", "StagedProcessGroup", "staged_bytes",
           "reset_staged_bytes"]

BACKEND = "staged"

# bytes moved in and out of the collectives this process joined, by kind
_BYTES: dict[str, int] = {}


def staged_bytes(kind: str | None = None) -> int:
    """Bytes of the collectives' inputs and outputs since the last reset:
    of one kind (``"all_gather"``, ``"reduce_scatter"``, ``"all_reduce"``,
    ``"all_to_all"``, ``"broadcast"``), or of all."""
    return sum(_BYTES.values()) if kind is None else _BYTES.get(kind, 0)


def reset_staged_bytes() -> None:
    _BYTES.clear()


def _count(kind: str, *tensors) -> None:
    _BYTES[kind] = _BYTES.get(kind, 0) + sum(
        t.numel() * t.element_size() for t in tensors)


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _host_like(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu" and t.is_contiguous():
        return t
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type != "cpu")


def _back(dst: torch.Tensor, host: torch.Tensor) -> None:
    if host is not dst:
        dst.copy_(host, non_blocking=dst.device.type != "cpu")


class StagedProcessGroup(dist.ProcessGroup):
    """The ``staged`` backend's process group: each collective stages its
    card operands through pinned host memory and runs on ``self.inner``, a
    gloo group over the same store.  The collectives run to their end
    before the call returns (the work handed back is complete)."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self.inner = dist.ProcessGroupGloo(
            dist.PrefixStore("staged", store), rank, size, timeout)
        self._name = ""

    def setGroupName(self, name):
        self._name = name

    def getGroupName(self):
        return self._name

    @property
    def group_name(self):
        return self._name

    def getBackendName(self):
        return BACKEND

    # ---- all-reduce, broadcast, barrier --------------------------------
    def allreduce(self, tensors, opts=None):
        opts = opts or dist.AllreduceOptions()
        hosts = [_to_host(t) for t in tensors]
        self.inner.allreduce(hosts, opts).wait()
        for t, h in zip(tensors, hosts):
            _back(t, h)
        _count("all_reduce", *tensors, *tensors)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        opts_one = dist.AllreduceOptions()
        if opts is not None:
            opts_one.reduceOp = opts.reduceOp
        return self.allreduce(tensors, opts_one)

    def broadcast(self, tensors, opts=None):
        opts = opts or dist.BroadcastOptions()
        hosts = [_to_host(t) for t in tensors]
        self.inner.broadcast(hosts, opts).wait()
        for t, h in zip(tensors, hosts):
            _back(t, h)
        _count("broadcast", *tensors, *tensors)
        return _done(tensors)

    def barrier(self, opts=None):
        self.inner.barrier(opts or dist.BarrierOptions()).wait()
        return _done(None)

    # ---- all-gather -------------------------------------------------------
    def allgather(self, output_lists, inputs, opts=None):
        opts = opts or dist.AllgatherOptions()
        host_in = [_to_host(t) for t in inputs]
        host_out = [[_host_like(o) for o in outs] for outs in output_lists]
        self.inner.allgather(host_out, host_in, opts).wait()
        for outs, houts in zip(output_lists, host_out):
            for o, h in zip(outs, houts):
                _back(o, h)
        _count("all_gather", *inputs, *(o for outs in output_lists
                                        for o in outs))
        return _done(output_lists)

    def _allgather_base(self, output, input, opts=None):
        opts = opts or dist.AllgatherOptions()
        host_in, host_out = _to_host(input), _host_like(output)
        self.inner._allgather_base(host_out, host_in, opts).wait()
        _back(output, host_out)
        _count("all_gather", input, output)
        return _done(output)

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    # ---- reduce-scatter ---------------------------------------------------
    def _reduce_scatter_base(self, output, input, opts=None):
        """The full input reduced on the host over gloo (an all-reduce: a
        gloo group may carry no reduce-scatter), this rank's chunk copied
        back."""
        op = dist.ReduceOp.SUM if opts is None else opts.reduceOp
        host = _to_host(input)
        if host is input:
            host = input.clone()
        ar = dist.AllreduceOptions()
        ar.reduceOp = op
        self.inner.allreduce([host], ar).wait()
        chunk = host.reshape(self.size(), -1)[self.rank()]
        _back(output, chunk.view(output.shape))
        _count("reduce_scatter", input, output)
        return _done(output)

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter(self, outputs, input_lists, opts=None):
        for o, ins in zip(outputs, input_lists, strict=True):
            self._reduce_scatter_base(o, torch.cat([t.reshape(-1)
                                                    for t in ins]), opts)
        return _done(outputs)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs, strict=True):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    # ---- all-to-all -------------------------------------------------------
    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        opts = opts or dist.AllToAllOptions()
        host_in, host_out = _to_host(input), _host_like(output)
        self.inner.alltoall_base(host_out, host_in, list(output_split_sizes),
                                 list(input_split_sizes), opts).wait()
        _back(output, host_out)
        _count("all_to_all", input, output)
        return _done(output)

    all_to_all_single = alltoall_base


def _create(store, rank, size, timeout):
    return StagedProcessGroup(store, rank, size, timeout)


if BACKEND not in dist.Backend.backend_list:
    dist.Backend.register_backend(BACKEND, _create, devices=["cpu", "cuda"])

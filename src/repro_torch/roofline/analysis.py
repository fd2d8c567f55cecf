"""Roofline terms of a step, counted on the H100's terms (counterpart of
``repro/roofline/analysis.py``).

    compute term    = FLOPs      / peak FLOP/s
    memory term     = bytes      / HBM rate
    collective term = coll bytes / link rate

all per rank (a chip).  The reference reads FLOPs and bytes accessed from
XLA's ``cost_analysis`` of the compiled step and the collectives from its
partitioned HLO text.  The port has neither, so it counts what a step
issues while it runs (on the card, on the CPU, or on ``meta`` tensors in
the dry run's fake world):

- :class:`StepCounter`, a ``TorchDispatchMode``: the FLOPs of every aten
  matmul as ``torch.utils.flop_counter`` counts them, the bytes each aten op
  reads and writes (its tensor inputs and outputs, a view moving none), and
  the peak of live storage.  A hand-written kernel's wrapper reports its
  own FLOPs and least bytes (``kernels/work.py``) and the counter leaves out
  the aten ops it runs inside, so the count is the same whether the kernel,
  its plain version or nothing (meta) runs.  The bytes are UNFUSED: each op
  reads its inputs from memory and writes its outputs back, where XLA's
  ``bytes accessed`` is of the fused program;
- :class:`CollectiveCounter`: the bytes of every functional (``
  _c10d_functional``) and ``c10d`` collective by kind, its inputs and its
  outputs apart.  The roofline takes the output bytes, the reference's
  convention; inputs plus outputs are what the staged backend moves
  (``models/sharded.py::step_collective_bytes``).

DTensor ops are left to DTensor (the counters return ``NotImplemented``
for them), so what the counters see is each rank's local ops and the
collectives the placements ask for.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import work

__all__ = ["HW", "RooflineReport", "model_flops", "StepCounter",
           "CollectiveCounter", "analyze_step"]


@dataclass(frozen=True)
class HW:
    """Constants of one card: NVIDIA H100 80GB HBM3 (SXM5), 700 W,
    datasheet."""

    # bf16 dense tensor-core FLOP/s (NVIDIA H100 80GB HBM3 (SXM5), 700 W,
    # datasheet)
    peak_flops: float = 989.4e12
    # f32 FLOP/s on the CUDA cores (NVIDIA H100 80GB HBM3 (SXM5), 700 W,
    # datasheet)
    peak_flops_f32: float = 66.9e12
    # HBM3 bytes/s (NVIDIA H100 80GB HBM3 (SXM5), 700 W, datasheet)
    hbm_bw: float = 3.35e12
    # NVLink 4 bytes/s, the aggregate of one card in one direction (NVIDIA
    # H100 80GB HBM3 (SXM5), 700 W, datasheet)
    link_bw: float = 450e9
    # device memory in bytes (NVIDIA H100 80GB HBM3 (SXM5), datasheet)
    memory_bytes: float = 80e9


def model_flops(n_active_params: float, tokens: float) -> float:
    """The 6·N·D estimate (N = active params, D = tokens)."""
    return 6.0 * n_active_params * tokens


@dataclass
class RooflineReport:
    name: str
    chips: int
    hlo_flops: float                 # per-chip FLOPs (a rank's count)
    hlo_bytes: float                 # per-chip bytes read and written
    coll_bytes: dict[str, int] = field(default_factory=dict)
    model_flops_total: float = 0.0   # 6·N·D over the GLOBAL batch
    peak_memory_per_chip: float = 0.0
    hw: HW = field(default_factory=HW)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes.values()) / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs × chips): the share of the counted
        compute that is model compute (shows remat and dispatch waste)."""
        total = self.hlo_flops * self.chips
        return self.model_flops_total / total if total else 0.0

    def row(self) -> dict:
        return {
            "name": self.name,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "coll_bytes_per_chip": sum(self.coll_bytes.values()),
            "coll_breakdown": self.coll_bytes,
            "model_flops": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_memory_per_chip_gb": self.peak_memory_per_chip / 1e9,
        }


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

# op name (its namespace dropped) -> the reference's kind of collective
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "c10d", "_dtensor")
# ops of the collectives' plumbing: no data moved through memory
_PLUMBING = {"wait_tensor", "_wrap_tensor_autograd"}


def _op_name(func) -> tuple[str, str]:
    ns, _, rest = func.name().partition("::")
    return ns, rest.split(".")[0]


def _collective_kind(func) -> str | None:
    ns, name = _op_name(func)
    if ns not in _NAMESPACES:
        return None
    return _KINDS.get(name)


def _is_comm(func) -> bool:
    ns, name = _op_name(func)
    return ns in _NAMESPACES and (name in _KINDS or name in _PLUMBING)


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _collective_bytes(func, args, kwargs, out) -> tuple[int, int]:
    """(input bytes, output bytes) of one collective: a functional one
    reads its tensor arguments and returns its outputs; a ``c10d`` one
    names them (``output*`` / ``input*``; the in-place ``tensors`` are
    both, but what ``send`` sends and ``recv_`` receives)."""
    ns, name = _op_name(func)
    if ns != "c10d":
        return _nbytes(_tensors(list(args) + list(kwargs.values()))), \
            _nbytes(_tensors(out))
    ins = outs = 0
    schema = func._schema.arguments
    for i, arg in enumerate(schema):
        val = args[i] if i < len(args) else kwargs.get(arg.name)
        n = _nbytes(_tensors(val))
        if not n:
            continue
        if "output" in arg.name:
            outs += n
        elif "input" in arg.name:
            ins += n
        elif name == "send":
            ins += n
        elif name == "recv_":
            outs += n
        else:
            ins, outs = ins + n, outs + n
    return ins, outs


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class CollectiveCounter(TorchDispatchMode):
    """Within the block: the bytes of every collective this rank issues, by
    the reference's kinds (``all-gather``, ``all-reduce``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute`` for send and
    receive, ``broadcast``), its inputs in ``in_bytes`` and its outputs in
    ``out_bytes``; ``calls`` by kind."""

    def __init__(self):
        super().__init__()
        self.in_bytes: dict[str, int] = {}
        self.out_bytes: dict[str, int] = {}
        self.calls: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            i, o = _collective_bytes(func, args, kwargs, out)
            self.in_bytes[kind] = self.in_bytes.get(kind, 0) + i
            self.out_bytes[kind] = self.out_bytes.get(kind, 0) + o
            self.calls[kind] = self.calls.get(kind, 0) + 1
        return out

    def total(self) -> dict[str, int]:
        """Inputs plus outputs by kind (what the staged backend moves)."""
        return {k: self.in_bytes.get(k, 0) + self.out_bytes.get(k, 0)
                for k in set(self.in_bytes) | set(self.out_bytes)}


# ---------------------------------------------------------------------------
# FLOPs, bytes and memory
# ---------------------------------------------------------------------------

# ops that allocate and write nothing a later op reads as data
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "lift_fresh", "alias",
            "_unsafe_view", "_local_scalar_dense"}


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class StepCounter(TorchDispatchMode):
    """Within the block: ``flops`` (aten matmuls, ``torch.utils.
    flop_counter``'s registry, plus the kernels' own), ``bytes`` (each op's
    tensor inputs and outputs, views moving none, plus the kernels' least
    bytes), by op in ``by_op`` and by kernel in ``kernels`` (``[calls,
    flops, bytes]``), and memory: ``argument_bytes`` (storages the block
    reads that existed before it), ``peak_bytes`` (those plus the largest
    sum of live storages the block made), ``output_bytes`` (storages made
    in the block and alive at its end) and ``temp_bytes`` (the rest of the
    peak).  Storages are tracked through weak references to the ops'
    outputs, the counterpart of XLA's ``memory_analysis``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: dict[str, list] = {}
        self.kernels: dict[str, list] = {}
        self.suspended = 0
        self._made: dict[int, int] = {}
        self._args: dict[int, int] = {}
        self.argument_bytes = 0
        self._live = 0
        self._peak_live = 0

    # ----------------------------------------------------------- the hook
    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        if self.suspended:
            return
        row = self.kernels.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        work.register_counter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.unregister_counter(self)
        self.output_bytes = self._live
        return super().__exit__(*exc)

    # ------------------------------------------------------------- memory
    def _freed(self, key: int, nbytes: int) -> None:
        if self._made.pop(key, None) is not None:
            self._live -= nbytes

    def _track(self, inputs, outputs) -> None:
        for t in inputs:
            st = t.untyped_storage()
            key = id(st)
            if key not in self._made and key not in self._args:
                self._args[key] = n = st.nbytes()
                self.argument_bytes += n
                weakref.finalize(st, self._args.pop, key, None)
        for t in outputs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._made or key in self._args:
                continue
            n = st.nbytes()
            self._made[key] = n
            self._live += n
            self._peak_live = max(self._peak_live, self._live)
            weakref.finalize(st, self._freed, key, n)

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self._peak_live

    @property
    def temp_bytes(self) -> int:
        return max(0, self._peak_live - getattr(self, "output_bytes",
                                                self._live))

    # ------------------------------------------------------------ the ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors(out)
        self._track(ins, outs)
        if self.suspended or _is_comm(func):
            return out
        packet = func._overloadpacket
        flops = 0
        if packet in self._registry:
            flops = self._registry[packet](*args, **kwargs, out_val=out)
        name = _op_name(func)[1]
        nbytes = 0
        if not (_is_view(func) or name in _NO_DATA):
            nbytes = _nbytes(ins) + _nbytes(outs)
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(str(packet), [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out


def analyze_step(name: str, counts: StepCounter, *, chips: int,
                 n_active_params: float, tokens: float,
                 collectives: CollectiveCounter | None = None,
                 hw: HW = HW()) -> RooflineReport:
    """The roofline of one rank's step from its counters (the reference's
    ``analyze_compiled``): FLOPs and bytes from ``counts``, the output
    bytes of ``collectives`` by kind, peak memory from the tracked
    storages."""
    return RooflineReport(
        name=name, chips=chips, hlo_flops=float(counts.flops),
        hlo_bytes=float(counts.bytes),
        coll_bytes=dict(collectives.out_bytes) if collectives else {},
        model_flops_total=model_flops(n_active_params, tokens),
        peak_memory_per_chip=float(counts.peak_bytes), hw=hw)

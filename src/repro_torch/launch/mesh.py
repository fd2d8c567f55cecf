"""The partition mesh: one ``torch.distributed`` rank per partition
(counterpart of ``repro/launch/mesh.py``'s ``make_partition_mesh``).

The reference builds a 1-D ``jax`` mesh over ``num_parts`` devices and
runs ``shard_map`` over it; here every partition is a process.  Ranks join
a process group, :func:`make_partition_mesh` describes the calling rank's
place in it, and the engine's collectives (``engine/compat.py``) run over
it.  :func:`spawn_partition_world` starts such a world from one process,
the counterpart of the reference's forced XLA device count; under
``torchrun`` the ranks exist already and call ``init_process_group``
themselves (``launch/train.py`` does).

Backends: ``nccl`` puts rank r on card r; ``gloo`` runs on the CPU, or,
asked for on CUDA, puts every rank on one card (the card tensors cross
the group through pinned host buffers, ``engine/compat.py``), which is how
a world of P ranks runs on a host with one card.  NCCL refuses two ranks
on one card.

The LLM meshes (the reference's ``make_mesh_compat``,
``make_production_mesh``, ``data_axes_of``, ``model_axis_of``): a named
``DeviceMesh`` over the initialized world, ``("data", "model")`` or
``("pod", "data", "model")``, on which the sharded LLM steps
(``launch/steps.py`` with a mesh) place DTensors.  A world of several ranks
on one card runs the ``staged`` backend (``launch/staged_backend.py``):
DTensor's collectives over gloo on card tensors end the rank in SIGSEGV on
the card's torch (``scripts/collective_probe.py``).
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["PartitionMesh", "make_partition_mesh", "partition_world_size",
           "spawn_partition_world", "default_backend", "make_mesh_compat",
           "make_production_mesh", "data_axes_of", "model_axis_of"]

# seconds a collective may wait for its peers before the group fails it
GROUP_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class PartitionMesh:
    """The calling rank's place in a 1-D partition mesh: ``rank`` owns
    partition ``rank`` of ``world``; its tensors live on ``device``."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: object = None            # None: the default group
    axis_name: str = "parts"

    @property
    def staged(self) -> bool:
        """True where card tensors cross the group through host buffers:
        gloo on a CUDA device (by the backend's name, never on failure)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def partition_world_size() -> int | None:
    """The size of the initialized default process group, or None outside
    one (``mode="auto"`` reads it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def make_partition_mesh(num_parts: int, axis_name: str = "parts",
                        device=None) -> PartitionMesh:
    """The calling rank's :class:`PartitionMesh` over the initialized
    default group.  Raises ``ValueError`` outside a group or when its size
    is not ``num_parts`` (the reference raises when it has fewer devices
    than partitions).  ``device`` defaults to the current card under
    ``nccl`` and to the CPU under ``gloo``."""
    world = partition_world_size()
    if world is None:
        raise ValueError(
            f"the partition mesh runs one torch.distributed rank per "
            f"partition, and no process group is initialized: start "
            f"{num_parts} ranks with repro_torch.launch.mesh."
            "spawn_partition_world (or torchrun)")
    if world != num_parts:
        raise ValueError(f"need a world of {num_parts} ranks for the "
                         f"partition mesh, have {world}")
    backend = str(dist.get_backend())
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend moves card tensors only; use "
                         "gloo for a CPU mesh")
    return PartitionMesh(rank=dist.get_rank(), world=world, device=device,
                         backend=backend, axis_name=axis_name)


def make_mesh_compat(shape: tuple[int, ...], axes: tuple[str, ...],
                     device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    initialized default group, rank ``i`` at the row-major position ``i``
    (``init_device_mesh``).  ``device`` (the mesh's device type) defaults to
    ``"cuda"`` under ``nccl`` and ``staged`` when a card is visible, and to
    ``"cpu"`` otherwise.  Raises ``ValueError`` outside a group and when the
    world is not ``prod(shape)`` ranks (the reference's ``jax.make_mesh``
    raises when it has too few devices)."""
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    world = partition_world_size()
    if world is None:
        raise ValueError(f"a mesh of {tuple(shape)} needs a world of {need} "
                         "ranks, and no process group is initialized")
    if world != need:
        raise ValueError(f"a mesh of {tuple(shape)} needs a world of {need} "
                         f"ranks, have {world}")
    if len(axes) != len(shape):
        raise ValueError(f"{len(shape)} mesh dims need as many names, got "
                         f"{tuple(axes)}")
    if device is None:
        on_card = (str(dist.get_backend()) in ("nccl", "staged")
                   and torch.cuda.is_available())
        device = "cuda" if on_card else "cpu"
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def data_axes_of(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def model_axis_of(mesh) -> str | None:
    return "model" if "model" in mesh.mesh_dim_names else None


def _rank_main(rank, fn, args, world, backend, device, store_path,
               out_dir, timeout_s, reraise=()):
    """One spawned rank: join the group, run ``fn(rank, *args)``, save its
    result (or its exception of a ``reraise`` type) for the parent, leave
    the group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        # nccl: a card per rank; gloo: every rank on the named card
        torch.cuda.set_device(rank if backend == "nccl" else (dev.index or 0))
    if backend == "staged":
        from . import staged_backend  # noqa: F401  (registers the backend)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    try:
        try:
            out = fn(rank, *args)
        except reraise as e:
            out = e                 # handed to the parent as the result
        dist.barrier()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_partition_world(fn, world: int, args: tuple = (), *,
                          backend: str | None = None, device="cuda",
                          workdir: str | None = None,
                          timeout_s: float = GROUP_TIMEOUT_S,
                          join_timeout_s: float = 900.0,
                          reraise: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` on ``world`` ranks and return their results
    in rank order.

    The ranks start with the ``spawn`` method (never ``fork``: the caller
    may hold CUDA state and threads), join a group initialized from a
    ``FileStore`` in ``workdir`` (a fresh temporary directory by default)
    with the group ``timeout_s``, and hand their results back through files
    there (``fn`` must be importable, its result loadable by
    ``torch.load`` onto the CPU).  If one rank raises, the others are
    killed and the call raises; if the world has not finished after
    ``join_timeout_s`` seconds, every rank is killed and the call raises
    ``TimeoutError``.  An exception of a ``reraise`` type (e.g. the
    pipeline's ``InjectedCrash``, which every rank raises at the same
    epoch boundary) ends its rank cleanly; when every rank ended in one,
    the call re-raises rank 0's, and when only some did, it raises
    ``RuntimeError``."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(device)
    reraise = tuple(reraise)
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="partition_world_")
    # the FileStore waits for a directory that does not exist
    os.makedirs(workdir, exist_ok=True)
    store_path = os.path.join(workdir, "store")
    if os.path.exists(store_path):
        os.remove(store_path)
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, world, backend, str(device),
                              store_path, workdir, timeout_s, reraise),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"the world of {world} ranks did not finish within "
                        f"{join_timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        outs = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
        raised = [r for r, o in enumerate(outs) if isinstance(o, reraise)]
        if len(raised) == world:
            raise outs[0]
        if raised:
            raise RuntimeError(f"ranks {raised} of {world} raised "
                               f"{outs[raised[0]]!r}; the others returned")
        return outs
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)

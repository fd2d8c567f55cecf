"""Which collectives a gloo world carries for card tensors on this machine's
torch: the question the sharded LLM steps (``launch/steps.py`` with a mesh)
ask before two ranks share one card.

    python3 scripts/collective_probe.py [--backend gloo staged]

For each collective DTensor issues (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``), the
list forms (``all_gather``, ``reduce_scatter``, ``broadcast``) and a
DTensor round trip on a 1-D card mesh (Shard to Replicate, Partial to
Replicate, Partial to Shard, Shard(0) to Shard(1)), spawns a world of 2
ranks on card 0 (``launch.mesh.spawn_partition_world``) that makes that one
call on CUDA tensors and checks its result: a call that kills its rank
(gloo on card tensors can end in SIGSEGV) takes only its own world down.
Prints one line per backend and call, ``ok``, ``wrong`` or the exception's
first line, and a JSON summary.  ``staged`` is the port's backend
(``launch/staged_backend.py``).
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _try(name, fn, out):
    try:
        out[name] = "ok" if fn() else "wrong"
    except Exception as e:          # noqa: BLE001 - the probe reports it
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def probe_rank(rank, backend, which):
    import torch
    import torch.distributed as dist

    world, dev = dist.get_world_size(), torch.device("cuda", 0)
    out = {}
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank

    def ag_tensor():
        o = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(o, x)
        return torch.equal(o.cpu(), torch.cat(
            [torch.arange(4.) + 10 * r for r in range(world)]))

    def rs_tensor():
        o = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(o, x)
        want = sum(torch.arange(4.) + 10 * r for r in range(world))
        return torch.equal(o.cpu(), want[2 * rank:2 * rank + 2])

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return torch.equal(t.cpu(), sum(torch.arange(4.) + 10 * r
                                        for r in range(world)))

    def a2a_single():
        o = torch.empty(4, device=dev)
        dist.all_to_all_single(o, x)
        want = torch.cat([(torch.arange(4.) + 10 * r)[2 * rank:2 * rank + 2]
                          for r in range(world)])
        return torch.equal(o.cpu(), want)

    def ag_list():
        o = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(o, x)
        return all(torch.equal(o[r].cpu(), torch.arange(4.) + 10 * r)
                   for r in range(world))

    def rs_list():
        o = torch.empty(2, device=dev)
        dist.reduce_scatter(o, list(x.chunk(world)))
        want = sum(torch.arange(4.) + 10 * r for r in range(world))
        return torch.equal(o.cpu(), want[2 * rank:2 * rank + 2])

    def bcast():
        t = x.clone()
        dist.broadcast(t, 0)
        return torch.equal(t.cpu(), torch.arange(4.))

    for name, fn in (("all_gather_into_tensor", ag_tensor),
                     ("reduce_scatter_tensor", rs_tensor),
                     ("all_reduce", all_reduce),
                     ("all_to_all_single", a2a_single),
                     ("all_gather", ag_list), ("reduce_scatter", rs_list),
                     ("broadcast", bcast)):
        if name == which:
            _try(name, fn, out)

    def dtensor():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("model",))
        full = torch.arange(8 * world, dtype=torch.float32,
                            device=dev).view(2 * world, 4)
        d = DTensor.from_local(full.chunk(world)[rank], mesh, [Shard(0)])
        ok = torch.equal(d.full_tensor(), full)
        p = DTensor.from_local(full * (rank + 1), mesh, [Partial()])
        tot = full * sum(range(1, world + 1))
        ok &= torch.equal(p.redistribute(mesh, [Replicate()]).to_local(), tot)
        ok &= torch.equal(p.redistribute(mesh, [Shard(0)]).to_local(),
                          tot.chunk(world)[rank])
        s1 = d.redistribute(mesh, [Shard(1)]).to_local()
        return ok and torch.equal(s1, full.chunk(world, dim=1)[rank])

    if which == "dtensor_round_trip":
        _try(which, dtensor, out)
    return out[which]


CALLS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
         "all_to_all_single", "all_gather", "reduce_scatter", "broadcast",
         "dtensor_round_trip")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", nargs="+", default=["gloo", "staged"],
                    choices=["gloo", "staged"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("collective_probe: no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    from repro_torch.launch import staged_backend  # noqa: F401
    from repro_torch.launch.mesh import spawn_partition_world
    summary = {}
    for backend in args.backend:
        for which in CALLS:
            try:
                got = spawn_partition_world(probe_rank, 2, (backend, which),
                                            backend=backend, device="cuda",
                                            timeout_s=60, join_timeout_s=120)
            except Exception as e:  # noqa: BLE001 - the probe reports it
                got = [f"{type(e).__name__}: "
                       f"{str(e).splitlines()[0][:160]}"]
            summary[f"{backend} {which}"] = got
            print(f"{backend} world of 2 on one card, {which}: {got}",
                  flush=True)
    print(json.dumps({"torch": torch.__version__, "results": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

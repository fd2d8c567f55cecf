"""Whether this machine's torch runs the dry run's world: the ``fake``
backend as rank 0 of 512 ranks and the production meshes over it
(``launch/mesh.py::make_dryrun_world``), DTensors on ``meta``, a
redistribute and a backward, counted by the roofline's counters
(``roofline/analysis.py``) beside torch's own ``FlopCounterMode`` and
``CommDebugMode``.

    python3 scripts/fake_world_probe.py

Prints each check's result and a JSON summary; exits 1 when one fails (no
fallback: the dry run needs every one).  Runs on the CPU; a card changes
nothing.
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> int:
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_dryrun_world
    from repro_torch.roofline import CollectiveCounter, StepCounter

    out = {"torch": torch.__version__}
    mesh = make_dryrun_world()
    pod = make_dryrun_world(multi_pod=True)
    out["meshes"] = [list(mesh.shape), list(pod.shape)]
    out["mesh_device"] = mesh.device_type
    # (256, 64) @ (64, 32), the rows over "data", the columns of w over
    # "model": each rank's block is (16, 64) @ (64, 2)
    x = DTensor.from_local(torch.empty(16, 64, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(64, 2, device="meta"), mesh,
                           [Replicate(), Shard(1)],
                           run_check=False).requires_grad_()

    def step():
        y = x @ w
        # the columns gathered over "model": an all-gather of (16, 2)
        z = y.redistribute(mesh, [Shard(0), Replicate()])
        return torch.autograd.grad(z.sum(), [w])[0]

    # torch's counters, then the port's (each pair in a run of its own:
    # torch's FlopCounterMode counts DTensor ops at their global shapes)
    with FlopCounterMode(display=False) as fc, CommDebugMode() as cd:
        step()
    with CollectiveCounter() as cc, StepCounter() as sc:
        g = step()
    out["torch_flops"] = fc.get_total_flops()
    out["rank_flops"] = sc.flops
    out["comm_counts"] = {str(k): v for k, v in
                          cd.get_comm_counts().items()}
    out["out_bytes"] = cc.out_bytes
    out["in_bytes"] = cc.in_bytes
    out["grad"] = [list(g.shape), [str(p) for p in g.placements]]
    checks = {
        "meshes": out["meshes"] == [[16, 16], [2, 16, 16]],
        # torch counts the global matmuls, the counter rank 0's blocks:
        # forward (16, 64) @ (64, 2), backward (64, 16) @ (16, 2)
        "rank_flops": sc.flops == 2 * (2 * 16 * 64 * 2),
        "torch_flops": out["torch_flops"] > sc.flops,
        # the gather's output: 16 ranks' (16, 2) f32 blocks
        "all_gather_bytes": cc.out_bytes.get("all-gather") == 16 * 16 * 2 * 4,
        "comm_debug_sees_it": sum(cd.get_comm_counts().values()) >= 1,
        "grad_shape": list(g.shape) == [64, 32],
    }
    out["checks"] = checks
    for name, ok in checks.items():
        print(f"fake world {name}: {'ok' if ok else 'FAILED'}", flush=True)
    print(json.dumps(out, default=str))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

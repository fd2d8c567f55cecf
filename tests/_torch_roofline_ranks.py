"""What one rank of ``tests/test_torch_roofline.py``'s world of 2 runs:
known collectives, each under its own ``CollectiveCounter``.  Imports
nothing of JAX."""
import torch


def collective_rank(rank):
    """Known collectives on a (4, 8) f32 block (128 B) over 2 ranks, each
    inside its own counter."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from repro_torch.roofline import CollectiveCounter

    x = torch.full((4, 8), float(rank + 1))
    group = [0, 1]
    out = {}

    def count(name, fn):
        with CollectiveCounter() as c:
            fn()
        out[name] = (c.in_bytes, c.out_bytes, c.calls)

    wait = funcol.wait_tensor

    count("funcol all_gather",
          lambda: wait(funcol.all_gather_tensor(x, 0, group)))
    count("funcol all_reduce",
          lambda: wait(funcol.all_reduce(x, "sum", group)))
    count("funcol reduce_scatter",
          lambda: wait(funcol.reduce_scatter_tensor(x, "sum", 0, group)))
    count("funcol all_to_all",
          lambda: wait(funcol.all_to_all_single(x, [2, 2], [2, 2], group)))
    count("c10d all_gather", lambda: dist.all_gather_into_tensor(
        torch.empty(8, 8), x))
    count("c10d all_reduce", lambda: dist.all_reduce(x.clone()))
    count("c10d reduce_scatter", lambda: dist.reduce_scatter_tensor(
        torch.empty(2, 8), x))
    count("c10d all_to_all", lambda: dist.all_to_all_single(
        torch.empty(4, 8), x))

    def send_recv():
        if rank == 0:
            dist.send(x, 1)
            dist.recv(x.clone(), 1)
        else:
            buf = torch.empty(4, 8)
            dist.recv(buf, 0)
            dist.send(buf, 0)

    count("c10d send/recv", send_recv)
    return out

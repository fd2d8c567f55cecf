"""What one rank of the partition-mesh tests runs.

``tests/test_torch_mesh.py`` and ``tests/test_torch_mesh_parity.py`` spawn
worlds of gloo ranks on the CPU (``repro_torch.launch.mesh``); each rank
imports this module, which imports nothing of JAX, so a rank starts in a
few seconds.  The same helpers build the stacked and oracle runs the tests
hold the ranks against, so both sides see one graph, seed and batch set.
"""
import numpy as np
import torch

from repro_torch.core import GPHyperParams, partition_graph
from repro_torch.engine import EngineConfig, make_engine
from repro_torch.engine.stacking import batches_to_device
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph.distributed import mesh_exchange
from repro_torch.graph.sage import broadcast_to_partitions
from repro_torch.launch.mesh import make_partition_mesh
from repro_torch.pipeline import EATConfig, run_eat_distgnn
from repro_torch.train.optim import AdamW

HIDDEN, LR = 32, 1e-2
RINGS = (0, 1, 3)
EPOCHS = ("phase0", "fullgraph", "phase1")


def tiny_parts(g, P: int) -> np.ndarray:
    """The tiny graph's EW partition (P = 1: one partition)."""
    if P == 1:
        return np.zeros(g.num_nodes, np.int64)
    return partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                           method="ew", seed=0).parts


def tiny_case(P: int):
    """The tiny graph and its EW partition (P = 1: one partition)."""
    g = make_benchmark(BENCHMARKS["tiny"])
    return g, build_partitioned_graph(g, tiny_parts(g, P), P)


def batches(g, P: int, dtype, iters: int = 3, B: int = 24, f=(4, 3),
            seed: int = 7) -> dict:
    """An epoch of ``(iters, P, ...)`` host batches from ``seed`` (padded
    label and mask entries included)."""
    rng = np.random.default_rng(seed)
    npd = np.float64 if dtype == torch.float64 else np.float32
    x = lambda *s: rng.normal(0, 1, (iters, P, *s, g.feature_dim)).astype(npd)
    labels = rng.integers(0, g.num_classes, (iters, P, B))
    labels[:, :, -3:] = -1
    mask = np.ones((iters, P, B), npd)
    mask[:, -1, -5:] = 0
    return {"x_t": x(B), "x_1": x(B, f[0]), "x_2": x(B, f[0], f[1]),
            "labels": labels.astype(np.int64), "mask": mask}


def budgets(P: int) -> np.ndarray:
    """Phase-1 budgets with a 0 and the full epoch (3) among them."""
    return np.array([3, 0, 1, 2][:P] if P > 1 else [2])


def start_params(g, dtype, device="cpu") -> GraphSAGE:
    return GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(2).to(
        device, dtype)


def per_partition_start(params, P: int):
    """Per-partition params that start apart."""
    pp = broadcast_to_partitions(params, P)
    with torch.no_grad():
        for w in pp.parameters():
            w.add_(torch.linspace(-0.01, 0.01, P, dtype=w.dtype).to(
                w.device).view(P, *(1,) * (w.dim() - 1)))
    return pp


def engine(pg, g, mode: str, dtype, device="cpu", **kw):
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    opt = AdamW(lr=LR, grad_clip=5.0)
    eng = make_engine(m, m.make_loss_fn(), opt, pg, GPHyperParams(),
                      EngineConfig(mode=mode, dtype=dtype, device=device,
                                   **kw))
    return eng, opt


def _weights(params) -> list:
    return [w.detach().clone() for w in params.parameters()]


def run_epoch(eng, opt, g, P: int, what: str, dtype, device="cpu") -> dict:
    """One epoch method from a fixed start: params, losses, val micro (and
    phase 1's optimizer steps)."""
    params = start_params(g, dtype, device)
    host = batches(g, P, dtype)
    if what in ("phase0", "fullgraph"):
        st = opt.init(params.parameters())
        if what == "phase0":
            out = eng.phase0_epoch(params, st, batches_to_device(host, device))
        else:
            out = eng.phase0_fullgraph_epoch(params, st, iters=2)
        return {"params": _weights(out[0]), "losses": out[2],
                "val": out[3], "step": out[1].step}
    pp = per_partition_start(params, P)
    po = opt.init_stacked(pp.parameters())
    out = eng.phase1_epoch(pp, po, batches_to_device(host, device), params,
                           budgets(P))
    return {"params": _weights(out[0]), "losses": out[2], "val": out[3],
            "step": out[1].step, "mu": [m.clone() for m in out[1].mu]}


@torch.no_grad()
def eval_and_export(eng, g, P: int, dtype=torch.float32,
                    device="cpu") -> dict:
    """From fixed params: the val eval with shared params, the test eval
    with per-partition ones, and the serving export."""
    params = start_params(g, dtype, device)
    pp = per_partition_start(params, P)
    ex = eng.export_serving_state(params)
    return {"val": eng.evaluate(params, "val", per_partition_params=False),
            "test": eng.evaluate(pp, "test", per_partition_params=True),
            "export": (list(ex["layers"]), ex["logits"],
                       [ex["cache"][k] for k in sorted(ex["cache"])])}


def exchange_inputs(P: int, rank: int, ring: int):
    """Rank ``rank``'s send block and the upstream gradient of its recv."""
    gen = torch.Generator().manual_seed(1000 * P + 10 * ring + rank)
    sent = torch.randn(P, 5, 3, generator=gen, dtype=torch.float64)
    return sent, torch.randn(P, 5, 3, generator=gen, dtype=torch.float64)


def run_exchanges(P: int) -> dict:
    """``mesh_exchange`` forward and backward for every ring setting."""
    mesh = make_partition_mesh(P)
    out = {}
    for ring in RINGS:
        sent, up = exchange_inputs(P, mesh.rank, ring)
        sent.requires_grad_(True)
        recv = mesh_exchange(sent, mesh, ring)
        (g,) = torch.autograd.grad((recv * up).sum(), sent)
        out[ring] = (recv.detach(), g)
    return out


def pipeline_config(P: int, mode: str, **kw) -> EATConfig:
    base = dict(dataset="tiny", num_parts=P, hidden_dim=HIDDEN,
                batch_size=64, fanouts=(4, 4), max_epochs=4,
                phase0_fraction=0.5, engine_mode=mode, device="cpu", seed=0)
    base.update(kw)
    return EATConfig(**base)


def pipeline_digest(res) -> dict:
    """The deterministic part of an ``EATResult`` (timings left out)."""
    return {"loss": np.asarray(res.loss_history),
            "val": np.asarray(res.val_history),
            "params": _weights(res.final_params),
            "micro": res.f1.micro,
            "per_micro": np.asarray(res.per_partition_micro),
            "iters": list(res.phase0_iter_history),
            "bytes": (res.comm_grad_bytes, res.comm_halo_bytes,
                      res.comm_halo_exchange_bytes,
                      res.host_to_device_bytes_phase0,
                      res.resident_feature_bytes),
            "engine": res.engine_mode, "epochs": res.epochs_run}


def _refusals(g, pg) -> dict:
    """The message of what the mesh refuses beyond the stacked engine:
    ``feat_groups`` (the reference's refusal)."""
    out = {}
    try:
        engine(pg, g, "spmd", torch.float32, feat_store=True, feat_groups=2)
    except ValueError as e:
        out["feat_groups"] = str(e)
    return out


def _fingerprint_refusal(g, pg, rank: int) -> str:
    """Rank 1 builds a partition whose send lists differ: every rank's
    engine must raise instead of pairing mismatched blocks."""
    if rank == 1:
        pg.send_idx = pg.send_idx.copy()
        pg.send_idx[0, 1, 0] += 1
    try:
        engine(pg, g, "spmd", torch.float32)
    except ValueError as e:
        return str(e)
    return "no refusal"


def world_checks(rank: int, P: int, full: bool) -> dict:
    """Everything one rank of a world of ``P`` reports; ``full`` adds the
    engine, pipeline and refusal checks (the world of 4, and the world of
    1 without the exchange's ring cases)."""
    out = {"exchange": run_exchanges(P)} if P > 1 else {}
    if not full:
        return out
    g, pg = tiny_case(P)
    for agg in (True, False):
        eng, _ = engine(pg, g, "spmd", torch.float32, use_kernel_agg=agg)
        out[f"eval_{agg}"] = eval_and_export(eng, g, P)
    for dtype in (torch.float64, torch.float32):
        for what in EPOCHS:
            eng, opt = engine(pg, g, "spmd", dtype)
            out[what, str(dtype)] = run_epoch(eng, opt, g, P, what, dtype)
    for fg in (False, True):
        out["pipeline", fg] = pipeline_digest(run_eat_distgnn(
            pipeline_config(P, "spmd", full_graph_train=fg,
                            centralized=P == 1)))
    if P > 1:
        out["ring2"] = eval_and_export(
            engine(pg, g, "spmd", torch.float32, ring_chunks=2)[0], g, P)
        out["refusals"] = _refusals(g, pg)
        out["fingerprint"] = _fingerprint_refusal(g, pg, rank)
    return out


def failing_rank(rank: int) -> None:
    """Rank 1 raises at once while rank 0 waits on a collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.all_reduce(torch.ones(1))


def sleeping_rank(rank: int, seconds: float) -> None:
    import time
    time.sleep(seconds)


def hanging_peer(rank: int, seconds: float) -> None:
    """Rank 1 never joins rank 0's collective (it sleeps past the group
    timeout): rank 0's collective must fail within the timeout."""
    import time
    if rank == 1:
        time.sleep(seconds)
        return
    torch.distributed.all_reduce(torch.ones(1))


def parity_inputs(P: int = 4) -> dict:
    """The float32 inputs the reference's spmd run reads from a file: the
    epoch's batches, the start params and the per-partition start, in
    ``SAGEParams`` leaf order (layer by layer: w_self, w_neigh, b)."""
    g, _ = tiny_case(P)
    params = start_params(g, torch.float32)
    pp = per_partition_start(params, P)
    out = {f"batch_{k}": v for k, v in batches(g, P, torch.float32).items()}
    for tag, m in (("start", params), ("pstart", pp)):
        for i, w in enumerate(m.parameters()):
            out[f"{tag}_{i}"] = w.detach().numpy()
    out["budgets"] = budgets(P).astype(np.int32)
    return out


def parity_checks(rank: int) -> dict:
    """The float32 epochs and the eval / export from the start params on
    the mesh, for the comparison with the reference's spmd mode."""
    P = make_partition_mesh(4).world
    g, pg = tiny_case(P)
    out = {}
    for what in EPOCHS:
        eng, opt = engine(pg, g, "spmd", torch.float32)
        out[what] = run_epoch(eng, opt, g, P, what, torch.float32)
    out["eval"] = eval_and_export(engine(pg, g, "spmd", torch.float32)[0],
                                  g, P)
    return out


def card_checks(rank: int, P: int) -> dict:
    """On the card: the float32 epochs and the eval / export of a mesh
    rank with the CUDA segment kernels, and the kernels' launches."""
    from repro_torch.kernels import segment_agg as sa
    g, pg = tiny_case(P)
    sa.reset_kernel_launch_count()
    out = {"eval": eval_and_export(engine(pg, g, "spmd", torch.float32,
                                          "cuda")[0], g, P, device="cuda")}
    for what in EPOCHS:
        eng, opt = engine(pg, g, "spmd", torch.float32, "cuda")
        out[what] = run_epoch(eng, opt, g, P, what, torch.float32, "cuda")
    out["launches"] = (sa.kernel_launch_count(), sa.bwd_kernel_launch_count())
    return out

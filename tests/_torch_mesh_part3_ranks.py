"""What one rank of the partition mesh's communication tests runs
(``tests/test_torch_mesh_comm.py``): the halo cache, the quantized
exchange, the overlapped forward and the gradient reducers on the mesh
(ROADMAP item 14 part 3).

Like ``_torch_mesh_ranks.py`` (whose graph, engines, batches and start
params it reuses) it imports nothing of JAX, so a spawned gloo rank starts
in a few seconds; the same helpers build the stacked and oracle runs the
tests hold the ranks against.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

import _torch_mesh_part2_ranks as m2
import _torch_mesh_ranks as mr
from repro_torch.core.gp.trainer import make_bucketed_reduce_shard
from repro_torch.engine.stacking import batches_to_device
from repro_torch.launch.mesh import make_partition_mesh
from repro_torch.graph.sage import partition_slice
from repro_torch.pipeline import run_eat_distgnn
from repro_torch.robustness import FaultPlan, InjectedCrash

F32, F64 = torch.float32, torch.float64

# eval cases: engine options; each engine runs EVALS evals from the same
# params.  K=2 gives the plans full, (0, 0), full; K=3 with the cv chunks
# full, the first chunk, the second
CACHE_K2 = {"halo_cache": True, "halo_refresh_every": 2}
CACHE_CV = {"halo_cache": True, "halo_refresh_every": 3, "halo_cv": True}
STORE = {"feat_store": True, "hot_frac": 0.5}
EVAL_CASES = {
    "cache_k2": CACHE_K2,
    "cache_cv": CACHE_CV,
    "cache_cv_ring2": {**CACHE_CV, "ring_chunks": 2},
    "int8": {"halo_compress": "int8"},
    "fp16_ring2": {"halo_compress": "fp16", "ring_chunks": 2},
    "cache_k2_int8": {**CACHE_K2, "halo_compress": "int8"},
    "cache_cv_fp16_ring2": {**CACHE_CV, "halo_compress": "fp16",
                            "ring_chunks": 2},
    "cache_cv_int8_store": {**CACHE_CV, "halo_compress": "int8", **STORE},
    "int8_plain": {"halo_compress": "int8", "use_kernel_agg": False},
    "overlap": {"overlap_halo": True},
    "overlap_ring2": {"overlap_halo": True, "ring_chunks": 2},
    "overlap_plain": {"overlap_halo": True, "use_kernel_agg": False},
    "overlap_store": {"overlap_halo": True, **STORE},
}
EVALS = 3

# phase-0 epochs through the per-shard reducers: (epoch, engine options)
REDUCE = {"bucketed": {"grad_compress": "bucketed", "grad_bucket_kb": 1},
          "topk": {"grad_compress": "topk", "grad_topk_frac": 0.1}}
REDUCER_EPOCHS = {
    "phase0-bucketed": ("phase0", REDUCE["bucketed"]),
    "phase0-topk": ("phase0", REDUCE["topk"]),
    "fullgraph-bucketed": ("fullgraph", REDUCE["bucketed"]),
    "fullgraph-overlap": ("fullgraph", {"overlap_halo": True}),
    "fullgraph-overlap-bucketed": ("fullgraph", {"overlap_halo": True,
                                                 **REDUCE["bucketed"]}),
    "async0-bucketed": ("async0", REDUCE["bucketed"]),
    "async0-cache-int8-topk": ("async0", {**CACHE_K2,
                                          "halo_compress": "int8",
                                          **REDUCE["topk"]}),
    "async1-cache-int8-topk": ("async1", {**CACHE_K2,
                                          "halo_compress": "int8",
                                          **REDUCE["topk"]}),
}

# the pipelines held against the stacked runs (the mesh's byte counters
# equal to theirs)
PIPELINES = {
    "cache-cv": {"halo_cache": True, "halo_refresh_every": 4,
                 "halo_cv": True},
    "int8-topk": {"halo_compress": "int8", "grad_compress": "topk",
                  "grad_topk_frac": 0.1},
    "fp16-bucketed": {"halo_compress": "fp16", "grad_compress": "bucketed",
                      "grad_bucket_kb": 1},
    "async-cache-int8-topk": {"async_generalize": True,
                              "async_personalize": True, "halo_cache": True,
                              "halo_refresh_every": 2,
                              "halo_compress": "int8",
                              "grad_compress": "topk",
                              "grad_topk_frac": 0.1},
    "fullgraph-overlap-bucketed": {"full_graph_train": True,
                                   "overlap_halo": True,
                                   "grad_compress": "bucketed",
                                   "grad_bucket_kb": 1},
}
# the resumed run: cache + int8 + top-k with the robustness settings,
# killed at boundary 1
RESUME = {"halo_cache": True, "halo_refresh_every": 2, "halo_cv": True,
          "halo_compress": "int8", "grad_compress": "topk",
          "grad_topk_frac": 0.1}
RESUME_CRASH = 1

# what the reference refuses, and the mesh with it: name -> (engine
# options, the call that raises)
REFUSALS = {
    "overlap+cache": ({"overlap_halo": True, "halo_cache": True}, None),
    "overlap+compress": ({"overlap_halo": True, "halo_compress": "int8"},
                         None),
    "fullgraph+cache": ({"halo_cache": True}, "fullgraph"),
    "fullgraph+topk": ({"grad_compress": "topk"}, "fullgraph"),
    "export+overlap": ({"overlap_halo": True}, "export"),
}


class CollectiveCount:
    """Counts the ``torch.distributed`` collectives and point-to-point
    batches the mesh's ``engine.compat`` functions issue while it is
    entered (it wraps the calls they make)."""

    NAMES = ("all_to_all_single", "batch_isend_irecv", "all_gather",
             "all_reduce", "barrier")

    def __enter__(self):
        self.calls = {n: 0 for n in self.NAMES}
        self._saved = {n: getattr(dist, n) for n in self.NAMES}
        for n in self.NAMES:
            def counted(*a, _n=n, **kw):
                self.calls[_n] += 1
                return self._saved[_n](*a, **kw)
            setattr(dist, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(dist, n, fn)

    @property
    def total(self) -> int:
        return sum(self.calls.values())


class WireBytes:
    """Counts the bytes this rank sends to its peers through
    ``all_to_all_single`` (all but its own block) and ``all_gather`` (its
    tensor to each peer) while it is entered."""

    def __enter__(self):
        self.sent = 0
        self._saved = {n: getattr(dist, n)
                       for n in ("all_to_all_single", "all_gather")}

        def a2a(out, inp, *a, **kw):
            P = dist.get_world_size(kw.get("group"))
            self.sent += inp.numel() * inp.element_size() * (P - 1) // P
            return self._saved["all_to_all_single"](out, inp, *a, **kw)

        def gather(parts, t, *a, **kw):
            self.sent += t.numel() * t.element_size() * (len(parts) - 1)
            return self._saved["all_gather"](parts, t, *a, **kw)

        dist.all_to_all_single, dist.all_gather = a2a, gather
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(dist, n, fn)


# the bucketed reducer's wire check: gradients of these shapes, drawn per
# partition from the seed, in buckets of BUCKET_ELEMS f32 entries (the last
# bucket and every bucket's pieces uneven at P = 4)
WIRE_SHAPES, BUCKET_ELEMS = [(37, 13), (13,), (5,)], 61


def wire_grads(P: int, dtype=F32) -> list:
    """The ``(P, ...)`` per-partition gradients of the wire check."""
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.standard_normal((P, *s))).to(dtype)
            for s in WIRE_SHAPES]


def bucketed_wire(rank: int, P: int, mesh) -> dict:
    """The per-shard bucketed reducer on this rank's rows of
    :func:`wire_grads`: its result and the bytes it sent."""
    reduce = make_bucketed_reduce_shard(P, mesh, BUCKET_ELEMS * 4)
    with WireBytes() as w:
        out = reduce([g[rank] for g in wire_grads(P)])
    return {"mean": out, "sent": w.sent}


def _state(eng) -> dict:
    """The engine's carried communication state in the stacked layout (a
    collective on the mesh), and its last exchange bytes."""
    cache = eng.halo_cache_state()
    res = eng.comm_residual_state()
    return {"cache": None if cache is None else (cache[0], cache[1]),
            "res": res, "bytes": eng.last_halo_exchange_bytes}


@torch.no_grad()
def eval_trace(eng, g, P: int, count: bool = False, device="cpu",
               per_partition: bool = True) -> dict:
    """``EVALS`` eval forwards from fixed params (shared, per-partition,
    shared; with ``per_partition`` False shared throughout): each one's
    logits (the rank's ``(maxN, C)`` on the mesh, ``(P, maxN, C)``
    stacked), the state after it and, with ``count``, the collectives it
    issued; then ``evaluate``'s micro-F1 and predictions."""
    params = mr.start_params(g, F32, device)
    pp = mr.per_partition_start(params, P)
    out = []
    for i in range(EVALS):
        prm = pp if i == 1 and per_partition else params
        if eng.mesh is not None and prm.num_parts is not None:
            prm = partition_slice(prm, eng.rank)
        with CollectiveCount() as cc:
            logits = eng._eval_forward(prm, eng._featurized())
        step = {"logits": logits, **_state(eng)}
        if count:
            step["collectives"] = cc.total
        out.append(step)
    return {"steps": out,
            "evaluate": eng.evaluate(params, "val",
                                     per_partition_params=False)}


def eval_cases(g, pg, P: int, mode: str, device="cpu") -> dict:
    """Every eval case's trace.  On the card, only shared params and the
    segment kernels: cuBLAS may run a partition axis of 1 otherwise than
    one of P, and the plain aggregation's ``index_add_`` adds with atomics,
    so neither is bitwise there (the CPU holds both)."""
    card = torch.device(device).type == "cuda"
    return {name: eval_trace(mr.engine(pg, g, mode, F32, device, **kw)[0], g,
                             P, count=mode == "spmd", device=device,
                             per_partition=not card)
            for name, kw in EVAL_CASES.items()
            if not (card and kw.get("use_kernel_agg") is False)}


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x.cpu() if isinstance(x, torch.Tensor) else x


def card_eval_checks(rank: int, P: int) -> dict:
    """On the card: every eval case's trace, moved to the host."""
    g, pg = mr.tiny_case(P)
    return _to_cpu(eval_cases(g, pg, P, "spmd", device="cuda"))


def reducer_epoch(g, pg, P: int, mode: str, what: str, dtype) -> dict:
    """One epoch of ``REDUCER_EPOCHS[what]`` on an engine of ``mode``
    (the top-k residual after it, in the stacked layout, too)."""
    epoch, kw = REDUCER_EPOCHS[what]
    eng, opt = mr.engine(pg, g, mode, dtype, **kw)
    if epoch.startswith("async"):
        ds = m2.device_sampler(g, P, dtype)
        out = m2.run_async(eng, opt, g, P, epoch, ds, dtype)
        out.pop("batches")
    else:
        out = mr.run_epoch(eng, opt, g, P, epoch, dtype)
    st = eng.comm_residual_state()
    out["grad_res"] = None if st is None else st[1]
    if eng.halo_cache:
        out["cache"] = eng.halo_cache_state()
    return out


def pipeline_runs(P: int, mode: str) -> dict:
    return {name: m2.digest(run_eat_distgnn(mr.pipeline_config(
        P, mode, **kw))) for name, kw in PIPELINES.items()}


def resume_config(P: int, mode: str, **kw):
    return m2.resume_config(P, mode, "sampled", **{**RESUME, **kw})


def resume_run(P: int, workdir: str) -> dict:
    """The cache + int8 + top-k run uninterrupted, killed at boundary 1
    (every checkpoint kept in ``workdir``) and resumed."""
    base = m2.digest(run_eat_distgnn(resume_config(P, "spmd")))
    try:
        run_eat_distgnn(resume_config(P, "spmd", checkpoint_dir=workdir),
                        fault_plan=FaultPlan(
                            crash_epochs=frozenset({RESUME_CRASH})))
        crashed = None
    except InjectedCrash as e:
        crashed = e.epoch
    res = run_eat_distgnn(resume_config(P, "spmd", checkpoint_dir=workdir,
                                        resume=True))
    return {"base": base, "crashed": crashed, "run": m2.digest(res),
            "resumed_from": res.resumed_from_epoch}


def refusals(g, pg, mode: str) -> dict:
    """Each of ``REFUSALS``' messages on an engine of ``mode``."""
    out = {}
    for name, (kw, call) in REFUSALS.items():
        try:
            eng, opt = mr.engine(pg, g, mode, F32, **kw)
            params = mr.start_params(g, F32)
            if call == "fullgraph":
                eng.phase0_fullgraph_epoch(params,
                                           opt.init(params.parameters()))
            elif call == "export":
                eng.export_serving_state(params)
            out[name] = "no refusal"
        except ValueError as e:
            out[name] = str(e)
    return out


def export_refresh(g, pg, P: int, mode: str) -> dict:
    """Under the cache, the export's snapshot becomes the cache: the
    export's cache and the engine's after it (four evals in)."""
    eng, _ = mr.engine(pg, g, mode, F32, **CACHE_K2)
    eval_trace(eng, g, P)
    ex = eng.export_serving_state(mr.start_params(g, F32))
    return {"export_cache": ex["cache"], "cache": eng.halo_cache_state()}


def fullgraph_grads(g, pg, mode: str) -> list:
    """One full-graph step's mean gradient through the overlapped forward
    (``pmean``'d on the mesh) from the start params."""
    from repro_torch.engine.compat import pmean
    eng, _ = mr.engine(pg, g, mode, F32, overlap_halo=True)
    params = mr.start_params(g, F32)
    w = list(params.parameters())
    loss = eng._fg_loss(params, {"shard": eng.shards, "labels": eng.labels,
                                 "train_mask": eng.masks["train"]})
    if eng.mesh is None:
        return list(torch.autograd.grad(loss.mean(), w))
    return pmean(torch.autograd.grad(loss, w), eng.mesh)


def comm_world(rank: int, P: int, workdir: str) -> dict:
    """Everything one rank of a world of ``P`` reports."""
    g, pg = mr.tiny_case(P)
    out = {"evals": eval_cases(g, pg, P, "spmd")}
    for dtype in (F64, F32):
        for what in REDUCER_EPOCHS:
            out[what, str(dtype)] = reducer_epoch(g, pg, P, "spmd", what,
                                                  dtype)
    out["pipelines"] = pipeline_runs(P, "spmd")
    out["resume"] = resume_run(P, os.path.join(workdir, "ck"))
    out["refusals"] = refusals(g, pg, "spmd")
    out["export"] = export_refresh(g, pg, P, "spmd")
    out["fg_grads"] = fullgraph_grads(g, pg, "spmd")
    out["bucketed_wire"] = bucketed_wire(rank, P, make_partition_mesh(P))
    return out


def parity_checks(rank: int) -> dict:
    """For the comparison with the reference's ``mode="spmd"``, with the
    plain aggregation: three evals under the cache (K = 2) with int8 from
    the start params (shared, per-partition, shared) and the last one's
    exchange bytes, one top-k phase-0 epoch and one overlapped eval."""
    P = 4
    g, pg = mr.tiny_case(P)
    params = mr.start_params(g, F32)
    pp = mr.per_partition_start(params, P)
    eng, _ = mr.engine(pg, g, "spmd", F32, use_kernel_agg=False,
                       halo_compress="int8", **CACHE_K2)
    out = {"cache_int8": [
        eng.evaluate(prm, "val" if prm is params else "test",
                     per_partition_params=prm is pp)
        for prm in (params, pp, params)],
        "cache_int8_bytes": eng.last_halo_exchange_bytes}
    eng, opt = mr.engine(pg, g, "spmd", F32, use_kernel_agg=False,
                         **REDUCE["topk"])
    p, _, losses, val, _ = eng.phase0_epoch(
        mr.start_params(g, F32), opt.init(params.parameters()),
        batches_to_device(mr.batches(g, P, F32), "cpu"))
    out["topk"] = {"params": mr._weights(p), "losses": losses, "val": val,
                   "grad_res": eng.comm_residual_state()[1]}
    eng, _ = mr.engine(pg, g, "spmd", F32, use_kernel_agg=False,
                       overlap_halo=True)
    out["overlap"] = eng.evaluate(params, "val", per_partition_params=False)
    return out


def parity_world(rank: int) -> dict:
    """The part-1 parity run (``_torch_mesh_ranks.parity_checks``) and this
    module's, on one world."""
    return {**mr.parity_checks(rank), "part3": parity_checks(rank)}

"""The historical halo cache and the compressed eval forward (ROADMAP item
10) on tiny, P=4, hidden 16, against the reference:

1. the compressed and cached forwards against the reference's under
   ``jax.vmap`` in f32, on carried non-zero caches and residuals: layer 0's
   payloads (its new residual and refreshed cache rows) bitwise, since the
   raw features are identical; logits and layer 1's state within one
   quantization step of layer 1's payload (stated below); the full-range
   cached forward bitwise the port's synchronous forward;
2. the stacked engine against the port's oracle in f64 to rel 1e-12 for the
   cache, the cache with cv, fp16, int8, int8 with the cache, bucketed and
   top-k, the async phase-0 epoch included;
3. the port's oracle against the reference's oracle in f32, in process;
4. ``run_eat_distgnn``: the byte counters and ``halo_exchange_history``
   equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPHyperParams as JGPHyperParams
from repro.core import partition_graph as j_partition_graph
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SequentialReference as JSequentialReference
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import distributed as jd
from repro.graph import make_benchmark as j_make_benchmark
from repro.pipeline import EATConfig as JEATConfig
from repro.pipeline import run_eat_distgnn as j_run_eat_distgnn
from repro.train.optim import AdamW as JAdamW
from repro_torch.core import GPHyperParams, partition_graph
from repro_torch.core.sampler import build_device_epoch_sampler
from repro_torch.engine import (EngineConfig, SequentialReference,
                                SPMDEngine, make_engine)
from repro_torch.engine.stacking import batches_to_device
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph import distributed as td
from repro_torch.graph.sage import broadcast_to_partitions
from repro_torch.pipeline import EATConfig, run_eat_distgnn
from repro_torch.train.optim import AdamW, opt_state_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401

P, HIDDEN, LR = 4, 16, 1e-2
# one forward's f32 logits: sums in another order than XLA's
ATOL, RTOL = 5e-6, 1e-5
# params and losses after float32 AdamW steps (tests/test_torch_sequential)
STEP_ATOL, STEP_RTOL = 1e-5, 1e-4
REL64 = 1e-12


@pytest.fixture(scope="module")
def graphs():
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, P)
    gj = j_make_benchmark(J_BENCHMARKS["tiny"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, P,
                           method="ew", seed=0)
    pgj = j_build_partitioned_graph(gj, rj.parts, P)
    host_train = [g.train_idx[r.parts[g.train_idx] == p] for p in range(P)]
    return g, pg, pgj, host_train


def _bits(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


# --------------------------------------------------------------------------
# 1. the forwards against the reference's, f32
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forwards(graphs):
    g, pg, pgj, _ = graphs
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes)
    jp = jm.init(0)
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(0)
    eng = SPMDEngine(m, None, None, pg, None,
                     EngineConfig(use_kernel_agg=False, device="cpu"))
    keys = ("features", "send_idx", "send_mask", "recv_pos", "edge_src",
            "edge_dst", "edge_mask")
    js = {k: jnp.asarray(getattr(pgj, k)) for k in keys}
    # a carried state: random rows on real slots, zero on pad slots (the
    # cache in recv layout, the residual in send layout)
    rng = np.random.default_rng(7)
    send_real = pg.send_mask[..., None]
    recv_real = np.swapaxes(pg.send_mask, 0, 1)[..., None]
    dims = m.layer_input_dims
    cache = {f"h{i}": (rng.normal(0, 1, (P, P, pg.send_idx.shape[-1], d))
                       * recv_real).astype(np.float32)
             for i, d in enumerate(dims)}
    res = {f"r{i}": (rng.normal(0, 0.01, (P, P, pg.send_idx.shape[-1], d))
                     * send_real).astype(np.float32)
           for i, d in enumerate(dims)}
    return dict(pg=pg, jm=jm, jp=jp, m=m, eng=eng, js=js, cache=cache,
                res=res, meta={"max_nodes": pg.max_nodes,
                               "own_cap": pg.own_cap})


def _t(d: dict) -> dict:
    return {k: torch.tensor(v) for k, v in d.items()}


def _j(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


def _layer1_step(f, mode: str) -> float:
    """The largest quantization step of layer 1's payload in the port's
    forward (int8: the largest row scale; fp16: one ulp of the largest
    |row entry|; uncompressed: 0), from the port's own layer 0."""
    if mode == "none":
        return 0.0
    m, sh = f["m"], f["eng"].shards
    h = sh["features"]
    mask = sh["send_mask"]
    recv, _ = td._ef_quantized_exchange(
        td._gather_send(h, sh["send_idx"], mask), mask[..., None],
        torch.tensor(f["res"]["r0"]), mode, h.dtype)
    h = td._land(h, recv, sh["recv_pos"])
    agg = td.make_ref_mean_agg(f["pg"].max_nodes)
    h1 = m._layer(m.layers[0], h, agg(h, sh), True)
    sent_ef = (td._gather_send(h1, sh["send_idx"], mask)
               + torch.tensor(f["res"]["r1"])) * mask[..., None]
    amax = float(sent_ef.detach().abs().max())
    if mode == "int8":
        return amax / 127.0
    return 2.0 ** (np.floor(np.log2(amax)) - 10)


def _logit_atol(f, step: float) -> float:
    """A layer-1 payload entry that rounds one step apart in the two
    forwards moves a landed halo row by ``step``, the mean over its
    out-neighbours' in-edges by at most ``step`` per element, and the
    logits by at most ``step`` times a column's absolute sum of layer 1's
    ``w_neigh``; plus the f32 forwards' own difference."""
    w = f["m"].layers[1].w_neigh.detach().abs().sum(dim=0).max()
    return ATOL + step * float(w)


@pytest.mark.parametrize("mode", ["fp16", "int8"])
def test_compressed_forward_against_reference(forwards, mode):
    f = forwards
    fj = jd.make_distributed_forward(f["jm"], f["meta"], axis_name="d",
                                     compress=mode)
    lj, rj = jax.vmap(fj, in_axes=(None, 0, 0), axis_name="d")(
        f["jp"], f["js"], _j(f["res"]))
    ft = td.make_distributed_forward(f["m"], f["meta"], compress=mode)
    with torch.no_grad():
        lt, rt = ft(f["m"], f["eng"].shards, _t(f["res"]))
    # layer 0 quantizes the raw features: bitwise
    assert (_bits(rt["r0"]) == _bits(rj["r0"])).all()
    step = _layer1_step(f, mode)
    assert step > 0
    np.testing.assert_allclose(rt["r1"].numpy(), rj["r1"], rtol=0,
                               atol=ATOL + step)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=RTOL,
                               atol=_logit_atol(f, step))
    for r in rt.values():
        assert (r.numpy()[f["pg"].send_mask == 0] == 0).all()
    assert (lt.numpy()[:, f["pg"].trash_row] == lj[:, -1]).all()


def _plans(max_s: int):
    return {"full": (0, max_s), "empty": (0, 0),
            "partial": (1, max(2, max_s - 1))}


@pytest.mark.parametrize("plan", ["full", "empty", "partial"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_cached_forward_against_reference(forwards, plan, mode):
    f = forwards
    lo, hi = _plans(f["pg"].send_idx.shape[-1])[plan]
    fj = jd.make_cached_forward(f["jm"], f["meta"], axis_name="d",
                                refresh_lo=lo, refresh_hi=hi, compress=mode)
    ft = td.make_cached_forward(f["m"], f["meta"], refresh_lo=lo,
                                refresh_hi=hi, compress=mode)
    args_j = (f["jp"], f["js"], _j(f["cache"]))
    args_t = (f["m"], f["eng"].shards, _t(f["cache"]))
    if mode != "none":
        args_j += (_j(f["res"]),)
        args_t += (_t(f["res"]),)
    out_j = jax.vmap(fj, in_axes=(None, 0, 0) + (0,) * (mode != "none"),
                     axis_name="d")(*args_j)
    with torch.no_grad():
        out_t = ft(*args_t)
    # layer 0's refreshed rows (and its residual) come from the features
    assert (_bits(out_t[1]["h0"]) == _bits(out_j[1]["h0"])).all()
    step = _layer1_step(f, mode)
    np.testing.assert_allclose(out_t[1]["h1"].numpy(), out_j[1]["h1"],
                               rtol=RTOL, atol=ATOL + step)
    np.testing.assert_allclose(out_t[0].numpy(), out_j[0], rtol=RTOL,
                               atol=_logit_atol(f, step))
    if mode != "none":
        assert (_bits(out_t[2]["r0"]) == _bits(out_j[2]["r0"])).all()
        np.testing.assert_allclose(out_t[2]["r1"].numpy(), out_j[2]["r1"],
                                   rtol=0, atol=ATOL + step)
    # slots outside [lo, hi) keep their cached rows; pad slots stay zero
    recv_real = np.swapaxes(f["pg"].send_mask, 0, 1)
    for i in range(2):
        c = out_t[1][f"h{i}"].numpy()
        outside = np.ones(c.shape[2], bool)
        outside[lo:hi] = False
        assert (c[:, :, outside] == f["cache"][f"h{i}"][:, :, outside]).all()
        assert (c[recv_real == 0] == 0).all()


def test_full_range_cached_forward_is_the_synchronous_forward(forwards):
    f = forwards
    max_s = f["pg"].send_idx.shape[-1]
    sync = td.make_distributed_forward(f["m"], f["meta"])
    cached = td.make_cached_forward(f["m"], f["meta"], refresh_lo=0,
                                    refresh_hi=max_s)
    with torch.no_grad():
        want = sync(f["m"], f["eng"].shards)
        got, cache = cached(f["m"], f["eng"].shards, _t(f["cache"]))
        export = f["eng"].export_serving_state(f["m"])
    assert (_bits(got) == _bits(want)).all()
    # the cache snapshots exactly the recv buffers the exchange landed
    for k in cache:
        assert (_bits(cache[k]) == _bits(export["cache"][k])).all()


# --------------------------------------------------------------------------
# 2. the stacked engine against the port's oracle
# --------------------------------------------------------------------------

CONFIGS = {
    "cache": dict(halo_cache=True, halo_refresh_every=3),
    "cache_cv": dict(halo_cache=True, halo_refresh_every=3, halo_cv=True),
    "fp16": dict(halo_compress="fp16"),
    "int8": dict(halo_compress="int8"),
    "int8_cache_cv": dict(halo_compress="int8", halo_cache=True,
                          halo_refresh_every=2, halo_cv=True),
    "bucketed": dict(grad_compress="bucketed", grad_bucket_kb=1),
    "topk": dict(grad_compress="topk", grad_topk_frac=0.05),
}


def _batches(g, iters=3, B=24, f=(4, 3), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    d = g.feature_dim
    x = lambda *s: rng.normal(0, 1, (iters, P, *s, d)).astype(dtype)
    labels = rng.integers(0, g.num_classes, (iters, P, B))
    labels[:, :, -3:] = -1
    mask = np.ones((iters, P, B), dtype)
    mask[:, 1, -5:] = 0
    return {"x_t": x(B), "x_1": x(B, f[0]), "x_2": x(B, f[0], f[1]),
            "labels": labels.astype(np.int64), "mask": mask}


def _state(eng):
    """The engine's carried state as stacked tensors (the oracle keeps one
    buffer per partition)."""
    out = {}
    st = lambda v: torch.stack(v) if isinstance(v, list) else v
    if eng.halo_cache:
        cache, age = eng.halo_cache_state()
        out.update({k: st(v) for k, v in cache.items()}, age=age)
    comm = eng.comm_residual_state()
    if comm is not None:
        h, g = comm
        if h is not None:
            out.update({k: st(v) for k, v in h.items()})
        if g is not None:
            out["grad_res"] = g
    return out


def _engine_run(eng, g, opt, sampler, dtype):
    """A phase-0 epoch, an async phase-0 epoch, then three evaluations
    (shared params, the test split, per-partition params); returns what
    each produced and the carried state after each."""
    params = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(2).to(
        dtype)
    st = opt.init(params.parameters())
    host = _batches(g, seed=7, dtype=np.float64 if dtype == torch.float64
                    else np.float32)
    out = []
    params, st, losses, val, _ = eng.phase0_epoch(
        params, st, batches_to_device(host, "cpu"))
    out.append((losses, val, eng.last_halo_exchange_bytes, _state(eng)))
    eng.set_device_sampler(sampler)
    params, st, losses, val, _ = eng.phase0_epoch_async(
        params, st, torch.Generator().manual_seed(11))
    out.append((losses, val, eng.last_halo_exchange_bytes, _state(eng)))
    pp = broadcast_to_partitions(params, P)
    with torch.no_grad():
        for w in pp.parameters():
            w.add_(torch.linspace(-0.01, 0.01, P, dtype=dtype).view(
                P, *(1,) * (w.dim() - 1)))
    for prm, split, per in ((params, "val", False), (params, "test", False),
                            (pp, "test", True)):
        micro, preds = eng.evaluate(prm, split, per_partition_params=per)
        out.append((preds, micro, eng.last_halo_exchange_bytes, _state(eng)))
    return params, out


@pytest.fixture(scope="module")
def samplers(graphs):
    g, _, _, host_train = graphs
    return {dt: build_device_epoch_sampler(
        g, host_train, P, batch_size=16, fanouts=(3, 3), dtype=dt,
        device="cpu") for dt in (torch.float32, torch.float64)}


def _close_state(a: dict, b: dict, dtype) -> None:
    assert set(a) == set(b)
    for k in a:
        if k == "age":
            assert a[k] == b[k]
            continue
        if dtype == torch.float64:
            # rel 1e-12 of the buffer's scale: a residual entry that is an
            # exact 0 on one side may be a last-bit rounding error on the
            # other
            scale = float(b[k].abs().max())
            tol = dict(rtol=REL64, atol=REL64 * scale)
        else:
            # f32: an entry the two sides round to neighbouring quantization
            # levels moves its residual (and its cached row) by one step,
            # and there |residual| is half a step, so a step is at most
            # twice the largest |residual| of the layer
            r = b.get("r" + k[1:]) if k[0] in "hr" else None
            step = 2.01 * float(r.abs().max()) if r is not None else 0.0
            tol = dict(rtol=STEP_RTOL, atol=STEP_ATOL + step)
        torch.testing.assert_close(a[k], b[k], **tol)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_stacked_engine_matches_oracle(graphs, samplers, name, dtype):
    g, pg, _, _ = graphs
    runs = []
    for mode in ("stacked", "sequential"):
        m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
        opt = AdamW(lr=LR, grad_clip=5.0)
        eng = make_engine(m, m.make_loss_fn(), opt, pg, GPHyperParams(),
                          EngineConfig(mode=mode, dtype=dtype, device="cpu",
                                       **CONFIGS[name]))
        assert eng.mode == mode
        runs.append(_engine_run(eng, g, opt, samplers[dtype], dtype))
    (pa, oa), (pb, ob) = runs
    tol = (dict(rtol=REL64, atol=0) if dtype == torch.float64
           else dict(atol=STEP_ATOL, rtol=STEP_RTOL))
    for a, b in zip(pa.parameters(), pb.parameters()):
        torch.testing.assert_close(a.detach(), b.detach(), **tol)
    own = torch.as_tensor(np.asarray(pg.labels) >= 0)
    for i, ((xa, va, ba, sa), (xb, vb, bb, sb)) in enumerate(zip(oa, ob)):
        if i < 2:                                   # losses
            torch.testing.assert_close(xa, xb, **tol)
        else:                                       # predictions
            assert torch.equal(xa[own], xb[own])
        torch.testing.assert_close(va, vb, atol=1e-6, rtol=0)
        assert ba == bb
        _close_state(sa, sb, dtype)
    last = oa[-1][3]
    if "cache" in name:
        assert last["age"] == 5          # two epochs' evals and three more
    if name == "topk":
        assert torch.isfinite(last["grad_res"]).all()
        assert (last["grad_res"] != 0).any()


def test_drop_next_halo_refresh_serves_the_stale_cache(graphs):
    g, pg, *_ = graphs
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    eng = SPMDEngine(m, None, None, pg, None, EngineConfig(
        device="cpu", halo_cache=True, halo_refresh_every=1))
    params = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(0)
    eng.evaluate(params, "val", per_partition_params=False)
    full = eng.last_halo_exchange_bytes
    assert full == 2 * pg.halo_bytes_per_layer
    before = {k: v.clone() for k, v in eng.halo_cache_state()[0].items()}
    eng.drop_next_halo_refresh()
    eng.evaluate(params.init(1), "val", per_partition_params=False)
    assert eng.last_halo_exchange_bytes == 0 and eng.halo_refresh_drops == 1
    cache, age = eng.halo_cache_state()
    assert age == 2 and all(torch.equal(cache[k], before[k]) for k in cache)
    eng.evaluate(params, "val", per_partition_params=False)
    assert eng.last_halo_exchange_bytes == full
    # the checkpoint surface round-trips
    eng.restore_halo_cache_state({k: v.numpy() for k, v in before.items()}, 7)
    cache, age = eng.halo_cache_state()
    assert age == 7 and all(torch.equal(cache[k], before[k]) for k in cache)
    assert eng.comm_residual_state() is None


# --------------------------------------------------------------------------
# 3. the port's oracle against the reference's, f32, in process
# --------------------------------------------------------------------------

def _mid_run_state(jm, jopt, seed=0):
    pj = jm.init(seed)
    rng = np.random.default_rng(seed + 5)
    mom = lambda s: jax.tree.map(
        lambda p: jnp.asarray(np.abs(rng.normal(0, s, p.shape))
                              .astype(np.float32)), pj)
    return pj, jopt.init(pj)._replace(step=jnp.asarray(3, jnp.int32),
                                      mu=mom(0.01), nu=mom(0.001))


ORACLE_CONFIGS = ["cache_cv", "int8", "int8_cache_cv", "bucketed", "topk"]


@pytest.mark.parametrize("name", ORACLE_CONFIGS)
def test_oracle_matches_reference_oracle(graphs, name):
    g, pg, pgj, _ = graphs
    kw = CONFIGS[name]
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes)
    jopt = JAdamW(lr=LR, grad_clip=5.0)
    jseq = JSequentialReference(jm, jm.make_loss_fn(), jopt, pgj,
                                JGPHyperParams(),
                                JEngineConfig(mode="sequential", **kw))
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    opt = AdamW(lr=LR, grad_clip=5.0)
    seq = SequentialReference(m, m.make_loss_fn(), opt, pg, GPHyperParams(),
                              EngineConfig(mode="sequential", device="cpu",
                                           **kw))
    host = _batches(g)
    pj, sj = _mid_run_state(jm, jopt)
    pj, sj, lj, vj, _ = jseq.phase0_epoch(
        pj, sj, {k: jnp.asarray(v) for k, v in host.items()})
    p0, s0 = _mid_run_state(jm, jopt)
    params = GraphSAGE(g.feature_dim, HIDDEN,
                       g.num_classes).params_from_numpy(p0.layers)
    params, st, lt, vt, _ = seq.phase0_epoch(
        params, opt_state_from_numpy(s0, params), batches_to_device(host,
                                                                    "cpu"))
    np.testing.assert_allclose(lt.numpy(), lj, atol=STEP_ATOL,
                               rtol=STEP_RTOL)
    want = GraphSAGE(g.feature_dim, HIDDEN,
                     g.num_classes).tensors_from_numpy(pj.layers)
    for a, b in zip(params.parameters(), want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   atol=STEP_ATOL, rtol=STEP_RTOL)
    np.testing.assert_allclose(vt.numpy(), vj, atol=1e-6)
    assert seq.last_halo_exchange_bytes == jseq.last_halo_exchange_bytes
    for split in ("test", "val", "test"):
        mj, _ = jseq.evaluate(pj, split, per_partition_params=False)
        mt, _ = seq.evaluate(params, split, per_partition_params=False)
        np.testing.assert_allclose(mt.numpy(), mj, atol=1e-6)
        assert seq.last_halo_exchange_bytes == jseq.last_halo_exchange_bytes
    assert seq.halo_wire_bytes_per_layer == jseq.halo_wire_bytes_per_layer
    if seq.halo_cache:
        (cj, aj), (ct, at) = jseq.halo_cache_state(), seq.halo_cache_state()
        assert at == aj == 4
        # layer 0's cached rows are the (dequantized) raw features
        for p in range(P):
            assert (_bits(ct["h0"][p]) == _bits(cj["h0"][p])).all()
            np.testing.assert_allclose(ct["h1"][p].numpy(), cj["h1"][p],
                                       atol=1e-2 if "int8" in name
                                       else STEP_ATOL, rtol=STEP_RTOL)
    comm_j, comm_t = jseq.comm_residual_state(), seq.comm_residual_state()
    assert (comm_j is None) == (comm_t is None)
    if comm_t is not None:
        (hj, gj), (ht, gt) = comm_j, comm_t
        if ht is not None:
            for p in range(P):
                assert (_bits(ht["r0"][p]) == _bits(hj["r0"][p])).all()
        if gt is not None:
            np.testing.assert_allclose(gt.numpy(), gj, atol=STEP_ATOL,
                                       rtol=STEP_RTOL)


# --------------------------------------------------------------------------
# 4. the pipeline's byte accounting
# --------------------------------------------------------------------------

BASE = dict(dataset="tiny", num_parts=4, max_epochs=6, hidden_dim=16,
            batch_size=64, fanouts=(5, 5), phase0_fraction=0.5, seed=0)


@pytest.mark.parametrize("extra", [
    {"halo_cache": True, "halo_refresh_every": 2, "halo_cv": True},
    {"halo_cache": True, "halo_refresh_every": 3, "halo_compress": "int8"},
    {"halo_compress": "int8", "grad_compress": "topk"},
    {"halo_compress": "fp16", "grad_compress": "bucketed",
     "full_graph_train": True},
    {"halo_cache": True, "halo_refresh_every": 2, "async_generalize": True,
     "grad_compress": "topk", "grad_topk_frac": 0.1}],
    ids=["cache_cv", "cache_int8", "int8_topk", "fp16_bucketed_full_graph",
         "cache_async_topk"])
def test_pipeline_byte_counters_match_reference(extra):
    kw = dict(BASE, **extra)
    got = run_eat_distgnn(EATConfig(device="cpu", **kw))
    want = j_run_eat_distgnn(JEATConfig(**kw))
    assert got.phase0_iter_history == want.phase0_iter_history
    assert (got.epochs_run, got.phase1_epochs) == (want.epochs_run,
                                                   want.phase1_epochs)
    assert got.halo_exchange_history == want.halo_exchange_history
    for k in ("comm_grad_bytes", "comm_halo_bytes", "comm_halo_bytes_phase0",
              "comm_halo_bytes_phase1", "comm_halo_exchange_bytes",
              "halo_bytes_per_layer"):
        assert getattr(got, k) == getattr(want, k), k
    assert set(got.summary()) == set(want.summary())
    for k in ("halo_cache", "halo_refresh_every", "halo_cv",
              "halo_compress", "grad_compress", "comm_halo_exchange_mb",
              "comm_grad_mb"):
        assert got.summary()[k] == want.summary()[k], k
    assert np.isfinite(got.loss_history).all()
    if not extra.get("async_generalize"):
        # the async draws come from torch's generator, the reference's from
        # jax's keys: only the host paths see the same batches
        np.testing.assert_allclose(got.loss_history, want.loss_history,
                                   rtol=1e-4)
        assert abs(got.f1.micro - want.f1.micro) <= 0.01

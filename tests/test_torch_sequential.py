"""The port's sequential oracle (``engine/sequential.py::SequentialReference``)
on tiny, P=4, hidden 16:

1. against the reference's ``SequentialReference`` in f32, in process, from
   the same ``GraphSAGE.init`` params, optimizer state and host batches:
   one sampled phase-0 epoch, one phase-1 epoch with budgets that include 0
   and the full epoch, one full-graph phase-0 epoch and ``evaluate``, each
   with and without ``overlap_halo`` (losses and params within atol 1e-5,
   rtol 1e-4; logits within atol 5e-6, rtol 1e-5);
2. the port's stacked engine against the port's oracle: the same epochs
   plus both async epochs (one ``torch.Generator`` state gives both the
   same batches), in f64 within rel 1e-12 and in f32 as above;
3. ``make_personalize_partition_step``: an inactive partition comes back
   bitwise unchanged, and the step equals row p of
   ``make_personalize_step``;
4. ``make_engine`` dispatches on the mode, and options the oracle does not
   have raise naming their ROADMAP item.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPHyperParams as JGPHyperParams
from repro.core import broadcast_to_partitions as j_broadcast
from repro.core import partition_graph as j_partition_graph
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SequentialReference as JSequentialReference
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import make_benchmark as j_make_benchmark
from repro.train.optim import AdamW as JAdamW
from repro_torch.core import GPHyperParams, partition_graph
from repro_torch.core.gp.trainer import (make_personalize_partition_step,
                                         make_personalize_step)
from repro_torch.core.sampler import build_device_epoch_sampler
from repro_torch.engine import (EngineConfig, SequentialReference,
                                SPMDEngine, make_engine)
from repro_torch.engine.stacking import batches_to_device
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph.sage import (broadcast_to_partitions, clone_params,
                                    take_partition)
from repro_torch.train.optim import AdamW, opt_state_from_numpy

# params and losses after several float32 AdamW steps whose gradients sum
# in another order than XLA's (tests/test_torch_engine.py's tolerance)
ATOL, RTOL = 1e-5, 1e-4
# one forward's logits: f32 sums in another order (test_torch_distributed)
LOGIT_ATOL, LOGIT_RTOL = 5e-6, 1e-5
# f64: the stacked step differentiates the mean of the P losses, the
# oracle sums the P gradients and divides by P, and the products run in
# other shapes; everything else is the same arithmetic
REL64 = 1e-12
HIDDEN, LR, P = 16, 1e-2, 4
BUDGETS = np.array([3, 0, 1, 2], np.int32)   # 0 and the full epoch (3)


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


def _batches(g, iters=3, B=24, f=(4, 3), seed=0):
    rng = np.random.default_rng(seed)
    d = g.feature_dim
    x = lambda *s: rng.normal(0, 1, (iters, P, *s, d)).astype(np.float32)
    labels = rng.integers(0, g.num_classes, (iters, P, B))
    labels[:, :, -3:] = -1
    mask = np.ones((iters, P, B), np.float32)
    mask[:, 1, -5:] = 0
    return {"x_t": x(B), "x_1": x(B, f[0]), "x_2": x(B, f[0], f[1]),
            "labels": labels.astype(np.int64), "mask": mask}


def _mid_run_state(jm, jopt, seed=0):
    """Params from a seed plus an optimizer state a few steps in."""
    pj = jm.init(seed)
    rng = np.random.default_rng(seed + 5)
    mom = lambda s: jax.tree.map(
        lambda p: jnp.asarray(np.abs(rng.normal(0, s, p.shape))
                              .astype(np.float32)), pj)
    return pj, jopt.init(pj)._replace(step=jnp.asarray(3, jnp.int32),
                                      mu=mom(0.01), nu=mom(0.001))


def _port(m, jparams, dtype=torch.float32):
    out = GraphSAGE(m.feature_dim, m.hidden_dim,
                    m.num_classes).params_from_numpy(jparams.layers)
    return out.to(dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or dict(atol=ATOL, rtol=RTOL)))


def _assert_params(got, jparams):
    want = GraphSAGE(got.feature_dim, got.hidden_dim,
                     got.num_classes).tensors_from_numpy(jparams.layers)
    for a, b in zip(got.parameters(), want):
        _close(a.detach().numpy(), b.numpy())


# --------------------------------------------------------------------------
# 1. the port's oracle against the reference's, f32, in process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True],
                ids=["sync", "overlap"])
def oracles(request, graphs):
    """Both oracles through every public epoch method from the same start;
    returns each side's outputs."""
    overlap = request.param
    g, pg, pgj, _ = graphs
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes)
    jopt = JAdamW(lr=LR, grad_clip=5.0)
    jseq = JSequentialReference(
        jm, jm.make_loss_fn(), jopt, pgj, JGPHyperParams(),
        JEngineConfig(mode="sequential", overlap_halo=overlap))
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    opt = AdamW(lr=LR, grad_clip=5.0)
    seq = SequentialReference(
        m, m.make_loss_fn(), opt, pg, GPHyperParams(),
        EngineConfig(mode="sequential", overlap_halo=overlap, device="cpu"))
    host = _batches(g)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = batches_to_device(host, "cpu")
    out = {"overlap": overlap, "pg": pg}

    # phase 0, sampled
    pj, sj = _mid_run_state(jm, jopt)
    pj, sj, lj, vj, _ = jseq.phase0_epoch(pj, sj, jb)
    p0, s0 = _mid_run_state(jm, jopt)
    params = _port(m, p0)
    params, st, losses, val, _ = seq.phase0_epoch(
        params, opt_state_from_numpy(s0, params), tb)
    out["phase0"] = (pj, sj, lj, vj), (params, st, losses, val)

    # full-graph phase 0, two steps
    pj, sj = _mid_run_state(jm, jopt, seed=1)
    pj, sj, lj, vj, _ = jseq.phase0_fullgraph_epoch(pj, sj, iters=2)
    p0, s0 = _mid_run_state(jm, jopt, seed=1)
    params = _port(m, p0)
    params, st, losses, val, _ = seq.phase0_fullgraph_epoch(
        params, opt_state_from_numpy(s0, params), iters=2)
    out["fullgraph"] = (pj, sj, lj, vj), (params, st, losses, val)

    # phase 1 with budgets 3 (the full epoch), 0, 1, 2
    gp_j = jm.init(3)
    ppj = j_broadcast(gp_j, P)
    poj = jax.vmap(jopt.init)(ppj)
    host1 = _batches(g, seed=4)
    ppj, poj, lj, vj, _ = jseq.phase1_epoch(
        ppj, poj, {k: jnp.asarray(v) for k, v in host1.items()}, gp_j,
        BUDGETS)
    gp = _port(m, gp_j)
    pp = broadcast_to_partitions(gp, P)
    frozen = [w[1].clone() for w in pp.parameters()]
    po = opt.init_stacked(pp.parameters())
    pp, po, losses, val, _ = seq.phase1_epoch(
        pp, po, batches_to_device(host1, "cpu"), gp, BUDGETS)
    out["phase1"] = (ppj, poj, lj, vj), (pp, po, losses, val)
    out["frozen"] = frozen

    # evaluate with those per-partition params, and the logits themselves
    out["evaluate"] = (jseq.evaluate(ppj, "test", per_partition_params=True),
                       seq.evaluate(pp, "test", per_partition_params=True))
    jlist = [jax.tree.map(lambda x: x[p], ppj) for p in range(P)]
    with torch.no_grad():
        tl = seq._full_forward([take_partition(pp, p) for p in range(P)])
    out["logits"] = ([np.asarray(x) for x in jseq._full_forward(jlist)],
                     [x.numpy() for x in tl])
    return out


def test_oracle_phase0_matches_reference(oracles):
    (pj, sj, lj, vj), (params, st, losses, val) = oracles["phase0"]
    assert losses.shape == (3, P)
    _close(losses.numpy(), lj)
    _assert_params(params, pj)
    assert int(st.step) == int(sj.step)
    _close(val.numpy(), vj, atol=1e-6)


def test_oracle_fullgraph_matches_reference(oracles):
    (pj, sj, lj, vj), (params, st, losses, val) = oracles["fullgraph"]
    assert losses.shape == (2, P)
    _close(losses.numpy(), lj)
    _assert_params(params, pj)
    assert int(st.step) == int(sj.step) == 2 + 3
    _close(val.numpy(), vj, atol=1e-6)


def test_oracle_phase1_matches_reference(oracles):
    (ppj, poj, lj, vj), (pp, po, losses, val) = oracles["phase1"]
    assert losses.shape == (3, P)
    assert po.step.tolist() == BUDGETS.tolist() == np.asarray(poj.step).tolist()
    _close(losses.numpy(), lj)
    _assert_params(pp, ppj)
    # the zero-budget partition rode through bitwise
    for w, f in zip(pp.parameters(), oracles["frozen"]):
        assert torch.equal(w[1], f)
    _close(val.numpy(), vj, atol=1e-6)


def test_oracle_evaluate_matches_reference(oracles):
    (mj, predj), (mt, pred) = oracles["evaluate"]
    pg = oracles["pg"]
    _close(mt.numpy(), mj, atol=1e-6)
    own = np.asarray(pg.labels) >= 0
    assert (pred.numpy()[own] == np.asarray(predj)[own]).mean() > 0.99
    for a, b in zip(*oracles["logits"]):
        assert a.shape == b.shape
        _close(b, a, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


# --------------------------------------------------------------------------
# 2. the port's stacked engine against the port's oracle
# --------------------------------------------------------------------------

EPOCHS = ["phase0", "fullgraph", "phase1", "async0", "async1", "evaluate"]


@pytest.fixture(scope="module")
def sampler(graphs):
    g, pg, _, host_train = graphs
    return {dt: build_device_epoch_sampler(
        g, host_train, P, batch_size=16, fanouts=(3, 3), dtype=dt,
        device="cpu") for dt in (torch.float32, torch.float64)}


def _run_epoch(eng, what, m, opt, g, dtype, ds):
    """One epoch method of ``eng`` from a fixed start; returns
    ``(params, losses, val_micro)`` (``evaluate``: the test micro-F1 and
    predictions of per-partition params)."""
    params = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(2).to(dtype)
    host = {k: v.astype(np.float64) if v.dtype == np.float32 and
            dtype == torch.float64 else v
            for k, v in _batches(g, seed=7).items()}
    gen = torch.Generator().manual_seed(11)
    if what in ("phase0", "fullgraph", "async0"):
        st = opt.init(params.parameters())
        if what == "phase0":
            out = eng.phase0_epoch(params, st, batches_to_device(host, "cpu"))
        elif what == "fullgraph":
            out = eng.phase0_fullgraph_epoch(params, st, iters=2)
        else:
            eng.set_device_sampler(ds)
            out = eng.phase0_epoch_async(params, st, gen)
        return out[0], out[2], out[3]
    pp = broadcast_to_partitions(params, P)
    with torch.no_grad():                 # partitions start apart
        for w in pp.parameters():
            w.add_(torch.linspace(-0.01, 0.01, P, dtype=dtype).view(
                P, *(1,) * (w.dim() - 1)))
    if what == "evaluate":
        micro, preds = eng.evaluate(pp, "test", per_partition_params=True)
        return pp, preds, micro
    po = opt.init_stacked(pp.parameters())
    if what == "phase1":
        out = eng.phase1_epoch(pp, po, batches_to_device(host, "cpu"),
                               params, BUDGETS)
    else:
        eng.set_device_sampler(ds)
        out = eng.phase1_epoch_async(pp, po, gen, np.array([2, 0, 1, 3]),
                                     params)
    return out[0], out[2], out[3]


@pytest.mark.parametrize("what", EPOCHS)
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_stacked_engine_matches_oracle(graphs, sampler, what, overlap, dtype):
    g, pg, _, _ = graphs
    runs = []
    for mode in ("stacked", "sequential"):
        m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
        opt = AdamW(lr=LR, grad_clip=5.0)
        eng = make_engine(m, m.make_loss_fn(), opt, pg, GPHyperParams(),
                          EngineConfig(mode=mode, dtype=dtype, device="cpu",
                                       overlap_halo=overlap))
        assert eng.mode == mode
        runs.append(_run_epoch(eng, what, m, opt, g, dtype, sampler[dtype]))
    (pa, la, va), (pb, lb, vb) = runs
    tol = (dict(rtol=REL64, atol=0) if dtype == torch.float64
           else dict(atol=ATOL, rtol=RTOL))
    for a, b in zip(pa.parameters(), pb.parameters()):
        assert a.dtype == dtype
        torch.testing.assert_close(a.detach(), b.detach(), **tol)
    if what == "evaluate":
        own = torch.as_tensor(np.asarray(pg.labels) >= 0)
        assert torch.equal(la[own], lb[own])
    else:
        torch.testing.assert_close(la, lb, **tol)
    torch.testing.assert_close(va, vb, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# 3. the single-partition phase-1 step
# --------------------------------------------------------------------------

def _partition_batch(g, dtype, seed=3):
    host = _batches(g, iters=1, seed=seed)
    return {k: torch.as_tensor(v[0]).to(dtype if v.dtype == np.float32
                                        else torch.int64)
            for k, v in host.items()}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_partition_step_is_row_p_of_the_stacked_step(graphs, dtype):
    g, *_ = graphs
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    opt = AdamW(lr=LR, grad_clip=5.0)
    gp = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(1).to(dtype)
    pp = broadcast_to_partitions(gp, P)
    with torch.no_grad():
        for w in pp.parameters():
            w.add_(0.01 * torch.randn(w.shape, generator=torch.Generator()
                                      .manual_seed(w.numel()), dtype=dtype))
    batch = _partition_batch(g, dtype)       # (P, ...)
    active = torch.tensor([True, True, False, True])
    parts = [take_partition(pp, p) for p in range(P)]
    po = opt.init_stacked(pp.parameters())
    sp, so, sl = make_personalize_step(m.make_loss_fn(), opt)(
        clone_params(pp), po, batch, gp, active)
    one = make_personalize_partition_step(m.make_loss_fn(), opt)
    tol = (dict(rtol=REL64, atol=1e-15) if dtype == torch.float64
           else dict(atol=1e-6, rtol=1e-5))
    for p in range(P):
        st = opt.init(parts[p].parameters())
        new, nst, loss = one(parts[p], st, {k: v[p] for k, v in batch.items()},
                             gp, active[p])
        torch.testing.assert_close(loss, sl[p], **tol)
        for a, b in zip(new.parameters(), sp.parameters()):
            torch.testing.assert_close(a.detach(), b[p].detach(), **tol)
        assert int(nst.step) == int(so.step[p]) == int(active[p])
        for a, b in zip(nst.mu + nst.nu, so.mu + so.nu):
            torch.testing.assert_close(a, b[p], **tol)


def test_inactive_partition_step_is_bitwise_noop(graphs):
    g, *_ = graphs
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    opt = AdamW(lr=LR, grad_clip=5.0)
    params = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(4)
    with torch.no_grad():                       # -0.0 must survive
        params.layers[0].b[:3] = -0.0
    gp = clone_params(params)
    before = [w.detach().clone() for w in params.parameters()]
    st = opt.init(params.parameters())
    st = st._replace(step=torch.tensor(5, dtype=torch.int32),
                     mu=[t + 0.5 for t in st.mu], nu=[t + 0.25 for t in st.nu])
    one = make_personalize_partition_step(m.make_loss_fn(), opt)
    b = {k: v[0] for k, v in _partition_batch(g, torch.float32).items()}
    new, nst, loss = one(params, st, b, gp, torch.tensor(False))
    assert torch.isfinite(loss)
    for a, w in zip(new.parameters(), before):
        assert torch.equal(a, w)
        assert torch.equal(torch.signbit(a), torch.signbit(w))
    assert int(nst.step) == 5
    for a, b_ in zip(nst.mu + nst.nu, st.mu + st.nu):
        assert torch.equal(a, b_)
    # and an active step does move them
    new, nst, _ = one(new, nst, b, gp, True)
    assert int(nst.step) == 6
    assert any(not torch.equal(a, w) for a, w in zip(new.parameters(), before))


# --------------------------------------------------------------------------
# 4. the factory and the options the oracle does not have
# --------------------------------------------------------------------------

def test_make_engine_dispatches_on_mode(graphs):
    g, pg, *_ = graphs
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    seq = make_engine(m, m.make_loss_fn(), AdamW(), pg,
                      config=EngineConfig(mode="sequential", device="cpu"))
    assert isinstance(seq, SequentialReference) and seq.mode == "sequential"
    eng = make_engine(m, m.make_loss_fn(), AdamW(), pg,
                      config=EngineConfig(device="cpu"))
    assert isinstance(eng, SPMDEngine) and eng.mode == "stacked"
    assert seq.resident_feature_bytes == eng.resident_feature_bytes > 0
    with pytest.raises(ValueError, match="set_device_sampler"):
        seq.phase0_epoch_async(m, None, torch.Generator())
    with pytest.raises(ValueError, match="shared form"):
        seq.evaluate(m.init(0), "test", per_partition_params=True)


@pytest.mark.parametrize("option,value", [
    ("halo_cache", True), ("halo_compress", "int8"),
    ("grad_compress", "topk")])
def test_oracle_communication_options_run(graphs, option, value):
    """The oracle has the options ROADMAP item 10 ports."""
    g, pg, *_ = graphs
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    seq = SequentialReference(m, m.make_loss_fn(), AdamW(), pg, None,
                              EngineConfig(mode="sequential", device="cpu",
                                           **{option: value}))
    micro, _ = seq.evaluate(m.init(0), "val", per_partition_params=False)
    assert micro.shape == (P,)
    assert (seq.last_halo_exchange_bytes > 0) == option.startswith("halo")


@pytest.mark.parametrize("option,value,item", [
    ("feat_store", True, 11), ("feat_groups", 2, 11)])
def test_oracle_unported_options_raise(graphs, option, value, item):
    """Item 11's options on the oracle, as the reference's oracle takes
    them: it IS the all-resident oracle, so it refuses ``feat_store`` with
    the reference's ValueError, and it ignores ``feat_groups``."""
    g, pg, *_ = graphs
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    cfg = EngineConfig(mode="sequential", device="cpu", **{option: value})
    if option == "feat_store":
        with pytest.raises(ValueError, match="all-resident oracle"):
            SequentialReference(m, m.make_loss_fn(), AdamW(), pg, None, cfg)
        return
    seq = SequentialReference(m, m.make_loss_fn(), AdamW(), pg, None, cfg)
    micro, _ = seq.evaluate(m.init(0), "val", per_partition_params=False)
    assert micro.shape == (P,) and seq.cold_h2d_bytes == 0

"""The port's stacked engine against the reference SPMDEngine in stacked
mode on tiny, P=4, from the same params, optimizer state and batches: one
sampled phase-0 epoch, one full-graph phase-0 epoch (2 steps, through the
halo exchange and the aggregation op's backward), one phase-1 epoch with
mixed per-partition budgets, and the evaluation with per-partition params;
plus the full-graph gradient itself and the out-of-place halo landing."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPHyperParams as JGPHyperParams
from repro.core import broadcast_to_partitions as j_broadcast
from repro.core import partition_graph as j_partition_graph
from repro.core.gp.trainer import make_fullgraph_loss_fn as j_fg_loss_fn
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SPMDEngine as JSPMDEngine
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import make_benchmark as j_make_benchmark
from repro.train.optim import AdamW as JAdamW
from repro_torch.core import GPHyperParams, partition_graph
from repro_torch.engine import EngineConfig, SPMDEngine
from repro_torch.engine.stacking import batches_to_device
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph.sage import broadcast_to_partitions
from repro_torch.train.optim import AdamW, opt_state_from_numpy

# params and losses after several float32 AdamW steps whose gradients sum
# in another order than XLA's
ATOL, RTOL = 1e-5, 1e-4
HIDDEN, LR = 16, 1e-2


@pytest.fixture(scope="module")
def both():
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    gj = j_make_benchmark(J_BENCHMARKS["tiny"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, 4,
                           method="ew", seed=0)
    pgj = j_build_partitioned_graph(gj, rj.parts, 4)
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes)
    jopt = JAdamW(lr=LR, grad_clip=5.0)
    jeng = JSPMDEngine(jm, jm.make_loss_fn(), jopt, pgj, JGPHyperParams(),
                       JEngineConfig(mode="stacked", use_pallas_agg=True,
                                     interpret=True))
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    opt = AdamW(lr=LR, grad_clip=5.0)
    eng = SPMDEngine(m, m.make_loss_fn(), opt, pg, GPHyperParams(),
                     EngineConfig(mode="stacked", device="cpu"))
    return g, pg, jm, jopt, jeng, m, opt, eng


def _port_params(m, jparams):
    return GraphSAGE(m.feature_dim, m.hidden_dim,
                     m.num_classes).params_from_numpy(jparams.layers)


def _assert_params(got, jparams, **tol):
    want = GraphSAGE(got.feature_dim, got.hidden_dim,
                     got.num_classes).tensors_from_numpy(jparams.layers)
    for a, b in zip(got.parameters(), want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(),
                                   **(tol or dict(atol=ATOL, rtol=RTOL)))


def _batches(g, iters=3, P=4, B=24, f=(4, 3), seed=0):
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


def test_phase0_epoch_matches(both):
    g, pg, jm, jopt, jeng, m, opt, eng = both
    pj, sj = _mid_run_state(jm, jopt)
    host = _batches(g)
    pj, sj, lj, vj, _ = jeng.phase0_epoch(
        pj, sj, {k: jnp.asarray(v) for k, v in host.items()})
    params = _port_params(m, _mid_run_state(jm, jopt)[0])
    st = opt_state_from_numpy(_mid_run_state(jm, jopt)[1], params)
    params, st, losses, val, dt = eng.phase0_epoch(
        params, st, batches_to_device(host, "cpu"))
    assert losses.shape == (3, 4) and dt > 0
    np.testing.assert_allclose(losses.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    _assert_params(params, pj)
    assert int(st.step) == int(sj.step)
    np.testing.assert_allclose(val.numpy(), np.asarray(vj), atol=1e-6)


def test_phase0_fullgraph_epoch_matches(both):
    g, pg, jm, jopt, jeng, m, opt, eng = both
    pj, sj = _mid_run_state(jm, jopt, seed=1)
    pj, sj, lj, vj, _ = jeng.phase0_fullgraph_epoch(pj, sj, iters=2)
    p0, s0 = _mid_run_state(jm, jopt, seed=1)
    params = _port_params(m, p0)
    params, st, losses, val, _ = eng.phase0_fullgraph_epoch(
        params, opt_state_from_numpy(s0, params), iters=2)
    assert losses.shape == (2, 4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    _assert_params(params, pj)
    np.testing.assert_allclose(val.numpy(), np.asarray(vj), atol=1e-6)


@pytest.mark.parametrize("use_kernel_agg", [True, False])
def test_fullgraph_backward_matches_reference_grad(both, use_kernel_agg):
    """backward() through the 2-layer stacked forward (halo exchange, the
    out-of-place landing, the aggregation op's backward) gives the
    reference's cross-partition mean gradient."""
    g, pg, jm, jopt, jeng, m, opt, eng = both
    if not use_kernel_agg:
        eng = SPMDEngine(m, None, opt, pg, None,
                         EngineConfig(use_kernel_agg=False, device="cpu"))
    pj = jm.init(2)
    loss = j_fg_loss_fn(jeng.fwd)
    lj, gj = jax.vmap(jax.value_and_grad(loss), in_axes=(None, 0),
                      axis_name="parts")(pj, jeng._fg_batch())
    gj = jax.tree.map(lambda x: x.sum(0) / 4, gj)
    params = _port_params(m, pj)
    losses = eng._fg_loss(params, {"shard": eng.shards, "labels": eng.labels,
                                   "train_mask": eng.masks["train"]})
    losses.mean().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(lj),
                               atol=1e-6, rtol=1e-5)
    want = GraphSAGE(m.feature_dim, HIDDEN,
                     m.num_classes).tensors_from_numpy(gj.layers)
    for p, w in zip(params.parameters(), want):
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-4)


def test_phase1_epoch_mixed_budgets(both):
    g, pg, jm, jopt, jeng, m, opt, eng = both
    gp_j = jm.init(3)
    ppj = j_broadcast(gp_j, 4)
    poj = jax.vmap(jopt.init)(ppj)
    host = _batches(g, seed=4)
    budgets = np.array([3, 0, 1, 2], np.int32)
    ppj, poj, lj, vj, _ = jeng.phase1_epoch(
        ppj, poj, {k: jnp.asarray(v) for k, v in host.items()}, gp_j,
        jnp.asarray(budgets))
    gp = _port_params(m, gp_j)
    pp = broadcast_to_partitions(gp, 4)
    frozen = [w[1].clone() for w in pp.parameters()]
    po = opt.init_stacked(pp.parameters())
    pp, po, losses, val, _ = eng.phase1_epoch(
        pp, po, batches_to_device(host, "cpu"), gp, budgets)
    assert po.step.tolist() == budgets.tolist()
    np.testing.assert_allclose(losses.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    _assert_params(pp, ppj)
    for w, f in zip(pp.parameters(), frozen):
        assert torch.equal(w[1], f)
    np.testing.assert_allclose(val.numpy(), np.asarray(vj), atol=1e-6)
    # the per-partition evaluation on the test split
    mj, predj = jeng.evaluate(ppj, "test", per_partition_params=True)
    mt, pred = eng.evaluate(pp, "test", per_partition_params=True)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)
    own = np.asarray(pg.labels) >= 0
    assert (pred.numpy()[own] == np.asarray(predj)[own]).mean() > 0.99
    with pytest.raises(ValueError, match="per-partition"):
        eng.evaluate(pp, "test", per_partition_params=False)


def test_bool_active_is_full_epoch_or_zero(both):
    *_, eng = both
    b = eng._as_budgets(np.array([True, False, True, False]), 5)
    assert b.tolist() == [5, 0, 5, 0] and b.dtype == torch.int32


def test_landing_is_out_of_place_and_relu_backward_works(both):
    """From layer 2 on the forward lands halo rows into a ReLU output;
    landing in place would break that ReLU's backward."""
    from repro_torch.graph.distributed import _halo_exchange
    *_, eng = both
    h0 = torch.randn(4, eng.max_nodes, 8, requires_grad=True)
    h = torch.relu(h0)
    keep = h.detach().clone()
    out = _halo_exchange(h, eng.shards["send_idx"], eng.shards["send_mask"],
                         eng.shards["recv_pos"])
    assert torch.equal(h, keep) and out.data_ptr() != h.data_ptr()
    out.sum().backward()
    assert h0.grad is not None and torch.isfinite(h0.grad).all()

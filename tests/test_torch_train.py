"""The training slice's host modules and train functions against the
reference, from the same NumPy inputs: neighbour sampling, CBS and the GP
controller bitwise; losses, F1 and AdamW (global, and the per-partition
form with an inactive partition) within float32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gp.schedule import GPController as JGPController
from repro.core.gp.schedule import GPScheduleConfig as JGPScheduleConfig
from repro.core.sampler.cbs import CBSampler as JCBSampler
from repro.core.sampler.cbs import cbs_probabilities as j_cbs_probabilities
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import make_benchmark as j_make_benchmark
from repro.graph.sampling import NeighborSampler as JNeighborSampler
from repro.train import losses as j_losses
from repro.train import metrics as j_metrics
from repro.train.optim import AdamW as JAdamW
from repro.train.optim import apply_updates as j_apply_updates
from repro_torch.core.gp.schedule import GPController, GPScheduleConfig
from repro_torch.core.sampler import CBSampler, cbs_probabilities
from repro_torch.graph import BENCHMARKS, GraphSAGE, make_benchmark
from repro_torch.graph.sage import broadcast_to_partitions
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.train import losses, metrics
from repro_torch.train.optim import AdamW, apply_updates, opt_state_from_numpy

# float32 reductions in another order than XLA's
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def graphs():
    return (make_benchmark(BENCHMARKS["tiny"]),
            j_make_benchmark(J_BENCHMARKS["tiny"]))


def test_neighbor_sampler_bitwise(graphs):
    g, gj = graphs
    a, b = NeighborSampler(g, (5, 3), seed=4), JNeighborSampler(gj, (5, 3), seed=4)
    feats = np.asarray(g.features)
    for _ in range(3):
        t = np.random.default_rng(1).choice(g.num_nodes, 40)
        x, y = a.sample(t), b.sample(t)
        for f in ("targets", "nbrs1", "nbrs2"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        for u, v in zip(x.feature_views(feats), y.feature_views(feats)):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("balanced,frac", [(True, 0.25), (False, 1.0)])
def test_cbs_bitwise(graphs, balanced, frac):
    g, gj = graphs
    tr = g.train_idx[:150]
    assert np.array_equal(
        cbs_probabilities(g.indptr, g.indices, g.labels, tr),
        j_cbs_probabilities(gj.indptr, gj.indices, gj.labels, tr))
    kw = dict(batch_size=16, subset_fraction=frac, class_balanced=balanced,
              seed=3)
    a = CBSampler(g.indptr, g.indices, g.labels, tr, **kw)
    b = JCBSampler(gj.indptr, gj.indices, gj.labels, tr, **kw)
    for _ in range(3):
        xa, xb = a.batches(), b.batches()
        assert len(xa) == len(xb)
        assert all(np.array_equal(u, v) for u, v in zip(xa, xb))


@pytest.mark.parametrize("frac", [None, 0.5])
def test_controller_bitwise(frac):
    """The same scores drive the same phase switch, best flags, stops and
    budgets."""
    rng = np.random.default_rng(0)
    kw = dict(max_epochs=30, phase0_fraction=frac, phase1_patience=2)
    a = GPController(3, GPScheduleConfig(**kw))
    b = JGPController(3, JGPScheduleConfig(**kw))
    loss = 2.0
    while not a.done:
        assert not b.done
        if a.phase == 0:
            loss *= 0.99 if a.epoch > 4 else 0.8
            v = float(rng.random())
            assert a.record_phase0(loss, v) == b.record_phase0(loss, v)
            assert a.should_personalize() == b.should_personalize()
            if a.should_personalize():
                a.start_personalization()
                b.start_personalization()
        else:
            nat = rng.integers(1, 9, 3)
            assert np.array_equal(a.phase1_budgets(nat), b.phase1_budgets(nat))
            assert np.array_equal(a.phase1_budgets(nat, taper=True),
                                  b.phase1_budgets(nat, taper=True))
            s = rng.random(3)
            assert np.array_equal(a.record_phase1(s), b.record_phase1(s))
    assert b.done and a.state_dict() == b.state_dict()


def _logits_labels(seed=0, n=64, c=7):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (n, c)).astype(np.float32)
    labels = rng.integers(-1, c, n)          # -1 entries are padding
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return logits, labels, mask


@pytest.mark.parametrize("use_mask", [False, True])
def test_losses_match(use_mask):
    lg, lb, m = _logits_labels()
    mt = torch.as_tensor(m) if use_mask else None
    mj = jnp.asarray(m) if use_mask else None
    t = lambda a: torch.as_tensor(a)
    np.testing.assert_allclose(
        float(losses.cross_entropy_loss(t(lg), t(lb), mt)),
        float(j_losses.cross_entropy_loss(jnp.asarray(lg), jnp.asarray(lb), mj)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        float(losses.cross_entropy_loss(t(lg), t(lb), mt, label_smoothing=0.1)),
        float(j_losses.cross_entropy_loss(jnp.asarray(lg), jnp.asarray(lb), mj,
                                          label_smoothing=0.1)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        float(losses.focal_loss(t(lg), t(lb), 2.0, mt)),
        float(j_losses.focal_loss(jnp.asarray(lg), jnp.asarray(lb), 2.0, mj)),
        atol=ATOL, rtol=RTOL)
    # every example padding: the mean's denominator is max(sum(w), 1)
    none = np.full_like(lb, -1)
    assert float(losses.cross_entropy_loss(t(lg), t(none))) == 0.0


def test_prox_penalty_matches_and_detaches_global():
    rng = np.random.default_rng(2)
    a = [rng.normal(0, 1, s).astype(np.float32) for s in ((5, 4), (4,))]
    b = [rng.normal(0, 1, s).astype(np.float32) for s in ((5, 4), (4,))]
    pa = [torch.as_tensor(x).requires_grad_(True) for x in a]
    pb = [torch.as_tensor(x).requires_grad_(True) for x in b]
    got = losses.prox_penalty(pa, pb)
    want = j_losses.prox_penalty([jnp.asarray(x) for x in a],
                                 [jnp.asarray(x) for x in b])
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=RTOL)
    got.backward()
    assert pb[0].grad is None and pa[0].grad is not None


@pytest.mark.parametrize("seed", [0, 1])
def test_f1_match(seed):
    """NumPy and torch F1 against the reference's, with out-of-range
    predictions (fn-only misses) and padding labels."""
    rng = np.random.default_rng(seed)
    c = 6
    labels = rng.integers(-1, c, 300)
    preds = rng.integers(-2, c + 2, 300)
    got = metrics.f1_scores(preds, labels, c)
    want = j_metrics.f1_scores(preds, labels, c)
    assert (got.micro, got.macro, got.weighted) == (
        want.micro, want.macro, want.weighted)
    t = metrics.f1_scores_torch(torch.as_tensor(preds), torch.as_tensor(labels), c)
    j = j_metrics.f1_scores_jnp(jnp.asarray(preds), jnp.asarray(labels), c)
    np.testing.assert_allclose([float(x) for x in t], [float(x) for x in j],
                               atol=ATOL, rtol=RTOL)


def _jparams(m, seed):
    return JGraphSAGE(feature_dim=m.feature_dim, hidden_dim=m.hidden_dim,
                      num_classes=m.num_classes).init(seed)


def _grads_like(params_j, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(0, scale, p.shape).astype(np.float32)),
        params_j)


@pytest.mark.parametrize("opt_kw", [
    dict(lr=1e-3, grad_clip=5.0),
    dict(lr=3e-3, grad_clip=0.5, weight_decay=0.01, warmup_steps=3)])
def test_adamw_updates_match(opt_kw):
    """Three AdamW steps from the same mid-run state (loaded with
    opt_state_from_numpy), clipping active in the second config."""
    m = GraphSAGE(12, 8, 5)
    pj = _jparams(m, 0)
    jopt, opt = JAdamW(**opt_kw), AdamW(**opt_kw)
    sj = jopt.init(pj)
    sj = sj._replace(step=jnp.asarray(4, jnp.int32),
                     mu=_grads_like(pj, 9, 0.1),
                     nu=jax.tree.map(jnp.abs, _grads_like(pj, 8, 0.1)))
    m.params_from_numpy(pj.layers)
    st = opt_state_from_numpy(sj, m)
    w = [p.detach() for p in m.parameters()]
    for k in range(3):
        gj = _grads_like(pj, k, 2.0)
        uj, sj = jopt.update(gj, sj, pj)
        pj = j_apply_updates(pj, uj)
        g = m.tensors_from_numpy(gj.layers)
        u, st = opt.update(g, st, w)
        w = apply_updates(w, u)
    assert int(st.step) == int(sj.step) and st.step.dtype == torch.int32
    want = GraphSAGE(12, 8, 5).tensors_from_numpy(pj.layers)
    for a, b in zip(w, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL)


def test_adamw_stacked_inactive_partition_bitwise():
    """The per-partition form: each partition clipped by its own norm,
    against the reference's AdamW vmapped over partitions; the inactive
    partition (holding -0.0 weights) comes back bitwise unchanged."""
    P = 3
    m = GraphSAGE(12, 8, 5)
    pj = _jparams(m, 1)
    pj = jax.tree.map(lambda x: jnp.stack([x, 2 * x, x.at[0].set(-0.0)]), pj)
    jopt, opt = JAdamW(lr=1e-2, grad_clip=1.0), AdamW(lr=1e-2, grad_clip=1.0)
    sj = jax.vmap(jopt.init)(pj)
    m.params_from_numpy(pj.layers)
    assert m.num_parts == P
    st = opt.init_stacked(m.parameters())
    assert st.step.shape == (P,) and st.step.dtype == torch.int32
    active = np.array([True, True, False])
    w = [p.detach() for p in m.parameters()]
    w0 = [x.clone() for x in w]
    for k in range(2):
        scale = np.array([0.1, 10.0, 5.0], np.float32)   # partition 1 clips
        gj = jax.tree.map(lambda x: x * scale.reshape(-1, *(1,) * (x.ndim - 1)),
                          _grads_like(pj, k, 1.0))

        def one(g, s, p, a):
            u, s2 = jopt.update(g, s, p)
            sel = lambda new, old: jnp.where(a, new, old)
            return (jax.tree.map(lambda x, y: sel(x + y, x), p, u),
                    jax.tree.map(sel, s2, s))

        pj, sj = jax.vmap(one)(gj, sj, pj, jnp.asarray(active))
        w, st = opt.step_stacked(m.tensors_from_numpy(gj.layers), st, w,
                                 torch.as_tensor(active))
    assert st.step.tolist() == [2, 2, 0]
    want = GraphSAGE(12, 8, 5).tensors_from_numpy(pj.layers)
    for a, b, a0 in zip(w, want, w0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL)
        assert torch.equal(a[2], a0[2])
        assert (torch.signbit(a[2]) == torch.signbit(a0[2])).all()
    for mo in st.mu + st.nu:
        assert (mo[2] == 0).all()


def test_broadcast_and_per_partition_layer():
    """broadcast_to_partitions gives P equal copies; the per-partition
    _layer on (P, B, F, D) inputs equals each partition's own product."""
    m = GraphSAGE(6, 4, 3).init(0)
    pp = broadcast_to_partitions(m, 2)
    assert pp.num_parts == 2 and m.num_parts is None
    with torch.no_grad():
        pp.layers[0].w_self[1] *= 2
    x = torch.randn(2, 5, 3, 6)
    out = pp._layer(pp.layers[0], x, x, True)
    for p in range(2):
        one = GraphSAGE(6, 4, 3)
        one.params_from_numpy([type("L", (), {
            k: getattr(pp.layers[0], k)[p].detach().numpy()
            for k in ("w_self", "w_neigh", "b")})(), m.layers[1]])
        torch.testing.assert_close(out[p], one._layer(one.layers[0], x[p],
                                                      x[p], True))

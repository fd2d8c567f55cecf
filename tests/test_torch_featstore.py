"""The two-tier feature store and the streamed eval (ROADMAP item 11) on
tiny, P=4, against the reference (``repro.graph.featstore``,
``repro.engine.streaming``; the reference engine runs as its own tests run
it, ``use_pallas_agg=False``, f32, in process):

1. the copied host functions (both stores' tiers, ``remap``, ``hot_order``,
   ``feat_peak_bytes``, the budget error) equal to the reference's;
2. ``assemble_features`` bitwise the reference's and the resident plane,
   per partition and stacked, in f32 and f64, for empty tiers too;
3. the engine: the store's evals (with the halo cache and int8 too), async
   epochs and export bitwise the all-resident engine's; the streamed eval's
   micro and preds equal to the port's oracle's and the reference's
   streamed eval's; ``cold_h2d_bytes`` the closed forms;
4. every refusal of the reference's ``tests/test_featstore.py``, with its
   exception type and message, and the budget gate;
5. ``run_eat_distgnn`` and the CLI flags.
"""
import numpy as np
import pytest
import torch

from repro.core import partition_graph as j_partition_graph
from repro.core.sampler import build_device_epoch_sampler as j_build_sampler
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SequentialReference as JSequentialReference
from repro.engine import SPMDEngine as JSPMDEngine
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import featstore as jfs
from repro.graph import make_benchmark as j_make_benchmark
from repro.pipeline import EATConfig as JEATConfig
from repro.pipeline import run_eat_distgnn as j_run_eat_distgnn
from repro.train.optim import AdamW as JAdamW
from repro_torch.core import partition_graph
from repro_torch.core.sampler import build_device_epoch_sampler
from repro_torch.engine import (EngineConfig, SequentialReference,
                                SPMDEngine, build_stacked_feat_store)
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph import featstore as tfs
from repro_torch.graph.sage import broadcast_to_partitions
from repro_torch.launch.train import build_parser, config_from_args, main
from repro_torch.pipeline import EATConfig, run_eat_distgnn
from repro_torch.train.optim import AdamW

P, HIDDEN = 4, 16
FRACS = [0.0, 0.25, 0.5, 1.0]
POLICIES = ["degree", "freq"]


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


def _engine(pg, **kw):
    m = GraphSAGE(pg.features.shape[-1], HIDDEN, int(pg.labels.max()) + 1)
    return SPMDEngine(m, m.make_loss_fn(), AdamW(lr=3e-3, grad_clip=5.0), pg,
                      None, EngineConfig(device="cpu", **kw))


def _jengine(pgj, **kw):
    m = JGraphSAGE(feature_dim=pgj.features.shape[-1], hidden_dim=HIDDEN,
                   num_classes=int(pgj.labels.max()) + 1)
    kw = {"mode": "stacked", "use_pallas_agg": False, **kw}
    return JSPMDEngine(m, m.make_loss_fn(), JAdamW(lr=3e-3, grad_clip=5.0),
                       pgj, config=JEngineConfig(**kw))


def _params(g, seed=0):
    return GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(seed)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------
# 1. the copied host functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("hot_frac", FRACS)
def test_partition_store_matches_reference(graphs, hot_frac, policy):
    _, pg, pgj, _ = graphs
    want = jfs.build_partition_feat_store(pgj, hot_frac, policy, np.float32)
    for dt in (np.float32, torch.float32):
        got = tfs.build_partition_feat_store(pg, hot_frac, policy, dt)
        for k in ("hot", "rows_hot", "cold", "rows_cold"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
    got64 = tfs.build_partition_feat_store(pg, hot_frac, policy, torch.float64)
    assert got64.hot.dtype == np.float64
    np.testing.assert_array_equal(got64.cold, want.cold.astype(np.float64))
    np.testing.assert_array_equal(tfs.reconstruct_features(got64, pg.max_nodes),
                                  np.asarray(pg.features, np.float64))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("hot_frac", FRACS)
def test_global_store_matches_reference(graphs, hot_frac, policy):
    g = graphs[0]
    got = tfs.build_global_feat_store(g, hot_frac, policy, torch.float32)
    want = jfs.build_global_feat_store(g, hot_frac, policy, np.float32)
    for k in ("hot", "remap", "cold", "hot_ids", "cold_ids"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    table = np.concatenate([got.hot, got.cold])
    np.testing.assert_array_equal(table[got.remap], g.features)


def test_hot_order_and_peak_bytes_match_reference():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 5, 200).astype(np.float64)      # many ties
    np.testing.assert_array_equal(tfs.hot_order(scores), jfs.hot_order(scores))
    for kw in ({}, {"hot_rows": 100, "cold_rows": 900},
               {"hot_rows": 100, "cold_rows": 900, "groups": 1},
               {"hot_rows": 0, "cold_rows": 1000, "groups": 3}):
        assert (tfs.feat_peak_bytes(4, 1000, 64, 4, **kw)
                == jfs.feat_peak_bytes(4, 1000, 64, 4, **kw))


def test_budget_and_argument_errors_match_reference(graphs):
    pg, pgj = graphs[1], graphs[2]
    assert issubclass(tfs.FeatureBudgetError, ValueError)
    tfs.check_feat_budget(0.0, 10**12)
    tfs.check_feat_budget(1.0, 999_999)
    for ctx in ("", "mode=stacked"):
        with pytest.raises(tfs.FeatureBudgetError) as got:
            tfs.check_feat_budget(1.0, 1_000_001, ctx)
        with pytest.raises(jfs.FeatureBudgetError) as want:
            jfs.check_feat_budget(1.0, 1_000_001, ctx)
        assert str(got.value) == str(want.value)
    for frac, pol in ((1.5, "degree"), (0.5, "nope")):
        with pytest.raises(ValueError) as got:
            tfs.build_partition_feat_store(pg, frac, pol, np.float32)
        with pytest.raises(ValueError) as want:
            jfs.build_partition_feat_store(pgj, frac, pol, np.float32)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# 2. assembly
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("hot_frac", FRACS)
def test_assemble_features_bitwise(graphs, hot_frac, dtype):
    _, pg, pgj, _ = graphs
    entries, fs = build_stacked_feat_store(pg, hot_frac, "degree", dtype,
                                           "cpu")
    cold = tfs.host_staging(fs.cold, "cpu")
    resident = torch.as_tensor(np.asarray(pg.features), dtype=dtype)
    stacked = tfs.assemble_features(entries["fs_hot"], entries["fs_rows_hot"],
                                    cold, entries["fs_rows_cold"],
                                    pg.max_nodes)
    assert stacked.dtype == dtype and torch.equal(stacked, resident)
    jstore = jfs.build_partition_feat_store(pgj, hot_frac, "degree",
                                            np.float32)
    for p in range(P):
        one = tfs.assemble_features(
            entries["fs_hot"][p], entries["fs_rows_hot"][p], cold[p],
            entries["fs_rows_cold"][p], pg.max_nodes)
        assert torch.equal(one, resident[p])
        if dtype == torch.float32:
            want = np.asarray(jfs.assemble_features(
                jstore.hot[p], jstore.rows_hot[p], jstore.cold[p],
                jstore.rows_cold[p], pgj.max_nodes))
            assert (one.numpy().view(np.uint32) == want.view(np.uint32)).all()


# --------------------------------------------------------------------------
# 3. the engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"halo_cache": True, "halo_refresh_every": 2},
    {"halo_compress": "int8"}], ids=["plain", "cache", "int8"])
def test_store_eval_bitwise_resident(graphs, kw):
    """Both splits, shared and per-partition params, three evals (the
    cache ages, the int8 residual carries): micro, preds and the carried
    state bitwise the resident engine's."""
    g, pg, _, _ = graphs
    base = _engine(pg, **kw)
    store = _engine(pg, feat_store=True, hot_frac=0.25, hot_policy="freq",
                    **kw)
    shared = _params(g)
    per = broadcast_to_partitions(_params(g, 1), P)
    for prm, split, pp in ((shared, "val", False), (per, "test", True),
                           (shared, "test", False)):
        assert _equal(base.evaluate(prm, split, pp),
                      store.evaluate(prm, split, pp))
    for name in ("_halo_state", "_halo_residual"):
        if hasattr(base, name):
            a, b = getattr(base, name), getattr(store, name)
            assert all(torch.equal(a[k], b[k]) for k in a), name
    assert store.cold_h2d_bytes == 3 * store._fs.cold.nbytes


def test_export_bitwise_resident(graphs):
    g, pg, _, _ = graphs
    params = _params(g)
    want = _engine(pg).export_serving_state(params)
    store = _engine(pg, feat_store=True, hot_frac=0.5)
    got = store.export_serving_state(params)
    assert torch.equal(got["logits"], want["logits"])
    assert _equal(got["layers"], want["layers"])
    assert all(torch.equal(got["cache"][k], want["cache"][k])
               for k in want["cache"])
    assert store.cold_h2d_bytes == 0      # a handoff, not a staging


@pytest.fixture(scope="module")
def streamed_reference(graphs):
    """The reference's streamed eval (micro, preds, cold bytes) at G = 1,
    2, 4 on the seed-0 params."""
    g, _, pgj, _ = graphs
    params = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                        num_classes=g.num_classes).init(0)
    out = {}
    for G in (1, 2, 4):
        eng = _jengine(pgj, feat_store=True, hot_frac=0.25, feat_groups=G)
        micro, preds = eng.evaluate(params, "test",
                                    per_partition_params=False)
        out[G] = (np.asarray(micro), np.asarray(preds), eng.cold_h2d_bytes)
    return out


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_streamed_eval_matches_oracle_and_reference(graphs, streamed_reference,
                                                    G, use_kernel):
    g, pg, _, _ = graphs
    params = _params(g)
    eng = _engine(pg, feat_store=True, hot_frac=0.25, feat_groups=G,
                  use_kernel_agg=use_kernel)
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    seq = SequentialReference(m, m.make_loss_fn(), AdamW(), pg, None,
                              EngineConfig(mode="sequential", device="cpu"))
    micro, preds = eng.evaluate(params, "test", per_partition_params=False)
    m_seq, p_seq = seq.evaluate(params, "test", per_partition_params=False)
    assert torch.equal(micro, m_seq) and torch.equal(preds, p_seq)
    m_ref, p_ref, bytes_ref = streamed_reference[G]
    np.testing.assert_array_equal(micro.numpy(), m_ref)
    np.testing.assert_array_equal(preds.numpy(), p_ref)
    assert eng.cold_h2d_bytes == bytes_ref == 2 * eng._fs.cold.nbytes
    if not use_kernel:
        # the oracle's ops in its order: the logits too
        with torch.no_grad():
            logits = torch.stack(eng._streamer.forward(params, False))
        want = torch.stack(seq._full_forward([params] * P))
        assert torch.equal(logits, want)


def test_cold_bytes_closed_form(graphs):
    """k evals stage k·P·C·D·B; a streamed eval 2·P·C·D·B; hot_frac 1.0
    stages nothing (the reference's tests/test_featstore.py closed forms)."""
    g, pg, _, _ = graphs
    params = _params(g)
    eng = _engine(pg, feat_store=True, hot_frac=0.25)
    C, D = eng._fs.cold.shape[1:]
    per_eval = P * C * D * 4
    assert eng._fs.cold.nbytes == per_eval and C == pg.own_cap - round(
        0.25 * pg.own_cap)
    for k in range(1, 4):
        eng.evaluate(params, "val", per_partition_params=False)
        assert eng.cold_h2d_bytes == k * per_eval
    st = _engine(pg, feat_store=True, hot_frac=0.25, feat_groups=2)
    st.evaluate(params, "val", per_partition_params=False)
    assert st.cold_h2d_bytes == 2 * per_eval
    full = _engine(pg, feat_store=True, hot_frac=1.0)
    assert full._fs.cold.shape[1] == 0
    full.evaluate(params, "val", per_partition_params=False)
    assert full.cold_h2d_bytes == 0
    # resident bytes: the hot tier, plus an attached sampler's hot tier
    H = pg.own_cap - C
    assert eng.resident_feature_bytes == P * H * D * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_async_epochs_bitwise_resident_sampler(graphs, dtype):
    """From one generator state, a feature-store engine with a
    feature-store sampler gives the resident engine's losses, val micro and
    params bitwise in both async epochs; the phase-0 epoch stages Nc·D·B +
    P·C·D·B, the phase-1 epoch the same (its sampler gathers, its eval)."""
    g, pg, _, host_train = graphs
    outs = []
    for store in (False, True):
        kw = {"feat_store": True, "hot_frac": 0.25} if store else {}
        eng = _engine(pg, dtype=dtype, **kw)
        ds = build_device_epoch_sampler(
            g, host_train, P, batch_size=32, fanouts=(3, 3), dtype=dtype,
            feat_store=store, hot_frac=0.25, device="cpu")
        eng.set_device_sampler(ds)
        prm = _params(g).to(dtype)
        st = eng.optimizer.init(prm.parameters())
        gen = torch.Generator().manual_seed(5)
        prm, st, l0, v0, _ = eng.phase0_epoch_async(prm, st, gen)
        b0 = eng.cold_h2d_bytes
        pp = broadcast_to_partitions(prm, P)
        po = eng.optimizer.init_stacked(pp.parameters())
        pp, po, l1, v1, _ = eng.phase1_epoch_async(
            pp, po, gen, np.full(P, 2, np.int32), prm)
        outs.append(([l0, v0, l1, v1, *prm.parameters(), *pp.parameters()],
                     b0, eng.cold_h2d_bytes - b0, eng, ds))
    (a, _, _, base, ds_r), (b, b0, b1, eng, ds) = outs
    assert _equal(a, b)
    item = torch.empty(0, dtype=dtype).element_size()
    both = (ds.cold_host.shape[0] + P * eng._fs.cold.shape[1]) * g.feature_dim \
        * item
    assert b0 == b1 == both
    assert eng.resident_feature_bytes == (
        eng.shards["fs_hot"].numel() + ds.hot_feats.numel()) * item
    assert base.resident_feature_bytes == (
        base.shards["features"].numel() + ds_r.features.numel()) * item


def test_async_cold_bytes_match_reference(graphs):
    """The reference's closed form for the async epochs (its
    ``test_async_cold_bytes_closed_form``): each stages the reference
    sampler's cold tier plus the reference engine's, byte for byte."""
    g, pg, pgj, host_train = graphs
    jds = j_build_sampler(g, host_train, P, batch_size=32, fanouts=(3, 3),
                          feat_store=True, hot_frac=0.25)
    jstore = jfs.build_partition_feat_store(pgj, 0.25, "degree", np.float32)
    eng = _engine(pg, feat_store=True, hot_frac=0.25)
    ds = build_device_epoch_sampler(g, host_train, P, batch_size=32,
                                    fanouts=(3, 3), feat_store=True,
                                    hot_frac=0.25, device="cpu")
    eng.set_device_sampler(ds)
    prm = _params(g)
    prm, _, _, _, _ = eng.phase0_epoch_async(
        prm, eng.optimizer.init(prm.parameters()), torch.Generator())
    one = jds.cold_host.nbytes + jstore.cold.nbytes
    assert eng.cold_h2d_bytes == one
    pp = broadcast_to_partitions(prm, P)
    eng.phase1_epoch_async(pp, eng.optimizer.init_stacked(pp.parameters()),
                           torch.Generator(), np.full(P, 2, np.int32), prm)
    assert eng.cold_h2d_bytes == 2 * one


# --------------------------------------------------------------------------
# 4. refusals and the budget
# --------------------------------------------------------------------------

ENGINE_REFUSALS = {
    "groups_without_store": {"feat_groups": 2},
    "groups_out_of_range": {"feat_store": True, "feat_groups": 9},
    "groups_spmd": {"mode": "spmd", "feat_store": True, "feat_groups": 2},
    "groups_with_cache": {"feat_store": True, "feat_groups": 2,
                          "halo_cache": True},
    "groups_with_int8": {"feat_store": True, "feat_groups": 2,
                         "halo_compress": "int8"},
    "groups_with_overlap": {"feat_store": True, "feat_groups": 2,
                            "overlap_halo": True},
    "over_budget": {"feat_budget_mb": 1e-3},
}


def _raised(fn):
    """The name of the ValueError (or subclass) ``fn`` raises, and its
    message."""
    with pytest.raises(ValueError) as e:
        fn()
    return e.type.__name__, str(e.value)


@pytest.mark.parametrize("name", list(ENGINE_REFUSALS))
def test_engine_refusals_match_reference(graphs, name):
    """Each refusal is the reference's exception type and message (the
    spmd one before the mode's own NotImplementedError)."""
    _, pg, pgj, _ = graphs
    kw = ENGINE_REFUSALS[name]
    assert _raised(lambda: _engine(pg, **kw)) == _raised(
        lambda: _jengine(pgj, **kw))


def test_method_refusals_match_reference(graphs):
    """Full-graph training under the store, the fused async phase 0 of a
    streamed engine, the sampler the engine disagrees with, and a
    feature-store ``make_batch`` without its cold rows; the oracle refuses
    the store; with ``feat_groups``, ``auto`` resolves to stacked."""
    import jax
    import jax.numpy as jnp

    g, pg, pgj, host_train = graphs
    params = _params(g)
    jparams = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                         num_classes=g.num_classes).init(0)
    eng, jeng = (_engine(pg, feat_store=True, hot_frac=0.25),
                 _jengine(pgj, feat_store=True, hot_frac=0.25))
    assert _raised(lambda: eng.phase0_fullgraph_epoch(
        params, eng.optimizer.init(params.parameters()))) == _raised(
        lambda: jeng.phase0_fullgraph_epoch(jparams,
                                            jeng.optimizer.init(jparams)))
    skw = dict(batch_size=32, fanouts=(3, 3))
    ds = {s: build_device_epoch_sampler(g, host_train, P, feat_store=s,
                                        device="cpu", **skw)
          for s in (False, True)}
    jds = {s: j_build_sampler(g, host_train, P, feat_store=s, **skw)
           for s in (False, True)}
    plain, jplain = _engine(pg), _jengine(pgj)
    assert _raised(lambda: eng.set_device_sampler(ds[False])) == _raised(
        lambda: jeng.set_device_sampler(jds[False]))
    assert _raised(lambda: plain.set_device_sampler(ds[True])) == _raised(
        lambda: jplain.set_device_sampler(jds[True]))
    nodes = torch.zeros((P, 32), dtype=torch.int64)
    assert _raised(lambda: ds[True].make_batch(
        torch.Generator(), nodes, nodes > 0)) == _raised(
        lambda: jds[True].make_batch(jax.random.PRNGKey(0),
                                     jnp.zeros((32,), jnp.int32),
                                     jnp.ones((32,), jnp.float32)))
    st, jst = (_engine(pg, mode="auto", feat_store=True, feat_groups=2),
               _jengine(pgj, mode="auto", feat_store=True, feat_groups=2))
    assert st.mode == jst.mode == "stacked"
    st.set_device_sampler(ds[True])
    jst.set_device_sampler(jds[True])
    assert _raised(lambda: st.phase0_epoch_async(
        params, st.optimizer.init(params.parameters()),
        torch.Generator())) == _raised(lambda: jst.phase0_epoch_async(
            jparams, jst.optimizer.init(jparams),
            jax.random.split(jax.random.PRNGKey(0), P)))
    m, jm = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes), jeng.model
    assert _raised(lambda: SequentialReference(
        m, m.make_loss_fn(), AdamW(), pg, None, EngineConfig(
            mode="sequential", device="cpu", feat_store=True))) == _raised(
        lambda: JSequentialReference(jm, jm.make_loss_fn(), JAdamW(), pgj,
                                     config=JEngineConfig(mode="sequential",
                                                          feat_store=True)))


@pytest.mark.parametrize("extra", [
    {"feat_store": True, "full_graph_train": True},
    {"feat_store": True, "feat_groups": 2, "async_generalize": True}],
    ids=["full_graph", "groups_async"])
def test_pipeline_refusals_match_reference(extra):
    assert _raised(lambda: run_eat_distgnn(EATConfig(
        device="cpu", dataset="tiny", **extra))) == _raised(
        lambda: j_run_eat_distgnn(JEATConfig(dataset="tiny", **extra)))


def test_budget_gate(graphs):
    """A budget between the streamed store's peak and the all-resident
    plane refuses the resident engine and the unstreamed store, and admits
    the streamed store; a generous budget admits the resident engine."""
    g, pg, _, _ = graphs
    base_peak = tfs.feat_peak_bytes(P, pg.max_nodes, g.feature_dim, 4)
    budget = base_peak * 0.6 / 1e6
    for kw in ({}, {"feat_store": True, "hot_frac": 0.25}):
        with pytest.raises(tfs.FeatureBudgetError, match="feat_budget_mb"):
            _engine(pg, feat_budget_mb=budget, **kw)
    eng = _engine(pg, feat_store=True, hot_frac=0.25, feat_groups=1,
                  feat_budget_mb=budget)
    assert eng.mode == "stacked" and eng._feat_peak_bytes(pg) <= budget * 1e6
    _engine(pg, feat_budget_mb=10.0)


# --------------------------------------------------------------------------
# 5. the pipeline and the CLI
# --------------------------------------------------------------------------

BASE = dict(dataset="tiny", num_parts=4, max_epochs=2, hidden_dim=16,
            batch_size=64, fanouts=(5, 5), phase0_fraction=0.5, seed=0)


@pytest.fixture(scope="module")
def resident_run():
    return run_eat_distgnn(EATConfig(device="cpu", **BASE))


@pytest.mark.parametrize("extra", [
    {"feat_store": True, "hot_frac": 0.5},
    {"feat_store": True, "hot_frac": 0.25, "hot_policy": "freq"},
    {"feat_store": True, "hot_frac": 1.0}], ids=["half", "freq", "all_hot"])
def test_pipeline_matches_reference(resident_run, extra):
    """Losses and micro-F1 as the reference's; ``cold_h2d_bytes``, the
    per-phase host-to-device bytes (the cold deltas) and the resident bytes
    equal to the reference's; at hot_frac 1.0 the counters are the no-store
    run's."""
    got = run_eat_distgnn(EATConfig(device="cpu", **BASE, **extra))
    want = j_run_eat_distgnn(JEATConfig(**BASE, **extra))
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-4)
    assert got.f1.micro == want.f1.micro
    for k in ("cold_h2d_bytes", "host_to_device_bytes_phase0",
              "host_to_device_bytes_phase1", "resident_feature_bytes"):
        assert getattr(got, k) == getattr(want, k), k
    assert set(got.summary()) == set(want.summary())
    for k in ("feat_store", "hot_frac", "cold_h2d_mb", "resident_feature_mb"):
        assert got.summary()[k] == want.summary()[k], k
    # the store does not touch host-sampled training
    r0 = resident_run
    assert got.loss_history == r0.loss_history and got.f1.micro == r0.f1.micro
    cold = got.cold_h2d_bytes
    assert (got.host_to_device_bytes_phase0 + got.host_to_device_bytes_phase1
            == r0.host_to_device_bytes_phase0
            + r0.host_to_device_bytes_phase1 + cold)
    if extra["hot_frac"] == 1.0:
        assert cold == 0
        assert (got.host_to_device_bytes_phase0,
                got.host_to_device_bytes_phase1) == (
            r0.host_to_device_bytes_phase0, r0.host_to_device_bytes_phase1)
        assert 0 < got.resident_feature_bytes <= r0.resident_feature_bytes


def test_pipeline_streamed_and_async(resident_run):
    """``feat_groups`` 2: the resident run's losses (the host-sampled
    training is untouched, and on the CPU the streamed eval picks the same
    models), twice the cold bytes an eval.  The async store run: the
    resident async run's losses and micro-F1 bitwise, cold bytes of
    (Nc + P·C)·D·B an epoch plus the test eval's P·C·D·B."""
    r0 = resident_run
    got = run_eat_distgnn(EATConfig(device="cpu", **BASE, feat_store=True,
                                    hot_frac=0.5, feat_groups=2))
    assert got.loss_history == r0.loss_history and got.f1.micro == r0.f1.micro
    per_eval = got.cold_h2d_bytes // (2 * (got.epochs_run + 1))
    assert got.cold_h2d_bytes == 2 * (got.epochs_run + 1) * per_eval > 0
    kw = dict(BASE, async_generalize=True, async_personalize=True)
    a = run_eat_distgnn(EATConfig(device="cpu", **kw))
    b = run_eat_distgnn(EATConfig(device="cpu", **kw, feat_store=True,
                                  hot_frac=0.5))
    assert a.loss_history == b.loss_history and a.f1.micro == b.f1.micro
    g = make_benchmark(BENCHMARKS["tiny"])
    nc = g.num_nodes - round(0.5 * g.num_nodes)
    assert b.cold_h2d_bytes == b.epochs_run * (
        nc * g.feature_dim * 4 + per_eval) + per_eval
    assert b.resident_feature_bytes < a.resident_feature_bytes


def test_cli_feat_store_flags(capsys):
    """The five flags with the reference's defaults (those of its
    ``EATConfig`` and its CLI) and choices, into ``EATConfig``; a streamed
    store run through ``main`` on the CPU."""
    names = ("feat_store", "hot_frac", "hot_policy", "feat_groups",
             "feat_budget_mb")
    argv = ["gnn", "--feat-store", "--hot-frac", "0.25", "--hot-policy",
            "freq", "--feat-groups", "2", "--feat-budget-mb", "64"]
    parser = build_parser()
    d = parser.parse_args(["gnn"])
    want = tuple(getattr(JEATConfig(), k) for k in names)
    assert tuple(getattr(d, k) for k in names) == want == (
        False, 0.5, "degree", 0, 0.0)
    assert tuple(getattr(EATConfig(), k) for k in names) == want
    assert tuple(getattr(parser.parse_args(argv), k) for k in names) == (
        True, 0.25, "freq", 2, 64.0)
    with pytest.raises(SystemExit):
        parser.parse_args(["gnn", "--hot-policy", "lru"])
    cfg = config_from_args(build_parser().parse_args(argv))
    assert (cfg.feat_store, cfg.hot_frac, cfg.hot_policy, cfg.feat_groups,
            cfg.feat_budget_mb) == (True, 0.25, "freq", 2, 64.0)
    capsys.readouterr()
    assert main(["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs",
                 "2", "--hidden", "8", "--batch-size", "64", "--fanout", "3",
                 "--phase0-frac", "0.5", "--feat-store", "--hot-frac", "0.5",
                 "--feat-groups", "2"]) == 0
    out = capsys.readouterr().out
    assert '"feat_store": true' in out and '"cold_h2d_mb"' in out

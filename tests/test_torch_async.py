"""The port's async epochs (ROADMAP item 9, stacked mode) against the
reference's, and the async pipeline on tiny.

Replay parity: a torch generator's stream is not jax's, so the port's
async epochs are held against the reference's on the SAME drawn batches.
A test-only sampler hands the port's engine the batches that the
reference's ``DeviceEpochSampler`` draws under the key splits of its
partition programs (``_phase0_async_partition_program`` and
``_async_partition_program``: ``kd, ke = split(key)``, the epoch from
``kd``, iteration i's batch from ``split(ke, I)[i]``), one partition at a
time; both engines start from the same converted params and optimizer
state.  Params and losses agree within atol 1e-5, rtol 1e-4 (float32 AdamW
steps whose gradients sum in another order than XLA's), validation
micro-F1 is equal, and a partition with budget 0 comes back bitwise
frozen.

The pipeline: ``async_personalize`` alone, then with ``async_generalize``
and a raising ``_EpochPrefetcher`` swapped in, as the reference's fixtures
(``tests/test_cbs_device.py``) run them: no host draw in either phase,
device draws made, finite losses, micro-F1 above 0.30, the reference's
summary keys; two same-seed runs bitwise equal; the train CLI with both
flags."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPHyperParams as JGPHyperParams
from repro.core import partition_graph as j_partition_graph
from repro.core.sampler import build_device_epoch_sampler as j_build_sampler
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SPMDEngine as JSPMDEngine
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import make_benchmark as j_make_benchmark
from repro.pipeline import EATConfig as JEATConfig
from repro.pipeline import EATResult as JEATResult
from repro.train.metrics import F1Report as JF1Report
from repro.train.optim import AdamW as JAdamW
from repro_torch import pipeline
from repro_torch.core import GPHyperParams, partition_graph
from repro_torch.core.sampler import (device_draw_count, host_draw_count,
                                      reset_device_draw_count)
from repro_torch.engine import EngineConfig, SPMDEngine
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.pipeline import EATConfig, run_eat_distgnn
from repro_torch.train.optim import AdamW, opt_state_from_numpy

ATOL, RTOL = 1e-5, 1e-4
HIDDEN, LR, P = 16, 1e-2, 4
FANOUTS = (3, 3)


@pytest.fixture(scope="module")
def both():
    g = make_benchmark(BENCHMARKS["tiny"])
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                            method="ew", seed=0).parts
    pg = build_partitioned_graph(g, parts, P)
    gj = j_make_benchmark(J_BENCHMARKS["tiny"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, P,
                           method="ew", seed=0)
    pgj = j_build_partitioned_graph(gj, rj.parts, P)
    host_train = [g.train_idx[parts[g.train_idx] == p] for p in range(P)]
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes)
    jopt = JAdamW(lr=LR, grad_clip=5.0)
    jeng = JSPMDEngine(jm, jm.make_loss_fn(), jopt, pgj, JGPHyperParams(),
                       JEngineConfig(mode="stacked", use_pallas_agg=True,
                                     interpret=True))
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    eng = SPMDEngine(m, m.make_loss_fn(), AdamW(lr=LR, grad_clip=5.0), pg,
                     GPHyperParams(), EngineConfig(mode="stacked",
                                                   device="cpu"))
    return gj, host_train, jm, jopt, jeng, m, eng


class _Replay:
    """Hands the port's engine the batches the reference's sampler ``jds``
    draws for ``keys``: ``draw_epoch`` returns the stacked epoch, and each
    ``make_batch`` call the next iteration's stacked batch.  The generator
    argument is ignored."""

    def __init__(self, jds, keys):
        self.num_batches = jds.num_batches
        epochs, batches = [], []
        for p in range(P):
            kd, ke = jax.random.split(keys[p])
            nodes, valid = jds.draw_epoch(kd, jds.logp[p], jds.train_idx[p],
                                          jds.k[p])
            iter_keys = jax.random.split(ke, jds.num_batches)
            epochs.append((np.asarray(nodes), np.asarray(valid)))
            batches.append([jds.make_batch(iter_keys[i], nodes[i], valid[i])
                            for i in range(jds.num_batches)])
        self.epoch = tuple(torch.as_tensor(np.stack(a)) for a in zip(*epochs))
        self.batches = [
            {k: torch.as_tensor(np.stack([np.asarray(batches[p][i][k])
                                          for p in range(P)]))
             for k in batches[0][i]}
            for i in range(self.num_batches)]
        self.made = 0

    def draw_epoch(self, gen):
        return self.epoch

    def make_batch(self, gen, nodes, valid):
        i = self.made
        self.made += 1
        assert torch.equal(nodes, self.epoch[0][:, i])
        assert torch.equal(valid, self.epoch[1][:, i])
        return self.batches[i]


def _mid_run_state(jm, jopt, seed):
    """Params from a seed plus an optimizer state a few steps in."""
    pj = jm.init(seed)
    rng = np.random.default_rng(seed + 5)
    mom = lambda s: jax.tree.map(
        lambda p: jnp.asarray(np.abs(rng.normal(0, s, p.shape))
                              .astype(np.float32)), pj)
    return pj, jopt.init(pj)._replace(step=jnp.asarray(3, jnp.int32),
                                      mu=mom(0.01), nu=mom(0.001))


def _stack(tree):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (P,) + x.shape), tree)


def _port(m, jparams):
    return GraphSAGE(m.feature_dim, m.hidden_dim,
                     m.num_classes).params_from_numpy(jparams.layers)


def _assert_params(got, jparams):
    want = GraphSAGE(got.feature_dim, got.hidden_dim,
                     got.num_classes).tensors_from_numpy(jparams.layers)
    for a, b in zip(got.parameters(), want):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("class_balanced,batch", [(True, 8), (False, 32)],
                         ids=["cbs", "uniform"])
def test_phase0_epoch_async_replays_reference(both, class_balanced, batch):
    gj, host_train, jm, jopt, jeng, m, eng = both
    jds = j_build_sampler(gj, host_train, P, batch_size=batch,
                          subset_fraction=0.25 if class_balanced else 1.0,
                          class_balanced=class_balanced, fanouts=FANOUTS)
    assert jds.num_batches >= 2
    keys = jax.random.split(jax.random.PRNGKey(3), P)
    replay = _Replay(jds, keys)
    jeng.set_device_sampler(jds)
    pj, sj = _mid_run_state(jm, jopt, seed=1)
    params = _port(m, pj)
    st = opt_state_from_numpy(sj, params)
    pj, sj, lj, vj, _ = jeng.phase0_epoch_async(pj, sj, keys)

    eng.set_device_sampler(replay)
    params, st, losses, val, dt = eng.phase0_epoch_async(params, st, None)
    assert replay.made == jds.num_batches
    assert losses.shape == (jds.num_batches, P) == np.asarray(lj).shape
    assert dt > 0 and eng.last_eval_seconds == 0.0
    np.testing.assert_allclose(losses.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    _assert_params(params, pj)
    assert int(st.step) == int(sj.step)
    np.testing.assert_array_equal(val.numpy(), np.asarray(vj))


@pytest.mark.parametrize("budgets", [[0, 2, 1, 2], [5, 0, 3, 1]],
                         ids=["i_run-below-I", "i_run-at-I"])
def test_phase1_epoch_async_replays_reference(both, budgets):
    gj, host_train, jm, jopt, jeng, m, eng = both
    jds = j_build_sampler(gj, host_train, P, batch_size=4,
                          subset_fraction=0.25, class_balanced=True,
                          fanouts=FANOUTS)
    assert jds.num_batches == 5
    keys = jax.random.split(jax.random.PRNGKey(7), P)
    replay = _Replay(jds, keys)
    jeng.set_device_sampler(jds)
    gj_params, sj = _mid_run_state(jm, jopt, seed=2)
    jpp, jpo = _stack(gj_params), _stack(sj)
    pp0 = _port(m, jpp)
    pp = _port(m, jpp)
    po = opt_state_from_numpy(jpo, pp)
    po0 = opt_state_from_numpy(jpo, pp)
    gparams = _port(m, gj_params)
    jpp, jpo, lj, vj, _ = jeng.phase1_epoch_async(
        jpp, jpo, keys, jnp.asarray(budgets, jnp.int32), gj_params)

    eng.set_device_sampler(replay)
    pp, po, losses, val, _ = eng.phase1_epoch_async(
        pp, po, None, np.asarray(budgets, np.int32), gparams)
    i_run = min(1 << int(np.ceil(np.log2(max(budgets)))), jds.num_batches)
    assert losses.shape == (i_run, P) == np.asarray(lj).shape
    assert replay.made == i_run
    np.testing.assert_allclose(losses.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=RTOL)
    _assert_params(pp, jpp)
    np.testing.assert_array_equal(po.step.numpy(), np.asarray(jpo.step))
    np.testing.assert_array_equal(val.numpy(), np.asarray(vj))
    frozen = budgets.index(0)
    for a, b in zip(list(pp.parameters()) + po.mu + po.nu,
                    list(pp0.parameters()) + po0.mu + po0.nu):
        assert torch.equal(a[frozen], b[frozen])
    assert int(po.step[frozen]) == int(po0.step[frozen])


def test_async_epochs_need_a_sampler():
    g = make_benchmark(BENCHMARKS["tiny"])
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                            method="ew", seed=0).parts
    m = GraphSAGE(g.feature_dim, 8, g.num_classes).init(0)
    eng = SPMDEngine(m, m.make_loss_fn(), AdamW(), build_partitioned_graph(
        g, parts, P), None, EngineConfig(device="cpu"))
    with pytest.raises(ValueError, match="set_device_sampler"):
        eng.phase0_epoch_async(m, None, None)
    with pytest.raises(ValueError, match="set_device_sampler"):
        eng.phase1_epoch_async(m, None, None, np.ones(P, np.int32), m)


# ------------------------------------------------------------ the pipeline

ASYNC = dict(dataset="tiny", num_parts=4, partition_method="ew",
             use_cbs=True, use_gp=True, max_epochs=12, hidden_dim=32,
             batch_size=64, fanouts=(3, 3), lr=3e-3, seed=0,
             flatten_tol=0.08, device="cpu")


class _ForbiddenPrefetcher:
    def __init__(self, *a, **k):
        raise AssertionError(
            "_EpochPrefetcher constructed on the fully-async path")


def _run(**flags):
    host_before = host_draw_count()
    reset_device_draw_count()
    result = run_eat_distgnn(EATConfig(**ASYNC, **flags))
    return result, host_draw_count() - host_before, device_draw_count()


@pytest.fixture(scope="module")
def async_runs():
    """``async_personalize`` alone, then both flags with the prefetcher's
    constructor raising."""
    out = {"personalize": _run(async_personalize=True)}
    orig = pipeline._EpochPrefetcher
    pipeline._EpochPrefetcher = _ForbiddenPrefetcher
    try:
        out["both"] = _run(async_personalize=True, async_generalize=True)
    finally:
        pipeline._EpochPrefetcher = orig
    return out


def _reference_summary_keys():
    f1 = JF1Report(0.0, 0.0, 0.0, np.zeros(1), np.zeros(1))
    return set(JEATResult(JEATConfig(), f1, np.zeros(4), np.zeros(4), 0.0,
                          0.0, 0.0, 0.0, 0, 0).summary())


@pytest.mark.parametrize("which", ["personalize", "both"])
def test_async_pipeline_draws_on_device_only(async_runs, which):
    result, host_delta, dev_draws = async_runs[which]
    assert result.phase1_epochs > 0, "personalization never ran"
    assert result.host_draws_phase1 == 0
    # 0.4 of the epochs generalize by default under async_personalize
    assert result.personalize_start_epoch == int(0.4 * ASYNC["max_epochs"])
    assert dev_draws >= result.phase1_epochs
    if which == "both":
        assert result.host_draws_phase0 == 0 and host_delta == 0
        assert dev_draws == result.epochs_run
        # the staged sampler, then nothing per epoch in phase 0
        assert result.host_to_device_bytes_phase0 > 0
        assert result.host_to_device_bytes_phase1 == 4 * P * \
            result.phase1_epochs
    else:
        assert result.host_draws_phase0 > 0
        assert dev_draws == result.phase1_epochs
        assert result.host_to_device_bytes_phase1 > 4 * P * \
            result.phase1_epochs


@pytest.mark.parametrize("which", ["personalize", "both"])
def test_async_pipeline_still_learns(async_runs, which):
    result = async_runs[which][0]
    assert result.f1.micro > 0.30
    assert np.isfinite(result.loss_history).all()
    assert len(result.loss_history) == result.epochs_run
    assert set(result.summary()) == _reference_summary_keys()
    s = result.summary()
    assert s["async_personalize"] and s["async_generalize"] == (
        which == "both")


def test_async_pipeline_same_seed_bitwise(async_runs):
    """A second run with the same seed draws the same epochs, so its
    losses, validation scores and predictions are bitwise the first's."""
    first = async_runs["both"][0]
    again = run_eat_distgnn(EATConfig(**ASYNC, async_personalize=True,
                                      async_generalize=True))
    assert again.loss_history == first.loss_history
    assert again.val_history == first.val_history
    assert again.f1.micro == first.f1.micro
    for a, b in zip(again.final_params.parameters(),
                    first.final_params.parameters()):
        assert torch.equal(a, b)


def test_train_cli_async_on_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs",
                 "4", "--hidden", "8", "--batch-size", "64", "--fanout", "3",
                 "--phase0-frac", "0.5", "--async-generalize",
                 "--async-personalize"]) == 0
    out = capsys.readouterr().out
    assert "[phase-0] epoch" in out and "[phase-1] epoch" in out
    assert '"async_personalize": true' in out
    assert '"async_generalize": true' in out

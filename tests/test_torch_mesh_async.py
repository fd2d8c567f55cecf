"""The partition mesh's async phases and two-tier feature store
(``EngineConfig(mode="spmd")``, ROADMAP item 14 part 2) on the CPU: a
world of 1 and a world of 4 gloo ranks, each spawned once for the module
(``repro_torch.launch.mesh``), on tiny with hidden 32; rank functions in
``tests/_torch_mesh_part2_ranks.py``.

1. A world of 1 is bitwise the stacked engine: both async epochs (their
   batches included) in float64 and float32, the store's evals, export and
   async epochs at every ``hot_frac``, and ``run_eat_distgnn`` with both
   async flags, alone and with the store.
2. In a world of 4 each rank's batches are bitwise its row of the stacked
   engine's (every rank draws the whole epoch and both fanouts); the async
   epochs in float32 and the async pipelines are within the reference's
   spmd-against-stacked tolerances of the stacked port, and in float64
   within rel 1e-12 of the port's ``SequentialReference``.
3. The store's evals, export and async epochs at ``hot_frac`` 0.25 and 1.0
   are bitwise the resident mesh's, and ``cold_h2d_bytes`` and the resident
   bytes equal the stacked engine's.
4. Against the reference: this process runs the reference's stacked
   ``phase0_epoch_async`` / ``phase1_epoch_async`` (plain aggregation);
   the batches its sampler drew go to the ranks, where a replay sampler
   hands each rank its row; the mesh's epochs lie within the spmd
   tolerances (the reference's own ``test_phase0_async_spmd_parity_fp64``
   shows its stacked and spmd async epochs bitwise).
5. Every rank returns the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_part2_ranks as m2
import _torch_mesh_ranks as mr
from repro.core import GPHyperParams as JGPHyperParams
from repro.core.sampler import build_device_epoch_sampler as j_build_sampler
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SPMDEngine as JSPMDEngine
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import make_benchmark as j_make_benchmark
from repro.train.optim import AdamW as JAdamW
from repro_torch.graph import GraphSAGE
from repro_torch.launch.mesh import spawn_partition_world
from repro_torch.train.optim import opt_state_from_numpy

# the reference's spmd-against-stacked tolerances (max |diff|), as
# tests/test_torch_mesh.py states them
P0_LOSS, P0_PARAMS, P1_LOSS, P1_PARAMS = 1e-6, 1e-6, 1e-5, 1e-5
VAL_F1, PRED_MISMATCH = 5e-3, 3
REL64 = 1e-12
DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the ranks, so the bitwise
    comparisons run this process's products as the ranks run theirs."""
    import os
    saved = os.environ.get("OMP_NUM_THREADS"), torch.get_num_threads()
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    if saved[0] is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = saved[0]
    torch.set_num_threads(saved[1])


# --------------------------------------------------------------------------
# the reference's epochs, and the batches the ranks replay
# --------------------------------------------------------------------------

def _replay(jds, keys, P):
    """The epoch and per-iteration stacked batches the reference's sampler
    draws under its partition programs' key splits (``kd, ke =
    split(key)``, the epoch from ``kd``, batch i from ``split(ke, I)[i]``),
    as tensors."""
    epochs, batches = [], []
    for p in range(P):
        kd, ke = jax.random.split(keys[p])
        nodes, valid = jds.draw_epoch(kd, jds.logp[p], jds.train_idx[p],
                                      jds.k[p])
        iter_keys = jax.random.split(ke, jds.num_batches)
        epochs.append((np.asarray(nodes), np.asarray(valid)))
        batches.append([jds.make_batch(iter_keys[i], nodes[i], valid[i])
                        for i in range(jds.num_batches)])
    epoch = tuple(torch.as_tensor(np.stack(a)) for a in zip(*epochs))
    stacked = [{k: torch.as_tensor(np.stack([np.asarray(batches[p][i][k])
                                             for p in range(P)]))
                for k in batches[0][i]} for i in range(jds.num_batches)]
    return epoch, stacked


def _mid_run_state(jm, jopt, seed):
    """Params from a seed plus an optimizer state a few steps in
    (``tests/test_torch_async.py``'s start)."""
    pj = jm.init(seed)
    rng = np.random.default_rng(seed + 5)
    mom = lambda s: jax.tree.map(
        lambda p: jnp.asarray(np.abs(rng.normal(0, s, p.shape))
                              .astype(np.float32)), pj)
    return pj, jopt.init(pj)._replace(step=jnp.asarray(3, jnp.int32),
                                      mu=mom(0.01), nu=mom(0.001))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's stacked async epochs on tiny (P = 4, hidden 32),
    and the file of replayed batches and converted start states the ranks
    read."""
    P = 4
    g = j_make_benchmark(J_BENCHMARKS["tiny"])
    parts = mr.tiny_parts(mr.make_benchmark(mr.BENCHMARKS["tiny"]), P)
    pgj = j_build_partitioned_graph(g, parts, P)
    host_train = [g.train_idx[parts[g.train_idx] == p] for p in range(P)]
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=mr.HIDDEN,
                    num_classes=g.num_classes)
    jopt = JAdamW(lr=mr.LR, grad_clip=5.0)
    jeng = JSPMDEngine(jm, jm.make_loss_fn(), jopt, pgj, JGPHyperParams(),
                       JEngineConfig(mode="stacked", use_pallas_agg=False))
    jds = j_build_sampler(g, host_train, P, batch_size=8,
                          subset_fraction=0.25, class_balanced=True,
                          fanouts=(3, 3))
    assert jds.num_batches >= 2
    jeng.set_device_sampler(jds)
    port = lambda tree: GraphSAGE(g.feature_dim, mr.HIDDEN,
                                  g.num_classes).params_from_numpy(tree.layers)
    src, want = {}, {}

    keys = jax.random.split(jax.random.PRNGKey(3), P)
    pj, sj = _mid_run_state(jm, jopt, seed=1)
    params = port(pj)
    src["async0"] = {"replay": _replay(jds, keys, P),
                     "start": (params, opt_state_from_numpy(sj, params))}
    pj, _, lj, vj, _ = jeng.phase0_epoch_async(pj, sj, keys)
    want["async0"] = (pj, np.array(lj), np.array(vj))

    keys = jax.random.split(jax.random.PRNGKey(7), P)
    gj, sj = _mid_run_state(jm, jopt, seed=2)
    stack = lambda t: jax.tree.map(
        lambda x: jnp.broadcast_to(x, (P,) + x.shape), t)
    jpp, jpo = stack(gj), stack(sj)
    pp = port(jpp)
    bud = np.array([2, 0, 1, 3], np.int32)
    src["async1"] = {"replay": _replay(jds, keys, P),
                     "start": (pp, opt_state_from_numpy(jpo, pp)),
                     "budgets": bud, "global": port(gj)}
    jpp, _, lj, vj, _ = jeng.phase1_epoch_async(jpp, jpo, keys,
                                                jnp.asarray(bud), gj)
    want["async1"] = (jpp, np.array(lj), np.array(vj))
    path = str(tmp_path_factory.mktemp("replay") / "replay.pt")
    torch.save(src, path)
    # the reference's params in the port's parameters() order
    want = {k: ([w.detach().numpy() for w in port(p).parameters()], l, v)
            for k, (p, l, v) in want.items()}
    return path, want


def _world(tmp_path_factory, P, replay_path, name):
    return spawn_partition_world(
        m2.async_world, P, (P, replay_path), device="cpu",
        workdir=str(tmp_path_factory.mktemp(name)), timeout_s=60,
        join_timeout_s=240)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, reference):
    return _world(tmp_path_factory, 4, reference[0], "w4")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(tmp_path_factory, 1, None, "w1")


# --------------------------------------------------------------------------
# the stacked port's side, in this process
# --------------------------------------------------------------------------

_STACKED: dict = {}


def _stacked(P, what, dtype, mode="stacked"):
    key = (P, what, dtype, mode)
    if key not in _STACKED:
        g, pg = mr.tiny_case(P)
        if what in m2.ASYNC:
            eng, opt = mr.engine(pg, g, mode, dtype)
            _STACKED[key] = m2.run_async(eng, opt, g, P, what,
                                         m2.device_sampler(g, P, dtype),
                                         dtype)
        elif what == "store":
            _STACKED[key] = m2.store_runs(g, pg, P, mode)
        elif what == "pipeline":
            _STACKED[key] = m2.digest(m2.async_pipeline(P, mode))
        else:
            _STACKED[key] = m2.digest(m2.async_pipeline(
                P, mode, feat_store=True, hot_frac=0.5))
    return _STACKED[key]


def _equal(a, b) -> bool:
    """Bitwise equality of nested results (tensors, arrays, scalars)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _rows(batches, r, what):
    """Rank ``r``'s rows of stacked batches as the mesh's epochs make
    them: phase 0's without the partition axis, phase 1's with one of
    1."""
    rows = r if what == "async0" else slice(r, r + 1)
    return [{k: v[rows] for k, v in b.items()} for b in batches]


def _maxdiff(a, b) -> float:
    return max(float((torch.as_tensor(x).double()
                      - torch.as_tensor(y).double()).abs().max())
               for x, y in zip(a, b, strict=True))


# --------------------------------------------------------------------------
# 1. a world of 1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("what", m2.ASYNC)
def test_world_of_one_async_epochs_bitwise_stacked(world1, what, dtype):
    got = world1[0][what, str(DTYPES[dtype])]
    want = _stacked(1, what, DTYPES[dtype])
    assert len(got["batches"]) > 1
    assert _equal(got["batches"], _rows(want["batches"], 0, what))
    drop = lambda d: {k: v for k, v in d.items() if k != "batches"}
    assert _equal(drop(got), drop(want))


@pytest.mark.parametrize("what", ["store", "pipeline", "pipeline_store"])
def test_world_of_one_store_and_pipelines_bitwise_stacked(world1, what):
    got, want = world1[0][what], _stacked(1, what, torch.float32)
    if what == "store":
        assert _equal(got, want)
        return
    assert got["engine"] == "spmd" and want["engine"] == "stacked"
    assert got["epochs"] > len(got["iters"]) > 0        # both phases ran
    drop = lambda d: {k: v for k, v in d.items() if k != "engine"}
    assert _equal(drop(got), drop(want))


# --------------------------------------------------------------------------
# 2. a world of 4 against the stacked port and the oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("what", m2.ASYNC)
def test_rank_batches_are_rows_of_the_stacked_batches(world4, what):
    want = _stacked(4, what, torch.float32)["batches"]
    for r in range(4):
        got = world4[r][what, str(torch.float32)]["batches"]
        assert len(got) == len(want) > 1
        assert _equal(got, _rows(want, r, what)), r


@pytest.mark.parametrize("what", m2.ASYNC)
def test_f32_async_epochs_within_spmd_tolerance(world4, what):
    got = world4[0][what, str(torch.float32)]
    want = _stacked(4, what, torch.float32)
    loss_tol, param_tol = ((P0_LOSS, P0_PARAMS) if what == "async0"
                           else (P1_LOSS, P1_PARAMS))
    assert got["losses"].shape == want["losses"].shape
    assert _maxdiff([got["losses"]], [want["losses"]]) <= loss_tol
    assert _maxdiff(got["params"], want["params"]) <= param_tol
    assert _maxdiff([got["val"]], [want["val"]]) <= VAL_F1
    assert torch.equal(got["step"], want["step"])


@pytest.mark.parametrize("what", m2.ASYNC)
def test_f64_async_epochs_match_the_oracle(world4, what):
    got = world4[0][what, str(torch.float64)]
    want = _stacked(4, what, torch.float64, mode="sequential")
    assert got["losses"].shape == want["losses"].shape
    for a, b in zip(got["params"], want["params"], strict=True):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=REL64, atol=0)
    torch.testing.assert_close(got["losses"], want["losses"], rtol=REL64,
                               atol=0)
    torch.testing.assert_close(got["val"], want["val"], atol=1e-6, rtol=0)
    assert torch.equal(got["step"], want["step"])


def _test_preds(g, pg, params_list):
    eng, _ = mr.engine(pg, g, "stacked", torch.float32)
    pp = mr.per_partition_start(mr.start_params(g, torch.float32), 4)
    with torch.no_grad():
        for w, v in zip(pp.parameters(), params_list, strict=True):
            w.copy_(v)
    return eng.evaluate(pp, "test", per_partition_params=True)[1]


@pytest.mark.parametrize("what", ["pipeline", "pipeline_store"])
def test_async_pipeline_within_spmd_tolerance(world4, what):
    """``run_eat_distgnn`` with both async flags (and the store) on the
    mesh against the stacked pipeline: the same iterations and byte
    counters (``cold_h2d_bytes`` too), phase-0 losses within 1e-6, phase-1
    losses and params within 1e-5, val micro-F1 within 5e-3, at most 3 test
    predictions apart."""
    got, want = world4[0][what], _stacked(4, what, torch.float32)
    assert got["engine"] == "spmd" and want["engine"] == "stacked"
    assert got["iters"] == want["iters"] and got["epochs"] == want["epochs"]
    assert got["bytes"] == want["bytes"] and got["cold"] == want["cold"]
    n0 = len(got["iters"])
    assert 0 < n0 < got["epochs"]
    d = np.abs(got["loss"] - want["loss"])
    assert d[:n0].max() <= P0_LOSS and d[n0:].max() <= P1_LOSS, d
    assert _maxdiff(got["params"], want["params"]) <= P1_PARAMS
    assert np.abs(got["val"] - want["val"]).max() <= VAL_F1
    g, pg = mr.tiny_case(4)
    mismatch = int((_test_preds(g, pg, got["params"])
                    != _test_preds(g, pg, want["params"])).sum())
    assert mismatch <= PRED_MISMATCH
    assert abs(got["micro"] - want["micro"]) <= VAL_F1


# --------------------------------------------------------------------------
# 3. the feature store on the mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hot_frac", m2.HOT_FRACS)
def test_store_bitwise_the_resident_mesh(world4, hot_frac):
    runs = world4[0]["store"]
    got, resident = runs[hot_frac], runs[None]
    for k in ("eval", *m2.ASYNC):
        assert _equal(got[k], resident[k]), k
    want = _stacked(4, "store", torch.float32)[hot_frac]["bytes"]
    assert got["bytes"] == want
    cold, res = got["bytes"]
    assert (cold > 0) == (hot_frac < 1.0)
    assert res < resident["bytes"][1] or hot_frac == 1.0


# --------------------------------------------------------------------------
# 4. against the reference's replayed epochs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("what", m2.ASYNC)
def test_replayed_epochs_match_the_reference(world4, reference, what):
    got = world4[0]["replay"][what]
    params, losses, val = reference[1][what]
    loss_tol, param_tol = ((P0_LOSS, P0_PARAMS) if what == "async0"
                           else (P1_LOSS, P1_PARAMS))
    assert got["made"] == losses.shape[0] > 1
    assert tuple(got["losses"].shape) == losses.shape
    assert _maxdiff([got["losses"]], [losses]) <= loss_tol
    assert _maxdiff(got["params"], params) <= param_tol
    assert _maxdiff([got["val"]], [val]) <= VAL_F1


# --------------------------------------------------------------------------
# 5. every rank the same
# --------------------------------------------------------------------------

def test_every_rank_returns_the_same(world4):
    drop = lambda out: {k: ({**v, "batches": None} if isinstance(v, dict)
                            and "batches" in v else v)
                        for k, v in out.items()}
    for r in range(1, 4):
        assert _equal(drop(world4[r]), drop(world4[0])), r

"""The partition mesh (``EngineConfig(mode="spmd")``, ROADMAP item 14
part 1) on the CPU: worlds of gloo ranks (``repro_torch.launch.mesh``),
each spawned once for the module, on tiny with hidden 32.

1. ``mesh_exchange`` across a world of 2 and of 4 is bitwise the stacked
   transpose ``recv[q][p] = sent[p][q]``, forward and backward, for
   ``ring_chunks`` 0, 1 and 3;
2. the mesh's evals and export are bitwise the stacked engine's from the
   same params, with the segment op and with the plain aggregation, and
   ``ring_chunks=2`` bitwise ``ring_chunks=0``;
3. phase 0 (sampled and full-graph) and phase 1 in float64 are within rel
   1e-12 of the port's ``SequentialReference``;
4. in float32 the epochs and ``run_eat_distgnn`` (sampled and full-graph)
   are within the reference's own spmd-against-stacked tolerances
   (``tests/test_engine_parity.py::test_spmd_shard_map_matches_stacked``);
5. a world of 1 is bitwise the stacked engine and pipeline;
6. every rank returns the same result;
7. ``feat_groups`` raises the reference's message, a partition that
   differs across ranks raises on every rank, and a rank that fails or
   hangs fails the world within its timeouts (the communication options
   of item 14's part 3 run on the mesh: ``tests/test_torch_mesh_comm.py``).
"""
import time

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as mr
from repro_torch.launch.mesh import spawn_partition_world

# the reference's spmd-against-stacked tolerances (pmean sums the P
# gradients in another order than the stacked mean): max |diff|
P0_LOSS, P0_PARAMS, P1_LOSS, P1_PARAMS = 1e-6, 1e-6, 1e-5, 1e-5
VAL_F1, PRED_MISMATCH = 5e-3, 3
# float64 against the oracle (tests/test_torch_sequential.py's REL64)
REL64 = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks and this process each use one intra-op thread (what
    torchrun gives its workers): P + 1 processes share the host's cores,
    and the bitwise comparisons need this process's products to run as
    the ranks' do."""
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


def _world(tmp_path_factory, fn, P, args, name):
    return spawn_partition_world(
        fn, P, args, device="cpu", workdir=str(tmp_path_factory.mktemp(name)),
        timeout_s=60, join_timeout_s=240)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, mr.world_checks, 4, (4, True), "w4")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _world(tmp_path_factory, mr.world_checks, 2, (2, False), "w2")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _world(tmp_path_factory, mr.world_checks, 1, (1, True), "w1")


@pytest.fixture(scope="module")
def case4():
    return mr.tiny_case(4)


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


def _maxdiff(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b, strict=True))


# --------------------------------------------------------------------------
# 1. the exchange
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ring", mr.RINGS)
@pytest.mark.parametrize("P", [2, 4])
def test_exchange_is_the_stacked_transpose(world2, world4, P, ring):
    outs = {2: world2, 4: world4}[P]
    sent = torch.stack([mr.exchange_inputs(P, r, ring)[0] for r in range(P)])
    up = torch.stack([mr.exchange_inputs(P, r, ring)[1] for r in range(P)])
    for r in range(P):
        recv, grad = outs[r]["exchange"][ring]
        # recv_r[q] = sent_q[r]; its VJP sends up_q[r] back to rank r
        assert torch.equal(recv, sent.transpose(0, 1)[r])
        assert torch.equal(grad, up.transpose(0, 1)[r])


# --------------------------------------------------------------------------
# 2. evals and export from the same params
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["kernel", "plain", "ring2"])
def test_eval_and_export_bitwise_the_stacked_engine(world4, case4, which):
    g, pg = case4
    got = world4[0]["eval_False" if which == "plain" else
                    ("ring2" if which == "ring2" else "eval_True")]
    eng, _ = mr.engine(pg, g, "stacked", torch.float32,
                       use_kernel_agg=which != "plain")
    want = mr.eval_and_export(eng, g, 4)
    assert _equal(got, want)
    if which == "ring2":
        assert _equal(got, world4[0]["eval_True"])


# --------------------------------------------------------------------------
# 3-4. epochs: float64 against the oracle, float32 against stacked
# --------------------------------------------------------------------------

@pytest.mark.parametrize("what", mr.EPOCHS)
def test_f64_epochs_match_the_oracle(world4, case4, what):
    g, pg = case4
    got = world4[0][what, str(torch.float64)]
    eng, opt = mr.engine(pg, g, "sequential", torch.float64)
    want = mr.run_epoch(eng, opt, g, 4, what, torch.float64)
    assert got["losses"].shape == want["losses"].shape
    for a, b in zip(got["params"], want["params"], strict=True):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=REL64, atol=0)
    torch.testing.assert_close(got["losses"], want["losses"], rtol=REL64,
                               atol=0)
    torch.testing.assert_close(got["val"], want["val"], atol=1e-6, rtol=0)
    assert torch.equal(got["step"], want["step"])


@pytest.mark.parametrize("what", mr.EPOCHS)
def test_f32_epochs_within_spmd_tolerance(world4, case4, what):
    g, pg = case4
    got = world4[0][what, str(torch.float32)]
    eng, opt = mr.engine(pg, g, "stacked", torch.float32)
    want = mr.run_epoch(eng, opt, g, 4, what, torch.float32)
    loss_tol, param_tol = ((P1_LOSS, P1_PARAMS) if what == "phase1"
                           else (P0_LOSS, P0_PARAMS))
    assert got["losses"].shape == want["losses"].shape
    assert _maxdiff([got["losses"]], [want["losses"]]) <= loss_tol
    assert _maxdiff(got["params"], want["params"]) <= param_tol
    assert _maxdiff([got["val"]], [want["val"]]) <= VAL_F1
    assert torch.equal(got["step"], want["step"])


def _test_preds(g, pg, params_list):
    """Test predictions of per-partition params through one stacked
    engine (the same forward for both runs compared)."""
    eng, _ = mr.engine(pg, g, "stacked", torch.float32)
    pp = mr.per_partition_start(mr.start_params(g, torch.float32), pg.num_parts)
    with torch.no_grad():
        for w, v in zip(pp.parameters(), params_list, strict=True):
            w.copy_(v)
    return eng.evaluate(pp, "test", per_partition_params=True)[1]


@pytest.mark.parametrize("fg", [False, True], ids=["sampled", "fullgraph"])
def test_f32_pipeline_within_spmd_tolerance(world4, case4, fg):
    """``run_eat_distgnn`` on the mesh against the stacked pipeline: the
    same iterations and byte counters, phase-0 losses within 1e-6, phase-1
    losses and params within 1e-5, val micro-F1 within 5e-3, at most 3 test
    predictions apart."""
    from repro_torch.pipeline import run_eat_distgnn
    g, pg = case4
    got = world4[0]["pipeline", fg]
    want = mr.pipeline_digest(run_eat_distgnn(
        mr.pipeline_config(4, "stacked", full_graph_train=fg)))
    assert got["engine"] == "spmd" and want["engine"] == "stacked"
    assert got["iters"] == want["iters"] and got["epochs"] == want["epochs"]
    assert got["bytes"] == want["bytes"]
    n0 = len(got["iters"])
    assert 0 < n0 < got["epochs"]
    d = np.abs(got["loss"] - want["loss"])
    assert d[:n0].max() <= P0_LOSS and d[n0:].max() <= P1_LOSS, d
    assert _maxdiff(got["params"], want["params"]) <= P1_PARAMS
    assert np.abs(got["val"] - want["val"]).max() <= VAL_F1
    mismatch = int((_test_preds(g, pg, got["params"])
                    != _test_preds(g, pg, want["params"])).sum())
    assert mismatch <= PRED_MISMATCH
    assert abs(got["micro"] - want["micro"]) <= VAL_F1


# --------------------------------------------------------------------------
# 5-6. a world of 1; every rank the same
# --------------------------------------------------------------------------

def test_world_of_one_is_bitwise_stacked(world1):
    from repro_torch.pipeline import run_eat_distgnn
    g, pg = mr.tiny_case(1)
    got = world1[0]
    for agg in (True, False):
        eng, _ = mr.engine(pg, g, "stacked", torch.float32,
                           use_kernel_agg=agg)
        assert _equal(got[f"eval_{agg}"], mr.eval_and_export(eng, g, 1))
    for dtype in (torch.float64, torch.float32):
        for what in mr.EPOCHS:
            eng, opt = mr.engine(pg, g, "stacked", dtype)
            assert _equal(got[what, str(dtype)],
                          mr.run_epoch(eng, opt, g, 1, what, dtype)), what
    for fg in (False, True):
        want = mr.pipeline_digest(run_eat_distgnn(mr.pipeline_config(
            1, "stacked", full_graph_train=fg, centralized=True)))
        assert got["pipeline", fg].pop("engine") == "spmd"
        assert want.pop("engine") == "stacked"
        assert _equal(got["pipeline", fg], want)


def test_every_rank_returns_the_same(world4):
    drop = lambda out: {k: v for k, v in out.items()
                        if k not in ("exchange", "fingerprint")}
    for r in range(1, 4):
        assert _equal(drop(world4[r]), drop(world4[0])), r


# --------------------------------------------------------------------------
# 7. refusals and failures
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["feat_groups"])
def test_part2_options_raise_item_14(world4, name):
    """What the mesh refuses beyond the stacked engine: ``feat_groups``,
    with the reference's message."""
    got = world4[0]["refusals"]
    assert set(got) == {"feat_groups"}, got
    assert "one-partition-per-device mesh" in got[name], got[name]
    assert got[name].endswith("use stacked mode"), got[name]


def test_partition_mismatch_raises_on_every_rank(world4):
    for r in range(4):
        assert "partition differs" in world4[r]["fingerprint"], r


def test_a_failing_rank_fails_the_world(tmp_path):
    """Rank 1 raises; rank 0, waiting on its collective, loses its peer:
    whichever error the parent sees first, the call raises at once."""
    import torch.multiprocessing as mp
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException):
        spawn_partition_world(mr.failing_rank, 2, device="cpu",
                              workdir=str(tmp_path), timeout_s=60,
                              join_timeout_s=60)
    assert time.monotonic() - t0 < 45


def test_a_hanging_peer_fails_within_the_group_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception):
        spawn_partition_world(mr.hanging_peer, 2, (60.0,), device="cpu",
                              workdir=str(tmp_path), timeout_s=3,
                              join_timeout_s=50)
    assert time.monotonic() - t0 < 40


def test_a_world_past_its_join_timeout_is_killed(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn_partition_world(mr.sleeping_rank, 2, (60.0,), device="cpu",
                              workdir=str(tmp_path), join_timeout_s=2)
    assert time.monotonic() - t0 < 30

"""The overlapped split forward (``graph/distributed.py::make_overlap_forward``)
and its parts on tiny, P=4, hidden 16:

1. overlapped against synchronous on owned rows: f64, predictions equal and
   logits within 1e-12, with either aggregation backend; and against the
   reference's ``make_overlap_forward`` under its stacked engine in f32
   (logits, and one full-graph step's gradient), the reference's side
   also with its ``ring_chunks`` ring;
2. ``make_kernel_split_agg`` through the plain path against
   ``make_ref_split_agg`` (f64 dyadic, bitwise on each half's rows), and
   ``gradcheck`` of both halves in f64 with the boundary half's ``(P,)``
   tensor ``row_base``;
3. ``build_stacked_split_vjp_blocks`` bitwise the reference's arrays, with
   each half's work plan over its own stacked row space;
4. the CLI's ``--overlap-halo``, ``--ring-chunks`` and ``--engine`` reach
   ``EngineConfig``, and the combinations that are refused raise.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import GPHyperParams as JGPHyperParams
from repro.core import partition_graph as j_partition_graph
from repro.core.gp.trainer import make_fullgraph_loss_fn as j_fg_loss_fn
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SPMDEngine as JSPMDEngine
from repro.engine.stacking import \
    build_stacked_split_vjp_blocks as j_split_blocks
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import make_benchmark as j_make_benchmark
from repro.train.optim import AdamW as JAdamW
from repro_torch.core import partition_graph
from repro_torch.engine import (EngineConfig, SPMDEngine,
                                build_stacked_split_vjp_blocks)
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph.distributed import (make_kernel_split_agg,
                                           make_ref_split_agg)
from repro_torch.graph.sage import broadcast_to_partitions
from repro_torch.kernels.segment_agg import PLAN_KEYS, blocks_to_device
from repro_torch.pipeline import EATConfig, run_eat_distgnn

# f32 sums in another order than XLA's segment_sum / the Pallas matmul
ATOL, RTOL = 5e-6, 1e-5
HIDDEN, P = 16, 4


@pytest.fixture(scope="module")
def setup():
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, P)
    gj = j_make_benchmark(J_BENCHMARKS["tiny"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, P,
                           method="ew", seed=0)
    pgj = j_build_partitioned_graph(gj, rj.parts, P)
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes)
    return g, pg, pgj, jm


def _engine(g, pg, dtype=torch.float32, **kw):
    m = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes)
    return m, SPMDEngine(m, m.make_loss_fn(), None, pg, None,
                         EngineConfig(dtype=dtype, device="cpu", **kw))


def _owned(pg):
    return torch.as_tensor(np.arange(pg.max_nodes)[None]
                           < np.asarray(pg.n_own)[:, None])


# --------------------------------------------------------------------------
# 1. overlapped against synchronous, and against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("per_partition", [False, True],
                         ids=["shared", "per_partition"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_overlap_equals_sync_on_owned_rows_f64(setup, use_kernel,
                                               per_partition):
    g, pg, *_ = setup
    params = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(1).double()
    if per_partition:
        params = broadcast_to_partitions(params, P)
        with torch.no_grad():
            for w in params.parameters():
                w.mul_(torch.linspace(0.9, 1.1, P, dtype=torch.float64).view(
                    P, *(1,) * (w.dim() - 1)))
    out = {}
    for overlap in (False, True):
        _, eng = _engine(g, pg, torch.float64, use_kernel_agg=use_kernel,
                         overlap_halo=overlap)
        with torch.no_grad():
            out[overlap] = eng.fwd(params, eng.shards)
        out[overlap, "eval"] = eng.evaluate(params, "test",
                                            per_partition_params=per_partition)
    own = _owned(pg)
    torch.testing.assert_close(out[True][own], out[False][own], rtol=0,
                               atol=1e-12)
    assert torch.equal(out[True].argmax(-1)[own], out[False].argmax(-1)[own])
    assert torch.equal(out[True, "eval"][0], out[False, "eval"][0])
    # rows past own_cap are the re-embedding's zeros (the trash row too)
    assert (out[True][:, pg.own_cap:] == 0).all()
    assert (out[True][:, pg.trash_row] == 0).all()


@pytest.mark.parametrize("use_kernel,j_pallas,ring_chunks", [
    (True, True, 0), (False, False, 1), (False, False, 2), (True, False, 3),
    (True, False, "more")])
def test_overlap_forward_matches_reference(setup, use_kernel, j_pallas,
                                           ring_chunks):
    """The port's transpose exchange gives what the reference's ring gives
    with 1, 2, 3 and more than maxS chunks a step."""
    g, pg, pgj, jm = setup
    if ring_chunks == "more":
        ring_chunks = pg.send_idx.shape[-1] + 5
    jeng = JSPMDEngine(jm, jm.make_loss_fn(), JAdamW(lr=1e-3), pgj,
                       JGPHyperParams(),
                       JEngineConfig(mode="stacked", use_pallas_agg=j_pallas,
                                     overlap_halo=True,
                                     ring_chunks=ring_chunks))
    jp = jm.init(0)
    want = np.asarray(jax.vmap(jeng.fwd, axis_name="parts",
                               in_axes=(None, 0))(jp, jeng.shards))
    m, eng = _engine(g, pg, use_kernel_agg=use_kernel, overlap_halo=True,
                     ring_chunks=ring_chunks)
    params = GraphSAGE(g.feature_dim, HIDDEN, g.num_classes).init(0)
    with torch.no_grad():
        got = eng.fwd(params, eng.shards).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    mj, predj = jeng.evaluate(jp, "val", per_partition_params=False)
    mt, pred = eng.evaluate(params, "val", per_partition_params=False)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_overlap_fullgraph_grad_matches_reference(setup, use_kernel):
    """backward() through the 2-layer split forward (both halves' backward,
    the landing and the send gather) gives the reference's cross-partition
    mean gradient."""
    g, pg, pgj, jm = setup
    jeng = JSPMDEngine(jm, jm.make_loss_fn(), JAdamW(lr=1e-3), pgj,
                       JGPHyperParams(),
                       JEngineConfig(mode="stacked", use_pallas_agg=True,
                                     overlap_halo=True))
    pj = jm.init(2)
    lj, gj = jax.vmap(jax.value_and_grad(j_fg_loss_fn(jeng.fwd)),
                      in_axes=(None, 0), axis_name="parts")(pj,
                                                            jeng._fg_batch())
    gj = jax.tree.map(lambda x: x.sum(0) / P, gj)
    m, eng = _engine(g, pg, use_kernel_agg=use_kernel, overlap_halo=True)
    params = GraphSAGE(g.feature_dim, HIDDEN,
                       g.num_classes).params_from_numpy(pj.layers)
    losses = eng._fg_loss(params, {"shard": eng.shards, "labels": eng.labels,
                                   "train_mask": eng.masks["train"]})
    losses.mean().backward()
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(lj),
                               atol=1e-6, rtol=1e-5)
    want = GraphSAGE(g.feature_dim, HIDDEN,
                     g.num_classes).tensors_from_numpy(gj.layers)
    for p_, w in zip(params.parameters(), want):
        np.testing.assert_allclose(p_.grad.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-4)


# --------------------------------------------------------------------------
# 2. the split aggregation pair
# --------------------------------------------------------------------------

def _split_shards(pg, dtype):
    bi, bb = build_stacked_split_vjp_blocks(pg)
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int64))
    return {"blk_int": blocks_to_device(bi, "cpu"),
            "blk_bnd": blocks_to_device(bb, "cpu"),
            "n_int": idx(pg.n_int), "int_src": idx(pg.int_src),
            "int_dst": idx(pg.int_dst), "bnd_src": idx(pg.bnd_src),
            "bnd_dst": idx(pg.bnd_dst),
            "deg": torch.as_tensor(pg.deg, dtype=dtype)}


def test_kernel_split_agg_plain_path_bitwise_f64_dyadic(setup):
    _, pg, *_ = setup
    sh = _split_shards(pg, torch.float64)
    x = torch.as_tensor(np.random.default_rng(0).integers(
        -8, 9, (P, pg.max_nodes, 6)).astype(np.float64))
    x[:, pg.trash_row] = 0
    ki, kb = make_kernel_split_agg(pg.own_cap)
    ri, rb = make_ref_split_agg(pg.own_cap)
    rows = np.arange(pg.own_cap)[None]
    n_int, n_own = np.asarray(pg.n_int)[:, None], np.asarray(pg.n_own)[:, None]
    interior = torch.as_tensor(rows < n_int)
    boundary = torch.as_tensor((rows >= n_int) & (rows < n_own))
    got_i, want_i = ki(x, sh), ri(x, sh)
    got_b, want_b = kb(x, sh), rb(x, sh)
    assert got_i.shape == got_b.shape == (P, pg.own_cap, 6)
    assert torch.equal(got_i[interior], want_i[interior])
    assert torch.equal(got_b[boundary], want_b[boundary])
    # each kernel half writes zeros outside its own rows
    assert (got_i[~interior] == 0).all() and (got_b[~boundary] == 0).all()
    assert boundary.any() and interior.any()


@pytest.mark.parametrize("half", ["interior", "boundary"])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_split_agg_gradcheck_f64(setup, half, backend):
    _, pg, *_ = setup
    sh = _split_shards(pg, torch.float64)
    assert sh["n_int"].shape == (P,)
    aggs = (make_kernel_split_agg if backend == "kernel"
            else make_ref_split_agg)(pg.own_cap)
    agg = aggs[0] if half == "interior" else aggs[1]
    x = torch.randn(P, pg.max_nodes, 1, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    x[:, pg.trash_row] = 0
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: agg(t, sh), (x,))


# --------------------------------------------------------------------------
# 3. the split blocks
# --------------------------------------------------------------------------

def test_split_blocks_match_reference_bitwise(setup):
    _, pg, pgj, _ = setup
    got, want = build_stacked_split_vjp_blocks(pg), j_split_blocks(pgj)
    for g_half, w_half in zip(got, want):
        assert set(w_half) <= set(g_half)
        for k, v in w_half.items():
            assert g_half[k].dtype == np.asarray(v).dtype, k
            assert np.array_equal(g_half[k], np.asarray(v)), k
        # the plan numbers this half's own stacked row space
        P_, nb, _ = g_half["src"].shape
        bn = g_half["deg"].shape[-1]
        assert g_half["row_space"].shape == (P_, nb, bn, 0)
        assert g_half["t_row_space"].shape == (P_, g_half["t_src"].shape[1],
                                               bn, 0)
        assert all(k in g_half and "t_" + k in g_half for k in PLAN_KEYS)


# --------------------------------------------------------------------------
# 4. the engine's and the CLI's surface
# --------------------------------------------------------------------------

def test_overlap_engine_state_and_refusals(setup):
    g, pg, *_ = setup
    for use_kernel, keys in ((True, {"blk_int", "blk_bnd"}),
                             (False, {"int_src", "int_dst", "bnd_src",
                                      "bnd_dst", "deg"})):
        m, eng = _engine(g, pg, use_kernel_agg=use_kernel, overlap_halo=True)
        assert keys <= set(eng.shards) and "n_int" in eng.shards
        assert not {"edge_src", "blk"} & set(eng.shards)
        with pytest.raises(ValueError, match="overlap_halo"):
            eng.export_serving_state(m.init(0))
    for kw in ({"halo_cache": True}, {"halo_compress": "int8"}):
        with pytest.raises(ValueError, match="pick one"):
            _engine(g, pg, overlap_halo=True, **kw)
    with pytest.raises(ValueError, match="ring_chunks"):
        _engine(g, pg, overlap_halo=True, ring_chunks=-1)


def test_cli_flags_reach_engine_config(monkeypatch, capsys):
    import repro_torch.pipeline as pipeline
    from repro_torch.launch.train import main

    seen = []
    real = pipeline.make_engine

    def spy(*args, config=None, **kw):
        seen.append(config)
        return real(*args, config=config, **kw)

    monkeypatch.setattr(pipeline, "make_engine", spy)
    base = ["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs", "2",
            "--hidden", "8", "--batch-size", "64", "--fanout", "4",
            "--phase0-frac", "0.5"]
    for extra, want, engine in (
            (["--overlap-halo", "--ring-chunks", "3", "--full-graph-train"],
             ("auto", True, 3), "stacked"),
            (["--engine", "sequential", "--overlap-halo"],
             ("sequential", True, 0), "sequential"),
            (["--engine", "sequential"], ("sequential", False, 0),
             "sequential")):
        assert main(base + extra) == 0
        cfg = seen[-1]
        assert (cfg.mode, cfg.overlap_halo, cfg.ring_chunks) == want
        out = capsys.readouterr().out
        assert f"engine[{engine}]" in out and "[phase-1] epoch" in out
        assert f'"overlap_halo": {str(want[1]).lower()}' in out


@pytest.mark.parametrize("extra", [
    {"engine_mode": "sequential", "halo_cache": True},
    {"engine_mode": "sequential", "grad_compress": "topk"},
    {"overlap_halo": True, "halo_compress": "int8"}])
def test_communication_combinations_run_or_pick_one(extra):
    """The oracle runs the options ROADMAP item 10 ports; the overlapped
    forward with compression is the reference's "pick one" refusal."""
    cfg = EATConfig(device="cpu", dataset="tiny", max_epochs=2,
                    hidden_dim=8, batch_size=64, fanouts=(3, 3),
                    phase0_fraction=0.5, **extra)
    if extra.get("overlap_halo"):
        with pytest.raises(ValueError, match="pick one"):
            run_eat_distgnn(cfg)
        return
    r = run_eat_distgnn(cfg)
    assert r.engine_mode == "sequential" and r.epochs_run == 2
    assert np.isfinite(r.loss_history).all()


@pytest.mark.parametrize("extra,item", [
    ({"engine_mode": "sequential", "feat_store": True}, 11),
    ({"overlap_halo": True, "checkpoint_dir": "ckpt"}, 12),
    ({"engine_mode": "sequential", "resume": True}, 12)])
def test_refused_combinations_name_their_item(extra, item, tmp_path):
    """The feature store with the oracle (item 11) is the reference's
    refusal: the oracle is the all-resident oracle.  Item 12 is ported:
    an overlapped run, or a sequential run, killed after epoch 1 and
    resumed is bitwise the uninterrupted one."""
    from repro_torch.robustness import FaultPlan, InjectedCrash
    if item == 11:
        with pytest.raises(ValueError, match="all-resident oracle"):
            run_eat_distgnn(EATConfig(device="cpu", dataset="tiny", **extra))
        return
    kw = dict(device="cpu", dataset="tiny", max_epochs=4, hidden_dim=8,
              batch_size=64, fanouts=(3, 3), phase0_fraction=0.5,
              **{k: v for k, v in extra.items()
                 if k not in ("checkpoint_dir", "resume")})
    ck = str(tmp_path / "ckpt")
    base = run_eat_distgnn(EATConfig(**kw))
    with pytest.raises(InjectedCrash):
        run_eat_distgnn(EATConfig(**kw, checkpoint_dir=ck),
                        fault_plan=FaultPlan(crash_epochs=frozenset({1})))
    r = run_eat_distgnn(EATConfig(**kw, checkpoint_dir=ck, resume=True))
    assert r.resumed_from_epoch == 1
    assert r.engine_mode == base.engine_mode == (
        "sequential" if "engine_mode" in extra else "stacked")
    assert (r.loss_history, r.val_history) == (base.loss_history,
                                               base.val_history)
    for a, b in zip(r.final_params.parameters(),
                    base.final_params.parameters()):
        assert torch.equal(a, b)

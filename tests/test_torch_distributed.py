"""Stacked distributed forward: the halo exchange lands the same rows as the
reference's vmapped all_to_all, and the port's export_serving_state
(layers, logits, cache) agrees with the reference SPMDEngine's stacked
export on tiny, P=4, with either package on either aggregation backend."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPHyperParams
from repro.core import partition_graph as j_partition_graph
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SPMDEngine as JSPMDEngine
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import make_benchmark as j_make_benchmark
from repro.graph.distributed import _halo_exchange as j_halo_exchange
from repro.train.optim import AdamW
from repro_torch.core import partition_graph
from repro_torch.engine import EngineConfig, SPMDEngine
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph.distributed import (_halo_exchange,
                                           make_distributed_forward)

# f32 sums in another order than XLA's segment_sum / the Pallas matmul
ATOL, RTOL = 5e-6, 1e-5


@pytest.fixture(scope="module")
def setup():
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    gj = j_make_benchmark(J_BENCHMARKS["tiny"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, 4,
                           method="ew", seed=0)
    pgj = j_build_partitioned_graph(gj, rj.parts, 4)
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=16,
                    num_classes=g.num_classes)
    m = GraphSAGE(g.feature_dim, 16, g.num_classes).init(0)
    return pg, pgj, jm, jm.init(0), m


def test_halo_exchange_direction_bitwise(setup):
    """recv[q][p] = sent[p][q]: the transpose must land exactly the rows
    the reference's vmapped all_to_all lands (a wrong direction still runs,
    with wrong halo rows)."""
    pg, pgj, *_ = setup
    h = np.random.default_rng(0).normal(
        0, 1, (4, pg.max_nodes, 8)).astype(np.float32)
    h[:, pg.trash_row] = 0
    fn = jax.vmap(lambda x, si, sm, rp: j_halo_exchange(x, si, sm, rp, "p"),
                  axis_name="p")
    want = np.asarray(fn(jnp.asarray(h), jnp.asarray(pgj.send_idx),
                         jnp.asarray(pgj.send_mask), jnp.asarray(pgj.recv_pos)))
    got = _halo_exchange(
        torch.tensor(h), torch.as_tensor(pg.send_idx.astype(np.int64)),
        torch.as_tensor(pg.send_mask),
        torch.as_tensor(pg.recv_pos.astype(np.int64))).numpy()
    assert (got == want).all()
    # and it moved something: the random halo rows now hold the owners' rows
    assert not (got == h).all()


def _j_export(setup, pallas):
    _, pgj, jm, jp, _ = setup
    eng = JSPMDEngine(jm, jm.make_loss_fn(), AdamW(lr=1e-3), pgj,
                      GPHyperParams(),
                      JEngineConfig(mode="stacked", use_pallas_agg=pallas))
    return eng.export_serving_state(jp)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("j_pallas", [True, False])
def test_export_matches_reference(setup, use_kernel, j_pallas):
    pg, _, _, _, m = setup
    want = _j_export(setup, j_pallas)
    eng = SPMDEngine(m, None, None, pg, None,
                     EngineConfig(use_kernel_agg=use_kernel, device="cpu"))
    got = eng.export_serving_state(m)
    assert len(got["layers"]) == len(want["layers"]) == 2
    for a, b in zip(got["layers"], want["layers"]):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL)
    assert tuple(got["logits"].shape) == want["logits"].shape
    np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                               atol=ATOL, rtol=RTOL)
    assert set(got["cache"]) == set(want["cache"])
    for k in want["cache"]:
        assert tuple(got["cache"][k].shape) == want["cache"][k].shape
        np.testing.assert_allclose(got["cache"][k].numpy(), want["cache"][k],
                                   atol=ATOL, rtol=RTOL)


def test_export_matches_reference_products_s():
    """The serving configuration itself (products-s, P=4, hidden 128):
    the port's export on both backends against the reference's stacked
    export with its plain aggregation (Pallas interpret mode is too slow
    at this size; tiny covers it above)."""
    gj = j_make_benchmark(J_BENCHMARKS["products-s"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, 4,
                           method="ew", seed=0)
    pgj = j_build_partitioned_graph(gj, rj.parts, 4)
    jm = JGraphSAGE(feature_dim=gj.feature_dim, hidden_dim=128,
                    num_classes=gj.num_classes)
    want = JSPMDEngine(jm, jm.make_loss_fn(), AdamW(lr=1e-3), pgj,
                       GPHyperParams(),
                       JEngineConfig(mode="stacked", use_pallas_agg=False)
                       ).export_serving_state(jm.init(0))
    g = make_benchmark(BENCHMARKS["products-s"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    m = GraphSAGE(g.feature_dim, 128, g.num_classes).init(0)
    for use_kernel in (True, False):
        got = SPMDEngine(m, None, None, pg, None,
                         EngineConfig(use_kernel_agg=use_kernel, device="cpu")
                         ).export_serving_state(m)
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got["layers"][1].numpy(), want["layers"][1],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_distributed_forward_is_export_logits(setup, use_kernel):
    """The eval forward and the export forward share one spelling."""
    pg, _, _, _, m = setup
    eng = SPMDEngine(m, None, None, pg, None,
                     EngineConfig(use_kernel_agg=use_kernel, device="cpu"))
    with torch.no_grad():
        logits = eng.fwd(m, eng.shards)
    assert torch.equal(logits, eng.export_serving_state(m)["logits"])


@pytest.mark.parametrize("option,value,item", [
    ("feat_store", True, 11), ("feat_groups", 2, 11), ("mode", "spmd", 14),
    ("mode", "auto", 14)])
def test_unported_options_raise(setup, option, value, item, monkeypatch):
    """The partition mesh (item 14): ``spmd`` outside a world of P ranks is
    the reference's ``ValueError`` of too few devices, naming
    ``launch.mesh``; under ``spmd`` (asked for, or picked by ``auto``
    inside a world of P) the communication options of the mesh's part 3
    and the store (part 2) are ported, so they too go on to build the
    mesh, which raises the same outside a world.  Item 11's options are ported and
    behave as the reference's: the store builds and evaluates bitwise the
    resident engine, and ``feat_groups`` without the store is the
    reference's ValueError."""
    pg, _, _, _, m = setup
    if item == 11:
        if option == "feat_groups":
            with pytest.raises(ValueError, match="enable feat_store"):
                SPMDEngine(m, None, None, pg, None,
                           EngineConfig(device="cpu", feat_groups=value))
            return
        eng = SPMDEngine(m, None, None, pg, None,
                         EngineConfig(device="cpu", feat_store=value))
        base = SPMDEngine(m, None, None, pg, None, EngineConfig(device="cpu"))
        got = eng.evaluate(m, "val", per_partition_params=False)
        want = base.evaluate(m, "val", per_partition_params=False)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert eng.cold_h2d_bytes == eng._fs.cold.nbytes > 0
        return
    if value == "auto":
        # auto picks the mesh inside a world of P ranks
        import repro_torch.engine.spmd as spmd_mod
        monkeypatch.setattr(spmd_mod, "partition_world_size", lambda: 4)
    else:
        with pytest.raises(ValueError, match="launch.mesh"):
            SPMDEngine(m, None, None, pg, None,
                       EngineConfig(device="cpu", mode=value))
    for ported in ({"overlap_halo": True}, {"halo_cache": True},
                   {"halo_compress": "int8"}, {"grad_compress": "bucketed"},
                   {"feat_store": True}):
        with pytest.raises(ValueError, match="launch.mesh"):
            SPMDEngine(m, None, None, pg, None,
                       EngineConfig(device="cpu", mode=value, **ported))


@pytest.mark.parametrize("option,value", [
    ("halo_cache", True), ("halo_compress", "int8"),
    ("grad_compress", "topk")])
def test_communication_options_run(setup, option, value):
    """The options ROADMAP item 10 ports build and evaluate: the cache ages
    and reports its refresh bytes, the compressed eval its wire bytes."""
    pg, _, _, _, m = setup
    eng = SPMDEngine(m, None, None, pg, None,
                     EngineConfig(device="cpu", **{option: value}))
    micro, preds = eng.evaluate(m, "val", per_partition_params=False)
    assert micro.shape == (4,) and preds.shape == (4, pg.max_nodes)
    if option == "halo_cache":
        assert eng.halo_cache_state()[1] == 1
        assert eng.last_halo_exchange_bytes == 2 * pg.halo_bytes_per_layer
    elif option == "halo_compress":
        assert eng.last_halo_exchange_bytes == 2 * eng.halo_wire_bytes_per_layer
    else:
        assert eng.comm_residual_state() is None     # no top-k step yet


@pytest.mark.parametrize("option,value", [("overlap_halo", True),
                                          ("mode", "sequential")])
def test_overlap_and_sequential_options_run(setup, option, value):
    """The two options that used to raise now build and evaluate: the
    overlapped engine's owned-row logits are the synchronous ones, and
    under mode="sequential" this engine stays stacked while make_engine
    builds the Python-loop oracle, which predicts as the engine does."""
    from repro_torch.engine import SequentialReference, make_engine
    pg, _, _, _, m = setup
    base = SPMDEngine(m, None, None, pg, None, EngineConfig(device="cpu"))
    eng = SPMDEngine(m, None, None, pg, None,
                     EngineConfig(device="cpu", **{option: value}))
    assert eng.mode == "stacked"
    own = torch.as_tensor(np.arange(pg.max_nodes)[None]
                          < np.asarray(pg.n_own)[:, None])
    with torch.no_grad():
        np.testing.assert_allclose(eng.fwd(m, eng.shards)[own].numpy(),
                                   base.fwd(m, base.shards)[own].numpy(),
                                   atol=ATOL, rtol=RTOL)
    micro, preds = eng.evaluate(m, "test", per_partition_params=False)
    if option == "mode":
        seq = make_engine(m, None, None, pg,
                          config=EngineConfig(device="cpu", mode=value))
        assert isinstance(seq, SequentialReference)
        micro, preds = seq.evaluate(m, "test", per_partition_params=False)
    want_micro, want_preds = base.evaluate(m, "test",
                                           per_partition_params=False)
    np.testing.assert_allclose(micro.numpy(), want_micro.numpy(), atol=1e-6)
    assert (preds[own] == want_preds[own]).float().mean() > 0.99


def test_auto_mode_resolves_to_stacked(setup, monkeypatch):
    """``auto`` is the mesh only inside a ``torch.distributed`` world of P
    ranks (P > 1): stacked in one process whatever the card count (the
    reference counts devices; one process here has no mesh to pick), in a
    world of another size, with one partition, and with ``feat_groups``."""
    pg, _, _, _, m = setup
    assert SPMDEngine(m, None, None, pg, None,
                      EngineConfig(mode="auto", device="cpu")).mode == "stacked"
    assert SPMDEngine(m, None, None, pg, None,
                      EngineConfig(device="cpu")).mode == "stacked"
    import repro_torch.engine.spmd as spmd_mod
    from repro_torch.engine.spmd import _resolve_mode
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cfg = EngineConfig(mode="auto")
    assert _resolve_mode(cfg, 4, torch.device("cuda")) == "stacked"
    for world, parts, want in ((4, 4, "spmd"), (2, 4, "stacked"),
                               (1, 1, "stacked"), (None, 4, "stacked")):
        monkeypatch.setattr(spmd_mod, "partition_world_size", lambda: world)
        assert _resolve_mode(cfg, parts, torch.device("cpu")) == want
    monkeypatch.setattr(spmd_mod, "partition_world_size", lambda: 4)
    assert _resolve_mode(EngineConfig(mode="auto", feat_store=True,
                                      feat_groups=2), 4,
                         torch.device("cpu")) == "stacked"
    assert _resolve_mode(EngineConfig(mode="spmd"), 4,
                         torch.device("cpu")) == "spmd"


def test_unknown_mode_and_compression_raise(setup):
    pg, _, _, _, m = setup
    with pytest.raises(ValueError, match="unknown engine mode"):
        SPMDEngine(m, None, None, pg, None,
                   EngineConfig(mode="bogus", device="cpu"))
    # the quantized forward runs; an unknown codec raises the reference's
    # ValueError when the forward quantizes
    eng = SPMDEngine(m, None, None, pg, None, EngineConfig(device="cpu"))
    res = {f"r{i}": torch.zeros((4, 4, pg.send_idx.shape[-1], d))
           for i, d in enumerate(m.layer_input_dims)}
    with torch.no_grad():
        logits, new_res = make_distributed_forward(
            m, {"max_nodes": pg.max_nodes}, compress="fp16")(
                m, eng.shards, res)
    assert logits.shape == (4, pg.max_nodes, m.num_classes)
    assert set(new_res) == set(res)
    with pytest.raises(ValueError, match="unknown halo compression mode"):
        make_distributed_forward(m, {"max_nodes": pg.max_nodes},
                                 compress="int4")(m, eng.shards, res)


def test_engine_disables_tf32(setup):
    pg, _, _, _, m = setup
    torch.backends.cuda.matmul.allow_tf32 = True
    SPMDEngine(m, None, None, pg, None, EngineConfig(device="cpu"))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

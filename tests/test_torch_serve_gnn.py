"""Partitioned GNN serving, port against reference: the same scripted
feature updates, halo-growing edge addition, removals and queries go through
both GNNServingEngines (equal stats, allclose logits); the port's
incremental logits equal its own from-scratch forward over
apply_updates_to_graph; query batching, the hot-row cache, the health
machine and the CLI."""
import os
import subprocess
import sys

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
from repro.robustness import FaultPlan
from repro.serve import GNNServingEngine as JGNNServingEngine
from repro.train.optim import AdamW
from repro_torch.core import partition_graph
from repro_torch.engine import EngineConfig, SPMDEngine
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.serve import GNNServingEngine, apply_updates_to_graph

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 sums in another order than the reference (XLA segment_sum); the
# same bound tests/test_serve_gnn.py holds its Pallas recompute to
ATOL, RTOL = 5e-6, 1e-5


@pytest.fixture(scope="module")
def world():
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    m = GraphSAGE(g.feature_dim, 16, g.num_classes).init(0)
    export = SPMDEngine(m, None, None, pg, None,
                        EngineConfig(device="cpu")).export_serving_state(m)
    gj = j_make_benchmark(J_BENCHMARKS["tiny"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, 4,
                           method="ew", seed=0)
    pgj = j_build_partitioned_graph(gj, rj.parts, 4)
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=16,
                    num_classes=g.num_classes)
    jp = jm.init(0)
    jexport = JSPMDEngine(jm, jm.make_loss_fn(), AdamW(lr=1e-3), pgj,
                          GPHyperParams(),
                          JEngineConfig(mode="stacked", use_pallas_agg=False)
                          ).export_serving_state(jp)
    return dict(g=g, parts=r.parts, pg=pg, m=m, export=export, pgj=pgj,
                jm=jm, jp=jp, jexport=jexport)


def _port_srv(w, **kw):
    kw.setdefault("device", "cpu")
    return GNNServingEngine(w["m"], w["m"], w["pg"], w["export"], **kw)


def _j_srv(w, **kw):
    return JGNNServingEngine(w["jm"], w["jp"], w["pgj"], w["jexport"], **kw)


def _edits(g, parts, srv):
    """Cross-partition add whose source the destination's partition has
    never seen (halo growth), a same-partition add, and a removal."""
    adds = []
    for v in range(g.num_nodes):
        p = parts[v]
        u = next((u for u in range(g.num_nodes)
                  if u != v and parts[u] != p and u not in srv.g2l[p]
                  and u not in g.neighbors(v)), None)
        if u is not None:
            adds.append((u, v))
            break
    for v in range(g.num_nodes):
        p = parts[v]
        u = next((u for u in range(g.num_nodes) if u != v and parts[u] == p
                  and u not in g.neighbors(v)), None)
        if u is not None:
            adds.append((u, v))
            break
    v0 = next(v for v in range(g.num_nodes) if len(g.neighbors(v)) > 1)
    return adds, [(int(g.neighbors(v0)[0]), v0)]


def _script(srv, w):
    """Two update rounds + a query tick; returns what each step produced."""
    g = w["g"]
    rng = np.random.default_rng(7)
    fupd = {int(v): rng.normal(0, 1, g.feature_dim).astype(np.float32)
            for v in rng.choice(g.num_nodes, 5, replace=False)}
    adds, rems = _edits(g, w["parts"], srv)
    for gid, vec in fupd.items():
        srv.update_features(gid, vec)
    assert all(srv.add_edge(u, v) for u, v in adds)
    assert all(srv.remove_edge(u, v) for u, v in rems)
    assert not srv.add_edge(*adds[0]) and not srv.remove_edge(*rems[0])
    st1 = srv.flush()
    out1 = srv.export_logits()
    fupd2 = {int(v): rng.normal(0, 1, g.feature_dim).astype(np.float32)
             for v in rng.choice(g.num_nodes, 3, replace=False)}
    for gid, vec in fupd2.items():
        srv.update_features(gid, vec)
    assert srv.remove_edge(*adds[0])
    st2 = srv.flush()
    out2 = srv.export_logits()
    srv.submit([0, 1, 2, 3, 17, 101, 0])
    res, _ = srv.tick()
    g2 = apply_updates_to_graph(g, fupd, adds, rems)
    g3 = apply_updates_to_graph(g2, fupd2, (), [adds[0]])
    return dict(st1=st1, st2=st2, out1=out1, out2=out2, res=res, g2=g2, g3=g3)


@pytest.mark.parametrize("use_kernel_agg", [True, False])
def test_scripted_updates_match_reference(world, use_kernel_agg):
    srv = _port_srv(world, use_kernel_agg=use_kernel_agg,
                    planner_compact_after=1)
    jsrv = _j_srv(world, planner_compact_after=1)
    got, want = _script(srv, world), _script(jsrv, world)
    assert srv.stats == jsrv.stats
    assert srv.stats["halo_rows_grown"] >= 1
    assert srv.planner.compactions >= 1
    for k in ("st1", "st2"):
        assert got[k] == want[k]
    for k in ("out1", "out2"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL)
    assert set(got["res"]) == set(want["res"])
    for gid, row in got["res"].items():
        np.testing.assert_allclose(row, want["res"][gid], atol=ATOL, rtol=RTOL)


def _from_scratch(w, graph):
    pg2 = build_partitioned_graph(graph, w["parts"], 4)
    ex = SPMDEngine(w["m"], None, None, pg2, None,
                    EngineConfig(device="cpu")).export_serving_state(w["m"])
    out = np.zeros((graph.num_nodes, graph.num_classes), np.float32)
    for p in range(4):
        n = int(pg2.n_own[p])
        out[pg2.global_ids[p][:n]] = ex["logits"][p][:n].numpy()
    return out


def _row_subset_bitwise() -> bool:
    """Does this backend's f32 matmul give a row subset of a product
    bitwise equal to the same rows of the full product (for >= 2 rows),
    at the serving layer's widths?"""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4 * 441, 16, generator=gen)
    w = torch.randn(16, 16, generator=gen)
    full = a @ w
    return all(torch.equal(a[idx] @ w, full[idx])
               for m in (2, 4, 32, 256)
               for idx in [torch.randperm(a.shape[0], generator=gen)[:m]])


@pytest.mark.parametrize("use_kernel_agg", [True, False])
def test_incremental_equals_from_scratch(world, use_kernel_agg):
    """Served logits after both update rounds equal the port's own
    from-scratch forward.  Each row's edges are summed in the same order
    by both (CPU index_add_ adds in edge order), so the result is bitwise
    exactly when the CPU matmul keeps the row-subset property the
    reference relies on; otherwise the products differ in rounding only,
    and 1e-6 (a few f32 ulps at these magnitudes) bounds it."""
    srv = _port_srv(world, use_kernel_agg=use_kernel_agg,
                    planner_compact_after=1)
    got = _script(srv, world)
    for out, graph in ((got["out1"], got["g2"]), (got["out2"], got["g3"])):
        want = _from_scratch(world, graph)
        if _row_subset_bitwise():
            assert (out == want).all()
        else:
            np.testing.assert_allclose(out, want, atol=1e-6, rtol=1e-6)


def test_query_batching_one_gather_per_partition(world):
    srv = _port_srv(world)
    q = [0, 5, 9, 42, 311]
    srv.submit(q)
    before = srv.stats["gather_calls"]
    res, _ = srv.tick()
    assert srv.stats["gather_calls"] - before == \
        len({int(srv.owner_part[x]) for x in q})
    assert set(res) == set(q)
    full = srv.export_logits()
    assert all((v == full[k]).all() for k, v in res.items())


def test_hot_row_cache_hits_and_invalidation(world):
    srv = _port_srv(world)
    q = [0, 5, 9]
    a = srv.query(q)
    assert srv.stats["cache_misses"] == len(q) and srv.stats["cache_hits"] == 0
    before = srv.stats["gather_calls"]
    b = srv.query(q)
    assert srv.stats["cache_hits"] == len(q)
    assert srv.stats["gather_calls"] == before, "cache hit still gathered"
    assert (a == b).all()
    srv.update_features(q[0], np.random.default_rng(0)
                        .normal(0, 1, world["g"].feature_dim)
                        .astype(np.float32))
    c = srv.query(q)
    assert (c == srv.export_logits()[np.asarray(q)]).all(), "stale cache row"
    assert srv.stats["cache_misses"] >= len(q) + 1
    small = _port_srv(world, hot_cache_rows=2)
    small.query([0, 5, 9, 42])
    assert len(small._hot) == 2


def test_health_machine_matches_reference(world):
    """A partition fails at tick 2 and recovers at tick 5: the same updates
    queue, replay with the same backoff, and degraded answers carry the
    same staleness tags in both packages."""
    plan = FaultPlan(serve_fail={2: (1,)}, serve_recover={5: (1,)})
    g = world["g"]
    engines = [_port_srv(world), _j_srv(world)]
    logs = []
    for srv in engines:
        srv.set_fault_plan(plan)
        rng = np.random.default_rng(1)
        log = []
        for _ in range(8):
            for v in rng.choice(g.num_nodes, 3, replace=False):
                srv.update_features(int(v), rng.normal(0, 1, g.feature_dim)
                                    .astype(np.float32))
            srv.submit(rng.choice(g.num_nodes, 6, replace=False))
            res, st = srv.tick()
            log.append((res, st["staleness"], st["queued_updates"],
                        st["health"]))
        logs.append(log)
    assert engines[0].stats == engines[1].stats
    assert engines[0].stats["updates_queued"] > 0
    assert engines[0].stats["degraded_queries"] > 0
    for (r0, s0, q0, h0), (r1, s1, q1, h1) in zip(*logs):
        assert (s0, q0, h0) == (s1, q1, h1)
        for gid in r1:
            np.testing.assert_allclose(r0[gid], r1[gid], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(engines[0].export_logits(),
                               engines[1].export_logits(), atol=ATOL,
                               rtol=RTOL)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO_ROOT, timeout=300)


def test_cli_runs_on_cpu():
    r = _cli("--gnn", "--device", "cpu", "--dataset", "tiny", "--ticks", "3")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "3 ticks x" in r.stdout and "kernel launches" in r.stdout


def test_cli_unported_paths_say_so(tmp_path):
    """``--swa`` (item 15.2, the rolling cache), item 12's ``--checkpoint``
    (an npz the reference's ``save_pytree`` wrote) and ``--fail-partition``
    run."""
    from repro.train.checkpoint import save_pytree as j_save
    r = _cli("--device", "cpu", "--swa")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "qwen2-0.5b+swa: 4 seqs x 16 tokens" in r.stdout
    g = j_make_benchmark(J_BENCHMARKS["tiny"])
    path = str(tmp_path / "ckpt.npz")
    j_save(path, JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=32,
                            num_classes=g.num_classes).init(5))
    r = _cli("--gnn", "--device", "cpu", "--checkpoint", path, "--ticks", "3")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "3 ticks x" in r.stdout
    r = _cli("--gnn", "--device", "cpu", "--fail-partition", "1",
             "--fail-at-tick", "2", "--recover-after-ticks", "3",
             "--ticks", "8")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "fault plan: partition 1 fails at tick 2" in r.stdout
    assert "degraded mode: 1 failover(s)" in r.stdout
    assert "final health ['healthy', 'healthy', 'healthy', 'healthy']" \
        in r.stdout


def test_from_checkpoint_serves_the_saved_params(world, tmp_path):
    """``from_checkpoint`` on a file of either package's ``save_pytree``
    serves the saved params: bitwise ``from_engine`` with them, and
    within ATOL of the reference's ``from_checkpoint`` on the same file."""
    from repro.train.checkpoint import save_pytree as j_save
    from repro_torch.train.checkpoint import save_pytree
    w = world
    eng = SPMDEngine(w["m"], None, None, w["pg"], None,
                     EngineConfig(device="cpu"))
    params = GraphSAGE(w["g"].feature_dim, 16, w["g"].num_classes).init(4)
    want = GNNServingEngine.from_engine(eng, w["pg"], params, device="cpu")
    for save, name in ((save_pytree, "port.npz"), (j_save, "ref.npz")):
        path = str(tmp_path / name)
        save(path, params if save is save_pytree else w["jm"].init(4))
        got = GNNServingEngine.from_checkpoint(path, eng, w["pg"])
        for a, b in zip(got.params.parameters(), params.parameters()):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(got.export_logits(),
                                      want.export_logits())
    jeng = JSPMDEngine(w["jm"], w["jm"].make_loss_fn(), AdamW(lr=1e-3),
                       w["pgj"], GPHyperParams(),
                       JEngineConfig(mode="stacked", use_pallas_agg=False))
    jsrv = JGNNServingEngine.from_checkpoint(str(tmp_path / "port.npz"),
                                             jeng, w["pgj"])
    np.testing.assert_allclose(want.export_logits(), jsrv.export_logits(),
                               atol=ATOL, rtol=RTOL)

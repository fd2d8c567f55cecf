"""The port's host (NumPy) layer is bitwise the reference's: the synthetic
benchmarks, EW partitioning, every PartitionedGraph field, the blocked-CSR
builders (per graph and stacked) and the serving planner's dirty-set
propagation."""
import dataclasses

import numpy as np
import pytest

from repro.core import partition_graph as j_partition_graph
from repro.engine.stacking import \
    build_stacked_vjp_blocks as j_build_stacked_vjp_blocks
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import make_benchmark as j_make_benchmark
from repro.graph.distributed import RecomputePlanner as JRecomputePlanner
from repro.kernels.segment_agg import build_vjp_blocks as j_build_vjp_blocks
from repro_torch.core import partition_graph
from repro_torch.engine.stacking import build_stacked_vjp_blocks
from repro_torch.graph import (BENCHMARKS, PartitionedGraph,
                               RecomputePlanner, build_partitioned_graph,
                               make_benchmark)
from repro_torch.kernels.segment_agg import block_row_ptr, build_vjp_blocks

DATASETS = ["tiny", "flickr-s"]
PG_FIELDS = [f.name for f in dataclasses.fields(PartitionedGraph)]
VJP_KEYS = ["src", "dst", "mask", "deg", "t_src", "t_dst", "t_mask"]


@pytest.fixture(scope="module", params=DATASETS)
def both(request):
    name = request.param
    g, gj = make_benchmark(BENCHMARKS[name]), j_make_benchmark(J_BENCHMARKS[name])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, 4,
                           method="ew", seed=0)
    return (g, r, build_partitioned_graph(g, r.parts, 4),
            gj, rj, j_build_partitioned_graph(gj, rj.parts, 4))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("field", ["indptr", "indices", "features", "labels",
                                   "train_idx", "val_idx", "test_idx"])
def test_make_benchmark_bitwise(both, field):
    g, _, _, gj, _, _ = both
    assert _same(getattr(g, field), getattr(gj, field))
    assert g.num_classes == gj.num_classes and g.name == gj.name


def test_ew_partition_bitwise(both):
    _, r, _, _, rj, _ = both
    assert _same(r.parts, rj.parts)
    assert _same(r.edge_weights, rj.edge_weights)
    assert r.stats.row() == rj.stats.row()


@pytest.mark.parametrize("field", PG_FIELDS)
def test_partitioned_graph_field_bitwise(both, field):
    _, _, pg, _, _, pgj = both
    a, b = getattr(pg, field), getattr(pgj, field)
    if isinstance(a, np.ndarray):
        assert _same(a, b), field
    else:
        assert a == b, field


def test_stacked_vjp_blocks_bitwise(both):
    _, _, pg, _, _, pgj = both
    got, want = build_stacked_vjp_blocks(pg), j_build_stacked_vjp_blocks(pgj)
    for k in VJP_KEYS:
        assert _same(got[k], want[k]), k
    _check_row_ptr(got)


def _check_row_ptr(blocks):
    """row_ptr (P?, nb, BN+1) of the builders' blocks, from which the
    kernels' work plan is cut: row r's real slots are exactly the slots
    [row_ptr[r], row_ptr[r+1]) of its block, each with local_dst == r."""
    ptr = block_row_ptr(blocks["dst"], blocks["mask"])
    ptr = ptr.reshape(-1, ptr.shape[-1])
    dst = blocks["dst"].reshape(-1, blocks["dst"].shape[-1])
    real = blocks["mask"].reshape(dst.shape) > 0
    assert ptr.dtype == np.int32 and (ptr[:, 0] == 0).all()
    assert (ptr[:, -1] == real.sum(-1)).all()
    for b in range(dst.shape[0]):
        rows = np.repeat(np.arange(ptr.shape[1] - 1), np.diff(ptr[b]))
        assert (dst[b, : rows.size] == rows).all()


@pytest.mark.parametrize("n,max_deg,n_src,seed", [
    (64, 4, 64, 0), (300, 9, 300, 1), (130, 0, 130, 2), (257, 6, 400, 3),
    (0, 0, 10, 4)])
def test_vjp_blocks_bitwise(n, max_deg, n_src, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, n)
    dst = rng.permutation(np.repeat(np.arange(n), deg))
    src = rng.integers(0, n_src, dst.size)
    got = build_vjp_blocks(src, dst, n, n_src)
    want = j_build_vjp_blocks(src, dst, n, n_src)
    for k in VJP_KEYS:
        assert _same(got[k], want[k]), k
    _check_row_ptr(got)


def test_row_ptr_rejects_unsorted_blocks():
    dst = np.array([[1, 0, 0, 0]], np.int32)
    mask = np.array([[1, 1, 0, 0]], np.float32)
    with pytest.raises(ValueError, match="sorted"):
        block_row_ptr(dst, mask, 4)
    with pytest.raises(ValueError, match="prefix"):
        block_row_ptr(np.zeros((1, 4), np.int32),
                      np.array([[1, 0, 1, 0]], np.float32), 4)


def test_recompute_planner_propagate_bitwise(both):
    """Same plans for several dirty sets, through edge additions, replica
    registration, removals and an eager compaction."""
    _, _, pg, _, _, pgj = both
    pl, plj = RecomputePlanner(pg, compact_after=2), \
        JRecomputePlanner(pgj, compact_after=2)
    rng = np.random.default_rng(0)

    def check():
        for trial in range(4):
            seeds = {p: rng.choice(int(pg.max_nodes) - 1, 3 + trial,
                                   replace=False) for p in range(4)}
            edge = {p: rng.choice(int(pg.n_own[p]), 2, replace=False)
                    for p in range(0, 4, 2)}
            for layers in (1, 2, 3):
                a = pl.propagate(seeds, edge, layers)
                b = plj.propagate(seeds, edge, layers)
                assert len(a) == len(b) == layers
                for la, lb in zip(a, b):
                    for p in range(4):
                        assert _same(la[p], lb[p])

    check()
    for planner in (pl, plj):
        planner.add_out_edge(0, 3, 5)
        planner.add_replica(1, 2, 3, int(pg.max_nodes))
        planner.remove_out_edge(0, 3, 5)
        srcs = np.asarray(pg.edge_src[2])[np.asarray(pg.edge_mask[2]) > 0]
        dsts = np.asarray(pg.edge_dst[2])[np.asarray(pg.edge_mask[2]) > 0]
        for s, d in zip(srcs[:3], dsts[:3]):
            planner.remove_out_edge(2, int(s), int(d))
    assert pl.compactions == plj.compactions >= 1
    check()

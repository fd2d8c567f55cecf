"""Compressed communication, piece by piece, against the reference on
inputs made from a seed with numpy:

1. the wire codec (``quantize_rows`` / ``dequantize_rows``) bitwise in f32
   and bf16, with zero rows, one-element rows and exact .5 ties;
2. the error-feedback exchange bitwise against the reference's under
   ``jax.vmap``, and the closed forms (``halo_refresh_plan``,
   ``wire_row_bytes``, ``grad_topk_size``, ``grad_sync_wire_bytes``) equal
   over a sweep;
3. the gradient reducers bitwise on dyadic f32 gradients, a top-k tie
   straddling the k-th entry included, and the port's flat order equal to
   ``ravel_pytree``'s;
4. the refusals: the same ``ValueError`` messages as the reference's, from
   the engines, the oracles and the pipeline;
5. the train CLI's seven flags.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import partition_graph as j_partition_graph
from repro.core.gp import trainer as jtr
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import SequentialReference as JSequentialReference
from repro.engine import SPMDEngine as JSPMDEngine
from repro.graph import BENCHMARKS as J_BENCHMARKS
from repro.graph import GraphSAGE as JGraphSAGE
from repro.graph import build_partitioned_graph as j_build_partitioned_graph
from repro.graph import distributed as jd
from repro.graph import make_benchmark as j_make_benchmark
from repro.pipeline import EATConfig as JEATConfig
from repro.pipeline import run_eat_distgnn as j_run_eat_distgnn
from repro.train.optim import AdamW as JAdamW
from repro_torch.core import partition_graph
from repro_torch.core.gp import trainer as tr
from repro_torch.engine import EngineConfig, SequentialReference, SPMDEngine
from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                               build_partitioned_graph, make_benchmark)
from repro_torch.graph import distributed as td
from repro_torch.pipeline import EATConfig, run_eat_distgnn
from repro_torch.train.optim import AdamW

P = 4


def _bits(a) -> np.ndarray:
    """The raw bits of an array (bf16/f16 as uint16), so -0.0 != 0.0."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _t_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


# --------------------------------------------------------------------------
# 1. the wire codec
# --------------------------------------------------------------------------

def _codec_rows(seed: int) -> np.ndarray:
    """Rows of mixed magnitudes (1e-30 to 1e30), all-zero rows, rows with
    one non-zero, and rows whose x / scale hits exact .5 ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (40, 9)) * 10.0 ** rng.integers(-30, 30, (40, 1))
    x[3] = 0.0
    x[7] = -0.0
    x[11] = 0.0
    x[11, 4] = -3.25
    # amax 127 makes the scale exactly 1, so x / scale keeps the halves
    x[13] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 0.0]
    x[17] = [-127.0 * 4, 2.0, 6.0, 10.0, -2.0, -10.0, 14.0, 1.0, -1.0]
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fp16", "int8"])
@pytest.mark.parametrize("width", [9, 1], ids=["rows", "one_element"])
def test_codec_bitwise_against_reference(dtype, mode, width):
    x = _codec_rows(0)[:, :width] if width == 9 else _codec_rows(1)[:, :1]
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    pj, sj = jd.quantize_rows(xj, mode)
    pt, st = td.quantize_rows(xt, mode)
    assert (_t_bits(pt) == _bits(pj)).all()
    if mode == "fp16":
        assert sj is None and st is None
    else:
        assert pt.dtype == torch.int8 and st.dtype == torch.float32
        assert (_t_bits(st) == _bits(sj)).all()
        assert (pt.numpy() >= -127).all() and (pt.numpy() <= 127).all()
    for out in ("float32", dtype):
        dj = jd.dequantize_rows(pj, sj, mode, getattr(jnp, out))
        dt = td.dequantize_rows(pt, st, mode, getattr(torch, out))
        assert (_t_bits(dt) == _bits(dj)).all()
    if mode == "int8" and width == 9:
        zero = (x == 0).all(axis=1)
        assert zero.sum() == 2
        assert (st.numpy()[zero] == 0).all() and (pt.numpy()[zero] == 0).all()
        d = td.dequantize_rows(pt, st, mode, torch.float32).numpy()
        assert (d[zero] == 0).all()
        # the .5 ties round half to even, as jnp.round does
        assert pt[13].tolist() == [127, 0, 2, 2, 0, -2, 4, -126, 0]
        assert pt[17].tolist() == [-127, 0, 2, 2, 0, -2, 4, 0, 0]


def test_codec_unknown_mode_raises_as_reference():
    x = np.ones((2, 3), np.float32)
    for j_fn, t_fn in ((lambda: jd.quantize_rows(jnp.asarray(x), "int4"),
                        lambda: td.quantize_rows(torch.tensor(x), "int4")),
                       (lambda: jd.dequantize_rows(jnp.asarray(x), None,
                                                   "int4", jnp.float32),
                        lambda: td.dequantize_rows(torch.tensor(x), None,
                                                   "int4", torch.float32)),
                       (lambda: jd.wire_row_bytes(8, "int4"),
                        lambda: td.wire_row_bytes(8, "int4"))):
        with pytest.raises(ValueError) as ej:
            j_fn()
        with pytest.raises(ValueError) as et:
            t_fn()
        assert str(et.value) == str(ej.value)
    assert td.HALO_COMPRESS_MODES == jd.HALO_COMPRESS_MODES
    assert tr.GRAD_COMPRESS_MODES == jtr.GRAD_COMPRESS_MODES


# --------------------------------------------------------------------------
# 2. the error-feedback exchange and the closed forms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["fp16", "int8"])
@pytest.mark.parametrize("ring_chunks", [0, 2])
def test_ef_exchange_bitwise_against_reference(mode, ring_chunks):
    """``recv`` and the new residual bitwise the reference's per-shard
    exchange under ``jax.vmap`` (its all_to_all, or its ppermute ring), on
    a send buffer with pad slots and a carried non-zero residual."""
    rng = np.random.default_rng(3)
    S, D = 7, 5
    mask = (rng.random((P, P, S)) < 0.7).astype(np.float32)
    mask[np.arange(P), np.arange(P)] = 0          # nothing is sent to itself
    sent = (rng.normal(0, 1, (P, P, S, D)) * mask[..., None]).astype(
        np.float32)
    res = (rng.normal(0, 0.01, (P, P, S, D)) * mask[..., None]).astype(
        np.float32)
    fn = jax.vmap(lambda s, m, r: jd._ef_quantized_exchange(
        s, m, r, mode, "p", ring_chunks, jnp.float32), axis_name="p")
    rj, nj = fn(jnp.asarray(sent), jnp.asarray(mask[..., None]),
                jnp.asarray(res))
    rt, nt = td._ef_quantized_exchange(
        torch.tensor(sent), torch.tensor(mask[..., None]), torch.tensor(res),
        mode, torch.float32)
    assert (_t_bits(rt.contiguous()) == _bits(rj)).all()
    assert (_t_bits(nt) == _bits(nj)).all()
    assert (nt.numpy()[mask == 0] == 0).all()
    # what arrived is what its sender kept after quantization
    np.testing.assert_array_equal(
        rt.numpy().transpose(1, 0, 2, 3),
        (sent + res) * mask[..., None] - nt.numpy())


def test_closed_forms_equal_reference():
    for age in range(13):
        for k in (1, 2, 3, 4, 5):
            for cv in (False, True):
                for ms in (1, 2, 7, 64):
                    assert td.halo_refresh_plan(age, k, cv, ms) == \
                        jd.halo_refresh_plan(age, k, cv, ms)
    for d in (1, 16, 64, 100):
        for mode in td.HALO_COMPRESS_MODES:
            for item in (2, 4, 8):
                assert td.wire_row_bytes(d, mode, item) == \
                    jd.wire_row_bytes(d, mode, item)
    for n in (0, 1, 7, 100, 12_345, 10 ** 6):
        for frac in (0.0, 1e-4, 0.01, 0.5, 1.0, 2.0):
            assert tr.grad_topk_size(n, frac) == jtr.grad_topk_size(n, frac)
            for mode in tr.GRAD_COMPRESS_MODES:
                for parts in (1, 2, 4, 8):
                    for item in (2, 4):
                        assert tr.grad_sync_wire_bytes(
                            mode, parts, n, item, frac) == \
                            jtr.grad_sync_wire_bytes(mode, parts, n, item,
                                                     frac)
    with pytest.raises(ValueError) as ej:
        jtr.grad_sync_wire_bytes("zip", 4, 10)
    with pytest.raises(ValueError) as et:
        tr.grad_sync_wire_bytes("zip", 4, 10)
    assert str(et.value) == str(ej.value)


# --------------------------------------------------------------------------
# 3. the gradient reducers
# --------------------------------------------------------------------------

def _model_grads(seed: int):
    """Dyadic f32 (P, ...) gradients shaped like a GraphSAGE's weights:
    the reference's stacked pytree and the port's list in
    ``parameters()`` order."""
    jm = JGraphSAGE(feature_dim=6, hidden_dim=5, num_classes=3)
    jp = jm.init(0)
    rng = np.random.default_rng(seed)
    gj = jax.tree.map(lambda w: jnp.asarray(
        rng.integers(-512, 513, (P,) + w.shape).astype(np.float32) / 64.0),
        jp)
    m = GraphSAGE(6, 5, 3)
    gt = [torch.tensor(np.asarray(a)) for a in
          m.tensors_from_numpy(gj.layers)]
    return gj, gt


def _assert_tree_equal(got: list, want_tree) -> None:
    leaves = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        assert tuple(a.shape) == b.shape
        assert (_t_bits(a) == _bits(b)).all()


@pytest.mark.parametrize("bucket_bytes", [4, 100, 512 * 1024])
def test_bucketed_reduce_bitwise(bucket_bytes):
    gj, gt = _model_grads(0)
    want = jtr.make_bucketed_reduce_stacked(P, bucket_bytes)(gj)
    got = tr.make_bucketed_reduce_stacked(P, bucket_bytes)(gt)
    _assert_tree_equal(got, want)
    # elementwise the plain stacked mean, the engines' mode none
    plain = tr.make_grad_reduce_stacked("none", P)(gt)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


@pytest.mark.parametrize("frac", [0.01, 0.1, 1.0])
def test_topk_reduce_bitwise(frac):
    gj, gt = _model_grads(1)
    n = sum(w.numel() for w in gt) // P
    res = np.random.default_rng(2).integers(-64, 65, (P, n)).astype(
        np.float32) / 128.0
    wj, rj = jtr.make_topk_reduce_stacked(P, frac)(gj, jnp.asarray(res))
    wt, rt = tr.make_topk_reduce_stacked(P, frac)(gt, torch.tensor(res))
    _assert_tree_equal(wt, wj)
    assert (_t_bits(rt) == _bits(rj)).all()
    k = tr.grad_topk_size(n, frac)
    # each partition kept exactly k entries: the rest is in the residual
    flat = tr._flat_stacked(gt)[0] + torch.tensor(res)
    assert ((flat - rt) != 0).sum(dim=1).le(k).all()


def test_topk_ties_straddling_k_pick_reference_indices():
    """Equal magnitudes of both signs straddle the k-th entry in every row:
    the chosen indices are ``lax.top_k``'s (lower index first)."""
    n, frac = 200, 0.05
    k = tr.grad_topk_size(n, frac)
    rng = np.random.default_rng(4)
    g = rng.integers(-3, 4, (P, n)).astype(np.float32) / 8.0
    for p in range(P):
        big = rng.choice(n, 4, replace=False)
        g[p, big] = 8.0 * rng.choice([-1, 1], 4)
        tie = rng.choice(np.setdiff1d(np.arange(n), big), 15, replace=False)
        g[p, tie] = 2.0 * rng.choice([-1, 1], 15)
    # rows of ranks 5..19 hold |2.0|: the k-th (10th) falls inside the tie
    res = np.zeros((P, n), np.float32)
    wj, rj = jtr.make_topk_reduce_stacked(P, frac)(jnp.asarray(g),
                                                   jnp.asarray(res))
    wt, rt = tr.make_topk_reduce_stacked(P, frac)([torch.tensor(g)],
                                                  torch.tensor(res))
    assert (_t_bits(wt[0]) == _bits(wj)).all()
    assert (_t_bits(rt) == _bits(rj)).all()
    for p in range(P):
        _, want = jax.lax.top_k(jnp.abs(jnp.asarray(g[p])), k)
        got = torch.sort(torch.tensor(g[p]).abs(), descending=True,
                         stable=True).indices[:k]
        assert got.tolist() == np.asarray(want).tolist()
        kept = np.flatnonzero(g[p] - rt[p].numpy())
        assert sorted(kept.tolist()) == sorted(np.asarray(want).tolist())


def test_flat_order_is_ravel_pytree():
    """The port's flat gradient space is ``ravel_pytree``'s over the
    reference's params, on weights carried across by the converter."""
    jm = JGraphSAGE(feature_dim=7, hidden_dim=6, num_classes=4,
                    num_layers=3)
    jp = jm.init(5)
    m = GraphSAGE(7, 6, 4, num_layers=3).params_from_numpy(jp.layers)
    flat, unravel = tr._flat_stacked([w.detach()[None]
                                      for w in m.parameters()])
    want, _ = ravel_pytree(jp)
    assert flat.shape == (1, want.shape[0])
    assert (_t_bits(flat[0]) == _bits(want)).all()
    back = unravel(flat[0])
    assert all(torch.equal(a, b.detach()) for a, b in
               zip(back, m.parameters()))


# --------------------------------------------------------------------------
# 4. the refusals
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, P)
    gj = j_make_benchmark(J_BENCHMARKS["tiny"])
    rj = j_partition_graph(gj.indptr, gj.indices, gj.features, gj.labels, P,
                           method="ew", seed=0)
    return g, pg, j_build_partitioned_graph(gj, rj.parts, P)


REFUSED = [dict(halo_compress="int4"), dict(grad_compress="zip"),
           dict(overlap_halo=True, halo_compress="int8"),
           dict(overlap_halo=True, halo_cache=True),
           dict(overlap_halo=True, halo_cache=True, halo_compress="fp16")]


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", REFUSED, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("oracle", [False, True], ids=["engine", "oracle"])
def test_refused_configs_raise_reference_message(tiny, kw, oracle):
    g, pg, pgj = tiny
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=8,
                    num_classes=g.num_classes)
    m = GraphSAGE(g.feature_dim, 8, g.num_classes)
    JCls, Cls = ((JSequentialReference, SequentialReference) if oracle
                 else (JSPMDEngine, SPMDEngine))
    want = _message(lambda: JCls(
        jm, jm.make_loss_fn(), JAdamW(), pgj, config=JEngineConfig(
            mode="sequential" if oracle else "stacked", **kw)))
    got = _message(lambda: Cls(
        m, m.make_loss_fn(), AdamW(), pg, None, EngineConfig(
            mode="sequential" if oracle else "stacked", device="cpu", **kw)))
    assert got == want


@pytest.mark.parametrize("kw", [dict(halo_cache=True),
                                dict(grad_compress="topk"),
                                dict(halo_cache=True, grad_compress="topk")])
@pytest.mark.parametrize("oracle", [False, True], ids=["engine", "oracle"])
def test_fullgraph_refusals_match_reference(tiny, kw, oracle):
    g, pg, pgj = tiny
    jm = JGraphSAGE(feature_dim=g.feature_dim, hidden_dim=8,
                    num_classes=g.num_classes)
    jopt = JAdamW()
    JCls, Cls = ((JSequentialReference, SequentialReference) if oracle
                 else (JSPMDEngine, SPMDEngine))
    mode = "sequential" if oracle else "stacked"
    jeng = JCls(jm, jm.make_loss_fn(), jopt, pgj,
                config=JEngineConfig(mode=mode, use_pallas_agg=False, **kw))
    jp = jm.init(0)
    want = _message(lambda: jeng.phase0_fullgraph_epoch(jp, jopt.init(jp)))
    m = GraphSAGE(g.feature_dim, 8, g.num_classes)
    opt = AdamW()
    eng = Cls(m, m.make_loss_fn(), opt, pg, None,
              EngineConfig(mode=mode, device="cpu", **kw))
    params = GraphSAGE(g.feature_dim, 8, g.num_classes).init(0)
    got = _message(lambda: eng.phase0_fullgraph_epoch(
        params, opt.init(params.parameters())))
    assert got == want


def test_pipeline_refuses_cache_with_fullgraph_as_reference():
    kw = dict(dataset="tiny", halo_cache=True, full_graph_train=True)
    want = _message(lambda: j_run_eat_distgnn(JEATConfig(**kw)))
    got = _message(lambda: run_eat_distgnn(EATConfig(device="cpu", **kw)))
    assert got == want


# --------------------------------------------------------------------------
# 5. the CLI
# --------------------------------------------------------------------------

def test_cli_flags_defaults_and_choices():
    from repro_torch.launch.train import build_parser, config_from_args
    ap = build_parser()
    base = ["gnn", "--device", "cpu"]
    cfg = config_from_args(ap.parse_args(base))
    ref = JEATConfig()
    for name in ("halo_cache", "halo_refresh_every", "halo_cv",
                 "halo_compress", "grad_compress", "grad_topk_frac",
                 "grad_bucket_kb"):
        assert getattr(cfg, name) == getattr(ref, name), name
    cfg = config_from_args(ap.parse_args(base + [
        "--halo-cache", "--halo-refresh-every", "3", "--halo-cv",
        "--halo-compress", "int8", "--grad-compress", "topk",
        "--grad-topk-frac", "0.25", "--grad-bucket-kb", "7"]))
    assert (cfg.halo_cache, cfg.halo_refresh_every, cfg.halo_cv,
            cfg.halo_compress, cfg.grad_compress, cfg.grad_topk_frac,
            cfg.grad_bucket_kb) == (True, 3, True, "int8", "topk", 0.25, 7)
    for flag, bad in (("--halo-compress", "int4"),
                      ("--grad-compress", "zip")):
        with pytest.raises(SystemExit):
            ap.parse_args(base + [flag, bad])


@pytest.mark.parametrize("extra,keys", [
    (["--halo-cache", "--halo-refresh-every", "2", "--halo-cv"],
     {"halo_cache": True, "halo_refresh_every": 2, "halo_cv": True}),
    (["--halo-compress", "int8", "--grad-compress", "topk",
      "--grad-topk-frac", "0.05"],
     {"halo_compress": "int8", "grad_compress": "topk"}),
    (["--halo-compress", "fp16", "--grad-compress", "bucketed",
      "--grad-bucket-kb", "1", "--full-graph-train"],
     {"halo_compress": "fp16", "grad_compress": "bucketed"})],
    ids=["cache_cv", "int8_topk", "fp16_bucketed_full_graph"])
def test_cli_runs_the_flags_on_cpu(capsys, extra, keys):
    import json

    from repro_torch.launch.train import main
    assert main(["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs",
                 "3", "--hidden", "8", "--batch-size", "64", "--fanout", "4",
                 "--phase0-frac", "0.34", *extra]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    for k, v in keys.items():
        assert summary[k] == v, k
    assert summary["comm_halo_exchange_mb"] > 0
    assert "[phase-1] epoch" in out

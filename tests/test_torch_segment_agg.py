"""The port's segment_mean_op on CPU tensors (its plain version) against the
reference's Pallas op in interpret mode and its row-range entry
``segment_agg_rows``, over the cases the chip smoke test runs on the card;
float64 dyadic inputs against an exact NumPy sum; and the dispatch rules
(no launch and no fallback off CUDA)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_agg import build_vjp_blocks as j_build_vjp_blocks
from repro.kernels.segment_agg import segment_agg_rows as j_segment_agg_rows
from repro.kernels.segment_agg import segment_mean_op as j_segment_mean_op
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import segment_agg as sa

# f32 sums in another order than the Pallas kernel's one-hot matmul (the
# same bound tests/test_serve_gnn.py holds the Pallas recompute to)
ATOL, RTOL = 5e-6, 1e-5


def _random_edges(n, max_deg, seed):
    """tests/test_kernels.py's ragged CSR, as (src, dst)."""
    rng = np.random.default_rng(seed)
    deg, indices = [], []
    for _ in range(n):
        k = int(rng.integers(0, max_deg + 1))
        indices.extend(rng.integers(0, n, k))
        deg.append(k)
    return (np.asarray(indices, np.int64),
            np.repeat(np.arange(n), np.asarray(deg, np.int64)))


def _port(x, blocks, **kw):
    bl = sa.blocks_to_device(blocks, "cpu")
    return sa.segment_mean_op(torch.as_tensor(x), bl, **kw).numpy()


def _jax(x, src, dst, num_blocks_rows, n_src, **kw):
    blocks = {k: jnp.asarray(v)
              for k, v in j_build_vjp_blocks(src, dst, num_blocks_rows,
                                             n_src).items()}
    return np.asarray(j_segment_mean_op(jnp.asarray(x), blocks,
                                        interpret=True, **kw))


@pytest.mark.parametrize("n,d,max_deg", [(64, 16, 4), (200, 48, 9), (300, 130, 6)])
@pytest.mark.parametrize("mean", [True, False])
def test_sweep_matches_reference(n, d, max_deg, mean):
    src, dst = _random_edges(n, max_deg, seed=n + max_deg)
    x = np.random.default_rng(n).normal(0, 1, (n, d)).astype(np.float32)
    got = _port(x, sa.build_mean_blocks(src, dst, n), num_rows=n, mean=mean)
    want = _jax(x, src, dst, n, n, num_rows=n, mean=mean)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_isolated_nodes():
    x = np.random.default_rng(0).normal(0, 1, (3, 8)).astype(np.float32)
    src, dst = np.array([0, 2]), np.array([1, 1])
    got = _port(x, sa.build_mean_blocks(src, dst, 3), num_rows=3)
    assert (got[0] == 0).all() and (got[2] == 0).all()
    np.testing.assert_allclose(got[1], (x[0] + x[2]) / 2, rtol=1e-6)
    np.testing.assert_allclose(got, _jax(x, src, dst, 3, 3, num_rows=3),
                               atol=ATOL, rtol=RTOL)


def test_empty_edge_set():
    x = np.ones((50, 16), np.float32)
    e = np.zeros(0, np.int64)
    blocks = sa.build_mean_blocks(e, e, 50)
    assert blocks["src"].shape[0] == 1 and blocks["row_part"].size == 0
    assert (blocks["row_work"][:, 1] == blocks["row_work"][:, 2]).all()
    got = _port(x, blocks, num_rows=50)
    assert got.shape == (50, 16) and (got == 0).all()


@pytest.mark.parametrize("split_kind", ["mixed", "zero_range", "full_range"])
@pytest.mark.parametrize("mean", [True, False])
def test_row_range_matches_reference(split_kind, mean):
    """Row-range placement at row_base (the all-pad block is zero_range),
    against both the Pallas op and the reference's segment_agg_rows."""
    rng = np.random.default_rng(5)
    n, d = 300, 24
    n_int = {"mixed": 141, "zero_range": n, "full_range": 0}[split_kind]
    rr = n - n_int
    deg = rng.integers(0, 6, rr) if rr else np.zeros(0, np.int64)
    rdst = np.repeat(np.arange(rr), deg)
    rsrc = rng.integers(0, n, int(deg.sum())).astype(np.int64)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    got = _port(x, sa.build_mean_blocks(rsrc, rdst, rr), num_rows=n,
                row_base=n_int, mean=mean)
    want = _jax(x, rsrc, rdst, rr, n, num_rows=n, row_base=n_int, mean=mean)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    jb = j_build_vjp_blocks(rsrc, rdst, rr, n)
    msgs = jnp.asarray(x)[jb["src"].reshape(-1)]
    rows = np.asarray(j_segment_agg_rows(
        msgs, jnp.asarray(jb["dst"]), jnp.asarray(jb["mask"]),
        jnp.asarray(jb["deg"]), row_base=n_int, num_rows=n, mean=mean,
        interpret=True))
    np.testing.assert_allclose(got, rows, atol=ATOL, rtol=RTOL)
    if split_kind == "zero_range":
        assert (got == 0).all()


def test_stacked_matches_per_partition():
    """The stacked (P, n, D) form with a (P,) row_base equals P unbatched
    calls, each against the reference op."""
    rng = np.random.default_rng(2)
    P, n, d = 3, 260, 40
    bases = np.array([0, 37, 129])
    per, per_edges = [], []
    for p in range(P):
        rr = n - bases[p]
        deg = rng.integers(0, 7, rr)
        src = rng.integers(0, n, int(deg.sum()))
        dst = np.repeat(np.arange(rr), deg)
        per.append(sa.build_mean_blocks(src, dst, rr))
        per_edges.append((src, dst, rr))
    nb = max(b["src"].shape[0] for b in per)
    be = max(b["src"].shape[1] for b in per)
    stacked = {k: np.zeros((P, nb, be), per[0][k].dtype)
               for k in ("src", "dst", "mask")}
    stacked["deg"] = np.ones((P, nb, sa.BN), np.float32)
    for p, b in enumerate(per):
        k, e = b["src"].shape
        for key in ("src", "dst", "mask"):
            stacked[key][p, :k, :e] = b[key]
        stacked["deg"][p, :k] = b["deg"]
    x = rng.normal(0, 1, (P, n, d)).astype(np.float32)
    got = _port(x, stacked, num_rows=n, row_base=torch.as_tensor(bases))
    for p, (src, dst, rr) in enumerate(per_edges):
        np.testing.assert_array_equal(
            got[p], _port(x[p], per[p], num_rows=n, row_base=int(bases[p])))
        np.testing.assert_allclose(
            got[p], _jax(x[p], src, dst, rr, n, num_rows=n,
                         row_base=int(bases[p])), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("zero_frac,seed", [(0.25, 0), (0.9, 1)])
@pytest.mark.parametrize("mean", [True, False])
def test_f64_dyadic_exact(zero_frac, seed, mean):
    """Integer features: every sum is exact in any order, so the plain
    version equals an exact NumPy sum bit for bit (and so must the kernel
    on the card, which chip_smoke.py checks)."""
    r = np.random.default_rng(seed)
    n, d = 200, 16
    deg = r.choice([1, 2, 3, 4, 8], n)
    deg[r.random(n) < zero_frac] = 0
    dst = np.repeat(np.arange(n), deg)
    src = r.integers(0, n, int(deg.sum()))
    x = r.integers(-8, 9, (n, d)).astype(np.float64)
    got = _port(x, sa.build_mean_blocks(src, dst, n), num_rows=n, mean=mean)
    want = np.zeros((n, d))
    np.add.at(want, dst, x[src])
    if mean:
        want /= np.maximum(deg, 1)[:, None]
    assert got.dtype == np.float64 and (got == want).all()


def test_ref_oracles_match_reference():
    from repro.kernels import ref as j_ref
    src, dst = _random_edges(100, 7, seed=9)
    x = np.random.default_rng(1).normal(0, 1, (100, 12)).astype(np.float32)
    got = ref.segment_agg_ref(torch.as_tensor(x), torch.as_tensor(src),
                              torch.as_tensor(dst), 100).numpy()
    want = np.asarray(j_ref.segment_agg_ref(jnp.asarray(x), jnp.asarray(src),
                                            jnp.asarray(dst), 100))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    got = ref.segment_agg_rows_ref(torch.as_tensor(x), torch.as_tensor(src),
                                   torch.as_tensor(dst), 100, 37, 120).numpy()
    want = np.asarray(j_ref.segment_agg_rows_ref(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), 100, 37, 120))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_make_segment_agg_backends_agree():
    src, dst = _random_edges(150, 5, seed=4)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=150))])
    x = torch.as_tensor(np.random.default_rng(3).normal(0, 1, (150, 20))
                        .astype(np.float32))
    a = ops.make_segment_agg(indptr, src, device="cpu")(x)
    b = ops.make_segment_agg(indptr, src, use_kernel=False, device="cpu")(x)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_path_launches_no_kernel():
    src, dst = _random_edges(64, 4, seed=0)
    before = sa.kernel_launch_count()
    _port(np.ones((64, 8), np.float32), sa.build_mean_blocks(src, dst, 64),
          num_rows=64)
    assert sa.kernel_launch_count() == before


def test_no_fallback_off_cpu_and_cuda():
    blocks = sa.blocks_to_device(sa.build_mean_blocks(
        np.array([0]), np.array([0]), 4), "cpu")
    # a meta x computes nothing: the output's shape on meta, no launch
    before = sa.kernel_launch_count()
    out = sa.segment_mean_op(torch.empty((4, 8), device="meta"), blocks,
                             num_rows=4)
    assert out.device.type == "meta" and tuple(out.shape) == (4, 8)
    assert sa.kernel_launch_count() == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc and no prior build: the kernel build fails loudly (it never
    substitutes the plain version)."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()

"""The backward of the port's segment_mean_op (a torch.autograd.Function)
on CPU tensors — its plain version — against ``jax.vjp`` of the reference's
Pallas op in interpret mode, over the cases the chip smoke test holds the
backward kernel to on the card; gradcheck and gradgradcheck in float64; and
the dispatch rules of the backward (no launch off CUDA, nothing run for an
input that needs no gradient)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_agg import build_vjp_blocks as j_build_vjp_blocks
from repro.kernels.segment_agg import segment_mean_op as j_segment_mean_op
from repro_torch.kernels import segment_agg as sa

# f32 sums in another order than the Pallas kernel's one-hot matmul
ATOL, RTOL = 5e-6, 1e-5


def _edges(n_rows, n_src, max_deg, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, n_rows)
    return (rng.integers(0, n_src, int(deg.sum())),
            np.repeat(np.arange(n_rows), deg))


# (name, range rows, n_in, max in-degree, num_rows, row_base)
CASES = [
    ("sweep-64", 64, 64, 4, 64, 0),
    ("sweep-200", 200, 200, 9, 200, 0),
    ("sweep-300-d130", 300, 300, 6, 300, 0),
    ("row-base-mixed", 159, 300, 5, 300, 141),
    ("rows-sliced-off", 200, 260, 6, 200, 37),
    ("all-pad-block", 0, 300, 5, 300, 300),
    ("empty-edge-set", 50, 50, 0, 50, 0),
]


def _port_vjp(x, g, src, dst, rows, n_in, num_rows, row_base, mean):
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, rows, n_in), "cpu")
    xt = torch.as_tensor(x).requires_grad_(True)
    out = sa.segment_mean_op(xt, bl, num_rows=num_rows, row_base=row_base,
                             mean=mean)
    out.backward(torch.as_tensor(g))
    return out.detach().numpy(), xt.grad.numpy()


def _jax_vjp(x, g, src, dst, rows, n_in, num_rows, row_base, mean):
    blocks = {k: jnp.asarray(v)
              for k, v in j_build_vjp_blocks(src, dst, rows, n_in).items()}
    out, vjp = jax.vjp(lambda xx: j_segment_mean_op(
        xx, blocks, num_rows=num_rows, row_base=row_base, mean=mean,
        interpret=True), jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("mean", [True, False])
def test_backward_matches_jax_vjp(case, mean):
    name, rows, n_in, max_deg, num_rows, row_base = case
    d = 130 if "d130" in name else 24
    src, dst = _edges(rows, n_in, max_deg, seed=rows + n_in)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (n_in, d)).astype(np.float32)
    g = rng.normal(0, 1, (num_rows, d)).astype(np.float32)
    got_out, got = _port_vjp(x, g, src, dst, rows, n_in, num_rows, row_base,
                             mean)
    want_out, want = _jax_vjp(x, g, src, dst, rows, n_in, num_rows, row_base,
                              mean)
    np.testing.assert_allclose(got_out, want_out, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if rows == 0 or max_deg == 0:
        assert (got == 0).all()


def test_stacked_per_partition_row_base():
    """The stacked (P, n, D) form with a (P,) row_base: each partition's
    gradient against the reference's vjp of that partition alone."""
    rng = np.random.default_rng(3)
    P, n, d = 3, 260, 20
    bases = np.array([0, 37, 129])
    per, edges = [], []
    for p in range(P):
        src, dst = _edges(n - bases[p], n, 6, seed=p)
        per.append(sa.build_vjp_blocks(src, dst, n - bases[p], n))
        edges.append((src, dst))
    stacked = {}
    for k in per[0]:
        shape = np.max([b[k].shape for b in per], axis=0)
        fill = 1 if k == "deg" else 0
        arr = np.full((P, *shape), fill, per[0][k].dtype)
        for p, b in enumerate(per):
            arr[(p, *map(slice, b[k].shape))] = b[k]
        stacked[k] = arr
    bl = sa.blocks_to_device(stacked, "cpu")
    x = rng.normal(0, 1, (P, n, d)).astype(np.float32)
    g = rng.normal(0, 1, (P, n, d)).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    sa.segment_mean_op(xt, bl, num_rows=n,
                       row_base=torch.as_tensor(bases)).backward(
        torch.as_tensor(g))
    for p, (src, dst) in enumerate(edges):
        _, want = _jax_vjp(x[p], g[p], src, dst, n - bases[p], n, n,
                           int(bases[p]), True)
        np.testing.assert_allclose(xt.grad[p].numpy(), want, atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("row_base,num_rows", [(0, 90), (23, 90), (40, 70)])
def test_gradcheck_and_gradgradcheck_f64(row_base, num_rows):
    """First and second order in float64: the backward is itself an
    autograd Function whose backward is the forward op."""
    src, dst = _edges(60, 80, 5, seed=row_base)
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, 60, 80), "cpu")
    x = torch.randn(80, 6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(row_base),
                    requires_grad=True)
    fn = lambda t: sa.segment_mean_op(t, bl, num_rows=num_rows,
                                      row_base=row_base)
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_bwd_op_is_the_transpose():
    """<op(x), g> == <x, bwd(g)> in float64, and bwd's own backward is
    the forward op."""
    src, dst = _edges(100, 120, 7, seed=1)
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, 100, 120), "cpu")
    x = torch.randn(120, 5, dtype=torch.float64)
    g = torch.randn(110, 5, dtype=torch.float64, requires_grad=True)
    y = sa.segment_mean_op(x, bl, num_rows=110, row_base=4)
    gx = sa.segment_mean_bwd_op(g, bl, n_in=120, row_base=4)
    torch.testing.assert_close((y * g).sum(), (x * gx).sum())
    gx.backward(x)
    torch.testing.assert_close(g.grad, y)


def test_f64_dyadic_backward_exact():
    """deg in {1, 2, 4, 8} and integer cotangents: the plain backward equals
    an exact NumPy transpose sum bit for bit (and so must the kernel on the
    card, which chip_smoke.py checks)."""
    r = np.random.default_rng(0)
    n = 200
    deg = r.choice([1, 2, 4, 8], n)
    deg[r.random(n) < 0.25] = 0
    dst = np.repeat(np.arange(n), deg)
    src = r.integers(0, n, int(deg.sum()))
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, n, n), "cpu")
    g = r.integers(-8, 9, (n, 16)).astype(np.float64)
    got = sa.segment_mean_bwd_op(torch.as_tensor(g), bl, n_in=n).numpy()
    want = np.zeros((n, 16))
    np.add.at(want, src, g[dst] / np.maximum(deg, 1)[dst, None])
    assert (got == want).all()


def test_backward_runs_nothing_without_grad_and_launches_nothing_on_cpu(
        monkeypatch):
    src, dst = _edges(64, 64, 4, seed=0)
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, 64, 64), "cpu")
    calls = []
    real = sa.segment_mean_bwd_plain
    monkeypatch.setattr(sa, "segment_mean_bwd_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(64, 8)               # layer-1 input: needs no gradient
    (sa.segment_mean_op(x, bl, num_rows=64) @ w).sum().backward()
    assert calls == [] and w.grad is not None
    before = (sa.kernel_launch_count(), sa.bwd_kernel_launch_count())
    x.requires_grad_(True)
    sa.segment_mean_op(x, bl, num_rows=64).sum().backward()
    assert calls == [1]
    assert (sa.kernel_launch_count(), sa.bwd_kernel_launch_count()) == before


def test_backward_needs_transpose_blocks():
    src, dst = _edges(64, 64, 4, seed=0)
    bl = sa.blocks_to_device(sa.build_mean_blocks(src, dst, 64), "cpu")
    x = torch.randn(64, 8, requires_grad=True)
    with pytest.raises(ValueError, match="transpose blocks"):
        sa.segment_mean_op(x, bl, num_rows=64).sum().backward()

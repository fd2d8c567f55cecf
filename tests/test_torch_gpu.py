"""Tests of the CUDA kernels (segment mean, flash attention, RMSNorm), which
run only on a machine with a CUDA card and nvcc (marked ``gpu``; they skip
elsewhere).  On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs; imports nothing of JAX, so it runs where only the port is
installed."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import segment_agg as sa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _edges(n, max_deg, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg + 1, n)
    return rng.integers(0, n, int(deg.sum())), np.repeat(np.arange(n), deg)


@pytest.mark.parametrize("n,d,max_deg", [(64, 16, 4), (300, 130, 6), (700, 64, 40)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("mean", [True, False])
def test_kernel_matches_plain(cuda, n, d, max_deg, dtype, tol, mean):
    src, dst = _edges(n, max_deg, seed=n)
    bl = sa.blocks_to_device(sa.build_mean_blocks(src, dst, n), cuda)
    x = torch.randn(n, d, device=cuda).to(dtype)
    before = sa.kernel_launch_count()
    got = sa.segment_mean_op(x, bl, num_rows=n, mean=mean)
    torch.cuda.synchronize()
    assert sa.kernel_launch_count() == before + 1
    want = sa.segment_mean_plain(x, bl, num_rows=n, mean=mean)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("row_base", [0, 37, 200])
def test_kernel_f64_dyadic_bitwise(cuda, row_base):
    n = 200
    src, dst = _edges(n - row_base, 8, seed=row_base)
    bl = sa.blocks_to_device(sa.build_mean_blocks(src, dst, n - row_base), cuda)
    x = torch.randint(-8, 9, (n, 16), device=cuda).double()
    got = sa.segment_mean_op(x, bl, num_rows=n, row_base=row_base)
    want = sa.segment_mean_plain(x, bl, num_rows=n, row_base=row_base)
    assert torch.equal(got, want)


def test_kernel_refuses_grad_and_bad_blocks(cuda):
    """Blocks of the wrong type raise; a gradient needs the transpose
    blocks (and then launches the backward kernel once)."""
    src, dst = _edges(64, 4, seed=1)
    bl = sa.blocks_to_device(sa.build_mean_blocks(src, dst, 64), cuda)
    x = torch.randn(64, 8, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="transpose blocks"):
        sa.segment_mean_op(x, bl, num_rows=64).sum().backward()
    bad = dict(bl, src=bl["src"].int())
    with pytest.raises(ValueError, match="blocks"):
        sa.segment_mean_op(x.detach(), bad, num_rows=64)
    vjp = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, 64, 64), cuda)
    before = sa.bwd_kernel_launch_count()
    sa.segment_mean_op(x, vjp, num_rows=64).sum().backward()
    torch.cuda.synchronize()
    assert sa.bwd_kernel_launch_count() == before + 1


@pytest.mark.parametrize("rows,n_in,num_rows,row_base", [
    (300, 300, 300, 0), (159, 300, 300, 141), (200, 260, 200, 37),
    (0, 300, 300, 300)])
@pytest.mark.parametrize("mean", [True, False])
def test_bwd_kernel_matches_plain(cuda, rows, n_in, num_rows, row_base, mean):
    rng = np.random.default_rng(rows)
    deg = rng.integers(0, 7, rows)
    src, dst = rng.integers(0, n_in, int(deg.sum())), np.repeat(np.arange(rows), deg)
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, rows, n_in), cuda)
    g = torch.randn(num_rows, 72, device=cuda)
    before = sa.bwd_kernel_launch_count()
    got = sa.segment_mean_bwd_op(g, bl, n_in=n_in, row_base=row_base, mean=mean)
    torch.cuda.synchronize()
    assert sa.bwd_kernel_launch_count() == before + 1
    want = sa.segment_mean_bwd_plain(g, bl, n_in=n_in, row_base=row_base,
                                     mean=mean)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_bwd_kernel_f64_dyadic_bitwise(cuda):
    r = np.random.default_rng(0)
    n = 200
    deg = r.choice([1, 2, 4, 8], n)
    src, dst = r.integers(0, n, int(deg.sum())), np.repeat(np.arange(n), deg)
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, n, n), cuda)
    g = torch.randint(-8, 9, (n, 16), device=cuda).double()
    assert torch.equal(sa.segment_mean_bwd_op(g, bl, n_in=n),
                       sa.segment_mean_bwd_plain(g, bl, n_in=n))


# tests/test_kernels.py's flash CASES, a fully masked row, and decode
# against a cache wider than its filled part; then the designs' edges:
# Dh 32/64/128 on the tensor-core prefill, Sq and Sk off the tile sizes,
# windows across tile edges, a prefill chunk continuing at q_offset, decode
# with GQA groups 1/2/7/8 at q_offset 0 and Sk - 1, decode fully masked,
# bidirectional decode, and a group above 16 at Sq = 1 (prefill design)
# (b, hq, hkv, sq, sk, dh, causal, window, q_offset)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, 0),
    (1, 8, 8, 200, 200, 32, True, None, 0),
    (1, 4, 1, 96, 96, 64, True, None, 0),
    (2, 4, 2, 256, 256, 64, True, 64, 0),
    (1, 4, 2, 1, 300, 64, True, None, 300),
    (1, 2, 2, 64, 64, 128, False, None, 0),
    (1, 2, 1, 4, 16, 64, True, 8, 40),
    (2, 14, 2, 1, 200, 64, True, None, 150),
    (1, 4, 4, 70, 90, 128, True, 33, 20),
    (1, 2, 1, 300, 300, 128, True, None, 0),
    (2, 3, 3, 130, 130, 32, True, None, 0),
    (1, 2, 2, 65, 65, 64, True, None, 0),
    (1, 2, 1, 48, 170, 64, True, None, 122),
    (1, 4, 2, 300, 300, 64, True, 100, 0),
    (1, 2, 2, 200, 333, 128, False, None, 0),
    (2, 2, 2, 1, 500, 64, True, None, 499),
    (1, 4, 2, 1, 257, 128, True, None, 0),
    (2, 14, 2, 1, 2116, 64, True, None, 2048),
    (1, 16, 2, 1, 1000, 32, True, 64, 700),
    (1, 4, 1, 1, 64, 64, True, 8, 80),
    (1, 4, 2, 1, 200, 64, False, None, 0),
    (1, 32, 1, 1, 100, 64, True, None, 99),
]


def _flash_inputs(case, dtype, device):
    b, hq, hkv, sq, sk, dh = case[:6]
    gen = torch.Generator(device=device).manual_seed(sq + sk)
    return [torch.randn(shape, device=device, generator=gen).to(dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_kernel_matches_plain(cuda, case, dtype, tol):
    causal, window, q_off = case[6:]
    q, k, v = _flash_inputs(case, dtype, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    before = fa.flash_launch_count()
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_launch_count() == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    q_pos = torch.arange(q.shape[2], device=cuda) + q_off
    k_pos = torch.arange(k.shape[2], device=cuda)
    live = torch.ones(q.shape[2], k.shape[2], dtype=torch.bool, device=cuda)
    if causal:
        live &= k_pos[None] <= q_pos[:, None]
    if window is not None:
        live &= k_pos[None] > q_pos[:, None] - window
    dead = ~live.any(1)
    assert not got[:, :, dead].float().abs().any()   # exactly 0


# bf16 cases held to one bf16 rounding of attention_ref (chip_smoke.py's
# BF16_MAIN_*): the kernel keeps P to ~16 bits (P_hi + P_lo) and sums in
# f32, so only the final rounding to bf16 may differ; a P rounded to bf16
# alone would break this.  Dh 32/64/128 on the tensor-core prefill (Dh 128
# has its own 16-rows-per-warp path), Sq and Sk off the 64-row and 64-key
# tiles, windows, a chunk at q_offset, and decode
BF16_ONE_ULP_CASES = [
    (1, 4, 2, 300, 300, 32, True, None, 0),
    (2, 14, 2, 512, 512, 64, True, None, 0),
    (1, 2, 1, 300, 300, 128, True, None, 0),
    (1, 4, 2, 130, 190, 64, True, 77, 60),
    (1, 2, 2, 200, 333, 128, False, None, 0),
    (1, 4, 4, 70, 90, 128, True, 33, 20),
    (2, 3, 3, 130, 130, 32, True, 40, 0),
    (4, 14, 2, 1, 2116, 64, True, None, 2048),
    (1, 16, 2, 1, 1000, 128, True, 64, 700),
]


@pytest.mark.parametrize("case", BF16_ONE_ULP_CASES)
def test_flash_bf16_within_one_rounding(cuda, case):
    causal, window, q_off = case[6:]
    q, k, v = _flash_inputs(case, torch.bfloat16, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("case,design", [
    ((2, 14, 2, 512, 512, 64, True, None, 0), "prefill"),
    ((2, 4, 2, 300, 300, 64, True, 100, 0), "prefill"),
    ((4, 14, 2, 1, 2116, 64, True, None, 2048), "decode"),
    ((1, 16, 2, 1, 1000, 32, True, 64, 700), "decode")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_repeats_bitwise(cuda, case, design, dtype):
    """Two launches give the same bits (the decode merge runs in a fixed
    order, no atomics), and each call counts once, under its design."""
    causal, window, q_off = case[6:]
    q, k, v = _flash_inputs(case, dtype, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    before = fa.flash_launch_count(design)
    first = fa.flash_attention(q, k, v, **kw)
    second = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_launch_count(design) == before + 2
    assert torch.equal(first, second)


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.randn(1, 2, 8, 64, device=cuda)
    k = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="head sizes"):
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           k[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           k.transpose(1, 2))
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="one device"):
        fa.flash_attention(q, k.cpu(), k)


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 512), (2, 5, 33, 256),
                                   (2, 16, 896), (3, 1500)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, tol):
    gen = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    w = torch.randn(shape[-1], device=cuda, generator=gen)
    before = rn.rmsnorm_launch_count()
    got = rn.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rn.rmsnorm_launch_count() == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), rn.rmsnorm_plain(x, w).float(),
                               atol=tol, rtol=tol)

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


# the split row gathers: hub rows of K, K+1, 3K+5 and 10,000 in-edges (a
# split row's partials merged in item order), hub SOURCE rows of up to 5,000
# out-edges for the backward, D=130 (scalar path) beside D=128 (16-byte
# path) and D=64 (half-width vectors at f32), bf16, f64 dyadic bitwise, and
# a hub in one partition of a stacked launch with per-partition row_base
K = sa.ROW_WORK_K


def _hub_edges(rows, n_src, hubs, seed):
    rng = np.random.default_rng(seed)
    deg = np.r_[rng.integers(0, 7, rows), hubs].astype(np.int64)
    return (rng.integers(0, n_src, int(deg.sum())),
            np.repeat(np.arange(deg.size), deg))


def _hub_source_edges(rows, n_src, hubs, seed):
    """Forward rows of in-degree 1, 2, 4 or 8 whose sources include one row
    per entry of ``hubs`` with that many out-edges."""
    rng = np.random.default_rng(seed)
    deg = rng.choice([1, 2, 4, 8], rows)
    deg[: -(-sum(hubs) // 8)] = 8
    dst = np.repeat(np.arange(rows), deg)
    src = rng.integers(len(hubs), n_src, dst.size)
    src[rng.permutation(dst.size)[:sum(hubs)]] = np.repeat(
        np.arange(len(hubs)), hubs)
    return src, dst


def _stack_vjp(per):
    P, out = len(per), {}
    for k in ("src", "dst", "mask", "deg", "t_src", "t_dst", "t_mask"):
        shape = np.max([b[k].shape for b in per], axis=0)
        arr = np.full((P, *shape), 1 if k == "deg" else 0, per[0][k].dtype)
        for p, b in enumerate(per):
            arr[(p, *map(slice, b[k].shape))] = b[k]
        out[k] = arr
    for pre in ("", "t_"):
        out.update(sa.block_row_work(
            sa.block_row_ptr(out[pre + "dst"], out[pre + "mask"]), prefix=pre))
    return out


@pytest.mark.parametrize("d", [64, 128, 130])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_kernel_hub_rows_match_plain(cuda, d, dtype, tol):
    src, dst = _hub_edges(300, 4096, [K, K + 1, 3 * K + 5, 10_000], seed=d)
    bl = sa.blocks_to_device(sa.build_mean_blocks(src, dst, 304), cuda)
    assert bl["row_split"].shape[0] == 3
    x = torch.randn(4096, d, device=cuda).to(dtype)
    before = sa.kernel_launch_count()
    got = sa.segment_mean_op(x, bl, num_rows=304)
    again = sa.segment_mean_op(x, bl, num_rows=304)
    torch.cuda.synchronize()
    assert sa.kernel_launch_count() == before + 2      # one per op call
    assert torch.equal(got, again)
    want = sa.segment_mean_plain(x, bl, num_rows=304)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [64, 130])
@pytest.mark.parametrize("mean", [True, False])
def test_kernel_hub_f64_dyadic_bitwise(cuda, d, mean):
    src, dst = _hub_edges(300, 4096, [K, K + 1, 3 * K + 5, 10_000], seed=1)
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, 304, 4096), cuda)
    x = torch.randint(-8, 9, (4096, d), device=cuda).double()
    assert torch.equal(sa.segment_mean_op(x, bl, num_rows=304, mean=mean),
                       sa.segment_mean_plain(x, bl, num_rows=304, mean=mean))
    g = torch.randint(-8, 9, (304, d), device=cuda).double()
    assert torch.equal(sa.segment_mean_bwd_op(g, bl, n_in=4096, mean=False),
                       sa.segment_mean_bwd_plain(g, bl, n_in=4096, mean=False))


@pytest.mark.parametrize("d", [64, 128, 130])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2),
                                       (torch.float64, 0.0)])
@pytest.mark.parametrize("row_base,num_rows", [(0, 2000), (37, 1500)])
def test_bwd_kernel_hub_sources_match_plain(cuda, d, dtype, tol, row_base,
                                            num_rows):
    """Source rows of 5,000, 3K+5, K+1 and K out-edges; g scaled by
    1/sqrt(5,000) so the hub's f32 sums are O(1); f64 integer g over
    dyadic deg is exact, so bitwise; rows cut off at num_rows read 0."""
    src, dst = _hub_source_edges(2000, 2000, [5_000, 3 * K + 5, K + 1, K],
                                 seed=d)
    bl = sa.blocks_to_device(sa.build_vjp_blocks(src, dst, 2000, 2000), cuda)
    assert bl["t_row_split"].shape[0] == 3
    if dtype == torch.float64:
        g = torch.randint(-8, 9, (num_rows, d), device=cuda).double()
    else:
        g = (torch.randn(num_rows, d, device=cuda) * 5_000 ** -0.5).to(dtype)
    kw = dict(n_in=2000, row_base=row_base)
    before = sa.bwd_kernel_launch_count()
    got = sa.segment_mean_bwd_op(g, bl, **kw)
    again = sa.segment_mean_bwd_op(g, bl, **kw)
    torch.cuda.synchronize()
    assert sa.bwd_kernel_launch_count() == before + 2
    assert torch.equal(got, again)
    want = sa.segment_mean_bwd_plain(g, bl, **kw)
    if dtype == torch.float64:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_stacked_hub_per_partition_row_base(cuda):
    bases = np.array([0, 37, 129])
    per = []
    for p in range(3):
        src, dst = _hub_edges(999 - bases[p], 1000,
                              [10_000 if p == 1 else 3], seed=20 + p)
        per.append(sa.build_vjp_blocks(src, dst, 1000 - bases[p], 1000))
    bl = sa.blocks_to_device(_stack_vjp(per), cuda)
    rb = torch.as_tensor(bases, device=cuda)
    x = torch.randn(3, 1000, 128, device=cuda)
    torch.testing.assert_close(
        sa.segment_mean_op(x, bl, num_rows=1000, row_base=rb),
        sa.segment_mean_plain(x, bl, num_rows=1000, row_base=rb),
        atol=1e-5, rtol=1e-5)
    g = torch.randn(3, 1000, 128, device=cuda) * 0.01
    torch.testing.assert_close(
        sa.segment_mean_bwd_op(g, bl, n_in=1000, row_base=rb),
        sa.segment_mean_bwd_plain(g, bl, n_in=1000, row_base=rb),
        atol=1e-4, rtol=1e-4)


def test_kernels_refuse_blocks_without_the_plan(cuda):
    """No row walk without the host plan: both CUDA ops raise, naming the
    builders, and launch nothing."""
    src, dst = _edges(64, 4, seed=1)
    blocks = sa.build_vjp_blocks(src, dst, 64, 64)
    bare = sa.blocks_to_device(
        {k: v for k, v in blocks.items()
         if k not in sa.PLAN_KEYS and k[2:] not in sa.PLAN_KEYS}, cuda)
    x = torch.randn(64, 8, device=cuda)
    before = (sa.kernel_launch_count(), sa.bwd_kernel_launch_count())
    with pytest.raises(ValueError, match="work plan.*build_mean_blocks"):
        sa.segment_mean_op(x, bare, num_rows=64)
    with pytest.raises(ValueError, match="work plan.*build_mean_blocks"):
        sa.segment_mean_bwd_op(x, bare, n_in=64)
    assert (sa.kernel_launch_count(), sa.bwd_kernel_launch_count()) == before


def test_kernels_refuse_a_plan_of_another_row_space(cuda):
    """A plan kept from one partition's blocks, launched with the stacked
    blocks, numbers other rows: both CUDA ops raise before any launch."""
    per = [sa.build_vjp_blocks(*_hub_edges(200 + 90 * p, 300, [3], seed=p),
                               203 + 90 * p, 300) for p in range(3)]
    stacked = _stack_vjp(per)
    stale = {**stacked, **{pre + k: per[0][pre + k] for pre in ("", "t_")
                           for k in sa.PLAN_KEYS}}
    bl = sa.blocks_to_device(stale, cuda)
    x = torch.randn(3, 300, 8, device=cuda)
    before = (sa.kernel_launch_count(), sa.bwd_kernel_launch_count())
    with pytest.raises(ValueError, match="rebuild the plan"):
        sa.segment_mean_op(x, bl, num_rows=300)
    with pytest.raises(ValueError, match="rebuild the plan"):
        sa.segment_mean_bwd_op(x, bl, n_in=300)
    assert (sa.kernel_launch_count(), sa.bwd_kernel_launch_count()) == before


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
    # Dh 256 (paligemma-3b's MQA heads): the tensor-core prefill with Q
    # reloaded from shared memory, ragged and bidirectional, the f32
    # prefill's 16-key tiles; decode at group 8 against 580 slots, a
    # window, bidirectional; whisper-small's cross-attention (Sq != Sk,
    # bidirectional) at a cut length
    (1, 8, 1, 130, 130, 256, True, None, 0),
    (1, 4, 4, 70, 90, 256, False, None, 0),
    (1, 2, 1, 200, 333, 256, True, 77, 150),
    (2, 8, 1, 1, 580, 256, True, None, 512),
    (1, 16, 1, 1, 200, 256, True, 33, 150),
    (1, 2, 2, 1, 300, 256, False, None, 0),
    (1, 12, 12, 96, 1500, 64, False, None, 0),
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
    (2, 8, 1, 300, 300, 256, True, None, 0),
    (4, 8, 1, 1, 580, 256, True, None, 512),
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


# the prefix-LM mask (b, hq, hkv, sq, sk, dh, causal, window, q_offset,
# prefix_len): a prefix edge inside a key tile, on a tile edge, past Sk;
# with a window whose live range leaves a gap after the prefix (two runs of
# tiles); at a q_offset; bidirectional (the prefix changes nothing); Sq = 1
# (the prefill design, which alone takes a prefix); paligemma-3b's prefill
# shape cut to batch 1 (MQA, Dh 256, prefix 256 of 512)
FLASH_PREFIX_CASES = [
    (1, 4, 2, 200, 200, 64, True, None, 0, 37),
    (1, 2, 2, 96, 96, 128, True, 16, 0, 64),
    (1, 2, 2, 40, 40, 32, True, None, 0, 64),
    (1, 4, 1, 300, 300, 64, True, 64, 0, 100),
    (2, 4, 2, 300, 300, 256, True, 50, 0, 70),
    (1, 2, 1, 48, 170, 64, True, 40, 122, 30),
    (1, 2, 2, 64, 64, 64, False, None, 0, 20),
    (1, 4, 2, 1, 90, 64, True, None, 50, 70),
    (1, 8, 1, 512, 512, 256, True, None, 0, 256),
]


def _prefix_live(case, device):
    sq, sk = case[3], case[4]
    causal, window, q_off, prefix = case[6:]
    q_pos = torch.arange(sq, device=device)[:, None] + q_off
    k_pos = torch.arange(sk, device=device)[None]
    live = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        live &= k_pos <= q_pos
    if window is not None:
        live &= k_pos > q_pos - window
    return live | (k_pos < prefix)


@pytest.mark.parametrize("case", FLASH_PREFIX_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_prefix_matches_plain(cuda, case, dtype, tol):
    """The prefix-LM mask in both prefill designs against the plain
    version (whose mask is the reference's ``_mask_block``); bf16 also
    within one bf16 rounding; two launches bitwise equal, each counted once
    under the prefill design."""
    causal, window, q_off, prefix = case[6:]
    q, k, v = _flash_inputs(case, dtype, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_off,
              prefix_len=prefix)
    before = fa.flash_launch_count("prefill")
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_launch_count("prefill") == before + 2
    assert torch.equal(got, again)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                   rtol=2.0 ** -7)
    dead = ~_prefix_live(case, cuda).any(1)
    assert not got[:, :, dead].float().abs().any()


def test_flash_prefix_and_dh256_refuse_training(cuda):
    """Under autograd a prefix and Dh 256 train (one training forward and
    one backward launch each); what the kernels still refuse is a head
    size outside HEAD_DIMS, with a prefix too, before any launch, in the
    autograd route and in ``flash_attention_bwd`` alike."""
    for dh, prefix in ((256, 0), (64, 16), (256, 16)):
        q = torch.randn(1, 2, 32, dh, device=cuda, requires_grad=True)
        k = torch.randn(1, 2, 32, dh, device=cuda)
        before = (fa.flash_launch_count("train"),
                  fa.flash_launch_count("backward"))
        out = fa.flash_attention(q, k, k, prefix_len=prefix)
        (g,) = torch.autograd.grad(out.sum(), [q])
        torch.cuda.synchronize()
        assert g.shape == q.shape and torch.isfinite(g).all()
        assert (fa.flash_launch_count("train"),
                fa.flash_launch_count("backward")) == (before[0] + 1,
                                                       before[1] + 1)
    for dh in (48, 512):
        q = torch.randn(1, 2, 32, dh, device=cuda, requires_grad=True)
        before = fa.flash_launch_count()
        with pytest.raises(ValueError, match="head sizes"):
            fa.flash_attention(q, q.detach(), q.detach(), prefix_len=8)
        lse = torch.empty(1, 2, 32, device=cuda)
        x = q.detach()
        with pytest.raises(ValueError, match="head sizes"):
            fa.flash_attention_bwd(x, x, x, x, lse, x, prefix_len=8)
        assert fa.flash_launch_count() == before


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


def _rms_inputs(shape, dtype, cuda, offset=0):
    """x, delta (each a view ``offset`` elements into its own buffer, so a
    nonzero offset gives contiguous tensors whose data is not 16-byte
    aligned) and an f32 weight, from a seed."""
    gen = torch.Generator(device=cuda).manual_seed(shape[-1] + offset)
    n = int(np.prod(shape))
    x, delta = (torch.randn(n + offset, device=cuda, generator=gen).to(dtype)
                [offset:].view(shape) for _ in range(2))
    return x, delta, torch.randn(shape[-1], device=cuda, generator=gen)


# d = 128, 256, 512, 896 (16-byte vectors), 264 (33 vectors: 32 lanes, the
# tail masked), 4,096 and 8,192 (the most vectors a lane keeps, fused and
# alone; fused, 8,192 takes the scalar path), 1,500 (ragged: the scalar
# path), 9,000 (past the registers: the scalar path reads the tail twice),
# and the qwen2-0.5b decode shape
RMS_ENTRY_SHAPES = [(4, 128), (3, 7, 256), (2, 5, 512), (2, 16, 896),
                    (3, 264), (2, 4096), (2, 8192), (3, 1500), (2, 9000),
                    (4, 1, 896)]


@pytest.mark.parametrize("shape", RMS_ENTRY_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("fused", [False, True], ids=["rmsnorm", "add_rmsnorm"])
def test_rmsnorm_entry_points_match_plain(cuda, shape, offset, dtype, tol,
                                          fused):
    """Both entry points: s bitwise torch's ``x + delta``, y within the
    plain version's tolerance, two launches bitwise equal, each launch
    counted once (the fused ones in both counts); ``offset`` 1 takes the
    inputs 2 or 4 bytes off a 16-byte boundary."""
    x, delta, w = _rms_inputs(shape, dtype, cuda, offset)
    assert (x.data_ptr() % 16 != 0) == bool(offset) and x.is_contiguous()
    before = (rn.rmsnorm_launch_count(), rn.add_rmsnorm_launch_count())
    if fused:
        runs = [rn.add_rmsnorm(x, delta, w) for _ in range(2)]
        s_want, y_want = rn.add_rmsnorm_plain(x, delta, w)
        assert torch.equal(s_want, x + delta)
        for s, _ in runs:
            assert s.dtype == dtype and torch.equal(s, s_want)
        ys = [y for _, y in runs]
    else:
        ys = [rn.rmsnorm(x, w) for _ in range(2)]
        y_want = rn.rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert (rn.rmsnorm_launch_count(), rn.add_rmsnorm_launch_count()) == (
        before[0] + 2, before[1] + 2 * fused)
    assert ys[0].dtype == dtype and ys[0].shape == x.shape
    torch.testing.assert_close(ys[0].float(), y_want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(ys[0], ys[1])


def test_add_rmsnorm_kernel_refuses_what_it_cannot_take(cuda):
    x, delta, w = _rms_inputs((4, 256), torch.float32, cuda)
    before = rn.rmsnorm_launch_count()
    with pytest.raises(ValueError, match="shape, dtype and device"):
        rn.add_rmsnorm(x, delta.bfloat16(), w)
    with pytest.raises(ValueError, match="shape, dtype and device"):
        rn.add_rmsnorm(x, delta.cpu(), w)
    with pytest.raises(ValueError, match="contiguous"):
        rn.add_rmsnorm(x, delta.T.contiguous().T, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rn.add_rmsnorm(x.half(), delta.half(), w)
    assert rn.rmsnorm_launch_count() == before


# --------------------------------------------------------------------------
# the on-device epoch sampler (no kernel of its own: torch ops on the card,
# whose random streams differ from the CPU's, so its CPU tests cannot speak
# for the card's draws)
# --------------------------------------------------------------------------

def _powerlaw_graph(n=300, seed=0):
    rng = np.random.default_rng(seed)
    deg = np.minimum((1.0 / rng.power(2.0, n) - 1).astype(np.int64), 150)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.maximum(deg, 0), out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int64)
    labels = rng.choice(5, n, p=[0.45, 0.25, 0.15, 0.10, 0.05])
    train_idx = np.sort(rng.choice(n, int(0.7 * n), replace=False))
    return indptr, indices, labels, train_idx


@pytest.mark.parametrize("seed", [0, 1])
def test_device_draw_follows_eq3_on_card(cuda, seed):
    """The first slot of the card's Gumbel top-k ranking is a
    categorical(Eq. 3) sample: chi-squared over 60k draws (alpha 1e-3, bins
    merged to an expectation of at least 5), and the card's float64 Eq. 3
    matches NumPy's to 1e-12."""
    import scipy.stats

    from repro_torch.core.sampler import (cbs_probabilities,
                                          cbs_probabilities_device,
                                          gumbel_subset)
    indptr, indices, labels, train_idx = _powerlaw_graph(seed=seed)
    probs = cbs_probabilities(indptr, indices, labels, train_idx)
    dev64 = cbs_probabilities_device(indptr, indices, labels, train_idx,
                                     dtype=torch.float64, device=cuda)
    assert np.abs(dev64.cpu().numpy() - probs).max() < 1e-12
    with np.errstate(divide="ignore"):
        logp = torch.as_tensor(np.log(probs), dtype=torch.float32,
                               device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed * 7919 + 13)
    first = gumbel_subset(gen, logp.expand(60_000, -1), 1)[:, 0].cpu().numpy()
    counts = np.bincount(first, minlength=len(probs)).astype(np.float64)
    assert counts[probs == 0].sum() == 0
    exp = probs * counts.sum()
    obs_m, exp_m, acc_o, acc_e = [], [], 0.0, 0.0
    for i in np.argsort(exp):
        acc_o, acc_e = acc_o + counts[i], acc_e + exp[i]
        if acc_e >= 5.0:
            obs_m.append(acc_o)
            exp_m.append(acc_e)
            acc_o = acc_e = 0.0
    obs_m[-1] += acc_o
    exp_m[-1] += acc_e
    assert scipy.stats.chisquare(obs_m, exp_m).pvalue > 1e-3


def test_device_epoch_same_seed_bitwise_on_card(cuda):
    """Two epochs drawn on the card from generators with one seed are
    bitwise equal (Eq. 3 staged twice, the draw, every batch tensor), and
    every valid node is a train node of its partition."""
    from repro_torch.core import partition_graph
    from repro_torch.core.sampler import build_device_epoch_sampler
    from repro_torch.graph import BENCHMARKS, make_benchmark
    g = make_benchmark(BENCHMARKS["tiny"])
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                            method="ew", seed=0).parts
    host_train = [g.train_idx[parts[g.train_idx] == p] for p in range(4)]

    def epoch(seed):
        ds = build_device_epoch_sampler(g, host_train, 4, batch_size=8,
                                        fanouts=(5, 5), device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        nodes, valid = ds.draw_epoch(gen)
        out = [ds.logp, nodes, valid]
        for i in range(ds.num_batches):
            out += list(ds.make_batch(gen, nodes[:, i], valid[:, i]).values())
        return out

    a, b = epoch(3), epoch(3)
    assert all(x.device.type == "cuda" and torch.equal(x, y)
               for x, y in zip(a, b))
    nodes, valid = a[1].cpu(), a[2].cpu()
    for p in range(4):
        assert set(nodes[p][valid[p]].tolist()) <= set(host_train[p].tolist())


# the overlapped forward's row-range use of the segment kernels: each half
# of the split blocks at its own row_base (0, or every partition's n_int as a
# (P,) tensor) into own_cap rows, forward and backward; rows that run past
# num_rows are dropped; the split forward on the card with its launch counts

@pytest.fixture(scope="module")
def split_tiny():
    from repro_torch.core import partition_graph
    from repro_torch.engine import build_stacked_split_vjp_blocks
    from repro_torch.graph import (BENCHMARKS, build_partitioned_graph,
                                   make_benchmark)
    g = make_benchmark(BENCHMARKS["tiny"])
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                            method="ew", seed=0).parts
    pg = build_partitioned_graph(g, parts, 4)
    return g, pg, build_stacked_split_vjp_blocks(pg)


@pytest.mark.parametrize("half", ["interior", "boundary"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_halves_match_plain(cuda, split_tiny, half, dtype):
    _, pg, (bi, bb) = split_tiny
    bl = sa.blocks_to_device(bi if half == "interior" else bb, cuda)
    rb = (0 if half == "interior"
          else torch.as_tensor(pg.n_int.astype(np.int64), device=cuda))
    x = torch.randint(-8, 9, (4, pg.max_nodes, 24), device=cuda).to(dtype)
    kw = dict(num_rows=pg.own_cap, row_base=rb)
    before = sa.kernel_launch_count()
    got = sa.segment_mean_op(x, bl, **kw)
    again = sa.segment_mean_op(x, bl, **kw)
    assert sa.kernel_launch_count() == before + 2
    assert torch.equal(got, again)
    want = sa.segment_mean_plain(x, bl, **kw)
    if dtype == torch.float64:       # integer sums, one division: exact
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    g = torch.randn(4, pg.own_cap, 24, device=cuda, dtype=dtype)
    kb = dict(n_in=pg.max_nodes, row_base=rb)
    before = sa.bwd_kernel_launch_count()
    gx = sa.segment_mean_bwd_op(g, bl, **kb)
    assert torch.equal(gx, sa.segment_mean_bwd_op(g, bl, **kb))
    assert sa.bwd_kernel_launch_count() == before + 2
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(gx, sa.segment_mean_bwd_plain(g, bl, **kb),
                               atol=tol, rtol=tol)


def test_rows_past_num_rows_are_dropped_bitwise(cuda):
    """Partition 0's rows start at 200 and its blocks (padded to the fleet's
    3 blocks) reach row 584 of a 300-row output, its real rows to 350: the
    rows past 300 must be dropped, not written into partition 1's rows.
    f64 dyadic, so both passes are bitwise the plain version."""
    bases, rows, n_in = np.array([200, 0, 100]), [150, 300, 200], 320
    per = []
    for p in range(3):
        r = np.random.default_rng(60 + p)
        deg = r.choice([0, 1, 2, 4, 8], rows[p])
        dst = np.repeat(np.arange(rows[p]), deg)
        per.append(sa.build_vjp_blocks(r.integers(0, n_in, dst.size), dst,
                                       rows[p], n_in))
    bl = sa.blocks_to_device(_stack_vjp(per), cuda)
    rb = torch.as_tensor(bases, device=cuda)
    x = torch.randint(-8, 9, (3, n_in, 40), device=cuda).double()
    got = sa.segment_mean_op(x, bl, num_rows=300, row_base=rb)
    assert torch.equal(got, sa.segment_mean_plain(x, bl, num_rows=300,
                                                  row_base=rb))
    assert (got[1] != 0).any(dim=1).sum() > 200     # partition 1 intact
    g = torch.randint(-8, 9, (3, 300, 40), device=cuda).double()
    assert torch.equal(
        sa.segment_mean_bwd_op(g, bl, n_in=n_in, row_base=rb),
        sa.segment_mean_bwd_plain(g, bl, n_in=n_in, row_base=rb))


def test_overlap_forward_on_card(cuda, split_tiny):
    """The split forward with the kernels against the plain split forward
    and the synchronous one on owned rows; an eval launches the forward
    kernel 4 times (2 layers x 2 halves) and a full-graph step the backward
    kernel twice (layer 1's halves; layer 0 reads features)."""
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE
    g, pg, _ = split_tiny
    params = GraphSAGE(g.feature_dim, 32, g.num_classes).init(0).to(cuda)
    engines = {k: SPMDEngine(params, None, None, pg, None, EngineConfig(
        device="cuda", use_kernel_agg=k != "plain", overlap_halo=k != "sync"))
        for k in ("kernel", "plain", "sync")}
    own = torch.as_tensor(np.arange(pg.max_nodes)[None]
                          < pg.n_own[:, None], device=cuda)
    sa.reset_kernel_launch_count()
    with torch.no_grad():
        got = engines["kernel"].fwd(params, engines["kernel"].shards)
    assert sa.kernel_launch_count() == 4
    for k in ("plain", "sync"):
        with torch.no_grad():
            want = engines[k].fwd(params, engines[k].shards)
        torch.testing.assert_close(got[own], want[own], atol=1e-5, rtol=1e-5)
    grads = {}
    for k in ("kernel", "plain"):
        eng = engines[k]
        params.zero_grad(set_to_none=True)
        sa.reset_kernel_launch_count()
        eng._fg_loss(params, {"shard": eng.shards, "labels": eng.labels,
                              "train_mask": eng.masks["train"]}).mean().backward()
        grads[k] = [p.grad.clone() for p in params.parameters()]
        launches = (sa.kernel_launch_count(), sa.bwd_kernel_launch_count())
        assert launches == ((4, 2) if k == "kernel" else (0, 0)), launches
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------------------
# the halo cache and compressed communication on the card: the full-range
# cached forward with the kernel bitwise the synchronous one, the wire codec
# bitwise its CPU run, and a top-k epoch reproducible bitwise

def test_full_range_cached_forward_is_synchronous_on_card(cuda, split_tiny):
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE
    g, pg, _ = split_tiny
    params = GraphSAGE(g.feature_dim, 32, g.num_classes).init(0).to(cuda)
    eng = SPMDEngine(params, None, None, pg, None, EngineConfig(
        device="cuda", halo_cache=True, halo_refresh_every=2))
    fwd = eng._cached_fwd(0, eng.max_send)
    sa.reset_kernel_launch_count()
    with torch.no_grad():
        got, cache = fwd(params, eng.shards, eng.halo_cache_state()[0])
        want = eng.fwd(params, eng.shards)
        export = eng.export_serving_state(params)
    assert sa.kernel_launch_count() == 6          # 2 layers x 3 forwards
    assert torch.equal(got, want)
    for k in cache:
        assert torch.equal(cache[k], export["cache"][k])
    # the refresh plan then serves layer rows from the cache: no exchange,
    # the segment kernel still launched once a layer
    sa.reset_kernel_launch_count()
    for _ in range(2):
        eng.evaluate(params, "val", per_partition_params=False)
    assert sa.kernel_launch_count() == 4
    assert eng.last_halo_exchange_bytes == 0


@pytest.mark.parametrize("mode", ["fp16", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_codec_on_card_is_bitwise_the_cpu_codec(cuda, mode, dtype):
    from repro_torch.graph.distributed import dequantize_rows, quantize_rows
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (257, 130)) * 10.0 ** rng.integers(-6, 6, (257, 1))
    x[3] = 0.0
    x[5, :] = [127.0, 0.5, 1.5, 2.5, -0.5] * 26   # exact .5 ties
    xc = torch.tensor(x).to(dtype)
    pc, sc = quantize_rows(xc, mode)
    pg_, sg = quantize_rows(xc.to(cuda), mode)
    assert torch.equal(pg_.cpu(), pc)
    if mode == "int8":
        assert torch.equal(sg.cpu(), sc)
    for out in (torch.float32, dtype):
        dc = dequantize_rows(pc, sc, mode, out)
        dg = dequantize_rows(pg_, sg, mode, out)
        assert torch.equal(dg.cpu().view(torch.uint8),
                           dc.view(torch.uint8))


def test_topk_epoch_on_card_repeats_bitwise(cuda, split_tiny):
    """Two runs of a top-k phase-0 epoch from the same start on the card:
    params, losses and the residual bitwise equal (the stable sort picks
    ties by index, and nothing on the path adds with atomics)."""
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE
    from repro_torch.train.optim import AdamW
    g, pg, _ = split_tiny
    rng = np.random.default_rng(1)
    B, f = 32, 4
    batches = {
        "x_t": torch.tensor(rng.normal(0, 1, (3, 4, B, g.feature_dim)),
                            dtype=torch.float32, device=cuda),
        "x_1": torch.tensor(rng.normal(0, 1, (3, 4, B, f, g.feature_dim)),
                            dtype=torch.float32, device=cuda),
        "x_2": torch.tensor(rng.normal(0, 1, (3, 4, B, f, f,
                                              g.feature_dim)),
                            dtype=torch.float32, device=cuda),
        "labels": torch.tensor(rng.integers(0, g.num_classes, (3, 4, B)),
                               device=cuda),
        "mask": torch.ones((3, 4, B), device=cuda)}
    runs = []
    for _ in range(2):
        m = GraphSAGE(g.feature_dim, 32, g.num_classes)
        opt = AdamW(lr=1e-2, grad_clip=5.0)
        eng = SPMDEngine(m, m.make_loss_fn(), opt, pg, None, EngineConfig(
            device="cuda", grad_compress="topk", grad_topk_frac=0.05))
        params = GraphSAGE(g.feature_dim, 32, g.num_classes).init(0).to(cuda)
        params, _, losses, _, _ = eng.phase0_epoch(
            params, opt.init(params.parameters()), batches)
        runs.append(([w.detach().clone() for w in params.parameters()],
                     losses, eng.comm_residual_state()[1].clone()))
    (pa, la, ra), (pb, lb, rb) = runs
    assert torch.isfinite(ra).all() and (ra != 0).any()
    assert torch.equal(la, lb) and torch.equal(ra, rb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


# the two-tier feature store (ROADMAP item 11): the store's eval on the card
# bitwise the resident eval, its cold tier pinned; the streamed eval's
# single-partition launches, each bitwise its partition's rows of the
# stacked launch

def test_feat_store_eval_on_card_bitwise(cuda, split_tiny):
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE
    g, pg, _ = split_tiny
    params = GraphSAGE(g.feature_dim, 32, g.num_classes).init(0).to(cuda)
    base = SPMDEngine(params, None, None, pg, None,
                      EngineConfig(device="cuda"))
    store = SPMDEngine(params, None, None, pg, None, EngineConfig(
        device="cuda", feat_store=True, hot_frac=0.5))
    assert store._cold_host.is_pinned()
    sa.reset_kernel_launch_count()
    got = store.evaluate(params, "test", per_partition_params=False)
    assert sa.kernel_launch_count() == 2
    want = base.evaluate(params, "test", per_partition_params=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert store.cold_h2d_bytes == store._fs.cold.nbytes


def test_partition_launch_is_its_rows_of_the_stacked_launch(cuda, split_tiny):
    from repro_torch.engine import build_stacked_vjp_blocks, partition_blocks
    _, pg, _ = split_tiny
    blk = build_stacked_vjp_blocks(pg)
    x = torch.randn(4, pg.max_nodes, 64, device=cuda)
    whole = sa.segment_mean_op(x, sa.blocks_to_device(blk, cuda),
                               num_rows=pg.max_nodes)
    for p in range(4):
        bl = sa.blocks_to_device(partition_blocks(blk, p), cuda)
        one = sa.segment_mean_op(x[p], bl, num_rows=pg.max_nodes)
        again = sa.segment_mean_op(x[p], bl, num_rows=pg.max_nodes)
        assert torch.equal(one, whole[p]) and torch.equal(one, again)


@pytest.mark.parametrize("half", ["interior", "boundary"])
def test_partition_split_launch_is_its_rows_of_the_stacked_launch(
        cuda, split_tiny, half):
    """The mesh's row-range single-partition use: each partition's rows of
    a split half (``partition_vjp_blocks``, its own plan) at its n_int as a
    Python int, forward and backward, bitwise its rows of the stacked
    launch at every partition's n_int."""
    from repro_torch.engine.stacking import partition_vjp_blocks
    _, pg, (bi, bb) = split_tiny
    bh = bi if half == "interior" else bb
    n_int = pg.n_int.astype(np.int64) if half == "boundary" else None
    rb = 0 if n_int is None else torch.as_tensor(n_int, device=cuda)
    x = torch.randn(4, pg.max_nodes, 64, device=cuda)
    g = torch.randn(4, pg.own_cap, 64, device=cuda)
    whole_bl = sa.blocks_to_device(bh, cuda)
    whole = sa.segment_mean_op(x, whole_bl, num_rows=pg.own_cap, row_base=rb)
    whole_t = sa.segment_mean_bwd_op(g, whole_bl, n_in=pg.max_nodes,
                                     row_base=rb)
    for p in range(4):
        bl = sa.blocks_to_device(partition_vjp_blocks(bh, p), cuda)
        rbp = 0 if n_int is None else int(n_int[p])
        before = sa.kernel_launch_count()
        one = sa.segment_mean_op(x[p], bl, num_rows=pg.own_cap, row_base=rbp)
        assert sa.kernel_launch_count() == before + 1
        assert torch.equal(one, whole[p]), p
        one_t = sa.segment_mean_bwd_op(g[p], bl, n_in=pg.max_nodes,
                                       row_base=rbp)
        assert torch.equal(one_t, whole_t[p]), p


@pytest.mark.parametrize("backend,P", [("nccl", 1), ("gloo", 2)])
def test_mesh_options_on_card_match_stacked(cuda, tmp_path, backend, P):
    """ROADMAP item 14 part 3 on the card: every eval case of
    ``tests/_torch_mesh_part3_ranks.py`` with the kernels (the cache's
    plans, both codecs, the ring, the store, the overlapped forward) from
    the same shared params and state is bitwise the stacked engine's on
    every rank, and a (0, 0) plan issues no collective."""
    import _torch_mesh_part3_ranks as m3
    import _torch_mesh_ranks as mr
    from repro_torch.launch.mesh import spawn_partition_world

    outs = spawn_partition_world(m3.card_eval_checks, P, (P,),
                                 backend=backend, device="cuda",
                                 workdir=str(tmp_path), timeout_s=120,
                                 join_timeout_s=600)
    g, pg = mr.tiny_case(P)
    want = m3.eval_cases(g, pg, P, "stacked", device="cuda")
    for r, out in enumerate(outs):
        for name, w in want.items():
            got = out[name]
            for i, (a, b) in enumerate(zip(got["steps"], w["steps"])):
                assert torch.equal(a["logits"], b["logits"][r].cpu()), (
                    r, name, i)
                for k in ("cache", "res"):
                    assert _nested_equal(a[k], b[k]), (r, name, i, k)
                assert a["bytes"] == b["bytes"], (r, name, i)
            if name.startswith("cache_k2"):
                assert got["steps"][1]["collectives"] == 0, (r, name)


def _nested_equal(a, b) -> bool:
    """Bitwise equality of nested state (b may live on the card)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nested_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_nested_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b.cpu())
    return a == b


# checkpoint/resume (ROADMAP item 12): the sampled path killed after epoch
# 1 and resumed on the card is bitwise the uninterrupted run, with the
# segment forward kernel in every eval of both

def test_sampled_resume_bitwise_on_card(cuda, tmp_path):
    from repro_torch.pipeline import EATConfig, run_eat_distgnn
    from repro_torch.robustness import FaultPlan, InjectedCrash
    kw = dict(dataset="tiny", num_parts=4, batch_size=32, hidden_dim=16,
              fanouts=(3, 3), max_epochs=6, phase0_fraction=0.5, seed=7,
              device="cuda")
    base = run_eat_distgnn(EATConfig(**kw))
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedCrash):
        run_eat_distgnn(EATConfig(**kw, checkpoint_dir=ck),
                        fault_plan=FaultPlan(crash_epochs=frozenset({1})))
    sa.reset_kernel_launch_count()
    res = run_eat_distgnn(EATConfig(**kw, checkpoint_dir=ck, resume=True))
    # epochs 2..6 evaluate once each, then the test eval: 2 layers each
    assert sa.kernel_launch_count() == 2 * (res.epochs_run - 1 + 1)
    assert res.resumed_from_epoch == 1
    for a, b in zip(res.final_params.parameters(),
                    base.final_params.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert (res.loss_history, res.val_history, res.f1.micro) == (
        base.loss_history, base.val_history, base.f1.micro)


# --------------------------------------------------------------------------
# the partition mesh on the card (ROADMAP item 14, part 1)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,P", [("nccl", 1), ("gloo", 2)])
def test_mesh_world_on_card_matches_stacked(cuda, tmp_path, backend, P):
    """An NCCL world of 1 (P = 1) is bitwise the stacked engine on the
    card; a gloo world of 2 ranks sharing the card has the stacked
    engine's evals and export bitwise from the same params and its epochs
    within the reference's spmd tolerances.  The ranks launch both segment
    kernels."""
    import _torch_mesh_ranks as mr
    from repro_torch.launch.mesh import spawn_partition_world

    outs = spawn_partition_world(mr.card_checks, P, (P,), backend=backend,
                                 device="cuda", workdir=str(tmp_path),
                                 timeout_s=120, join_timeout_s=600)
    g, pg = mr.tiny_case(P)
    eng, _ = mr.engine(pg, g, "stacked", torch.float32, "cuda")
    want = mr.eval_and_export(eng, g, P, device="cuda")
    for r, out in enumerate(outs):
        fwd, bwd = out["launches"]
        assert fwd > 0 and bwd > 0, (r, out["launches"])
        got = out["eval"]
        for split in ("val", "test"):
            for a, b in zip(got[split], want[split]):
                assert torch.equal(a, b.cpu()), (r, split)
        for a, b in zip(got["export"][0] + [got["export"][1]],
                        want["export"][0] + [want["export"][1]]):
            assert torch.equal(a, b.cpu()), r
    for what in mr.EPOCHS:
        eng, opt = mr.engine(pg, g, "stacked", torch.float32, "cuda")
        w = mr.run_epoch(eng, opt, g, P, what, torch.float32, "cuda")
        got = outs[0][what]
        pairs = list(zip(got["params"], w["params"])) + [
            (got["losses"], w["losses"])]
        if P == 1:
            assert all(torch.equal(a, b.cpu()) for a, b in pairs), what
            continue
        tol = 1e-5 if what == "phase1" else 1e-6
        for a, b in pairs:
            assert float((a - b.cpu()).abs().max()) <= tol, what


# --------------------------------------------------------------------------
# the training path: flash attention's forward with the log-sum-exp and its
# backward kernel, the RMSNorm backward, one reduced train step
# --------------------------------------------------------------------------

# tests/test_kernels.py's cases, a row with no key (window 8 past the keys),
# window 0 (every row sees no key), qwen2-0.5b's training shape, Sq and Sk
# off the 64-row tiles, GQA groups 1/2/7 and Dh 32/64/128; then the
# tensor-core backward's work split: group 7 with one and two KV heads, Dh
# 128 (32-row query steps) with a window, Sq = 1 and Sq = 65 at a q_offset.
# Then (b, hq, hkv, sq, sk, dh, causal, window, q_offset, prefix_len): the
# prefix-LM mask at Dh 32/64/128 (a prefix edge inside a key tile, on a
# tile edge, past Sk; a window leaving a gap after the prefix; at a
# q_offset; bidirectional); Dh 256 (eight warps, two per row group, in bf16;
# 32-row tiles in f32) with paligemma-3b's MQA group of 8, with and without
# a prefix, the Sq and Sk tails, a window gap, Sq != Sk, bidirectional;
# whisper-small's three shapes at batch 1 (the encoder's 12 heads over
# 1,500 frames, the decoder's causal 448, the cross-attention's 448 over
# 1,500: the Sk tail of 1,500 in both grids)
FLASH_TRAIN_CASES = [
    (2, 4, 2, 128, 128, 64, True, None, 0),
    (1, 8, 8, 200, 200, 32, True, None, 0),
    (1, 4, 1, 96, 96, 64, True, None, 0),
    (2, 4, 2, 256, 256, 64, True, 64, 0),
    (1, 4, 2, 1, 300, 64, True, None, 300),
    (1, 2, 2, 64, 64, 128, False, None, 0),
    (1, 2, 1, 4, 16, 64, True, 8, 40),
    (1, 4, 2, 70, 70, 64, True, 0, 0),
    (2, 14, 2, 512, 512, 64, True, None, 0),
    (1, 4, 4, 70, 90, 128, True, 33, 20),
    (1, 7, 1, 130, 130, 64, True, None, 0),
    (1, 14, 2, 100, 164, 32, True, None, 64),
    (1, 4, 2, 200, 200, 128, True, 48, 0),
    (2, 4, 1, 1, 97, 64, True, None, 96),
    (1, 6, 2, 65, 200, 128, True, None, 135),
    (1, 4, 2, 200, 200, 64, True, None, 0, 37),
    (1, 2, 2, 96, 96, 128, True, 16, 0, 64),
    (1, 2, 2, 40, 40, 32, True, None, 0, 64),
    (1, 4, 1, 300, 300, 64, True, 64, 0, 100),
    (1, 2, 1, 48, 170, 64, True, 40, 122, 30),
    (1, 2, 2, 64, 64, 64, False, None, 0, 20),
    (1, 8, 1, 200, 200, 256, True, None, 0, 0),
    (1, 8, 1, 300, 300, 256, True, None, 0, 100),
    (1, 8, 1, 130, 190, 256, True, None, 60, 64),
    (2, 4, 2, 300, 300, 256, True, 50, 0, 70),
    (1, 2, 2, 100, 70, 256, False, None, 0, 0),
    (1, 8, 1, 768, 768, 256, True, None, 0, 256),
    (1, 12, 12, 1500, 1500, 64, False, None, 0),
    (1, 12, 12, 448, 448, 64, True, None, 0),
    (1, 12, 12, 448, 1500, 64, False, None, 0),
]
# the backward against autograd of the plain version: f32 sums in another
# order (observed below 1e-5); bf16 gradients round once from f32 sums in
# both, and the kernel's D_i reads the output rounded to bf16 where the
# plain softmax backward reads it in f32, the forward's bf16 tolerance
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# and in bf16 each gradient's max |kernel - plain| within this share of its
# largest plain entry (chip_smoke.py's FLASH_BWD_TOP_RTOL): over long key
# ranges a typical |dk| or |dv| is no larger than the atol above
FLASH_BWD_TOP_RTOL = 3e-2


def _flash_train_inputs(case, dtype, cuda):
    q, k, v = _flash_inputs(case, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    do = torch.randn(q.shape, device=cuda, generator=gen).to(dtype)
    return q, k, v, do


def _train_kw(case):
    """The mask arguments of a FLASH_TRAIN_CASES case (its prefix, 0 where
    the case has none)."""
    causal, window, q_off, *prefix = case[6:]
    return dict(causal=causal, window=window, q_offset=q_off,
                prefix_len=prefix[0] if prefix else 0)


def _train_live(case, cuda):
    return _prefix_live((*case[:6], *_train_kw(case).values()), cuda)


def _dead_rows(case, cuda):
    return ~_train_live(case, cuda).any(1)


@pytest.mark.parametrize("case", FLASH_TRAIN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_train_forward_writes_lse(cuda, case, dtype):
    """The training forward's output is bitwise the serving forward's (the
    LSE changes none of its arithmetic), and its log-sum-exp is the plain
    one of the scaled live scores (-inf for a row with no key)."""
    kw = _train_kw(case)
    q, k, v, _ = _flash_train_inputs(case, dtype, cuda)
    b, hq, sq, dh = q.shape
    before = fa.flash_launch_count("train")
    got, lse = fa.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_launch_count("train") == before + 1
    serve = fa.flash_attention(q, k, v, **kw)
    plan = fa.plan(q.shape, k.shape, causal=kw["causal"],
                   window=kw["window"], q_offset=kw["q_offset"], sms=132,
                   prefix_len=kw["prefix_len"])
    if plan.design == "prefill":
        assert torch.equal(got, serve)
    torch.testing.assert_close(got.float(), fa.flash_attention_plain(
        q, k, v, **kw).float(),
        atol=FLASH_BWD_TOL[dtype], rtol=FLASH_BWD_TOL[dtype])
    kx = k.repeat_interleave(hq // k.shape[1], 1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / dh ** 0.5
    dead = _dead_rows(case, cuda)
    mask = _train_live(case, cuda)
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), -1)
    assert torch.isneginf(lse[:, :, dead]).all()
    torch.testing.assert_close(lse[:, :, ~dead], want[:, :, ~dead],
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", FLASH_TRAIN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_matches_plain_autograd(cuda, case, dtype):
    """dq, dk, dv of the kernels (forward with the LSE, then the backward)
    against autograd of the plain version, within FLASH_BWD_TOL (and in
    bf16 within FLASH_BWD_TOP_RTOL of each one's largest entry); rows that
    see no key give zero dq and no NaN anywhere; each call counts once."""
    kw = _train_kw(case)
    q, k, v, do = _flash_train_inputs(case, dtype, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.flash_launch_count("train"), fa.flash_launch_count("backward"))
    out = fa.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fa.flash_launch_count("train"),
            fa.flash_launch_count("backward")) == (before[0] + 1,
                                                   before[1] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*plain, **kw), plain,
                               do)
    tol = FLASH_BWD_TOL[dtype]
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"d{name}: {m}")
        if dtype == torch.bfloat16:
            err = float((g.float() - w.float()).abs().max())
            top = float(w.float().abs().max())
            assert err <= FLASH_BWD_TOP_RTOL * top, (name, err, top)
    dead = _dead_rows(case, cuda)
    assert not got[0][:, :, dead].float().abs().any()


@pytest.mark.parametrize("case", [(2, 14, 2, 512, 512, 64, True, None, 0),
                                  (1, 4, 4, 300, 300, 128, True, 100, 0),
                                  (2, 8, 1, 768, 768, 256, True, None, 0,
                                   256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_repeats_bitwise(cuda, case, dtype):
    """No atomics: two launches of the backward give the same bits, at
    qwen2-0.5b's training shape (GQA partials summed in head order), with
    one query head per KV head (dK, dV written directly), and at
    paligemma-3b's (Dh 256, group 8, prefix 256) cut to batch 2."""
    q, k, v, do = _flash_train_inputs(case, dtype, cuda)
    kw = _train_kw(case)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_train_refuses_what_it_cannot_take(cuda):
    """Under autograd too, a head size or dtype the kernels do not take
    raises; nothing falls back to the plain version."""
    q = torch.randn(1, 2, 8, 48, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="head sizes"):
        fa.flash_attention(q, q.detach(), q.detach())
    for dt in (torch.float16, torch.float64):
        q = torch.randn(1, 2, 8, 64, device=cuda, dtype=dt,
                        requires_grad=True)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fa.flash_attention(q, q.detach(), q.detach())
    q = torch.randn(1, 2, 8, 64, device=cuda)
    lse = torch.empty(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="q's shape"):
        fa.flash_attention_bwd(q, q, q, q, lse, q[:, :, :4])
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_bwd(*(t.cpu() for t in (q, q, q, q, lse, q)))


# d = 128, 256, 896 (the vector path), 264 and 1,000 (32 lanes with the
# tail masked), 1,500 (ragged at bf16, past 8 vectors a lane at f32: the
# wide path), 2,048 (the vector path's widest at bf16, the wide path at
# f32), 8,192 (the widest row); one row, and fewer rows than the grid's
# blocks throughout
RMS_BWD_SHAPES = [(4, 128), (3, 7, 256), (2, 16, 896), (3, 264), (3, 1500),
                  (2, 8192), (8, 512, 896), (1, 896), (5, 1000), (3, 2048)]
# the backward against autograd of the plain version: f32 row sums in
# another order; bf16 gradients round once from f32 in the kernel, while
# autograd rounds the norm's gradient to bf16 and then adds s's own
# gradient in bf16 (one rounding more)
RMS_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("shape", RMS_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True], ids=["rmsnorm", "add_rmsnorm"])
def test_rmsnorm_bwd_matches_plain_autograd(cuda, shape, dtype, fused):
    """Both entry points' gradients (x, delta and the f32 weight) through
    the hand-written backward against autograd of the plain versions; two
    launches bitwise equal; each launch counted (the fused one in both
    counts)."""
    x, delta, w = _rms_inputs(shape, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    dy = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    ds = torch.randn(shape, device=cuda, generator=gen).to(dtype)

    def grads(fn):
        leaves = [x.clone().requires_grad_(), delta.clone().requires_grad_(),
                  w.clone().requires_grad_()]
        if fused:
            s, y = fn(*leaves)
            return torch.autograd.grad((s, y), leaves, (ds, dy))
        y = fn(leaves[0], leaves[2])
        return torch.autograd.grad(y, [leaves[0], leaves[2]], dy)

    before = (rn.rmsnorm_bwd_launch_count(),
              rn.add_rmsnorm_bwd_launch_count())
    got = grads(rn.add_rmsnorm if fused else rn.rmsnorm)
    again = grads(rn.add_rmsnorm if fused else rn.rmsnorm)
    torch.cuda.synchronize()
    assert (rn.rmsnorm_bwd_launch_count(),
            rn.add_rmsnorm_bwd_launch_count()) == (before[0] + 2,
                                                   before[1] + 2 * fused)
    want = grads(rn.add_rmsnorm_plain if fused else rn.rmsnorm_plain)
    tol = RMS_BWD_TOL[dtype]
    for g, a, wt in zip(got, again, want):
        assert g.dtype == wt.dtype and torch.equal(g, a)
        scale = float(wt.float().abs().max())
        torch.testing.assert_close(g.float(), wt.float(), atol=tol * scale,
                                   rtol=tol)


@pytest.mark.parametrize("fused", [False, True], ids=["rmsnorm", "add_rmsnorm"])
def test_rmsnorm_bwd_is_one_launch(cuda, fused):
    """Under torch.profiler each call runs exactly one kernel (dw in the
    same launch, no memset of its counters); two calls in a row and one at
    another row count each give the plain version's dw, the repeat bitwise
    the first: a ticket counter left dirty by a launch would show."""
    from torch.profiler import ProfilerActivity, profile

    shape = (8, 512, 896)
    x, delta, w = _rms_inputs(shape, torch.bfloat16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dy = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    ds = torch.randn(shape, device=cuda, generator=gen).to(torch.bfloat16)
    rn.rmsnorm_bwd(x, dy, w, ds if fused else None)    # warm: the counters
    torch.cuda.synchronize()
    outs = []
    for rows in (4096, 4096, 37):
        s, g, i = (t.reshape(-1, 896)[:rows] for t in (x, dy, ds))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = rn.rmsnorm_bwd(s, g, w, i if fused else None)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1, [e.name for e in kernels]
        leaves = [s.clone().requires_grad_(), w.clone().requires_grad_()]
        y = rn.rmsnorm_plain(*leaves)
        want = torch.autograd.grad(y, leaves, g)
        scale = float(want[1].abs().max())
        torch.testing.assert_close(got[1], want[1],
                                   atol=RMS_BWD_TOL[torch.bfloat16] * scale,
                                   rtol=RMS_BWD_TOL[torch.bfloat16])
        outs.append(got)
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))


def test_rmsnorm_bwd_refuses_what_it_cannot_take(cuda):
    x, _, w = _rms_inputs((4, 256), torch.float32, cuda)
    with pytest.raises(ValueError, match="shape, dtype and device"):
        rn.rmsnorm_bwd(x, x.bfloat16(), w)
    with pytest.raises(ValueError, match="at most"):
        big = torch.randn(2, rn.BWD_MAX_D + 8, device=cuda)
        rn.rmsnorm_bwd(big, big, torch.ones(big.shape[-1], device=cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rn.rmsnorm(x.half().requires_grad_(), w)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "starcoder2-7b"])
def test_reduced_train_step_kernels_match_plain(cuda, arch):
    """One reduced-config f32 train step (loss and every gradient) with the
    kernels, forward and backward, against the plain versions from the same
    weights; every attention and RMSNorm call of the step went through the
    kernels."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    model = Transformer(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 96))
    batch = {"tokens": tokens,
             "labels": np.concatenate([tokens[:, 1:], -np.ones((2, 1),
                                                               np.int64)], 1)}
    out = {}
    for use in (True, False):
        model.use_kernels = use
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        loss = model.train_loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out[use] = (loss, grads, fa.flash_launch_count("train"),
                    fa.flash_launch_count("backward"),
                    rn.rmsnorm_launch_count(), rn.rmsnorm_bwd_launch_count())
    L = cfg.num_layers
    norms = 0 if cfg.norm == "layernorm" else 1
    # remat replays each layer's forward in the backward
    assert out[True][2:] == (2 * L, L, norms * (4 * L + 1),
                             norms * (2 * L + 1)), out[True][2:]
    assert out[False][2:] == (0, 0, 0, 0)
    torch.testing.assert_close(out[True][0], out[False][0], atol=1e-5,
                               rtol=1e-5)
    for g, w in zip(out[True][1], out[False][1]):
        scale = float(w.abs().max()) or 1.0
        torch.testing.assert_close(g, w, atol=1e-4 * scale, rtol=1e-3)


# ------------------------------------------- the rest of the decoder zoo --

@pytest.mark.parametrize("cache_len", [100, 4095, 4096, 4097, 9000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_rolling_decode_kernel_matches_plain(cuda, cache_len, dtype, tol):
    """A rolling decode step's attention (starcoder2's GQA group of 9 at Dh
    128, a 4,096-slot mod-W cache) through the split-KV decode kernel
    against the plain version on the same cache: below, at and past the
    width; and against a softmax over the valid slots in slot order (the
    reference's ``rolling_window_attention``) computed in f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("starcoder2-7b")
    w, hq, hkv, dh = 4096, cfg.num_heads, cfg.num_kv_heads, 128
    gen = torch.Generator(device=cuda).manual_seed(cache_len)
    q = torch.randn((2, hq, 1, dh), device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn((2, hkv, w, dh), device=cuda, generator=gen)
            .to(dtype) for _ in range(2))
    q_offset = min(cache_len, w - 1)
    before = fa.flash_launch_count("decode")
    got = fa.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    again = fa.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_launch_count("decode") == before + 2
    assert torch.equal(got, again)
    want = fa.flash_attention_plain(q, k, v, causal=True, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    valid = torch.as_tensor(L.rolling_slot_positions(cache_len + 1, w) >= 0,
                            device=cuda)
    s = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(),
                     k.float().repeat_interleave(hq // hkv, 1)) / dh ** 0.5
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), -1)
    oracle = torch.einsum("bhk,bhkd->bhd", p,
                          v.float().repeat_interleave(hq // hkv, 1))
    torch.testing.assert_close(got[:, :, 0].float(), oracle, atol=tol,
                               rtol=tol)


def test_moe_and_mamba2_on_card(cuda):
    """``moe_apply`` and ``mamba2_apply`` / ``mamba2_decode`` (plain
    PyTorch on the card): two runs bitwise equal, and within f32 tolerance
    of the CPU on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("jamba-v0.1-52b").reduced()
    gen = torch.Generator().manual_seed(0)
    moe = L.moe_init(cfg, gen)
    mamba = L.mamba2_init(cfg, gen)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    nxt = torch.randn((2, 1, cfg.d_model), generator=gen)

    def run(dev):
        on = lambda p: {k: v.to(dev) for k, v in p.items()}
        y, aux = L.moe_apply(on(moe), x.to(dev), cfg)
        m, cache = L.mamba2_apply(on(mamba), x.to(dev), cfg)
        d, cache = L.mamba2_decode(on(mamba), nxt.to(dev), cache, cfg)
        return [t.cpu() for t in (y, aux, m, d, cache["conv"], cache["ssm"])]

    first, second, cpu = run(cuda), run(cuda), run("cpu")
    for a, b, c in zip(first, second, cpu):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-4)


def test_reduced_jamba_decode_kernels_match_plain(cuda):
    """Reduced jamba (attention, Mamba2, MLP and MoE in one super-block; a
    mixed cache per layer) in f32: prefill and a decode step through the
    kernels against the plain versions on the same weights, with each
    pass's launches: one flash attention, 17 RMSNorm of which 16 fused."""
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    cfg = get_config("jamba-v0.1-52b").reduced()
    model = Transformer(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 64))
    tok = rng.integers(0, cfg.vocab_size, (2, 1))
    out = {}
    for use in (True, False):
        model.use_kernels = use
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        lg, caches, n = model.prefill({"tokens": prompt}, cache_size=80)
        counts = [(fa.flash_launch_count(), rn.rmsnorm_launch_count(),
                   rn.add_rmsnorm_launch_count())]
        lg2, caches = model.decode_step(tok, caches, n)
        torch.cuda.synchronize()
        counts.append((fa.flash_launch_count() - counts[0][0],
                       rn.rmsnorm_launch_count() - counts[0][1],
                       rn.add_rmsnorm_launch_count() - counts[0][2]))
        out[use] = (lg, lg2, caches, counts)
    n_layers = cfg.num_layers
    assert out[True][3] == [(1, 2 * n_layers + 1, 2 * n_layers)] * 2, \
        out[True][3]
    assert out[False][3] == [(0, 0, 0)] * 2
    for a, b in zip(out[True][:2], out[False][:2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for ck, cp in zip(out[True][2], out[False][2]):
        assert set(ck) == set(cp)
        for key in ck:
            torch.testing.assert_close(ck[key], cp[key], atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# the sharded LLM steps on a mesh (ROADMAP item 15.7)
# --------------------------------------------------------------------------

def test_sharded_steps_on_card(cuda, tmp_path):
    """A world of 2 ranks sharing the card (the ``staged`` backend) on a
    ``(1, 2)`` mesh runs the four step kinds of reduced f32 qwen2-0.5b with
    the kernels on each rank's shard: within 1e-5 of the largest entry of
    the world of 1's (NCCL, ``(1, 1)``) loss, gradients, logits and caches,
    greedy tokens equal, the gradients' global norm (AdamW's clip) within
    1e-6 relative, the weights after one step as
    ``test_torch_sharding_world.py`` holds them; each rank launches the flash and RMSNorm kernels
    as often as the unsharded step does; the staged backend's bytes equal
    ``step_collective_bytes``.  The world of 1 is bitwise its own
    unsharded steps."""
    import _torch_sharding_ranks as sr
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_partition_world

    build.build_all()
    one = spawn_partition_world(sr.card_checks, 1, ((1, 1),),
                                backend="nccl", device="cuda",
                                workdir=str(tmp_path / "w1"), timeout_s=120,
                                join_timeout_s=600)[0]
    two = spawn_partition_world(sr.card_checks, 2, ((1, 2),),
                                backend="staged", device="cuda",
                                workdir=str(tmp_path / "w2"), timeout_s=120,
                                join_timeout_s=600)
    a, b = one["sharded"], one["plain"]
    for key in ("loss", "grad_norm", "prefill", "prefill_k", "decode",
                "tokens"):
        assert np.array_equal(a[key], b[key]), key
    for n in b["grads"]:
        assert np.array_equal(a["grads"][n], b["grads"][n]), n
        assert np.array_equal(a["params"][n], b["params"][n]), n
    for r, out in enumerate(two):
        got, plain = out["sharded"], out["plain"]
        for kind, counts in plain["launches"].items():
            assert got["launches"][kind] == counts, (r, kind)
            assert sum(counts.values()) > 0, kind
        for kind in ("train", "prefill", "decode"):
            assert got[f"{kind}_bytes"] == got["closed_form"][kind], (
                r, kind, got[f"{kind}_bytes"], got["closed_form"][kind])
        scale = lambda x: float(np.abs(x).max()) or 1.0
        for key in ("loss", "prefill", "prefill_k", "prefill_v", "decode",
                    "decode_k"):
            err = float(np.abs(np.asarray(got[key]) - a[key]).max())
            assert err <= 1e-5 * scale(a[key]), (r, key, err)
        # the clip's norm, of the full gradients; the weights after AdamW's
        # first step within 1e-5 of the largest weight where the gradient
        # is at least 1e-6, within 1e-4 below (there -lr g / (|g| + eps)
        # turns on the gradient's rounding)
        assert abs(got["grad_norm"] - a["grad_norm"]) <= 1e-6 * a[
            "grad_norm"], (r, got["grad_norm"], a["grad_norm"])
        w_max = max(scale(p) for p in a["params"].values())
        for n in a["grads"]:
            err = float(np.abs(got["grads"][n] - a["grads"][n]).max())
            assert err <= 1e-5 * scale(a["grads"][n]), (r, n, err)
            dw = np.abs(got["params"][n] - a["params"][n])
            big = np.abs(a["grads"][n]) >= 1e-6
            assert dw[big].max(initial=0) <= 1e-5 * w_max, (r, n)
            assert dw[~big].max(initial=0) <= 1e-4, (r, n)
        np.testing.assert_array_equal(got["tokens"], a["tokens"])
        sp, pp = out["personalize"]
        assert sp["launches"] == pp["launches"], r
        np.testing.assert_allclose(sp["losses"], one["personalize"][0][
            "losses"], rtol=1e-5)


# ------------------------------- training MoE and Mamba2 (ROADMAP 15.9) --

def _train_pass_launches(cfg):
    """A training pass's (flash forward, flash backward, RMSNorm forward,
    RMSNorm backward) launches: remat replays each decoder layer's forward
    (its self- and cross-attention and norms), not the encoder's; the
    final norms run once."""
    attn = sum((sl.mixer == "attention") + sl.cross_attention
               for sl in cfg.super_block) * cfg.num_repeats
    norms = sum(1 + sl.cross_attention + (sl.ffn != "none")
                for sl in cfg.super_block) * cfg.num_repeats + 1
    enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    enc_norms = 2 * enc + 1 if enc else 0
    rms = cfg.norm == "rmsnorm"
    return (2 * attn + enc, attn + enc,
            rms * (2 * (norms - 1) + 1 + enc_norms), rms * (norms + enc_norms))


@pytest.mark.parametrize("arch", ["whisper-small", "paligemma-3b"])
def test_reduced_encdec_train_kernels_match_plain(cuda, arch):
    """A reduced f32 training pass of the encoder-decoder (the encoder
    under autograd, the decoder's cross-attention at Sq != Sk) and the
    prefix-LM (its prefix through the flash backward, at Dh 256) with the
    kernels, forward and backward, against the plain versions from the same
    weights: the loss and every gradient; the kernels' launches are the
    pass's attention and RMSNorm calls."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer

    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    if arch == "paligemma-3b":
        cfg = dataclasses.replace(cfg, head_dim=256)
    model = Transformer(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 80))
    batch = {"tokens": tokens,
             "labels": np.concatenate([tokens[:, 1:], -np.ones((2, 1),
                                                               np.int64)], 1)}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rng.normal(0, 1, (2, cfg.encoder_seq,
                                                cfg.d_model))
    if cfg.prefix_tokens:
        batch["patch_embeds"] = rng.normal(0, 1, (2, cfg.prefix_tokens,
                                                  cfg.d_model))
    out = {}
    for use in (True, False):
        model.use_kernels = use
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        loss = model.train_loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        out[use] = (loss, grads, (
            fa.flash_launch_count("train"), fa.flash_launch_count("backward"),
            rn.rmsnorm_launch_count(), rn.rmsnorm_bwd_launch_count()))
    assert out[True][2] == _train_pass_launches(cfg), out[True][2]
    assert out[False][2] == (0, 0, 0, 0)
    assert torch.isfinite(out[True][0])
    torch.testing.assert_close(out[True][0], out[False][0], atol=1e-5,
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    plain = dict(zip(names, out[False][1]))
    for name, g, w in zip(names, out[True][1], out[False][1]):
        assert torch.isfinite(g).all(), name
        # whisper's key bias has a gradient of 0 in exact arithmetic (no
        # RoPE: q . b_k is the same for every key), rounding alone on both
        # sides: held against its projection's gradient
        like = plain[name[:-3] + "wk"] if name.endswith(".b_k") else w
        scale = float(like.abs().max()) or 1.0
        torch.testing.assert_close(g, w, atol=1e-4 * scale, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("arch", ["mamba2-370m", "phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b", "jamba-v0.1-52b"])
def test_reduced_zoo_train_kernels_match_plain(cuda, arch):
    """A reduced f32 training pass (loss with MoE's auxiliary loss, every
    gradient) of the MoE and Mamba2 families with the kernels, forward and
    backward, against the plain versions from the same weights, on a batch
    whose MoE routes agree between the two; the kernels' launches are the
    pass's attention and RMSNorm calls."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    model = Transformer(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 64))
    batch = {"tokens": tokens,
             "labels": np.concatenate([tokens[:, 1:], -np.ones((2, 1),
                                                               np.int64)], 1)}
    out, inner = {}, L.moe_route
    for use in (True, False):
        model.use_kernels = use
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        routes = []

        def spy(p, xf, c):
            r = inner(p, xf, c)
            routes.append((r[2].cpu(), r[4].cpu()))
            return r

        L.moe_route = spy
        try:
            loss = model.train_loss(batch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        finally:
            L.moe_route = inner
        torch.cuda.synchronize()
        out[use] = (loss, grads, routes, (
            fa.flash_launch_count("train"), fa.flash_launch_count("backward"),
            rn.rmsnorm_launch_count(), rn.rmsnorm_bwd_launch_count()))
    assert out[True][3] == _train_pass_launches(cfg), out[True][3]
    assert out[False][3] == (0, 0, 0, 0)
    for (ik, kk), (ip, kp) in zip(out[True][2], out[False][2]):
        assert torch.equal(ik, ip) and torch.equal(kk, kp)
    assert torch.isfinite(out[True][0])
    torch.testing.assert_close(out[True][0], out[False][0], atol=1e-5,
                               rtol=1e-5)
    for g, w in zip(out[True][1], out[False][1]):
        assert torch.isfinite(g).all()
        scale = float(w.abs().max()) or 1.0
        torch.testing.assert_close(g, w, atol=1e-4 * scale, rtol=1e-3)


def test_train_step_counts_on_the_card_equal_meta(cuda):
    """A reduced bf16 qwen2-0.5b train step counted on the card (the
    kernels run) and on meta: the same FLOPs and every kernel's count
    (ROADMAP 15.8)."""
    import dataclasses

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.steps import build_step
    from repro_torch.models import Transformer
    from repro_torch.roofline import StepCounter
    from repro_torch.train.optim import AdamW

    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              dtype="bfloat16", remat=True)
    built = build_step(cfg, InputShape("t", 64, 2, "train"))
    counts = {}
    for dev in ("cuda", "meta"):
        model = Transformer(cfg, seed=0, device=dev)
        state = AdamW().init(model.parameters())
        tokens = torch.zeros((2, 64), dtype=torch.long, device=dev)
        with StepCounter() as sc:
            built.step(model, state, {"tokens": tokens, "labels": tokens})
        counts[dev] = sc
    assert counts["cuda"].flops == counts["meta"].flops > 0
    assert counts["cuda"].kernels == counts["meta"].kernels

"""The port's flash attention, RMSNorm and fused add + RMSNorm on CPU tensors
(their plain versions) against the reference's Pallas kernels in interpret
mode (after the reference's own add, for the fused one), the reference's
oracles and the model's ``chunked_attention``; and the wrappers' dispatch and
input rules (no launch and no fallback off CUDA).  Inputs are
made with numpy from a seed and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models.layers import chunked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn

# the tolerances tests/test_kernels.py holds the Pallas kernels to
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
RMS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}

# tests/test_kernels.py's CASES plus a fully masked row (every key lies
# outside the window) and a window with q_offset over a ragged cache:
# b, hq, hkv, sq, sk, dh, causal, window, q_offset
CASES = [
    (2, 4, 2, 128, 128, 64, True, None, 0),
    (1, 8, 8, 200, 200, 32, True, None, 0),       # MHA, ragged seq
    (1, 4, 1, 96, 96, 64, True, None, 0),         # MQA
    (2, 4, 2, 256, 256, 64, True, 64, 0),         # sliding window
    (1, 4, 2, 1, 300, 64, True, None, 300),       # decode, ragged kv
    (1, 2, 2, 64, 64, 128, False, None, 0),       # encoder (bidirectional)
    (1, 2, 1, 4, 16, 64, True, 8, 40),            # fully masked rows
    (2, 14, 2, 1, 116, 64, True, 16, 100),        # GQA-7 decode, window
]


def _inputs(case, seed):
    b, hq, hkv, sq, sk, dh = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]


def _to_jax(arrays, dtype):
    return [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays]


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_pallas_interpret(case, dtype):
    causal, window, q_off = case[6:]
    arrays = _inputs(case, seed=sum(case[:6]))
    kw = dict(causal=causal, window=window, q_offset=q_off)
    want = j_ops.flash_attention(*_to_jax(arrays, dtype), block_q=64,
                                 block_k=64, interpret=True, **kw)
    before = fa.flash_launch_count()
    got = ops.flash_attention(*_to_torch(arrays, dtype), **kw)
    assert fa.flash_launch_count() == before       # no kernel on the CPU
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    if case == CASES[6]:
        assert not got.float().abs().any()         # fully masked rows are 0


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[7]])
def test_flash_matches_reference_oracle_and_chunked(case):
    """f32: the port's plain version against the reference's dense oracle
    and the model's chunked online-softmax twin."""
    causal, window, q_off = case[6:]
    arrays = _inputs(case, seed=7)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    got = ops.flash_attention(*_to_torch(arrays, "float32"), **kw).numpy()
    jq, jk, jv = _to_jax(arrays, "float32")
    np.testing.assert_allclose(got, np.asarray(j_ref.attention_ref(
        jq, jk, jv, **kw)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(chunked_attention(
        jq, jk, jv, chunk_q=32, chunk_k=64, **kw)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 512), (2, 5, 33, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(shape[-1])
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 1, shape[-1]).astype(np.float32)
    want = j_ops.rmsnorm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w))
    before = rn.rmsnorm_launch_count()
    got = ops.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(w))
    assert rn.rmsnorm_launch_count() == before
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    tol = RMS_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(
        ref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(j_ref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 128), (3, 7, 512), (2, 5, 33, 256),
                                   (2, 3, 896)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_matches_reference(shape, dtype):
    """s bitwise against jnp's ``x + delta`` (both round the exact f32 sum
    to nearest even, in f32 and in bf16), y against the Pallas kernel in
    interpret mode run on that sum, at the tolerance of the plain norm."""
    rng = np.random.default_rng(shape[-1] + 1)
    x, delta = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    w = rng.normal(0, 1, shape[-1]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_s = jnp.asarray(x, jdt) + jnp.asarray(delta, jdt)
    j_y = j_ops.rmsnorm(j_s, jnp.asarray(w))
    before = (rn.rmsnorm_launch_count(), rn.add_rmsnorm_launch_count())
    s, y = ops.add_rmsnorm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(delta).to(tdt),
                           torch.from_numpy(w))
    assert (rn.rmsnorm_launch_count(), rn.add_rmsnorm_launch_count()) == before
    assert s.dtype == y.dtype == tdt and s.shape == y.shape == shape
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(j_s, np.float32))
    tol = RMS_TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), np.asarray(j_y, np.float32),
                               atol=tol, rtol=tol)
    # the norm is taken from the rounded sum: exactly rmsnorm of s
    assert torch.equal(y, ops.rmsnorm(s, torch.from_numpy(w)))


def test_flash_input_rules():
    q, k = torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="fit"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64))
    with pytest.raises(ValueError, match="Dh"):
        ops.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=-1)
    # what only the CUDA kernel refuses, checked without a card
    with pytest.raises(ValueError, match="head sizes"):
        fa._check_kernel_inputs(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_kernel_inputs(q.transpose(1, 2), k, k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_kernel_inputs(q.half(), k.half(), k.half())
    # a meta q computes nothing: the output's shape and dtype on meta
    # (the shape-only branch of the dry run), no launch
    before = fa.flash_launch_count()
    out = ops.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == q.dtype and fa.flash_launch_count() == before


def test_rmsnorm_input_rules():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="does not fit"):
        ops.rmsnorm(x, torch.ones(7))
    # a meta x gives the output's shape on meta, no launch
    before = rn.rmsnorm_launch_count()
    out = ops.rmsnorm(x.to("meta"), torch.ones(8, device="meta"))
    assert out.device.type == "meta" and out.shape == x.shape
    assert rn.rmsnorm_launch_count() == before


def test_add_rmsnorm_input_rules():
    x, w = torch.zeros(3, 8), torch.ones(8)
    with pytest.raises(ValueError, match="shape, dtype and device"):
        ops.add_rmsnorm(x, torch.zeros(3, 7), w)
    with pytest.raises(ValueError, match="shape, dtype and device"):
        ops.add_rmsnorm(x, torch.zeros(3, 8, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="shape, dtype and device"):
        ops.add_rmsnorm(x, torch.zeros(3, 8, device="meta"), w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.add_rmsnorm(x, torch.zeros(8, 3).T, w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.add_rmsnorm(torch.zeros(8, 3).T, x, w)
    with pytest.raises(ValueError, match="does not fit"):
        ops.add_rmsnorm(x, x, torch.ones(7))
    before = rn.rmsnorm_launch_count()
    s, y = ops.add_rmsnorm(x.to("meta"), x.to("meta"), w.to("meta"))
    assert s.device.type == y.device.type == "meta"
    assert s.shape == y.shape == x.shape
    assert rn.rmsnorm_launch_count() == before

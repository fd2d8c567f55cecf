"""The arithmetic of the Hopper flash attention designs, emulated on the CPU
(a CUDA kernel has no CPU mode), and the host function that picks them.

(a) The tensor-core prefill: f32 scores from bf16 q.k scaled in f32, online
    softmax in the log2 domain over 64-key tiles, the live key range of each
    q tile (128 rows at Dh <= 64, else 64), and P split into two bf16 halves
    for the P.V products.
    Held against the plain version ``attention_ref`` at the main path's bf16
    tolerance (one output ulp), on long rows; a bf16 P alone does not hold
    it, which is why the kernel splits P.
(b) The split-KV decode: per-split partials (m, l, acc) over chunks of the
    live key range and a fixed-order log-sum-exp merge, against
    ``attention_ref`` and the reference's Pallas kernel in interpret mode;
    empty splits change no bit of the merge.
(c) ``plan``: which design a call takes and how decode is split.

Inputs are made with numpy from a seed and handed to both packages."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# the main path's bf16 tolerance (chip_smoke.py's BF16_MAIN_*): one bf16
# ulp, since kernel and plain version each round one f32 result
BF16_ATOL, BF16_RTOL = 1e-5, 2.0 ** -7
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py's
TILE = 64                 # the prefill kernel's keys per K/V tile
LOG2E = 1.4426950408889634
NEG = -1e30               # the kernels' running-max floor


def _inputs(b, hq, hkv, sq, sk, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _scale_log2(dh):
    # the kernels' f32 product of 1/sqrt(Dh) (a ctypes float) and log2 e
    return (torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
            * torch.tensor(LOG2E, dtype=torch.float32))


def _live(q_pos, k_pos, causal, window):
    live = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool)
    if causal:
        live &= k_pos[None] <= q_pos[:, None]
    if window is not None:
        live &= k_pos[None] > q_pos[:, None] - window
    return live


def emulate_prefill(q, k, v, *, causal, window, q_offset, split_p=True):
    """The tensor-core prefill kernel's arithmetic, tile by tile."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(hq // hkv, 1)
    vf = v.float().repeat_interleave(hq // hkv, 1)
    scale = _scale_log2(dh)
    out = torch.zeros(b, hq, sq, dh)
    bq = 128 if dh <= 64 else 64        # q rows per block
    for q0 in range(0, sq, bq):
        q1 = min(q0 + bq, sq)
        q_first, q_last = q_offset + q0, q_offset + q1 - 1
        k_hi = min(sk, q_last + 1) if causal else sk
        k_lo = 0 if window is None else max(0, q_first - window + 1)
        k_lo = k_lo // TILE * TILE
        pos = torch.arange(q0, q1) + q_offset
        m = torch.full((b, hq, q1 - q0), NEG)
        l = torch.zeros(b, hq, q1 - q0)
        acc = torch.zeros(b, hq, q1 - q0, dh)
        for k0 in range(k_lo, k_hi, TILE):
            k1 = min(k0 + TILE, sk)
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)
            live = _live(pos, torch.arange(k0, k1), causal, window)
            s = s.masked_fill(~live, float("-inf"))
            # max of the raw scores, scaled; the exponent is one fma
            mx = torch.maximum(m, s.amax(-1) * scale)
            alpha = torch.exp2(m - mx)
            arg = s.double() * scale.double() - mx.double()[..., None]
            p = torch.exp2(arg.float())
            l = l * alpha + p.sum(-1)
            hi = p.bfloat16().float()
            pv = hi @ vf[:, :, k0:k1]
            if split_p:
                pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k1]
            acc = acc * alpha[..., None] + pv
            m = mx
        out[:, :, q0:q1] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.to(q.dtype)


def decode_partials(q, k, v, p):
    """The split kernel: per split (m, l, acc) in f32, log2 domain."""
    b, hq, _, dh = q.shape
    hkv = k.shape[1]
    kc = min(64, 16384 // (dh * q.element_size()))   # keys per tile
    qg = q.float().reshape(b, hkv, hq // hkv, dh)
    scale = _scale_log2(dh)
    parts = []
    for split in range(p.n_split):
        c_lo = p.k_lo + split * p.chunk
        c_hi = min(p.k_hi, c_lo + p.chunk)
        m = torch.full(qg.shape[:3], NEG)
        l = torch.zeros(qg.shape[:3])
        acc = torch.zeros(qg.shape)
        for c0 in range(c_lo, c_hi, kc):
            c1 = min(c0 + kc, c_hi)
            s = torch.einsum("bhgd,bhjd->bhgj", qg, k[:, :, c0:c1].float())
            s = s * scale
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - mx)
            pr = torch.exp2(s - mx[..., None])
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + pr @ v[:, :, c0:c1].float()
            m = mx
        parts.append((m, l, acc))
    return parts


def decode_merge(parts, q):
    """The merge kernel: splits weighted by 2^(m_s - max m), in order."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros(parts[0][2].shape)
    den = torch.zeros(mx.shape)
    for m, l, acc in parts:
        w = torch.exp2(m - mx)
        den = den + l * w
        num = num + acc * w[..., None]
    out = num / torch.where(den == 0, 1.0, den)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def emulate_decode(q, k, v, *, causal, window, q_offset, sms=132):
    p = fa.plan(q.shape, k.shape, causal=causal, window=window,
                q_offset=q_offset, sms=sms)
    assert p.design == "decode"
    return decode_merge(decode_partials(q, k, v, p), q)


# ---------------------------------------------------------------------------
# (a) the tensor-core prefill
# ---------------------------------------------------------------------------

# b, hq, hkv, sq, sk, dh, causal, window, q_offset: long causal rows (GQA),
# a window across tile edges, and a chunk continuing at q_offset with Sq
# and Sk off the tiles
PREFILL_CASES = [
    (1, 2, 1, 1024, 1024, 64, True, None, 0),
    (1, 2, 2, 1024, 1024, 64, True, 200, 0),
    (1, 2, 1, 300, 470, 128, True, None, 170),
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_split_p_holds_one_ulp(case):
    b, hq, hkv, sq, sk, dh, causal, window, q_off = case
    q, k, v = _torch(_inputs(b, hq, hkv, sq, sk, dh, seed=sq + sk),
                     torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    got = emulate_prefill(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=BF16_RTOL)


def test_prefill_bf16_p_breaks_the_tolerance():
    """Rounding P to bf16 (2^-9 relative per term) moves outputs that cancel
    by more than one ulp: the reason for the P_hi + P_lo split."""
    q, k, v = _torch(_inputs(1, 2, 1, 1024, 1024, 64, seed=2048),
                     torch.bfloat16)
    got = emulate_prefill(q, k, v, causal=True, window=None, q_offset=0,
                          split_p=False)
    want = ref.attention_ref(q, k, v, causal=True)
    assert not torch.allclose(got.float(), want.float(), atol=BF16_ATOL,
                              rtol=BF16_RTOL)


def test_prefill_fully_masked_rows_are_zero():
    q, k, v = _torch(_inputs(1, 2, 1, 70, 16, 64, seed=3), torch.bfloat16)
    got = emulate_prefill(q, k, v, causal=True, window=8, q_offset=40)
    assert not got.float().abs().any()


# ---------------------------------------------------------------------------
# (b) the split-KV decode
# ---------------------------------------------------------------------------

# b, hq, hkv, sk, dh, causal, window, q_offset, sms: GQA groups 1, 2, 7, 8;
# q_offset 0 and the last cache slot; a window; a bidirectional query; a
# fully masked row; few and many splits
DECODE_CASES = [
    (2, 2, 2, 300, 64, True, None, 299, 132),
    (1, 4, 2, 257, 128, True, None, 0, 132),
    (2, 14, 2, 500, 64, True, None, 400, 132),
    (1, 16, 2, 300, 32, True, 64, 250, 132),
    (1, 16, 2, 300, 64, True, None, 299, 4),
    (1, 4, 2, 200, 64, False, None, 0, 132),
    (1, 4, 1, 64, 64, True, 8, 80, 132),
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_matches_oracle_and_pallas(case, dtype):
    b, hq, hkv, sk, dh, causal, window, q_off, sms = case
    arrays = _inputs(b, hq, hkv, 1, sk, dh, seed=sk + q_off)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    q, k, v = _torch(arrays, getattr(torch, dtype))
    got = emulate_decode(q, k, v, sms=sms, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    atol, rtol = ((BF16_ATOL, BF16_RTOL) if dtype == "bfloat16"
                  else (FLASH_TOL[dtype], FLASH_TOL[dtype]))
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    pallas = j_ops.flash_attention(
        *[jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays],
        block_q=64, block_k=64, interpret=True, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])
    if fa.plan(q.shape, k.shape, sms=sms, **kw).k_lo >= min(sk, q_off + 1):
        assert not got.float().abs().any()          # no live key: exactly 0


@pytest.mark.parametrize("extra", [1, 5])
def test_decode_empty_splits_change_no_bit(extra):
    """Splits past the live range (m = -1e30, l = 0, acc = 0) get weight 0:
    the merge with them is bitwise the merge without them."""
    q, k, v = _torch(_inputs(2, 14, 2, 1, 600, 64, seed=5), torch.float32)
    p = fa.plan(q.shape, k.shape, causal=True, window=None, q_offset=550,
                sms=16)
    parts = decode_partials(q, k, v, p)
    padded = decode_partials(q, k, v, p._replace(n_split=p.n_split + extra))
    assert all(not l.any() and not acc.any() and (m == NEG).all()
               for m, l, acc in padded[p.n_split:])
    assert torch.equal(decode_merge(padded, q), decode_merge(parts, q))


def test_decode_split_count_moves_only_rounding():
    """One split (the one-pass result) and many agree to f32 rounding."""
    q, k, v = _torch(_inputs(1, 14, 2, 1, 2116, 64, seed=6), torch.float32)
    kw = dict(causal=True, window=None, q_offset=2048)
    one = emulate_decode(q, k, v, sms=1, **kw)
    many = emulate_decode(q, k, v, sms=132, **kw)
    assert fa.plan(q.shape, k.shape, sms=1, **kw).n_split == 1
    assert fa.plan(q.shape, k.shape, sms=132, **kw).n_split > 30
    torch.testing.assert_close(one, many, atol=2e-6, rtol=2e-6)


# ---------------------------------------------------------------------------
# (c) the host plan
# ---------------------------------------------------------------------------

def test_plan_qwen2_decode_fills_two_waves():
    p = fa.plan((4, 14, 1, 64), (4, 2, 2116, 64), causal=True, window=None,
                q_offset=2048, sms=132)
    assert p == fa.Plan("decode", 0, 2049, 63, 33)
    assert 4 * 2 * p.n_split == 2 * 132          # two waves of blocks


@pytest.mark.parametrize("q_shape,k_shape", [
    ((4, 14, 2048, 64), (4, 2, 2048, 64)),      # prefill
    ((1, 4, 2, 64), (1, 2, 300, 64)),           # two query rows
    ((1, 34, 1, 64), (1, 2, 300, 64)),          # group 17 at Sq = 1
])
def test_plan_prefill(q_shape, k_shape):
    p = fa.plan(q_shape, k_shape, causal=True, window=None, q_offset=0,
                sms=132)
    assert p.design == "prefill"


@pytest.mark.parametrize("causal,window,q_offset,sk,want", [
    (True, None, 0, 300, (0, 1)),                 # first token
    (True, None, 299, 300, (0, 300)),             # last slot
    (True, None, 500, 300, (0, 300)),             # past the cache
    (False, None, 0, 300, (0, 300)),              # bidirectional
    (True, 64, 250, 300, (187, 251)),             # window
    (True, 8, 80, 64, (73, 64)),                  # nothing live
])
def test_plan_decode_live_range(causal, window, q_offset, sk, want):
    p = fa.plan((2, 16, 1, 64), (2, 2, sk, 64), causal=causal, window=window,
                q_offset=q_offset, sms=132)
    assert p.design == "decode" and (p.k_lo, p.k_hi) == want


@pytest.mark.parametrize("b,hkv,sk,sms", [
    (4, 2, 2116, 132), (1, 1, 1, 132), (1, 2, 40, 132), (8, 8, 4096, 132),
    (1, 1, 100000, 132), (2, 2, 700, 4)])
def test_plan_decode_chunks_cover_the_live_keys(b, hkv, sk, sms):
    p = fa.plan((b, hkv * 7, 1, 64), (b, hkv, sk, 64), causal=True,
                window=None, q_offset=sk - 1, sms=sms)
    live = p.k_hi - p.k_lo
    assert live == sk
    assert p.chunk >= fa.DECODE_MIN_CHUNK
    assert (p.n_split - 1) * p.chunk < live <= p.n_split * p.chunk
    # no more blocks than the waves ask for, unless one split is all
    assert b * hkv * p.n_split <= max(b * hkv, 2 * sms + b * hkv)

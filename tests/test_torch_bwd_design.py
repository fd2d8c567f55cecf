"""The host side of the training path's backward kernels, and the
arithmetic of the flash backward's tensor-core design emulated on the CPU
(a CUDA kernel has no CPU mode).

(a) The flash backward (``csrc/flash_attention_bwd.cu``, bf16):
    - the tile walks of ``flash_bwd_dkdv_mma_kernel`` (per key tile of 64,
      the live query tiles of 64 rows, 32 at Dh 128) and
      ``flash_bwd_dq_mma_kernel`` (per query tile of 64, the live key
      tiles): every live (query, key) pair lies in exactly one visited
      tile, and a tile the kernels leave unmasked is whole and fully live;
    - its arithmetic: f32 scores, P = 2^(s scale log2e - lse log2e), dS =
      P (dP - D) with D from the output rounded to bf16, P and dS split
      into two bf16 halves for the dV, dK and dQ products, the GQA
      partials summed in head order, one rounding to bf16; held against
      ``jax.vjp`` of the reference's ``chunked_attention`` at the kernel's
      tolerance (``tests/test_torch_gpu.py``'s FLASH_BWD_TOL), no further
      from it than a bf16 P and dS alone (within 2^-8: the gradients'
      own bf16 rounding dominates both);
    - ``bwd_part_elems`` and ``bwd_counter_elems``: the GQA partials'
      scratch and their ticket counters (``kernels/build.py::ticket_counters``,
      one cached buffer per kernel and device).
(b) The RMSNorm backward's grid (``kernels/rmsnorm.py::_bwd_grid``): a
    function of the SM count alone, the two-level groups of its dw sum, and
    its ticket counters.

Inputs are made with numpy from a seed and handed to both packages."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

KMB = 64                   # keys of a dK/dV block, rows of a dQ block
LOG2E = 1.4426950408889634
FLASH_BWD_TOL = 3e-2       # tests/test_torch_gpu.py's, bf16


def _q_step(dh):
    """Query rows a step of the dK/dV kernel (kQN)."""
    return 64 if dh <= 64 else 32


def dkdv_walk(sq, sk, causal, window, q_offset, qn):
    """``(k0, q0, edge)`` of every tile ``flash_bwd_dkdv_mma_kernel``
    visits, in its order."""
    for k0 in range(0, sk, KMB):
        k_last = min(k0 + KMB, sk) - 1
        q_lo, q_hi = 0, sq
        if causal:
            q_lo = max(q_lo, k0 - q_offset)
        if window is not None:
            q_hi = min(q_hi, k_last + window - q_offset)
        q_lo = q_lo // qn * qn
        n = -(-(q_hi - q_lo) // qn) if q_hi > q_lo else 0
        for t in range(n):
            q0 = q_lo + t * qn
            edge = (k0 + KMB > sk or q0 + qn > sq
                    or (causal and k0 + KMB - 1 > q_offset + q0)
                    or (window is not None
                        and k0 <= q_offset + q0 + qn - 1 - window))
            yield k0, q0, edge


def dq_walk(sq, sk, causal, window, q_offset):
    """``(k0, q0, edge)`` of every tile ``flash_bwd_dq_mma_kernel``
    visits."""
    for qt in range(0, sq, KMB):
        q_first = q_offset + qt
        q_last = q_offset + min(qt + KMB, sq) - 1
        k_hi = min(sk, q_last + 1) if causal else sk
        k_lo = 0 if window is None else max(0, q_first - window + 1)
        k_lo = k_lo // KMB * KMB
        n = -(-(k_hi - k_lo) // KMB) if k_hi > k_lo else 0
        for t in range(n):
            k0 = k_lo + t * KMB
            edge = (k0 + KMB > sk or qt + KMB > sq
                    or (causal and k0 + KMB - 1 > q_first)
                    or (window is not None
                        and k0 <= q_first + KMB - 1 - window))
            yield k0, qt, edge


def _live(sq, sk, causal, window, q_offset):
    q_pos = np.arange(sq)[:, None] + q_offset
    k_pos = np.arange(sk)[None, :]
    live = np.ones((sq, sk), bool)
    if causal:
        live &= k_pos <= q_pos
    if window is not None:
        live &= k_pos > q_pos - window
    return live


WALK_CASES = [(sq, sk, causal, window, q_off)
              for sq, sk, q_off in ((512, 512, 0), (1, 300, 299), (1, 97, 96),
                                    (65, 200, 135), (200, 333, 0),
                                    (100, 164, 64), (70, 90, 20),
                                    (4, 16, 40), (300, 300, 0))
              for causal in (True, False)
              for window in (None, 0, 8, 33, 64, 100)]


@pytest.mark.parametrize("dh", [64, 128])
def test_tile_walks_cover_every_live_pair_once(dh):
    """Both grids visit each live pair in exactly one tile, and a tile they
    leave unmasked is whole (no row past Sq, no key past Sk) and fully
    live, so a row with no live key (lse = -inf) is always masked."""
    for sq, sk, causal, window, q_off in WALK_CASES:
        live = _live(sq, sk, causal, window, q_off)
        for walk, qn in ((dkdv_walk(sq, sk, causal, window, q_off,
                                    _q_step(dh)), _q_step(dh)),
                         (dq_walk(sq, sk, causal, window, q_off), KMB)):
            seen = np.zeros((sq, sk), int)
            for k0, q0, edge in walk:
                seen[q0:q0 + qn, k0:k0 + KMB] += 1
                if not edge:
                    assert q0 + qn <= sq and k0 + KMB <= sk
                    assert live[q0:q0 + qn, k0:k0 + KMB].all(), \
                        (sq, sk, causal, window, q_off, k0, q0)
            assert (seen <= 1).all()
            assert (seen[live] == 1).all(), (sq, sk, causal, window, q_off)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    """x = hi + lo, both bf16 (lo = bf16(x - hi)), as the kernel's A
    operands."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def emulate_flash_bwd(q, k, v, o, do, *, causal, window, q_offset,
                      split=True):
    """The bf16 backward's arithmetic in f32 on the CPU: ``(dq, dk, dv)``
    rounded to bf16, from bf16 ``q, k, v``, the forward's bf16 output ``o``
    and the bf16 output gradient ``do``."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    live = torch.as_tensor(_live(sq, sk, causal, window, q_offset))
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    kx = kf.repeat_interleave(group, 1)
    vx = vf.repeat_interleave(group, 1)
    s = qf @ kx.transpose(-1, -2)
    lse = torch.logsumexp((s * scale).masked_fill(~live, float("-inf")), -1)
    delta = (gf * of).sum(-1)
    p = torch.exp2(s * scale_log2 - (lse * LOG2E)[..., None])
    p = torch.where(live, p, torch.zeros(()))
    ds = p * (gf @ vx.transpose(-1, -2) - delta[..., None])
    parts = _split(p) if split else (_bf16(p),)
    dparts = _split(ds) if split else (_bf16(ds),)
    dv_h = sum(x.transpose(-1, -2) @ gf for x in parts)
    dk_h = sum(x.transpose(-1, -2) @ qf for x in dparts)
    dq = sum(x @ kx for x in dparts) * scale
    dk = torch.zeros(b, hkv, sk, dh)
    dv = torch.zeros(b, hkv, sk, dh)
    for hh in range(group):        # the partials in head order
        dk += dk_h.view(b, hkv, group, sk, dh)[:, :, hh]
        dv += dv_h.view(b, hkv, group, sk, dh)[:, :, hh]
    return _bf16(dq), _bf16(dk * scale), _bf16(dv)


# (b, hq, hkv, sq, sk, dh, causal, window, q_offset): GQA groups 1/2/7,
# Dh 32/64/128, sq != sk and off the tiles, windows, q_offset, rows with
# no key (window 0; window 8 past the keys)
EMU_CASES = [
    (1, 4, 2, 96, 96, 64, True, None, 0),
    (1, 7, 1, 130, 130, 64, True, None, 0),
    (1, 14, 2, 100, 164, 32, True, None, 64),
    (1, 4, 2, 200, 200, 128, True, 48, 0),
    (2, 4, 1, 1, 97, 64, True, None, 96),
    (1, 6, 2, 65, 200, 128, True, None, 135),
    (1, 2, 2, 64, 64, 128, False, None, 0),
    (1, 4, 2, 70, 70, 64, True, 0, 0),
    (1, 2, 1, 4, 16, 64, True, 8, 40),
]


def _emu_inputs(case):
    b, hq, hkv, sq, sk, dh = case[:6]
    rng = np.random.default_rng(sq * 1000 + sk + dh)
    arrays = [rng.normal(0, 1, s).astype(np.float32)
              for s in ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh),
                        (b, hq, sq, dh))]
    # bf16 values, handed to both packages in f32
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _reference_grads(q, k, v, do, causal, window, q_offset):
    """``jax.vjp`` of the reference's ``chunked_attention`` in f32 on the
    same (bf16-valued) inputs."""
    args = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b_, c: chunked_attention(
        a, b_, c, causal=causal, window=window, q_offset=q_offset), *args)
    return [torch.from_numpy(np.asarray(g))
            for g in vjp(jnp.asarray(do.float().numpy()))]


@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_bwd_matches_reference_vjp(case):
    """The design's arithmetic (split P and dS) against the reference's
    autodiff gradient within the kernel's tolerance, and no further from
    it than a bf16 P and dS alone; rows with no key give dq = 0."""
    causal, window, q_off = case[6:]
    q, k, v, do = _emu_inputs(case)
    kw = dict(causal=causal, window=window, q_offset=q_off)
    o = fa.flash_attention_plain(q, k, v, **kw)
    want = _reference_grads(q, k, v, do, **kw)
    got = emulate_flash_bwd(q, k, v, o, do, **kw)
    plain = emulate_flash_bwd(q, k, v, o, do, **kw, split=False)
    for name, g, p, w in zip("qkv", got, plain, want):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, atol=FLASH_BWD_TOL,
                                   rtol=FLASH_BWD_TOL,
                                   msg=lambda m: f"d{name}: {m}")
        err = float((g - w).abs().max())
        assert err <= float((p - w).abs().max()) + 2.0 ** -8, name
    dead = ~torch.as_tensor(_live(case[3], case[4], causal, window,
                                  q_off)).any(1)
    assert not got[0][:, :, dead].abs().any()


@pytest.mark.parametrize("q_shape,k_shape,dtype,want", [
    ((8, 14, 512, 64), (8, 2, 512, 64), torch.bfloat16, 8 * 14 * 512 * 64),
    ((8, 14, 512, 64), (8, 2, 512, 64), torch.float32, 0),
    ((2, 4, 100, 128), (2, 4, 300, 128), torch.bfloat16, 0),
    ((1, 7, 1, 32), (1, 1, 97, 32), torch.bfloat16, 7 * 97 * 32),
])
def test_bwd_part_elems(q_shape, k_shape, dtype, want):
    """The GQA partials: (B, Hq, Sk, Dh) f32 each for dK and dV where a KV
    head serves more than one query head in bf16, none otherwise (f32
    keeps its one-block-per-KV-head design)."""
    assert fa.bwd_part_elems(q_shape, k_shape, dtype) == want


@pytest.mark.parametrize("q_shape,k_shape,dtype,want", [
    ((8, 14, 512, 64), (8, 2, 512, 64), torch.bfloat16, 8 * 2 * 8),
    ((1, 7, 1, 32), (1, 1, 97, 32), torch.bfloat16, 2),
    ((8, 14, 512, 64), (8, 2, 512, 64), torch.float32, 0),
    ((2, 4, 100, 128), (2, 4, 300, 128), torch.bfloat16, 0),
])
def test_flash_bwd_counter_elems(q_shape, k_shape, dtype, want):
    """One GQA ticket per (B, KV head, key tile of 64) where partials are
    summed, none otherwise."""
    assert fa.bwd_counter_elems(q_shape, k_shape, dtype) == want


def test_ticket_counters_cached_and_grown():
    """The tickets: one zeroed int32 buffer per kernel and device, kept
    while it is large enough, replaced by a larger zeroed one when a call
    needs more."""
    dev = torch.device("cpu")
    build._TICKETS.pop(("flash_attention_bwd", dev), None)
    first = build.ticket_counters("flash_attention_bwd", dev, 128)
    assert first.dtype == torch.int32 and first.numel() == 128
    assert not first.any()
    assert build.ticket_counters("flash_attention_bwd", "cpu", 100) is first
    grown = build.ticket_counters("flash_attention_bwd", dev, 300)
    assert grown.numel() == 300 and not grown.any()
    assert build.ticket_counters("flash_attention_bwd", dev, 256) is grown
    build._TICKETS.pop(("flash_attention_bwd", dev))


@pytest.mark.parametrize("sms,want", [(132, (264, 17, 16)), (1, (2, 2, 1)),
                                      (114, (228, 16, 15)),
                                      (8, (16, 4, 4))])
def test_rmsnorm_bwd_grid(sms, want):
    """Blocks from the SM count alone, in groups of ceil(sqrt(blocks)) so
    that no block of the dw sum reads more than ~2 sqrt(blocks) rows; every
    block in one group; the counters hold a ticket per group and one."""
    grid = rn._bwd_grid(sms)
    assert tuple(grid) == want
    assert grid.group == math.ceil(math.sqrt(grid.blocks))
    assert (grid.groups - 1) * grid.group < grid.blocks \
        <= grid.groups * grid.group


def test_ticket_counters_apart_per_kernel():
    """Each kernel has its own buffer on a device (the RMSNorm backward's
    a ticket per group of blocks and one, at least), made once: each
    launch leaves it at 0, so no memset precedes a call."""
    dev = torch.device("cpu")
    for key in (("rmsnorm_bwd", dev), ("flash_attention_bwd", dev)):
        build._TICKETS.pop(key, None)
    n = rn._bwd_grid(132).groups + 1
    first = build.ticket_counters("rmsnorm_bwd", dev, n)
    assert first.dtype == torch.int32 and first.shape == (n,)
    assert not first.any()
    assert build.ticket_counters("rmsnorm_bwd", dev, n) is first
    other = build.ticket_counters("flash_attention_bwd", dev, n)
    assert other is not first and other.data_ptr() != first.data_ptr()
    for key in (("rmsnorm_bwd", dev), ("flash_attention_bwd", dev)):
        build._TICKETS.pop(key)


def test_bwd_kernels_refuse_cpu_tensors():
    """The backward wrappers launch kernels only: a CPU tensor raises (the
    CPU trains through the plain versions under autograd)."""
    x = torch.randn(2, 4, 8, 64)
    lse = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention_bwd(x, x, x, x, lse, x)
    with pytest.raises(ValueError, match="CUDA kernel"):
        rn.rmsnorm_bwd(x, x, torch.ones(64))

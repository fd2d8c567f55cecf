"""The port's roofline (``repro_torch.roofline``) and the kernels' work
formulas (``repro_torch.kernels.work``), on the CPU.

- ``CollectiveCounter`` on known collectives in a world of 2 gloo ranks
  (functional and ``c10d``: all-gather, all-reduce, reduce-scatter,
  all-to-all, send and receive): each kind's output bytes, and input bytes,
  exact (the twin of ``tests/test_system.py::test_collective_parser``);
- ``RooflineReport``'s terms, ``dominant``, ``useful_flops_ratio`` and
  ``row()`` equal to the reference's ``RooflineReport`` given the same
  constants; ``HW`` holds the H100's;
- ``active_params`` of all ten archs at full width equal to the
  reference's (its function, run on ``jax.eval_shape`` of the reference's
  init);
- each kernel wrapper (flash attention's serving and training forwards and
  its backward, RMSNorm and the fused add + RMSNorm forward and backward,
  the segment mean forward and backward) counts the same FLOPs and bytes on
  CPU tensors (the plain versions) and on meta tensors, equal to
  ``kernels/work.py``'s formulas, and leaves the aten ops inside out;
- the O(S) live-pair count equal to the dense mask's;
- a reduced qwen2-0.5b train step counting the same FLOPs and bytes on the
  CPU and on meta; the counter's memory on a known sequence of ops.
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

import _torch_roofline_ranks as rr
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import segment_agg as sa
from repro_torch.kernels import work
from repro_torch.launch.dryrun import active_params
from repro_torch.models import Transformer
from repro_torch.roofline import (HW, RooflineReport, StepCounter,
                                  analyze_step, model_flops)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_partition_world
    return spawn_partition_world(
        rr.collective_rank, 2, (), backend="gloo", device="cpu",
        workdir=str(tmp_path_factory.mktemp("coll")), timeout_s=60,
        join_timeout_s=300)


# (counted name, kind, input bytes, output bytes): a 128 B block over 2
# ranks; a reduce-scatter writes half of it, an all-gather twice it
COLLECTIVE_CASES = [
    ("funcol all_gather", "all-gather", 128, 256),
    ("funcol all_reduce", "all-reduce", 128, 128),
    ("funcol reduce_scatter", "reduce-scatter", 128, 64),
    ("funcol all_to_all", "all-to-all", 128, 128),
    ("c10d all_gather", "all-gather", 128, 256),
    ("c10d all_reduce", "all-reduce", 128, 128),
    ("c10d reduce_scatter", "reduce-scatter", 128, 64),
    ("c10d all_to_all", "all-to-all", 128, 128),
    ("c10d send/recv", "collective-permute", 128, 128),
]


@pytest.mark.parametrize("name,kind,ins,outs", COLLECTIVE_CASES)
def test_collective_counter_exact_bytes(collectives, name, kind, ins, outs):
    for rank_out in collectives:
        in_b, out_b, calls = rank_out[name]
        assert out_b == {kind: outs}, (name, out_b)
        assert in_b == {kind: ins}, (name, in_b)
        assert calls == {kind: 2 if kind == "collective-permute" else 1}


# --------------------------------------------------------------------------
# the roofline report
# --------------------------------------------------------------------------

def test_hw_holds_the_cards_constants():
    hw = HW()
    assert (hw.peak_flops, hw.peak_flops_f32, hw.hbm_bw, hw.link_bw,
            hw.memory_bytes) == (989.4e12, 66.9e12, 3.35e12, 450e9, 80e9)


REPORT_CASES = [
    # flops, bytes, collectives by kind, model flops, chips, peak memory
    (3e14, 1e9, {"all-gather": 10 ** 8}, 2e15, 8, 3e10),     # compute
    (1e10, 5e11, {"all-reduce": 10 ** 6}, 1e12, 1, 1e9),     # memory
    (1e9, 1e6, {"all-gather": 10 ** 9, "reduce-scatter": 4 * 10 ** 8},
     1e10, 256, 5e8),                                        # collective
    (0.0, 0.0, {}, 0.0, 4, 0.0),                             # nothing
]


@pytest.mark.parametrize("case", REPORT_CASES)
def test_roofline_report_matches_reference(case):
    """The port's report and the reference's on the same numbers and the
    same constants (the reference's ``ici_bw`` is the port's ``link_bw``):
    every term, the dominant one, the useful ratio and every ``row()``
    key."""
    from repro.roofline import HW as JHW
    from repro.roofline import RooflineReport as JReport

    flops, nbytes, coll, mflops, chips, peak = case
    hw = HW()
    jhw = JHW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, ici_bw=hw.link_bw)
    got = RooflineReport("step", chips, flops, nbytes, dict(coll), mflops,
                         peak, hw)
    want = JReport("step", chips, flops, nbytes, dict(coll), mflops, peak,
                   jhw)
    for term in ("compute_s", "memory_s", "collective_s", "dominant",
                 "useful_flops_ratio"):
        assert getattr(got, term) == getattr(want, term), term
    assert got.row() == want.row()


def test_analyze_step_and_model_flops():
    """``analyze_step`` reads a counter's FLOPs, bytes and peak, the
    collectives' output bytes, and 6·N·D of the tokens."""
    from repro_torch.roofline import CollectiveCounter

    with StepCounter() as sc:
        a = torch.ones(64, 32)
        torch.mm(a, torch.ones(32, 16))
    cc = CollectiveCounter()
    cc.out_bytes, cc.in_bytes = {"all-reduce": 100}, {"all-reduce": 100}
    rep = analyze_step("s", sc, chips=2, n_active_params=10.0, tokens=3.0,
                       collectives=cc)
    assert rep.hlo_flops == 2 * 64 * 32 * 16 == sc.flops
    assert rep.coll_bytes == {"all-reduce": 100}
    assert rep.model_flops_total == model_flops(10.0, 3.0) == 180.0
    assert rep.peak_memory_per_chip == sc.peak_bytes > 0


# --------------------------------------------------------------------------
# active_params
# --------------------------------------------------------------------------

def _reference_active_params():
    """``repro/launch/dryrun.py::active_params``, taken from its source
    (importing that module forces 512 host devices on this process)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "active_params")
    ns = {"jax": jax, "np": np}
    exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), ns)
    return ns["active_params"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_match_reference(arch):
    from repro.configs import get_config as j_get_config

    want = _reference_active_params()(j_get_config(arch))
    assert active_params(get_config(arch)) == want


# --------------------------------------------------------------------------
# the kernels' work
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,causal,window,q_offset,prefix", [
    (1, 1, True, None, 0, 0), (17, 17, True, None, 0, 0),
    (33, 50, False, None, 0, 0), (40, 40, True, 7, 0, 0),
    (5, 90, True, 30, 85, 0), (1, 64, True, 16, 100, 0),
    (48, 48, True, None, 0, 12), (48, 60, True, 8, 4, 20),
    (20, 10, True, 3, 0, 40), (9, 32, False, 4, 0, 3)])
def test_live_counts_match_the_mask(sq, sk, causal, window, q_offset,
                                    prefix):
    live = work.flash_live_mask(sq, sk, causal, window, q_offset, prefix)
    assert work.flash_live_counts(sq, sk, causal, window, q_offset,
                                  prefix) == (int(live.sum()),
                                              int(live.any(axis=0).sum()))


def _count(fn, *tensors):
    """Kernels counted over ``fn`` (forward and, for tensors that need a
    gradient, backward), and the aten ops the counter saw."""
    with StepCounter() as sc:
        out = fn(*tensors)
        outs = out if isinstance(out, tuple) else (out,)
        leaves = [t for t in tensors if t.requires_grad]
        if leaves:
            # each output its own gradient: a detach moves no data, so the
            # counter sees the wrappers alone
            torch.autograd.grad(outs, leaves, [o.detach() for o in outs])
    return sc


def _leaves(device, shapes, grad, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for s in shapes:
        t = torch.randn(s, generator=gen, dtype=torch.float32).to(dtype)
        out.append(t.to(device).requires_grad_(grad))
    return out


FLASH_CASES = [((2, 4, 24, 32), (2, 2, 24, 32), dict(causal=True)),
               ((1, 6, 20, 64), (1, 3, 20, 64),
                dict(causal=True, window=8)),
               ((2, 2, 1, 32), (2, 1, 40, 32),
                dict(causal=True, q_offset=39)),
               ((1, 2, 16, 32), (1, 2, 24, 32), dict(causal=False))]


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_work_same_on_cpu_and_meta(case, train):
    q_shape, k_shape, mask = case
    got = {}
    for dev in ("cpu", "meta"):
        q, k, v = _leaves(dev, (q_shape, k_shape, k_shape), train)
        got[dev] = _count(lambda q, k, v: fa.flash_attention(q, k, v, **mask),
                          q, k, v)
    fwd = work.flash_fwd_work(q_shape, k_shape, 4, lse=train, **mask)
    want = {("flash_attention_train" if train else "flash_attention"):
            [1, *fwd]}
    if train:
        want["flash_attention_bwd"] = [1, *work.flash_bwd_work(
            q_shape, k_shape, 4, **mask)]
    for dev, sc in got.items():
        assert sc.kernels == want, dev
        assert (sc.flops, sc.bytes) == (sum(v[1] for v in want.values()),
                                        sum(v[2] for v in want.values())), dev


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rmsnorm_work_same_on_cpu_and_meta(fused, train, dtype):
    shape, d = (3, 5, 64), 64
    elem = torch.finfo(dtype).bits // 8
    got = {}
    for dev in ("cpu", "meta"):
        x, delta = _leaves(dev, (shape, shape), train, dtype)
        w = _leaves(dev, ((d,),), train, dtype, seed=1)[0]
        if fused:
            got[dev] = _count(lambda x, dl, w: rn.add_rmsnorm(x, dl, w), x,
                              delta, w)
        else:
            got[dev] = _count(lambda x, w: rn.rmsnorm(x, w), x, w)
    name = "add_rmsnorm" if fused else "rmsnorm"
    want = {name: [1, *work.rmsnorm_work(15 * d, d, elem, fused=fused)]}
    if train:
        want[name + "_bwd"] = [1, *work.rmsnorm_bwd_work(15 * d, d, elem,
                                                         fused=fused)]
    for dev, sc in got.items():
        assert sc.kernels == want, dev
        assert (sc.flops, sc.bytes) == (sum(v[1] for v in want.values()),
                                        sum(v[2] for v in want.values())), dev


@pytest.mark.parametrize("stacked", [False, True], ids=["one", "stacked"])
def test_segment_work_same_on_cpu_and_meta(stacked):
    """The forward and the backward (the transpose) of ``segment_mean_op``
    over host-built blocks: the formulas read the blocks' masks, so a meta
    x takes blocks on the CPU."""
    rng = np.random.default_rng(0)
    n, d = 300, 16
    src = rng.integers(0, n, 2000)
    dst = rng.integers(0, n, 2000)
    host = sa.build_vjp_blocks(src, dst, n, n)
    blocks = sa.blocks_to_device(host, "cpu")
    if stacked:
        blocks = {k: torch.stack([v, v]) for k, v in blocks.items()}
    shape = (2, n, d) if stacked else (n, d)
    got = {}
    for dev in ("cpu", "meta"):
        (x,) = _leaves(dev, (shape,), True)
        got[dev] = _count(lambda x: sa.segment_mean_op(x, blocks,
                                                       num_rows=n), x)
    want = {"segment_mean_fwd": [1, *work.segment_fwd_work(shape, 4, blocks,
                                                           n)],
            "segment_mean_bwd": [1, *work.segment_bwd_work(shape, 4, blocks,
                                                           n)]}
    real = int((host["mask"] > 0).sum()) * (2 if stacked else 1)
    assert want["segment_mean_fwd"][1] == 2.0 * real * d
    for dev, sc in got.items():
        assert sc.kernels == want, dev


def test_counting_leaves_the_plain_ops_out():
    """Inside a wrapper the counter counts the formula alone: no aten op of
    the plain attention (its score products) reaches ``by_op``."""
    q, k, v = _leaves("cpu", ((1, 2, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)),
                      False)
    with StepCounter() as sc:
        fa.flash_attention(q, k, v)
    assert sc.by_op == {} and set(sc.kernels) == {"flash_attention"}
    # and without a counter nothing is routed or computed differently
    assert not work.counting()
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_plain(q, k, v), rtol=0,
                               atol=0)


def test_counted_plain_gradients_are_the_plain_ones():
    """Under a counter the CPU wrappers' gradients (recomputed in the
    counted backward) are bitwise the uncounted ones."""
    q, k, v = _leaves("cpu", ((1, 4, 12, 32), (1, 2, 12, 32),
                              (1, 2, 12, 32)), True)
    x = _leaves("cpu", ((6, 64),), True)[0]
    w = _leaves("cpu", ((64,),), True, seed=2)[0]

    def grads():
        o = fa.flash_attention(q, k, v, window=5).sum() + \
            rn.rmsnorm(x, w).square().sum()
        return torch.autograd.grad(o, [q, k, v, x, w])

    plain = grads()
    with StepCounter():
        counted = grads()
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# a step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_reduced_train_step_counts_same_on_cpu_and_meta(remat):
    """A reduced qwen2-0.5b loss and backward: FLOPs, bytes and every
    kernel's count equal on the CPU (plain versions) and on meta (the batch
    already on each device)."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              remat=remat)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    got = {}
    for dev in ("cpu", "meta"):
        model = Transformer(cfg, seed=0, device=dev)
        t = torch.as_tensor(tok, device=dev)
        with StepCounter() as sc:
            loss = model.train_loss({"tokens": t, "labels": t})
            torch.autograd.grad(loss, list(model.parameters()))
        got[dev] = sc
    a, b = got["cpu"], got["meta"]
    assert a.flops == b.flops > 0
    assert a.bytes == b.bytes > 0
    assert a.kernels == b.kernels
    n = cfg.num_layers
    assert a.kernels["flash_attention_train"][0] == n * (2 if remat else 1)
    assert a.kernels["flash_attention_bwd"][0] == n


def test_step_counter_memory():
    """Arguments (storages that existed before), the peak of what the block
    made, what it made that is alive at its end, the rest as temporaries;
    a view makes nothing."""
    x = torch.ones(1000)                          # 4,000 B argument
    with StepCounter() as sc:
        y = x * 2                                 # made, 4,000
        z = y + 1                                 # made, 8,000 live
        v = z.view(10, 100)                       # a view: nothing new
        del y                                     # 4,000 live
        w = z.sum()                               # 4 B
        keep = (v, w)
    assert sc.argument_bytes == 4000
    assert sc.peak_bytes == 4000 + 8000
    assert sc.output_bytes == 4004 and sc.temp_bytes == 8000 - 4004
    assert keep[0].shape == (10, 100)


def test_meta_flash_training_refuses_what_the_card_refuses():
    """A meta q that needs a gradient takes what the card's backward takes
    since ROADMAP item 15.10: at Dh 256 with a prefix the gradients' shapes
    come back, and the counter holds the training forward and the
    backward by ``kernels/work.py``'s formulas with the prefix; serving
    gives the output's shape."""
    q_shape, k_shape = (1, 8, 40, 256), (1, 1, 40, 256)
    mask = dict(causal=True, prefix_len=16)
    q, k, v = _leaves("meta", (q_shape, k_shape, k_shape), True)
    sc = _count(lambda q, k, v: fa.flash_attention(q, k, v, **mask), q, k, v)
    assert sc.kernels == {
        "flash_attention_train": [1, *work.flash_fwd_work(
            q_shape, k_shape, 4, lse=True, **mask)],
        "flash_attention_bwd": [1, *work.flash_bwd_work(q_shape, k_shape, 4,
                                                        **mask)]}
    assert work.flash_bwd_work(q_shape, k_shape, 4, **mask) != \
        work.flash_bwd_work(q_shape, k_shape, 4, causal=True)
    out = fa.flash_attention(q, k, v, **mask)
    grads = torch.autograd.grad(out, [q, k, v], torch.empty_like(out))
    assert [tuple(g.shape) for g in grads] == [q_shape, k_shape, k_shape]
    out = fa.flash_attention(q.detach(), k.detach(), v.detach())
    assert out.device.type == "meta"

"""The split row gathers of the Hopper segment-mean kernels, on the CPU (a
CUDA kernel has no CPU mode): the host work plan and the kernels'
arithmetic, emulated.

(a) ``block_row_work``: every real slot of every row lies in exactly one
    item, in slot order, items hold at most K slots, a row of several items
    has its partial rows consecutive and in item order, and the runs of
    empty rows cover exactly the rows with no slot.
(b) The kernels' arithmetic in NumPy: per-item sums in slot order (a split
    row's into partial rows), the partials added in item order, one
    division by deg; for the backward the un-placing pre-pass ``gsub``
    (g from row_base, divided by deg once per row, 0 where the forward cut
    the row off) and then the same split gather with no division over the
    transpose blocks.  Held against the plain versions within chip_smoke.py's
    f32 tolerances (``TOL``, ``TOL_BWD``), bitwise on f64 dyadic inputs, and
    the backward against ``jax.vjp`` of the reference's Pallas op in
    interpret mode.  Output rows start as NaN where the kernel's buffer
    starts unwritten, so a row the plan misses shows.
(c) The builders and the stacked engine builder emit the plan (and no
    ``row_ptr``: it stays on the host), ``blocks_to_device`` keeps it int32,
    and a plan built for another row space than the blocks it is launched
    with is refused.

Inputs are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_agg import build_vjp_blocks as j_build_vjp_blocks
from repro.kernels.segment_agg import segment_mean_op as j_segment_mean_op
from repro_torch.core import partition_graph
from repro_torch.engine.stacking import build_stacked_vjp_blocks
from repro_torch.graph import BENCHMARKS, build_partitioned_graph, make_benchmark
from repro_torch.kernels import segment_agg as sa

K = sa.ROW_WORK_K
TOL = 1e-5        # chip_smoke.py's TOL["float32"] (forward)
TOL_BWD = 1e-4    # chip_smoke.py's TOL_BWD["float32"]
# f32 sums in another order than the Pallas kernel's one-hot matmul
# (tests/test_torch_segment_bwd.py's)
JAX_ATOL, JAX_RTOL = 5e-6, 1e-5
HUBS = [K, K + 1, 3 * K + 5]


def _edges(rows, n_src, max_deg, seed, hubs=()):
    """``rows`` destination rows of 0..max_deg in-edges, then one row per
    entry of ``hubs`` with that many."""
    rng = np.random.default_rng(seed)
    deg = np.r_[rng.integers(0, max_deg + 1, rows), hubs].astype(np.int64)
    return (rng.integers(0, n_src, int(deg.sum())),
            np.repeat(np.arange(deg.size), deg))


def _stack(per):
    """Pad per-partition build_vjp_blocks dicts to common shapes; the plans
    rebuilt over the padded arrays (as chip_smoke.py does)."""
    P, out = len(per), {}
    for k in ("src", "dst", "mask", "deg", "t_src", "t_dst", "t_mask"):
        shape = np.max([b[k].shape for b in per], axis=0)
        arr = np.full((P, *shape), 1 if k == "deg" else 0, per[0][k].dtype)
        for p, b in enumerate(per):
            arr[(p, *map(slice, b[k].shape))] = b[k]
        out[k] = arr
    for pre in ("", "t_"):
        out.update(sa.block_row_work(_ptr(out, pre), prefix=pre))
    return out


def _ptr(blocks, prefix):
    return sa.block_row_ptr(blocks[prefix + "dst"], blocks[prefix + "mask"])


# (name, blocks dict, num_rows, row_base, n_in): the ragged sweep, the
# row_base sub-ranges, an empty edge set, an all-pad block, hub rows of
# K, K+1 and 3K+5 edges (and their transpose: hub SOURCE rows), and the
# stacked P=3 per-partition row_base blocks with a hub in one partition
def _cases():
    cases = []
    for n, max_deg in ((64, 4), (200, 9), (300, 6)):
        src, dst = _edges(n, n, max_deg, seed=n)
        cases.append((f"sweep-{n}", sa.build_vjp_blocks(src, dst, n, n), n,
                      0, n))
    src, dst = _edges(159, 300, 5, seed=1)
    cases.append(("row-base-mixed", sa.build_vjp_blocks(src, dst, 159, 300),
                  300, 141, 300))
    src, dst = _edges(200, 260, 6, seed=2)
    cases.append(("rows-cut-off", sa.build_vjp_blocks(src, dst, 200, 260),
                  200, 37, 260))
    src, dst = _edges(0, 300, 5, seed=3)
    cases.append(("all-pad-block", sa.build_vjp_blocks(src, dst, 0, 300),
                  300, 300, 300))
    e = np.zeros(0, np.int64)
    cases.append(("empty-edge-set", sa.build_vjp_blocks(e, e, 50, 50), 50,
                  0, 50))
    src, dst = _edges(120, 500, 6, seed=4, hubs=HUBS)
    # the same edges reversed give hub source rows for the backward
    cases.append(("hub-rows", sa.build_vjp_blocks(src, dst, 123, 500), 123,
                  0, 500))
    cases.append(("hub-sources", sa.build_vjp_blocks(dst, src, 500, 123),
                  500, 0, 123))
    bases = np.array([0, 37, 129])
    per = []
    for p in range(3):
        src, dst = _edges(259 - bases[p], 260, 6, seed=10 + p,
                          hubs=[3 * K + 5] if p == 1 else [2])
        per.append(sa.build_vjp_blocks(src, dst, 260 - bases[p], 260))
    cases.append(("stacked-per-partition-row-base", _stack(per), 260, bases,
                  260))
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]


def _place(row, nb, bn, bases):
    pb = row // bn
    p = pb // nb
    return p, bases[p] + (pb % nb) * bn + row % bn


def _check_plan(ptr, plan, k):
    bn = ptr.shape[-1] - 1
    part, work, split, space = (plan[key] for key in sa.PLAN_KEYS)
    assert space.dtype == np.int32 and space.shape == ptr.shape[:-1] + (bn, 0)
    ptr = ptr.reshape(-1, bn + 1).astype(np.int64)
    beg, end = ptr[:, :-1].reshape(-1), ptr[:, 1:].reshape(-1)
    for a, cols in ((part, 3), (work, 4), (split, 3)):
        assert a.dtype == np.int32 and a.ndim == 2 and a.shape[1] == cols
    items = work[work[:, 2] > work[:, 1]]
    zero = work[work[:, 2] == work[:, 1]]
    assert (items[:, 3] == 1).all() and (zero[:, 1:3] == 0).all()
    assert ((zero[:, 3] >= 1) & (zero[:, 3] <= 32)).all()
    # every real slot once, each item inside its row, at most k slots
    seen = {}
    for row, b, e in np.r_[part, items[:, :3]]:
        assert beg[row] <= b < e <= end[row] and e - b <= k
        seen.setdefault(int(row), []).append((int(b), int(e)))
    for row, spans in seen.items():
        spans.sort()
        assert spans[0][0] == beg[row] and spans[-1][1] == end[row]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert sorted(seen) == list(np.flatnonzero(end > beg))
    # split rows: their partial rows consecutive, in slot (= item) order
    assert len(split) == len(set(split[:, 0]))
    q = 0
    for row, q0, q1 in split:
        assert q0 == q and q1 - q0 >= 2 and (part[q0:q1, 0] == row).all()
        assert (np.diff(part[q0:q1, 1]) > 0).all()
        q = q1
    assert q == len(part)
    assert set(items[:, 0]).isdisjoint(split[:, 0])
    # the runs of empty rows cover exactly the rows with no slot
    runs = [np.arange(r, r + m) for r, _, _, m in zero]
    empty = np.concatenate(runs) if runs else np.zeros(0, np.int64)
    assert np.array_equal(np.sort(empty), np.flatnonzero(end == beg))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("prefix", ["", "t_"])
def test_plan_covers_every_slot_once(case, prefix):
    blocks = case[1]
    _check_plan(_ptr(blocks, prefix),
                {k: blocks[prefix + k] for k in sa.PLAN_KEYS}, K)


@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("case", CASES[-3:], ids=IDS[-3:])
def test_plan_other_item_sizes(case, k):
    ptr = _ptr(case[1], "")
    _check_plan(ptr, sa.block_row_work(ptr, k=k), k)


def test_plan_rows_of_k_k1_and_3k5():
    ptr = np.zeros((1, 4, 5), np.int32)
    ptr[0, 0, 1:] = np.cumsum([K, K + 1, 0, 3 * K + 5])
    plan = sa.block_row_work(ptr)
    work, part, split = plan["row_work"], plan["row_part"], plan["row_split"]
    assert work[0].tolist() == [0, 0, K, 1]            # K: one item
    assert split.tolist() == [[1, 0, 2], [3, 2, 6]]    # K+1: 2, 3K+5: 4
    assert (part[:, 2] - part[:, 1]).tolist() == [K, 1, K, K, K, 5]
    # the empty row 2, then the three empty blocks as one run of 12 rows
    assert work[1:].tolist() == [[2, 0, 0, 1], [4, 0, 0, 12]]


def _sum(x, idx, w, acc):
    """Edges added in slot order (ufunc.accumulate is sequential)."""
    terms = w.astype(acc)[:, None] * x[idx].astype(acc)
    return np.add.accumulate(terms, axis=0)[-1]


def _gather(x, src, mask, deg, plan, bases, num_rows, mean, out_dtype,
            covered):
    """The kernels' gather + merge: x (P, n_src, D), blocks (P, nb, be)."""
    P, nb, be = src.shape
    bn = deg.shape[-1]
    acc = np.float64 if x.dtype == np.float64 else np.float32
    src, mask = src.reshape(-1, be), mask.reshape(-1, be)
    deg = deg.reshape(-1).astype(acc)
    part, work, split = (plan[k] for k in sa.PLAN_KEYS[:3])
    d = x.shape[-1]
    out = np.full((P, num_rows, d), np.nan if covered else 0.0, acc)
    partials = np.full((len(part), d), np.nan, acc)

    def valid(row):
        p, orow = _place(row, nb, bn, bases)
        return p, orow, 0 <= orow < num_rows

    for i, (row, b, e) in enumerate(part):
        p, _, ok = valid(row)
        if ok:
            partials[i] = _sum(x[p], src[row // bn, b:e], mask[row // bn, b:e],
                               acc)
    for row, b, e, m in work:
        for r in range(row, row + m):
            p, orow, ok = valid(r)
            if not ok:
                continue
            if b == e:
                out[p, orow] = 0
            else:
                s = _sum(x[p], src[r // bn, b:e], mask[r // bn, b:e], acc)
                out[p, orow] = s / deg[r] if mean else s
    for row, q0, q1 in split:
        p, orow, ok = valid(row)
        if ok:
            s = np.add.accumulate(partials[q0:q1], axis=0)[-1]
            out[p, orow] = s / deg[row] if mean else s
    return out.astype(out_dtype)


def _stacked(blocks, x):
    if x.ndim == 3:
        return blocks, x
    return {k: (v if k in sa.PLAN_KEYS or k[2:] in sa.PLAN_KEYS else v[None])
            for k, v in blocks.items()}, x[None]


def _bases(row_base, P):
    return np.broadcast_to(np.asarray(row_base, np.int64).reshape(-1), (P,))


def emulate_fwd(x, blocks, num_rows, row_base, mean):
    bl, xs = _stacked(blocks, x)
    P, nb = bl["src"].shape[:2]
    bn = bl["deg"].shape[-1]
    bases = _bases(row_base, P)
    covered = bases.size == 1 or (bases == bases[0]).all()
    covered = covered and bases[0] <= 0 and bases[0] + nb * bn >= num_rows
    out = _gather(xs, bl["src"], bl["mask"], bl["deg"],
                  {k: bl[k] for k in sa.PLAN_KEYS}, bases, num_rows, mean,
                  x.dtype, covered)
    return out if x.ndim == 3 else out[0]


def emulate_bwd(g, blocks, n_in, row_base, mean):
    bl, gs = _stacked(blocks, g)
    P, num_rows, d = gs.shape
    nb, bn = bl["deg"].shape[-2:]
    nb_t = bl["t_src"].shape[1]
    acc = np.float64 if g.dtype == np.float64 else np.float32
    bases = _bases(row_base, P)
    # the pre-pass: un-place from row_base, divide by deg once per row
    gsub = np.zeros((P, nb * bn, d), acc)
    for p in range(P):
        orow = bases[p] + np.arange(nb * bn)
        keep = (orow >= 0) & (orow < num_rows)
        gsub[p, keep] = gs[p, orow[keep]].astype(acc)
        if mean:
            gsub[p] = gsub[p] / bl["deg"][p].reshape(-1, 1).astype(acc)
    out = _gather(gsub, bl["t_src"], bl["t_mask"],
                  np.ones((P, nb_t, bn), np.float32),
                  {k: bl["t_" + k] for k in sa.PLAN_KEYS}, np.zeros(P, int),
                  n_in, False, g.dtype, nb_t * bn >= n_in)
    return out if g.ndim == 3 else out[0]


def _inputs(case, d, dtype, seed):
    name, blocks, num_rows, row_base, n_in = case
    rng = np.random.default_rng(seed)
    shape = ((3,) if "stacked" in name else ()) + (n_in, d)
    gshape = shape[:-2] + (num_rows, d)
    if dtype == np.float64:          # dyadic: exact sums in any order
        return (rng.integers(-8, 9, shape).astype(dtype),
                rng.integers(-8, 9, gshape).astype(dtype))
    return (rng.normal(0, 1, shape).astype(dtype),
            rng.normal(0, 1, gshape).astype(dtype))


def _plain(blocks, row_base):
    bl = sa.blocks_to_device(blocks, "cpu")
    rb = torch.as_tensor(row_base) if isinstance(row_base, np.ndarray) \
        else row_base
    return bl, rb


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("d", [24, 130])
def test_emulated_forward_matches_plain_f32(case, mean, d):
    _, blocks, num_rows, row_base, _ = case
    x, _ = _inputs(case, d, np.float32, seed=d)
    bl, rb = _plain(blocks, row_base)
    want = sa.segment_mean_plain(torch.as_tensor(x), bl, num_rows=num_rows,
                                 row_base=rb, mean=mean).numpy()
    got = emulate_fwd(x, blocks, num_rows, row_base, mean)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("d", [24, 130])
def test_emulated_backward_matches_plain_f32(case, mean, d):
    _, blocks, _, row_base, n_in = case
    _, g = _inputs(case, d, np.float32, seed=d + 1)
    bl, rb = _plain(blocks, row_base)
    want = sa.segment_mean_bwd_plain(torch.as_tensor(g), bl, n_in=n_in,
                                     row_base=rb, mean=mean).numpy()
    got = emulate_bwd(g, blocks, n_in, row_base, mean)
    np.testing.assert_allclose(got, want, atol=TOL_BWD, rtol=TOL_BWD)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("mean", [True, False])
def test_emulated_f64_dyadic_bitwise(case, mean):
    """Integer inputs: every forward sum, and every backward sum without
    the division, is exact in any order, and the division is the same IEEE
    division, so the split kernels must match bit for bit."""
    _, blocks, num_rows, row_base, n_in = case
    x, g = _inputs(case, 16, np.float64, seed=5)
    bl, rb = _plain(blocks, row_base)
    want = sa.segment_mean_plain(torch.as_tensor(x), bl, num_rows=num_rows,
                                 row_base=rb, mean=mean).numpy()
    assert np.array_equal(emulate_fwd(x, blocks, num_rows, row_base, mean),
                          want)
    want = sa.segment_mean_bwd_plain(torch.as_tensor(g), bl, n_in=n_in,
                                     row_base=rb, mean=False).numpy()
    assert np.array_equal(emulate_bwd(g, blocks, n_in, row_base, False), want)


def _hub_source_edges(rows, n_src, seed):
    """Forward rows of in-degree 1, 2, 4 or 8 (so g / deg is dyadic) whose
    sources include rows of K, K+1 and 3K+5 out-edges."""
    rng = np.random.default_rng(seed)
    deg = rng.choice([1, 2, 4, 8], rows)
    dst = np.repeat(np.arange(rows), deg)
    src = rng.integers(3, n_src, dst.size)
    hub = np.repeat([0, 1, 2], HUBS)
    src[rng.permutation(dst.size)[:hub.size]] = hub
    return src, dst


@pytest.mark.parametrize("row_base,num_rows", [(0, 600), (37, 600),
                                               (-20, 590)])
def test_emulated_backward_f64_dyadic_hub_sources_bitwise(row_base, num_rows):
    """deg in {1, 2, 4, 8} and integer cotangents: g / deg and every sum
    are exact, so the pre-pass + split gather equals the plain backward bit
    for bit, hub source rows and rows cut off at num_rows included."""
    src, dst = _hub_source_edges(600, 150, seed=row_base + 50)
    blocks = sa.build_vjp_blocks(src, dst, 600, 150)
    assert len(blocks["t_row_split"]) == 2     # K+1 and 3K+5 are split
    g = np.random.default_rng(1).integers(-8, 9, (num_rows, 16)).astype(
        np.float64)
    want = sa.segment_mean_bwd_plain(torch.as_tensor(g),
                                     sa.blocks_to_device(blocks, "cpu"),
                                     n_in=150, row_base=row_base).numpy()
    got = emulate_bwd(g, blocks, 150, row_base, True)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", [c for c in CASES if "stacked" not in c[0]],
                         ids=[i for i in IDS if "stacked" not in i])
def test_emulated_backward_matches_jax_vjp(case):
    name, blocks, num_rows, row_base, n_in = case
    x, g = _inputs(case, 24, np.float32, seed=9)
    jb = {k: jnp.asarray(v) for k, v in blocks.items()
          if k in ("src", "dst", "mask", "deg", "t_src", "t_dst", "t_mask")}
    _, vjp = jax.vjp(lambda xx: j_segment_mean_op(
        xx, jb, num_rows=num_rows, row_base=row_base, interpret=True),
        jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = emulate_bwd(g, blocks, n_in, row_base, True)
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=JAX_RTOL)


def test_vjp_blocks_keep_the_reference_arrays():
    """The plan is added beside the reference's arrays, which stay bitwise
    the reference builder's."""
    src, dst = _edges(120, 500, 6, seed=4, hubs=HUBS)
    got = sa.build_vjp_blocks(src, dst, 123, 500)
    want = j_build_vjp_blocks(src, dst, 123, 500)
    for k, v in want.items():
        assert np.array_equal(got[k], np.asarray(v)), k
    for k in sa.PLAN_KEYS:
        assert k in got and "t_" + k in got
    mean_only = sa.build_mean_blocks(src, dst, 123)
    assert all(k in mean_only for k in sa.PLAN_KEYS)
    assert not any("t_" + k in mean_only for k in sa.PLAN_KEYS)


def test_stacked_engine_blocks_carry_the_plan():
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    blk = build_stacked_vjp_blocks(build_partitioned_graph(g, r.parts, 4))
    for pre in ("", "t_"):
        _check_plan(_ptr(blk, pre), {k: blk[pre + k] for k in sa.PLAN_KEYS}, K)
        assert pre + "row_ptr" not in blk
    dev = sa.blocks_to_device(blk, "cpu")
    for pre in ("", "t_"):
        for k in sa.PLAN_KEYS:
            assert dev[pre + k].dtype == torch.int32
            assert dev[pre + k].shape == blk[pre + k].shape
            assert np.array_equal(dev[pre + k].numpy(), blk[pre + k])


def test_cpu_op_takes_the_plain_version_without_a_plan():
    """The plan is the kernels' input only: a CPU tensor goes to the plain
    version, which needs none."""
    src, dst = _edges(64, 64, 4, seed=0)
    blocks = sa.build_vjp_blocks(src, dst, 64, 64)
    bare = sa.blocks_to_device(
        {k: v for k, v in blocks.items()
         if k not in sa.PLAN_KEYS and k[2:] not in sa.PLAN_KEYS}, "cpu")
    x = torch.randn(64, 8, requires_grad=True)
    out = sa.segment_mean_op(x, bare, num_rows=64)
    out.sum().backward()
    full = sa.blocks_to_device(blocks, "cpu")
    torch.testing.assert_close(out, sa.segment_mean_plain(x.detach(), full,
                                                          num_rows=64))


@pytest.mark.parametrize("prefix", ["", "t_"])
def test_launch_refuses_a_plan_of_another_row_space(prefix):
    """The launch checks the plan's row space against the blocks (P, nb,
    bn) before any kernel reads them: a plan kept from before the blocks
    were stacked or padded numbers other rows, and raises instead of
    reading past them.  The check is the wrappers' own (``_plan_args``),
    made here on CPU tensors since it reads only shapes."""
    per = [sa.build_vjp_blocks(*_edges(200 + 90 * p, 300, 6, seed=30 + p),
                               200 + 90 * p, 300) for p in range(3)]
    stacked = _stack(per)
    stale = {**stacked, **{prefix + k: per[0][prefix + k]
                           for k in sa.PLAN_KEYS}}
    side = prefix + "src"
    P, nb = stacked[side].shape[:2]
    cpu = torch.device("cpu")
    args, n_part = sa._plan_args(sa.blocks_to_device(stacked, cpu), prefix,
                                 cpu, (P, nb, sa.BN))
    assert n_part == len(stacked[prefix + "row_part"]) and len(args) == 6
    with pytest.raises(ValueError, match="rebuild the plan"):
        sa._plan_args(sa.blocks_to_device(stale, cpu), prefix, cpu,
                      (P, nb, sa.BN))
    # one partition's own blocks: its plan fits their (nb, bn) only
    one = sa.blocks_to_device(per[2], cpu)
    nb2 = per[2][side].shape[0]
    sa._plan_args(one, prefix, cpu, (nb2, sa.BN))
    with pytest.raises(ValueError, match="rebuild the plan"):
        sa._plan_args(one, prefix, cpu, (nb2 - 1, sa.BN))

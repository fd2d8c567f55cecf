"""The port's on-device epoch sampler (``repro_torch.core.sampler.
cbs_device``) against the NumPy Eq. 3 and the reference's device sampler.

Its draws come from a ``torch.Generator``, whose streams are not jax's, so
they are held to the distributions, with the reference's own statistical
tests and thresholds (``tests/test_cbs_device.py`` §1–3 and §5): Eq. 3 in
float64 against the NumPy ``cbs_probabilities`` to 1e-12 (the check the
reference's own x64 test cannot make on this jax) and against the
reference's float32 device probabilities; chi-squared of the weighted and
the uniform draw (60k draws, alpha 1e-3); the subset drawn without
replacement, the minority class oversampled, the fanout inside each CSR
span with isolated nodes self-looping, the mini-epoch capped at the
support, the epoch a valid permutation.  The staged sampler's sizes equal
the reference's on tiny.  Every seed is fixed."""
import zlib

import numpy as np
import pytest
import scipy.stats
import torch

from repro.core.sampler import build_device_epoch_sampler as j_build_sampler
from repro.core.sampler import cbs_probabilities_device as j_cbs_probs_device
from repro_torch.core import partition_graph
from repro_torch.core.sampler import (DeviceEpochSampler,
                                      build_device_epoch_sampler,
                                      cbs_probabilities,
                                      cbs_probabilities_device,
                                      device_fanout, gumbel_subset)
from repro_torch.graph import BENCHMARKS, make_benchmark

KINDS = ["powerlaw", "isolated", "single_hub"]
N_DRAWS = 60_000
ALPHA = 1e-3


def _graph(kind: str, seed: int, n: int = 300):
    """The reference tests' adversarial degree profiles with imbalanced
    labels (``tests/test_cbs_device.py::_graph``, same draws)."""
    rng = np.random.default_rng([seed, zlib.crc32(kind.encode())])
    if kind == "powerlaw":
        deg = np.minimum((1.0 / rng.power(2.0, n) - 1).astype(np.int64), 150)
        deg = np.maximum(deg, 0)
    elif kind == "isolated":
        deg = rng.integers(0, 6, n)
        deg[rng.random(n) < 0.5] = 0
    else:
        deg = rng.integers(0, 4, n)
        deg[int(rng.integers(0, n))] = 2000
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int64)
    labels = rng.choice(5, n, p=[0.45, 0.25, 0.15, 0.10, 0.05])
    train_idx = np.sort(rng.choice(n, int(0.7 * n), replace=False))
    return indptr, indices, labels, train_idx


class _G:
    """A bare CSR graph with the fields build_device_epoch_sampler reads."""


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _logp(probs) -> torch.Tensor:
    with np.errstate(divide="ignore"):
        return torch.as_tensor(np.log(probs), dtype=torch.float32)


def _merged_chisquare(counts: np.ndarray, probs: np.ndarray):
    """Pearson chi-squared, small-expectation bins merged until each
    expects >= 5 (the reference tests' helper)."""
    exp = probs * counts.sum()
    obs_m, exp_m = [], []
    acc_o = acc_e = 0.0
    for i in np.argsort(exp):
        acc_o += counts[i]
        acc_e += exp[i]
        if acc_e >= 5.0:
            obs_m.append(acc_o)
            exp_m.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0:
        obs_m[-1] += acc_o
        exp_m[-1] += acc_e
    return scipy.stats.chisquare(np.asarray(obs_m), np.asarray(exp_m))


# ---------------------------------------------------------------- 1. Eq. 3

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probabilities_f64_match_numpy_1e12(kind, seed):
    indptr, indices, labels, train_idx = _graph(kind, seed)
    want = cbs_probabilities(indptr, indices, labels, train_idx)
    got = cbs_probabilities_device(indptr, indices, labels, train_idx,
                                   dtype=torch.float64, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-12
    assert abs(float(got.sum()) - 1.0) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_probabilities_f32_match_reference_device(kind):
    indptr, indices, labels, train_idx = _graph(kind, 0)
    want = np.asarray(j_cbs_probs_device(indptr, indices, labels, train_idx))
    got = cbs_probabilities_device(indptr, indices, labels, train_idx,
                                   device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_probabilities_zero_support_uniform():
    """All nodes isolated: no Eq. 3 mass anywhere, so the uniform fallback,
    as the NumPy reference."""
    n = 40
    indptr = np.zeros(n + 1, np.int64)
    args = (indptr, np.zeros(0, np.int64), np.zeros(n, np.int64),
            np.arange(n))
    got = cbs_probabilities_device(*args, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), cbs_probabilities(*args))
    np.testing.assert_allclose(got.numpy(), 1.0 / n)


# ------------------------------------------------- 2. chi-squared of Eq. 3

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_draw_follows_eq3(kind, seed):
    """The first slot of the Gumbel top-k ranking is a categorical(Eq. 3)
    sample: 60k independent rows drawn in one call."""
    indptr, indices, labels, train_idx = _graph(kind, seed)
    probs = cbs_probabilities(indptr, indices, labels, train_idx)
    logp = _logp(probs).expand(N_DRAWS, -1)
    first = gumbel_subset(_gen(seed * 7919 + 13), logp, 1)[:, 0].numpy()
    counts = np.bincount(first, minlength=len(train_idx)).astype(np.float64)
    assert counts[probs == 0].sum() == 0
    res = _merged_chisquare(counts, probs)
    assert res.pvalue > ALPHA, (kind, seed, res)


# ------------------------------------- 3. the subset, the fanout, the cap

@pytest.mark.parametrize("kind", KINDS)
def test_gumbel_subset_is_without_replacement(kind):
    indptr, indices, labels, train_idx = _graph(kind, 3)
    probs = cbs_probabilities(indptr, indices, labels, train_idx)
    k = min(50, int((probs > 0).sum()))
    gen = _gen(0)
    for _ in range(5):
        pick = gumbel_subset(gen, _logp(probs), k).numpy()
        assert len(np.unique(pick)) == k
        assert (probs[pick] > 0).all()


def test_gumbel_subset_oversamples_minority():
    """Inclusion rates under the subset draw track Eq. 3: the rarest
    class's mean inclusion beats the majority's."""
    indptr, indices, labels, train_idx = _graph("powerlaw", 4)
    probs = cbs_probabilities(indptr, indices, labels, train_idx)
    k, reps = len(train_idx) // 4, 400
    picks = gumbel_subset(_gen(42), _logp(probs).expand(reps, -1), k).numpy()
    incl = np.bincount(picks.reshape(-1), minlength=len(train_idx)) / reps
    tl = labels[train_idx]
    pop = np.bincount(tl, minlength=5)
    rare, major = int(np.argmin(pop)), int(np.argmax(pop))
    assert incl[tl == rare].mean() > incl[tl == major].mean()


def test_device_fanout_matches_host_semantics():
    """Every pick lies in its node's CSR span; isolated nodes self-loop
    (NeighborSampler's contract).  Stacked ``(P, B)`` nodes give ``(P, B,
    fanout)`` picks."""
    indptr, indices, labels, train_idx = _graph("isolated", 5)
    nodes = torch.as_tensor(train_idx[:64]).view(2, 32)
    nbrs = device_fanout(_gen(0), nodes, torch.as_tensor(indptr),
                         torch.as_tensor(indices), 7)
    assert nbrs.shape == (2, 32, 7)
    deg = np.diff(indptr)
    n_iso = 0
    for v, row in zip(nodes.reshape(-1).tolist(), nbrs.reshape(-1, 7).numpy()):
        if deg[v] == 0:
            n_iso += 1
            assert (row == v).all()
        else:
            assert set(row.tolist()) <= set(indices[indptr[v]: indptr[v + 1]])
    assert 0 < n_iso < 64


def test_device_fanout_covers_the_span_uniformly():
    """The modular pick reaches every neighbour of a node equally often:
    chi-squared over 60k picks from the hub's 2,000-slot span."""
    indptr, indices, _, _ = _graph("single_hub", 0)
    hub = int(np.argmax(np.diff(indptr)))
    d = int(indptr[hub + 1] - indptr[hub])
    picks = device_fanout(_gen(3), torch.full((N_DRAWS // 10,), hub),
                          torch.as_tensor(indptr), torch.arange(
                              len(indices)), 10).reshape(-1).numpy()
    counts = np.bincount(picks - indptr[hub], minlength=d).astype(np.float64)
    assert counts.sum() == N_DRAWS and len(counts) == d
    res = _merged_chisquare(counts, np.full(d, 1.0 / d))
    assert res.pvalue > ALPHA, res


def _bare_graph(n, deg, rng, d=8):
    g = _G()
    g.indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=g.indptr[1:])
    g.indices = rng.integers(0, 30, int(g.indptr[-1])).astype(np.int64)
    g.features = rng.normal(0, 1, (n, d)).astype(np.float32)
    return g


def test_epoch_sampler_caps_mini_epoch_at_support():
    """A partition whose mini-epoch exceeds its positive-probability
    support caps there: no zero-probability (isolated) node is ever a valid
    example, and the valid examples stay packed in the leading slots."""
    n = 120
    rng = np.random.default_rng(0)
    deg = np.zeros(n, np.int64)
    deg[:30] = rng.integers(1, 4, 30)
    g = _bare_graph(n, deg, rng)
    g.labels = rng.integers(0, 3, n)
    ds = build_device_epoch_sampler(g, [np.arange(n), np.arange(20)], 2,
                                    batch_size=64, subset_fraction=0.5,
                                    fanouts=(3, 3), device="cpu")
    nodes, valid = ds.draw_epoch(_gen(7))
    for p in range(2):
        probs = np.exp(ds.logp[p].double().numpy())
        k = int(ds.k[p])
        assert k <= int((probs > 0).sum())
        picked = nodes[p][valid[p]].numpy()
        assert len(picked) == k
        assert all(probs[v] > 0 for v in picked)   # slot == id here
        flat = valid[p].reshape(-1).numpy()
        assert flat[:k].all() and not flat[k:].any()


# --------------------------------------------- 5. the phase-0 epoch draw

def _phase0_sampler(class_balanced: bool, n: int = 160, seed: int = 6):
    indptr, indices, labels, train_idx = _graph("powerlaw", seed, n)
    g = _G()
    g.indptr, g.indices, g.labels = indptr, indices, labels
    g.features = np.random.default_rng(seed).normal(
        0, 1, (n, 8)).astype(np.float32)
    half = len(train_idx) // 2
    host_train = [train_idx[:half], train_idx[half:]]
    ds = build_device_epoch_sampler(
        g, host_train, 2, batch_size=32,
        subset_fraction=0.25 if class_balanced else 1.0,
        class_balanced=class_balanced, fanouts=(3, 3), device="cpu")
    return ds, host_train


def test_phase0_uniform_draw_is_uniform_chisquared():
    """The uniform phase-0 path end to end through ``draw_epoch``: the first
    batch slot is uniform over the partition's train set (60k rows, one
    call)."""
    ds, host_train = _phase0_sampler(class_balanced=False)
    p, t = 0, len(host_train[0])
    rows = lambda a: a[p:p + 1].expand(N_DRAWS, *a.shape[1:])
    nodes, _ = ds.draw_epoch(_gen(991), rows(ds.logp), rows(ds.train_idx),
                             rows(ds.k))
    first = nodes[:, 0, 0].numpy()
    assert set(first.tolist()) <= set(host_train[p].tolist())
    slot = {v: i for i, v in enumerate(host_train[p].tolist())}
    counts = np.bincount([slot[v] for v in first.tolist()],
                         minlength=t).astype(np.float64)
    res = _merged_chisquare(counts, np.full(t, 1.0 / t))
    assert res.pvalue > ALPHA, res


def test_phase0_cbs_draw_follows_eq3_chisquared():
    """The CBS phase-0 path: the first slot of the Gumbel ranking over the
    sampler's staged log-Eq. 3 row follows those probabilities."""
    ds, _ = _phase0_sampler(class_balanced=True)
    logp = ds.logp[1]
    probs = np.exp(logp.double().numpy())
    probs /= probs.sum()
    first = gumbel_subset(_gen(41), logp.expand(N_DRAWS, -1), 1)[:, 0].numpy()
    counts = np.bincount(first, minlength=len(probs)).astype(np.float64)
    assert counts[probs == 0].sum() == 0
    res = _merged_chisquare(counts, probs)
    assert res.pvalue > ALPHA, res


@pytest.mark.parametrize("class_balanced", [True, False])
def test_phase0_epoch_is_valid_permutation(class_balanced):
    """Within one epoch each valid index is visited at most once (exactly k
    distinct nodes of the partition), the uniform epoch covers the whole
    train set, and a fresh seed reshuffles."""
    ds, host_train = _phase0_sampler(class_balanced=class_balanced)
    orders = []
    for epoch in (0, 1, 2):
        nodes, valid = ds.draw_epoch(_gen(17 + epoch))
        for p in range(2):
            picked = nodes[p][valid[p]].numpy()
            assert len(picked) == int(ds.k[p])
            assert len(np.unique(picked)) == len(picked)
            assert set(picked.tolist()) <= set(host_train[p].tolist())
            if not class_balanced:
                assert sorted(picked.tolist()) == sorted(host_train[p].tolist())
        orders.append(tuple(nodes[0][valid[0]].tolist()))
    assert len(set(orders)) > 1


def test_make_batch_is_the_host_batch_layout():
    """``make_batch`` on stacked ``(P, B)`` nodes: the host path's keys,
    shapes and dtypes, features gathered at the drawn ids, labels -1 and
    mask 0 outside the valid slots."""
    ds, _ = _phase0_sampler(class_balanced=True)
    gen = _gen(5)
    nodes, valid = ds.draw_epoch(gen)
    b = ds.make_batch(gen, nodes[:, 0], valid[:, 0])
    P, B, D = 2, ds.batch_size, ds.features.shape[1]
    f1, f2 = ds.fanouts
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        "x_t": (P, B, D), "x_1": (P, B, f1, D), "x_2": (P, B, f1, f2, D),
        "labels": (P, B), "mask": (P, B)}
    assert b["labels"].dtype == torch.int32
    assert b["mask"].dtype == ds.features.dtype
    n0, v0 = nodes[:, 0], valid[:, 0]
    assert torch.equal(b["x_t"], ds.features[n0])
    assert torch.equal(b["mask"], v0.float())
    assert torch.equal(b["labels"], torch.where(v0, ds.labels[n0], -1))
    assert (b["labels"][~v0] == -1).all() and v0.any()


# -------------------------------- the staged sampler against the reference

@pytest.fixture(scope="module")
def tiny_train():
    g = make_benchmark(BENCHMARKS["tiny"])
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                            method="ew", seed=0).parts
    return g, [g.train_idx[parts[g.train_idx] == p] for p in range(4)]


@pytest.mark.parametrize("class_balanced", [True, False])
def test_build_matches_reference(tiny_train, class_balanced):
    g, host_train = tiny_train
    kw = dict(batch_size=16, subset_fraction=0.25 if class_balanced else 1.0,
              class_balanced=class_balanced, fanouts=(5, 5))
    got = build_device_epoch_sampler(g, host_train, 4, device="cpu", **kw)
    want = j_build_sampler(g, host_train, 4, **kw)
    assert isinstance(got, DeviceEpochSampler)
    np.testing.assert_array_equal(got.train_idx.numpy(),
                                  np.asarray(want.train_idx))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    assert (got.subset_size, got.num_batches) == (want.subset_size,
                                                  want.num_batches)
    np.testing.assert_array_equal(got.natural_iters, want.natural_iters)
    np.testing.assert_allclose(got.logp.numpy(), np.asarray(want.logp),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(want.features))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.nbytes == sum(t.numel() * t.element_size() for t in (
        got.indptr, got.indices, got.features, got.labels, got.train_idx,
        got.logp, got.k))


def test_build_feat_store_raises(tiny_train):
    """The feature-store sampler (ROADMAP item 11, ported) stages what the
    reference's does: its hot rows, ``remap`` and host cold rows are the
    reference's, ``nbytes`` counts the hot rows and ``remap`` instead of
    the table, and its batches are bitwise the resident sampler's; a
    ``make_batch`` without the cold rows is the reference's refusal."""
    g, host_train = tiny_train
    kw = dict(batch_size=16, fanouts=(5, 5), hot_frac=0.25, hot_policy="freq")
    got = build_device_epoch_sampler(g, host_train, 4, feat_store=True,
                                     device="cpu", **kw)
    want = j_build_sampler(g, host_train, 4, feat_store=True, **kw)
    assert got.features is None and want.features is None
    np.testing.assert_array_equal(got.hot_feats.numpy(),
                                  np.asarray(want.hot_feats))
    np.testing.assert_array_equal(got.remap.numpy(), np.asarray(want.remap))
    np.testing.assert_array_equal(got.cold_host.numpy(), want.cold_host)
    assert got.nbytes == sum(t.numel() * t.element_size() for t in (
        got.indptr, got.indices, got.hot_feats, got.remap, got.labels,
        got.train_idx, got.logp, got.k))
    res = build_device_epoch_sampler(g, host_train, 4, device="cpu", **kw)
    nodes, valid = res.draw_epoch(_gen(3))
    a = res.make_batch(_gen(4), nodes[:, 0], valid[:, 0])
    b = got.make_batch(_gen(4), nodes[:, 0], valid[:, 0], got.cold_host)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="feat-store mismatch"):
        got.make_batch(_gen(4), nodes[:, 0], valid[:, 0])


def test_same_seed_draws_bitwise(tiny_train):
    """Two epochs drawn from generators with one seed are bitwise equal,
    nodes, masks and every batch tensor; another seed differs."""
    g, host_train = tiny_train
    ds = build_device_epoch_sampler(g, host_train, 4, batch_size=16,
                                    fanouts=(5, 5), device="cpu")

    def epoch(seed):
        gen = _gen(seed)
        nodes, valid = ds.draw_epoch(gen)
        out = [nodes, valid]
        for i in range(ds.num_batches):
            out += list(ds.make_batch(gen, nodes[:, i], valid[:, i]).values())
        return out

    a, b, c = epoch(11), epoch(11), epoch(12)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])

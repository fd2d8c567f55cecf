"""Synthetic graph benchmarks engineered to exhibit the paper's pathologies.

The paper's datasets (Reddit, OGBN-Products, OGBN-Papers100M, Flickr, Yelp)
are not downloadable offline, so we generate degree-corrected stochastic
block-model graphs with:

  · Zipf class imbalance (Fig. 1b — OGBN-Products' long tail),
  · homophily (same-label nodes connect preferentially — what makes EW work),
  · feature–label correlation (class prototypes + noise — what Alg. 1 taps),
  · power-law degrees (hub structure of Reddit),
  · optional unlabelled majority (OGBN-Papers' ~98% unlabelled),
  · optional out-of-distribution test split (OGBN-Products' 8/2/90 split).

``BENCHMARKS`` maps small-scale stand-ins for each paper dataset; every
experiment records which stand-in it ran on.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .csr import CSRGraph

__all__ = ["SyntheticSpec", "make_benchmark", "BENCHMARKS"]


@dataclass(frozen=True)
class SyntheticSpec:
    name: str
    num_nodes: int
    avg_degree: float
    num_classes: int
    feature_dim: int
    class_zipf: float = 1.2        # Zipf exponent of class sizes (0 = uniform)
    homophily: float = 0.8         # P(edge endpoint same class)
    feature_noise: float = 0.5     # noise std around the class prototype
    degree_alpha: float = 0.8      # power-law-ish degree propensity exponent
    train_frac: float = 0.5
    val_frac: float = 0.2
    labelled_frac: float = 1.0     # OGBN-Papers ≈ 0.02
    ood_test: bool = False         # skew test split toward tail classes
    seed: int = 0


def _class_sizes(spec: SyntheticSpec, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, spec.num_classes + 1, dtype=np.float64)
    p = ranks ** (-spec.class_zipf)
    return p / p.sum()


def make_benchmark(spec: SyntheticSpec) -> CSRGraph:
    rng = np.random.default_rng([spec.seed, 0x5EED])
    n, k = spec.num_nodes, spec.num_classes

    class_p = _class_sizes(spec, rng)
    labels = rng.choice(k, size=n, p=class_p).astype(np.int64)

    # class prototypes on a scaled simplex + noise -> feature-label correlation
    protos = rng.normal(0.0, 1.0, size=(k, spec.feature_dim))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    feats = protos[labels] + rng.normal(0.0, spec.feature_noise, (n, spec.feature_dim))
    feats = feats.astype(np.float32)

    # degree-corrected SBM edges: hub propensity ~ power law
    prop = (1.0 / (np.arange(n) + 1.0)) ** spec.degree_alpha
    rng.shuffle(prop)
    num_edges = int(n * spec.avg_degree)

    # class-bucketed node lists with propensity weights for homophilous picks
    by_class = [np.flatnonzero(labels == c) for c in range(k)]
    w_by_class = [prop[idx] / prop[idx].sum() for idx in by_class]
    w_all = prop / prop.sum()

    src = rng.choice(n, size=num_edges, p=w_all)
    homo = rng.random(num_edges) < spec.homophily
    dst = np.empty(num_edges, dtype=np.int64)
    # homophilous endpoints: same class as src; others: global propensity draw
    for c in range(k):
        m = homo & (labels[src] == c)
        cnt = int(m.sum())
        if cnt and len(by_class[c]):
            dst[m] = rng.choice(by_class[c], size=cnt, p=w_by_class[c])
        elif cnt:
            dst[m] = rng.choice(n, size=cnt, p=w_all)
    nh = ~homo
    dst[nh] = rng.choice(n, size=int(nh.sum()), p=w_all)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    # symmetrize + dedupe, build CSR of in-neighbours
    import scipy.sparse as sp

    a = sp.csr_matrix(
        (np.ones(2 * len(src)), (np.concatenate([src, dst]), np.concatenate([dst, src]))),
        shape=(n, n),
    )
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()

    # splits
    perm = rng.permutation(n)
    labelled = perm[: int(n * spec.labelled_frac)]
    final_labels = np.full(n, -1, dtype=np.int64)
    final_labels[labelled] = labels[labelled]

    if spec.ood_test:
        # OGBN-Products-style OOD: train on the HEAD (popular classes),
        # test skews toward the tail — descending class popularity with
        # noise so the split is shifted, not disjoint
        head_score = class_p[labels[labelled]]
        noise = rng.random(len(labelled)) * float(class_p.max())
        order = labelled[np.argsort(-(head_score + noise))]
    else:
        order = labelled
    n_lab = len(labelled)
    n_tr = int(n_lab * spec.train_frac)
    n_va = int(n_lab * spec.val_frac)
    train_idx = order[:n_tr]
    val_idx = order[n_tr : n_tr + n_va]
    test_idx = order[n_tr + n_va :]

    return CSRGraph(
        indptr=a.indptr.astype(np.int64),
        indices=a.indices.astype(np.int64),
        features=feats,
        labels=final_labels,
        train_idx=np.sort(train_idx),
        val_idx=np.sort(val_idx),
        test_idx=np.sort(test_idx),
        num_classes=k,
        name=spec.name,
    )


# Small-scale stand-ins for the paper's five benchmarks (Table I), scaled to
# CPU-feasible sizes while keeping each dataset's signature pathology.
BENCHMARKS: dict[str, SyntheticSpec] = {
    # Flickr: 7 classes, noisy labels -> high feature noise, low homophily
    "flickr-s": SyntheticSpec(
        name="flickr-s", num_nodes=6_000, avg_degree=10, num_classes=7,
        feature_dim=64, class_zipf=0.8, homophily=0.55, feature_noise=1.0, seed=1,
    ),
    # Yelp: many classes (100 -> 32 here), moderate degree
    "yelp-s": SyntheticSpec(
        name="yelp-s", num_nodes=12_000, avg_degree=20, num_classes=32,
        feature_dim=64, class_zipf=1.0, homophily=0.7, feature_noise=0.7, seed=2,
    ),
    # Reddit: very high degree, strong homophily, 41 classes
    "reddit-s": SyntheticSpec(
        name="reddit-s", num_nodes=10_000, avg_degree=60, num_classes=16,
        feature_dim=96, class_zipf=1.1, homophily=0.85, feature_noise=0.4,
        train_frac=0.66, val_frac=0.10, seed=3,
    ),
    # OGBN-Products: heavy class imbalance + OOD test split (8/2/90)
    "products-s": SyntheticSpec(
        name="products-s", num_nodes=20_000, avg_degree=25, num_classes=24,
        feature_dim=64, class_zipf=1.6, homophily=0.8, feature_noise=0.5,
        train_frac=0.08, val_frac=0.02, ood_test=True, seed=4,
    ),
    # OGBN-Papers: mostly unlabelled
    "papers-s": SyntheticSpec(
        name="papers-s", num_nodes=30_000, avg_degree=15, num_classes=32,
        feature_dim=64, class_zipf=1.4, homophily=0.75, feature_noise=0.6,
        labelled_frac=0.10, train_frac=0.78, val_frac=0.08, seed=5,
    ),
    # tiny graph for unit tests
    "tiny": SyntheticSpec(
        name="tiny", num_nodes=600, avg_degree=8, num_classes=5,
        feature_dim=16, class_zipf=1.2, homophily=0.8, feature_noise=0.4, seed=6,
    ),
    # medium single benchmark for scaling tables
    "products-m": SyntheticSpec(
        name="products-m", num_nodes=60_000, avg_degree=25, num_classes=24,
        feature_dim=64, class_zipf=1.6, homophily=0.8, feature_noise=0.5,
        train_frac=0.12, val_frac=0.03, ood_test=True, seed=7,
    ),
    # wide-feature benchmark for the two-tier feature store: the stacked
    # (P, maxN, D) feature plane is the dominant array, so a feat_budget_mb
    # between the streamed feat-store peak and the all-resident footprint
    # demonstrates a graph that only trains with --feat-store (DESIGN.md §12)
    "featstore-xl": SyntheticSpec(
        name="featstore-xl", num_nodes=16_000, avg_degree=10, num_classes=16,
        feature_dim=96, class_zipf=1.2, homophily=0.75, feature_noise=0.5,
        train_frac=0.20, val_frac=0.05, seed=8,
    ),
}

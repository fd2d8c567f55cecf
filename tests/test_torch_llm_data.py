"""The LLM path's data modules (``repro_torch.data``) against the
reference's ``repro.data``: the synthetic domain corpus, the kNN document
graph, the entropy-aware corpus sharding and the sharded CBS batcher, all
host NumPy, must be bitwise the reference's for the same spec and seeds."""
import numpy as np
import pytest

from repro.data import (CorpusSpec as JCorpusSpec, DomainCorpus as JCorpus,
                        ShardedBatcher as JBatcher,
                        shard_corpus_by_entropy as j_shard)
from repro.data.partition import knn_graph as j_knn_graph
from repro_torch.data import (CorpusSpec, DomainCorpus, ShardedBatcher,
                              shard_corpus_by_entropy)
from repro_torch.data.partition import knn_graph

SPECS = [dict(num_docs=96, doc_len=12, vocab_size=64, seed=3),
         dict(num_docs=160, doc_len=8, vocab_size=40, num_domains=5,
              domain_zipf=1.5, feature_dim=16, seed=0)]


@pytest.fixture(scope="module", params=range(len(SPECS)))
def corpora(request):
    kw = SPECS[request.param]
    return JCorpus(JCorpusSpec(**kw)), DomainCorpus(CorpusSpec(**kw))


def test_corpus_bitwise(corpora):
    ref, port = corpora
    for name in ("tokens", "domains", "features", "domain_p"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ref.domain_entropy() == port.domain_entropy()
    idx = np.arange(0, ref.num_docs, 3)
    assert ref.domain_entropy(idx) == port.domain_entropy(idx)


@pytest.mark.parametrize("k", [5, 10])
def test_knn_graph_bitwise(corpora, k):
    ref, port = corpora
    a, b = j_knn_graph(ref.features, k=k), knn_graph(port.features, k=k)
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("method", ["ew", "metis", "random"])
@pytest.mark.parametrize("num_shards", [2, 4])
def test_sharding_and_batches_bitwise(corpora, method, num_shards):
    """The shard assignment and entropies, then three ``next_batch`` draws
    of the CBS batcher (and of the uniform one), bitwise."""
    ref, port = corpora
    js = j_shard(ref, num_shards, method=method, seed=1)
    ps = shard_corpus_by_entropy(port, num_shards, method=method, seed=1)
    assert np.array_equal(js.assignment, ps.assignment)
    assert js.assignment.dtype == ps.assignment.dtype
    assert np.array_equal(js.shard_entropies, ps.shard_entropies)
    assert (js.num_shards, js.method) == (ps.num_shards, ps.method)
    for p in range(num_shards):
        assert np.array_equal(js.docs_of(p), ps.docs_of(p))
    for cbs in (True, False):
        jb = JBatcher(ref, js, batch_per_shard=6, class_balanced=cbs, seed=2)
        pb = ShardedBatcher(port, ps, batch_per_shard=6, class_balanced=cbs,
                            seed=2)
        for _ in range(3):
            a, b = jb.next_batch(), pb.next_batch()
            assert set(a) == set(b) == {"tokens", "labels", "domains"}
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                assert np.array_equal(a[key], b[key]), (key, cbs)

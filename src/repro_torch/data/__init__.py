# The LLM path's data: the synthetic domain corpus, its entropy-aware
# sharding and the sharded CBS batcher (host NumPy, the reference's code).
from .corpus import DomainCorpus, CorpusSpec
from .partition import shard_corpus_by_entropy, CorpusShards
from .pipeline import ShardedBatcher

__all__ = ["DomainCorpus", "CorpusSpec", "shard_corpus_by_entropy",
           "CorpusShards", "ShardedBatcher"]

"""The paper's technique as a first-class LLM-framework feature, on the
PyTorch port (the twin of ``examples/llm_entropy_sharding.py``).

    PYTHONPATH=src python examples/llm_entropy_sharding_torch.py \
        [--arch qwen2-0.5b] [--shards 4] [--steps 40] [--device cpu]

Shards a domain-labelled corpus across data-parallel workers with the same
EW objective used for graphs (kNN doc-similarity graph + Algorithm-1
weights) and, for comparison, at random; trains a reduced zoo architecture
through both GP phases (``make_generalize_step`` on the shards' summed
batch, then ``make_personalize_partition_step`` on each shard's replica),
and shows the per-shard domain specialisation that personalization buys:
each personalized replica against the global model on ITS OWN shard's
held-out documents.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse
import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gp.trainer import (  # noqa: E402
    GPHyperParams, make_generalize_step, make_personalize_partition_step)
from repro_torch.data import (CorpusSpec, DomainCorpus,  # noqa: E402
                              ShardedBatcher, shard_corpus_by_entropy)
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.train.optim import AdamW  # noqa: E402


def _labels(tokens: np.ndarray) -> np.ndarray:
    return np.concatenate([tokens[:, 1:], np.full((len(tokens), 1), -1)],
                          axis=1)


@torch.no_grad()
def eval_loss(model, corpus, docs) -> float:
    toks = corpus.tokens[docs]
    return float(model.train_loss({"tokens": toks, "labels": _labels(toks)}))


def _loss(model, batch):
    return model.train_loss(batch)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced(d_model=128)
    model = Transformer(cfg, seed=0, device=args.device)
    corpus = DomainCorpus(CorpusSpec(num_docs=480, doc_len=48,
                                     vocab_size=cfg.vocab_size,
                                     num_domains=8, seed=0))
    for method in ("random", "ew"):
        sh = shard_corpus_by_entropy(corpus, args.shards, method=method)
        print(f"{method:7s} shard domain entropies: "
              f"{sh.shard_entropies.round(3).tolist()}")
    shards = shard_corpus_by_entropy(corpus, args.shards, method="ew")
    batcher = ShardedBatcher(corpus, shards, batch_per_shard=8)

    # phase-0: synchronous generalization on the mean of the shards' losses
    opt = AdamW(lr=3e-3, grad_clip=1.0)
    opt_state = opt.init(model.parameters())
    step = make_generalize_step(
        lambda m, nb: torch.stack([_loss(m, {"tokens": nb["tokens"][p],
                                             "labels": nb["labels"][p]})
                                   for p in range(args.shards)]), opt)
    for _ in range(args.steps):
        model, opt_state, _ = step(model, opt_state, batcher.next_batch())

    # phase-1: per-shard personalization toward the frozen global model
    pstep = make_personalize_partition_step(_loss, opt,
                                            GPHyperParams(lambda_prox=0.01))
    replicas = [copy.deepcopy(model) for _ in range(args.shards)]
    states = [opt.init(r.parameters()) for r in replicas]
    for _ in range(args.steps):
        nb = batcher.next_batch()
        for p, rep in enumerate(replicas):
            _, states[p], _ = pstep(rep, states[p],
                                    {"tokens": nb["tokens"][p],
                                     "labels": nb["labels"][p]}, model, True)

    # personalization wins on the shard's own held-out distribution
    rng = np.random.default_rng(1)
    print("\nshard  global-loss  personal-loss  (own held-out docs)")
    for p in range(args.shards):
        docs = shards.docs_of(p)
        held = rng.choice(docs, size=min(16, len(docs)), replace=False)
        lg = eval_loss(model, corpus, held)
        lp = eval_loss(replicas[p], corpus, held)
        print(f"  {p}      {lg:7.4f}      {lp:7.4f}   "
              f"{'personalized wins' if lp < lg else ''}")


if __name__ == "__main__":
    main()

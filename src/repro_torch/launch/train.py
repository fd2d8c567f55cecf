"""Training entry point (CLI) on the CUDA card (counterpart of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train gnn \\
        --dataset products-s --parts 4 --method ew --epochs 30 [--device cpu]

``gnn`` runs the paper's pipeline (EW partitioning → CBS sampling → GP
two-phase training) through ``repro_torch.pipeline.run_eat_distgnn`` on the
stacked engine: every full-graph forward goes through the CUDA
segment-mean kernel and, with ``--full-graph-train``, every backward
through its backward kernel; ``--async-generalize`` and
``--async-personalize`` draw the epochs on the card; ``--overlap-halo``
runs the interior/boundary split forward, whose two halves are two
row-range launches of the kernel (``--ring-chunks`` schedules the
partition mesh's exchange; stacked, the exchange is the transpose);
``--engine
sequential`` runs the Python-loop oracle with the plain aggregation;
``--halo-cache`` (with ``--halo-refresh-every`` and ``--halo-cv``) and
``--halo-compress`` change the eval forwards' exchange, ``--grad-compress``
(with ``--grad-topk-frac`` and ``--grad-bucket-kb``) phase 0's gradient
reduction; ``--feat-store`` (with ``--hot-frac``, ``--hot-policy``,
``--feat-groups`` and ``--feat-budget-mb``) keeps only the hot feature
rows on the card and stages the cold rows from pinned host memory;
``--checkpoint-dir`` (with ``--checkpoint-every`` and
``--keep-checkpoints``) saves the run at epoch boundaries and ``--resume``
continues from the newest intact step; ``--crash-at-epoch`` and
``--drop-refresh-at`` inject the reference's faults (an injected crash
ends the CLI with exit code 1).  ``--engine spmd`` runs the partition
mesh: P ranks, one partition each, spawned through
``repro_torch.launch.mesh`` (the counterpart of the reference's forced XLA
device count), or joined from the environment when ``torchrun`` set
``RANK`` and ``WORLD_SIZE``; ``--backend`` picks ``nccl`` (a card per
rank, the default on CUDA) or ``gloo`` (the CPU, or every rank on one
card); ``--engine auto`` spawns the mesh only with a card per partition; the
async phases, the feature store, checkpoint/resume and the communication
options (``--halo-cache``, ``--halo-compress``, ``--overlap-halo``,
``--grad-compress``) run on it as stacked (an injected crash in the world
ends the CLI as it does stacked).
It takes the reference's flags for the
ported options, plus ``--device`` (``cuda`` by default; raises without a
card unless ``cpu``).  The reference's other flags belong to paths that
are not ported yet.

    PYTHONPATH=src python -m repro_torch.launch.train llm \\
        --arch qwen2-0.5b --shards 4 --steps 60 [--full] [--device cpu]

``llm`` trains a transformer of the zoo (``reduced(d_model=--d-model)``,
or ``--full`` for its published widths) on the entropy-sharded domain
corpus through both GP phases (:func:`run_llm`), with the reference's flags;
on the card every attention and RMSNorm call runs the hand-written kernels,
forward and backward.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def config_from_args(args):
    from repro_torch.pipeline import EATConfig

    return EATConfig(
        dataset=args.dataset,
        num_parts=args.parts,
        partition_method=args.method,
        use_cbs=not args.no_cbs,
        use_gp=not args.no_gp,
        max_epochs=args.epochs,
        hidden_dim=args.hidden,
        batch_size=args.batch_size,
        fanouts=(args.fanout, args.fanout),
        seed=args.seed,
        centralized=args.centralized,
        engine_mode=args.engine,
        overlap_halo=args.overlap_halo,
        ring_chunks=args.ring_chunks,
        halo_cache=args.halo_cache,
        halo_refresh_every=args.halo_refresh_every,
        halo_cv=args.halo_cv,
        halo_compress=args.halo_compress,
        grad_compress=args.grad_compress,
        grad_topk_frac=args.grad_topk_frac,
        grad_bucket_kb=args.grad_bucket_kb,
        feat_store=args.feat_store,
        hot_frac=args.hot_frac,
        hot_policy=args.hot_policy,
        feat_groups=args.feat_groups,
        feat_budget_mb=args.feat_budget_mb,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        keep_checkpoints=args.keep_checkpoints,
        resume=args.resume,
        use_kernel_agg=not args.no_kernel_agg,
        double_buffer=not args.no_double_buffer,
        phase0_fraction=args.phase0_frac,
        full_graph_train=args.full_graph_train,
        full_graph_iters=args.full_graph_iters,
        async_personalize=args.async_personalize,
        async_generalize=args.async_generalize,
        device=args.device,
    )


def fault_plan_from_args(args):
    """The ``FaultPlan`` of ``--crash-at-epoch`` and ``--drop-refresh-at``,
    or None when neither is given."""
    if not (args.crash_at_epoch or args.drop_refresh_at):
        return None
    from repro_torch.robustness import FaultPlan

    return FaultPlan(
        crash_epochs=frozenset(args.crash_at_epoch or ()),
        drop_refresh_epochs=frozenset(args.drop_refresh_at or ()))


def _run(args):
    from repro_torch.pipeline import run_eat_distgnn

    return run_eat_distgnn(config_from_args(args), verbose=True,
                           fault_plan=fault_plan_from_args(args))


def _mesh_launch(args) -> str | None:
    """How this run joins a partition mesh: ``"torchrun"`` (the environment
    defines the world), ``"spawn"`` (start P ranks here) or None (one
    process).  ``auto`` spawns only with a card per partition."""
    if args.engine not in ("spmd", "auto"):
        return None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return "torchrun"
    if args.engine == "spmd":
        return "spawn"
    import torch

    parts = 1 if args.centralized else args.parts
    if (parts > 1 and torch.device(args.device).type == "cuda"
            and torch.cuda.device_count() >= parts):
        return "spawn"
    return None


def _mesh_rank(rank: int, args):
    """One spawned rank of ``launch.train gnn``: the pipeline on its
    partition (only rank 0 prints), its result returned to the parent."""
    return _run(args)


def run_gnn(args):
    """Run the pipeline (on the partition mesh when ``--engine`` asks for
    it), print its summary as JSON and return the ``EATResult`` (rank 0's
    on the mesh; every rank returns the same)."""
    launch = _mesh_launch(args)
    if launch == "spawn":
        from repro_torch.launch.mesh import spawn_partition_world
        from repro_torch.robustness import InjectedCrash

        parts = 1 if args.centralized else args.parts
        # an injected crash fires on every rank at one boundary: the world
        # ends in it as one process would
        result = spawn_partition_world(_mesh_rank, parts, (args,),
                                       backend=args.backend,
                                       device=args.device,
                                       reraise=(InjectedCrash,))[0]
    elif launch == "torchrun":
        result = _run_torchrun(args)
    else:
        result = _run(args)
    if result is not None:
        print(json.dumps(result.summary(), indent=2))
    return result


def _run_torchrun(args):
    """This process as one rank of the world ``torchrun`` describes: join
    its group (``env://``), run the pipeline, leave; the summary is
    rank 0's to print (None elsewhere)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import default_backend

    backend = args.backend or default_backend(args.device)
    if torch.device(args.device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method="env://")
    try:
        result = _run(args)
        return result if dist.get_rank() == 0 else None
    finally:
        dist.destroy_process_group()


def _llm_model(cfg, seed, device):
    """The model a run starts from: random weights drawn from ``seed``."""
    from repro_torch.models import Transformer

    return Transformer(cfg, seed=seed, device=device)


def _launches() -> tuple[int, int, int, int]:
    """The kernels' launch counts so far: flash attention's training forward
    and backward, RMSNorm's forward (both entry points) and backward."""
    from repro_torch.kernels import (flash_launch_count,
                                     rmsnorm_bwd_launch_count,
                                     rmsnorm_launch_count)

    return (flash_launch_count("train"), flash_launch_count("backward"),
            rmsnorm_launch_count(), rmsnorm_bwd_launch_count())


def _shard(nb, p) -> dict:
    return {"tokens": nb["tokens"][p], "labels": nb["labels"][p]}


def llm_phase0_step(model, opt, opt_state, nb, shards):
    """One phase-0 step in the reference's order: a backward per shard, the
    gradients summed in shard order, divided by the shard count, then one
    AdamW update.  Returns ``(opt_state, per-shard losses)``."""
    import torch

    weights = list(model.parameters())
    losses, acc = [], None
    for p in range(shards):
        loss = model.train_loss(_shard(nb, p))
        grads = torch.autograd.grad(loss, weights)
        losses.append(loss.item())
        acc = list(grads) if acc is None else [a + g for a, g in
                                               zip(acc, grads)]
    updates, opt_state = opt.update([a / shards for a in acc], opt_state,
                                    weights)
    with torch.no_grad():
        for w, u in zip(weights, updates):
            w.add_(u)
    return opt_state, losses


def run_llm(args) -> dict:
    """The LLM path (the reference's ``run_llm``): the entropy-sharded
    domain corpus, phase 0 (the shards' gradients averaged, then AdamW),
    phase 1 (each shard's replica descends its own loss plus the prox pull
    toward the phase-0 model).  Prints and returns the reference's summary
    (``shard_entropies``, ``phase0_final_loss``, ``phase1_final_loss``,
    ``wall_s``) with the step times, tokens/s, peak device memory and the
    kernels' launches per step beside it; the returned dict also holds the
    run's objects (``cfg``, ``model``, ``replicas``, ``opt``, ``batcher``).

    Phase 1 keeps P replicas and runs the single-partition step on each in
    turn, where the reference vmaps it over a stacked partition axis: the
    same math.  ``--full`` takes the arch's published widths, with the
    corpus drawn over the ``reduced()`` vocabulary (512 ids, valid ids of
    the full vocabulary; the corpus's per-domain transition tables are
    (V, V)); the loss still runs over every logit."""
    import copy
    import time

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.gp.trainer import (GPHyperParams,
                                             make_personalize_partition_step)
    from repro_torch.data import (CorpusSpec, DomainCorpus, ShardedBatcher,
                                  shard_corpus_by_entropy)
    from repro_torch.device import resolve_device
    from repro_torch.train.optim import AdamW

    device = resolve_device(args.device)
    base = get_config(args.arch)
    cfg = base if args.full else base.reduced(d_model=args.d_model)
    vocab = base.reduced().vocab_size if args.full else cfg.vocab_size
    spec = CorpusSpec(num_docs=args.docs, doc_len=args.seq, vocab_size=vocab,
                      num_domains=8, seed=args.seed)
    corpus = DomainCorpus(spec)
    shards = shard_corpus_by_entropy(corpus, args.shards, method=args.method)
    print(f"corpus shard domain entropies ({args.method}): "
          f"{shards.shard_entropies.round(3).tolist()}")
    batcher = ShardedBatcher(corpus, shards, batch_per_shard=args.batch,
                             class_balanced=not args.no_cbs, seed=args.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    opt = AdamW(lr=3e-3, grad_clip=1.0)
    model = _llm_model(cfg, args.seed, device)
    opt_state = opt.init(model.parameters())
    steps_phase0 = int(args.steps * args.phase0_frac)
    hist, step_s, launches = [], {0: [], 1: []}, []
    t0 = time.time()
    for step in range(steps_phase0):
        nb = batcher.next_batch()
        sync()
        n0, ts = _launches(), time.perf_counter()
        opt_state, losses = llm_phase0_step(model, opt, opt_state, nb,
                                            args.shards)
        sync()
        step_s[0].append(time.perf_counter() - ts)
        launches.append([b - a for a, b in zip(n0, _launches())])
        hist.append(float(np.mean(losses)))
        if step % 10 == 0:
            print(f"[phase-0] step {step:4d} loss {hist[-1]:.4f}")

    # phase-1: personalization (per-shard replicas, no gradient traffic)
    global_model = model
    pstep = make_personalize_partition_step(
        lambda m, b: m.train_loss(b), opt,
        GPHyperParams(lambda_prox=args.lambda_prox))
    replicas, popt = [], []
    if args.steps > steps_phase0:
        replicas = [copy.deepcopy(model) for _ in range(args.shards)]
        popt = [opt.init(r.parameters()) for r in replicas]
    ploss_hist = []
    for step in range(args.steps - steps_phase0):
        nb = batcher.next_batch()
        sync()
        n0, ts = _launches(), time.perf_counter()
        losses = []
        for p in range(args.shards):
            _, popt[p], loss = pstep(replicas[p], popt[p], _shard(nb, p),
                                     global_model, True)
            losses.append(loss)
        losses = torch.stack(losses).cpu().numpy()
        step_s[1].append(time.perf_counter() - ts)
        launches.append([b - a for a, b in zip(n0, _launches())])
        ploss_hist.append(losses)
        if step % 10 == 0:
            print(f"[phase-1] step {step:4d} per-shard loss "
                  f"{np.asarray(losses).round(4).tolist()}")
    wall = time.time() - t0

    # a phase's step time: the median over its steps after the first,
    # which warms up (allocator, cuBLAS, kernel builds)
    ms = {p: float(np.median(ts[1:] if len(ts) > 1 else ts)) * 1e3
          for p, ts in step_s.items() if ts}
    tokens = args.shards * args.batch * args.seq
    out = {
        "arch": args.arch, "method": args.method,
        "shard_entropies": shards.shard_entropies.tolist(),
        "phase0_final_loss": hist[-1] if hist else None,
        "phase1_final_loss": (np.asarray(ploss_hist[-1]).tolist()
                              if ploss_hist else None),
        "wall_s": wall,
        "device": str(device),
        "phase0_step_ms": ms.get(0),
        "phase1_step_ms": ms.get(1),
        "tokens_per_step": tokens,
        "phase0_tokens_per_s": tokens / ms[0] * 1e3 if 0 in ms else None,
        "phase1_tokens_per_s": tokens / ms[1] * 1e3 if 1 in ms else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "launches_per_step": launches,
    }
    print(json.dumps(out, indent=2))
    return dict(out, cfg=cfg, model=model, replicas=replicas, opt=opt,
                opt_state=opt_state, batcher=batcher,
                step_s=step_s)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    g = sub.add_parser("gnn")
    g.add_argument("--dataset", default="products-s")
    g.add_argument("--parts", type=int, default=4)
    g.add_argument("--method", default="ew",
                   choices=("random", "metis", "ew", "ew_balanced"))
    g.add_argument("--no-cbs", action="store_true")
    g.add_argument("--no-gp", action="store_true")
    g.add_argument("--epochs", type=int, default=30)
    g.add_argument("--hidden", type=int, default=128)
    g.add_argument("--batch-size", type=int, default=256)
    g.add_argument("--fanout", type=int, default=10)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--engine", default="auto",
                   choices=("auto", "stacked", "spmd", "sequential"),
                   help="epoch executor: all partitions stacked on one "
                        "device, the partition mesh (spmd: one process per "
                        "partition, real collectives; auto picks it with a "
                        "card per partition or inside a torchrun world), "
                        "or the sequential Python-loop reference")
    g.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="torch.distributed backend of the partition mesh "
                        "(default: nccl on CUDA, gloo on the CPU; gloo on "
                        "CUDA puts every rank on one card)")
    g.add_argument("--overlap-halo", action="store_true",
                   help="boundary/interior split forward: overlap each "
                        "layer's halo exchange with interior aggregation "
                        "and restrict dense compute to owned rows")
    g.add_argument("--ring-chunks", type=int, default=0,
                   help="exchange as a ring with N chunks per step instead "
                        "of one all_to_all (0 = all_to_all) on the "
                        "partition mesh; stacked on one device the "
                        "exchange is the all_to_all transpose")
    g.add_argument("--halo-cache", action="store_true",
                   help="historical-embedding halo cache: eval forwards "
                        "aggregate against the last-received boundary "
                        "embeddings and only pay the exchange on the "
                        "--halo-refresh-every cadence")
    g.add_argument("--halo-refresh-every", type=int, default=4,
                   help="full halo refresh cadence K with --halo-cache: "
                        "every K-th eval forward pays the full exchange "
                        "(1 = refresh always, i.e. no staleness)")
    g.add_argument("--halo-cv", action="store_true",
                   help="VR-GCN control-variate mode: cached forwards "
                        "refresh a rotating 1/(K-1) chunk of the send "
                        "slots instead of going fully stale between "
                        "full refreshes")
    g.add_argument("--halo-compress", default="none",
                   choices=("none", "fp16", "int8"),
                   help="quantize the eval forwards' halo exchange payload "
                        "(error-compensated per-row codec; composes with "
                        "--halo-cache)")
    g.add_argument("--grad-compress", default="none",
                   choices=("none", "bucketed", "topk"),
                   help="phase-0 gradient reduction: the bucketed mean, or "
                        "top-k sparsification with error feedback")
    g.add_argument("--grad-topk-frac", type=float, default=0.01,
                   help="fraction of gradient entries --grad-compress=topk "
                        "ships per sync")
    g.add_argument("--grad-bucket-kb", type=int, default=512,
                   help="slice size of the bucketed gradient reduction")
    g.add_argument("--no-kernel-agg", action="store_true",
                   help="aggregate with plain index_add_ instead of the "
                        "CUDA segment-mean kernels")
    g.add_argument("--centralized", action="store_true",
                   help="one host, no partitioning (the Table IV baseline)")
    g.add_argument("--full-graph-train", action="store_true",
                   help="phase 0 takes full-batch steps through the "
                        "distributed forward (halo exchange + both "
                        "segment-mean kernels) instead of sampled batches")
    g.add_argument("--full-graph-iters", type=int, default=1,
                   help="full-batch steps per phase-0 epoch with "
                        "--full-graph-train")
    g.add_argument("--async-personalize", action="store_true",
                   help="phase-1 with per-partition iteration budgets and "
                        "the CBS mini-epoch draw on device (no host NumPy "
                        "on the mini-epoch path)")
    g.add_argument("--async-generalize", action="store_true",
                   help="phase-0 epoch draw on device (uniform shuffle, or "
                        "the CBS mini-epoch with CBS on) with the train "
                        "steps and the validation eval on the card, no "
                        "host batch per epoch — retires the host "
                        "prefetcher on that path")
    g.add_argument("--no-double-buffer", action="store_true",
                   help="draw each epoch's batches after the previous "
                        "epoch's steps instead of during them")
    g.add_argument("--phase0-frac", type=float, default=None,
                   help="hard phase split: fraction of --epochs spent "
                        "generalizing (default: the loss-driven trigger)")
    g.add_argument("--feat-store", action="store_true",
                   help="two-tier feature store: keep the top --hot-frac "
                        "of each partition's feature rows resident on "
                        "the card and stage the cold remainder from pinned "
                        "host memory per eval or epoch call")
    g.add_argument("--hot-frac", type=float, default=0.5,
                   help="fraction of feature rows kept device-resident "
                        "with --feat-store (0.0..1.0; 1.0 = all resident, "
                        "zero cold traffic)")
    g.add_argument("--hot-policy", default="degree",
                   choices=("degree", "freq"),
                   help="hot-set ranking: clamped in-degree, or degree "
                        "with a dominating boost for training-set rows")
    g.add_argument("--feat-groups", type=int, default=0,
                   help="stream the eval forward over groups of G <= parts "
                        "partitions (stacked mode, needs --feat-store): "
                        "only G assembled feature planes exist at once, so "
                        "graphs bigger than the stacked plane still run")
    g.add_argument("--feat-budget-mb", type=float, default=0.0,
                   help="refuse to build when peak device feature bytes "
                        "exceed this budget (0 disables): the "
                        "bigger-than-device gate")
    g.add_argument("--checkpoint-dir", default=None,
                   help="save an epoch-granular full-pipeline checkpoint "
                        "here (atomic, checksummed, last "
                        "--keep-checkpoints retained)")
    g.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint every k-th epoch boundary")
    g.add_argument("--keep-checkpoints", type=int, default=3)
    g.add_argument("--resume", action="store_true",
                   help="resume from the newest intact checkpoint in "
                        "--checkpoint-dir; the finished run is bit-for-bit "
                        "the uninterrupted one")
    g.add_argument("--crash-at-epoch", type=int, nargs="*", default=None,
                   metavar="E",
                   help="fault injection: raise InjectedCrash after the "
                        "epoch-E boundary checkpoint")
    g.add_argument("--drop-refresh-at", type=int, nargs="*", default=None,
                   metavar="E",
                   help="fault injection: drop epoch E's halo-cache "
                        "refresh payload (eval serves the stale cache)")
    g.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu for tests)")

    l = sub.add_parser("llm", help="the transformer path: an arch trained "
                       "on the entropy-sharded domain corpus")
    l.add_argument("--arch", default="llama3.2-1b")
    l.add_argument("--shards", type=int, default=4)
    l.add_argument("--method", default="ew", choices=("random", "metis",
                                                      "ew"))
    l.add_argument("--no-cbs", action="store_true")
    l.add_argument("--steps", type=int, default=60)
    l.add_argument("--phase0-frac", type=float, default=0.6)
    l.add_argument("--lambda-prox", type=float, default=0.01)
    l.add_argument("--docs", type=int, default=512)
    l.add_argument("--seq", type=int, default=64)
    l.add_argument("--batch", type=int, default=8)
    l.add_argument("--d-model", type=int, default=128)
    l.add_argument("--seed", type=int, default=0)
    l.add_argument("--full", action="store_true",
                   help="the arch's published widths instead of "
                        "reduced(d_model=--d-model)")
    l.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu for tests)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "llm":
        run_llm(args)
        return 0
    from repro_torch.robustness import InjectedCrash

    try:
        run_gnn(args)
    except InjectedCrash as e:
        print(f"train gnn: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

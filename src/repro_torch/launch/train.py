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
are not ported yet.  ``llm`` (the transformer path) waits
for ROADMAP item 15.
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

    sub.add_parser("llm", help="the transformer path (not ported yet)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "llm":
        print("train llm: the transformer path is not ported yet "
              "(ROADMAP item 15)", file=sys.stderr)
        return 2
    from repro_torch.robustness import InjectedCrash

    try:
        run_gnn(args)
    except InjectedCrash as e:
        print(f"train gnn: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

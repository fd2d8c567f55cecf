"""EAT-DistGNN pipeline: EW partitioning → CBS sampling → GP training, on
one CUDA card (counterpart of ``repro/pipeline.py``).

The paper's experimental loop over N logical compute hosts, every epoch run
by the stacked :class:`repro_torch.engine.SPMDEngine`: the train steps over
all P partitions at once (the cross-partition gradient mean in phase 0,
per-partition weights in phase 1), then the full-graph validation forward
with its per-layer halo exchange and the segment-mean kernel.
``engine_mode="sequential"`` runs the same loop on the Python-loop oracle
(:class:`repro_torch.engine.SequentialReference`, plain aggregation), and
``overlap_halo`` swaps in the split forward.  ``engine_mode="spmd"`` runs
it on the partition mesh: every rank of a world of P
(``launch/mesh.py``) calls this function, holds one partition, and
exchanges halos and gradients through real collectives; the async
phases, the feature store, checkpoint/resume (rank 0 writes the
archives, every rank reads them) and every communication option below
run there too, with the fleet's byte counters.  ``halo_cache`` serves the
eval forwards' halo rows from a historical cache refreshed every
``halo_refresh_every``-th eval (``halo_cv``: a rotating slot chunk in
between), ``halo_compress`` quantizes their exchange with error feedback,
and ``grad_compress`` reduces phase 0's per-partition gradients through
the bucketed or top-k reducer; the byte counters follow the reference's
closed forms.  ``feat_store`` keeps the top ``hot_frac`` of the feature
rows (by ``hot_policy``) on the card, in the engine and in the device
sampler, and stages the cold rows from pinned host memory per eval or
epoch call (``cold_h2d_bytes``, attributed per phase as the reference
does); ``feat_groups`` streams the evals over partition groups, and
``feat_budget_mb`` refuses a configuration whose peak device feature bytes
exceed it.  ``checkpoint_dir`` saves the whole run at every
``checkpoint_every``-th epoch boundary through
:class:`~repro_torch.robustness.RunCheckpointer` (the reference's archive
keys and host blob, so either package resumes the other's files);
``resume=True`` continues from the newest intact step, bitwise the
uninterrupted run; ``fault_plan`` injects the reference's crashes,
stragglers and dropped halo refreshes; ``dtype="float64"`` runs the
features, the batches and the parameters in float64.

Four ported paths, each following the reference:

  · sampled (default): host CBS mini-epochs and fanout sampling,
    double-buffered (epoch t+1 is drawn in a thread while epoch t trains;
    the thread keeps NumPy arrays, the main thread moves each epoch to the
    card in one copy), phase 0 with AdamW (``grad_clip=5.0``), the
    loss-driven (or ``phase0_fraction``) switch, phase-1 prox
    personalization with per-partition budgets and early stops;
  · ``full_graph_train=True``: phase 0 takes full-batch steps through the
    distributed forward, so the backward runs the segment-mean backward
    kernel;
  · ``centralized=True``: one partition (Table IV), with either phase 0;
  · ``async_personalize`` / ``async_generalize``: phase 1 (and phase 0)
    draw every epoch on the card from one shared
    :class:`~repro_torch.core.sampler.DeviceEpochSampler` (Eq. 3 or uniform
    subset, shuffle, fanout, feature gather), with per-partition budgets in
    phase 1; no host sampler runs on these phases and nothing but the
    phase-1 budgets is copied to the card per epoch.

Timing is the reference's "distributed" accounting: per-epoch time is the
max over hosts of host sampling time and an equal 1/N share of the train
steps (the larger of the two with double buffering), validation excluded;
``epoch_time_with_eval_s`` adds the eval's 1/N share.  Communication is
reported in bytes.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .core import (GPController, GPHyperParams, GPScheduleConfig,
                   broadcast_to_partitions, partition_graph)
from .core.gp.trainer import grad_sync_wire_bytes
from .core.sampler import (CBSampler, build_device_epoch_sampler,
                           host_draw_count)
from .device import resolve_device
from .engine import EngineConfig, make_engine
from .engine.compat import barrier
from .engine.stacking import batches_to_device, stack_epoch_batches
from .graph import (BENCHMARKS, GraphSAGE, build_partitioned_graph,
                    make_benchmark)
from .graph.sage import clone_params
from .graph.sampling import NeighborSampler
from .robustness import FaultPlan, InjectedCrash, RunCheckpointer
from .train.metrics import F1Report, f1_scores
from .train.optim import AdamW

__all__ = ["EATConfig", "EATResult", "run_eat_distgnn"]


@dataclass(frozen=True)
class EATConfig:
    dataset: str = "products-s"
    num_parts: int = 4
    partition_method: str = "ew"          # random | metis | ew | ew_balanced
    use_cbs: bool = True
    use_gp: bool = True
    use_focal: bool = False
    max_epochs: int = 40
    hidden_dim: int = 128
    batch_size: int = 256
    fanouts: tuple[int, int] = (10, 10)
    lr: float = 1e-3
    lambda_prox: float = 0.01
    subset_fraction: float = 0.25
    flatten_tol: float = 0.02
    # hard phase split: fraction of max_epochs spent generalizing; None =
    # the loss-driven trigger
    phase0_fraction: float | None = None
    seed: int = 0
    centralized: bool = False             # 1 host, no partitioning (Table IV)
    # auto | stacked | spmd (one torch.distributed rank per partition;
    # every rank runs this function) | sequential
    engine_mode: str = "auto"
    use_kernel_agg: bool = True           # CUDA segment-mean kernels
    # phase 0 trains FULL-GRAPH: ``full_graph_iters`` full-batch steps per
    # epoch straight through the distributed forward
    full_graph_train: bool = False
    full_graph_iters: int = 1
    # overlap host sampling of epoch t+1 with the device steps of epoch t
    double_buffer: bool = True
    # draw phase 1's (and phase 0's) epochs on the card: no host sampler
    async_personalize: bool = False
    async_generalize: bool = False
    device: str = "cuda"                  # raises without a card unless "cpu"
    # boundary/interior split forward: overlap each layer's halo exchange
    # with the interior aggregation and restrict dense compute to owned rows
    overlap_halo: bool = False
    ring_chunks: int = 0                  # ring chunks (the mesh's exchange)
    # historical-embedding halo cache: eval forwards aggregate against the
    # last-received boundary embeddings; only every halo_refresh_every-th
    # forward pays the full exchange, and halo_cv refreshes a rotating slot
    # chunk in between (VR-GCN control variate)
    halo_cache: bool = False
    halo_refresh_every: int = 4
    halo_cv: bool = False
    # compressed communication: quantized halo exchange on the eval
    # forwards (error-compensated; composes with the halo cache) and the
    # phase-0 gradient reduction
    halo_compress: str = "none"           # none | fp16 | int8
    grad_compress: str = "none"           # none | bucketed | topk
    grad_topk_frac: float = 0.01          # fraction of entries top-k ships
    grad_bucket_kb: int = 512             # bucketed reduction's slice size
    # two-tier feature store: keep the top hot_frac of each partition's
    # feature rows (by hot_policy score) on the card and stage the cold
    # rest from pinned host memory per eval or epoch call; the device
    # sampler's gather table splits the same way.  feat_groups > 0 streams
    # the eval over G-partition groups (stacked mode); feat_budget_mb makes
    # the engine refuse to build when peak device feature bytes exceed the
    # budget (<= 0 disables)
    feat_store: bool = False
    hot_frac: float = 0.5
    hot_policy: str = "degree"            # degree | freq
    feat_groups: int = 0
    feat_budget_mb: float = 0.0
    # fault tolerance: checkpoint_dir arms epoch-granular checkpointing
    # through RunCheckpointer (atomic archives + checksummed manifest, the
    # last keep_checkpoints retained); resume=True restores the newest valid
    # checkpoint and continues such that final params and val micro-F1 are
    # bit-for-bit the uninterrupted run's
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    keep_checkpoints: int = 3
    resume: bool = False
    # float dtype of the features, the batches and the parameters
    # ("float32" | "float64"); float64 is what the oracle comparisons run
    dtype: str = "float32"


@dataclass
class EATResult:
    config: EATConfig
    f1: F1Report                       # pooled test predictions
    per_partition_micro: np.ndarray
    partition_entropies: np.ndarray
    partition_time_s: float
    weight_time_s: float
    train_time_s: float                # simulated distributed wall time
    epoch_time_s: float                # mean per-epoch (phase-0), eval excluded
    epochs_run: int
    personalize_start_epoch: int
    loss_history: list[float] = field(default_factory=list)
    val_history: list[float] = field(default_factory=list)
    comm_grad_bytes: int = 0
    comm_halo_bytes: int = 0
    comm_halo_bytes_phase0: int = 0
    comm_halo_bytes_phase1: int = 0
    halo_bytes_per_layer: int = 0      # eval-forward exchange payload/layer
    comm_halo_exchange_bytes: int = 0  # eval-forward exchange volume paid
    halo_exchange_history: list[int] = field(default_factory=list)
    engine_mode: str = "stacked"
    phase1_time_s: float = 0.0         # slowest host's cumulative phase-1 time
    phase1_epochs: int = 0
    host_draws_phase1: int = 0         # host NumPy mini-epoch draws
    host_draws_phase0: int = 0
    # per-epoch TRAIN iteration counts in phase 0 (the work-based witness
    # that CBS mini-epochs shorten the epoch)
    phase0_iter_history: list[int] = field(default_factory=list)
    # bytes copied to the card: the host path's stacked batches; on the
    # async paths the device sampler's staging (in the phase that stages
    # it) and phase 1's per-epoch budgets
    # bytes copied to the card (continued): under the feature store each
    # phase also counts the cold rows staged for its calls (the train
    # gathers of the async epochs, the evals; phase 1 the test eval too)
    host_to_device_bytes_phase0: int = 0
    host_to_device_bytes_phase1: int = 0
    # device-resident feature bytes: the engine's plane (or hot tier) plus
    # the attached device sampler's table (or hot tier)
    resident_feature_bytes: int = 0
    cold_h2d_bytes: int = 0            # cold-row staging, both phases
    # mean phase-0 epoch period INCLUDING the validation eval's 1/N share
    epoch_time_with_eval_s: float = 0.0
    # the per-partition params the final test eval ran with — the
    # bit-for-bit witness the kill-and-resume checks compare
    final_params: Any = None
    resumed_from_epoch: int = -1       # epoch resumed from (-1: fresh start)
    # total injected straggler delay (max over hosts per epoch, summed)
    straggler_delay_s: float = 0.0

    def summary(self) -> dict:
        return {
            "dataset": self.config.dataset,
            "method": self._label(),
            "parts": self.config.num_parts,
            "engine": self.engine_mode,
            "micro_f1": round(self.f1.micro * 100, 2),
            "macro_f1": round(self.f1.macro * 100, 2),
            "weighted_f1": round(self.f1.weighted * 100, 2),
            "train_time_s": round(self.train_time_s, 2),
            "epoch_time_s": round(self.epoch_time_s, 3),
            "epoch_time_with_eval_s": round(self.epoch_time_with_eval_s, 4),
            "epochs": self.epochs_run,
            "personalize_start": self.personalize_start_epoch,
            "avg_entropy": round(float(self.partition_entropies.mean()), 4),
            "partition_time_s": round(self.partition_time_s, 2),
            "comm_grad_mb": round(self.comm_grad_bytes / 1e6, 1),
            "comm_halo_mb": round(self.comm_halo_bytes / 1e6, 1),
            "comm_halo_phase0_mb": round(self.comm_halo_bytes_phase0 / 1e6, 1),
            "comm_halo_phase1_mb": round(self.comm_halo_bytes_phase1 / 1e6, 1),
            "halo_bytes_per_layer": self.halo_bytes_per_layer,
            "halo_cache": self.config.halo_cache,
            "halo_refresh_every": self.config.halo_refresh_every,
            "halo_cv": self.config.halo_cv,
            "halo_compress": self.config.halo_compress,
            "grad_compress": self.config.grad_compress,
            "comm_halo_exchange_mb": round(
                self.comm_halo_exchange_bytes / 1e6, 3),
            "phase1_time_s": round(self.phase1_time_s, 3),
            "phase1_epochs": self.phase1_epochs,
            "async_personalize": self.config.async_personalize,
            "async_generalize": self.config.async_generalize,
            "overlap_halo": self.config.overlap_halo,
            "full_graph_train": self.config.full_graph_train,
            "phase0_iters_per_epoch": (
                round(float(np.mean(self.phase0_iter_history)), 2)
                if self.phase0_iter_history else 0.0),
            "host_to_device_mb_phase0": round(
                self.host_to_device_bytes_phase0 / 1e6, 3),
            "host_to_device_mb_phase1": round(
                self.host_to_device_bytes_phase1 / 1e6, 3),
            "feat_store": self.config.feat_store,
            "hot_frac": self.config.hot_frac,
            "resident_feature_mb": round(
                self.resident_feature_bytes / 1e6, 3),
            "cold_h2d_mb": round(self.cold_h2d_bytes / 1e6, 3),
            "resumed_from_epoch": self.resumed_from_epoch,
            "straggler_delay_s": round(self.straggler_delay_s, 3),
        }

    def _label(self) -> str:
        c = self.config
        if c.centralized:
            return "Centralized"
        parts = {"random": "RAND", "metis": "METIS", "ew": "EW",
                 "ew_balanced": "EW-BAL"}[c.partition_method]
        mods = [parts]
        if c.use_gp:
            mods.append("GP")
        if c.use_cbs:
            mods.append("CBS")
        return "+".join(mods)


class _EpochPrefetcher:
    """Double-buffered host sampling: draw epoch t+1's batches in a
    background thread while the device executes epoch t's steps.

    One worker thread at a time, so the samplers' NumPy RNG streams advance
    in exactly the sequential order — results are identical to the
    unbuffered pipeline, only the wall-clock overlaps.  The worker returns
    NumPy arrays; nothing in it touches torch.

    ``snapshot`` (optional) is called on the MAIN thread immediately before
    each speculative draw starts, so ``last_snapshot`` always holds a
    race-free capture of the sampler RNG states with every draw through the
    last handed-out epoch consumed — the stream position an epoch-boundary
    checkpoint must store for a resumed run to re-draw the next epoch
    identically.
    """

    def __init__(self, draw, snapshot=None):
        self._draw = draw
        self._snapshot = snapshot
        self._pending = None
        self.last_snapshot = None

    def _spawn(self) -> None:
        if self._snapshot is not None:
            self.last_snapshot = self._snapshot()
        box = {}

        def work():
            try:
                box["out"] = self._draw()
            except BaseException as e:   # surfaces in next(), not swallowed
                box["err"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        self._pending = (th, box)

    def next(self):
        """Epoch t's batches (waits if still sampling), then immediately
        kicks off epoch t+1's draw so it overlaps the caller's device step."""
        if self._pending is None:
            self._spawn()
        th, box = self._pending
        th.join()
        if "err" in box:
            raise box["err"]
        self._spawn()
        return box["out"]

    def settle(self) -> None:
        """Wait for any in-flight draw WITHOUT discarding it, so
        host_draw_count() reads are race-free."""
        if self._pending is not None:
            self._pending[0].join()

    def close(self) -> None:
        """Join and discard any in-flight draw (phase transition/shutdown)."""
        if self._pending is not None:
            self._pending[0].join()
            self._pending = None


def _check_config(cfg: EATConfig) -> None:
    if cfg.halo_cache and cfg.full_graph_train:
        raise ValueError(
            "halo_cache is an eval-forward optimisation; full_graph_train "
            "differentiates through the live halo exchange and cannot train "
            "against stale cached embeddings")
    if cfg.feat_store and cfg.full_graph_train:
        raise ValueError(
            "full_graph_train differentiates through the resident feature "
            "stack; the feature store's staged cold tier has no training "
            "spelling — run full-graph training all-resident")
    if cfg.feat_groups and cfg.async_generalize:
        raise ValueError(
            "feat_groups streams the eval host-side, which cannot live "
            "inside the fused async phase-0 program — run the host-batch "
            "phase-0 path (async_generalize=False) when streaming")
    if cfg.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, got "
                         f"{cfg.dtype!r}")


def _fold_in(base: int, epoch: int) -> int:
    """A generator seed for ``epoch`` of the stream ``base`` (the
    counterpart of ``jax.random.fold_in``), the same on every run."""
    return int(np.random.SeedSequence([base, epoch]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def _copy_partitions(dst, src, parts) -> None:
    """Copy partitions ``parts`` of per-partition ``src`` into ``dst``."""
    idx = torch.as_tensor(np.asarray(parts), device=next(dst.parameters()).device)
    for d, s in zip(dst.parameters(), src.parameters()):
        d[idx] = s[idx]


def run_eat_distgnn(cfg: EATConfig, verbose: bool = False,
                    fault_plan: FaultPlan | None = None) -> EATResult:
    """The paper's pipeline.  Inside a ``torch.distributed`` world (the
    partition mesh, ``engine_mode="spmd"`` or ``"auto"``) every rank calls
    it with the same config, builds the same graph and partition, and
    returns the same result (its timings are its own host's); only rank 0
    prints."""
    _check_config(cfg)
    verbose = verbose and (dist.get_rank() == 0 if dist.is_available()
                           and dist.is_initialized() else True)
    dev = resolve_device(cfg.device)
    fdt = np.dtype(cfg.dtype)
    tdt = getattr(torch, cfg.dtype)
    graph = make_benchmark(BENCHMARKS[cfg.dataset])
    n_parts = 1 if cfg.centralized else cfg.num_parts

    # ---------------- partitioning (host-side preprocessing, timed) -------
    if cfg.centralized:
        parts = np.zeros(graph.num_nodes, dtype=np.int64)
        p_time = w_time = 0.0
        ents = np.array([0.0])
    else:
        pres = partition_graph(graph.indptr, graph.indices, graph.features,
                               graph.labels, n_parts,
                               method=cfg.partition_method, seed=cfg.seed,
                               fanout_k=cfg.fanouts[0])
        parts = pres.parts
        p_time, w_time = pres.partition_time_s, pres.weight_time_s
        ents = pres.stats.entropies
        if verbose:
            print(f"partition[{cfg.partition_method}] {pres.stats.row()}")

    # ---------------- stacked shards + engine ------------------------------
    pg = build_partitioned_graph(graph, parts, n_parts)
    model = GraphSAGE(feature_dim=graph.feature_dim, hidden_dim=cfg.hidden_dim,
                      num_classes=graph.num_classes)
    loss_fn = model.make_loss_fn(loss="focal" if cfg.use_focal else "ce")
    opt = AdamW(lr=cfg.lr, grad_clip=5.0)
    engine = make_engine(
        model, loss_fn, opt, pg, hp=GPHyperParams(lambda_prox=cfg.lambda_prox),
        config=EngineConfig(mode=cfg.engine_mode,
                            use_kernel_agg=cfg.use_kernel_agg,
                            dtype=tdt,
                            device=cfg.device,
                            overlap_halo=cfg.overlap_halo,
                            ring_chunks=cfg.ring_chunks,
                            fg_loss="focal" if cfg.use_focal else "ce",
                            halo_cache=cfg.halo_cache,
                            halo_refresh_every=cfg.halo_refresh_every,
                            halo_cv=cfg.halo_cv,
                            halo_compress=cfg.halo_compress,
                            grad_compress=cfg.grad_compress,
                            grad_topk_frac=cfg.grad_topk_frac,
                            grad_bucket_kb=cfg.grad_bucket_kb,
                            feat_store=cfg.feat_store,
                            hot_frac=cfg.hot_frac,
                            hot_policy=cfg.hot_policy,
                            feat_groups=cfg.feat_groups,
                            feat_budget_mb=cfg.feat_budget_mb))
    # the partition mesh of this rank (None outside one, and for the
    # sequential oracle): every rank runs this function; rank 0 alone
    # writes the checkpoints
    mesh = getattr(engine, "mesh", None)
    if verbose:
        print(f"engine[{engine.mode}] {pg.summary()}")

    # ---------------- per-host samplers -----------------------------------
    neigh = NeighborSampler(graph, fanouts=cfg.fanouts, seed=cfg.seed)
    host_train = [graph.train_idx[parts[graph.train_idx] == p]
                  for p in range(n_parts)]
    samplers = [
        CBSampler(graph.indptr, graph.indices, graph.labels, host_train[p],
                  batch_size=cfg.batch_size,
                  subset_fraction=cfg.subset_fraction if cfg.use_cbs else 1.0,
                  class_balanced=cfg.use_cbs, seed=cfg.seed + p)
        for p in range(n_parts)
    ]

    # the parameters take the run's dtype: torch's products do not promote
    # f32 weights against f64 features as the reference's do
    params = model.init(cfg.seed).to(dev, tdt)
    opt_state = opt.init(params.parameters())
    # per-sync gradient wire volume, truthful to the sync spelling: the
    # all_gather ships P*(P-1) full copies, the bucketed ring 2*(P-1),
    # top-k only the (value, index) pairs each partition keeps
    weights = list(params.parameters())
    grad_bytes_per_sync = grad_sync_wire_bytes(
        cfg.grad_compress, n_parts, sum(w.numel() for w in weights),
        itemsize=weights[0].element_size(), topk_frac=cfg.grad_topk_frac)
    # cross-partition edges = remote fetch volume per epoch (DistDGL analog)
    src_all = graph.indices
    dst_all = np.repeat(np.arange(graph.num_nodes), np.diff(graph.indptr))
    cut_frac = float((parts[src_all] != parts[dst_all]).mean())
    # CBS mini-epochs touch subset_fraction of the train nodes, the plain
    # sampler all of them
    eff_fraction = cfg.subset_fraction if cfg.use_cbs else 1.0
    fetch_bytes_per_epoch = int(cut_frac * graph.num_edges * graph.feature_dim
                                * fdt.itemsize * eff_fraction)

    def eval_exchange_bytes() -> int:
        # the exchange volume THIS epoch's eval forward paid: only the
        # refreshed-row payload under the halo cache (the engine reports it
        # after each cached forward), the full per-layer wire payload
        # (compression-truthful) otherwise
        if cfg.halo_cache:
            return int(engine.last_halo_exchange_bytes)
        return model.num_layers * engine.halo_wire_bytes_per_layer

    batch_feats = np.asarray(graph.features, fdt)

    def make_batch(nodes: np.ndarray) -> dict:
        # fixed shapes (pad + mask) so batches stack across hosts
        k = len(nodes)
        if k < cfg.batch_size:
            nodes = np.concatenate(
                [nodes, np.zeros(cfg.batch_size - k, dtype=nodes.dtype)])
        mask = np.zeros(cfg.batch_size, fdt)
        mask[:k] = 1.0
        blocks = neigh.sample(nodes)
        x_t, x_1, x_2 = blocks.feature_views(batch_feats)
        return {"x_t": x_t, "x_1": x_1, "x_2": x_2,
                "labels": graph.labels[nodes].astype(np.int32), "mask": mask}

    # ---------------- phase 0: generalization -----------------------------
    p0frac = cfg.phase0_fraction
    if p0frac is None and cfg.async_personalize:
        p0frac = 0.4
    sched = GPScheduleConfig(
        max_epochs=cfg.max_epochs,
        flatten_tol=cfg.flatten_tol,
        phase0_fraction=p0frac,
        # a hard split must fit the epoch budget (e.g. --epochs 3)
        min_phase0_epochs=(min(3, max(1, cfg.max_epochs // 3))
                           if p0frac is not None else 3))
    ctrl = GPController(num_partitions=n_parts, config=sched)
    sim_time = 0.0
    epoch_times: list[float] = []
    epoch_times_with_eval: list[float] = []
    comm_grad = comm_halo_p0 = comm_halo_p1 = 0
    halo_exchange_hist: list[int] = []
    best_global = clone_params(params)
    loss_hist: list[float] = []
    val_hist: list[float] = []

    # host sampler RNG discipline for checkpointing: `rng_snapshot` always
    # holds the generator states with every draw through the last
    # handed-out epoch consumed — captured on the main thread BEFORE any
    # speculative prefetch draw, so the double-buffered path checkpoints
    # the same stream position the unbuffered path would
    def capture_rng() -> dict:
        return {"cbs": [s._rng.bit_generator.state for s in samplers],
                "neigh": neigh._rng.bit_generator.state}

    def restore_rng(snap: dict) -> None:
        for s, st in zip(samplers, snap["cbs"]):
            s._rng.bit_generator.state = st
        neigh._rng.bit_generator.state = snap["neigh"]

    rng_snapshot = capture_rng()
    prefetch = None

    def next_epoch_batches():
        """One epoch of stacked batches on the card, host time, iters."""
        nonlocal prefetch, rng_snapshot
        if cfg.double_buffer:
            if prefetch is None:
                prefetch = _EpochPrefetcher(
                    lambda: stack_epoch_batches(samplers, make_batch, n_parts),
                    snapshot=capture_rng)
            host, t_host, iters = prefetch.next()
            rng_snapshot = prefetch.last_snapshot
        else:
            host, t_host, iters = stack_epoch_batches(samplers, make_batch,
                                                      n_parts)
            rng_snapshot = capture_rng()
        # the fleet's bytes: on the mesh each rank copies its own rows of the
        # stack every rank draws (one shared NeighborSampler advances over
        # all partitions, so only the whole draw reproduces its stream)
        nbytes = sum(v.nbytes for v in host.values())
        if engine.mode == "spmd":
            host = engine.rank_batches(host)
        return batches_to_device(host, dev), t_host, iters, nbytes

    def epoch_host_times(t_host, t_dev):
        # synchronous epoch: everyone waits for the slowest host; the device
        # steps are attributed in equal 1/N shares.  Double-buffered, the
        # next epoch's sampling overlaps this epoch's device steps.
        if cfg.double_buffer:
            return np.maximum(t_host, t_dev / n_parts)
        return t_host + t_dev / n_parts

    # full-graph epochs exchange halos in BOTH directions of each train
    # step, plus the per-epoch validation forward's exchange, and fetch no
    # sampled neighbours; training exchanges stay uncompressed, only the
    # eval forward's term uses the wire rate
    fg_halo_bytes_per_epoch = (2 * model.num_layers * pg.halo_bytes_per_layer
                               * cfg.full_graph_iters
                               + model.num_layers
                               * engine.halo_wire_bytes_per_layer)

    # ONE device sampler serves both async phases, staged by the first phase
    # that needs it (on the mesh every rank stages the same sampler, and the
    # count is the stacked one: the fleet's table counted once)
    async_phase0 = cfg.async_generalize and not cfg.full_graph_train
    dev_sampler = None
    gen = torch.Generator(device=dev)

    def stage_device_sampler():
        nonlocal dev_sampler
        dev_sampler = build_device_epoch_sampler(
            graph, host_train, n_parts, batch_size=cfg.batch_size,
            subset_fraction=cfg.subset_fraction if cfg.use_cbs else 1.0,
            class_balanced=cfg.use_cbs, fanouts=cfg.fanouts,
            dtype=getattr(torch, cfg.dtype), feat_store=cfg.feat_store,
            hot_frac=cfg.hot_frac, hot_policy=cfg.hot_policy, device=dev)
        engine.set_device_sampler(dev_sampler)
        return dev_sampler.nbytes

    # on a resume the restore below overwrites this count with the
    # archived one, which already holds the staging
    host_to_device_p0 = stage_device_sampler() if async_phase0 else 0
    host_to_device_p1 = 0
    p0_iter_hist: list[int] = []
    straggler_total = 0.0

    # cold-row staging is counted inside the engine as each copy is issued;
    # the pipeline reads per-epoch deltas to attribute it to its phase
    cold_mark = engine.cold_h2d_bytes

    def cold_delta() -> int:
        nonlocal cold_mark
        d, cold_mark = engine.cold_h2d_bytes - cold_mark, engine.cold_h2d_bytes
        return d

    # ---------------- checkpoint/resume -------------------------------------
    # on the mesh every rank reads the directory and rank 0 writes it: the
    # archive (replicated and gathered arrays, the host blob) is the
    # stacked run's, its fingerprint's engine "spmd"
    ckpt = (RunCheckpointer(cfg.checkpoint_dir,
                            keep_last=cfg.keep_checkpoints)
            if cfg.checkpoint_dir else None)
    fingerprint = {"dataset": cfg.dataset, "num_parts": n_parts,
                   "method": cfg.partition_method, "seed": cfg.seed,
                   "dtype": cfg.dtype, "engine": engine.mode,
                   "halo_cache": cfg.halo_cache,
                   "halo_compress": cfg.halo_compress,
                   "grad_compress": cfg.grad_compress,
                   "feat_store": cfg.feat_store,
                   "hot_frac": cfg.hot_frac if cfg.feat_store else 0.0,
                   "hot_policy": cfg.hot_policy if cfg.feat_store else ""}

    def make_like(host: dict) -> dict:
        # reject a foreign checkpoint BEFORE any array I/O: a different
        # seed/partitioning would otherwise surface as a shape mismatch
        fp = host.get("fingerprint", {})
        if fp != fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {fp} does not match this run "
                f"{fingerprint} — refusing to resume")
        # the arrays template is phase-dependent: personal params exist
        # only once the phase-1 loop has run at least one epoch
        like = {"params": params, "opt": opt_state, "best_global": params}
        if host.get("has_phase1"):
            pp = broadcast_to_partitions(params, n_parts)
            like.update(global_params=params, pparams=pp,
                        popt=opt.init_stacked(pp.parameters()),
                        best_personal=pp)
        # the stacked layout's templates (on the mesh too)
        comm = engine.comm_state_like(params)
        if "halo" in comm:
            like["halo"] = comm["halo"]
        if host.get("has_halo_res"):
            like["halo_res"] = comm["halo_res"]
        if host.get("has_grad_res"):
            like["grad_res"] = comm["grad_res"]
        return like

    restore_phase1 = None
    resumed_from = -1
    if ckpt is not None and cfg.resume:
        loaded = ckpt.load_latest(make_like)
        if loaded is not None:
            arrays, host, resumed_from = loaded
            params, opt_state = arrays["params"], arrays["opt"]
            best_global = arrays["best_global"]
            ctrl.load_state_dict(host["controller"])
            rng_snapshot = host["rng"]
            restore_rng(rng_snapshot)
            loss_hist = [float(x) for x in host["loss_hist"]]
            val_hist = [float(x) for x in host["val_hist"]]
            sim_time = float(host["sim_time"])
            epoch_times = [float(x) for x in host["epoch_times"]]
            epoch_times_with_eval = [float(x)
                                     for x in host["epoch_times_with_eval"]]
            comm_grad, comm_halo_p0, comm_halo_p1 = (
                int(x) for x in host["comm"])
            halo_exchange_hist = [int(x) for x in host["halo_exchange_hist"]]
            p0_iter_hist = [int(x) for x in host["p0_iter_hist"]]
            host_to_device_p0 = int(host["host_to_device_p0"])
            host_to_device_p1 = int(host.get("host_to_device_p1", 0))
            straggler_total = float(host.get("straggler_s", 0.0))
            if "halo" in arrays:
                engine.restore_halo_cache_state(arrays["halo"],
                                                host["halo_age"])
            if "halo_res" in arrays or "grad_res" in arrays:
                engine.restore_comm_residual_state(
                    (arrays.get("halo_res"), arrays.get("grad_res")))
            if host.get("has_phase1"):
                restore_phase1 = (arrays, host)
            if verbose:
                print(f"[resume] epoch {resumed_from} phase {ctrl.phase} "
                      f"from {cfg.checkpoint_dir}")
        if mesh is not None:
            # every rank has read the same newest archive before rank 0
            # can write (and prune) the next one
            barrier(mesh)

    phase1_state: dict = {}   # live phase-1 state, for checkpoint capture

    def save_checkpoint() -> None:
        arrays = {"params": params, "opt": opt_state,
                  "best_global": best_global}
        host = {
            "has_phase1": bool(phase1_state),
            "controller": ctrl.state_dict(),
            "rng": rng_snapshot,
            "loss_hist": loss_hist, "val_hist": val_hist,
            "sim_time": sim_time,
            "epoch_times": epoch_times,
            "epoch_times_with_eval": epoch_times_with_eval,
            "comm": [int(comm_grad), int(comm_halo_p0), int(comm_halo_p1)],
            "halo_exchange_hist": [int(x) for x in halo_exchange_hist],
            "p0_iter_hist": [int(x) for x in p0_iter_hist],
            "host_to_device_p0": int(host_to_device_p0),
            "host_to_device_p1": int(host_to_device_p1),
            "straggler_s": straggler_total,
            "fingerprint": fingerprint,
        }
        st = engine.halo_cache_state()
        if st is not None:
            arrays["halo"] = st[0]
            host["halo_age"] = int(st[1])
        cs = engine.comm_residual_state()
        if cs is not None:
            h_res, g_res = cs
            if h_res is not None:
                arrays["halo_res"] = h_res
            if g_res is not None:
                arrays["grad_res"] = g_res
            host["has_halo_res"] = h_res is not None
            host["has_grad_res"] = g_res is not None
        if phase1_state:
            arrays.update(
                global_params=phase1_state["global_params"],
                pparams=phase1_state["pparams"],
                popt=phase1_state["popt"],
                best_personal=phase1_state["best_personal"])
            host["host_elapsed"] = [float(x)
                                    for x in phase1_state["host_elapsed"]]
            host["phase1_epochs"] = int(phase1_state["phase1_epochs"])
        if mesh is None or mesh.rank == 0:
            ckpt.save(ctrl.epoch, arrays, host)

    def epoch_boundary() -> None:
        """End of one epoch (ctrl already advanced): persist the boundary,
        then let any injected crash fire AFTER the state is durable — the
        only crash point an epoch-granular checkpointer can replay.  On the
        mesh every rank waits after rank 0's save, so no rank crashes
        ahead of a durable archive."""
        if ckpt is not None and ctrl.epoch % max(1, cfg.checkpoint_every) == 0:
            save_checkpoint()
            if mesh is not None:
                barrier(mesh)
        if fault_plan is not None and fault_plan.crash_at(ctrl.epoch):
            raise InjectedCrash(ctrl.epoch)

    def epoch_faults() -> np.ndarray | None:
        """Start of one epoch (index ctrl.epoch): arm the dropped-refresh
        fault, return this epoch's straggler delays (None = none)."""
        if fault_plan is None:
            return None
        if (cfg.halo_cache and fault_plan.drop_halo_refresh(ctrl.epoch)
                and hasattr(engine, "drop_next_halo_refresh")):
            engine.drop_next_halo_refresh()
        d = fault_plan.straggler_delay(ctrl.epoch, n_parts)
        return d if d.any() else None

    draws_at_p0_start = host_draw_count()
    # the no-GP early stop lives in the loop CONDITION (not a body break) so
    # a run resumed from its stopping boundary also exits before training
    while (not ctrl.done and ctrl.phase == 0
           and not (not cfg.use_gp and ctrl.phase0_stopper.stopped)):
        delay = epoch_faults()
        if cfg.full_graph_train:
            params, opt_state, losses, val_micro, t_dev = (
                engine.phase0_fullgraph_epoch(params, opt_state,
                                              iters=cfg.full_graph_iters))
            iters = losses.shape[0]
            t_host = np.zeros(n_parts)      # no host sampling on this path
            comm_halo_p0 += fg_halo_bytes_per_epoch
            halo_exchange_hist.append(eval_exchange_bytes())
        elif async_phase0:
            # draw, steps and validation forward on the card; the seed rides
            # in the launches' arguments, nothing is copied
            gen.manual_seed(_fold_in(cfg.seed ^ 0x6E02, ctrl.epoch))
            params, opt_state, losses, val_micro, t_dev = (
                engine.phase0_epoch_async(params, opt_state, gen))
            iters = losses.shape[0]
            t_host = np.zeros(n_parts)      # no host sampling on this path
            ex = eval_exchange_bytes()
            halo_exchange_hist.append(ex)
            comm_halo_p0 += ex + fetch_bytes_per_epoch
        else:
            batches, t_host, iters, nbytes = next_epoch_batches()
            host_to_device_p0 += nbytes
            params, opt_state, losses, val_micro, t_dev = engine.phase0_epoch(
                params, opt_state, batches)
            ex = eval_exchange_bytes()
            halo_exchange_hist.append(ex)
            comm_halo_p0 += ex + fetch_bytes_per_epoch
        host_to_device_p0 += cold_delta()
        comm_grad += grad_bytes_per_sync * iters
        p0_iter_hist.append(int(iters))
        host_time = epoch_host_times(t_host, t_dev)
        if delay is not None:
            # injected straggler: the synchronous epoch waits for it
            host_time = host_time + delay
            straggler_total += float(delay.max())
        sim_time += float(host_time.max())
        epoch_times.append(float(host_time.max()))
        # the async epoch's t_dev already holds its validation forward
        # (last_eval_seconds is 0 there)
        epoch_times_with_eval.append(
            float(host_time.max()) + engine.last_eval_seconds / n_parts)

        mean_loss = float(losses.mean())
        mean_val = float(val_micro.mean())
        loss_hist.append(mean_loss)
        val_hist.append(mean_val)
        if ctrl.record_phase0(mean_loss, mean_val):
            best_global = clone_params(params)
        if verbose:
            print(f"[phase-0] epoch {ctrl.epoch:3d} loss {mean_loss:.4f} "
                  f"val-micro {mean_val*100:.2f}")
        if cfg.use_gp and ctrl.should_personalize():
            ctrl.start_personalization()
        epoch_boundary()

    if prefetch is not None:
        prefetch.settle()
    # with the prefetcher the tally includes the speculative next-epoch draw
    host_draws_p0 = host_draw_count() - draws_at_p0_start
    personalize_start = ctrl.personalize_start_epoch

    # ---------------- phase 1: personalization ----------------------------
    phase1_time = 0.0
    phase1_epochs = 0
    host_draws_p1 = 0
    if cfg.use_gp and not cfg.centralized:
        if restore_phase1 is not None:
            # resumed mid-personalization: restore the phase-1 state the
            # checkpoint carried instead of re-deriving it from best_global
            arrays, rhost = restore_phase1
            global_params = arrays["global_params"]
            pparams, popt = arrays["pparams"], arrays["popt"]
            best_personal = arrays["best_personal"]
            host_elapsed = np.asarray(rhost["host_elapsed"], float)
            phase1_epochs = int(rhost["phase1_epochs"])
        else:
            global_params = best_global
            pparams = broadcast_to_partitions(global_params, n_parts)
            popt = opt.init_stacked(pparams.parameters())
            best_personal = clone_params(pparams)
            host_elapsed = np.zeros(n_parts)
        if cfg.async_personalize:
            # from here on every epoch is drawn on the card: discard any
            # in-flight host draw, and stage the sampler unless phase 0 did
            # (a run resumed in phase 1 restored the count that holds it)
            if prefetch is not None:
                prefetch.close()
            if dev_sampler is None:
                staged = stage_device_sampler()
                if restore_phase1 is None:
                    host_to_device_p1 += staged
        draws_at_p1_start = host_draw_count()
        while not ctrl.done:
            active_np = ctrl.active_partitions
            delay = epoch_faults()
            if delay is not None:
                host_elapsed += np.where(active_np, delay, 0.0)
                straggler_total += float(delay.max())
            if cfg.async_personalize:
                budgets = ctrl.phase1_budgets(dev_sampler.natural_iters)
                gen.manual_seed(_fold_in(cfg.seed ^ 0xCB5D, ctrl.epoch))
                pparams, popt, losses, val_micro, t_dev = (
                    engine.phase1_epoch_async(pparams, popt, gen, budgets,
                                              global_params))
                host_to_device_p1 += budgets.astype(np.int32).nbytes
                # each host pays for its own budgeted share of the steps;
                # converged hosts (budget 0) pay nothing
                host_elapsed += t_dev * budgets / max(1, int(budgets.sum()))
            else:
                batches, t_host, iters, _ = next_epoch_batches()
                budgets = ctrl.phase1_budgets(iters)
                pparams, popt, losses, val_micro, t_dev = engine.phase1_epoch(
                    pparams, popt, batches, global_params, budgets)
                host_elapsed += np.where(
                    active_np, epoch_host_times(t_host, t_dev), 0.0)
            ex = eval_exchange_bytes()
            halo_exchange_hist.append(ex)
            comm_halo_p1 += ex + fetch_bytes_per_epoch
            host_to_device_p1 += cold_delta()
            scores = val_micro.cpu().numpy()
            is_best = ctrl.record_phase1(scores)
            phase1_epochs += 1
            if is_best.any():
                _copy_partitions(best_personal, pparams, np.flatnonzero(is_best))
            loss_hist.append(float(losses[-1].mean()))
            val_hist.append(float(scores.mean()))
            if verbose:
                print(f"[phase-1] epoch {ctrl.epoch:3d} "
                      f"val-micro {scores.mean()*100:.2f} "
                      f"active {int(active_np.sum())}/{n_parts} "
                      f"budgets {np.asarray(budgets).tolist()}")
            phase1_state.update(
                global_params=global_params, pparams=pparams, popt=popt,
                best_personal=best_personal, host_elapsed=host_elapsed,
                phase1_epochs=phase1_epochs)
            epoch_boundary()
        if prefetch is not None:
            prefetch.close()
        host_draws_p1 = host_draw_count() - draws_at_p1_start
        # distributed time = slowest host's own cumulative time
        phase1_time = float(host_elapsed.max())
        sim_time += phase1_time
        final_params = best_personal
    else:
        final_params = broadcast_to_partitions(best_global, n_parts)
        if prefetch is not None:
            prefetch.close()

    # ---------------- final evaluation -------------------------------------
    _, preds = engine.evaluate(final_params, "test", per_partition_params=True)
    host_to_device_p1 += cold_delta()    # the test eval's cold staging
    preds = preds.cpu().numpy()
    test_mask = np.asarray(pg.test_mask)
    labels = np.asarray(pg.labels)
    all_preds, all_labels, per_micro = [], [], np.zeros(n_parts)
    for p in range(n_parts):
        m = test_mask[p]
        pred, lab = preds[p][m], labels[p][m]
        all_preds.append(pred)
        all_labels.append(lab)
        per_micro[p] = f1_scores(pred, lab, graph.num_classes).micro
    f1 = f1_scores(np.concatenate(all_preds), np.concatenate(all_labels),
                   graph.num_classes)

    return EATResult(
        config=cfg, f1=f1, per_partition_micro=per_micro,
        partition_entropies=ents, partition_time_s=p_time, weight_time_s=w_time,
        train_time_s=sim_time,
        epoch_time_s=float(np.mean(epoch_times)) if epoch_times else 0.0,
        epoch_time_with_eval_s=(float(np.mean(epoch_times_with_eval))
                                if epoch_times_with_eval else 0.0),
        epochs_run=ctrl.epoch, personalize_start_epoch=personalize_start,
        loss_history=loss_hist, val_history=val_hist,
        comm_grad_bytes=comm_grad,
        comm_halo_bytes=comm_halo_p0 + comm_halo_p1,
        comm_halo_bytes_phase0=comm_halo_p0,
        comm_halo_bytes_phase1=comm_halo_p1,
        halo_bytes_per_layer=pg.halo_bytes_per_layer,
        comm_halo_exchange_bytes=sum(halo_exchange_hist),
        halo_exchange_history=halo_exchange_hist,
        engine_mode=engine.mode,
        phase1_time_s=phase1_time, phase1_epochs=phase1_epochs,
        host_draws_phase1=host_draws_p1,
        host_draws_phase0=host_draws_p0,
        phase0_iter_history=p0_iter_hist,
        host_to_device_bytes_phase0=host_to_device_p0,
        host_to_device_bytes_phase1=host_to_device_p1,
        resident_feature_bytes=engine.resident_feature_bytes,
        cold_h2d_bytes=engine.cold_h2d_bytes,
        final_params=final_params,
        resumed_from_epoch=resumed_from,
        straggler_delay_s=straggler_total,
    )

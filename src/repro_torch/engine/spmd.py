"""Stacked and partition-mesh execution engine (counterpart of
``repro/engine/spmd.py``).

On one GPU all P partitions run batched on one device: every shard array
is stacked into a ``(P, ...)`` tensor and each forward is one program over
all partitions, the reference's ``mode="stacked"`` (``mode="auto"``
resolves to it outside a ``torch.distributed`` world of P ranks;
``mode="sequential"`` is the Python-loop oracle
:class:`~repro_torch.engine.sequential.SequentialReference`, which
:func:`repro_torch.engine.make_engine` builds).  Ported: the construction
(shards and blocked-CSR structures), the synchronous and the overlapped
split forward (``overlap_halo``; stacked, the exchange is the transpose
whatever ``ring_chunks`` says), the epoch
methods of the training path — sampled phase 0, full-graph phase 0, phase
1 with per-partition budgets, and the async epochs of both phases, which
draw their batches on the device from an attached
:class:`~repro_torch.core.sampler.DeviceEpochSampler` — and
:meth:`SPMDEngine.evaluate`, plus :meth:`SPMDEngine.export_serving_state`
for serving.  The communication options are ported too: the historical
halo cache (``halo_cache``, ``halo_refresh_every``, ``halo_cv``) and the
quantized halo exchange (``halo_compress``) on every eval forward, and
the bucketed and top-k phase-0 gradient reducers (``grad_compress``).
So is the two-tier feature store (``feat_store``, ``hot_frac``,
``hot_policy``, ``feat_budget_mb``): the hot rows stay on the device, the
cold rows live in pinned host memory and are staged with one non-blocking
copy per eval or epoch call (``cold_h2d_bytes`` counts them), and every
forward reads the plane reassembled from both, bitwise the resident one;
``feat_groups`` streams the eval over partition groups
(:class:`~repro_torch.engine.streaming.StreamedEvaluator`).

``mode="spmd"`` is the partition mesh, the reference's ``shard_map`` mode:
inside a ``torch.distributed`` world of P ranks (``launch/mesh.py``) every
rank holds only its own partition's shard on its own device, runs its
partition's forward with the halo exchange a real collective (an
all_to_all, or the ``ring_chunks`` ring), ``pmean``s the phase-0
gradients, and trains its own phase-1 weights.  Each call gathers at its
end what the stacked call returns (losses, micro-F1, predictions, the
phase-1 params, the export), so the public surface returns the same on
every rank; the epoch's seconds are the slowest rank's.  The async epochs
run there too: every rank draws the whole ``(P, I, B)`` epoch and both
fanouts from the same generator, and gathers only its own row's features,
so its batches are bitwise its row of the stacked engine's; phase 0 means
the gradients as the reference's fused program does (``all_gather``, then
a partition-order sum), and phase 1 trains each rank's row with no
collective until the epoch's end.  Under the feature store a rank holds
its partition's hot tier and stages its own cold rows; the byte counters
report the fleet's (the stacked engine's) values.  The communication
options run there as well: the rank's rows of the halo cache and of the
halo residual ride through its eval forwards (the refresh plan, a
function of host state every rank holds, is the same on every rank, and
a ``(0, 0)`` plan runs no collective), the quantized payload and its
int8 scales cross the ranks as two collectives, the overlapped forward
starts its exchange before the interior half and waits for it before
landing, and phase 0 reduces through the per-shard bucketed
reduce-scatter and all-gather or the top-k ``all_gather`` (with the
rank's ``(N,)`` residual), each summed in partition order.  Their
checkpoint surface gives and takes the stacked layout.

Epoch methods return a trailing ``device_seconds``: host wall time of the
TRAIN steps, ended by ``torch.cuda.synchronize()`` on the card.  The
validation forward is a separate call whose time lands in
``last_eval_seconds``, so epoch-time comparisons stay about training, as in
the reference; the async phase-0 epoch times its validation forward with
its steps and sets ``last_eval_seconds`` to 0, as the reference's fused
epoch does.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.gp.trainer import (GPHyperParams, GRAD_COMPRESS_MODES,
                               make_bucketed_reduce_shard,
                               make_fullgraph_loss_fn, make_generalize_step,
                               make_grad_reduce_stacked,
                               make_mesh_generalize_step,
                               make_personalize_step,
                               make_reduce_generalize_step,
                               make_topk_reduce_shard)
from ..device import resolve_device
from ..graph.distributed import (HALO_COMPRESS_MODES, PartitionedGraph,
                                 halo_refresh_plan, make_cached_forward,
                                 make_distributed_forward,
                                 make_export_forward, make_kernel_mean_agg,
                                 make_kernel_split_agg, make_overlap_forward,
                                 make_ref_mean_agg, make_ref_shard_mean_agg,
                                 make_ref_shard_split_agg,
                                 make_ref_split_agg, make_shard_forward,
                                 wire_row_bytes)
from ..graph.featstore import (assemble_features, check_feat_budget,
                               feat_peak_bytes, host_staging, numpy_dtype,
                               reconstruct_features)
from ..graph.sage import partition_slice
from ..kernels.segment_agg import blocks_to_device
from ..launch.mesh import make_partition_mesh, partition_world_size
from ..train.metrics import f1_scores_torch
from ..train.optim import OptState
from .compat import all_gather
from .stacking import (build_stacked_feat_store, build_stacked_halo_cache,
                       build_stacked_halo_residual,
                       build_stacked_split_vjp_blocks,
                       build_stacked_vjp_blocks, partition_arrays,
                       partition_vjp_blocks)

__all__ = ["EngineConfig", "SPMDEngine"]


@dataclass(frozen=True)
class EngineConfig:
    # stacked | spmd (the partition mesh, one torch.distributed rank per
    # partition) | auto (spmd inside a world of P ranks, else stacked) |
    # sequential (make_engine's oracle)
    mode: str = "stacked"
    # route the full-graph aggregation through the CUDA segment-mean kernels
    # (counterpart of the reference's ``use_pallas_agg``); False uses the
    # plain index_add_ aggregation
    use_kernel_agg: bool = True
    dtype: torch.dtype = torch.float32   # float dtype of graph features
    device: str = "cuda"            # raises without a card unless "cpu"
    # boundary/interior split forward: the interior aggregation and the
    # self term need no halo row, and dense compute covers owned rows only
    overlap_halo: bool = False
    # the reference's ring schedule (chunks per step, 0 = all_to_all): the
    # partition mesh's exchange runs it; stacked on one device every
    # exchange is the transpose whatever its value
    ring_chunks: int = 0
    # objective of the FULL-GRAPH phase-0 mode (the sampled path's loss is
    # the loss_fn the engine is constructed with): "ce" | "focal"
    fg_loss: str = "ce"
    # historical-embedding halo cache: eval forwards aggregate against the
    # last-received boundary embeddings and only pay the exchange on the
    # halo_refresh_every cadence; halo_cv refreshes a rotating slot chunk
    # on cached epochs (the VR-GCN control-variate delta) instead of going
    # fully stale between refreshes
    halo_cache: bool = False
    halo_refresh_every: int = 1
    halo_cv: bool = False
    # compressed communication: quantized halo exchange on the eval
    # forwards ("none" | "fp16" | "int8", error-compensated via a carried
    # send-side residual) and the phase-0 gradient reduction ("none" |
    # "bucketed" | "topk")
    halo_compress: str = "none"
    grad_compress: str = "none"
    grad_topk_frac: float = 0.01    # fraction of entries top-k ships
    grad_bucket_kb: int = 512       # bucketed reduction's slice size
    # two-tier feature store: keep the hot_frac highest-scoring owned
    # feature rows of each partition on the device; the cold rows stay in
    # pinned host memory and are staged per eval or epoch call, and every
    # forward reassembles the full plane bitwise before it runs
    feat_store: bool = False
    hot_frac: float = 0.5
    hot_policy: str = "degree"      # degree | freq (see graph/featstore.py)
    # partition-group streaming (0 = off): evaluate in groups of G <= P
    # partitions, so no (P, maxN, D) feature stack is assembled; needs
    # feat_store, stacked mode
    feat_groups: int = 0
    # feature-memory budget in MB (0 = unchecked): the engine refuses to
    # build a configuration whose closed-form peak device feature bytes
    # exceed it (FeatureBudgetError)
    feat_budget_mb: float = 0.0


def _resolve_mode(config: EngineConfig, num_parts: int,
                  device: torch.device) -> str:
    """``auto`` is the partition mesh inside an initialized
    ``torch.distributed`` world of ``num_parts`` ranks (P > 1), and stacked
    outside one or with ``feat_groups`` (the streamed eval is
    stacked-only).  The reference picks its mesh when the host has P
    devices; one process here has no mesh to pick, so the world decides (a
    deliberate difference, ROADMAP §3).  This engine runs ``sequential``
    stacked; :func:`repro_torch.engine.make_engine` builds the sequential
    oracle for that mode.  ``spmd`` resolves as asked; the engine checks
    the world when it builds the mesh."""
    mode = config.mode
    if mode == "auto":
        if (config.feat_groups or num_parts <= 1
                or partition_world_size() != num_parts):
            return "stacked"
        return "spmd"
    if mode == "sequential":
        # the oracle is a class of its own (engine.make_engine builds it);
        # this engine stays stacked under that mode, as the reference's does
        return "stacked"
    if mode not in ("stacked", "spmd"):
        raise ValueError(f"unknown engine mode {mode!r}")
    return mode


def _check_feat_groups(config: EngineConfig, num_parts: int) -> None:
    """The stacked engine's ``feat_groups`` refusals, the reference's, in
    its order (before any other check, the mode's included)."""
    if not config.feat_groups:
        return
    if not config.feat_store:
        raise ValueError(
            "feat_groups streams the feat-store cold tier over "
            "partition groups; enable feat_store to use it")
    if not 1 <= config.feat_groups <= num_parts:
        raise ValueError(
            f"feat_groups must be in [1, num_parts], got "
            f"{config.feat_groups}")
    if config.mode == "spmd":
        raise ValueError(
            "feat_groups is a host-orchestrated streaming eval over "
            "partition groups; the one-partition-per-device mesh "
            "needs all planes at once — use stacked mode")
    if (config.halo_cache or config.overlap_halo
            or config.halo_compress != "none"):
        raise ValueError(
            "feat_groups streams the eval through the plain "
            "sequential exchange; it has no cached/compressed/"
            "overlapped spelling — pick one")


def _check_config(config: EngineConfig) -> None:
    """Raise ``ValueError`` for a value or combination the reference
    refuses, in the reference's order."""
    if config.halo_compress not in HALO_COMPRESS_MODES:
        raise ValueError(f"unknown halo_compress {config.halo_compress!r} "
                         f"(expected one of {HALO_COMPRESS_MODES})")
    if config.grad_compress not in GRAD_COMPRESS_MODES:
        raise ValueError(f"unknown grad_compress {config.grad_compress!r} "
                         f"(expected one of {GRAD_COMPRESS_MODES})")
    if config.overlap_halo and config.halo_compress != "none":
        raise ValueError(
            "halo_compress quantizes the gathered send buffer on the "
            "combined-edge eval forward; the overlap forward has no "
            "compressed spelling — pick one")
    if config.overlap_halo and config.halo_cache:
        raise ValueError(
            "halo_cache and overlap_halo are alternative exchange "
            "optimisations: the cache removes the very exchange the "
            "overlap would hide — pick one")
    if config.ring_chunks < 0:
        raise ValueError(f"ring_chunks must be >= 0, got {config.ring_chunks}")


class SPMDEngine:
    """Stacked (or, with ``mode="spmd"``, partition-mesh) executor over a
    :class:`PartitionedGraph`.

    The constructor keeps the reference's argument order ``(model, loss_fn,
    optimizer, pg, hp, config)``; serving passes ``None`` for the training
    arguments, which only the epoch methods read.  Params are ``GraphSAGE``
    modules on the engine's device (shared, or per-partition for phase 1);
    the epoch methods update them in place and return them.

      phase0_epoch(params, opt_state, batches) ->
          (params, opt_state, losses (I, P), val_micro (P,), seconds)
      phase0_fullgraph_epoch(params, opt_state, iters) -> the same
      phase1_epoch(pparams, popt, batches, global_params, budgets) ->
          (pparams, popt, losses (I, P), val_micro (P,), seconds)
      phase0_epoch_async(params, opt_state, gen) -> as phase0_epoch
      phase1_epoch_async(pparams, popt, gen, budgets, global_params) ->
          (pparams, popt, losses (i_run, P), val_micro (P,), seconds)
      evaluate(params, split, per_partition_params) ->
          (micro (P,), preds (P, maxN))

    On the mesh the same calls return the same shapes on every rank:
    ``self.shards``, ``self.labels`` and ``self.masks`` hold only the
    rank's partition (no partition axis), and each call gathers its results
    at its end.

    Under ``feat_store`` the shards hold the hot tier (``fs_hot``) and its
    scatter maps instead of ``features``; the cold tier is a host tensor,
    pinned on a CUDA engine and never written after the build.  Each eval
    (and each async epoch, for the sampler's cold tier) stages it once
    with a non-blocking copy on the current stream, counted in
    ``cold_h2d_bytes`` as it is issued.
    """

    def __init__(self, model, loss_fn, optimizer, pg: PartitionedGraph,
                 hp: GPHyperParams | None = None,
                 config: EngineConfig = EngineConfig()):
        _check_feat_groups(config, pg.num_parts)
        _check_config(config)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.hp = hp if hp is not None else GPHyperParams()
        self.config = config
        self.device = resolve_device(config.device)
        self.mode = _resolve_mode(config, pg.num_parts, self.device)
        # float32 products stay full float32 on the card, as the reference's
        # XLA dots are: no TF32 for matmuls (nor for cuDNN, which this
        # engine does not call)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.num_parts = pg.num_parts
        self.num_classes = model.num_classes
        self.max_nodes = pg.max_nodes
        # the kernels read float32 masks/degrees whatever the features'
        # dtype (both hold small integers, exact in every float type)
        self._fwd_meta = {"max_nodes": pg.max_nodes, "own_cap": pg.own_cap}
        # the two-tier feature store: host->device bytes spent staging cold
        # rows (0 all-resident and at hot_frac=1.0)
        self.feat_store = bool(config.feat_store)
        self.cold_h2d_bytes = 0
        self._fs = self._cold_host = self._streamer = None
        self.last_eval_seconds = 0.0   # time of the latest evaluate() call
        self._device_sampler = None
        # compressed communication: the wire accounting's basis (real halo
        # rows per layer and the payload dtype's itemsize); the top-k
        # gradient residual is built at the first top-k step
        self.halo_compress = config.halo_compress
        self.grad_compress = config.grad_compress
        self._halo_rows_total = int(pg.n_halo.sum())
        self._halo_row_width = pg.features.shape[-1]
        self._halo_itemsize = pg.features.dtype.itemsize
        self._grad_res = None
        self.halo_cache = bool(config.halo_cache)
        self.last_halo_exchange_bytes = 0
        # fault injection: when armed, the next eval forward's refresh
        # payload is "lost in transit" — the stale cache is kept and ages on
        self._drop_next_refresh = False
        self.halo_refresh_drops = 0
        self.mesh = None
        if self.mode == "spmd":
            self._build_mesh(pg)
        else:
            self._build_stacked(pg)
        # the halo exchange's error-feedback residual (on the mesh, the
        # rank's row)
        if self.halo_compress != "none":
            self._halo_residual = self._as_state(self._rank_row(
                build_stacked_halo_residual(pg, model.layer_input_dims)))
        # the historical halo cache: its age counts eval forwards, and the
        # refresh plan is a host-side function of the age
        if self.halo_cache:
            self.max_send = pg.send_idx.shape[-1]
            # real (unpadded) rows per send-slot index, for the refreshed-
            # payload accounting; their sum is the graph's halo rows
            self._halo_slot_counts = np.asarray(pg.send_mask).sum(axis=(0, 1))
            self._halo_byte_per_slot = wire_row_bytes(
                pg.features.shape[-1], config.halo_compress,
                pg.features.dtype.itemsize)
            self._halo_state = self._as_state(self._rank_row(
                build_stacked_halo_cache(pg, model.layer_input_dims)))
            self._halo_age = 0
            self._cached_fwds: dict = {}

    def _build_stacked(self, pg: PartitionedGraph) -> None:
        """Every partition's arrays stacked on the engine's device, with
        the forwards of the configuration over them."""
        config, model = self.config, self.model
        f, dev = config.dtype, self.device
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        flt = lambda a: torch.as_tensor(np.asarray(a), dtype=f, device=dev)
        self.shards = {
            "send_idx": idx(pg.send_idx),
            "send_mask": flt(pg.send_mask),
            "recv_pos": idx(pg.recv_pos),
        }
        # the feature budget is checked before the resident plane is
        # allocated
        if self.feat_store:
            entries, self._fs = build_stacked_feat_store(
                pg, config.hot_frac, config.hot_policy, f, dev)
        check_feat_budget(config.feat_budget_mb, self._feat_peak_bytes(pg),
                          context=f"mode={self.mode}")
        if self.feat_store:
            self.shards.update(entries)
            self._cold_host = host_staging(self._fs.cold, dev)
        else:
            self.shards["features"] = flt(pg.features)
        meta = self._fwd_meta
        if config.overlap_halo:
            # the split forward's state: the per-partition interior row
            # count and ONE aggregation backend's structures
            self.shards["n_int"] = idx(pg.n_int)
            if config.use_kernel_agg:
                bi, bb = build_stacked_split_vjp_blocks(pg)
                self.shards["blk_int"] = blocks_to_device(bi, dev)
                self.shards["blk_bnd"] = blocks_to_device(bb, dev)
                aggs = make_kernel_split_agg(pg.own_cap)
            else:
                self.shards.update({
                    "int_src": idx(pg.int_src), "int_dst": idx(pg.int_dst),
                    "bnd_src": idx(pg.bnd_src), "bnd_dst": idx(pg.bnd_dst),
                    "deg": flt(pg.deg)})
                aggs = make_ref_split_agg(pg.own_cap)
            self._mean_agg = None
            self.fwd = make_overlap_forward(
                model, meta, agg_interior=aggs[0], agg_boundary=aggs[1])
        else:
            self.shards.update({"edge_src": idx(pg.edge_src),
                                "edge_dst": idx(pg.edge_dst),
                                "edge_mask": flt(pg.edge_mask)})
            if config.use_kernel_agg:
                blk = build_stacked_vjp_blocks(pg)
                self.shards["blk"] = blocks_to_device(blk, dev)
            self._mean_agg = (make_kernel_mean_agg(pg.max_nodes)
                              if config.use_kernel_agg
                              else make_ref_mean_agg(pg.max_nodes))
            self.fwd = make_distributed_forward(model, meta,
                                                agg=self._mean_agg)
            if config.halo_compress != "none":
                # the compressed eval forward; self.fwd stays uncompressed
                # (full-graph training differentiates through the live
                # exchange, and the serving export needs exact embeddings)
                self._fwd_comp = make_distributed_forward(
                    model, meta, agg=self._mean_agg,
                    compress=config.halo_compress)
        self.labels = idx(pg.labels)
        self.masks = {k: torch.as_tensor(getattr(pg, f"{k}_mask"), device=dev)
                      for k in ("train", "val", "test")}
        self._fg_loss = make_fullgraph_loss_fn(self.fwd, loss=config.fg_loss)
        if config.feat_groups:
            from .streaming import StreamedEvaluator
            self._streamer = StreamedEvaluator(
                self, blk if config.use_kernel_agg else None)

    # ------------------------------------------------- the partition mesh
    def _build_mesh(self, pg: PartitionedGraph) -> None:
        """This rank's engine on the partition mesh: the mesh of the
        initialized world (``ValueError`` outside one of P ranks), the
        partition checked against every rank's, and only partition
        ``rank``'s arrays on the rank's device, with its own forward and
        transpose blocks for the segment kernels (under ``overlap_halo``
        its rows of both split halves, each with a plan of its own, and its
        ``n_int`` as a Python int).  Under the feature store the rank holds
        its row of the stacked store: the hot tier and scatter maps on the
        device, its ``(C, D)`` cold tier on the host (pinned on a CUDA
        engine)."""
        config, model = self.config, self.model
        self.mesh = make_partition_mesh(self.num_parts, device=self.device)
        self.device = dev = self.mesh.device
        self.rank = r = self.mesh.rank
        self._check_partition_fingerprint(pg)
        f = config.dtype
        if self.feat_store:
            entries, self._fs = build_stacked_feat_store(
                pg, config.hot_frac, config.hot_policy, f, dev, part=r)
        # the fleet's closed form, as the stacked engine checks it
        check_feat_budget(config.feat_budget_mb, self._feat_peak_bytes(pg),
                          context=f"mode={self.mode}")
        a = partition_arrays(pg, r)
        idx = lambda v: torch.as_tensor(np.asarray(v).astype(np.int64),
                                        device=dev)
        flt = lambda v: torch.as_tensor(np.asarray(v), dtype=f, device=dev)
        self.shards = {"send_idx": idx(a["send_idx"]),
                       "send_mask": flt(a["send_mask"]),
                       "recv_pos": idx(a["recv_pos"])}
        if self.feat_store:
            self.shards.update(entries)
            self._cold_host = host_staging(self._fs.cold, dev)
        else:
            self.shards["features"] = flt(a["features"])
        meta, mesh, ring = self._fwd_meta, self.mesh, config.ring_chunks
        if config.overlap_halo:
            self.shards["n_int"] = int(pg.n_int[r])
            if config.use_kernel_agg:
                # the partition's rows of each half, with plans of their own
                bi, bb = build_stacked_split_vjp_blocks(pg)
                self.shards["blk_int"] = blocks_to_device(
                    partition_vjp_blocks(bi, r), dev)
                self.shards["blk_bnd"] = blocks_to_device(
                    partition_vjp_blocks(bb, r), dev)
                aggs = make_kernel_split_agg(pg.own_cap)
            else:
                self.shards.update({
                    k: idx(getattr(pg, k)[r])
                    for k in ("int_src", "int_dst", "bnd_src", "bnd_dst")})
                self.shards["deg"] = flt(pg.deg[r])
                aggs = make_ref_shard_split_agg(pg.own_cap)
            self._mean_agg = None
            self.fwd = make_shard_forward(model, meta, mesh, ring_chunks=ring,
                                          overlap=True, split_agg=aggs)
        else:
            self.shards.update({"edge_src": idx(a["edge_src"]),
                                "edge_dst": idx(a["edge_dst"]),
                                "edge_mask": flt(a["edge_mask"])})
            if config.use_kernel_agg:
                # the partition's slots of the stacked structure, with
                # plans of their own (each launch bitwise its rows of the
                # stacked one)
                self.shards["blk"] = blocks_to_device(
                    partition_vjp_blocks(build_stacked_vjp_blocks(pg), r),
                    dev)
                self._mean_agg = make_kernel_mean_agg(pg.max_nodes)
            else:
                self._mean_agg = make_ref_shard_mean_agg(pg.max_nodes)
            self.fwd = make_shard_forward(model, meta, mesh,
                                          agg=self._mean_agg,
                                          ring_chunks=ring)
            if config.halo_compress != "none":
                self._fwd_comp = make_shard_forward(
                    model, meta, mesh, agg=self._mean_agg, ring_chunks=ring,
                    compress=config.halo_compress)
        self.labels = idx(a["labels"])
        self.masks = {k: torch.as_tensor(a[f"{k}_mask"], device=dev)
                      for k in ("train", "val", "test")}
        self._fg_loss = make_fullgraph_loss_fn(self.fwd, loss=config.fg_loss)

    def _rank_row(self, arrays: dict) -> dict:
        """Stacked ``(P, ...)`` state: the rank's row on the mesh, the
        whole stack otherwise."""
        if self.mesh is None:
            return arrays
        return {k: v[self.rank] for k, v in arrays.items()}

    def _stacked(self, state: dict) -> dict:
        """The rank's rows of per-partition state gathered into the
        stacked ``(P, ...)`` layout on the mesh (ONE all_gather), as is
        otherwise."""
        if self.mesh is None:
            return state
        keys = sorted(state)
        return dict(zip(keys, all_gather([state[k] for k in keys],
                                         self.mesh)))

    def _check_partition_fingerprint(self, pg: PartitionedGraph) -> None:
        """Every rank must hold the same partition and send lists, or the
        exchanges would pair mismatched blocks (or wait forever): a hash of
        them is gathered, and every rank raises on a mismatch."""
        h = hashlib.sha256(repr((pg.num_parts, pg.max_nodes, pg.own_cap,
                                 pg.features.shape)).encode())
        for k in ("n_own", "n_halo", "send_idx", "send_mask", "recv_pos",
                  "edge_src", "edge_dst", "edge_mask", "global_ids"):
            h.update(np.ascontiguousarray(getattr(pg, k)).tobytes())
        mine = torch.tensor(np.frombuffer(h.digest()[:8], np.int64).copy(),
                            device=self.device)
        every = all_gather([mine], self.mesh)[0].reshape(-1)
        if not bool((every == every[0]).all()):
            raise ValueError(
                f"the partition differs across the mesh's ranks (rank "
                f"fingerprints {every.tolist()}): every rank must build the "
                "same graph and partition")

    def _rank_rows(self, batches: dict) -> dict:
        """This rank's ``(I, ...)`` rows of epoch batches given as the
        whole ``(I, P, ...)`` stack or as the rank's own ``(I, 1, ...)``
        rows."""
        out = {}
        for k, v in batches.items():
            if v.shape[1] not in (1, self.num_parts):
                raise ValueError(f"batches[{k!r}] has {v.shape[1]} "
                                 f"partitions, expected {self.num_parts} "
                                 "or this rank's 1")
            out[k] = v[:, self.rank if v.shape[1] > 1 else 0]
        return out

    def rank_batches(self, host: dict) -> dict:
        """The host batches this engine moves to its device: on the mesh
        the rank's ``(I, 1, ...)`` rows of the ``(I, P, ...)`` stack, and
        the whole stack otherwise."""
        if self.mesh is None:
            return host
        return {k: v[:, self.rank:self.rank + 1] for k, v in host.items()}

    def _per_partition(self, losses: torch.Tensor) -> torch.Tensor:
        """An epoch's losses as ``(I, P)``: on the mesh the ranks' ``(I,)``
        gathered (one collective at the call's end)."""
        if self.mesh is None:
            return losses
        return all_gather([losses], self.mesh)[0].T

    def _phase1_mesh(self, pparams, popt, global_params, budgets,
                     iters: int, rank_batches):
        """Phase 1 on the mesh: the rank trains its own row of ``pparams``
        (no cross-rank traffic) with the stacked phase-1 step over a
        partition axis of 1 on the ``iters`` batches ``rank_batches()``
        yields (its ``(1, ...)`` rows, made inside the timed run), while
        the iteration is below its budget; then ONE all_gather brings every
        rank's params, optimizer state and losses back into the
        per-partition form, written into ``pparams`` in place."""
        r = self.rank
        bud = self._as_budgets(budgets, iters)[r:r + 1]
        step = make_personalize_step(self.loss_fn, self.optimizer, self.hp)

        def run():
            p = partition_slice(pparams, r)
            o = OptState(step=popt.step[r:r + 1],
                         mu=[m[r:r + 1] for m in popt.mu],
                         nu=[v[r:r + 1] for v in popt.nu])
            losses = []
            for i, batch in enumerate(rank_batches()):
                p, o, l = step(p, o, batch, global_params, i < bud)
                losses.append(l)
            return p, o, torch.stack(losses)

        (p, o, losses), dt = self._timed(run)
        n = len(o.mu)
        every = [t[:, 0] for t in all_gather(
            [*p.parameters(), o.step, *o.mu, *o.nu, losses.T], self.mesh)]
        with torch.no_grad():
            for w, g in zip(pparams.parameters(), every):
                w.copy_(g)
        k = len(list(pparams.parameters()))
        popt = OptState(step=every[k], mu=every[k + 1:k + 1 + n],
                        nu=every[k + 1 + n:k + 1 + 2 * n])
        return pparams, popt, every[-1].T, dt

    @torch.no_grad()
    def _eval_mesh(self, params, split: str):
        """This rank's eval forward (its row of per-partition params, or the
        shared ones; against the cache, quantized or overlapped as the
        configuration says, :meth:`_eval_forward`) and micro-F1, then ONE
        all_gather of ``(micro, preds)``: ``((P,), (P, maxN))`` on every
        rank."""
        if params.num_parts is not None:
            params = partition_slice(params, self.rank)
        preds = torch.argmax(self._eval_forward(params, self._featurized()),
                             dim=-1)
        lab = torch.where(self.masks[split], self.labels, -1)
        micro = f1_scores_torch(preds, lab, self.num_classes)[0]
        micro, preds = all_gather([micro, preds], self.mesh)
        return micro, preds

    def _export_mesh(self, params) -> dict:
        """The export forward of this rank's partition, then ONE all_gather
        into the stacked handoff's ``(P, ...)`` layout.  Under the feature
        store the plane is assembled from both tiers, the cold one copied
        as a handoff, not counted in ``cold_h2d_bytes``."""
        fwd_e = make_shard_forward(self.model, self._fwd_meta, self.mesh,
                                   agg=self._mean_agg,
                                   ring_chunks=self.config.ring_chunks,
                                   export=True)
        out = fwd_e(params, self._featurized(counted=False))
        if self.halo_cache:
            # the snapshot is exactly a full refresh: the rank's row of it
            # becomes the rank's cache
            self._halo_state = {k: v.to(self.config.dtype).clone()
                                for k, v in out["cache"].items()}
        L = len(out["layers"])
        every = all_gather([*out["layers"], out["logits"],
                            *(out["cache"][f"h{i}"] for i in range(L))],
                           self.mesh)
        return {"layers": tuple(every[:L]), "logits": every[L],
                "cache": {f"h{i}": every[L + 1 + i] for i in range(L)}}

    # ------------------------------------------- two-tier feature store
    def _feat_peak_bytes(self, pg: PartitionedGraph) -> int:
        d = pg.features.shape[-1]
        b = numpy_dtype(self.config.dtype).itemsize
        if not self.feat_store:
            return feat_peak_bytes(self.num_parts, pg.max_nodes, d, b)
        # the store's tiers are (P, H, D) stacked, (H, D) on a mesh rank
        return feat_peak_bytes(
            self.num_parts, pg.max_nodes, d, b,
            hot_rows=self._fs.hot.shape[-2], cold_rows=self._fs.cold.shape[-2],
            groups=self.config.feat_groups)

    def _stage(self, host: torch.Tensor, fleet: bool = False) -> torch.Tensor:
        """``host`` (a cold tier, pinned on a CUDA engine) copied to the
        device with a non-blocking copy on the current stream, its bytes
        counted in ``cold_h2d_bytes`` as the copy is issued.  ``fleet``
        marks a per-partition tier: on the mesh every rank stages its own,
        so the count is the fleet's, P times the rank's bytes (every
        partition's tier has the same shape)."""
        n = host.numel() * host.element_size()
        if fleet and self.mesh is not None:
            n *= self.num_parts
        self.cold_h2d_bytes += n
        return host.to(self.device, non_blocking=True)

    def _featurized(self, counted: bool = True) -> dict:
        """The shards a forward reads: ``self.shards`` all-resident; under
        the store, the same tensors with the ``features`` plane assembled
        from the hot tier and the cold tier staged now (bitwise the resident
        plane, graph/featstore.py's invariant), counted in
        ``cold_h2d_bytes`` unless ``counted`` is False."""
        if not self.feat_store:
            return self.shards
        cold = (self._stage(self._cold_host, fleet=True) if counted
                else self._cold_host.to(self.device))
        s = {k: v for k, v in self.shards.items() if not k.startswith("fs_")}
        s["features"] = assemble_features(
            self.shards["fs_hot"], self.shards["fs_rows_hot"], cold,
            self.shards["fs_rows_cold"], self.max_nodes)
        return s

    def _batcher(self, ds, gen: torch.Generator, rows=None):
        """``(nodes, valid) -> batch`` for one epoch call of the device
        sampler ``ds``; under the store its gather table ``[hot | cold]`` is
        built here, once per call, from its cold tier staged now (one table
        for every partition, so counted once, on the mesh too).  ``rows``
        cuts each batch to a mesh rank's row after the fanouts
        (:meth:`DeviceEpochSampler.make_batch`)."""
        kw = {} if rows is None else {"rows": rows}
        if self.feat_store:
            kw["table"] = ds.feature_table(self._stage(ds.cold_host))
        return lambda n, v: ds.make_batch(gen, n, v, **kw)

    @property
    def resident_feature_bytes(self) -> int:
        """Device-resident feature bytes: the stacked plane (or the hot
        tier) plus the attached device sampler's gather table (or its hot
        tier), the footprint the feature store shrinks.  On the mesh, the
        fleet's: every rank holds one partition's plane."""
        f = self.shards["fs_hot" if self.feat_store else "features"]
        total = f.numel() * f.element_size()
        if self.mesh is not None:
            total *= self.num_parts
        ds = self._device_sampler
        if ds is not None:
            t = ds.features if ds.features is not None else ds.hot_feats
            total += t.numel() * t.element_size()
        return total

    # ------------------------------------------------------------ plumbing
    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        if self.mesh is not None:
            # a collective step goes at its slowest rank's pace
            t = torch.tensor(dt, dtype=torch.float64, device=self.device)
            dt = float(all_gather([t], self.mesh)[0].max())
        return out, dt

    def _run_steps(self, step, params, opt_state, batches_per_iter):
        losses = []
        for batch in batches_per_iter:
            if self.grad_compress == "topk":
                params, opt_state, l, self._grad_res = step(
                    params, opt_state, batch, self._grad_residual(params))
            else:
                params, opt_state, l = step(params, opt_state, batch)
            losses.append(l)
        return params, opt_state, torch.stack(losses)

    def _generalize_step(self, loss_fn, gather_sum: bool = False,
                         full_graph: bool = False):
        """The phase-0 step of ``grad_compress``: the gradient of the mean
        of the P losses (``none``), or the bucketed or top-k reducer over
        the P per-partition gradients (the top-k step also carries the
        residual); on the mesh, the rank's loss and the gradients'
        ``pmean``, or with ``gather_sum`` (the async epoch) their
        ``all_gather`` summed in partition order, or the per-shard
        bucketed or top-k reducer (on every path, as in the reference; a
        sampled batch meets the per-partition weights with a partition
        axis of 1, the full-graph shard as it is)."""
        cfg = self.config
        if self.mesh is not None:
            reduce = None
            if self.grad_compress == "bucketed":
                reduce = make_bucketed_reduce_shard(
                    self.num_parts, self.mesh, cfg.grad_bucket_kb * 1024)
            elif self.grad_compress == "topk":
                reduce = make_topk_reduce_shard(self.num_parts, self.mesh,
                                                cfg.grad_topk_frac)
            lift = ((lambda b: b) if full_graph else
                    (lambda b: {k: v[None] for k, v in b.items()}))
            return make_mesh_generalize_step(
                loss_fn, self.optimizer, self.mesh, gather_sum=gather_sum,
                reduce=reduce, topk=self.grad_compress == "topk", lift=lift)
        if self.grad_compress == "none":
            return make_generalize_step(loss_fn, self.optimizer)
        reduce = make_grad_reduce_stacked(
            self.grad_compress, self.num_parts, cfg.grad_topk_frac,
            cfg.grad_bucket_kb)
        return make_reduce_generalize_step(loss_fn, self.optimizer,
                                           self.num_parts, reduce,
                                           topk=self.grad_compress == "topk")

    # ------------------------------------------ historical halo cache state
    # The cache ages once per eval forward (standalone evaluate, or the
    # async phase-0 epoch's validation forward); the refresh slot range is
    # a host-side constant from halo_refresh_plan, and each range gets its
    # own forward, the empty one exchanging nothing.

    def _halo_plan(self) -> tuple[int, int]:
        if self._drop_next_refresh:
            self._drop_next_refresh = False
            self.halo_refresh_drops += 1
            return (0, 0)
        return halo_refresh_plan(self._halo_age, self.config.halo_refresh_every,
                                 self.config.halo_cv, self.max_send)

    def _halo_slot_bytes(self, lo: int, hi: int) -> int:
        return (int(self._halo_slot_counts[lo:hi].sum())
                * self._halo_byte_per_slot)

    def _halo_tick(self, plan: tuple[int, int], new_state: dict) -> None:
        self._halo_state = new_state
        # one exchange per SAGE layer, each shipping only the refreshed slots
        self.last_halo_exchange_bytes = (self.model.num_layers
                                         * self._halo_slot_bytes(*plan))
        self._halo_age += 1

    def drop_next_halo_refresh(self) -> None:
        """Arm the dropped-payload fault: the next eval forward runs the
        pure-cached plan (0, 0) — it aggregates fully against the stale
        cache and ships no refresh bytes, exactly as if the scheduled
        payload was lost in transit — while the cache still ages."""
        self._drop_next_refresh = True

    def _cached_fwd(self, lo: int, hi: int):
        key = (lo, hi)
        if key not in self._cached_fwds:
            if self.mesh is not None:
                self._cached_fwds[key] = make_shard_forward(
                    self.model, self._fwd_meta, self.mesh,
                    agg=self._mean_agg, ring_chunks=self.config.ring_chunks,
                    compress=self.halo_compress, refresh=key)
            else:
                self._cached_fwds[key] = make_cached_forward(
                    self.model, self._fwd_meta, agg=self._mean_agg,
                    refresh_lo=lo, refresh_hi=hi,
                    compress=self.halo_compress)
        return self._cached_fwds[key]

    # ---- checkpoint surface (the files themselves: ROADMAP item 12) ------
    # The stacked layout on the mesh too: saving gathers the ranks' rows
    # (a collective every rank makes), restoring takes the rank's row, so
    # rank 0's archive is a stacked run's.
    def halo_cache_state(self):
        """(cache dict, age) for checkpointing; None without the cache."""
        if not self.halo_cache:
            return None
        return self._stacked(self._halo_state), self._halo_age

    def restore_halo_cache_state(self, state: dict, age: int) -> None:
        if not self.halo_cache:
            raise ValueError("engine built without halo_cache")
        self._halo_state = self._as_state(self._rank_row(state))
        self._halo_age = int(age)

    def comm_state_like(self, params) -> dict:
        """What a resume loads the ``halo``, ``halo_res`` and ``grad_res``
        checkpoint entries into (those this engine carries): its state, or
        on the mesh templates of the stacked layout (shapes, dtype and
        device; no collective)."""
        out = {}
        if self.halo_cache:
            out["halo"] = self._halo_state
        if self.halo_compress != "none":
            out["halo_res"] = self._halo_residual
        if self.grad_compress == "topk":
            out["grad_res"] = (self._grad_res if self._grad_res is not None
                               else self._zero_grad_residual(params))
        if self.mesh is None:
            return out
        like = lambda t: torch.empty((self.num_parts, *t.shape),
                                     dtype=t.dtype, device=t.device)
        return {k: like(v) if isinstance(v, torch.Tensor)
                else {n: like(t) for n, t in v.items()}
                for k, v in out.items()}

    def _as_state(self, arrays: dict) -> dict:
        """Arrays (NumPy or tensors) as state tensors of the engine's
        dtype on its device."""
        return {k: torch.as_tensor(v).to(self.device, self.config.dtype)
                for k, v in arrays.items()}

    # -------------------------------------- compressed communication state
    @property
    def halo_wire_bytes_per_layer(self) -> int:
        """Real payload bytes ONE layer's halo exchange puts on the wire
        under the configured compression.  Equals
        ``pg.halo_bytes_per_layer`` when ``halo_compress == "none"``."""
        return self._halo_rows_total * wire_row_bytes(
            self._halo_row_width, self.halo_compress, self._halo_itemsize)

    def _grad_residual(self, params) -> torch.Tensor:
        """The ``(P, N)`` top-k error-feedback state over the flat
        per-partition gradient (``parameters()`` order), zero before the
        first compressed sync; on the mesh the rank's ``(N,)`` row."""
        if self._grad_res is None:
            self._grad_res = self._zero_grad_residual(params)
        return self._grad_res

    def _zero_grad_residual(self, params) -> torch.Tensor:
        n = sum(w.numel() for w in params.parameters())
        w0 = next(params.parameters())
        shape = (n,) if self.mesh is not None else (self.num_parts, n)
        return torch.zeros(shape, dtype=w0.dtype, device=w0.device)

    def comm_residual_state(self):
        """Error-feedback residuals for checkpointing: ``(halo_residual,
        grad_residual)`` in the stacked layout; each entry is None when the
        matching compression is off (or, for top-k, before the first
        phase-0 step).  None when neither exists."""
        h = self._halo_residual if self.halo_compress != "none" else None
        g = self._grad_res if self.grad_compress == "topk" else None
        if h is None and g is None:
            return None
        if self.mesh is not None:
            h = None if h is None else self._stacked(h)
            g = None if g is None else all_gather([g], self.mesh)[0]
        return h, g

    def restore_comm_residual_state(self, state) -> None:
        h, g = state
        if h is not None:
            self._halo_residual = self._as_state(self._rank_row(h))
        if g is not None:
            g = torch.as_tensor(g)
            if self.mesh is not None:
                g = g[self.rank]
            self._grad_res = g.to(self.device)

    # ------------------------------------------------------- public surface
    def phase0_epoch(self, params, opt_state, batches: dict):
        """One sampled generalization epoch: ``batches`` holds ``(I, P,
        ...)`` tensors on the engine's device; each iteration descends the
        mean of the P partitions' losses (the cross-partition gradient
        mean), then the validation forward runs."""
        step = self._generalize_step(self.loss_fn)
        if self.mesh is not None:
            batches = self._rank_rows(batches)
        iters = next(iter(batches.values())).shape[0]
        per_iter = ({k: v[i] for k, v in batches.items()}
                    for i in range(iters))
        (params, opt_state, losses), dt = self._timed(
            self._run_steps, step, params, opt_state, per_iter)
        losses = self._per_partition(losses)
        val_micro, _ = self.evaluate(params, "val", per_partition_params=False)
        return params, opt_state, losses, val_micro, dt

    def phase0_fullgraph_epoch(self, params, opt_state, iters: int = 1):
        """Full-graph phase-0 epoch: ``iters`` full-batch steps whose
        gradient runs straight through the distributed forward — per-layer
        halo exchange, both aggregation kernels (forward, and backward from
        layer 2 on) and the cross-partition gradient mean.  The centralized
        (P=1) configuration is the paper's Table IV baseline at full-graph
        scale.  ``grad_compress="bucketed"`` reduces through the bucketed
        mean; the feature store, the historical halo cache and top-k are
        refused, as the reference refuses them."""
        if self.feat_store:
            raise ValueError(
                "full-graph training differentiates through the resident "
                "feature stack on every iteration; the feature store "
                "serves features per compiled call — run full_graph_train "
                "all-resident")
        if self.halo_cache:
            raise ValueError(
                "halo_cache is an eval-forward optimisation; full-graph "
                "training differentiates through the live halo exchange "
                "and cannot train against stale cached embeddings")
        if self.grad_compress == "topk":
            raise ValueError(
                "top-k gradient sparsification is a sampled phase-0 feature; "
                "full-graph training keeps the exact (or bucketed) all-reduce")
        step = self._generalize_step(self._fg_loss, full_graph=True)
        batch = {"shard": self.shards, "labels": self.labels,
                 "train_mask": self.masks["train"]}
        (params, opt_state, losses), dt = self._timed(
            self._run_steps, step, params, opt_state, [batch] * iters)
        losses = self._per_partition(losses)
        val_micro, _ = self.evaluate(params, "val", per_partition_params=False)
        return params, opt_state, losses, val_micro, dt

    def _as_budgets(self, active_or_budgets, iters: int) -> torch.Tensor:
        """Phase-1 gating as per-partition iteration BUDGETS; a bool
        ``active`` vector means full-epoch-or-zero."""
        b = torch.as_tensor(np.asarray(active_or_budgets), device=self.device)
        if b.dtype == torch.bool:
            b = torch.where(b, iters, 0)
        return b.to(torch.int32)

    def phase1_epoch(self, pparams, popt, batches: dict, global_params,
                     budgets):
        """One personalization epoch over per-partition params: partition p
        trains while the iteration index is below ``budgets[p]`` and rides
        through bitwise frozen afterwards.  On the mesh each rank trains
        its own partition (``_phase1_mesh``)."""
        if self.mesh is not None:
            rows = {k: v[:, None] for k, v in self._rank_rows(batches).items()}
            iters = next(iter(rows.values())).shape[0]
            pparams, popt, losses, dt = self._phase1_mesh(
                pparams, popt, global_params, budgets, iters,
                lambda: ({k: v[i] for k, v in rows.items()}
                         for i in range(iters)))
            val_micro, _ = self.evaluate(pparams, "val",
                                         per_partition_params=True)
            return pparams, popt, losses, val_micro, dt
        step = make_personalize_step(self.loss_fn, self.optimizer, self.hp)
        iters = next(iter(batches.values())).shape[0]
        budgets = self._as_budgets(budgets, iters)

        def run():
            pp, po, losses = pparams, popt, []
            for i in range(iters):
                pp, po, l = step(pp, po, {k: v[i] for k, v in batches.items()},
                                 global_params, i < budgets)
                losses.append(l)
            return pp, po, torch.stack(losses)

        (pparams, popt, losses), dt = self._timed(run)
        val_micro, _ = self.evaluate(pparams, "val", per_partition_params=True)
        return pparams, popt, losses, val_micro, dt

    # ----------------------------------------------- async personalization
    def set_device_sampler(self, sampler) -> None:
        """Attach a :class:`~repro_torch.core.sampler.DeviceEpochSampler`;
        required by :meth:`phase0_epoch_async` and
        :meth:`phase1_epoch_async`.  The sampler must be built with the
        feature store exactly when the engine is.  On the mesh every rank
        attaches the same sampler (all P partitions' state)."""
        if self.feat_store != (getattr(sampler, "cold_host", None)
                               is not None):
            raise ValueError(
                "feat-store mismatch: the engine and its device sampler "
                "must agree — build the sampler with feat_store matching "
                "EngineConfig.feat_store")
        self._device_sampler = sampler

    def _sampler(self, method: str):
        if self._device_sampler is None:
            raise ValueError(f"{method} needs set_device_sampler()")
        return self._device_sampler

    def phase0_epoch_async(self, params, opt_state, gen: torch.Generator):
        """One generalization epoch drawn on the device: the epoch draw
        (a uniform shuffle of each local train set, or the CBS mini-epoch
        when the sampler is class-balanced), then per iteration the batch's
        fanout and feature gather and one step on the mean of the P losses,
        then the validation forward.  ``gen`` is a ``torch.Generator`` on
        the engine's device, seeded by the caller for the epoch.  Every
        partition runs all ``num_batches`` iterations (synchronous
        data-parallel SGD).  The returned seconds INCLUDE the validation
        forward, and ``last_eval_seconds`` is 0, as in the reference.  The
        carried state advances in the reference's order: the top-k residual
        through the steps, then the halo cache and the halo residual
        through the validation forward.  Under the feature store the call
        stages the sampler's cold tier once (the batch gathers) and the
        engine's once (the validation forward).

        On the mesh the rank draws the whole epoch and both fanouts of
        every batch, gathers its own row (``rows=rank``), means the
        gradients as the reference's fused program does (``all_gather``,
        then a partition-order sum, ``/ P``) and runs the validation
        forward on its partition; the losses come back ``(I, P)``."""
        ds = self._sampler("phase0_epoch_async")
        if self.config.feat_groups:
            raise ValueError(
                "feat_groups streams the eval forward on the host; the "
                "fused async epoch is one device program — run the host-"
                "batch phase-0 path (async_generalize=False) when streaming")
        step = self._generalize_step(self.loss_fn, gather_sum=True)
        rows = None if self.mesh is None else self.rank

        def run():
            batch = self._batcher(ds, gen, rows)
            nodes, valid = ds.draw_epoch(gen)                # (P, I, B)
            batches = (batch(nodes[:, i], valid[:, i])
                       for i in range(ds.num_batches))
            p, o, losses = self._run_steps(step, params, opt_state, batches)
            micro, _ = self._eval(p, "val")
            return p, o, losses, micro

        (params, opt_state, losses, val_micro), dt = self._timed(run)
        self.last_eval_seconds = 0.0
        return params, opt_state, self._per_partition(losses), val_micro, dt

    def phase1_epoch_async(self, pparams, popt, gen: torch.Generator,
                           budgets, global_params):
        """One personalization epoch drawn on the device: the mini-epoch
        draw, then per iteration the batch's fanout and feature gather and
        one per-partition step, partition p active while the iteration is
        below ``budgets[p]`` (host ints from
        ``GPController.phase1_budgets``) and bitwise frozen after.  The
        loop runs ``i_run`` iterations: max(budgets) rounded up to a power
        of two, capped at ``num_batches`` (the reference's rule, which fixes
        the shape of ``losses``, ``(i_run, P)``).  Under the feature store
        the call stages the sampler's cold tier once; the validation
        ``evaluate`` stages the engine's.  On the mesh every rank draws the
        whole epoch and trains its own row over ``i_run`` iterations with
        its own budget (``_phase1_mesh``: no collective until the epoch's
        end)."""
        ds = self._sampler("phase1_epoch_async")
        cap = ds.num_batches
        budgets = np.asarray(budgets)
        need = int(budgets.max())
        i_run = 1
        while i_run < min(need, cap):
            i_run *= 2
        i_run = min(i_run, cap)
        if self.mesh is not None:
            r = self.rank

            def rank_batches():
                batch = self._batcher(ds, gen, slice(r, r + 1))
                nodes, valid = ds.draw_epoch(gen)
                return (batch(nodes[:, i], valid[:, i]) for i in range(i_run))

            pparams, popt, losses, dt = self._phase1_mesh(
                pparams, popt, global_params, budgets.astype(np.int32),
                i_run, rank_batches)
            val_micro, _ = self.evaluate(pparams, "val",
                                         per_partition_params=True)
            return pparams, popt, losses, val_micro, dt
        budgets = torch.as_tensor(budgets.astype(np.int32), device=self.device)
        step = make_personalize_step(self.loss_fn, self.optimizer, self.hp)

        def run():
            pp, po, losses = pparams, popt, []
            batch = self._batcher(ds, gen)
            nodes, valid = ds.draw_epoch(gen)
            for i in range(i_run):
                pp, po, l = step(pp, po, batch(nodes[:, i], valid[:, i]),
                                 global_params, i < budgets)
                losses.append(l)
            return pp, po, torch.stack(losses)

        (pparams, popt, losses), dt = self._timed(run)
        val_micro, _ = self.evaluate(pparams, "val", per_partition_params=True)
        return pparams, popt, losses, val_micro, dt

    def _eval_forward(self, params, shards: dict) -> torch.Tensor:
        """The eval forward of this configuration over ``shards`` (with the
        feature plane): against the halo cache (which ages, and under
        ``halo_compress`` carries the residual too), the quantized
        exchange, or the plain synchronous (or overlapped) one."""
        comp = self.halo_compress != "none"
        if self.halo_cache:
            plan = self._halo_plan()
            fwd = self._cached_fwd(*plan)
            if comp:
                logits, new_state, self._halo_residual = fwd(
                    params, shards, self._halo_state,
                    self._halo_residual)
            else:
                logits, new_state = fwd(params, shards, self._halo_state)
            self._halo_tick(plan, new_state)
            return logits
        if comp:
            logits, self._halo_residual = self._fwd_comp(
                params, shards, self._halo_residual)
            self.last_halo_exchange_bytes = (self.model.num_layers
                                             * self.halo_wire_bytes_per_layer)
            return logits
        return self.fwd(params, shards)

    def _micro(self, preds: torch.Tensor, split: str) -> torch.Tensor:
        """Each partition's micro-F1 of ``preds`` (P, maxN) on ``split``."""
        mask = self.masks[split]
        return torch.stack([
            f1_scores_torch(preds[p], torch.where(mask[p], self.labels[p], -1),
                            self.num_classes)[0]
            for p in range(self.num_parts)])

    @torch.no_grad()
    def _eval(self, params, split: str):
        if self.mesh is not None:
            return self._eval_mesh(params, split)
        logits = self._eval_forward(params, self._featurized())
        preds = torch.argmax(logits, dim=-1)
        return self._micro(preds, split), preds

    def evaluate(self, params, split: str = "test",
                 per_partition_params: bool = True):
        """The full-graph forward over all partitions (halo exchange + the
        aggregation kernel) and each partition's micro-F1 on ``split``:
        ``(micro (P,), preds (P, maxN))``.  ``params`` is per-partition
        (each partition's rows, and the halo rows it sends, computed under
        its own weights) when ``per_partition_params``, else shared.  Under
        ``halo_cache`` every call ages the cache and refreshes the slots
        :func:`halo_refresh_plan` picks; under ``halo_compress`` the
        exchange is quantized with the carried residual.  Under the feature
        store the call stages the cold tier once (P·C·D·B bytes), or, with
        ``feat_groups``, runs the streamed eval, which stages each
        partition's cold rows twice."""
        if per_partition_params != (params.num_parts is not None):
            raise ValueError(
                f"per_partition_params={per_partition_params} but params "
                f"are in the {'shared' if params.num_parts is None else 'per-partition'} form")
        if self._streamer is not None:
            out, self.last_eval_seconds = self._timed(
                self._streamer.evaluate, params, split, per_partition_params)
        else:
            out, self.last_eval_seconds = self._timed(self._eval, params,
                                                      split)
        return out

    @torch.no_grad()
    def export_serving_state(self, params) -> dict:
        """One full forward materializing the serving handoff:
        ``{"layers": [(P, maxN, D_i) per layer], "logits": (P, maxN, C),
        "cache": {"h{i}": (P, P, maxS, D_i)}}``.  The reference returns
        host numpy arrays; here they stay tensors on the engine's device,
        where the serving engine keeps its stores.  ``params`` is a
        ``GraphSAGE`` on that device (global, replicated weights).  Under
        ``halo_cache`` the snapshot also becomes the cache (a full
        refresh).  The overlapped forward never materialises the
        post-exchange layer inputs, so an ``overlap_halo`` engine
        raises.  Under the feature store the export forward reads the plane
        reconstructed on the host from both tiers, copied once (a handoff,
        not counted in ``cold_h2d_bytes``)."""
        if self.config.overlap_halo:
            raise ValueError(
                "export_serving_state needs the combined-edge forward; "
                "build the engine without overlap_halo")
        if self.mesh is not None:
            return self._export_mesh(params)
        shards = self.shards
        if self.feat_store:
            shards = {k: v for k, v in self.shards.items()
                      if not k.startswith("fs_")}
            shards["features"] = torch.as_tensor(reconstruct_features(
                self._fs, self.max_nodes)).to(self.device)
        fwd_e = make_export_forward(self.model, self._fwd_meta,
                                    agg=self._mean_agg)
        out = fwd_e(params, shards)
        if self.halo_cache:
            # the snapshot is exactly a full refresh: hand it to the cache
            self._halo_state = {k: v.to(self.config.dtype).clone()
                                for k, v in out["cache"].items()}
        return out

"""The sequential reference — the parity oracle for the stacked engine
(counterpart of ``repro/engine/sequential.py``).

It runs the math of :class:`repro_torch.engine.SPMDEngine` as legible
Python loops over partitions: per-partition gradients in a loop, the
all-reduce as a stack-and-sum divided by P, the halo exchange as explicit
gather / transpose / scatter, and phase 1 one partition at a time through
``make_personalize_partition_step``.  It aggregates with the plain ops
(:func:`~repro_torch.graph.distributed.make_ref_mean_agg`, or
:func:`~repro_torch.graph.distributed.make_ref_split_agg` under
``overlap_halo``) whatever ``use_kernel_agg`` says, exactly as the
reference's oracle does, so the stacked engine with its kernels can be
held against an independent path; it runs on the device it is given
(``cuda`` by default).

Differences from the stacked engine that the parity tests hold to
tolerances: the stacked step differentiates the mean of the P losses, this
one sums the P gradients and divides by P; the per-partition products and
sums run in other shapes.  Given one ``torch.Generator`` state the async
epochs draw exactly the batches the stacked engine draws: one
``draw_epoch`` and, per iteration, one ``make_batch`` over all P
partitions, in the engine's order; only the steps run one partition at a
time.  The communication options follow the reference's oracle: the
halo cache as per-partition recv buffers landed and refreshed partition
by partition, the quantized exchange with a per-sender residual (the
sender dequantizes before the transpose, which models the wire exactly:
dequantization is elementwise), and the bucketed and top-k reducers over
the stacked per-partition gradients.  Like the reference's oracle it is
the all-resident oracle the feature-store engine is held against, so it
refuses ``feat_store`` (``feat_groups`` without the store is ignored, as
there); its async epochs accept a feature-store sampler, whose cold tier
they copy to the device once per epoch call.  The reference's checkpoint
files belong to ROADMAP item 12.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.gp.trainer import (GPHyperParams, _assign,
                               make_grad_reduce_stacked,
                               make_personalize_partition_step)
from ..device import resolve_device
from ..graph.distributed import (PartitionedGraph, dequantize_rows,
                                 halo_refresh_plan, make_ref_mean_agg,
                                 make_ref_split_agg, quantize_rows,
                                 wire_row_bytes)
from ..graph.sage import take_partition
from ..train.losses import cross_entropy_loss, focal_loss
from ..train.metrics import f1_scores_torch
from ..train.optim import OptState, apply_updates
from .spmd import EngineConfig, _check_config

__all__ = ["SequentialReference"]


def _split_state(state: OptState, p: int) -> OptState:
    return OptState(step=state.step[p], mu=[m[p] for m in state.mu],
                    nu=[v[p] for v in state.nu])


def _stack_states(states: list[OptState]) -> OptState:
    return OptState(step=torch.stack([s.step for s in states]),
                    mu=[torch.stack(ms) for ms in zip(*(s.mu for s in states))],
                    nu=[torch.stack(vs) for vs in zip(*(s.nu for s in states))])


@torch.no_grad()
def _write_back(pparams, parts: list) -> None:
    """Copy each partition's shared-form params into row p of the
    per-partition ``pparams``."""
    for p, part in enumerate(parts):
        for w, v in zip(pparams.parameters(), part.parameters()):
            w[p].copy_(v)


class SequentialReference:
    """Same public surface as :class:`~repro_torch.engine.SPMDEngine`
    (``phase0_epoch``, ``phase0_fullgraph_epoch``, ``phase1_epoch``, the
    async epochs, ``evaluate``), Python-loop execution.  Epoch methods
    update the params module in place and return it, as the stacked
    engine's do."""

    mode = "sequential"

    def __init__(self, model, loss_fn, optimizer, pg: PartitionedGraph,
                 hp: GPHyperParams | None = None, config=None):
        config = config if config is not None else EngineConfig(
            mode="sequential")
        # the stacked engine's option rules, then the reference oracle's own
        _check_config(config)
        if config.feat_store:
            raise ValueError(
                "SequentialReference IS the all-resident oracle the "
                "feat-store engine is locked against; build it without "
                "feat_store (a feat-store DeviceEpochSampler is still "
                "accepted — its gather is bitwise the resident one)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.hp = hp if hp is not None else GPHyperParams()
        self.config = config
        self.device = resolve_device(config.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.num_parts = P = pg.num_parts
        self.num_classes = model.num_classes
        self.max_nodes = pg.max_nodes
        self.own_cap = pg.own_cap
        self.overlap = bool(config.overlap_halo)
        self._fg_loss_kind = config.fg_loss

        f, dev = config.dtype, self.device
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        flt = lambda a: torch.as_tensor(np.asarray(a), dtype=f, device=dev)
        self.features = flt(pg.features)                 # (P, maxN, D)
        self.send_idx = idx(pg.send_idx)
        self.send_mask = flt(pg.send_mask)
        self.recv_pos = idx(pg.recv_pos)
        self.labels = idx(pg.labels)
        self.masks = {k: torch.as_tensor(getattr(pg, f"{k}_mask"), device=dev)
                      for k in ("train", "val", "test")}
        # per-partition edge views for whichever forward this config runs:
        # the combined-edge aggregation, or (overlap) the destination-
        # disjoint CSR shards with the static degree and interior counts;
        # each keeps a leading partition axis of 1, the stacked
        # aggregations' (P, ...) form, and one partition's rows are passed
        # as h[None]
        self.n_int = [int(n) for n in pg.n_int]
        if self.overlap:
            self._agg_int, self._agg_bnd = make_ref_split_agg(pg.own_cap)
            self._split_shards = [
                {k: (flt if k == "deg" else idx)(getattr(pg, k)[p:p + 1])
                 for k in ("int_src", "int_dst", "bnd_src", "bnd_dst", "deg")}
                for p in range(P)]
        else:
            self._agg = make_ref_mean_agg(pg.max_nodes)
            self._edge_shards = [
                {k: (flt if k == "edge_mask" else idx)(getattr(pg, k)[p:p + 1])
                 for k in ("edge_src", "edge_dst", "edge_mask")}
                for p in range(P)]
        self._pstep1 = make_personalize_partition_step(loss_fn, optimizer,
                                                       self.hp)
        self._device_sampler = None
        self.last_eval_seconds = 0.0   # time of the latest _eval
        # all-resident: no eval of the oracle stages cold rows
        self.cold_h2d_bytes = 0

        # compressed communication and the historical halo cache, mirrored
        # from the engine: per-partition (P, maxS, d) buffers, one list per
        # layer — the legible rendering of the engine's stacked state
        self.halo_compress = config.halo_compress
        self.grad_compress = config.grad_compress
        self._reduce = make_grad_reduce_stacked(
            config.grad_compress, P, config.grad_topk_frac,
            config.grad_bucket_kb)
        self._grad_res = None   # lazy (P, N) top-k error-feedback state
        self._halo_rows_total = int(pg.n_halo.sum())
        self._halo_row_width = pg.features.shape[-1]
        self._halo_itemsize = pg.features.dtype.itemsize
        self.max_send = pg.send_idx.shape[-1]
        zeros = lambda prefix: {
            f"{prefix}{i}": [torch.zeros((P, self.max_send, d), dtype=f,
                                         device=dev) for _ in range(P)]
            for i, d in enumerate(model.layer_input_dims)}
        if self.halo_compress != "none":
            self._halo_residual = zeros("r")
        self.halo_cache = bool(config.halo_cache)
        self.last_halo_exchange_bytes = 0
        if self.halo_cache:
            self.halo_refresh_every = int(config.halo_refresh_every)
            self.halo_cv = bool(config.halo_cv)
            self._halo_slot_counts = np.asarray(pg.send_mask).sum(axis=(0, 1))
            self._halo_byte_per_slot = wire_row_bytes(
                pg.features.shape[-1], self.halo_compress,
                pg.features.dtype.itemsize)
            self._halo_state = zeros("h")
            self._halo_age = 0

    @property
    def resident_feature_bytes(self) -> int:
        """Bytes of the feature plane held on the device."""
        return self.features.numel() * self.features.element_size()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------- forward pass
    def _exchange(self, hs: list) -> list:
        """Explicit halo exchange: every partition gathers its masked send
        rows, ``recv[q][p] = sent[p][q]`` (the all_to_all transpose), and
        each partition scatters what it received into its halo slots (a
        new tensor)."""
        P = self.num_parts
        sent = [hs[p][self.send_idx[p]] * self.send_mask[p][..., None]
                for p in range(P)]                     # each (P, maxS, D)
        out = []
        for q in range(P):
            recv = torch.stack([sent[p][q] for p in range(P)])
            d = hs[q].shape[-1]
            out.append(hs[q].index_put((self.recv_pos[q].reshape(-1),),
                                       recv.reshape(-1, d).to(hs[q].dtype)))
        return out

    def _exchange_comp(self, hs: list, rkey: str) -> list:
        """Error-compensated quantized rendering of :meth:`_exchange`: per
        sender, fold last round's residual into the gathered send buffer,
        quantize, update ``self._halo_residual[rkey]``, then transpose and
        scatter the DEQUANTIZED rows (the sender's dequantization is
        bitwise the receiver's)."""
        P = self.num_parts
        mode = self.halo_compress
        res = self._halo_residual[rkey]
        deqs = []
        for p in range(P):
            m3 = self.send_mask[p][..., None]
            sent = hs[p][self.send_idx[p]] * m3
            sent_ef = (sent + res[p].to(sent.dtype)) * m3
            payload, scale = quantize_rows(sent_ef, mode)
            deq = dequantize_rows(payload, scale, mode, sent.dtype)
            res[p] = ((sent_ef - deq) * m3).to(res[p].dtype)
            deqs.append(deq)
        out = []
        for q in range(P):
            recv = torch.stack([deqs[p][q] for p in range(P)])
            d = hs[q].shape[-1]
            out.append(hs[q].index_put((self.recv_pos[q].reshape(-1),),
                                       recv.reshape(-1, d).to(hs[q].dtype)))
        return out

    def _exchange_cached(self, hs: list, key: str, lo: int, hi: int) -> list:
        """Historical-cache variant of :meth:`_exchange`: land each
        partition's CACHED recv buffers into the halo slots, then exchange
        only send slots ``[lo, hi)`` live and overwrite both the halo rows
        and the cache with the refreshed values.  The full refresh skips
        the cache landing, so its ops are :meth:`_exchange`'s.  Mutates
        ``self._halo_state[key]`` (and, compressed, the residual)."""
        P = self.num_parts
        full = lo == 0 and hi == self.max_send
        cache = self._halo_state[key]
        if hi > lo:
            # gather BEFORE any cache landing, as the engine does
            sent = [hs[p][self.send_idx[p][:, lo:hi]]
                    * self.send_mask[p][:, lo:hi][..., None]
                    for p in range(P)]
            if self.halo_compress != "none":
                # quantize the refresh payload with error feedback on the
                # matching residual slot slice; the cache stores the
                # dequantized rows
                mode = self.halo_compress
                res = self._halo_residual["r" + key[1:]]
                for p in range(P):
                    m3 = self.send_mask[p][:, lo:hi][..., None]
                    sent_ef = (sent[p] + res[p][:, lo:hi].to(sent[p].dtype)
                               ) * m3
                    payload, scale = quantize_rows(sent_ef, mode)
                    deq = dequantize_rows(payload, scale, mode,
                                          sent[p].dtype)
                    res[p] = res[p].clone()
                    res[p][:, lo:hi] = ((sent_ef - deq) * m3).to(res[p].dtype)
                    sent[p] = deq
        out = []
        for q in range(P):
            h = hs[q]
            d = h.shape[-1]
            if not full:
                h = h.index_put((self.recv_pos[q].reshape(-1),),
                                cache[q].reshape(-1, d).to(h.dtype))
            if hi > lo:
                recv = torch.stack([sent[p][q] for p in range(P)])
                h = h.index_put((self.recv_pos[q][:, lo:hi].reshape(-1),),
                                recv.reshape(-1, d).to(h.dtype))
                cache[q] = cache[q].clone()
                cache[q][:, lo:hi] = recv.to(cache[q].dtype)
            out.append(h)
        return out

    def _layers(self, params_list: list, exchange) -> list:
        """The layer-synchronous n-layer GraphSAGE over all partitions with
        ``exchange(hs, i)`` landing layer i's halo rows; one logits tensor
        ``(maxN, C)`` per partition."""
        P = self.num_parts
        hs = [self.features[p] for p in range(P)]
        num_layers = len(params_list[0].layers)
        for i in range(num_layers):
            hs = exchange(hs, i)
            nxt = []
            for p in range(P):
                lp = params_list[p].layers[i]
                agg = self._agg(hs[p][None], self._edge_shards[p])[0]
                out = hs[p] @ lp.w_self + agg @ lp.w_neigh + lp.b
                nxt.append(torch.relu(out) if i < num_layers - 1 else out)
            hs = nxt
        return hs

    def _full_forward_cached(self, params_list: list) -> list:
        """The cached eval forward: the plain layer schedule, halo rows
        served from the historical cache with the refresh slot range
        :func:`halo_refresh_plan` picks.  Ages the cache once per call and
        records the refreshed payload in ``last_halo_exchange_bytes``."""
        lo, hi = halo_refresh_plan(self._halo_age, self.halo_refresh_every,
                                   self.halo_cv, self.max_send)
        hs = self._layers(params_list, lambda hs, i: self._exchange_cached(
            hs, f"h{i}", lo, hi))
        real = int(self._halo_slot_counts[lo:hi].sum())
        self.last_halo_exchange_bytes = (len(params_list[0].layers) * real
                                         * self._halo_byte_per_slot)
        self._halo_age += 1
        return hs

    def _full_forward_comp(self, params_list: list) -> list:
        """The quantized-exchange eval forward; records the compressed wire
        payload in ``last_halo_exchange_bytes``."""
        hs = self._layers(params_list,
                          lambda hs, i: self._exchange_comp(hs, f"r{i}"))
        self.last_halo_exchange_bytes = (len(params_list[0].layers)
                                         * self.halo_wire_bytes_per_layer)
        return hs

    def _full_forward(self, params_list: list) -> list:
        """The eval forward of this configuration: the split forward under
        ``overlap_halo``, else the cached, the quantized or the plain
        layer-synchronous one."""
        if self.overlap:
            return self._full_forward_overlap(params_list)
        if self.halo_cache:
            return self._full_forward_cached(params_list)
        if self.halo_compress != "none":
            return self._full_forward_comp(params_list)
        return self._full_forward_plain(params_list)

    def _full_forward_plain(self, params_list: list) -> list:
        return self._layers(params_list, lambda hs, i: self._exchange(hs))

    def _split_layer(self, hs: list, layers: list, activate: bool) -> list:
        """One interior/boundary split layer, unrolled: the interior
        aggregation and the self term on the pre-exchange embeddings, the
        boundary aggregation on the post-exchange ones, a per-row select
        between the two, and the owned rows re-embedded into the padded
        local space (the trash row stays zero)."""
        P, oc = self.num_parts, self.own_cap
        agg_i = [self._agg_int(hs[p][None], self._split_shards[p])[0]
                 for p in range(P)]
        self_t = [hs[p][:oc] @ layers[p].w_self for p in range(P)]
        hs = self._exchange(hs)
        rows = torch.arange(oc, device=self.device)[:, None]
        outs = []
        for p in range(P):
            agg_b = self._agg_bnd(hs[p][None], self._split_shards[p])[0]
            agg = torch.where(rows < self.n_int[p], agg_i[p], agg_b)
            out = self_t[p] + agg @ layers[p].w_neigh + layers[p].b
            if activate:
                out = torch.relu(out)
            pad = out.new_zeros((self.max_nodes - oc, out.shape[-1]))
            outs.append(torch.cat([out, pad]))
        return outs

    def _full_forward_overlap(self, params_list: list) -> list:
        P = self.num_parts
        hs = [self.features[p] for p in range(P)]
        num_layers = len(params_list[0].layers)
        for i in range(num_layers):
            hs = self._split_layer(hs, [prm.layers[i] for prm in params_list],
                                   i < num_layers - 1)
        return hs

    @torch.no_grad()
    def _eval(self, params_list: list, split: str):
        t0 = time.perf_counter()
        logits = self._full_forward(params_list)
        micros, preds = [], []
        for p in range(self.num_parts):
            pr = torch.argmax(logits[p], dim=-1)
            lab = torch.where(self.masks[split][p], self.labels[p], -1)
            micros.append(f1_scores_torch(pr, lab, self.num_classes)[0])
            preds.append(pr)
        out = torch.stack(micros), torch.stack(preds)
        self._sync()
        self.last_eval_seconds = time.perf_counter() - t0
        return out

    # ------------------------------------------------------------ the steps
    def _generalize_step(self, params, opt_state, batches: list):
        """One synchronous phase-0 step: each partition's loss and gradient
        in turn, the all-reduce as a stack-and-sum divided by P, one
        optimizer update.  Returns the losses ``(P,)``."""
        weights = list(params.parameters())
        losses, grads = [], []
        for b in batches:
            loss = self.loss_fn(params, b)
            grads.append(torch.autograd.grad(loss, weights))
            losses.append(loss.detach())
        opt_state = self._apply(params, opt_state, grads)
        return opt_state, torch.stack(losses)

    def _apply(self, params, opt_state, grads: list):
        """The all-reduce of the P partitions' gradients as the configured
        reducer over their stack (``none``: the stack's sum divided by P;
        top-k carries ``self._grad_res``), then one optimizer update."""
        stacked = [torch.stack(gs) for gs in zip(*grads)]
        if self.grad_compress == "topk":
            avg, self._grad_res = self._reduce(stacked,
                                               self._grad_residual(params))
        else:
            avg = self._reduce(stacked)
        old = [w.detach() for w in params.parameters()]
        updates, opt_state = self.optimizer.update(avg, opt_state, old)
        _assign(params, apply_updates(old, updates))
        return opt_state

    def _partition_batches(self, batch: dict) -> list:
        return [{k: v[p] for k, v in batch.items()}
                for p in range(self.num_parts)]

    # ------------------------------------------------------- public surface
    def phase0_epoch(self, params, opt_state, batches: dict):
        """One sampled generalization epoch over ``(I, P, ...)`` batches;
        the seconds cover the steps, the validation forward runs after."""
        iters = next(iter(batches.values())).shape[0]
        t0 = time.perf_counter()
        all_losses = []
        for it in range(iters):
            opt_state, losses = self._generalize_step(
                params, opt_state,
                self._partition_batches({k: v[it] for k, v in batches.items()}))
            all_losses.append(losses)
        self._sync()
        dt = time.perf_counter() - t0
        val_micro, _ = self._eval([params] * self.num_parts, "val")
        return params, opt_state, torch.stack(all_losses), val_micro, dt

    def phase0_fullgraph_epoch(self, params, opt_state, iters: int = 1):
        """Full-graph phase 0, legibly: partition p's loss is the train-mask
        loss of ITS rows of the full multi-partition forward, and its
        gradient is taken through the whole forward (halo exchange
        included); the P gradients are averaged as in :meth:`phase0_epoch`.
        The forward runs once a step and each partition's loss is
        differentiated from it.  Training runs the live uncompressed
        exchange whatever ``halo_compress`` says (only eval forwards
        quantize); the halo cache and top-k are refused, as the reference's
        oracle refuses them."""
        if self.halo_cache:
            raise ValueError(
                "halo_cache is an eval-forward optimisation; full-graph "
                "training differentiates through the live halo exchange "
                "and cannot train against stale cached embeddings")
        if self.grad_compress == "topk":
            raise ValueError(
                "top-k gradient sparsification is a sampled phase-0 feature; "
                "full-graph training keeps the exact (or bucketed) all-reduce")
        P = self.num_parts
        fg_fwd = (self._full_forward_overlap if self.overlap
                  else self._full_forward_plain)
        base = ((lambda lg, lab, m: focal_loss(lg, lab, gamma=2.0, mask=m))
                if self._fg_loss_kind == "focal" else
                (lambda lg, lab, m: cross_entropy_loss(lg, lab, mask=m)))
        t0 = time.perf_counter()
        all_losses = []
        for _ in range(iters):
            weights = list(params.parameters())
            logits = fg_fwd([params] * P)
            losses, grads = [], []
            for p in range(P):
                loss = base(logits[p], self.labels[p], self.masks["train"][p])
                grads.append(torch.autograd.grad(loss, weights,
                                                 retain_graph=p < P - 1))
                losses.append(loss.detach())
            opt_state = self._apply(params, opt_state, grads)
            all_losses.append(torch.stack(losses))
        self._sync()
        dt = time.perf_counter() - t0
        val_micro, _ = self._eval([params] * P, "val")
        return params, opt_state, torch.stack(all_losses), val_micro, dt

    def _budgets(self, budgets, iters: int) -> np.ndarray:
        if isinstance(budgets, torch.Tensor):
            budgets = budgets.cpu().numpy()
        budgets = np.asarray(budgets)
        if budgets.dtype == bool:        # full epoch or zero
            budgets = np.where(budgets, iters, 0)
        return budgets

    def _personalize(self, pparams, popt, global_params, n_iter: int,
                     budgets: np.ndarray, batch_at):
        """``n_iter`` phase-1 iterations, one partition at a time: partition
        p trains while the iteration is below ``budgets[p]`` and is frozen
        bitwise after.  ``batch_at(i)`` gives iteration i's stacked batch."""
        P = self.num_parts
        pp = [take_partition(pparams, p) for p in range(P)]
        po = [_split_state(popt, p) for p in range(P)]
        all_losses = []
        for it in range(n_iter):
            losses = []
            for p, b in enumerate(self._partition_batches(batch_at(it))):
                pp[p], po[p], loss = self._pstep1(
                    pp[p], po[p], b, global_params, bool(it < budgets[p]))
                losses.append(loss)
            all_losses.append(torch.stack(losses))
        _write_back(pparams, pp)
        return pparams, _stack_states(po), torch.stack(all_losses), pp

    def phase1_epoch(self, pparams, popt, batches: dict, global_params,
                     budgets):
        """One personalization epoch over per-partition params and
        ``(I, P, ...)`` batches with per-partition iteration budgets (a bool
        vector means full epoch or zero)."""
        iters = next(iter(batches.values())).shape[0]
        budgets = self._budgets(budgets, iters)
        t0 = time.perf_counter()
        pparams, popt, losses, pp = self._personalize(
            pparams, popt, global_params, iters, budgets,
            lambda it: {k: v[it] for k, v in batches.items()})
        self._sync()
        dt = time.perf_counter() - t0
        val_micro, _ = self._eval(pp, "val")
        return pparams, popt, losses, val_micro, dt

    # ----------------------------------------------- async personalization
    def set_device_sampler(self, sampler) -> None:
        """Attach a :class:`~repro_torch.core.sampler.DeviceEpochSampler`;
        required by the async epochs."""
        self._device_sampler = sampler

    def _sampler(self, method: str):
        if self._device_sampler is None:
            raise ValueError(f"{method} needs set_device_sampler()")
        return self._device_sampler

    def _batcher(self, ds, gen: torch.Generator):
        """``(nodes, valid) -> batch`` for one epoch call, as the engine
        draws them; a feature-store sampler gathers from ``[hot | cold]``
        with its cold tier copied to the device once per call."""
        if getattr(ds, "cold_host", None) is None:
            return lambda n, v: ds.make_batch(gen, n, v)
        table = ds.feature_table(ds.cold_host.to(self.device,
                                                 non_blocking=True))
        return lambda n, v: ds.make_batch(gen, n, v, table=table)

    def phase0_epoch_async(self, params, opt_state, gen: torch.Generator):
        """The device-drawn generalization epoch, legibly: the engine's one
        epoch draw and one batch draw per iteration over all P partitions,
        then the steps one partition at a time; the seconds include the
        validation forward and ``last_eval_seconds`` is 0, as the engine's."""
        ds = self._sampler("phase0_epoch_async")
        t0 = time.perf_counter()
        make = self._batcher(ds, gen)
        nodes, valid = ds.draw_epoch(gen)                # (P, I, B)
        all_losses = []
        for i in range(ds.num_batches):
            batch = make(nodes[:, i], valid[:, i])
            opt_state, losses = self._generalize_step(
                params, opt_state, self._partition_batches(batch))
            all_losses.append(losses)
        val_micro, _ = self._eval([params] * self.num_parts, "val")
        self._sync()
        dt = time.perf_counter() - t0
        self.last_eval_seconds = 0.0
        return params, opt_state, torch.stack(all_losses), val_micro, dt

    def phase1_epoch_async(self, pparams, popt, gen: torch.Generator,
                           budgets, global_params):
        """The device-drawn personalization epoch, legibly: the engine's
        draws in the engine's order over ``i_run`` iterations (max(budgets)
        rounded up to a power of two, capped at ``num_batches``), the steps
        one partition at a time."""
        ds = self._sampler("phase1_epoch_async")
        budgets = self._budgets(budgets, ds.num_batches)
        cap, need = ds.num_batches, int(budgets.max())
        i_run = 1
        while i_run < min(need, cap):
            i_run *= 2
        i_run = min(i_run, cap)
        t0 = time.perf_counter()
        make = self._batcher(ds, gen)
        nodes, valid = ds.draw_epoch(gen)
        pparams, popt, losses, pp = self._personalize(
            pparams, popt, global_params, i_run, budgets,
            lambda i: make(nodes[:, i], valid[:, i]))
        self._sync()
        dt = time.perf_counter() - t0
        val_micro, _ = self._eval(pp, "val")
        return pparams, popt, losses, val_micro, dt

    def evaluate(self, params, split: str = "test",
                 per_partition_params: bool = True):
        """The Python-loop full-graph forward and each partition's micro-F1
        on ``split``: ``(micro (P,), preds (P, maxN))``."""
        if per_partition_params != (params.num_parts is not None):
            raise ValueError(
                f"per_partition_params={per_partition_params} but params "
                f"are in the {'shared' if params.num_parts is None else 'per-partition'} form")
        if per_partition_params:
            plist = [take_partition(params, p) for p in range(self.num_parts)]
        else:
            plist = [params] * self.num_parts
        return self._eval(plist, split)

    # ---- checkpoint surface (mirrors SPMDEngine; files: ROADMAP item 12) --
    def halo_cache_state(self):
        """(cache dict of per-partition lists, age) for checkpointing; None
        without the cache."""
        if not self.halo_cache:
            return None
        return self._halo_state, self._halo_age

    def restore_halo_cache_state(self, state: dict, age: int) -> None:
        if not self.halo_cache:
            raise ValueError("engine built without halo_cache")
        self._halo_state = self._as_lists(state)
        self._halo_age = int(age)

    def _as_lists(self, state: dict) -> dict:
        return {k: [torch.as_tensor(b).to(self.device, self.config.dtype)
                    for b in bufs] for k, bufs in state.items()}

    # -------------------------------------- compressed communication state
    @property
    def halo_wire_bytes_per_layer(self) -> int:
        """Real payload bytes ONE layer's halo exchange puts on the wire
        under the configured compression (mirrors SPMDEngine)."""
        return self._halo_rows_total * wire_row_bytes(
            self._halo_row_width, self.halo_compress, self._halo_itemsize)

    def _grad_residual(self, params) -> torch.Tensor:
        """The lazily built ``(P, N)`` top-k error-feedback state, zero
        before the first compressed sync (mirrors SPMDEngine)."""
        if self._grad_res is None:
            n = sum(w.numel() for w in params.parameters())
            w0 = next(params.parameters())
            self._grad_res = torch.zeros((self.num_parts, n), dtype=w0.dtype,
                                         device=w0.device)
        return self._grad_res

    def comm_state_like(self, params) -> dict:
        """The ``halo``, ``halo_res`` and ``grad_res`` state a resume loads
        its checkpoint entries into (mirrors SPMDEngine)."""
        out = {}
        if self.halo_cache:
            out["halo"] = self._halo_state
        if self.halo_compress != "none":
            out["halo_res"] = self._halo_residual
        if self.grad_compress == "topk":
            n = sum(w.numel() for w in params.parameters())
            w0 = next(params.parameters())
            out["grad_res"] = (self._grad_res if self._grad_res is not None
                               else torch.zeros((self.num_parts, n),
                                                dtype=w0.dtype,
                                                device=w0.device))
        return out

    def comm_residual_state(self):
        """``(halo_residual, grad_residual)`` for checkpointing; each entry
        None when the matching compression is off (or, for top-k, before
        the first phase-0 step).  None when neither exists."""
        h = self._halo_residual if self.halo_compress != "none" else None
        g = self._grad_res if self.grad_compress == "topk" else None
        if h is None and g is None:
            return None
        return h, g

    def restore_comm_residual_state(self, state) -> None:
        h, g = state
        if h is not None:
            self._halo_residual = self._as_lists(h)
        if g is not None:
            self._grad_res = torch.as_tensor(g).to(self.device)

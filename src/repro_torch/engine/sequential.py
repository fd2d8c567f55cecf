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
time.  Options the oracle does not have raise ``NotImplementedError``
naming the ROADMAP item that ports them; the reference's checkpoint
surface belongs to item 12.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.gp.trainer import (GPHyperParams, _assign,
                               make_personalize_partition_step)
from ..device import resolve_device
from ..graph.distributed import (PartitionedGraph, make_ref_mean_agg,
                                 make_ref_split_agg)
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
        # the stacked engine's option rules: the same refusals, and the
        # options not ported yet raise naming their ROADMAP item
        _check_config(config)
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

    def _full_forward(self, params_list: list) -> list:
        """Layer-synchronous n-layer GraphSAGE over all partitions (or the
        split forward under ``overlap_halo``); one logits tensor
        ``(maxN, C)`` per partition."""
        if self.overlap:
            return self._full_forward_overlap(params_list)
        return self._full_forward_plain(params_list)

    def _full_forward_plain(self, params_list: list) -> list:
        P = self.num_parts
        hs = [self.features[p] for p in range(P)]
        num_layers = len(params_list[0].layers)
        for i in range(num_layers):
            hs = self._exchange(hs)
            nxt = []
            for p in range(P):
                lp = params_list[p].layers[i]
                agg = self._agg(hs[p][None], self._edge_shards[p])[0]
                out = hs[p] @ lp.w_self + agg @ lp.w_neigh + lp.b
                nxt.append(torch.relu(out) if i < num_layers - 1 else out)
            hs = nxt
        return hs

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
        avg = [torch.stack(gs).sum(0) / self.num_parts for gs in zip(*grads)]
        old = [w.detach() for w in weights]
        updates, opt_state = self.optimizer.update(avg, opt_state, old)
        _assign(params, apply_updates(old, updates))
        return opt_state, torch.stack(losses)

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
        differentiated from it."""
        P = self.num_parts
        base = ((lambda lg, lab, m: focal_loss(lg, lab, gamma=2.0, mask=m))
                if self._fg_loss_kind == "focal" else
                (lambda lg, lab, m: cross_entropy_loss(lg, lab, mask=m)))
        t0 = time.perf_counter()
        all_losses = []
        for _ in range(iters):
            weights = list(params.parameters())
            logits = self._full_forward([params] * P)
            losses, grads = [], []
            for p in range(P):
                loss = base(logits[p], self.labels[p], self.masks["train"][p])
                grads.append(torch.autograd.grad(loss, weights,
                                                 retain_graph=p < P - 1))
                losses.append(loss.detach())
            avg = [torch.stack(gs).sum(0) / P for gs in zip(*grads)]
            old = [w.detach() for w in weights]
            updates, opt_state = self.optimizer.update(avg, opt_state, old)
            _assign(params, apply_updates(old, updates))
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

    def phase0_epoch_async(self, params, opt_state, gen: torch.Generator):
        """The device-drawn generalization epoch, legibly: the engine's one
        epoch draw and one batch draw per iteration over all P partitions,
        then the steps one partition at a time; the seconds include the
        validation forward and ``last_eval_seconds`` is 0, as the engine's."""
        ds = self._sampler("phase0_epoch_async")
        t0 = time.perf_counter()
        nodes, valid = ds.draw_epoch(gen)                # (P, I, B)
        all_losses = []
        for i in range(ds.num_batches):
            batch = ds.make_batch(gen, nodes[:, i], valid[:, i])
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
        nodes, valid = ds.draw_epoch(gen)
        pparams, popt, losses, pp = self._personalize(
            pparams, popt, global_params, i_run, budgets,
            lambda i: ds.make_batch(gen, nodes[:, i], valid[:, i]))
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

"""GraphSAGE (Hamilton et al. 2017) as a PyTorch module — the paper's model.

Counterpart of ``repro/graph/sage.py``.  Eq. 1–2 with the mean aggregator:

    h_N(v) = mean(h_u, u in N(v))
    h_v    = sigma(h_v @ w_self + h_N(v) @ w_neigh + b)

The weights keep the reference's layout — ``w_self``/``w_neigh`` are
``(d_in, d_out)`` and ``b`` is ``(d_out,)`` — and :meth:`GraphSAGE.init`
draws them from the same NumPy generator in the same order, so a port model
and a reference ``SAGEParams`` from one seed are bitwise equal.  The module
is its own parameter set: every forward in the port reads
``params.layers[i].w_self`` etc., which a ``GraphSAGE`` provides.

A module is in one of two forms.  The shared form holds one set of weights
(the reference's ``SAGEParams``); the per-partition form, made by
:func:`broadcast_to_partitions`, holds P sets along a leading axis
(``w_self`` ``(P, d_in, d_out)``, ``b`` ``(P, d_out)``) — the reference's
stacked phase-1 params.  :meth:`GraphSAGE._layer` applies either to
``(P, ...)`` inputs: the per-partition weights meet partition p's rows.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["SAGELayer", "GraphSAGE", "broadcast_to_partitions",
           "clone_params", "take_partition", "partition_slice"]


def _glorot(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
    fan_in, fan_out = shape[0], shape[-1]
    scale = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-scale, scale, size=shape).astype(np.float32)


class SAGELayer(nn.Module):
    """One SAGE layer's weights (the reference's ``SAGELayer`` tuple)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w_self = nn.Parameter(torch.zeros(d_in, d_out))
        self.w_neigh = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))


class GraphSAGE(nn.Module):
    """Config plus weights: ``layers`` holds ``num_layers`` SAGE layers."""

    def __init__(self, feature_dim: int, hidden_dim: int, num_classes: int,
                 num_layers: int = 2):
        super().__init__()
        if num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, got {num_layers}")
        self.feature_dim = feature_dim
        self.hidden_dim = hidden_dim
        self.num_classes = num_classes
        self.num_layers = num_layers
        dims = self.layer_dims
        self.layers = nn.ModuleList(
            SAGELayer(dims[i], dims[i + 1]) for i in range(num_layers))

    @property
    def layer_dims(self) -> tuple[int, ...]:
        """Per-layer (input, ..., output) widths: (D, H, ..., H, C)."""
        return ((self.feature_dim,)
                + (self.hidden_dim,) * (self.num_layers - 1)
                + (self.num_classes,))

    @property
    def layer_input_dims(self) -> tuple[int, ...]:
        """Width of the embedding each layer's halo exchange ships."""
        return self.layer_dims[:-1]

    # ---------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, seed: int = 0) -> "GraphSAGE":
        """Redraw every weight in place, bitwise the reference's
        ``GraphSAGE.init(seed)``; returns the module."""
        rng = np.random.default_rng([seed, 0x5A6E])
        dims = self.layer_dims
        for i, lp in enumerate(self.layers):
            shape = (dims[i], dims[i + 1])
            lp.w_self.copy_(torch.from_numpy(_glorot(rng, shape)))
            lp.w_neigh.copy_(torch.from_numpy(_glorot(rng, shape)))
            lp.b.zero_()
        return self

    @property
    def num_parts(self) -> int | None:
        """P for the per-partition form, None for the shared form."""
        w = self.layers[0].w_self
        return int(w.shape[0]) if w.dim() == 3 else None

    def tensors_from_numpy(self, layers) -> list[torch.Tensor]:
        """The reference's ``SAGEParams.layers`` (or any tree of that shape,
        such as an ``OptState``'s moments) as tensors in
        ``self.parameters()`` order, on this module's device.  Each array has
        the shared shape or one leading partition axis more."""
        if len(layers) != self.num_layers:
            raise ValueError(f"{len(layers)} layers given, model has "
                             f"{self.num_layers}")
        out, lead = [], set()
        for lp, src in zip(self.layers, layers):
            for name in ("w_self", "w_neigh", "b"):
                shape = tuple(getattr(lp, name).shape[-(2 if name != "b" else 1):])
                val = torch.as_tensor(np.array(getattr(src, name)),
                                      device=lp.w_self.device)
                if tuple(val.shape[-len(shape):]) != shape or val.dim() > len(shape) + 1:
                    raise ValueError(f"{name}: shape {tuple(val.shape)} is "
                                     f"neither {shape} nor (P,) + {shape}")
                lead.add(tuple(val.shape[:-len(shape)]))
                out.append(val)
        if len(lead) != 1:
            raise ValueError(f"mixed shared/per-partition arrays: {lead}")
        return out

    @torch.no_grad()
    def params_from_numpy(self, layers) -> "GraphSAGE":
        """Load the reference's ``SAGEParams.layers`` (each with ``w_self``,
        ``w_neigh``, ``b`` as arrays) into this module; returns the module.
        Arrays with a leading partition axis (the reference's stacked
        phase-1 params) turn the module into the per-partition form."""
        vals = self.tensors_from_numpy(layers)
        for (lp, name), val in zip(self._slots(), vals):
            dst = getattr(lp, name)
            if tuple(val.shape) == tuple(dst.shape):
                dst.copy_(val)
            else:
                setattr(lp, name, nn.Parameter(val.to(dst.dtype).clone()))
        return self

    def _slots(self):
        return [(lp, name) for lp in self.layers
                for name in ("w_self", "w_neigh", "b")]

    # ------------------------------------------------------------- helpers
    def _layer(self, lp: SAGELayer, h_self: torch.Tensor,
               h_neigh: torch.Tensor, activate: bool) -> torch.Tensor:
        w_self, w_neigh, b = lp.w_self, lp.w_neigh, lp.b
        if w_self.dim() == 3:
            # per-partition weights against (P, ..., d_in) inputs: batch the
            # products over P, broadcast over the middle axes
            mid = (1,) * (h_self.dim() - 3)
            w_self = w_self.view(w_self.shape[0], *mid, *w_self.shape[1:])
            w_neigh = w_neigh.view(w_neigh.shape[0], *mid, *w_neigh.shape[1:])
            b = b.view(b.shape[0], *mid, 1, b.shape[-1])
        out = h_self @ w_self + h_neigh @ w_neigh + b
        return torch.relu(out) if activate else out

    # ------------------------------------------------------- sampled apply
    def apply_sampled(self, params: "GraphSAGE", x_t: torch.Tensor,
                      x_1: torch.Tensor, x_2: torch.Tensor) -> torch.Tensor:
        """Two-layer sampled forward -> ``(B, num_classes)`` logits from
        target features ``x_t (B, D)``, their sampled neighbours
        ``x_1 (B, F1, D)`` and the second hop ``x_2 (B, F1, F2, D)``; every
        input may carry a leading partition axis ``(P, ...)`` (with shared or
        per-partition ``params``).  The neighbour means are dense means over
        the fanout axis, as in the reference."""
        if self.num_layers != 2:
            raise ValueError(
                "apply_sampled is the paper's fixed two-layer fanout path; "
                f"got num_layers={self.num_layers}")
        l1, l2 = params.layers[0], params.layers[-1]
        h1_t = self._layer(l1, x_t, x_1.mean(dim=-2), activate=True)
        h1_1 = self._layer(l1, x_1, x_2.mean(dim=-2), activate=True)
        return self._layer(l2, h1_t, h1_1.mean(dim=-2), activate=False)

    def make_loss_fn(self, loss: str = "ce", focal_gamma: float = 2.0):
        """``loss_fn(params, batch)`` for the GP trainer; ``batch`` holds
        ``x_t``, ``x_1``, ``x_2``, ``labels`` and optionally ``mask`` (padded
        batches).  A batch with a leading partition axis gives the ``(P,)``
        per-partition losses."""
        from ..train.losses import cross_entropy_loss, focal_loss

        def one(logits, labels, mask):
            if loss == "focal":
                return focal_loss(logits, labels, gamma=focal_gamma, mask=mask)
            return cross_entropy_loss(logits, labels, mask=mask)

        def loss_fn(params: "GraphSAGE", batch: dict) -> torch.Tensor:
            logits = self.apply_sampled(params, batch["x_t"], batch["x_1"],
                                        batch["x_2"])
            mask = batch.get("mask")
            if batch["x_t"].dim() == 2:
                return one(logits, batch["labels"], mask)
            return torch.stack([
                one(logits[p], batch["labels"][p],
                    None if mask is None else mask[p])
                for p in range(logits.shape[0])])

        return loss_fn

    # ---------------------------------------------------------- full apply
    def apply_full(
        self,
        features: torch.Tensor,     # (N, D)
        edge_src,                   # (E,) message sources
        edge_dst,                   # (E,) message destinations
        num_nodes: int,
        *,
        blocks: dict | None = None,   # prebuilt blocks_to_device(...) dict
        use_kernel: bool = True,
    ) -> torch.Tensor:
        """Full-graph n-layer forward -> (N, num_classes) logits.

        ``use_kernel`` aggregates through ``segment_mean_op`` (the CUDA
        kernel for CUDA tensors; ``blocks`` is built from the edge lists
        unless passed), otherwise through the oracle
        ``kernels.ref.segment_agg_ref`` — the reference's ``use_pallas``.
        """
        dev = features.device
        if use_kernel:
            from ..kernels.segment_agg import (blocks_to_device,
                                               build_vjp_blocks,
                                               segment_mean_op)
            if blocks is None:
                blocks = blocks_to_device(build_vjp_blocks(
                    _host(edge_src), _host(edge_dst), num_rows=num_nodes,
                    num_src_rows=num_nodes), dev)
            mean_agg = lambda h: segment_mean_op(h, blocks, num_rows=num_nodes)
        else:
            from ..kernels.ref import segment_agg_ref
            src = torch.as_tensor(_host(edge_src), device=dev)
            dst = torch.as_tensor(_host(edge_dst), device=dev)
            mean_agg = lambda h: segment_agg_ref(h, src, dst, num_nodes)

        h = features
        last = len(self.layers) - 1
        for i, lp in enumerate(self.layers):
            h = self._layer(lp, h, mean_agg(h), activate=i < last)
        return h


def _host(idx) -> np.ndarray:
    if isinstance(idx, torch.Tensor):
        idx = idx.cpu().numpy()
    return np.asarray(idx, np.int64)


def _rebuilt(params: GraphSAGE, weight) -> GraphSAGE:
    """A new ``GraphSAGE`` of ``params``' config whose every weight is
    ``weight(w)`` of the detached weight ``w``."""
    out = GraphSAGE(params.feature_dim, params.hidden_dim, params.num_classes,
                    params.num_layers)
    with torch.no_grad():
        for (lp, name), src in zip(out._slots(), params.parameters()):
            setattr(lp, name, nn.Parameter(weight(src.detach())))
    return out


def clone_params(params: GraphSAGE) -> GraphSAGE:
    """A detached copy of ``params`` (either form), e.g. a best-model
    snapshot that later in-place updates leave alone."""
    return _rebuilt(params, torch.clone)


def broadcast_to_partitions(params: GraphSAGE, num_parts: int) -> GraphSAGE:
    """W^G -> the per-partition form, every partition starting from the same
    weights (the phase transition)."""
    return _rebuilt(params,
                    lambda w: w[None].expand(num_parts, *w.shape).clone())


def take_partition(params: GraphSAGE, p: int) -> GraphSAGE:
    """Partition ``p``'s weights of per-partition ``params`` as a detached
    copy in the shared form (the reference's ``tree.map(lambda x: x[p])``)."""
    return _rebuilt(params, lambda w: w[p].clone())


def partition_slice(params: GraphSAGE, p: int) -> GraphSAGE:
    """Partition ``p``'s weights of per-partition ``params`` as a detached
    copy that keeps the partition axis (length 1): the per-partition form
    of one partition, which the stacked phase-1 step takes as it is."""
    return _rebuilt(params, lambda w: w[p:p + 1].clone())

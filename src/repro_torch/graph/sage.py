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

Only the full-graph forward is here; the sampled training path
(``apply_sampled``, ``make_loss_fn``) joins with the training slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["SAGELayer", "GraphSAGE"]


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

    @torch.no_grad()
    def params_from_numpy(self, layers) -> "GraphSAGE":
        """Load the reference's ``SAGEParams.layers`` (each with ``w_self``,
        ``w_neigh``, ``b`` as arrays) into this module; returns the module."""
        if len(layers) != self.num_layers:
            raise ValueError(f"{len(layers)} layers given, model has "
                             f"{self.num_layers}")
        for lp, src in zip(self.layers, layers):
            for name in ("w_self", "w_neigh", "b"):
                dst = getattr(lp, name)
                val = torch.as_tensor(np.asarray(getattr(src, name)))
                if tuple(val.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: shape {tuple(val.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(val)
        return self

    # ------------------------------------------------------------- helpers
    def _layer(self, lp: SAGELayer, h_self: torch.Tensor,
               h_neigh: torch.Tensor, activate: bool) -> torch.Tensor:
        out = h_self @ lp.w_self + h_neigh @ lp.w_neigh + lp.b
        return torch.relu(out) if activate else out

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

"""Sharding policy: how the model zoo maps onto a mesh of ranks
(counterpart of ``repro/models/sharding.py``; the port's own copy, which
imports nothing of ``repro``).

The reference's scheme, kept rule for rule:
  · params: Megatron 2D — heads / ffn-hidden / experts / vocab over "model";
    everything batch-like over ("pod", "data");
  · residual stream (B, S, d): batch over the data axes, sequence over
    "model" between blocks (Megatron sequence parallelism;
    ``seq_shard_residual=False`` keeps it replicated there);
  · attention / MLP internals: heads (resp. ffn hidden) over "model",
    sequence gathered (``constrain_attn=False`` drops the head constraint
    on training attention's activations).

The reference states this as ``PartitionSpec``s and lets GSPMD insert the
collectives.  Here a spec is the small :class:`P` below, and
:meth:`ShardingPolicy.placements` turns it into DTensor placements on a
named ``DeviceMesh`` (one ``Shard(d)`` or ``Replicate()`` per mesh
dimension); :meth:`ShardingPolicy.constrain` plays the part of
``with_sharding_constraint`` as a ``redistribute``.  Parameter names are the
port's ``named_parameters()`` names (``layers.3.attn.wq``), which carry no
stacked-layer axis: a port parameter's spec is the reference's with its
leading ``None`` dropped.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

__all__ = ["P", "ShardingPolicy", "NO_SHARDING", "placements",
           "sanitize_spec", "cache_spec_for"]


class P(tuple):
    """A partition spec: one entry per tensor dim, each an axis name, a
    tuple of axis names (the dim sharded over all of them, the first the
    outermost) or None.  Indexing past the end gives None, as a dim the
    spec does not name is not sharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getitem__(self, i):
        if isinstance(i, int) and i >= len(self):
            return None
        return super().__getitem__(i)

    def __repr__(self):
        return f"P{tuple.__repr__(tuple(self))}"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec: P, shape, axis_sizes) -> P:
    """Drop mesh axes from dims they do not divide evenly, from the right
    of a tuple entry (the reference's ``_sanitize`` and
    ``launch/steps.py::sanitize_spec``); ``axis_sizes`` maps each axis name
    to its size."""
    parts: list = []
    for d in range(len(shape)):
        axes = list(_axes(spec[d]))
        while axes:
            if shape[d] % math.prod(axis_sizes[a] for a in axes) == 0:
                break
            axes.pop()
        parts.append(tuple(axes) if len(axes) > 1
                     else (axes[0] if axes else None))
    return P(*parts)


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    named dims): ``Shard(d)`` on every mesh dim that shards tensor dim d,
    ``Replicate()`` on the others.  A tuple entry shards dim d over its mesh
    dims outermost first, as JAX nests it; DTensor nests a dim sharded over
    several mesh dims in mesh order, so the tuple must follow it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} nests its axes against "
                             f"the mesh order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            out[i] = Shard(d)
    return out


def cache_spec_for(path: str, shape, dax, axis_sizes) -> P:
    """The decode cache's spec by its path in the cache tree (the
    reference's ``launch/steps.py::_cache_spec_for`` with its stacked
    repeat axis dropped): KV ``(B, Hkv, W, Dh)`` heads over ``"model"``, or
    where the heads do not divide it the sequence (a context-parallel
    cache); Mamba2's ``ssm`` ``(B, H, N, P)`` heads and ``conv`` ``(B, K-1,
    C)`` channels over ``"model"``; batch over the data axes ``dax``.  As
    in the reference a path ending in ``v`` (``conv`` too) takes the KV
    rule first."""
    nd = len(shape)
    if path.endswith("k") or path.endswith("v"):
        s = sanitize_spec(P(dax, "model", None, None), shape, axis_sizes)
        if s[1] is None and shape[2] % axis_sizes["model"] == 0:
            # heads not shardable -> context-parallel cache (shard sequence)
            s = sanitize_spec(P(dax, None, "model", None), shape, axis_sizes)
        return s
    if path.endswith("ssm"):
        return sanitize_spec(P(dax, "model", None, None), shape, axis_sizes)
    if path.endswith("conv"):
        return sanitize_spec(P(dax, None, "model"), shape, axis_sizes)
    return P(*([None] * nd))


@dataclass(frozen=True)
class ShardingPolicy:
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str | None = "model"
    # Megatron sequence parallelism: the residual stream's sequence over
    # "model" between sub-layers (off: replicated there, each sub-layer's
    # output all-reduced)
    seq_shard_residual: bool = True
    # the head constraint on training attention's activations (off: each
    # model rank computes every head from gathered projections)
    constrain_attn: bool = True
    enabled: bool = True
    # mesh axis sizes: required for divisibility-aware activation constraints
    axis_sizes: Any = None   # dict[str, int] | None

    # ---- activation specs -------------------------------------------------
    def residual_spec(self) -> P:
        if self.seq_shard_residual and self.model_axis:
            return P(self.data_axes, self.model_axis, None)
        return P(self.data_axes, None, None)

    def attn_act_spec(self) -> P:
        # (B, H, S, Dh): heads over model
        return P(self.data_axes, self.model_axis, None, None)

    def batch_spec(self, ndim: int) -> P:
        return P(self.data_axes, *([None] * (ndim - 1)))

    def _sanitize(self, spec: P, shape) -> P:
        if self.axis_sizes is None:
            return spec
        return sanitize_spec(spec, shape, self.axis_sizes)

    def placements(self, spec: P, shape, mesh) -> list:
        """The placements of ``spec`` sanitized against ``shape``."""
        return placements(self._sanitize(spec, shape), mesh)

    def constrain(self, x, spec: P):
        """``x`` (a DTensor) redistributed to the sanitized ``spec`` on its
        own mesh: the collectives the placements ask for, nothing where it
        is placed so already.  Nothing when the policy is disabled."""
        if not self.enabled:
            return x
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            raise TypeError("an enabled ShardingPolicy constrains DTensors; "
                            f"got {type(x).__name__}")
        want = self.placements(spec, x.shape, x.device_mesh)
        if tuple(want) == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, want)

    def residual(self, x):
        return self.constrain(x, self.residual_spec())

    # ---- parameter specs ---------------------------------------------------
    def spec_for_param(self, name: str, shape) -> P:
        """Name/shape rule-based parameter sharding: the reference's rules
        in its order, matched on the lower-cased name (the port's
        ``layers.3.attn.wq``, the reference's ``blocks/sub0/attn/wq``)."""
        m = self.model_axis
        if not self.enabled or m is None:
            return P()
        n = name.lower()
        nd = len(shape)

        def last2(a, b):  # spec with trailing two dims (a, b), rest None
            return P(*([None] * (nd - 2)), a, b)

        def last1(a):
            return P(*([None] * (nd - 1)), a)

        if nd == 0:
            return P()
        if "embed" in n and nd >= 2:          # (V, d) token embedding
            return last2(m, None)
        if "lm_head" in n and nd >= 2:        # (d, V)
            return last2(None, m)
        if any(k in n for k in ("wq", "wk", "wv")) and nd >= 2:
            return last2(None, m)             # (d, H*Dh) -> heads sharded
        if "wo" in n and nd >= 2:
            return last2(m, None)             # (H*Dh, d)
        if any(k in n for k in ("w_gate", "w_up", "w_in")) and nd >= 2:
            return last2(None, m)             # (d, ff)
        if any(k in n for k in ("w_down", "w_out")) and nd >= 2:
            return last2(m, None)             # (ff, d)
        if "expert" in n and nd >= 3:
            # stacked experts (..., E, d, ff)/(..., E, ff, d): expert-parallel
            return P(*([None] * (nd - 3)), m, None, None)
        if "router" in n and nd >= 2:
            return P()                        # tiny, replicate
        if any(k in n for k in ("b_q", "b_k", "b_v")) and nd >= 1:
            return last1(m)
        if "in_proj" in n and nd >= 2:        # mamba2 (d, 2*di+2*G*N+H)
            return last2(None, m)
        if "out_proj" in n and nd >= 2:       # mamba2 (di, d)
            return last2(m, None)
        if any(k in n for k in ("conv", "a_log", "dt_bias", "d_skip",
                                "ssm_norm")):
            # small per-channel params along d_inner -> model-sharded last dim
            return last1(m) if shape[-1] % 2 == 0 else P()
        return P()  # norms, biases, scalars: replicated

    def param_specs(self, model) -> dict[str, P]:
        """``{name: spec}`` over ``model.named_parameters()`` (or over a
        ``{name: shape}`` dict)."""
        items = (model.items() if isinstance(model, dict)
                 else ((k, v.shape) for k, v in model.named_parameters()))
        return {k: self.spec_for_param(k, tuple(s)) for k, s in items}


NO_SHARDING = ShardingPolicy(enabled=False, model_axis=None, data_axes=())

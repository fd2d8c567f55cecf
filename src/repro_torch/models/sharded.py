"""The model zoo on a mesh of ranks (the dense decoders, the
encoder-decoder, the prefix-LM, the MoE and the Mamba2 families): tensor
(Megatron), expert and sequence parallelism over ``"model"``, data
parallelism over the data axes, as DTensors (the port's counterpart of the
reference's GSPMD sharding, whose policy is ``models/sharding.py``).

Parameters are DTensors placed by their sanitized ``param_specs``; the
batch is sharded over the data axes; between sub-layers the residual
stream is placed by ``policy.residual`` (batch over data, sequence over
``"model"``; with ``seq_shard_residual`` off the sequence stays replicated
there, so a sub-layer needs no gather and its ``Partial`` output is
all-reduced; with ``constrain_attn`` off training attention computes every
head on each model rank).  Each sub-layer runs as ONE ``local_map`` on the ranks'
local shards, so every hand-written kernel (flash attention, RMSNorm and
their backwards) runs on a rank's shard, and the communication is the
``redistribute`` calls around the sub-layers:

- a norm runs on the residual's local rows; its weight is replicated, so
  its gradient comes back ``Partial`` over the dims that split the rows;
- attention and the MLP take the normed rows gathered over ``"model"``
  (an all-gather of the sequence) and each rank computes its heads (resp.
  its slice of the FFN hidden) against its column shards of ``wq``, ``wk``,
  ``wv`` (``w_gate``, ``w_up``) and its row shard of ``wo`` (``w_down``):
  a ``Partial`` output that ``policy.residual`` reduce-scatters back to
  the sequence shard (Megatron's all-gather / reduce-scatter pair).  Where
  the heads do not divide ``|model|`` (the reference's sanitized head
  constraint drops ``"model"``) the rank gathers the projections it needs
  and computes every query head, and where only the KV heads do not divide
  it takes the KV heads its query heads read;
- the embedding is row-sharded over ``"model"``: a masked lookup of the
  rank's vocabulary rows, ``Partial``, reduce-scattered like a sub-layer
  (a vocabulary that does not divide ``"model"``, whisper's, stays whole:
  each rank looks up its own rows of the residual); a prefix-LM's patch
  embeddings are placed beside the token rows before that scatter;
- an encoder runs the same blocks on its own rows (``P(data, "model",
  None)``, replicated over ``"model"`` where its sequence does not divide
  it); its output is gathered over ``"model"`` once, and each decoder
  layer's cross-attention block takes its queries from the gathered rows
  and its keys and values from that output, whose gradient comes back a
  Partial sum;
- the loss gathers the tied head once (one all-gather) and sums the nll
  and counts the unmasked labels of the rank's rows; both sums are
  all-reduced and divided, never a mean of the ranks' means;
- the mixture of experts routes the gathered rows on every model rank
  (the router replicated), places each choice at the global batch's slot
  (each expert's count of the earlier data ranks' choices gathered over
  the data axes, an exclusive scan) and runs the rank's experts on its
  own tokens' slots, a Partial output; the Switch auxiliary is built from
  sums all-reduced over the data axes (:meth:`ShardedOps.moe`);
- Mamba2 runs its SSM heads over ``"model"`` on the gathered rows: in
  training the packed ``in_proj`` and the conv's weights (whose even cuts
  do not fall on the heads) are gathered over ``"model"`` a call; serving
  gathers the rows' projections onto them instead, where those are the
  fewer bytes (a decode step always); the gated norm's mean square over
  every head is all-reduced between two local maps
  (:meth:`ShardedOps.mamba2`, :meth:`ShardedOps.mamba2_decode`).

Inside a ``local_map`` a rank's result is its part of a sum over the
ranks, so every input the block holds replicated over a dim that splits
the work gets its gradient back ``Partial`` there (``in_grad_placements``).
Decode caches are placed by ``cache_spec_for``: heads over ``"model"``,
or, where the KV heads do not divide it, the sequence (the context-
parallel cache, gathered over ``"model"`` before each decode step's
kernel); the ``"cross"`` cache by the same rule over the encoder's
sequence; Mamba2's ``ssm`` state by heads and its ``conv`` tail by an even
cut of its channels (each rank steps its block of the conv in place).
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L
from .sharding import P, cache_spec_for, placements

__all__ = ["ShardedOps", "param_placements", "shard_tensor",
           "local_shard", "ssm_serves_activations"]


def _dt():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def local_shard(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``placements``
    (mesh dims in order, so a dim sharded over several nests them
    outermost first), as a copy of its own."""
    _, _, _, Shard = _dt()
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if t.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not "
                                 f"split over {n} ranks")
            t = t.chunk(n, dim=pl.dim)[coord[i]]
    return t.clone()


def shard_tensor(t: torch.Tensor, mesh, placements):
    """The DTensor of the full tensor ``t`` (the same on every rank) under
    ``placements``: each rank keeps its block, no collective."""
    DTensor = _dt()[0]
    return DTensor.from_local(local_shard(t, mesh, placements), mesh,
                              list(placements), run_check=False)


def param_placements(model, mesh) -> dict:
    """``{name: placements}`` of the model's parameters on ``mesh``: the
    policy's ``param_specs`` sanitized against each shape."""
    pol = model.policy
    return {name: pol.placements(pol.spec_for_param(name, p.shape), p.shape,
                                 mesh)
            for name, p in model.named_parameters()}


def _is_dtensor(x) -> bool:
    return isinstance(x, _dt()[0])


class _AttnLayout:
    """How one attention sub-layer splits over ``"model"`` (``m`` ranks,
    this one ``r``): query heads local (the sanitized head spec keeps
    ``"model"``) or all; KV heads local (both head counts divide ``m``) or
    all, with the KV heads this rank's query heads read picked from them.
    ``constrain=False`` (training attention under a policy without
    ``constrain_attn``) puts no head constraint on the activations: every
    model rank computes all heads from gathered projections."""

    def __init__(self, cfg, policy, m: int, r: int, b: int, s: int,
                 constrain: bool = True):
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        qspec = policy._sanitize(policy.attn_act_spec(), (b, h, s, dh))
        self.q_local = m == 1 or (constrain and qspec[1] is not None)
        self.kv_local = self.q_local and hkv % m == 0
        self.cfg_local = cfg if m == 1 else replace(
            cfg, num_heads=h // m if self.q_local else h,
            num_kv_heads=hkv // m if self.kv_local else hkv, head_dim=dh)
        self.kv_pick = None
        if self.q_local and not self.kv_local:
            hl, g = h // m, h // hkv
            need = [(r * hl + j) // g for j in range(hl)]
            uniq = sorted(set(need))
            grp = hl // len(uniq)
            if hl % len(uniq) == 0 and all(need[j] == uniq[j // grp]
                                           for j in range(hl)):
                self.kv_pick = uniq          # local group hl / len(uniq)
            else:
                self.kv_pick = need          # one KV head per query head
        self.plain = self.q_local and self.kv_local

    def pick(self, k, v):
        if self.kv_pick is None:
            return k, v
        idx = torch.as_tensor(self.kv_pick, device=k.device)
        return k[:, idx], v[:, idx]


class ShardedOps:
    """The sub-layers and the model's ends of ``model`` (distributed on
    ``mesh``) as local maps with the redistributions between them (see the
    module docstring): the calls of ``models/transformer.py::_LocalOps``,
    which the model's one layer loop makes on a mesh."""

    def __init__(self, model, mesh):
        self.model, self.mesh, self.cfg = model, mesh, model.cfg
        self.policy = pol = model.policy
        names = list(mesh.mesh_dim_names)
        self.model_dim = (names.index(pol.model_axis)
                          if pol.model_axis in names else None)
        self.m = 1 if self.model_dim is None else mesh.size(self.model_dim)
        self.r = (0 if self.model_dim is None
                  else mesh.get_coordinate()[self.model_dim])

    @property
    def kernels(self) -> bool:
        return self.model.use_kernels

    # ---------------------------------------------------------- placements
    def _split(self, pls) -> list[bool]:
        """Mesh dims over which a block's rows are split (sharded there,
        more than one rank)."""
        Shard = _dt()[3]
        return [isinstance(p, Shard) and self.mesh.size(i) > 1
                for i, p in enumerate(pls)]

    def _grad(self, pls, split) -> list:
        """Gradient placements of a block input placed ``pls``: Partial
        where it is replicated over a dim that splits the block's work."""
        _, Partial, Replicate, _ = _dt()
        return [Partial() if isinstance(p, Replicate) and sp else p
                for p, sp in zip(pls, split)]

    def _model_split(self, pls, dim: int) -> bool:
        """Whether placements ``pls`` split tensor dim ``dim`` over more
        than one model rank (a sequence: 1 for the rows, 2 for a KV cache,
        the context-parallel one)."""
        Shard = _dt()[3]
        return (self.model_dim is not None and self.m > 1
                and pls[self.model_dim] == Shard(dim))

    def _model_partial(self, pls) -> list:
        """``pls`` with the model dim Partial (a block's output: its part of
        a sum over the model ranks), Replicate for one model rank."""
        _, Partial, Replicate, _ = _dt()
        out = list(pls)
        if self.model_dim is not None:
            out[self.model_dim] = Partial() if self.m > 1 else Replicate()
        return out

    def _lmap(self, fn, ins, outs, grads=None):
        from torch.distributed.tensor.experimental import local_map
        return local_map(fn, out_placements=outs, in_placements=tuple(ins),
                         in_grad_placements=None if grads is None
                         else tuple(grads), device_mesh=self.mesh)

    def place(self, x, spec: P):
        """A global tensor (the same on every rank) or DTensor placed by
        the sanitized ``spec``."""
        if _is_dtensor(x):
            return self.policy.constrain(x, spec)
        return shard_tensor(x, self.mesh,
                            self.policy.placements(spec, x.shape, self.mesh))

    def gathered(self, x):
        """``x`` (B, S, d) with its sequence gathered over ``"model"``."""
        return self.policy.constrain(x, P(self.policy.data_axes, None, None))

    def residual(self, x):
        return self.policy.residual(x)

    def tokens(self, t):
        if not _is_dtensor(t):
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(np.asarray(t))
            t = t.to(self.model.device)
        return self.place(t.long(), self.policy.batch_spec(2))

    # ------------------------------------------------------------ the norm
    def add_norm(self, p, x, delta):
        """``(x + delta, norm(x + delta))`` on the local rows (the fused
        RMSNorm kernel); ``delta`` None: ``(x, norm(x))``."""
        keys = list(p.keys())
        ws = [p[k] for k in keys]
        rows = list(x.placements)
        split = self._split(rows)
        xs = [x] if delta is None else [x, delta]
        cfg, kernels = self.cfg, self.kernels

        def fn(*args):
            pd = dict(zip(keys, args[len(xs):]))
            xl = args[0].contiguous()
            # with no delta x passes through as an output of its own, so its
            # gradient sums the residual's and the norm's parts in one place,
            # in the order of the unsharded model
            return L.add_norm_apply(pd, xl, None if delta is None
                                    else args[1].contiguous(), cfg,
                                    kernels=kernels)

        ins = [rows] * len(xs) + [list(w.placements) for w in ws]
        grads = [rows] * len(xs) + [self._grad(w.placements, split)
                                    for w in ws]
        return self._lmap(fn, ins, (rows, rows), grads)(*xs, *ws)

    # ------------------------------------------------------- the embedding
    def embed(self, tokens, offset: int = 0):
        """The lookup of ``tokens`` (B, S), plus the sinusoidal positions
        ``offset ..`` where the model has no RoPE (whisper's decoder).  With
        the vocabulary over ``"model"`` each rank looks up the tokens in its
        rows (0 for the others), a Partial sum, the positions added on
        model rank 0 alone.  With the vocabulary whole (whisper's 51,865 is
        odd, so ``sanitize_spec`` leaves it replicated) and no prefix to
        place beside them, the tokens are placed as the residual's rows (a
        local slice) and each rank looks up its own: the output is in the
        residual's placements, and the table's gradient a Partial sum over
        the ranks that split the rows."""
        w = self.model.embed
        Shard = _dt()[3]
        vsplit = (self.model_dim is not None and self.m > 1
                  and isinstance(w.placements[self.model_dim], Shard))
        if not vsplit and not self.cfg.prefix_tokens:
            tokens = self.policy.constrain(
                tokens, P(*self.policy.residual_spec()[:2]))
        r = self.r
        tpl = list(tokens.placements)
        out = self._model_partial(tpl) if vsplit else tpl
        seq_split = self._model_split(tpl, 1)
        sinus = self.cfg.rope_theta is None and (not vsplit or r == 0)
        d = self.cfg.d_model

        def fn(tl, wl):
            if vsplit:
                n = wl.shape[0]
                idx = tl - r * n
                valid = (idx >= 0) & (idx < n)
                rows = F.embedding(idx.clamp(0, n - 1), wl)
                x = rows * valid[..., None].to(wl.dtype)
            else:
                x = F.embedding(tl, wl)
            if sinus:
                sl = tl.shape[1]
                pos = L.sinusoidal_positions(
                    sl, d, device=x.device,
                    offset=offset + (r * sl if seq_split else 0))
                x = x + pos[None].to(x.dtype)
            return x

        split = self._split(tpl)
        return self._lmap(fn, [tpl, list(w.placements)], out,
                          [tpl, self._grad(w.placements, split)])(tokens, w)

    def prefix(self, x, patch_embeds, labels=None):
        """The prefix-LM's input: the patch embeddings (B, P, d) placed
        beside the token rows ``x`` (B, S, d) under x's placements (batch
        over the data axes; over ``"model"`` the embedding's Partial sum,
        to which the patches are added on model rank 0 alone, or
        replicated; :meth:`embed` never splits a prefix-LM's rows) and
        concatenated on each rank, before ``policy.residual`` splits the P
        + S rows; ``labels`` (B, S) get P labels -1 in front, placed as
        they are.  Returns ``(x, labels)``."""
        DTensor, _, Replicate, _ = _dt()
        n = self.cfg.prefix_tokens
        xp = list(x.placements)
        pe = self.place(self.model._embeds(patch_embeds, "patch_embeds", n),
                        self.policy.batch_spec(3))
        coord = self.mesh.get_coordinate()
        first = all(coord[i] == 0 for i, p in enumerate(xp)
                    if p.is_partial())

        def fn(xl, pl):
            pl = pl.to(xl.dtype)
            return torch.cat([pl if first else torch.zeros_like(pl), xl],
                             dim=1)

        # x's gradient comes back whole where x is a Partial sum
        xg = [Replicate() if p.is_partial() else p for p in xp]
        x = self._lmap(fn, [xp, list(pe.placements)], xp,
                       [xg, list(pe.placements)])(x, pe)
        if labels is not None:
            ll = labels.to_local()
            ll = torch.cat([ll.new_full((ll.shape[0], n), -1), ll], dim=1)
            labels = DTensor.from_local(ll, self.mesh,
                                        list(labels.placements),
                                        run_check=False)
        return x, labels

    # ----------------------------------------------------------- the encoder
    def encoder_input(self, enc_embeds):
        """The encoder's input: the frame embeddings (B, Se, d) placed as
        the residual (``P(data, "model", None)``, sanitized: an encoder
        sequence that does not divide ``"model"`` stays replicated there,
        as the dry run's 1,500 frames over 16), plus the sinusoidal
        positions of each rank's rows."""
        x = self.place(self.model._embeds(enc_embeds, "enc_embeds"),
                       self.policy.residual_spec())
        xp = list(x.placements)
        seq_split = self._model_split(xp, 1)
        r, d = self.r, self.cfg.d_model

        def fn(xl):
            sl = xl.shape[1]
            pos = L.sinusoidal_positions(sl, d, device=xl.device,
                                         offset=r * sl if seq_split else 0)
            return xl + pos[None].to(xl.dtype)

        return self._lmap(fn, [xp], xp, [xp])(x)

    def cross_input(self, enc_out):
        """The encoder's output as every decoder layer's cross-attention
        reads it: its sequence gathered over ``"model"``, once a step."""
        return self.gathered(enc_out)

    # ---------------------------------------------------------- the blocks
    def _block_weights(self, p, gather: set):
        """The block's weights as fed to it: those named in ``gather``
        replicated over ``"model"`` (an all-gather of the shards), the
        others as placed."""
        _, _, Replicate, _ = _dt()
        keys = list(p.keys())
        ws = []
        for k in keys:
            w = p[k]
            if k in gather and self.model_dim is not None and not isinstance(
                    w.placements[self.model_dim], Replicate):
                pls = list(w.placements)
                pls[self.model_dim] = Replicate()
                w = w.redistribute(self.mesh, pls)
            ws.append(w)
        return keys, ws

    def _block(self, fn, h, keys, ws, extra=(), extra_out=(), acts=()):
        """Run ``fn(h_local, params_dict, *acts_local, *extra_local)`` on
        every rank: its part of a sum over the model ranks, plus
        ``extra_out`` placed outputs (prefill caches).  ``acts`` are
        activations beside ``h`` (the encoder's output), whose gradients
        come back Partial like ``h``'s; ``extra`` take none (caches)."""
        hp = list(h.placements)
        split = self._split(hp)
        if self.model_dim is not None:
            split[self.model_dim] = self.m > 1
        nk = len(keys)

        def local(hl, *args):
            return fn(hl, dict(zip(keys, args[:nk])), *args[nk:])

        ins = [hp] + [list(w.placements) for w in ws] + [
            list(a.placements) for a in acts] + [
            list(e.placements) for e in extra]
        grads = [self._grad(hp, split)] + [
            self._grad(w.placements, split) for w in ws] + [
            self._grad(a.placements, split) for a in acts] + [
            list(e.placements) for e in extra]
        outs = self._model_partial(hp)
        if extra_out:
            outs = (outs, *extra_out)
        return self._lmap(local, ins, outs, grads)(h, *ws, *acts, *extra)

    def _zero_unless_first(self, y):
        return y if self.r == 0 else y * 0

    def mlp(self, p, h):
        """The MLP on the gathered rows: its FFN-hidden slice where the
        hidden divides ``|model|``, else all of it on model rank 0 (0 on
        the others); a Partial output.  The replicated hidden bias
        ``b_in`` (the reference's specs leave it whole) is sliced to the
        rank's hidden columns, and ``b_out`` added on model rank 0 alone."""
        cfg = self.cfg
        hf = self.gathered(h)
        keys, ws = self._block_weights(p, set())
        Shard = _dt()[3]
        first = "w_gate" if cfg.activation == "swiglu" else "w_in"
        hsplit = self.m > 1 and isinstance(
            p[first].placements[self.model_dim], Shard)
        zero = self._zero_unless_first
        r = self.r

        def fn(hl, pd):
            if hsplit and "b_out" in pd:
                pd = {**pd, "b_out": zero(pd["b_out"])}
            if hsplit and "b_in" in pd and \
                    pd["b_in"].shape[-1] != pd["w_in"].shape[-1]:
                c = pd["w_in"].shape[-1]
                pd = {**pd, "b_in": pd["b_in"][..., r * c:(r + 1) * c]}
            y = L.mlp_apply(pd, hl, cfg)
            return y if hsplit or self.m == 1 else zero(y)

        return self._block(fn, hf, keys, ws)

    def _attn_weights(self, p, lay):
        gather = set()
        if not lay.q_local:
            gather |= {"wq", "b_q"}
        if not lay.kv_local:
            gather |= {"wk", "wv", "b_k", "b_v"}
        return self._block_weights(p, gather)

    def _project(self, pd, hl, lay, positions):
        """q, k, v of the local heads (all heads where not local), RoPE
        applied at ``positions``."""
        q, k, v = L._project_qkv(pd, hl, lay.cfg_local)
        if self.cfg.rope_theta is not None:
            q = L.apply_rope(q, positions, self.cfg.rope_theta)
            k = L.apply_rope(k, positions, self.cfg.rope_theta)
        return q, k, v

    def _out(self, out, pd, lay):
        """The merged heads (B, S, ·) through ``wo``: this rank's rows of it
        (its heads, or its slice of all heads), or all of ``wo`` on model
        rank 0 where ``wo`` is not sharded."""
        wo = pd["wo"]
        if lay.q_local or self.m == 1:
            return out @ wo
        if wo.shape[0] == out.shape[-1]:       # wo replicated
            return self._zero_unless_first(out @ wo)
        c = wo.shape[0]
        return out[..., self.r * c:(self.r + 1) * c] @ wo

    def attention(self, p, h, *, causal=True, window=None, prefix_len=0):
        """Training attention over the gathered rows (flash forward and
        backward on the local heads), its first ``prefix_len`` keys seen
        by every query (the prefix-LM mask)."""
        cfg, kernels = self.cfg, self.kernels
        hf = self.gathered(h)
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, h.shape[0],
                          h.shape[1], constrain=self.policy.constrain_attn)
        keys, ws = self._attn_weights(p, lay)

        def fn(hl, pd):
            if lay.plain:
                return L.attention_apply(pd, hl, lay.cfg_local,
                                         causal=causal, window=window,
                                         prefix_len=prefix_len,
                                         kernels=kernels)
            b, s, _ = hl.shape
            q, k, v = self._project(pd, hl, lay,
                                    torch.arange(s, device=hl.device))
            k, v = lay.pick(k, v)
            out = L._attend(q, k, v, window=window, q_offset=0,
                            kernels=kernels, causal=causal,
                            prefix_len=prefix_len)
            return self._out(out.transpose(1, 2).reshape(b, s, -1), pd, lay)

        return self._block(fn, hf, keys, ws)

    def _cache_placements(self, shape) -> list:
        pol = self.policy
        return placements(cache_spec_for("k", shape, pol.data_axes,
                                         pol.axis_sizes), self.mesh)

    def attention_prefill(self, p, h, *, window=None, cache_size=None,
                          prefix_len=0):
        """Prefill attention and the layer's decode cache ``{"k", "v"}``,
        placed by ``cache_spec_for``: this rank's KV heads, or its slice of
        the sequence (the context-parallel cache), or all of it; the
        first ``prefix_len`` positions are seen by every query."""
        cfg, kernels = self.cfg, self.kernels
        hf = self.gathered(h)
        b, s = h.shape[0], h.shape[1]
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, b, s)
        keys, ws = self._attn_weights(p, lay)
        width = cache_size or s
        cshape = (b, cfg.num_kv_heads, width, cfg.resolved_head_dim)
        cpl = self._cache_placements(cshape)
        seq_split = self._model_split(cpl, 2)

        def fn(hl, pd):
            if lay.plain:
                return L.attention_prefill(pd, hl, lay.cfg_local,
                                           window=window,
                                           prefix_len=prefix_len,
                                           cache_size=cache_size,
                                           kernels=kernels)
            bl, sl, _ = hl.shape
            q, k, v = self._project(pd, hl, lay,
                                    torch.arange(sl, device=hl.device))
            cache = L.prefill_cache(k, v, cache_size)
            if seq_split:
                w = cache["k"].shape[2] // self.m
                cache = {n: c[:, :, self.r * w:(self.r + 1) * w].contiguous()
                         for n, c in cache.items()}
            kk, vv = lay.pick(k, v)
            out = L._attend(q, kk, vv, window=window, q_offset=0,
                            prefix_len=prefix_len, kernels=kernels)
            return (self._out(out.transpose(1, 2).reshape(bl, sl, -1), pd,
                              lay), cache)

        return self._block(fn, hf, keys, ws, extra_out=(cpl, cpl))

    def attention_decode(self, p, h, cache, cache_len, *, window=None,
                         rolling=False):
        """One decode step: the new key and value written into the layer's
        cache in place (on the rank that holds the slot), attention over
        the cache (gathered over ``"model"`` first where it is the
        sequence-sharded context-parallel cache).  Returns ``(out,
        cache)``."""
        cfg, kernels = self.cfg, self.kernels
        _, _, Replicate, _ = _dt()
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, h.shape[0],
                          h.shape[1])
        keys, ws = self._attn_weights(p, lay)
        hf = self.gathered(h)
        ck, cv = cache["k"], cache["v"]
        cpl = list(ck.placements)
        seq_split = self._model_split(cpl, 2)
        extra = [ck, cv]
        if seq_split:
            full = list(cpl)
            full[self.model_dim] = Replicate()
            extra += [ck.redistribute(self.mesh, full),
                      cv.redistribute(self.mesh, full)]
        width = ck.shape[2]
        slot, q_offset, win = L.decode_slot(cache_len, width, window, rolling)

        def fn(hl, pd, kl, vl, *gathered):
            if lay.plain:
                return L.attention_decode(pd, hl, {"k": kl, "v": vl},
                                          cache_len, lay.cfg_local,
                                          window=window, rolling=rolling,
                                          kernels=kernels)[0]
            bl = hl.shape[0]
            pos = torch.full((1,), cache_len, device=hl.device)
            q, k_new, v_new = self._project(pd, hl, lay, pos)
            kf, vf = gathered if gathered else (kl, vl)
            for c, new in ((kf, k_new), (vf, v_new)):
                c[:, :, slot] = new[:, :, 0].to(c.dtype)
            if gathered:
                w = kl.shape[2]
                if self.r * w <= slot < (self.r + 1) * w:
                    kl[:, :, slot - self.r * w] = kf[:, :, slot]
                    vl[:, :, slot - self.r * w] = vf[:, :, slot]
            kk, vv = lay.pick(kf, vf)
            out = L._attend(q, kk, vv, window=win, q_offset=q_offset,
                            kernels=kernels)
            out = out.to(hl.dtype).transpose(1, 2).reshape(bl, 1, -1)
            return self._out(out, pd, lay)

        return self._block(fn, hf, keys, ws, extra=extra), cache

    # ---------------------------------------------------- cross-attention
    def cross_attention(self, p, h, enc_out):
        """Training cross-attention: queries from the gathered rows of
        ``h``, keys and values from ``enc_out`` (:meth:`cross_input`'s,
        gathered over ``"model"``), bidirectional, on the local heads (all
        of them, from gathered projections, where the heads do not divide
        ``"model"``); ``enc_out``'s gradient comes back a Partial sum over
        the model ranks."""
        cfg, kernels = self.cfg, self.kernels
        hf = self.gathered(h)
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, h.shape[0],
                          h.shape[1], constrain=self.policy.constrain_attn)
        keys, ws = self._attn_weights(p, lay)

        def fn(hl, pd, el):
            if lay.plain:
                return L._cross(pd, hl, el, lay.cfg_local, kernels)[0]
            return self._cross_out(pd, hl, el, lay)[0]

        return self._block(fn, hf, keys, ws, acts=[enc_out])

    def _cross_out(self, pd, hl, el, lay):
        """The gathered-projection cross-attention of one rank: its part of
        the output, and the KV heads it projected."""
        q, k, v = L._project_qkv(pd, hl, lay.cfg_local, kv_input=el)
        kk, vv = lay.pick(k, v)
        out = L._attend(q, kk, vv, causal=False, window=None, q_offset=0,
                        kernels=self.kernels)
        b, s = hl.shape[:2]
        return self._out(out.transpose(1, 2).reshape(b, s, -1), pd, lay), \
            k, v

    def cross_attention_prefill(self, p, h, enc_out):
        """Prefill cross-attention and the decode's ``"cross"`` cache
        ``{"k", "v"}`` of ``(B, Hkv, Se, Dh)``, placed by
        ``cache_spec_for``: this rank's KV heads, its slice of the encoder
        sequence, or all of it."""
        cfg, kernels = self.cfg, self.kernels
        hf = self.gathered(h)
        b = h.shape[0]
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, b, h.shape[1])
        keys, ws = self._attn_weights(p, lay)
        cpl = self._cache_placements((b, cfg.num_kv_heads, enc_out.shape[1],
                                      cfg.resolved_head_dim))
        seq_split = self._model_split(cpl, 2)

        def fn(hl, pd, el):
            if lay.plain:
                return L.cross_attention_prefill(pd, hl, el, lay.cfg_local,
                                                 kernels=kernels)
            out, k, v = self._cross_out(pd, hl, el, lay)
            cache = {"k": k.contiguous(), "v": v.contiguous()}
            if seq_split:
                w = k.shape[2] // self.m
                cache = {n: c[:, :, self.r * w:(self.r + 1) * w].contiguous()
                         for n, c in cache.items()}
            return out, cache

        return self._block(fn, hf, keys, ws, acts=[enc_out],
                           extra_out=(cpl, cpl))

    def cross_attention_decode(self, p, h, enc_cache):
        """One decode step's cross-attention over the ``"cross"`` cache
        (gathered over ``"model"`` first where it splits the encoder
        sequence): a query-only projection, so only ``wq`` (``b_q``) and
        ``wo`` enter the block."""
        cfg, kernels = self.cfg, self.kernels
        _, _, Replicate, _ = _dt()
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, h.shape[0],
                          h.shape[1])
        keys, ws = self._attn_weights({k: p[k] for k in ("wq", "b_q", "wo")
                                       if k in p}, lay)
        hf = self.gathered(h)
        ck, cv = enc_cache["k"], enc_cache["v"]
        if self._model_split(ck.placements, 2):
            full = list(ck.placements)
            full[self.model_dim] = Replicate()
            ck, cv = (ck.redistribute(self.mesh, full),
                      cv.redistribute(self.mesh, full))

        def fn(hl, pd, kl, vl):
            return self._out(L.cross_decode_heads(pd, hl, *lay.pick(kl, vl),
                                                  lay.cfg_local, kernels),
                             pd, lay)

        return self._block(fn, hf, keys, ws, extra=[ck, cv])

    # ------------------------------------------------- mixture of experts
    def _data_rank(self) -> tuple[int, int, list]:
        """This rank's data coordinate (the outer data axis first, so the
        order of the batch's blocks), the number of data coordinates, and
        the mesh dims that split the batch (more than one rank)."""
        names = list(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate()
        dims = [names.index(a) for a in self.policy.data_axes
                if a in names and self.mesh.size(names.index(a)) > 1]
        c, n = 0, 1
        for i in dims:
            c, n = c * self.mesh.size(i) + coord[i], n * self.mesh.size(i)
        return c, n, dims

    def _expert_offsets(self, hf, router, c, dims):
        """The slots of each expert that the earlier data ranks' tokens
        take (E,): every rank routes its rows, the counts (E integers a
        rank) are gathered over the data axes and summed over the ranks
        before this one (the batch is block-sharded, so data-coordinate
        order is token-major order)."""
        _, _, Replicate, Shard = _dt()
        cfg = self.cfg
        pls = [Shard(0) if i in dims else Replicate()
               for i in range(self.mesh.ndim)]

        def fn(hl, rl):
            xf = hl.reshape(-1, hl.shape[-1])
            return L.moe_expert_counts({"router": rl}, xf, cfg)[None]

        with torch.no_grad():
            counts = self._lmap(fn, [list(hf.placements),
                                     list(router.placements)], pls)(
                hf, router)
            every = counts.redistribute(
                self.mesh, [Replicate()] * self.mesh.ndim).to_local()
        return every[:c].sum(0)

    def moe(self, p, h, aux=True):
        """The mixture of experts on the rows gathered over ``"model"``:
        every model rank routes them (the router is replicated, f32), and
        runs its experts (its ``Shard(0)`` block, or where E does not divide
        ``|model|`` its range ``r E / m ..`` of the replicated ones) on the
        choices its data rank's tokens hold, a Partial output.  Slots and
        capacity are the global batch's: each expert's count of the earlier
        data ranks' choices (:meth:`_expert_offsets`) offsets the rank's
        slots, and the capacity is that of all B · S tokens; the rank's
        buffer holds at most its own tokens' slots, ``min(C, T_rank)`` an
        expert.  The Switch auxiliary is built from global sums: each data
        rank's first-choice shares and mean probabilities over its rows
        scaled by its share of the tokens, all-reduced (model rank 0's
        alone, so its gradient reaches the router once); it comes back a
        local scalar, as the loss does.  ``aux=False`` (serving) skips it.
        Returns ``(y, aux)``."""
        _, Partial, Replicate, _ = _dt()
        cfg = self.cfg
        hf = self.gathered(h)
        keys, ws = self._block_weights(p, set())
        e, m, r = cfg.num_experts, self.m, self.r
        lo, hi = r * e // m, (r + 1) * e // m
        b, s = hf.to_local().shape[:2]
        c, nd, dims = self._data_rank()
        t_loc = b * s
        cap = L.moe_capacity(t_loc * nd, cfg)
        if nd > 1:
            cap = min(cap, t_loc)
        offset = (self._expert_offsets(hf, p["router"], c, dims)
                  if nd > 1 else None)
        share, first = 1.0 / nd, r == 0

        def fn(hl, pd):
            xf = hl.reshape(-1, hl.shape[-1])
            probs, top_w, top_i, slot, keep = L.moe_route(
                pd, xf, cfg, offset=offset, tokens=t_loc * nd)
            ex = {k: pd[k] if pd[k].shape[0] == hi - lo else pd[k][lo:hi]
                  for k in ("expert_gate", "expert_up", "expert_down")}
            buf, mine = L.moe_dispatch(xf, top_i, slot, keep, lo, hi - lo,
                                       cap)
            y = L.moe_combine(L.moe_experts(ex, buf), top_i, slot, mine,
                              top_w, lo).reshape(hl.shape)
            if not aux:
                return y
            st = torch.stack([F.one_hot(top_i[:, 0], e).float().mean(0),
                              probs.mean(0)]) * share
            return y, (st if first else st * 0)

        if not aux:
            return self._block(fn, hf, keys, ws), None
        st_pl = [Partial() if (i in dims or (i == self.model_dim and m > 1))
                 else Replicate() for i in range(self.mesh.ndim)]
        y, st = self._block(fn, hf, keys, ws, extra_out=(st_pl,))
        st = st.redistribute(self.mesh, [Replicate()] * self.mesh.ndim)
        return y, L.moe_aux(st[0], st[1], cfg).to_local()

    # ------------------------------------------------------------- Mamba2
    def _ssm_heads(self) -> tuple[bool, int, int]:
        """Whether the SSM heads split over ``"model"`` (they divide it),
        and this rank's heads ``lo, hi`` (all where they do not split)."""
        h = self.cfg.ssm_heads
        if self.m > 1 and h % self.m == 0:
            n = h // self.m
            return True, self.r * n, (self.r + 1) * n
        return False, 0, h

    def _ssm_local(self, pd, lo, hi) -> dict:
        """The pieces of heads ``lo .. hi`` (:func:`layers.mamba2_mix`'s
        ``p``) from the layer's whole ``in_proj``, ``conv_w``, ``conv_b``
        (gathered) and its per-head parameters (this rank's block, or
        whole)."""
        cfg = self.cfg
        di, n, pdim = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_headdim
        c0, c1 = lo * pdim, hi * pdim
        w = pd["in_proj"]
        cols = [(c0, c1), (di + c0, di + c1), (2 * di, 2 * di + 2 * n),
                (2 * di + 2 * n + lo, 2 * di + 2 * n + hi)]
        ch = [(c0, c1), (di, di + 2 * n)]
        out = {"in_proj": torch.cat([w[:, a:b] for a, b in cols], 1),
               "conv_w": torch.cat([pd["conv_w"][:, a:b] for a, b in ch], 1),
               "conv_b": torch.cat([pd["conv_b"][a:b] for a, b in ch])}
        for k in ("a_log", "dt_bias", "d_skip"):
            v = pd[k]
            out[k] = v if v.shape[0] == hi - lo else v[lo:hi]
        return out

    def _ssm_out(self, g, ms, ns, wo, c0, c1, dtype):
        """This rank's part of ``out_proj`` applied to the gated norm: the
        channels ``c0 .. c1`` of ``g`` (which holds them, or all of them;
        ``ms`` the rows' mean square over every channel), normed by their
        ``ssm_norm`` and against their rows of ``out_proj`` (the rank's
        blocks, or slices of whole ones)."""
        n = c1 - c0
        if g.shape[-1] != n:
            g = g[..., c0:c1]
        ns = ns if ns.shape[0] == n else ns[c0:c1]
        wo = wo if wo.shape[0] == n else wo[c0:c1]
        return L._gated_norm(g, {"ssm_norm": ns}, ms).to(dtype) @ wo

    def _conv_block(self, cpl) -> tuple[int, int]:
        """The conv channels of this rank's block of a conv cache placed
        ``cpl``."""
        cd = self.cfg.ssm_d_inner + 2 * self.cfg.ssm_state
        if self._model_split(cpl, 2):
            w = cd // self.m
            return self.r * w, (self.r + 1) * w
        return 0, cd

    def _ssm_cache_placements(self, b):
        cfg, pol = self.cfg, self.policy
        cd = cfg.ssm_d_inner + 2 * cfg.ssm_state
        conv = placements(cache_spec_for(
            "conv", (b, cfg.ssm_conv - 1, cd), pol.data_axes,
            pol.axis_sizes), self.mesh)
        ssm = placements(cache_spec_for(
            "ssm", (b, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
            pol.data_axes, pol.axis_sizes), self.mesh)
        return conv, ssm

    def _ssm_blocks(self, p, hf, f1, first, gather=(), outs_extra=(),
                    extra=()):
        """Run a Mamba2 block on the gathered rows ``hf``: ``f1(hl, pd, r0,
        r1, *extra)`` gives the gated output of this rank's heads and its
        cache pieces (placed ``outs_extra``), where ``r0, r1`` is its head
        range and ``pd`` the parameters ``first`` (those in ``gather``
        gathered over ``"model"``); ``extra`` (caches, serving's
        activations) take no gradient.  Heads over ``"model"``: ``f1``'s
        ``g`` (its channels) and the rows' mean square (Partial) leave the
        first local map, the mean square is all-reduced, and a second
        applies the norm and ``out_proj``'s row block; heads not split: one
        local map."""
        _, _, Replicate, Shard = _dt()
        cfg = self.cfg
        split_h, lo, hi = self._ssm_heads()
        keys, ws = self._block_weights({k: p[k] for k in first},
                                       set(gather) if self.m > 1 else set())
        out_keys = ("ssm_norm", "out_proj")
        rows = list(hf.placements)
        split = self._split(rows)
        if self.model_dim is not None:
            split[self.model_dim] = self.m > 1
        nk, di = len(keys), cfg.ssm_d_inner
        dtype = hf.dtype
        ins_extra = [list(e.placements) for e in extra]
        ins = [rows] + [list(w.placements) for w in ws]
        grads = [self._grad(rows, split)] + [self._grad(w.placements, split)
                                             for w in ws]
        if not split_h:
            ow = [p[k] for k in out_keys]
            keys_all = list(keys) + list(out_keys)
            c0, c1 = self.r * di // self.m, (self.r + 1) * di // self.m

            def fn(hl, *args):
                pd = dict(zip(keys_all, args[:nk + 2]))
                g, *rest = f1(hl, pd, lo, hi, *args[nk + 2:])
                y = self._ssm_out(g, (g * g).mean(-1, keepdim=True),
                                  pd["ssm_norm"], pd["out_proj"], c0, c1,
                                  dtype)
                return (y, *rest) if rest else y

            outs = self._model_partial(rows)
            res = self._lmap(
                fn, ins + [list(w.placements) for w in ow] + ins_extra,
                (outs, *outs_extra) if outs_extra else outs,
                grads + [self._grad(w.placements, split) for w in ow]
                + ins_extra)(hf, *ws, *ow, *extra)
            return (res[0], tuple(res[1:])) if outs_extra else (res, ())
        g_pl = list(rows)
        g_pl[self.model_dim] = Shard(2)
        ms_pl = self._model_partial(rows)
        share = (hi - lo) / cfg.ssm_heads

        def f_heads(hl, *args):
            pd = dict(zip(keys, args[:nk]))
            g, *rest = f1(hl, pd, lo, hi, *args[nk:])
            return (g, (g * g).mean(-1, keepdim=True) * share, *rest)

        g, ms, *rest = self._lmap(f_heads, ins + ins_extra,
                                  (g_pl, ms_pl, *outs_extra),
                                  grads + ins_extra)(hf, *ws, *extra)
        ms = ms.redistribute(self.mesh, [
            Replicate() if i == self.model_dim else pl
            for i, pl in enumerate(ms.placements)])
        ow = [p[k] for k in out_keys]
        c0, c1 = lo * cfg.ssm_headdim, hi * cfg.ssm_headdim

        def f_out(gl, msl, ns, wo):
            return self._ssm_out(gl, msl, ns, wo, c0, c1, dtype)

        ms_in = list(ms.placements)
        y = self._lmap(f_out, [g_pl, ms_in] + [list(w.placements)
                                               for w in ow],
                       self._model_partial(rows),
                       [g_pl, self._grad(ms_in, split)]
                       + [self._grad(w.placements, split) for w in ow])(
            g, ms, *ow)
        return y, tuple(rest)

    def mamba2(self, p, h, cache=True):
        """The Mamba2 mixer on the rows gathered over ``"model"``, heads
        over ``"model"`` where they divide it (else every model rank runs
        every head).  Training (and a prefill where
        :func:`ssm_serves_activations` says the weights are the fewer
        bytes) gathers ``in_proj``, ``conv_w`` and ``conv_b`` over
        ``"model"`` a call (their even cuts do not fall on the heads'
        columns of z, x and dt, and every head reads all of B and C), their
        gradients reduce-scattered back; a rank projects only its heads'
        columns and B, C.  Other prefills gather the projected activations
        instead (:meth:`_ssm_serve`).  The gated norm's mean square over
        every head is all-reduced between two local maps (see
        :meth:`_ssm_blocks`).  ``cache`` (prefill) adds the decode cache
        placed by ``cache_spec_for``: the ``ssm`` state by heads, the
        ``conv`` tail by an even cut of its channels (a rank projects the
        last K-1 rows onto its block's channels).  Returns ``(y, cache or
        None)``."""
        cfg = self.cfg
        hf = self.gathered(h)
        b, s = hf.to_local().shape[:2]
        if cache and self.m > 1 and ssm_serves_activations(cfg, b * s):
            return self._ssm_serve(p, hf)
        b = hf.shape[0]
        kc = cfg.ssm_conv - 1
        di = cfg.ssm_d_inner
        cpl = self._ssm_cache_placements(b) if cache else ()
        clo, chi = self._conv_block(cpl[0]) if cache else (0, 0)
        split_h = self._ssm_heads()[0]

        def f1(hl, pd, lo, hi):
            pl = self._ssm_local(pd, lo, hi) if split_h else pd
            g, c = L.mamba2_mix(pl, hl, cfg, heads=hi - lo)
            if not cache:
                return (g,)
            if not split_h:
                conv = c["conv"]
                if (clo, chi) != (0, conv.shape[-1]):
                    conv = conv[..., clo:chi].contiguous()
            else:
                conv = hl[:, -kc:] @ pd["in_proj"][:, di + clo:di + chi]
            return g, conv, c["ssm"]

        y, caches = self._ssm_blocks(
            p, hf, f1, ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
                        "d_skip"), {"in_proj", "conv_w", "conv_b"}, cpl)
        if not cache:
            return y, None
        return y, {"conv": caches[0], "ssm": caches[1]}

    def mamba2_decode(self, p, h, cache):
        """One decode step of the Mamba2 mixer (heads as :meth:`mamba2`),
        by the projected activations (:meth:`_ssm_serve`); the cache's
        entries are replaced by the new ones, placed as before.  Returns
        ``(y, cache)``."""
        y, new = self._ssm_serve(p, self.gathered(h), cache)
        cache.update(new)
        return y, cache

    def _ssm_serve(self, p, hf, cache=None):
        """A serving Mamba2 call on the gathered rows ``hf`` by their
        projected activations: a prefill (``cache`` None) or one decode
        step from ``cache``.  Each rank projects the rows onto its block of
        ``in_proj``'s columns and the blocks [z | x, B, C | dt] are
        gathered over ``"model"``; the conv runs on the rank's block of
        the channels (its ``conv_w``, ``conv_b`` and conv cache blocks, so
        the new tail, the block's last K-1 inputs, stays where it is), and
        its SiLU'd output is gathered over ``"model"``; then each rank's
        heads, the norm and ``out_proj`` as :meth:`_ssm_blocks` runs them.
        No weight moves.  Returns ``(y, {"conv": tail, "ssm": state})``,
        placed by ``cache_spec_for``."""
        _, _, _, Shard = _dt()
        cfg, md = self.cfg, self.model_dim
        di, n, pdim = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_headdim
        rows = list(hf.placements)
        cpl = ([list(cache["conv"].placements), list(cache["ssm"].placements)]
               if cache is not None else self._ssm_cache_placements(
                   hf.shape[0]))

        def cut(w):
            # the placements of an activation whose last dim is w's columns
            pls = list(rows)
            if self.m > 1 and isinstance(w.placements[md], Shard):
                pls[md] = Shard(2)
            return pls

        w = p["in_proj"]
        zx_pl = cut(w)
        zx = self._lmap(lambda hl, wl: hl @ wl, [rows, list(w.placements)],
                        zx_pl)(hf, w)
        if zx_pl != rows:
            zx = zx.redistribute(self.mesh, rows)
        clo, chi = self._conv_block(cpl[0])
        xc_pl = cut(p["conv_w"])
        if (xc_pl != rows) != ((clo, chi) != (0, di + 2 * n)):
            raise ValueError("the conv cache's channels are not cut as "
                             "conv_w's")
        state = [] if cache is None else [cache["conv"]]

        def f_conv(zl, wl, bl, *cl):
            y, tail = L._causal_depthwise_conv(
                zl[..., di + clo:di + chi], wl, bl, cl[0] if cl else None)
            return F.silu(y), tail

        xbc, tail = self._lmap(
            f_conv, [rows, list(p["conv_w"].placements),
                     list(p["conv_b"].placements)] + [cpl[0]] * len(state),
            (xc_pl, cpl[0]))(zx, p["conv_w"], p["conv_b"], *state)
        if xc_pl != rows:
            xbc = xbc.redistribute(self.mesh, rows)

        def f1(hl, pd, lo, hi, zl, xl, *sl):
            c0, c1 = lo * pdim, hi * pdim
            z = zl[..., c0:c1]
            dt_raw = zl[..., 2 * di + 2 * n + lo:2 * di + 2 * n + hi]
            if (lo, hi) != (0, cfg.ssm_heads):
                xl = torch.cat([xl[..., c0:c1], xl[..., di:]], -1)
            pl = {k: v if v.shape[0] == hi - lo else v[lo:hi]
                  for k, v in pd.items()}
            if cache is None:
                return L.mamba2_ssd(pl, z, xl, dt_raw, cfg, hi - lo)
            return L.mamba2_step(pl, z, xl, dt_raw, sl[0], cfg, hi - lo)

        y, (ssm,) = self._ssm_blocks(
            p, hf, f1, ("a_log", "dt_bias", "d_skip"), (), (cpl[1],),
            [zx, xbc] + ([] if cache is None else [cache["ssm"]]))
        return y, {"conv": tail, "ssm": ssm}

    # ---------------------------------------------------- the model's ends
    def _head(self):
        m = self.model
        return m.embed if self.cfg.tie_embeddings else m.lm_head

    def loss(self, h, labels):
        """Summed nll and count of the unmasked labels on each rank's rows
        (the tied head gathered), both all-reduced, then divided."""
        from .transformer import chunked_ce_sum
        _, _, Replicate, _ = _dt()

        cfg, tied = self.cfg, self.cfg.tie_embeddings
        hp = list(h.placements)
        # the labels' rows placed as the residual's
        labels = self.policy.constrain(labels,
                                       P(*self.policy.residual_spec()[:2]))
        head = self._head()
        rep = [Replicate()] * self.mesh.ndim
        if list(head.placements) != rep:
            # a whole head (whisper's) is not redistributed: its gradient
            # stays a Partial sum until the step sums it with the lookup's
            head = head.redistribute(self.mesh, rep)
        split = self._split(hp)

        def fn(hl, ll, wl):
            b, s, d = hl.shape
            chunk = b * s if cfg.scan_unroll else 4096
            tot, cnt = chunked_ce_sum(hl.reshape(b * s, d),
                                      wl.T if tied else wl, ll.reshape(-1),
                                      chunk=chunk)
            return torch.stack([tot, cnt])

        _, Partial, _, _ = _dt()
        out = [Partial() if sp else Replicate() for sp in split]
        lp = list(labels.placements)
        sums = self._lmap(fn, [hp, lp, rep], out,
                          [hp, lp, self._grad(rep, split)])(h, labels, head)
        sums = sums.redistribute(self.mesh, rep).to_local()
        return sums[0] / torch.clamp_min(sums[1], 1.0)

    def logits(self, x, delta):
        """The last position's logits (B, V) float32: the final norm on the
        last position of the gathered stream, against this rank's
        vocabulary columns (placed ``P(data, "model")``)."""
        cfg, kernels = self.cfg, self.kernels
        model = self.model
        xg, dg = self.gathered(x), self.gathered(delta)
        keys = list(model.final_norm.keys())
        ws = [model.final_norm[k] for k in keys]
        head = self._head()
        Shard = _dt()[3]
        vsplit = (self.model_dim is not None
                  and isinstance(head.placements[self.model_dim], Shard))
        tied = cfg.tie_embeddings

        def fn(xl, dl, hw, *norm):
            pd = dict(zip(keys, norm))
            _, hn = L.add_norm_apply(pd, xl[:, -1:].contiguous(),
                                     dl[:, -1:].contiguous(), cfg,
                                     kernels=kernels)
            w = hw.T if tied else hw
            return hn[:, 0].float() @ w.float()

        xp = list(xg.placements)
        out = list(xp)
        if self.model_dim is not None:
            out[self.model_dim] = Shard(1) if vsplit else xp[self.model_dim]
        ins = [xp, xp, list(head.placements)] + [list(w.placements)
                                                  for w in ws]
        return self._lmap(fn, ins, out)(xg, dg, head, *ws)


def ssm_serves_activations(cfg, rows: int) -> bool:
    """Whether a prefill's Mamba2 block on ``rows`` rows a rank (gathered
    over ``"model"``) gathers its projected activations there rather than
    the layer's weights: the rows' [z | x, B, C | dt] and conv output,
    ``rows · (cols + C)`` elements, against ``in_proj``, ``conv_w`` and
    ``conv_b``, ``d · cols + (K + 1) · C`` (C the conv channels).  A decode
    step always gathers activations (its B rows' against the weights and
    the conv cache); training always gathers the weights, whose gradients
    reduce-scatter back (at jamba's train_4k on (16, 16) the activations
    are 2.18 GB, the weights 136 MB)."""
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    cols, cd = 2 * di + 2 * n + cfg.ssm_heads, di + 2 * n
    return rows * (cols + cd) < cfg.d_model * cols + (cfg.ssm_conv + 1) * cd


# ---------------------------------------------------------------------------
# the collectives' bytes in closed form
# ---------------------------------------------------------------------------

def step_collective_bytes(cfg, kind: str, batch: int, seq: int, policy,
                          *, cache_width: int | None = None) -> dict:
    """The bytes one rank's collectives move in one sharded step of
    ``kind`` (``"train"``: loss, backward, gradient sums and AdamW's clip;
    ``"prefill"`` of ``seq`` tokens; ``"decode"``: one step against caches
    of ``cache_width`` slots), by kind of collective, worked out from the
    specs as :class:`ShardedOps` places them: each collective counts its
    input and its output (``launch/staged_backend.py``'s count), a gather
    of a local block of ``n`` bytes over ``k`` ranks ``n (1 + k)``, a
    reduce-scatter the same, an all-reduce ``2 n``.  ``policy`` carries the
    mesh's axis sizes and its two options: with ``seq_shard_residual``
    the sequence is split over ``"model"`` in training and prefill
    (``seq`` divisible) and each sub-layer gathers it and reduce-scatters
    its output; without, each sub-layer's output is all-reduced (``2 n``
    of the whole sequence's block), in the backward too, and nothing is
    gathered; without ``constrain_attn`` training attention (and the
    encoder's, which runs the training form) gathers the
    ``"model"``-sharded query, key and value projections.  ``seq`` is the
    token sequence: a prefix-LM's residual holds ``prefix_tokens`` more
    rows.  The vocabulary split over ``"model"`` makes the embedding a
    Partial block, reduce-scattered; a whole one (whisper's) looks up the
    residual's rows where they hold no prefix, and its tied head's
    gradient is all-reduced whole.  An encoder-decoder adds the encoder's
    blocks on its ``encoder_seq`` rows (split over ``"model"`` where they
    divide it, else each block all-reduced), its output gathered once, a
    cross-attention block in each decoder layer (its gradient summed back
    once, not checkpointed) and in decode the ``"cross"`` cache gathered
    where it splits the encoder sequence.  An MoE block adds the experts'
    counts (E int64) gathered over the data axes a call and, in training,
    the Switch auxiliary's (2, E) f32 sums all-reduced over every dim that
    splits the rows or the experts; a Mamba2 block gathers ``in_proj``,
    ``conv_w`` and ``conv_b`` over ``"model"`` a call in training (their
    gradients summed back as attention's gathered projections') and in a
    prefill where :func:`ssm_serves_activations` says so, else (decode
    too) the rows' projected activations and conv output, and it
    all-reduces the rows' f32 mean square over ``"model"`` where its
    heads split there (forward, replay and backward).  Covers a batch split over all the data
    axes; with ``cfg.remat`` the backward replays each decoder layer's
    forward up to its last saved input (the layer's last block's
    collective is not replayed)."""
    from .transformer import Transformer

    sizes = policy.axis_sizes
    m = sizes.get(policy.model_axis, 1) if policy.model_axis else 1
    ddims = [sizes[a] for a in policy.data_axes]
    dsplit = [n for n in ddims if n > 1]
    b = batch // int(np.prod(ddims or [1]))
    e = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    d, hkv, dh = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    meta = Transformer(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    size = {n: p.element_size() for n, p in meta.named_parameters()}
    specs = policy.param_specs(shapes)

    def sharded(name):
        s = policy._sanitize(specs[name], shapes[name])
        return any(policy.model_axis in (x if isinstance(x, tuple) else (x,))
                   for x in s if x is not None)

    def numel(name):
        return int(np.prod(shapes[name]))

    sp = policy.seq_shard_residual
    vsplit = m > 1 and sharded("embed")
    if m > 1 and cfg.prefix_tokens and not vsplit:
        raise NotImplementedError("the closed form takes a prefix-LM's "
                                  "vocabulary split over 'model'")
    if batch % int(np.prod(ddims or [1])):
        raise NotImplementedError("the closed form takes the batch split "
                                  "over all the data axes")
    sd = 1 if kind == "decode" else seq + cfg.prefix_tokens
    if kind != "decode" and m > 1 and sp and sd % m:
        raise NotImplementedError("the closed form takes the sequence split "
                                  "over 'model'")
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    lay = _AttnLayout(cfg, policy, m, 0, batch, seq,
                      constrain=kind != "train" or policy.constrain_attn)
    lay_enc = _AttnLayout(cfg, policy, m, 0, batch, seq,
                          constrain=policy.constrain_attn)

    def gathered(prefix, lay):
        return [n for n in shapes if n.startswith(prefix) and m > 1
                and sharded(n) and (
                    (n.endswith((".wq", ".b_q")) and not lay.q_local)
                    or (n.endswith((".wk", ".wv", ".b_k", ".b_v"))
                        and not lay.kv_local))]

    # a Mamba2 layer gathers in_proj and the conv's weights every call of
    # training (and of a prefill where they are the fewer bytes); serving
    # otherwise gathers the projected activations
    ssm_w = [n for n in shapes if n.startswith("layers.") and m > 1
             and sharded(n) and n.endswith((".mamba.in_proj",
                                            ".mamba.conv_w", ".mamba.conv_b"))]
    ssm_acts = kind == "decode" or (kind == "prefill" and ssm_serves_activations(
        cfg, b * (seq + cfg.prefix_tokens)))
    dec_g = gathered("layers.", lay) + ([] if ssm_acts else ssm_w)
    if kind == "decode":
        # a decode's cross-attention projects its query alone
        dec_g = [n for n in dec_g if ".cross." not in n
                 or n.endswith((".wq", ".b_q"))]
    n_enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    enc_g = gathered("encoder.0.", lay_enc) if n_enc else []

    def w_gather(names):
        return sum(size[n] * numel(n) // m * (1 + m) for n in names)

    def gather_over(nbytes, dims):
        """An all-gather over several mesh dims, the inner one first."""
        tot = 0
        for k in reversed(dims):
            tot += nbytes * (1 + k)
            nbytes *= k
        return tot

    n_layers = cfg.num_layers
    subs = list(cfg.super_block) * cfg.num_repeats
    n_attn = sum(sl.mixer == "attention" for sl in subs)
    n_ssm = len(subs) - n_attn
    n_moe = sum(sl.ffn == "moe" for sl in subs)
    # MoE: the experts' counts (E int64) gathered over the data axes; the
    # Switch auxiliary's (2, E) f32 sums all-reduced over every dim that
    # splits the rows or the experts (training)
    moe_count = gather_over(8 * cfg.num_experts, dsplit) if n_moe else 0
    moe_aux = 2 * 8 * cfg.num_experts * (len(dsplit) + int(m > 1))
    # Mamba2 with its heads over "model": the rows' mean square (f32)
    # all-reduced over "model" a call
    ssm_split = bool(n_ssm) and m > 1 and cfg.ssm_heads % m == 0
    ssm_ms = 2 * 4 * b * sd if ssm_split else 0
    # blocks a decoder layer runs: its mixer, cross-attention, FFN
    per_rep = sum(1 + sl.cross_attention + (sl.ffn != "none")
                  for sl in cfg.super_block)
    n_blocks = per_rep * cfg.num_repeats
    n_cross = sum(sl.cross_attention for sl in cfg.super_block) \
        * cfg.num_repeats
    reduced = kind == "decode" or not sp        # all-reduced block outputs
    if m == 1:
        act = 0
    elif reduced:
        act = 2 * e * b * d * sd
    else:
        act = e * b * d * (sd // m + sd)        # a gather or a scatter
    blocks = n_blocks + int(vsplit)             # and the embedding's
    # the encoder's rows: split over "model" where they divide it
    se = cfg.encoder_seq
    enc_split = bool(n_enc) and m > 1 and sp and se % m == 0
    if m == 1 or not n_enc:
        act_e = 0
    elif enc_split:
        act_e = e * b * d * (se // m + se)
    else:
        act_e = 2 * e * b * d * se
    if kind in ("prefill", "decode"):
        if reduced:
            out["all_reduce"] += blocks * act
        out["all_gather"] += n_moe * moe_count
        out["all_reduce"] += n_ssm * ssm_ms
        if ssm_acts and n_ssm:
            # the rows' [z | x, B, C | dt] and the conv's SiLU'd output
            # gathered over "model" where in_proj's columns and the conv's
            # channels are cut there, a Mamba2 layer
            di, ns = cfg.ssm_d_inner, cfg.ssm_state
            for tail, width in ((".mamba.in_proj",
                                 2 * di + 2 * ns + cfg.ssm_heads),
                                (".mamba.conv_w", di + 2 * ns)):
                if any(n.endswith(tail) for n in ssm_w):
                    out["all_gather"] += n_ssm * e * b * sd * (
                        width // m) * (1 + m)
        if kind == "decode":
            if m > 1 and not lay.kv_local and cache_width and \
                    cache_width % m == 0 and hkv % m:
                # the context-parallel cache gathered, k and v, a layer
                out["all_gather"] += n_attn * 2 * e * b * hkv * dh * (
                    cache_width // m + cache_width)
            if m > 1 and hkv % m and se % m == 0:
                # the cross cache split over the encoder's sequence
                out["all_gather"] += n_cross * 2 * e * b * hkv * dh * (
                    se // m + se)
        elif not reduced:
            out["reduce_scatter"] += blocks * act
            out["all_gather"] += (n_blocks + 2) * act   # + x, delta
        out["all_gather"] += w_gather(dec_g)
        if kind == "prefill" and n_enc:
            if enc_split:
                # two blocks a layer, then the output gathered once
                out["all_gather"] += (2 * n_enc + 1) * act_e
                out["reduce_scatter"] += 2 * n_enc * act_e
            else:
                out["all_reduce"] += 2 * n_enc * act_e
            out["all_gather"] += n_enc * w_gather(enc_g)
        return out
    # train: forward, the layers' replay, backward
    replay = n_blocks - n_layers if cfg.remat else 0
    if reduced:
        # a block's output all-reduced, those replayed; in the backward
        # each block input's Partial gradient all-reduced
        out["all_reduce"] += (blocks + replay + n_blocks) * act
    else:
        rep_ag = n_blocks if cfg.remat else 0
        out["all_gather"] += (n_blocks + rep_ag + blocks) * act
        out["reduce_scatter"] += (blocks + replay + n_blocks) * act
    if n_enc:
        # the encoder's blocks, forward and backward (no replay), its
        # output gathered and its gradient summed back once
        if enc_split:
            out["all_gather"] += (4 * n_enc + 1) * act_e
            out["reduce_scatter"] += (4 * n_enc + 1) * act_e
        else:
            out["all_reduce"] += (4 * n_enc + 1) * act_e
    reps = 1 + int(cfg.remat)
    # the MoE's count exchange and auxiliary, the Mamba2 mean square: each
    # layer's forward and its replay; the mean square's gradient too
    out["all_gather"] += n_moe * reps * moe_count
    out["all_reduce"] += n_moe * reps * moe_aux + n_ssm * (
        reps + 1) * ssm_ms
    out["all_gather"] += reps * w_gather(dec_g) + n_enc * w_gather(enc_g)
    # the gathered weights' gradients: summed over the data ranks whole,
    # then reduce-scattered over "model"
    full = sum(size[n] * numel(n) for n in dec_g) + sum(
        size[n] * numel(n) for n in enc_g) * n_enc
    out["all_reduce"] += 2 * full * len(dsplit)
    out["reduce_scatter"] += full + full // m if m > 1 else 0
    head = "embed" if cfg.tie_embeddings else "lm_head"
    hb = e * numel(head)
    if sharded(head):
        if m > 1:
            out["all_gather"] += hb // m * (1 + m)
            # its gradient a Partial sum over "model" where the loss's rows
            # are split there (reduce-scattered); with the sequence
            # replicated, every model rank holds it whole
            if sp:
                out["reduce_scatter"] += hb + hb // m
        out["all_reduce"] += 2 * hb * len(dsplit)
        if cfg.tie_embeddings:
            # the embedding's own gradient, summed over the data ranks when
            # the head's (already summed) is added to it
            out["all_reduce"] += 2 * hb // m * len(dsplit)
    else:
        # a whole head: its gradient (with a tied one the lookup's, Partial
        # over the same dims) all-reduced over every dim that splits rows
        out["all_reduce"] += 2 * hb * (len(dsplit) + int(m > 1 and sp))
    # the loss's sum and count: one all-reduce a dim that splits the rows
    out["all_reduce"] += 2 * 8 * (len(dsplit) + int(m > 1 and sp))
    # the other gradients summed into their parameters' placements
    gset = set(dec_g) | {
        f"encoder.{i}.{n[len('encoder.0.'):]}" for n in enc_g
        for i in range(n_enc)}
    for n in shapes:
        if n in gset or n == head:
            continue
        norm = (".norm" in n and n.endswith(("scale", "bias"))) \
            or n.startswith(("final_norm", "encoder_norm"))
        pb = numel(n) * size[n]
        if sharded(n):
            out["all_reduce"] += 2 * pb // m * len(dsplit)
            continue
        # replicated over "model": its gradient is a partial sum over every
        # rank of a block that splits the work there (an attention, cross-
        # attention, MLP, MoE or Mamba2 block always does; a norm's rows, or
        # a whole embedding's lookup, only with the rows split)
        in_block = any(g in n for g in (".attn.", ".mlp.", ".cross.",
                                        ".moe.", ".mamba."))
        rows = enc_split if n.startswith("encoder") else sp
        if n == "embed":
            rows = sp and not cfg.prefix_tokens
        over_m = int(m > 1 and (((norm or n == "embed") and rows)
                                or in_block))
        out["all_reduce"] += 2 * pb * (len(dsplit) + over_m)
    # AdamW's clip: the sharded gradients' sums of squares, one all-reduce
    n_sh = sum(1 for n in shapes if sharded(n))
    if m > 1 and n_sh:
        out["all_reduce"] += 2 * 4 * n_sh
    return out

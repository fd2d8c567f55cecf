"""The dense decoder on a mesh of ranks: tensor (Megatron) and sequence
parallelism over ``"model"``, data parallelism over the data axes, as
DTensors (the port's counterpart of the reference's GSPMD sharding, whose
policy is ``models/sharding.py``).

Parameters are DTensors placed by their sanitized ``param_specs``; the
batch is sharded over the data axes; between sub-layers the residual
stream is placed by ``policy.residual`` (batch over data, sequence over
``"model"``).  Each sub-layer runs as ONE ``local_map`` on the ranks'
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
  rank's vocabulary rows, ``Partial``, reduce-scattered like a sub-layer;
- the loss gathers the tied head once (one all-gather) and sums the nll
  and counts the unmasked labels of the rank's rows; both sums are
  all-reduced and divided, never a mean of the ranks' means.

Inside a ``local_map`` a rank's result is its part of a sum over the
ranks, so every input the block holds replicated over a dim that splits
the work gets its gradient back ``Partial`` there (``in_grad_placements``).
Decode caches are placed by ``cache_spec_for``: heads over ``"model"``,
or, where the KV heads do not divide it, the sequence (the context-
parallel cache, gathered over ``"model"`` before each decode step's
kernel).
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L
from .sharding import P, cache_spec_for, placements

__all__ = ["ShardedOps", "param_placements", "shard_tensor",
           "local_shard"]


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
    all, with the KV heads this rank's query heads read picked from them."""

    def __init__(self, cfg, policy, m: int, r: int, b: int, s: int):
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        qspec = policy._sanitize(policy.attn_act_spec(), (b, h, s, dh))
        self.q_local = m == 1 or qspec[1] is not None
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
        """The lookup of ``tokens`` (B, S): with the vocabulary over
        ``"model"``, each rank looks up the tokens in its rows (0 for the
        others), a Partial sum.  RoPE models only (``check_shardable``):
        ``offset`` places no positions here."""
        w = self.model.embed
        Shard = _dt()[3]
        vsplit = (self.model_dim is not None and self.m > 1
                  and isinstance(w.placements[self.model_dim], Shard))
        r = self.r
        tpl = list(tokens.placements)
        out = list(tpl)
        if self.model_dim is not None:
            out = self._model_partial(tpl) if vsplit else tpl

        def fn(tl, wl):
            if not vsplit:
                return F.embedding(tl, wl)
            n = wl.shape[0]
            idx = tl - r * n
            valid = (idx >= 0) & (idx < n)
            rows = F.embedding(idx.clamp(0, n - 1), wl)
            return rows * valid[..., None].to(wl.dtype)

        split = self._split(tpl)
        return self._lmap(fn, [tpl, list(w.placements)], out,
                          [tpl, self._grad(w.placements, split)])(tokens, w)

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

    def _block(self, fn, h, keys, ws, extra=(), extra_out=()):
        """Run ``fn(h_local, params_dict, *extra_local)`` on every rank: its
        part of a sum over the model ranks, plus ``extra_out`` placed
        outputs (prefill caches)."""
        hp = list(h.placements)
        split = self._split(hp)
        if self.model_dim is not None:
            split[self.model_dim] = self.m > 1
        nk = len(keys)

        def local(hl, *args):
            return fn(hl, dict(zip(keys, args[:nk])), *args[nk:])

        ins = [hp] + [list(w.placements) for w in ws] + [
            list(e.placements) for e in extra]
        grads = [self._grad(hp, split)] + [
            self._grad(w.placements, split) for w in ws] + [
            list(e.placements) for e in extra]
        outs = self._model_partial(hp)
        if extra_out:
            outs = (outs, *extra_out)
        return self._lmap(local, ins, outs, grads)(h, *ws, *extra)

    def _zero_unless_first(self, y):
        return y if self.r == 0 else y * 0

    def mlp(self, p, h):
        """The MLP on the gathered rows: its FFN-hidden slice where the
        hidden divides ``|model|``, else all of it on model rank 0 (0 on
        the others); a Partial output."""
        cfg = self.cfg
        hf = self.gathered(h)
        keys, ws = self._block_weights(p, set())
        Shard = _dt()[3]
        first = "w_gate" if cfg.activation == "swiglu" else "w_in"
        hsplit = self.m > 1 and isinstance(
            p[first].placements[self.model_dim], Shard)
        zero = self._zero_unless_first

        def fn(hl, pd):
            if self.m > 1 and "b_out" in pd:
                pd = {**pd, "b_out": zero(pd["b_out"])} if hsplit else pd
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

    def attention(self, p, h, *, causal=True, window=None):
        """Training attention over the gathered rows (flash forward and
        backward on the local heads)."""
        cfg, kernels = self.cfg, self.kernels
        hf = self.gathered(h)
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, h.shape[0],
                          h.shape[1])
        keys, ws = self._attn_weights(p, lay)

        def fn(hl, pd):
            if lay.plain:
                return L.attention_apply(pd, hl, lay.cfg_local,
                                         causal=causal, window=window,
                                         kernels=kernels)
            b, s, _ = hl.shape
            q, k, v = self._project(pd, hl, lay,
                                    torch.arange(s, device=hl.device))
            k, v = lay.pick(k, v)
            out = L._attend(q, k, v, window=window, q_offset=0,
                            kernels=kernels, causal=causal)
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
        the sequence (the context-parallel cache), or all of it.  A mesh
        runs no prefix (``check_shardable``): ``prefix_len`` is 0."""
        cfg, kernels = self.cfg, self.kernels
        hf = self.gathered(h)
        b, s = h.shape[0], h.shape[1]
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, b, s)
        keys, ws = self._attn_weights(p, lay)
        width = cache_size or s
        cshape = (b, cfg.num_kv_heads, width, cfg.resolved_head_dim)
        cpl = self._cache_placements(cshape)
        Shard = _dt()[3]
        seq_split = (self.model_dim is not None and self.m > 1
                     and isinstance(cpl[self.model_dim], Shard)
                     and cpl[self.model_dim].dim == 2)

        def fn(hl, pd):
            if lay.plain:
                return L.attention_prefill(pd, hl, lay.cfg_local,
                                           window=window,
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
                            kernels=kernels)
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
        _, _, Replicate, Shard = _dt()
        lay = _AttnLayout(cfg, self.policy, self.m, self.r, h.shape[0],
                          h.shape[1])
        keys, ws = self._attn_weights(p, lay)
        hf = self.gathered(h)
        ck, cv = cache["k"], cache["v"]
        cpl = list(ck.placements)
        seq_split = (self.model_dim is not None and self.m > 1
                     and isinstance(cpl[self.model_dim], Shard)
                     and cpl[self.model_dim].dim == 2)
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
        labels = self.policy.constrain(labels, P(self.policy.data_axes,
                                                 self.policy.model_axis))
        head = self._head()
        rep = [Replicate()] * self.mesh.ndim
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
    mesh's axis sizes.  Covers the dense decoders with the sequence split
    over ``"model"`` in training and prefill (``seq`` divisible), the
    vocabulary split over ``"model"`` and a batch split over all the data
    axes; with ``cfg.remat`` the backward replays each layer's forward up
    to its last saved input (the MLP's reduce-scatter is not replayed)."""
    from .transformer import Transformer

    sizes = policy.axis_sizes
    m = sizes.get(policy.model_axis, 1) if policy.model_axis else 1
    ddims = [sizes[a] for a in policy.data_axes]
    dsplit = [n for n in ddims if n > 1]
    b = batch // int(np.prod(ddims or [1]))
    e = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    meta = Transformer(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    specs = policy.param_specs(shapes)

    def sharded(name):
        s = policy._sanitize(specs[name], shapes[name])
        return any(policy.model_axis in (x if isinstance(x, tuple) else (x,))
                   for x in s if x is not None)

    def numel(name):
        return int(np.prod(shapes[name]))

    if m > 1 and not sharded("embed"):
        raise NotImplementedError("the closed form takes a vocabulary split "
                                  "over 'model'")
    if kind != "decode" and m > 1 and seq % m:
        raise NotImplementedError("the closed form takes the sequence split "
                                  "over 'model'")
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    lay = _AttnLayout(cfg, policy, m, 0, batch, seq)
    layer0 = [n for n in shapes if n.startswith("layers.0.")]
    gathered = [n for n in layer0 if m > 1 and sharded(n) and (
        (n.endswith((".wq", ".b_q")) and not lay.q_local)
        or (n.endswith((".wk", ".wv", ".b_k", ".b_v")) and not lay.kv_local))]
    w_gather = sum(e * numel(n) // m * (1 + m) for n in gathered)
    n_layers = cfg.num_layers
    if m == 1:
        act = 0
    elif kind == "decode":
        act = 2 * e * b * d                     # an all-reduce a block
    else:
        act = e * b * d * (seq // m + seq)      # a gather or a scatter
    blocks = 2 * n_layers + 1                   # two a layer, the embedding
    if kind in ("prefill", "decode"):
        if kind == "decode":
            out["all_reduce"] += blocks * act
            if m > 1 and not lay.kv_local and cache_width and \
                    cache_width % m == 0 and hkv % m:
                # the context-parallel cache gathered, k and v, a layer
                out["all_gather"] += n_layers * 2 * e * b * hkv * dh * (
                    cache_width // m + cache_width)
        else:
            out["reduce_scatter"] += blocks * act
            out["all_gather"] += (2 * n_layers + 2) * act   # + x, delta
        out["all_gather"] += n_layers * w_gather
        return out
    # train: forward, the layers' replay, backward
    fwd_ag, fwd_rs = 2 * n_layers, 2 * n_layers + 1
    rep_ag, rep_rs = (2 * n_layers, n_layers) if cfg.remat else (0, 0)
    out["all_gather"] += (fwd_ag + rep_ag + fwd_rs) * act
    out["reduce_scatter"] += (fwd_rs + rep_rs + fwd_ag) * act
    reps = 1 + int(cfg.remat)
    out["all_gather"] += n_layers * reps * w_gather
    # the gathered weights' gradients: summed over the data ranks whole,
    # then reduce-scattered over "model"
    full = sum(e * numel(n) for n in gathered) * n_layers
    out["all_reduce"] += 2 * full * len(dsplit)
    out["reduce_scatter"] += full + full // m if m > 1 else 0
    head = "embed" if cfg.tie_embeddings else "lm_head"
    hb = e * numel(head)
    if m > 1:
        out["all_gather"] += hb // m * (1 + m)
        out["reduce_scatter"] += hb + hb // m
    out["all_reduce"] += 2 * hb * len(dsplit)
    # the loss's sum and count: one all-reduce a dim that splits the rows
    out["all_reduce"] += 2 * 8 * (len(dsplit) + int(m > 1))
    # the other gradients summed into their parameters' placements
    gset = {f"layers.{i}.{n[len('layers.0.'):]}" for n in gathered
            for i in range(n_layers)}
    ff_split = m == 1 or sharded(
        "layers.0.mlp.w_gate" if cfg.activation == "swiglu"
        else "layers.0.mlp.w_in")
    for n in shapes:
        if n in gset or n == head:
            continue
        pb = numel(n) * (4 if n.endswith(("scale", "bias")) and ".norm"
                         in n or n.startswith("final_norm") else e)
        if sharded(n):
            out["all_reduce"] += 2 * pb // m * len(dsplit)
            continue
        # replicated over "model": its gradient is a partial sum over every
        # rank of a block that splits the work there
        mlp_rep = ".mlp." in n and not ff_split
        norm = ".norm" in n or n.startswith("final_norm")
        over_m = int(m > 1 and (norm or mlp_rep))
        out["all_reduce"] += 2 * pb * (len(dsplit) + over_m)
    if cfg.tie_embeddings:
        # the embedding's own gradient, summed over the data ranks when
        # the head's (already summed) is added to it
        out["all_reduce"] += 2 * hb // m * len(dsplit)
    # AdamW's clip: the sharded gradients' sums of squares, one all-reduce
    n_sh = sum(1 for n in shapes if sharded(n))
    if m > 1 and n_sh:
        out["all_reduce"] += 2 * 4 * n_sh
    return out

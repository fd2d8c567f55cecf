"""What one rank of the partition mesh's async, feature-store and
checkpoint tests runs (``tests/test_torch_mesh_async.py``,
``tests/test_torch_mesh_resume.py``).

Like ``_torch_mesh_ranks.py`` (whose graph, engines and start params it
reuses), it imports nothing of JAX, so a spawned gloo rank starts in a few
seconds; the same helpers build the stacked and oracle runs the tests hold
the ranks against.
"""
import os

import numpy as np
import torch

import _torch_mesh_ranks as mr
from repro_torch.core.sampler import build_device_epoch_sampler
from repro_torch.pipeline import EATConfig, run_eat_distgnn
from repro_torch.robustness import FaultPlan, InjectedCrash

ASYNC = ("async0", "async1")
HOT_FRACS = (0.25, 1.0)
# the reference's robustness settings (tests/test_robustness.py _PIPE_KW:
# 6 epochs, phase0_fraction 0.5, so boundary 1 falls in phase 0 and
# boundary 4 in phase 1)
RESUME_BASE = dict(dataset="tiny", batch_size=32, hidden_dim=mr.HIDDEN,
                   fanouts=(3, 3), max_epochs=6, phase0_fraction=0.5,
                   seed=7, keep_checkpoints=6, device="cpu")
RESUME_PATHS = {"sampled": {},
                "async": {"async_generalize": True,
                          "async_personalize": True},
                "feat_store": {"feat_store": True, "hot_frac": 0.5},
                "float64": {"dtype": "float64"}}
CRASHES = (1, 4)


def budgets(P: int) -> np.ndarray:
    """Async phase-1 budgets: a 0 and one past the epoch among them."""
    return np.array([2, 0, 1, 9][:P] if P > 1 else [2], np.int32)


def device_sampler(g, P: int, dtype, **store):
    """The device sampler every rank (and the stacked engine) attaches:
    the CBS mini-epoch over each partition's train nodes, batches of 8."""
    parts = mr.tiny_parts(g, P)
    host_train = [g.train_idx[parts[g.train_idx] == p] for p in range(P)]
    return build_device_epoch_sampler(
        g, host_train, P, batch_size=8, subset_fraction=0.25,
        class_balanced=True, fanouts=(3, 3), dtype=dtype, device="cpu",
        **store)


class Recording:
    """A device sampler that keeps a copy of every batch it makes."""

    def __init__(self, ds):
        self._ds = ds
        self.batches = []

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def make_batch(self, *args, **kw):
        batch = self._ds.make_batch(*args, **kw)
        self.batches.append({k: v.clone() for k, v in batch.items()})
        return batch


def run_async(eng, opt, g, P: int, what: str, ds, dtype,
              seed: int = 11) -> dict:
    """One async epoch of ``eng`` from a fixed start (the seed-2 params
    and a fresh optimizer state; per-partition params that start apart for
    phase 1), drawn with a generator seeded ``seed``: params, losses, val
    micro, optimizer step (and moments), and the batches the engine
    made."""
    rec = Recording(ds)
    eng.set_device_sampler(rec)
    gen = torch.Generator().manual_seed(seed)
    params = mr.start_params(g, dtype)
    if what == "async0":
        out = eng.phase0_epoch_async(params, opt.init(params.parameters()),
                                     gen)
        res = {"params": mr._weights(out[0]), "losses": out[2],
               "val": out[3], "step": out[1].step}
    else:
        pp = mr.per_partition_start(params, P)
        out = eng.phase1_epoch_async(pp, opt.init_stacked(pp.parameters()),
                                     gen, budgets(P), params)
        res = {"params": mr._weights(out[0]), "losses": out[2],
               "val": out[3], "step": out[1].step,
               "mu": [m.clone() for m in out[1].mu]}
    res["batches"] = rec.batches
    return res


def store_runs(g, pg, P: int, mode: str) -> dict:
    """For the resident engine and the store at each of ``HOT_FRACS``: the
    evals and export from fixed params, both async epochs (batches left
    out), and the engine's ``cold_h2d_bytes`` and resident bytes after
    them."""
    out = {}
    for hf in (None, *HOT_FRACS):
        kw = {} if hf is None else {"feat_store": True, "hot_frac": hf}
        eng, opt = mr.engine(pg, g, mode, torch.float32, **kw)
        run = {"eval": mr.eval_and_export(eng, g, P)}
        ds = device_sampler(g, P, torch.float32, **kw)
        for what in ASYNC:
            r = run_async(eng, opt, g, P, what, ds, torch.float32)
            r.pop("batches")
            run[what] = r
        run["bytes"] = (eng.cold_h2d_bytes, eng.resident_feature_bytes)
        out[hf] = run
    return out


def async_pipeline(P: int, mode: str, **kw):
    """``run_eat_distgnn`` with both async flags on tiny (P = 1: one
    partition, not centralized, so phase 1 runs)."""
    return run_eat_distgnn(mr.pipeline_config(
        P, mode, async_generalize=True, async_personalize=True, **kw))


def digest(res) -> dict:
    """``mr.pipeline_digest`` with every byte counter the resume checks
    compare, and ``cold_h2d_bytes`` apart (a resumed run's holds only the
    resumed part, as the stacked engine's does)."""
    out = mr.pipeline_digest(res)
    out["bytes"] = (*out["bytes"], res.comm_halo_bytes_phase0,
                    res.comm_halo_bytes_phase1,
                    res.host_to_device_bytes_phase1)
    out["cold"] = res.cold_h2d_bytes
    out["phase1_epochs"] = res.phase1_epochs
    out["start"] = res.personalize_start_epoch
    return out


# --------------------------------------------------------------- replay

class RankReplay:
    """Hands the engine the epoch and batches the reference's sampler drew
    (``tests/test_torch_mesh_async.py`` makes them in the parent): the
    stacked ``(P, I, B)`` epoch, and each ``make_batch`` call the next
    iteration's batch cut to ``rows``.  The generator is ignored."""

    cold_host = None

    def __init__(self, epoch, batches):
        self.epoch = epoch
        self.batches = batches
        self.num_batches = len(batches)
        self.made = 0

    def draw_epoch(self, gen):
        return self.epoch

    def make_batch(self, gen, nodes, valid, rows=None):
        i = self.made
        self.made += 1
        assert torch.equal(nodes, self.epoch[0][:, i])
        assert torch.equal(valid, self.epoch[1][:, i])
        b = self.batches[i]
        return b if rows is None else {k: v[rows] for k, v in b.items()}


def replay_runs(path: str) -> dict:
    """Both async epochs on the reference's replayed batches, from the
    converted start state the parent saved in ``path``."""
    src = torch.load(path, weights_only=False)
    g, pg = mr.tiny_case(4)
    out = {}
    for what in ASYNC:
        eng, opt = mr.engine(pg, g, "spmd", torch.float32)
        rp = RankReplay(*src[what]["replay"])
        eng.set_device_sampler(rp)
        params, st = src[what]["start"]
        if what == "async0":
            p, st, losses, val, _ = eng.phase0_epoch_async(params, st, None)
        else:
            p, st, losses, val, _ = eng.phase1_epoch_async(
                params, st, None, src[what]["budgets"], src[what]["global"])
        out[what] = {"params": mr._weights(p), "losses": losses, "val": val,
                     "step": st.step, "made": rp.made}
    return out


def async_world(rank: int, P: int, replay_path: str | None) -> dict:
    """Everything one rank of the async/store world reports: the async
    epochs in float64 and float32 (with their batches), the store's runs,
    the async pipeline alone and with the store, and (the world of 4) the
    reference's replayed epochs."""
    g, pg = mr.tiny_case(P)
    out = {}
    for dtype in (torch.float64, torch.float32):
        ds = device_sampler(g, P, dtype)
        for what in ASYNC:
            eng, opt = mr.engine(pg, g, "spmd", dtype)
            out[what, str(dtype)] = run_async(eng, opt, g, P, what, ds,
                                              dtype)
    out["store"] = store_runs(g, pg, P, "spmd")
    out["pipeline"] = digest(async_pipeline(P, "spmd"))
    out["pipeline_store"] = digest(async_pipeline(P, "spmd", feat_store=True,
                                                  hot_frac=0.5))
    if replay_path is not None:
        out["replay"] = replay_runs(replay_path)
    return out


# --------------------------------------------------------------- resume

def resume_config(P: int, mode: str, path: str, **kw) -> EATConfig:
    return EATConfig(num_parts=P, engine_mode=mode,
                     **{**RESUME_BASE, **RESUME_PATHS[path], **kw})


def resume_world(rank: int, P: int, workdir: str, stacked_dir: str) -> dict:
    """For every path of ``RESUME_PATHS``: the uninterrupted run, then for
    each boundary of ``CRASHES`` a run killed there (checkpoints in
    ``workdir``, every one kept) and its resume; then a resume from the
    stacked engine's archives in ``stacked_dir``, which must be refused."""
    out = {}
    for path in RESUME_PATHS:
        out[path] = digest(run_eat_distgnn(resume_config(P, "spmd", path)))
        for crash in CRASHES:
            ck = os.path.join(workdir, f"{path}_{crash}")
            try:
                run_eat_distgnn(resume_config(P, "spmd", path,
                                              checkpoint_dir=ck),
                                fault_plan=FaultPlan(
                                    crash_epochs=frozenset({crash})))
                crashed = None
            except InjectedCrash as e:
                crashed = e.epoch
            res = run_eat_distgnn(resume_config(P, "spmd", path,
                                                checkpoint_dir=ck,
                                                resume=True))
            out[path, crash] = {"crashed": crashed, "run": digest(res),
                                "resumed_from": res.resumed_from_epoch}
    try:
        run_eat_distgnn(resume_config(P, "spmd", "async",
                                      checkpoint_dir=stacked_dir,
                                      resume=True))
        out["refused"] = "no refusal"
    except ValueError as e:
        out["refused"] = str(e)
    return out


def crash_ranks(rank: int, crashing: tuple) -> str:
    """The ranks in ``crashing`` raise an injected crash, the others
    return."""
    if rank in crashing:
        raise InjectedCrash(3)
    return "returned"

"""Kill-and-resume, fault plans and float64 runs of the port's pipeline on
tiny, with the reference's robustness settings (``tests/test_robustness.py``
``_PIPE_KW``: 6 epochs, ``phase0_fraction`` 0.5, so boundary 1 falls in
phase 0 and boundary 4 in phase 1):

1. A run crashed by an injected fault at boundary 1 or 4 and resumed from
   its checkpoint is bitwise the uninterrupted port run (final params,
   histories, F1, byte counters) on the sampled (double-buffered),
   full-graph, async, halo cache + int8 + top-k, feature-store, sequential
   and float64 paths; ``checkpoint_every``/``keep_checkpoints``; the
   fingerprint refusal.
2. A float64 run of the stacked engine matches the sequential oracle to
   rel 1e-12.
3. The straggler and dropped-refresh plan gives the reference's exchange
   history and straggler seconds.
4. Against one reference run with ``checkpoint_dir``: the port's archives
   have the reference's entries and host blob; the port resumes the
   reference's step-1 archive; the train and serve CLIs' robustness flags
   run on the CPU.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.pipeline import EATConfig, run_eat_distgnn
from repro_torch.robustness import FaultPlan, InjectedCrash

# the reference's _PIPE_KW without its halo cache (full_graph_train refuses
# the cache); the cache path adds it back
BASE = dict(dataset="tiny", num_parts=4, batch_size=32, hidden_dim=16,
            fanouts=(3, 3), max_epochs=6, phase0_fraction=0.5, seed=7,
            engine_mode="stacked")
REF_KW = dict(BASE, halo_cache=True, halo_refresh_every=2)
PATHS = {
    "sampled": {},
    "full_graph": {"full_graph_train": True},
    "async": {"async_generalize": True, "async_personalize": True},
    # phase 1 stages the device sampler: a resume in phase 1 stages it
    # again and must not count its bytes twice
    "async_phase1": {"async_personalize": True},
    "cache_int8_topk": {"halo_cache": True, "halo_refresh_every": 2,
                        "halo_compress": "int8", "grad_compress": "topk"},
    "feat_store": {"feat_store": True, "hot_frac": 0.5},
    "sequential": {"engine_mode": "sequential"},
    "float64": {"dtype": "float64"},
}
# tests/test_torch_pipeline.py's tolerance against another run's float32
# arithmetic
LOSS_RTOL, F1_ATOL = 1e-4, 0.01
REL64 = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its runs are tiny, and
    beside the other test workers a thread per core oversubscribes the
    CPU (a run then takes ~20x as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return EATConfig(device="cpu", **kw)


_BASELINES: dict = {}


def _baseline(name):
    if name not in _BASELINES:
        _BASELINES[name] = run_eat_distgnn(_cfg(**dict(BASE, **PATHS[name])))
    return _BASELINES[name]


def _assert_same_run(res, base):
    got, want = (list(r.final_params.parameters()) for r in (res, base))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), \
            "resumed final params are not bitwise the uninterrupted run's"
    assert res.loss_history == base.loss_history
    assert res.val_history == base.val_history
    assert res.f1.micro == base.f1.micro
    assert res.halo_exchange_history == base.halo_exchange_history
    assert res.phase0_iter_history == base.phase0_iter_history
    for k in ("comm_grad_bytes", "comm_halo_bytes", "comm_halo_bytes_phase0",
              "comm_halo_bytes_phase1", "comm_halo_exchange_bytes",
              "host_to_device_bytes_phase0", "host_to_device_bytes_phase1",
              "epochs_run", "personalize_start_epoch", "phase1_epochs"):
        assert getattr(res, k) == getattr(base, k), k


def _crash(kw, ck, epoch, **extra):
    with pytest.raises(InjectedCrash) as ei:
        run_eat_distgnn(_cfg(**kw, checkpoint_dir=ck, **extra),
                        fault_plan=FaultPlan(crash_epochs=frozenset({epoch})))
    assert ei.value.epoch == epoch


@pytest.mark.parametrize("crash", [1, 4], ids=["phase0", "phase1"])
@pytest.mark.parametrize("path", list(PATHS))
def test_kill_and_resume_bitwise(tmp_path, path, crash):
    kw = dict(BASE, **PATHS[path])
    ck = str(tmp_path / "ck")
    _crash(kw, ck, crash)
    res = run_eat_distgnn(_cfg(**kw, checkpoint_dir=ck, resume=True))
    assert res.resumed_from_epoch == crash
    assert res.summary()["resumed_from_epoch"] == crash
    _assert_same_run(res, _baseline(path))


def test_checkpoint_every_and_keep(tmp_path):
    ck = str(tmp_path / "ck")
    every = dict(checkpoint_every=2, keep_checkpoints=2)
    _crash(BASE, ck, 5, **every)           # boundary 5 saves nothing
    from repro_torch.robustness import RunCheckpointer
    assert RunCheckpointer(ck).steps() == [2, 4]
    assert sorted(n for n in os.listdir(ck) if n.endswith(".npz")) == [
        "ckpt_000002.npz", "ckpt_000004.npz"]
    res = run_eat_distgnn(_cfg(**BASE, checkpoint_dir=ck, resume=True,
                               **every))
    assert res.resumed_from_epoch == 4
    _assert_same_run(res, _baseline("sampled"))
    assert RunCheckpointer(ck).steps() == [4, 6]


def test_resume_refuses_a_foreign_fingerprint(tmp_path):
    ck = str(tmp_path / "ck")
    _crash(BASE, ck, 1)
    with pytest.raises(ValueError, match="refusing to resume"):
        run_eat_distgnn(_cfg(**dict(BASE, seed=8), checkpoint_dir=ck,
                             resume=True))
    with pytest.raises(ValueError, match="refusing to resume"):
        run_eat_distgnn(_cfg(**BASE, dtype="float64", checkpoint_dir=ck,
                             resume=True))


def test_resume_falls_back_past_a_corrupt_archive(tmp_path):
    ck = str(tmp_path / "ck")
    _crash(BASE, ck, 4)
    FaultPlan(seed=1).corrupt(os.path.join(ck, "ckpt_000004.npz"))
    res = run_eat_distgnn(_cfg(**BASE, checkpoint_dir=ck, resume=True))
    assert res.resumed_from_epoch == 3
    _assert_same_run(res, _baseline("sampled"))


@pytest.mark.parametrize("extra", [{}, {"full_graph_train": True}],
                         ids=["sampled", "full_graph"])
def test_float64_stacked_matches_oracle(extra):
    runs = [run_eat_distgnn(_cfg(**dict(BASE, **extra, dtype="float64",
                                        engine_mode=mode)))
            for mode in ("stacked", "sequential")]
    a, b = runs
    assert (a.engine_mode, b.engine_mode) == ("stacked", "sequential")
    for x, y in zip(a.final_params.parameters(), b.final_params.parameters()):
        assert x.dtype == torch.float64
        torch.testing.assert_close(x, y, rtol=REL64, atol=0)
    np.testing.assert_allclose(a.loss_history, b.loss_history, rtol=REL64)
    assert a.val_history == b.val_history and a.f1.micro == b.f1.micro
    assert a.comm_halo_bytes == b.comm_halo_bytes


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """One reference run with checkpoint_dir (every step kept) and the
    port's run of the same configuration with its own checkpoints."""
    from repro.pipeline import EATConfig as JEATConfig
    from repro.pipeline import run_eat_distgnn as j_run
    root = tmp_path_factory.mktemp("ref")
    ref = j_run(JEATConfig(**REF_KW, checkpoint_dir=str(root / "ref"),
                           keep_checkpoints=6))
    port = run_eat_distgnn(_cfg(**REF_KW, checkpoint_dir=str(root / "port"),
                                keep_checkpoints=6))
    return root, ref, port


def _archive(d, step):
    with np.load(os.path.join(d, f"ckpt_{step:06d}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(d, f"ckpt_{step:06d}.npz.meta.json")) as f:
        host = json.load(f)["meta"]["host"]
    return arrays, host


@pytest.mark.parametrize("step", [1, 4])
def test_archives_have_the_references_entries(reference_run, step):
    root, _, _ = reference_run
    (ra, rh), (pa, ph) = (_archive(str(root / w), step)
                          for w in ("ref", "port"))
    assert set(pa) == set(ra)
    for k in ra:
        assert pa[k].shape == ra[k].shape and pa[k].dtype == ra[k].dtype, k
    assert set(ph) == set(rh)
    assert ph["rng"] == rh["rng"]
    assert ph["fingerprint"] == rh["fingerprint"]
    for k in ("phase", "epoch", "personalize_start_epoch"):
        assert ph["controller"][k] == rh["controller"][k], k
    assert ph["has_phase1"] == rh["has_phase1"] == (step == 4)
    assert ph["halo_age"] == rh["halo_age"]
    assert ph["halo_exchange_hist"] == rh["halo_exchange_hist"]
    assert ph["p0_iter_hist"] == rh["p0_iter_hist"]
    # the controller's histories are the run's losses, in f32 arithmetic
    np.testing.assert_allclose(ph["loss_hist"], rh["loss_hist"],
                               rtol=LOSS_RTOL)


def test_port_resumes_the_references_archive(reference_run, tmp_path):
    root, _, port = reference_run
    ck = tmp_path / "ck"
    os.mkdir(ck)
    for f in ("ckpt_000001.npz", "ckpt_000001.npz.meta.json"):
        shutil.copy(root / "ref" / f, ck / f)
    with open(ck / "manifest.json", "w") as f:
        json.dump({"steps": [1], "entries": {}}, f)
    res = run_eat_distgnn(_cfg(**REF_KW, checkpoint_dir=str(ck),
                               resume=True))
    assert res.resumed_from_epoch == 1
    assert res.epochs_run == port.epochs_run
    assert res.halo_exchange_history == port.halo_exchange_history
    np.testing.assert_allclose(res.loss_history, port.loss_history,
                               rtol=LOSS_RTOL)
    assert abs(res.f1.micro - port.f1.micro) <= F1_ATOL


def test_fault_plan_run_matches_the_references(reference_run):
    from repro.pipeline import EATConfig as JEATConfig
    from repro.pipeline import run_eat_distgnn as j_run
    from repro.robustness import FaultPlan as JFaultPlan
    _, ref, port = reference_run
    plan = dict(straggler={1: {2: 0.75}}, drop_refresh_epochs=frozenset({2}))
    want = j_run(JEATConfig(**REF_KW), fault_plan=JFaultPlan(**plan))
    got = run_eat_distgnn(_cfg(**REF_KW), fault_plan=FaultPlan(**plan))
    assert got.halo_exchange_history == want.halo_exchange_history
    assert got.straggler_delay_s == want.straggler_delay_s == 0.75
    assert got.summary()["straggler_delay_s"] == 0.75
    # epoch 2's full refresh was due and its payload dropped
    assert port.halo_exchange_history[2] > 0 == got.halo_exchange_history[2]
    assert got.halo_exchange_history[4] == port.halo_exchange_history[4]
    assert ref.halo_exchange_history == port.halo_exchange_history


def test_robustness_clis_on_cpu(reference_run, tmp_path, capsys):
    """``launch.train``'s checkpoint and fault flags, and ``launch.serve``'s
    ``--checkpoint`` on a model the reference saved and
    ``--fail-partition``."""
    import jax
    from repro.train.checkpoint import save_pytree as j_save
    from repro_torch.launch.serve import build_parser, gnn_main
    from repro_torch.launch.train import main
    _, ref, _ = reference_run
    ck = str(tmp_path / "ck")
    argv = ["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs", "4",
            "--hidden", "8", "--batch-size", "64", "--fanout", "3",
            "--phase0-frac", "0.5", "--halo-cache", "--halo-refresh-every",
            "2", "--checkpoint-dir", ck, "--checkpoint-every", "1",
            "--keep-checkpoints", "2"]
    assert main(argv + ["--crash-at-epoch", "1", "--drop-refresh-at",
                        "0"]) == 1
    assert "injected crash after epoch 1" in capsys.readouterr().err
    assert main(argv + ["--resume", "--drop-refresh-at", "0"]) == 0
    out = capsys.readouterr().out
    assert "[resume] epoch 1 phase 0" in out
    assert '"resumed_from_epoch": 1' in out
    assert sorted(n for n in os.listdir(ck) if n.endswith(".npz")) == [
        "ckpt_000003.npz", "ckpt_000004.npz"]

    model = str(tmp_path / "best.npz")
    j_save(model, jax.tree.map(lambda x: x[0], ref.final_params))
    args = build_parser().parse_args(
        ["--gnn", "--device", "cpu", "--dataset", "tiny", "--hidden", "16",
         "--ticks", "20", "--checkpoint", model, "--fail-partition", "1",
         "--fail-at-tick", "5", "--recover-after-ticks", "8"])
    run = gnn_main(args)
    want = np.asarray(ref.final_params.layers[0].w_self[0])
    assert np.array_equal(run["params"].layers[0].w_self.detach().numpy(),
                          want)
    failed = [i + 1 for i, h in enumerate(run["health"]) if h[1] == "failed"]
    assert failed == list(range(5, 13))
    assert run["stats"]["failovers"] == run["stats"]["recoveries"] == 1
    assert run["stats"]["degraded_queries"] == run["stale_answers"] > 0
    assert "degraded mode: 1 failover(s)" in capsys.readouterr().out

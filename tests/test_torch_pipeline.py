"""run_eat_distgnn end to end on tiny against the reference pipeline, with
the phase switch pinned (phase0_fraction): the sampled path, the
full-graph path, the centralized full-graph path, the overlapped split
forward (full-graph, and sampled with the reference's ring exchange) and the
sequential oracle's full-graph path; and the train CLI on the CPU."""
import numpy as np
import pytest
import torch

from repro.pipeline import EATConfig as JEATConfig
from repro.pipeline import run_eat_distgnn as j_run_eat_distgnn
from repro_torch.pipeline import EATConfig, run_eat_distgnn
from _torch_threads import one_torch_thread  # noqa: F401

BASE = dict(dataset="tiny", num_parts=4, max_epochs=6, hidden_dim=16,
            batch_size=64, fanouts=(5, 5), phase0_fraction=0.5, seed=0)
# losses after up to six epochs of float32 AdamW steps whose gradients sum
# in another order than XLA's; F1 may flip a few test predictions
LOSS_RTOL, F1_ATOL = 1e-4, 0.01


@pytest.mark.parametrize("extra", [
    {}, {"full_graph_train": True},
    {"full_graph_train": True, "centralized": True, "max_epochs": 4},
    {"overlap_halo": True, "full_graph_train": True},
    {"overlap_halo": True, "ring_chunks": 2},
    {"engine_mode": "sequential", "full_graph_train": True}],
    ids=["sampled", "full_graph", "centralized", "overlap_full_graph",
         "overlap_ring", "sequential_full_graph"])
def test_pipeline_matches_reference(extra):
    kw = dict(BASE, **extra)
    got = run_eat_distgnn(EATConfig(device="cpu", **kw))
    want = j_run_eat_distgnn(JEATConfig(**kw))
    # the same partition, the same schedule
    assert np.array_equal(got.partition_entropies, want.partition_entropies)
    assert got.halo_bytes_per_layer == want.halo_bytes_per_layer
    assert got.phase0_iter_history == want.phase0_iter_history
    assert got.epochs_run == want.epochs_run
    assert got.personalize_start_epoch == want.personalize_start_epoch
    assert got.phase1_epochs == want.phase1_epochs
    assert (got.comm_grad_bytes, got.comm_halo_bytes) == (
        want.comm_grad_bytes, want.comm_halo_bytes)
    assert got.host_to_device_bytes_phase0 == want.host_to_device_bytes_phase0
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=LOSS_RTOL)
    assert abs(got.f1.micro - want.f1.micro) <= F1_ATOL
    assert got.engine_mode == want.engine_mode == (
        "sequential" if kw.get("engine_mode") == "sequential" else "stacked")
    assert set(got.summary()) == set(want.summary())
    assert np.isfinite(got.loss_history).all()


def test_train_cli_on_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs",
                 "3", "--hidden", "8", "--batch-size", "64", "--fanout", "4",
                 "--full-graph-train", "--phase0-frac", "0.34"]) == 0
    out = capsys.readouterr().out
    assert "[phase-0] epoch" in out and "[phase-1] epoch" in out
    assert '"full_graph_train": true' in out
    # the llm mode is ported (ROADMAP item 15.1): it trains, here on the CPU
    assert main(["llm", "--device", "cpu", "--shards", "2", "--d-model",
                 "32", "--seq", "8", "--docs", "32", "--steps", "2",
                 "--phase0-frac", "0.5"]) == 0
    assert '"phase1_final_loss"' in capsys.readouterr().out


@pytest.mark.parametrize("option,value", [
    ("async_generalize,halo_cache", True), ("halo_cache", True),
    ("halo_compress", "int8"), ("grad_compress", "topk")])
def test_communication_options_run(option, value):
    """The options ROADMAP item 10 ports run, alone or beside the async
    flags (``option`` may name several, comma-separated)."""
    r = run_eat_distgnn(EATConfig(
        device="cpu", dataset="tiny", max_epochs=2, hidden_dim=8,
        batch_size=64, fanouts=(3, 3), phase0_fraction=0.5,
        **{o: value for o in option.split(",")}))
    assert np.isfinite(r.loss_history).all() and r.epochs_run == 2
    assert len(r.halo_exchange_history) == 2
    assert r.comm_halo_exchange_bytes == sum(r.halo_exchange_history) > 0


@pytest.mark.parametrize("option,value,item", [
    ("async_personalize,feat_store", True, 11), ("feat_store", True, 11),
    ("checkpoint_dir", "ckpt", 12), ("resume", True, 12)])
def test_unported_options_raise(option, value, item, tmp_path):
    """Every option of items 11 and 12 is ported and runs, alone or beside
    the async flags (``option`` may name several, comma-separated): the
    feature store stages cold rows; ``checkpoint_dir`` writes the retained
    steps and a crashed run leaves its boundary on disk; ``resume``
    continues it bitwise the uninterrupted run."""
    from repro_torch.robustness import (FaultPlan, InjectedCrash,
                                        RunCheckpointer)
    small = dict(device="cpu", dataset="tiny", max_epochs=2, hidden_dim=8,
                 batch_size=64, fanouts=(3, 3), phase0_fraction=0.5)
    if item == 11:
        r = run_eat_distgnn(EATConfig(
            **small, **{o: value for o in option.split(",")}))
        assert np.isfinite(r.loss_history).all() and r.epochs_run == 2
        assert r.cold_h2d_bytes > 0 and r.summary()["feat_store"]
        return
    ck = str(tmp_path / "ckpt")
    if option == "checkpoint_dir":
        r = run_eat_distgnn(EATConfig(**small, checkpoint_dir=ck))
        assert np.isfinite(r.loss_history).all() and r.epochs_run == 2
        assert RunCheckpointer(ck).steps() == [1, 2]
        assert r.resumed_from_epoch == -1
        return
    base = run_eat_distgnn(EATConfig(**small))
    with pytest.raises(InjectedCrash):
        run_eat_distgnn(EATConfig(**small, checkpoint_dir=ck),
                        fault_plan=FaultPlan(crash_epochs=frozenset({1})))
    r = run_eat_distgnn(EATConfig(**small, checkpoint_dir=ck, resume=value))
    assert r.resumed_from_epoch == 1
    assert r.loss_history == base.loss_history
    for a, b in zip(r.final_params.parameters(),
                    base.final_params.parameters()):
        assert torch.equal(a, b)

"""Checkpoint/resume on the partition mesh (``engine_mode="spmd"``, ROADMAP
item 14 part 2) on the CPU: one world of 4 gloo ranks spawned for the
module (``repro_torch.launch.mesh``) on tiny with hidden 32, with the
reference's robustness settings (6 epochs, ``phase0_fraction`` 0.5: boundary
1 falls in phase 0, boundary 4 in phase 1); rank functions in
``tests/_torch_mesh_part2_ranks.py``.

1. A run killed by an injected crash at boundary 1 or 4 and resumed from
   its checkpoints is bitwise the uninterrupted mesh run (final params,
   histories, F1, byte counters) on the sampled, async, feature-store and
   float64 paths; every rank crashes at the boundary and reports the same
   ``resumed_from_epoch``.
2. Rank 0 writes the archives: their entries (keys, shapes, dtypes) and
   host blob are a stacked run's, the fingerprint differing only in its
   ``engine``; a stacked run's archives are refused on the mesh.
3. ``spawn_partition_world`` re-raises an injected crash that every rank
   raised, and fails the world when only some did;
   ``launch.train gnn --engine spmd --parts 2`` with ``--crash-at-epoch
   1`` exits 1 with the ``train gnn: ...`` line on stderr, and ``--resume``
   exits 0 with the uninterrupted run's summary.
"""
import json
import os

import numpy as np
import pytest
import torch

import _torch_mesh_part2_ranks as m2
from repro_torch.launch.mesh import spawn_partition_world
from repro_torch.pipeline import run_eat_distgnn
from repro_torch.train.checkpoint import load_meta

P = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the ranks: P + 1 processes share
    the host's cores."""
    saved = os.environ.get("OMP_NUM_THREADS"), torch.get_num_threads()
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    yield
    if saved[0] is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = saved[0]
    torch.set_num_threads(saved[1])


@pytest.fixture(scope="module")
def stacked_dir(tmp_path_factory):
    """The archives of a stacked async run of the same configuration."""
    d = str(tmp_path_factory.mktemp("stacked") / "ck")
    run_eat_distgnn(m2.resume_config(P, "stacked", "async", checkpoint_dir=d))
    return d


@pytest.fixture(scope="module")
def world(tmp_path_factory, stacked_dir):
    workdir = tmp_path_factory.mktemp("mesh")
    outs = spawn_partition_world(
        m2.resume_world, P, (P, str(workdir / "ck"), stacked_dir),
        device="cpu", workdir=str(workdir), timeout_s=60,
        join_timeout_s=240)
    return outs, str(workdir / "ck")


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("crash", m2.CRASHES, ids=["phase0", "phase1"])
@pytest.mark.parametrize("path", list(m2.RESUME_PATHS))
def test_kill_and_resume_bitwise(world, path, crash):
    outs, _ = world
    got, base = outs[0][path, crash], outs[0][path]
    assert got["crashed"] == crash and got["resumed_from"] == crash
    assert base["epochs"] == 6 and 0 < len(base["iters"]) < 6
    if path == "float64":
        assert all(w.dtype == torch.float64 for w in base["params"])
    # a resumed run's cold_h2d_bytes holds only the resumed part
    drop = lambda d: {k: v for k, v in d.items() if k != "cold"}
    assert _equal(drop(got["run"]), drop(base))


def test_every_rank_crashes_and_resumes_alike(world):
    outs, _ = world
    for r in range(1, P):
        for path in m2.RESUME_PATHS:
            for crash in m2.CRASHES:
                a, b = outs[r][path, crash], outs[0][path, crash]
                assert a["crashed"] == b["crashed"] == crash, (r, path)
                assert a["resumed_from"] == b["resumed_from"], (r, path)
                assert _equal(a["run"], b["run"]), (r, path, crash)


@pytest.mark.parametrize("step", [1, 4])
def test_archives_have_the_stacked_runs_entries(world, stacked_dir, step):
    _, ck = world
    name = f"ckpt_{step:06d}.npz"
    # the async run killed at boundary 1 and resumed: every step kept
    mesh_npz = os.path.join(ck, "async_1", name)
    got, want = np.load(mesh_npz), np.load(os.path.join(stacked_dir, name))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    host, ref = load_meta(mesh_npz)["host"], load_meta(
        os.path.join(stacked_dir, name))["host"]
    assert sorted(host) == sorted(ref)
    fp, fp_ref = host["fingerprint"], ref["fingerprint"]
    assert fp["engine"] == "spmd" and fp_ref["engine"] == "stacked"
    assert {**fp, "engine": "stacked"} == fp_ref
    assert host["rng"] == ref["rng"] and host["controller"] == ref["controller"]
    for k in ("comm", "p0_iter_hist", "host_to_device_p0",
              "host_to_device_p1", "halo_exchange_hist"):
        assert host[k] == ref[k], k


def test_a_stacked_archive_is_refused_on_the_mesh(world):
    outs, _ = world
    for r in range(P):
        msg = outs[r]["refused"]
        assert "fingerprint" in msg and "refusing to resume" in msg, msg


def test_a_world_reraises_a_crash_only_every_rank_raised(tmp_path):
    """``spawn_partition_world(reraise=)``: an injected crash on every rank
    comes out as itself; on only some ranks, as a ``RuntimeError``."""
    from repro_torch.robustness import InjectedCrash
    kw = dict(device="cpu", timeout_s=60, join_timeout_s=60,
              reraise=(InjectedCrash,))
    with pytest.raises(InjectedCrash) as ei:
        spawn_partition_world(m2.crash_ranks, 2, ((0, 1),),
                              workdir=str(tmp_path), **kw)
    assert ei.value.epoch == 3
    with pytest.raises(RuntimeError, match=r"ranks \[1\] of 2 raised"):
        spawn_partition_world(m2.crash_ranks, 2, ((1,),),
                              workdir=str(tmp_path), **kw)


def test_train_cli_crash_and_resume(tmp_path, capsys):
    """The mesh CLI ends an injected crash as the stacked one does, and
    its resume prints the uninterrupted run's summary."""
    from repro_torch.launch.train import main
    base = ["gnn", "--device", "cpu", "--dataset", "tiny", "--epochs", "4",
            "--hidden", "8", "--batch-size", "64", "--fanout", "3",
            "--phase0-frac", "0.5", "--parts", "2", "--engine", "spmd",
            "--async-generalize", "--async-personalize"]
    summary = lambda out: json.loads(out[out.index("{"):])
    assert main(base) == 0
    want = summary(capsys.readouterr().out)
    ck = ["--checkpoint-dir", str(tmp_path / "ck")]
    assert main(base + ck + ["--crash-at-epoch", "1"]) == 1
    err = capsys.readouterr().err
    assert "train gnn: injected crash after epoch 1" in err, err
    assert main(base + ck + ["--resume"]) == 0
    got = summary(capsys.readouterr().out)
    assert got["resumed_from_epoch"] == 1 and want["resumed_from_epoch"] == -1
    timing = {"train_time_s", "epoch_time_s", "epoch_time_with_eval_s",
              "partition_time_s", "phase1_time_s", "resumed_from_epoch"}
    assert got["engine"] == "spmd" and got["epochs"] == 4
    assert ({k: v for k, v in got.items() if k not in timing}
            == {k: v for k, v in want.items() if k not in timing})

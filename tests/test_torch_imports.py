"""The port stands alone: importing every module of ``repro_torch`` (and
``chip_smoke.py``), the halo cache, the wire codec, the gradient reducers,
the feature store, the streamed eval, the checkpoint files, the fault
plan, the partition mesh's collectives and reducers, the dry run and the
roofline included (and, for the mesh tests' spawned ranks, their rank
modules), pulls in neither
``jax`` nor anything of ``repro``; and every entry point defaults to the
CUDA card, raising without one unless the caller passes
``device="cpu"``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HYGIENE_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
# the communication path (ROADMAP item 10) stands alone too
from repro_torch.core.gp.trainer import (make_bucketed_reduce_stacked,
                                         make_topk_reduce_stacked)
from repro_torch.engine.stacking import (build_stacked_halo_cache,
                                         build_stacked_halo_residual)
from repro_torch.graph.distributed import (halo_refresh_plan,
                                           make_cached_forward, quantize_rows)
assert "repro_torch.core.sampler.cbs_device" in mods, mods
assert "repro_torch.engine.sequential" in mods, mods
# the feature store and the streamed eval (ROADMAP item 11) stand alone too
assert "repro_torch.graph.featstore" in mods, mods
assert "repro_torch.engine.streaming" in mods, mods
from repro_torch.engine.streaming import StreamedEvaluator
from repro_torch.graph.featstore import assemble_features, host_staging
# checkpoint/resume and fault injection (ROADMAP item 12) stand alone too
for name in ("repro_torch.robustness", "repro_torch.robustness.faults",
             "repro_torch.robustness.checkpoint",
             "repro_torch.train.checkpoint"):
    assert name in mods, (name, mods)
from repro_torch.robustness import FaultPlan, InjectedCrash, RunCheckpointer
from repro_torch.train.checkpoint import (CheckpointManager, load_pytree,
                                          save_pytree)
# the partition mesh (ROADMAP item 14, parts 1 and 2) stands alone too
for name in ("repro_torch.engine.compat", "repro_torch.launch.mesh"):
    assert name in mods, (name, mods)
from repro_torch.engine.compat import all_gather, all_to_all, barrier, pmean
from repro_torch.graph.distributed import make_shard_forward, mesh_exchange
from repro_torch.launch.mesh import make_partition_mesh, spawn_partition_world
# its part 3 (the started exchange, the per-shard reducers, the shard
# forwards' options) stands alone too
from repro_torch.core.gp.trainer import (make_bucketed_reduce_shard,
                                         make_topk_reduce_shard)
from repro_torch.engine.compat import PendingExchange, exchange_start
from repro_torch.graph.distributed import make_ref_shard_split_agg
# the LLM training path (ROADMAP item 15.1): the corpus modules, the input
# shapes, the step builders, the loss and the kernels' autograd functions
for name in ("repro_torch.data", "repro_torch.data.corpus",
             "repro_torch.data.partition", "repro_torch.data.pipeline",
             "repro_torch.configs.shapes", "repro_torch.launch.steps"):
    assert name in mods, (name, mods)
from repro_torch.configs import SHAPES, input_specs
from repro_torch.data import DomainCorpus, ShardedBatcher
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_bwd)
from repro_torch.kernels.rmsnorm import AddRMSNormFn, RMSNormFn, rmsnorm_bwd
from repro_torch.launch.steps import build_step
from repro_torch.launch.train import run_llm
from repro_torch.models.transformer import chunked_ce_loss
# the sharding policy, the LLM meshes and the sharded steps (ROADMAP item
# 15.7), and the staged backend that carries a world sharing one card
for name in ("repro_torch.models.sharding", "repro_torch.models.sharded",
             "repro_torch.launch.staged_backend"):
    assert name in mods, (name, mods)
from repro_torch.launch.mesh import (data_axes_of, make_mesh_compat,
                                     make_production_mesh, model_axis_of)
from repro_torch.launch.staged_backend import StagedProcessGroup
from repro_torch.launch.steps import sanitize_spec
from repro_torch.models.sharded import ShardedOps, step_collective_bytes
from repro_torch.models.sharding import NO_SHARDING, P, ShardingPolicy
# the dry run and the roofline (ROADMAP item 15.8) stand alone too
for name in ("repro_torch.roofline", "repro_torch.roofline.analysis",
             "repro_torch.launch.dryrun", "repro_torch.kernels.work"):
    assert name in mods, (name, mods)
from repro_torch.kernels.work import counted, kernel_work
from repro_torch.launch.dryrun import active_params, run_one
from repro_torch.launch.mesh import make_dryrun_world
from repro_torch.roofline import (HW, CollectiveCounter, RooflineReport,
                                  StepCounter, analyze_step)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("IMPORTED", len(mods))
"""


def test_import_hygiene():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO_ROOT, "src"), REPO_ROOT]))
    r = subprocess.run([sys.executable, "-c", HYGIENE_SCRIPT],
                       capture_output=True, text=True, env=env, cwd=REPO_ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    n = int(r.stdout.split("IMPORTED")[1])
    assert n >= 20, r.stdout


@pytest.mark.parametrize("script", ["flash_timing.py", "segment_timing.py",
                                    "rmsnorm_timing.py", "mesh_probe.py",
                                    "train_probe.py",
                                    "flash_serving_digest.py",
                                    "collective_probe.py",
                                    "shard_probe.py",
                                    "shard_f32_witness.py",
                                    "fake_world_probe.py",
                                    "zoo_train_probe.py"])
def test_timing_scripts_import_hygiene(script):
    """The chip timing scripts run where only the port is installed."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('s', 'scripts/{script}')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO_ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("module", ["_torch_mesh_ranks",
                                    "_torch_mesh_part2_ranks",
                                    "_torch_mesh_part3_ranks",
                                    "_torch_sharding_ranks",
                                    "_torch_sharding_encdec_ranks",
                                    "_torch_roofline_ranks",
                                    "_torch_dryrun_world"])
def test_mesh_rank_modules_import_no_jax(module):
    """What a spawned rank of the mesh tests imports pulls in no JAX, so a
    rank starts in seconds."""
    code = (f"import sys\nimport {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO_ROOT, "src"), os.path.join(REPO_ROOT, "tests")]))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO_ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_sharding_example_imports_no_jax():
    """``examples/llm_entropy_sharding_torch.py`` runs where only the port
    is installed."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('e', "
        "'examples/llm_entropy_sharding_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO_ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_sharding_example_defaults_to_card(no_cuda, monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "llm_entropy_sharding_torch",
        os.path.join(REPO_ROOT, "examples", "llm_entropy_sharding_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["x", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def tiny():
    from repro_torch.core import partition_graph
    from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                                   build_partitioned_graph, make_benchmark)
    g = make_benchmark(BENCHMARKS["tiny"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    return g, pg, GraphSAGE(g.feature_dim, 8, g.num_classes).init(0)


def test_engine_defaults_to_card(no_cuda, tiny):
    from repro_torch.engine import EngineConfig, SPMDEngine
    _, pg, m = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SPMDEngine(m, None, None, pg, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SPMDEngine(m, None, None, pg, None, EngineConfig(use_kernel_agg=False))
    SPMDEngine(m, None, None, pg, None, EngineConfig(device="cpu"))


def test_sequential_oracle_defaults_to_card(no_cuda, tiny):
    from repro_torch.engine import EngineConfig, SequentialReference
    from repro_torch.launch.train import main
    _, pg, m = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SequentialReference(m, None, None, pg, None,
                            EngineConfig(mode="sequential"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["gnn", "--dataset", "tiny", "--epochs", "1", "--engine",
              "sequential", "--overlap-halo"])
    SequentialReference(m, None, None, pg, None,
                        EngineConfig(mode="sequential", device="cpu"))


def test_serving_defaults_to_card(no_cuda, tiny):
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.serve import GNNServingEngine
    _, pg, m = tiny
    export = SPMDEngine(m, None, None, pg, None,
                        EngineConfig(device="cpu")).export_serving_state(m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GNNServingEngine(m, m, pg, export)
    GNNServingEngine(m, m, pg, export, device="cpu")


def test_ops_and_cli_default_to_card(no_cuda, tiny):
    from repro_torch.kernels.ops import make_segment_agg
    from repro_torch.launch.serve import build_parser, gnn_main
    g, _, _ = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_segment_agg(g.indptr, g.indices)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_main(build_parser().parse_args(["--gnn", "--ticks", "1"]))
    agg = make_segment_agg(g.indptr, g.indices, device="cpu")
    assert agg(torch.ones(g.num_nodes, 2)).shape == (g.num_nodes, 2)
    assert np.isfinite(agg(torch.ones(g.num_nodes, 2)).numpy()).all()


def test_training_defaults_to_card(no_cuda):
    from repro_torch.launch.train import main
    from repro_torch.pipeline import EATConfig, run_eat_distgnn
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_eat_distgnn(EATConfig(dataset="tiny"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["gnn", "--dataset", "tiny", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_eat_distgnn(EATConfig(dataset="tiny", async_personalize=True,
                                  async_generalize=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["gnn", "--dataset", "tiny", "--epochs", "1",
              "--async-generalize", "--async-personalize"])
    r = run_eat_distgnn(EATConfig(dataset="tiny", device="cpu", max_epochs=1,
                                  hidden_dim=8, batch_size=64, fanouts=(3, 3)))
    assert np.isfinite(r.loss_history).all() and r.epochs_run == 1


def test_device_sampler_defaults_to_card(no_cuda, tiny):
    from repro_torch.core.sampler import build_device_epoch_sampler
    g, _, _ = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_device_epoch_sampler(g, [g.train_idx], 1, batch_size=64)
    ds = build_device_epoch_sampler(g, [g.train_idx], 1, batch_size=64,
                                    device="cpu")
    assert ds.logp.device.type == "cpu"


def test_llm_training_defaults_to_card(no_cuda):
    """``launch.train llm`` runs on the card unless ``--device cpu``."""
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["llm", "--steps", "1"])
    assert main(["llm", "--arch", "qwen2-0.5b", "--shards", "2",
                 "--d-model", "32", "--seq", "8", "--docs", "32", "--steps",
                 "2", "--phase0-frac", "0.5", "--device", "cpu"]) == 0


def test_transformer_serving_defaults_to_card(no_cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, llm_main, main
    from repro_torch.models import Transformer, params_from_jax
    from repro_torch.serve import ServeEngine
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm_main(build_parser().parse_args(["--new-tokens", "2"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "llama3.2-1b"])
    model = Transformer(cfg, device="cpu")
    assert model.device.type == "cpu"
    out = ServeEngine(model, cache_size=8).generate(
        {"tokens": np.zeros((1, 4), np.int64)}, max_new_tokens=2)
    assert out.shape == (1, 2)

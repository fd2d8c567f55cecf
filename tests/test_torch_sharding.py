"""The sharding policy and the step shardings of the port
(``models/sharding.py``, ``launch/steps.py``, ``launch/mesh.py``; ROADMAP
item 15.7) against the reference's, with no world of ranks:

- ``param_specs`` of every one of the ten archs at full width, by the
  port's ``named_parameters()`` names (taken on the ``meta`` device, no
  storage), equal to the reference's ``ShardingPolicy.param_specs`` of
  ``jax.eval_shape(model.init)`` with its stacked-layer axis dropped, raw
  and sanitized at the production meshes' axis sizes ``(16, 16)`` and
  ``(2, 16, 16)``;
- ``sanitize_spec`` on the reference's ``FakeMesh`` cases;
- ``_cache_spec_for`` over every arch's decode caches at ``decode_32k`` and
  ``long_500k`` (the ``swa`` variant where the arch has no sub-quadratic
  path), the port's one cache dict per layer against the reference's
  stacked tree;
- ``placements``: a tuple entry nests its mesh dims in mesh order;
- the refusal of a mesh outside a process group (``ValueError``); the
  encoder-decoder, the prefix-LM, the MoE and the Mamba2 families (whisper,
  paligemma, phi3.5-moe, qwen3-moe, mamba2-370m, jamba) built and
  distributed on the dry run's fake (16, 16) world in a process of its
  own;
- the example ``examples/llm_entropy_sharding_torch.py`` at ``--steps 2
  --device cpu``.

The worlds of ranks are ``tests/test_torch_sharding_world.py``'s.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.launch.steps import _cache_spec_for as j_cache_spec_for
from repro.launch.steps import sanitize_spec as j_sanitize_spec
from repro.models import Transformer as JTransformer
from repro.models.sharding import ShardingPolicy as JShardingPolicy
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, input_specs
from repro_torch.launch.steps import _cache_spec_for, sanitize_spec
from repro_torch.models import Transformer
from repro_torch.models.sharding import P, ShardingPolicy

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    """The reference test's stand-in: axis name -> size."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"16x16": (("data",), {"data": 16, "model": 16}),
          "2x16x16": (("pod", "data"), {"pod": 2, "data": 16, "model": 16})}


def _spec(s):
    return tuple(s)


def _ref_name(name: str, cfg) -> tuple[str, int | None]:
    """The reference's tree path of the port's parameter ``name`` and the
    slice of its stacked axis (None: not stacked)."""
    parts = name.split(".")
    if parts[0] == "layers":
        idx, nsub = int(parts[1]), len(cfg.super_block)
        r, i = divmod(idx, nsub)
        return f"blocks/sub{i}/{parts[2]}/{parts[3]}", r
    if parts[0] == "encoder":
        return f"encoder/blocks/sub0/{parts[2]}/{parts[3]}", int(parts[1])
    if parts[0] == "encoder_norm":
        return f"encoder/final_norm/{parts[1]}", None
    if parts[0] == "final_norm":
        return f"final_norm/{parts[1]}", None
    return name, None


def _ref_tree(arch):
    jm = JTransformer(j_get_config(arch))
    structs = jax.eval_shape(lambda: jm.init(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(structs)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf.shape for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    """Every parameter's spec, raw and sanitized on both production meshes,
    is the reference's with its stacked axis dropped; norms (``norm_mix``,
    ``encoder_norm``, ``final_norm``) stay replicated."""
    assert set(ARCH_IDS) == set(J_ARCH_IDS)
    cfg = get_config(arch)
    shapes = {n: tuple(p.shape) for n, p in Transformer(
        cfg, device="meta").named_parameters()}
    ref_shapes = _ref_tree(arch)
    port_names = set()
    for mesh, (dax, sizes) in MESHES.items():
        pol = ShardingPolicy(data_axes=dax, model_axis="model",
                             axis_sizes=sizes)
        jpol = JShardingPolicy(data_axes=dax, model_axis="model",
                               axis_sizes=sizes)
        specs = pol.param_specs(shapes)
        for name, shape in shapes.items():
            path, r = _ref_name(name, cfg)
            port_names.add(path)
            rshape = ref_shapes[path]
            want = _spec(jpol.spec_for_param(path, rshape))
            want_s = _spec(j_sanitize_spec(jpol.spec_for_param(path, rshape),
                                           rshape, FakeMesh(sizes)))
            if r is not None:
                assert rshape[1:] == shape, (name, rshape, shape)
                assert want[:1] in ((), (None,)), (name, want)
                want, want_s = want[1:], want_s[1:]
            else:
                assert rshape == shape, (name, rshape, shape)
            assert _spec(specs[name]) == want, (mesh, name)
            assert _spec(sanitize_spec(specs[name], shape,
                                       FakeMesh(sizes))) == want_s, (mesh,
                                                                     name)
            group = name.split(".")[-2] if "." in name else name
            if group.startswith("norm_") or group in ("final_norm",
                                                      "encoder_norm"):
                assert _spec(specs[name]) == (), name
    assert port_names == set(ref_shapes), set(ref_shapes) ^ port_names


def test_sanitize_spec_fake_mesh_cases():
    """The reference's ``test_sanitize_spec_rules`` cases."""
    m = FakeMesh({"data": 4, "model": 8, "pod": 2})
    assert sanitize_spec(P(None, "model"), (3, 64), m) == P(None, "model")
    assert sanitize_spec(P(None, "model"), (3, 51865 % 100 + 3), m)[1] is None
    s = sanitize_spec(P(("pod", "data"), None), (4, 7), m)
    assert s[0] is None or s[0] == "pod"
    assert s == j_sanitize_spec(jax.sharding.PartitionSpec(
        ("pod", "data"), None), (4, 7), m)
    s2 = sanitize_spec(P(("pod", "data"),), (8,), m)
    assert s2[0] == ("pod", "data")
    # past the spec's end is None, as the reference's spec indexes
    assert P("data")[3] is None


def _ref_cache_paths(caches) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(caches)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf.shape for path, leaf in flat}


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, shape):
    """Each layer's cache leaf (``{"k", "v"}``, ``{"conv", "ssm"}``,
    ``"cross"``) takes the reference's spec of its stacked leaf with the
    repeat axis dropped, on both production meshes, including the
    context-parallel fallback where the KV heads do not divide 16."""
    variant = None
    if shape == "long_500k" and not get_config(arch).supports_long_context:
        variant = "swa"
    cfg, jcfg = get_config(arch, variant), j_get_config(arch, variant)
    port = input_specs(cfg, SHAPES[shape])["caches"]
    ref = _ref_cache_paths(j_input_specs(jcfg, J_SHAPES[shape])["caches"])
    nsub = len(cfg.super_block)
    seen = set()
    for mesh, (dax, sizes) in MESHES.items():
        fm = FakeMesh(sizes)
        for idx, layer in enumerate(port):
            r, i = divmod(idx, nsub)
            for key, leaf in layer.items():
                pairs = ([(f"{idx}/{key}/{k}", v, f"cross/{k}")
                          for k, v in leaf.items()] if isinstance(leaf, dict)
                         else [(f"{idx}/{key}", leaf, key)])
                for path, v, tail in pairs:
                    group = "attn" if tail in ("k", "v") else (
                        "mamba" if tail in ("conv", "ssm") else "")
                    rpath = (f"sub{i}/{tail}" if tail.startswith("cross")
                             else f"sub{i}/{group}/{tail}")
                    rshape = ref[rpath]
                    assert rshape[1:] == tuple(v.shape), (rpath, rshape)
                    want = _spec(j_cache_spec_for(rpath, rshape, dax, fm))
                    got = _spec(_cache_spec_for(path, tuple(v.shape), dax, fm))
                    assert got == want[1:], (mesh, path, got, want)
                    seen.add(rpath)
    assert seen == set(ref)


def test_tuple_entries_nest_in_mesh_order():
    """``P(("pod", "data"))`` shards dim 0 over pod then data (pod-major,
    as JAX nests it); the other order, or one axis on two dims, raises."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import placements

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert placements(P(("pod", "data"), None, "model"), Mesh()) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(P(None, None), Mesh()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="nests its axes"):
        placements(P(("data", "pod")), Mesh())
    with pytest.raises(ValueError, match="shards two dims"):
        placements(P("model", "model"), Mesh())


# run in a process of its own: the fake world of the dry run is its only
# process group.  Each arch at full width on ``meta``: build_step's four
# step kinds on the (16, 16) mesh, and the model distributed by the train
# step's policy (every parameter a DTensor with the policy's placements)
_SHARDABLE = """
import json, sys
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import make_dryrun_world
from repro_torch.launch.steps import build_step
from repro_torch.models import Transformer
from repro_torch.models.sharded import param_placements

mesh = make_dryrun_world()
out = {}
for arch in sys.argv[1:]:
    cfg = get_config(arch)
    built = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        built[shape] = build_step(cfg, SHAPES[shape], mesh).name
    built["personalize"] = build_step(cfg, SHAPES["train_4k"], mesh,
                                      phase="personalize").name
    step = build_step(cfg, SHAPES["train_4k"], mesh)
    model = step.shard_model(Transformer(cfg, device="meta"))
    want = param_placements(model, mesh)
    placed = {n: [str(p) for p in w.placements]
              for n, w in model.named_parameters()
              if type(w.data).__name__ == "DTensor"
              and list(w.placements) == want[n]}
    out[arch] = {"built": built, "placed": placed,
                 "params": [n for n, _ in model.named_parameters()],
                 "b_shard": {k: [str(p) for p in v]
                             for k, v in step.in_shardings[2].items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def shardable():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SHARDABLE, *ENCDEC, *ZOO],
                       capture_output=True, text=True, env=env,
                       cwd=REPO_ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    return json.loads(r.stdout.splitlines()[-1])


ENCDEC = ["whisper-small", "paligemma-3b"]
ZOO = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "mamba2-370m",
       "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", ENCDEC)
def test_encdec_and_prefix_lm_run_on_a_mesh(shardable, arch):
    """The encoder-decoder and the prefix-LM at full width on ``meta``:
    ``build_step`` builds their four step kinds on the (16, 16) mesh and
    ``distribute`` places every parameter (the encoder's, the
    cross-attention's) by the policy; the extra input is a batch leaf
    split over the data axes."""
    got = shardable[arch]
    assert got["built"] == {
        "train_4k": f"train:{arch}:train_4k",
        "prefill_32k": f"prefill:{arch}:prefill_32k",
        "decode_32k": f"serve:{arch}:decode_32k",
        "personalize": f"train-personalize:{arch}:train_4k"}
    assert sorted(got["placed"]) == sorted(got["params"])
    extra = "enc_embeds" if arch == "whisper-small" else "patch_embeds"
    assert got["b_shard"][extra] == ["S(0)", "R"]
    if arch == "whisper-small":
        assert any(n.startswith("encoder.") for n in got["params"])
        # 51,865 is odd: the vocabulary stays whole
        assert got["placed"]["embed"] == ["R", "R"]
        assert got["placed"]["layers.0.cross.wq"] == ["R", "S(1)"]
    else:
        assert got["placed"]["embed"] == ["R", "S(0)"]


@pytest.mark.parametrize("arch", ZOO)
def test_moe_and_mamba2_run_on_a_mesh(shardable, arch):
    """The MoE and Mamba2 families at full width on ``meta``: ``build_step``
    builds their four step kinds on the (16, 16) mesh and ``distribute``
    places every parameter by the policy: the experts over ``"model"``
    (16 or 128 of them), the router whole, Mamba2's ``in_proj`` columns,
    ``out_proj`` rows and per-head parameters over ``"model"``."""
    got = shardable[arch]
    assert got["built"] == {
        "train_4k": f"train:{arch}:train_4k",
        "prefill_32k": f"prefill:{arch}:prefill_32k",
        "decode_32k": f"serve:{arch}:decode_32k",
        "personalize": f"train-personalize:{arch}:train_4k"}
    assert sorted(got["placed"]) == sorted(got["params"])
    placed = got["placed"]
    if "moe" in arch or "jamba" in arch:
        layer = 1 if "jamba" in arch else 0
        assert placed[f"layers.{layer}.moe.expert_gate"] == ["R", "S(0)"]
        assert placed[f"layers.{layer}.moe.router"] == ["R", "R"]
    if "mamba" in arch or "jamba" in arch:
        layer = 1 if "jamba" in arch else 0
        assert placed[f"layers.{layer}.mamba.in_proj"] == ["R", "S(1)"]
        assert placed[f"layers.{layer}.mamba.out_proj"] == ["R", "S(0)"]
        assert placed[f"layers.{layer}.mamba.a_log"] == ["R", "S(0)"]


def test_mesh_outside_a_group_raises():
    from repro_torch.launch.mesh import (make_mesh_compat,
                                         make_production_mesh)
    with pytest.raises(ValueError, match="no process group"):
        make_mesh_compat((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


def test_no_mesh_keeps_the_unsharded_step():
    """``mesh=None`` builds the one-device steps: no shardings, no
    policy."""
    from repro_torch.launch.steps import build_step
    from repro_torch.models.sharding import NO_SHARDING

    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        built = build_step(get_config("qwen2-0.5b"), SHAPES[kind])
        assert built.mesh is None and built.policy is NO_SHARDING
        assert built.in_shardings is None and built.out_shardings is None


def test_a_deleted_model_is_freed_at_once():
    """The model holds no reference cycle (its sub-layer ops are made per
    call): dropping the last reference frees it and its memory without the
    cycle collector, as serving model after model on one card needs."""
    import gc
    import weakref

    cfg = get_config("qwen2-0.5b").reduced()
    model = Transformer(cfg, device="cpu")
    model.prefill({"tokens": np.zeros((1, 4), np.int64)})
    ref = weakref.ref(model)
    gc.disable()
    try:
        del model
        assert ref() is None
    finally:
        gc.enable()


def test_example_runs_on_cpu():
    """The twin of ``examples/llm_entropy_sharding.py``: both sets of shard
    entropies, and each shard's global and personalized held-out loss."""
    # one intra-op thread: the example runs beside the other test workers
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "examples/llm_entropy_sharding_torch.py", "--steps",
         "2", "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=REPO_ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "random  shard domain entropies" in out
    assert "ew      shard domain entropies" in out
    rows = [line.split() for line in out.splitlines()
            if line.strip()[:1].isdigit()]
    assert len(rows) == 4, out
    for row in rows:
        assert np.isfinite([float(row[1]), float(row[2])]).all(), row

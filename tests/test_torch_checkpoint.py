"""The port's fault plan, checkpoint files and run checkpointer against the
reference's (``repro.robustness``, ``repro.train.checkpoint``):

1. ``FaultPlan`` (copied) draws the reference's schedules from the same
   seeds and corrupts a file at the reference's offsets.
2. ``save_pytree`` / ``load_pytree`` round trips are bitwise in f32, f64
   and bf16, with the template's dtype and device; a file the reference
   wrote loads bitwise in the port and the other way round, with the same
   entry keys; corrupt, bit-flipped and mismatched files raise the
   reference's errors with the reference's messages; no tmp file is left.
3. ``RunCheckpointer``: the reference's retention, fallback past
   corruption, torn-manifest rebuild and empty-directory cases, on the
   port.
4. ``CheckpointManager``'s best-model bookkeeping.
"""
import json
import os
import re
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import GraphSAGE as JGraphSAGE
from repro.robustness import FaultPlan as JFaultPlan
from repro.train import checkpoint as jck
from repro.train.optim import AdamW as JAdamW
from repro_torch.graph import GraphSAGE
from repro_torch.robustness import (FaultPlan, RunCheckpointer, flip_bit,
                                    truncate_file)
from repro_torch.train import checkpoint as ck
from repro_torch.train.optim import AdamW, OptState

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------------
# 1. FaultPlan
# --------------------------------------------------------------------------

def _plan_fields(plan):
    return (plan.crash_epochs, plan.straggler, plan.drop_refresh_epochs,
            plan.serve_fail, plan.serve_recover, plan.seed)


@pytest.mark.parametrize("seed", [0, 3, 4, 5, 11])
def test_fault_plan_random_equals_reference(seed):
    kw = dict(num_parts=4, max_epochs=20, serve_ticks=10,
              serve_fail_prob=0.3, down_ticks=2)
    got = FaultPlan.random(seed, **kw)
    assert _plan_fields(got) == _plan_fields(JFaultPlan.random(seed, **kw))
    assert _plan_fields(got) == _plan_fields(FaultPlan.random(seed, **kw))
    for e in range(20):
        assert got.crash_at(e) == (e in got.crash_epochs)
        np.testing.assert_array_equal(
            got.straggler_delay(e, 4),
            JFaultPlan.random(seed, **kw).straggler_delay(e, 4))
    for t in range(1, 14):
        assert got.serve_events(t) == JFaultPlan.random(
            seed, **kw).serve_events(t)


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_fault_plan_corrupt_equals_reference(tmp_path, mode):
    payload = bytes(range(256)) * 40
    paths = []
    for sub in ("port", "ref"):
        os.mkdir(tmp_path / sub)
        paths.append(tmp_path / sub / "ckpt_000003.npz")
        paths[-1].write_bytes(payload)
    got = FaultPlan(seed=9).corrupt(str(paths[0]), mode=mode)
    want = JFaultPlan(seed=9).corrupt(str(paths[1]), mode=mode)
    assert got == want
    assert paths[0].read_bytes() == paths[1].read_bytes() != payload


def test_fault_plan_helpers():
    plan = FaultPlan(crash_epochs=frozenset({2}),
                     straggler={1: {0: 0.5, 3: 1.5}},
                     drop_refresh_epochs=frozenset({4}),
                     serve_fail={2: (1,)}, serve_recover={5: (1,)})
    assert plan.crash_at(2) and not plan.crash_at(1)
    np.testing.assert_array_equal(plan.straggler_delay(1, 4),
                                  [0.5, 0.0, 0.0, 1.5])
    assert plan.drop_halo_refresh(4) and not plan.drop_halo_refresh(3)
    assert plan.serve_events(2) == [("fail", 1)]
    assert plan.serve_events(5) == [("recover", 1)]


# --------------------------------------------------------------------------
# 2. save_pytree / load_pytree
# --------------------------------------------------------------------------

def _model_tree(dtype, seed=0):
    """A GraphSAGE, its AdamW state and loose leaves, all of ``dtype``."""
    m = GraphSAGE(8, 4, 3).init(seed).to(dtype)
    st = AdamW().init(m.parameters())
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((5, 2))).to(dtype)
    return {"params": m, "opt": st, "x": x, "host": [x.numpy().copy()
                                                     if dtype != torch.bfloat16
                                                     else np.arange(3.0)],
            "none": None}


def _flat(tree):
    return dict(ck._leaves(tree))


def _bits_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        u8 = lambda t: t.detach().contiguous().view(-1).view(torch.uint8)
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.device == b.device and a.shape == b.shape
                and torch.equal(u8(a), u8(b)))
    return (isinstance(b, np.ndarray) and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=["f32", "f64", "bf16"])
def test_roundtrip_bitwise(tmp_path, dtype):
    tree = _model_tree(dtype)
    path = str(tmp_path / "t.npz")
    ck.save_pytree(path, tree, meta={"epoch": 3})
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
    back = ck.load_pytree(path, _model_tree(dtype, seed=1))
    assert isinstance(back["params"], GraphSAGE)
    assert isinstance(back["opt"], OptState)
    assert back["none"] is None
    a, b = _flat(tree), _flat(back)
    # params 6, opt 1 + 6 + 6, x, host
    assert a.keys() == b.keys() and len(a) == 6 + 13 + 2
    for k in a:
        assert _bits_equal(a[k], b[k]), k
    assert ck.load_meta(path) == {"epoch": 3}
    # a template on another device restores there (meta: no data)
    like = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in _model_tree(dtype).items() if k in ("x", "host")}
    with pytest.raises(ck.CheckpointKeyError):
        ck.load_pytree(path, like)
    ck.save_pytree(path, {"x": tree["x"], "host": tree["host"]})
    out = ck.load_pytree(path, like)
    assert out["x"].device.type == "meta" and out["x"].dtype == dtype
    assert isinstance(out["host"][0], np.ndarray)


def test_keys_are_the_references(tmp_path):
    """The port's flat keys for a model and its optimizer state are the
    ones the reference's flattening gives the same tree."""
    jm = JGraphSAGE(feature_dim=8, hidden_dim=4, num_classes=3)
    jp = jm.init(0)
    want = jck._flatten({"params": jp, "opt": JAdamW().init(jp)})
    m = GraphSAGE(8, 4, 3).init(0)
    got = ck._flatten({"params": m, "opt": AdamW().init(m.parameters())})
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _ref_tree(stacked: bool):
    jp = JGraphSAGE(feature_dim=8, hidden_dim=4, num_classes=3).init(2)
    if stacked:
        jp = jax.tree.map(lambda x: jnp.stack([x, 2 * x, -x]), jp)
        opt = jax.vmap(JAdamW().init)(jp)
    else:
        opt = JAdamW().init(jp)
    opt = opt._replace(step=opt.step + 5,
                       mu=jax.tree.map(lambda x: x + 0.25, opt.mu))
    return {"params": jp, "opt": opt,
            "x": jnp.asarray(np.linspace(-1, 1, 6), jnp.bfloat16),
            "n": np.arange(4, dtype=np.int64)}


def _port_like(stacked: bool):
    m = GraphSAGE(8, 4, 3)
    if stacked:
        from repro_torch.graph.sage import broadcast_to_partitions
        m = broadcast_to_partitions(m, 3)
        opt = AdamW().init_stacked(m.parameters())
    else:
        opt = AdamW().init(m.parameters())
    return {"params": m, "opt": opt,
            "x": torch.zeros(6, dtype=torch.bfloat16),
            "n": np.zeros(4, np.int64)}


@pytest.mark.parametrize("stacked", [False, True], ids=["shared", "stacked"])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_files_cross_between_packages(tmp_path, direction, stacked):
    """A file either package wrote loads bitwise in the other, and both
    archives hold the same entry keys."""
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jck.save_pytree(ref_path, _ref_tree(stacked))
    port_tree = ck.load_pytree(ref_path, _port_like(stacked))
    ck.save_pytree(port_path, port_tree)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    if direction == "reference_to_port":
        want = jck._flatten(_ref_tree(stacked))
        got = ck._flatten(port_tree)
    else:
        back = jck.load_pytree(port_path, _ref_tree(stacked))
        want, got = jck._flatten(_ref_tree(stacked)), jck._flatten(back)
        assert back["x"].dtype == jnp.bfloat16
        assert isinstance(back["n"], np.ndarray)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert port_tree["x"].dtype == torch.bfloat16
    assert port_tree["opt"].step.dtype == torch.int32


def _small_tree():
    return {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"w": np.ones((2, 2), np.float64)}}


def _both_errors(path, like_np):
    """The error each package's load_pytree raises on ``path``."""
    out = []
    for mod in (ck, jck):
        with pytest.raises(Exception) as ei:
            mod.load_pytree(path, like_np)
        out.append(ei.value)
    return out


def _crc_flip(path):
    mp = path + ".meta.json"
    with open(mp) as f:
        doc = json.load(f)
    doc["crc32"]["a"] ^= 1                     # silent-corruption model
    with open(mp, "w") as f:
        json.dump(doc, f)


def _bit_flip(path):
    with zipfile.ZipFile(path) as z:           # locate entry 'a's payload
        zi = z.getinfo("a.npy")
    with open(path, "rb") as f:
        f.seek(zi.header_offset + 26)
        nlen, elen = struct.unpack("<HH", f.read(4))
    data_start = zi.header_offset + 30 + nlen + elen
    flip_bit(path, data_start + zi.file_size - 4)   # lands in array bytes


@pytest.mark.parametrize("fault,error,match", [
    ("crc", "CheckpointCorruptError", r"entry 'a'.*crc32"),
    ("bitflip", "CheckpointCorruptError", "entry 'a'"),
    ("truncate", "CheckpointCorruptError", "unreadable archive|entry"),
    ("keys", "CheckpointKeyError", "missing.*'c'.*unexpected.*'a'"),
    ("shape", "ValueError", "shape mismatch")])
def test_errors_name_what_the_reference_names(tmp_path, fault, error, match):
    path = str(tmp_path / "t.npz")
    ck.save_pytree(path, _small_tree())
    like = _small_tree()
    if fault == "crc":
        _crc_flip(path)
    elif fault == "bitflip":
        _bit_flip(path)
    elif fault == "truncate":
        truncate_file(path, 0.3)
    elif fault == "keys":
        like = {"b": like["b"], "c": np.ones(2)}
    else:
        like["a"] = np.zeros((4, 3), np.float32)
    got, want = _both_errors(path, like)
    assert type(got).__name__ == type(want).__name__ == error
    assert str(got) == str(want)
    assert re.search(match, str(got)), str(got)
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


def test_checkpoint_module_uses_no_pickle():
    src = open(os.path.join(REPO_ROOT, "src", "repro_torch", "train",
                            "checkpoint.py")).read()
    for call in ("torch.save(", "torch.load(", "import pickle",
                 "allow_pickle=True"):
        assert call not in src, call
    assert "import jax" not in src and "from repro." not in src


# --------------------------------------------------------------------------
# 3. RunCheckpointer (the reference's cases, on the port)
# --------------------------------------------------------------------------

def _arrays(step):
    return {"p": torch.full((3,), float(step)), "o": np.arange(4) + step}


def _ck_retention(ckr):
    for s in range(1, 6):
        ckr.save(s, _arrays(s), {"epoch": s})
    assert ckr.steps() == [3, 4, 5]
    assert ckr.latest_step() == 5
    on_disk = sorted(n for n in os.listdir(ckr.dir) if n.endswith(".npz"))
    assert on_disk == ["ckpt_000003.npz", "ckpt_000004.npz",
                       "ckpt_000005.npz"]
    assert ckr.peek(4) == {"epoch": 4}
    arrays, host = ckr.load(4, _arrays(0))
    assert host == {"epoch": 4}
    assert torch.equal(arrays["p"], torch.full((3,), 4.0))
    assert np.array_equal(arrays["o"], np.arange(4) + 4)


def _ck_fallback(ckr):
    for s in range(1, 4):
        ckr.save(s, _arrays(s), {"epoch": s})
    FaultPlan(seed=2).corrupt(ckr._npz(3))     # newest archive damaged
    arrays, host, step = ckr.load_latest(lambda h: _arrays(0))
    assert step == 2 and host == {"epoch": 2}
    assert torch.equal(arrays["p"], torch.full((3,), 2.0))
    for s in (1, 2):                           # now everything is corrupt
        truncate_file(ckr._npz(s), 0.3)
    with pytest.raises(ck.CheckpointCorruptError, match="no valid checkpoint"):
        ckr.load_latest(lambda h: _arrays(0))


def _ck_torn_manifest(ckr):
    for s in (1, 2):
        ckr.save(s, _arrays(s), {"epoch": s})
    with open(ckr._manifest_path(), "w") as f:
        f.write('{"steps": [1, 2')            # torn mid-write
    assert ckr.steps() == [1, 2]               # rebuilt from the archives
    _, host, step = ckr.load_latest(lambda h: _arrays(0))
    assert step == 2 and host == {"epoch": 2}


def _ck_empty(ckr):
    assert ckr.load_latest(lambda h: _arrays(0)) is None
    assert ckr.steps() == [] and ckr.latest_step() is None


@pytest.mark.parametrize("case", [_ck_retention, _ck_fallback,
                                  _ck_torn_manifest, _ck_empty],
                         ids=["retention", "fallback", "torn_manifest",
                              "empty_dir"])
def test_run_checkpointer(tmp_path, case):
    case(RunCheckpointer(str(tmp_path / "ck"), keep_last=3 if case in (
        _ck_retention, _ck_fallback) else 5))


def test_run_checkpointer_reads_the_references_directory(tmp_path):
    """A directory the reference's RunCheckpointer wrote is read by the
    port's, manifest and whole-file CRCs included."""
    from repro.robustness import RunCheckpointer as JRunCheckpointer
    jr = JRunCheckpointer(str(tmp_path / "ck"), keep_last=2)
    for s in range(1, 4):
        jr.save(s, {"p": np.full((3,), float(s))}, {"epoch": s})
    ckr = RunCheckpointer(str(tmp_path / "ck"), keep_last=2)
    assert ckr.steps() == [2, 3]
    arrays, host, step = ckr.load_latest(
        lambda h: {"p": torch.zeros(3, dtype=torch.float64)})
    assert step == 3 and host == {"epoch": 3}
    assert torch.equal(arrays["p"], torch.full((3,), 3.0, dtype=torch.float64))


# --------------------------------------------------------------------------
# 4. CheckpointManager
# --------------------------------------------------------------------------

def test_checkpoint_manager_best_model_bookkeeping(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    like = {"w": torch.zeros((2, 2))}
    full = lambda v: {"w": torch.full((2, 2), v)}
    assert mgr.update_global(full(1.0), epoch=0, score=0.5) is True
    assert mgr.update_global(full(2.0), epoch=1, score=0.5) is False
    assert mgr.update_global(full(3.0), epoch=2, score=0.4) is False
    assert float(mgr.load_global(like)["w"][0, 0]) == 1.0
    assert mgr.global_meta() == {"epoch": 0, "score": 0.5, "phase": 0}
    assert mgr.update_global(full(4.0), epoch=3, score=0.6) is True
    assert float(mgr.load_global(like)["w"][0, 0]) == 4.0
    assert mgr.update_personal(0, full(7.0), epoch=4, score=0.3) is True
    assert mgr.update_personal(1, full(8.0), epoch=4, score=0.2) is True
    assert mgr.update_personal(0, full(9.0), epoch=5, score=0.25) is False
    assert float(mgr.load_personal(0, like)["w"][0, 0]) == 7.0
    assert float(mgr.load_personal(1, like)["w"][0, 0]) == 8.0
    assert mgr.personal_meta(1) == {"epoch": 4, "score": 0.2, "phase": 1,
                                    "partition": 1}
    # the reference's manager reads the port's files, and the other way
    jm = jck.CheckpointManager(str(tmp_path))
    assert jm.global_meta() == mgr.global_meta()
    np.testing.assert_array_equal(
        np.asarray(jm.load_personal(1, {"w": jnp.zeros((2, 2))})["w"]), 8.0)
    jm2 = jck.CheckpointManager(str(tmp_path / "j"))
    jm2.save_global({"w": jnp.full((2, 2), 5.0)}, epoch=2, score=0.7)
    mgr2 = ck.CheckpointManager(str(tmp_path / "j"))
    assert float(mgr2.load_global(like)["w"][0, 0]) == 5.0
    assert mgr2.global_meta()["score"] == 0.7

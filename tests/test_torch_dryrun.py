"""The port's dry run (``repro_torch.launch.dryrun``, ROADMAP item 15.8) on
the CPU: its CLI in a process of its own as rank 0 of the fake world
(``launch/mesh.py::make_dryrun_world``; ``tests/_torch_dryrun_world.py``
runs it), every step on ``meta`` tensors.

- qwen2-0.5b and llama3.2-1b on the (16, 16) mesh, all four shapes
  (``--auto-swa`` for long_500k): ``ok`` rows with the reference's keys,
  fitting the card, and collective bytes (inputs plus outputs) equal to
  ``models/sharded.py::step_collective_bytes`` wherever the closed form
  applies (long_500k's batch of 1 does not split over the data axes);
- qwen2-0.5b's decode step with ``--multi-pod`` on (2, 16, 16);
- ``--no-seq-shard`` and ``--no-constrain-attn`` (the reference's policy
  options): ``ok`` rows equal to their closed forms and moving other
  collectives than the default;
- whisper-small and paligemma-3b (the encoder-decoder and the prefix-LM)
  ``ok`` at train_4k, prefill_32k and decode_32k on (16, 16) and at
  train_4k on (2, 16, 16), each equal to its closed form: whisper's 12
  heads and paligemma's 8 divide no model axis of 16 (the
  gathered-projection path), whisper's 1,500 frames stay replicated over
  it and its vocabulary whole, paligemma's one KV head makes its decode
  cache the context-parallel one;
- the MoE and Mamba2 families (ROADMAP item 15.7b, part 2): phi3.5-moe at
  train_4k and mamba2-370m at decode_32k ``ok``, each equal to its closed
  form; a full-attention arch at long_500k without ``swa`` skipped by the
  reference's rule (phi3.5-moe, whisper and paligemma too), every run's
  exit code 0.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch.dryrun import closed_form_holds

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
DENSE = ["qwen2-0.5b", "llama3.2-1b"]
GROUPS = [
    ["--arch", "qwen2-0.5b", "--shape", "all", "--auto-swa"],
    ["--arch", "llama3.2-1b", "--shape", "all", "--auto-swa"],
    ["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--multi-pod",
     "--tag", "pod"],
    ["--arch", "qwen2-0.5b", "--shape", "train_4k", "--no-seq-shard",
     "--tag", "no-seq-shard"],
    ["--arch", "llama3.2-1b", "--shape", "train_4k", "--no-constrain-attn",
     "--no-measure", "--tag", "no-constrain-attn"],
    ["--arch", "phi3.5-moe-42b-a6.6b", "--shape", "train_4k"],
    ["--arch", "phi3.5-moe-42b-a6.6b", "--shape", "long_500k"],
    ["--arch", "mamba2-370m", "--shape", "decode_32k"],
    ["--arch", "qwen2-0.5b", "--shape", "long_500k"],
    ["--arch", "whisper-small", "--shape", "all"],
    ["--arch", "paligemma-3b", "--shape", "all"],
    ["--arch", "whisper-small", "--shape", "train_4k", "--multi-pod",
     "--tag", "pod"],
    ["--arch", "paligemma-3b", "--shape", "train_4k", "--multi-pod",
     "--tag", "pod"],
]
ENCDEC = ["whisper-small", "paligemma-3b"]
# the keys of a row of the reference's run_one (tag where one is given)
REFERENCE_KEYS = {
    "name", "chips", "compute_s", "memory_s", "collective_s", "dominant",
    "hlo_flops_per_chip", "hlo_bytes_per_chip", "coll_bytes_per_chip",
    "coll_breakdown", "model_flops", "useful_flops_ratio",
    "peak_memory_per_chip_gb", "raw_cost_analysis", "seq_shard_residual",
    "constrain_attn", "arch", "shape", "multi_pod", "variant", "phase",
    "status", "total_params", "active_params", "lower_s", "compile_s",
    "argument_bytes", "output_bytes", "temp_bytes"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "rows.json"
    argv = [str(out)]
    for g in GROUPS:
        argv += g + ["--"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests/_torch_dryrun_world.py"),
         *argv[:-1]], capture_output=True, text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rcs = [int(line.split()[1]) for line in proc.stdout.splitlines()
           if line.startswith("rc ")]
    return rcs, json.loads(out.read_text())


def _row(rows, arch, shape, tag="", status="ok"):
    hit = [r for r in rows if r["arch"] == arch and r["shape"] == shape
           and r.get("tag", "") == tag and r["status"] == status]
    assert len(hit) == 1, (arch, shape, tag, len(hit))
    return hit[0]


def test_every_run_exits_0(run):
    rcs, rows = run
    assert rcs == [0] * len(GROUPS)
    assert not [r for r in rows if r["status"] == "error"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", DENSE)
def test_dense_rows_are_ok_and_match_the_closed_form(run, arch, shape):
    r = _row(run[1], arch, shape)
    assert REFERENCE_KEYS <= set(r)
    assert r["chips"] == 256 and not r["multi_pod"]
    assert r["mesh_device"] == "cpu" and r["fits"]
    assert r["variant"] == ("swa" if shape == "long_500k" else "base")
    assert r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0
    assert 0 < r["useful_flops_ratio"] < 1
    assert r["coll_breakdown"] and sum(r["coll_in_out"].values()) > 0
    if shape == "long_500k":
        # one sequence: the batch does not split over 16 data ranks
        assert r["coll_closed_form"] is None
    else:
        assert closed_form_holds(r), (r["coll_in_out"],
                                      r["coll_closed_form"])
    kernels = r["kernels"]
    assert ("flash_attention_bwd" in kernels) == (shape == "train_4k")
    assert kernels["flash_attention_train" if shape == "train_4k"
                   else "flash_attention"][1] > 0


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("arch", ENCDEC)
def test_encdec_rows_are_ok_and_match_the_closed_form(run, arch, shape):
    r = _row(run[1], arch, shape)
    assert REFERENCE_KEYS <= set(r)
    assert r["chips"] == 256 and not r["multi_pod"]
    assert r["mesh_device"] == "cpu" and r["fits"]
    assert r["hlo_flops_per_chip"] > 0 and r["hlo_bytes_per_chip"] > 0
    assert r["coll_breakdown"] and sum(r["coll_in_out"].values()) > 0
    assert closed_form_holds(r), (r["coll_in_out"], r["coll_closed_form"])
    kernels = r["kernels"]
    assert ("flash_attention_bwd" in kernels) == (shape == "train_4k")
    assert kernels["flash_attention_train" if shape == "train_4k"
                   else "flash_attention"][1] > 0
    # whisper's norms are layernorms: plain ops, no RMSNorm kernel
    assert ("rmsnorm" in kernels or "add_rmsnorm" in kernels) == (
        arch == "paligemma-3b")


@pytest.mark.parametrize("arch", ENCDEC)
def test_encdec_multi_pod_row(run, arch):
    r = _row(run[1], arch, "train_4k", "pod")
    assert r["chips"] == 512 and r["multi_pod"] and r["fits"]
    assert closed_form_holds(r), (r["coll_in_out"], r["coll_closed_form"])


def test_multi_pod_row(run):
    r = _row(run[1], "qwen2-0.5b", "decode_32k", "pod")
    assert r["chips"] == 512 and r["multi_pod"]
    assert closed_form_holds(r)


def test_the_policy_options(run):
    """Without the sequence split the residual's collectives are
    all-reduces (the activations no longer reduce-scattered); without the head constraint llama's
    attention gathers its projections (more all-gather than the default).
    Each row equals its closed form."""
    rows = run[1]
    base = _row(rows, "qwen2-0.5b", "train_4k")
    seq = _row(rows, "qwen2-0.5b", "train_4k", "no-seq-shard")
    assert not seq["seq_shard_residual"]
    assert closed_form_holds(seq)
    # what is still reduce-scattered is the gathered projections' gradients
    assert seq["coll_in_out"]["reduce_scatter"] < base["coll_in_out"][
        "reduce_scatter"]
    assert seq["coll_in_out"]["all_reduce"] > base["coll_in_out"][
        "all_reduce"]
    lbase = _row(rows, "llama3.2-1b", "train_4k")
    attn = _row(rows, "llama3.2-1b", "train_4k", "no-constrain-attn")
    assert not attn["constrain_attn"]
    assert closed_form_holds(attn)
    assert attn["coll_in_out"]["all_gather"] > lbase["coll_in_out"][
        "all_gather"]


def test_skipped_rows(run):
    """The MoE and Mamba2 families run on a mesh: phi3.5-moe's train step
    (its 16 experts over the 16 model ranks, the count exchange and the
    Switch auxiliary's sums over the 16 data ranks) and mamba2-370m's
    decode step (its 32 heads over "model", the conv cache gathered) give
    ``ok`` rows equal to their closed forms; only the reference's
    long-context rule skips: phi3.5-moe is full attention."""
    rows = run[1]
    for arch, shape in (("phi3.5-moe-42b-a6.6b", "train_4k"),
                        ("mamba2-370m", "decode_32k")):
        r = _row(rows, arch, shape)
        assert r["chips"] == 256 and r["fits"], (arch, shape)
        assert closed_form_holds(r), (r["coll_in_out"],
                                      r["coll_closed_form"])
    moe = _row(rows, "phi3.5-moe-42b-a6.6b", "long_500k", status="skipped")
    assert moe["reason"] == "full attention; run with --variant swa"
    # the reference's skipped rows carry no tag
    full = _row(rows, "qwen2-0.5b", "long_500k", status="skipped")
    assert full["reason"] == "full attention; run with --variant swa"
    # the encoder-decoder and the prefix-LM run on a mesh: at long_500k
    # only the reference's full-attention rule skips them
    for arch in ENCDEC:
        full = _row(rows, arch, "long_500k", status="skipped")
        assert full["reason"] == "full attention; run with --variant swa"

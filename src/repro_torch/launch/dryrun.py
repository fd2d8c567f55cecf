"""The dry run on the production meshes (counterpart of
``repro/launch/dryrun.py``): every (arch x input shape) step built on the
(16, 16) mesh, or (2, 16, 16) with ``--multi-pod``, run once on ``meta``
tensors as rank 0 of a fake world, its work counted and its roofline terms
written as JSON rows.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod] [--phase generalize|personalize] \\
        [--variant base|swa] [--auto-swa] [--no-seq-shard] \\
        [--no-constrain-attn] [--override capacity_factor=1.0] [--tag T] \\
        [--out rows.json]

Where the reference lowers and compiles the step for 256 (or 512) forced
host devices and reads XLA's cost and memory analyses, the port builds
``launch/steps.py::build_step``'s step on ``launch/mesh.py::
make_dryrun_world``'s mesh, shards a ``Transformer(cfg, device="meta")``
onto it, makes the inputs from ``configs/shapes.py::input_specs`` and runs
the step once under ``roofline/analysis.py``'s ``StepCounter`` and
``CollectiveCounter``: rank 0's FLOPs, bytes, collective bytes and peak
memory, the kernels' work by their formulas (``kernels/work.py``).  A row
has the reference's keys (``lower_s`` is the build's time, ``compile_s``
the counted run's), plus ``fits`` (the peak within the card's 80 GB), the
mesh's device type, the collectives' input-plus-output bytes beside
``models/sharded.py::step_collective_bytes`` where that closed form
applies.

Deliberate differences from the reference: an eager run sees every layer,
where XLA counts a loop body once, so the unrolled R=1/R=2 extrapolation
(``--no-measure``'s) is not needed and ``--no-measure`` changes nothing;
the bytes are unfused (each op's inputs and outputs); the collective term
takes the output bytes, as the reference's; and a family the mesh does not
run yet (``models/transformer.py::check_shardable``: MoE, Mamba2, the
encoder-decoder and the prefix-LM) gets a ``skipped`` row naming ROADMAP
item 15.7b, so ``--arch all`` exits 0 when nothing else failed.

Exit code 0: every combination ran (or was skipped); anything else is a
fault in the distribution (a placement, a shape, a collective).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

__all__ = ["active_params", "run_one", "closed_form_holds", "main"]


def active_params(cfg) -> tuple[float, float]:
    """(total_params, active_params) over the meta model's parameters:
    active counts a parameter whose name holds ``expert`` at ``top_k /
    num_experts`` of its size (the routed experts a token runs)."""
    from repro_torch.models import Transformer

    total = active = 0.0
    for name, p in Transformer(cfg, device="meta").named_parameters():
        n = float(p.numel())
        total += n
        if "expert" in name and cfg.num_experts:
            active += n * cfg.top_k / cfg.num_experts
        else:
            active += n
    return total, active


def _skipped(arch, shape_name, multi_pod, reason) -> dict:
    return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "skipped", "reason": reason}


def _tokens(shape) -> float:
    """The reference's token count for MODEL_FLOPS: 6·N·D for training, 2·N·D
    for serving, D the processed tokens (B·S, or B for decode)."""
    if shape.kind == "decode":
        return shape.global_batch * 2.0 / 6.0
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len * 2.0 / 6.0
    return float(shape.global_batch * shape.seq_len)


def _step_args(built, cfg, shape, mesh, phase):
    """The step's arguments on the meta device: the model (and its replicas)
    sharded on the mesh, the optimizer state, the inputs of
    ``input_specs``; a decode step at the context's last position."""
    import torch

    from repro_torch.configs import input_specs
    from repro_torch.models import Transformer
    from repro_torch.train.optim import AdamW

    def model():
        return built.shard_model(Transformer(cfg, device="meta"))

    if shape.kind == "train" and phase == "personalize":
        names = list(mesh.mesh_dim_names)
        n_data = 1
        for a in names:
            if a != "model":
                n_data *= mesh.size(names.index(a))
        glob = model()
        reps = built.shard_replicas([Transformer(cfg, device="meta")
                                     for _ in range(n_data)])
        states = [AdamW().init(m.parameters()) for m in reps]
        active = torch.ones(n_data, dtype=torch.bool)
        return (reps, states, built.arg_specs, glob, active)
    # the inputs placed as the step's in_shardings say: each rank holds its
    # shard of the batch and of the decode caches
    from repro_torch.models.sharded import shard_tensor

    def place(tree, pls):
        if isinstance(tree, dict):
            return {k: place(v, pls[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [place(v, q) for v, q in zip(tree, pls)]
        return shard_tensor(tree, mesh, pls)

    specs = input_specs(cfg, shape)
    m = model()
    sh = built.in_shardings
    if shape.kind == "train":
        return (m, AdamW().init(m.parameters()), place(specs, sh[2]))
    if shape.kind == "prefill":
        return (m, place(specs, sh[1]))
    return (m, place(specs["token"], sh[1]), place(specs["caches"], sh[2]),
            shape.seq_len - 1)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            variant: str | None = None, phase: str = "generalize",
            measure: bool = True, overrides: dict | None = None,
            seq_shard_residual: bool = True, constrain_attn: bool = True,
            tag: str = "") -> dict:
    """One (arch, shape) combination: its row (``status`` ``"ok"`` or
    ``"skipped"``).  ``measure`` is accepted for the reference's CLI and
    changes nothing (see the module's docstring)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_dryrun_world
    from repro_torch.launch.steps import build_step
    from repro_torch.models.sharded import step_collective_bytes
    from repro_torch.models.transformer import check_shardable
    from repro_torch.roofline import (HW, CollectiveCounter, StepCounter,
                                      analyze_step)

    del measure
    shape = SHAPES[shape_name]
    base_cfg = get_config(arch)
    # a family no mesh runs yet (ROADMAP item 15.7b), whatever the shape
    try:
        check_shardable(base_cfg)
    except NotImplementedError as e:
        return _skipped(arch, shape_name, multi_pod, str(e))
    # long_500k policy (DESIGN.md): full-attention archs need the swa variant
    if shape_name == "long_500k" and not base_cfg.supports_long_context \
            and variant not in ("swa",):
        return _skipped(arch, shape_name, multi_pod,
                        "full attention; run with --variant swa")
    cfg = get_config(arch, variant)
    if overrides:
        cfg = replace(cfg, **overrides)

    mesh = make_dryrun_world(multi_pod=multi_pod)
    chips = mesh.size()
    t0 = time.perf_counter()
    built = build_step(cfg, shape, mesh, phase=phase,
                       seq_shard_residual=seq_shard_residual,
                       constrain_attn=constrain_attn)
    args = _step_args(built, cfg, shape, mesh, phase)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    with CollectiveCounter() as coll, StepCounter() as counts:
        # the step's outputs stay alive to the counter's end: its output
        # bytes
        out = built.step(*args)
    t_run = time.perf_counter() - t0
    del args, out
    print(f"== {built.name} mesh={tuple(mesh.shape)} ==")
    print({"flops": counts.flops, "bytes accessed": counts.bytes})

    total_p, active_p = active_params(cfg)
    rep = analyze_step(built.name, counts, chips=chips,
                       n_active_params=active_p, tokens=_tokens(shape),
                       collectives=coll)
    in_out = coll.total()
    closed = None
    if phase == "generalize" or shape.kind != "train":
        kind = shape.kind
        width = None
        if kind == "decode":
            from repro_torch.configs import decode_cache_width
            width = decode_cache_width(cfg, shape)[0]
        try:
            closed = step_collective_bytes(
                cfg, kind, shape.global_batch,
                1 if kind == "decode" else shape.seq_len, built.policy,
                cache_width=width)
        except NotImplementedError:
            closed = None
    row = rep.row()
    row["raw_cost_analysis"] = {"flops": rep.hlo_flops,
                                "bytes": rep.hlo_bytes,
                                "coll": dict(rep.coll_bytes)}
    if tag:
        row["tag"] = tag
    if overrides:
        row["overrides"] = {k: str(v) for k, v in overrides.items()}
    row["seq_shard_residual"] = seq_shard_residual
    row["constrain_attn"] = constrain_attn
    row.update({
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "variant": variant or "base", "phase": phase, "status": "ok",
        "total_params": total_p, "active_params": active_p,
        "lower_s": t_build, "compile_s": t_run,
        "argument_bytes": counts.argument_bytes,
        "output_bytes": counts.output_bytes,
        "temp_bytes": counts.temp_bytes,
        "fits": counts.peak_bytes <= HW().memory_bytes,
        "mesh_device": mesh.device_type,
        "kernels": {k: list(v) for k, v in counts.kernels.items()},
        # the collectives' inputs plus outputs by kind, as the staged
        # backend and the closed form count them
        "coll_in_out": {k.replace("-", "_"): v for k, v in in_out.items()},
        "coll_closed_form": closed,
    })
    print(json.dumps({k: row[k] for k in
                      ("compute_s", "memory_s", "collective_s", "dominant",
                       "useful_flops_ratio", "compile_s", "fits")},
                     indent=None))
    return row


def closed_form_holds(row) -> bool | None:
    """Whether an ``ok`` row's input-plus-output collective bytes equal the
    closed form (None where it does not apply)."""
    want = row.get("coll_closed_form")
    if want is None:
        return None
    got = row["coll_in_out"]
    return all(got.get(k, 0) == v for k, v in want.items()) and all(
        k in want or v == 0 for k, v in got.items())


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default=None, choices=(None, "base", "swa"))
    ap.add_argument("--phase", default="generalize",
                    choices=("generalize", "personalize"))
    ap.add_argument("--auto-swa", action="store_true",
                    help="use the swa serving variant automatically for "
                         "long_500k on full-attention archs")
    ap.add_argument("--no-measure", action="store_true",
                    help="accepted for the reference's CLI; the eager "
                         "count needs no extrapolation")
    ap.add_argument("--no-seq-shard", action="store_true",
                    help="disable Megatron sequence-sharding of the residual")
    ap.add_argument("--no-constrain-attn", action="store_true",
                    help="drop the head-sharding constraint on attention acts")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field override, e.g. capacity_factor=1.0")
    ap.add_argument("--tag", default="", help="label stored with the rows")
    ap.add_argument("--out", default=None, help="append JSON rows here")
    return ap


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config

    args = build_parser().parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)
    rows, failures = [], []
    for arch in archs:
        for shape_name in shapes:
            variant = args.variant
            if (args.auto_swa and shape_name == "long_500k"
                    and not get_config(arch).supports_long_context):
                variant = "swa"
            overrides = {}
            for ov in args.override:
                k, v = ov.split("=", 1)
                overrides[k] = (float(v) if "." in v else
                                (None if v == "None" else int(v)))
            try:
                rows.append(run_one(
                    arch, shape_name, multi_pod=args.multi_pod,
                    variant=variant, phase=args.phase,
                    measure=not args.no_measure,
                    overrides=overrides or None,
                    seq_shard_residual=not args.no_seq_shard,
                    constrain_attn=not args.no_constrain_attn,
                    tag=args.tag))
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((arch, shape_name, repr(e)))
                rows.append({"arch": arch, "shape": shape_name,
                             "multi_pod": args.multi_pod, "status": "error",
                             "error": repr(e)[:2000]})
                print(f"FAILED {arch} x {shape_name}: {e!r}", file=sys.stderr)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + rows, f, indent=1, default=str)
    print(f"\n{len(rows) - len(failures)}/{len(rows)} combination(s) OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

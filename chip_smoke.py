#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
Phases, each of which fails the run (non-zero exit) on any error:

  1. device   requires ``torch.cuda.is_available()``; prints the card's name
              and power limit as ``nvidia-smi`` reports them
  2. build    compiles every CUDA source of the package (one ``nvcc`` per
              source, all started together) and prints ptxas's report
  3. kernels  holds every kernel against its plain PyTorch version on the
              card.  Segment-mean forward: the cases of
              ``tests/test_kernels.py`` (ragged sweep incl. D=130, isolated
              nodes, an empty edge set, an all-pad block, the row_base
              sub-ranges), float64 dyadic inputs (bitwise), a stacked case
              with per-partition row_base, hub rows split across warps
              (K, K+1, 3K+5 and 10,000 in-edges at D=128/130, f32, bf16,
              f64 dyadic, one partition's hub stacked), and the stacked
              products-s shapes at D=64 and D=128, launched twice (bitwise
              equal) with the work plan's size printed; the
              single-partition use (the streamed eval, the partition
              mesh): each products-s partition's blocks and transpose
              blocks unstacked with plans of their own
              (``engine.stacking.partition_vjp_blocks``), every
              partition's launch of either kernel bitwise its rows of the
              stacked launch, the partition with the most edges timed at
              D=64 and D=128, forward and backward (launched twice,
              bitwise equal); its row-range use (a mesh rank's overlapped
              forward): each partition's rows of both split halves with
              plans of their own, the boundary half at the partition's
              n_int as a Python int, every launch of either kernel bitwise
              its rows of the stacked launch, the boundary half of the
              partition with the most edges timed; the overlapped
              forward's row-range use: the products-s interior and boundary
              split blocks (``build_stacked_split_vjp_blocks``) at D=64 and
              D=128 into own_cap rows, the boundary half at every
              partition's n_int (a (P,) tensor), forward and backward,
              each launched twice (bitwise equal), the products-s boundary
              half in f64 dyadic (bitwise; one partition's n_int + nb·BN
              runs past own_cap, so its last rows are dropped) and a
              stacked f64 dyadic case whose real rows run past num_rows
              (both passes bitwise).  Backward: the cases of
              ``tests/test_torch_segment_bwd.py`` (ragged sweep, row_base
              sub-ranges, rows sliced off by num_rows, an all-pad block, an
              empty edge set, stacked per-partition row_base), float64
              dyadic cases with deg in {1, 2, 4, 8} (bitwise), hub source
              rows (5,000, 3K+5, K+1, K out-edges; D=128/130, f32, bf16,
              f64 dyadic, rows cut off, stacked), and the products-s
              transpose blocks at D=64 and D=128 (twice, bitwise); blocks
              without the work plan must make both ops raise.  One line per
              shape with kernel_ms, plain_ms, library_ms (one
              ``torch.sparse.mm`` with the CSR mean matrix, or its
              transpose, a yardstick the port never calls), bound_us and,
              for the backward, the longest transpose row.  Flash
              attention: ``tests/test_kernels.py``'s cases, a fully masked
              row, qwen2-0.5b's prefill (q 4x14x2048x64, k/v
              4x2x2048x64) and decode (q 4x14x1x64 against a 2,116-slot
              cache at q_offset 2,048) shapes and starcoder2-7b's prefill
              (q 4x36x4608x128, k/v 4x4x4608x128, window 4,096) and
              rolling decode (q 4x36x1x128 against all 4,096 slots of its
              mod-W cache, q_offset 4,095), whisper-small's (batch 4:
              the encoder's bidirectional 1,500 frames, the decoder's
              causal 384-token prefill, the cross prefill of 384 queries
              over 1,500 keys, the self decode against 452 slots at
              q_offset 416, the cross decode over 1,500 keys; Dh 64) and
              paligemma-3b's (q 4x8x512x256 against one KV head under the
              prefix-LM mask of 256 patches, and the decode of group 8
              against 580 slots; Dh 256), and a window whose live range
              leaves a gap after a prefix, the serving shapes launched
              twice (bitwise equal; SDPA with a boolean mask beside a
              prefix, none where every key is live); RMSNorm, alone and with the
              residual add fused in (its sum bitwise torch's ``x + delta``):
              its three shapes and qwen2-0.5b's prefill (4, 2048, 896) and
              decode (4, 1, 896) rows; all in f32 and bf16 (the main path's
              shapes in bf16 held to one bf16 rounding, flash attention's
              launched twice there and every RMSNorm case, bitwise equal),
              with library_ms one ``scaled_dot_product_attention`` or
              ``rms_norm`` call (for the fused norm two: ``x + delta``, then
              ``rms_norm``), and torch's add alone beside RMSNorm.  Each
              flash line names its design (tensor-core or f32 prefill,
              split-KV decode) and grids, and the share of the bound it
              reached (TFLOP/s over the peak, bytes/s over HBM's rate).
              Times are medians between events around the enqueue of a
              call (host work counts where the device outruns the host);
              every line adds the device time alone (``*_device_ms``, host
              hidden behind a sleep kernel) and ``call_us``, the host clock
              over back-to-back calls.  The training path: flash
              attention's forward with the log-sum-exp (its output bitwise
              serving's prefill, the LSE against ``torch.logsumexp``, -inf
              where a row sees no key) and its backward kernel (dq, dk, dv
              against autograd of the plain version, launched twice
              bitwise) on ``tests/test_kernels.py``'s cases, window 0,
              qwen2-0.5b's training shape (q 8x14x512x64, k/v 8x2x512x64),
              the prefix-LM mask and Dh 256 (group 8, the Sq and Sk tails),
              paligemma-3b's training shape (q 4x8x768x256 against one KV
              head, prefix 256) and whisper-small's (the encoder's 8 x 12
              x 1,500^2 bidirectional, the decoder's causal 448, the
              cross-attention's 448 over 1,500; Dh 64),
              and the RMSNorm backward of both entry points at three
              shapes and the training rows (8, 512, 896), all in f32 and
              bf16; at the training shapes their times beside the plain
              versions' (autograd) and the library's
              (``scaled_dot_product_attention`` with ``is_causal``, or a
              boolean mask of the live pairs beside a prefix, and
              ``enable_gqa``; ``rms_norm``; their backwards through
              autograd), with the bounds (operations at the type's peak,
              bytes at 3.35 TB/s)
  4. serve    ``repro_torch.launch.serve.gnn_main`` at products-s, P=4,
              hidden 128, seed 0: export, 20 ticks of 4 feature updates and
              16 queries, then edge additions (one grows a halo row) and a
              removal; the launch counts must rise in the export and in the
              recompute, and the served logits must match a from-scratch
              plain-aggregation forward over ``apply_updates_to_graph``;
              then ten more ticks are broken down: host functions by
              cumulative time (cProfile), the device's busy share and top
              kernels (torch.profiler)
  5. train    ``repro_torch.launch.train`` ``gnn`` at products-s, P=4,
              hidden 128, seed 0: a sampled run and a ``--full-graph-train``
              run (both ``--phase0-frac 0.5``, so both phases run) and a
              short ``--centralized --full-graph-train`` run, after an
              uncounted two-epoch warm-up run.  Each eval
              must launch the forward kernel (2 launches, one per layer)
              and each full-graph step the backward kernel once; losses
              finite, the full-graph loss falling.  Then one full-graph
              step's gradients with the kernels against the plain
              aggregation, the sampled run again with the plain
              aggregation (same iteration history, micro-F1 within 0.005),
              and one full-graph step broken down (torch.profiler).  Then
              the overlapped split forward: an ``--overlap-halo
              --full-graph-train`` run and a sampled ``--overlap-halo
              --ring-chunks 2`` run (the flag is only checked to be
              accepted: on one card the exchange is the transpose whatever
              its value; each eval launches the forward kernel
              4 times, 2 layers x 2 halves, and each full-graph step the
              backward kernel twice, layer 1's halves: layer 0 reads the
              features, which need no gradient); overlapped against
              synchronous on one set of params (owned-row logits within
              1e-4, owned predictions and micro-F1 reported, one
              full-graph step's gradients within GRAD_ATOL/GRAD_RTOL), the
              full-graph step's and the eval forward's times with and
              without overlap (CUDA events around the enqueue, and with
              the host hidden), and one overlapped step and both eval
              forwards broken down (torch.profiler); then ``--engine sequential
              --full-graph-train`` for 2 epochs, the Python-loop oracle with
              the plain aggregation, against the stacked engine with its
              kernels from the same start (losses and params within
              GRAD_ATOL/GRAD_RTOL; the oracle launches no kernel).  Then
              ``comm_checks``, the halo cache and compressed communication:
              the cached forward at full refresh bitwise the synchronous
              one; a sampled ``--halo-cache --halo-refresh-every 4
              --halo-cv`` run whose per-epoch exchange bytes equal
              ``halo_refresh_plan``'s closed form (micro-F1 beside the
              uncached run's, its launches); fp16 and int8 evals (the
              codec on the card bitwise the CPU's, the residual zero on
              pad slots, landed trash rows zero, the wire bytes 1/2 and
              (D+4)/(4D) of the uncompressed, micro-F1 beside it); async
              phase-0 epochs through the bucketed and top-k reducers
              against none's; the eval forward's and the epoch call's
              times and the state's bytes on the device.  Then
              ``featstore_checks``, the two-tier feature store and the
              streamed eval over the pipeline's partition: evals at
              hot_frac 0 / 0.25 / 0.5 / 1 and both policies bitwise the
              all-resident eval (logits, micro, preds; 2 launches an eval),
              the store with the halo cache and with int8 bitwise those
              compositions without it, async epochs of both phases with a
              feature-store sampler bitwise the resident sampler's, the
              streamed eval at G = 1, 2, 4 within SERVE_ATOL of the stacked
              eval (2·P single-partition launches), ``cold_h2d_bytes``
              equal to the closed forms, ``launch.train gnn`` runs with
              ``--feat-store`` (sampled and async equal to the resident
              runs; ``--feat-groups 2``), featstore-xl refused all-resident
              under 0.7 x its peak and trained streamed, and the times of
              the eval forward, the stage copy (pinned and pageable), the
              streamed evals and the async epoch, with and without the
              store.  Then
              ``mesh_checks``, the partition mesh (``mode="spmd"``): an
              NCCL world of 1 at P = 1 and a gloo world of 4 ranks sharing
              the card (an NCCL world of 4 where there are 4 cards), each
              rank running the pipeline sampled, full-graph and phase 0
              alone, held against the stacked runs (the world of 1
              bitwise; the world of 4 within the reference's spmd
              tolerances, its export logits and ``ring_chunks=2``
              bitwise), every rank's result equal, a phase-0 epoch's and
              one exchange's times beside the card (4 processes sharing
              one card, not a multi-card time); and item 14's part 2 on
              the same worlds: the pipeline with both async flags against
              the stacked run, ``--feat-store --hot-frac 0.5`` sampled and
              async runs bitwise the world's resident runs with
              ``cold_h2d_bytes`` the closed forms, sampled and async runs
              killed after boundary 1 and a store run after boundary 4,
              each resumed bitwise the uninterrupted run, each async
              epoch call's time beside the stacked one, rank 0's save
              and load ms; and item 14's part 3 on the same worlds
              (``mesh_part3_checks``): seven cached, compressed and
              overlapped eval cases bitwise the stacked engine on every
              rank (logits, the cache and residual by digest, bytes), no
              collective under a (0, 0) plan (a wrapper counts the
              ``torch.distributed`` calls), the overlapped full-graph
              gradients and each reducer's first reduced gradient within
              rel 1e-6, nine option pipelines against the stacked runs
              with every byte counter equal (the world of 1 bitwise), the
              async cache + int8 + top-k run killed after boundary 1 and
              resumed bitwise, and the options' eval-forward, exchange and
              reducer-epoch times; in the gloo world the 4-epoch runs'
              params are held to MESH_ORACLE_MULT times the sequential
              oracle's own 4-epoch drift from the stacked engine at the
              two runs that drift most (``mesh_oracle_drift``: the oracle
              runs each partition's products at a rank's shapes).  Then
              the async run, ``--async-generalize --async-personalize``
              (both epochs drawn on the card by the device sampler): no
              host draw in either phase, the device draw counter moved, two
              forward launches per eval, finite losses, phase 1 ran; beside
              the sampled run, each phase's epoch call (steps and eval,
              host clock, synchronised), host→device bytes per epoch and
              micro-F1 (reported, not asserted: the draws come from other
              streams); and one async epoch of each phase, and a
              host-path phase-0 epoch with its batch's copy, broken down
              in a fresh process (torch.profiler: launches, device busy,
              top kernels, HtoD copies and their bytes)
  6. llm      ``repro_torch.launch.serve.llm_main`` with qwen2-0.5b at its
              published widths (24 layers, d_model 896, 14/2 heads, vocab
              151,936, bf16), batch 4, prompt 2,048, 64 new tokens, seed 0:
              prefill ms, decode ms per step (p50, p99), tokens/s; every
              prefill and decode step must launch flash attention 24 times
              and RMSNorm 49 times, 48 of them with the residual add fused
              in, and both flash designs and both RMSNorm entry points must
              have launched.  Then the kernels against their plain
              versions on the same weights: in bf16 the logits' max |diff|
              and the share of equal greedy tokens (reported), in the f32
              variant of the config the prefill logits and 8 teacher-forced
              decode steps and their greedy tokens (asserted), the SHA-256
              of the bf16 prefill logits and tokens printed (held against
              another tree's by ``scripts/llm_serving_digest.py``); and one
              prefill and 16 decode steps broken down (torch.profiler),
              with the kernel launches and torch's elementwise adds per step
  6b. zoo     the rest of the zoo served at full width, bf16,
              seed 0 (``ZOO_RUNS``): starcoder2-7b ``--full --swa``
              through ``llm_main`` (batch 4, prompt 4,608 past its 4,096
              window, 64 new tokens, the rolling cache filled by the
              prefill's gather and wrapped by the decode), mamba2-370m
              ``--full`` (batch 4, prompt 2,048, 64 new), and through
              ``serve_model`` (a ``ServeEngine``) phi3.5-moe cut to 8 of
              its 32 layers (batch 4, prompt 2,048, 64 new) and jamba cut
              to 1 of its 4 super-blocks (batch 4, prompt 2,048, 32 new),
              widths untouched; then (ROADMAP items 15.5, 15.6)
              whisper-small ``--full`` (batch 4, prompt 384, 64 new: the
              published 448-token decoder context; random 1,500-frame
              encoder inputs) and paligemma-3b ``--full`` (batch 4, 256
              random patch embeddings before a 256-token prompt, 64 new),
              both through ``llm_main``, nothing cut: prefill ms, decode
              p50/p99, tokens/s, peak memory, launches per prefill and
              per decode step asserted (flash 32 / 0 / 8 / 1 / 36 and 24 /
              18, RMSNorm 0 / 49 / 0 / 17 / 0 / 37 of which 0 / 48 / 0 /
              16 / 0 / 36 fused; every decode step in the split-KV decode
              design) and the tokens an MoE prefill drops by capacity;
              then each one's f32 variant (``ZOO_F32``: starcoder2 4
              layers at batch 2, phi3.5-moe 2 layers, jamba its first 4
              sub-layers, whisper-small and paligemma-3b whole) with the
              kernels against their plain versions on the same weights:
              prefill logits, 8 teacher-forced decode steps and their
              greedy tokens on the batch rows whose MoE routes agree, the
              flipped routes counted (asserted)
  7. train    ``repro_torch.launch.train`` ``llm`` with qwen2-0.5b at its
              published widths (remat on), 4 shards of 8 x 512 tokens, 4
              phase-0 and 4 phase-1 steps, seed 0: finite losses; every
              step launches, per shard, the flash training forward 48
              times (remat replays each layer), its backward 24 times,
              RMSNorm's forward 97 times and its backward 49 times, and
              no serving design; step ms (median after a phase's first
              step), tokens/s and peak memory beside the card's name and
              power limit.  Then one phase-0 step of the f32 variant
              from one seed, the kernels against their plain versions
              (the shards' losses and the mean gradient), and one bf16
              phase-0 step broken down (torch.profiler, from fresh AdamW
              moments: the run frees phase 0's when phase 1 starts)
  7b. shard   the sharded steps (ROADMAP item 15.7,
              ``launch/steps.py::build_step(cfg, shape, mesh)``): qwen2-0.5b
              bf16 at full width and depth (train 8 x 512 with remat,
              prefill 4 x 2,048, 16 greedy decode steps, a personalize
              step of 2 replicas) and its f32 variant cut to 4 layers; an
              NCCL world of 1 on a (1, 1) mesh bitwise the unsharded steps
              (what differs is named); a world of 4 sharing the card on
              (2, 2) over the ``staged`` backend (a gloo world of 2 shows
              first what DTensor on gloo does with card tensors), each
              rank's launches equal to the unsharded step's, its staged
              bytes equal to ``step_collective_bytes``, the f32 loss,
              logits and gradients within 1e-5 of the world of 1's, the
              gradients' global norm (AdamW's clip) within 1e-6, the
              weights after one step within 1e-5 of the largest weight
              where the gradient is at least 1e-6 (the rest reported); step ms on
              the slowest rank, peak memory per rank, the bf16 greedy
              tokens' agreement reported
  7c. dryrun  the dry run and the roofline (ROADMAP item 15.8): the fake
              backend probed (``scripts/fake_world_probe.py``), then
              ``python -m repro_torch.launch.dryrun --arch qwen2-0.5b
              --shape all --auto-swa`` on the fake (16, 16) world (four
              rows ``ok``, the collectives' input-plus-output bytes equal
              to ``step_collective_bytes`` where it applies); then one
              qwen2-0.5b bf16 train step at full width (8 x 512, remat, no
              mesh) counted on the card by the same counters while the
              kernels run: its FLOPs and every kernel's count equal to the
              same step's on meta, its launches asserted; compute_s,
              memory_s and the model FLOPs beside the measured step ms
              (median of 5) and the share of the bf16 peak, with the
              card's name and power limit
  7d. zoo-train  the MoE and Mamba2 families trained (ROADMAP item 15.9,
              ``ZOO_TRAIN_RUNS``): ``launch.train llm`` bf16, seed 0, the
              published widths and every expert, cut in depth only, 2
              phase-0 and 2 phase-1 steps: mamba2-370m whole and
              phi3.5-moe at 1 of 32 layers on 2 shards of 4 x 512, jamba
              at its first 2 sub-layers (attention + MLP, Mamba2 + MoE) on
              1 shard of 8 x 512 (two replicas and their AdamW moments
              would not fit the card); finite
              losses, each step's flash and RMSNorm launches asserted,
              step ms, tokens/s, peak memory; then the ``ZOO_F32``
              variants' training pass (loss and every gradient) with the
              kernels against the plain versions on a batch whose MoE
              routes agree, the flipped routes of the others counted
  7e. encdec-train  whisper-small and paligemma-3b trained (ROADMAP item
              15.10, ``ENCDEC_TRAIN_RUNS``) through ``launch/steps.py::
              build_step`` with no mesh, bf16, seed 0, whole at their
              published widths: whisper 8 x 448 decoder tokens over 1,500
              random frames, paligemma 4 x (256 random patches + 512
              tokens); 2 generalize steps, then 2 personalize steps (2
              replicas for whisper, 1 for paligemma, whose two replicas
              would not fit the card); finite losses, each step's flash
              and RMSNorm launches asserted (the encoder not under remat,
              the decoder under it), no prefill or decode launch, step
              ms, tokens/s and peak memory; then each one's f32 training
              pass with the kernels against the plain versions
  8. report   a ``{"kernels": [...]}`` line (the segment kernels' whole-space
              use, their row-range use, their single-partition use, whose
              launches include the mesh ranks', and their row-range
              single-partition use, the mesh ranks' overlapped forward;
              flash attention's two designs and both RMSNorm entry points,
              whose launches include the zoo's, flash's Dh 256
              instantiations apart (paligemma-3b's prefill with its prefix
              and its decode),
              and the training path's flash forward with the LSE, the
              flash backward and the RMSNorm backward of both entry
              points, whose launches include phases 7, 7c, 7d and 7e, as
              the RMSNorm rows include their forwards, both flash
              launches' Dh 256 instantiations with the prefix apart at
              paligemma-3b's training shape, with 7e's paligemma
              launches), then the device line last


Nothing of JAX or of the ``repro`` package is imported.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the kernels' work formulas and the card's rates (the roofline's)
from repro_torch.kernels import work  # noqa: E402
from repro_torch.roofline import HW  # noqa: E402

_HW = HW()

# tolerances of the kernel against its plain version on the card: f32 sums
# run in another order (the plain version's index_add_ uses atomics), bf16
# outputs round once from f32 sums in both (mirrors tests/test_kernels.py);
# f64 on dyadic inputs is exact in any order, so it must be bitwise
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# the backward's f32 tolerance: at products-s a transpose row sums up to
# 3,119 out-edges (the forward's sums are divided by deg before they are
# compared, the backward's are not), and the plain version's index_add_
# adds with atomics in a run-dependent order; |kernel - plain| there has
# been 9.5e-6 to 1.34e-5.  bf16 as the forward: both round one f32 sum
TOL_BWD = {"float32": 1e-4, "bfloat16": TOL["bfloat16"]}
# served logits (incremental recompute through the kernel) against a
# from-scratch plain forward: f32 sums of up to thousands of edges in
# different orders over two layers, and cuBLAS may pick other kernels for a
# row subset than for the full product
SERVE_ATOL, SERVE_RTOL = 1e-4, 1e-4
# one full-graph step's gradients, kernels against the plain aggregation
# (the float32 sums of both passes run in other orders; the backward's
# plain index_add_ and the halo gather's backward use atomics)
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# micro-F1 of the sampled run with the kernels against the plain
# aggregation: training never runs the kernel, evaluation picks the best
# model, so only a flipped validation prediction can move it
F1_ATOL = 0.005
# flash attention and RMSNorm against their plain versions on the card: the
# tolerances tests/test_kernels.py holds the Pallas kernels to (f32 sums in
# another order; bf16 outputs round once from f32 in both)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
RMS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# both kernels in bf16 at the main path's shapes, where flash attention's
# outputs are of order 0.04 and 3e-2 would hide a dropped tile: the kernel
# and its plain version both round one f32 result to bf16, so they may be
# one bf16 ulp apart (at most 2^-7 of the value) plus the f32 sums' own
# difference (observed <= 3e-6 in f32)
BF16_MAIN_ATOL, BF16_MAIN_RTOL = 1e-5, 2.0 ** -7
# qwen2-0.5b at full width in float32, kernels against their plain versions
# on the same weights: every GEMM is the same cuBLAS call on both sides, so
# the difference is the attention's and the norms' summation order, carried
# through 24 residual layers into logits of magnitude ~3.4; it has been
# 2.8e-6 to 3.9e-6, and a wrong mask or row moves logits by O(0.1)
LLM_F32_ATOL, LLM_F32_RTOL = 1e-4, 1e-4
# cycles of the sleep kernel that keeps the device ahead of the host while
# a launch's device time is timed (~2 ms at the H100's clocks, more than a
# kernel wrapper's host work); a whole forward or step, whose host work can
# pass 2 ms, is timed behind 10 times as many
SLEEP_CYCLES = 4_000_000
# the card's rates, one definition with the roofline's
# (repro_torch/roofline/analysis.py::HW, the H100 SXM5's datasheet): HBM3
# bytes/s, f32 on the CUDA cores (the norm's and the segment kernels'
# arithmetic in either type), f64 on the CUDA cores
HBM_BYTES_S = _HW.hbm_bw
PEAK_FLOPS = {"float32": _HW.peak_flops_f32, "bfloat16": _HW.peak_flops_f32,
              "float64": 34e12}
# attention's products: f32 on CUDA cores, bf16 on the tensor cores (dense)
ATTN_PEAK_FLOPS = {"float32": _HW.peak_flops_f32, "bfloat16": _HW.peak_flops}
SEGMENT_AGG_TPU = "src/repro/kernels/segment_agg.py:161"
SEGMENT_AGG_BWD_TPU = "src/repro/kernels/segment_agg.py:332"
SEGMENT_AGG_ROWS_TPU = "src/repro/kernels/segment_agg.py:239"
FLASH_TPU = "src/repro/kernels/flash_attention.py:41"
RMSNORM_TPU = "src/repro/kernels/rmsnorm.py:21"
# the transformer serving run: qwen2-0.5b at its published widths
LLM_ARGS = ["--arch", "qwen2-0.5b", "--full", "--batch", "4", "--prompt-len",
            "2048", "--new-tokens", "64", "--seed", "0", "--device", "cuda"]
# the transformer training run: qwen2-0.5b at its published widths, 4
# shards of 8 sequences of 512 tokens, 4 phase-0 and 4 phase-1 steps
LLM_TRAIN_ARGS = ["llm", "--arch", "qwen2-0.5b", "--full", "--shards", "4",
                  "--batch", "8", "--seq", "512", "--docs", "256", "--steps",
                  "8", "--phase0-frac", "0.5", "--seed", "0", "--device",
                  "cuda"]
# the training path's backward kernels against autograd of their plain
# versions (tests/test_torch_gpu.py's FLASH_BWD_TOL and RMS_BWD_TOL, the
# RMSNorm ones relative to each gradient's largest entry): f32 sums in
# another order; bf16 gradients round once from f32 in the kernels, where
# the plain flash backward reads the output in f32 and not rounded to bf16
# as the kernel's D_i does, and autograd rounds the norm's gradient to bf16
# before it adds the residual's
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# and in bf16 each gradient's max |kernel - plain| within this share of its
# largest plain entry: at long key ranges (whisper's 1,500 frames) P is
# ~1/1,500 and a typical |dk| or |dv| is no larger than FLASH_BWD_TOL's
# atol, so that alone would miss a lost query tile
FLASH_BWD_TOP_RTOL = 3e-2
RMS_BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the training forward's log-sum-exp against torch.logsumexp of the scaled
# live scores: f32, the kernel's exp2 and sums in another order
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# qwen2-0.5b at full width in float32, one phase-0 step (4 shards' losses
# and their mean gradient) with the kernels, forward and backward, against
# the plain versions from the same weights: the GEMMs are the same calls on
# both sides, the attention's and the norms' sums (forward and backward)
# run in other orders through 24 layers; each gradient is compared
# relative to its largest entry
LLM_TRAIN_LOSS_RTOL = 1e-5
LLM_TRAIN_GRAD_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# phase 3 helpers
# --------------------------------------------------------------------------

def random_csr_edges(n, max_deg, seed):
    """tests/test_kernels.py's _random_csr, as (src, dst) edge lists."""
    rng = np.random.default_rng(seed)
    deg = []
    indices = []
    for _ in range(n):
        k = int(rng.integers(0, max_deg + 1))
        indices.extend(rng.integers(0, n, k))
        deg.append(k)
    return (np.asarray(indices, np.int64),
            np.repeat(np.arange(n), np.asarray(deg, np.int64)))


def stack_host_blocks(per_part, sa):
    """Pad per-partition forward blocks dicts to common (nb, BE)."""
    nb = max(b["src"].shape[0] for b in per_part)
    be = max(b["src"].shape[1] for b in per_part)
    P = len(per_part)
    out = {"src": np.zeros((P, nb, be), np.int32),
           "dst": np.zeros((P, nb, be), np.int32),
           "mask": np.zeros((P, nb, be), np.float32),
           "deg": np.ones((P, nb, sa.BN), np.float32)}
    for p, b in enumerate(per_part):
        k, e = b["src"].shape
        for key in ("src", "dst", "mask"):
            out[key][p, :k, :e] = b[key]
        out["deg"][p, :k] = b["deg"]
    out.update(sa.block_row_work(
        sa.block_row_ptr(out["dst"], out["mask"], sa.BN)))
    return out


def hub_edges(rows, n_src, hubs, max_deg, seed):
    """(src, dst): ``rows`` destination rows of 0..max_deg in-edges, then
    one row per entry of ``hubs`` with that many in-edges."""
    r = np.random.default_rng(seed)
    deg = np.r_[r.integers(0, max_deg + 1, rows), hubs].astype(np.int64)
    return r.integers(0, n_src, int(deg.sum())), np.repeat(np.arange(deg.size), deg)


CLIP_BASES, CLIP_ROWS, CLIP_N_IN, CLIP_NUM_ROWS = (np.array([200, 0, 100]),
                                                   (150, 300, 200), 320, 300)


def clip_case(sa, name, stack, kind):
    """A stacked f64 dyadic case (in-degrees in {0, 1, 2, 4, 8}, integer
    inputs: both passes exact) whose first partition's rows run past
    num_rows; ``kind`` "mean" gives the forward case, "vjp" the
    backward's."""
    per = []
    for p in range(3):
        r = np.random.default_rng(60 + p)
        deg = r.choice([0, 1, 2, 4, 8], CLIP_ROWS[p])
        dst = np.repeat(np.arange(CLIP_ROWS[p]), deg)
        src = r.integers(0, CLIP_N_IN, dst.size)
        per.append(sa.build_mean_blocks(src, dst, CLIP_ROWS[p]) if kind == "mean"
                   else sa.build_vjp_blocks(src, dst, CLIP_ROWS[p], CLIP_N_IN))
    blk = stack(per, sa)
    rows = CLIP_N_IN if kind == "mean" else CLIP_NUM_ROWS
    x = np.random.default_rng(64).integers(-8, 9, (3, rows, 40)).astype(
        np.float64)
    extent = CLIP_BASES + blk["src"].shape[1] * sa.BN
    assert (extent > CLIP_NUM_ROWS).any(), extent
    return (name, x, blk, CLIP_NUM_ROWS if kind == "mean" else CLIP_N_IN,
            CLIP_BASES, True, "float64")


def kernel_cases(sa):
    """(name, x numpy, blocks numpy, num_rows, row_base, mean, dtype)."""
    rng = np.random.default_rng(11)
    cases = []
    for n, d, max_deg in [(64, 16, 4), (200, 48, 9), (300, 130, 6)]:
        src, dst = random_csr_edges(n, max_deg, seed=n + max_deg)
        blk = sa.build_mean_blocks(src, dst, n)
        x = rng.normal(0, 1, (n, d)).astype(np.float32)
        for dtype in ("float32", "bfloat16"):
            for mean in (True, False):
                cases.append((f"sweep n={n} d={d} deg<={max_deg} {dtype} "
                              f"mean={mean}", x, blk, n, 0, mean, dtype))
    cases.append(("isolated nodes", rng.normal(0, 1, (3, 8)).astype(np.float32),
                  sa.build_mean_blocks(np.array([0, 2]), np.array([1, 1]), 3),
                  3, 0, True, "float32"))
    cases.append(("empty edge set", rng.normal(0, 1, (50, 16)).astype(np.float32),
                  sa.build_mean_blocks(np.zeros(0, np.int64),
                                       np.zeros(0, np.int64), 50),
                  50, 0, True, "float32"))
    n, d = 300, 24
    for kind, n_int in (("mixed", 141), ("zero_range (all-pad block)", n),
                        ("full_range", 0)):
        rr = n - n_int
        deg = rng.integers(0, 6, rr) if rr else np.zeros(0, np.int64)
        rdst = np.repeat(np.arange(rr), deg)
        rsrc = rng.integers(0, n, int(deg.sum())).astype(np.int64)
        blk = sa.build_mean_blocks(rsrc, rdst, rr)
        x = rng.normal(0, 1, (n, d)).astype(np.float32)
        for mean in (True, False):
            cases.append((f"rows {kind} mean={mean}", x, blk, n, n_int, mean,
                          "float32"))
    # float64 dyadic: integer features, sums exact in any order
    n, d = 200, 16
    for zero_frac, seed in ((0.25, 0), (0.9, 1)):
        r = np.random.default_rng(seed)
        deg = r.choice([1, 2, 3, 4, 8], n)
        deg[r.random(n) < zero_frac] = 0
        dst = np.repeat(np.arange(n), deg)
        src = r.integers(0, n, int(deg.sum())).astype(np.int64)
        x = rng.integers(-8, 9, (n, d)).astype(np.float64)
        for mean in (True, False):
            cases.append((f"f64 dyadic zero_frac={zero_frac} mean={mean}", x,
                          sa.build_mean_blocks(src, dst, n), n, 0, mean,
                          "float64"))
    # stacked, ragged partitions, per-partition row_base (one launch)
    P, n, d = 3, 260, 40
    per, bases = [], np.array([0, 37, 129])
    for p in range(P):
        rr = n - bases[p]
        deg = rng.integers(0, 7, rr)
        per.append(sa.build_mean_blocks(
            rng.integers(0, n, int(deg.sum())), np.repeat(np.arange(rr), deg),
            rr))
    cases.append(("stacked P=3 per-partition row_base",
                  rng.normal(0, 1, (P, n, d)).astype(np.float32),
                  stack_host_blocks(per, sa), n, bases, True, "float32"))
    # stacked f64 dyadic, rows past num_rows: partition 0's rows start at
    # 200 and its real rows reach 350 (its padded blocks 584) of a 300-row
    # output; those rows must be dropped, not land in partition 1's rows
    cases.append(clip_case(sa, "stacked f64 dyadic rows past num_rows",
                           stack_host_blocks, "mean"))
    # hub rows split across warps: rows of K, K+1, 3K+5 and 10,000 in-edges
    # among ragged ones, at D=128 (16-byte vectors), D=64 (half-width
    # vectors at f32) and D=130 (one element a lane), f32, bf16 and f64
    # dyadic (bitwise), and one partition's hub in a stacked launch with
    # per-partition row_base.  Without the mean, x is scaled by
    # 1e-3 so the 10,000-edge sums are O(0.1) (the mean makes them O(0.01)):
    # f32 reordering then moves a sum by ~1e-6, a dropped edge by ~1e-3
    k, n_in = sa.ROW_WORK_K, 4096
    hubs = [k, k + 1, 3 * k + 5, 10_000]
    src, dst = hub_edges(300, n_in, hubs, 6, seed=5)
    blk = sa.build_mean_blocks(src, dst, 304)
    for d, dtype, mean in ((128, "float32", True), (128, "float32", False),
                           (64, "float32", True), (130, "float32", True),
                           (128, "bfloat16", True), (130, "bfloat16", True)):
        scale = 1.0 if mean else 1e-3
        cases.append((f"hub rows {hubs} d={d} {dtype} mean={mean}",
                      rng.normal(0, scale, (n_in, d)).astype(np.float32),
                      blk, 304, 0, mean, dtype))
    for d in (64, 130):
        cases.append((f"hub rows f64 dyadic d={d}",
                      rng.integers(-8, 9, (n_in, d)).astype(np.float64), blk,
                      304, 0, True, "float64"))
    P, n = 3, 400
    per = []
    for p in range(P):
        src, dst = hub_edges(n - bases[p] - 1, n_in,
                             [10_000 if p == 1 else 3], 6, seed=20 + p)
        per.append(sa.build_mean_blocks(src, dst, n - bases[p]))
    cases.append(("hub stacked P=3 per-partition row_base",
                  rng.normal(0, 1, (P, n_in, 128)).astype(np.float32),
                  stack_host_blocks(per, sa), n, bases, True, "float32"))
    return cases


def time_ms(fn, iters, flush, *, hide_host=False, sleep_cycles=SLEEP_CYCLES):
    """Median time of ``fn`` over ``iters`` launches, L2 flushed (a 64 MB
    write) before each so every launch starts cold, between CUDA events
    recorded just before and just after ``fn`` is enqueued.  Where the
    host enqueues ``fn`` more slowly than the device runs it, this counts
    the host's part of the call too.  With ``hide_host`` a sleep kernel of
    ``sleep_cycles`` queued behind the flush keeps the device busy while
    the host enqueues ``fn``, so only the device's time is counted (while
    the host's part of ``fn`` is shorter than the sleep)."""
    import torch

    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in evs:
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(sleep_cycles)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def call_us(fn, calls=20):
    """Host-clock microseconds per call of ``fn`` over back-to-back calls:
    the call as its caller sees it, host work and device work together."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def library_matrix(bl_host, num_rows, row_base, n_in, mean, dtype, device,
                   transpose=False):
    """The CSR mean matrix of a blocks dict, block-diagonal over partitions:
    A @ x.reshape(P * n_in, D) is the op's output, and with ``transpose``
    A^T @ g.reshape(P * num_rows, D) its backward (yardstick only)."""
    import torch

    src = np.asarray(bl_host["src"])
    stacked = src.ndim == 3
    get = (lambda k: np.asarray(bl_host[k])) if stacked else \
        (lambda k: np.asarray(bl_host[k])[None])
    src, ldst, mask, deg = get("src"), get("dst"), get("mask"), get("deg")
    P, nb, _ = src.shape
    bn = deg.shape[-1]
    bases = np.broadcast_to(np.asarray(row_base).reshape(-1), (P,))
    rows, cols, vals = [], [], []
    for p in range(P):
        b, e = np.nonzero(mask[p] > 0)
        r = bases[p] + b * bn + ldst[p][b, e]
        keep = r < num_rows
        w = mask[p][b, e] / (deg[p][b, ldst[p][b, e]] if mean else 1.0)
        rows.append(p * num_rows + r[keep])
        cols.append(p * n_in + src[p][b, e][keep])
        vals.append(w[keep])
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    shape = (P * num_rows, P * n_in)
    if transpose:
        rows, cols, shape = cols, rows, shape[::-1]
    idx = torch.as_tensor(np.stack([rows, cols]))
    a = torch.sparse_coo_tensor(
        idx, torch.as_tensor(np.concatenate(vals)), shape,
        check_invariants=False)
    return a.coalesce().to(dtype=dtype, device=device).to_sparse_csr()


def bound_of(x, bl_host, num_rows, dtype_name):
    """Least time (s) and what bounds it, by ``kernels/work.py``'s formula:
    each input read once, the output written once, real edges only (src
    int64 + mask f32), the work plan and deg, and 2 flops per real edge and
    feature."""
    flops, nbytes = work.segment_fwd_work(tuple(x.shape), x.element_size(),
                                          bl_host, num_rows)
    t_b, t_o = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def row_edges(sa, bl_host, prefix=""):
    """Real slots of every block row (in-edges of a destination row, or
    out-edges of a source row for the transpose, ``prefix="t_"``)."""
    return np.diff(sa.block_row_ptr(bl_host[prefix + "dst"],
                                    bl_host[prefix + "mask"], sa.BN), axis=-1)


def longest_row(sa, bl_host, prefix):
    rows = row_edges(sa, bl_host, prefix)
    return int(rows.max()) if rows.size else 0


def plan_stats(sa, bl_host, prefix=""):
    """The work plan's size: entries, rows split, partial rows, the longest
    item and the empty-row runs (kernels/segment_agg.py::block_row_work)."""
    part, work, split = (np.asarray(bl_host[prefix + k])
                         for k in sa.PLAN_KEYS[:3])
    items = np.r_[part[:, 2] - part[:, 1], work[:, 2] - work[:, 1]]
    return {"items": int(part.shape[0] + (work[:, 2] > work[:, 1]).sum()),
            "rows_split": int(split.shape[0]), "partials": int(part.shape[0]),
            "zero_runs": int((work[:, 2] == work[:, 1]).sum()),
            "longest_item": int(items.max()) if items.size else 0,
            "k": sa.ROW_WORK_K}


def run_kernel_case(sa, name, x_np, bl_host, num_rows, row_base, mean,
                    dtype_name, flush, iters, record, *, repeat=False):
    """The forward kernel against its plain version on the card, its time
    (enqueue and device timers, call_us), the plain version's, one
    torch.sparse.mm's (yardstick) and the bound; with ``repeat`` two
    launches must give the same bits."""
    import torch

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    x = torch.as_tensor(x_np).to(device=dev, dtype=dtype)
    bl = sa.blocks_to_device(bl_host, dev)
    rb = (torch.as_tensor(row_base, device=dev)
          if isinstance(row_base, np.ndarray) else row_base)
    kw = dict(num_rows=num_rows, row_base=rb, mean=mean)
    got = sa.segment_mean_op(x, bl, **kw)
    torch.cuda.synchronize()
    want = sa.segment_mean_plain(x, bl, **kw)
    assert got.shape == want.shape and got.dtype == dtype, (name, got.shape)
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if dtype_name == "float64":
        assert torch.equal(got, want), f"{name}: f64 dyadic not bitwise ({err})"
    else:
        tol = TOL[dtype_name]
        assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol), \
            f"{name}: max |kernel - plain| = {err} above {tol}"
    assert torch.isfinite(got.float()).all(), name
    if name == "isolated nodes":
        assert float(got[0].abs().max()) == 0.0, "isolated row not zero"
    if repeat:
        again = sa.segment_mean_op(x, bl, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: two launches differ"
    call = lambda: sa.segment_mean_op(x, bl, **kw)
    k_ms = time_ms(call, iters, flush)
    k_dev = time_ms(call, iters, flush, hide_host=True)
    k_call = call_us(call)
    p_ms = time_ms(lambda: sa.segment_mean_plain(x, bl, **kw), iters, flush)
    lib_ms = None
    if dtype_name != "bfloat16":
        n_in = x.shape[-2]
        a = library_matrix(bl_host, num_rows, row_base, n_in, mean, dtype, dev)
        x2 = x.reshape(-1, x.shape[-1])
        lib_ms = time_ms(lambda: torch.sparse.mm(a, x2), iters, flush)
    bound_s, bound_by = bound_of(x, bl_host, num_rows, dtype_name)
    row = {"shape": name, "x": list(x.shape), "blocks": list(bl["src"].shape),
           "dtype": dtype_name, "max_abs_err": err, "kernel_ms": k_ms,
           "kernel_device_ms": k_dev, "call_us": k_call,
           "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_us": bound_s * 1e6, "bound_by": bound_by,
           "longest_row": longest_row(sa, bl_host, "")}
    log("shape " + json.dumps(row))
    record.append(row)
    return row


def part_split_cases(torch, sa, pg, bi, bb, rng, flush, record):
    """The row-range single-partition use of both segment kernels at
    products-s (see phase 3): returns the boundary half's forward and
    backward rows at D=64 and D=128."""
    from repro_torch.engine.stacking import partition_vjp_blocks

    n_int = pg.n_int.astype(np.int64)
    halves = {"interior": (bi, 0), "boundary": (bb, n_int)}
    part = {h: [partition_vjp_blocks(b, p) for p in range(4)]
            for h, (b, _) in halves.items()}
    p_big = int(np.argmax([(b["mask"] > 0).sum() for b in part["boundary"]]))
    fwd_rows, bwd_rows = {}, {}
    for d in (64, 128):
        x = rng.normal(0, 1, (4, pg.max_nodes, d)).astype(np.float32)
        gq = rng.normal(0, 1, (4, pg.own_cap, d)).astype(np.float32)
        xs = torch.as_tensor(x, device="cuda")
        gs = torch.as_tensor(gq, device="cuda")
        for half, (bh, rb) in halves.items():
            bh_dev = sa.blocks_to_device(bh, "cuda")
            rb_t = (torch.as_tensor(rb, device="cuda")
                    if isinstance(rb, np.ndarray) else rb)
            whole = sa.segment_mean_op(xs, bh_dev, num_rows=pg.own_cap,
                                       row_base=rb_t)
            whole_t = sa.segment_mean_bwd_op(gs, bh_dev, n_in=pg.max_nodes,
                                             row_base=rb_t)
            for p in range(4):
                one_blk = sa.blocks_to_device(part[half][p], "cuda")
                rbp = int(rb[p]) if isinstance(rb, np.ndarray) else rb
                one = sa.segment_mean_op(xs[p], one_blk, num_rows=pg.own_cap,
                                         row_base=rbp)
                one_t = sa.segment_mean_bwd_op(gs[p], one_blk,
                                               n_in=pg.max_nodes,
                                               row_base=rbp)
                assert torch.equal(one, whole[p]), (
                    f"partition {p}'s {half} launch differs from its rows "
                    f"of the stacked launch at D={d}")
                assert torch.equal(one_t, whole_t[p]), (
                    f"partition {p}'s {half} backward launch differs from "
                    f"its rows of the stacked launch at D={d}")
        log(f"products-s D={d}: each partition's row-range single-partition "
            f"launch of both halves, forward and backward, bitwise its rows "
            f"of the stacked launch; partition {p_big}'s boundary half "
            f"{part['boundary'][p_big]['src'].shape} at row_base "
            f"{int(n_int[p_big])}, plan "
            f"{json.dumps(plan_stats(sa, part['boundary'][p_big]))}")
        fwd_rows[d] = run_kernel_case(
            sa, f"products-s partition {p_big} split boundary D={d}",
            x[p_big], part["boundary"][p_big], pg.own_cap, int(n_int[p_big]),
            True, "float32", flush=flush, iters=30, record=record,
            repeat=True)
        bwd_rows[d] = run_bwd_case(
            sa, f"bwd products-s partition {p_big} split boundary D={d}",
            gq[p_big], part["boundary"][p_big], pg.max_nodes,
            int(n_int[p_big]), True, "float32", flush=flush, iters=30,
            record=record, repeat=True)
    return fwd_rows, bwd_rows


def stack_vjp_blocks(per_part, sa):
    """Pad per-partition build_vjp_blocks dicts to common shapes, with the
    kernels' work plans rebuilt over the padded arrays."""
    P = len(per_part)
    out = {}
    for k in ("src", "dst", "mask", "deg", "t_src", "t_dst", "t_mask"):
        shape = np.max([b[k].shape for b in per_part], axis=0)
        arr = np.full((P, *shape), 1 if k == "deg" else 0, per_part[0][k].dtype)
        for p, b in enumerate(per_part):
            arr[(p, *map(slice, b[k].shape))] = b[k]
        out[k] = arr
    for pre in ("", "t_"):
        out.update(sa.block_row_work(
            sa.block_row_ptr(out[pre + "dst"], out[pre + "mask"], sa.BN),
            prefix=pre))
    return out


def bwd_kernel_cases(sa):
    """(name, g numpy, vjp blocks numpy, n_in, row_base, mean, dtype)."""
    rng = np.random.default_rng(12)
    cases = []

    def edges(rows, n_in, max_deg, seed):
        r = np.random.default_rng(seed)
        deg = r.integers(0, max_deg + 1, rows)
        return r.integers(0, n_in, int(deg.sum())), np.repeat(np.arange(rows), deg)

    # tests/test_torch_segment_bwd.py's cases: (rows, n_in, deg, num_rows,
    # row_base, D)
    for name, rows, n_in, max_deg, num_rows, row_base, d in (
            ("sweep-64", 64, 64, 4, 64, 0, 24),
            ("sweep-200", 200, 200, 9, 200, 0, 24),
            ("sweep-300 d=130", 300, 300, 6, 300, 0, 130),
            ("row_base mixed", 159, 300, 5, 300, 141, 24),
            ("rows sliced off by num_rows", 200, 260, 6, 200, 37, 24),
            ("all-pad block", 0, 300, 5, 300, 300, 24),
            ("empty edge set", 50, 50, 0, 50, 0, 24)):
        src, dst = edges(rows, n_in, max_deg, rows + n_in)
        blk = sa.build_vjp_blocks(src, dst, rows, n_in)
        g = rng.normal(0, 1, (num_rows, d)).astype(np.float32)
        for mean in (True, False):
            cases.append((f"bwd {name} mean={mean}", g, blk, n_in, row_base,
                          mean, "float32"))
    # float64 dyadic: deg in {1, 2, 4, 8}, integer cotangents, exact sums
    n = 200
    for zero_frac, seed in ((0.25, 0), (0.9, 1)):
        r = np.random.default_rng(seed)
        deg = r.choice([1, 2, 4, 8], n)
        deg[r.random(n) < zero_frac] = 0
        dst = np.repeat(np.arange(n), deg)
        src = r.integers(0, n, int(deg.sum()))
        g = r.integers(-8, 9, (n, 16)).astype(np.float64)
        for mean in (True, False):
            cases.append((f"bwd f64 dyadic zero_frac={zero_frac} mean={mean}",
                          g, sa.build_vjp_blocks(src, dst, n, n), n, 0, mean,
                          "float64"))
    # stacked, per-partition row_base (one launch)
    P, n, d = 3, 260, 20
    bases = np.array([0, 37, 129])
    per = []
    for p in range(P):
        src, dst = edges(n - bases[p], n, 6, p)
        per.append(sa.build_vjp_blocks(src, dst, n - bases[p], n))
    cases.append(("bwd stacked P=3 per-partition row_base",
                  rng.normal(0, 1, (P, n, d)).astype(np.float32),
                  stack_vjp_blocks(per, sa), n, bases, True, "float32"))
    cases.append(clip_case(sa, "bwd stacked f64 dyadic rows past num_rows",
                           stack_vjp_blocks, "vjp"))
    # hub source rows split across warps: one source row of 5,000 out-edges
    # and rows of K, K+1 and 3K+5, among ragged ones; D=128, D=64 and
    # D=130, f32, bf16 and f64 dyadic (deg in {1, 2, 4, 8}, bitwise); rows
    # sliced off by num_rows with a row_base; the hub in one partition of a
    # stacked launch.
    # g is scaled by 1/sqrt(5,000) so the hub's sums are O(1): f32
    # reordering then moves a sum by ~1e-6, a dropped edge by ~1e-2
    k, g_scale = sa.ROW_WORK_K, 5_000 ** -0.5
    hubs = {7: 5_000, 11: k, 12: k + 1, 13: 3 * k + 5}

    def hub_src_edges(rows, n_in, seed, degs=(1, 2, 3, 4, 5, 6), hub=hubs):
        r = np.random.default_rng(seed)
        n_hub = sum(hub.values())
        deg = r.choice(degs, rows)
        deg[: -(-n_hub // 8)] = 8          # room for the hub edges
        dst = np.repeat(np.arange(rows), deg)
        src = r.integers(0, n_in, dst.size)
        src[np.isin(src, list(hub))] = 0
        pos = r.permutation(dst.size)[:n_hub]
        src[pos] = np.repeat(list(hub), list(hub.values()))
        return src, dst

    src, dst = hub_src_edges(2000, 2000, seed=31)
    blk = sa.build_vjp_blocks(src, dst, 2000, 2000)
    for d, dtype in ((128, "float32"), (64, "float32"), (130, "float32"),
                     (128, "bfloat16"), (130, "bfloat16")):
        for mean in (True, False):
            cases.append((f"bwd hub out-edges {sorted(hubs.values())} d={d} "
                          f"{dtype} mean={mean}",
                          rng.normal(0, g_scale, (2000, d)).astype(np.float32),
                          blk, 2000, 0, mean, dtype))
    src, dst = hub_src_edges(1500, 2000, seed=32)
    cases.append(("bwd hub rows sliced off by num_rows",
                  rng.normal(0, g_scale, (1500, 128)).astype(np.float32),
                  sa.build_vjp_blocks(src, dst, 1500, 2000), 2000, 37, True,
                  "float32"))
    src, dst = hub_src_edges(2000, 2000, seed=33, degs=(1, 2, 4, 8))
    for d in (64, 130):
        cases.append((f"bwd hub f64 dyadic d={d}",
                      np.random.default_rng(d).integers(-8, 9, (2000, d))
                      .astype(np.float64),
                      sa.build_vjp_blocks(src, dst, 2000, 2000), 2000, 0,
                      True, "float64"))
    P, n = 3, 1000
    per = []
    for p in range(P):
        src, dst = hub_src_edges(n - bases[p], n, seed=40 + p,
                                 hub=hubs if p == 2 else {3: 20})
        per.append(sa.build_vjp_blocks(src, dst, n - bases[p], n))
    cases.append(("bwd hub stacked P=3 per-partition row_base",
                  rng.normal(0, g_scale, (P, n, 128)).astype(np.float32),
                  stack_vjp_blocks(per, sa), n, bases, True, "float32"))
    return cases


def bwd_bound_of(g, bl_host, n_in, dtype_name):
    """Least time (s) of the backward and what bounds it, by
    ``kernels/work.py``'s formula: g read once, dx written once, the real
    transpose slots (t_src int64 + t_mask f32), the transpose work plan and
    deg; a divide per placed forward row and feature, a multiply and an add
    per real edge and feature."""
    flops, nbytes = work.segment_bwd_work(tuple(g.shape), g.element_size(),
                                          bl_host, n_in)
    t_b, t_o = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def run_bwd_case(sa, name, g_np, bl_host, n_in, row_base, mean, dtype_name,
                 flush, iters, record, *, repeat=False):
    """The backward kernel as run_kernel_case holds the forward, against
    torch.sparse.mm with the transposed mean matrix."""
    import torch

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    g = torch.as_tensor(g_np).to(device=dev, dtype=dtype)
    bl = sa.blocks_to_device(bl_host, dev)
    rb = (torch.as_tensor(row_base, device=dev)
          if isinstance(row_base, np.ndarray) else row_base)
    kw = dict(n_in=n_in, row_base=rb, mean=mean)
    got = sa.segment_mean_bwd_op(g, bl, **kw)
    torch.cuda.synchronize()
    want = sa.segment_mean_bwd_plain(g, bl, **kw)
    assert got.shape == want.shape and got.dtype == dtype, (name, got.shape)
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if dtype_name == "float64":
        assert torch.equal(got, want), f"{name}: f64 dyadic not bitwise ({err})"
    else:
        tol = TOL_BWD[dtype_name]
        assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol), \
            f"{name}: max |kernel - plain| = {err} above {tol}"
    assert torch.isfinite(got.float()).all(), name
    if repeat:
        again = sa.segment_mean_bwd_op(g, bl, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: two launches differ"
    call = lambda: sa.segment_mean_bwd_op(g, bl, **kw)
    k_ms = time_ms(call, iters, flush)
    k_dev = time_ms(call, iters, flush, hide_host=True)
    k_call = call_us(call)
    p_ms = time_ms(lambda: sa.segment_mean_bwd_plain(g, bl, **kw), iters, flush)
    lib_ms = None
    if dtype_name != "bfloat16":
        num_rows = g.shape[-2]
        a_t = library_matrix(bl_host, num_rows, row_base, n_in, mean, dtype,
                             dev, transpose=True)
        g2 = g.reshape(-1, g.shape[-1])
        lib_ms = time_ms(lambda: torch.sparse.mm(a_t, g2), iters, flush)
    bound_s, bound_by = bwd_bound_of(g, bl_host, n_in, dtype_name)
    row = {"shape": name, "g": list(g.shape), "t_blocks": list(bl["t_src"].shape),
           "dtype": dtype_name, "max_abs_err": err, "kernel_ms": k_ms,
           "kernel_device_ms": k_dev, "call_us": k_call,
           "plain_ms": p_ms, "library_ms": lib_ms,
           "bound_us": bound_s * 1e6, "bound_by": bound_by,
           "longest_t_row": longest_row(sa, bl_host, "t_")}
    log("shape " + json.dumps(row))
    record.append(row)
    return row


# b, hq, hkv, sq, sk, dh, causal, window, q_offset[, prefix_len]:
# tests/test_kernels.py's CASES, a fully masked row, then qwen2-0.5b's
# prefill and decode shapes, then starcoder2-7b's (GQA group 9, Dh 128): its
# prefill under the 4,096 window, and its rolling decode, the query at
# q_offset W - 1 against all 4,096 slots (any cache_len >= 4,095); then
# whisper-small's (batch 4, prompt 384, 64 new tokens: 452 slots, a decode
# step's query at 416) and paligemma-3b's (MQA, Dh 256; 256 patches + a
# 256-token prompt under the prefix-LM mask, 580 slots), and a small case
# whose window leaves a gap after the prefix
FLASH_CASES = [
    ("sweep GQA", (2, 4, 2, 128, 128, 64, True, None, 0)),
    ("sweep MHA ragged", (1, 8, 8, 200, 200, 32, True, None, 0)),
    ("sweep MQA", (1, 4, 1, 96, 96, 64, True, None, 0)),
    ("sweep window", (2, 4, 2, 256, 256, 64, True, 64, 0)),
    ("sweep decode ragged kv", (1, 4, 2, 1, 300, 64, True, None, 300)),
    ("sweep bidirectional", (1, 2, 2, 64, 64, 128, False, None, 0)),
    ("fully masked row", (1, 2, 1, 4, 16, 64, True, 8, 40)),
    ("qwen2-0.5b prefill", (4, 14, 2, 2048, 2048, 64, True, None, 0)),
    ("qwen2-0.5b decode", (4, 14, 2, 1, 2116, 64, True, None, 2048)),
    ("starcoder2-7b prefill", (4, 36, 4, 4608, 4608, 128, True, 4096, 0)),
    ("starcoder2-7b rolling decode", (4, 36, 4, 1, 4096, 128, True, None,
                                      4095)),
    ("whisper-small encoder self", (4, 12, 12, 1500, 1500, 64, False, None,
                                    0)),
    ("whisper-small decoder prefill", (4, 12, 12, 384, 384, 64, True, None,
                                       0)),
    ("whisper-small cross prefill", (4, 12, 12, 384, 1500, 64, False, None,
                                     0)),
    ("whisper-small self decode", (4, 12, 12, 1, 452, 64, True, None, 416)),
    ("whisper-small cross decode", (4, 12, 12, 1, 1500, 64, False, None, 0)),
    ("paligemma-3b prefill", (4, 8, 1, 512, 512, 256, True, None, 0, 256)),
    ("paligemma-3b decode", (4, 8, 1, 1, 580, 256, True, None, 540)),
    ("window + prefix", (1, 4, 2, 300, 300, 64, True, 64, 0, 100)),
]
# the serving paths' shapes: held to BF16_MAIN_* in bf16, launched twice
MAIN_FLASH_CASES = ("qwen2", "starcoder2", "whisper", "paligemma",
                    "window + prefix")
# the last two are qwen2-0.5b's prefill and decode rows
RMS_SHAPES = [(4, 128), (3, 7, 512), (2, 5, 33, 256), (4, 2048, 896),
              (4, 1, 896)]
RMS_MAIN_SHAPES = RMS_SHAPES[-2:]
# the training path: tests/test_kernels.py's flash cases and the fully
# masked row through the forward with the log-sum-exp and the backward,
# window 0 (no row sees a key), the tensor-core backward's work split (a
# GQA group of 7 on one KV head, Dh 128 with a window, Sq = 65 at a
# q_offset) and qwen2-0.5b's training shape (batch 8 x seq 512); RMSNorm's
# backward at three shapes, one row, the vector path's widest bf16 row, the
# widest row, and qwen2-0.5b's training rows (8, 512, 896)
FLASH_TRAIN_CASES = FLASH_CASES[:7] + [
    ("window 0", (1, 4, 2, 70, 70, 64, True, 0, 0)),
    ("group 7 one kv head", (1, 7, 1, 130, 130, 64, True, None, 0)),
    ("dh 128 window", (1, 4, 2, 200, 200, 128, True, 48, 0)),
    ("sq 65 q_offset", (1, 6, 2, 65, 200, 128, True, None, 135)),
    ("qwen2-0.5b train", (8, 14, 2, 512, 512, 64, True, None, 0)),
    # the prefix-LM mask and Dh 256 (ROADMAP 15.10; a tenth entry is the
    # prefix): a prefix edge inside a key tile at Dh 64, a window leaving a
    # gap after it; Dh 256 at group 8 with the Sq and Sk tails, with and
    # without a prefix; then the training shapes of paligemma-3b (q 4 x 8 x
    # 768 x 256 against one KV head, prefix 256) and whisper-small (the
    # encoder's 8 x 12 x 1,500^2, the decoder's causal 448, the
    # cross-attention's 448 over 1,500)
    ("prefix 37", (1, 4, 2, 200, 200, 64, True, None, 0, 37)),
    ("window + prefix gap", (1, 4, 1, 300, 300, 64, True, 64, 0, 100)),
    ("dh 256 group 8 tails", (1, 8, 1, 130, 190, 256, True, None, 60)),
    ("dh 256 group 8 prefix", (1, 8, 1, 300, 300, 256, True, None, 0, 100)),
    ("paligemma-3b train", (4, 8, 1, 768, 768, 256, True, None, 0, 256)),
    ("whisper-small encoder train", (8, 12, 12, 1500, 1500, 64, False, None,
                                     0)),
    ("whisper-small decoder train", (8, 12, 12, 448, 448, 64, True, None,
                                     0)),
    ("whisper-small cross train", (8, 12, 12, 448, 1500, 64, False, None,
                                   0)),
]
# the training shapes timed beside their bounds, the plain versions and
# scaled_dot_product_attention's backward
FLASH_TRAIN_MAIN = ("qwen2-0.5b train", "paligemma-3b train",
                    "whisper-small encoder train",
                    "whisper-small decoder train",
                    "whisper-small cross train")
RMS_TRAIN_MAIN = (8, 512, 896)
RMS_TRAIN_SHAPES = [(4, 128), (3, 7, 512), (2, 5, 33, 256), (1, 896),
                    (3, 2048), (2, 8192), RMS_TRAIN_MAIN]


def run_flash_case(fa, name, case, dtype_name, flush, iters, record, *,
                   main_path=False):
    """The flash kernel against its plain version on the card, its time,
    the plain version's, one scaled_dot_product_attention call's
    (yardstick) and the bound; ``main_path`` shapes are held to
    ``BF16_MAIN_*`` in bf16."""
    import torch
    import torch.nn.functional as F

    b, hq, hkv, sq, sk, dh, causal, window, q_off, *prefix = case
    prefix = prefix[0] if prefix else 0
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + dh)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
               for shape in ((b, hq, sq, dh), (b, hkv, sk, dh),
                             (b, hkv, sk, dh)))
    kw = dict(causal=causal, window=window, q_offset=q_off)
    if prefix:
        kw["prefix_len"] = prefix
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == dtype, (name, got.shape)
    err = float((got.float() - want.float()).abs().max())
    atol = rtol = FLASH_TOL[dtype_name]
    if main_path and dtype_name == "bfloat16":
        atol, rtol = BF16_MAIN_ATOL, BF16_MAIN_RTOL
    assert torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol), \
        (f"flash {name} {dtype_name}: max |kernel - plain| = {err} above "
         f"atol {atol} rtol {rtol}")
    if main_path:
        again = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again), \
            f"flash {name} {dtype_name}: two launches differ"
    live = work.flash_live_mask(sq, sk, causal, window, q_off, prefix)
    if not live.any(axis=1).all():
        dead = torch.as_tensor(~live.any(axis=1), device="cuda")
        assert not got[:, :, dead].float().abs().any(), "masked row not 0"
    p = fa.plan(q.shape, k.shape, causal=causal, window=window,
                q_offset=q_off, prefix_len=prefix,
                sms=torch.cuda.get_device_properties(0).multi_processor_count)
    # decode: the split grid, then the merge's (one block per query row)
    grids = ([[b * hkv, p.n_split], [b * hkv, hq // hkv]]
             if p.design == "decode" else None)
    call = lambda: fa.flash_attention(q, k, v, **kw)
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
    k_ms, p_ms = time_ms(call, iters, flush), time_ms(plain, iters, flush)
    k_dev, p_dev = (time_ms(call, iters, flush, hide_host=True),
                    time_ms(plain, iters, flush, hide_host=True))
    k_call = call_us(call)
    if causal and window is None and q_off == 0 and sq == sk and not prefix:
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                     enable_gqa=True)
    elif live.all():
        lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                     enable_gqa=True)
    else:
        mask = torch.as_tensor(live, device="cuda")
        lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                     enable_gqa=True)
    lib_ms = time_ms(lib, iters, flush)
    lib_dev = time_ms(lib, iters, flush, hide_host=True)
    # the K/V rows of keys some query may see: the kernel never loads the
    # others (decode's dead cache tail); kernels/work.py's formula
    flops, nbytes = work.flash_fwd_work(tuple(q.shape), tuple(k.shape),
                                        q.element_size(), **kw)
    t_o, t_b = flops / ATTN_PEAK_FLOPS[dtype_name], nbytes / HBM_BYTES_S
    # the share of the bound the device reached: TFLOP/s over the type's
    # peak where operations bound the call, bytes/s over HBM's rate where
    # bytes do
    k_s = k_dev * 1e-3
    row = {"kernel": "flash_attention", "shape": name, "q": list(q.shape),
           "kv": list(k.shape), "causal": causal, "window": window,
           "q_offset": q_off, "prefix_len": prefix, "dtype": dtype_name,
           "design": p.design,
           "grids": grids, "max_abs_err": err,
           "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
           "kernel_device_ms": k_dev, "plain_device_ms": p_dev,
           "library_device_ms": lib_dev, "call_us": k_call,
           "bound_us": max(t_o, t_b) * 1e6,
           "bound_by": "operations" if t_o >= t_b else "bytes",
           "flops": flops, "bytes": nbytes,
           "tflops": flops / k_s / 1e12,
           "flops_share": flops / k_s / ATTN_PEAK_FLOPS[dtype_name],
           "tbps": nbytes / k_s / 1e12,
           "bytes_share": nbytes / k_s / HBM_BYTES_S}
    log("shape " + json.dumps(row))
    record.append(row)
    return row


def run_rmsnorm_case(rn, shape, dtype_name, flush, iters, record, *,
                     fused=False, main_path=False):
    """One RMSNorm entry point against its plain version on the card:
    ``rmsnorm`` or, ``fused``, ``add_rmsnorm`` (its sum s bitwise torch's
    ``x + delta``); launched twice, bitwise equal; its times, the plain
    version's, the library's (one ``rms_norm`` call; for the fused one the
    two calls ``x + delta`` then ``rms_norm``, as no one call computes it)
    and torch's add alone, and the bound.  ``main_path`` shapes are held to
    ``BF16_MAIN_*`` in bf16."""
    import torch
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(shape[-1])
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    w = torch.randn(shape[-1], device="cuda", generator=gen)
    delta = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    name = "add_rmsnorm" if fused else "rmsnorm"
    if fused:
        call = lambda: rn.add_rmsnorm(x, delta, w)
        plain = lambda: rn.add_rmsnorm_plain(x, delta, w)
    else:
        call = lambda: rn.rmsnorm(x, w)
        plain = lambda: rn.rmsnorm_plain(x, w)
    got, again = call(), call()
    torch.cuda.synchronize()
    want = plain()
    if fused:
        assert torch.equal(got[0], x + delta), \
            f"{name} {shape} {dtype_name}: s is not torch's x + delta"
        assert torch.equal(got[0], again[0]), f"{name}: two launches differ"
        got, again, want = got[1], again[1], want[1]
    assert torch.equal(got, again), \
        f"{name} {shape} {dtype_name}: two launches differ"
    assert got.shape == want.shape and got.dtype == dtype, shape
    err = float((got.float() - want.float()).abs().max())
    atol = rtol = RMS_TOL[dtype_name]
    if main_path and dtype_name == "bfloat16":
        atol, rtol = BF16_MAIN_ATOL, BF16_MAIN_RTOL
    assert torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol), \
        (f"{name} {shape} {dtype_name}: max |kernel - plain| = {err} above "
         f"atol {atol} rtol {rtol}")
    k_ms = time_ms(call, iters, flush)
    k_dev = time_ms(call, iters, flush, hide_host=True)
    k_call = call_us(call)
    p_ms = time_ms(plain, iters, flush)
    w_lib = w.to(dtype)
    if fused:
        lib = lambda: F.rms_norm(x + delta, (shape[-1],), w_lib, 1e-6)
    else:
        lib = lambda: F.rms_norm(x, (shape[-1],), w_lib, 1e-6)
    lib_ms = time_ms(lib, iters, flush)
    lib_dev = time_ms(lib, iters, flush, hide_host=True)
    add_dev = time_ms(lambda: x + delta, iters, flush, hide_host=True)
    # each input read once, each output written once: x (and delta) in, y
    # (and s) out, w; a square, a sum and two products per element (and the
    # add): kernels/work.py's formula
    flops, nbytes = work.rmsnorm_work(x.numel(), shape[-1], x.element_size(),
                                      fused=fused)
    t_b, t_o = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS["float32"]
    bound = max(t_b, t_o)
    row = {"kernel": name, "shape": list(shape), "dtype": dtype_name,
           "max_abs_err": err, "kernel_ms": k_ms, "kernel_device_ms": k_dev,
           "call_us": k_call, "plain_ms": p_ms,
           "library": ("x + delta, then F.rms_norm (two calls)" if fused
                       else "F.rms_norm"),
           "library_ms": lib_ms, "library_device_ms": lib_dev,
           "torch_add_device_ms": add_dev, "bound_us": bound * 1e6,
           "bound_by": "bytes" if t_b >= t_o else "operations",
           "device_share": bound * 1e3 / k_dev}
    log("shape " + json.dumps(row))
    record.append(row)
    return row


def kernels_per_call(fn):
    """The kernels one call of ``fn`` runs on the card and each one's
    device µs, by torch.profiler (after a warm call): ``(count, {name:
    µs})``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hit = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    us = {}
    for e in hit:
        name = e.name.replace("void ", "").replace("(anonymous namespace)::",
                                                   "")
        name = name.split("(")[0].split("::")[-1][:48]
        us[name] = us.get(name, 0.0) + e.device_time_total
    return len(hit), us


def timed_row(fn, plain, lib, iters, flush):
    """The kernel's, the plain version's and the library call's times
    (enqueue and device alone) and the kernel's ``call_us``."""
    return {"kernel_ms": time_ms(fn, iters, flush),
            "kernel_device_ms": time_ms(fn, iters, flush, hide_host=True),
            "call_us": call_us(fn),
            "plain_ms": time_ms(plain, iters, flush),
            "plain_device_ms": time_ms(plain, iters, flush, hide_host=True),
            "library_ms": time_ms(lib, iters, flush),
            "library_device_ms": time_ms(lib, iters, flush, hide_host=True)}


def with_bound(row, flops, nbytes, peak):
    t_o, t_b = flops / peak, nbytes / HBM_BYTES_S
    row.update(flops=flops, bytes=nbytes, bound_us=max(t_o, t_b) * 1e6,
               bound_by="operations" if t_o >= t_b else "bytes")
    if "kernel_device_ms" in row:
        row["device_share"] = max(t_o, t_b) * 1e3 / row["kernel_device_ms"]
    return row


def run_flash_train_case(fa, name, case, dtype_name, flush, iters, record, *,
                         main_path=False):
    """The training path's two flash launches on the card: the forward
    with the log-sum-exp (launched twice, bitwise equal; its output
    bitwise serving's prefill, its LSE
    against ``torch.logsumexp``, -inf for a row with no key) and the
    backward (dq, dk, dv against autograd of the plain version, in bf16
    also within ``FLASH_BWD_TOP_RTOL`` of each one's largest entry,
    launched twice, bitwise equal, no NaN, zero dq on rows with no key); on
    the main path's shapes their device times beside the bounds, and in
    bf16 beside the plain versions' and one
    ``scaled_dot_product_attention`` call's (``is_causal`` where the mask
    is causal alone, else a boolean mask of the live pairs; ``enable_gqa``;
    its backward through autograd).  A case's optional
    tenth entry is its prefix.  Returns ``(forward row, backward row)``."""
    import torch
    import torch.nn.functional as F

    b, hq, hkv, sq, sk, dh, causal, window, q_off, *pre = case
    prefix = pre[0] if pre else 0
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + dh)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for shape in ((b, hq, sq, dh), (b, hkv, sk, dh),
                                 (b, hkv, sk, dh), (b, hq, sq, dh)))
    kw = dict(causal=causal, window=window, q_offset=q_off,
              prefix_len=prefix)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    o2, lse2 = fa.flash_attention_lse(q, k, v, **kw)
    serve = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), \
        f"flash train {name} {dtype_name}: two launches differ"
    design = fa.plan(q.shape, k.shape, causal=causal, window=window,
                     q_offset=q_off, sms=torch.cuda.get_device_properties(
                         0).multi_processor_count, prefix_len=prefix).design
    if design == "prefill":
        assert torch.equal(o, serve), \
            f"flash train {name} {dtype_name}: output is not serving's"
    live = work.flash_live_mask(sq, sk, causal, window, q_off, prefix)
    live_t = torch.as_tensor(live, device="cuda")
    dead = ~live_t.any(1)
    kx = k.repeat_interleave(hq // hkv, 1).float()
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / dh ** 0.5
    want_lse = torch.logsumexp(scores.masked_fill(~live_t, float("-inf")),
                               -1)
    assert torch.isneginf(lse[:, :, dead]).all(), f"{name}: dead row's LSE"
    lse_err = float((lse[:, :, ~dead] - want_lse[:, :, ~dead]).abs().max()) \
        if (~dead).any() else 0.0
    torch.testing.assert_close(lse[:, :, ~dead], want_lse[:, :, ~dead],
                               atol=LSE_ATOL, rtol=LSE_RTOL)
    fwd_err = float((o.float() - fa.flash_attention_plain(
        q, k, v, **kw).float()).abs().max())
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(grads, again)), \
        f"flash bwd {name} {dtype_name}: two launches differ"
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out_p = fa.flash_attention_plain(*leaves, **kw)
    want = torch.autograd.grad(out_p, leaves, do, retain_graph=True)
    tol = FLASH_BWD_TOL[dtype_name]
    errs, tops = {}, {}
    for label, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == dtype and torch.isfinite(g).all(), (name, label)
        errs[label] = float((g.float() - w.float()).abs().max())
        tops[label] = float(w.float().abs().max())
        if dtype_name == "bfloat16":
            assert errs[label] <= FLASH_BWD_TOP_RTOL * tops[label], \
                (f"flash bwd {name} {dtype_name} {label}: max |kernel - "
                 f"plain| = {errs[label]} above {FLASH_BWD_TOP_RTOL} of the "
                 f"largest plain entry {tops[label]}")
        assert torch.allclose(g.float(), w.float(), atol=tol, rtol=tol), \
            (f"flash bwd {name} {dtype_name} {label}: max |kernel - plain| "
             f"= {errs[label]} above atol {tol} rtol {tol}")
    assert not grads[0][:, :, dead].float().abs().any(), "dead row's dq"
    fwd = {"kernel": "flash_attention_train", "shape": name,
           "q": list(q.shape), "kv": list(k.shape), "dtype": dtype_name,
           "window": window, "prefix_len": prefix, "max_abs_err": fwd_err,
           "lse_max_abs_err": lse_err}
    bwd = {"kernel": "flash_attention_bwd", "shape": name,
           "q": list(q.shape), "kv": list(k.shape), "dtype": dtype_name,
           "window": window, "prefix_len": prefix,
           "max_abs_err": max(errs.values()), **errs,
           "max_plain": tops,
           "err_over_max_plain": {k: errs[k] / tops[k] if tops[k] else 0.0
                                  for k in errs}}
    if main_path:
        assert window is None and q_off == 0
        # the library's call: is_causal where the mask is the causal one
        # alone, else the boolean mask of the live pairs
        sdpa = (dict(is_causal=True) if causal and not prefix and sq == sk
                else dict(attn_mask=live_t) if causal or prefix else {})
        lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out_l = F.scaled_dot_product_attention(*lib_leaves, **sdpa,
                                               enable_gqa=True)
        # the library's own error against the same plain reference, from
        # the same inputs: the kernel is no less exact than it where its
        # max_abs_err is no larger
        lib_grads = torch.autograd.grad(out_l, lib_leaves, do,
                                        retain_graph=True)
        bwd["library_max_abs_err"] = max(
            float((g.float() - w.float()).abs().max())
            for g, w in zip(lib_grads, want))
        bwd["kernels_per_call"], bwd["profiled_us"] = kernels_per_call(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw))
        bwd["scratch_bytes"] = 2 * 4 * fa.bwd_part_elems(q.shape, k.shape,
                                                         dtype)
        fwd_call = lambda: fa.flash_attention_lse(q, k, v, **kw)
        bwd_call = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        if dtype_name == "bfloat16":
            fwd.update(timed_row(
                fwd_call, lambda: fa.flash_attention_plain(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(q, k, v, **sdpa,
                                                       enable_gqa=True),
                iters, flush))
            bwd.update(timed_row(
                bwd_call,
                lambda: torch.autograd.grad(out_p, leaves, do,
                                            retain_graph=True),
                lambda: torch.autograd.grad(out_l, lib_leaves, do,
                                            retain_graph=True),
                iters, flush))
        else:
            # f32: the kernels' device times alone; the plain versions'
            # and the library's f32 times at these shapes are the costliest
            # timings of the phase and feed no line the run prints last
            fwd["kernel_device_ms"] = time_ms(fwd_call, iters, flush,
                                              hide_host=True)
            bwd["kernel_device_ms"] = time_ms(bwd_call, iters, flush,
                                              hide_host=True)
        # forward: q, the live K/V rows in, o and the LSE out; 4 Dh FLOPs a
        # live pair.  Backward: q, o, dO, the LSE and the live K/V rows in,
        # dq, dk, dv out; 10 Dh FLOPs a live pair (S, dP, dV, dK, dQ):
        # kernels/work.py's formulas
        shapes = (tuple(q.shape), tuple(k.shape), q.element_size())
        with_bound(fwd, *work.flash_fwd_work(*shapes, lse=True, **kw),
                   ATTN_PEAK_FLOPS[dtype_name])
        with_bound(bwd, *work.flash_bwd_work(*shapes, **kw),
                   ATTN_PEAK_FLOPS[dtype_name])
    for row in (fwd, bwd):
        log("shape " + json.dumps(row))
        record.append(row)
    return fwd, bwd


def run_rmsnorm_bwd_case(rn, shape, dtype_name, flush, iters, record, *,
                         fused=False, main_path=False):
    """The RMSNorm backward on the card for one entry point: ``(ds, dw)``
    against autograd of the plain version (for the fused one, with the
    residual's own gradient ``ds_in``: the gradient of x and of delta),
    launched twice, bitwise equal; on the main path's rows its times beside
    the plain version's and the library's (autograd of one ``rms_norm``
    call; for the fused one of ``x + delta``, then ``rms_norm``) and the
    bound."""
    import torch
    import torch.nn.functional as F

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(shape[-1] + 1)
    x, delta, dy, ds_in = (torch.randn(shape, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
    w = torch.randn(shape[-1], device="cuda", generator=gen)
    s = x + delta if fused else x
    extra = ds_in if fused else None
    got = rn.rmsnorm_bwd(s, dy, w, extra)
    again = rn.rmsnorm_bwd(s, dy, w, extra)
    torch.cuda.synchronize()
    name = "add_rmsnorm_bwd" if fused else "rmsnorm_bwd"
    assert all(torch.equal(a, c) for a, c in zip(got, again)), \
        f"{name} {shape} {dtype_name}: two launches differ"
    leaves = [t.detach().clone().requires_grad_() for t in (x, delta, w)]
    if fused:
        outs = rn.add_rmsnorm_plain(*leaves)
        want = torch.autograd.grad(outs, leaves, (ds_in, dy),
                                   retain_graph=True)
        pairs = [(got[0], want[0]), (got[0], want[1]), (got[1], want[2])]
        plain = lambda: torch.autograd.grad(outs, leaves, (ds_in, dy),
                                            retain_graph=True)
    else:
        outs = rn.rmsnorm_plain(leaves[0], leaves[2])
        want = torch.autograd.grad(outs, [leaves[0], leaves[2]], dy,
                                   retain_graph=True)
        pairs = [(got[0], want[0]), (got[1], want[1])]
        plain = lambda: torch.autograd.grad(outs, [leaves[0], leaves[2]], dy,
                                            retain_graph=True)
    tol = RMS_BWD_TOL[dtype_name]
    err = 0.0
    for g, wt in pairs:
        scale = float(wt.float().abs().max())
        err = max(err, float((g.float() - wt.float()).abs().max()))
        assert torch.allclose(g.float(), wt.float(), atol=tol * scale,
                              rtol=tol), \
            (f"{name} {shape} {dtype_name}: max |kernel - plain| {err} above "
             f"atol {tol} x {scale} rtol {tol}")
    row = {"kernel": name, "shape": list(shape), "dtype": dtype_name,
           "max_abs_err": err}
    if main_path:
        lib_leaves = [t.detach().clone().requires_grad_()
                      for t in (x, delta, w.to(dtype))]
        lx = lib_leaves[0] + lib_leaves[1] if fused else lib_leaves[0]
        y_l = F.rms_norm(lx, (shape[-1],), lib_leaves[2], 1e-6)
        lib_in = lib_leaves if fused else [lib_leaves[0], lib_leaves[2]]
        row.update(timed_row(
            lambda: rn.rmsnorm_bwd(s, dy, w, extra), plain,
            lambda: torch.autograd.grad(y_l, lib_in, dy, retain_graph=True),
            iters, flush))
        row["library"] = ("autograd of x + delta, then F.rms_norm" if fused
                          else "autograd of F.rms_norm")
        row["kernels_per_call"], row["profiled_us"] = kernels_per_call(
            lambda: rn.rmsnorm_bwd(s, dy, w, extra))
        # s, dy (and ds_in) and w in, ds and dw out; about ten flops an
        # element: kernels/work.py's formula
        with_bound(row, *work.rmsnorm_bwd_work(
            x.numel(), shape[-1], x.element_size(), fused=fused),
            PEAK_FLOPS["float32"])
    log("shape " + json.dumps(row))
    record.append(row)
    return row


# --------------------------------------------------------------------------
# phase 4 helpers
# --------------------------------------------------------------------------

def pick_edge_edits(g, parts, srv):
    """A cross-partition addition whose source the destination's partition
    has never seen (halo growth), a same-partition addition, a removal."""
    adds = []
    for v in range(g.num_nodes):
        p = parts[v]
        nb = set(map(int, g.neighbors(v)))
        u = next((u for u in range(g.num_nodes)
                  if u != v and parts[u] != p and u not in srv.g2l[p]
                  and u not in nb), None)
        if u is not None:
            adds.append((u, v))
            break
    for v in range(1, g.num_nodes):
        p = parts[v]
        nb = set(map(int, g.neighbors(v)))
        u = next((u for u in range(g.num_nodes)
                  if u != v and parts[u] == p and u not in nb), None)
        if u is not None and (u, v) not in adds:
            adds.append((u, v))
            break
    v0 = next(v for v in range(g.num_nodes) if len(g.neighbors(v)) > 1)
    rems = [(int(g.neighbors(v0)[0]), int(v0))]
    return adds, rems


def rows_subset_bitwise(torch, m_full, d_in, d_out, sizes):
    """Does cuBLAS give a row subset of A @ W bitwise equal to the same
    rows of the full product?  (The reference's bitwise incremental
    serving relies on that property of its backend.)"""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m_full, d_in, device="cuda", generator=gen)
    w = torch.randn(d_in, d_out, device="cuda", generator=gen)
    full = a @ w
    out = {}
    for m in sizes:
        idx = torch.randperm(m_full, device="cuda", generator=gen)[:m]
        sub = a[idx] @ w
        out[m] = {"bitwise": bool(torch.equal(sub, full[idx])),
                  "max_abs": float((sub - full[idx]).abs().max())}
    return out


def profile_ticks(torch, srv, g, n_ticks, seed):
    """Where a serving tick's time goes: the host
    functions by cumulative time (cProfile, which inflates Python-heavy
    code), then the device's busy share and top kernels (torch.profiler)
    over the same kind of ticks."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)

    def tick():
        for v in rng.choice(g.num_nodes, 4, replace=False):
            srv.update_features(int(v), rng.normal(0, 1, g.feature_dim)
                                .astype(np.float32))
        srv.submit(rng.choice(g.num_nodes, 16, replace=False))
        srv.tick()
        torch.cuda.synchronize()

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(n_ticks):
        tick()
    prof.disable()
    log(f"profile: {n_ticks} ticks under cProfile, "
        f"{(time.perf_counter() - t0) / n_ticks * 1e3:.1f} ms/tick")
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(
        "repro_torch", 25)
    for line in buf.getvalue().splitlines():
        if "repro_torch" in line or "cumtime" in line:
            log("cprofile " + line.rstrip())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            tick()
        wall = time.perf_counter() - t0
    cuda = [e for e in tp.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in cuda)
    log(f"profile: {n_ticks} ticks under torch.profiler, wall "
        f"{wall / n_ticks * 1e3:.1f} ms/tick, device busy "
        f"{busy_us / n_ticks / 1e3:.2f} ms/tick = "
        f"{busy_us / 1e6 / wall:.3f} of wall")
    for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile kernel {e.self_device_time_total / n_ticks:9.1f} "
            f"us/tick x{e.count / n_ticks:5.1f}  {e.key[:90]}")


# --------------------------------------------------------------------------
# phase 5 helpers
# --------------------------------------------------------------------------

def train_args(*extra):
    """``launch.train gnn`` at the main path's widths in this process: the
    stacked engine unless ``extra`` names one (``auto`` would spawn the
    partition mesh on a host with a card per partition)."""
    from repro_torch.launch.train import build_parser

    engine = [] if "--engine" in extra else ["--engine", "stacked"]
    return build_parser().parse_args(
        ["gnn", "--dataset", "products-s", "--parts", "4", "--hidden", "128",
         "--seed", "0", "--device", "cuda", *engine, *extra])


def train_run(torch, sa, label, *extra, halves=1, per_eval=None):
    """One ``launch.train gnn`` run with the launch counts set to 0 just
    before it and read just after; checks that every evaluation launched
    the forward kernel once a layer and half (``halves`` 2 for the
    overlapped split forward: interior and boundary), or ``per_eval`` times
    (the streamed eval: once a layer and partition), and every full-graph
    step the backward kernel once a half of layer 1 (layer 0 reads the
    features, which need no gradient) and its forward as an eval does."""
    from repro_torch.launch.train import run_gnn

    sa.reset_kernel_launch_count()
    t0 = time.perf_counter()
    res = run_gnn(train_args(*extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = sa.kernel_launch_count(), sa.bwd_kernel_launch_count()
    fg_steps = (sum(res.phase0_iter_history) if res.config.full_graph_train
                else 0)
    evals = res.epochs_run + 1              # one per epoch, and the test
    per_eval = 2 * halves if per_eval is None else per_eval
    assert fwd == per_eval * evals + 2 * halves * fg_steps, (
        label, fwd, evals, fg_steps)
    assert bwd == halves * fg_steps, (label, bwd, fg_steps)
    losses = np.asarray(res.loss_history)
    assert losses.size == res.epochs_run and np.isfinite(losses).all(), label
    n0 = len(res.phase0_iter_history)
    if fg_steps:
        assert losses[n0 - 1] < losses[0], (label, losses[:n0])
    s = res.summary()
    log(f"train {label}: wall {wall:.1f} s, epochs {res.epochs_run} "
        f"(phase 0: {n0}, iters {res.phase0_iter_history}), epoch "
        f"{res.epoch_time_s * 1e3:.2f} ms, with eval "
        f"{res.epoch_time_with_eval_s * 1e3:.2f} ms, train "
        f"{res.train_time_s:.3f} s, micro-F1 {res.f1.micro:.4f}, macro-F1 "
        f"{res.f1.macro:.4f}, losses {np.round(losses, 4).tolist()}, "
        f"launches fwd {fwd} bwd {bwd}, comm_grad_mb {s['comm_grad_mb']}, "
        f"comm_halo_mb {s['comm_halo_mb']}")
    return res, fwd, bwd


class EpochClock:
    """While active, records each ``SPMDEngine`` epoch call's host-clock
    time (synchronised before and after, so steps and eval) and, for the
    host path's calls, the bytes of the batches the call was handed."""

    METHODS = ("phase0_epoch", "phase1_epoch", "phase0_epoch_async",
               "phase1_epoch_async")

    def __init__(self, torch):
        self.torch = torch
        self.ms = {m: [] for m in self.METHODS}
        self.batch_bytes = {m: [] for m in self.METHODS[:2]}

    def __enter__(self):
        from repro_torch.engine import SPMDEngine

        self._orig = {m: getattr(SPMDEngine, m) for m in self.METHODS}
        for name, fn in self._orig.items():
            def timed(eng, *args, _fn=fn, _name=name, **kw):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(eng, *args, **kw)
                self.torch.cuda.synchronize()
                self.ms[_name].append((time.perf_counter() - t0) * 1e3)
                if _name in self.batch_bytes:
                    self.batch_bytes[_name].append(sum(
                        v.numel() * v.element_size()
                        for v in args[2].values()))
                return out
            setattr(SPMDEngine, name, timed)
        return self

    def __exit__(self, *exc):
        from repro_torch.engine import SPMDEngine

        for name, fn in self._orig.items():
            setattr(SPMDEngine, name, fn)

    def median(self, name):
        v = self.ms[name]
        return round(float(np.median(v)), 3) if v else None


def async_vs_host(res_s, clock_s, res_a, clock_a, staged):
    """The async run beside the host-path sampled run of the same call."""
    n0a, n1a = len(res_a.phase0_iter_history), res_a.phase1_epochs
    row = {
        "phase0_epoch_ms": {"host": clock_s.median("phase0_epoch"),
                            "async": clock_a.median("phase0_epoch_async")},
        "phase1_epoch_ms": {"host": clock_s.median("phase1_epoch"),
                            "async": clock_a.median("phase1_epoch_async")},
        "phase0_epoch_ms_all": {"host": clock_s.ms["phase0_epoch"],
                                "async": clock_a.ms["phase0_epoch_async"]},
        "phase1_epoch_ms_all": {"host": clock_s.ms["phase1_epoch"],
                                "async": clock_a.ms["phase1_epoch_async"]},
        "h2d_bytes_per_epoch": {
            "host_phase0": clock_s.batch_bytes["phase0_epoch"],
            "host_phase1": clock_s.batch_bytes["phase1_epoch"],
            "async_phase0": (res_a.host_to_device_bytes_phase0 - staged)
            / max(1, n0a),
            "async_phase1": res_a.host_to_device_bytes_phase1 / max(1, n1a),
            "async_sampler_staging_once": staged},
        "epoch_time_with_eval_s": {"host": res_s.epoch_time_with_eval_s,
                                   "async": res_a.epoch_time_with_eval_s},
        "phase1_time_s": {"host": res_s.phase1_time_s,
                          "async": res_a.phase1_time_s},
        "micro_f1": {"host": res_s.f1.micro, "async": res_a.f1.micro},
        "epochs": {"host": [len(res_s.phase0_iter_history),
                            res_s.phase1_epochs], "async": [n0a, n1a]},
    }
    log(f"async vs host sampling (epoch calls: steps + eval, host clock, "
        f"synchronised; medians and every epoch): {json.dumps(row)}")


def profile_epoch(torch, label, fn):
    """One call of ``fn`` under torch.profiler: kernel launches, device
    busy, the top kernels, and the copies: host-to-device copies counted
    by ``key_averages`` and, from the chrome trace (whose copy events
    carry their size), every copy or fill by name with its count and
    bytes."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        tp.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and any(
        c in str(e.get("cat", "")).lower()
        for c in ("kernel", "memcpy", "memset"))]
    kernels = [e for e in dev if "kernel" in str(e["cat"]).lower()]
    copies = {}
    for e in dev:
        if "kernel" in str(e["cat"]).lower():
            continue
        n, b = copies.get(e.get("name"), (0, 0))
        copies[e.get("name")] = (n + 1, b + int(e.get("args", {}).get(
            "bytes", 0)))
    h2d = sum(e.count for e in tp.key_averages()
              if e.key.startswith("Memcpy HtoD"))
    busy_us = sum(float(e.get("dur", 0)) for e in dev)
    log(f"profile {label}: wall {wall * 1e3:.3f} ms, kernel launches "
        f"{len(kernels)}, device busy {busy_us / 1e3:.3f} ms = "
        f"{busy_us / 1e6 / wall:.3f} of wall, HtoD copies {h2d} "
        f"(key_averages); copies and fills in the trace (count, bytes) "
        f"{json.dumps(copies)}")
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + float(e.get("dur", 0)), n + 1)
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"profile {label} kernel {t:9.1f} us x{n:4d}  {name[:90]}")


def async_epoch_profiles(torch):
    """One async epoch of each phase at the main path's widths (the
    pipeline's partition: EW, P=4, seed 0, fanout 10), broken down after a
    warm-up epoch of each; returns the bytes the device sampler stages."""
    from repro_torch.core import partition_graph
    from repro_torch.core.gp.trainer import GPHyperParams
    from repro_torch.core.sampler import build_device_epoch_sampler
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.engine.stacking import batches_to_device
    from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                                   build_partitioned_graph, make_benchmark)
    from repro_torch.graph.sage import broadcast_to_partitions
    from repro_torch.train.optim import AdamW

    g = make_benchmark(BENCHMARKS["products-s"])
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                            method="ew", seed=0, fanout_k=10).parts
    pg = build_partitioned_graph(g, parts, 4)

    m = GraphSAGE(g.feature_dim, 128, g.num_classes)
    opt = AdamW(lr=1e-3, grad_clip=5.0)
    eng = SPMDEngine(m, m.make_loss_fn(), opt, pg, GPHyperParams(),
                     EngineConfig(device="cuda"))
    host_train = [g.train_idx[parts[g.train_idx] == p]
                  for p in range(pg.num_parts)]
    ds = build_device_epoch_sampler(g, host_train, pg.num_parts,
                                    batch_size=256, fanouts=(10, 10),
                                    device="cuda")
    eng.set_device_sampler(ds)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m.init(0).cuda()
    state = {"p": params, "o": opt.init(params.parameters())}
    pp = broadcast_to_partitions(params, pg.num_parts)
    pstate = {"p": pp, "o": opt.init_stacked(pp.parameters())}

    def p0():
        state["p"], state["o"], *_ = eng.phase0_epoch_async(
            state["p"], state["o"], gen)

    def p1():
        pstate["p"], pstate["o"], *_ = eng.phase1_epoch_async(
            pstate["p"], pstate["o"], gen, ds.natural_iters, params)

    # the host path's phase-0 epoch for comparison: one iteration's batch
    # of the host path's shapes (drawn here, held in host memory), moved
    # in its one pinned copy, then the steps and the eval
    nodes, valid = ds.draw_epoch(gen)
    host = {k: v.cpu().numpy()[None] for k, v in
            ds.make_batch(gen, nodes[:, 0], valid[:, 0]).items()}

    def h0():
        state["p"], state["o"], *_ = eng.phase0_epoch(
            state["p"], state["o"], batches_to_device(host, "cuda"))

    log(f"async sampler at products-s P={pg.num_parts}: k "
        f"{ds.k.tolist()}, batches {ds.num_batches}, natural_iters "
        f"{ds.natural_iters.tolist()}, staged {ds.nbytes} bytes")
    for label, fn in (("async phase-0 epoch", p0),
                      ("async phase-1 epoch", p1),
                      ("host-path phase-0 epoch (copy, steps, eval)", h0)):
        fn()
        profile_epoch(torch, label, fn)
    return ds.nbytes


def async_epoch_profiles_fresh():
    """:func:`async_epoch_profiles` in a fresh process, whose output is
    printed here; returns the bytes the sampler staged.  In this process,
    after the phases before it, torch.profiler recorded no host-to-device
    copy at all, not even a host-path epoch's 29 MB pinned one that a fresh
    process records."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--profile-async-epochs"], capture_output=True,
                       text=True, timeout=600)
    for line in r.stdout.splitlines():
        log(line)
    if r.returncode != 0:
        raise RuntimeError(f"async epoch profiles failed: {r.stderr[-3000:]}")
    return int(re.search(r"staged (\d+) bytes", r.stdout).group(1))


def fullgraph_step_checks(torch, pg, flush):
    """One full-graph step from seed-0 params: gradients with the kernels
    against the plain aggregation, both step times, and a torch.profiler
    breakdown of the kernel step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE

    def engine(use_kernel):
        m = GraphSAGE(64, 128, 24)
        return SPMDEngine(m, None, None, pg, None,
                          EngineConfig(use_kernel_agg=use_kernel,
                                       device="cuda"))

    engines = {"kernel": engine(True), "plain": engine(False)}
    params = GraphSAGE(64, 128, 24).init(0).cuda()

    def step(eng):
        params.zero_grad(set_to_none=True)
        batch = {"shard": eng.shards, "labels": eng.labels,
                 "train_mask": eng.masks["train"]}
        eng._fg_loss(params, batch).mean().backward()
        return [p.grad.clone() for p in params.parameters()]

    gk, gp = step(engines["kernel"]), step(engines["plain"])
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(gk, gp)]
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    times = {}
    for label in ("plain", "kernel", "kernel2", "plain2"):
        times[label] = time_ms(lambda: step(engines[label.rstrip("2")]), 5,
                               flush)
    log(f"full-graph step grads kernel vs plain: max |diff| per weight "
        f"{errs} (atol {GRAD_ATOL}, rtol {GRAD_RTOL}); step ms (CUDA "
        f"events, L2 flushed) {json.dumps(times)}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        for _ in range(3):
            step(engines["kernel"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
    cuda = [e for e in tp.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in cuda) / 3
    log(f"profile full-graph step: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms = {busy_us / 1e6 / wall:.3f} of wall")
    for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile fg kernel {e.self_device_time_total / 3:9.1f} us/step "
            f"x{e.count / 3:5.1f}  {e.key[:90]}")
    return times


def overlap_checks(torch, pg, flush):
    """The overlapped split forward against the synchronous one on seed-0
    params at products-s, both with the kernels: owned-row logits (atol =
    rtol = 1e-4), owned predictions and test micro-F1 (reported); one
    full-graph step's gradients (GRAD_ATOL/GRAD_RTOL); the step's and the
    eval forward's device times (CUDA events, L2 flushed; sync, overlap,
    overlap, sync); one overlapped step under torch.profiler."""
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE

    m = GraphSAGE(64, 128, 24)
    engines = {k: SPMDEngine(m, None, None, pg, None, EngineConfig(
        device="cuda", overlap_halo=k == "overlap")) for k in ("sync",
                                                              "overlap")}
    params = GraphSAGE(64, 128, 24).init(0).cuda()
    own = torch.as_tensor(np.arange(pg.max_nodes)[None]
                          < pg.n_own[:, None], device="cuda")

    def fwd(eng):
        with torch.no_grad():
            return eng.fwd(params, eng.shards)

    def step(eng):
        params.zero_grad(set_to_none=True)
        batch = {"shard": eng.shards, "labels": eng.labels,
                 "train_mask": eng.masks["train"]}
        eng._fg_loss(params, batch).mean().backward()
        return [p.grad.clone() for p in params.parameters()]

    lo, ls = fwd(engines["overlap"]), fwd(engines["sync"])
    torch.cuda.synchronize()
    logit_err = float((lo[own] - ls[own]).abs().max())
    torch.testing.assert_close(lo[own], ls[own], atol=1e-4, rtol=1e-4)
    same = float((lo.argmax(-1)[own] == ls.argmax(-1)[own]).float().mean())
    f1 = {k: float(e.evaluate(params, "test", per_partition_params=False)[0]
                   .mean()) for k, e in engines.items()}
    go, gs = step(engines["overlap"]), step(engines["sync"])
    grad_errs = [float((a - b).abs().max()) for a, b in zip(go, gs)]
    for a, b in zip(go, gs):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # the device timers hide up to ~20 ms of host work behind a sleep
    # kernel (a profiled step's wall is ~12-14 ms, an overlapped eval
    # forward's enqueue up to ~3 ms)
    times = {}
    for label in ("sync", "overlap", "overlap2", "sync2"):
        eng = engines[label.rstrip("2")]
        times[f"step_{label}"] = time_ms(lambda: step(eng), 5, flush)
        times[f"step_device_{label}"] = time_ms(
            lambda: step(eng), 5, flush, hide_host=True,
            sleep_cycles=10 * SLEEP_CYCLES)
        times[f"eval_fwd_{label}"] = time_ms(lambda: fwd(eng), 10, flush)
        times[f"eval_fwd_device_{label}"] = time_ms(
            lambda: fwd(eng), 10, flush, hide_host=True,
            sleep_cycles=10 * SLEEP_CYCLES)
    log(f"overlap vs sync at products-s: owned-row logits max |diff| "
        f"{logit_err:.3e} (atol = rtol = 1e-4), owned predictions equal "
        f"{same:.6f}, test micro-F1 (mean over partitions) {json.dumps(f1)}; "
        f"full-graph step grads max |diff| per weight {grad_errs} (atol "
        f"{GRAD_ATOL}, rtol {GRAD_RTOL}); ms (CUDA events, L2 flushed; "
        f"*_device_* with the host hidden) {json.dumps(times)}")
    profile_window(torch, "synchronous eval forward",
                   lambda: [fwd(engines["sync"]) for _ in range(3)], 3)
    profile_window(torch, "overlapped full-graph step",
                   lambda: [step(engines["overlap"]) for _ in range(3)], 3)
    profile_window(torch, "overlapped eval forward",
                   lambda: [fwd(engines["overlap"]) for _ in range(3)], 3)
    return times


def sequential_vs_stacked(torch, sa):
    """``--engine sequential --full-graph-train`` for 2 epochs (both
    full-graph: ``--phase0-frac 1.0``) against the stacked engine with its
    kernels from the same start: loss histories and final params within
    GRAD_ATOL/GRAD_RTOL.  The oracle aggregates with the plain ops, so it
    launches no kernel."""
    from repro_torch.launch.train import run_gnn

    args = ("--epochs", "2", "--phase0-frac", "1.0", "--full-graph-train")
    res_k, fwd_k, bwd_k = train_run(torch, sa, "stacked full-graph 2 epochs",
                                    *args)
    sa.reset_kernel_launch_count()
    t0 = time.perf_counter()
    res_q = run_gnn(train_args(*args, "--engine", "sequential"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert res_q.engine_mode == "sequential", res_q.engine_mode
    assert (sa.kernel_launch_count(), sa.bwd_kernel_launch_count()) == (0, 0)
    lk, lq = np.asarray(res_k.loss_history), np.asarray(res_q.loss_history)
    assert lk.shape == lq.shape == (2,) and np.isfinite(lq).all()
    np.testing.assert_allclose(lq, lk, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    errs = []
    for a, b in zip(res_q.final_params.parameters(),
                    res_k.final_params.parameters()):
        errs.append(float((a - b).abs().max()))
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    log(f"sequential oracle (plain aggregation) vs stacked engine (kernels), "
        f"full-graph 2 epochs: losses {lq.tolist()} vs {lk.tolist()}, "
        f"params max |diff| per weight {errs} (atol {GRAD_ATOL}, rtol "
        f"{GRAD_RTOL}), micro-F1 {res_q.f1.micro:.4f} vs {res_k.f1.micro:.4f}, "
        f"oracle wall {wall:.1f} s, epoch {res_q.epoch_time_s * 1e3:.2f} vs "
        f"{res_k.epoch_time_s * 1e3:.2f} ms")
    return fwd_k, bwd_k


def busy_ms(torch, fn, reps):
    """Device busy ms per call of ``fn`` over ``reps`` calls
    (torch.profiler: the sum of the device's kernel, copy and fill
    times), beside the host clock's ms per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    busy = sum(e.self_device_time_total for e in tp.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / reps / 1e3, wall * 1e3


def comm_checks(torch, sa, pg, flush, card, res_s):
    """ROADMAP item 10 at products-s, P=4, EW, hidden 128, seed 0, with the
    kernels; returns the segment forward's launches of its runs (each
    counted from 0 just before and read just after).

    1. The cached forward at full refresh bitwise the synchronous forward.
    2. A sampled run with ``--halo-cache --halo-refresh-every 4 --halo-cv``:
       each epoch's exchange bytes equal ``halo_refresh_plan``'s closed
       form over the pipeline's partition; micro-F1 beside the uncached
       run's; its launches.
    3. Evals with ``fp16`` and ``int8`` on the uncached run's final
       per-partition params: the codec on the card bitwise the codec on the
       CPU for the gathered send rows of both layers; the residual zero on
       pad slots and every landed trash row zero; the wire bytes a layer
       1/2 (fp16) and (D+4)/(4D) (int8) of the uncompressed; micro-F1
       beside the uncompressed eval's.
    4. Three async phase-0 epochs (the device sampler, one seed) with grad
       none, bucketed and topk (frac 0.01): bucketed's losses against
       none's within GRAD_ATOL/GRAD_RTOL, top-k's first epoch (before any
       top-k update) too, its residual finite.
    5. Times beside the card: the eval forward for none / fp16 / int8 /
       cached (0, 0) / cached cv chunk (CUDA events around the enqueue,
       and the device's with the host hidden); the epoch call for each
       grad mode (CUDA events around the call, which synchronises, and the
       device's busy time under torch.profiler); the cache and residual
       bytes on the device."""
    from repro_torch.core import partition_graph
    from repro_torch.core.sampler import build_device_epoch_sampler
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                                   build_partitioned_graph, make_benchmark)
    from repro_torch.graph.distributed import (_gather_send,
                                               dequantize_rows,
                                               halo_refresh_plan,
                                               make_distributed_forward,
                                               make_kernel_mean_agg,
                                               quantize_rows)
    from repro_torch.train.optim import AdamW

    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    launches = 0
    m = GraphSAGE(64, 128, 24)
    params = GraphSAGE(64, 128, 24).init(0).cuda()
    engines = {k: SPMDEngine(m, None, None, pg, None, EngineConfig(
        device="cuda", **kw)) for k, kw in (
            ("none", {}), ("fp16", {"halo_compress": "fp16"}),
            ("int8", {"halo_compress": "int8"}),
            ("cache", {"halo_cache": True, "halo_refresh_every": 4,
                       "halo_cv": True}))}
    max_s = pg.send_idx.shape[-1]

    # 1. the full refresh is the synchronous forward
    ec = engines["cache"]
    with torch.no_grad():
        sync = ec.fwd(params, ec.shards)
        full, cache = ec._cached_fwd(0, max_s)(params, ec.shards,
                                               ec._halo_state)
    torch.cuda.synchronize()
    assert torch.equal(full, sync), "full-refresh cached forward not bitwise"
    ec._halo_state = cache
    log(f"comm {card}: cached forward at full refresh bitwise the "
        f"synchronous forward (logits {tuple(full.shape)}, cache "
        f"{nbytes(cache.values())} B)")

    # 2. the sampled run with the cache, cv, K=4
    res_c, fwd_c, _ = train_run(torch, sa, "sampled halo cache K=4 cv",
                                "--epochs", "6", "--phase0-frac", "0.5",
                                "--halo-cache", "--halo-refresh-every", "4",
                                "--halo-cv")
    launches += fwd_c
    g = make_benchmark(BENCHMARKS["products-s"])
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                            method="ew", seed=0, fanout_k=10).parts
    pgp = build_partitioned_graph(g, parts, 4)
    want = [2 * pgp.halo_slot_bytes(*halo_refresh_plan(
        e, 4, True, pgp.send_idx.shape[-1])) for e in range(res_c.epochs_run)]
    assert res_c.halo_exchange_history == want, (
        res_c.halo_exchange_history, want)
    log(f"comm {card}: sampled run with the cache (K=4, cv): per-epoch "
        f"exchange bytes {res_c.halo_exchange_history} = the closed form "
        f"(full {2 * pgp.halo_bytes_per_layer}); micro-F1 "
        f"{res_c.f1.micro:.4f} vs uncached {res_s.f1.micro:.4f}; segment "
        f"forward launches {fwd_c}")

    # 3. compressed evals on the uncached run's final params
    pp = res_s.final_params
    e_none = engines["none"]
    with torch.no_grad():
        layers = e_none.export_serving_state(params)["layers"]
    trash = pg.trash_row
    pad = torch.as_tensor(pg.send_mask == 0, device="cuda")
    micro = {"none": float(e_none.evaluate(pp, "test")[0].mean())}
    for mode in ("fp16", "int8"):
        eng = engines[mode]
        codec = []
        for h in layers:
            x = _gather_send(h, eng.shards["send_idx"], eng.shards["send_mask"])
            pc, sc = quantize_rows(x.cpu(), mode)
            pd, sd = quantize_rows(x, mode)
            same = torch.equal(pd.cpu(), pc) and (
                sc is None or torch.equal(sd.cpu(), sc))
            same = same and torch.equal(
                dequantize_rows(pd, sd, mode, x.dtype).cpu(),
                dequantize_rows(pc, sc, mode, x.dtype))
            assert same, f"{mode} codec on the card differs from the CPU's"
            codec.append(tuple(x.shape))
        sa.reset_kernel_launch_count()
        for _ in range(3):
            mic = eng.evaluate(pp, "test")[0]
        n = sa.kernel_launch_count()
        assert n == 6, (mode, n)
        launches += n
        micro[mode] = float(mic.mean())
        for r in eng._halo_residual.values():
            assert float(r[pad].abs().max()) == 0.0, "residual pad slot set"
        trash_max = []
        agg = make_kernel_mean_agg(pg.max_nodes)

        def watched(h, shards):
            trash_max.append(float(h[:, trash].abs().max()))
            return agg(h, shards)

        with torch.no_grad():
            make_distributed_forward(m, eng._fwd_meta, agg=watched,
                                     compress=mode)(
                params, eng.shards, eng._halo_residual)
        assert trash_max == [0.0, 0.0], trash_max
        ratio = eng.halo_wire_bytes_per_layer / e_none.halo_wire_bytes_per_layer
        want_ratio = 0.5 if mode == "fp16" else (64 + 4) / (4 * 64)
        assert ratio == want_ratio, (mode, ratio)
        log(f"comm {card}: {mode} eval: codec bitwise CUDA vs CPU on the "
            f"send rows {codec}; residual zero on pad slots; landed trash "
            f"rows {trash_max}; wire bytes a layer "
            f"{eng.halo_wire_bytes_per_layer} = {ratio} of "
            f"{e_none.halo_wire_bytes_per_layer}; 3 evals launched the "
            f"segment forward {n} times")
    log(f"comm {card}: test micro-F1 (mean over partitions) of the final "
        f"per-partition params, compressed vs uncompressed eval: "
        f"{json.dumps(micro)}")

    # 4. phase-0 epochs through the reducers, drawn on the card
    host_train = [g.train_idx[parts[g.train_idx] == p] for p in range(4)]
    ds = build_device_epoch_sampler(g, host_train, 4, batch_size=256,
                                    fanouts=(10, 10), device="cuda")
    grad_engines, grad_state, losses = {}, {}, {}
    for mode in ("none", "bucketed", "topk"):
        mm = GraphSAGE(64, 128, 24)
        opt = AdamW(lr=1e-3, grad_clip=5.0)
        eng = SPMDEngine(mm, mm.make_loss_fn(), opt, pgp, None, EngineConfig(
            device="cuda", grad_compress=mode))
        eng.set_device_sampler(ds)
        prm = mm.init(0).cuda()
        st = opt.init(prm.parameters())
        gen = torch.Generator(device="cuda")
        sa.reset_kernel_launch_count()
        out = []
        for e in range(3):
            gen.manual_seed(e)
            prm, st, ls, _, _ = eng.phase0_epoch_async(prm, st, gen)
            out.append(ls)
        launches += sa.kernel_launch_count()
        losses[mode] = torch.cat(out)
        grad_engines[mode] = eng
        grad_state[mode] = {"p": prm, "o": st, "gen": gen}
    for a, b in zip(losses["bucketed"], losses["none"]):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    first = losses["none"].shape[0] // 3
    torch.testing.assert_close(losses["topk"][:first],
                               losses["none"][:first], atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    g_res = grad_engines["topk"].comm_residual_state()[1]
    assert torch.isfinite(g_res).all() and bool((g_res != 0).any())
    log(f"comm {card}: async phase-0 epochs (mean loss over partitions per "
        f"iteration): " + json.dumps({k: [round(float(x), 6)
                                        for x in v.mean(dim=1)]
                                       for k, v in losses.items()})
        + f"; top-k residual finite, {int((g_res != 0).sum())} of "
        f"{g_res.numel()} non-zero")

    # 5. times
    cache = ec._halo_state
    plan_cv = halo_refresh_plan(1, 4, True, max_s)
    fwds = {
        "none": lambda: e_none.fwd(params, e_none.shards),
        "fp16": lambda: engines["fp16"]._fwd_comp(
            params, engines["fp16"].shards, engines["fp16"]._halo_residual),
        "int8": lambda: engines["int8"]._fwd_comp(
            params, engines["int8"].shards, engines["int8"]._halo_residual),
        "cached_0_0": lambda: ec._cached_fwd(0, 0)(params, ec.shards, cache),
        f"cached_cv_{plan_cv[0]}_{plan_cv[1]}": lambda: ec._cached_fwd(
            *plan_cv)(params, ec.shards, cache)}
    # in turns, each twice (a, b, ..., b, a); the second reading is "_2"
    turns = lambda keys: [(k, k) for k in keys] + [
        (k, f"{k}_2") for k in reversed(keys)]
    times = {}
    with torch.no_grad():
        for key, label in turns(list(fwds)):
            times[f"eval_fwd_{label}"] = time_ms(fwds[key], 10, flush)
            times[f"eval_fwd_device_{label}"] = time_ms(
                fwds[key], 10, flush, hide_host=True,
                sleep_cycles=10 * SLEEP_CYCLES)
    for mode, label in turns(["none", "bucketed", "topk"]):
        eng, s = grad_engines[mode], grad_state[mode]

        def epoch():
            s["p"], s["o"], *_ = eng.phase0_epoch_async(s["p"], s["o"],
                                                        s["gen"])

        times[f"epoch_{label}"] = time_ms(epoch, 5, flush)
        times[f"epoch_device_busy_{label}"], _ = busy_ms(torch, epoch, 3)
    state_bytes = {
        "halo_cache": nbytes(cache.values()),
        "halo_residual_int8": nbytes(
            engines["int8"]._halo_residual.values()),
        "grad_residual_topk": nbytes([g_res]),
        "features": e_none.resident_feature_bytes}
    log(f"comm {card}: ms (eval forwards: CUDA events around the enqueue, "
        f"L2 flushed; *_device_* with the host hidden; epoch calls: CUDA "
        f"events around the synchronising call, device busy from "
        f"torch.profiler) {json.dumps(times)}; bytes on the device "
        f"{json.dumps(state_bytes)}")
    return launches


def featstore_checks(torch, sa, flush, card, res_s, res_a):
    """ROADMAP item 11 at products-s, P=4, EW, hidden 128, seed 0, with the
    kernels, over the pipeline's own partition (``fanout_k`` 10); returns
    the segment forward's launches of its runs (each counted from 0 just
    before and read just after): ``(stacked, per_partition)``, the second
    the streamed evals' single-partition launches.

    1. Feature-store evals at ``hot_frac`` 0.0 / 0.25 / 0.5 / 1.0 (degree)
       and 0.5 (freq): logits, micro and preds bitwise the all-resident
       engine's, on the seed-0 params and on the sampled run's trained
       per-partition params; the cold tier pinned; 2 forward launches an
       eval.  The store with the halo cache (refresh every 2) and with
       int8, 3 evals each, bitwise the same composition without the store
       (micro, preds, and the cache or the residual).
    2. One async phase-0 and one async phase-1 epoch with a feature-store
       sampler against the resident sampler from equal generator states:
       losses, val micro and params bitwise.
    3. The streamed eval at G = 1, 2, 4 against the stacked all-resident
       eval: logits within SERVE_ATOL/SERVE_RTOL, differing predictions
       reported, 2·P single-partition launches an eval.
    4. ``cold_h2d_bytes`` against the closed forms: P·C·D·B an eval,
       twice that streamed, Nc·D·B + P·C·D·B an async phase-0 epoch (and a
       phase-1 epoch with its eval), 0 at hot_frac 1.0; printed:
       ``resident_feature_bytes`` against P·H·D·B (+ Nh·D·B) and the rise
       of ``torch.cuda.max_memory_allocated`` over one eval beside
       ``feat_peak_bytes``'s transient term.
    5. ``launch.train gnn`` runs: sampled ``--feat-store --hot-frac 0.5``
       (losses and micro-F1 equal to the all-resident sampled run's, its
       cold bytes the closed form), ``--feat-store --async-generalize
       --async-personalize`` against the resident async run, and
       ``--feat-store --feat-groups 2``.
    6. featstore-xl under a budget of 0.7 x the all-resident peak of the
       pipeline's partition: the plain run raises FeatureBudgetError,
       ``--feat-store --hot-frac 0.25 --feat-groups 1`` trains 3 epochs;
       the device's measured peak beside the budget.
    7. Times beside the card: the eval forward with and without the store
       and the stage copy alone, pinned and pageable (CUDA events around
       the enqueue, and the device's with the host hidden); the streamed
       evals (host clock, synchronised); the async phase-0 epoch call with
       and without the store (CUDA events around the synchronising call,
       device busy from torch.profiler)."""
    from repro_torch.core import partition_graph
    from repro_torch.core.sampler import build_device_epoch_sampler
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import (BENCHMARKS, GraphSAGE,
                                   build_partitioned_graph, make_benchmark)
    from repro_torch.graph.featstore import FeatureBudgetError, feat_peak_bytes
    from repro_torch.graph.sage import broadcast_to_partitions
    from repro_torch.launch.train import build_parser, run_gnn
    from repro_torch.train.optim import AdamW

    t_fs = time.perf_counter()
    P, B = 4, 4
    fwd_stacked = fwd_part = 0
    g = make_benchmark(BENCHMARKS["products-s"])
    D = g.feature_dim
    parts = partition_graph(g.indptr, g.indices, g.features, g.labels, P,
                            method="ew", seed=0, fanout_k=10).parts
    pg = build_partitioned_graph(g, parts, P)
    own_cap, max_n = pg.own_cap, pg.max_nodes
    cold_rows = lambda frac: own_cap - int(round(frac * own_cap))
    eval_bytes = lambda frac: P * cold_rows(frac) * D * B
    model = lambda: GraphSAGE(D, 128, g.num_classes)
    m = model()
    p0 = model().init(0).cuda()
    trained = res_s.final_params
    engine = lambda **kw: SPMDEngine(m, None, None, pg, None, EngineConfig(
        device="cuda", **kw))

    def counted(fn):
        """``fn()`` and the forward launches it made."""
        k0 = sa.kernel_launch_count()
        out = fn()
        return out, sa.kernel_launch_count() - k0

    base = engine()
    cases = (("seed0", p0, False), ("trained", trained, True))
    want = {}
    with torch.no_grad():
        for name, prm, per in cases:
            want[name] = (base.fwd(prm, base.shards),
                          *base.evaluate(prm, "test", per))
    log(f"featstore {card}: pipeline partition own_cap {own_cap} max_nodes "
        f"{max_n}; all-resident plane {base.resident_feature_bytes} B")

    # 1. the store's evals, bitwise
    stores = {}
    for frac, pol in ((0.0, "degree"), (0.25, "degree"), (0.5, "degree"),
                      (1.0, "degree"), (0.5, "freq")):
        e = engine(feat_store=True, hot_frac=frac, hot_policy=pol)
        assert e._fs.cold.shape[1] == cold_rows(frac)
        assert e._cold_host.is_pinned() or e._cold_host.numel() == 0
        for name, prm, per in cases:
            b0 = e.cold_h2d_bytes
            (micro, preds), n = counted(lambda: e.evaluate(prm, "test", per))
            assert n == 2, (frac, pol, n)
            assert e.cold_h2d_bytes - b0 == eval_bytes(frac), (
                frac, e.cold_h2d_bytes - b0, eval_bytes(frac))
            with torch.no_grad():
                logits, n2 = counted(lambda: e._eval_forward(
                    prm, e._featurized()))
            fwd_stacked += n + n2
            assert torch.equal(logits, want[name][0]), (frac, pol, name)
            assert torch.equal(micro, want[name][1]), (frac, pol, name)
            assert torch.equal(preds, want[name][2]), (frac, pol, name)
        H = e._fs.hot.shape[1]
        assert e.resident_feature_bytes == P * H * D * B
        stores[frac, pol] = e
        log(f"featstore {card}: hot_frac {frac} {pol}: H {H} C "
            f"{cold_rows(frac)}; logits, micro and preds bitwise the "
            f"resident engine's (seed-0 and trained params); 2 launches an "
            f"eval; cold bytes an eval {eval_bytes(frac)} = P·C·D·B; resident "
            f"{e.resident_feature_bytes} B = P·H·D·B")
    assert eval_bytes(1.0) == 0
    for kw, state in (({"halo_cache": True, "halo_refresh_every": 2},
                       "_halo_state"), ({"halo_compress": "int8"},
                                        "_halo_residual")):
        a, b = engine(**kw), engine(feat_store=True, hot_frac=0.5, **kw)
        for i in range(3):
            (ma, pa), na = counted(lambda: a.evaluate(trained, "test", True))
            (mb, pb), nb = counted(lambda: b.evaluate(trained, "test", True))
            assert na == nb == 2, (kw, na, nb)
            fwd_stacked += na + nb
            assert torch.equal(ma, mb) and torch.equal(pa, pb), (kw, i)
            sa_, sb_ = getattr(a, state), getattr(b, state)
            assert all(torch.equal(sa_[k], sb_[k]) for k in sa_), (kw, i)
        assert b.cold_h2d_bytes == 3 * eval_bytes(0.5)
        log(f"featstore {card}: store x {json.dumps(kw)}: 3 evals bitwise "
            f"the composition without the store (micro, preds, {state})")

    # 2. async epochs, feature-store sampler against the resident one
    host_train = [g.train_idx[parts[g.train_idx] == p] for p in range(P)]
    ds_kw = dict(batch_size=256, fanouts=(10, 10), device="cuda")
    samplers = {"resident": build_device_epoch_sampler(g, host_train, P,
                                                        **ds_kw),
                "store": build_device_epoch_sampler(
                    g, host_train, P, feat_store=True, hot_frac=0.5,
                    **ds_kw)}
    ds_f = samplers["store"]
    assert ds_f.cold_host.is_pinned()
    nc, nh = ds_f.cold_host.shape[0], ds_f.hot_feats.shape[0]
    sampler_cold = nc * D * B
    runs = {}
    for label, ds in samplers.items():
        mm = model()
        opt = AdamW(lr=1e-3, grad_clip=5.0)
        kw = {"feat_store": True, "hot_frac": 0.5} if label == "store" else {}
        eng = SPMDEngine(mm, mm.make_loss_fn(), opt, pg, None,
                         EngineConfig(device="cuda", **kw))
        eng.set_device_sampler(ds)
        prm = mm.init(0).cuda()
        st = opt.init(prm.parameters())
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        (prm, st, l0, v0, _), n0 = counted(
            lambda: eng.phase0_epoch_async(prm, st, gen))
        d0 = eng.cold_h2d_bytes
        pp = broadcast_to_partitions(prm, P)
        po = opt.init_stacked(pp.parameters())
        gen.manual_seed(12)
        (pp, po, l1, v1, _), n1 = counted(lambda: eng.phase1_epoch_async(
            pp, po, gen, ds.natural_iters, prm))
        assert n0 == n1 == 2, (label, n0, n1)
        fwd_stacked += n0 + n1
        runs[label] = dict(eng=eng, prm=prm, st=st, gen=gen, out=(
            l0, v0, l1, v1, *prm.parameters(), *pp.parameters()),
            d0=d0, d1=eng.cold_h2d_bytes - d0)
    r, s = runs["resident"], runs["store"]
    assert all(torch.equal(x, y) for x, y in zip(r["out"], s["out"]))
    assert (r["d0"], r["d1"]) == (0, 0)
    both = sampler_cold + eval_bytes(0.5)
    assert s["d0"] == s["d1"] == both, (s["d0"], s["d1"], both)
    res_bytes = s["eng"].resident_feature_bytes
    log(f"featstore {card}: async phase-0 and phase-1 epochs with the "
        f"store's sampler (Nh {nh}, Nc {nc}) bitwise the resident sampler's "
        f"(losses {[round(float(x), 6) for x in s['out'][0].mean(dim=1)]}, "
        f"{float(s['out'][2].mean()):.6f}; val micro; params); cold bytes "
        f"an epoch {s['d0']} / {s['d1']} = Nc·D·B {sampler_cold} + P·C·D·B "
        f"{eval_bytes(0.5)}; resident {res_bytes} B against P·H·D·B + Nh·D·B "
        f"{P * (own_cap - cold_rows(0.5)) * D * B + nh * D * B} (resident "
        f"engine and sampler: {r['eng'].resident_feature_bytes} B)")

    # 3. the streamed eval against the stacked all-resident eval
    times = {}
    e05 = stores[0.5, "degree"]
    for G in (1, 2, 4):
        e = engine(feat_store=True, hot_frac=0.5, feat_groups=G)
        b0 = e.cold_h2d_bytes
        with torch.no_grad():
            hs, n = counted(lambda: e._streamer.forward(trained, True))
        assert n == 2 * P, (G, n)
        assert e.cold_h2d_bytes - b0 == 2 * eval_bytes(0.5)
        logits = torch.stack(hs)
        err = float((logits - want["trained"][0]).abs().max())
        diff = int((logits.argmax(-1) != want["trained"][0].argmax(-1)).sum())
        (micro, preds), n2 = counted(lambda: e.evaluate(trained, "test",
                                                        True))
        assert n2 == 2 * P, (G, n2)
        fwd_part += n + n2
        torch.testing.assert_close(logits, want["trained"][0],
                                   atol=SERVE_ATOL, rtol=SERVE_RTOL)
        k0 = sa.kernel_launch_count()
        times[f"streamed_eval_G{G}_ms"] = call_us(
            lambda: e.evaluate(trained, "test", True), calls=5) / 1e3
        fwd_part += sa.kernel_launch_count() - k0
        log(f"featstore {card}: streamed eval G={G}: logits max |diff| "
            f"{err:.3e} against the stacked all-resident eval (atol "
            f"{SERVE_ATOL}, rtol {SERVE_RTOL}), {diff} of {logits.shape[0] * logits.shape[1]} "
            f"rows' predictions differ, micro {float(micro.mean()):.6f} vs "
            f"{float(want['trained'][1].mean()):.6f}; {n} single-partition "
            f"launches an eval; cold bytes an eval {2 * eval_bytes(0.5)} = "
            f"2·P·C·D·B")
        # 4. the device memory's rise over one eval, beside the closed form
        rise = {}
        for label, eng in ([("resident", base), ("store", e05)] if G == 1
                           else []) + [(f"streamed G={G}", e)]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            (_, _), k = counted(lambda: eng.evaluate(trained, "test", True))
            torch.cuda.synchronize()
            if label.startswith("streamed"):
                fwd_part += k
            else:
                fwd_stacked += k
            rise[label] = torch.cuda.max_memory_allocated() - m0
        transient = {
            "store": P * (cold_rows(0.5) + max_n) * D * B,
            f"streamed G={G}": G * (cold_rows(0.5) + max_n) * D * B}
        log(f"featstore {card}: max_memory_allocated rise over one eval "
            f"{json.dumps(rise)} B; feat_peak_bytes' transient term "
            f"{json.dumps({k: v for k, v in transient.items() if k in rise})}"
            f" B (the rise adds the hidden planes and logits)")

    # 5. pipeline runs through launch.train gnn
    args = ("--epochs", "6", "--phase0-frac", "0.5")
    res_f, n, _ = train_run(torch, sa, "sampled feat-store 0.5", *args,
                            "--feat-store", "--hot-frac", "0.5")
    fwd_stacked += n
    assert res_f.loss_history == res_s.loss_history, (res_f.loss_history,
                                                      res_s.loss_history)
    assert res_f.f1.micro == res_s.f1.micro, (res_f.f1.micro, res_s.f1.micro)
    n0 = len(res_f.phase0_iter_history)
    assert res_f.cold_h2d_bytes == (res_f.epochs_run + 1) * eval_bytes(0.5)
    assert (res_f.host_to_device_bytes_phase0
            - res_s.host_to_device_bytes_phase0) == n0 * eval_bytes(0.5)
    assert (res_f.host_to_device_bytes_phase1
            - res_s.host_to_device_bytes_phase1) == (
                res_f.phase1_epochs + 1) * eval_bytes(0.5)
    log(f"featstore {card}: sampled --feat-store --hot-frac 0.5: losses and "
        f"micro-F1 {res_f.f1.micro:.4f} equal to the resident run's; cold "
        f"bytes {res_f.cold_h2d_bytes} = {res_f.epochs_run + 1} evals x "
        f"{eval_bytes(0.5)}, per phase by the deltas; resident "
        f"{res_f.resident_feature_bytes} B vs {res_s.resident_feature_bytes}")
    res_fa, n, _ = train_run(torch, sa, "async feat-store 0.5", *args,
                             "--async-generalize", "--async-personalize",
                             "--feat-store", "--hot-frac", "0.5")
    fwd_stacked += n
    assert res_fa.loss_history == res_a.loss_history, (res_fa.loss_history,
                                                       res_a.loss_history)
    assert res_fa.f1.micro == res_a.f1.micro, (res_fa.f1.micro,
                                               res_a.f1.micro)
    assert res_fa.cold_h2d_bytes == res_fa.epochs_run * both + eval_bytes(0.5)
    log(f"featstore {card}: async --feat-store: losses and micro-F1 "
        f"{res_fa.f1.micro:.4f} equal to the resident async run's; cold "
        f"bytes {res_fa.cold_h2d_bytes} = {res_fa.epochs_run} epochs x "
        f"{both} + the test eval's {eval_bytes(0.5)}; host-to-device bytes "
        f"phase 0 {res_fa.host_to_device_bytes_phase0} phase 1 "
        f"{res_fa.host_to_device_bytes_phase1} (resident run "
        f"{res_a.host_to_device_bytes_phase0}, "
        f"{res_a.host_to_device_bytes_phase1}); resident "
        f"{res_fa.resident_feature_bytes} B vs {res_a.resident_feature_bytes}")
    res_g, n, _ = train_run(torch, sa, "sampled feat-store feat-groups 2",
                            *args, "--feat-store", "--feat-groups", "2",
                            per_eval=2 * P)
    fwd_part += n
    assert res_g.cold_h2d_bytes == (res_g.epochs_run + 1) * 2 * eval_bytes(0.5)
    log(f"featstore {card}: --feat-store --feat-groups 2: losses "
        f"{np.round(res_g.loss_history, 6).tolist()} vs "
        f"{np.round(res_s.loss_history, 6).tolist()}, micro-F1 "
        f"{res_g.f1.micro:.4f} vs {res_s.f1.micro:.4f}, epoch with eval "
        f"{res_g.epoch_time_with_eval_s * 1e3:.2f} vs "
        f"{res_s.epoch_time_with_eval_s * 1e3:.2f} ms, cold bytes "
        f"{res_g.cold_h2d_bytes}")

    # 6. the bigger-than-device witness on featstore-xl
    gx = make_benchmark(BENCHMARKS["featstore-xl"])
    px = partition_graph(gx.indptr, gx.indices, gx.features, gx.labels, P,
                         method="ew", seed=0, fanout_k=10).parts
    pgx = build_partitioned_graph(gx, px, P)
    peak_x = feat_peak_bytes(P, pgx.max_nodes, gx.feature_dim, B)
    budget = peak_x * 0.7 / 1e6
    xl = lambda *extra: build_parser().parse_args(
        ["gnn", "--dataset", "featstore-xl", "--parts", "4", "--hidden",
         "128", "--seed", "0", "--device", "cuda", "--epochs", "3",
         "--feat-budget-mb", repr(budget), *extra])
    try:
        run_gnn(xl())
    except FeatureBudgetError as e:
        refused = str(e)
    else:
        raise AssertionError("featstore-xl all-resident ran over its budget")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    sa.reset_kernel_launch_count()
    res_x = run_gnn(xl("--feat-store", "--hot-frac", "0.25",
                       "--feat-groups", "1"))
    torch.cuda.synchronize()
    n = sa.kernel_launch_count()
    assert n == 2 * P * (res_x.epochs_run + 1), n
    fwd_part += n
    dev_peak = torch.cuda.max_memory_allocated() - m0
    assert res_x.epochs_run >= 3 and np.isfinite(res_x.loss_history).all()
    hx = int(round(0.25 * pgx.own_cap))
    store_peak = feat_peak_bytes(P, pgx.max_nodes, gx.feature_dim, B,
                                 hot_rows=hx, cold_rows=pgx.own_cap - hx,
                                 groups=1)
    log(f"featstore {card}: featstore-xl (max_nodes {pgx.max_nodes}, own_cap "
        f"{pgx.own_cap}, D {gx.feature_dim}): budget {budget:.6f} MB = 0.7 x "
        f"the all-resident peak {peak_x} B; all-resident refused "
        f"({refused[:90]}...); --feat-store --hot-frac 0.25 --feat-groups 1 "
        f"trained {res_x.epochs_run} epochs, losses "
        f"{np.round(res_x.loss_history, 4).tolist()}, micro-F1 "
        f"{res_x.f1.micro:.4f}, feature peak (closed form) {store_peak} B, "
        f"device peak over the run (max_memory_allocated, everything) "
        f"{dev_peak} B, resident features {res_x.resident_feature_bytes} B, "
        f"cold bytes {res_x.cold_h2d_bytes}; {n} single-partition launches")

    # 7. times
    pageable = torch.from_numpy(e05._fs.cold)
    pinned = e05._cold_host
    assert pinned.is_pinned() and not pageable.is_pinned()
    fns = {
        "eval_fwd_resident": lambda: base.fwd(p0, base.shards),
        "eval_fwd_store": lambda: e05._eval_forward(p0, e05._featurized()),
        "stage_pinned": lambda: pinned.to("cuda", non_blocking=True),
        "stage_pageable": lambda: pageable.to("cuda", non_blocking=True)}
    turns = lambda keys: [(k, k) for k in keys] + [
        (k, f"{k}_2") for k in reversed(keys)]
    with torch.no_grad():
        k0 = sa.kernel_launch_count()
        for key, label in turns(list(fns)):
            times[f"{label}_ms"] = time_ms(fns[key], 10, flush)
            times[f"{label}_device_ms"] = time_ms(
                fns[key], 10, flush, hide_host=True,
                sleep_cycles=10 * SLEEP_CYCLES)
        fwd_stacked += sa.kernel_launch_count() - k0
    k0 = sa.kernel_launch_count()
    for key, label in turns(["resident", "store"]):
        run = runs[key]

        def epoch():
            run["prm"], run["st"], *_ = run["eng"].phase0_epoch_async(
                run["prm"], run["st"], run["gen"])

        times[f"async_epoch_{label}_ms"] = time_ms(epoch, 5, flush)
        times[f"async_epoch_{label}_device_busy_ms"], _ = busy_ms(
            torch, epoch, 3)
    fwd_stacked += sa.kernel_launch_count() - k0
    log(f"featstore {card}: ms (eval forwards and stage copies: CUDA events "
        f"around the enqueue, L2 flushed; *_device_ms with the host hidden; "
        f"streamed evals: host clock, synchronised; async epoch calls: CUDA "
        f"events around the synchronising call, device busy from "
        f"torch.profiler) {json.dumps(times)}")
    log(f"featstore {card}: checks took {time.perf_counter() - t_fs:.1f} s")
    return fwd_stacked, fwd_part


class CkptClock:
    """While active, records every ``RunCheckpointer.save`` (host clock:
    the device-to-host copies, the npz and its sidecar each written to a
    tmp file, fsync'd and renamed, the manifest) with its archive's bytes,
    and every ``load_latest`` (host clock, synchronised: CRCs, the arrays
    back on the card)."""

    def __init__(self, torch):
        self.torch = torch
        self.save_ms, self.load_ms = [], []
        self.bytes = {}                     # (directory, step) -> npz bytes

    def __enter__(self):
        from repro_torch.robustness import RunCheckpointer

        self._orig = (RunCheckpointer.save, RunCheckpointer.load_latest)
        save, load_latest = self._orig

        def timed_save(ck, step, arrays, host):
            t0 = time.perf_counter()
            path = save(ck, step, arrays, host)
            self.save_ms.append((time.perf_counter() - t0) * 1e3)
            self.bytes[ck.dir, int(step)] = os.path.getsize(path)
            return path

        def timed_load(ck, make_like):
            t0 = time.perf_counter()
            out = load_latest(ck, make_like)
            self.torch.cuda.synchronize()
            self.load_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        RunCheckpointer.save, RunCheckpointer.load_latest = (timed_save,
                                                             timed_load)
        return self

    def __exit__(self, *exc):
        from repro_torch.robustness import RunCheckpointer

        RunCheckpointer.save, RunCheckpointer.load_latest = self._orig


def robustness_checks(torch, sa, card):
    """ROADMAP item 12 at products-s, P=4, EW, hidden 128, fanouts (10, 10),
    seed 0, 6 epochs with ``phase0_fraction`` 0.5 (boundary 1 in phase 0,
    boundary 4 in phase 1), through ``run_eat_distgnn`` with the kernels;
    returns the segment kernels' launches of its runs ``(fwd, bwd)``, each
    run counted from 0 just before it and read just after.

    1. Five paths: sampled (double-buffered), full-graph, async (both
       phases), halo cache (refresh every 2) + int8 + top-k, feature store
       at hot_frac 0.5.  For each, one uninterrupted run, then for E in
       {1, 4} a run with ``checkpoint_dir`` that an injected crash after
       boundary E ends, then a ``resume=True`` run: resumed from E, every
       tensor of ``final_params`` equal, the histories, micro-F1, exchange
       bytes and host-to-device bytes equal, and the resumed run launching
       the forward kernel twice an eval (and a full-graph step) and the
       backward kernel once a full-graph step.  A mismatch reruns the
       uninterrupted run to tell a resume fault from run-to-run
       nondeterminism, then fails.
    2. On the sampled path: the newest archive bit-flipped by
       ``FaultPlan.corrupt``; the resume falls back one step and finishes
       bitwise.  In float64: a crash-at-4 resume, bitwise.
    3. The cache path with ``FaultPlan(straggler={1: {2: 0.75}},
       drop_refresh_epochs={2})``: 0.75 straggler seconds, epoch 2's
       exchange bytes 0 where the uninterrupted run's are > 0; whether the
       final params are equal is reported.
    4. Serving: the sampled run's phase-0 best model, read from its
       boundary-3 archive and written with ``save_pytree``;
       ``launch.serve --gnn --checkpoint`` on it (no updates) serves
       logits bitwise ``from_engine``'s with the same params; a
       ``--fail-partition 1 --fail-at-tick 5 --recover-after-ticks 8`` run
       over 20 ticks fails and recovers at ticks 5 and 13, reports its
       degraded queries, and its logits match a from-scratch plain forward
       over the updated graph within SERVE_ATOL/SERVE_RTOL.
    Printed beside the card: save ms per boundary, load ms, archive bytes
    at a phase-0 and a phase-1 step, the checks' wall time."""
    import shutil
    import tempfile

    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE, build_partitioned_graph
    from repro_torch.launch.serve import build_parser, gnn_main
    from repro_torch.pipeline import EATConfig, run_eat_distgnn
    from repro_torch.robustness import FaultPlan, InjectedCrash
    from repro_torch.serve import GNNServingEngine, apply_updates_to_graph
    from repro_torch.train.checkpoint import load_pytree, save_pytree
    from repro_torch.train.optim import AdamW

    t_rb = time.perf_counter()
    base = dict(dataset="products-s", num_parts=4, partition_method="ew",
                hidden_dim=128, fanouts=(10, 10), seed=0, max_epochs=6,
                phase0_fraction=0.5, device="cuda")
    paths = {
        "sampled": {},
        "full-graph": {"full_graph_train": True},
        "async": {"async_generalize": True, "async_personalize": True},
        "cache+int8+topk": {"halo_cache": True, "halo_refresh_every": 2,
                            "halo_compress": "int8", "grad_compress": "topk"},
        "feat-store": {"feat_store": True, "hot_frac": 0.5},
    }
    launches = [0, 0]

    def run(kw, **extra):
        """One counted run; an injected crash returns the exception."""
        sa.reset_kernel_launch_count()
        try:
            res = run_eat_distgnn(EATConfig(**kw), **extra)
        except InjectedCrash as e:
            res = e
        torch.cuda.synchronize()
        fwd, bwd = sa.kernel_launch_count(), sa.bwd_kernel_launch_count()
        launches[0] += fwd
        launches[1] += bwd
        return res, fwd, bwd

    def diffs(res, want):
        out = {}
        for i, (a, b) in enumerate(zip(res.final_params.parameters(),
                                       want.final_params.parameters())):
            if not torch.equal(a, b):
                out[f"param{i}"] = float((a.double() - b.double()).abs().max())
        for k in ("loss_history", "val_history", "halo_exchange_history",
                  "phase0_iter_history", "comm_grad_bytes", "comm_halo_bytes",
                  "comm_halo_exchange_bytes", "host_to_device_bytes_phase0",
                  "host_to_device_bytes_phase1", "epochs_run"):
            if getattr(res, k) != getattr(want, k):
                out[k] = (getattr(res, k), getattr(want, k))
        if res.f1.micro != want.f1.micro:
            out["f1.micro"] = (res.f1.micro, want.f1.micro)
        return out

    def check_resume(label, kw, want, res, fwd, bwd, expect_from):
        assert not isinstance(res, Exception), (label, res)
        assert res.resumed_from_epoch == expect_from, (
            label, res.resumed_from_epoch)
        d = diffs(res, want)
        if d:
            again, _, _ = run(kw)
            log(f"robustness {label}: resumed run differs {d}; a second "
                f"uninterrupted run differs from the first by "
                f"{diffs(again, want) or 'nothing'}")
            raise AssertionError(f"{label}: resumed run not bitwise: {d}")
        evals = res.epochs_run - expect_from + 1
        fg = (sum(res.phase0_iter_history[expect_from:])
              if kw.get("full_graph_train") else 0)
        assert (fwd, bwd) == (2 * evals + 2 * fg, fg), (label, fwd, bwd,
                                                        evals, fg)

    summary = {}
    with tempfile.TemporaryDirectory() as tmp, CkptClock(torch) as clock:
        wants = {}
        for name, extra in paths.items():
            kw = dict(base, **extra)
            t0 = time.perf_counter()
            wants[name], fwd0, bwd0 = run(kw)
            t_run = time.perf_counter() - t0
            for crash in (1, 4):
                ck = os.path.join(tmp, f"{name}-{crash}")
                err, _, _ = run(dict(kw, checkpoint_dir=ck),
                                fault_plan=FaultPlan(
                                    crash_epochs=frozenset({crash})))
                assert isinstance(err, InjectedCrash) and err.epoch == crash, (
                    name, crash, err)
                if (name, crash) == ("sampled", 4):
                    # the crashed run's steps 2-4, kept for the corrupted
                    # archive's fallback and the served model
                    shutil.copytree(ck, os.path.join(tmp, "crashed"))
                res, fwd, bwd = run(dict(kw, checkpoint_dir=ck, resume=True))
                check_resume(f"{name} crash {crash}", kw, wants[name], res,
                             fwd, bwd, crash)
            summary[name] = {"run_s": round(t_run, 3), "launches": (fwd0, bwd0),
                             "micro_f1": wants[name].f1.micro}
            log(f"robustness {card}: {name}: resumes after boundaries 1 and "
                f"4 bitwise the uninterrupted run (params, losses, val, "
                f"micro-F1 {wants[name].f1.micro:.4f}, exchange and "
                f"host-to-device bytes); uninterrupted run {t_run:.2f} s, "
                f"launches fwd {fwd0} bwd {bwd0}")

        # the newest archive corrupted: the resume falls back one step
        kw = dict(base, **paths["sampled"])
        ck = os.path.join(tmp, "crashed")
        ck3 = os.path.join(tmp, "best-of-phase-0.npz")
        shutil.copy(os.path.join(ck, "ckpt_000003.npz"), ck3)
        shutil.copy(os.path.join(ck, "ckpt_000003.npz.meta.json"),
                    ck3 + ".meta.json")
        info = FaultPlan(seed=3).corrupt(os.path.join(ck, "ckpt_000004.npz"))
        res, fwd, bwd = run(dict(kw, checkpoint_dir=ck, resume=True))
        check_resume("sampled, corrupt step 4", kw, wants["sampled"], res,
                     fwd, bwd, 3)
        log(f"robustness {card}: step 4's archive corrupted {info}; the "
            f"resume fell back to step 3 and finished bitwise")

        # float64: one crash-at-4 resume
        kw64 = dict(kw, dtype="float64")
        want64, _, _ = run(kw64)
        ck = os.path.join(tmp, "f64")
        err, _, _ = run(dict(kw64, checkpoint_dir=ck),
                        fault_plan=FaultPlan(crash_epochs=frozenset({4})))
        assert isinstance(err, InjectedCrash), err
        res, fwd, bwd = run(dict(kw64, checkpoint_dir=ck, resume=True))
        check_resume("sampled float64 crash 4", kw64, want64, res, fwd, bwd,
                     4)
        assert all(w.dtype == torch.float64
                   for w in res.final_params.parameters())
        log(f"robustness {card}: float64 sampled run resumed after boundary "
            f"4 bitwise (micro-F1 {want64.f1.micro:.4f} against float32 "
            f"{wants['sampled'].f1.micro:.4f})")

        # stragglers and a dropped halo refresh on the cache path
        kwc = dict(base, **paths["cache+int8+topk"])
        res, _, _ = run(kwc, fault_plan=FaultPlan(
            straggler={1: {2: 0.75}}, drop_refresh_epochs=frozenset({2})))
        want = wants["cache+int8+topk"]
        assert res.straggler_delay_s == 0.75, res.straggler_delay_s
        assert want.halo_exchange_history[2] > 0, want.halo_exchange_history
        assert res.halo_exchange_history[2] == 0, res.halo_exchange_history
        same = not any(k.startswith("param") for k in diffs(res, want))
        log(f"robustness {card}: straggler + dropped refresh: straggler "
            f"{res.straggler_delay_s} s, exchange bytes "
            f"{res.halo_exchange_history} against "
            f"{want.halo_exchange_history}; final params equal to the "
            f"uninterrupted run's: {same} (micro-F1 {res.f1.micro:.4f} "
            f"against {want.f1.micro:.4f})")

        # serving the sampled run's phase-0 best model (boundary 3 is phase
        # 0's last: its archive holds no phase-1 state)
        fp = wants["sampled"].final_params
        m = GraphSAGE(fp.feature_dim, fp.hidden_dim,
                      fp.num_classes).init(0).to("cuda")
        best = load_pytree(ck3, {"params": m, "best_global": m,
                                 "opt": AdamW().init(m.parameters())})
        model_path = os.path.join(tmp, "best.npz")
        save_pytree(model_path, best["best_global"])
        serve = ["--gnn", "--dataset", "products-s", "--parts", "4",
                 "--hidden", "128", "--seed", "0", "--device", "cuda",
                 "--checkpoint", model_path]
        srun = gnn_main(build_parser().parse_args(
            serve + ["--ticks", "3", "--updates-per-tick", "0"]))
        launches[0] += srun["export_launches"] + srun["tick_launches"]
        for a, b in zip(srun["params"].parameters(),
                        best["best_global"].parameters()):
            assert torch.equal(a, b)
        want_srv = GNNServingEngine.from_engine(
            srun["spmd"], srun["pg"], best["best_global"],
            use_kernel_agg=True)
        assert np.array_equal(srun["engine"].export_logits(),
                              want_srv.export_logits())
        log(f"robustness {card}: launch.serve --checkpoint serves the "
            f"sampled run's phase-0 best model: logits bitwise from_engine's")
        frun = gnn_main(build_parser().parse_args(
            serve + ["--ticks", "20", "--fail-partition", "1",
                     "--fail-at-tick", "5", "--recover-after-ticks", "8"]))
        launches[0] += frun["export_launches"] + frun["tick_launches"]
        failed = [t + 1 for t, h in enumerate(frun["health"])
                  if h[1] == "failed"]
        assert failed == list(range(5, 13)), failed
        st = frun["stats"]
        assert st["failovers"] == st["recoveries"] == 1, st
        served = frun["engine"].export_logits()
        g2 = apply_updates_to_graph(frun["graph"], frun["feature_updates"])
        pg2 = build_partitioned_graph(g2, frun["parts"], 4)
        ex2 = SPMDEngine(frun["model"], None, None, pg2, None, EngineConfig(
            use_kernel_agg=False, device="cuda")).export_serving_state(
                frun["params"])
        logits2 = ex2["logits"].cpu().numpy()
        want_l = np.zeros_like(served)
        for p in range(4):
            n = int(pg2.n_own[p])
            want_l[pg2.global_ids[p][:n]] = logits2[p][:n]
        own1 = np.flatnonzero(frun["engine"].owner_part == 1)
        err1 = float(np.abs(served[own1] - want_l[own1]).max())
        np.testing.assert_allclose(served[own1], want_l[own1],
                                   atol=SERVE_ATOL, rtol=SERVE_RTOL)
        np.testing.assert_allclose(served, want_l, atol=SERVE_ATOL,
                                   rtol=SERVE_RTOL)
        log(f"robustness {card}: --fail-partition 1 over 20 ticks: failed "
            f"at tick 5, healthy again at tick 13, degraded queries "
            f"{st['degraded_queries']} ({frun['stale_answers']} stale "
            f"answers), updates queued {st['updates_queued']}, replayed "
            f"{st['replayed']}; partition 1's logits against a from-scratch "
            f"plain forward max |diff| {err1:.3e} (atol {SERVE_ATOL})")

        p0 = clock.bytes[os.path.join(tmp, "sampled-4"), 1]
        p1 = clock.bytes[os.path.join(tmp, "sampled-4"), 4]
        log(f"robustness {card}: save ms per boundary (host clock, fsync "
            f"inside; {len(clock.save_ms)} saves) median "
            f"{np.median(clock.save_ms):.3f} min {min(clock.save_ms):.3f} "
            f"max {max(clock.save_ms):.3f}; load ms (load_latest, "
            f"synchronised; {len(clock.load_ms)} loads) median "
            f"{np.median(clock.load_ms):.3f} min {min(clock.load_ms):.3f} "
            f"max {max(clock.load_ms):.3f}; sampled archive bytes at step 1 "
            f"(phase 0) {p0}, at step 4 (phase 1) {p1}; per path "
            f"{json.dumps(summary)}")
    log(f"robustness {card}: checks took {time.perf_counter() - t_rb:.1f} s, "
        f"launches fwd {launches[0]} bwd {launches[1]}")
    return tuple(launches)


# --------------------------------------------------------------------------
# the partition mesh (ROADMAP item 14, part 1)
# --------------------------------------------------------------------------

# the reference's spmd-against-stacked tolerances (max |diff|,
# tests/test_engine_parity.py::test_spmd_shard_map_matches_stacked)
MESH_P0_TOL, MESH_P1_TOL = 1e-6, 1e-5
MESH_F1_TOL, MESH_PRED_MISMATCH = 5e-3, 3
# one full-graph step's pmean'd gradients against the stacked mean's: the
# P partitions' gradients are summed in another order (relative to each
# weight's largest entry)
MESH_GRAD_RTOL = 1e-6


# the mesh's pipeline runs held against the stacked ones: sampled and
# full-graph, 2 epochs with phase0_fraction 0.5 (one phase-0 epoch, one of
# phase 1: the reference's own schedule for its tolerances; 4 until item
# 14's part 3 needed the time), a sampled run of 2 phase-0 epochs alone
# (its final params are phase 0's best), and (item 14 part 2) the async
# run, one partition at P = 1 but not centralized, so that its phase 1
# runs
MESH_ASYNC = {"async_generalize": True, "async_personalize": True}
MESH_STORE = {"feat_store": True, "hot_frac": 0.5}
MESH_RUNS = {"sampled": {}, "full-graph": {"full_graph_train": True},
             "phase-0": {"max_epochs": 2, "phase0_fraction": 1.0},
             "async": {**MESH_ASYNC, "centralized": False}}
# the store's runs, each (config, the resident run of MESH_RUNS it must
# equal bitwise); store-5's 5 epochs put boundary 4 in phase 1
MESH_STORE_RUNS = {
    "sampled-store": (MESH_STORE, "sampled"),
    "async-store": ({**MESH_RUNS["async"], **MESH_STORE}, "async"),
    "store-5": ({**MESH_STORE, "max_epochs": 5, "centralized": False},
                None)}
# the runs killed after a boundary and resumed: run -> boundary
MESH_RESUMES = {"sampled": 1, "async": 1, "store-5": 4}
# the mesh checks' model: products-s's 64 features and 24 classes, hidden 128
MESH_DIMS = (64, 128, 24)
# item 14 part 3: the communication options' pipeline runs, 4 epochs
# unless they say otherwise (the overlapped one's launches are the
# row-range single-partition use), and the one killed after boundary 1 and
# resumed
MESH_PART3_RUNS = {
    "cache-cv": {"halo_cache": True, "halo_refresh_every": 4,
                 "halo_cv": True},
    "int8-topk": {"halo_compress": "int8", "grad_compress": "topk"},
    "fp16-bucketed": {"halo_compress": "fp16", "grad_compress": "bucketed"},
    "async-cache-int8-topk": {**MESH_ASYNC, "centralized": False,
                              "halo_cache": True, "halo_refresh_every": 2,
                              "halo_compress": "int8",
                              "grad_compress": "topk"},
    "fullgraph-overlap-bucketed": {"full_graph_train": True,
                                   "overlap_halo": True,
                                   "grad_compress": "bucketed"}}
# phase 0 alone through each reducer (2 epochs, final params phase 0's
# best), and the codec + reducer runs on the reference's own schedule for
# its tolerances, one phase-0 and one phase-1 epoch
# (tests/test_engine_parity.py::run_pair): their params are held to the
# phase-0 and phase-1 tolerances.  The 4-epoch runs' params are held on the
# CPU (tests/test_torch_mesh_drift.py: within the reference's 1e-5, the
# reducers bitwise the stacked engine, as the reference's own spmd runs
# are) and here to a multiple of the sequential oracle's drift
# (MESH_ORACLE_*): on the card a rank's own gradient is bitwise its
# partition's computed alone on a partition axis of 1 but not its row of
# the stacked call, which runs other GEMM shapes (mesh_partition_grads,
# held to MESH_GRAD_RTOL), and phase 1, which restarts AdamW where the prox
# term's gradient is 0, grows that rounding to ~1e-5 by epoch 4
MESH_PART3_RUNS.update({
    f"phase-0-{r}": {"max_epochs": 2, "phase0_fraction": 1.0,
                     "grad_compress": r} for r in ("bucketed", "topk")})
MESH_PART3_RUNS.update({
    f"{k}-1+1": {**MESH_PART3_RUNS[k], "max_epochs": 2, "centralized": False}
    for k in ("int8-topk", "fp16-bucketed")})
# the sequential oracle against the stacked engine at the 4-epoch runs that
# drift most on the mesh: the oracle runs every partition's products at one
# partition's shapes, the mesh ranks' shapes, so its drift is the share of
# the mesh's that other GEMM shapes alone explain.  Every 4-epoch mesh
# run's params are held to MESH_ORACLE_MULT times the oracle's drift (its
# own run's, or the larger of the two).  The mesh adds no rounding of its
# own (its collectives and reducers are bitwise the stacked ones), so its
# drift is of the oracle's order; on the H100 the oracle drifted 2.69e-5
# (fp16 + bucketed) and 1.14e-5 (int8 + top-k), the mesh 1.10e-5 and
# 9.57e-6 (0.41 and 0.84 of it); twice the oracle's leaves room for that
# spread, and a fault of the mesh's own (a lost exchange, a wrong row) is
# not bounded by a rounding at all
MESH_ORACLE_RUNS = ("fp16-bucketed", "int8-topk")
MESH_ORACLE_MULT = 2.0
MESH_PART3_OVERLAP_RUN = "fullgraph-overlap-bucketed"
MESH_PART3_RESUME = ("async-cache-int8-topk", 1)
# the eval checks: engine options, each engine running three eval
# forwards from the same params (K = 2: plans full, (0, 0), full; K = 3
# with the cv chunks: full, chunk 0, chunk 1)
MESH_PART3_EVALS = {
    "cache-k2-int8": {"halo_cache": True, "halo_refresh_every": 2,
                      "halo_compress": "int8"},
    "cache-cv": {"halo_cache": True, "halo_refresh_every": 3,
                 "halo_cv": True},
    "cache-cv-fp16-ring2": {"halo_cache": True, "halo_refresh_every": 3,
                            "halo_cv": True, "halo_compress": "fp16",
                            "ring_chunks": 2},
    "int8": {"halo_compress": "int8"},
    "fp16-ring2": {"halo_compress": "fp16", "ring_chunks": 2},
    "overlap": {"overlap_halo": True},
    "overlap-ring2": {"overlap_halo": True, "ring_chunks": 2}}


def mesh_run_config(P, mode, name, **kw):
    """The config of the mesh run ``name`` (of MESH_RUNS or
    MESH_STORE_RUNS)."""
    run = (MESH_RUNS[name] if name in MESH_RUNS
           else MESH_STORE_RUNS[name][0])
    return mesh_config(P, mode, **{**run, **kw})


def mesh_config(P, mode, **kw):
    """The pipeline at the default widths (products-s, hidden 128, fanouts
    (10, 10), batch 256, seed 0), 2 epochs with ``phase0_fraction`` 0.5
    unless ``kw`` says otherwise (P = 1: centralized, phase 0 only)."""
    from repro_torch.pipeline import EATConfig

    base = dict(dataset="products-s", num_parts=P, hidden_dim=128,
                max_epochs=2, phase0_fraction=0.5, engine_mode=mode,
                device="cuda", seed=0, centralized=P == 1)
    return EATConfig(**{**base, **kw})


def mesh_graph(P):
    """products-s, the pipeline's partition of it (P = 1: one part) and
    the partition's assignment of nodes."""
    from repro_torch.core import partition_graph
    from repro_torch.graph import (BENCHMARKS, build_partitioned_graph,
                                   make_benchmark)

    g = make_benchmark(BENCHMARKS["products-s"])
    parts = (np.zeros(g.num_nodes, np.int64) if P == 1 else partition_graph(
        g.indptr, g.indices, g.features, g.labels, P, method="ew", seed=0,
        fanout_k=10).parts)
    return g, build_partitioned_graph(g, parts, P), parts


def mesh_digest(res, eng):
    """The deterministic part of an ``EATResult`` (timings left out) and
    its final params' test predictions through ``eng``."""
    return {"loss": np.asarray(res.loss_history),
            "test_preds": eng.evaluate(res.final_params, "test")[1].cpu(),
            "engine": res.engine_mode, "epoch_s": res.epoch_time_s,
            "val": np.asarray(res.val_history),
            "params": [w.detach().cpu() for w in res.final_params.parameters()],
            "micro": res.f1.micro, "iters": list(res.phase0_iter_history),
            "bytes": (res.comm_grad_bytes, res.comm_halo_bytes,
                      res.comm_halo_exchange_bytes,
                      res.host_to_device_bytes_phase0,
                      res.host_to_device_bytes_phase1,
                      res.resident_feature_bytes),
            "cold": res.cold_h2d_bytes, "epochs": res.epochs_run,
            "resumed_from": res.resumed_from_epoch}


def mesh_step_checks(torch, eng, opt, P, epoch=True):
    """On one engine (a mesh rank's, or the stacked one in this process),
    from seed-1 params: the export's logits, one full-graph step's gradient
    of the mean loss (pmean'd on the mesh) and, with ``epoch``, a sampled
    phase-0 epoch of 3 iterations on random batches at the main path's
    widths from seed 5 (params, losses and the epoch's seconds, 3 times;
    random features and labels make gradients that nearly cancel across
    partitions, which AdamW's first steps amplify, so its params are
    reported and its losses held)."""
    from repro_torch.engine.compat import pmean
    from repro_torch.graph import GraphSAGE

    params = GraphSAGE(*MESH_DIMS).init(1).cuda()
    out = {"logits": eng.export_serving_state(params)["logits"].cpu()}
    batch = {"shard": eng.shards, "labels": eng.labels,
             "train_mask": eng.masks["train"]}
    w = list(params.parameters())
    loss = eng._fg_loss(params, batch)
    grads = (torch.autograd.grad(loss.mean(), w) if eng.mesh is None
             else pmean(torch.autograd.grad(loss, w), eng.mesh))
    out["grads"] = [x.cpu() for x in grads]
    if not epoch:
        return out
    p, losses, out["phase0_s"] = random_phase0_epochs(torch, eng, opt, P)
    out["phase0"] = ([v.detach().cpu() for v in p.parameters()],
                     losses.cpu())
    return out


def random_batches(P):
    """Three iterations of random ``(3, P, ...)`` host batches at the main
    path's widths, from seed 5."""
    rng = np.random.default_rng(5)
    d, _, c = MESH_DIMS
    x = lambda *s: rng.normal(0, 1, (3, P, *s, d)).astype(np.float32)
    return {"x_t": x(256), "x_1": x(256, 10), "x_2": x(256, 10, 10),
            "labels": rng.integers(0, c, (3, P, 256)).astype(np.int64),
            "mask": np.ones((3, P, 256), np.float32)}


def random_phase0_epochs(torch, eng, opt, P, calls=3):
    """``calls`` sampled phase-0 epochs of 3 iterations on random batches
    at the main path's widths from seed 5, each from seed-1 params: the
    last epoch's params and losses, and every epoch's seconds."""
    from repro_torch.engine.stacking import batches_to_device
    from repro_torch.graph import GraphSAGE

    host = random_batches(P)
    if eng.mesh is not None:
        host = eng.rank_batches(host)
    b = batches_to_device(host, "cuda")
    secs = []
    for _ in range(calls):
        p = GraphSAGE(*MESH_DIMS).init(1).cuda()
        p, _, losses, _, dt = eng.phase0_epoch(p, opt.init(p.parameters()), b)
        secs.append(dt)
    return p, losses, secs


def mesh_engine(pg, mode, **kw):
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.graph import GraphSAGE
    from repro_torch.train.optim import AdamW

    m = GraphSAGE(*MESH_DIMS)
    opt = AdamW(lr=1e-3, grad_clip=5.0)
    return SPMDEngine(m, m.make_loss_fn(), opt, pg, None,
                      EngineConfig(mode=mode, device="cuda", **kw)), opt


def mesh_store_and_resumes(torch, P, ckdir):
    """The mesh runs of item 14's part 2 besides the async run: the store
    runs of ``MESH_STORE_RUNS``, then each run of ``MESH_RESUMES`` killed
    by an injected crash after its boundary (checkpoints in ``ckdir``,
    the same directory on every rank: rank 0 writes it) and resumed, with
    rank 0's save and every rank's load timed (``CkptClock``).  Returns
    ``(store results, resumed results, (save ms, load ms))``."""
    from repro_torch.pipeline import run_eat_distgnn
    from repro_torch.robustness import FaultPlan, InjectedCrash

    store = {k: run_eat_distgnn(mesh_run_config(P, "spmd", k))
             for k in MESH_STORE_RUNS}
    resumed = {}
    with CkptClock(torch) as clock:
        for name, crash in MESH_RESUMES.items():
            ck = os.path.join(ckdir, name)
            try:
                run_eat_distgnn(mesh_run_config(P, "spmd", name,
                                                checkpoint_dir=ck),
                                fault_plan=FaultPlan(
                                    crash_epochs=frozenset({crash})))
                raise AssertionError(f"mesh {name}: no crash at {crash}")
            except InjectedCrash as e:
                assert e.epoch == crash, (name, e.epoch)
            resumed[name] = run_eat_distgnn(mesh_run_config(
                P, "spmd", name, checkpoint_dir=ck, resume=True))
    return store, resumed, (clock.save_ms, clock.load_ms)


def mesh_async_epoch_s(torch, P, mode, calls=3):
    """Each async epoch call's seconds as the engine reports them (host
    clock, synchronised; on the mesh the slowest rank's), on an engine of
    its own with the pipeline's device sampler at the main path's widths
    (batch 256, fanouts (10, 10), the CBS mini-epoch), after one warm-up
    call of each phase."""
    from repro_torch.core.sampler import build_device_epoch_sampler
    from repro_torch.graph import GraphSAGE
    from repro_torch.graph.sage import broadcast_to_partitions

    g, pg, parts = mesh_graph(P)
    eng, opt = mesh_engine(pg, mode)
    host_train = [g.train_idx[parts[g.train_idx] == p] for p in range(P)]
    ds = build_device_epoch_sampler(g, host_train, P, batch_size=256,
                                    subset_fraction=0.25, fanouts=(10, 10),
                                    device=eng.device)
    eng.set_device_sampler(ds)
    gen = torch.Generator(device=eng.device)
    params = GraphSAGE(g.feature_dim, 128, g.num_classes).init(1).to(
        eng.device)
    st = opt.init(params.parameters())
    out = {"phase0": [], "phase1": []}
    for i in range(calls + 1):
        gen.manual_seed(100 + i)
        params, st, _, _, dt = eng.phase0_epoch_async(params, st, gen)
        out["phase0"].append(dt)
    pp = broadcast_to_partitions(params, P)
    po = opt.init_stacked(pp.parameters())
    for i in range(calls + 1):
        gen.manual_seed(200 + i)
        pp, po, _, _, dt = eng.phase1_epoch_async(pp, po, gen,
                                                  ds.natural_iters, params)
        out["phase1"].append(dt)
    return {k: v[1:] for k, v in out.items()}


def mesh_rank(rank, P, ckdir):
    """One rank of the mesh: the pipeline runs of ``MESH_RUNS``, the store
    runs and the killed-and-resumed runs (the main path, their segment
    launches counted from 0 just before them and read just after), their
    final params' test predictions, the step checks on an engine of its
    own, the ``ring_chunks=2`` engine's logits and gradients, one
    exchange's time per layer width (host clock, synchronised, 20 calls)
    and the async epoch calls' times."""
    import torch

    from repro_torch.graph.distributed import mesh_exchange
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.pipeline import run_eat_distgnn

    sa.reset_kernel_launch_count()
    t0 = time.perf_counter()
    results = {k: run_eat_distgnn(mesh_run_config(P, "spmd", k))
               for k in MESH_RUNS}
    store, resumed, ckpt_ms = mesh_store_and_resumes(torch, P, ckdir)
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0,
           "launches": (sa.kernel_launch_count(),
                        sa.bwd_kernel_launch_count()),
           "ckpt_ms": ckpt_ms}
    _, pg, _ = mesh_graph(P)
    eng, opt = mesh_engine(pg, "spmd")
    out["pipelines"] = {k: mesh_digest(r, eng) for k, r in results.items()}
    out["store"] = {k: mesh_digest(r, eng) for k, r in store.items()}
    out["resumed"] = {k: mesh_digest(r, eng) for k, r in resumed.items()}
    out["async_s"] = mesh_async_epoch_s(torch, P, "spmd")
    out.update(mesh_step_checks(torch, eng, opt, P))
    out["ring2"] = mesh_step_checks(
        torch, *mesh_engine(pg, "spmd", ring_chunks=2), P, epoch=False)
    out["exchange_ms"] = {}
    for d in (64, 128):
        sent = torch.randn(P, pg.send_idx.shape[-1], d, device=eng.device)
        mesh_exchange(sent, eng.mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            mesh_exchange(sent, eng.mesh)
        torch.cuda.synchronize()
        out["exchange_ms"][d] = (time.perf_counter() - t0) / 20 * 1e3
    out["part3"] = mesh_part3_rank(torch, sa, P, ckdir)
    return out


def mesh_stacked(torch, P):
    """The stacked engine's side of the comparison, in this process."""
    from repro_torch.pipeline import run_eat_distgnn

    results = {k: run_eat_distgnn(mesh_run_config(P, "stacked", k))
               for k in MESH_RUNS}
    _, pg, _ = mesh_graph(P)
    eng, opt = mesh_engine(pg, "stacked")
    out = {"pipelines": {k: mesh_digest(r, eng) for k, r in results.items()}}
    out.update(mesh_step_checks(torch, eng, opt, P))
    out["async_s"] = mesh_async_epoch_s(torch, P, "stacked")
    out["part3"] = mesh_part3_stacked(torch, P)
    return out


def mesh_part2_checks(torch, P, got, label):
    """Item 14's part 2 within one world (rank 0's ``got``): the store runs
    bitwise the world's resident runs (losses, val, params, test
    predictions, micro-F1) with ``cold_h2d_bytes`` the closed forms —
    P·C·D·B an eval (C the partition's cold rows), Nc·D·B more an async
    epoch (the sampler's cold rows) — and each resumed run bitwise its
    uninterrupted run (the same and every byte counter but the cold bytes,
    which hold only the resumed part)."""
    g, pg, _ = mesh_graph(P)
    D, B = g.feature_dim, 4
    eval_bytes = P * (pg.own_cap - int(round(0.5 * pg.own_cap))) * D * B
    sampler_cold = (g.num_nodes - int(round(0.5 * g.num_nodes))) * D * B
    same = ("loss", "val", "params", "test_preds", "micro", "iters")

    def equal(a, b, keys):
        return all(
            all(torch.equal(x, y) for x, y in zip(a[k], b[k], strict=True))
            if k == "params" else
            torch.equal(a[k], b[k]) if k == "test_preds" else
            np.array_equal(a[k], b[k]) for k in keys)

    for name, (_, resident) in MESH_STORE_RUNS.items():
        d = got["store"][name]
        epochs = d["epochs"]
        want = ((epochs + 1) * eval_bytes if "async" not in name else
                epochs * (sampler_cold + eval_bytes) + eval_bytes)
        assert d["cold"] == want, (label, name, d["cold"], want)
        if resident is not None:
            assert equal(d, got["pipelines"][resident], same), (label, name)
    for name, crash in MESH_RESUMES.items():
        d = got["resumed"][name]
        base = (got["pipelines"] if name in MESH_RUNS else got["store"])[name]
        assert d["resumed_from"] == crash, (label, name, d["resumed_from"])
        assert equal(d, base, (*same, "bytes", "epochs")), (label, name)
    log(f"mesh {label}: --feat-store --hot-frac 0.5 sampled and async runs "
        f"bitwise the resident runs, cold bytes "
        f"{[got['store'][k]['cold'] for k in MESH_STORE_RUNS]} = the closed "
        f"forms ({eval_bytes} B an eval, {sampler_cold} B more an async "
        f"epoch); resumes after boundaries {MESH_RESUMES} bitwise the "
        f"uninterrupted runs (params, losses, val, test predictions, "
        f"micro-F1, byte counters)")


def mesh_compare(torch, got, want, label, bitwise):
    """The mesh run ``got`` (rank 0's) against the stacked ``want``:
    bitwise, or within the reference's spmd tolerances (phase-0 losses and
    the phase-0 run's params 1e-6, phase-1 losses and params 1e-5, val
    micro-F1 5e-3, at most 3 test predictions apart, a full-graph step's
    gradients rel 1e-6); the export's logits bitwise in both cases, and
    ``ring_chunks=2`` bitwise 0's."""
    found = {}
    for k, gp in got["pipelines"].items():
        wp = want["pipelines"][k]
        assert gp["engine"] == "spmd" and wp["engine"] == "stacked"
        assert gp["iters"] == wp["iters"] and gp["bytes"] == wp["bytes"], k
        n0 = len(gp["iters"])
        dl = np.abs(gp["loss"] - wp["loss"])
        found[k] = {
            "loss0": float(dl[:n0].max()),
            "loss1": float(dl[n0:].max()) if dl[n0:].size else 0.0,
            "params": max(float((a - b).abs().max()) for a, b in
                          zip(gp["params"], wp["params"], strict=True)),
            "val": float(np.abs(gp["val"] - wp["val"]).max()),
            "preds_apart": int((gp["test_preds"] != wp["test_preds"]).sum()),
            "micro": (gp["micro"], wp["micro"])}
    (p0g, l0g), (p0w, l0w) = got["phase0"], want["phase0"]
    dp0 = max(float((a - b).abs().max()) for a, b in zip(p0g, p0w))
    dl0 = float((l0g - l0w).abs().max())
    grel = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got["grads"], want["grads"]))
    logits_eq = torch.equal(got["logits"], want["logits"])
    ring_eq = (torch.equal(got["ring2"]["logits"], got["logits"])
               and all(torch.equal(a, b) for a, b in
                       zip(got["ring2"]["grads"], got["grads"])))
    log(f"mesh {label} vs stacked: pipelines {json.dumps(found)}; random-"
        f"batch phase-0 epoch params max |diff| {dp0:.3e} losses {dl0:.3e}; "
        f"full-graph step gradients rel {grel:.3e}; export logits bitwise "
        f"{logits_eq}; ring_chunks=2 bitwise 0 {ring_eq}")
    assert logits_eq, f"{label}: the export's logits are not bitwise"
    assert ring_eq, f"{label}: ring_chunks=2 differs from 0"
    for k, f in found.items():
        if bitwise:
            assert (f["loss0"] == f["loss1"] == f["params"] == f["val"]
                    == f["preds_apart"] == 0), (label, k, f)
            assert f["micro"][0] == f["micro"][1], (label, k, f)
            continue
        assert f["loss0"] <= MESH_P0_TOL and f["loss1"] <= MESH_P1_TOL, (
            label, k, f)
        assert f["params"] <= (MESH_P0_TOL if k == "phase-0"
                               else MESH_P1_TOL), (label, k, f)
        assert f["val"] <= MESH_F1_TOL, (label, k, f)
        assert f["preds_apart"] <= MESH_PRED_MISMATCH, (label, k, f)
    if bitwise:
        assert dp0 == 0 and dl0 == 0 and grel == 0, label
        return
    assert dl0 <= MESH_P0_TOL, label
    assert grel <= MESH_GRAD_RTOL, label


class CollectiveCount:
    """Counts the ``torch.distributed`` calls the mesh's collectives
    (``engine/compat.py``) make while it is entered: it wraps them."""

    NAMES = ("all_to_all_single", "batch_isend_irecv", "all_gather",
             "all_reduce", "barrier")

    def __enter__(self):
        import torch.distributed as dist

        self.n = 0
        self._saved = {k: getattr(dist, k) for k in self.NAMES}
        for k, fn in self._saved.items():
            def counted(*a, _fn=fn, **kw):
                self.n += 1
                return _fn(*a, **kw)
            setattr(dist, k, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for k, fn in self._saved.items():
            setattr(dist, k, fn)


def digest_tensor(t):
    """Shape, dtype and SHA-256 of a tensor's bytes: equal digests are
    equal bits (for state too large to send back whole)."""
    import hashlib

    import torch

    t = t.detach().contiguous().cpu()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return tuple(t.shape), str(t.dtype), hashlib.sha256(raw).hexdigest()


def digest_state(state):
    """``digest_tensor`` over a nested state (dicts, tuples, None)."""
    import torch

    if state is None:
        return None
    if isinstance(state, dict):
        return {k: digest_state(v) for k, v in sorted(state.items())}
    if isinstance(state, (tuple, list)):
        return [digest_state(v) for v in state]
    if isinstance(state, torch.Tensor):
        return digest_tensor(state)
    return state


def mesh_part3_evals(torch, pg, mode):
    """For each of ``MESH_PART3_EVALS``: three eval forwards from the same
    seed-1 params, each one's logits (the rank's rows on the mesh), the
    digests of the cache and residual after it (the stacked layout), its
    exchange bytes and, on the mesh, the collectives it issued."""
    from repro_torch.graph import GraphSAGE

    params = GraphSAGE(*MESH_DIMS).init(1).cuda()
    out = {}
    for name, kw in MESH_PART3_EVALS.items():
        eng, _ = mesh_engine(pg, mode, **kw)
        steps = []
        for _ in range(3):
            with torch.no_grad(), CollectiveCount() as cc:
                logits = eng._eval_forward(params, eng._featurized())
                torch.cuda.synchronize()
            cache = eng.halo_cache_state()
            steps.append({
                "logits": logits.cpu(), "collectives": cc.n,
                "cache": digest_state(None if cache is None else cache[0]),
                "res": digest_state(eng.comm_residual_state()),
                "bytes": eng.last_halo_exchange_bytes})
        out[name] = steps
    return out


def mesh_overlap_grads(torch, pg, mode):
    """One full-graph step's mean gradient through the overlapped forward
    from seed-1 params (``pmean``'d on the mesh)."""
    from repro_torch.engine.compat import pmean
    from repro_torch.graph import GraphSAGE

    eng, _ = mesh_engine(pg, mode, overlap_halo=True)
    params = GraphSAGE(*MESH_DIMS).init(1).cuda()
    w = list(params.parameters())
    loss = eng._fg_loss(params, {"shard": eng.shards, "labels": eng.labels,
                                 "train_mask": eng.masks["train"]})
    grads = (torch.autograd.grad(loss.mean(), w) if eng.mesh is None
             else pmean(torch.autograd.grad(loss, w), eng.mesh))
    return [g.cpu() for g in grads]


def mesh_reducer_grads(torch, pg, P, mode):
    """For each gradient reducer, the reduced gradient AdamW receives in
    the first step of a sampled phase-0 epoch on random batches (seed 5)
    from seed-1 params (the optimizer's ``update`` wrapped to keep it)."""
    out = {}
    for reducer in ("none", "bucketed", "topk"):
        eng, opt = mesh_engine(pg, mode, grad_compress=reducer)
        seen, update = [], opt.update

        def kept(grads, state, params, _update=update, _seen=seen):
            _seen.append([g.detach().cpu() for g in grads])
            return _update(grads, state, params)

        object.__setattr__(opt, "update", kept)
        random_phase0_epochs(torch, eng, opt, P, calls=1)
        out[reducer] = seen[0]
    return out


def mesh_partition_grads(torch, pg, P, mode):
    """Each partition's own phase-0 gradient before any reduction, from
    seed-1 params on the first iteration of :func:`random_batches`,
    differentiated as the reducers' steps differentiate it (the summed
    losses of a per-partition copy of the weights).  A mesh rank gives its
    own (``own``); the stacked engine its ``(P, ...)`` rows in one call
    (``rows``) and each partition alone on a partition axis of 1, the
    rank's shapes (``alone``)."""
    from repro_torch.engine.stacking import batches_to_device
    from repro_torch.graph import GraphSAGE
    from repro_torch.graph.sage import broadcast_to_partitions

    eng, _ = mesh_engine(pg, mode)
    params = GraphSAGE(*MESH_DIMS).init(1).cuda()
    host = {k: v[:1] for k, v in random_batches(P).items()}

    def grads(batch):
        per = broadcast_to_partitions(params, batch["labels"].shape[0])
        w = list(per.parameters())
        return [g.cpu() for g in torch.autograd.grad(
            eng.loss_fn(per, batch).sum(), w)]

    if eng.mesh is not None:
        b = batches_to_device(eng.rank_batches(host), "cuda")
        return {"own": grads({k: v[0] for k, v in b.items()})}
    b = {k: v[0] for k, v in batches_to_device(host, "cuda").items()}
    return {"rows": grads(b),
            "alone": [grads({k: v[r:r + 1] for k, v in b.items()})
                      for r in range(P)]}


def mesh_part3_times(torch, pg, P, calls=10):
    """A rank's times (host clock, synchronised, ms a call after one
    warm-up): the eval forward of each option beside the synchronous one
    (the cache's full, (0, 0) and cv-chunk plans run directly, without
    ageing it); one started-and-waited exchange at D=64 and D=128 beside
    the overlapped forward's interior half on the device (CUDA events);
    and 3 sampled phase-0 epochs of random batches (the engine's seconds,
    the slowest rank's) with each gradient reducer."""
    from repro_torch.engine.compat import exchange_start
    from repro_torch.graph import GraphSAGE
    from repro_torch.graph.distributed import make_kernel_split_agg

    params = GraphSAGE(*MESH_DIMS).init(1).cuda()

    def host_ms(fn):
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    out = {"eval_ms": {}}
    eng, _ = mesh_engine(pg, "spmd")
    out["eval_ms"]["sync"] = host_ms(lambda: eng.fwd(params, eng.shards))
    eng, _ = mesh_engine(pg, "spmd", halo_cache=True, halo_refresh_every=4,
                         halo_cv=True)
    S = eng.max_send
    for label, plan in (("cache full", (0, S)), ("cache (0, 0)", (0, 0)),
                        ("cache cv chunk", (0, S // 3))):
        fwd = eng._cached_fwd(*plan)
        out["eval_ms"][label] = host_ms(
            lambda: fwd(params, eng.shards, eng._halo_state))
    for codec in ("int8", "fp16"):
        eng, _ = mesh_engine(pg, "spmd", halo_compress=codec)
        out["eval_ms"][codec] = host_ms(lambda: eng._fwd_comp(
            params, eng.shards, eng._halo_residual))
    eng, _ = mesh_engine(pg, "spmd", overlap_halo=True)
    out["eval_ms"]["overlap"] = host_ms(lambda: eng.fwd(params, eng.shards))
    agg_i = make_kernel_split_agg(pg.own_cap)[0]
    out["exchange_ms"], out["interior_device_ms"] = {}, {}
    for d in (64, 128):
        sent = torch.randn(P, pg.send_idx.shape[-1], d, device=eng.device)
        out["exchange_ms"][d] = host_ms(
            lambda: exchange_start(sent, eng.mesh).wait())
        h = torch.randn(pg.max_nodes, d, device=eng.device)
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
        agg_i(h, eng.shards)
        for a, b in evs:
            a.record()
            agg_i(h, eng.shards)
            b.record()
        torch.cuda.synchronize()
        out["interior_device_ms"][d] = float(np.median(
            [a.elapsed_time(b) for a, b in evs]))
    out["phase0_s"] = {}
    for mode in ("none", "bucketed", "topk"):
        e, opt = mesh_engine(pg, "spmd", grad_compress=mode)
        out["phase0_s"][mode] = random_phase0_epochs(torch, e, opt, P)[2]
    return out


def mesh_part3_rank(torch, sa, P, ckdir):
    """Item 14's part 3 on one rank: the pipeline runs of
    ``MESH_PART3_RUNS`` (the main path: the segment launches counted from
    0 just before them and read just after, the overlapped run's apart),
    the resumed run, the eval checks, the overlapped full-graph gradients
    and the times."""
    from repro_torch.pipeline import run_eat_distgnn
    from repro_torch.robustness import FaultPlan, InjectedCrash

    _, pg, _ = mesh_graph(P)
    eng, _ = mesh_engine(pg, "spmd")
    out = {"pipelines": {}}
    t0 = time.perf_counter()
    counts = {}
    for name in MESH_PART3_RUNS:
        sa.reset_kernel_launch_count()
        res = run_eat_distgnn(mesh_part3_config(P, "spmd", name))
        torch.cuda.synchronize()
        counts[name] = (sa.kernel_launch_count(),
                        sa.bwd_kernel_launch_count())
        out["pipelines"][name] = mesh_digest(res, eng)
    name, crash = MESH_PART3_RESUME
    ck = os.path.join(ckdir, "part3")
    try:
        run_eat_distgnn(mesh_part3_config(P, "spmd", name,
                                          checkpoint_dir=ck),
                        fault_plan=FaultPlan(crash_epochs=frozenset({crash})))
        raise AssertionError(f"mesh {name}: no crash at {crash}")
    except InjectedCrash as e:
        assert e.epoch == crash, (name, e.epoch)
    out["resumed"] = mesh_digest(run_eat_distgnn(mesh_part3_config(
        P, "spmd", name, checkpoint_dir=ck, resume=True)), eng)
    out["wall"] = time.perf_counter() - t0
    ov = counts.pop(MESH_PART3_OVERLAP_RUN)
    out["launches"] = tuple(sum(c[i] for c in counts.values())
                            for i in (0, 1))
    out["rows_launches"] = ov
    out["evals"] = mesh_part3_evals(torch, pg, "spmd")
    out["fg_grads"] = mesh_overlap_grads(torch, pg, "spmd")
    out["reducer_grads"] = mesh_reducer_grads(torch, pg, P, "spmd")
    out["part_grads"] = mesh_partition_grads(torch, pg, P, "spmd")
    out["times"] = mesh_part3_times(torch, pg, P)
    return out


def mesh_part3_config(P, mode, name, **kw):
    """The part-3 run ``name``: 4 epochs unless its entry says otherwise."""
    return mesh_config(P, mode,
                       **{"max_epochs": 4, **MESH_PART3_RUNS[name], **kw})


def mesh_part3_stacked(torch, P):
    """The stacked engine's side of item 14's part 3, in this process."""
    from repro_torch.pipeline import run_eat_distgnn

    _, pg, _ = mesh_graph(P)
    eng, _ = mesh_engine(pg, "stacked")
    out = {"pipelines": {k: mesh_digest(run_eat_distgnn(
        mesh_part3_config(P, "stacked", k)), eng) for k in MESH_PART3_RUNS}}
    out["evals"] = mesh_part3_evals(torch, pg, "stacked")
    out["fg_grads"] = mesh_overlap_grads(torch, pg, "stacked")
    out["reducer_grads"] = mesh_reducer_grads(torch, pg, P, "stacked")
    out["part_grads"] = mesh_partition_grads(torch, pg, P, "stacked")
    return out


def mesh_oracle_drift(torch, stacked):
    """The sequential oracle's final params after each run of
    ``MESH_ORACLE_RUNS`` (P = 4, 4 epochs, on the card) against the stacked
    engine's (``stacked``: run -> its params): the max |diff|, run ->
    drift."""
    from repro_torch.pipeline import run_eat_distgnn

    out = {}
    for k in MESH_ORACLE_RUNS:
        t0 = time.perf_counter()
        res = run_eat_distgnn(mesh_part3_config(4, "sequential", k))
        assert res.engine_mode == "sequential", res.engine_mode
        out[k] = max(float((a.detach().cpu() - b).abs().max()) for a, b in
                     zip(res.final_params.parameters(), stacked[k],
                         strict=True))
        log(f"mesh oracle {k}: the sequential oracle's 4-epoch params "
            f"against the stacked engine's, max |diff| {out[k]:.3e} "
            f"({time.perf_counter() - t0:.1f} s)")
    return out


def mesh_part3_checks(torch, P, outs, want, label, bitwise, card,
                      oracle=None):
    """Item 14's part 3 within one world (the ranks' ``outs``, the stacked
    ``want``): every eval bitwise the stacked engine's (each rank's logits
    its rows of the stacked logits, the cache and residual digests, the
    exchange bytes) with no collective under a (0, 0) plan; the overlapped
    full-graph gradients and each reducer's first reduced gradient within
    rel 1e-6; the pipelines within the spmd tolerances (losses, val
    micro-F1, test predictions and micro-F1; params where the tolerances
    are defined, ``MESH_PART3_RUNS``), bitwise in the world of 1, every
    byte counter equal to the stacked run's; the resumed run bitwise its
    uninterrupted run; every rank's pipelines equal.  Logs what it found,
    and the part's times, before it asserts."""
    got = [o["part3"] for o in outs]
    evals_bad = []
    for name, wsteps in want["evals"].items():
        for r, g in enumerate(got):
            for i, (gs, ws) in enumerate(zip(g["evals"][name], wsteps,
                                             strict=True)):
                empty = name == "cache-k2-int8" and i == 1
                ok = (torch.equal(gs["logits"], ws["logits"][r])
                      and gs["cache"] == ws["cache"]
                      and gs["res"] == ws["res"]
                      and gs["bytes"] == ws["bytes"]
                      and (gs["collectives"] == 0 if empty
                           else P == 1 or gs["collectives"] > 0))
                if not ok:
                    evals_bad.append((name, r, i, float(
                        (gs["logits"] - ws["logits"][r]).abs().max())))
    rel = lambda a, b: max(float((x - y).abs().max() / y.abs().max())
                           for x, y in zip(a, b, strict=True))
    # which runs' params are held, and to what: the phase-0 and 1 + 1 runs
    # to the reference's tolerances, the 4-epoch runs to a multiple of the
    # oracle's drift (``oracle``: run -> drift)
    held = {k: MESH_P0_TOL if k.startswith("phase-0") else MESH_P1_TOL
            for k in want["pipelines"]
            if k.startswith("phase-0") or k.endswith("-1+1")}
    if oracle:
        held.update({k: MESH_ORACLE_MULT * oracle.get(
            k, max(oracle.values())) for k in want["pipelines"]
            if k not in held})
    grel = rel(got[0]["fg_grads"], want["fg_grads"])
    rgrel = {k: rel(got[0]["reducer_grads"][k], want["reducer_grads"][k])
             for k in want["reducer_grads"]}
    # each rank's own gradient against its row of the stacked call and
    # against its partition alone on a partition axis of 1
    pg_want = want["part_grads"]
    part_rel = max(rel([x[0] for x in g["part_grads"]["own"]],
                       [x[r] for x in pg_want["rows"]])
                   for r, g in enumerate(got))
    part_alone = all(all(torch.equal(x, y) for x, y in zip(
        g["part_grads"]["own"], pg_want["alone"][r], strict=True))
        for r, g in enumerate(got))
    found, ranks_bad = {}, []
    for k, wp in want["pipelines"].items():
        gp = got[0]["pipelines"][k]
        for r, g in enumerate(got):
            d = g["pipelines"][k]
            if not (all(torch.equal(a, b) for a, b in
                        zip(d["params"], gp["params"]))
                    and d["bytes"] == gp["bytes"]):
                ranks_bad.append((r, k))
        n0 = len(gp["iters"])
        dl = np.abs(gp["loss"] - wp["loss"])
        pd = [float((a - b).abs().max()) for a, b in
              zip(gp["params"], wp["params"], strict=True)]
        worst = int(np.argmax(pd))
        found[k] = {
            "iters": gp["iters"] == wp["iters"],
            "bytes": gp["bytes"] == wp["bytes"],
            "loss0": float(dl[:n0].max()),
            "loss1": float(dl[n0:].max()) if dl[n0:].size else 0.0,
            "params": pd[worst], "params_held": held.get(k),
            # the tensor with the largest |diff|, and its largest |w|
            "params_at": (worst, float(wp["params"][worst].abs().max())),
            "val": float(np.abs(gp["val"] - wp["val"]).max()),
            "preds_apart": int((gp["test_preds"] != wp["test_preds"]).sum()),
            "micro": (gp["micro"], wp["micro"])}
    name, crash = MESH_PART3_RESUME
    d, base = got[0]["resumed"], got[0]["pipelines"][name]
    resumed_ok = (d["resumed_from"] == crash
                  and all(np.array_equal(d[k], base[k]) for k in
                          ("loss", "val", "micro", "iters", "bytes", "epochs"))
                  and all(torch.equal(a, b) for a, b in
                          zip(d["params"], base["params"]))
                  and torch.equal(d["test_preds"], base["test_preds"]))
    log(f"mesh {label} part 3: {len(want['evals'])} eval cases x 3 against "
        f"the stacked engine (logits, cache, residual, bytes; no collective "
        f"under the (0, 0) plan), mismatches {evals_bad}; overlapped "
        f"full-graph gradients rel {grel:.3e}; the first reduced gradient "
        f"of a random-batch phase-0 epoch rel {json.dumps(rgrel)}; each "
        f"rank's own unreduced gradient against its row of the stacked "
        f"call rel {part_rel:.3e}, bitwise its partition alone on a "
        f"partition axis of 1 {part_alone}; "
        f"pipelines vs stacked {json.dumps(found)}, byte counters "
        f"{ {k: v['bytes'] for k, v in want['pipelines'].items()} }; ranks "
        f"apart {ranks_bad}; {name} killed after boundary {crash} and "
        f"resumed bitwise {resumed_ok}; launches per rank (fwd, bwd): "
        f"whole-space {[g['launches'] for g in got]}, row-range "
        f"{[g['rows_launches'] for g in got]}; pipeline wall per rank "
        f"{[round(g['wall'], 2) for g in got]} s")
    times = [g["times"] for g in got]
    slow = lambda key: {k: round(max(t[key][k] for t in times), 3)
                        for k in times[0][key]}
    log(f"{card}: mesh {label} part 3 (host clock, synchronised, slowest "
        f"rank): eval forward ms {json.dumps(slow('eval_ms'))}; one "
        f"started-and-waited exchange ms {json.dumps(slow('exchange_ms'))} "
        f"beside the interior half's device ms "
        f"{json.dumps(slow('interior_device_ms'))}; a 3-iteration phase-0 "
        f"epoch by reducer ms "
        f"{ {k: [round(x * 1e3, 2) for x in v] for k, v in times[0]['phase0_s'].items()} }")
    assert not evals_bad, (label, evals_bad)
    assert not ranks_bad, (label, ranks_bad)
    assert resumed_ok, (label, name)
    limit = 0 if bitwise else MESH_GRAD_RTOL
    assert grel <= limit, (label, grel)
    assert all(v <= limit for v in rgrel.values()), (label, rgrel)
    assert part_alone and part_rel <= limit, (label, part_rel)
    for k, f in found.items():
        assert f["iters"] and f["bytes"], (label, k, f)
        if bitwise:
            assert (f["loss0"] == f["loss1"] == f["params"] == f["val"]
                    == f["preds_apart"] == 0), (label, k, f)
            continue
        assert f["loss0"] <= MESH_P0_TOL and f["loss1"] <= MESH_P1_TOL, (
            label, k, f)
        if k in held:
            assert f["params"] <= held[k], (label, k, f)
        assert f["val"] <= MESH_F1_TOL, (label, k, f)
        assert f["preds_apart"] <= MESH_PRED_MISMATCH, (label, k, f)
    return (sum(g["launches"][0] for g in got),
            sum(g["launches"][1] for g in got),
            sum(g["rows_launches"][0] for g in got),
            sum(g["rows_launches"][1] for g in got))


def mesh_checks(torch, card):
    """ROADMAP item 14 at products-s, hidden 128, float32, with the
    kernels: an NCCL world of 1 at P = 1 bitwise the stacked P = 1 runs
    (the async one too), a gloo world of 4 ranks sharing this card within
    the reference's spmd tolerances of the stacked runs (the export's
    logits bitwise, a full-graph step's gradients within rel 1e-6,
    ``ring_chunks=2`` bitwise 0), the same on an NCCL world of 4 where
    there are 4 cards; in each world the store runs and the resumes
    (``mesh_part2_checks``) and the communication options
    (``mesh_part3_checks``); every rank's result equal to rank 0's.
    Returns the segment kernels' single-partition launches the ranks' runs
    reported: ``(fwd, bwd)`` of the whole-space use, then of the
    row-range use."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_partition_world

    t_mesh = time.perf_counter()
    # (whole-space fwd, bwd, row-range fwd, bwd) single-partition launches
    launches = [0, 0, 0, 0]

    def world(P, backend):
        t0 = time.perf_counter()
        ckdir = tempfile.mkdtemp(prefix="mesh_ckpt_")
        try:
            outs = spawn_partition_world(mesh_rank, P, (P, ckdir),
                                         backend=backend, device="cuda",
                                         join_timeout_s=600)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        for r, o in enumerate(outs):
            for group in ("pipelines", "store", "resumed"):
                for k, d in o[group].items():
                    d0 = outs[0][group][k]
                    assert all(torch.equal(a, b) for a, b in
                               zip(d["params"], d0["params"])), (r, k)
                    assert np.array_equal(d["loss"], d0["loss"]), (r, k)
                    assert torch.equal(d["test_preds"],
                                       d0["test_preds"]), (r, k)
                    assert (d["bytes"], d["cold"], d["resumed_from"]) == (
                        d0["bytes"], d0["cold"], d0["resumed_from"]), (r, k)
            assert torch.equal(o["logits"], outs[0]["logits"]), r
            launches[0] += o["launches"][0]
            launches[1] += o["launches"][1]
        log(f"mesh {backend} world {P}: {time.perf_counter() - t0:.1f} s "
            f"(spawn, build, checks); pipeline wall per rank "
            f"{[round(o['wall'], 2) for o in outs]} s, launches per rank "
            f"(fwd, bwd) {[o['launches'] for o in outs]}; single-partition "
            f"segment forward launches per rank "
            f"{[o['launches'][0] for o in outs]}")
        return outs

    def part2_times(label, got, want):
        save, load = got["ckpt_ms"]
        log(f"{card}: mesh {label}: async epoch calls (host clock, "
            f"synchronised, slowest rank) phase 0 "
            f"{[round(x * 1e3, 2) for x in got['async_s']['phase0']]} ms, "
            f"phase 1 {[round(x * 1e3, 2) for x in got['async_s']['phase1']]}"
            f" ms against stacked "
            f"{[round(x * 1e3, 2) for x in want['async_s']['phase0']]} / "
            f"{[round(x * 1e3, 2) for x in want['async_s']['phase1']]} ms; "
            f"rank 0's checkpoint save ms median "
            f"{float(np.median(save)):.2f} of {len(save)}, load ms median "
            f"{float(np.median(load)):.2f} of {len(load)}")

    def part3(P, outs, want, label, bitwise, oracle=None):
        counts = mesh_part3_checks(torch, P, outs, want["part3"], label,
                                   bitwise, card, oracle)
        for i, n in enumerate(counts):
            launches[i] += n

    w1 = world(1, "nccl")
    s1 = mesh_stacked(torch, 1)
    mesh_compare(torch, w1[0], s1, "nccl world 1", bitwise=True)
    mesh_part2_checks(torch, 1, w1[0], "nccl world 1")
    part2_times("nccl world 1", w1[0], s1)
    part3(1, w1, s1, "nccl world 1", bitwise=True)
    w4 = world(4, "gloo")
    s4 = mesh_stacked(torch, 4)
    mesh_compare(torch, w4[0], s4, "gloo world 4 on one card", bitwise=False)
    mesh_part2_checks(torch, 4, w4[0], "gloo world 4 on one card")
    part2_times("gloo world 4, 4 processes sharing one card (not a "
                "multi-card time)", w4[0], s4)
    oracle = mesh_oracle_drift(torch, {
        k: s4["part3"]["pipelines"][k]["params"] for k in MESH_ORACLE_RUNS})
    part3(4, w4, s4, "gloo world 4, 4 processes sharing one card (not a "
          "multi-card time)", bitwise=False, oracle=oracle)
    if torch.cuda.device_count() >= 4:
        n4 = world(4, "nccl")
        mesh_compare(torch, n4[0], s4, "nccl world 4", bitwise=False)
        mesh_part2_checks(torch, 4, n4[0], "nccl world 4")
        part2_times("nccl world 4", n4[0], s4)
        part3(4, n4, s4, "nccl world 4 (multi-card)", bitwise=False,
              oracle=oracle)
    else:
        log(f"mesh nccl world 4: not run, {torch.cuda.device_count()} card")
    log(f"{card}: 4 processes sharing one card through gloo (not a "
        f"multi-card time): a sampled phase-0 epoch (3 iterations of 256, "
        f"host clock, synchronised, slowest rank) "
        f"{[round(x * 1e3, 2) for x in w4[0]['phase0_s']]} ms against "
        f"stacked {[round(x * 1e3, 2) for x in s4['phase0_s']]} ms; the "
        f"sampled pipeline's phase-0 epoch "
        f"{w4[0]['pipelines']['sampled']['epoch_s'] * 1e3:.2f} vs "
        f"{s4['pipelines']['sampled']['epoch_s'] * 1e3:.2f} ms, the "
        f"full-graph one's "
        f"{w4[0]['pipelines']['full-graph']['epoch_s'] * 1e3:.2f} vs "
        f"{s4['pipelines']['full-graph']['epoch_s'] * 1e3:.2f} ms; one "
        f"exchange (ms, per rank) at "
        f"D=64 {[round(o['exchange_ms'][64], 3) for o in w4]}, D=128 "
        f"{[round(o['exchange_ms'][128], 3) for o in w4]}; NCCL world of 1 "
        f"phase-0 epoch {[round(x * 1e3, 2) for x in w1[0]['phase0_s']]} ms")
    log(f"mesh checks: {time.perf_counter() - t_mesh:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 6 helpers
# --------------------------------------------------------------------------

def profile_window(torch, label, fn, steps):
    """Print the device's busy share and top kernels over ``fn()``
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in tp.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in cuda)
    log(f"profile {label}: wall {wall / steps * 1e3:.3f} ms/step, device "
        f"busy {busy_us / steps / 1e3:.3f} ms/step = "
        f"{busy_us / 1e6 / wall:.3f} of wall")
    for e in sorted(cuda, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile {label} kernel {e.self_device_time_total / steps:10.1f} "
            f"us/step x{e.count / steps:6.1f}  {e.key[:90]}")
    return cuda


def serving_digest(logits, tokens) -> dict:
    """SHA-256 of the prefill logits' bytes and of the tokens' (int32), to
    hold two trees' serving outputs bitwise."""
    import hashlib

    raw = logits.contiguous().cpu().numpy().tobytes()
    return {"prefill_logits": hashlib.sha256(raw).hexdigest(),
            "tokens": hashlib.sha256(np.asarray(tokens, np.int32)
                                     .tobytes()).hexdigest()}


def llm_phase(torch, fa, rn):
    """qwen2-0.5b at full width through ``llm_main`` with every launch count
    set to 0 just before and read just after; then the kernels against
    their plain versions on the same weights (bf16: logits and greedy
    tokens; f32: prefill and 8 teacher-forced decode steps, asserted), and a
    profile of one prefill and 16 decode steps."""
    import dataclasses

    from repro_torch.kernels import reset_kernel_launch_count
    from repro_torch.launch.serve import build_parser, llm_main
    from repro_torch.models import Transformer
    from repro_torch.serve import ServeEngine

    reset_kernel_launch_count()
    fa.reset_flash_launch_count()
    rn.reset_rmsnorm_launch_count()
    t0 = time.perf_counter()
    run = llm_main(build_parser().parse_args(LLM_ARGS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_flash = {d: fa.flash_launch_count(d) for d in ("prefill", "decode")}
    n_fused = rn.add_rmsnorm_launch_count()
    n_rms = {"rmsnorm": rn.rmsnorm_launch_count() - n_fused,
             "add_rmsnorm": n_fused}
    assert all(n_flash.values()), f"a flash design never launched: {n_flash}"
    assert all(n_rms.values()), f"an RMSNorm entry point never ran: {n_rms}"
    cfg, model, batch, toks = (run["cfg"], run["model"], run["batch"],
                               run["tokens"])
    n_layers = cfg.num_layers
    # flash attention, RMSNorm (both entry points), of which the fused add:
    # every norm but the first layer's takes in the add before it
    per_pass = (n_layers, 2 * n_layers + 1, 2 * n_layers)
    assert run["launches"]["prefill"] == per_pass, run["launches"]["prefill"]
    assert len(run["launches"]["decode"]) == toks.shape[1] - 1
    assert all(n == per_pass for n in run["launches"]["decode"]), \
        run["launches"]["decode"]
    assert toks.shape == (4, 64) and ((toks >= 0) & (toks < cfg.vocab_size)).all()
    stats = {k: run[k] for k in ("prefill_ms", "decode_ms_p50",
                                 "decode_ms_p99", "tokens_per_s", "wall_s")}
    log(f"llm serve {cfg.name} full width, {model.param_count()} params: "
        f"{json.dumps(stats)}; launches per prefill and per decode step "
        f"(flash, rmsnorm, of which fused add) {per_pass}; this run's totals "
        f"flash {n_flash} rmsnorm {n_rms}; main path {wall:.1f} s")

    # bf16, same weights: logits and greedy tokens, kernels vs plain
    width = run["engine"].cache_size
    lk, _, _ = model.prefill(batch, cache_size=width)
    model.use_kernels = False
    lp, _, _ = model.prefill(batch, cache_size=width)
    plain_toks = ServeEngine(model, cache_size=width).generate(
        batch, max_new_tokens=toks.shape[1])
    model.use_kernels = True
    assert torch.isfinite(lk).all()
    log(f"llm serving digest (SHA-256 of the bf16 prefill logits, of the "
        f"greedy tokens): {json.dumps(serving_digest(lk, toks))}")
    same = plain_toks == toks
    first_diff = [int(np.argmin(r)) if not r.all() else len(r) for r in same]
    log(f"llm bf16 kernels vs plain: prefill logits max |diff| "
        f"{float((lk - lp).abs().max()):.4e} (max |logit| "
        f"{float(lp.abs().max()):.3f}); greedy tokens equal "
        f"{float(same.mean()):.4f} of {same.size}, first difference per row "
        f"{first_diff}")

    # f32 variant of the full config, same seed: asserted within tolerance
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = Transformer(cfg32, seed=0, device=model.device)
    forced = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8))
    outs = {}
    for use_kernels in (True, False):
        m32.use_kernels = use_kernels
        lg, caches, n = m32.prefill(batch, cache_size=width)
        seq = [lg]
        for t in range(forced.shape[1]):
            lg, caches = m32.decode_step(forced[:, t:t + 1], caches, n + t)
            seq.append(lg)
        outs[use_kernels] = seq
        del caches
    errs = [float((a - b).abs().max()) for a, b in zip(outs[True], outs[False])]
    log(f"llm f32 kernels vs plain: max |diff| prefill {errs[0]:.3e}, decode "
        f"steps {[f'{e:.3e}' for e in errs[1:]]} (atol {LLM_F32_ATOL}, rtol "
        f"{LLM_F32_RTOL}); max |logit| {float(outs[False][0].abs().max()):.3f}")
    for a, b in zip(outs[True], outs[False]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=LLM_F32_ATOL, rtol=LLM_F32_RTOL)
    # the greedy token of every step: in f32 the kernels' few-ulp sums must
    # not flip one (in bf16 a one-ulp norm flips near-ties, reported above)
    greedy = [torch.equal(a.argmax(-1), b.argmax(-1))
              for a, b in zip(outs[True], outs[False])]
    log(f"llm f32 greedy tokens of the prefill and 8 decode steps equal: "
        f"{greedy}")
    assert all(greedy), greedy
    del m32, outs

    # where the time goes: one prefill, then 16 decode steps
    state = {}

    def prefill():
        state["lg"], state["caches"], state["n"] = model.prefill(
            batch, cache_size=width)

    def decode16():
        lg, caches, n = state["lg"], state["caches"], state["n"]
        for t in range(16):
            lg, caches = model.decode_step(lg.argmax(-1)[:, None], caches,
                                           n + t)

    for label, fn, steps in (("llm prefill", prefill, 1),
                             ("llm decode", decode16, 16)):
        cuda = profile_window(torch, label, fn, steps)
        # torch's elementwise adds (tensor + tensor): the residual adds are
        # fused into the norms, what stays is RoPE's and the QKV bias's
        adds = [e for e in cuda if "CUDAFunctor_add" in e.key]
        log(f"profile {label}: {sum(e.count for e in cuda) / steps:.1f} "
            f"kernel launches a step, of which elementwise adds "
            f"{sum(e.count for e in adds) / steps:.1f} "
            f"({sum(e.self_device_time_total for e in adds) / steps:.1f} us)")
    return n_flash, n_rms


# the rest of the zoo at full width (ROADMAP items 15.2-15.6), bf16, seed
# 0: (label, arch, entry point, config overrides (the depth cuts), batch,
# prompt, new tokens, launches per prefill and per decode step, each (flash,
# rmsnorm, of which fused)); "cli" runs launch.serve's llm_main (starcoder2
# with --swa: a prompt past the 4,096 window, so the prefill fills the
# rolling cache through the gather and the decode wraps it; whisper-small at
# its published decoder context of 448 tokens, 384 + 64; paligemma-3b's 256
# patch embeddings before a 256-token prompt), "engine" a ServeEngine over
# the cut config (the reference's CLI has no depth flag).  Whisper's
# prefill launches the encoder's 12 bidirectional self-attentions, the
# decoder's 12 causal ones and 12 cross-attentions, its decode step 12 + 12
# in the decode design; its layernorm is plain PyTorch
ZOO_RUNS = [
    ("starcoder2-7b --swa", "starcoder2-7b", "cli", {}, 4, 4608, 64,
     ((32, 0, 0), (32, 0, 0))),
    ("mamba2-370m", "mamba2-370m", "cli", {}, 4, 2048, 64,
     ((0, 49, 48), (0, 49, 48))),
    ("phi3.5-moe depth 8 of 32", "phi3.5-moe-42b-a6.6b", "engine",
     {"num_repeats": 8}, 4, 2048, 64, ((8, 0, 0), (8, 0, 0))),
    ("jamba depth 1 of 4 super-blocks", "jamba-v0.1-52b", "engine",
     {"num_repeats": 1}, 4, 2048, 32, ((1, 17, 16), (1, 17, 16))),
    ("whisper-small", "whisper-small", "cli", {}, 4, 384, 64,
     ((36, 0, 0), (24, 0, 0))),
    ("paligemma-3b", "paligemma-3b", "cli", {}, 4, 256, 64,
     ((18, 37, 36), (18, 37, 36))),
]
# the runs whose attention is flash's Dh 256 instantiations (the kernels
# line lists their launches apart)
ZOO_DH256 = ("paligemma-3b",)
# the f32 variant of each, kernels against plain versions on the same
# weights, cut further to fit beside the plain attention's dense f32 scores:
# (overrides, batch rows); starcoder2 4 of 32 layers at batch 2 (its plain
# prefill holds 4 x 36 x 4,608^2 f32 scores a row pair, 12 GB at batch 4),
# phi3.5-moe 2 layers, jamba its first 4 sub-layers (attention + MLP,
# Mamba2 + MoE, Mamba2 + MLP, Mamba2 + MoE), mamba2-370m whole
ZOO_F32 = {"starcoder2-7b": ({"num_repeats": 4}, 2),
           "mamba2-370m": ({}, 4),
           "phi3.5-moe-42b-a6.6b": ({"num_repeats": 2}, 4),
           "jamba-v0.1-52b": ({"num_repeats": 1, "sub_layers": 4}, 4),
           "whisper-small": ({}, 4),
           "paligemma-3b": ({}, 4)}
# the zoo's f32 runs, kernels against plain versions: as LLM_F32_*, every
# GEMM and every plain op (Mamba2's scan, the MoE experts, layernorm) is the
# same call on both sides, the difference the attention's and the RMSNorms'
# summation order, carried through up to 48 residual layers into logits of
# magnitude ~1-10; a wrong slot, mask or row moves logits by O(0.1).  A
# near-tied MoE route can flip between the two sides (their attention sums
# differ by a few ulps) and move a row's logits by O(0.1) just as well: so
# the logits and greedy tokens are held on the batch rows whose routes all
# agree (expert and capacity keep of every token of the row, in every MoE
# call of the prefill and of the decode steps up to that one; tokens of
# other rows meet a row only through capacity, which the keep flags show),
# and the flipped routes are counted and printed
ZOO_F32_ATOL, ZOO_F32_RTOL = 1e-4, 1e-4


class RouteLog:
    """Records every MoE routing call (``models.layers.moe_route``) made
    inside the block: each call's ``(top_i (T, K), keep (T, K))`` on the
    host, in call order."""

    def __enter__(self):
        from repro_torch.models import layers

        self.mod, self.inner, self.calls = layers, layers.moe_route, []

        def route(p, xf, cfg):
            out = self.inner(p, xf, cfg)
            self.calls.append((out[2].cpu(), out[4].cpu().reshape(
                out[2].shape)))
            return out

        layers.moe_route = route
        return self

    def __exit__(self, *exc):
        self.mod.moe_route = self.inner


def zoo_config(arch, overrides, dtype="bfloat16"):
    """``arch``'s published config with the depth cuts of ``overrides``
    (``sub_layers``: the first n sub-layers of its super-block)."""
    import dataclasses

    from repro_torch.configs import get_config

    kw = dict(overrides)
    cfg = get_config(arch)
    if "sub_layers" in kw:
        kw["super_block"] = cfg.super_block[:kw.pop("sub_layers")]
    return dataclasses.replace(cfg, dtype=dtype, **kw)


def held_rows(kern_calls, plain_calls, n_moe, s, b, steps):
    """The batch rows whose MoE routes agree between the two sides' calls
    (``n_moe`` a pass: the prefill's over ``b`` rows of ``s`` tokens, then
    ``steps`` decode steps' over one token a row), after the prefill and
    after each decode step (``steps + 1`` boolean arrays), and the number
    of flipped (token, layer) routes."""
    assert len(kern_calls) == len(plain_calls) == n_moe * (steps + 1)
    ok, held, flips = np.ones(b, bool), [], 0
    for step in range(steps + 1):
        for c in range(step * n_moe, (step + 1) * n_moe):
            (ik, kk), (ip, kp) = kern_calls[c], plain_calls[c]
            bad = ((ik != ip) | (kk != kp)).any(1).numpy()
            flips += int(bad.sum())
            ok[np.arange(bad.size)[bad] // (s if step == 0 else 1)] = False
        held.append(ok.copy())
    return held, flips


def zoo_f32_check(torch, label, arch, batch, rolling, steps=8):
    """The f32 variant of ``arch`` cut by ``ZOO_F32``, kernels against
    plain versions on the same weights: prefill logits, ``steps``
    teacher-forced decode steps (rolling where the run rolls) and each
    step's greedy token, on the rows whose routes agree (``held_rows``)."""
    from repro_torch.models import Transformer

    overrides, rows = ZOO_F32[arch]
    cfg = zoo_config(arch, overrides, "float32")
    inputs = {k: np.asarray(v)[:rows] for k, v in batch.items()}
    b, s = inputs["tokens"].shape
    width = (cfg.sliding_window if rolling
             else cfg.prefix_tokens + s + steps + 4)
    model = Transformer(cfg, seed=0, device="cuda")
    forced = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, steps))
    outs, calls = {}, {}
    for use in (True, False):
        model.use_kernels = use
        with RouteLog() as rl:
            lg, caches, n = model.prefill(inputs, cache_size=width)
            seq = [lg]
            for t in range(steps):
                lg, caches = model.decode_step(forced[:, t:t + 1], caches,
                                               n + t, rolling=rolling)
                seq.append(lg)
        outs[use], calls[use] = seq, rl.calls
        del caches
    n_moe = sum(layer.ffn == "moe" for layer in model.layers)
    held, flips = held_rows(calls[True], calls[False], n_moe, s, b, steps)
    errs, greedy = [], []
    for a, w, h in zip(outs[True], outs[False], held):
        assert torch.isfinite(a).all(), label
        hm = torch.as_tensor(h, device=a.device)
        errs.append(float((a[hm] - w[hm]).abs().max()) if h.any() else 0.0)
        greedy.append(torch.equal(a[hm].argmax(-1), w[hm].argmax(-1)))
    log(f"zoo f32 {label} ({cfg.num_layers} layers, batch {b}, prompt {s}"
        f"{', rolling ' + str(width) if rolling else ''}) kernels vs plain: "
        f"max |diff| on held rows prefill {errs[0]:.3e}, decode steps "
        f"{[f'{e:.3e}' for e in errs[1:]]} (atol {ZOO_F32_ATOL}, rtol "
        f"{ZOO_F32_RTOL}); max |logit| "
        f"{float(outs[False][0].abs().max()):.3f}; MoE routes flipped "
        f"{flips} of {sum(c[0].shape[0] for c in calls[True])} (token, "
        f"layer) pairs; rows held per step {[int(h.sum()) for h in held]} "
        f"of {b}; greedy tokens equal {greedy}")
    assert held[0].any(), f"{label}: no row's routes agree"
    for a, w, h in zip(outs[True], outs[False], held):
        hm = torch.as_tensor(h, device=a.device)
        torch.testing.assert_close(a[hm], w[hm], atol=ZOO_F32_ATOL,
                                   rtol=ZOO_F32_RTOL)
    assert all(greedy), (label, greedy)
    del model, outs
    torch.cuda.empty_cache()


def zoo_phase(torch, fa, rn, card):
    """The rest of the zoo served at full width (``ZOO_RUNS``), each with
    every launch count set to 0 just before its run and read just after:
    prefill ms, decode p50/p99 per step, tokens/s, peak memory and launches
    per prefill and per decode step (asserted), the tokens dropped by
    capacity in a prefill where MoE routes; then each one's f32 variant
    kernels against plain (``zoo_f32_check``).  Returns the runs' launches:
    flash by design and RMSNorm by entry point, and apart from them the
    flash launches of the ``ZOO_DH256`` runs (``"prefill_dh256"``,
    ``"decode_dh256"``)."""
    from repro_torch.launch.serve import build_parser, llm_main, serve_model
    from repro_torch.models import Transformer

    totals = {"prefill": 0, "decode": 0, "rmsnorm": 0, "add_rmsnorm": 0,
              "prefill_dh256": 0, "decode_dh256": 0}
    t_zoo = time.perf_counter()
    for label, arch, how, overrides, b, s, new, (pre, dec) in ZOO_RUNS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        if how == "cli":
            run = llm_main(build_parser().parse_args(
                ["--arch", arch, "--full", "--batch", str(b),
                 "--prompt-len", str(s), "--new-tokens", str(new), "--seed",
                 "0", "--device", "cuda"]
                + (["--swa"] if "--swa" in label else [])))
            model, batch = run["model"], run["batch"]
        else:
            model = Transformer(zoo_config(arch, overrides), seed=0,
                                device="cuda")
            batch = {"tokens": np.random.default_rng(0).integers(
                0, model.cfg.vocab_size, (b, s))}
            run = serve_model(model, batch, new_tokens=new,
                              cache_size=s + new + 4,
                              label=f"{label}, full width on cuda")
        torch.cuda.synchronize()
        n_flash = {d: fa.flash_launch_count(d) for d in ("prefill",
                                                          "decode")}
        n_fused = rn.add_rmsnorm_launch_count()
        n_rms = rn.rmsnorm_launch_count() - n_fused
        peak = torch.cuda.max_memory_allocated()
        cfg, toks, engine = model.cfg, run["tokens"], run["engine"]
        rolling = engine.rolling
        assert toks.shape == (b, new) and ((toks >= 0)
                                           & (toks < cfg.vocab_size)).all()
        assert rolling == ("--swa" in label), (label, rolling)
        assert run["launches"]["prefill"] == pre, (
            label, run["launches"]["prefill"])
        assert all(n == dec for n in run["launches"]["decode"]), (
            label, run["launches"]["decode"])
        # the warm-up generation (a prefill and one decode step) and the
        # timed one (a prefill and new - 1 steps): new decode steps, every
        # attention layer's prefill in the prefill design and every decode
        # step's in the split-KV decode design
        assert n_flash == {"prefill": 2 * pre[0], "decode": new * dec[0]}, (
            label, n_flash)
        assert (n_rms + n_fused, n_fused) == (
            2 * pre[1] + new * dec[1], 2 * pre[2] + new * dec[2]), (
            label, n_rms, n_fused)
        dh256 = "_dh256" if arch in ZOO_DH256 else ""
        for k, n in (("prefill" + dh256, n_flash["prefill"]),
                     ("decode" + dh256, n_flash["decode"]),
                     ("rmsnorm", n_rms), ("add_rmsnorm", n_fused)):
            totals[k] += n
        dropped = ""
        if any(layer.ffn == "moe" for layer in model.layers):
            with RouteLog() as rl:
                model.prefill(batch, cache_size=engine.cache_size)
            drops = [int((~keep).sum()) for _, keep in rl.calls]
            dropped = (f"; a prefill's (token, choice) pairs dropped by "
                       f"capacity per MoE layer {drops} of "
                       f"{rl.calls[0][0].numel()}")
        stats = {k: run[k] for k in ("prefill_ms", "decode_ms_p50",
                                     "decode_ms_p99", "tokens_per_s",
                                     "wall_s")}
        log(f"{card}: zoo serve {label}: {cfg.name}, {cfg.num_layers} "
            f"layers, {model.param_count()} params, batch {b}, prompt {s}, "
            f"{new} new tokens{', rolling cache ' + str(engine.cache_size) if rolling else ''}: "
            f"{json.dumps(stats)}; max_memory_allocated "
            f"{peak / 2**30:.2f} GiB; launches per prefill and per decode "
            f"step (flash, rmsnorm, of which fused add) {pre}, {dec}; this "
            f"run's totals flash {n_flash} rmsnorm {n_rms} fused "
            f"{n_fused}{dropped}; {time.perf_counter() - t0:.1f} s")
        del model, run, engine
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        zoo_f32_check(torch, label, arch, batch, rolling)
        log(f"zoo f32 {label}: {time.perf_counter() - t0:.1f} s")
    log(f"zoo phase: {time.perf_counter() - t_zoo:.1f} s")
    return totals


def llm_train_phase(torch, fa, rn, card):
    """qwen2-0.5b at its published widths trained through ``launch.train
    llm`` (4 shards, 4 phase-0 and 4 phase-1 steps) with every launch count
    set to 0 just before and read just after: finite losses, every step's
    launches of the four training kernels (remat replays each layer's
    forward, so the forward kernels launch twice a layer), none of
    serving's; step times, tokens/s and peak memory.  Then one phase-0
    step of the f32 variant, the kernels against their plain versions from
    the same weights, and one bf16 phase-0 step broken down
    (torch.profiler).  Returns the launch counts."""
    import dataclasses

    from repro_torch.launch.train import (build_parser, llm_phase0_step,
                                          run_llm)
    from repro_torch.models import Transformer

    fa.reset_flash_launch_count()
    rn.reset_rmsnorm_launch_count()
    t0 = time.perf_counter()
    run = run_llm(build_parser().parse_args(LLM_TRAIN_ARGS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash = {d: fa.flash_launch_count(d)
             for d in ("train", "backward", "prefill", "decode")}
    rms = {"rmsnorm": rn.rmsnorm_launch_count()
           - rn.add_rmsnorm_launch_count(),
           "add_rmsnorm": rn.add_rmsnorm_launch_count(),
           "rmsnorm_bwd": rn.rmsnorm_bwd_launch_count()
           - rn.add_rmsnorm_bwd_launch_count(),
           "add_rmsnorm_bwd": rn.add_rmsnorm_bwd_launch_count()}
    cfg, shards = run["cfg"], 4
    n_layers = cfg.num_layers
    assert cfg.remat and cfg.d_model == 896 and cfg.vocab_size == 151936
    # per shard's loss and backward: flash forward (with the LSE) and
    # backward, RMSNorm forward (both entry points) and backward; the
    # layers' forwards run twice (remat), the final norm once
    per_pass = [2 * n_layers, n_layers, 4 * n_layers + 1, 2 * n_layers + 1]
    steps = run["launches_per_step"]
    assert len(steps) == 8, steps
    for i, n in enumerate(steps):
        assert n == [shards * c for c in per_pass], (i, n, per_pass)
    assert flash["prefill"] == flash["decode"] == 0, flash
    assert flash["train"] == 8 * shards * per_pass[0], flash
    assert flash["backward"] == 8 * shards * per_pass[1], flash
    # the fused entry point: every norm but layer 0's first takes in the
    # add before it, twice over (remat) but the final norm's; its backward
    # gets the sum's own gradient everywhere but at the final norm
    assert rms == {"rmsnorm": 8 * shards * 2,
                   "add_rmsnorm": 8 * shards * (4 * n_layers - 1),
                   "rmsnorm_bwd": 8 * shards * 2,
                   "add_rmsnorm_bwd": 8 * shards * (2 * n_layers - 1)}, rms
    losses = [run["phase0_final_loss"]] + run["phase1_final_loss"]
    assert np.isfinite(losses).all(), losses
    stats = {k: run[k] for k in ("phase0_step_ms", "phase1_step_ms",
                                 "tokens_per_step", "phase0_tokens_per_s",
                                 "phase1_tokens_per_s",
                                 "max_memory_allocated", "phase0_final_loss",
                                 "phase1_final_loss", "shard_entropies",
                                 "wall_s")}
    step_ms = [np.round(np.array(run["step_s"][i]) * 1e3, 3).tolist()
               for i in (0, 1)]
    log(f"llm train {cfg.name} full width ({card}): {json.dumps(stats)}; "
        f"phase-0 step ms {step_ms[0]}, phase-1 {step_ms[1]}; "
        f"launches per step (flash fwd, flash bwd, rmsnorm fwd, rmsnorm "
        f"bwd) {steps[0]} = {shards} x {per_pass}; totals flash {flash} "
        f"rmsnorm {rms}; main path {wall:.1f} s")
    nb = run["batcher"].next_batch()
    # run_llm frees phase 0's AdamW state when phase 1 starts: the profiled
    # step below starts from fresh moments (the same work)
    model, opt = run["model"], run["opt"]
    opt_state = opt.init(model.parameters())
    run.clear()      # the replicas and their optimizer states

    # the f32 variant from one seed: one phase-0 step's losses and mean
    # gradient, kernels against plain versions
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = Transformer(cfg32, seed=0, device="cuda")
    weights = list(m32.parameters())
    names = [n for n, _ in m32.named_parameters()]
    out = {}
    for use_kernels in (True, False):
        m32.use_kernels = use_kernels
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        shard_losses, acc = [], None
        for p in range(shards):
            loss = m32.train_loss({"tokens": nb["tokens"][p],
                                   "labels": nb["labels"][p]})
            g = torch.autograd.grad(loss, weights)
            shard_losses.append(loss.item())
            acc = list(g) if acc is None else [a + x for a, x in zip(acc, g)]
        out[use_kernels] = (shard_losses, [a / shards for a in acc])
        del acc, g
        # the kernels' pass went through all four kernels, the plain one
        # through none
        n = [fa.flash_launch_count("train"), fa.flash_launch_count("backward"),
             rn.rmsnorm_launch_count(), rn.rmsnorm_bwd_launch_count()]
        assert n == [shards * c * use_kernels for c in per_pass], n
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(out[True][0],
                                                       out[False][0]))
    rel = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for n, a, b in zip(names, out[True][1], out[False][1])}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"llm train f32 phase-0 step, kernels vs plain: shard losses "
        f"{out[True][0]} vs {out[False][0]} (rel diff {loss_err:.3e}, rtol "
        f"{LLM_TRAIN_LOSS_RTOL}); gradients max |diff| / max |plain| "
        f"{max(rel.values()):.3e} (limit {LLM_TRAIN_GRAD_RTOL}), worst "
        f"{worst}")
    assert loss_err <= LLM_TRAIN_LOSS_RTOL, loss_err
    assert max(rel.values()) <= LLM_TRAIN_GRAD_RTOL, worst
    del m32, weights, out

    # where the time goes: one bf16 phase-0 step of the trained model
    state = {"opt": opt_state}

    def step():
        state["opt"], _ = llm_phase0_step(model, opt, state["opt"], nb,
                                          shards)

    step()
    cuda = profile_window(torch, "llm train phase-0 step", step, 1)
    # the two backward kernels' device time in the step, beside the
    # CUDA-core flash backward's 112 ms (dK/dV 78, dQ 34) on the same step
    # (PERF.md §5)
    totals = {}
    for name, keys in (("flash backward", ("flash_bwd",)),
                       ("rmsnorm backward", ("rms_bwd",))):
        hit = [e for e in cuda if any(k in e.key for k in keys)]
        totals[name] = {"ms": sum(e.self_device_time_total
                                  for e in hit) / 1e3,
                        "kernels": {e.key.replace(
                            "(anonymous namespace)::", "").split("(")[0][-40:]:
                                    [e.count, e.self_device_time_total / 1e3]
                                    for e in hit}}
    log(f"llm train phase-0 step, backward kernels per step ({card}): "
        f"{json.dumps(totals)} (the CUDA-core flash backward: 112 ms, dK/dV "
        f"78, dQ 34)")
    return flash, rms


# --------------------------------------------------------------------------
# phase 7b: the sharded LLM steps (ROADMAP item 15.7)
# --------------------------------------------------------------------------

SHARD_ARCH = "qwen2-0.5b"
SHARD_TRAIN = (8, 512)        # global batch x sequence, remat on
SHARD_PREFILL = (4, 2048)     # batch x prompt
SHARD_DECODE = 16             # greedy decode steps
SHARD_PARTS = 2               # personalize replicas
SHARD_F32_LAYERS = 4          # the f32 variant: full width cut to 4 layers
SHARD_MESH = (2, 2)           # the world of 4 sharing the card
# the f32 variant, the world of 4 against the world of 1: loss, logits and
# every gradient within 1e-5 of the tensor's largest entry; the gradients'
# global norm, which AdamW's clip divides by, within 1e-6 relative (the
# clip's scale cancels from AdamW's first update wherever |g| >> eps, so the
# norm is held on its own); the weights after AdamW's first step within
# 1e-5 of the model's largest weight where the world of 1's gradient is at
# least 1e-6 (100 x AdamW's eps): below it the update -lr g / (|g| + eps)
# turns on the gradient's rounding, up to 2 lr = 2e-3 (such entries are
# counted and their largest difference printed)
SHARD_REL = 1e-5
SHARD_NORM_REL = 1e-6
SHARD_GRAD_FLOOR = 1e-6


def shard_cfg(f32: bool):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(SHARD_ARCH)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  num_repeats=SHARD_F32_LAYERS)
    return cfg


def shard_inputs(cfg):
    """The train batch (next-token labels, the last masked) and the prompt,
    from seed 0."""
    rng = np.random.default_rng(0)
    b, s = SHARD_TRAIN
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1)], axis=1)
    pb, ps = SHARD_PREFILL
    return ({"tokens": tokens, "labels": labels},
            rng.integers(0, cfg.vocab_size, (pb, ps)))


def shard_counts():
    """The flash and RMSNorm kernels' launches since the last call, then
    zeroed."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    out = {d: fa.flash_launch_count(d)
           for d in ("prefill", "decode", "train", "backward")}
    out.update(rmsnorm=rn.rmsnorm_launch_count()
               - rn.add_rmsnorm_launch_count(),
               add_rmsnorm=rn.add_rmsnorm_launch_count(),
               rmsnorm_bwd=rn.rmsnorm_bwd_launch_count()
               - rn.add_rmsnorm_bwd_launch_count(),
               add_rmsnorm_bwd=rn.add_rmsnorm_bwd_launch_count())
    fa.reset_flash_launch_count()
    rn.reset_rmsnorm_launch_count()
    return out


def shard_sync(torch):
    import torch.distributed as dist
    torch.cuda.synchronize()
    if dist.get_world_size() > 1:
        dist.barrier()


def shard_steps(torch, cfg, mesh, *, steps=1, personalize=True,
                grads=False):
    """qwen2-0.5b's prefill and greedy decode, (with ``grads``) the
    gradients of the train loss, then the train step(s) and (optionally) a
    personalize step, on ``mesh`` (None: the unsharded steps), from the
    weights of seed 0; each step between synchronised host clocks (CUDA
    synchronised, then a barrier of the world) with its kernels' launches
    and its staged bytes.  Returns the results and the model (for
    comparisons in the rank)."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import staged_backend as sb
    from repro_torch.launch.steps import _sync, build_step
    from repro_torch.models import Transformer
    from repro_torch.train.optim import AdamW

    every = {}          # every launch of the run, timed or not

    def count():
        n = shard_counts()
        for k, v in n.items():
            every[k] = every.get(k, 0) + v
        return n

    def clock(fn):
        shard_sync(torch)
        count()
        sb.reset_staged_bytes()
        t0 = time.perf_counter()
        r = fn()
        shard_sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
        return r, ms, count(), sb.staged_bytes()

    shard_counts()

    batch, prompt = shard_inputs(cfg)
    b, s = SHARD_TRAIN
    pb, ps = SHARD_PREFILL
    opt = AdamW(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    out = {"ms": {}, "launches": {}, "bytes": {}}
    built = build_step(cfg, InputShape("shard_train", s, b, "train"), mesh,
                       optimizer=opt)
    model = built.shard_model(Transformer(cfg, seed=0, device="cuda"))
    full = lambda t: (t.full_tensor() if mesh is not None else t).float()
    # serving: the prefill step (once untimed, to warm the card and the
    # host's caches), then a prefill into a cache with room for the greedy
    # decode steps
    pre = build_step(cfg, InputShape("shard_prefill", ps, pb, "prefill"),
                     mesh)
    pre.step(model, {"tokens": prompt})
    (logits, caches, n_ctx), ms, n, nb = clock(
        lambda: pre.step(model, {"tokens": prompt}))
    out["ms"]["prefill"], out["launches"]["prefill"] = ms, n
    out["bytes"]["prefill"] = nb
    out["prefill"] = full(logits).cpu()
    width = ps + SHARD_DECODE
    dec = build_step(cfg, InputShape("shard_decode", width, pb, "decode"),
                     mesh)
    logits, caches, n_ctx = model.prefill({"tokens": prompt},
                                          cache_size=width)
    tok = full(logits).argmax(-1, keepdim=True).cpu().numpy()
    steps_ms, dlog, toks = [], [], [tok[:, 0]]
    for t in range(SHARD_DECODE):
        (logits, caches), ms, n, nb = clock(
            lambda: dec.step(model, tok, caches, n_ctx + t))
        steps_ms.append(ms)
        if t == 0:
            out["launches"]["decode"], out["bytes"]["decode"] = n, nb
        dlog.append(full(logits).cpu())
        tok = dlog[-1].argmax(-1, keepdim=True).numpy()
        toks.append(tok[:, 0])
    out["ms"]["decode_p50"] = float(np.median(steps_ms))
    out["decode"], out["tokens"] = torch.stack(dlog), np.stack(toks, 1)
    out["caches"] = caches
    del logits
    weights = list(model.parameters())
    if grads:
        g = torch.autograd.grad(model.train_loss(batch), weights)
        out["grads"] = _sync(g, weights) if mesh is not None else g
    state = opt.init(weights)
    for i in range(steps):
        (model, state, loss), ms, n, nb = clock(
            lambda: built.step(model, state, batch))
        out["ms"][f"train{i}"], out["launches"]["train"] = ms, n
        out["bytes"]["train"] = nb
    out["loss"] = float(loss.full_tensor() if mesh is not None else loss)
    if personalize:
        pbuilt = build_step(cfg, InputShape("shard_train", s, b, "train"),
                            mesh, phase="personalize",
                            num_partitions=SHARD_PARTS, optimizer=opt)
        reps = pbuilt.shard_replicas([Transformer(cfg, seed=0, device="cuda")
                                      for _ in range(SHARD_PARTS)])
        states = [opt.init(r.parameters()) for r in reps]
        batch_p = {k: v.reshape(SHARD_PARTS, b // SHARD_PARTS, s)
                   for k, v in batch.items()}
        active = np.ones(SHARD_PARTS, bool)
        (reps, states, losses), ms, n, nb = clock(
            lambda: pbuilt.step(reps, states, batch_p, model, active))
        # a rank steps the replicas its data coordinate owns: count a
        # replica's launches
        assert all(v % len(reps) == 0 for v in n.values()), n
        out["ms"]["personalize"] = ms
        out["launches"]["personalize"] = {k: v // len(reps)
                                          for k, v in n.items()}
        out["personalize"] = full(losses).cpu()
        out["replicas"] = reps
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    count()
    out["every"] = every
    return out, model


def shard_differs(torch, a, b, ma, mb) -> list:
    """What of the sharded run ``a`` (model ``ma``) is not bitwise the
    unsharded run ``b`` (model ``mb``), by name."""
    bad = []
    if a["loss"] != b["loss"]:
        bad.append("train loss")
    for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
        if not torch.equal(p.to_local(), q):
            bad.append(f"train step weight {n}")
    for key in ("prefill", "decode", "personalize"):
        if key in a and not torch.equal(a[key], b[key]):
            bad.append(f"{key} output")
    if not np.array_equal(a["tokens"], b["tokens"]):
        bad.append("greedy tokens")
    for i, (ca, cb) in enumerate(zip(a["caches"], b["caches"])):
        for k in ("k", "v"):
            if not torch.equal(ca[k].to_local(), cb[k]):
                bad.append(f"decode cache layer {i} {k}")
    for j, (ra, rb) in enumerate(zip(a.get("replicas", ()),
                                     b.get("replicas", ()))):
        for (n, p), q in zip(ra.named_parameters(), rb.parameters()):
            if not torch.equal(p.to_local(), q):
                bad.append(f"personalize replica {j} weight {n}")
    return bad


def shard_rank(rank, mesh_shape, ref_path):
    """One rank of a world on a ``("data", "model")`` mesh of
    ``mesh_shape``: qwen2-0.5b bf16 at full depth, then the f32 4-layer
    variant.  The world of 1 also runs the unsharded steps and names what
    is not bitwise; it saves its f32 results to ``ref_path``, which the
    world of 4 holds its own shards against."""
    import torch

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models.sharded import local_shard
    from repro_torch.train.optim import global_norm

    mesh = make_mesh_compat(mesh_shape, ("data", "model"))
    one = mesh.size() == 1
    out = {}
    cfg = shard_cfg(False)
    sh, model = shard_steps(torch, cfg, mesh, steps=2)
    if one:
        pl, plain = shard_steps(torch, cfg, None, steps=2)
        out["differs"] = shard_differs(torch, sh, pl, model, plain)
        out["plain_launches"], out["plain_ms"] = pl["launches"], pl["ms"]
        del plain, pl
    keep = ("loss", "ms", "launches", "bytes", "prefill", "decode", "tokens",
            "personalize", "peak_gib", "every")
    out["bf16"] = {k: sh[k] for k in keep}
    del sh, model
    torch.cuda.empty_cache()
    cfg = shard_cfg(True)
    f32, model = shard_steps(torch, cfg, mesh, personalize=False, grads=True)
    names = [n for n, _ in model.named_parameters()]
    local = lambda t: t.detach().to_local().cpu()
    norm = float(global_norm(f32["grads"]))
    if one:
        torch.save({"loss": f32["loss"], "prefill": f32["prefill"],
                    "grad_norm": norm,
                    "decode": f32["decode"], "tokens": f32["tokens"],
                    "grads": {n: local(g) for n, g in zip(names,
                                                          f32["grads"])},
                    "weights": {n: local(p)
                                for n, p in model.named_parameters()}},
                   ref_path)
        out["f32"] = {k: f32[k] for k in ("loss", "launches", "every")}
        out["f32"]["grad_norm"] = norm
        return out
    ref = torch.load(ref_path, weights_only=False)
    rel = lambda a, b: float((a - b).abs().max()) / (
        float(b.abs().max()) or 1.0)
    w_max = max(float(w.abs().max()) for w in ref["weights"].values())
    grad_rel, w_held, w_rest, n_rest = 0.0, 0.0, 0.0, 0
    for (n, p), g in zip(model.named_parameters(), f32["grads"]):
        want = ref["grads"][n]
        g1 = local_shard(want, mesh, g.placements)
        err = float((local(g) - g1).abs().max())
        grad_rel = max(grad_rel, err / (float(want.abs().max()) or 1.0))
        # the weights after one step, apart where the world of 1's gradient
        # is below SHARD_GRAD_FLOOR: there AdamW's first update g / (|g| +
        # eps) turns on the gradient's rounding
        dw = (local(p) - local_shard(ref["weights"][n], mesh,
                                     p.placements)).abs()
        small = g1.abs() < SHARD_GRAD_FLOOR
        if (~small).any():
            w_held = max(w_held, float(dw[~small].max()))
        if small.any():
            w_rest = max(w_rest, float(dw[small].max()))
            n_rest += int(small.sum())
    out["f32"] = {
        "loss": abs(f32["loss"] - ref["loss"]) / abs(ref["loss"]),
        "prefill": rel(f32["prefill"], ref["prefill"]),
        "decode": rel(f32["decode"], ref["decode"]),
        "grads": grad_rel,
        "grad_norm": abs(norm - ref["grad_norm"]) / ref["grad_norm"],
        "tokens": bool(np.array_equal(f32["tokens"], ref["tokens"])),
        "weights": w_held / w_max, "weights_small_grad": w_rest,
        "small_grad_entries": n_rest,
        "launches": f32["launches"], "every": f32["every"]}
    return out


def shard_probe_rank(rank):
    """DTensor over a gloo world on card tensors (the question of
    ``scripts/collective_probe.py``): a Shard to Replicate round trip."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("model",))
    full = torch.arange(8.0, device="cuda").view(4, 2)
    d = DTensor.from_local(full.chunk(2)[rank], mesh, [Shard(0)])
    return bool(torch.equal(d.full_tensor(), full))


def shard_checks(torch, card):
    """Phase 7b: qwen2-0.5b's train, prefill, greedy decode and personalize
    steps on a mesh (``launch/steps.py::build_step(cfg, shape, mesh)``), bf16
    at full width and depth and an f32 variant cut to 4 layers: an NCCL
    world of 1 on a ``(1, 1)`` mesh bitwise the unsharded steps (what is
    not is named, and the phase fails); a world of 4 sharing the card on
    ``(2, 2)`` (the ``staged`` backend: gloo carries DTensor's collectives
    on card tensors only to a SIGSEGV, which a gloo world of 2 shows here
    first) with each rank's flash and RMSNorm launches equal to the
    unsharded step's and its staged bytes equal to
    ``step_collective_bytes``; its f32 loss, logits and weights after one
    step held against the world of 1's.  Prints step ms (slowest rank,
    synchronised host clock), bytes, peak memory per rank, and for bf16
    the share of equal greedy tokens and the largest logit difference.
    Returns the ranks' launches (the sharded runs') by kernel."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import spawn_partition_world
    from repro_torch.launch.steps import _make_policy
    from repro_torch.models.sharded import step_collective_bytes

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    try:
        probe = spawn_partition_world(shard_probe_rank, 2, backend="gloo",
                                      device="cuda", timeout_s=60,
                                      join_timeout_s=120)
        probe = f"ok, results {probe}"
    except Exception as e:  # noqa: BLE001 - the probe's answer is printed
        probe = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    log(f"shard probe ({card}): a gloo world of 2 on this card, DTensor "
        f"Shard to Replicate on card tensors: {probe} "
        f"({time.perf_counter() - t0:.1f} s); the world of 4 runs the "
        "staged backend")
    tmp = tempfile.mkdtemp(prefix="shard_")
    try:
        ref = os.path.join(tmp, "world1_f32.pt")
        t0 = time.perf_counter()
        one = spawn_partition_world(shard_rank, 1, ((1, 1), ref),
                                    backend="nccl", device="cuda",
                                    timeout_s=300, join_timeout_s=900)[0]
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        four = spawn_partition_world(shard_rank, 4, (SHARD_MESH, ref),
                                     backend="staged", device="cuda",
                                     timeout_s=600, join_timeout_s=900)
        t4 = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert not one["differs"], (
        f"the world of 1 is not bitwise the unsharded steps: "
        f"{one['differs'][:8]}")
    log(f"shard world of 1 (nccl, (1, 1), {card}): train, prefill, "
        f"{SHARD_DECODE} decode steps, personalize bitwise the unsharded "
        f"steps (loss {one['bf16']['loss']:.6f}); ms {json.dumps(one['bf16']['ms'])} "
        f"(unsharded {json.dumps(one['plain_ms'])}); peak "
        f"{one['bf16']['peak_gib']:.2f} GiB; {t1:.1f} s")
    want = one["plain_launches"]
    cfg16, cfg32 = shard_cfg(False), shard_cfg(True)
    b, s = SHARD_TRAIN
    pb, ps = SHARD_PREFILL

    class _Mesh:
        shape = dict(zip(("data", "model"), SHARD_MESH))
        mesh_dim_names = ("data", "model")
    pol = _make_policy(_Mesh())
    closed = {"train": step_collective_bytes(cfg16, "train", b, s, pol),
              "prefill": step_collective_bytes(cfg16, "prefill", pb, ps, pol),
              "decode": step_collective_bytes(cfg16, "decode", pb, 1, pol,
                                              cache_width=ps + SHARD_DECODE)}
    closed = {k: sum(v.values()) for k, v in closed.items()}
    for r, o in enumerate(four):
        got = o["bf16"]
        for kind, n in want.items():
            assert got["launches"][kind] == n, (
                f"rank {r}'s {kind} launches {got['launches'][kind]} are not "
                f"the unsharded step's {n}")
        for kind, n in closed.items():
            assert got["bytes"][kind] == n, (
                f"rank {r}'s {kind} step moved {got['bytes'][kind]} B, the "
                f"closed form says {n}")
        f = o["f32"]
        assert max(f["loss"], f["prefill"], f["decode"],
                   f["grads"]) <= SHARD_REL and f["tokens"], (r, f)
        assert f["grad_norm"] <= SHARD_NORM_REL, (r, f)
        assert f["weights"] <= SHARD_REL, (r, f)
        assert got["loss"] == four[0]["bf16"]["loss"], r
    slow = {k: max(o["bf16"]["ms"][k] for o in four)
            for k in four[0]["bf16"]["ms"]}
    g0 = four[0]["bf16"]
    same = float((g0["tokens"] == one["bf16"]["tokens"]).mean())
    ldiff = float((g0["decode"] - one["bf16"]["decode"]).abs().max())
    pdiff = float((g0["prefill"] - one["bf16"]["prefill"]).abs().max())
    log(f"shard world of 4 (staged, {SHARD_MESH}, {card}): launches per rank "
        f"equal the unsharded step's {json.dumps(want)}; staged bytes a step "
        f"equal the closed form {json.dumps(closed)}; ms on the slowest rank "
        f"(synchronised host clock) {json.dumps(slow)}; peak GiB per rank "
        f"{[round(o['bf16']['peak_gib'], 2) for o in four]}; loss "
        f"{g0['loss']:.6f} vs {one['bf16']['loss']:.6f}; {t4:.1f} s")
    log(f"shard bf16 full depth, world of 4 vs world of 1 ({card}): equal "
        f"greedy tokens {same:.4f} of {g0['tokens'].size}, largest logit "
        f"difference {ldiff:.4g} over {SHARD_DECODE} decode steps, "
        f"{pdiff:.4g} on the prefill's")
    log(f"shard f32 {SHARD_F32_LAYERS} layers, world of 4 vs world of 1 "
        f"({card}): " + json.dumps([{k: v for k, v in o["f32"].items()
                                     if k not in ("launches", "every")}
                                    for o in four])
        + f" (limits {SHARD_REL} relative, the gradients' global norm "
        f"{SHARD_NORM_REL}, {one['f32']['grad_norm']:.6g} in the world of 1; "
        f"weights {SHARD_REL} of the largest where the gradient is at least "
        f"{SHARD_GRAD_FLOOR}, reported below)")
    log(f"shard_checks: {time.perf_counter() - t_all:.1f} s")
    # every launch of the sharded runs: the world of 1's and every rank's of
    # 4 (the world of 1's unsharded runs apart)
    total = {}
    for o in [one] + four:
        for part in ("bf16", "f32"):
            for k, v in o[part]["every"].items():
                total[k] = total.get(k, 0) + v
    assert all(total[k] > 0 for k in ("prefill", "decode", "train",
                                      "backward", "rmsnorm", "add_rmsnorm",
                                      "rmsnorm_bwd", "add_rmsnorm_bwd")), total
    return total


# --------------------------------------------------------------------------
# phase 7c: the dry run and the roofline on the card's terms (ROADMAP 15.8)
# --------------------------------------------------------------------------

# the dry run's CLI on the fake (16, 16) world: qwen2-0.5b's four shapes,
# long_500k through the swa variant
DRYRUN_ARGS = ["--arch", "qwen2-0.5b", "--shape", "all", "--auto-swa"]
# the counted step on the card: phase 7's shard batch, 8 sequences of 512
ROOFLINE_BATCH, ROOFLINE_SEQ = 8, 512


def run_script(args, timeout_s):
    """``python args...`` from the checkout's root with its ``src`` on the
    path; its output, or a raise with the end of its errors."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout_s)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} exited {proc.returncode}: "
                           f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    return proc.stdout


def train_launches_per_pass(cfg) -> list[int]:
    """A training pass's launches (flash training forward, flash backward,
    RMSNorm forward of both entry points, RMSNorm backward) of ``cfg``:
    remat replays each decoder layer's forward (its self- and
    cross-attention and norms), never the encoder's, which runs once; the
    final norms run once; a layernorm model launches no RMSNorm."""
    attn = sum((sl.mixer == "attention") + sl.cross_attention
               for sl in cfg.super_block) * cfg.num_repeats
    norms = sum(1 + sl.cross_attention + (sl.ffn != "none")
                for sl in cfg.super_block) * cfg.num_repeats + 1
    enc = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    enc_norms = 2 * enc + 1 if enc else 0
    replay = 2 if cfg.remat else 1
    rms = cfg.norm == "rmsnorm"
    return [replay * attn + enc, attn + enc,
            rms * (replay * (norms - 1) + 1 + enc_norms),
            rms * (norms + enc_norms)]


def dryrun_phase(torch, fa, rn, card):
    """The dry run (``launch/dryrun.py``) and the roofline on the card: the
    fake backend probed first, then qwen2-0.5b's four shapes on the fake
    (16, 16) world (every row ``ok``, the collectives' input-plus-output
    bytes equal to ``step_collective_bytes`` wherever it applies); then one
    qwen2-0.5b bf16 train step at full width (8 x 512, remat, no mesh) on
    the card counted by the same counters while the kernels run, its
    counted FLOPs and every kernel's count equal to the same step's on
    meta exactly, its roofline terms beside the measured step time.
    Returns the card steps' launches."""
    import tempfile

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import active_params, closed_form_holds
    from repro_torch.launch.steps import build_step
    from repro_torch.models import Transformer
    from repro_torch.roofline import (CollectiveCounter, StepCounter,
                                      analyze_step)
    from repro_torch.train.optim import AdamW

    t_phase = time.perf_counter()
    out = run_script(["scripts/fake_world_probe.py"], 300)
    log("fake world probe: " + " ".join(
        line for line in out.splitlines() if line.startswith("fake world")))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rows.json")
        t0 = time.perf_counter()
        run_script(["-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
                    "--out", path], 600)
        dry_s = time.perf_counter() - t0
        with open(path) as f:
            rows = json.load(f)
    assert [r["status"] for r in rows] == ["ok"] * 4, rows
    for r in rows:
        held = closed_form_holds(r)
        assert held is not False, (r["shape"], r["coll_in_out"],
                                   r["coll_closed_form"])
        log("dryrun " + json.dumps({k: r[k] for k in (
            "name", "chips", "compute_s", "memory_s", "collective_s",
            "dominant", "hlo_flops_per_chip", "hlo_bytes_per_chip",
            "coll_in_out", "peak_memory_per_chip_gb", "fits",
            "useful_flops_ratio", "lower_s", "compile_s", "variant")})
            + f" closed form {'held' if held else 'not applicable'}")
    log(f"dryrun CLI: {dry_s:.1f} s for {len(rows)} rows")

    # one train step on the card, counted, and the same step on meta
    cfg = get_config("qwen2-0.5b")
    assert cfg.remat and cfg.dtype == "bfloat16"
    shape = InputShape("train_8x512", ROOFLINE_SEQ, ROOFLINE_BATCH, "train")
    built = build_step(cfg, shape)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (ROOFLINE_BATCH, ROOFLINE_SEQ),
                           generator=gen, device="cuda")
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    batch = {"tokens": tokens, "labels": labels}
    model = Transformer(cfg, seed=0, device="cuda")
    state = {"opt": AdamW().init(model.parameters())}

    def step():
        _, state["opt"], loss = built.step(model, state["opt"], batch)
        return loss

    fa.reset_flash_launch_count()
    rn.reset_rmsnorm_launch_count()
    step()                                  # warm-up: builds, cuBLAS
    torch.cuda.synchronize()
    with CollectiveCounter() as coll, StepCounter() as card_counts:
        loss = step()
        torch.cuda.synchronize()
    assert torch.isfinite(loss).all(), loss
    meta = Transformer(cfg, device="meta")
    meta_state = AdamW().init(meta.parameters())
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in batch.items()}
    with StepCounter() as meta_counts:
        built.step(meta, meta_state, meta_batch)
    del meta, meta_state
    log(f"roofline step counted ({card}): card flops "
        f"{card_counts.flops:.6e} bytes {card_counts.bytes:.6e} peak "
        f"{card_counts.peak_bytes / 2**30:.2f} GiB (argument "
        f"{card_counts.argument_bytes / 2**30:.2f}, output "
        f"{card_counts.output_bytes / 2**30:.2f}, temp "
        f"{card_counts.temp_bytes / 2**30:.2f}); meta flops "
        f"{meta_counts.flops:.6e} bytes {meta_counts.bytes:.6e} peak "
        f"{meta_counts.peak_bytes / 2**30:.2f} GiB; kernels "
        f"{json.dumps(card_counts.kernels)}; collectives {coll.out_bytes}")
    assert card_counts.flops == meta_counts.flops, (card_counts.flops,
                                                    meta_counts.flops)
    assert card_counts.kernels == meta_counts.kernels, (
        card_counts.kernels, meta_counts.kernels)
    assert not coll.out_bytes, coll.out_bytes
    # the step's time, uncounted: the median of 5 synchronised steps
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    launches = {"train": fa.flash_launch_count("train"),
                "backward": fa.flash_launch_count("backward"),
                "rmsnorm_bwd": rn.rmsnorm_bwd_launch_count()
                - rn.add_rmsnorm_bwd_launch_count(),
                "add_rmsnorm_bwd": rn.add_rmsnorm_bwd_launch_count(),
                "rmsnorm": rn.rmsnorm_launch_count()
                - rn.add_rmsnorm_launch_count(),
                "add_rmsnorm": rn.add_rmsnorm_launch_count()}
    per_pass = train_launches_per_pass(cfg)
    n_steps = 7                             # warm-up, counted, 5 timed
    assert [launches["train"], launches["backward"],
            launches["rmsnorm"] + launches["add_rmsnorm"],
            launches["rmsnorm_bwd"] + launches["add_rmsnorm_bwd"]] == [
        n_steps * c for c in per_pass], (launches, per_pass)
    rep = analyze_step(built.name, card_counts, chips=1,
                       n_active_params=active_params(cfg)[1],
                       tokens=ROOFLINE_BATCH * ROOFLINE_SEQ)
    row = rep.row()
    log(f"roofline train step qwen2-0.5b 8x512 bf16 ({card}): " + json.dumps(
        {"compute_s": row["compute_s"], "memory_s": row["memory_s"],
         "dominant": row["dominant"], "model_flops": row["model_flops"],
         "counted_flops": row["hlo_flops_per_chip"],
         "counted_bytes": row["hlo_bytes_per_chip"],
         "useful_flops_ratio": row["useful_flops_ratio"],
         "step_ms": step_s * 1e3,
         "step_ms_all": [t * 1e3 for t in times],
         "compute_share": rep.compute_s / step_s,
         "memory_share": rep.memory_s / step_s,
         "mfu": rep.model_flops_total / step_s / _HW.peak_flops,
         "peak_gib_counted": card_counts.peak_bytes / 2**30,
         "max_memory_allocated_gib":
             torch.cuda.max_memory_allocated() / 2**30})
        + f"; launches {launches} = {n_steps} x {per_pass}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del model, state, batch
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 7d: training the zoo's MoE and Mamba2 families (ROADMAP 15.9)
# --------------------------------------------------------------------------

# (label, arch, cuts, shards, sequences a shard): launch.train llm bf16 at
# the published widths, every expert kept, 512 tokens a sequence, 2
# phase-0 and 2 phase-1 steps, cut in depth only.  jamba's first 2
# sub-layers hold 3.67 B parameters: phase 1's replicas with their f32
# AdamW moments take 10 bytes a parameter each (34.2 GiB), so two of them
# beside the phase-0 model (6.8 GiB) and one replica's gradients (6.8 GiB)
# need 82 GiB, more than the card's 80 GiB, even with the moments stepped in
# place; jamba runs one shard of 8 sequences (the same 4,096 tokens a step)
ZOO_TRAIN_RUNS = [
    ("mamba2-370m", "mamba2-370m", [], 2, 4),
    ("phi3.5-moe 1 of 32 layers", "phi3.5-moe-42b-a6.6b",
     ["--num-repeats", "1"], 2, 4),
    ("jamba first 2 sub-layers, 1 shard", "jamba-v0.1-52b",
     ["--num-repeats", "1", "--sub-layers", "2"], 1, 8),
]
# the f32 variant's kernels-against-plain training pass: a batch of 2
# sequences of 512 tokens, tried until one whose MoE routes all agree
ZOO_TRAIN_F32_ROWS, ZOO_TRAIN_F32_TRIES = 2, 4


def zoo_train_f32_check(torch, fa, rn, arch):
    """The f32 variant of ``arch`` cut as ``ZOO_F32`` cuts it, one training
    pass (loss and every gradient) with the kernels against the plain
    versions from the same weights, on a batch whose MoE routes agree
    between the two (the flipped routes of the batches passed over are
    counted); each gradient within ``LLM_TRAIN_GRAD_RTOL`` of its largest
    entry, the loss within ``LLM_TRAIN_LOSS_RTOL``."""
    from repro_torch.models import Transformer

    overrides, _ = ZOO_F32[arch]
    cfg = zoo_config(arch, overrides, "float32")
    model = Transformer(cfg, seed=0, device="cuda")
    weights = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    flipped, tried = 0, 0
    for attempt in range(ZOO_TRAIN_F32_TRIES):
        gen = torch.Generator(device="cuda").manual_seed(100 + attempt)
        tokens = torch.randint(0, cfg.vocab_size, (ZOO_TRAIN_F32_ROWS, 512),
                               generator=gen, device="cuda")
        labels = torch.cat([tokens[:, 1:],
                            torch.full_like(tokens[:, :1], -1)], dim=1)
        batch = {"tokens": tokens, "labels": labels}
        res = {}
        for use in (True, False):
            model.use_kernels = use
            fa.reset_flash_launch_count()
            rn.reset_rmsnorm_launch_count()
            with RouteLog() as rl:
                loss = model.train_loss(batch)
                grads = torch.autograd.grad(loss, weights)
            n = [fa.flash_launch_count("train"),
                 fa.flash_launch_count("backward"),
                 rn.rmsnorm_launch_count(), rn.rmsnorm_bwd_launch_count()]
            assert n == [c * use for c in train_launches_per_pass(cfg)], n
            # the kernels' gradients wait on the host while the plain ones
            # are made (jamba's f32 cut holds 27 GB of them)
            res[use] = (loss.item(), [g.cpu() if use else g for g in grads],
                        rl.calls)
            del grads
        tried += 1
        flips = sum(int(((ik != ip) | (kk != kp)).any(1).sum())
                    for (ik, kk), (ip, kp) in zip(res[True][2],
                                                  res[False][2]))
        assert len(res[True][2]) == len(res[False][2])
        if flips == 0:
            break
        flipped += flips
        res.clear()
    assert res, f"{arch}: no batch's MoE routes agreed in {tried} tries"
    loss_err = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    rel = {}
    for name, a, b in zip(names, res[True][1], res[False][1]):
        rel[name] = float((a.to(b.device) - b).abs().max()
                          / b.abs().max().clamp_min(1e-30))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    n_calls = len(res[True][2])
    log(f"zoo train f32 {arch} ({cfg.num_layers} layers, batch "
        f"{ZOO_TRAIN_F32_ROWS} x 512) kernels vs plain: loss "
        f"{res[True][0]} vs {res[False][0]} (rel diff {loss_err:.3e}, rtol "
        f"{LLM_TRAIN_LOSS_RTOL}); gradients max |diff| / max |plain| "
        f"{max(rel.values()):.3e} (limit {LLM_TRAIN_GRAD_RTOL}), worst "
        f"{worst}; batches tried {tried}, routes flipped on the others "
        f"{flipped}, MoE calls on the held batch {n_calls}")
    assert loss_err <= LLM_TRAIN_LOSS_RTOL, loss_err
    assert max(rel.values()) <= LLM_TRAIN_GRAD_RTOL, worst
    del model, weights, res
    torch.cuda.empty_cache()


def zoo_train_phase(torch, fa, rn, card):
    """``ZOO_TRAIN_RUNS`` through ``launch.train llm`` (bf16, seed 0, the
    published widths), each with every launch count set to 0 just before
    its run and read just after: finite losses, every step's launches equal
    to the shards' passes (``train_launches_per_pass``), none of serving's;
    step ms, tokens/s and peak memory.  Then each one's f32 variant, the
    kernels against their plain versions (``zoo_train_f32_check``).
    Returns the runs' launches."""
    from repro_torch.launch.train import build_parser, run_llm

    totals = {"train": 0, "backward": 0, "rmsnorm": 0, "add_rmsnorm": 0,
              "rmsnorm_bwd": 0, "add_rmsnorm_bwd": 0}
    t_zoo = time.perf_counter()
    for label, arch, cut, shards, rows in ZOO_TRAIN_RUNS:
        torch.cuda.empty_cache()
        argv = ["llm", "--arch", arch, "--full", "--shards", str(shards),
                "--batch", str(rows), "--seq", "512", "--docs", "128",
                "--steps", "4", "--phase0-frac", "0.5", "--seed", "0",
                "--device", "cuda", *cut]
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        t0 = time.perf_counter()
        run = run_llm(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flash = {d: fa.flash_launch_count(d)
                 for d in ("train", "backward", "prefill", "decode")}
        rms = {"rmsnorm": rn.rmsnorm_launch_count()
               - rn.add_rmsnorm_launch_count(),
               "add_rmsnorm": rn.add_rmsnorm_launch_count(),
               "rmsnorm_bwd": rn.rmsnorm_bwd_launch_count()
               - rn.add_rmsnorm_bwd_launch_count(),
               "add_rmsnorm_bwd": rn.add_rmsnorm_bwd_launch_count()}
        cfg = run["cfg"]
        per_pass = train_launches_per_pass(cfg)
        steps = run["launches_per_step"]
        assert len(steps) == 4, steps
        for i, n in enumerate(steps):
            assert n == [shards * c for c in per_pass], (label, i, n,
                                                         per_pass)
        assert flash["prefill"] == flash["decode"] == 0, flash
        losses = [run["phase0_final_loss"]] + run["phase1_final_loss"]
        assert np.isfinite(losses).all(), (label, losses)
        for k in ("train", "backward"):
            totals[k] += flash[k]
        for k, v in rms.items():
            totals[k] += v
        stats = {k: run[k] for k in ("phase0_step_ms", "phase1_step_ms",
                                     "tokens_per_step", "phase0_tokens_per_s",
                                     "phase1_tokens_per_s",
                                     "max_memory_allocated",
                                     "phase0_final_loss",
                                     "phase1_final_loss", "wall_s")}
        n_params = sum(p.numel() for p in run["model"].parameters())
        step_ms = [np.round(np.array(run["step_s"][i]) * 1e3, 3).tolist()
                   for i in (0, 1)]
        log(f"zoo train {label} ({card}): {arch}, {cfg.num_layers} layers, "
            f"{n_params} params, {shards} shard(s) of {rows} x 512: "
            f"{json.dumps(stats)}; phase-0 step ms {step_ms[0]}, phase-1 "
            f"{step_ms[1]}; launches per step (flash fwd, flash bwd, "
            f"rmsnorm fwd, rmsnorm bwd) {steps[0]} = {shards} x {per_pass}; "
            f"totals flash {flash} rmsnorm {rms}; max_memory_allocated "
            f"{run['max_memory_allocated'] / 2**30:.2f} GiB; {wall:.1f} s")
        run.clear()
        del run
        torch.cuda.empty_cache()
    for _, arch, *_ in ZOO_TRAIN_RUNS:
        zoo_train_f32_check(torch, fa, rn, arch)
    log(f"zoo train phase: {time.perf_counter() - t_zoo:.1f} s")
    return totals


# the encoder-decoder and the prefix-LM trained (ROADMAP 15.10) through
# build_step(cfg, InputShape(...), mesh=None) at their published widths,
# bf16, seed 0, whole (no depth cut): (label, arch, batch rows, text
# tokens, personalize replicas).  whisper-small: 8 x 448 decoder tokens
# (its text context) over 1,500 random frames; paligemma-3b: 4 x (256
# patches + 512 tokens).  Personalize takes 2 replicas where the peak stays
# under 76 GiB: paligemma's 2.51 B parameters take 5 GB of bf16 weights and
# 20 GB of f32 AdamW moments a replica, and the functional step holds the
# new moments beside the old (20 GB more), so two replicas beside the
# global model need ~80 GB: it runs 1
ENCDEC_TRAIN_RUNS = [
    ("whisper-small", "whisper-small", 8, 448, 2),
    ("paligemma-3b", "paligemma-3b", 4, 512, 1),
]
ENCDEC_TRAIN_STEPS = 2
# the f32 variants' kernels-against-plain training pass: 2 rows of the
# run's shape
ENCDEC_TRAIN_F32_ROWS = 2


def encdec_batch(torch, cfg, rows, seq, seed, lead=()):
    """A training batch on the card from ``seed``: ``rows`` x ``seq``
    tokens, next-token labels (the last -1), and the arch's extra input in
    the model's dtype (``enc_embeds`` of ``encoder_seq`` frames,
    ``patch_embeds`` of ``prefix_tokens``); ``lead`` a leading partition
    shape that ``rows`` splits into."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens,
             "labels": torch.cat([tokens[:, 1:],
                                  torch.full_like(tokens[:, :1], -1)], 1)}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn(
            (rows, cfg.encoder_seq, cfg.d_model), generator=gen,
            device="cuda").to(dt)
    if cfg.prefix_tokens:
        batch["patch_embeds"] = torch.randn(
            (rows, cfg.prefix_tokens, cfg.d_model), generator=gen,
            device="cuda").to(dt)
    return {k: v.reshape(*lead, -1, *v.shape[1:]) if lead else v
            for k, v in batch.items()}


def train_counts(fa, rn):
    """The training launches since the last reset: flash forward, flash
    backward, RMSNorm forward (both entry points), RMSNorm backward."""
    return [fa.flash_launch_count("train"), fa.flash_launch_count("backward"),
            rn.rmsnorm_launch_count(), rn.rmsnorm_bwd_launch_count()]


def encdec_train_f32_check(torch, fa, rn, arch, seq):
    """The f32 variant of ``arch`` cut as ``ZOO_F32`` cuts it (whisper and
    paligemma whole), one training pass (loss and every gradient) with the
    kernels against the plain versions from the same weights on
    ``ENCDEC_TRAIN_F32_ROWS`` rows; each gradient within
    ``LLM_TRAIN_GRAD_RTOL`` of its largest entry (a key bias, whose
    gradient is 0 in exact arithmetic where there is no RoPE, of its
    projection's), the loss within ``LLM_TRAIN_LOSS_RTOL``."""
    from repro_torch.models import Transformer

    cfg = zoo_config(arch, ZOO_F32[arch][0], "float32")
    model = Transformer(cfg, seed=0, device="cuda")
    weights = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    batch = encdec_batch(torch, cfg, ENCDEC_TRAIN_F32_ROWS, seq, seed=100)
    res = {}
    for use in (True, False):
        model.use_kernels = use
        fa.reset_flash_launch_count()
        rn.reset_rmsnorm_launch_count()
        loss = model.train_loss(batch)
        grads = torch.autograd.grad(loss, weights)
        n = train_counts(fa, rn)
        assert n == [c * use for c in train_launches_per_pass(cfg)], n
        res[use] = (loss.item(), [g.cpu() if use else g for g in grads])
        del grads
    loss_err = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    plain = dict(zip(names, res[False][1]))
    rel = {}
    for name, a, b in zip(names, res[True][1], res[False][1]):
        like = plain[name[:-3] + "wk"] if name.endswith(".b_k") else b
        rel[name] = float((a.to(b.device) - b).abs().max()
                          / like.abs().max().clamp_min(1e-30))
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    log(f"encdec train f32 {arch} ({cfg.num_layers} layers, "
        f"{cfg.encoder_layers if cfg.is_encoder_decoder else 0} encoder "
        f"layers, batch {ENCDEC_TRAIN_F32_ROWS} x "
        f"{cfg.prefix_tokens + seq}) kernels vs plain: loss {res[True][0]} "
        f"vs {res[False][0]} (rel diff {loss_err:.3e}, rtol "
        f"{LLM_TRAIN_LOSS_RTOL}); gradients max |diff| / max |plain| "
        f"{max(rel.values()):.3e} (limit {LLM_TRAIN_GRAD_RTOL}), worst "
        f"{worst}")
    assert loss_err <= LLM_TRAIN_LOSS_RTOL, loss_err
    assert max(rel.values()) <= LLM_TRAIN_GRAD_RTOL, worst
    del model, weights, res, plain
    torch.cuda.empty_cache()


def encdec_train_phase(torch, fa, rn, card):
    """``ENCDEC_TRAIN_RUNS`` through ``launch/steps.py::build_step`` with
    ``mesh=None``: ``ENCDEC_TRAIN_STEPS`` generalize steps of one model,
    then as many personalize steps of the run's replicas (copies of it,
    the prox pull toward it), each step's launch counts set to 0 just
    before it and read just after: finite losses, the flash forward and
    backward and RMSNorm forward and backward launches equal to the
    passes' (``train_launches_per_pass``: the encoder not under remat, the
    decoder under it), none of serving's; step ms, tokens/s and peak
    memory.  Then each one's f32 variant, the kernels against their plain
    versions (``encdec_train_f32_check``).  Returns the launches, the Dh
    256 flash launches (paligemma's) apart."""
    import copy

    from repro_torch.configs import InputShape
    from repro_torch.launch.steps import build_step
    from repro_torch.models import Transformer
    from repro_torch.train.optim import AdamW

    totals = {"train": 0, "backward": 0, "train_dh256": 0,
              "backward_dh256": 0, "rmsnorm": 0, "add_rmsnorm": 0,
              "rmsnorm_bwd": 0, "add_rmsnorm_bwd": 0}
    t_phase = time.perf_counter()
    for label, arch, rows, seq, npart in ENCDEC_TRAIN_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = zoo_config(arch, {})
        dh256 = cfg.resolved_head_dim == 256
        shape = InputShape(f"{arch}-train", cfg.prefix_tokens + seq, rows,
                           "train")
        opt = AdamW(lr=1e-4, weight_decay=0.01, grad_clip=1.0)
        per_pass = train_launches_per_pass(cfg)
        model = Transformer(cfg, seed=0, device="cuda")
        n_params = model.param_count()
        runs = {}
        for phase in ("generalize", "personalize"):
            built = build_step(cfg, shape, phase=phase, optimizer=opt,
                               num_partitions=npart)
            if phase == "generalize":
                state = opt.init(model.parameters())
            else:
                del state
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reps = [copy.deepcopy(model) for _ in range(npart)]
                states = [opt.init(r.parameters()) for r in reps]
                active = torch.ones(npart, dtype=torch.bool, device="cuda")
            step_ms, losses = [], []
            for i in range(ENCDEC_TRAIN_STEPS):
                lead = (npart,) if phase == "personalize" else ()
                batch = encdec_batch(torch, cfg, rows, seq, seed=i, lead=lead)
                torch.cuda.synchronize()
                fa.reset_flash_launch_count()
                rn.reset_rmsnorm_launch_count()
                t0 = time.perf_counter()
                if phase == "generalize":
                    model, state, loss = built.step(model, state, batch)
                else:
                    reps, states, loss = built.step(reps, states, batch,
                                                    model, active)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                n = train_counts(fa, rn)
                reps_n = npart if phase == "personalize" else 1
                assert n == [reps_n * c for c in per_pass], (label, phase,
                                                             i, n, per_pass)
                assert fa.flash_launch_count("prefill") == 0
                assert fa.flash_launch_count("decode") == 0
                for key, c in zip(("train", "backward"), n[:2]):
                    totals[key + ("_dh256" if dh256 else "")] += c
                fused = rn.add_rmsnorm_launch_count()
                fused_bwd = rn.add_rmsnorm_bwd_launch_count()
                totals["rmsnorm"] += n[2] - fused
                totals["add_rmsnorm"] += fused
                totals["rmsnorm_bwd"] += n[3] - fused_bwd
                totals["add_rmsnorm_bwd"] += fused_bwd
                losses.append(loss.float().cpu().tolist())
            assert np.isfinite(np.asarray(losses, float)).all(), (label,
                                                                  losses)
            tokens = rows * (cfg.prefix_tokens + seq)
            runs[phase] = {
                "step_ms": [round(t, 3) for t in step_ms],
                "tokens_per_s": [round(tokens / t * 1e3, 1)
                                 for t in step_ms],
                "losses": losses, "replicas": npart if phase ==
                "personalize" else 1,
                "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30,
                                  2)}
        enc = (f"{cfg.encoder_layers} encoder layers over "
               f"{cfg.encoder_seq} frames" if cfg.is_encoder_decoder
               else "no encoder")
        log(f"encdec train {label} ({card}): {cfg.num_layers} decoder "
            f"layers, {enc}, {n_params} params, batch {rows} x "
            f"{cfg.prefix_tokens + seq} ({cfg.prefix_tokens} prefix): "
            f"{json.dumps(runs)}; launches per pass (flash fwd, flash bwd, "
            f"rmsnorm fwd, rmsnorm bwd) {per_pass}")
        del model, reps, states, runs
        torch.cuda.empty_cache()
    for _, arch, _, seq, _ in ENCDEC_TRAIN_RUNS:
        encdec_train_f32_check(torch, fa, rn, arch, seq)
    log(f"encdec train phase: {time.perf_counter() - t_phase:.1f} s")
    return totals


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.engine import EngineConfig, SPMDEngine
    from repro_torch.engine.stacking import build_stacked_vjp_blocks
    from repro_torch.graph import build_partitioned_graph
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.launch.serve import build_parser, gnn_main
    from repro_torch.serve import apply_updates_to_graph

    t_all = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}")
    for name in build.SOURCES:
        kernel = "?"
        for line in build.build_log(name).splitlines():
            if "Function properties for" in line:
                # the mangled name holds the kernel and its element type
                m = re.search(r"(\w+?_kernel)I(\w+?)E+v", line)
                kernel = f"{m.group(1)}<{m.group(2)}>" if m else "?"
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name} {kernel}: {line.strip()}")

    # ---- 3. kernels vs plain versions on the card --------------------------
    log(f"phase 3 starts at {time.perf_counter() - t_all:.1f} s")
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device="cuda")
    shapes = []
    for case in kernel_cases(sa):
        run_kernel_case(sa, *case, flush=flush, iters=10, record=shapes)
    for case in bwd_kernel_cases(sa):
        run_bwd_case(sa, *case, flush=flush, iters=10, record=shapes)

    from repro_torch.core import partition_graph
    from repro_torch.graph import BENCHMARKS, make_benchmark
    t0 = time.perf_counter()
    g = make_benchmark(BENCHMARKS["products-s"])
    r = partition_graph(g.indptr, g.indices, g.features, g.labels, 4,
                        method="ew", seed=0)
    pg = build_partitioned_graph(g, r.parts, 4)
    blk = build_stacked_vjp_blocks(pg)
    row_deg = row_edges(sa, blk)
    log(f"products-s host setup {time.perf_counter() - t0:.2f} s: "
        f"{pg.summary()} blocks {blk['src'].shape} "
        f"real edges {int((blk['mask'] > 0).sum())}, most in-edges of one "
        f"row {int(row_deg.max())}, rows above 1000 "
        f"{int((row_deg > 1000).sum())}; plan {json.dumps(plan_stats(sa, blk))}")
    rng = np.random.default_rng(0)
    main_rows, bwd_rows = {}, {}
    t_deg = row_edges(sa, blk, "t_")
    log(f"products-s transpose blocks {blk['t_src'].shape}: most out-edges "
        f"of one row {int(t_deg.max())}, rows above 1000 "
        f"{int((t_deg > 1000).sum())}; plan "
        f"{json.dumps(plan_stats(sa, blk, 't_'))}")
    for d in (64, 128):
        x = rng.normal(0, 1, (4, pg.max_nodes, d)).astype(np.float32)
        main_rows[d] = run_kernel_case(
            sa, f"products-s stacked D={d}", x, blk, pg.max_nodes, 0, True,
            "float32", flush=flush, iters=30, record=shapes, repeat=True)
        bwd_rows[d] = run_bwd_case(
            sa, f"bwd products-s stacked D={d}", x, blk, pg.max_nodes, 0,
            True, "float32", flush=flush, iters=30, record=shapes,
            repeat=True)
    # the single-partition use (the streamed eval's forward; the partition
    # mesh's forward and backward): each partition's blocks and transpose
    # blocks unstacked with work plans of their own, every partition's
    # launch of either kernel bitwise its rows of the stacked launch; the
    # partition with the most edges timed (two launches bitwise equal)
    from repro_torch.engine.stacking import partition_vjp_blocks
    part_blk = [partition_vjp_blocks(blk, p) for p in range(4)]
    p_big = int(np.argmax([(b["mask"] > 0).sum() for b in part_blk]))
    blk_dev = sa.blocks_to_device(blk, "cuda")
    part_rows, part_bwd_rows = {}, {}
    for d in (64, 128):
        x = rng.normal(0, 1, (4, pg.max_nodes, d)).astype(np.float32)
        xs = torch.as_tensor(x, device="cuda")
        whole = sa.segment_mean_op(xs, blk_dev, num_rows=pg.max_nodes)
        whole_t = sa.segment_mean_bwd_op(xs, blk_dev, n_in=pg.max_nodes)
        for p in range(4):
            one_blk = sa.blocks_to_device(part_blk[p], "cuda")
            one = sa.segment_mean_op(xs[p], one_blk, num_rows=pg.max_nodes)
            one_t = sa.segment_mean_bwd_op(xs[p], one_blk, n_in=pg.max_nodes)
            assert torch.equal(one, whole[p]), (
                f"partition {p}'s launch differs from its rows of the "
                f"stacked launch at D={d}")
            assert torch.equal(one_t, whole_t[p]), (
                f"partition {p}'s backward launch differs from its rows of "
                f"the stacked launch at D={d}")
        log(f"products-s D={d}: each partition's single-partition launch, "
            f"forward and backward, bitwise its rows of the stacked launch; "
            f"partition {p_big} blocks {part_blk[p_big]['src'].shape}, plan "
            f"{json.dumps(plan_stats(sa, part_blk[p_big]))}, transpose "
            f"blocks {part_blk[p_big]['t_src'].shape}, plan "
            f"{json.dumps(plan_stats(sa, part_blk[p_big], 't_'))}")
        part_rows[d] = run_kernel_case(
            sa, f"products-s partition {p_big} D={d}", x[p_big],
            part_blk[p_big], pg.max_nodes, 0, True, "float32", flush=flush,
            iters=30, record=shapes, repeat=True)
        part_bwd_rows[d] = run_bwd_case(
            sa, f"bwd products-s partition {p_big} D={d}", x[p_big],
            part_blk[p_big], pg.max_nodes, 0, True, "float32", flush=flush,
            iters=30, record=shapes, repeat=True)
    del blk_dev, xs, whole, whole_t
    # the overlapped forward's row-range use: each half of the split blocks
    # into own_cap rows, the boundary half at every partition's n_int
    from repro_torch.engine.stacking import build_stacked_split_vjp_blocks
    bi, bb = build_stacked_split_vjp_blocks(pg)
    n_int = pg.n_int.astype(np.int64)
    extent = n_int + bb["src"].shape[1] * sa.BN
    log(f"products-s split blocks: n_int {pg.n_int.tolist()}, own_cap "
        f"{pg.own_cap}; interior {bi['src'].shape} real edges "
        f"{int((bi['mask'] > 0).sum())}, plan "
        f"{json.dumps(plan_stats(sa, bi))}; boundary {bb['src'].shape} real "
        f"edges {int((bb['mask'] > 0).sum())}, plan "
        f"{json.dumps(plan_stats(sa, bb))}, transpose plan "
        f"{json.dumps(plan_stats(sa, bb, 't_'))}; boundary extent n_int + "
        f"nb·BN {extent.tolist()} against own_cap {pg.own_cap}")
    assert (extent > pg.own_cap).any(), "no boundary range runs past own_cap"
    split_rows, split_bwd_rows = {}, {}
    for d in (64, 128):
        x = rng.normal(0, 1, (4, pg.max_nodes, d)).astype(np.float32)
        gq = rng.normal(0, 1, (4, pg.own_cap, d)).astype(np.float32)
        for half, bh, rb in (("interior", bi, 0), ("boundary", bb, n_int)):
            split_rows[half, d] = run_kernel_case(
                sa, f"products-s split {half} D={d}", x, bh, pg.own_cap, rb,
                True, "float32", flush=flush, iters=30, record=shapes,
                repeat=True)
            split_bwd_rows[half, d] = run_bwd_case(
                sa, f"bwd products-s split {half} D={d}", gq, bh,
                pg.max_nodes, rb, True, "float32", flush=flush, iters=30,
                record=shapes, repeat=True)
    # f64 dyadic at products-s: the boundary half's last rows of the
    # partitions whose range runs past own_cap are dropped, bitwise
    run_kernel_case(sa, "products-s split boundary f64 dyadic D=64",
                    rng.integers(-8, 9, (4, pg.max_nodes, 64)).astype(
                        np.float64), bb, pg.own_cap, n_int, True, "float64",
                    flush=flush, iters=5, record=shapes, repeat=True)
    # the partition mesh's row-range use (a rank's overlapped forward): each
    # partition's rows of either half (partition_vjp_blocks: plans of their
    # own), the boundary half at the partition's n_int as a Python int;
    # every partition's launch of either kernel bitwise its rows of the
    # stacked launch, the boundary half of the partition with the most
    # edges timed against its plain version
    part_split_rows, part_split_bwd_rows = part_split_cases(
        torch, sa, pg, bi, bb, rng, flush, shapes)
    # blocks without the work plan, or with the plans of partition 0 alone
    # (kept from before stacking): the CUDA ops raise, naming the builders or
    # the rebuild, and launch nothing
    bare = {k: v for k, v in blk.items()
            if not any(k.endswith(p) for p in sa.PLAN_KEYS)}
    stale = dict(bare)
    for pre in ("", "t_"):
        stale.update(sa.block_row_work(sa.block_row_ptr(
            blk[pre + "dst"][0], blk[pre + "mask"][0], sa.BN), prefix=pre))
    x = torch.zeros((4, pg.max_nodes, 8), device="cuda")
    before = (sa.kernel_launch_count(), sa.bwd_kernel_launch_count())
    for what, host, msg in (("without the work plan", bare,
                             "build_mean_blocks"),
                            ("with a plan of another row space", stale,
                             "rebuild the plan")):
        dev = sa.blocks_to_device(host, "cuda")
        for label, op in (("forward", lambda: sa.segment_mean_op(
                x, dev, num_rows=pg.max_nodes)), ("backward", lambda:
                sa.segment_mean_bwd_op(x, dev, n_in=pg.max_nodes))):
            try:
                op()
            except ValueError as e:
                assert msg in str(e), e
            else:
                raise AssertionError(f"{label} op ran {what}")
        log(f"blocks {what}: forward and backward raise")
    assert (sa.kernel_launch_count(), sa.bwd_kernel_launch_count()) == before
    flash_rows, rms_rows = {}, {}
    for name, case in FLASH_CASES:
        for dtype_name in ("float32", "bfloat16"):
            flash_rows[name, dtype_name] = run_flash_case(
                fa, name, case, dtype_name, flush=flush, iters=10,
                record=shapes, main_path=name.startswith(MAIN_FLASH_CASES))
    for fused in (False, True):
        for shape in RMS_SHAPES:
            for dtype_name in ("float32", "bfloat16"):
                rms_rows[fused, shape, dtype_name] = run_rmsnorm_case(
                    rn, shape, dtype_name, flush=flush, iters=10,
                    record=shapes, fused=fused,
                    main_path=shape in RMS_MAIN_SHAPES)
    # the training path: flash attention's forward with the log-sum-exp and
    # its backward, RMSNorm's backward for both entry points
    log(f"phase 3's training kernels start at "
        f"{time.perf_counter() - t_all:.1f} s")
    flash_train_rows, rms_bwd_rows = {}, {}
    for name, case in FLASH_TRAIN_CASES:
        for dtype_name in ("float32", "bfloat16"):
            flash_train_rows[name, dtype_name] = run_flash_train_case(
                fa, name, case, dtype_name, flush=flush, iters=10,
                record=shapes, main_path=name in FLASH_TRAIN_MAIN)
    for fused in (False, True):
        for shape in RMS_TRAIN_SHAPES:
            for dtype_name in ("float32", "bfloat16"):
                rms_bwd_rows[fused, shape, dtype_name] = run_rmsnorm_bwd_case(
                    rn, shape, dtype_name, flush=flush, iters=10,
                    record=shapes, fused=fused,
                    main_path=shape == RMS_TRAIN_MAIN)

    # ---- 4. main path: GNN serving at products-s, P=4, hidden 128 ----------
    log(f"phase 4 starts at {time.perf_counter() - t_all:.1f} s")
    args = build_parser().parse_args(
        ["--gnn", "--dataset", "products-s", "--parts", "4", "--hidden",
         "128", "--ticks", "20", "--updates-per-tick", "4",
         "--queries-per-tick", "16", "--seed", "0", "--device", "cuda"])
    sa.reset_kernel_launch_count()
    t0 = time.perf_counter()
    run = gnn_main(args)
    srv, g, parts = run["engine"], run["graph"], run["parts"]
    adds, rems = pick_edge_edits(g, parts, srv)
    k_edit = sa.kernel_launch_count()
    for u, v in adds:
        assert srv.add_edge(u, v), ("edge already present", u, v)
    for u, v in rems:
        assert srv.remove_edge(u, v), ("edge absent", u, v)
    srv.submit([v for _, v in adds + rems])
    t_edit = time.perf_counter()
    _, edit_stats = srv.tick()
    torch.cuda.synchronize()
    t_edit = time.perf_counter() - t_edit
    launches = sa.kernel_launch_count()
    edit_launches = launches - k_edit
    main_s = time.perf_counter() - t0
    assert run["export_launches"] > 0, "export never launched the kernel"
    assert run["tick_launches"] > 0, "recompute never launched the kernel"
    assert edit_launches > 0, "edge-edit recompute never launched the kernel"
    assert srv.stats["halo_rows_grown"] >= 1, "no halo row grew"
    log(f"serve: {json.dumps({k: run[k] for k in ('p50_ms', 'p99_ms', 'qps', 'export_launches', 'tick_launches')})} "
        f"edit tick {t_edit * 1e3:.1f} ms ({edit_stats['rows_recomputed']} "
        f"rows, {edit_launches} launches), main path {main_s:.1f} s, "
        f"stats {json.dumps(srv.stats)}")

    # served logits vs a from-scratch plain-aggregation forward on the card
    served = srv.export_logits()
    g2 = apply_updates_to_graph(g, run["feature_updates"], adds, rems)
    pg2 = build_partitioned_graph(g2, parts, 4)
    eng2 = SPMDEngine(run["model"], None, None, pg2, None,
                      EngineConfig(use_kernel_agg=False, device="cuda"))
    ex2 = eng2.export_serving_state(run["model"])
    logits2 = ex2["logits"].cpu().numpy()
    want = np.zeros_like(served)
    for p in range(pg2.num_parts):
        n = int(pg2.n_own[p])
        want[pg2.global_ids[p][:n]] = logits2[p][:n]
    assert served.shape == (g.num_nodes, g.num_classes), served.shape
    assert np.isfinite(served).all(), "served logits not finite"
    serve_err = float(np.abs(served - want).max())
    n_bitwise = int((served == want).all(axis=1).sum())
    log(f"served vs from-scratch plain forward: max |diff| {serve_err:.3e} "
        f"(atol {SERVE_ATOL}, rtol {SERVE_RTOL}), rows bitwise "
        f"{n_bitwise}/{g.num_nodes}")
    np.testing.assert_allclose(served, want, atol=SERVE_ATOL, rtol=SERVE_RTOL)

    # where the main path's time goes: the export forward, kernel vs plain
    # aggregation, and cuBLAS's row-subset property
    eng = run["spmd"]
    ex_k = lambda: eng.export_serving_state(run["model"])
    ex_p = lambda: eng2.export_serving_state(run["model"])
    times = {}
    for label, fn in (("plain", ex_p), ("kernel", ex_k), ("kernel2", ex_k),
                      ("plain2", ex_p)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"export forward ms (host clock, synchronised): {json.dumps(times)}")
    subset = rows_subset_bitwise(torch, 4 * pg.max_nodes, 128, 128,
                                 (2, 16, 256, 4096))
    log(f"cuBLAS row-subset bitwise (A {4 * pg.max_nodes}x128 @ 128x128): "
        f"{json.dumps(subset)}")
    profile_ticks(torch, srv, g, 10, seed=1)
    del srv, eng, eng2, run

    # ---- 5. main path: training at products-s, P=4, hidden 128 ------------
    log(f"phase 5 starts at {time.perf_counter() - t_all:.1f} s")
    # a warm-up run first (CUDA modules, cuBLAS handles, pinned pools), so
    # the epoch times below are steady-state; its launches are not counted
    from repro_torch.launch.train import run_gnn
    run_gnn(train_args("--epochs", "2", "--phase0-frac", "0.5",
                       "--full-graph-train"))
    with EpochClock(torch) as clock_s:
        res_s, fwd_s, _ = train_run(torch, sa, "sampled", "--epochs", "6",
                                    "--phase0-frac", "0.5")
    res_f, fwd_f, bwd_f = train_run(torch, sa, "full-graph", "--epochs", "6",
                                    "--phase0-frac", "0.5",
                                    "--full-graph-train")
    res_c, fwd_c, bwd_c = train_run(torch, sa, "centralized full-graph",
                                    "--epochs", "3", "--centralized",
                                    "--full-graph-train")
    assert res_s.phase1_epochs > 0 and res_f.phase1_epochs > 0
    # the async run: every epoch of both phases drawn on the card
    from repro_torch.core.sampler import (device_draw_count,
                                          reset_device_draw_count)
    reset_device_draw_count()
    with EpochClock(torch) as clock_a:
        res_a, fwd_a, _ = train_run(torch, sa, "async", "--epochs", "6",
                                    "--phase0-frac", "0.5",
                                    "--async-generalize",
                                    "--async-personalize")
    draws = device_draw_count()
    assert res_a.phase1_epochs > 0, "async phase 1 never ran"
    assert res_a.host_draws_phase0 == res_a.host_draws_phase1 == 0, (
        res_a.host_draws_phase0, res_a.host_draws_phase1)
    assert draws == res_a.epochs_run, (draws, res_a.epochs_run)
    log(f"async run: device draws {draws}, host draws 0 and 0, "
        f"host-to-device bytes phase 0 {res_a.host_to_device_bytes_phase0} "
        f"phase 1 {res_a.host_to_device_bytes_phase1}")
    train_fwd, train_bwd = fwd_s + fwd_f + fwd_c + fwd_a, bwd_f + bwd_c
    # the overlapped split forward: two row-range launches a layer
    res_of, fwd_of, bwd_of = train_run(
        torch, sa, "overlap full-graph", "--epochs", "6", "--phase0-frac",
        "0.5", "--full-graph-train", "--overlap-halo", halves=2)
    res_or, fwd_or, _ = train_run(
        torch, sa, "overlap sampled", "--epochs", "6",
        "--phase0-frac", "0.5", "--overlap-halo", "--ring-chunks", "2",
        halves=2)
    assert res_of.phase1_epochs > 0 and res_or.phase1_epochs > 0
    assert res_or.phase0_iter_history == res_s.phase0_iter_history
    log(f"overlap runs beside the synchronous ones: full-graph losses "
        f"{np.round(res_of.loss_history, 6).tolist()} vs "
        f"{np.round(res_f.loss_history, 6).tolist()}, micro-F1 "
        f"{res_of.f1.micro:.4f} vs {res_f.f1.micro:.4f}, epoch with eval "
        f"{res_of.epoch_time_with_eval_s * 1e3:.2f} vs "
        f"{res_f.epoch_time_with_eval_s * 1e3:.2f} ms; sampled "
        f"micro-F1 {res_or.f1.micro:.4f} vs {res_s.f1.micro:.4f}, epoch "
        f"with eval {res_or.epoch_time_with_eval_s * 1e3:.2f} vs "
        f"{res_s.epoch_time_with_eval_s * 1e3:.2f} ms")
    rows_fwd, rows_bwd = fwd_of + fwd_or, bwd_of
    overlap_checks(torch, pg, flush)
    fwd_k, bwd_k = sequential_vs_stacked(torch, sa)
    train_fwd, train_bwd = train_fwd + fwd_k, train_bwd + bwd_k
    # the halo cache and compressed communication (ROADMAP item 10)
    train_fwd += comm_checks(torch, sa, pg, flush, card, res_s)
    # the two-tier feature store and the streamed eval (ROADMAP item 11)
    fs_fwd, part_fwd = featstore_checks(torch, sa, flush, card, res_s, res_a)
    train_fwd += fs_fwd
    # checkpoint/resume, fault injection and float64 runs (ROADMAP item 12)
    rb_fwd, rb_bwd = robustness_checks(torch, sa, card)
    train_fwd, train_bwd = train_fwd + rb_fwd, train_bwd + rb_bwd
    # the partition mesh (ROADMAP item 14): the ranks' pipelines launch the
    # single-partition use of both kernels, and the overlapped one (part
    # 3) their row-range single-partition use
    mesh_fwd, mesh_bwd, mesh_rows_fwd, mesh_rows_bwd = mesh_checks(torch,
                                                                   card)
    # not part of the main path: the plain aggregation, for comparison
    res_p = run_gnn(train_args("--epochs", "6", "--phase0-frac", "0.5",
                               "--no-kernel-agg"))
    assert res_p.phase0_iter_history == res_s.phase0_iter_history
    f1_diff = abs(res_p.f1.micro - res_s.f1.micro)
    log(f"sampled run, kernel vs plain aggregation: iteration history "
        f"{res_s.phase0_iter_history} both, micro-F1 {res_s.f1.micro:.4f} vs "
        f"{res_p.f1.micro:.4f} (|diff| {f1_diff:.4f}, limit {F1_ATOL}), "
        f"epoch with eval {res_s.epoch_time_with_eval_s * 1e3:.2f} vs "
        f"{res_p.epoch_time_with_eval_s * 1e3:.2f} ms")
    assert f1_diff <= F1_ATOL, f1_diff
    staged = async_epoch_profiles_fresh()
    async_vs_host(res_s, clock_s, res_a, clock_a, staged)
    fullgraph_step_checks(torch, pg, flush)
    del flush

    # ---- 6. main path: transformer serving, qwen2-0.5b at full width -------
    log(f"phase 6 starts at {time.perf_counter() - t_all:.1f} s")
    llm_flash, llm_rms = llm_phase(torch, fa, rn)

    # ---- 6b. main path: the rest of the decoder zoo at full width ---------
    log(f"phase 6b starts at {time.perf_counter() - t_all:.1f} s")
    zoo_launches = zoo_phase(torch, fa, rn, card)

    # ---- 7. main path: transformer training, qwen2-0.5b at full width ------
    log(f"phase 7 starts at {time.perf_counter() - t_all:.1f} s")
    train_flash, train_rms = llm_train_phase(torch, fa, rn, card)

    # ---- 7b. main path: the sharded steps on a mesh (ROADMAP 15.7) --------
    log(f"phase 7b starts at {time.perf_counter() - t_all:.1f} s")
    shard_launches = shard_checks(torch, card)

    # ---- 7c. the dry run and the roofline on the card (ROADMAP 15.8) ------
    log(f"phase 7c starts at {time.perf_counter() - t_all:.1f} s")
    dry_launches = dryrun_phase(torch, fa, rn, card)

    # ---- 7d. main path: training the MoE and Mamba2 families (15.9) -------
    log(f"phase 7d starts at {time.perf_counter() - t_all:.1f} s")
    zoo_train = zoo_train_phase(torch, fa, rn, card)

    # ---- 7e. main path: training whisper and paligemma (15.10) -----------
    log(f"phase 7e starts at {time.perf_counter() - t_all:.1f} s")
    encdec_train = encdec_train_phase(torch, fa, rn, card)
    # the training forward and backward launches of phases 7, 7c, 7d and
    # 7e (paligemma's Dh 256 flash launches apart)
    train_all = {k: train_flash.get(k, 0) + train_rms.get(k, 0)
                 + dry_launches[k] + zoo_train[k] + encdec_train[k]
                 for k in zoo_train}

    # ---- 8. report ---------------------------------------------------------
    log(f"phase 8 starts at {time.perf_counter() - t_all:.1f} s")
    main_row, bwd_row = main_rows[128], bwd_rows[128]
    log(f"launches: serving fwd {launches}; training fwd {train_fwd} "
        f"bwd {train_bwd}; overlapped split forward (row-range use) fwd "
        f"{rows_fwd} bwd {rows_bwd}; single-partition use: streamed eval "
        f"fwd {part_fwd}, partition mesh ranks fwd {mesh_fwd} bwd "
        f"{mesh_bwd}; row-range single-partition use (the mesh ranks' "
        f"overlapped forward) fwd {mesh_rows_fwd} bwd {mesh_rows_bwd}; llm "
        f"serving flash {llm_flash} rmsnorm {llm_rms}; the zoo's serving "
        f"{zoo_launches}; llm training flash {train_flash} rmsnorm "
        f"{train_rms}; the sharded steps {shard_launches}; the roofline "
        f"step {dry_launches}; the zoo's training {zoo_train}; whisper's "
        f"and paligemma's training {encdec_train}")
    kernels = [{
        "name": "segment_mean_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_agg.cu",
        "replaces": SEGMENT_AGG_TPU, "launches": launches + train_fwd,
        "max_abs_err": max(r["max_abs_err"] for r in main_rows.values()),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        "name": "segment_mean_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_agg.cu",
        "replaces": SEGMENT_AGG_BWD_TPU, "launches": train_bwd,
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
        "ms": bwd_row["kernel_ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_us"] / 1e3,
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"]}]
    # the row-range use on the overlapped forward's path: the boundary half
    # at D=128 (per-partition row_base; the interior half is in the log);
    # the streamed eval's single-partition use at D=128 (D=64 in the log);
    # the mesh's row-range single-partition use: the boundary half of one
    # partition at its n_int, D=128
    for name, tpu, rows, key, n in (
            ("segment_mean_fwd_rows", SEGMENT_AGG_ROWS_TPU, split_rows,
             ("boundary", 128), rows_fwd),
            ("segment_mean_bwd_rows", SEGMENT_AGG_BWD_TPU, split_bwd_rows,
             ("boundary", 128), rows_bwd),
            ("segment_mean_fwd_partition", SEGMENT_AGG_TPU, part_rows, 128,
             part_fwd + mesh_fwd),
            ("segment_mean_bwd_partition", SEGMENT_AGG_BWD_TPU, part_bwd_rows,
             128, mesh_bwd),
            ("segment_mean_fwd_rows_partition", SEGMENT_AGG_ROWS_TPU,
             part_split_rows, 128, mesh_rows_fwd),
            ("segment_mean_bwd_rows_partition", SEGMENT_AGG_BWD_TPU,
             part_split_bwd_rows, 128, mesh_rows_bwd)):
        row = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/segment_agg.cu",
            "replaces": tpu, "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # the main path's shapes in its working type: flash attention's prefill
    # (tensor cores) and decode (split over the KV length) designs, the
    # prefill's (B·S, d_model) rows for both RMSNorm entry points (the
    # decode rows are in the log); then the Dh 256 instantiations of both
    # flash designs at paligemma-3b's shapes (the prefill with its prefix),
    # their launches those of the paligemma run
    rms_errs = {f: [r["max_abs_err"] for (g, c, _), r in rms_rows.items()
                    if g == f and c in RMS_MAIN_SHAPES] for f in (False, True)}
    for name, source, tpu, row, n, errs in (
            ("flash_attention", "flash_attention.cu", FLASH_TPU,
             flash_rows["qwen2-0.5b prefill", "bfloat16"],
             llm_flash["prefill"] + zoo_launches["prefill"]
             + shard_launches["prefill"],
             [r["max_abs_err"] for (c, _), r in flash_rows.items()
              if c == "qwen2-0.5b prefill"]),
            ("flash_attention_decode", "flash_attention.cu", FLASH_TPU,
             flash_rows["qwen2-0.5b decode", "bfloat16"],
             llm_flash["decode"] + zoo_launches["decode"]
             + shard_launches["decode"],
             [r["max_abs_err"] for (c, _), r in flash_rows.items()
              if c == "qwen2-0.5b decode"]),
            ("flash_attention_dh256_prefix", "flash_attention.cu", FLASH_TPU,
             flash_rows["paligemma-3b prefill", "bfloat16"],
             zoo_launches["prefill_dh256"],
             [r["max_abs_err"] for (c, _), r in flash_rows.items()
              if c == "paligemma-3b prefill"]),
            ("flash_attention_decode_dh256", "flash_attention.cu", FLASH_TPU,
             flash_rows["paligemma-3b decode", "bfloat16"],
             zoo_launches["decode_dh256"],
             [r["max_abs_err"] for (c, _), r in flash_rows.items()
              if c == "paligemma-3b decode"]),
            ("rmsnorm", "rmsnorm.cu", RMSNORM_TPU,
             rms_rows[False, (4, 2048, 896), "bfloat16"],
             llm_rms["rmsnorm"] + zoo_launches["rmsnorm"]
             + shard_launches["rmsnorm"] + train_all["rmsnorm"],
             rms_errs[False]),
            ("add_rmsnorm", "rmsnorm.cu", RMSNORM_TPU,
             rms_rows[True, (4, 2048, 896), "bfloat16"],
             llm_rms["add_rmsnorm"] + zoo_launches["add_rmsnorm"]
             + shard_launches["add_rmsnorm"] + train_all["add_rmsnorm"],
             rms_errs[True])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}", "replaces": tpu,
            "launches": n, "max_abs_err": max(errs),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # the training path at qwen2-0.5b's training shape in bf16: the forward
    # with the log-sum-exp, the flash backward, and the RMSNorm backward of
    # both entry points at the (8, 512, 896) rows; then both flash launches'
    # Dh 256 instantiations with the prefix at paligemma-3b's training shape
    # (whisper-small's shapes run the Dh 64 ones: their rows are in the log)
    train_main = ("qwen2-0.5b train", "bfloat16")
    pali = ("paligemma-3b train", "bfloat16")
    dh256 = [r for (c, _), r in flash_train_rows.items()
             if c.startswith(("dh 256", "paligemma"))]
    for name, source, tpu, row, n, errs in (
            ("flash_attention_train_dh256_prefix", "flash_attention.cu",
             FLASH_TPU, flash_train_rows[pali][0],
             encdec_train["train_dh256"], [r[0]["max_abs_err"]
                                           for r in dh256]),
            ("flash_attention_bwd_dh256_prefix", "flash_attention_bwd.cu",
             FLASH_TPU, flash_train_rows[pali][1],
             encdec_train["backward_dh256"], [r[1]["max_abs_err"]
                                              for r in dh256]),
            ("flash_attention_train", "flash_attention.cu", FLASH_TPU,
             flash_train_rows[train_main][0],
             train_all["train"] + shard_launches["train"],
             [r[0]["max_abs_err"] for r in flash_train_rows.values()]),
            ("flash_attention_bwd", "flash_attention_bwd.cu", FLASH_TPU,
             flash_train_rows[train_main][1],
             train_all["backward"] + shard_launches["backward"],
             [r[1]["max_abs_err"] for r in flash_train_rows.values()]),
            ("rmsnorm_bwd", "rmsnorm.cu", RMSNORM_TPU,
             rms_bwd_rows[False, RMS_TRAIN_MAIN, "bfloat16"],
             train_all["rmsnorm_bwd"] + shard_launches["rmsnorm_bwd"],
             [r["max_abs_err"] for (f, _, _), r in rms_bwd_rows.items()
              if not f]),
            ("add_rmsnorm_bwd", "rmsnorm.cu", RMSNORM_TPU,
             rms_bwd_rows[True, RMS_TRAIN_MAIN, "bfloat16"],
             train_all["add_rmsnorm_bwd"] + shard_launches["add_rmsnorm_bwd"],
             [r["max_abs_err"] for (f, _, _), r in rms_bwd_rows.items()
              if f])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}", "replaces": tpu,
            "launches": n, "max_abs_err": max(errs),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_us"] / 1e3, "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-async-epochs"]:
        import torch
        async_epoch_profiles(torch)
        sys.exit(0)
    sys.exit(main())

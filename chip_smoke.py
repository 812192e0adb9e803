#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's paths on the card and holds every kernel on them
against its plain PyTorch version:

* the co-design sweep (``repro_torch``: trace -> augmented task graph ->
  FrozenGraph -> candidate-axis lockstep replay -> ranked
  ExplorationResult) with ``Explorer(engine="torch")``, through the
  hand-written fused step kernel (a whole step of the scan, one block a
  lane, one launch a step), each result held against the port's exact
  host engine (``engine="batch"``);
* the same sweep as a service (``repro_torch.serve.sweepd``): torch
  requests over HTTP to a server on the card, eight at once, and the
  CLI's server drained by SIGTERM;
* the paper's tile accelerators (``csrc/tiles.cu``): Fig. 6's traditional
  build-and-run flow through a fresh build of the ``mxmBlock`` GEMM tile
  per candidate, and the Fig. 4 Cholesky through the dsyrk, dgemm and
  dtrsm tiles;
* the LM serve path (``repro_torch.serve.engine.Engine``) on qwen3-0.6b
  at its published full width, in bf16 with weights drawn from a seeded
  ``torch.Generator``, through the hand-written flash-attention kernel on
  every prefill: ``csrc/flash_attention_wgmma.cu`` (``wgmma`` products,
  TMA-fed K/V ring) for bf16 at D 64/128/256, ``csrc/flash_attention.cu``
  (f32 FMAs) for every other call;
* RWKV6 serving (the same ``Engine``) on rwkv6-1.6b at its published full
  width, in bf16 from a seeded ``torch.Generator``, through the
  hand-written linear-attention kernels on every prefill, routed by
  ``linear_attn.kernel_for``: ``csrc/linear_attn_tc.cu`` (chunks in
  parallel, the decay factored at sub-chunks of 16, bf16 products on
  tensor cores) at dk = dv = 64 and chunk 16/32/64, ``csrc/linear_attn.cu``
  (chunks one after another) for every other call; and the plain
  per-token recurrence on every decode step;
* zamba2 serving (the same ``Engine``) on zamba2-1.2b at its published
  full width, in bf16 from a seeded ``torch.Generator``: 38 Mamba2 layers,
  each prefill's linear attention in f32 through ``linear_attn_tc.cu``
  (64 heads of 64, d_state 64, zamba2's decays, u = 0), and one
  weight-shared attention block at six sites through the ``wgmma`` flash
  kernel (32 heads of 64, no GQA grouping);
* MoE serving (the same ``Engine``) on mixtral-8x22b at its published
  width (d 6144, 48 heads over 8, ff 16384, 8 experts, top 2, vocab
  32,768) cut to 4 of its 56 layers, in bf16 from a seeded
  ``torch.Generator``: every prefill's attention (GQA 6:1, window 4096)
  through the ``wgmma`` flash kernel, the routed experts in f32 as in
  the JAX package;
* patch-token serving on pixtral-12b at its published width and depth
  (40 layers, 12.2 B parameters), in bf16 from a seeded
  ``torch.Generator``: text-only through ``Engine.run`` (as the JAX
  engine serves it), then with 256 seeded patch embeddings before each
  prompt through ``make_prefill_step`` and the engine's decode runner,
  every prefill's attention (GQA 4:1, D 128) through the ``wgmma`` flash
  kernel;
* encoder-decoder serving on whisper-tiny at its published width, with
  1500 seeded frames a request, through the same step entry points: the
  decoder's causal self-attention through the ``wgmma`` flash kernel (D
  64), the encoder and the cross-attention through
  ``attention_chunked`` (a fixed route: the kernels refuse the encoder's
  padded, non-causal keys);
* the estimator's cost model on the card: ``TorchCostModel``'s
  prediction (counted on ``meta`` tensors) of qwen3-0.6b's and mixtral's
  prefill and decode step set against their measured device time, and
  the step estimator (``core/steptask.py``) from probes at 1 and 2
  mixtral layers set against the measured 4-layer prefill;
* training (``repro_torch.train``) on qwen3-0.6b at its published width
  on the chunked route (the JAX package's training arithmetic: no
  kernel has a backward, and the train step launches none).

Phases, one line each or more:

1. the card (``nvidia-smi`` name and power limit, torch's name, count);
   TF32 is switched off for f32 products (the plain versions run in full
   f32);
2. the kernel builds, all started together (seconds, ``-Xptxas -v``
   registers and spills): ``lockstep_step.cu``, ``tiles.cu`` at ``TILE``
   64 and 128, ``flash_attention.cu``, ``flash_attention_wgmma.cu``,
   ``linear_attn.cu`` and ``linear_attn_tc.cu``;
3. the standalone step_commit == plain PyTorch version, bit for bit, on
   seeded states, with all-``inf`` pools and ties;
4. the tile kernels == plain versions within tolerance at every path
   shape: ``block_matmul`` at (64,64,64) and (128,128,128) in f32 and
   bf16, ``syrk_tile`` and ``gemm_update`` at (64, 64), ``trsm_tile`` at
   (64, 64) with panel 16; ``flash_attention`` == plain version at the
   serve path's shape (16, 8, 512, 512, 128) bf16 causal (GQA 2:1), a
   padded length through ``ops.attention`` (T = S = 300), gemma2's local
   layer (8 heads over 4, D 256, window 256, softcap 50) and in f32;
   the ``wgmma`` kernel == plain version at D 64 (causal GQA 2:1, and
   windowed with softcap) and at T = S = 1024, and the FMA kernel in
   bf16 at D 96, each call on the kernel ``kernel_for`` names;
   ``linear_attn`` == plain version (output and final state) at the
   RWKV6 path's shape (32, 512, 64, 64) chunk 64 with bf16 r/k/v/u and
   f32 w, a padded length through ``ops.linear_attn`` (T = 300), strong
   decay (w <= 1e-6), Mamba2's scalar decay with u = 0, and in f32, all
   on the sub-chunked kernel, and a chunk of 7 at (3, 42, 16, 20) on the
   serial one, each call on the kernel ``kernel_for`` names; and at
   zamba2-1.2b's path shapes: ``flash_attention`` at (32, 32, 512, 512,
   64) bf16 causal on ``wgmma`` (``zamba2_path``); mixtral-8x22b's:
   ``flash_attention`` at (48, 8, 512, 512, 128) bf16 causal with window
   4096 (``mixtral_path``) and at (6, 1, 4608, 4608, 128) where the
   window bites (``mixtral_window``), both on ``wgmma``; pixtral-12b's at
   (32, 8, 512, 512, 128) and (32, 8, 768, 768, 128) and whisper-tiny's
   at (6, 6, 256, 256, 64), bf16 causal on ``wgmma``; ``linear_attn`` at
   (64, 512, 64, 64) chunk 64 in f32 with u = 0 and zamba2's decay
   spectrum (``exp(-softplus(z) · linspace(1, 16, 64)[row % 64])``, held
   at the strong-decay tolerance, ``mamba2_path``) on the sub-chunked
   kernel;
5. four sweeps, each torch sweep through the step loop's captured CUDA
   graphs (the compile cache's runners, ``repro_torch.core.graphcache``):
   ``trace_matmul(512, 64)`` with a 200-candidate slot ×
   ±SMP ramp (cold, then warm from the recorded orders), the same sweep
   with ``top_k=5, prune=True``, and ``trace_cholesky(512, 64)`` with the
   six Fig. 9 designs each at 1..8 accelerator slots — each ranking must
   agree with the batch engine's at ``TORCH_RTOL`` with the same best
   candidate, no engine demotion, kernel launches > 0 and lanes that went
   through the lockstep path; then ``[graph sweep]``:
   ``matmul512_200_warm`` and ``cholesky512_48_cold`` through the graphs
   of a fresh compile cache with a disk tier, then again warm: every
   result bit for bit, the replay protocol's counts and the fused step's
   launches equal both times; each slice of both sweeps run again
   eagerly (``torchsim._steps`` on a fresh state) bit for bit the
   runner's outputs, with the eager launches by shape equal to those
   credited at the graphs' replays; steps/s and candidates/s each time,
   captures, replays and capture seconds, 0 captures on the warm repeat,
   and each graph's device time a step by CUDA events; then a second
   Python process sweeps the
   Cholesky ramp on that store with 0 ``nvcc`` builds and every runner a
   disk hit;
6. the sweep service, with the step launch counts set to 0 just before
   each torch request phase and read just after: (a) an in-process
   ``SweepServer`` on the card answers one torch request over HTTP, the
   matmul trace inline with its bs = 64 report, ``accs "1-100"`` (200
   candidates), held ``rankings_equivalent`` to a ``batch`` request of
   the same body, its ``timings`` beside the one-shot cold sweep's; (b)
   eight concurrent clients of the Cholesky trace inline at ``accs
   "1-8"`` (16 candidates) against a fresh server's ``max_concurrent =
   4``: all 200, all equivalent to ``batch``, ``/healthz`` at 8 done, 0
   errors, 0 demotions, latency p50/p99; (c) ``python -m
   repro_torch.explore serve --device cuda`` in its own process answers
   (b)'s body through ``client`` (the trace file sent inline), then
   drains on SIGTERM with a second request in flight, which completes
   with the same best, and exits 0; (d) (b)'s best design through
   ``estimate`` (its makespan equal to ``batch``'s) and ``write_prv`` into
   ``chiprun_out/sweepd/``, and its Gantt chart;
7. the fused step at every ``(P, S, B)`` the sweeps and the service
   launched it at (phases 5 and 6 record the first slice of each step
   runner's shape): kernel == the plain body (``torchsim._plain_step``:
   on the card ~150 PyTorch kernels and the standalone commit a step)
   through that whole slice, every field of the state bit for bit after
   every 32 steps; a step through the wrapper, per bare launch and by
   the plain body by CUDA events, the device time of one bare launch
   behind a device spin and by ``torch.profiler``'s rows, and the whole
   step's byte bound at each.
   Then the standalone step_commit, which the path no longer launches:
   kernel == plain version at the same ``(P, S, B)``, per wrapper call
   and per bare launch by CUDA events (two passes in turns), the device
   time of one bare launch and the bound, at the commonest;
8. a warm Cholesky sweep plain and under ``torch.profiler`` (device busy
   share, kernels per step, the costliest host operations);
9. Fig. 6 at n = 512: the estimator (traces plus ``Explorer(engine=
   "torch")``) over the six traditional-flow candidates, then each
   candidate built afresh (seconds, registers, static shared memory and
   spills) and run; every product held to ``AA @ BB``;
10. ``cholesky_via_tiles(512, 64, panel=16)``: exactly 28 syrk, 56
    gemm_update and 28 trsm launches, ``UᵀU`` held to ``A``;
11. each tile kernel's time per wrapper call and per bare launch at each
    path shape by CUDA events, beside the one PyTorch call that computes
    the same function (the three timed twice in turns), its plain
    version's and its bound; and the device time of one bare launch and
    of one library call, from ``torch.profiler``'s kernel rows and from
    CUDA events around launches queued behind a device spin;
12. serve qwen3-0.6b (full width, bf16, seed 0) through ``Engine(slots=
    4)``: 8 requests of 512-token prompts, 32 new tokens each, with the
    flash counts set to 0 just before and read just after (224 launches,
    all at the path shape, all on the ``wgmma`` kernel); prefill tokens/s
    and decode ms per step; the
    kernel route's last-position prefill logits against the plain route's
    (``attn_impl="naive"``, same weights); and ``examples/serve_e2e.py``'s
    self-check: one teacher-forced ``forward`` per request over its
    served sequence (T = 543, padded to 640 by ``ops.attention``), where
    every served token's logit must be within ``SELFCHECK_TOL`` of its
    position's maximum; decode runs through the captured decode step
    (``Engine``'s compile cache), and the same traffic through the eager
    step in the same call must serve the same tokens with the same
    last-step logits (``[serve graphs]``: ms a step both ways, capture
    seconds); then one prefill and one decode step (eager, and one replay
    of the captured graph) under ``torch.profiler`` (device busy share,
    kernels, costliest operations);
    then the same for rwkv6-1.6b (the qwen model freed first), with the
    ``linear_attn`` counts set to 0 just before the served run and read
    just after (192 launches, all at the path shape, all on the
    sub-chunked kernel), the kernel route
    against ``attn_impl="chunked"`` (printed on the served bf16 weights,
    gated on the arch's f32 weights from the same seed: see
    ``ROUTE_ATOL``) and the self-check's forward padded to 576 by
    ``ops.linear_attn``; then the same for zamba2-1.2b (the rwkv6 model
    freed first), with both kernels' counts set to 0 just before the
    served run and read just after (304 ``linear_attn`` launches at
    (64, 512, 64, 64) chunk 64 f32, all sub-chunked; 48 flash launches
    at (32, 32, 512, 512, 64) bf16, all ``wgmma``), the kernel route
    against ``attn_impl="chunked"`` gated as rwkv6's is, and each
    kernel's share of a prefill's device time; then the same for
    mixtral-8x22b at 4 layers (the zamba2 model freed first), with the
    flash counts set to 0 just before the served run and read just after
    (32 launches at (48, 8, 512, 512, 128) bf16, all ``wgmma``), the
    kernel route against ``attn_impl="naive"`` gated on f32 weights (the
    f32 attention runs the FMA kernel) at 1e-3, and the MoE's share of a
    prefill's device time (``[serve moe]``: one layer's ``moe_apply``
    under ``torch.profiler``, times 4); then pixtral-12b at full depth
    (the mixtral model freed first): text-only as qwen3-0.6b (320 launches
    at (32, 8, 512, 512, 128), all ``wgmma``; the route gated on f32
    weights at full depth as mixtral's, the f32 copy built beside the
    bf16 one), then the same prompts with their patches (``[serve
    fused]``: 320 launches at (32, 8, 768, 768, 128) and no other shape,
    the captured decode step against the eager one, the route gated in
    f32, the self-check's forward with the patches); then whisper-tiny
    (the pixtral model freed first) with 256-token prompts and their
    frames, the same way (32 launches at (6, 6, 256, 256, 64) and none at
    T = 1500, the route gated in bf16, the encoder's ms a request apart
    from the whole prefill's); each serve phase's seconds;
12b. ``[cost model]``: a bf16 and an f32 ``torch.matmul`` at 8192^3 give
    the sustained fractions of the peaks; ``TorchCostModel`` at those
    fractions counts qwen3-0.6b's and mixtral's 512-token prefill and
    batch-4 decode step on ``meta`` and prints each prediction against the
    device time measured in phase 12 (not gated); ``[step estimate]``:
    the dry-run's probe records of mixtral at 1 and 2 layers (a fake (1,
    1) mesh), ``estimate_step`` at 4 layers against the measured prefill and at 56
    (the published depth), at the ``H100`` record's bf16 peak and at the
    f32 peak (not gated); each phase's seconds;
12c. ``[train]``: (a) qwen3-0.6b at full width with 2 layers in f32,
    one ``make_train_step`` step on the card and the same step on the
    CPU from the same weights and a ``SyntheticLM`` batch of 2 x 128:
    loss and grad norm within rtol 1e-4, the updated parameters within
    rtol 2e-3 / atol 2e-5; (b) on the card, ``remat`` ``full`` and
    ``dots`` against ``none`` (loss and gradients within 1e-5, each
    mode's peak memory, also at full depth on 8 x 512 in bf16), and
    ``accum_steps=2`` against 1 at JAX's bounds; (c) with deterministic
    algorithms on for this check only, the supervisor through failures
    at steps 6 and 11 with checkpoints every 4 equals an uninterrupted
    run within 1e-5 / 1e-6; (d) the full depth (28 layers, 596 M
    parameters) in bf16 with f32 moments on ``SyntheticLM`` batches of 8
    x 512, 20 steps through the supervisor with asynchronous checkpoints
    every 10 and a failure at step 13, every kernel's count set to 0
    just before and read just after (all 0): tokens/s, ms a step by CUDA
    events, peak memory, a 3-step ``torch.profiler`` window (kernels,
    device time, busy share), the mean of the last 5 losses below the
    first 5's; (e) ``ops.attention`` and ``ops.linear_attn`` on CUDA
    operands that require grad raise ``NotImplementedError`` and launch
    nothing; the phase's seconds; (d) keeps its checkpoints for 12d;
12d. the distribution layer: ``[parallel]``, a world of one over NCCL and
    a (1, 1) ("data", "model") mesh on the card, the [train] slice's last
    checkpoint restored with ``restore(shardings=param_shardings(...))``
    as DTensors and again as plain tensors, one AdamW step of each at full
    width and depth (losses within 1e-3 relative, parameters at rtol 2e-3
    / atol 2e-5), ms a step each way in turns and the peak memory, and
    ``make_overlapped_matmul`` at (4096, 1024) @ (1024, 3072) bf16 against
    ``torch.matmul``; ``[pipeline]``, qwen3-0.6b's 28 layers in 2 stages
    (``stage_slices``), 4 microbatches of 2 x 512 prompts through the
    default kernel route against the unstaged 8-prompt prefill at
    ``ROUTE_ATOL``, the ``wgmma`` flash launches of each run by shape from
    the wrapper's counters (one a layer a microbatch), and
    ``evaluate_pp`` for gpipe and 1f1b at the stage cost measured there;
    ``[dryrun]``, the port's dry-run, every cell in an interpreter of its
    own, all started together: (a) qwen3-0.6b's train step at 8 x 512 on a
    fake (1, 1) mesh, its predicted peak within 2x of [train]'s measured
    one, its FLOPs at the bf16 peak beside [train]'s ms a step; (b)
    qwen3-4b train_4k, mixtral-8x22b decode_32k, llama4-maverick
    prefill_32k, zamba2-1.2b long_500k and whisper-tiny train_4k at data=16
    x model=16, each timed, and ``roofline_table(analyze_all(...))`` over
    them at ``H100``; (c) mixtral-8x22b decode_32k at
    ``mesh_variant(32, 8)``; every cell a record, every FSDP record with a
    nonzero all-gather; each phase's seconds, then the whole smoke's;
13. ``flash_attention`` at the path shape by CUDA events, per wrapper
    call and per bare launch of the ``wgmma`` kernel, beside the bare
    launch of the FMA kernel (the earlier design, its output held to the
    plain version first), its plain version,
    ``F.scaled_dot_product_attention(..., is_causal=True,
    enable_gqa=True)`` and its bound, each timed twice in turns; and the
    device time of one launch of each, from ``torch.profiler``'s kernel
    rows and from CUDA events around launches queued behind a device
    spin at least twice as long as their enqueue; ``linear_attn`` at its
    path shape the same way, per wrapper call and per bare launch of each
    kernel (the sub-chunked one and the serial one, each output held to
    the plain version first), beside its plain version and its bound (no
    single PyTorch call computes it), and again at the f32 case of the
    same shape, which is what ``kernel_for``'s route for f32 rests on;
    both kernels the same way at zamba2-1.2b's path shapes, and the flash
    kernel at mixtral-8x22b's, pixtral-12b's two and whisper-tiny's;
14. a ``kernels`` JSON line (launches on the paths, error against the
    plain version, times and bound at the commonest path shape, and for
    the two attention kernels a row a serve path's shape) and
    candidates/s lines.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or without the port's sources beside this file, it prints no result and
exits non-zero.  Run: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# cuBLAS reads this when its handle is made: the train phase's replay (c)
# turns deterministic algorithms on, which need it; set before torch first
# touches the card.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

#: HBM3 rate of an H100 SXM (NVIDIA's data sheet), for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12

#: (P, S, B) states the kernel is held to its plain version at before the
#: sweeps: a wide and deep state, a four-pool one and a ragged one.  After
#: the sweeps it is held again at every shape they launched it at.
KERNEL_SHAPES = ((2, 64, 256), (4, 16, 256), (3, 5, 128))

#: Peak rates of an H100 SXM (NVIDIA's data sheet, dense): f32 on the CUDA
#: cores (a full-precision f32 product cannot use the TF32 tensor cores),
#: bf16 on the tensor cores.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

#: Fig. 6's and Fig. 4's width: the port's sweeps trace ``(512, 64)``.
TILE_N = 512

#: Tolerances of ``tests/test_kernels.py`` (kernel vs plain version).
MATMUL_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
SYRK_TOL = (1e-5, 1e-4)     # rtol, atol; gemm_update too
TRSM_TOL = 2e-4
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}     # rtol = atol

#: The serve path's flash launch: qwen3-0.6b's prefill of one 512-token
#: prompt, ``(BH, BKV, T, S, D)`` in bf16, causal.
FLASH_PATH = (16, 8, 512, 512, 128)

#: zamba2-1.2b's flash launch: its shared attention block's prefill of one
#: 512-token prompt, 32 heads over 32 (no GQA grouping), D 64, bf16,
#: causal, on the ``wgmma`` kernel.
ZAMBA2_FLASH_PATH = (32, 32, 512, 512, 64)

#: mixtral-8x22b served at its published width with its depth cut to 4 of
#: its 56 layers (56 layers are 141 B parameters, 282 GB in bf16: more
#: than one card holds; 4 are 10.4 B, 20.8 GB, and 41.7 GB in f32 for the
#: route check).
MIXTRAL_LAYERS = 4

#: mixtral-8x22b's flash launch: a layer's prefill of one 512-token
#: prompt, 48 heads over 8 (GQA 6:1), D 128, bf16, causal with its window
#: of 4096 (which a 512-token prompt does not reach), on ``wgmma``; and a
#: launch where the window bites, 4608 rows, whose first key tile for the
#: rows past 4096 does not start on a 64-row boundary.
MIXTRAL_FLASH_PATH = (48, 8, 512, 512, 128)
MIXTRAL_WINDOW = 4096
MIXTRAL_WINDOW_CASE = (6, 1, 4608, 4608, 128)

#: pixtral-12b's flash launches, served at full width and full depth (40
#: layers, 12,247,782,400 parameters, 24.5 GB in bf16): a layer's prefill
#: of one 512-token prompt, text only (as ``Engine.run`` serves it), and
#: of the same prompt behind its 256 patch embeddings (768 positions); 32
#: heads over 8 (GQA 4:1), D 128, bf16, causal, on ``wgmma``.
PIXTRAL_FLASH_PATH = (32, 8, 512, 512, 128)
PIXTRAL_FUSED_PATH = (32, 8, 768, 768, 128)

#: whisper-tiny's flash launch: a decoder layer's self-attention over a
#: 256-token prompt (256 + 32 new stays inside the published decoder's
#: 448-token context), 6 heads over 6, D 64, bf16, causal, on ``wgmma``.
#: Its encoder (1500 frames, non-causal) and its cross-attention run
#: ``attention_chunked``, a route fixed in the code, so no flash launch
#: has T = 1500.
WHISPER_PROMPT = 256
WHISPER_FLASH_PATH = (6, 6, WHISPER_PROMPT, WHISPER_PROMPT, 64)

#: The cost-model phase's square matmul edge: a bf16 and an f32
#: ``torch.matmul`` there give the sustained fractions of the peaks.
MATMUL_EFF_N = 8192

#: The flash kernels' further bf16 checks, beyond ``flash_cases``: label,
#: ``(BH, BKV, T, S, D)``, window, softcap (causal).  D 96 is the FMA
#: kernel's: its bf16 build is held to the plain version there.
ROUTE_CASES = (
    ("d64", (16, 8, 512, 512, 64), 0, 0.0),
    ("d64_window_softcap", (8, 4, 512, 512, 64), 100, 50.0),
    ("t1024", (16, 8, 1024, 1024, 128), 0, 0.0),
    ("fma_d96", (8, 4, 512, 512, 96), 0, 0.0),
)

#: The linear-attention kernel's path launch: rwkv6-1.6b's prefill of one
#: 512-token prompt, ``(BH, T, dk, dv)`` with chunk 64, bf16 r/k/v/u and
#: f32 w, on the sub-chunked kernel.
LINEAR_PATH = (32, 512, 64, 64)
LINEAR_CHUNK = 64

#: zamba2-1.2b's linear-attention launch: a Mamba2 layer's prefill of one
#: 512-token prompt, 64 heads of 64 with d_state 64, chunk 64, every
#: operand f32 (``v = dt·x`` is f32), u = 0, zamba2's decay spectrum; on
#: the sub-chunked kernel.
MAMBA2_PATH = (64, 512, 64, 64)

#: Tolerances (rtol = atol) of ``linear_attn`` against its plain version:
#: ``tests/test_kernels.py``'s 2e-4 in f32 and 1e-3 under strong decay;
#: bf16 outputs at 1e-2, above 2**-7 (one bf16 ulp relative: two
#: roundings of f32 values that agree to f32 precision differ by at most
#: that).  The final state is f32 in every case.
LINEAR_TOL = {"float32": 2e-4, "strong": 1e-3, "bfloat16": 1e-2}

#: The serve phases' traffic: requests, prompt length, new tokens, slots.
SERVE = {"requests": 8, "prompt_len": 512, "max_new": 32, "slots": 4}

#: The archs served at full width with that traffic: the kernels every
#: prefill must go through (each by its wrapper's launch key, with its
#: path shape key, the kernel ``kernel_for`` routes it to, and its
#: launches a prefill: one a layer, or one a shared site), the plain route
#: the kernel route is held to, and the weights' type of the model that
#: route check is gated on.  An arch with ``fused`` is served again (or,
#: with ``engine_run`` false, only) with seeded patches or frames in each
#: prefill batch, through the step entry points (:func:`fused_flow`):
#: ``Engine.run`` feeds tokens alone, as the JAX engine does, so it serves
#: pixtral text-only and cannot serve whisper.
SERVE_MODELS = (
    {"arch": "qwen3-0.6b", "plain_impl": "naive", "route_dtype": "bfloat16",
     "kernels": ({"kernel": "flash_attention",
                  "path_key": (*FLASH_PATH, "torch.bfloat16"),
                  "variant": "wgmma", "per": "n_layers"},)},
    {"arch": "rwkv6-1.6b", "plain_impl": "chunked", "route_dtype": "float32",
     "kernels": ({"kernel": "linear_attn",
                  "path_key": (*LINEAR_PATH, LINEAR_CHUNK, "torch.bfloat16"),
                  "variant": "subchunk", "per": "n_layers"},)},
    {"arch": "zamba2-1.2b", "plain_impl": "chunked", "route_dtype": "float32",
     "kernels": ({"kernel": "linear_attn",
                  "path_key": (*MAMBA2_PATH, LINEAR_CHUNK, "torch.float32"),
                  "variant": "subchunk", "per": "n_layers"},
                 {"kernel": "flash_attention",
                  "path_key": (*ZAMBA2_FLASH_PATH, "torch.bfloat16"),
                  "variant": "wgmma", "per": "n_shared_sites"})},
    {"arch": "mixtral-8x22b", "n_layers": MIXTRAL_LAYERS,
     "plain_impl": "naive", "route_dtype": "float32",
     "kernels": ({"kernel": "flash_attention",
                  "path_key": (*MIXTRAL_FLASH_PATH, "torch.bfloat16"),
                  "variant": "wgmma", "per": "n_layers"},)},
    {"arch": "pixtral-12b", "plain_impl": "naive", "route_dtype": "float32",
     "kernels": ({"kernel": "flash_attention",
                  "path_key": (*PIXTRAL_FLASH_PATH, "torch.bfloat16"),
                  "variant": "wgmma", "per": "n_layers"},),
     "fused": {"input": "patches", "prompt_len": SERVE["prompt_len"],
               "path_key": (*PIXTRAL_FUSED_PATH, "torch.bfloat16")}},
    {"arch": "whisper-tiny", "plain_impl": "naive", "route_dtype": "bfloat16",
     "engine_run": False,
     "kernels": ({"kernel": "flash_attention",
                  "path_key": (*WHISPER_FLASH_PATH, "torch.bfloat16"),
                  "variant": "wgmma", "per": "n_layers"},),
     "fused": {"input": "frames", "prompt_len": WHISPER_PROMPT,
               "path_key": (*WHISPER_FLASH_PATH, "torch.bfloat16")}},
)

#: Limits of the serve phase, on logits (f32 after the unembedding): the
#: kernel route's last-position prefill logits against the plain route's
#: (max abs difference), by the weights' type of the gated model, and a
#: served token's logit below its position's maximum when the served
#: sequence is fed back (bf16; :func:`teacher_forced`).  The bf16 limit is
#: gated for qwen3-0.6b.  rwkv6-1.6b's bf16 routes differ by the model's
#: own rounding noise (its plain route against itself at half the chunk
#: moves the logits by 0.19), so its route is gated on the same arch with
#: f32 weights, where every pair of routes agrees within 4.1e-5
#: (``tools/route_noise.py``); its bf16 difference is printed, not gated.
#: zamba2-1.2b and mixtral-8x22b are gated the same way: mixtral's two
#: plain routes differ by 0.051 in bf16 and the kernel route by 0.121,
#: each flipping hundreds of its 32,768 routing decisions, while in f32
#: every pair agrees within 1.0e-5 and flips none.  pixtral-12b too: at
#: its 40 layers its two plain routes differ by 0.066 in bf16 on the
#: text-only prompts and by 0.086 behind the patches (the kernel route by
#: 0.078 and 0.098, logits up to 5.1), too close to 0.1 to tell a kernel
#: fault from the model's noise, while in f32 every pair agrees within
#: 2.4e-5 (its f32 copy, 49 GB, is built beside the served bf16 one, 24.5
#: GB).  whisper-tiny is gated in bf16: its plain routes differ by 0.012
#: and the kernel route by 0.016 (logits up to 1.9; f32 1.0e-6).
ROUTE_ATOL = {"bfloat16": 0.1, "float32": 1e-3}
SELFCHECK_TOL = 0.1

#: The train phase (``[train]``): qwen3-0.6b at its published width on the
#: chunked route (the JAX package's training arithmetic: the kernels have
#: no backward).  (a)-(c) run 2 of its layers in f32 on a SyntheticLM
#: batch of 2 x 128; (c) replays 14 steps with checkpoints every 4 and
#: failures injected at steps 6 and 11 (JAX's ``test_fault_tolerance``);
#: (d) trains the full depth in bf16 with f32 moments on batches of 8 x
#: 512 for 20 steps through the supervisor, asynchronous checkpoints
#: every 10 steps (keep 2) and one failure injected at step 13, then
#: profiles 3 more steps.
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_CHECK = {"n_layers": 2, "batch": 2, "seq": 128}
TRAIN_REPLAY = {"steps": 14, "ckpt_every": 4, "fail_at": (6, 11)}
TRAIN_SLICE = {"batch": 8, "seq": 512, "steps": 20, "ckpt_every": 10,
               "fail_at": 13, "lr": 3e-3, "profile_steps": 3}
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
#: Where (d) keeps its checkpoints, which the [parallel] phase restores.
SLICE_CKPT = TRAIN_DIR / "slice"

#: The train phase's bounds: JAX's for two equivalent steps
#: (``tests/test_train_step.py:85-87``: loss rtol 1e-5 for accumulation,
#: updated parameters rtol 2e-3 / atol 2e-5); the card's loss and grad
#: norm against the CPU's at rtol 1e-4; the remat modes' loss and
#: gradients within 1e-5 (rtol and atol); the replay's parameters against
#: the uninterrupted run's at JAX's ``test_fault_tolerance`` bounds.
TRAIN_STEP_TOL = {"loss": 1e-4, "accum_loss": 1e-5, "params": (2e-3, 2e-5)}
REMAT_TOL = 1e-5
REPLAY_TOL = (1e-5, 1e-6)

#: The distribution phases.  [parallel]: a world of one over NCCL, a
#: (1, 1) ("data", "model") mesh on the card; the [train] slice's last
#: checkpoint restored twice, as DTensors laid out by ``param_shardings``
#: and as plain tensors, then one AdamW step of each on a SyntheticLM batch
#: of 8 x 512 (bf16, f32 moments, chunked); their losses within 1e-3
#: relative and parameters at JAX's rtol 2e-3 / atol 2e-5; 3 more steps
#: each way timed in turns; ``make_overlapped_matmul`` at qwen3-0.6b's MLP
#: width against ``torch.matmul`` at ``MATMUL_RTOL``.
PARALLEL = {"timed_steps": 3}
PARALLEL_TOL = {"loss": 1e-3, "params": (2e-3, 2e-5)}
OVERLAP_SHAPE = (4096, 1024, 3072)          # x (M, K) @ w (K, N), bf16
#: [pipeline]: qwen3-0.6b's 28 layers in 2 stages (``stage_slices``), 4
#: microbatches of 2 prompts of 512 through the default "kernel" route,
#: against the unstaged 8-prompt prefill at ``ROUTE_ATOL``.
PIPELINE = {"stages": 2, "micro": 4, "prompts": 8, "seq": 512}
#: [dryrun]: (a) qwen3-0.6b's train step at the [train] slice's 8 x 512 on
#: a fake (1, 1) mesh, its predicted peak within a factor of 2 of the
#: slice's measured one; (b) published cells at data=16 x model=16; (c)
#: one at mesh_variant(32, 8).  Each cell runs in an interpreter of its
#: own (the fake process group is process-wide), all at once.
DRYRUN_CELLS = (("qwen3-4b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
                ("llama4-maverick-400b-a17b", "prefill_32k"),
                ("zamba2-1.2b", "long_500k"), ("whisper-tiny", "train_4k"))
DRYRUN_VARIANT = ("mixtral-8x22b", "decode_32k", (32, 8))
DRYRUN_PEAK_FACTOR = 2.0
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_CELL = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import Shape
from repro_torch.launch import dryrun
spec = json.loads(sys.argv[2])
dryrun.ARTIFACTS = Path(spec["artifacts"])
rec = dryrun.run_cell(spec["arch"], spec["shape_name"], False,
                      mesh_override=(tuple(spec["sizes"]),
                                     tuple(spec["names"])),
                      device=spec["device"], save=spec["save"],
                      shape_override=(Shape(**spec["shape"])
                                      if spec["shape"] else None))
print("RECORD " + json.dumps(rec))
"""


#: The sweep-service phase: concurrent clients of (b) against the
#: server's default ``max_concurrent`` (4), and where its files go (the
#: trace and reports (c)'s client sends, and (d)'s Paraver files).
SWEEPD_CLIENTS = 8
SWEEPD_DIR = ROOT / "build" / "chip_smoke_sweepd"
PARAVER_DIR = ROOT / "chiprun_out" / "sweepd"

#: The graph-sweep phase's compile-cache roots (one a sweep), emptied at
#: the start of the phase.
GRAPH_DIR = ROOT / "build" / "chip_smoke_graphs"

#: The second process of the graph-sweep phase: the Cholesky sweep on the
#: first process's store, printing its cache counters and nvcc runs.
SECOND_PROCESS = """
import json, sys
sys.path.insert(0, sys.argv[2])
from repro_torch.apps import cholesky as ch
from repro_torch.core import Explorer, a9_smp_seconds, zynq_system
from repro_torch.core.diskcache import DiskCache
from repro_torch.core.explore import Candidate
from repro_torch.core.graphcache import CompileCache
from repro_torch.kernels import build
sys.path.insert(0, sys.argv[3])
from chip_smoke import cholesky_ramp
cc = CompileCache(DiskCache(sys.argv[1]))
ex = Explorer(ch.trace_cholesky(n=512, bs=64), ch.report_map(bs=64),
              engine="torch", smp_seconds_fn=a9_smp_seconds("float64"),
              compile_cache=cc)
res = ex.explore(cholesky_ramp(ch, zynq_system, Candidate, 8), top_k=3)
print(json.dumps({"cc": cc.as_dict(), "nvcc": build.BUILDS,
                  "rebuilds": build.REBUILDS, "best": res.best_name}))
"""


#: Every phase line also goes here, whole: a run's printed output is
#: often read only from its end.
PHASE_LOG = ROOT / "chiprun_out" / "chip_smoke_phases.log"


def phase(name: str, text: str) -> None:
    line = f"[{name}] {text}"
    print(line, flush=True)
    PHASE_LOG.parent.mkdir(parents=True, exist_ok=True)
    with PHASE_LOG.open("a") as f:
        f.write(line + "\n")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_state(rng, P: int, S: int, B: int):
    """A commit's inputs: small integer clocks (many ties), pools that are
    all ``inf`` in some lanes, slots past a lane's count at ``inf``."""
    import numpy as np
    clocks = rng.integers(0, 4, (P, S, B)).astype(np.float64)
    clocks[:, (S + 1) // 2:, ::3] = np.inf
    clocks[P - 1, :, ::5] = np.inf
    busy = rng.random((P, B))
    seen = rng.random((P, B)) < 0.5
    p = rng.integers(0, P, B).astype(np.int64)
    rt = rng.integers(0, 4, B).astype(np.float64)
    base = rng.random(B)
    live = rng.random(B) < 0.75
    return clocks, busy, seen, p, rt, base, live


def compare(a, b):
    """``(bit-identical, max abs difference over finite entries)``; NaN
    and infinite entries must sit at the same places with equal values."""
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bool:
        return torch.equal(a, b), 0.0
    both_nan = torch.isnan(a) & torch.isnan(b)
    same = bool(((a == b) | both_nan).all())
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return same, err


def commit_bytes(S: int, B: int, n_live: int) -> int:
    """Bytes the commit must move, read once and written once: the S
    clocks of each lane's own pool, each lane's p, rt, base and live, the
    busy entry of each live lane (read and written), ``end`` for every
    lane, and one clock and one seen entry per live lane (in place).  The
    other pools' clocks, busy and seen are not touched, so P drops out."""
    reads = S * B * 8 + B * (8 + 8 + 8 + 1) + n_live * 8
    writes = B * 8 + n_live * (8 + 8 + 1)
    return reads + writes


def time_ms(fn, n: int) -> float:
    """Mean ms per call of ``fn`` over ``n`` back-to-back calls, by CUDA
    events, after a warm-up."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def kernel_check(ls, torch, np, shapes, label, seed):
    """Kernel == plain version at every ``(P, S, B)`` of ``shapes``, on
    seeded states; returns the worst finite error."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for P, S, B in shapes:
        host = [torch.from_numpy(a) for a in seeded_state(rng, P, S, B)]
        ref = [t.clone().cuda() for t in host]
        dev = [t.clone().cuda() for t in host]
        end_ref = ls.step_commit_ref(*ref)
        end_dev = ls.step_commit(*dev)
        torch.cuda.synchronize()
        results = [compare(x, y) for x, y in
                   zip(dev[:3] + [end_dev], ref[:3] + [end_ref])]
        ok = all(same for same, _ in results)
        err = max(e for _, e in results)
        worst = max(worst, err)
        n_inf = int(torch.isinf(host[0]).all(dim=1).sum())
        phase(label, f"P={P} S={S} B={B}: bit-identical={ok} "
              f"max_abs_err={err} (all-inf pool lanes: {n_inf})")
        if not ok:
            raise SystemExit(f"step_commit disagrees with step_commit_ref "
                             f"at {(P, S, B)}")
    return worst


def kernel_times(ls, torch, np, shape):
    """step_commit at ``shape`` on seeded inputs: per wrapper call and per
    bare launch (the packed arguments, no checks, no allocation) by CUDA
    events, each timed twice in turns; the plain version; the device time
    of one bare launch by ``torch.profiler``'s rows (``device_us``) and
    behind a device spin (``queued_us``); the thread group a lane's pool
    is split across; and the bound.  The state is updated in place by
    every call, as in the scan."""
    P, S, B = shape
    rng = np.random.default_rng(1)
    host = [torch.from_numpy(a) for a in seeded_state(rng, P, S, B)]
    dev = [t.cuda() for t in host]
    n_live = int(host[6].sum())
    lib = ls.step_library()
    end = torch.empty(B, dtype=torch.float64, device="cuda")
    args = ls.STEP_ARGS.pack(*(t.data_ptr() for t in dev), end.data_ptr(),
                             torch.cuda.current_stream().cuda_stream, S, B)

    def bare():
        return lib.step_commit_launch(args)

    if bare() != 0:
        raise SystemExit(f"bare step_commit launch failed at {shape}")
    runs = {"wrapper": lambda: ls.step_commit(*dev), "bare": bare}
    ev = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        ev[name].append(time_ms(runs[name], 2000))
    mean = {name: sum(x) / len(x) for name, x in ev.items()}
    us, rows = device_us(torch, bare)
    q_us, enqueue, spin = queued_us(torch, bare)
    return {"shape": [P, S, B], "group": lib.step_commit_group(S),
            "ms": mean["wrapper"], "kernel_only_ms": mean["bare"],
            "event_ms_by_pass": ev,
            "plain_ms": time_ms(lambda: ls.step_commit_ref(*dev), 500),
            "device_us": us, "device_kernels": rows, "queued_us": q_us,
            "queued_enqueue_us": enqueue, "queued_spin_us": spin,
            "bound_ms": commit_bytes(S, B, n_live) / HBM_BYTES_PER_S * 1e3,
            "bytes": commit_bytes(S, B, n_live)}


def record_slices(torch, torchsim, slices):
    """From now until the returned function is called, the first slice
    each step runner's shape ``(P, S, B, rows)`` runs is kept in
    ``slices``: copies, on the runner's device and taken before the slice
    runs, of its packed step inputs, initial clocks, own-order lanes and
    cohorts, pool map and SMP kinds, with the runner's ``eft`` and
    ``K``."""
    run = torchsim.StepRunner.run

    def recorded(self, xi, xf, xb, clocks, kind_pool, smp_kid, npred=None,
                 own=None, cohort=None):
        st = self.state
        key = (*st.clocks.shape, st.ready.shape[0])
        if key not in slices:
            dev = st.clocks.device

            def copy(t):
                return None if t is None else t.to(dev, copy=True)

            slices.setdefault(key, {
                "xi": copy(xi), "xf": copy(xf), "xb": copy(xb),
                "clocks": clocks.copy(), "npred": copy(npred),
                "own": copy(own), "cohort": copy(cohort),
                "kind_pool": torch.empty_like(self.kind_pool).copy_(
                    kind_pool),
                "smp_kid": torch.empty_like(self.smp_kid).copy_(smp_kid),
                "eft": self.eft, "K": self.K})
        return run(self, xi, xf, xb, clocks, kind_pool, smp_kid, npred, own,
                   cohort)

    def stop():
        torchsim.StepRunner.run = run

    torchsim.StepRunner.run = recorded
    return stop


#: The fields a step writes (``torchsim._State``), compared bit for bit.
STEP_FIELDS = ("clocks", "ready", "placement", "busy", "seen", "makespan",
               "prev_rt", "prev_tb", "div", "npred", "key", "t")


def same_on_card(a, b) -> bool:
    """Equal bit for bit as values, NaN where the other has NaN."""
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return bool((a == b).all())


def fused_step_bytes(P: int, S: int, B: int, rows: int, K: int, NK: int,
                     SC: int, n_own: int) -> int:
    """Bytes a whole step must move, each read once and written once: the
    heap keys of the ``n_own`` own-order lanes (the pop's first minimum);
    and per lane its row's packed words (``4 + 2K + SC`` int64, ``2 NK``
    f64, ``3 + NK`` bools), every pool's S clocks (each pool's first free
    slot for ``choose``), its pool map row and SMP kind, its scalars
    (``cohort``, ``own``, ``ran``, ``gone`` read; ``t``, ``makespan``,
    ``prev_rt``, ``prev_tb``, ``div`` read and written), ``ready[r]`` and
    the conditional parent's placement read and ``r``'s written, the
    commit (a clock and a seen entry written, a busy entry read and
    written), the leaving row's key and npred written, and each
    successor's ready and npred read and written and its key written."""
    row = (4 + 2 * K + SC) * 8 + 2 * NK * 8 + (3 + NK)
    scalars = 8 + 1 + 4 + 8 + 2 * (8 + 8 + 8 + 8 + 1)
    lane = (row + P * S * 8 + NK * 8 + 8 + scalars + 8 + 4 + 4
            + (8 + 1 + 16) + (8 + 4) + SC * (16 + 8 + 8))
    return n_own * rows * 8 + B * lane


def fused_states(torchsim, key, snap):
    """Two scan states of shape ``key`` at ``snap``'s slice start."""
    P, S, B, rows = key
    out = []
    for _ in range(2):
        st = torchsim._State(P, S, B, rows, snap["xi"].device)
        st.reset(snap["clocks"], snap["npred"], snap["own"], snap["cohort"])
        out.append(st)
    return out


def fused_check(torch, torchsim, ls, key, snap):
    """The fused step against the plain body on the card (~150 PyTorch
    kernels and the standalone commit a step) through a whole recorded
    slice from the same start: every field of the state
    bit for bit after every ``STEPS`` steps.  Returns ``(bit-identical,
    steps, first step and field that differ or None)``."""
    fused, plain = fused_states(torchsim, key, snap)
    ops = (snap["xi"], snap["xf"], snap["xb"])
    rest = (snap["kind_pool"], snap["smp_kid"], snap["eft"], snap["K"])
    T = ops[0].shape[0]
    for t0 in range(0, T, torchsim.STEPS):
        for _ in range(min(torchsim.STEPS, T - t0)):
            ls.step_fused(*ops, fused, *rest)
            torchsim._plain_step(*ops, plain, *rest)
        for name in STEP_FIELDS:
            if not same_on_card(getattr(fused, name), getattr(plain, name)):
                return False, T, (t0, name)
    return True, T, None


def fused_times(torch, torchsim, ls, key, snap):
    """The fused step at ``key`` on a recorded slice, each way from the
    slice's start by CUDA events: per step through the wrapper, per bare
    launch (the packed arguments, no checks) over the slice's steps, and
    the plain body per step over up to 256 of them; the device time of
    one bare launch by ``torch.profiler``'s rows and behind a device spin
    (past the slice's end, which the kernel reads as row 0 and flags);
    and the whole step's bound."""
    P, S, B, rows = key
    ops = (snap["xi"], snap["xf"], snap["xb"])
    rest = (snap["kind_pool"], snap["smp_kid"], snap["eft"], snap["K"])
    T, WI, G = ops[0].shape
    K, NK = snap["K"], ops[1].shape[1] // 2
    SC = WI - 4 - 2 * K
    lib = ls.step_library()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)

    def per_step(fn, st, n):
        torch.cuda.synchronize()
        t0.record()
        for _ in range(n):
            fn(st)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    st, _ = fused_states(torchsim, key, snap)
    n_own = int(st.own.sum())
    wrapper_ms = per_step(lambda s: ls.step_fused(*ops, s, *rest), st, T)
    st, plain = fused_states(torchsim, key, snap)
    args = ls.FUSED_ARGS.pack(
        *(t.data_ptr() for t in ops), rest[0].data_ptr(), rest[1].data_ptr(),
        *(getattr(st, name).data_ptr() for name in ls.FUSED_STATE),
        torch.cuda.current_stream().cuda_stream, P, S, B, rows, T, G, K, NK,
        SC, int(snap["eft"]))

    def bare(_=None):
        return lib.step_fused_launch(args)

    if bare() != 0:
        raise SystemExit(f"bare step_fused launch failed at {key}")
    st.reset(snap["clocks"], snap["npred"], snap["own"], snap["cohort"])
    bare_ms = per_step(bare, st, T)
    plain_ms = per_step(lambda s: torchsim._plain_step(*ops, s, *rest),
                        plain, min(T, 256))
    us, dev_rows = device_us(torch, bare)
    q_us, enqueue, spin = queued_us(torch, bare)
    nbytes = fused_step_bytes(P, S, B, rows, K, NK, SC, n_own)
    return {"shape": [P, S, B, rows], "K": K, "NK": NK, "SC": SC,
            "steps": T, "own_lanes": n_own, "ms": wrapper_ms,
            "kernel_only_ms": bare_ms, "plain_ms": plain_ms,
            "device_us": us, "device_kernels": dev_rows, "queued_us": q_us,
            "queued_enqueue_us": enqueue, "queued_spin_us": spin,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}


def fused_path(torch, torchsim, ls, slices, path_shapes):
    """The fused step at every shape ``(P, S, B, rows)`` of ``slices``,
    which must cover each ``(P, S, B)`` the sweeps and the service
    launched it at: held to the plain body through the recorded slice
    (exits at the first difference), and timed.  Returns the rows by
    shape, the commonest first."""
    missing = set(path_shapes) - {key[:3] for key in slices}
    if missing:
        raise SystemExit(f"step_fused: no slice recorded at P,S,B "
                         f"{sorted(missing)}")
    out = []
    for key in sorted(slices, key=lambda k: (-path_shapes[k[:3]], k)):
        launches = path_shapes[key[:3]]
        ok, steps, where = fused_check(torch, torchsim, ls, key, slices[key])
        if not ok:
            raise SystemExit(f"step_fused differs from the plain body at "
                             f"{key}: step {where[0]}, field {where[1]}")
        t = fused_times(torch, torchsim, ls, key, slices[key])
        t.update(launches=launches, bit_identical=ok)
        out.append(t)
        qu = ("not measured (enqueue past half the spin)"
              if t["queued_us"] is None else f"{t['queued_us']:.2f} us")
        rows_us = ("not measured" if t["device_us"] is None
                   else f"{t['device_us']:.2f} us")
        phase("fused step", f"P,S,B,rows={list(key)} ({launches} path "
              f"launches at its P,S,B; {t['own_lanes']} own-order lanes, "
              f"K={t['K']} NK={t['NK']} SC={t['SC']}): == plain body "
              f"through a recorded slice of {steps} steps, every field "
              f"bit for bit: {ok}; CUDA events {t['ms'] * 1e3:.2f} us a "
              f"step through the wrapper, {t['kernel_only_ms'] * 1e3:.2f} "
              f"us per bare "
              f"launch, plain body {t['plain_ms'] * 1e3:.2f} us a step; "
              f"device time of one bare launch behind a spin {qu}, by "
              f"torch.profiler {rows_us}; bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bytes']} B at 3.35 TB/s)")
    return out


def profile_sweep(torch, Explorer, trace, reports, a9, cands, library, ls):
    """Where a warm sweep's time goes on the card: the sweep once plain and
    once under ``torch.profiler``, both from ``library``'s recorded orders.
    Returns the plain wall, the device time of the profiled run's kernels,
    their count, the steps (fused step launches) and the busiest ops."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import torchsim
    cc = torchsim._DEFAULT_CACHE

    def run():
        ex = Explorer(trace, reports, engine="torch", smp_seconds_fn=a9,
                      order_library=library)
        ls.LAUNCHES = 0
        before = cc.as_dict()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex.explore(cands, top_k=3)
        torch.cuda.synchronize()
        after = cc.as_dict()
        return (time.perf_counter() - t, ls.LAUNCHES,
                {k: after[k] - before[k] for k in ("captures", "replays")})

    wall, steps, graphs = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall, _, _ = run()
    events = prof.key_averages()
    dev = [e for e in events if "cuda" in str(e.device_type).lower()]
    device_s = sum(e.self_device_time_total for e in dev) * 1e-6
    n_kernels = sum(e.count for e in dev)
    top_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:5]
    commits = sum(e.count for e in dev if "step_commit" in e.key)
    return {"wall_s": wall, "profiled_wall_s": prof_wall, "steps": steps,
            "graph_captures": graphs["captures"],
            "graph_replays": graphs["replays"],
            "device_s": device_s, "device_busy_share": device_s / wall,
            "profiled_busy_share": device_s / prof_wall,
            "kernels": n_kernels,
            "kernels_per_step": n_kernels / max(steps, 1),
            # the profiler sees the kernels inside the replayed graphs
            # when it counts one fused step (step_commit_fused_kernel) a
            # step
            "profiler_sees_graph_kernels": commits == steps,
            "step_commit_rows": commits,
            "top_host_ops": [[e.key, e.count, e.self_cpu_time_total * 1e-6]
                             for e in top_host]}


def library_copy(lib):
    """A copy of a ReplayLibrary's recorded orders, so that two sweeps
    start from the same library."""
    import copy
    from repro_torch.core.replay import ReplayLibrary
    if lib is None:
        return None
    new = ReplayLibrary(lib.max_orders_per_key)
    with lib._lock:
        new._entries = copy.deepcopy(lib._entries)
    return new


def sims_bits(ex):
    """Every torch-tier result an Explorer holds, by its content key:
    makespan, per-pool busy (its keys are the pools seen), placements and
    pool slots, floats as their hex form (bit for bit)."""
    return {repr(k): (s.makespan.hex(),
                      sorted((p, b.hex()) for p, b in s.busy.items()),
                      s.placements, s.pool_slots)
            for k, s in ex._sims.items()}


def graph_step_times(torch, cc, STEPS, n: int = 20):
    """Device time of the captured step graphs of ``cc``: each runner's
    graph replayed ``n`` times back to back by CUDA events (on whatever
    its buffers hold: the work of a step has fixed shapes), per replay and
    per step, by signature ``(P, S, B)``."""
    out = []
    for runner in list(cc._mem.values()):
        graph = getattr(runner, "graph", None)
        if graph is None or not hasattr(runner, "state"):
            continue
        P, S, B = runner.state.clocks.shape
        graph.replay()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            graph.replay()
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / n
        out.append({"P,S,B": [P, S, B], "ms_per_replay": ms,
                    "us_per_step": ms * 1e3 / STEPS})
    return out


def graph_sweep(torch, Explorer, ls, label, trace, reports, a9, cands,
                top_k, library, failures):
    """One sweep through captured step graphs on a fresh compile cache
    with a disk tier, then again on the warm cache, in one call and each
    from a copy of ``library``: every torch-tier result bit for bit, the
    replay protocol's counts and the fused step's launches (by shape)
    equal both times; the warm repeat captures nothing.  Each slice of
    both sweeps is kept and, after them, run again eagerly
    (:func:`eager_slices`).  Each run's wall is split between the step
    loop (``torchsim._scan_cohorts``, timed around each call: staging,
    the replays, the copy-out) and the rest (graphs, host order
    discovery, assembly).  Returns the phase's row and the cache."""
    from repro_torch.core import torchsim
    from repro_torch.core.diskcache import DiskCache
    from repro_torch.core.graphcache import CompileCache
    cc = CompileCache(DiskCache(str(GRAPH_DIR / label)))
    runs = {}
    loop_s = [0.0]
    scan = torchsim._scan_cohorts
    run = torchsim.StepRunner.run
    kept = []

    def timed_scan(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return scan(*args, **kwargs)
        finally:
            loop_s[0] += time.perf_counter() - t0

    def kept_run(self, *args):
        out = run(self, *args)
        kept.append((self, args, out))
        return out

    torchsim._scan_cohorts = timed_scan
    torchsim.StepRunner.run = kept_run
    try:
        runs = graph_sweep_runs(torch, Explorer, ls, trace, reports, a9,
                                cands, top_k, library, cc, loop_s)
    finally:
        torchsim._scan_cohorts = scan
        torchsim.StepRunner.run = run
    slices = eager_slices(torch, torchsim, ls, kept)
    return graph_sweep_row(torch, torchsim, label, cands, runs, slices, cc,
                           failures), cc


def eager_slices(torch, torchsim, ls, kept):
    """Each kept slice ``(runner, arguments, outputs)`` of a sweep run
    again eagerly: ``torchsim._steps`` on a fresh state, one fused launch
    a step, tallied by shape.  Returns the slices compared, those whose
    outputs differ from the runner's bit for bit, those whose eager
    launches differ from the ones the runner credited at its replays,
    the eager launches by shape and the eager seconds (synchronised)."""
    bad_bits, bad_launches, shapes, secs = 0, 0, Counter(), 0.0
    for runner, args, out in kept:
        xi, xf, xb, clocks, kind_pool, smp_kid, *rest = args
        P, S, B = runner.state.clocks.shape
        st = torchsim._State(P, S, B, runner.state.ready.shape[0],
                             xi.device)
        st.reset(clocks, *rest)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ls.recording() as tally:
            torchsim._steps(xi, xf, xb, st, kind_pool, smp_kid, runner.eft,
                            runner.K)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        want = st.outputs()
        if any(a.tobytes() != b.tobytes() for a, b in zip(out, want)):
            bad_bits += 1
        replays = xi.shape[0] // torchsim.STEPS
        if tally != Counter({sh: n * replays
                             for sh, n in runner.launches.items()}):
            bad_launches += 1
        shapes.update(tally)
    return {"slices": len(kept), "bad_bits": bad_bits,
            "bad_launches": bad_launches, "shapes": shapes, "seconds": secs}


def graph_sweep_runs(torch, Explorer, ls, trace, reports, a9, cands, top_k,
                     library, cc, loop_s):
    """The two runs of :func:`graph_sweep`, each from a copy of
    ``library``; ``loop_s`` accumulates the step loop's seconds."""
    runs = {}
    for name in ("graph", "graph_warm"):
        ex = Explorer(trace, reports, engine="torch", smp_seconds_fn=a9,
                      order_library=library_copy(library), compile_cache=cc)
        before = cc.as_dict()
        ls.LAUNCHES = 0
        ls.SHAPES.clear()
        torch.cuda.synchronize()
        loop_s[0] = 0.0
        t = time.perf_counter()
        r = ex.explore(cands, top_k=top_k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = cc.as_dict()
        runs[name] = {
            "wall_s": wall, "step_loop_s": loop_s[0],
            "rest_s": wall - loop_s[0], "steps": ls.LAUNCHES,
            "steps_per_s": ls.LAUNCHES / wall,
            "cand_per_s": len(cands) / wall, "best": r.best_name,
            "shapes": Counter(ls.SHAPES),
            "batch_stats": ex.batch_stats.as_dict(),
            "cache": {k: after[k] - before[k] for k in after},
            "sims": sims_bits(ex), "engine": ex.engine,
            "spans": [(o.name, None if o.makespan_s is None
                       else o.makespan_s.hex()) for o in r.outcomes]}
    return runs


def graph_sweep_row(torch, torchsim, label, cands, runs, slices, cc,
                    failures):
    """:func:`graph_sweep`'s checks and its ``[graph sweep]`` line."""
    graph, warm = runs["graph"], runs["graph_warm"]
    checks = {
        "ok_bitwise": graph["sims"] == warm["sims"]
        and graph["spans"] == warm["spans"] and len(graph["sims"]) > 0,
        "ok_slices_bitwise": slices["slices"] > 0
        and slices["bad_bits"] == 0,
        "ok_protocol": graph["batch_stats"] == warm["batch_stats"],
        "ok_launches": graph["steps"] == warm["steps"] > 0
        and graph["shapes"] == warm["shapes"]
        and graph["shapes"] + warm["shapes"] == slices["shapes"]
        and slices["bad_launches"] == 0,
        "ok_captured": graph["cache"]["captures"] >= 1
        and graph["cache"]["replays"] >= 1,
        "ok_warm_no_capture": warm["cache"]["captures"] == 0
        and warm["cache"]["compiles"] == 0 and warm["cache"]["mem_hits"] >= 1,
        "ok_no_demotion": graph["engine"] == warm["engine"] == "torch",
    }
    row = {"sweep": label, "candidates": len(cands), "best": graph["best"],
           "steps": graph["steps"],
           **{f"{name}_{key}": run[key] for name, run in runs.items()
              for key in ("wall_s", "step_loop_s", "rest_s", "steps_per_s",
                          "cand_per_s")},
           "graph_cache": graph["cache"], "warm_cache": warm["cache"],
           "lockstep_lanes": graph["batch_stats"]["lockstep_lanes"],
           "diverged_lanes": graph["batch_stats"]["diverged_lanes"],
           "results_compared": len(graph["sims"]),
           "slices_compared": slices["slices"],
           "eager_slices_s": slices["seconds"],
           "step_graphs": graph_step_times(torch, cc, torchsim.STEPS),
           **checks}
    phase("graph sweep", json.dumps(row))
    bad = [k for k, v in checks.items() if not v]
    if bad:
        failures.append(f"graph sweep {label}: failed {bad}")
    return row


def second_process(label, failures):
    """The Cholesky sweep in a second Python process on the graph-sweep
    phase's store of ``label``: no ``nvcc`` run, every runner a disk hit
    (the store holds the libraries its entries name)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", SECOND_PROCESS, str(GRAPH_DIR / label),
         str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        failures.append(f"graph sweep second process: exit "
                        f"{out.returncode}: {out.stderr[-2000:]}")
        return {}
    got = json.loads(out.stdout.strip().splitlines()[-1])
    cc = got["cc"]
    ok = got["nvcc"] == 0 and cc["compiles"] == 0 and cc["disk_hits"] >= 1 \
        and cc["failures"] == 0
    row = {"sweep": f"{label}_second_process", "wall_s": wall,
           "nvcc_builds": got["nvcc"], "rebuilds": got["rebuilds"],
           "cache": cc, "best": got["best"], "ok_no_build_all_disk": ok}
    phase("graph sweep", json.dumps(row))
    if not ok:
        failures.append(f"graph sweep second process: {row}")
    return row


def cholesky_ramp(ch, zynq_system, Candidate, slots):
    """The six Fig. 9 designs, each at 1..``slots`` slots per accelerator
    pool, without fabric payload (this sweep exercises the engines, not
    the feasibility filter).  A design alone is a one-lane family, which
    the replay protocol runs serially; its slot ramp is a lockstep family.
    """
    out = []
    for base in ch.candidates(bs=64):
        for k in range(1, slots + 1):
            name = f"{base.name}x{k}"
            counts = {kind: n * k for kind, n
                      in base.system.meta["accelerators"].items()}
            out.append(Candidate(name=name,
                                 system=zynq_system(name, counts),
                                 eligibility=base.eligibility))
    return out


def matmul_ramp(mm, zynq_system, Eligibility, bs, count):
    """``count`` slot × ±SMP variants over one granularity (the fig6
    sweep shape)."""
    kind = f"fpga:mxm{bs}"
    out = []
    for n_acc in range(1, count // 2 + 1):
        for smp in (False, True):
            name = f"{n_acc}acc{bs}" + ("+smp" if smp else "")
            kinds = (kind, "smp") if smp else (kind,)
            out.append(mm.Candidate(
                name=name, system=zynq_system(name, {kind: n_acc}),
                eligibility=Eligibility({"mxm_block": kinds})))
    return out


def tile_inputs(torch, np, seed: int, *shapes, dtype="float32"):
    """Standard-normal f32 matrices from ``seed``, cast to ``dtype``, on
    the card."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(getattr(torch, dtype)).cuda() for s in shapes]


def upper_tile(torch, np, seed: int, bs: int):
    """A well-conditioned upper-triangular tile, ``chol(m mᵀ + bs I)ᵀ``."""
    m = np.random.default_rng(seed).standard_normal((bs, bs))
    spd = (m @ m.T + bs * np.eye(bs)).astype(np.float32)
    return torch.from_numpy(np.linalg.cholesky(spd).T.copy()).cuda()


def ptxas_summary(report: str) -> str:
    """Kernel count, most registers, most static shared memory and spill
    bytes of a ptxas report (dynamic shared memory is sized at launch and
    not in the report)."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    smem = [int(b) for b in re.findall(r"(\d+) bytes smem", report)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", report))
    return (f"{len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers, at most {max(smem, default=0)} bytes of static "
            f"shared memory, {spills} bytes of spills")


def bound(flops: float, nbytes: float, dtype: str):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tile_cases(torch, np, ref, bm, ct, lib128):
    """Every tile-kernel call of the paths, at its path shape, with its
    plain version, the PyTorch call that computes the same function, its
    bare launch, tolerance and bound.  ``block_matmul`` at (128,128,128)
    runs the ``TILE=128`` build, as the traditional flow's bs-128
    candidates do; the rest the cached ``TILE=64`` build.  A bare launch
    takes its arguments packed, raw pointers and all, so its lambda also
    holds (``held``) the tensors they point into: freed, their memory
    would go to other tensors, which every timed launch would then
    overwrite."""
    cases = []
    stream = torch.cuda.current_stream().cuda_stream
    lib64 = bm.tiles_library()
    for m, dtype in ((64, "float32"), (128, "float32"), (64, "bfloat16"),
                     (128, "bfloat16")):
        a, b = tile_inputs(torch, np, m, (m, m), (m, m), dtype=dtype)
        lib = lib128 if m == 128 else lib64
        out = torch.empty_like(a)
        code = bm.DTYPE_CODES[a.dtype]
        el = a.element_size()
        cases.append({
            "kernel": "block_matmul", "entry": "block_matmul",
            "shape": [m, m, m], "dtype": dtype,
            "tile": lib.tiles_tile_edge(),
            "run": (lambda a=a, b=b, lib=lib, m=m: bm.block_matmul(
                a, b, block_m=m, block_n=m, block_k=m, library=lib)),
            "bare": (lambda lib=lib, held=(a, b, out),
                     args=bm.GEMM_ARGS.pack(
                         a.data_ptr(), b.data_ptr(), 0, out.data_ptr(),
                         stream, m, m, m, code, code, 0, 0):
                     lib.tiles_gemm_launch(args)),
            "plain": lambda a=a, b=b: ref.matmul(a, b),
            "library": lambda a=a, b=b: torch.matmul(a, b),
            "library_call": "torch.matmul(a, b)",
            "rtol": MATMUL_RTOL[dtype], "atol": MATMUL_RTOL[dtype] * m,
            "bound": bound(2 * m ** 3, 3 * m * m * el, dtype)})
    bs = 64
    a, b, c = tile_inputs(torch, np, 3, (bs, bs), (bs, bs), (bs, bs))
    out = torch.empty_like(c)
    cases.append({
        "kernel": "block_matmul", "entry": "gemm_update",
        "shape": [bs, bs, bs], "dtype": "float32", "tile": 64,
        "run": lambda: bm.gemm_update_tile(a, b, c),
        "bare": lambda held=(a, b, c, out), args=bm.GEMM_ARGS.pack(
            b.data_ptr(), a.data_ptr(), c.data_ptr(), out.data_ptr(), stream,
            bs, bs, bs, 0, 0, 1, 1): lib64.tiles_gemm_launch(args),
        "plain": lambda: ref.gemm_update(a, b, c),
        "library": lambda: torch.addmm(c, b.T, a, alpha=-1),
        "library_call": "torch.addmm(c, b.T, a, alpha=-1)",
        "rtol": SYRK_TOL[0], "atol": SYRK_TOL[1],
        "bound": bound(2 * bs ** 3 + bs * bs, 4 * bs * bs * 4, "float32")})
    cases.append({
        "kernel": "syrk_tile", "entry": "syrk_tile",
        "shape": [bs, bs], "dtype": "float32", "tile": 64,
        "run": lambda: ct.syrk_tile(a, c),
        "bare": lambda held=(a, c, out), args=bm.GEMM_ARGS.pack(
            a.data_ptr(), a.data_ptr(), c.data_ptr(), out.data_ptr(), stream,
            bs, bs, bs, 0, 0, 1, 1): lib64.tiles_gemm_launch(args),
        "plain": lambda: ref.syrk(a, c),
        "library": lambda: torch.addmm(c, a.T, a, alpha=-1),
        "library_call": "torch.addmm(c, a.T, a, alpha=-1)",
        "rtol": SYRK_TOL[0], "atol": SYRK_TOL[1],
        "bound": bound(2 * bs ** 3 + bs * bs, 3 * bs * bs * 4, "float32")})
    up = upper_tile(torch, np, 4, bs)
    (rhs,) = tile_inputs(torch, np, 5, (bs, bs))
    x = torch.empty_like(rhs)
    cases.append({
        "kernel": "trsm_tile", "entry": "trsm_tile",
        "shape": [bs, bs], "dtype": "float32", "panel": 16, "tile": None,
        "run": lambda: ct.trsm_tile(up, rhs, panel=16),
        "bare": lambda held=(up, rhs, x), args=bm.TRSM_ARGS.pack(
            up.data_ptr(), rhs.data_ptr(), x.data_ptr(), stream, bs, bs, 16,
            0): lib64.tiles_trsm_launch(args),
        "plain": lambda: ref.trsm(up, rhs),
        "library": lambda: torch.linalg.solve_triangular(up.mT, rhs,
                                                         upper=False),
        "library_call": "torch.linalg.solve_triangular(a.mT, b, upper=False)",
        "rtol": TRSM_TOL, "atol": TRSM_TOL,
        # forward substitution: bs² flops per column; the upper triangle
        # of A, B and X each moved once
        "bound": bound(bs * bs * bs, (bs * (bs + 1) // 2 + 2 * bs * bs) * 4,
                       "float32")})
    return cases


def check_tiles(torch, cases):
    """Each case's kernel against its plain version; exits on any
    disagreement.  Returns ``{case index: max abs error}``."""
    errs = {}
    for i, case in enumerate(cases):
        got = case["run"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(),
                                 rtol=case["rtol"], atol=case["atol"]))
        errs[i] = err
        phase("tiles==plain", f"{case['entry']} {case['shape']} "
              f"{case['dtype']} (TILE={case['tile']}): max_abs_err={err} "
              f"within rtol={case['rtol']} atol={case['atol']}: {ok}")
        if not ok:
            raise SystemExit(f"{case['entry']} disagrees with its plain "
                             f"version at {case['shape']} {case['dtype']}")
    return errs


def time_tiles(torch, cases, errs):
    """Each case's times: by CUDA events back to back, per wrapper call,
    per bare launch and per library call, each timed twice in turns
    (wrapper, bare, library, library, bare, wrapper), and the plain
    version once; the device time of one bare launch and of one library
    call, by ``torch.profiler``'s kernel rows (``device_us``) and behind
    a device spin (``queued_us``).  Bare launches are checked for a zero
    return code."""
    rows = []
    for i, case in enumerate(cases):
        rc = case["bare"]()
        torch.cuda.synchronize()
        if rc != 0:
            raise SystemExit(f"bare {case['entry']} launch returned {rc}")
        runs = {"wrapper": case["run"], "bare": case["bare"],
                "library": case["library"]}
        order = list(runs)
        ev = {name: [] for name in order}
        for name in order + order[::-1]:
            ev[name].append(time_ms(runs[name], 1000))
        mean = {name: sum(x) / len(x) for name, x in ev.items()}
        dev = {name: device_us(torch, runs[name])
               for name in ("bare", "library")}
        queued = {name: queued_us(torch, runs[name])
                  for name in ("bare", "library")}
        row = {k: case[k] for k in ("kernel", "entry", "shape", "dtype",
                                    "tile", "library_call")}
        row.update(ms=mean["wrapper"], kernel_only_ms=mean["bare"],
                   library_ms=mean["library"],
                   plain_ms=time_ms(case["plain"], 500),
                   bound_ms=case["bound"][0], bound_by=case["bound"][1],
                   max_abs_err=errs[i], event_ms_by_pass=ev,
                   device_us={n: us for n, (us, _) in dev.items()},
                   device_kernels={n: r for n, (_, r) in dev.items()},
                   queued_us={n: us for n, (us, _, _) in queued.items()},
                   queued_enqueue_us={n: h for n, (_, h, _)
                                      in queued.items()},
                   queued_spin_us={n: sp for n, (_, _, sp)
                                   in queued.items()})
        row["slower_than_library"] = {
            "wrapper_call": row["ms"] > row["library_ms"],
            "device": (None if None in row["queued_us"].values() else
                       row["queued_us"]["bare"]
                       > row["queued_us"]["library"])}
        rows.append(row)
        us = {n: "not measured" if x is None else f"{x:.2f} us"
              for n, x in row["device_us"].items()}
        qu = {n: "not measured (enqueue past half the spin)" if x is None
              else f"{x:.2f} us" for n, x in row["queued_us"].items()}
        gaps = "; ".join(f"{n} {row['queued_enqueue_us'][n]:.0f} of "
                         f"{row['queued_spin_us'][n]:.0f}"
                         for n in ("bare", "library"))
        phase("tile kernel", f"{row['entry']} {row['shape']} {row['dtype']}"
              f" (TILE={row['tile']}): CUDA events (two passes in turns) "
              f"{row['ms'] * 1e3:.2f} us per wrapper call, "
              f"{row['kernel_only_ms'] * 1e3:.2f} us per bare launch, "
              f"{row['library_call']} {row['library_ms'] * 1e3:.2f} us, "
              f"plain version {row['plain_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}); device "
              f"time of one call behind a spin: kernel {qu['bare']}, "
              f"library {qu['library']} (longest enqueue of 20 calls "
              f"against the spin, us: {gaps}); by torch.profiler: kernel "
              f"{us['bare']}, library {us['library']}; slower than the "
              f"library: {row['slower_than_library']}; kernel rows [name, "
              f"count, total us] of 20 calls each: "
              f"{json.dumps(row['device_kernels'])}")
    return rows


def fig6_flow(torch, np, mm, Explorer, a9_smp_seconds, tr, bm, ls):
    """Fig. 6 at ``TILE_N``: the estimator's time for the six
    traditional-flow candidates, then each built afresh and run.  Returns
    a summary; exits if a product is wrong or a build was not fresh."""
    t0 = time.perf_counter()
    traces = {bs: mm.trace_matmul(n=TILE_N, bs=bs, verify=False)
              for bs in (64, 128)}
    trace_s = time.perf_counter() - t0
    reports = mm.report_map()
    a9 = a9_smp_seconds("float32")
    names = {tr.candidate_name(*c) for c in tr.FIG6_CANDIDATES}
    ls.LAUNCHES = 0
    t0 = time.perf_counter()
    best = {}
    for bs, clist in mm.candidates().items():
        cands = [c for c in clist if c.name in names]
        res = Explorer(traces[bs], reports, engine="torch",
                       smp_seconds_fn=a9).explore(cands)
        torch.cuda.synchronize()
        if res.best_name is None:
            raise SystemExit(f"the estimator ranked no bs={bs} candidate")
        best[bs] = res.best_name
    explore_s = time.perf_counter() - t0
    est_s = trace_s + explore_s
    est_steps = ls.LAUNCHES

    bm.LAUNCHES.clear()
    bm.SHAPES.clear()
    runs = []
    for bs, het, n_acc in tr.FIG6_CANDIDATES:
        run = tr.traditional_candidate(TILE_N, bs, het)
        aa, bb = tr.matmul_blocks(TILE_N, bs)
        want = np.block(aa) @ np.block(bb)
        err = float(np.abs(run.product - want).max())
        ok = bool(np.allclose(run.product, want, rtol=2e-3, atol=2e-3))
        name = tr.candidate_name(bs, het, n_acc)
        phase("traditional", f"{name}: fresh TILE={run.tile} build "
              f"{run.build_s:.3f} s, run {run.run_s:.3f} s, "
              f"{run.fpga_tasks} FPGA tasks on the card, {run.smp_tasks} "
              f"SMP tasks on the host, max_abs_err vs AA@BB {err}: {ok}; "
              f"ptxas: {ptxas_summary(run.ptxas)}")
        if not ok or run.build_s <= 0:
            raise SystemExit(f"traditional candidate {name} failed")
        runs.append({"name": name, "build_s": run.build_s,
                     "ptxas": ptxas_summary(run.ptxas),
                     "run_s": run.run_s, "fpga_tasks": run.fpga_tasks,
                     "smp_tasks": run.smp_tasks, "max_abs_err": err})
    launches = bm.LAUNCHES["block_matmul"]
    shapes = dict(bm.SHAPES)
    if launches != sum(r["fpga_tasks"] for r in runs) or launches == 0:
        raise SystemExit(f"traditional flow: {launches} block_matmul "
                         f"launches for {sum(r['fpga_tasks'] for r in runs)}"
                         f" FPGA tasks")
    trad_s = sum(r["build_s"] + r["run_s"] for r in runs)
    summary = {"n": TILE_N, "candidates": len(runs),
               "estimator_s": est_s, "estimator_trace_s": trace_s,
               "estimator_explore_s": explore_s, "estimator_best": best,
               "estimator_step_launches": est_steps,
               "traditional_s": trad_s,
               "traditional_build_s": sum(r["build_s"] for r in runs),
               "traditional_run_s": sum(r["run_s"] for r in runs),
               "ratio": trad_s / est_s, "block_matmul_launches": launches,
               "launch_shapes": {str(k): v for k, v in shapes.items()},
               "runs": runs}
    phase("fig6", f"estimator {est_s:.3f} s (traces {trace_s:.3f} s + "
          f"torch sweep {explore_s:.3f} s, {est_steps} fused step "
          f"launches) vs traditional build-and-run "
          f"{trad_s:.3f} s over {len(runs)} candidates: ratio "
          f"{trad_s / est_s:.2f}x (printed, not gated)")
    return summary


def cholesky_flow(torch, np, tr, bm, ct):
    """``cholesky_via_tiles(TILE_N, 64, panel=16)`` on the card: the launch
    counts of Fig. 4's loop at nb = 8 and ``UᵀU == A``; exits otherwise."""
    bm.LAUNCHES.clear()
    ct.LAUNCHES.clear()
    t0 = time.perf_counter()
    u = tr.cholesky_via_tiles(TILE_N, 64, 16, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"syrk_tile": ct.LAUNCHES["syrk_tile"],
              "gemm_update": bm.LAUNCHES["gemm_update"],
              "trsm_tile": ct.LAUNCHES["trsm_tile"],
              "block_matmul": bm.LAUNCHES["block_matmul"]}
    a = tr.spd_matrix(TILE_N, 0)
    un = u.cpu().numpy()
    err = float(np.abs(un.T @ un - a).max())
    ok = bool(np.allclose(un.T @ un, a, rtol=2e-3, atol=2e-1))
    upper = bool(np.array_equal(un, np.triu(un)))
    u_cpu = tr.cholesky_via_tiles(TILE_N, 64, 16, seed=0,
                                  device="cpu").numpy()
    vs_cpu = float(np.abs(un - u_cpu).max())
    want = {"syrk_tile": 28, "gemm_update": 56, "trsm_tile": 28,
            "block_matmul": 0}
    phase("cholesky", f"cholesky_via_tiles({TILE_N}, 64, panel=16) in "
          f"{wall:.3f} s: launches {counts} (Fig. 4 at nb=8: {want}); "
          f"max |UᵀU - A| = {err}, within rtol 2e-3 atol 2e-1: {ok}; "
          f"upper: {upper}; max |U - U on the CPU's plain path| = {vs_cpu}")
    if counts != want or not ok or not upper:
        raise SystemExit("cholesky_via_tiles failed on the card")
    return {"wall_s": wall, "launches": counts, "max_abs_err_UtU": err,
            "max_abs_diff_vs_cpu": vs_cpu}


def flash_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks keep: the products the work needs
    (a kernel that skips masked tiles does no more than this plus its
    tiles' ragged diagonal)."""
    import numpy as np
    q = np.arange(t)[:, None]
    k = np.arange(s)[None, :]
    m = np.ones((t, s), bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    return int(m.sum())


def flash_cases(torch, np, fa, ops):
    """The flash kernel's check cases: each runs the wrapper (or
    ``ops.attention``, which pads) on seeded inputs on the card."""
    specs = [  # label, (BH, BKV, T, S, D), dtype, window, softcap, padded
        ("path", FLASH_PATH, "bfloat16", 0, 0.0, False),
        ("padded", (16, 8, 300, 300, 128), "bfloat16", 0, 0.0, True),
        ("gemma2_local", (8, 4, 512, 512, 256), "bfloat16", 256, 50.0, False),
        ("f32", FLASH_PATH, "float32", 0, 0.0, False),
        ("zamba2_path", ZAMBA2_FLASH_PATH, "bfloat16", 0, 0.0, False),
        ("mixtral_path", MIXTRAL_FLASH_PATH, "bfloat16", MIXTRAL_WINDOW, 0.0,
         False),
        ("mixtral_window", MIXTRAL_WINDOW_CASE, "bfloat16", MIXTRAL_WINDOW,
         0.0, False),
        ("pixtral_path", PIXTRAL_FLASH_PATH, "bfloat16", 0, 0.0, False),
        ("pixtral_fused", PIXTRAL_FUSED_PATH, "bfloat16", 0, 0.0, False),
        ("whisper_path", WHISPER_FLASH_PATH, "bfloat16", 0, 0.0, False),
    ]
    cases = []
    for i, (label, (bh, bkv, t, s, d), dtype, window, cap, padded) \
            in enumerate(specs):
        q, k, v = tile_inputs(torch, np, 10 + i, (bh, t, d), (bkv, s, d),
                              (bkv, s, d), dtype=dtype)
        kw = dict(causal=True, window=window, softcap=cap)
        run = ((lambda q=q, k=k, v=v, kw=kw: ops.attention(q, k, v, **kw))
               if padded else
               (lambda q=q, k=k, v=v, kw=kw: fa.flash_attention(q, k, v,
                                                                **kw)))
        cases.append({"label": label, "shape": [bh, bkv, t, s, d],
                      "dtype": dtype, "window": window, "softcap": cap,
                      "q": q, "k": k, "v": v, "kw": kw, "run": run,
                      "padded": padded})
    return cases


def check_flash(torch, fa, ref, cases):
    """Each case's kernel against the plain version, on the kernel
    ``kernel_for`` names; exits on any disagreement or another kernel.
    Returns ``{label: max abs error}``."""
    errs = {}
    for case in cases:
        fa.VARIANTS.clear()
        got = case["run"]()
        routes = dict(fa.VARIANTS)
        want = ref.attention(case["q"], case["k"], case["v"], **case["kw"])
        torch.cuda.synchronize()
        tol = FLASH_TOL[case["dtype"]]
        err = float((got.float() - want.float()).abs().max())
        route = fa.kernel_for(case["q"].dtype, case["shape"][4])
        ok = (bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol)) and got.dtype == want.dtype
              and routes == {route: 1})
        errs[case["label"]] = err
        phase("flash==plain", f"{case['label']} (BH,BKV,T,S,D)="
              f"{case['shape']} {case['dtype']} window={case['window']} "
              f"softcap={case['softcap']} via "
              f"{'ops.attention' if case['padded'] else 'flash_attention'}, "
              f"kernels {routes}: "
              f"max_abs_err={err} within rtol=atol={tol}: {ok}")
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version at {case['label']}")
    return errs


def flash_bare(torch, fa, lib, variant, case, out):
    """A bare launch of ``variant``'s kernel from ``lib`` at ``case``
    (causal, the case's window and softcap) into ``out``: no checks, no
    allocation, no count; returns the launch's error code."""
    q, k, v = case["q"], case["k"], case["v"]
    bh, bkv, t, s, d = case["shape"]
    fn = (lib.flash_attention_wgmma_launch if variant == "wgmma"
          else lib.flash_attention_launch)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            bkv, t, s, d, fa.DTYPE_CODES[q.dtype], 1, case["window"],
            case["softcap"], d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    return lambda: fn(*args)


def check_routes(torch, np, fa, ref):
    """Each of ``ROUTE_CASES`` through the wrapper, which must launch the
    kernel ``kernel_for`` names, held to the plain version at
    ``FLASH_TOL``.  Exits on any disagreement.  Returns ``{label: max abs
    error}``."""
    errs = {}
    tol = FLASH_TOL["bfloat16"]
    for i, (label, (bh, bkv, t, s, d), window, cap) in enumerate(
            ROUTE_CASES):
        q, k, v = tile_inputs(torch, np, 30 + i, (bh, t, d), (bkv, s, d),
                              (bkv, s, d), dtype="bfloat16")
        kw = dict(causal=True, window=window, softcap=cap)
        fa.VARIANTS.clear()
        got = fa.flash_attention(q, k, v, **kw)
        variants = dict(fa.VARIANTS)
        want = ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        variant = fa.kernel_for(torch.bfloat16, d)
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol)) and variants == {variant: 1}
        errs[label] = err
        phase(f"{variant}==plain", f"{label} (BH,BKV,T,S,D)="
              f"{[bh, bkv, t, s, d]} bf16 window={window} softcap={cap} "
              f"kernels {variants}: max_abs_err={err} within "
              f"rtol=atol={tol}: {ok}")
        if not ok:
            raise SystemExit(f"flash_attention's {variant} kernel disagrees "
                             f"with its plain version at {label}")
    return errs


def device_us(torch, fn, n: int = 20):
    """Device time of one call of ``fn`` from ``torch.profiler``'s kernel
    rows over ``n`` calls: the sum over the rows of each row's mean (a
    call launches each row's kernel once), and each row's name, count and
    total in us.  A row's count may fall short of ``n`` when the trace
    loses records; the mean is over the launches it kept."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if "cuda" in str(e.device_type).lower()
           and e.self_device_time_total > 0]
    per_call = sum(e.self_device_time_total / e.count for e in dev)
    return (per_call if dev else None), \
        [[e.key[:60], e.count, e.self_device_time_total] for e in dev]


def queued_us(torch, fn, n: int = 20, reps: int = 5):
    """Device time of one call of ``fn`` by CUDA events with the host out
    of the way: a device spin (``torch.cuda._sleep``, 2^22 cycles or
    more) is queued first, so the ``n`` calls are enqueued before the
    device reaches them and run back to back; the events around them then
    time the device alone.  That holds only while the host's enqueue of
    the ``n`` calls takes at most half the spin, timed alone by events:
    past that, the spin grows fourfold, up to 2^28 cycles, and the run is
    made again.  Returns the median over ``reps`` of the elapsed time over
    ``n`` (None when no spin was long enough), the longest enqueue of the
    ``n`` calls and the spin, both in us."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 22
    while True:
        t0.record()
        torch.cuda._sleep(cycles)
        t1.record()
        torch.cuda.synchronize()
        spin = t0.elapsed_time(t1) * 1e3
        times, enqueue = [], 0.0
        for _ in range(reps):
            torch.cuda._sleep(cycles)
            h0 = time.perf_counter()
            t0.record()
            for _ in range(n):
                fn()
            t1.record()
            enqueue = max(enqueue, (time.perf_counter() - h0) * 1e6)
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1) * 1e3 / n)
        if enqueue <= 0.5 * spin:
            return sorted(times)[reps // 2], enqueue, spin
        if cycles >= 1 << 28:
            return None, enqueue, spin
        cycles <<= 2


def time_flash(torch, F, fa, ref, case):
    """The flash kernels' times at ``case``: by CUDA events, per wrapper
    call and per bare launch of the ``wgmma`` kernel, per bare launch of
    the FMA kernel (the earlier design; its output is held to the plain
    version first, and the run exits if it disagrees), the plain version
    and the one PyTorch call that computes the same function, each timed
    twice in turns; the device time of one launch of each kernel and of
    that call, by ``torch.profiler`` and by ``queued_us``; and the
    bound."""
    q, k, v = case["q"], case["k"], case["v"]
    bh, bkv, t, s, d = case["shape"]
    outs = {name: torch.empty_like(q) for name in ("wgmma", "fma")}
    runs = {
        "wgmma": flash_bare(torch, fa, fa.wgmma_library(), "wgmma", case,
                            outs["wgmma"]),
        "fma": flash_bare(torch, fa, fa.library(), "fma", case, outs["fma"]),
    }
    want = ref.attention(q, k, v, **case["kw"]).float()
    tol = FLASH_TOL[case["dtype"]]
    for name, fn in runs.items():
        if fn() != 0:
            raise SystemExit(f"bare flash_attention {name} launch failed")
        torch.cuda.synchronize()
        err = float((outs[name].float() - want).abs().max())
        ok = bool(torch.allclose(outs[name].float(), want, rtol=tol,
                                 atol=tol))
        phase("flash bare==plain", f"{name} kernel's bare launch at "
              f"{case['shape']} {case['dtype']}: max_abs_err={err} within "
              f"rtol=atol={tol}: {ok}")
        if not ok:
            raise SystemExit(f"the bare {name} flash launch disagrees with "
                             f"the plain version")
    q4, k4, v4 = q[None], k[None], v[None]
    window = case["window"]
    if 0 < window < t:          # the window bites: the same mask, explicit
        qp = torch.arange(t, device=q.device)[:, None]
        kp = torch.arange(s, device=q.device)[None, :]
        mask = (kp <= qp) & (kp > qp - window)
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True)
        library_call = ("F.scaled_dot_product_attention(q, k, v, attn_mask="
                        "causal & window, enable_gqa=True)")
    else:                       # causal alone is the same mask
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)
        library_call = ("F.scaled_dot_product_attention(q, k, v, "
                        "is_causal=True, enable_gqa=True)")
    runs["wrapper"] = case["run"]
    order = list(runs)
    ev = {name: [] for name in order}
    for name in order + order[::-1]:
        ev[name].append(time_ms(runs[name], 200))
    timed = ("wgmma", "fma", "sdpa")
    dev = {name: device_us(torch, runs[name]) for name in timed}
    queued = {name: queued_us(torch, runs[name]) for name in timed}
    mean = {name: sum(x) / len(x) for name, x in ev.items()}
    row = {"shape": case["shape"], "dtype": case["dtype"],
           "ms": mean["wrapper"], "kernel_only_ms": mean["wgmma"],
           "fma_kernel_only_ms": mean["fma"],
           "plain_ms": time_ms(lambda: ref.attention(q, k, v, **case["kw"]),
                               50),
           "library_ms": mean["sdpa"],
           "event_ms_by_pass": ev,
           "device_us": {name: us for name, (us, _) in dev.items()},
           "device_kernels": {name: rows for name, (_, rows)
                              in dev.items()},
           "queued_us": {name: us for name, (us, _, _) in queued.items()},
           "queued_enqueue_us": {name: h for name, (_, h, _)
                                 in queued.items()},
           "queued_spin_us": {name: sp for name, (_, _, sp)
                              in queued.items()},
           "window": window, "library_call": library_call}
    pairs = flash_pairs(t, s, True, case["window"])
    el = q.element_size()
    nbytes = (2 * bh * t * d + 2 * bkv * s * d) * el
    flops = 4 * d * pairs * bh
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, case["dtype"])
    row.update(bytes=nbytes, flops=flops, pairs=pairs)
    us = {name: "not measured" if x is None else f"{x:.2f} us"
          for name, x in row["device_us"].items()}
    qu = {name: "not measured (enqueue past half the spin)" if x is None
          else f"{x:.2f} us" for name, x in row["queued_us"].items()}
    gaps = "; ".join(f"{name} {row['queued_enqueue_us'][name]:.0f} of "
                     f"{row['queued_spin_us'][name]:.0f}" for name in timed)
    phase("flash kernel", f"(BH,BKV,T,S,D)={case['shape']} {case['dtype']} "
          f"causal window={window}, CUDA events (two passes in turns): wgmma "
          f"{row['ms'] * 1e3:.2f} us per wrapper call, "
          f"{row['kernel_only_ms'] * 1e3:.2f} us per bare launch; FMA kernel "
          f"(earlier design) {row['fma_kernel_only_ms'] * 1e3:.2f} us; SDPA "
          f"{row['library_ms'] * 1e3:.2f} us; plain version "
          f"{row['plain_ms'] * 1e3:.1f} us; bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: {nbytes} B, "
          f"{flops} flops over {pairs} causal pairs per head)")
    phase("flash device time", f"CUDA events behind a device spin, one "
          f"launch: wgmma {qu['wgmma']}, FMA {qu['fma']}, SDPA "
          f"{qu['sdpa']} (longest host enqueue of 20 calls against the "
          f"spin, us: {gaps}); "
          f"torch.profiler, one launch: wgmma {us['wgmma']}, FMA "
          f"{us['fma']}, SDPA {us['sdpa']}; kernel "
          f"rows [name, count, total us] of 20 calls each: "
          f"{json.dumps(row['device_kernels'])}")
    return row


def linear_inputs(torch, np, seed, shape, dtype, *, decay="rwkv",
                  bonus=True, device="cuda"):
    """Seeded ``(r, k, v, w, u)`` on ``device`` at ``(BH, T, dk, dv)``, as
    ``tests/test_kernels.py`` draws them: r standard normal, k and v at
    0.5, u at 0.3 (zeros when ``bonus`` is false), one head per row.
    ``decay``: ``"rwkv"`` is ``exp(-exp(z))``, ``"strong"`` the same with
    ``z`` at 3 and capped at 1e-6, ``"scalar"`` one ``sigmoid(z)`` per
    step broadcast over dk (Mamba2's form), ``"zamba2"`` zamba2-1.2b's
    spectrum: row ``bh`` decays by ``exp(-softplus(z) · linspace(1, 16,
    64)[bh % 64])`` a step (``dt`` standard normal, ``dt_bias = 0``,
    ``a_log = log(linspace(1, 16, 64))``), broadcast over dk.  r, k, v, u
    in ``dtype``, w in f32."""
    bh, t, dk, dv = shape
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, t, dk))
    k = rng.standard_normal((bh, t, dk)) * 0.5
    v = rng.standard_normal((bh, t, dv)) * 0.5
    if decay == "scalar":
        w = np.broadcast_to(1 / (1 + np.exp(-rng.standard_normal(
            (bh, t, 1)))), (bh, t, dk)).copy()
    elif decay == "zamba2":
        rate = np.linspace(1.0, 16.0, 64)[np.arange(bh) % 64]
        dt = np.logaddexp(0.0, rng.standard_normal((bh, t, 1)))
        w = np.broadcast_to(np.exp(-dt * rate[:, None, None]),
                            (bh, t, dk)).copy()
    else:
        z = rng.standard_normal((bh, t, dk))
        w = np.exp(-np.exp(z * (3.0 if decay == "strong" else 1.0)))
        if decay == "strong":
            w = np.minimum(w, 1e-6)
    u = (rng.standard_normal((bh, dk)) * 0.3 if bonus
         else np.zeros((bh, dk)))
    cast = getattr(torch, dtype)
    out = [torch.from_numpy(a.astype(np.float32)).to(cast).to(device)
           for a in (r, k, v)]
    out.append(torch.from_numpy(w.astype(np.float32)).to(device))
    out.append(torch.from_numpy(u.astype(np.float32)).to(cast).to(device))
    return out


def linear_cases(torch, np, la, ops):
    """The linear-attention kernel's check cases, each through the wrapper
    (or ``ops.linear_attn``, which pads T) on seeded inputs on the card."""
    specs = [  # label, (BH, T, dk, dv), dtype, decay, bonus, padded, chunk
        ("path", LINEAR_PATH, "bfloat16", "rwkv", True, False, LINEAR_CHUNK),
        ("padded", (32, 300, 64, 64), "bfloat16", "rwkv", True, True,
         LINEAR_CHUNK),
        ("strong_decay", LINEAR_PATH, "float32", "strong", True, False,
         LINEAR_CHUNK),
        ("scalar_decay_u0", LINEAR_PATH, "float32", "scalar", False, False,
         LINEAR_CHUNK),
        ("mamba2_path", MAMBA2_PATH, "float32", "zamba2", False, False,
         LINEAR_CHUNK),
        ("f32", LINEAR_PATH, "float32", "rwkv", True, False, LINEAR_CHUNK),
        ("odd_chunk", (3, 42, 16, 20), "float32", "rwkv", True, False, 7),
    ]
    cases = []
    for i, (label, shape, dtype, decay, bonus, padded, chunk) in enumerate(
            specs):
        r, k, v, w, u = linear_inputs(torch, np, 20 + i, shape, dtype,
                                      decay=decay, bonus=bonus)
        run = ((lambda r=r, k=k, v=v, w=w, u=u, c=chunk: ops.linear_attn_state(
            r, k, v, w, u, chunk=c)) if padded
               else (lambda r=r, k=k, v=v, w=w, u=u, c=chunk:
                     la.linear_attention_state(r, k, v, w, u, chunk=c)))
        strong = decay in ("strong", "zamba2")
        tol = LINEAR_TOL["strong" if strong else dtype]
        cases.append({"label": label, "shape": list(shape), "dtype": dtype,
                      "decay": decay, "padded": padded, "chunk": chunk,
                      "route": la.kernel_for(getattr(torch, dtype), shape[2],
                                             shape[3], chunk),
                      "inputs": (r, k, v, w, u), "run": run, "tol": tol,
                      "state_tol": LINEAR_TOL["strong" if strong
                                              else "float32"]})
    return cases


def check_linear(torch, la, ref, cases):
    """Each case's kernel (output and final state) against the plain
    version, on the kernel ``kernel_for`` names; exits on any disagreement
    or another kernel.  Returns ``{label: max abs error of the output}``."""
    errs = {}
    for case in cases:
        la.VARIANTS.clear()
        got, got_state = case["run"]()
        routes = dict(la.VARIANTS)
        want, want_state = ref.linear_attention_state(*case["inputs"])
        torch.cuda.synchronize()
        tol, stol = case["tol"], case["state_tol"]
        err = float((got.float() - want.float()).abs().max())
        serr = float((got_state - want_state).abs().max())
        ok = (bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol)) and got.dtype == want.dtype
              and bool(torch.allclose(got_state, want_state, rtol=stol,
                                      atol=stol))
              and bool(torch.isfinite(got.float()).all())
              and routes == {case["route"]: 1})
        errs[case["label"]] = err
        via = ("ops.linear_attn" if case["padded"]
               else "linear_attention_state")
        w = case["inputs"][3]
        phase("linear==plain", f"{case['label']} (BH,T,dk,dv)="
              f"{case['shape']} {case['dtype']} r/k/v/u, f32 w, decay "
              f"{case['decay']} (w from {float(w.min()):.3g} to "
              f"{float(w.max()):.3g}, {int((w < 1e-30).sum())} below the "
              f"kernels' 1e-30 clamp, {int((w == 0).sum())} zero), chunk "
              f"{case['chunk']} via {via}, kernels {routes}: "
              f"max_abs_err={err} (outputs up to "
              f"{float(want.float().abs().max()):.3f}) within rtol=atol="
              f"{tol}, final state max_abs_err={serr} within {stol}: {ok}")
        if not ok:
            raise SystemExit(f"linear_attn disagrees with its plain version "
                             f"at {case['label']}")
    return errs


def linear_work(bh: int, t: int, dk: int, dv: int) -> int:
    """The operations the function needs: the per-step recurrence's
    (``ref.linear_attention_state``), per step and row ``dk·dv`` for the
    state's decay, ``2·dk·dv`` for its ``kᵀv`` update and ``2·dk·dv`` for
    ``r S``, ``3·dk`` for the bonus's ``(r ⊙ u)·k`` and ``2·dv`` for
    adding it times ``v``.  The chunked form's pairwise decays are work of
    that form, not of the function, and are not counted."""
    return bh * t * (5 * dk * dv + 3 * dk + 2 * dv)


def linear_bare(torch, la, variant, case, out, state, scratch):
    """A bare launch of ``variant``'s kernel at ``case`` into ``out`` and
    ``state`` (the packed arguments: no checks, no allocation, no count);
    the lambda holds the tensors its raw pointers point into."""
    r, k, v, w, u = case["inputs"]
    bh, t, dk, dv = case["shape"]
    lib = la.library(variant)
    fn = (lib.linear_attn_tc_launch if variant == "subchunk"
          else lib.linear_attn_launch)
    args = la.LINEAR_ARGS.pack(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(),
        0 if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream, bh, t, dk, dv, u.shape[0],
        case["chunk"], *(la.DTYPE_CODES[x.dtype] for x in (r, w, u)))
    return lambda held=(r, k, v, w, u, out, state, scratch): fn(args)


def time_linear(torch, la, ref, case):
    """The linear-attention kernels' times at ``case``: per wrapper call
    (the kernel ``kernel_for`` names) and per bare launch of each kernel
    (the serial one is the earlier design; each bare output is held to the
    plain version first, and the run exits if one disagrees) by CUDA
    events, each timed twice in turns; the device time of one bare launch
    of each by ``torch.profiler``'s rows (the sub-chunked kernel's three
    launches summed) and behind a device spin; the plain version; the
    bound (no single PyTorch call computes the function: no library
    time)."""
    r, k, v, w, u = case["inputs"]
    bh, t, dk, dv = case["shape"]
    chunk = case["chunk"]
    want, want_state = ref.linear_attention_state(r, k, v, w, u)
    runs, outs = {}, {}
    for variant in ("subchunk", "serial"):
        out = torch.empty_like(v)
        state = torch.empty((bh, dk, dv), dtype=torch.float32, device="cuda")
        scratch = (torch.empty(la.scratch_floats(la.library(variant), bh,
                                                 t, chunk),
                               dtype=torch.float32, device="cuda")
                   if variant == "subchunk" else None)
        runs[variant] = linear_bare(torch, la, variant, case, out, state,
                                    scratch)
        if runs[variant]() != 0:
            raise SystemExit(f"bare linear_attn {variant} launch failed")
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        serr = float((state - want_state).abs().max())
        ok = (bool(torch.allclose(out.float(), want.float(),
                                  rtol=case["tol"], atol=case["tol"]))
              and bool(torch.allclose(state, want_state,
                                      rtol=case["state_tol"],
                                      atol=case["state_tol"])))
        outs[variant] = (err, serr)
        phase("linear bare==plain", f"{variant} kernel's bare launch at "
              f"{case['shape']} chunk {chunk} {case['dtype']}: max_abs_err="
              f"{err}, final state {serr}: {ok}")
        if not ok:
            raise SystemExit(f"the bare {variant} linear_attn launch "
                             f"disagrees with the plain version")
    runs["wrapper"] = lambda: la.linear_attention_state(r, k, v, w, u,
                                                        chunk=chunk)
    order = list(runs)
    ev = {name: [] for name in order}
    for name in order + order[::-1]:
        ev[name].append(time_ms(runs[name], 200))
    mean = {name: sum(x) / len(x) for name, x in ev.items()}
    timed = ("subchunk", "serial")
    dev = {name: device_us(torch, runs[name]) for name in timed}
    queued = {name: queued_us(torch, runs[name]) for name in timed}
    row = {"shape": case["shape"], "dtype": case["dtype"], "chunk": chunk,
           "route": case["route"],
           "ms": mean["wrapper"], "kernel_only_ms": mean["subchunk"],
           "serial_kernel_only_ms": mean["serial"],
           "plain_ms": time_ms(lambda: ref.linear_attention_state(
               r, k, v, w, u), 3),
           "library_ms": None, "library_call": None,
           "event_ms_by_pass": ev, "bare_max_abs_err": outs,
           "device_us": {name: us for name, (us, _) in dev.items()},
           "device_kernels": {name: rows for name, (_, rows) in dev.items()},
           "queued_us": {name: us for name, (us, _, _) in queued.items()},
           "queued_enqueue_us": {name: h for name, (_, h, _)
                                 in queued.items()},
           "queued_spin_us": {name: sp for name, (_, _, sp)
                              in queued.items()}}
    nbytes = sum(x.numel() * x.element_size() for x in (r, k, v, w, u)) \
        + v.numel() * v.element_size() + bh * dk * dv * 4
    flops = linear_work(bh, t, dk, dv)
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, case["dtype"])
    row.update(bytes=nbytes, flops=flops)
    us = {name: "not measured" if x is None else f"{x:.2f} us"
          for name, x in row["device_us"].items()}
    qu = {name: "not measured (enqueue past half the spin)" if x is None
          else f"{x:.2f} us" for name, x in row["queued_us"].items()}
    gaps = "; ".join(f"{name} {row['queued_enqueue_us'][name]:.0f} of "
                     f"{row['queued_spin_us'][name]:.0f}" for name in timed)
    phase("linear kernel", f"(BH,T,dk,dv)={case['shape']} chunk {chunk} "
          f"{case['dtype']} r/k/v/u, f32 w, CUDA events (two passes in "
          f"turns): {row['ms'] * 1e3:.2f} us per wrapper call (routed to "
          f"the {case['route']} kernel); bare launches: sub-chunked kernel "
          f"{row['kernel_only_ms'] * 1e3:.2f} us, serial kernel "
          f"{row['serial_kernel_only_ms'] * 1e3:.2f} us; plain version "
          f"{row['plain_ms'] * 1e3:.1f} us, no library call, bound "
          f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: {nbytes} B, "
          f"{flops} operations at the {case['dtype']} peak)")
    phase("linear device time", f"CUDA events behind a device spin, one "
          f"launch: sub-chunked {qu['subchunk']}, serial {qu['serial']} "
          f"(longest host enqueue of 20 calls against the spin, us: "
          f"{gaps}); torch.profiler, one launch: sub-chunked "
          f"{us['subchunk']}, serial {us['serial']}; kernel rows [name, "
          f"count, total us] of 20 calls each: "
          f"{json.dumps(row['device_kernels'])}")
    return row


def route_diff(torch, T, model, plain_impl, batches, max_len):
    """The max abs difference of the last-position prefill logits of
    ``model`` (the kernel route) and of ``plain_impl``'s route on the same
    weights (shared, not copied), over the prefill ``batches``; and the
    logits' max."""
    plain = T.Transformer(dataclasses.replace(model.cfg,
                                              attn_impl=plain_impl),
                          device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    err = 0.0
    for batch in batches:
        got, _ = T.prefill(model, batch, max_len)
        want, _ = T.prefill(plain, batch, max_len)
        err = max(err, float((got - want).abs().max()))
    return err, float(want.abs().max())


def route_check(torch, T, model, model_spec, batches, max_len, failures,
                what):
    """The kernel route against ``model_spec``'s plain route on the
    served weights and, where the route is gated in f32, on the arch's f32
    weights from the same seed; a difference past ``ROUTE_ATOL`` goes to
    ``failures``.  Returns ``(bf16 difference, f32 difference or
    None)``."""
    cfg, plain_impl = model.cfg, model_spec["plain_impl"]
    route_err, scale = route_diff(torch, T, model, plain_impl, batches,
                                  max_len)
    route_dtype = model_spec["route_dtype"]
    gated_err, limit = route_err, ROUTE_ATOL[route_dtype]
    text = (f"{cfg.name}: kernel vs plain ({plain_impl}) route, "
            f"last-position prefill logits of the {len(batches)} {what}, "
            f"bf16 weights: max_abs_diff={route_err} (logits up to "
            f"{scale:.3f})")
    if route_dtype == "bfloat16":
        text += f" within {limit}: {route_err <= limit}"
        route_f32 = None
    else:
        f32 = T.Transformer(
            dataclasses.replace(cfg, param_dtype=route_dtype), device="cuda",
            generator=torch.Generator("cuda").manual_seed(0))
        route_f32, scale_f32 = route_diff(torch, T, f32, plain_impl, batches,
                                          max_len)
        del f32
        torch.cuda.empty_cache()
        gated_err = route_f32
        text += (f" (not gated); f32 weights: max_abs_diff={route_f32} "
                 f"(logits up to {scale_f32:.3f}) within {limit}: "
                 f"{route_f32 <= limit}")
    phase("serve routes", text)
    if not gated_err <= limit:
        failures.append(f"serve {cfg.name}: the kernel route differs from "
                        f"the plain route by {gated_err} > {limit} "
                        f"({route_dtype} weights, {what})")
    return route_err, route_f32


def inline_request(trace, reports, accs: str, engine: str,
                   top_k: int) -> dict:
    """A sweep request carrying ``trace`` and ``reports`` inline, as the
    port's ``client`` sends a trace file.  The server keys each report by
    its own ``(kernel, device_kind)``, so each entry carries its map key
    (the matmul app's reports are named ``mxm_block64`` but keyed by the
    traced ``mxm_block``)."""
    return {"trace": "inline",
            "events": [json.loads(e.to_json()) for e in trace.events],
            "reports": [dict(dataclasses.asdict(r), kernel=kernel,
                             device_kind=kind)
                        for (kernel, kind), r in reports.items()],
            "accs": accs, "engine": engine, "top_k": top_k,
            "budget_s": 1800.0}


def same_ranking(doc: dict, want: dict, rankings_equivalent, rtol) -> bool:
    """``doc`` ranks as ``want`` (a ``batch`` answer) does at ``rtol``,
    with the same best."""
    spans = {t["name"]: t["makespan_s"] for t in want["top"]}
    return doc["best"] == want["best"] and rankings_equivalent(
        [t["name"] for t in doc["top"]], [t["name"] for t in want["top"]],
        spans, rtol)


def best_estimate(estimate, build_candidates, parse_accs, trace, reports,
                  accs: str, want: dict):
    """``want``'s (a ``batch`` answer's) best candidate through the
    reference estimator on the caller's own ``trace`` and ``reports``:
    ``(estimate, batch's makespan, the estimate's makespan)``, equal when
    the server built the same graph."""
    cand = next(c for c in build_candidates(reports, parse_accs(accs),
                                            smp=True)
                if c.name == want["best"])
    est = estimate(trace, cand.system, reports, cand.eligibility)
    span = {t["name"]: t["makespan_s"] for t in want["top"]}[cand.name]
    return est, span, est.makespan_s


def start_server(sweepd, **kw):
    """An in-process sweep server on a free port, serving in a thread;
    returns ``(service, server, base URL)``."""
    svc = sweepd.SweepService(**kw)
    httpd = sweepd.serve(svc, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return svc, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def sweepd_flow(torch, np, ls, device, mm_case, ch_case, one_shot,
                failures):
    """The sweep service on ``device``: (a) one torch request of
    ``mm_case`` (``(label, trace, reports, accs)``) over HTTP to an
    in-process server, held to a ``batch`` request of the same body; (b)
    ``SWEEPD_CLIENTS`` concurrent torch clients of ``ch_case`` against a
    fresh server with ``max_concurrent=4``; (c) ``python -m
    repro_torch.explore serve`` in its own process, one request of (b)'s
    body through ``client``, then SIGTERM while a second is in flight;
    (d) (b)'s best candidate through ``estimate`` and ``write_prv``.  The
    step launch counts are set to 0 just before (a)'s and (b)'s torch
    requests and read just after.  Every failed check is appended to
    ``failures``.  ``one_shot`` is the earlier one-shot sweep of (a)'s
    trace (its row), printed beside (a)."""
    from repro_torch.core import ascii_gantt, estimate, write_prv
    from repro_torch.core.replay import TORCH_RTOL, rankings_equivalent
    from repro_torch.serve import sweepd
    from repro_torch.serve.protocol import (build_candidates, get_json,
                                            parse_accs, post_json)

    def check(label, ok, detail):
        if not ok:
            failures.append(f"sweepd {label}: {detail}")
        return ok

    out = {"launches": {}, "shapes": Counter()}

    def counted(run):
        ls.LAUNCHES = 0
        ls.SHAPES.clear()
        got = run()
        if device == "cuda":
            torch.cuda.synchronize()
        return got, ls.LAUNCHES, Counter(ls.SHAPES)

    # (a) one full-size torch request over HTTP
    label_a, mm_tr, mm_rep, mm_accs = mm_case
    body_a = inline_request(mm_tr, mm_rep, mm_accs, "torch",
                            2 * len(parse_accs(mm_accs)))
    _, httpd_a, url_a = start_server(sweepd, device=device)
    try:
        t0 = time.perf_counter()
        (status, doc_a), launches, shapes = counted(
            lambda: post_json(url_a + "/sweep", body_a, timeout=1900))
        wall_a = time.perf_counter() - t0
        status_b, want_a = post_json(url_a + "/sweep",
                                     dict(body_a, engine="batch"),
                                     timeout=1900)
        ch_label, ch_tr, ch_rep, ch_accs = ch_case
        body_b = inline_request(ch_tr, ch_rep, ch_accs, "torch",
                                2 * len(parse_accs(ch_accs)))
        status_bb, want_b = post_json(url_a + "/sweep",
                                      dict(body_b, engine="batch"),
                                      timeout=1900)
    finally:
        httpd_a.shutdown()
        httpd_a.server_close()
    out["launches"][label_a] = launches
    out["shapes"].update(shapes)
    ok_a = (check("a", status == status_b == status_bb == 200,
                  f"HTTP {status} / {status_b} / {status_bb}")
            and check("a", doc_a["engine_final"] == "torch"
                      and not doc_a["failed"]
                      and doc_a["faults"]["engine_demotions"] == 0,
                      "demoted or failed candidates")
            and check("a", same_ranking(doc_a, want_a, rankings_equivalent,
                                        TORCH_RTOL),
                      "the torch ranking differs from batch's"))
    check("a", launches > 0, "no fused step launch")
    if status_b == 200:
        span, est_span = best_estimate(estimate, build_candidates,
                                       parse_accs, mm_tr, mm_rep, mm_accs,
                                       want_a)[1:]
        check("a", est_span == span, f"batch's best makespan {span} is "
              f"not the estimate's {est_span}")
    n_a = doc_a.get("candidates", 0)
    row_a = {"request": label_a, "candidates": n_a,
             "best": doc_a.get("best"), "batch_best": want_a.get("best"),
             "launches": launches, "timings": doc_a.get("timings"),
             "client_wall_s": wall_a,
             "cand_per_s": n_a / doc_a["timings"]["sweep_s"] if ok_a else None,
             "one_shot": {"sweep": one_shot["sweep"],
                          "torch_s": one_shot["torch_s"],
                          "torch_cand_per_s": one_shot["torch_cand_per_s"]},
             "batch_timings": want_a.get("timings"), "ok": ok_a}
    phase("sweepd", json.dumps(row_a))

    # (b) concurrent torch clients against max_concurrent = 4
    svc_b, httpd_b, url_b = start_server(sweepd, device=device,
                                         max_concurrent=4)
    try:
        results, lat = [None] * SWEEPD_CLIENTS, [0.0] * SWEEPD_CLIENTS

        def client(i):
            t = time.perf_counter()
            results[i] = post_json(url_b + "/sweep", body_b, timeout=1900)
            lat[i] = time.perf_counter() - t

        def run_clients():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SWEEPD_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        t0 = time.perf_counter()
        _, launches, shapes = counted(run_clients)
        wall_b = time.perf_counter() - t0
        _, health = get_json(url_b + "/healthz")
    finally:
        httpd_b.shutdown()
        httpd_b.server_close()
    out["launches"][ch_label] = launches
    out["shapes"].update(shapes)
    statuses = [r[0] for r in results]
    ok_b = (check("b", statuses == [200] * SWEEPD_CLIENTS,
                  f"statuses {statuses}")
            and check("b", all(same_ranking(d, want_b, rankings_equivalent,
                                            TORCH_RTOL)
                               and d["engine_final"] == "torch"
                               for _, d in results),
                      "a client's ranking differs from batch's"))
    reqs = health["requests"]
    check("b", reqs["done"] == SWEEPD_CLIENTS and reqs["errors"] == 0
          and health["faults"]["engine_demotions"] == 0,
          f"/healthz {reqs}, {health['faults']}")
    check("b", launches > 0, "no fused step launch")
    n_b = SWEEPD_CLIENTS * 2 * len(parse_accs(ch_accs))
    p50, p99 = np.percentile(lat, [50, 99])
    phase("sweepd", json.dumps({
        "request": ch_label, "clients": SWEEPD_CLIENTS,
        "max_concurrent": svc_b.max_concurrent, "statuses": statuses,
        "best": results[0][1].get("best"), "batch_best": want_b["best"],
        "launches": launches, "wall_s": wall_b, "cand_per_s": n_b / wall_b,
        "latency_p50_s": p50, "latency_p99_s": p99, "latency_s": lat,
        "sweep_s": [d.get("timings", {}).get("sweep_s")
                    for _, d in results],
        "queue_s": [d.get("timings", {}).get("queue_s")
                    for _, d in results],
        "healthz_requests": reqs,
        "healthz_demotions": health["faults"]["engine_demotions"],
        "ok": ok_b}))

    # (c) the CLI's server in its own process, drained by SIGTERM
    SWEEPD_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = SWEEPD_DIR / f"{ch_label}.jsonl"
    reports_path = SWEEPD_DIR / f"{ch_label}_reports.json"
    ch_tr.save(str(trace_path))
    reports_path.write_text(json.dumps(body_b["reports"]))
    err_path = SWEEPD_DIR / "server.err"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = [sys.executable, "-m", "repro_torch.explore"]
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        server = subprocess.Popen(cli + ["serve", "--port", "0", "--device",
                                         device], stderr=err, env=env,
                                  cwd=str(ROOT))
    second = None
    try:
        url = None
        while url is None and server.poll() is None \
                and time.perf_counter() - t0 < 300:
            words = err_path.read_text().split()
            if "listening" in words:
                url = words[words.index("listening") + 2]
            else:
                time.sleep(0.05)
        if url is None:
            raise SystemExit("sweepd (c): the server never listened: "
                             + err_path.read_text()[-2000:])
        start_s = time.perf_counter() - t0
        client_cmd = cli + ["client", "--url", str(url), str(trace_path),
                            "--reports", str(reports_path), "--accs",
                            ch_accs, "--top-k", str(len(want_b["top"])),
                            "--budget", "1800"]
        t1 = time.perf_counter()
        first = subprocess.run(client_cmd, capture_output=True, text=True,
                               timeout=1900, env=env, cwd=str(ROOT))
        first_s = time.perf_counter() - t1
        doc_c = json.loads(first.stdout) if first.returncode == 0 else {}
        check("c", first.returncode == 0 and same_ranking(
            doc_c, want_b, rankings_equivalent, TORCH_RTOL),
            f"client exit {first.returncode}: {first.stderr[-2000:]}")
        second = subprocess.Popen(client_cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=env, cwd=str(ROOT))
        in_flight = False
        while not in_flight and second.poll() is None \
                and time.perf_counter() - t1 < 600:
            in_flight = get_json(url + "/healthz")[1][
                "requests"]["running"] >= 1
        server.send_signal(signal.SIGTERM)
        out2, err2 = second.communicate(timeout=1900)
        rc = server.wait(timeout=300)
        doc_c2 = json.loads(out2) if second.returncode == 0 else {}
        drain = [line for line in err_path.read_text().splitlines()
                 if line.startswith("sweepd: drained")]
        ok_c = (check("c", in_flight, "SIGTERM found no request in flight")
                and check("c", second.returncode == 0 and same_ranking(
                    doc_c2, want_b, rankings_equivalent, TORCH_RTOL),
                    f"in-flight client exit {second.returncode}: "
                    f"{err2[-2000:]}")
                and check("c", rc == 0 and drain == [
                    "sweepd: drained (2 request(s) served, 0 order "
                    "payload(s) flushed)"],
                    f"server exit {rc}: {err_path.read_text()[-2000:]}"))
    finally:
        for proc in (second, server):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    phase("sweepd", json.dumps({
        "request": f"{ch_label}_cli", "server_start_s": start_s,
        "client_s": first_s, "best": doc_c.get("best"),
        "in_flight_best": doc_c2.get("best"), "in_flight_at_sigterm":
        in_flight, "server_exit": rc, "drain_line": drain, "ok": ok_c}))

    # (d) the best design of (b) as a Paraver trace
    est, span, _ = best_estimate(estimate, build_candidates, parse_accs,
                                 ch_tr, ch_rep, ch_accs, want_b)
    cand_name = want_b["best"]
    PARAVER_DIR.mkdir(parents=True, exist_ok=True)
    prefix = str(PARAVER_DIR / f"{ch_label}_{cand_name}")
    prv = write_prv(est.sim, prefix)
    sizes = {ext: os.path.getsize(prefix + ext)
             for ext in (".prv", ".row", ".pcf")}
    with open(prv) as f:
        header = f.readline()
    ok_d = check("d", header.startswith("#Paraver") and all(sizes.values())
                 and est.makespan_s == span,
                 f"header {header!r}, sizes {sizes}, makespan "
                 f"{est.makespan_s} against batch's {span}")
    phase("sweepd", json.dumps({
        "paraver": os.path.relpath(prv, ROOT), "candidate": cand_name,
        "bytes": sizes, "records": sum(1 for _ in open(prv)) - 1,
        "makespan_s": est.makespan_s, "batch_makespan_s": span,
        "ok": ok_d}))
    print(ascii_gantt(est.sim, width=96, max_rows=12), flush=True)
    return out


def build_model(torch, configs, T, model_spec):
    """``model_spec``'s arch at its published width (its depth cut where
    the spec says) on the card, weights from ``torch.Generator("cuda")``
    seed 0; and the seconds that took."""
    cfg = configs.get_config(model_spec["arch"])
    if "n_layers" in model_spec:        # depth cut to fit the card
        cfg = dataclasses.replace(cfg, n_layers=model_spec["n_layers"])
    t0 = time.perf_counter()
    model = T.Transformer(cfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def kernel_counters(torch, wrappers, kernels):
    """``(clear, read)`` of ``kernels``' counters (``wrappers``: each
    kernel's wrapper module by launch key): ``clear()`` sets every
    ``LAUNCHES``, ``SHAPES`` and ``VARIANTS`` to 0; ``read()`` returns the
    launches, the launches by path shape key (dtypes as text) and by
    kernel, each by launch key."""
    mods = [wrappers[k] for k in kernels]

    def clear():
        for mod in mods:
            for counter in (mod.LAUNCHES, mod.SHAPES, mod.VARIANTS):
                counter.clear()

    def read():
        return ({k: mod.LAUNCHES[k] for k, mod in zip(kernels, mods)},
                {k: {tuple(str(x) if isinstance(x, torch.dtype) else x
                           for x in key): n
                     for key, n in mod.SHAPES.items()}
                 for k, mod in zip(kernels, mods)},
                {k: dict(mod.VARIANTS) for k, mod in zip(kernels, mods)})

    return clear, read


def serve_flow(torch, np, T, engine, wrappers, model, init_s, model_spec,
               failures):
    """Serve ``SERVE``'s traffic through ``Engine.run`` with ``model``
    (``model_spec``'s arch, built in ``init_s`` seconds); returns a summary
    with the launch counts of its kernels in the served run (``wrappers``:
    each kernel's wrapper module by launch key, whose ``LAUNCHES``,
    ``SHAPES`` and ``VARIANTS`` are set to 0 just before the run and read
    just after).  Exits if a request is short or the launch counts are
    off; a kernel route that disagrees with the plain route, or a failed
    self-check, is appended to ``failures`` (the script fails at its end)
    and the phase goes on, so that one run measures everything."""
    specs = model_spec["kernels"]
    kernels = [k["kernel"] for k in specs]
    clear, read = kernel_counters(torch, wrappers, kernels)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(SERVE["prompt_len"],),
                            dtype=np.int32) for _ in range(SERVE["requests"])]
    batches = [{"tokens": torch.as_tensor(pr, device="cuda")[None]}
               for pr in prompts]
    max_len = SERVE["prompt_len"] + SERVE["max_new"] + 1
    warm = engine.Engine(model, slots=1, max_len=max_len)    # lazy inits
    warm.submit(engine.Request(rid=-1, prompt=prompts[0], max_new=2))
    warm.run()
    del warm
    eng = engine.Engine(model, slots=SERVE["slots"], max_len=max_len)
    for rid, pr in enumerate(prompts):
        eng.submit(engine.Request(rid=rid, prompt=pr,
                                  max_new=SERVE["max_new"]))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    clear()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes, variants = read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    served = sum(len(r.out) for r in done)
    summary = {
        "arch": cfg.name, "params": model.param_count(),
        "dtype": str(cfg.dtype), "attn_impl": cfg.attn_impl,
        "init_s": init_s, "requests": len(done), "served_tokens": served,
        "wall_s": wall, "prefill_tokens": st.prefill_tokens,
        "prefill_s": st.prefill_s,
        "prefill_tok_per_s": st.prefill_tokens / st.prefill_s,
        "decode_steps": st.decode_steps, "decode_s": st.decode_s,
        "decode_ms_per_step": st.decode_s / st.decode_steps * 1e3,
        "decode_tok_per_s": st.decode_steps * SERVE["slots"] / st.decode_s,
        "decode_capture_s": st.capture_s,
        "graph_cache": eng.compile_cache.as_dict(),
        "kernels": kernels, "launches": launches,
        "shapes": {k: {str(key): n for key, n in by.items()}
                   for k, by in shapes.items()},
        "variants": variants,
        "peak_mem_gb": peak_gb, "prefill_key": "prefill_512"}
    phase("serve", json.dumps(summary))
    if len(done) != SERVE["requests"] or any(
            len(r.out) != SERVE["max_new"] for r in done):
        raise SystemExit(f"serve {cfg.name}: a request was not served in "
                         f"full")
    for spec in specs:
        kernel, path_key = spec["kernel"], spec["path_key"]
        want = SERVE["requests"] * getattr(cfg, spec["per"])
        if launches[kernel] != want or shapes[kernel].get(path_key) != want:
            raise SystemExit(f"serve {cfg.name}: {launches[kernel]} {kernel} "
                             f"launches ({shapes[kernel]}), expected {want} "
                             f"at {path_key}")
        if variants[kernel] != {spec["variant"]: want}:
            raise SystemExit(f"serve {cfg.name}: {kernel} launches by kernel "
                             f"{variants[kernel]}, expected all {want} on "
                             f"{spec['variant']}")

    # the same traffic through the eager decode step, in the same call:
    # the same tokens, the same last-step logits
    eager = engine.Engine(model, slots=SERVE["slots"], max_len=max_len,
                          graphs=False)
    for rid, pr in enumerate(prompts):
        eager.submit(engine.Request(rid=rid, prompt=pr,
                                    max_new=SERVE["max_new"]))
    torch.cuda.synchronize()
    done_e = eager.run()
    torch.cuda.synchronize()
    graphs_row = graphs_check(cfg.name, eng, done, eager, done_e, failures)
    del eager, done_e

    route_err, route_f32 = route_check(torch, T, model, model_spec, batches,
                                       max_len, failures, "prompts")

    # examples/serve_e2e.py's self-check, one teacher-forced forward each;
    # an MoE arch's forward is another function (see teacher_forced), so
    # its gate is the incremental recomputation and the forward is printed
    moe = has_moe(model)
    t_fwd = SERVE["prompt_len"] + SERVE["max_new"] - 1
    how = (f"each prompt prefilled alone, then {SERVE['max_new'] - 1} "
           f"teacher-forced decode steps at batch 1, eager" if moe else
           f"teacher-forced forward (T={t_fwd}, padded by kernels.ops)")
    worst_gap, exact, check_launches = self_check(
        torch, np, T, model, done, max_len, clear, read, failures, how,
        incremental=moe)
    forward_gap = None
    if moe:
        forward_gap, forward_exact = teacher_forced(torch, np, T, model, done,
                                                    max_len,
                                                    incremental=False)
        phase("serve self-check", f"{cfg.name}: teacher-forced forward "
              f"(T={t_fwd}; its MoE groups of "
              f"{snap_group(cfg, t_fwd)} tokens drop other (token, choice) "
              f"pairs than the served prefill's group of "
              f"{snap_group(cfg, SERVE['prompt_len'])}, so not gated): "
              f"{forward_exact}/{served} served tokens are its argmax, the "
              f"worst is {forward_gap} below its position's maximum")
    summary.update(graphs=graphs_row, route_max_abs_diff=route_err,
                   route_f32_max_abs_diff=route_f32,
                   selfcheck_worst_gap=worst_gap,
                   selfcheck_argmax_equal=exact,
                   selfcheck_incremental=moe,
                   selfcheck_forward_worst_gap=forward_gap,
                   selfcheck_launches={
                       k: {str(key): n for key, n in by.items()}
                       for k, by in check_launches.items()},
                   profile=profile_serve(torch, engine, model, batches,
                                         max_len, kernels, eng,
                                         "prefill_512"))
    if moe:
        summary["moe_profile"] = profile_moe(torch, T, model, summary)
    return summary


def fused_requests(torch, np, cfg, key, prompt_len):
    """``SERVE``'s requests for an arch whose prefill takes ``key``
    (``"patches"`` or ``"frames"``): ``(prompt, prefill batch)`` pairs,
    the prompts :func:`serve_flow` draws (numpy seed 0) at ``prompt_len``,
    each batch with its own standard-normal rows ``(1, patch_tokens or
    encoder_seq, d_model)`` in the weights' type, drawn on the card from
    ``torch.Generator("cuda")`` seed 1 (a conv or ViT frontend's output:
    the JAX package stubs both)."""
    rng = np.random.default_rng(0)
    gen = torch.Generator("cuda").manual_seed(1)
    rows = cfg.patch_tokens if key == "patches" else cfg.encoder_seq
    out = []
    for _ in range(SERVE["requests"]):
        prompt = rng.integers(0, cfg.vocab, size=(prompt_len,),
                              dtype=np.int32)
        extra = torch.randn((1, rows, cfg.d_model), device="cuda",
                            generator=gen).to(cfg.dtype)
        out.append((prompt, {"tokens": torch.as_tensor(
            prompt, device="cuda")[None], key: extra}))
    return out


def fused_serve(torch, engine, model, requests, max_len, *, graphs):
    """``Engine.run``'s batching of ``requests`` (:func:`fused_requests`)
    through the step entry points: each prefilled alone by
    ``make_prefill_step`` with its patches or frames, then ``slots`` at a
    time decoded in lock-step by the engine's decode runner (captured
    unless ``graphs`` is false) from ``positions + 1``.  Returns the
    served ``Request``s and the ``Engine``, whose ``stats`` and
    ``last_logits`` count the run as ``Engine.run`` counts its own
    (``prefill_tokens``: the prompts' tokens)."""
    eng = engine.Engine(model, slots=SERVE["slots"], max_len=max_len,
                        graphs=graphs)
    prefill = engine.make_prefill_step(model, max_len)
    st = eng.stats
    done = []
    for b0 in range(0, len(requests), eng.slots):
        active, caches, toks = [], [], []
        for rid in range(b0, min(b0 + eng.slots, len(requests))):
            prompt, batch = requests[rid]
            t0 = time.perf_counter()
            tok, cache = prefill(batch)
            active.append(engine.Request(rid=rid, prompt=prompt,
                                         max_new=SERVE["max_new"],
                                         out=[int(tok[0, 0])]))
            st.prefill_s += time.perf_counter() - t0
            st.prefill_tokens += len(prompt)
            caches.append(cache)
            toks.append(tok)
        t0 = time.perf_counter()
        runner = eng.decoder(len(active))
        st.capture_s += time.perf_counter() - t0
        runner.load(caches, torch.cat(toks), max(
            positions(requests[r.rid][1]) for r in active) + 1)
        for _ in range(SERVE["max_new"] - 1):
            t0 = time.perf_counter()
            host = runner.step()[:, 0].tolist()
            st.decode_s += time.perf_counter() - t0
            st.decode_steps += 1
            for r, tok in zip(active, host):
                r.out.append(tok)
        eng.last_logits = runner.logits.clone()
        done += active
    return done, eng


def fused_flow(torch, np, T, engine, wrappers, model, init_s, model_spec,
               failures):
    """Serve ``SERVE``'s requests with ``model`` (``model_spec``'s arch),
    each with its seeded patches or frames (``model_spec["fused"]``),
    through the step entry points (:func:`fused_serve`), with the flash
    counts set to 0 just before the served run and read just after: every
    launch at the fused path shape, on its kernel, one a layer a request,
    and none elsewhere (for whisper: none at the encoder's 1500 frames),
    else the script exits.  Then :func:`serve_flow`'s checks: the eager
    decode step serves the same tokens and last logits, the kernel route
    against the plain one, the teacher-forced self-check (the forward with
    each request's patches or frames), and a profile; for whisper also
    the encoder's time a request apart from the whole prefill's.  Returns
    a summary."""
    fused = model_spec["fused"]
    key, path_key = fused["input"], fused["path_key"]
    spec = model_spec["kernels"][0]
    kernel = spec["kernel"]
    clear, read = kernel_counters(torch, wrappers, [kernel])
    cfg = model.cfg
    requests = fused_requests(torch, np, cfg, key, fused["prompt_len"])
    batches = [batch for _, batch in requests]
    n_pos = positions(batches[0])
    max_len = n_pos + SERVE["max_new"] + 1
    prefill = engine.make_prefill_step(model, max_len)
    prefill(batches[0])                     # lazy inits at this shape
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    clear()
    t0 = time.perf_counter()
    done, eng = fused_serve(torch, engine, model, requests, max_len,
                            graphs=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes, variants = read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = eng.stats
    served = sum(len(r.out) for r in done)
    want = SERVE["requests"] * cfg.n_layers
    at_encoder = sum(n for k, n in shapes[kernel].items()
                     if cfg.is_enc_dec and k[2] == cfg.encoder_seq)
    summary = {
        "arch": cfg.name, "input": key, "params": model.param_count(),
        "dtype": str(cfg.dtype), "attn_impl": cfg.attn_impl,
        "init_s": init_s, "requests": len(done), "served_tokens": served,
        "positions_a_prefill": n_pos, "wall_s": wall,
        "prefill_tokens": st.prefill_tokens, "prefill_s": st.prefill_s,
        "prefill_tok_per_s": st.prefill_tokens / st.prefill_s,
        "prefill_positions_per_s": len(done) * n_pos / st.prefill_s,
        "decode_steps": st.decode_steps, "decode_s": st.decode_s,
        "decode_ms_per_step": st.decode_s / st.decode_steps * 1e3,
        "decode_tok_per_s": st.decode_steps * SERVE["slots"] / st.decode_s,
        "decode_capture_s": st.capture_s,
        "graph_cache": eng.compile_cache.as_dict(),
        "kernels": [kernel], "launches": launches,
        "shapes": {k: {str(sh): n for sh, n in by.items()}
                   for k, by in shapes.items()},
        "variants": variants, "launches_at_encoder_seq": at_encoder,
        "peak_mem_gb": peak_gb, "prefill_key": f"prefill_{key}_{n_pos}"}
    if cfg.is_enc_dec:
        enc_ms = time_ms(lambda: T._encoder_kv(model, batches[0]), 8)
        prefill_ms = time_ms(lambda: prefill(batches[0]), 8)
        summary.update(encoder_ms_a_request=enc_ms,
                       prefill_ms_a_request=prefill_ms,
                       decoder_prefill_ms_a_request=prefill_ms - enc_ms)
    phase("serve fused", json.dumps(summary))
    if len(done) != SERVE["requests"] or any(
            len(r.out) != SERVE["max_new"] for r in done):
        raise SystemExit(f"serve {cfg.name} with {key}: a request was not "
                         f"served in full")
    if launches[kernel] != want or shapes[kernel] != {path_key: want}:
        raise SystemExit(f"serve {cfg.name} with {key}: {launches[kernel]} "
                         f"{kernel} launches ({shapes[kernel]}), expected "
                         f"{want}, all at {path_key}")
    if variants[kernel] != {spec["variant"]: want}:
        raise SystemExit(f"serve {cfg.name} with {key}: {kernel} launches "
                         f"by kernel {variants[kernel]}, expected all {want} "
                         f"on {spec['variant']}")

    done_e, eager = fused_serve(torch, engine, model, requests, max_len,
                                graphs=False)
    torch.cuda.synchronize()
    graphs_row = graphs_check(f"{cfg.name} with {key}", eng, done, eager,
                              done_e, failures)
    del eager, done_e
    route_err, route_f32 = route_check(torch, T, model, model_spec, batches,
                                       max_len, failures,
                                       f"prompts with their {key}")
    t_fwd = fused["prompt_len"] + SERVE["max_new"] - 1
    worst_gap, exact, check_launches = self_check(
        torch, np, T, model, done, max_len, clear, read, failures,
        f"teacher-forced forward with the {key} (T={t_fwd} tokens, "
        f"{positions(batches[0]) - fused['prompt_len'] + t_fwd} positions, "
        f"padded by kernels.ops)", incremental=False,
        extras=[{key: batch[key]} for batch in batches])
    summary.update(graphs=graphs_row, route_max_abs_diff=route_err,
                   route_f32_max_abs_diff=route_f32,
                   selfcheck_worst_gap=worst_gap,
                   selfcheck_argmax_equal=exact,
                   selfcheck_launches={
                       k: {str(sh): n for sh, n in by.items()}
                       for k, by in check_launches.items()},
                   profile=profile_serve(torch, engine, model, batches,
                                         max_len, [kernel], eng,
                                         summary["prefill_key"]))
    return summary


def graphs_check(name, eng, done, eager, done_e, failures):
    """The captured decode step (``eng``, which served ``done``) against
    the eager one (``eager``, ``done_e``) in the same call: the same
    tokens and the same last-step logits, else ``failures``; prints and
    returns the ``[serve graphs]`` row."""
    st, se = eng.stats, eager.stats
    same_tokens = ({r.rid: r.out for r in done}
                   == {r.rid: r.out for r in done_e})
    logits_diff = float((eng.last_logits.float()
                         - eager.last_logits.float()).abs().max())
    row = {
        "arch": name, "decode_steps": st.decode_steps,
        "graph_decode_ms_per_step": st.decode_s / st.decode_steps * 1e3,
        "eager_decode_ms_per_step": se.decode_s / se.decode_steps * 1e3,
        "graph_capture_s": st.capture_s,
        "graph_cache": eng.compile_cache.as_dict(),
        "same_tokens": same_tokens,
        "last_step_logits_max_abs_diff": logits_diff,
        "ok": same_tokens and logits_diff == 0.0}
    phase("serve graphs", json.dumps(row))
    if not same_tokens:
        failures.append(f"serve {name}: the captured decode step served "
                        f"other tokens than the eager one")
    if logits_diff != 0.0:
        failures.append(f"serve {name}: the captured decode step's last "
                        f"logits differ from the eager step's by "
                        f"{logits_diff}")
    return row


def self_check(torch, np, T, model, done, max_len, clear, read, failures,
               how, *, incremental, extras=None):
    """``examples/serve_e2e.py``'s self-check of the served ``done`` by
    :func:`teacher_forced`, with the kernel counters (``clear``/``read``
    of :func:`kernel_counters`) set to 0 just before and read just after:
    exits if the check launched none of the kernels; a served token
    further than ``SELFCHECK_TOL`` below its position's maximum goes to
    ``failures``.  Returns ``(worst gap, argmax count, launches by path
    shape key)``."""
    cfg = model.cfg
    clear()
    worst_gap, exact = teacher_forced(torch, np, T, model, done, max_len,
                                      incremental=incremental, extras=extras)
    _, check_launches, _ = read()
    served = sum(len(r.out) for r in done)
    phase("serve self-check", f"{cfg.name}: {how} (launches "
          f"{check_launches}): {exact}/{served} served tokens are its "
          f"argmax, the worst is {worst_gap} below its position's maximum, "
          f"within {SELFCHECK_TOL}: {worst_gap <= SELFCHECK_TOL}")
    missing = [k for k, by in check_launches.items() if not by]
    if missing:
        raise SystemExit(f"serve {cfg.name}: the self-check's forward "
                         f"launched no {', '.join(missing)}")
    if not worst_gap <= SELFCHECK_TOL:
        failures.append(f"serve {cfg.name}: a served token is {worst_gap} "
                        f"below its position's maximum > {SELFCHECK_TOL}")
    return worst_gap, exact, check_launches


def has_moe(model) -> bool:
    return any(getattr(layer, "moe", None) is not None
               for layer in model.layers)


def snap_group(cfg, n_tok: int) -> int:
    """The MoE group size ``n_tok`` tokens of one sequence dispatch in."""
    from repro_torch.models.moe import snap_group_size
    return snap_group_size(n_tok, cfg.moe_group_size)


def teacher_forced(torch, np, T, model, done, max_len, *, incremental,
                   extras=None):
    """The served tokens of ``done`` against the logits each position
    gets with the served sequence fed back: ``(worst gap below the
    position's maximum, how many are the argmax)``.

    ``incremental=False`` is ``examples/serve_e2e.py``'s check, one
    ``forward`` over each served sequence (with request ``rid``'s patches
    or frames, ``extras[rid]``, in its batch: the forward returns the text
    positions' logits).  For an MoE that is another
    function than the served one: the forward dispatches the sequence in
    other groups, whose capacity drops other (token, choice) pairs (with
    random weights the router is far from balanced: PERF.md §7).  So
    ``incremental=True`` recomputes what the engine computes, request by
    request: its prompt prefilled alone (the served prefill's group), then
    one eager decode step a served token at batch 1 (``SERVE``'s decode
    groups of at most 4 tokens never drop: an expert gets at most one
    choice a token, and the capacity is never below 4)."""
    worst, exact = 0.0, 0
    for r in done:
        if incremental:
            logits, cache = T.prefill(model, {"tokens": torch.as_tensor(
                r.prompt, device="cuda")[None]}, max_len)
            rows = [logits[0, -1]]
            for i, tok in enumerate(r.out[:-1]):
                logits, cache = T.decode_step(
                    model, torch.tensor([[tok]], dtype=torch.int32,
                                        device="cuda"),
                    cache, len(r.prompt) + 1 + i)
                rows.append(logits[0, -1])
            pos = torch.stack(rows)
        else:
            seq = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
            logits, _ = T.forward(model, {
                "tokens": torch.as_tensor(seq, device="cuda")[None],
                **(extras[r.rid] if extras else {})})
            pos = logits[0, len(r.prompt) - 1:]
        picked = pos.gather(1, torch.as_tensor(r.out, device="cuda")[:, None])
        gaps = pos.amax(1) - picked[:, 0]
        worst = max(worst, float(gaps.max()))
        exact += int((gaps == 0).sum())
    return worst, exact


def profile_moe(torch, T, model, served):
    """The MoE's share of a 512-token prefill's device time: one MoE
    layer's ``moe_apply`` on that prefill's shapes (its first layer's
    weights, a seeded input through the layer's norm) under
    ``torch.profiler``, times the model's MoE layers, over the prefill's
    device time in ``served``'s profile; with the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.moe import moe_apply
    cfg = model.cfg
    layers = [layer for layer in model.layers
              if getattr(layer, "moe", None) is not None]
    layer = layers[0]
    gen = torch.Generator("cuda").manual_seed(3)
    x = torch.randn((1, SERVE["prompt_len"], cfg.d_model), device="cuda",
                    generator=gen).to(cfg.dtype)
    h = layer.ln2(x)

    def run():
        return moe_apply(layer.moe, h, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         group_size=cfg.moe_group_size,
                         dispatch=cfg.moe_dispatch)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if "cuda" in str(e.device_type).lower()]
    layer_s = sum(e.self_device_time_total for e in dev) * 1e-6
    prefill_s = served["profile"]["prefill_512"]["device_s"]
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    out = {"arch": cfg.name, "moe_layers": len(layers),
           "moe_layer_device_s": layer_s,
           "moe_layer_kernels": sum(e.count for e in dev),
           "prefill_device_s": prefill_s,
           "moe_prefill_device_share": len(layers) * layer_s / prefill_s,
           "flash_prefill_device_share": served["profile"]["prefill_512"][
               "kernel_device_share_by_kernel"].get("flash_attention"),
           "top_device_kernels": [[e.key[:80], e.count,
                                   e.self_device_time_total * 1e-6]
                                  for e in top]}
    phase("serve moe", json.dumps(out))
    return out


def positions(batch) -> int:
    """The positions a prefill batch fills: its patches and its tokens."""
    return sum(batch[k].shape[1] for k in ("patches", "tokens")
               if k in batch)


def profile_serve(torch, engine, model, batches, max_len, kernels, eng,
                  prefill_key):
    """Where one prefill (of ``batches[0]``, named ``prefill_key``) and
    one batch-4 decode step spend their time on the card: each run once
    unprofiled (host wall, ending in a synchronise) and once under
    ``torch.profiler`` (device time, kernel count, the costliest host
    operations and device kernels, and the device time and share of the
    rows whose name holds each of ``kernels``, and of all of them); the
    decode step also as one replay of ``eng``'s captured graph."""
    from torch.profiler import ProfilerActivity, profile
    prefill = engine.make_prefill_step(model, max_len)
    step = engine.make_serve_step(model)
    caches, toks = [], []
    for batch in batches[:SERVE["slots"]]:
        tok, cache = prefill(batch)
        caches.append(cache)
        toks.append(tok)
    cache = [{name: torch.cat([c[layer][name] for c in caches])
              for name in caches[0][layer]}
             for layer in range(len(caches[0]))]
    toks = torch.cat(toks)
    length = positions(batches[0]) + 1
    runner = eng.decoder(SERVE["slots"])
    runner.load(caches, toks, length)
    runs = {prefill_key: lambda: prefill(batches[0]),
            "decode_step_b4": lambda: step(toks, cache, length),
            "decode_step_b4_graph": runner.step}
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        dev = [e for e in events if "cuda" in str(e.device_type).lower()]
        device_s = sum(e.self_device_time_total for e in dev) * 1e-6
        top_host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
        top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
        by_kernel = {k: sum(e.self_device_time_total for e in dev
                            if k in e.key) * 1e-6 for k in kernels}
        mine = sum(by_kernel.values())
        out[name] = {
            "wall_s": wall, "device_s": device_s,
            "device_busy_share": device_s / wall,
            "kernel_device_s": mine, "kernel_device_share": mine / device_s,
            "kernel_device_share_by_kernel": {
                k: t / device_s for k, t in by_kernel.items()},
            "kernels": sum(e.count for e in dev),
            "top_host_ops": [[e.key, e.count, e.self_cpu_time_total * 1e-6]
                             for e in top_host],
            "top_device_kernels": [[e.key[:80], e.count,
                                    e.self_device_time_total * 1e-6]
                                   for e in top_dev]}
        phase("serve profile", json.dumps({"arch": model.cfg.name,
                                           name: out[name]}))
    return out


def matmul_fraction(torch, dtype: str, n: int = MATMUL_EFF_N):
    """The sustained fraction of ``dtype``'s peak of a square
    ``torch.matmul`` at ``n`` (seeded operands), by CUDA events."""
    gen = torch.Generator("cuda").manual_seed(7)
    a, b = (torch.randn((n, n), device="cuda", generator=gen)
            .to(getattr(torch, dtype)) for _ in range(2))
    ms = time_ms(lambda: torch.matmul(a, b),
                 20 if dtype == "bfloat16" else 4)
    del a, b
    return 2.0 * n ** 3 / (ms * 1e-3) / PEAK_FLOPS[dtype], ms


def meta_model(T, configs, arch, n_layers=None):
    """``arch``'s published config (its depth cut to ``n_layers``) built
    on ``meta``: nothing is allocated."""
    cfg = configs.get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return T.Transformer(cfg, device="meta")


def meta_runs(torch, T, model, batch: int = SERVE["slots"]):
    """The serve path's two steps of ``model`` on meta: a prefill of one
    ``SERVE`` prompt and a decode step at ``batch`` (the cache at the
    prompt's length), as ``(fn, args)``."""
    t = SERVE["prompt_len"]
    max_len = t + SERVE["max_new"] + 1
    toks = torch.zeros((1, t), dtype=torch.int32, device="meta")
    step = torch.zeros((batch, 1), dtype=torch.int32, device="meta")
    cache = T.init_cache(model.cfg, batch, max_len, device="meta")
    return {"prefill_512": (T.prefill, (model, {"tokens": toks}, max_len)),
            "decode_step_b4": (T.decode_step, (model, step, cache, t + 1))}


def cost_model_flow(torch, configs, T, hlsreport, served):
    """``[cost model]``: the sustained bf16 and f32 matmul fractions, then
    ``TorchCostModel``'s prediction (at those fractions) of each served
    arch's prefill and decode step against the device time measured in
    this call (``served``: arch → its serve summary, whose profile holds
    the prefill's and the captured decode step's device seconds)."""
    t0 = time.perf_counter()
    frac = {dt: matmul_fraction(torch, dt) for dt in ("bfloat16", "float32")}
    phase("cost model", f"torch.matmul at {MATMUL_EFF_N}^3: bf16 "
          f"{frac['bfloat16'][1]:.3f} ms, {frac['bfloat16'][0]:.4f} of "
          f"{PEAK_FLOPS['bfloat16']:.3g} FLOP/s; f32 "
          f"{frac['float32'][1]:.3f} ms, {frac['float32'][0]:.4f} of "
          f"{PEAK_FLOPS['float32']:.3g} FLOP/s (TF32 off)")
    consts = dataclasses.replace(
        hlsreport.H100_SXM, matmul_efficiency=frac["bfloat16"][0],
        matmul_efficiency_f32=frac["float32"][0])
    cm = hlsreport.TorchCostModel(consts)
    rows = []
    for arch, summary in served.items():
        layers = summary.get("n_layers")
        model = meta_model(T, configs, arch, layers)
        measured = {"prefill_512": summary["profile"]["prefill_512"],
                    "decode_step_b4": summary["profile"][
                        "decode_step_b4_graph"]}
        for step, (fn, args) in meta_runs(torch, T, model).items():
            t1 = time.perf_counter()
            a = cm.analyze(fn, *args)
            count_s = time.perf_counter() - t1
            pred = cm.seconds(a)
            dev = measured[step]["device_s"]
            row = {"arch": arch, "n_layers": model.cfg.n_layers,
                   "step": step, "predicted_s": pred,
                   "flops_s": consts.flops_seconds(a["flops_by_dtype"]),
                   "bytes_s": a["bytes"] / consts.hbm_bw,
                   "measured_device_s": dev,
                   "measured_wall_s": measured[step]["wall_s"],
                   "predicted_over_measured": pred / dev,
                   "flops_by_dtype": a["flops_by_dtype"],
                   "bytes": a["bytes"],
                   "transcendentals": a["transcendentals"],
                   "aten_ops": a["ops"], "count_s": count_s}
            phase("cost model", json.dumps(row))
            rows.append(row)
    return {"matmul_fraction": {dt: f for dt, (f, _) in frac.items()},
            "matmul_ms": {dt: ms for dt, (_, ms) in frac.items()},
            "rows": rows, "seconds": time.perf_counter() - t0}


def probe_record(arch, n_layers):
    """The dry-run's probe record of ``arch`` at its published width and
    ``n_layers`` layers (``dryrun.run_cell`` on a fake (1, 1) mesh): a
    ``SERVE`` prompt's prefill, no collectives (one card)."""
    from repro_torch.configs import Shape
    from repro_torch.launch import dryrun
    return dryrun.run_cell(
        arch, "prefill_32k", False, mesh_override=((1, 1), ("data", "model")),
        save=False, probe_layers=n_layers,
        shape_override=Shape("prefill_512", SERVE["prompt_len"], 1,
                             "prefill"))


def step_estimate_flow(steptask, roofline, arch, measured_s, full_layers):
    """``[step estimate]``: probes at 1 and 2 layers, then
    ``estimate_step`` at the served depth against ``measured_s`` (the
    served prefill's device time) and at the published depth; each at the
    ``H100`` record (every FLOP at the bf16 peak, as the reference's
    estimator counts) and at a record whose peak is the f32 one (the rate
    of mixtral's f32 expert products)."""
    t0 = time.perf_counter()
    p1, p2 = (probe_record(arch, n) for n in (1, 2))
    hws = {"h100_bf16_peak": roofline.H100,
           "h100_f32_peak": dataclasses.replace(
               roofline.H100, name="h100_f32_peak",
               peak_flops=PEAK_FLOPS["float32"])}
    rows = []
    for name, hw in hws.items():
        for layers in (MIXTRAL_LAYERS, full_layers):
            est = steptask.estimate_step(arch, "prefill_512", p1, p2, layers,
                                         hw=hw)
            row = {"arch": arch, "hw": name, "n_layers": layers,
                   "predicted_s": est.makespan_s,
                   "layer_compute_s": est.costs.layer_compute,
                   "head_compute_s": est.costs.head_compute,
                   "measured_device_s": (measured_s if layers
                                         == MIXTRAL_LAYERS else None),
                   "predicted_over_measured": (
                       est.makespan_s / measured_s
                       if layers == MIXTRAL_LAYERS else None)}
            phase("step estimate", json.dumps(row))
            rows.append(row)
    return {"probes": [p1, p2], "rows": rows,
            "seconds": time.perf_counter() - t0}


def path_row(row, served, kernel):
    """A timed row of ``kernel`` at one serve path's shape for the
    ``kernels`` line: its times, bound and library call, and the served
    run's launches of ``kernel`` and share of a prefill's device time."""
    keys = ("shape", "dtype", "ms", "kernel_only_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "device_us", "queued_us")
    return {"arch": served["arch"], "launches": served["launches"][kernel],
            "prefill_device_share": served["profile"][served["prefill_key"]][
                "kernel_device_share_by_kernel"][kernel],
            **{key: row[key] for key in keys}}


def tile_kernel_rows(rows, fig6, chol):
    """The ``kernels`` line's entries of the tile kernels: each at its
    commonest path shape (f32, 64), with all its rows beside."""
    src = "src/repro_torch/kernels/csrc/tiles.cu"
    meta = {
        "block_matmul": ("src/repro/kernels/block_matmul.py:34",
                         {"traditional_flow": fig6["block_matmul_launches"],
                          "cholesky_gemm_update":
                              chol["launches"]["gemm_update"]}),
        "syrk_tile": ("src/repro/kernels/cholesky_tiles.py:34",
                      {"cholesky": chol["launches"]["syrk_tile"]}),
        "trsm_tile": ("src/repro/kernels/cholesky_tiles.py:86",
                      {"cholesky": chol["launches"]["trsm_tile"]}),
    }
    out = []
    for name, (replaces, by_path) in meta.items():
        mine = [r for r in rows if r["kernel"] == name]
        top = mine[0]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == "float32"),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "kernel_only_ms": top["kernel_only_ms"],
            "device_us": top["device_us"], "queued_us": top["queued_us"],
            "queued_enqueue_us": top["queued_enqueue_us"],
            "queued_spin_us": top["queued_spin_us"],
            "slower_than_library": top["slower_than_library"],
            "timed_shape": top["shape"], "launches_by_path": by_path,
            "by_shape": mine})
    return out


def train_models(torch, T, cfg, state, modes=("none",)):
    """A model of ``cfg`` on the card per remat mode, each loaded with
    ``state`` (built on ``meta`` and allocated empty, so no weights are
    drawn)."""
    out = {}
    for mode in modes:
        model = T.Transformer(dataclasses.replace(cfg, remat=mode),
                              device="meta").to_empty(device="cuda")
        model.load_state_dict(state)
        out[mode] = model
    return out


def max_rel(torch, got, want) -> float:
    """Largest ``|got - want| / (|want| + 1e-30)`` over two tensors."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float(((got - want).abs() / (want.abs() + 1e-30)).max())


def held(torch, got, want, rtol, atol) -> bool:
    """``|got - want| <= atol + rtol·|want|`` everywhere (numpy's
    ``allclose``), on the host."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def params_held(torch, a, b, rtol, atol):
    """``(every parameter of model a held to b's, worst abs difference,
    its name)``."""
    ok, worst, where = True, 0.0, ""
    pb = dict(b.named_parameters())
    for name, p in a.named_parameters():
        q = pb[name]
        ok &= held(torch, p, q, rtol, atol)
        d = float((p.detach().float().cpu() - q.detach().float().cpu())
                  .abs().max())
        if d > worst:
            worst, where = d, name
    return ok, worst, where


def train_flow(torch, np, configs, T, failures):
    """The ``[train]`` phase: the port's train step on qwen3-0.6b at its
    published width, on the chunked route (the JAX package's training
    arithmetic; the kernels have no backward).  (a) 2 layers in f32, one
    step on the card against the same step on the CPU; (b) on the card,
    the three remat modes (loss, gradients, peak memory) and
    accumulation over two microbatches against one batch; (c) the
    supervisor's replay under deterministic algorithms against an
    uninterrupted run; (d) full width and depth in bf16, 20 steps through
    the supervisor with asynchronous checkpoints and one injected failure
    (tokens/s, ms a step by CUDA events, peak memory, a 3-step profile,
    the loss falling); (e) the kernel wrappers refuse operands that
    require grad on the card and launch nothing.  Every check that fails
    is added to ``failures``.  Returns the summary."""
    import copy
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import cholesky_tiles as ct
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_attn as la
    from repro_torch.kernels import lockstep_step as ls
    from repro_torch.kernels import ops
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as S
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.supervisor import FailureInjector, Supervisor

    t_phase = time.perf_counter()
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    out = {"arch": TRAIN_ARCH}

    def check(label, ok, detail):
        phase("train check", f"{label}: {detail}: {ok}")
        if not ok:
            failures.append(f"train {label}: {detail}")

    # (a) card against CPU: one step from the same weights and batch
    ck = TRAIN_CHECK
    cfg2 = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                               n_layers=ck["n_layers"], param_dtype="float32",
                               attn_impl="chunked")
    cpu = T.Transformer(cfg2, device="cpu")
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    ds2 = SyntheticLM(DataConfig(seq_len=ck["seq"], global_batch=ck["batch"],
                                 vocab=cfg2.vocab))
    batch = ds2.global_batch(0)
    tcfg = S.TrainConfig(opt=opt_mod.OptConfig(lr=1e-2))
    results = {}
    for dev, model in (("cuda", train_models(torch, T, cfg2, init)["none"]),
                       ("cpu", cpu)):
        state = opt_mod.init(tcfg.opt, S.trainable(model))
        t0 = time.perf_counter()
        model, state, m = S.make_train_step(cfg2, tcfg)(model, state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        results[dev] = (model, m, time.perf_counter() - t0)
    (gpu_model, gm, g_s), (cpu_model, cm, c_s) = results["cuda"], \
        results["cpu"]
    tol = TRAIN_STEP_TOL
    loss_rel = max_rel(torch, gm["loss"], cm["loss"])
    norm_rel = max_rel(torch, gm["grad_norm"], cm["grad_norm"])
    p_ok, p_worst, p_where = params_held(torch, gpu_model, cpu_model,
                                         *tol["params"])
    out["card_vs_cpu"] = {
        "n_layers": ck["n_layers"], "batch": [ck["batch"], ck["seq"]],
        "dtype": "float32", "loss_card": float(gm["loss"]),
        "loss_cpu": float(cm["loss"]), "loss_rel_diff": loss_rel,
        "grad_norm_card": float(gm["grad_norm"]),
        "grad_norm_cpu": float(cm["grad_norm"]), "grad_norm_rel_diff":
        norm_rel, "param_max_abs_diff": p_worst, "param_worst": p_where,
        "card_step_s_first_call": g_s, "cpu_step_s": c_s}
    phase("train card vs cpu", json.dumps(out["card_vs_cpu"]))
    check("(a) card vs cpu", loss_rel <= tol["loss"] and
          norm_rel <= tol["loss"],
          f"loss and grad norm within rtol {tol['loss']}")
    check("(a) card vs cpu", p_ok, f"updated parameters within rtol "
          f"{tol['params'][0]} / atol {tol['params'][1]}")
    del cpu, cpu_model, gpu_model

    # (b) the remat modes' loss, gradients and peak memory; accumulation
    card_batch = {k: torch.as_tensor(v, device="cuda")
                  for k, v in batch.items()}
    models = train_models(torch, T, cfg2, init, ("none", "full", "dots"))
    remat, base = {}, None
    for mode, model in models.items():
        loss_fn = S.make_loss_fn(model.cfg, 0.01)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        total, _, grads = S.value_and_grad(loss_fn, model, card_batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        if base is None:
            base = (total, grads)
            worst = 0.0
            ok = True
        else:
            ok = held(torch, total, base[0], REMAT_TOL, REMAT_TOL) and all(
                held(torch, g, base[1][k], REMAT_TOL, REMAT_TOL)
                for k, g in grads.items())
            worst = max(float((g - base[1][k]).abs().max())
                        for k, g in grads.items())
        remat[mode] = {"loss": float(total), "grad_max_abs_diff": worst,
                       "peak_bytes_over_weights": peak}
        if mode != "none":
            check(f"(b) remat {mode}", ok, f"loss and gradients within "
                  f"{REMAT_TOL} of remat none")
    del models, base, grads
    out["remat_2_layers"] = remat
    phase("train remat", json.dumps({"n_layers": ck["n_layers"],
                                     "batch": [ck["batch"], ck["seq"]],
                                     "dtype": "float32", **remat}))
    accum = {}
    for n in (1, 2):
        model = train_models(torch, T, cfg2, init)["none"]
        tc = dataclasses.replace(tcfg, accum_steps=n)
        state = opt_mod.init(tc.opt, S.trainable(model))
        model, state, m = S.make_train_step(cfg2, tc)(model, state, batch)
        accum[n] = (model, float(m["loss"]))
    a_ok, a_worst, _ = params_held(torch, accum[2][0], accum[1][0],
                                   *tol["params"])
    a_rel = abs(accum[2][1] - accum[1][1]) / abs(accum[1][1])
    out["accum"] = {"loss_1": accum[1][1], "loss_2": accum[2][1],
                    "loss_rel_diff": a_rel, "param_max_abs_diff": a_worst}
    phase("train accum", json.dumps(out["accum"]))
    check("(b) accum_steps=2", a_rel <= tol["accum_loss"] and a_ok,
          f"loss within rtol {tol['accum_loss']}, parameters within rtol "
          f"{tol['params'][0]} / atol {tol['params'][1]} of accum_steps=1")
    del accum

    # (c) the supervisor's replay against an uninterrupted run, with
    # deterministic algorithms on for this phase only
    rp = TRAIN_REPLAY
    tcfg_r = S.TrainConfig(opt=opt_mod.OptConfig(lr=1e-3, warmup_steps=2))
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(dir=TRAIN_DIR) as tmp:
            model = train_models(torch, T, cfg2, init)["none"]
            state = opt_mod.init(tcfg_r.opt, S.trainable(model))
            t0 = time.perf_counter()
            sup = Supervisor(S.make_train_step(cfg2, tcfg_r), ds2, tmp,
                             ckpt_every=rp["ckpt_every"],
                             injector=FailureInjector(at_steps=rp["fail_at"]))
            model, state, rep = sup.run(model, state, rp["steps"])
            torch.cuda.synchronize()
            sup_s = time.perf_counter() - t0
        ref = train_models(torch, T, cfg2, init)["none"]
        ref_state = opt_mod.init(tcfg_r.opt, S.trainable(ref))
        ref_step = S.make_train_step(cfg2, tcfg_r)
        for s in range(rp["steps"]):
            ref, ref_state, _ = ref_step(ref, ref_state, ds2.global_batch(s))
    finally:
        torch.use_deterministic_algorithms(False)
    r_ok, r_worst, _ = params_held(torch, model, ref, *REPLAY_TOL)
    identical = all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                      ref.parameters()))
    out["replay"] = {"steps": rep.steps_done, "restarts": rep.restarts,
                     "steps_replayed": rep.steps_replayed,
                     "fail_at": list(rp["fail_at"]),
                     "ckpt_every": rp["ckpt_every"], "supervised_s": sup_s,
                     "param_max_abs_diff": r_worst,
                     "bit_identical": identical}
    phase("train replay", json.dumps(out["replay"]))
    check("(c) supervisor replay", r_ok and rep.restarts == 2
          and rep.steps_done == rp["steps"],
          f"2 restarts, parameters within rtol {REPLAY_TOL[0]} / atol "
          f"{REPLAY_TOL[1]} of the uninterrupted run")
    del model, ref, state, ref_state, init
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the slice at full width and depth
    sl = TRAIN_SLICE
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              attn_impl="chunked")
    tcfg = S.TrainConfig(opt=opt_mod.OptConfig(
        lr=sl["lr"], warmup_steps=2, total_steps=sl["steps"]))
    t0 = time.perf_counter()
    model, state = S.init_train_state(cfg, tcfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = SyntheticLM(DataConfig(seq_len=sl["seq"], global_batch=sl["batch"],
                                vocab=cfg.vocab))
    tokens = sl["batch"] * sl["seq"]
    # the peak each remat mode needs for one step's gradients at this size
    peaks = {}
    big_batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in ds.global_batch(0).items()}
    for mode in ("none", "full", "dots"):
        m = model if mode == "none" else train_models(
            torch, T, cfg, model.state_dict(), (mode,))[mode]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, _, grads = S.value_and_grad(S.make_loss_fn(m.cfg, 0.01), m,
                                       big_batch)
        torch.cuda.synchronize()
        peaks[mode] = {"peak_bytes_over_resident":
                       torch.cuda.max_memory_allocated() - before}
        del grads, m
    gc.collect()
    torch.cuda.empty_cache()
    phase("train remat", json.dumps({"n_layers": cfg.n_layers,
                                     "batch": [sl["batch"], sl["seq"]],
                                     "dtype": str(cfg.dtype), **peaks}))
    out["remat_full_depth"] = peaks

    step_fn = S.make_train_step(cfg, tcfg)
    events = []

    def timed(model, state, batch):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = step_fn(model, state, batch)
        e1.record()
        events.append((e0, e1))
        return res

    # every kernel's count set to 0 just before the run, read just after
    counters = (fa.LAUNCHES, la.LAUNCHES, bm.LAUNCHES, ct.LAUNCHES)
    for c in counters:
        c.clear()
    ls.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the slice's checkpoints stay for the [parallel] phase
    shutil.rmtree(SLICE_CKPT, ignore_errors=True)
    SLICE_CKPT.mkdir(parents=True)
    free_gb = shutil.disk_usage(SLICE_CKPT).free / 1e9
    t0 = time.perf_counter()
    sup = Supervisor(timed, ds, str(SLICE_CKPT), ckpt_every=sl["ckpt_every"],
                     keep=2, async_ckpt=True,
                     injector=FailureInjector(at_steps=(sl["fail_at"],)))
    model, state, rep = sup.run(model, state, sl["steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kept = sorted(d.name for d in SLICE_CKPT.iterdir())
    peak = torch.cuda.max_memory_allocated()
    launched = {**fa.LAUNCHES, **la.LAUNCHES, **bm.LAUNCHES, **ct.LAUNCHES,
                "step_fused": ls.LAUNCHES}
    step_ms = [a.elapsed_time(b) for a, b in events]
    steady = sorted(step_ms[1:])
    med = steady[len(steady) // 2]
    first5, last5 = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])

    # three more steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(sl["profile_steps"]):
            model, state, _ = step_fn(model, state,
                                      ds.global_batch(sl["steps"] + s))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if "cuda" in str(e.device_type).lower()]
    device_s = sum(e.self_device_time_total for e in dev) * 1e-6
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    out["slice"] = {
        "params": model.param_count(), "dtype": str(cfg.dtype),
        "moment_dtype": str(tcfg.opt.moment_dtype),
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
        "batch": [sl["batch"], sl["seq"]], "init_s": init_s,
        "steps_done": rep.steps_done, "steps_run": len(step_ms),
        "restarts": rep.restarts, "steps_replayed": rep.steps_replayed,
        "ckpt_every": sl["ckpt_every"], "fail_at": sl["fail_at"],
        "checkpoints_kept": kept, "disk_free_gb": free_gb,
        "wall_s": wall, "wall_tok_per_s": len(step_ms) * tokens / wall,
        "step_ms_median": med, "step_ms_first": step_ms[0],
        "step_ms_min": steady[0], "step_ms_max": steady[-1],
        "tok_per_s": tokens / (med * 1e-3),
        "peak_bytes": peak, "loss_first5": float(first5),
        "loss_last5": float(last5), "losses": rep.losses,
        "kernel_launches": launched,
        "profile": {"steps": sl["profile_steps"], "wall_s": prof_wall,
                    "device_s": device_s,
                    "device_busy_share": device_s / prof_wall,
                    "kernels": sum(e.count for e in dev),
                    "top_device_kernels": [[e.key[:80], e.count,
                                            e.self_device_time_total * 1e-6]
                                           for e in top]}}
    phase("train slice", json.dumps(out["slice"]))
    check("(d) slice", last5 < first5, f"mean of the last 5 losses "
          f"{last5:.4f} below the first 5's {first5:.4f}")
    check("(d) slice", rep.restarts == 1 and rep.steps_done == sl["steps"]
          and all(np.isfinite(rep.losses)),
          "one restart, every step done, finite losses")
    check("(d) slice", not any(launched.values()),
          f"no kernel launched by the train step: {launched}")
    phase("train", json.dumps({"kernels": []}))
    del model, state
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the wrappers refuse operands that require grad, and launch
    # nothing
    gen = torch.Generator("cuda").manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=gen,
                           dtype=torch.bfloat16).requires_grad_(True)
    calls = {"flash_attention": lambda: ops.attention(
                 rnd(16, 512, 128), rnd(8, 512, 128), rnd(8, 512, 128)),
             "linear_attn": lambda: ops.linear_attn(
                 rnd(32, 512, 64), rnd(32, 512, 64), rnd(32, 512, 64),
                 torch.rand((32, 512, 64), device="cuda", generator=gen,
                            requires_grad=True), rnd(32, 64), chunk=64)}
    guard = {}
    wrappers = {"flash_attention": fa, "linear_attn": la}
    for name, call in calls.items():
        before = sum(wrappers[name].LAUNCHES.values())
        try:
            call()
            raised = False
        except NotImplementedError:
            raised = True
        torch.cuda.synchronize()
        after = sum(wrappers[name].LAUNCHES.values())
        guard[name] = {"raised": raised, "launches": after - before}
        check(f"(e) {name} guard", raised and after == before,
              "raises NotImplementedError on operands that require grad, "
              "no launch")
    out["guard"] = guard
    out["seconds"] = time.perf_counter() - t_phase
    phase("train seconds", f"{out['seconds']:.1f} s")
    return out


def parallel_flow(torch, np, configs, T, failures, ckpt_dir=SLICE_CKPT):
    """``[parallel]``: the distribution layer on the card (a world of one
    over NCCL, a (1, 1) mesh).  The [train] slice's last checkpoint
    (``ckpt_dir``) restored with ``restore(shardings=param_shardings(...))``
    as DTensors and again as plain tensors; one qwen3-0.6b AdamW step each
    way at full width and depth, held to each other; ms a step and peak
    memory each way; ``make_overlapped_matmul`` against ``torch.matmul``.
    Every check that fails is added to ``failures``.  Returns the
    summary."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as S
    from repro_torch.train.data import DataConfig, SyntheticLM

    t_phase = time.perf_counter()
    out = {"arch": TRAIN_ARCH}

    def check(label, ok, detail):
        phase("parallel check", f"{label}: {detail}: {ok}")
        if not ok:
            failures.append(f"parallel {label}: {detail}")

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.mesh_variant(1, 1, device_type="cuda")
        sl = TRAIN_SLICE
        cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                                  attn_impl="chunked")
        plan = sh.plan_for(cfg)
        tcfg = S.TrainConfig(opt=opt_mod.OptConfig(
            lr=sl["lr"], warmup_steps=2, total_steps=sl["steps"]))
        step_n = ckpt.latest_step(ckpt_dir)
        meta = T.Transformer(cfg, device="meta")
        like = {"params": meta,
                "opt": opt_mod.init(tcfg.opt, dict(meta.named_parameters()))}
        shardings = {"params": sh.param_shardings(cfg, mesh, plan, meta),
                     "opt": sh.opt_shardings(cfg, mesh, plan, like["opt"])}
        t0 = time.perf_counter()
        laid = ckpt.restore(ckpt_dir, step_n, like, shardings=shardings)
        restore_s = time.perf_counter() - t0
        plain = ckpt.restore(ckpt_dir, step_n, like, device="cuda")
        models = {}
        for way, tree in (("dtensor", laid), ("plain", plain)):
            model = T.Transformer(cfg, device="meta")
            sh.set_parameters(model, tree["params"])
            opt = tree["opt"]
            if way == "dtensor":        # the step counter stays a scalar
                opt = opt._replace(step=opt.step.to_local())
            models[way] = [model, opt]
        placed = all(
            p.placements == shardings["params"][n].placements
            for n, p in models["dtensor"][0].named_parameters())
        ds = SyntheticLM(DataConfig(seq_len=sl["seq"], global_batch=sl["batch"],
                                    vocab=cfg.vocab))
        step_fn = S.make_train_step(cfg, tcfg)

        def batch_for(way, n):
            b = {k: torch.as_tensor(v, device="cuda")
                 for k, v in ds.global_batch(n).items()}
            if way == "dtensor":
                bsh = sh.batch_shardings(cfg, mesh, b)
                b = {k: bsh[k].distribute(v) for k, v in b.items()}
            return b

        def run(way, n):
            model, opt = models[way]
            batch = batch_for(way, n)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with implicit_replication():
                e0.record()
                model, opt, m = step_fn(model, opt, batch)
                e1.record()
            torch.cuda.synchronize()
            models[way] = [model, opt]
            loss = m["loss"]
            loss = loss.full_tensor() if hasattr(loss, "full_tensor") \
                else loss
            return float(loss), e0.elapsed_time(e1)

        first = {}
        for way in ("dtensor", "plain"):
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            loss, ms = run(way, step_n)
            first[way] = {"loss": loss, "first_step_ms": ms,
                          "resident_bytes": before,
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        loss_rel = abs(first["dtensor"]["loss"] - first["plain"]["loss"]) \
            / abs(first["plain"]["loss"])
        pd = dict(models["plain"][0].named_parameters())
        ok, worst, where = True, 0.0, ""
        for n, p in models["dtensor"][0].named_parameters():
            local = p.to_local()
            ok &= held(torch, local, pd[n], *PARALLEL_TOL["params"])
            d = float((local.detach().float()
                       - pd[n].detach().float()).abs().max())
            if d > worst:
                worst, where = d, n
        check("(a) restore(shardings=)", placed, "every parameter a DTensor "
              "in its param_shardings placements")
        check("(a) step", loss_rel <= PARALLEL_TOL["loss"],
              f"DTensor loss {first['dtensor']['loss']:.6f} vs plain "
              f"{first['plain']['loss']:.6f}: within rtol "
              f"{PARALLEL_TOL['loss']}")
        check("(a) step", ok, f"updated parameters within rtol "
              f"{PARALLEL_TOL['params'][0]} / atol "
              f"{PARALLEL_TOL['params'][1]} (worst {worst:.3g} at {where})")
        times = {"dtensor": [], "plain": []}
        for i in range(PARALLEL["timed_steps"]):
            for way in ("dtensor", "plain"):
                times[way].append(run(way, step_n + 1 + i)[1])
        tokens = sl["batch"] * sl["seq"]
        out["step"] = {
            "checkpoint_step": step_n, "restore_shardings_s": restore_s,
            "n_layers": cfg.n_layers, "batch": [sl["batch"], sl["seq"]],
            "dtype": str(cfg.dtype), "loss_rel_diff": loss_rel,
            "param_max_abs_diff": worst, "param_worst": where,
            **{f"{way}_{k}": v for way, d in first.items()
               for k, v in d.items()},
            **{f"{way}_step_ms": sorted(t)[len(t) // 2]
               for way, t in times.items()},
            **{f"{way}_tok_per_s": tokens / (sorted(t)[len(t) // 2] * 1e-3)
               for way, t in times.items()},
            "step_ms_by_turn": times}
        phase("parallel step", json.dumps(out["step"]))
        del models, laid, plain
        gc.collect()
        torch.cuda.empty_cache()

        # make_overlapped_matmul at qwen3-0.6b's MLP width
        m_, k_, n_ = OVERLAP_SHAPE
        gen = torch.Generator("cuda").manual_seed(7)
        x = torch.randn((m_, k_), device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        w = torch.randn((k_, n_), device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        wd = sh.NamedSharding(mesh, ("data", None)).distribute(w)
        f = coll.make_overlapped_matmul(mesh, "data")
        got = f(x, wd).to_local()
        want = torch.matmul(x, w)
        err = float((got.float() - want.float()).abs().max())
        rtol = MATMUL_RTOL["bfloat16"]
        check("(b) make_overlapped_matmul", held(torch, got, want, rtol,
                                                 rtol),
              f"x {tuple(x.shape)} @ w {tuple(w.shape)} bf16 against "
              f"torch.matmul within {rtol} (max abs err {err:.3g})")
        out["overlap"] = {"shape": list(OVERLAP_SHAPE), "max_abs_err": err,
                          "ms": time_ms(lambda: f(x, wd), 20),
                          "matmul_ms": time_ms(lambda: torch.matmul(x, w),
                                               20)}
        phase("parallel overlap", json.dumps(out["overlap"]))
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    phase("parallel seconds", f"{out['seconds']:.1f} s")
    return out


def pipeline_flow(torch, np, configs, T, fa, failures):
    """``[pipeline]``: qwen3-0.6b (full width and depth, bf16, the default
    "kernel" route) prefilled whole and then staged (``staged_prefill``:
    ``stage_slices`` into 2 stages, 4 microbatches): the staged logits
    against the whole at ``ROUTE_ATOL``, the flash launches of each run by
    shape from the wrapper's counters (one a layer a microbatch), and
    ``evaluate_pp`` for gpipe and 1f1b at the stage cost measured here.
    Returns the summary (its launches feed the kernels line)."""
    from repro_torch.parallel import pipeline as pp
    from repro_torch.roofline import H100

    t_phase = time.perf_counter()
    pl = PIPELINE
    model, init_s = build_model(torch, configs, T, {"arch": TRAIN_ARCH})
    cfg = model.cfg
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (pl["prompts"], pl["seq"]), dtype=np.int32),
        device="cuda")}
    clear, read = kernel_counters(torch, {"flash_attention": fa},
                                  ("flash_attention",))
    runs = {}
    with torch.no_grad():
        for name, fn in (("whole", lambda: T.prefill(model, batch,
                                                       pl["seq"])),
                         ("staged", lambda: pp.staged_prefill(
                             model, batch, pl["seq"], pl["stages"],
                             pl["micro"]))):
            fn()                         # warm (builds, first launches)
            torch.cuda.synchronize()
            clear()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            logits, _ = fn()
            e1.record()
            torch.cuda.synchronize()
            launches, shapes, variants = read()
            runs[name] = {"logits": logits, "ms": e0.elapsed_time(e1),
                          "launches": launches["flash_attention"],
                          "shapes": shapes["flash_attention"],
                          "variants": variants["flash_attention"]}
    diff = float((runs["staged"]["logits"].float()
                  - runs["whole"]["logits"].float()).abs().max())
    atol = ROUTE_ATOL["bfloat16"]
    out = {"arch": cfg.name, "stages": pl["stages"], "micro": pl["micro"],
           "prompts": pl["prompts"], "seq": pl["seq"], "init_s": init_s,
           "bounds": pp.stage_bounds(cfg.n_periods, pl["stages"]),
           "logits_max_abs_diff": diff,
           **{f"{n}_{k}": r[k] for n, r in runs.items()
              for k in ("ms", "launches", "variants")},
           "shapes": {n: {str(k): v for k, v in r["shapes"].items()}
                      for n, r in runs.items()}}
    checks = {
        "logits": diff <= atol,
        "whole launches": runs["whole"]["launches"] == cfg.n_layers
        and len(runs["whole"]["shapes"]) == 1,
        "staged launches": runs["staged"]["launches"]
        == pl["micro"] * cfg.n_layers and len(runs["staged"]["shapes"]) == 1,
        "microbatch shape": all(
            k[0] * pl["micro"] == j[0] for k in runs["staged"]["shapes"]
            for j in runs["whole"]["shapes"])}
    for label, ok in checks.items():
        phase("pipeline check", f"{label}: {ok}")
        if not ok:
            failures.append(f"pipeline {label}: {json.dumps(out)}")
    # the stage cost: the staged run's device time over its units of one
    # stage and one microbatch (equal stages); a backward of 2x the
    # forward; the p2p send of one microbatch's activations computed at
    # the H100 record's NVLink rate (not measured)
    units = pl["stages"] * pl["micro"]
    fwd = runs["staged"]["ms"] * 1e-3 / units
    rows = pl["prompts"] // pl["micro"]
    p2p = rows * pl["seq"] * cfg.d_model * 2 / H100.link_bw
    out["evaluate_pp"] = {
        sched: dataclasses.asdict(pp.evaluate_pp(pp.PPConfig(
            pl["stages"], pl["micro"], fwd, 2 * fwd, p2p, sched)))
        for sched in ("gpipe", "1f1b")}
    out["stage_fwd_s"], out["p2p_s_computed"] = fwd, p2p
    phase("pipeline", json.dumps(out))
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    phase("pipeline seconds", f"{out['seconds']:.1f} s")
    return out


def dryrun_cells():
    """The [dryrun] cells as specs for ``DRYRUN_CELL``: (a) the [train]
    slice's shape on a (1, 1) mesh, (b) ``DRYRUN_CELLS`` at 16 x 16, (c)
    ``DRYRUN_VARIANT``."""
    sl = TRAIN_SLICE
    base = {"artifacts": str(DRYRUN_DIR / "dryrun"), "device": "cuda",
            "names": ["data", "model"]}
    cells = [dict(base, label="(a)", arch=TRAIN_ARCH, shape_name="train_4k",
                  sizes=[1, 1], save=False,
                  shape={"name": "train_4k", "seq_len": sl["seq"],
                         "global_batch": sl["batch"], "kind": "train"})]
    cells += [dict(base, label="(b)", arch=a, shape_name=s, sizes=[16, 16],
                   save=True, shape=None) for a, s in DRYRUN_CELLS]
    a, s, sizes = DRYRUN_VARIANT
    cells.append(dict(base, label="(c)", arch=a, shape_name=s,
                      sizes=list(sizes), save=True, shape=None))
    return cells


def dryrun_flow(torch, train_summary, failures):
    """``[dryrun]``: the port's dry-run on the card's machine, every cell
    in an interpreter of its own, all started together.  (a) qwen3-0.6b's
    train step at the [train] slice's shape on a fake (1, 1) mesh: its
    predicted peak against the slice's measured one (gated within
    ``DRYRUN_PEAK_FACTOR``), its FLOPs at the bf16 peak against the
    measured ms a step; (b) the published cells at 16 x 16, each timed,
    and ``roofline_table(analyze_all(...))`` over them with ``hw=H100``;
    (c) one cell at ``mesh_variant(32, 8)``.  Gates: every cell yields a
    record, every FSDP record has a nonzero all-gather."""
    from repro_torch.roofline import model as rmodel

    t_phase = time.perf_counter()
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for spec in dryrun_cells():
        procs.append((spec, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CELL, str(ROOT / "src"),
             json.dumps(spec)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)))
    records = []
    for spec, t0, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        wall = time.perf_counter() - t0
        logs = ROOT / "chiprun_out" / "dryrun"
        logs.mkdir(parents=True, exist_ok=True)
        (logs / f"{spec['arch']}__{spec['shape_name']}__"
                f"{'x'.join(map(str, spec['sizes']))}.log").write_text(
            stdout + stderr)
        rec = next((json.loads(line[len("RECORD "):])
                    for line in stdout.splitlines()
                    if line.startswith("RECORD ")), None)
        label = f"{spec['label']} {spec['arch']} {spec['shape_name']} " \
            f"{'x'.join(map(str, spec['sizes']))}"
        if proc.returncode != 0 or rec is None:
            failures.append(f"dryrun {label}: rc {proc.returncode}: "
                            f"{stderr[-1500:]}")
            phase("dryrun cell", f"{label}: FAILED rc {proc.returncode}")
            continue
        c = rec["collectives"]
        row = {"cell": spec["label"], "arch": rec["arch"],
               "shape": rec["shape"], "mesh": rec["mesh"],
               "wall_s": wall, "lower_s": rec["lower_s"],
               "fsdp": rec["plan"]["fsdp"], "remat": rec["plan"]["remat"],
               "flops_per_device": rec["cost_analysis"]["flops"],
               "bytes_per_device": rec["cost_analysis"]["bytes accessed"],
               "per_op_bytes": c["per_op_bytes"],
               "wire_bytes": c["wire_bytes"],
               "peak_memory_in_bytes": rec["memory"][
                   "peak_memory_in_bytes"],
               "explicit_redistributes": len(rec["explicit_redistributes"]),
               "explicit_redistribute_bytes": sum(
                   d["operand_bytes"] for d in rec["explicit_redistributes"]),
               "predicted_with": "TorchCostModel counts; roofline at "
               "roofline.H100"}
        phase("dryrun cell", json.dumps(row))
        records.append((spec, rec, row))
        if rec["plan"]["fsdp"] and not c["per_op_bytes"]["all-gather"] > 0:
            failures.append(f"dryrun {label}: FSDP record without an "
                            f"all-gather")
    out = {"cells": [row for _, _, row in records]}
    a = next((rec for spec, rec, _ in records if spec["label"] == "(a)"),
             None)
    measured = train_summary["slice"]["peak_bytes"] if train_summary \
        else None
    if a is not None and measured:
        pred = a["memory"]["peak_memory_in_bytes"]
        ratio = pred / measured
        step_ms = train_summary["slice"]["step_ms_median"]
        out["a"] = {"predicted_peak_bytes": pred,
                    "measured_peak_bytes": measured,
                    "predicted_over_measured": ratio,
                    "flops_per_step": a["cost_analysis"]["flops"],
                    "flops_at_bf16_peak_ms": a["cost_analysis"]["flops"]
                    / PEAK_FLOPS["bfloat16"] * 1e3,
                    "measured_step_ms": step_ms}
        phase("dryrun (a)", json.dumps(out["a"]))
        ok = 1 / DRYRUN_PEAK_FACTOR <= ratio <= DRYRUN_PEAK_FACTOR
        phase("dryrun check", f"(a) predicted peak within "
              f"{DRYRUN_PEAK_FACTOR}x of the measured: {ok}")
        if not ok:
            failures.append(f"dryrun (a): predicted peak {pred} vs measured "
                            f"{measured}")
    elif train_summary:
        failures.append("dryrun (a): no record")
    ok = len(records) == len(procs)
    phase("dryrun check", f"every cell yields a record: {ok}")
    rmodel.ARTIFACTS = DRYRUN_DIR
    cells = rmodel.analyze_all(mesh_filter="data=16×model=16",
                               hw=rmodel.H100)
    out["roofline"] = [c.row() for c in cells]
    for line in rmodel.roofline_table(cells).splitlines():
        phase("dryrun roofline", line)
    out["seconds"] = time.perf_counter() - t_phase
    phase("dryrun seconds", f"{out['seconds']:.1f} s")
    return out


def main() -> int:
    t_smoke = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    PHASE_LOG.unlink(missing_ok=True)
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch.apps import cholesky as ch
    from repro_torch.apps import matmul as mm
    from repro_torch.apps import traditional as tr
    from repro_torch.core import Explorer, a9_smp_seconds, torchsim
    from repro_torch.core import zynq_system
    from repro_torch.core.augment import Eligibility
    from repro_torch.core.explore import Candidate
    from repro_torch.core.replay import TORCH_RTOL, rankings_equivalent
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import build
    from repro_torch.kernels import cholesky_tiles as ct
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_attn as la
    from repro_torch.kernels import lockstep_step as ls
    from repro_torch.kernels import ops, ref
    from repro_torch.core import hlsreport, steptask
    from repro_torch import roofline
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine

    # 1. the card; the plain versions' f32 products in full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    power_line = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase("card", f"{power_line} | torch: {kind} x{count} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # 2. the kernel builds, one nvcc per library, all started together
    builds = ((ls.SOURCE, None, ls.bind), (bm.SOURCE, None, bm.bind),
              (bm.SOURCE, {"TILE": 128}, bm.bind),
              (fa.SOURCE, None, fa.bind_fma),
              (fa.SOURCE_WGMMA, None, fa.bind_wgmma),
              (la.SOURCE, None, la.bind_serial),
              (la.SOURCE_TC, None, la.bind_subchunk))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        built = [f.result() for f in [
            pool.submit(build.load, src, defines, bind=bind)
            for src, defines, bind in builds]]
    wall = time.perf_counter() - t0
    phase("kernel store", f"{build.BUILD_DIR}: {build.BUILDS} nvcc builds, "
          f"{build.REBUILDS} rebuilt, keyed by {build.environment()}")
    for src, defines, _ in builds:
        info = build.BUILD_INFO[build.label(src, defines)]
        ptxas = "; ".join(info["ptxas"].splitlines()) or "(no ptxas report)"
        phase("build", f"{build.label(src, defines)} for sm_90a: nvcc "
              f"{info['seconds']:.2f} s (all builds {wall:.2f} s of wall): "
              f"{ptxas}")
    lib128 = bm.tiles_library(built[2])
    wg_info = build.BUILD_INFO[build.label(fa.SOURCE_WGMMA, None)]
    phase("flash wgmma build", f"{fa.SOURCE_WGMMA}: nvcc "
          f"{wg_info['seconds']:.2f} s; {ptxas_summary(wg_info['ptxas'])}")
    if lib128.tiles_tile_edge() != 128 or \
            bm.tiles_library().tiles_tile_edge() != 64:
        raise SystemExit("tiles.cu builds have the wrong TILE")

    # 3. the standalone step_commit vs plain version on the card
    worst_err = kernel_check(ls, torch, np, KERNEL_SHAPES, "kernel==plain", 0)

    # 4. the tile kernels vs plain versions at every path shape
    cases = tile_cases(torch, np, ref, bm, ct, lib128)
    tile_errs = check_tiles(torch, cases)
    fcases = flash_cases(torch, np, fa, ops)
    flash_errs = check_flash(torch, fa, ref, fcases)
    route_errs = check_routes(torch, np, fa, ref)
    lcases = linear_cases(torch, np, la, ops)
    linear_errs = check_linear(torch, la, ref, lcases)

    # 5. the sweeps: torch on the card, then batch on the host
    sweeps = []
    mm_tr = mm.trace_matmul(n=512, bs=64)
    mm_rep = mm.report_map()
    mm_a9 = a9_smp_seconds("float32")
    mm_cands = matmul_ramp(mm, zynq_system, Eligibility, 64, 200)
    ch_tr = ch.trace_cholesky(n=512, bs=64)
    ch_rep = ch.report_map(bs=64)
    ch_a9 = a9_smp_seconds("float64")
    ch_cands = cholesky_ramp(ch, zynq_system, Candidate, 8)
    libs = {}
    path_shapes = Counter()     # (P, S, B) of the sweeps' step launches
    default_cache = torchsim._DEFAULT_CACHE
    # the first slice of each step shape, for the fused step's checks (7)
    slices = {}
    stop_recording = record_slices(torch, torchsim, slices)

    def sweep(label, trace, reports, a9, cands, *, top_k, prune=False,
              warm_from=None):
        """One sweep on both engines; ``warm_from`` names an earlier sweep
        whose recorded orders this one starts from (fresh Explorers, so no
        simulation cache hit short-cuts the engines)."""
        res = {}
        for engine in ("torch", "batch"):
            lib = libs.get((warm_from, engine)) if warm_from else None
            ex = Explorer(trace, reports, engine=engine, smp_seconds_fn=a9,
                          order_library=lib)
            ls.LAUNCHES = 0
            ls.SHAPES.clear()
            before = default_cache.as_dict()
            t = time.perf_counter()
            r = ex.explore(cands, top_k=top_k, prune=prune)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            libs[(label, engine)] = ex.order_library
            res[engine] = (ex, r, wall, ls.LAUNCHES)
            if engine == "torch":
                path_shapes.update(ls.SHAPES)
                after = default_cache.as_dict()
                graphs = {k: after[k] - before[k]
                          for k in ("captures", "capture_s", "replays")}
        (ex_t, r_t, w_t, launches), (ex_b, r_b, w_b, host_launches) = \
            res["torch"], res["batch"]
        got = [o.name for o in r_t.ranked]
        want = [o.name for o in r_b.ranked]
        spans = {o.name: o.makespan_s for o in r_b.ranked}
        bst = ex_t.batch_stats.as_dict()
        ok_out = [o for o in r_t.outcomes if o.status == "ok"]
        checks = {
            "ok_rankings_equivalent": rankings_equivalent(got, want, spans,
                                                          TORCH_RTOL),
            "ok_same_best": r_t.best_name == r_b.best_name,
            "ok_no_demotion": ex_t.stats.engine_demotions == 0
            and ex_t.engine == "torch",
            "ok_launches": launches > 0 and host_launches == 0,
            "ok_lockstep_lanes": bst["lockstep_lanes"] > 0,
            "ok_outcomes": len(r_t.outcomes) == len(cands)
            and all(np.isfinite(o.makespan_s) and o.makespan_s > 0
                    for o in ok_out),
        }
        row = {"sweep": label, "trace_tasks": len(trace),
               "candidates": len(cands), "best": r_t.best_name,
               "launches": launches, "torch_s": w_t, "batch_s": w_b,
               "torch_cand_per_s": len(cands) / w_t,
               "batch_cand_per_s": len(cands) / w_b,
               "launches_per_s": launches / w_t,
               "lockstep_lanes": bst["lockstep_lanes"],
               "reference_lanes": bst["reference_lanes"],
               "retired_lanes": bst["retired_lanes"],
               "graph_captures": graphs["captures"],
               "graph_capture_s": graphs["capture_s"],
               "graph_replays": graphs["replays"],
               "demotions": ex_t.stats.engine_demotions, **checks}
        phase("sweep", json.dumps(row))
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise SystemExit(f"sweep {label}: failed {bad}")
        sweeps.append(row)

    sweep("matmul512_200_cold", mm_tr, mm_rep, mm_a9, mm_cands, top_k=5)
    sweep("matmul512_200_warm", mm_tr, mm_rep, mm_a9, mm_cands, top_k=5,
          warm_from="matmul512_200_cold")
    sweep("cholesky512_48_cold", ch_tr, ch_rep, ch_a9, ch_cands, top_k=3)
    sweep("matmul512_200_top5_prune", mm_tr, mm_rep, mm_a9, mm_cands,
          top_k=5, prune=True)

    # 5b. the step loop's captured graphs against the eager loop, slice by
    # slice and bit for bit, on a compile cache with a disk tier; then a
    # second process on that store builds nothing
    failures = []
    shutil.rmtree(GRAPH_DIR, ignore_errors=True)
    graph_rows = [
        graph_sweep(torch, Explorer, ls, "matmul512_200_warm", mm_tr,
                    mm_rep, mm_a9, mm_cands, 5,
                    libs[("matmul512_200_cold", "torch")], failures)[0],
        graph_sweep(torch, Explorer, ls, "cholesky512_48_cold", ch_tr,
                    ch_rep, ch_a9, ch_cands, 3, None, failures)[0]]
    graph_rows.append(second_process("cholesky512_48_cold", failures))

    # 6. the sweep service on the card: the matmul trace's 200 candidates
    # in one request (its bs = 64 report: the trace's blocks are 64), then
    # eight concurrent Cholesky clients, the CLI's server drained by
    # SIGTERM, and the Paraver export; its launches count with the sweeps'
    served = sweepd_flow(
        torch, np, ls, "cuda",
        ("sweepd_matmul512_200_torch", mm_tr,
         {key: r for key, r in mm_rep.items() if key[1] == "fpga:mxm64"},
         "1-100"),
        ("sweepd_cholesky512_16_8clients", ch_tr, ch_rep, "1-8"),
        sweeps[0], failures)
    path_shapes.update(served["shapes"])
    stop_recording()

    # 7. the fused step at the shapes the sweeps launched it at: == the
    # plain body through a recorded slice of each, times at each; then the
    # standalone commit (no longer on the path) == its plain version at
    # the same (P, S, B), timed at the commonest and the first check shape
    shapes = [sh for sh, _ in path_shapes.most_common()]
    phase("path shapes", "; ".join(f"P,S,B={sh}: {n} launches"
                                   for sh, n in path_shapes.most_common()))
    fused_rows = fused_path(torch, torchsim, ls, slices, path_shapes)
    slices.clear()
    worst_err = max(worst_err, kernel_check(
        ls, torch, np, shapes, "step_commit==plain at path P,S,B", 2))
    by_shape = []
    for sh in shapes[:1] + [x for x in KERNEL_SHAPES[:1]
                            if x not in shapes[:1]]:
        t = kernel_times(ls, torch, np, sh)
        by_shape.append(t)
        qu = ("not measured (enqueue past half the spin)"
              if t["queued_us"] is None else f"{t['queued_us']:.2f} us")
        rows_us = ("not measured" if t["device_us"] is None
                   else f"{t['device_us']:.2f} us")
        phase("kernel", f"step_commit (standalone) at P,S,B={sh} "
              f"({t['group']} threads a lane): CUDA events (two "
              f"passes in turns) {t['ms'] * 1e3:.2f} us per call through "
              f"the wrapper, {t['kernel_only_ms'] * 1e3:.2f} us per bare "
              f"launch; device time of one bare launch behind a spin {qu} "
              f"(enqueue of 20 {t['queued_enqueue_us']:.0f} of "
              f"{t['queued_spin_us']:.0f} us), by torch.profiler {rows_us}; "
              f"plain version {t['plain_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bytes']} B at 3.35 TB/s)")
    top = by_shape[0]
    ftop = fused_rows[0] if fused_rows else {}
    fused_kern = {
        "name": "step_fused", "route": "cuda",
        "kernel": "step_commit_fused_kernel",
        "source": "src/repro_torch/kernels/csrc/lockstep_step.cu",
        "replaces": "src/repro/core/jaxsim.py:272 (the scan's step)",
        "launches": sum(s["launches"] for s in sweeps)
        + sum(served["launches"].values()),
        "bit_identical": all(r["bit_identical"] for r in fused_rows),
        **{k: ftop.get(k) for k in (
            "ms", "plain_ms", "bound_ms", "kernel_only_ms", "device_us",
            "queued_us", "queued_enqueue_us", "queued_spin_us", "bytes")},
        "bound_by": "bytes", "library_ms": None,
        "timed_shape": ftop.get("shape"),
        "graph_step_device_time": {row["sweep"]: row["step_graphs"]
                                   for row in graph_rows[:2]},
        "launches_by_sweep": {**{s["sweep"]: s["launches"]
                                 for s in sweeps}, **served["launches"]},
        "by_shape": fused_rows,
    }
    kern = {
        "name": "step_commit", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lockstep_step.cu",
        "replaces": "src/repro/kernels/lockstep_step.py:67",
        # the path commits inside the fused step; this kernel is checked
        # and timed on its own
        "launches": 0,
        "max_abs_err": worst_err,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "kernel_only_ms": top["kernel_only_ms"],
        "device_us": top["device_us"], "queued_us": top["queued_us"],
        "queued_enqueue_us": top["queued_enqueue_us"],
        "queued_spin_us": top["queued_spin_us"], "group": top["group"],
        "timed_shape": top["shape"],
        "by_shape": by_shape,
    }

    # 8. where a warm sweep's time goes on the card
    prof = profile_sweep(torch, Explorer, ch_tr, ch_rep, ch_a9, ch_cands,
                         libs[("cholesky512_48_cold", "torch")], ls)
    phase("profile", json.dumps({"sweep": "cholesky512_48_warm", **prof}))
    phase("throughput", "; ".join(
        f"{s['sweep']}: torch {s['torch_cand_per_s']:.1f} cand/s "
        f"({s['launches_per_s']:.0f} steps/s), batch "
        f"{s['batch_cand_per_s']:.1f} cand/s" for s in sweeps))

    # 9. Fig. 6: the estimator against build-and-run, fresh builds
    fig6 = fig6_flow(torch, np, mm, Explorer, a9_smp_seconds, tr, bm, ls)
    phase("fig6 summary", json.dumps(fig6))

    # 10. the Fig. 4 Cholesky through the tiles
    chol = cholesky_flow(torch, np, tr, bm, ct)

    # 11. the tile kernels' times at the path shapes
    rows = time_tiles(torch, cases, tile_errs)

    # 12. the LM serve path at full width, qwen3-0.6b, rwkv6-1.6b,
    # zamba2-1.2b, mixtral-8x22b at 4 of its 56 layers, pixtral-12b (text
    # only through Engine.run, then with its patches) and whisper-tiny
    # (with its frames), each model freed before the next is built; each
    # kernel's counts of each served run
    wrappers = {"flash_attention": fa, "linear_attn": la}

    def served(spec):
        """``(Engine.run's summary or None, the fused run's or None)``."""
        t0 = time.perf_counter()
        model, init_s = build_model(torch, configs, T, spec)
        out = [None, None]
        if spec.get("engine_run", True):
            out[0] = serve_flow(torch, np, T, engine, wrappers, model, init_s,
                                spec, failures)
        if "fused" in spec:
            out[1] = fused_flow(torch, np, T, engine, wrappers, model,
                                init_s, spec, failures)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        for summary in out:
            if summary is not None:
                summary["n_layers"] = spec.get("n_layers")
        phase("serve seconds", f"{spec['arch']}: "
              f"{time.perf_counter() - t0:.1f} s")
        return out

    ((serve, _), (serve_rwkv, _), (serve_zamba, _), (serve_mixtral, _),
     (serve_pixtral, serve_pixtral_fused), (_, serve_whisper)) = [
        served(spec) for spec in SERVE_MODELS]
    flash_served = {"qwen3-0.6b": serve, "zamba2-1.2b": serve_zamba,
                    "mixtral-8x22b": serve_mixtral,
                    "pixtral-12b": serve_pixtral,
                    "pixtral-12b+patches": serve_pixtral_fused,
                    "whisper-tiny+frames": serve_whisper}

    # 12b. the cost model against this call's measured device times, and
    # the step estimator's prediction of mixtral's prefill
    costs = cost_model_flow(torch, configs, T, hlsreport,
                            {"qwen3-0.6b": serve,
                             "mixtral-8x22b": serve_mixtral})
    phase("cost model seconds", f"{costs['seconds']:.1f} s")
    estimate = step_estimate_flow(
        steptask, roofline, "mixtral-8x22b",
        serve_mixtral["profile"]["prefill_512"]["device_s"],
        configs.get_config("mixtral-8x22b").n_layers)
    phase("step estimate seconds", f"{estimate['seconds']:.1f} s")

    # 12c. the train step on qwen3-0.6b at full width: card against CPU,
    # remat and accumulation, the supervisor's replay, then the slice at
    # full depth through the supervisor; it launches no kernel
    trained = train_flow(torch, np, configs, T, failures)

    # 12d. the distribution layer: the slice's checkpoint restored as
    # DTensors on a (1, 1) mesh over NCCL, a step each way; the staged
    # prefill through the flash kernel; the dry-run's cells
    parallel_flow(torch, np, configs, T, failures)
    piped = pipeline_flow(torch, np, configs, T, fa, failures)
    dryrun_flow(torch, trained, failures)

    # 13. the flash and linear-attention kernels' times at the path shapes
    frow = time_flash(torch, F, fa, ref, fcases[0])
    frows = {label: time_flash(torch, F, fa, ref, next(
        c for c in fcases if c["label"] == label))
        for label in ("zamba2_path", "mixtral_path", "pixtral_path",
                      "pixtral_fused", "whisper_path")}
    flash = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "fma_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": sum(run["launches"]["flash_attention"]
                        for run in flash_served.values())
        + piped["whole_launches"] + piped["staged_launches"],
        "launches_by_path": {
            **{path: run["launches"]["flash_attention"]
               for path, run in flash_served.items()},
            "pipeline whole prefill": piped["whole_launches"],
            "pipeline staged prefill": piped["staged_launches"]},
        "launches_by_kernel": {
            **{path: run["variants"]["flash_attention"]
               for path, run in flash_served.items()},
            "pipeline whole prefill": piped["whole_variants"],
            "pipeline staged prefill": piped["staged_variants"]},
        "max_abs_err": flash_errs["path"],
        "ms": frow["ms"], "plain_ms": frow["plain_ms"],
        "bound_ms": frow["bound_ms"], "bound_by": frow["bound_by"],
        "library_ms": frow["library_ms"],
        "kernel_only_ms": frow["kernel_only_ms"],
        "fma_kernel_only_ms": frow["fma_kernel_only_ms"],
        "device_us": frow["device_us"],
        "queued_us": frow["queued_us"],
        "queued_enqueue_us": frow["queued_enqueue_us"],
        "queued_spin_us": frow["queued_spin_us"],
        "event_ms_by_pass": frow["event_ms_by_pass"],
        "wgmma_build_s": wg_info["seconds"],
        "wgmma_ptxas": ptxas_summary(wg_info["ptxas"]),
        "timed_shape": frow["shape"], "timed_dtype": frow["dtype"],
        "library_call": frow["library_call"],
        "launches_by_shape": {
            **{shape: n for run in flash_served.values()
               for shape, n in run["shapes"]["flash_attention"].items()},
            **{f"pipeline {name} {shape}": n
               for name, shapes in piped["shapes"].items()
               for shape, n in shapes.items()}},
        "max_abs_err_by_case": {**flash_errs, **route_errs},
        "path_shapes": [
            path_row(frow, serve, "flash_attention"),
            *(path_row(frows[label], run, "flash_attention")
              for label, run in (("zamba2_path", serve_zamba),
                                 ("mixtral_path", serve_mixtral),
                                 ("pixtral_path", serve_pixtral),
                                 ("pixtral_fused", serve_pixtral_fused),
                                 ("whisper_path", serve_whisper)))],
    }
    lrow = time_linear(torch, la, ref, lcases[0])
    lrow32 = time_linear(torch, la, ref,
                         next(c for c in lcases if c["label"] == "f32"))
    lrow_z = time_linear(torch, la, ref, next(
        c for c in lcases if c["label"] == "mamba2_path"))
    linear = {
        "name": "linear_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_attn_tc.cu",
        "serial_source": "src/repro_torch/kernels/csrc/linear_attn.cu",
        "replaces": "src/repro/kernels/linear_attn.py:84",
        "launches": serve_rwkv["launches"]["linear_attn"]
        + serve_zamba["launches"]["linear_attn"],
        "launches_by_path": {
            "rwkv6-1.6b": serve_rwkv["launches"]["linear_attn"],
            "zamba2-1.2b": serve_zamba["launches"]["linear_attn"]},
        "launches_by_kernel": {
            "rwkv6-1.6b": serve_rwkv["variants"]["linear_attn"],
            "zamba2-1.2b": serve_zamba["variants"]["linear_attn"]},
        "max_abs_err": linear_errs["path"],
        "ms": lrow["ms"], "plain_ms": lrow["plain_ms"],
        "bound_ms": lrow["bound_ms"], "bound_by": lrow["bound_by"],
        "library_ms": None,
        "kernel_only_ms": lrow["kernel_only_ms"],
        "serial_kernel_only_ms": lrow["serial_kernel_only_ms"],
        "device_us": lrow["device_us"], "queued_us": lrow["queued_us"],
        "queued_enqueue_us": lrow["queued_enqueue_us"],
        "queued_spin_us": lrow["queued_spin_us"],
        "event_ms_by_pass": lrow["event_ms_by_pass"],
        "prefill_device_share": serve_rwkv["profile"]["prefill_512"][
            "kernel_device_share"],
        "timed_shape": lrow["shape"], "timed_dtype": lrow["dtype"],
        "chunk": LINEAR_CHUNK, "library_call": None,
        "launches_by_shape": {**serve_rwkv["shapes"]["linear_attn"],
                              **serve_zamba["shapes"]["linear_attn"]},
        "max_abs_err_by_case": linear_errs,
        "path_shapes": [path_row(lrow, serve_rwkv, "linear_attn"),
                        path_row(lrow_z, serve_zamba, "linear_attn")],
        "f32_timed": {key: lrow32[key] for key in (
            "route", "ms", "kernel_only_ms", "serial_kernel_only_ms",
            "plain_ms", "bound_ms", "bound_by", "device_us", "queued_us",
            "event_ms_by_pass")},
    }

    # 14. the kernels line
    kernels_line = json.dumps({"kernels": [fused_kern, kern]
                               + tile_kernel_rows(rows, fig6, chol)
                               + [flash, linear]})
    print(kernels_line)
    with PHASE_LOG.open("a") as f:
        f.write(kernels_line + "\n")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    phase("smoke seconds", f"{time.perf_counter() - t_smoke:.1f} s")
    print(power_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

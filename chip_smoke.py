#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the run exits
non-zero without its result line):

1. the card: name, count, ``nvidia-smi`` name and power limit, versions, and
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once);
2. each kernel held against its plain version on the same inputs at the
   main paths' shapes (floats at a stated tolerance, integers bit for bit),
   with its time, the plain version's, one PyTorch call's where there is
   one, and the least time the card could take (its bound).  The float
   GEMM is checked at every distinct float GEMM shape of both main paths on
   the route its plan names (wgmma, splitk; tile for the im2col route),
   bit for bit repeatable, and timed on gate / up (beside its route "tile"
   on the same call, the design that served it before), fc0, the tied head
   and, on route "tile", the im2col call's GEMM.  The float conv is checked on the route its plan names: "tc" (the
   tensor cores in 3xTF32) at 1e-4 and bit for bit repeatable at
   vgg16.conv1, vgg16.conv8, alexnet.conv1, the 512² dma call and a
   two-block call, "cudacore" at 2e-3 at every case; "tc" is timed at the
   first four (bounds in 3xTF32 and f32), "cudacore" at vgg16.conv0.  The
   fixed-point conv is checked bit for bit, and for repeatability, on the
   route its plan names at VGG16 conv0 / 1 / 4 / 8 / 12, AlexNet conv0-4
   and LeNet conv0 over every width mix and both rungs, at the 512² dma
   call, a two-block call and two wrap-around cases on "tc" (raws -1 at 3x3
   x Cin 4096, -32768 at 1x1 x Cin 8); "tc" (s8 / u8 limb wgmma) is timed at
   VGG16 conv1 int16, conv8 int8 x int8 and the 512² dma call, "cudacore"
   at VGG16 conv0 int16, each with its bytes and limb bounds.  Flash
   attention is checked on the route its plan names (head dims 16 and 32 on
   "simt", 64 and 128 on "wgmma", the tensor cores in split-precision bf16)
   at 2e-3 (bf16: 2^-7), and each "wgmma" case also against
   ``ref.attention_split_bf16``, the emulation of its arithmetic, at 1e-4
   (bf16: one bf16 step relative plus 2^-12); "wgmma" is timed at the qwen2 prefill
   shape beside its preparation launch, the plain version and SDPA (bounds
   in split bf16 and f32), and non-causal at q (2, 16, 4096, 64) (the
   chunked route of an encoder layer), "simt" at a head-dim-32 GQA case of
   1024 tokens.  Phase 10's expert GEMMs, granite-moe's (128, 1536) @
   (1536, 512) on "wgmma" and (2, 1536) @ (1536, 512) on "splitk" in bf16,
   are checked and timed beside ``torch.matmul``.  The q16 GEMM is checked bit for bit on the
   route its plan names ("splitk" for m <= 16, "wgmma" above) at every q16
   GEMM shape of both main paths, the im2col route's int8 x int8 and int16
   x int8, and the two wrap-around cases (raws -1 at k = 40,960, -32768 at
   k = 4) on both routes; "splitk" is timed at VGG16 fc0, decode gate / up
   and the grid head, "wgmma" at the prefill's gate / up and the im2col
   int8 x int8 call (beside ``torch._int_mm``), each beside route "tile",
   the design that served every q16 GEMM before the routes; and the q8
   serving path's int8 x int8 GEMMs, checked and timed: decode gate / up and
   the head on "splitk", the prefill's gate / up on "wgmma" (beside
   ``torch._int_mm``);
3. the CNN path: ``plan_cnn`` -> ``cnn_forward`` for LeNet, AlexNet and
   VGG16 at full width, batch 8, random weights and biases from a seed
   (each hidden layer fitted onto the activation grid), in float,
   grid-resident Q2.14, a forced int8/int16 mix and the mix the precision
   DSE chooses (``calibrate_cnn_precision`` at budget 0.99 on the card,
   its per-layer drift and plan printed; a second call must replay the pins
   with no search and no forward), with every kernel's
   launch count set to 0 just before and read just after (each conv per
   route, float and fixed point alike: VGG16 12 "tc" and 1 "cudacore",
   AlexNet 4 and 1, LeNet 0 and 2, with a preparation launch per "tc" call
   and a reduction per Cin split; every FC layer on its GEMM's "splitk").  Float logits
   are held to the plain ``torch`` backend on the card; the fixed-point
   logits to the same engine on the CPU (the kernels' plain versions), bit
   for bit, and that run shows how few of each layer's raws are clipped;
4. the time, images/s and peak memory of one forward of each, and the
   device time by kernel of VGG16's forwards (``torch.profiler``);
5. the serving path: ``launch/serve.py:generate`` on qwen2-0.5b at full
   width and depth (bf16, random weights from the seed), 4 prompts of 4096
   tokens then 16 greedy tokens, in float on the ``cuda`` backend and
   grid-resident after ``calibrate_policy``, each with the launch counts set
   to 0 just before and read just after (the float GEMM's per route: every
   prefill GEMM on wgmma, every m = 4 GEMM on splitk, none on the q16
   GEMM; on the grid, every prefill GEMM on the q16 GEMM's "wgmma" with its
   preparation launch, its head and every decode GEMM on "splitk", none on
   "tile"; flash once a layer a prefill on its route "wgmma", with its
   preparation launch, none on "simt" and none in decode).  Each stream is
   replayed teacher-forced through the same kernels and through the plain
   ``torch`` backend (float), and the logits are held to stated
   tolerances; the grid-resident replay shows each layer's share of raws at
   the grid's bounds and the island counts.  A third run, ``q8``, streams
   the plan of the precision DSE (``calibrate_precision`` at budget 0.99,
   then, where that leaves no group on int8, the budget-0.0 plan on the same
   drifts: every GEMM int8 x int8 and an int8 KV cache) under the grid's
   gates and launch counts, one graph capture, and k / v cache bytes
   exactly half the grid run's in each int8 group.  Then prefill tokens/s,
   decode ms/step, peak memory, device time by kernel (``torch.profiler``),
   each beside the same steps through ``compiled_steps`` (one CUDA graph
   replay a step);
6. the serve scheduler: ``ServeScheduler`` on the same qwen2-0.5b, float
   and grid-resident, 8 slots over the ladder (512, 1024, 4096), 32 new
   tokens at most, warmed up, then a bursty ``synthetic_trace`` of 24
   requests (prompts of 64-4096 tokens, half at t = 0, the rest in four
   bursts) on the system clock, each decode step one replay of the
   scheduler's own captured CUDA graph (one graph per cache owner and input
   signature).  Gates: a replay and the eager step give the same logits and
   cache bit for bit at the 8-slot shape (anonymous calls, on a graph of
   their own, released before the trace); every request completes and no
   slot leaks; the trace makes no DSE search and no capture after warm-up;
   each stream, teacher-forced through the unbatched path, within phase 5's
   logit tolerances, a token differing only where the top-2 margin is at
   most 2·max |Δlogit|; launches per route counted through the replays
   (decode GEMMs and heads on "splitk", prefill GEMMs on "wgmma", none on
   "tile", flash once a layer per 4096-rung prefill).  Printed: decode ms a
   step eager against graph, the device's busy share of a replayed step,
   tokens/s by wall time, TTFT p50 / p99, peak memory; then 4 requests with
   512-token prefill chunks under the same stream gate; then ``serve.main``
   at the reference's reduced CLI size: the default backend, and ``--backend
   q8 --precision-budget 0.5`` with and without ``--scheduler``;
7. the serving fleet: (a) ``measure_and_pin`` on the H100 spec at qwen2's
   gate / up (float decode over route splitk's slices, float prefill over
   both wgmma tiles, grid decode in int16), each candidate timed with CUDA
   events beside the analytic plan, the pin saved to a JSON store, reloaded
   and launched; (b) ``ReplicaRouter`` on qwen2-0.5b at full width and
   depth on the grid: 2 replicas of 4 slots, ladder (256, 512, 1024), 16
   requests of 64-900 prompt tokens and 8-24 new ones on a virtual clock,
   replica 0 killed at tick 3 with checkpoints every 2 ticks and a restart a
   tick later, store saves every 4 ticks with one delayed; gates: the ledger
   equals a one-replica fault-free run's and is exactly-once, a session was
   restored from a checkpoint, no DSE search after the first warm-up, no
   capture but the restarted incarnation's warm-up, the kill releases the
   dead incarnation's memory and the peak after the restart stays within
   one replica of the peak before, the store loads; tokens/s of 1 and 2
   replicas and the restart's cost in ticks and seconds are printed;
   (c) the CLIs in subprocesses at the reduced size, in parallel chains at
   the end of the run (with phase 9(c)'s): ``serve --backend q16
   --scheduler --replicas 2 --plan-store S`` twice (the second with no
   search), ``scheduler_soak --backend q16`` under ``REPRO_PLAN_ASSERT_WARM=1``
   on S3 (after one run that writes S3), ``serve --backend q8 --plan-store``
   twice, ``router_soak --backend q16 --workers 2`` with its real kill;
8. the paper's FPGA plane: phase 14 prints the port's Table 1, Table 2
   and DSE-sweep rows from ``benchmarks/run.py``'s JSON and checks that
   every paper compute unit fits its board and Table 1's conv GOP/s rise
   from Ultra96 to ZCU102;
9. sharding on ``torch.distributed`` ("shards"): two ranks on the one card
   over ``gloo`` (``launch/mesh.py:spawn_ranks``; gloo takes no CUDA tensor
   for send / recv, so every collective is staged through the host, and
   two ranks on one card are not a multi-card time).  (a) VGG16 and AlexNet
   at 224², batch 8, full width, phase 3's weights and grid, with H cut
   into S = 2 slabs: once as the one-process slab-major simulation
   (``plan_cnn(spatial=2)``) and once over the ranks (``spatial="data"``,
   each rank its slab, only the halo rows exchanged); gates: grid logits
   bit-identical to the unsharded forward, float within 2e-3 (max |Δ|
   printed beside the reference's own 1e-5), a warm forward plans nothing;
   printed: launches by route, the halo bytes against a full gather's, ms a
   forward.  (b) qwen2-0.5b at full width cut to 2 of its 24 layers
   (drawn apart from phase 5's), tensor-parallel over a
   2-way "model" axis (column shards, activations gathered at the seams,
   decode eager), float and Q4.12, a ``ServeScheduler`` of 4 slots over the
   ladder (256, 512) on a short ``synthetic_trace``: token streams
   byte-identical to the single-device scheduler on the card, and after a
   plan-store round trip a warm restart searches nothing and streams the
   same tokens; printed: eager ms a meshed decode step beside the
   single-device replayed step.  (c) ``serve --scheduler --shards 2`` in a
   subprocess exits 0 (run with phase 7(c)'s CLIs).  (d)
   granite-moe-3b-a800m at full width cut to 2 of its 32 layers, bf16,
   through the meshed ``ServeScheduler`` on the same two ranks as a (1, 2)
   mesh under ``DECODE_RULES`` with expert_mlp over "model" (gate /
   up column shards, the hidden gathered before down; each rank draws only
   its shards, ``scheduler.serve_shardings``), 4 slots over (256, 512), 4
   requests: streams byte-identical to the single-device scheduler on the
   card, every request complete, every meshed step eager; printed: eager
   ms a meshed decode step beside the replayed single-device step, the
   expert GEMMs a step, launches.  (e) mamba2-1.3b, recurrentgemma-9b,
   whisper-medium and llama-3.2-vision-90b (phase 10's 5 layers; the others
   a quarter of their layers, whisper's decoder) at full width through ``compiled_steps(mesh=)`` on the
   same (1, 2) mesh (the SSD and RG-LRU blocks whole on both ranks, their
   states uncut; MLPs and attention projections column shards) and on a
   (2, 1) mesh (the data split: a row a rank, the recurrent states, conv
   histories and cross k / v cut by rows, ``scheduler.shard_cache``), 2 x
   256 prompt tokens then 8 greedy decode steps: on both meshes every
   step's logits and tokens bit for bit the single-device
   ``compiled_steps``' on the card; printed: eager ms a meshed decode step,
   launches, each part's seconds;
10. the other model families ("families"): ``generate`` on the ``cuda``
   backend in bf16, ``init_params`` weights from the seed, 16 greedy
   tokens after each prompt:
   granite-moe-3b-a800m, mamba2-1.3b and recurrentgemma-9b (cut to 4 of
   32, 12 of 48 and 9 of 38 layers) on 2 x 4096 tokens, whisper-medium on 2 x 432 after a 2 x 1500 x 1024 frame context,
   llama-3.2-vision-90b at full width cut to 5 layers (one period: 4 self +
   1 gated cross; ``reduced``) on 2 x 1024 after a 2 x 1600 x 8192 image
   context; the VLM's cross gates are set to 0.5 (init_params's 0 would
   zero the cross layer's output).  Gates per config: launches by route
   counted over generate
   (flash once a layer only in granite's prefill, on "wgmma"; every GEMM on
   the route its m sends it to, counted from the model's structure; no
   "tile", q16 or conv launch), the prefill's and every teacher-forced
   decode step's logits against the plain ``torch`` backend (phase 5's
   float gates; where the plain bf16 path itself sits more than 5 % of the
   logit scale from the same weights in f32, the kernel path is held to
   sit at most 1.25x as far from them instead of within 5 % of the plain
   path), two replayed decode steps equal to the eager ones bit for
   bit in logits and the whole cache, recurrent states moving.  Printed:
   prefill tokens/s, decode ms a step eager and replayed, peak memory.
   Then granite through ``ServeScheduler`` (4 slots, ladder (256, 512), 6
   requests of ``synthetic_trace``): replay = eager at the 4-slot shape,
   every request completes.  (b) internlm2-1.8b and mistral-nemo-12b, the
   dense configs no earlier phase ran, at full width and depth on 2 x 4096
   tokens under the same gates and launch counts (flash once a layer on
   "wgmma" at head dim 128; the f32 floor's copy made where it fits, and
   where the 5 % gate misses), their seconds printed apart;
11. training ("train"), every step on the ``torch`` template (autograd over
   plain tensor ops, as the reference trains on its ``xla`` backend; no
   hand-written kernel has a backward): (a) qwen2-0.5b at full width and
   depth (bf16, remat on, 493,961,216 parameters) through
   ``launch/train.main``, 6 steps of 8 x 1024 tokens in 2 microbatches,
   once fault-free without a checkpoint and once failing at step 4 with
   checkpoints every 3 (into a directory under ``build/`` that the phase
   deletes).  Gates: every loss finite, the last two below the first, one
   failure and a restart at 3, the restarted run's losses equal to the fault-free run's
   bit for bit, step 0 within 1 % (loss) and 5 % (grad norm) of the same
   weights and batch in f32, no kernel launched.  Printed: ms a step,
   tokens/s, peak memory, checkpoint save and restore seconds, the share
   of the bf16 dense peak that 6·N·D reaches.  (b) The LeNet QAT example
   (``repro_torch.examples.train_lenet_q214``): 60 float and 30 QAT steps
   at batch 32, then the grid deploy and the precision DSE on the ``q16``
   template.  Gates: the last QAT loss below the first float loss, the
   deployed logits (grid and the DSE's plan) bit-identical to the CPU
   engine's on the same quantized weights and images, the q16 conv on
   "cudacore" and the q16 GEMM on "splitk" launched and counted, no float
   kernel.  (c) One ``loss_fn`` forward and backward a family at full
   width, depth cut to one period (whisper: one decoder and one encoder
   layer; llama-3.2-vision: one self and one gated cross layer), bf16, no
   optimizer state, 1 x 1024 tokens (whisper 1 x 432 after 1500 frames,
   llama-vision after 1600 image tokens).  Gates: the loss and every grad
   finite, the loss within 1 % and the grad norm within 5 % of the same
   weights' f32 pass.  Printed: ms and peak memory;
12. training on ranks ("train_mesh"): (a)'s qwen2-0.5b run at full width,
   cut to 2 of its 24 layers, through ``launch/train.main --mesh single
   --ranks 2`` (two gloo ranks of the card, collectives staged through
   pinned host memory), one run after another on the same two rank
   processes: FSDP for 2 steps, FSDP failing at step 1 with a checkpoint
   every step, data-parallel (``--no-fsdp``) for 1, and tensor-parallel
   (``--model 2``: "model" = 2, sequence-parallel activations) for 1.
   Gates: finite losses, step 0 within 1e-3 (loss) and 1e-2 (grad norm)
   of a single-device step 0 at the same depth, the restarted run equal to
   the fault-free one bit for bit.  Printed: ms a
   step, tokens/s, each rank's peak memory, save and restore seconds, and
   each run's collectives a step by kind and mesh axis;
13. the dry-run cells ("dryrun"): ``python -m repro_torch.launch.dryrun
   --arch qwen2.5-32b --mesh both`` in a subprocess started before phase
   2, planning on the host meanwhile (every cell of the arch on the
   production meshes (16, 16) and (2, 16, 16) planned as layouts and
   counted op by op as rank 0, a recording rank, on fake tensors, a JSON
   record a cell; printed: the cells that ran and were skipped, the CLI's
   own seconds, and each ran cell's roofline terms at the card's rates,
   dominant term, useful ratio and roofline fraction, or its recorded
   ``analysis_refused``: a ran cell with neither fails the phase); the op
   analyzer's counts of phase 5's float prefill and phase 11a's train step
   (one card, no mesh; a second subprocess started beside the CLI), bytes
   and least ms by group beside the device ms by group those phases
   measured (reported, not gated); rank 0's argument shards of the
   (decode_32k, 16x16) cell
   allocated on the card at the record's local shapes, their bytes equal
   to the record's ``argument_size_in_bytes`` exactly (printed beside
   ``torch.cuda.memory_allocated``'s delta); every planned local GEMM of
   (decode_32k, 16x16) and (prefill_32k, 16x16) run in bf16 through
   ``Engine.matmul`` on its plan, gated to launch the plan's route and held
   to the float GEMM's plain version at phase 2's bf16 tolerance; printed:
   kernel ms and bound ms.  Their launches are the ``kernels`` line's path
   "dryrun cells";
14. the benchmark scripts, when nothing else runs on the card:
   ``python -m repro_torch.benchmarks.run`` in a subprocess (table1,
   table2, dse_sweep, kernel_table, precision_drift, scheduler_soak,
   router_soak, then the roofline report of phase 13's records), which must
   exit 0 (each script's own gates held); printed from its JSON
   (``build/bench_torch.json``): the H100 ``kernel_table`` rows (each case's
   float GEMM in bf16 and q16 GEMM in int16 on its planned route, with
   ``ms``, ``bound_ms`` and ``library_ms``), the correctness pass (the
   integer kernels exact), the precision gates' verdicts and the roofline
   rows of the 16x16 cells, each gated equal to phase 13's records field for
   field.

``--train-mesh-nccl`` runs, alone, training over NCCL on four cards (a
rank each; it fails with fewer): qwen2-0.5b data-parallel, FSDP and
tensor-parallel on (2, 2) and (1, 4) ("data", "model") at 8 x 4096 tokens
against one card's steps, and recurrentgemma-9b at full depth under FSDP
with each card's peak memory.
``--serve-mesh-nccl`` runs, alone, meshed serving over NCCL on four cards
(a rank each, mesh (1, 4); it fails with fewer): qwen2.5-32b at full width
and depth through the meshed scheduler against the same scheduler on one
card (streams byte for byte; 4 slots, ladder (256, 512), 6 requests, which
one card holds beside its 65.5 GB of weights); phi3.5-moe (scheduler,
expert_mlp over "model") and llama-3.2-vision-90b (``compiled_steps``,
embed over "model", 2 x 4096 prompt tokens, 16 steps) at full depth on
the four cards (every request or step completes, finite logits, each
card's peak under its memory), and each cut to a depth one card holds
(8 and 10 layers) on four cards against one, bit for bit.  Each meshed
run serves eager (``capture=False``), then captured (one CUDA graph a
signature on each rank, the NCCL collectives inside, every decode step a
replay) on the same weights: the captured streams and logits equal the
eager ones bit for bit.  Printed: each card's peak memory, prefill
tokens/s, eager and replayed decode ms a step, captures a rank,
collectives a decode step by kind.
``--parent-ab DIR`` runs, alone, phase 11(a)'s single-device run (4
steps), the replayed single-card decode of recurrentgemma-9b, whisper-medium
and mamba2-1.3b at full depth, phase 9's tensor-parallel scheduler runs
(float and grid, no plan store) and phase 12's FSDP run from the
checkout at DIR (an earlier commit's tree, unpacked with ``git archive``)
and from this one, each run in a process of its own on two gloo ranks of
the card, in the order DIR, this, this, DIR; it prints each run's decode
ms a step, FSDP ms a step and seconds, and whether the runs' streams and
losses agree (the kernels' sources must be the same in both trees: DIR
reuses this checkout's build).
``--split-decode-study`` runs, alone, the decode step's plain contractions
at the families' full widths on 8 rows against every (f, 1) data split of
them (f = 2, 4, 8; each rank under ``sharding.batch_split``): attention
with its two contractions made four ways (one batched einsum over a rank's
rows, one einsum a row, products summed by torch, ``layers.split_einsum``),
the RG-LRU conv and SSD output contractions, the norms and the float GEMMs
under the split's logical plan; it prints which splits give a rank other
bits than one device and each attention form's ms at 2, 4 and 8 rows (not
gated: the design study behind ``split_einsum``).
``--gemm-route-study`` adds the float GEMM's design measurements, off by
default: route "tile" timed beside fc0 and the tied head, and the
``wgmma_threshold`` lines (gate / up's n and k at m from 17 to 256 and at
the prefill's m, each wgmma tile against the tile route), which set the
planner's bound between routes W and L, and the q16 GEMM's line (split-k
against wgmma in int16 from m = 1 to 64), which checks its bound at m = 16.
``--conv-route-study`` times the conv's CUDA-core route beside each timed
tensor-core row, float, and fixed point at every VGG16 layer checked.
``--float-fleet-study`` runs phase 7b's kill in float once more and reports
whether the ledger diverged, and at what top-2 margin (not a gate).
``--flash-pv-study`` builds a variant of flash's route "wgmma" that
accumulates PV in place into O (the design the committed kernel rejected)
and reports both designs' ptxas spills, times at the qwen2 prefill shape
and error against ``ref.attention_split_bf16`` at two q / k scales.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or run from a
directory that holds no ``src/repro_torch``, it exits with code 2 and
prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: float tolerances (atol = rtol), the reference's own (tests/test_kernels.py)
GEMM_TOL = 1e-4
#: ``--gemm-route-study``: time the float GEMM's design alternatives too
ROUTE_STUDY = False
#: ``--conv-route-study``: time the float conv's CUDA-core route beside "tc"
CONV_ROUTE_STUDY = False
#: ``--flash-pv-study``: flash's route wgmma beside a variant with PV in place
FLASH_PV_STUDY = False
#: --float-fleet-study: phase 7b's kill in float too, reported, not gated
FLOAT_FLEET_STUDY = False
GEMM_TOL_BF16 = 2e-2
CONV_TOL = 2e-3
#: the float conv's tensor-core route (3xTF32) against conv2d_plain: the
#: reference's tolerance between its conv routes (tests/test_conv_routes.py)
TC_TOL = 1e-4
#: end-to-end float logits, cuda kernels vs the torch backend on the card
E2E_TOL = 2e-3
#: the q16 GEMM's library yardstick where none exists
Q16_NO_LIBRARY = "none: no PyTorch call multiplies int16 matrices on CUDA"
#: H100 SXM dense peaks (NVIDIA data sheet, 700 W): HBM, f32, int8 and bf16
#: are the port's spec's (``core/tiling.py:H100``), read by :func:`read_peaks`
HBM_BW = PEAK_F32 = PEAK_INT8 = PEAK_BF16 = None
PEAK_TF32 = 495e12
#: int32 multiply-adds on the CUDA cores: IMAD at half the FFMA rate
PEAK_INT32_CUDA = None
BATCH = 8
SEED = 0
#: He-style weight scale: keeps the activations O(1) through VGG16's ReLU
#: stack (at the reference's default 0.5 its logits fall to ~4e-7, below the
#: Q2.14 grid's resolution, and the fixed-point checks would compare zeros)
INIT_SCALE = 2 ** 0.5
#: random biases, N(0, BIAS_STD^2), so the bias path carries non-zero values
BIAS_STD = 0.1
#: every hidden layer's float output on the input batch peaks here
#: (``fit_cnn_activations``): inside the activation grid that calibration
#: picks from an input in [-1, 1], so the grid-resident forward clips nothing
FIT_LIMIT = 0.5
#: most share of a grid-resident layer's output raws allowed at its bounds
MAX_CLIPPED_SHARE = 1e-3
#: flash attention against its plain version: the reference's 2e-3 in f32
#: (tests/test_kernels.py); bf16 outputs to one bf16 step
FA_TOL = 2e-3
FA_TOL_BF16 = 2 ** -7
#: flash attention's route wgmma against the emulation of its own
#: split-bf16 arithmetic (``ref.attention_split_bf16``): only the order of
#: the f32 sums differs, so a dropped lo product would show.  bf16 outputs to
#: one bf16 step relative, plus 2^-12 (one step at the typical |out| ~ 0.04):
#: there p is rounded to bf16, and an f32 p that differs in its last bits
#: can round to the neighbouring value, 2^-8 of p
FA_SPLIT_TOL = 1e-4
FA_SPLIT_TOL_BF16 = dict(atol=2 ** -12, rtol=2 ** -7)
#: the serving main path: qwen2-0.5b, 4 prompts of 4096 tokens, 16 generated
QWEN_ARCH = "qwen2-0.5b"
QWEN_PROMPTS = 4
QWEN_PROMPT_LEN = 4096
QWEN_GEN = 16
#: random QKV biases and norm scales, N(0, 0.1²), so both carry values
QWEN_PARAM_STD = 0.1
#: phase 6, the serve scheduler: 8 slots over the ladder (512, 1024, 4096),
#: 32 new tokens at most (cache_len 4128); a 24-request bursty trace, then 4
#: requests with 512-token prefill chunks
SCHED_SLOTS = 8
SCHED_LADDER = (512, 1024, 4096)
SCHED_MAX_NEW = 32
SCHED_REQUESTS = 24
SCHED_CHUNK_REQUESTS = 4
SCHED_CHUNK = 512
#: the trace's prompts run from 64 tokens, its budgets from 8
SCHED_MIN_LEN = 64
SCHED_MIN_NEW = 8
#: seconds between the trace's four later bursts
SCHED_BURST_S = 0.25
#: teacher-forced logits against the plain torch backend (float) on the same
#: stream: max |Δ| / max |logit|, and the least argmax agreement; wherever
#: the plain path's top-2 margin exceeds 2·max |Δ| the argmax must agree
FLOAT_REL_TOL = 0.05
FLOAT_ARGMAX = 0.75
Q16_REL_TOL = 0.25
Q16_ARGMAX = 0.5
#: the precision DSE's budget (serve's default): a layer (group) drops to the
#: int8 rung where its solo-flip argmax agreement is at least this
DSE_BUDGET = 0.99


def read_peaks() -> None:
    """The card's rates from the port's ``H100`` spec, the one copy of each
    (the roofline of ``core/roofline.py`` divides by the same)."""
    global HBM_BW, PEAK_F32, PEAK_INT8, PEAK_BF16, PEAK_INT32_CUDA
    from repro_torch.core.tiling import H100

    HBM_BW, PEAK_F32 = H100.hbm_bw, H100.peak_f32_flops
    PEAK_INT8, PEAK_BF16 = H100.peak_int8_ops, H100.peak_bf16_flops
    PEAK_INT32_CUDA = PEAK_F32 / 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    res = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else res.stderr.strip()


def smi_clocks() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    res = subprocess.run([exe, "--query-gpu=clocks.sm,power.draw,power.limit,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip() if res.returncode == 0 else res.stderr.strip()


def nvcc_version() -> str:
    from repro_torch.kernels._build import _nvcc

    res = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[-1]


def time_ms(fn, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` by CUDA events (``benchmarks/_timing.py``,
    the benchmark scripts' timer)."""
    from repro_torch.benchmarks._timing import time_ms as timed

    return timed(fn, target_ms)


def bound(nbytes: int, ops: int, peak: float) -> tuple[float, str]:
    """The least time of the work on the card (``benchmarks/_timing.py``)."""
    from repro_torch.benchmarks._timing import bound as least

    return least(nbytes, ops, peak, HBM_BW)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------


def phase_card(torch, dev):
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.library(name)  # loads, and binds every entry point
    regs = {}
    for name in _build.SOURCES:
        log = _build.build_log(name)
        used = [int(w) for line in log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes")
                  and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        warnings = [line.strip() for line in log.splitlines() if "arning" in line]
        # ptxas's notes where it serializes a kernel's wgmmas (C7511 and kin)
        serialized = [line.strip()[:200] for line in log.splitlines()
                      if "Performance Loss" in line]
        regs[name] = {"kernels": len(used), "max_registers": max(used, default=None),
                      "spill_lines": spills[:4], "warnings": warnings[:4],
                      "wgmma_serialized": serialized[:4]}
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_version(), "build_s": round(build_s, 3),
          "built": {k: round(v, 3) for k, v in built.items()}, "ptxas": regs})


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


class KernelBook:
    """Per-kernel record: worst error over its checks, and the timings of its
    representative main-path shape.  The float GEMM keeps one record per
    route (``matmul_fp.<route>``)."""

    def __init__(self):
        self.rows = {}

    def check(self, kernel, case, got, want, *, exact, tol=None):
        """``kernel``: a kernel's name, or ``matmul_fp.<route>``."""
        import torch

        if exact:
            if got.dtype != want.dtype or not torch.equal(got, want):
                diff = (got.long() - want.long()).abs()
                raise AssertionError(f"{kernel} {case}: {int((diff > 0).sum())} integer "
                                     f"results differ (max {int(diff.max())})")
            err = 0.0
        else:
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                                       msg=lambda m: f"{kernel} {case}: {m}")
        row = self.rows.setdefault(kernel, {"max_abs_err": 0.0, "checks": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["checks"] += 1
        emit({"phase": "kernel_check", "kernel": kernel, "case": case,
              "max_abs_err": err, "exact": exact, "tol": tol})

    def timing(self, kernel, case, *, kernel_fn, plain_fn, library_fn, library,
               nbytes_, ops, peak, record=True, tile_fn=None, cudacore_fn=None,
               bound_note=None, extra=None):
        """Time one call of the kernel, its plain version and the library
        call on the same inputs; ``record`` makes it the kernel's row in the
        ``kernels`` line, else it is printed as an extra case.  ``tile_fn``:
        the float GEMM's route "tile" on the same call (the block-tiled
        CUDA-core kernel that served every float GEMM before the routes);
        ``cudacore_fn``: the conv's CUDA-core route on the same call.
        ``ops`` are what the bound counts at ``peak`` (``bound_note`` says
        how); ``extra`` adds fields to the row."""
        b_ms, b_by = bound(nbytes_, ops, peak)
        row = {
            "shape": case,
            "ms": time_ms(kernel_fn),
            "plain_ms": time_ms(plain_fn),
            "library_ms": None if library_fn is None else time_ms(library_fn),
            "library": library,
            "bound_ms": b_ms,
            "bound_by": b_by,
            **({"bound_note": bound_note} if bound_note else {}),
            **(extra or {}),
        }
        if tile_fn is not None:
            row["route_tile_ms"] = time_ms(tile_fn)
        if cudacore_fn is not None:
            row["route_cudacore_ms"] = time_ms(cudacore_fn)
        if record:
            self.rows[kernel].update(row)
        emit({"phase": "kernel_time" if record else "kernel_time_extra",
              "kernel": kernel, **row})


def _plan(blk) -> str:
    """A GEMM plan in a case name: route, tile and slices."""
    out = f"route={blk.route} block={blk.bm}x{blk.bn}x{blk.bk}"
    return out + (f" splits={blk.splits}" if blk.splits > 1 else "")


def _gen(dev, seed):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def _randn(torch, shape, dev, seed, scale=1.0):
    return torch.randn(shape, device=dev, generator=_gen(dev, seed)) * scale


def _raws(torch, shape, dtype, dev, seed):
    lim = 127 if dtype == torch.int8 else 32767
    return torch.randint(-lim - 1, lim + 1, shape, device=dev, generator=_gen(dev, seed),
                         dtype=torch.int32).to(dtype)


def phase_kernels(torch, dev, book: KernelBook):
    import torch.nn.functional as F

    from repro_torch.core import dse
    from repro_torch.core.quantization import Q2_6, Q2_14
    from repro_torch.core.template import default_template
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d import (conv2d_cuda, conv2d_plain, conv2d_q16_cuda,
                                            conv2d_q16_plain)
    from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain
    from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain
    from repro_torch.kernels.matmul_q16 import plan_for as q16_plan_for
    from repro_torch.models import cnn

    def conv_plan(n, h, cin, cout, k, s, p, in_bytes):
        """The CUDA-core route's (τ, Cin chunk) for a conv: the planner's
        best-ranked configuration on that route."""
        ho = (h + 2 * p - k) // s + 1
        ranked = dse.explore_conv_spatial(h + 2 * p, h + 2 * p, cin, k, k, ho, ho, cout, s,
                                          H100, in_bytes)
        c = next(c for c in ranked if c.route == "cudacore")
        return c.tau, c.cin_chunk

    # -- float conv ----------------------------------------------------------
    float_convs = [
        # name, n, h, cin, cout, k, stride, pad, tiles (rows, cols, regime)
        ("vgg16.conv0", BATCH, 224, 3, 64, 3, 1, 1, None),
        ("vgg16.conv1", BATCH, 224, 64, 64, 3, 1, 1, None),
        ("vgg16.conv8", BATCH, 28, 512, 512, 3, 1, 1, None),
        ("alexnet.conv0", BATCH, 224, 3, 64, 11, 4, 2, None),
        ("alexnet.conv1", BATCH, 18, 64, 192, 5, 1, 2, None),
        ("lenet.conv0", BATCH, 32, 1, 6, 5, 1, 0, None),
        ("vgg16@512.conv1 dma(256x128)", BATCH, 512, 64, 64, 3, 1, 1, (256, 128, "dma")),
        ("vgg16.conv4 two_block(8)", BATCH, 56, 128, 256, 3, 1, 1, (8, 0, "two_block")),
    ]
    tc_timed = ("vgg16.conv1", "vgg16.conv8", "alexnet.conv1", "vgg16@512.conv1 dma(256x128)")
    engine = default_template("cuda").engine
    for i, (name, n, h, cin, cout, k, s, p, tiles) in enumerate(float_convs):
        x = _randn(torch, (n, h, h, cin), dev, 10 + i)
        w = _randn(torch, (k, k, cin, cout), dev, 20 + i, (k * k * cin) ** -0.5)
        b = _randn(torch, (cout,), dev, 30 + i, 0.1)
        tr, tc, hm = tiles or (0, 0, "none")
        plan = engine.plan_conv(x.shape, w.shape, stride=s, padding=p)
        ho = (h + 2 * p - k) // s + 1
        want = conv2d_plain(x, w, b, stride=s, padding=p, relu=True)
        # the CUDA-core route: checked at every case, as before the routes
        tau, chunk = conv_plan(n, h, cin, cout, k, s, p, 4)
        ckw = dict(stride=s, padding=p, tau=tau, cin_chunk=chunk, tile_rows=tr,
                   tile_cols=tc, halo_mode=hm, relu=True, conv_route="cudacore")
        got = conv2d_cuda(x, w, b, **ckw)
        torch.cuda.synchronize()
        book.check("conv2d.cudacore", f"{name} tau={tau} chunk={chunk}", got, want,
                   exact=False, tol=CONV_TOL)
        cudacore_fn = lambda: conv2d_cuda(x, w, b, **ckw)  # noqa: E731
        nb = nbytes(x, w, b) + n * ho * ho * cout * 4
        flops = 2 * n * ho * ho * cout * k * k * cin
        library_fn = (lambda wn: lambda: F.conv2d(x.permute(0, 3, 1, 2), wn, b, stride=s,
                                                  padding=p))(w.permute(3, 2, 0, 1))
        library = "F.conv2d (cuDNN, TF32 off, channels_last input; no ReLU)"
        if plan.conv_route == "tc":
            tkw = dict(stride=s, padding=p, tau=plan.tau, splits=plan.splits, tile_rows=tr,
                       tile_cols=tc, halo_mode=hm, relu=True, conv_route="tc")
            if tiles is None:  # the plan's own sub-tile; a tiled call plans its region's
                tkw.update(sub_rows=plan.sub_rows, sub_cols=plan.sub_cols)
            else:
                tkw["splits"] = 1
            got = conv2d_cuda(x, w, b, **tkw)
            again = conv2d_cuda(x, w, b, **tkw)
            torch.cuda.synchronize()
            desc = (f"{name} tau={plan.tau} splits={tkw['splits']}"
                    + (f" sub={plan.sub_rows}x{plan.sub_cols}" if tiles is None else ""))
            if not torch.equal(got, again):
                raise AssertionError(f"conv2d.tc {desc}: not repeatable bit for bit")
            book.check("conv2d.tc", desc, got, want, exact=False, tol=TC_TOL)
            if name in tc_timed:
                book.timing(
                    "conv2d.tc", f"{desc} x{tuple(x.shape)} w{tuple(w.shape)}",
                    record=name == "vgg16.conv1",
                    kernel_fn=lambda: conv2d_cuda(x, w, b, **tkw),
                    plain_fn=lambda: conv2d_plain(x, w, b, stride=s, padding=p, relu=True),
                    library_fn=library_fn, library=library, nbytes_=nb, ops=3 * flops,
                    peak=PEAK_TF32, bound_note="ops, 3xTF32: 3 x 2·N·Ho·Wo·Cout·K²·Cin "
                    "at 495 TFLOP/s dense TF32",
                    extra={"bound_f32_ms": bound(nb, flops, PEAK_F32)[0],
                           "bound_f32_note": "ops at 67 TFLOP/s f32 (CUDA cores)"},
                    cudacore_fn=cudacore_fn if CONV_ROUTE_STUDY else None)
            del again
        elif name == "vgg16.conv0":
            book.timing(
                "conv2d.cudacore",
                f"{name} x{tuple(x.shape)} w{tuple(w.shape)} tau={tau} chunk={chunk}",
                kernel_fn=cudacore_fn,
                plain_fn=lambda: conv2d_plain(x, w, b, stride=s, padding=p, relu=True),
                library_fn=library_fn, library=library, nbytes_=nb, ops=flops, peak=PEAK_F32)
        del x, w, got, want

    # -- float GEMM: every FC shape of the CNN path, on the plan it runs ----
    fcs = {}
    for net in ("lenet", "alexnet", "vgg16"):
        spec = cnn.CNN_ZOO[net]
        plan = cnn.plan_cnn(default_template("cuda"), spec,
                            (BATCH, spec.input_hw, spec.input_hw, spec.input_ch))
        for j, gp in enumerate(plan.fcs):
            fcs.setdefault((gp.m, gp.k, gp.n), (f"{net}.fc{j}", gp.block))
    for i, ((m, k, n), (name, blk)) in enumerate(fcs.items()):
        x = _randn(torch, (m, k), dev, 40 + i)
        w = _randn(torch, (k, n), dev, 50 + i, k ** -0.5)
        b = _randn(torch, (n,), dev, 60 + i, 0.1)
        assert blk.route == "splitk", (name, blk)
        got = matmul_fp_cuda(x, w, b, block=blk, relu=True)
        again = matmul_fp_cuda(x, w, b, block=blk, relu=True)
        want = matmul_fp_plain(x, w, b, relu=True)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: route {blk.route} not repeatable"
        book.check(f"matmul_fp.{blk.route}", f"{name} ({m},{k})@({k},{n}) {_plan(blk)}",
                   got, want, exact=False, tol=GEMM_TOL)
        if name == "vgg16.fc0":
            tile = dse.default_block_for(m, n, k, H100)
            book.timing(
                "matmul_fp.splitk", f"{name} ({m},{k})@({k},{n}) f32 {_plan(blk)}",
                kernel_fn=lambda: matmul_fp_cuda(x, w, b, block=blk, relu=True),
                plain_fn=lambda: matmul_fp_plain(x, w, b, relu=True),
                library_fn=lambda: torch.relu(torch.addmm(b, x, w)),
                library="torch.relu(torch.addmm(b, x, w)) (cuBLAS, TF32 off)",
                nbytes_=nbytes(x, w, b) + m * n * 4, ops=2 * m * n * k, peak=PEAK_F32,
                tile_fn=(lambda: matmul_fp_cuda(x, w, b, block=tile, relu=True))
                if ROUTE_STUDY else None)
        del x, w
    # the forced im2col route: im2col + the float GEMM kernel, route "tile"
    x = _randn(torch, (BATCH, 28, 28, 512), dev, 70)
    w = _randn(torch, (3, 3, 512, 512), dev, 71, 4608 ** -0.5)
    blk = dse.default_fp_block_for(BATCH * 28 * 28, 512, 4608, H100, dtype_bytes=4)
    assert blk.route == "tile", blk
    got = ops.conv2d(x, w, padding=1, relu=True, route="im2col", block=blk)
    want = conv2d_plain(x, w, padding=1, relu=True)
    torch.cuda.synchronize()
    book.check("matmul_fp.tile", f"im2col route vgg16.conv8 {_plan(blk)}", got, want,
               exact=False, tol=CONV_TOL)
    # its GEMM alone, timed: route "tile" serves no main-path call
    cols = ops.im2col(F.pad(x, (0, 0, 1, 1, 1, 1)), 3, 3, 1)[0].contiguous()
    wmat = ops.conv_gemm_weights(w).contiguous()
    m, k, n = cols.shape[0], cols.shape[1], wmat.shape[1]
    book.timing(
        "matmul_fp.tile", f"im2col vgg16.conv8 ({m},{k})@({k},{n}) f32 {_plan(blk)}",
        record=False, kernel_fn=lambda: matmul_fp_cuda(cols, wmat, block=blk, relu=True),
        plain_fn=lambda: matmul_fp_plain(cols, wmat, relu=True),
        library_fn=lambda: torch.relu(torch.matmul(cols, wmat)),
        library="torch.relu(torch.matmul(x, w)) (cuBLAS, TF32 off)",
        nbytes_=nbytes(cols, wmat) + m * n * 4, ops=2 * m * n * k, peak=PEAK_F32)
    del x, w, got, want, cols, wmat

    # -- fixed-point conv: each case on the route its plan names ------------
    q_convs = [
        # name, n, h, cin, cout, k, s, p, x dtype, w dtype, out fmt, shift, relu,
        # tiles; the shifts put the int32 sum's top bits on the rung
        ("vgg16.conv0 Q2.14", BATCH, 224, 3, 64, 3, 1, 1, torch.int16, torch.int16,
         Q2_14, 16, True, None),
        ("vgg16.conv1 Q2.14", BATCH, 224, 64, 64, 3, 1, 1, torch.int16, torch.int16,
         Q2_14, 16, True, None),
        ("vgg16.conv4 int16xint8->int8", BATCH, 56, 128, 256, 3, 1, 1, torch.int16,
         torch.int8, Q2_6, 24, False, None),
        ("vgg16.conv8 int8xint8->int16", BATCH, 28, 512, 512, 3, 1, 1, torch.int8,
         torch.int8, Q2_14, 4, True, None),
        ("vgg16.conv12 int8xint16", BATCH, 14, 512, 512, 3, 1, 1, torch.int8, torch.int16,
         Q2_14, 16, False, None),
        ("alexnet.conv0 int16->int8", BATCH, 224, 3, 64, 11, 4, 2, torch.int16,
         torch.int16, Q2_6, 24, True, None),
        ("alexnet.conv1 Q2.14", BATCH, 18, 64, 192, 5, 1, 2, torch.int16, torch.int16,
         Q2_14, 16, True, None),
        ("alexnet.conv2 Q2.14", BATCH, 6, 192, 384, 3, 1, 1, torch.int16, torch.int16,
         Q2_14, 16, True, None),
        ("alexnet.conv3 int8xint8->int8", BATCH, 6, 384, 256, 3, 1, 1, torch.int8,
         torch.int8, Q2_6, 12, True, None),
        ("alexnet.conv4 Q2.14", BATCH, 6, 256, 256, 3, 1, 1, torch.int16, torch.int16,
         Q2_14, 16, False, None),
        ("lenet.conv0 Q2.14", BATCH, 32, 1, 6, 5, 1, 0, torch.int16, torch.int16, Q2_14,
         15, True, None),
        ("vgg16@512.conv1 dma(256x128)", BATCH, 512, 64, 64, 3, 1, 1, torch.int16,
         torch.int16, Q2_14, 16, True, (256, 128, "dma")),
        ("vgg16.conv4 two_block(8)", BATCH, 56, 128, 256, 3, 1, 1, torch.int16,
         torch.int16, Q2_14, 17, True, (8, 0, "two_block")),
    ]
    q_timed = {  # record name -> its row in the kernels line
        "vgg16.conv0 Q2.14": "conv2d_q16.cudacore", "vgg16.conv1 Q2.14": "conv2d_q16.tc",
        "vgg16.conv8 int8xint8->int16": None, "vgg16@512.conv1 dma(256x128)": None}
    q_engine = default_template("q16").engine
    for i, (name, n, h, cin, cout, k, s, p, xd, wd, fmt, shift, relu,
            tiles) in enumerate(q_convs):
        x = _raws(torch, (n, h, h, cin), xd, dev, 80 + i)
        w = _raws(torch, (k, k, cin, cout), wd, dev, 90 + i)
        b = _raws(torch, (cout,), xd, dev, 100 + i)
        plan = q_engine.plan_conv(x.shape, w.shape, stride=s, padding=p)
        tr, tc, hm = tiles or (0, 0, "none")
        kw = dict(stride=s, padding=p, tau=plan.tau, cin_chunk=plan.cin_chunk, tile_rows=tr,
                  tile_cols=tc, halo_mode=hm, relu=relu, fmt=fmt, shift=shift,
                  bias_shift=3, conv_route=plan.conv_route)
        if plan.conv_route == "tc" and tiles is None:  # a tiled call plans its region's
            kw.update(sub_rows=plan.sub_rows, sub_cols=plan.sub_cols, splits=plan.splits)
        desc = (f"{name} route={plan.conv_route} tau={plan.tau} chunk={plan.cin_chunk}"
                + (f" sub={plan.sub_rows}x{plan.sub_cols} splits={kw['splits']}"
                   if "splits" in kw else ""))
        got = conv2d_q16_cuda(x, w, b, **kw)
        again = conv2d_q16_cuda(x, w, b, **kw)
        pkw = dict(stride=s, padding=p, shift=shift, bias_shift=3, raw_min=fmt.raw_min,
                   raw_max=fmt.raw_max, out_dtype=fmt.storage_dtype, relu=relu)
        want = conv2d_q16_plain(x, w, b, **pkw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"conv2d_q16 {desc}: not repeatable bit for bit")
        book.check(f"conv2d_q16.{plan.conv_route}", desc, got, want, exact=True)
        timed = name in q_timed or CONV_ROUTE_STUDY and name.startswith("vgg16.conv") \
            and plan.conv_route == "tc"
        if timed:
            ho = (h + 2 * p - k) // s + 1
            limbs = dse.q16_limb_products(8 * x.element_size(), 8 * w.element_size())
            nb = nbytes(x, w, b) + n * ho * ho * cout * fmt.storage_dtype.itemsize
            ops = 2 * n * ho * ho * cout * k * k * cin
            ckw = dict(kw, conv_route="cudacore", tau=conv_plan(n, h, cin, cout, k, s, p, 2)[0],
                       cin_chunk=conv_plan(n, h, cin, cout, k, s, p, 2)[1])
            for key in ("sub_rows", "sub_cols", "splits"):
                ckw.pop(key, None)
            # the bound is the card's, whatever the route: the int8
            # tensor-core peak over the limb products; the CUDA cores' IMAD
            # rate is kept beside it for route "cudacore"
            extra = {"bound_bytes_ms": nb / HBM_BW * 1e3,
                     "bound_limbs_ms": ops * limbs / PEAK_INT8 * 1e3, "limb_products": limbs}
            if plan.conv_route == "cudacore":
                extra["bound_imad_ms"] = ops / PEAK_INT32_CUDA * 1e3
            row = q_timed.get(name)
            book.timing(
                row or f"conv2d_q16.{plan.conv_route}", f"{desc} x{tuple(x.shape)} "
                f"w{tuple(w.shape)}", record=row is not None,
                kernel_fn=lambda: conv2d_q16_cuda(x, w, b, **kw),
                plain_fn=lambda: conv2d_q16_plain(x, w, b, **pkw),
                library_fn=None,
                library="none: no PyTorch call convolves int16 or int8 on CUDA",
                nbytes_=nb, ops=ops,
                peak=PEAK_INT8 / limbs,
                bound_note=f"ops, {limbs} s8/u8 limb product(s) a multiply-add at 1979 "
                           "TOPS dense int8",
                extra=extra,
                cudacore_fn=(lambda: conv2d_q16_cuda(x, w, b, **ckw))
                if CONV_ROUTE_STUDY and plan.conv_route == "tc" else None)
        del x, w, got, again, want

    # the two wrap-around cases on route "tc": raws -1 at 3x3 x Cin 4096 (the
    # ll limb sum alone passes 2^31; the total is 36,864) and -32768 at 1x1 x
    # Cin 8 (the int32 sum 2^33 wraps to 0); a .satfinite would show here
    for k, cin, v, total in ((3, 4096, -1, 36864), (1, 8, -32768, 0)):
        x = torch.full((BATCH, 3, 3, cin), v, dtype=torch.int16, device=dev)
        w = torch.full((k, k, cin, 64), v, dtype=torch.int16, device=dev)
        # int16 Cin 8 is 16 bytes a pixel, which route "tc" takes; the plan
        # (for every width mix: int8 Cin 8 is not) puts it on "cudacore"
        plan = q_engine.plan_conv(x.shape, w.shape)
        splits = plan.splits if plan.conv_route == "tc" else 1
        kw = dict(tau=64, conv_route="tc", splits=splits, shift=1, bias_shift=0)
        got = conv2d_q16_cuda(x, w, **kw)
        want = conv2d_q16_plain(x, w, shift=1, bias_shift=0, raw_min=Q2_14.raw_min,
                                raw_max=Q2_14.raw_max, out_dtype=torch.int16)
        torch.cuda.synchronize()
        if not int(want.min()) == int(want.max()) == (total + 1) >> 1:
            raise AssertionError(f"wrap case {v} x {v}: plain gives {want.flatten()[0]}")
        book.check("conv2d_q16.tc", f"wrap {v}x{v} {k}x{k} Cin {cin} splits={splits}",
                   got, want, exact=True)
        del x, w, got, want

    # -- fixed-point GEMM: the CNN path's shapes on their planned routes ----
    q_gemms = [
        # name, m, k, n, x dtype, w dtype, out fmt, shift, wide
        ("vgg16.fc0 Q2.14", BATCH, 25088, 4096, torch.int16, torch.int16, Q2_14, 16, False),
        ("vgg16.fc1 int8->int16", BATCH, 4096, 4096, torch.int8, torch.int8, Q2_14, 1, False),
        ("vgg16.fc1 int16->int8", BATCH, 4096, 4096, torch.int16, torch.int16, Q2_6, 24,
         False),
        ("vgg16.fc2 wide", BATCH, 4096, 1000, torch.int16, torch.int16, Q2_14, 0, True),
        ("im2col vgg16.conv8 int8xint8", BATCH * 28 * 28, 4608, 512, torch.int8,
         torch.int8, Q2_6, 9, False),
        ("im2col vgg16.conv8 int16xint8", BATCH * 28 * 28, 4608, 512, torch.int16,
         torch.int8, Q2_14, 10, False),
    ]
    for i, (name, m, k, n, xd, wd, fmt, shift, wide) in enumerate(q_gemms):
        x = _raws(torch, (m, k), xd, dev, 110 + i)
        w = _raws(torch, (k, n), wd, dev, 120 + i)
        b = _raws(torch, (n,), xd, dev, 130 + i)
        blk = q16_plan_for(x, w)
        assert blk.route == ("splitk" if m <= 16 else "wgmma"), (name, blk)
        kw = dict(fmt=fmt, block=blk, relu=not wide, shift=shift, bias_shift=3, wide=wide)
        got = matmul_q16_cuda(x, w, b, **kw)
        again = matmul_q16_cuda(x, w, b, **kw)
        pkw = dict(shift=shift, bias_shift=3, raw_min=fmt.raw_min, raw_max=fmt.raw_max,
                   out_dtype=torch.int32 if wide else fmt.storage_dtype, relu=not wide,
                   wide=wide)
        want = matmul_q16_plain(x, w, b, **pkw)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: route {blk.route} not repeatable"
        book.check(f"matmul_q16.{blk.route}", f"{name} ({m},{k})@({k},{n}) {_plan(blk)}",
                   got, want, exact=True)
        limbs = dse.q16_limb_products(8 * x.element_size(), 8 * w.element_size())
        if name == "vgg16.fc0 Q2.14":
            book.timing(
                "matmul_q16.splitk", f"{name} ({m},{k})@({k},{n}) int16 {_plan(blk)}",
                kernel_fn=lambda: matmul_q16_cuda(x, w, b, **kw),
                plain_fn=lambda: matmul_q16_plain(x, w, b, **pkw),
                library_fn=None, library=Q16_NO_LIBRARY,
                nbytes_=nbytes(x, w, b) + m * n * 2, ops=2 * m * n * k,
                peak=PEAK_INT8 / limbs, tile_fn=lambda: matmul_q16_cuda(
                    x, w, b, **{**kw, "block": dse.default_block_for(m, n, k, H100)}))
        if name.endswith("int8xint8"):
            # torch._int_mm (int8 x int8 -> int32) fits this shape (m > 16,
            # k and n multiples of 8): timed beside the kernel, never used by it
            book.timing(
                "matmul_q16.wgmma", f"{name} ({m},{k})@({k},{n}) {_plan(blk)}",
                kernel_fn=lambda: matmul_q16_cuda(x, w, b, **kw),
                plain_fn=lambda: matmul_q16_plain(x, w, b, **pkw),
                library_fn=lambda: torch._int_mm(x, w),
                library="torch._int_mm (no epilogue)",
                nbytes_=nbytes(x, w, b) + m * n, ops=2 * m * n * k, peak=PEAK_INT8,
                record=False, tile_fn=lambda: matmul_q16_cuda(
                    x, w, b, **{**kw, "block": dse.default_block_for(m, n, k, H100)}),
                extra={"prep_ms": time_ms(lambda: q16_prep_only(x, w))})
        del x, w, got, again, want

    # the two wrap-around cases on both routes: raws -1 at k = 40,960 (the ll
    # limb sum alone passes 2^31; wide reads exactly 40,960) and -32768 at
    # k = 4 (the int32 sum 2^32 wraps to 0); a .satfinite would show here
    for route, m in (("wgmma", 64), ("splitk", 8)):
        for k, v, total in ((40960, -1, 40960), (4, -32768, 0)):
            x = torch.full((m, k), v, dtype=torch.int16, device=dev)
            w = torch.full((k, 40), v, dtype=torch.int16, device=dev)
            blk = q16_plan_for(x, w)
            assert blk.route == route, blk
            got = matmul_q16_cuda(x, w, block=blk, wide=True, shift=0, bias_shift=0)
            want = matmul_q16_plain(x, w, shift=0, bias_shift=0, raw_min=-1, raw_max=1,
                                    out_dtype=torch.int32, wide=True)
            torch.cuda.synchronize()
            if int(want.min()) != total or int(want.max()) != total:
                raise AssertionError(f"wrap case {v} x {v} at k={k}: plain gives {want[0, 0]}")
            book.check(f"matmul_q16.{route}", f"wrap {v}x{v} k={k} wide ({m},{k})@({k},40) "
                       f"{_plan(blk)}", got, want, exact=True)
            del x, w, got, want


def q16_prep_only(x, w):
    """Route "wgmma"'s preparation launch alone, on fresh planes."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels._common import stream_of
    from repro_torch.kernels.matmul_q16 import plan_for, planes_for, prep

    xp, wp, kp = planes_for(x, w, plan_for(x, w))
    prep(_build.library("matmul_q16"), x, w, xp, wp, kp=kp, device=torch.cuda.current_device(),
         stream=stream_of(x))


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

#: float convs per forward on the conv's routes: ("tc", "cudacore")
CONV_ROUTES = {"lenet": (0, 2), "alexnet": (4, 1), "vgg16": (12, 1)}

MIXED = {
    "lenet": ("conv0", "fc0", "fc2"),
    "alexnet": ("conv0", "conv3", "fc1"),
    "vgg16": ("conv0", "conv5", "fc1"),
}


def _to(tree, dev):
    from repro_torch.core.quantization import QTensor

    def leaf(v):
        return QTensor(v.raw.to(dev), v.fmt) if isinstance(v, QTensor) else v.to(dev)

    return {g: [{k: leaf(v) for k, v in layer.items()} for layer in tree[g]]
            for g in ("convs", "fcs")}


def clip_probe(eng, fn):
    """Runs ``fn`` with the engine's ``conv2d`` / ``linear`` wrapped and
    returns (its result, per grid-resident layer the share of output raws
    at the bounds of the layer's rung)."""
    from repro_torch.core.quantization import QTensor

    shares = []
    for meth in ("conv2d", "linear"):
        def probe(*a, _orig=getattr(eng, meth), **kw):
            out = _orig(*a, **kw)
            if isinstance(out, QTensor):
                r, f = out.raw, out.fmt
                shares.append(float(((r == f.raw_max) | (r == f.raw_min)).float().mean()))
            return out

        setattr(eng, meth, probe)
    try:
        return fn(), shares
    finally:
        del eng.conv2d, eng.linear


def random_net(torch, dev, spec, x):
    """He-scale weights and random biases from the seed, each hidden layer
    fitted onto the activation grid on ``x``."""
    from repro_torch.core.template import default_template
    from repro_torch.models import cnn

    params = cnn.init_cnn(torch.Generator().manual_seed(SEED), spec, scale=INIT_SCALE,
                          device=dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    for layer in params["convs"] + params["fcs"]:
        layer["b"] = (BIAS_STD * torch.randn(layer["b"].shape, generator=gen)).to(dev)
    return cnn.fit_cnn_activations(default_template("torch"), spec, params, x,
                                   limit=FIT_LIMIT)


def phase_main_path(torch, dev):
    """Returns per-(net, numerics) state for the timing phase."""
    from repro_torch.core.quantization import int8_rung
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build
    from repro_torch.models import cnn

    runs = []
    _build.reset_launches()
    for net in ("lenet", "alexnet", "vgg16"):
        spec = cnn.CNN_ZOO[net]
        x = (torch.rand((BATCH, spec.input_hw, spec.input_hw, spec.input_ch),
                        device=dev, generator=_gen(dev, SEED + 1)) * 2 - 1)
        params = random_net(torch, dev, spec, x)
        nc, nf = len(spec.convs), len(spec.fcs) + 1

        # float: the CUDA kernels against the plain torch backend, on the card
        tpl = default_template("cuda")
        before = dict(_build.launches)
        plan = cnn.plan_cnn(tpl, spec, tuple(x.shape))
        y = cnn.cnn_forward(tpl, spec, params, x, plan=plan)
        torch.cuda.synchronize()
        assert _build.launches["conv2d"] - before["conv2d"] == nc
        # the float conv's routes: every conv with Cin and Cout multiples of
        # 8 on the tensor cores, the first layers on the CUDA cores
        grew = {k: _build.launches[k] - before[k] for k in before}
        tc, cc = CONV_ROUTES[net]
        splits = sum(cp.splits > 1 for cp in plan.convs)
        if (grew["conv2d.tc"], grew["conv2d.cudacore"]) != (tc, cc) \
                or grew["conv2d.tc_prep"] != tc or grew["conv2d.tc_reduce"] != splits:
            raise AssertionError(f"{net} float: conv launches by route {grew}, want "
                                 f"{tc} tc (+ {tc} prep, {splits} reduce), {cc} cudacore")
        assert _build.launches["matmul_fp"] - before["matmul_fp"] == nf
        # every FC layer (batch 8) streams its weights on the split-k route
        assert _build.launches["matmul_fp.splitk"] - before["matmul_fp.splitk"] == nf
        y_ref = cnn.cnn_forward(default_template("torch"), spec, params, x)
        assert y.shape == (BATCH, spec.n_classes) and bool(torch.isfinite(y).all())
        err = float((y - y_ref).abs().max())
        torch.testing.assert_close(y, y_ref, atol=E2E_TOL, rtol=E2E_TOL)
        with tpl.engine.plan_cache.scope() as warm:
            cnn.cnn_forward(tpl, spec, params, x)
        assert warm["misses"] == 0
        emit({"phase": "forward", "net": net, "numerics": "float", "batch": BATCH,
              "plan": plan.describe(), "max_abs_err_vs_torch_backend": err,
              "tol": E2E_TOL, "logit_absmax": float(y_ref.abs().max())})
        runs.append((net, "float", tpl, spec, params, x, None))
        y_float = y_ref

        # grid-resident Q2.14 and the forced mix, held to the CPU engine
        tq = default_template("q16")
        pol = cnn.calibrate_cnn_policy(tq, spec, params, x)
        low = int8_rung(pol.fmt)
        mixed = dataclasses.replace(pol, name="mixed", layer_fmts=tuple(
            sorted((layer, low) for layer in MIXED[net])))
        tcpu = default_template("q16", device="cpu")
        qplan = cnn.plan_cnn(tq, spec, tuple(x.shape))
        chosen = phase_cnn_dse(torch, tq, spec, params, x, pol)
        for numerics, policy in (("grid " + pol.fmt.name, pol), ("mixed", mixed),
                                 ("dse", chosen)):
            qp = cnn.quantize_cnn_params(tq, spec, params, policy)
            tq.engine.counters.clear()
            before = dict(_build.launches)
            y = cnn.cnn_forward(tq, spec, qp, x, policy=policy)
            torch.cuda.synchronize()
            c = tq.engine.counters
            law = {"quantize_calls": c["quantize_calls"],
                   "dequantize_calls": c["dequantize_calls"]}
            assert law == {"quantize_calls": 1, "dequantize_calls": 1}, dict(c)
            assert _build.launches["conv2d_q16"] - before["conv2d_q16"] == nc
            assert _build.launches["matmul_q16"] - before["matmul_q16"] == nf
            grew = {k: _build.launches[k] - before[k] for k in before}
            # the fixed-point conv's routes: every conv with Cin a multiple of
            # 16 and Cout of 8 on the tensor cores, the first layers on the
            # CUDA cores, as in float
            qsplits = sum(cp.splits > 1 for cp in qplan.convs)
            if (grew["conv2d_q16.tc"], grew["conv2d_q16.cudacore"]) != (tc, cc) \
                    or grew["conv2d_q16.tc_prep"] != tc \
                    or grew["conv2d_q16.tc_reduce"] != qsplits:
                raise AssertionError(f"{net} {numerics}: q16 conv launches by route {grew}, "
                                     f"want {tc} tc (+ {tc} prep, {qsplits} reduce), "
                                     f"{cc} cudacore")
            # every FC layer (batch 8) streams its raws on the q16 split-k route
            if (grew["matmul_q16.splitk"], grew["matmul_q16.tile"],
                    grew["matmul_q16.wgmma"]) != (nf, 0, 0):
                raise AssertionError(f"{net} {numerics}: q16 GEMM launches by route {grew}, "
                                     f"want {nf} splitk")
            assert _build.launches["matmul_fp"] == before["matmul_fp"]
            assert _build.launches["conv2d"] == before["conv2d"]  # no float conv
            with tq.engine.plan_cache.scope() as warm:
                y2 = cnn.cnn_forward(tq, spec, qp, x, policy=policy)
            assert warm["misses"] == 0 and torch.equal(y, y2)
            t0 = time.perf_counter()
            y_cpu, clipped = clip_probe(tcpu.engine, lambda: cnn.cnn_forward(
                tcpu, spec, _to(qp, "cpu"), x.cpu(), policy=policy))
            cpu_s = time.perf_counter() - t0
            assert len(clipped) == nc + nf - 1, clipped
            if max(clipped) > MAX_CLIPPED_SHARE:
                raise AssertionError(f"{net} {numerics}: grid-resident layers clip "
                                     f"{clipped} of their raws")
            if not torch.equal(y.cpu(), y_cpu):
                raise AssertionError(
                    f"{net} {numerics}: logits differ from the plain q16 path "
                    f"(max {float((y.cpu() - y_cpu).abs().max())})")
            emit({"phase": "forward", "net": net, "numerics": numerics, "batch": BATCH,
                  "policy": {"fmt": policy.fmt.name,
                             "layer_fmts": {k: v.name for k, v in policy.layer_fmts}},
                  "bit_identical_to_plain_q16_path": True, "plain_path_cpu_s": cpu_s,
                  "clipped_share_by_layer": clipped,
                  "argmax_agreement_vs_float": float(
                      (y.argmax(-1) == y_float.argmax(-1)).float().mean()),
                  "max_abs_diff_vs_float": float((y - y_float).abs().max()),
                  "island_law": law,
                  "int8_weights": sum(int(qp[g][i]["w"].raw.dtype == torch.int8)
                                      for g in ("convs", "fcs")
                                      for i in range(len(qp[g])))})
            runs.append((net, numerics, tq, spec, qp, x, policy))
    launches = dict(_build.launches)
    emit({"phase": "main_path_launches", "path": "cnn", **launches})
    for name in ("matmul_fp", "matmul_q16", "matmul_q16.splitk", "conv2d", "conv2d.tc",
                 "conv2d.cudacore", "conv2d.tc_prep", "conv2d.tc_reduce", "conv2d_q16",
                 "conv2d_q16.tc", "conv2d_q16.cudacore", "conv2d_q16.tc_prep",
                 "conv2d_q16.tc_reduce"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the CNN path")
    return runs, launches


def phase_cnn_dse(torch, tq, spec, params, x, pol):
    """The drift-aware precision DSE on the card: ``calibrate_cnn_precision``
    at ``DSE_BUDGET`` against the calibrated grid ``pol`` (the reference
    predictions: the per-op q16 forward of the float weights), then a second
    call that must replay the pins: the same policy, one hit a layer, no
    search and no forward.  Returns the chosen policy, which the caller
    holds to the CPU engine bit for bit."""
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import _build
    from repro_torch.models import cnn

    reg = tq.engine.plan_cache
    names = cnn.cnn_layer_names(spec)
    t0 = time.perf_counter()
    chosen = cnn.calibrate_cnn_precision(tq, spec, params, x, budget=DSE_BUDGET, policy=pol)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    pins = {n: reg.precision_for(spec.name, n, H100) for n in names}
    hits0, misses0 = reg.hits, reg.misses
    counters0, launches0 = dict(tq.engine.counters), dict(_build.launches)
    again = cnn.calibrate_cnn_precision(tq, spec, params, x, budget=DSE_BUDGET, policy=pol)
    if not (again == chosen and reg.misses == misses0 and reg.hits == hits0 + len(names)
            and dict(tq.engine.counters) == counters0 and dict(_build.launches) == launches0):
        raise AssertionError(f"{spec.name}: the warm precision DSE did not replay its pins "
                             f"({reg.hits - hits0} hits, {reg.misses - misses0} misses, "
                             f"same policy: {again == chosen})")
    emit({"phase": "cnn_dse", "net": spec.name, "budget": DSE_BUDGET, "base": pol.fmt.name,
          "drift": {n: p.drift for n, p in pins.items()},
          "plan": {n: f.name for n, f in chosen.layer_fmts},
          "int8_layers": sum(f.total_bits == 8 for _, f in chosen.layer_fmts),
          "layers": len(names), "cold_s": cold_s,
          "warm": {"hits": len(names), "misses": 0, "forwards": 0}})
    return chosen


def phase_timing(torch, runs):
    from repro_torch.models import cnn

    emit({"phase": "clocks_before_timing", "nvidia_smi": smi_clocks()})
    for net, numerics, tpl, spec, params, x, policy in runs:
        fwd = (lambda: cnn.cnn_forward(tpl, spec, params, x, policy=policy))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(fwd, target_ms=300.0)
        peak = torch.cuda.max_memory_allocated()
        # peak_mem_bytes counts every tensor alive (all nets' weights and
        # inputs); forward_peak_bytes only what one forward adds on top
        emit({"phase": "forward_time", "net": net, "numerics": numerics, "batch": BATCH,
              "ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
              "peak_mem_bytes": peak, "forward_peak_bytes": peak - resident})
    emit({"phase": "clocks_after_timing", "nvidia_smi": smi_clocks()})


def phase_profile(torch, runs):
    """Device time by kernel over three forwards of each net and numerics
    (torch.profiler's CUDA events), the device's busy share of the profiled
    window's wall time, and its busy share of the forwards' time by CUDA
    events without the profiler, whose own per-op cost inflates the wall of
    a window of short kernels."""
    from repro_torch.models import cnn

    for net, numerics, tpl, spec, params, x, policy in runs:
        fwd = (lambda: cnn.cnn_forward(tpl, spec, params, x, policy=policy))
        fwd()
        torch.cuda.synchronize()
        prof = profile_window(torch, lambda: [fwd() for _ in range(3)],
                              groups=("conv_q16_tc", "q16_conv_prep", "conv_tc",
                                      "conv_kernel", "splitk", "split_reduce", "gemm_kernel"))
        event_ms = time_ms(fwd)
        busy = prof["device_busy_ms"]
        emit({"phase": "profile", "net": net, "numerics": numerics, "forwards": 3, **prof,
              "event_ms_per_forward": event_ms,
              "device_busy_share_of_event_time": busy / 3 / event_ms
              if isinstance(busy, float) else "not measured"})


# ---------------------------------------------------------------------------
# phase 2, serving kernels: flash attention and the tied head's GEMM
# ---------------------------------------------------------------------------


def causal_pairs(sq: int, sk: int, q_offset: int) -> int:
    """(row, col) pairs with col <= q_offset + row, col < sk."""
    return sum(min(sk, q_offset + r + 1) for r in range(sq))


def phase_kernels_serving(torch, dev, book: KernelBook):
    import torch.nn.functional as F

    from repro_torch.core import dse
    from repro_torch.core.quantization import Q2_6
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._common import stream_of
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.matmul_fp import matmul_fp_cuda, matmul_fp_plain, plan_for
    from repro_torch.kernels.matmul_q16 import matmul_q16_cuda, matmul_q16_plain
    from repro_torch.kernels.matmul_q16 import plan_for as q16_plan_for

    fa_cases = [
        # name, b, hq, hkv, sq, sk, d, causal, q_offset, dtype, block; the
        # planner's route (simt at head dims 16 / 32, wgmma at 64 / 128)
        ("MHA", 1, 4, 4, 64, 64, 32, True, 0, torch.float32, 32),
        ("GQA", 2, 8, 2, 64, 64, 32, True, 0, torch.float32, 32),
        ("MQA", 1, 4, 1, 128, 128, 64, True, 0, torch.float32, 32),
        ("non-causal", 2, 4, 4, 64, 64, 32, False, 0, torch.float32, 32),
        ("ragged Sq=96", 1, 2, 2, 96, 96, 32, True, 0, torch.float32, 32),
        ("q_offset=48", 1, 2, 2, 16, 64, 32, True, 48, torch.float32, 16),
        ("bf16 GQA", 2, 16, 2, 300, 300, 64, True, 0, torch.bfloat16, 256),
        ("MHA D128 ragged", 2, 4, 4, 190, 190, 128, True, 0, torch.float32, 64),
        ("GQA D128 q_offset=133", 1, 8, 2, 200, 333, 128, True, 133, torch.float32, 32),
        ("non-causal GQA", 2, 4, 2, 96, 256, 64, False, 0, torch.float32, 256),
        ("non-causal bf16 D128", 1, 4, 4, 64, 128, 128, False, 0, torch.bfloat16, 128),
        ("under one TMA box", 1, 2, 1, 5, 9, 64, True, 4, torch.float32, 16),
        ("GQA D32 S1024", 2, 8, 2, 1024, 1024, 32, True, 0, torch.float32, 256),
        ("qwen2-0.5b prefill", QWEN_PROMPTS, 16, 2, QWEN_PROMPT_LEN, QWEN_PROMPT_LEN, 64,
         True, 0, torch.float32, 1024),
        # the chunked route of a non-causal layer (whisper's encoder at 4096
        # frames or more): the model passes causal=False
        ("non-causal encoder", 2, 16, 16, 4096, 4096, 64, False, 0, torch.float32, 1024),
    ]
    split_err = 0.0
    for i, (name, b, hq, hkv, sq, sk, d, causal, q_offset, dtype, blk) in enumerate(fa_cases):
        # the model's layout: (B, S, H, D) memory, viewed as (B, H, S, D)
        q = _randn(torch, (b, sq, hq, d), dev, 140 + i, 0.5).to(dtype).transpose(1, 2)
        k = _randn(torch, (b, sk, hkv, d), dev, 150 + i, 0.5).to(dtype).transpose(1, 2)
        v = _randn(torch, (b, sk, hkv, d), dev, 160 + i, 0.5).to(dtype).transpose(1, 2)
        kw = dict(causal=causal, q_offset=q_offset)
        plan = dse.plan_flash(d, q.element_size(), H100)
        label = f"{name} q{tuple(q.shape)} kv{tuple(k.shape)} {str(dtype)[6:]}"
        got = ops.flash_attention(q, k, v, bq=blk, bk=blk, **kw)
        want = flash_attention_plain(q, k, v, bk=blk, **kw)
        torch.cuda.synchronize()
        tol = FA_TOL if dtype == torch.float32 else FA_TOL_BF16
        book.check(f"flash_attention.{plan.route}", label, got, want, exact=False, tol=tol)
        if plan.route == "wgmma":
            split = ref.attention_split_bf16(q, k, v, bk=plan.bk, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - split.float()).abs().max())
            tols = (dict(atol=FA_SPLIT_TOL, rtol=FA_SPLIT_TOL) if dtype == torch.float32
                    else FA_SPLIT_TOL_BF16)
            torch.testing.assert_close(got, split, **tols,
                                       msg=lambda m: f"flash wgmma {label} vs split: {m}")
            if dtype == torch.float32:
                split_err = max(split_err, err)
            emit({"phase": "kernel_check", "kernel": "flash_attention.wgmma",
                  "case": f"{label} vs ref.attention_split_bf16", "max_abs_err": err,
                  "exact": False, "tol": tols})
            del split
        if name == "GQA D32 S1024":  # route simt serves no main-path call: timed here
            qc = q.contiguous()
            ke = k.repeat_interleave(hq // hkv, dim=1).contiguous()
            ve = v.repeat_interleave(hq // hkv, dim=1).contiguous()
            pairs = causal_pairs(sq, sk, q_offset)
            book.timing(
                "flash_attention.simt", f"{name} q{tuple(q.shape)} kv{tuple(k.shape)} f32 "
                "causal", record=False,
                kernel_fn=lambda: ops.flash_attention(q, k, v, bq=blk, bk=blk, **kw),
                plain_fn=lambda: flash_attention_plain(q, k, v, bk=blk, **kw),
                library_fn=lambda: F.scaled_dot_product_attention(qc, ke, ve, is_causal=True),
                library="F.scaled_dot_product_attention (f32, kv heads expanded, is_causal)",
                nbytes_=nbytes(q, k, v) + nbytes(q), ops=4 * d * b * hq * pairs,
                peak=PEAK_F32)
            del qc, ke, ve
        if name == "non-causal encoder":  # no main-path call at this size: timed here
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            book.timing(
                "flash_attention.wgmma", f"{name} q{tuple(q.shape)} kv{tuple(k.shape)} f32 "
                "non-causal", record=False,
                kernel_fn=lambda: ops.flash_attention(q, k, v, bq=blk, bk=blk, **kw),
                plain_fn=lambda: flash_attention_plain(q, k, v, bk=blk, **kw),
                library_fn=lambda: F.scaled_dot_product_attention(qc, kc, vc),
                library="F.scaled_dot_product_attention (f32, non-causal)",
                nbytes_=nbytes(q, k, v) + nbytes(q), ops=3 * 4 * d * b * hq * sq * sk,
                peak=PEAK_BF16,
                bound_note="three bf16 products (split precision) per f32 product at "
                           "the bf16 peak")
            del qc, kc, vc
        if name.startswith("qwen2"):
            g = hq // hkv
            qc = q.contiguous()  # the library call gets dense, expanded heads
            ke = k.repeat_interleave(g, dim=1).contiguous()
            ve = v.repeat_interleave(g, dim=1).contiguous()
            lib = _build.library("flash_attention")
            planes = fa.planes(q, k)
            pairs = causal_pairs(sq, sk, q_offset)
            nb = nbytes(q, k, v) + nbytes(q)
            extra = {
                "bound_f32_ms": bound(nb, 4 * d * b * hq * pairs, PEAK_F32)[0],
                "prep_ms": time_ms(lambda: fa.prep(lib, q, k, v, *planes, device=dev.index,
                                                   stream=stream_of(q))),
                "max_abs_err_vs_split": split_err,
            }
            book.timing(
                "flash_attention.wgmma",
                f"{name} q{tuple(q.shape)} kv{tuple(k.shape)} f32 causal",
                kernel_fn=lambda: ops.flash_attention(q, k, v, bq=blk, bk=blk, **kw),
                plain_fn=lambda: flash_attention_plain(q, k, v, bk=blk, **kw),
                library_fn=lambda: F.scaled_dot_product_attention(qc, ke, ve, is_causal=True),
                library="F.scaled_dot_product_attention (f32, kv heads expanded, is_causal)",
                nbytes_=nb, ops=3 * 4 * d * b * hq * pairs, peak=PEAK_BF16,
                bound_note="three bf16 products (split precision) per f32 product at "
                           "the bf16 peak; bound_f32_ms: one f32 product on the CUDA cores",
                extra=extra)
            del qc, ke, ve, planes
        del q, k, v, got, want
    phase_flash_d128(torch, dev, book)

    # the tied LM head reads the (vocab, d) table in place (transposed B)
    vocab, dm = 151936, 896
    for dtype, tol in ((torch.float32, GEMM_TOL), (torch.bfloat16, FA_TOL_BF16)):
        x = _randn(torch, (QWEN_PROMPTS, dm), dev, 170).to(dtype)
        table = _randn(torch, (vocab, dm), dev, 171, dm ** -0.5).to(dtype)
        blk = plan_for(x, table.T)
        assert blk.route == "splitk", blk
        got = matmul_fp_cuda(x, table.T, block=blk)
        again = matmul_fp_cuda(x, table.T, block=blk)
        want = matmul_fp_plain(x, table.T)
        torch.cuda.synchronize()
        assert torch.equal(got, again), "tied head: route splitk not repeatable"
        book.check("matmul_fp.splitk", f"tied head ({QWEN_PROMPTS},{dm})@embed.T({dm},"
                   f"{vocab}) {str(dtype)[6:]} {_plan(blk)}", got, want, exact=False,
                   tol=tol)
        if dtype == torch.bfloat16:
            tile = dse.default_block_for(QWEN_PROMPTS, vocab, dm, H100)
            book.timing(
                "matmul_fp.splitk", f"tied head ({QWEN_PROMPTS},{dm})@embed.T bf16 "
                f"{_plan(blk)}", record=False,
                kernel_fn=lambda: matmul_fp_cuda(x, table.T, block=blk),
                plain_fn=lambda: matmul_fp_plain(x, table.T),
                library_fn=lambda: torch.matmul(x, table.T),
                library="torch.matmul(x, embed.T) (cuBLAS, bf16)",
                nbytes_=nbytes(x, table) + QWEN_PROMPTS * vocab * 2,
                ops=2 * QWEN_PROMPTS * vocab * dm, peak=PEAK_BF16,
                tile_fn=(lambda: matmul_fp_cuda(x, table.T, block=tile))
                if ROUTE_STUDY else None)
        del x, table, got, again, want

    # every distinct GEMM of a qwen2 layer, at prefill (m = 4 x 4096) and at
    # decode (m = 4), on the planner's route: wgmma and splitk
    m_prefill = QWEN_PROMPTS * QWEN_PROMPT_LEN
    layer = [("q", 1024, dm), ("k/v", 128, dm), ("o", dm, 1024), ("gate/up", 4864, dm),
             ("down", dm, 4864)]
    for j, (name, n, k) in enumerate(layer):
        w = _randn(torch, (k, n), dev, 180 + j, k ** -0.5).to(torch.bfloat16)
        b = _randn(torch, (n,), dev, 190 + j, 0.1)
        for m, route in ((m_prefill, "wgmma"), (QWEN_PROMPTS, "splitk")):
            x = _randn(torch, (m, k), dev, 200 + j).to(torch.bfloat16)
            blk = plan_for(x, w)
            assert blk.route == route, (name, m, blk)
            got = matmul_fp_cuda(x, w, b, block=blk)
            again = matmul_fp_cuda(x, w, b, block=blk)
            want = matmul_fp_plain(x, w, b)
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"qwen2 {name} m={m}: route {route} not repeatable"
            book.check(f"matmul_fp.{route}", f"qwen2 {name} ({m},{k})@({k},{n}) bf16 "
                       f"{_plan(blk)}", got, want, exact=False, tol=GEMM_TOL_BF16)
            if name == "gate/up":
                tile = dse.default_block_for(m, n, k, H100)
                book.timing(
                    f"matmul_fp.{route}",
                    f"qwen2 gate/up ({m},{k})@({k},{n}) bf16 {_plan(blk)}",
                    record=route == "wgmma",
                    kernel_fn=lambda: matmul_fp_cuda(x, w, block=blk),
                    plain_fn=lambda: matmul_fp_plain(x, w),
                    library_fn=lambda: torch.matmul(x, w),
                    library="torch.matmul (cuBLAS, bf16)", nbytes_=nbytes(x, w) + m * n * 2,
                    ops=2 * m * n * k, peak=PEAK_BF16,
                    tile_fn=(lambda: matmul_fp_cuda(x, w, block=tile))
                    if route == "wgmma" or ROUTE_STUDY else None)
            del x, got, again, want
        del w, b

    # phase 10's expert GEMMs: granite-moe's (cap, d) @ (d, ff) per (group,
    # expert), at prefill (cap 128, route wgmma) and at decode (cap 2, route
    # splitk), each beside torch.matmul on the same call
    for j, (m, route) in enumerate(((FAMILY_EXPERT_CAP_PREFILL, "wgmma"),
                                    (FAMILY_EXPERT_CAP_DECODE, "splitk"))):
        k, n = GRANITE_D, GRANITE_FF
        x = _randn(torch, (m, k), dev, 270 + j).to(torch.bfloat16)
        w = _randn(torch, (k, n), dev, 275 + j, k ** -0.5).to(torch.bfloat16)
        blk = plan_for(x, w)
        assert blk.route == route, (m, blk)
        got = matmul_fp_cuda(x, w, block=blk)
        again = matmul_fp_cuda(x, w, block=blk)
        want = matmul_fp_plain(x, w)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"granite expert m={m}: route {route} not repeatable"
        label = f"granite-moe expert gate/up ({m},{k})@({k},{n}) bf16 {_plan(blk)}"
        book.check(f"matmul_fp.{route}", label, got, want, exact=False, tol=GEMM_TOL_BF16)
        book.timing(
            f"matmul_fp.{route}", label, record=False,
            kernel_fn=lambda: matmul_fp_cuda(x, w, block=blk),
            plain_fn=lambda: matmul_fp_plain(x, w),
            library_fn=lambda: torch.matmul(x, w), library="torch.matmul (cuBLAS, bf16)",
            nbytes_=nbytes(x, w) + m * n * 2, ops=2 * m * n * k, peak=PEAK_BF16)
        del x, w, got, again, want

    # every distinct grid GEMM of a qwen2 layer in int16, at prefill (route
    # wgmma) and at decode (route splitk), and the grid head (m = 4, w
    # (896, 151936) stored row-major); gate / up timed at both m, beside
    # route "tile" (the design that served every q16 GEMM before the routes)
    for j, (name, n, k) in enumerate(layer + [("head", vocab, dm)]):
        wq = _raws(torch, (k, n), torch.int16, dev, 220 + j)
        # a bias where the model has one (q, k / v), as the float rows
        bq = _raws(torch, (n,), torch.int16, dev, 230 + j) if j < 2 else None
        for m, route in ((m_prefill, "wgmma"), (QWEN_PROMPTS, "splitk")):
            if name == "head" and route == "wgmma":
                continue  # the head reads only each prompt's last position
            xq = _raws(torch, (m, k), torch.int16, dev, 240 + j)
            blk = q16_plan_for(xq, wq)
            assert blk.route == route, (name, m, blk)
            qkw = dict(block=blk, shift=20, bias_shift=4)
            pkw = dict(shift=20, bias_shift=4, raw_min=-32768, raw_max=32767,
                       out_dtype=torch.int16)
            got = matmul_q16_cuda(xq, wq, bq, **qkw)
            again = matmul_q16_cuda(xq, wq, bq, **qkw)
            want = matmul_q16_plain(xq, wq, bq, **pkw)
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"qwen2 {name} m={m}: not repeatable"
            book.check(f"matmul_q16.{route}", f"qwen2 {name} ({m},{k})@({k},{n}) int16 "
                       f"{_plan(blk)}", got, want, exact=True)
            if name in ("gate/up", "head"):
                tile = dse.default_block_for(m, n, k, H100)
                extra = ({"prep_ms": time_ms(lambda: q16_prep_only(xq, wq))}
                         if route == "wgmma" else None)
                book.timing(
                    f"matmul_q16.{route}",
                    f"qwen2 {name} ({m},{k})@({k},{n}) int16 {_plan(blk)}",
                    record=route == "wgmma",
                    kernel_fn=lambda: matmul_q16_cuda(xq, wq, bq, **qkw),
                    plain_fn=lambda: matmul_q16_plain(xq, wq, bq, **pkw), library_fn=None,
                    library=Q16_NO_LIBRARY, nbytes_=nbytes(xq, wq, bq) + m * n * 2,
                    ops=2 * m * n * k, peak=PEAK_INT8 / 4, extra=extra,
                    tile_fn=lambda: matmul_q16_cuda(xq, wq, bq, **{**qkw, "block": tile}))
            del xq, got, again, want
        del wq, bq

    # the q8 path's int8 x int8 GEMMs: decode gate / up and the head on
    # "splitk" (int8 out, and the head's wide int32), the prefill's gate / up
    # on "wgmma" (one limb product) beside torch._int_mm, which takes m > 16
    q8_rows = [("decode gate/up", QWEN_PROMPTS, 4864, dm, "splitk", False),
               ("head", QWEN_PROMPTS, vocab, dm, "splitk", True),
               ("prefill gate/up", m_prefill, 4864, dm, "wgmma", False)]
    for j, (name, m, n, k, route, wide) in enumerate(q8_rows):
        xq = _raws(torch, (m, k), torch.int8, dev, 250 + j)
        wq = _raws(torch, (k, n), torch.int8, dev, 260 + j)
        blk = q16_plan_for(xq, wq)
        assert blk.route == route, (name, blk)
        # shift 14 keeps most int8 outputs off the rung's bounds at k = 896
        qkw = dict(fmt=Q2_6, block=blk, shift=0 if wide else 14, bias_shift=0, wide=wide)
        pkw = dict(shift=0 if wide else 14, bias_shift=0, raw_min=Q2_6.raw_min,
                   raw_max=Q2_6.raw_max, out_dtype=torch.int32 if wide else torch.int8,
                   wide=wide)
        got = matmul_q16_cuda(xq, wq, **qkw)
        again = matmul_q16_cuda(xq, wq, **qkw)
        want = matmul_q16_plain(xq, wq, **pkw)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"q8 {name}: not repeatable"
        label = f"q8 {name} ({m},{k})@({k},{n}) int8 x int8{' wide' if wide else ''}"
        book.check(f"matmul_q16.{route}", f"{label} {_plan(blk)}", got, want, exact=True)
        book.timing(
            f"matmul_q16.{route}", f"{label} {_plan(blk)}", record=False,
            kernel_fn=lambda: matmul_q16_cuda(xq, wq, **qkw),
            plain_fn=lambda: matmul_q16_plain(xq, wq, **pkw),
            library_fn=(lambda: torch._int_mm(xq, wq)) if route == "wgmma" else None,
            library="torch._int_mm (no epilogue)" if route == "wgmma" else
            "none: torch._int_mm takes m > 16 only",
            nbytes_=nbytes(xq, wq) + m * n * got.element_size(), ops=2 * m * n * k,
            peak=PEAK_INT8, bound_note="bytes: each operand read once and the output "
            "written once; ops at 1979 TOPS dense int8 (one limb product)",
            extra={"prep_ms": time_ms(lambda: q16_prep_only(xq, wq))}
            if route == "wgmma" else None)
        del xq, wq, got, again, want

#: flash's route wgmma at head dim 128, at mistral-nemo-12b's prefill in
#: phase 10(b): 2 x 4096 tokens, 32 query and 8 kv heads, bf16, causal
FLASH_D128 = ("mistral-nemo-12b prefill", 2, 32, 8, 4096, 128)


def phase_flash_d128(torch, dev, book: KernelBook):
    """Flash's route wgmma at head dim 128 (``FLASH_D128``, the shape phase
    10(b)'s mistral-nemo prefill gives it) as a row of its own: checked
    against the plain version and the split-precision emulation, timed
    beside the plain version and SDPA; bf16 operands take one bf16 product
    a pair (no lo plane), so the bound counts one."""
    import torch.nn.functional as F

    from repro_torch.core import dse
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_plain

    name, b, hq, hkv, s, d = FLASH_D128
    dt = torch.bfloat16
    q = _randn(torch, (b, s, hq, d), dev, 180, 0.5).to(dt).transpose(1, 2)
    k = _randn(torch, (b, s, hkv, d), dev, 181, 0.5).to(dt).transpose(1, 2)
    v = _randn(torch, (b, s, hkv, d), dev, 182, 0.5).to(dt).transpose(1, 2)
    plan = dse.plan_flash(d, q.element_size(), H100)
    if plan.route != "wgmma":
        raise AssertionError(f"flash at head dim {d}: route {plan.route}, want wgmma")
    key = "flash_attention.wgmma.d128"
    label = f"{name} q{tuple(q.shape)} kv{tuple(k.shape)} bf16 causal"
    got = ops.flash_attention(q, k, v, bq=1024, bk=1024)
    want = flash_attention_plain(q, k, v, bk=1024)
    split = ref.attention_split_bf16(q, k, v, bk=plan.bk)
    torch.cuda.synchronize()
    book.check(key, label, got, want, exact=False, tol=FA_TOL_BF16)
    torch.testing.assert_close(got, split, **FA_SPLIT_TOL_BF16,
                               msg=lambda m: f"flash wgmma {label} vs split: {m}")
    split_err = float((got.float() - split.float()).abs().max())
    del got, want, split
    qc = q.contiguous()
    ke = k.repeat_interleave(hq // hkv, dim=1).contiguous()
    ve = v.repeat_interleave(hq // hkv, dim=1).contiguous()
    book.timing(
        key, label,
        kernel_fn=lambda: ops.flash_attention(q, k, v, bq=1024, bk=1024),
        plain_fn=lambda: flash_attention_plain(q, k, v, bk=1024),
        library_fn=lambda: F.scaled_dot_product_attention(qc, ke, ve, is_causal=True),
        library="F.scaled_dot_product_attention (bf16, kv heads expanded, is_causal)",
        nbytes_=nbytes(q, k, v) + nbytes(q), ops=4 * d * b * hq * causal_pairs(s, s, 0),
        peak=PEAK_BF16, bound_note="one bf16 product a pair (bf16 operands: no lo plane)",
        extra={"max_abs_err_vs_split": split_err})
    del q, k, v, qc, ke, ve


#: ``--flash-pv-study``: flash_wgmma.cuh's PV step (a fresh accumulator a kv
#: tile, added to the rescaled O on the CUDA cores) and the variant it
#: rejected, PV accumulated in place into the rescaled O on the tensor cores
_PV_FRESH = """        float pv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) pv[i] = 0.0f;
        const uint64_t dv_hi = smem_desc(vs, BK * 128, 1024);
        const uint64_t dv_lo = smem_desc(vs + (P - 1) * KP, BK * 128, 1024);
        fence_regs(pv);
        fence_regs(ph);
        if constexpr (P == 2) fence_regs(pl);
        wgmma_fence();
        if constexpr (P == 2) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(pv, ph + 4 * kk, dv_lo + kk * 128);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(pv, pl + 4 * kk, dv_hi + kk * 128);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(pv, ph + 4 * kk, dv_hi + kk * 128);
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            o[4 * j + 2 * hh] *= alpha[hh];
            o[4 * j + 2 * hh + 1] *= alpha[hh];
          }
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(ph);
        if constexpr (P == 2) fence_regs(pl);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
"""
_PV_IN_PLACE = """#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            o[4 * j + 2 * hh] *= alpha[hh];
            o[4 * j + 2 * hh + 1] *= alpha[hh];
          }
        const uint64_t dv_hi = smem_desc(vs, BK * 128, 1024);
        const uint64_t dv_lo = smem_desc(vs + (P - 1) * KP, BK * 128, 1024);
        fence_regs(o);
        fence_regs(ph);
        if constexpr (P == 2) fence_regs(pl);
        wgmma_fence();
        if constexpr (P == 2) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(o, ph + 4 * kk, dv_lo + kk * 128);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(o, pl + 4 * kk, dv_hi + kk * 128);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) mma_rs<D>(o, ph + 4 * kk, dv_hi + kk * 128);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ph);
        if constexpr (P == 2) fence_regs(pl);
"""


def _ptxas_spills(log: str) -> list:
    """ptxas's spill lines of route wgmma's kernels in a ``-Xptxas -v`` log."""
    lines, out, kernel = log.splitlines(), [], None
    for line in lines:
        if "Compiling entry function" in line:
            kernel = "flash_attention_wgmma" in line
        elif kernel and "spill" in line:
            out.append(line.strip())
    return out


def phase_flash_pv_study(torch, dev):
    """``--flash-pv-study``: route wgmma as committed beside a variant that
    accumulates PV in place into O, built from a patched copy of the sources
    under ``build/``: ptxas's spills, the time of each at the qwen2 prefill
    shape (committed, variant, variant, committed), and each one's error
    against ``ref.attention_split_bf16`` and the plain version at q / k
    scales 0.5 (the smoke's inputs) and 1.6 (scores several times larger)."""
    import re

    from repro_torch.core import dse
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._common import stream_of

    src = ROOT / "build" / "flash_pv_study"
    src.mkdir(parents=True, exist_ok=True)
    for f in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / "flash_attention.cu"]:
        text = f.read_text()
        if f.name == "flash_wgmma.cuh":
            if text.count(_PV_FRESH) != 1:
                raise AssertionError("flash_wgmma.cuh's PV step is not the one the study "
                                     "patches; update _PV_FRESH / _PV_IN_PLACE")
            # a namespace of its own: launch_d's static `configured` flag would
            # otherwise be one symbol across both libraries
            text = re.sub(r"\bfawg\b", "fawg_pv", text.replace(_PV_FRESH, _PV_IN_PLACE))
        (src / f.name).write_text(text)
    so = src / "libflash_attention_pv_in_place.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src / "flash_attention.cu")], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"flash PV study: nvcc failed:\n{res.stdout[-3000:]}"
                           f"{res.stderr[-3000:]}")
    base = _build.library("flash_attention")
    var = _build.bind(ctypes.CDLL(str(so)), "flash_attention")
    emit({"phase": "flash_pv_study_build",
          "committed_spills": _ptxas_spills(_build.build_log("flash_attention")),
          "in_place_spills": _ptxas_spills(res.stdout + res.stderr)})

    b, hq, hkv, s, d = QWEN_PROMPTS, 16, 2, QWEN_PROMPT_LEN, 64
    plan = dse.plan_flash(d, 4, H100)
    for i, scale in enumerate((0.5, 1.6)):
        q = _randn(torch, (b, s, hq, d), dev, 190 + i, scale).transpose(1, 2)
        k = _randn(torch, (b, s, hkv, d), dev, 192 + i, scale).transpose(1, 2)
        v = _randn(torch, (b, s, hkv, d), dev, 194 + i).transpose(1, 2)
        planes = fa.planes(q, k)
        fa.prep(base, q, k, v, *planes, device=dev.index, stream=stream_of(q))

        def run(lib, q=q, k=k, planes=planes):
            out = torch.empty_like(q)
            fa.launch_wgmma(lib, *planes, out, plan=plan, kv_shape=k.shape, causal=True,
                            q_offset=0, device=dev.index, stream=stream_of(q))
            return out

        fresh, in_place = run(base), run(var)
        split = ref.attention_split_bf16(q, k, v, bk=plan.bk)
        plain = fa.flash_attention_plain(q, k, v, bk=1024)
        score = (q[0, 0] @ k[0, 0].T).abs().max() / d ** 0.5
        torch.cuda.synchronize()
        row = {"phase": "flash_pv_study", "shape": f"q{tuple(q.shape)} kv{tuple(k.shape)} "
               "f32 causal", "qk_scale": scale, "max_abs_score_head0": float(score)}
        for name, got in (("committed", fresh), ("in_place", in_place)):
            row[f"{name}_err_vs_split"] = float((got - split).abs().max())
            row[f"{name}_err_vs_plain"] = float((got - plain).abs().max())
        if i == 0:
            t = [time_ms(lambda: run(base)), time_ms(lambda: run(var)),
                 time_ms(lambda: run(var)), time_ms(lambda: run(base))]
            row.update({"committed_ms": [t[0], t[3]], "in_place_ms": [t[1], t[2]]})
        emit(row)
        del q, k, v, planes, fresh, in_place, split, plain


def phase_wgmma_threshold(torch, dev):
    """``--gemm-route-study``: where route W starts to beat route L on bf16,
    on gate / up's n and k at small m (the planner sends m <= 16 to split-k
    and every larger m to W), and at the full prefill m the two compiled
    wgmma tiles side by side; then the q16 GEMM's split-k and wgmma routes
    on the same n and k in int16 from m = 1 to 64."""
    from repro_torch.core import dse
    from repro_torch.core.tiling import H100, MatmulBlock
    from repro_torch.kernels.matmul_fp import matmul_fp_cuda, plan_for
    from repro_torch.kernels.matmul_q16 import matmul_q16_cuda
    from repro_torch.kernels.matmul_q16 import plan_for as q16_plan_for

    n, k = 4864, 896
    w = _randn(torch, (k, n), dev, 210, k ** -0.5).to(torch.bfloat16)
    for m in (17, 32, 64, 128, 256, QWEN_PROMPTS * QWEN_PROMPT_LEN):
        x = _randn(torch, (m, k), dev, 211).to(torch.bfloat16)
        wg, wg256 = (MatmulBlock(128, bn, 64, route="wgmma") for bn in (128, 256))
        tile = dse.default_block_for(m, n, k, H100)
        emit({"phase": "wgmma_threshold", "m": m, "n": n, "k": k,
              "wgmma_128x128_ms": time_ms(lambda: matmul_fp_cuda(x, w, block=wg)),
              "wgmma_128x256_ms": time_ms(lambda: matmul_fp_cuda(x, w, block=wg256)),
              "tile_ms": time_ms(lambda: matmul_fp_cuda(x, w, block=tile)),
              "tile": _plan(tile), "planned": _plan(plan_for(x, w))})
        del x
    del w

    # the q16 GEMM on the same n and k in int16: route "splitk" (m <= 16)
    # against route "wgmma" (any m) on both sides of splitk_max_m, which
    # sets the planner's bound between the two
    wq = _raws(torch, (k, n), torch.int16, dev, 212)
    wg = MatmulBlock(128, 64, 128, route="wgmma")
    for m in (1, 2, 4, 8, 12, 16, 17, 24, 32, 64):
        xq = _raws(torch, (m, k), torch.int16, dev, 213)
        row = {"phase": "wgmma_threshold", "kernel": "matmul_q16", "m": m, "n": n, "k": k,
               "dtype": "int16", "wgmma_128x64_ms": time_ms(
                   lambda: matmul_q16_cuda(xq, wq, block=wg)),
               "planned": _plan(q16_plan_for(xq, wq))}
        if m <= H100.splitk_max_m:
            sk = dse.default_q16_block_for(m, n, k, H100)
            row.update({"splitk_ms": time_ms(lambda: matmul_q16_cuda(xq, wq, block=sk)),
                        "splitk": _plan(sk)})
        emit(row)
        del xq
    del wq


# ---------------------------------------------------------------------------
# phase 5: the serving path (qwen2-0.5b)
# ---------------------------------------------------------------------------


def qwen_params(torch, dev, cfg):
    """Random weights from the seed in the config's bf16, drawn on the card,
    with N(0, 0.1²) QKV biases and norm scales (both are zero at init)."""
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(gen, cfg)
    for blk in params["blocks"]:
        leaves = [blk["attn"][n]["b"] for n in ("wq", "wk", "wv")]
        leaves += [blk[n]["scale"] for n in ("norm", "ffn_norm")]
        for t in leaves:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * QWEN_PARAM_STD)
    return params


def teacher_forced(torch, tpl, cfg, params, prompts, stream, policy=None, islands=None,
                   kv_bytes=None, ctx=None):
    """Per-step logits (B, gen, V) in f32 of the prefill (over ``ctx`` too,
    for an encoder-decoder or VLM config) and the decode steps fed
    ``stream`` (the greedy tokens of a ``generate`` run).  ``islands``, a
    list, receives each step's (quantize, dequantize) counts; ``kv_bytes``, a
    dict, the bytes of the prefill cache's k / v by precision group."""
    from repro_torch.models import transformer as T

    c = tpl.engine.counters

    def step(fn):
        q0, d0 = c["quantize_calls"], c["dequantize_calls"]
        res = fn()
        if islands is not None:
            islands.append((c["quantize_calls"] - q0, c["dequantize_calls"] - d0))
        return res

    s, gen = prompts.shape[1], stream.shape[1]
    logits, cache = step(lambda: T.prefill(tpl, cfg, params, prompts, ctx=ctx,
                                           cache_len=s + gen, policy=policy))
    if kv_bytes is not None:
        groups = [(f"g{i}", c) for i, c in enumerate(cache["blocks"])]
        groups += [(f"tail{j}", c) for j, c in enumerate(cache["tail"])]
        kv_bytes.update({g: nbytes(c["attn"]["k"], c["attn"]["v"]) for g, c in groups})
    out = [logits.float()]
    for i in range(gen - 1):
        logits, cache = step(lambda: T.decode_step(tpl, cfg, params, stream[:, i:i + 1],
                                                   s + i, cache, policy=policy))
        out.append(logits.float())
    return torch.stack(out, dim=1)


def compare_logits(torch, got, want, *, rel_tol, argmax_min, what, gate=True):
    """``got`` against the plain path's ``want`` on the same stream; with
    ``gate`` False the numbers are returned, not held to the tolerances."""
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = got.argmax(-1) == want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * diff
    res = {"max_abs_diff": diff, "logit_absmax": scale, "rel_diff": diff / scale,
           "rel_tol": rel_tol, "argmax_agreement": float(agree.float().mean()),
           "argmax_min": argmax_min, "decisive_positions": int(decisive.sum()),
           "decisive_agreement": float(agree[decisive].float().mean())
           if bool(decisive.any()) else None}
    res["within_tolerances"] = (bool(torch.isfinite(got).all()) and diff / scale <= rel_tol
                                and res["argmax_agreement"] >= argmax_min
                                and bool(agree[decisive].all()))
    if gate and not res["within_tolerances"]:
        raise AssertionError(f"{what}: logits off the plain path: {res}")
    return res


class ClipProbe:
    """While installed, records per layer the largest share of raws at the
    grid's bounds over every QTensor an engine's ``quant`` / ``matmul``
    returns (``head`` outside the layers), over prefill and decode alike."""

    def __init__(self, eng, T, n_layers: int):
        self.eng, self.T, self.n_layers = eng, T, n_layers
        self.layer, self.shares = "head", {}

    def __enter__(self):
        from repro_torch.core.quantization import QTensor

        def watch(orig):
            def fn(*a, **kw):
                out = orig(*a, **kw)
                if isinstance(out, QTensor):
                    r, f = out.raw, out.fmt
                    share = float(((r == f.raw_max) | (r == f.raw_min)).float().mean())
                    self.shares[self.layer] = max(self.shares.get(self.layer, 0.0), share)
                return out
            return fn

        self.eng.quant = watch(self.eng.quant)
        self.eng.matmul = watch(self.eng.matmul)
        self._run_layer = self.T._run_layer
        count = iter(range(10 ** 6))

        def run_layer(*a, **kw):
            self.layer = f"layer{next(count) % self.n_layers}"
            try:
                return self._run_layer(*a, **kw)
            finally:
                self.layer = "head"

        self.T._run_layer = run_layer
        return self

    def __exit__(self, *exc):
        del self.eng.quant, self.eng.matmul
        self.T._run_layer = self._run_layer


def phase_serving(torch, dev):
    """The serving main path, float and grid-resident; returns the runs for
    the timing phase and the launches of each main-path window."""
    from repro_torch.configs import get_config
    from repro_torch.core.template import default_template
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import CAPTURE_COUNTS
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    cfg = get_config(QWEN_ARCH)
    params = qwen_params(torch, dev, cfg)
    prompts = synthetic_batch(SEED, 0, QWEN_PROMPTS, QWEN_PROMPT_LEN, cfg.vocab, device=dev)
    tq = default_template("q16")
    t0 = time.perf_counter()
    cal = synthetic_batch(SEED + 1, 7, 2, QWEN_PROMPT_LEN, cfg.vocab, device=dev)
    policy = T.calibrate_policy(tq, cfg, params, cal)
    qp = T.quantize_params(tq, cfg, params, policy)
    torch.cuda.synchronize()
    q8, q8_all = phase_serving_dse(torch, tq, cfg, params, cal, policy)
    emit({"phase": "serving_setup", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": f"{cfg.n_heads} padded to {cfg.eff_heads}",
          "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab, "dtype": cfg.dtype,
          "prompts": QWEN_PROMPTS, "prompt_len": QWEN_PROMPT_LEN, "gen": QWEN_GEN,
          "calibrated_fmt": policy.fmt.name, "calibrate_and_quantize_s":
          time.perf_counter() - t0,
          "int16_weight_fmts": sorted({v.fmt.name for v in _qleaves(qp)})})
    tf = default_template("cuda")
    tplain = default_template("torch")
    per_prefill = {"matmul_fp": 7 * cfg.n_layers + 1}
    runs, windows, kv = [], {}, {}
    q8_runs = (("q8", tq, q8),) + ((("q8 all-int8", tq, q8_all),)
                                   if q8_all is not None and q8_all != q8 else ())
    for numerics, tpl, pol in (("float", tf, None), ("grid " + policy.fmt.name, tq, policy),
                               *q8_runs):
        kernel = "matmul_fp" if pol is None else "matmul_q16"
        _build.reset_launches()
        caps0 = sum(CAPTURE_COUNTS.values())
        stream = generate(cfg, params, prompts, gen=QWEN_GEN, tpl=tpl, policy=pol)
        torch.cuda.synchronize()
        # generate's decode steps replay a CUDA graph; its capture ran one
        # eager warm-up step, whose launches count as any other's
        captures = sum(CAPTURE_COUNTS.values()) - caps0
        launches = dict(_build.launches)
        windows[numerics] = launches
        emit({"phase": "serving_launches", "numerics": numerics,
              "decode_graph_captures": captures, **launches})
        if numerics.startswith("q8") and captures != 1:  # a new (int8) cache signature
            raise AssertionError(f"{numerics}: {captures} decode graph captures, want 1")
        # flash once a layer a prefill, on route wgmma with its preparation
        # (head dim 64), never in decode
        want = {"flash_attention": cfg.n_layers, "flash_attention.wgmma": cfg.n_layers,
                "flash_attention.prep": cfg.n_layers, "flash_attention.simt": 0,
                kernel: (QWEN_GEN + captures) * per_prefill["matmul_fp"]}
        if pol is None:
            # the prefill's 7 GEMMs a layer (m = 4 x 4096, bf16) on the tensor
            # cores; its head (m = 4) and every decode GEMM stream on split-k
            want.update({"matmul_fp.wgmma": 7 * cfg.n_layers,
                         "matmul_fp.splitk": want[kernel] - 7 * cfg.n_layers,
                         "matmul_fp.tile": 0, "matmul_q16": 0})
        else:
            # the grid-resident path never reaches the float GEMM; its
            # prefill's 7 GEMMs a layer (m = 4 x 4096, int16) run on the q16
            # GEMM's tensor cores, each after a preparation launch; its head
            # (m = 4) and every decode GEMM stream on split-k
            want.update({"matmul_fp": 0, "matmul_q16.wgmma": 7 * cfg.n_layers,
                         "matmul_q16.prep": 7 * cfg.n_layers,
                         "matmul_q16.splitk": want[kernel] - 7 * cfg.n_layers,
                         "matmul_q16.tile": 0})
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{numerics}: {name} launched {launches[name]} times, "
                                     f"want {n} (flash once per layer per prefill on "
                                     f"route wgmma, never in decode; GEMMs by route)")
        assert stream.shape == (QWEN_PROMPTS, QWEN_GEN)
        # replay the stream teacher-forced through the same kernels (and, on
        # the grid, count islands and clipped raws), then through the plain path
        tree = params if pol is None else T.quantize_params(tpl, cfg, params, pol)
        eng = tpl.engine
        islands = []
        kv[numerics] = {}
        with ClipProbe(eng, T, cfg.n_layers) as probe:
            got = teacher_forced(torch, tpl, cfg, tree, prompts, stream, pol, islands,
                                 kv[numerics])
        if not torch.equal(got.argmax(-1), stream):
            raise AssertionError(f"{numerics}: the teacher-forced replay does not "
                                 f"reproduce generate's greedy tokens")
        extra = {}
        if pol is not None:
            law_p = T.q16_island_counts(cfg, mode="prefill")
            law_d = T.q16_island_counts(cfg, mode="decode")
            law = [(law_p["quantize"], law_p["dequantize"])]
            law += [(law_d["quantize"], law_d["dequantize"])] * (QWEN_GEN - 1)
            if islands != law:
                raise AssertionError(f"island counts per step {islands} != "
                                     f"q16_island_counts {law}")
            seen = {"prefill": islands[0], "each decode step": sorted(set(islands[1:]))}
            worst = max(probe.shares.values())
            if worst > MAX_CLIPPED_SHARE:
                raise AssertionError(f"{numerics}: raws at the grid's bounds: "
                                     f"{probe.shares}")
            extra = {"island_counts": seen, "island_law_prefill": law_p,
                     "island_law_decode": law_d, "clipped_share_by_layer": probe.shares,
                     "kv_cache_bytes": kv[numerics]}
        if numerics.startswith("q8"):
            # each int8 group's k / v take exactly half the grid run's bytes
            grid = kv["grid " + policy.fmt.name]
            want_kv = {g: b // 2 if pol.fmt_for(g).total_bits == 8 else b
                       for g, b in grid.items()}
            if kv[numerics] != want_kv:
                raise AssertionError(f"q8 cache bytes {kv[numerics]}, want {want_kv}")
            extra["plan"] = {n: f.name for n, f in pol.layer_fmts}
        plain = teacher_forced(torch, tplain, cfg, params, prompts, stream)
        res = compare_logits(
            torch, got, plain, what=numerics,
            rel_tol=FLOAT_REL_TOL if pol is None else Q16_REL_TOL,
            argmax_min=FLOAT_ARGMAX if pol is None else Q16_ARGMAX,
            # the all-int8 plan is the one the DSE rejects at these gates:
            # its distance from the float model is measured, not held
            gate=numerics != "q8 all-int8")
        emit({"phase": "serving_check", "numerics": numerics,
              "vs": "torch backend, float, same stream", **res, **extra,
              "sample_tokens": stream[0, :8].tolist()})
        del got, plain
        runs.append((numerics, tpl, pol))
    return cfg, params, prompts, runs, windows


def phase_serving_dse(torch, tq, cfg, params, cal, policy):
    """The precision DSE over qwen2-0.5b's groups ("g0": every layer, and
    "head") on the card, on the calibration batch ``cal``.

    1. ``calibrate_precision`` cold at ``DSE_BUDGET`` with its default
       reference, as ``serve --backend q8`` runs it: the per-op q16 forward
       of the float weights on the q16 template.  At qwen2's width that
       forward's fixed Q2.14 grid saturates, so its argmax says little and
       no group meets the budget; the budget-0.0 plan on the same drifts
       (every group and every layer's KV cache on the int8 rung) is printed
       beside it.
    2. Where that plan keeps every group on int16 (it is then the grid
       run), the plan streamed under the gates is the DSE at the stream
       gate's own budget (``Q16_ARGMAX``) against the float model (``ref``:
       the argmax of the plain backend's forward), which must put at least
       the head on the int8 rung.

    Returns (the streamed plan, the budget-0.0 plan or None); the caller
    also streams the second, every GEMM int8 x int8 and the KV cache int8,
    and holds it to every gate but the logits'.

    Every plan is printed with its argmax agreement and max |Δlogit| against
    the float model on ``cal``, and the peak memory the probe trees reach
    (each probe's tree is released)."""
    from repro_torch.core.template import default_template
    from repro_torch.core.tiling import H100
    from repro_torch.models import transformer as T

    reg = tq.engine.plan_cache
    names = T.precision_group_names(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    plain = T.forward(default_template("torch"), cfg, params, cal)[0].float()
    plain_ref, scale = plain.argmax(-1), float(plain.abs().max())

    def versus_float(pol):
        qp = T.quantize_params(tq, cfg, params, pol)
        lg = T.forward(tq, cfg, qp, cal, policy=pol)[0]
        tq.engine.drop_qparams(params, pol)
        return {"argmax_agreement": float((lg.argmax(-1) == plain_ref).float().mean()),
                "rel_diff": float((lg - plain).abs().max()) / scale}

    def run(label, budget, **kw):
        reg.clear()  # drop the last run's pins (and the GEMM plans, re-planned on use)
        t0 = time.perf_counter()
        pol = T.calibrate_precision(tq, cfg, params, cal, budget=budget, policy=policy, **kw)
        torch.cuda.synchronize()
        out = {"budget": budget, "cold_s": time.perf_counter() - t0,
               "drift": {n: reg.precision_for(cfg.name, n, H100).drift for n in names},
               "plan": {n: f.name for n, f in pol.layer_fmts}, "vs_float": versus_float(pol)}
        plans[label] = out
        return pol, out["drift"]

    plans, all8 = {}, None
    chosen, drift = run(f"{DSE_BUDGET}, default ref", DSE_BUDGET)
    if not any(f.total_bits == 8 for _, f in chosen.layer_fmts):
        all8, _ = run("0.0, same drifts", 0.0, drift=drift)
        chosen, _ = run(f"{Q16_ARGMAX} vs float", Q16_ARGMAX, ref=plain_ref)
        if chosen.fmt_for("head").total_bits != 8:
            raise AssertionError(f"the DSE at {Q16_ARGMAX} against the float model keeps "
                                 f"the head on int16: {plans}")
    torch.cuda.synchronize()
    emit({"phase": "serving_dse", "arch": cfg.name, "groups": names,
          "calibration_tokens": list(cal.shape), "base": policy.fmt.name, "plans": plans,
          "streamed": {n: f.name for n, f in chosen.layer_fmts},
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "resident_bytes_before": resident})
    del plain
    return chosen, all8


def _qleaves(tree):
    from repro_torch.core.quantization import QTensor

    if isinstance(tree, QTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _qleaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _qleaves(v)


def profile_window(torch, fn, *, groups=("flash_attention_prep", "flash_attention",
                                         "q16wg::prep_kernel", "q16_wgmma_kernel",
                                         "wgmma_kernel", "splitk", "split_reduce",
                                         "gemm_kernel"),
                   host_ops: bool = False) -> dict:
    """``fn`` once under ``torch.profiler``: its wall time, the device's
    busy time and share of it, device time by group (kernels whose name
    holds the group's name; "other" is everything else, the PS-plane ops)
    and the top kernels; with ``host_ops`` also the host ops with the most
    self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.split("(")[0][:90]
            us, n = by_name.get(name, (0.0, 0))
            by_name[name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    by_group = dict.fromkeys((*groups, "other"), 0.0)
    for name, (us, _) in by_name.items():
        by_group[next((g for g in groups if g in name), "other")] += us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy_ms if by_name else "not measured",
           "device_busy_share": busy_ms / wall_ms if by_name else "not measured",
           "device_ms_by_group": by_group,
           "device_launches": sum(n for _, n in by_name.values()),
           "top_kernels": [{"name": k, "ms": us / 1e3, "calls": n} for k, (us, n) in top]}
    if host_ops:
        avg = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
        out["top_host_ops"] = [{"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                                "calls": e.count} for e in avg]
    return out


def phase_serving_timing(torch, cfg, params, prompts, runs):
    """Prefill tokens/s, decode ms/step and peak memory (CUDA events after
    warm-up), then the device time by kernel of one prefill and of four
    decode steps (``torch.profiler``)."""
    from repro_torch.launch.scheduler import CAPTURE_COUNTS, compiled_steps
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    s = prompts.shape[1]
    emit({"phase": "clocks_before_serving_timing", "nvidia_smi": smi_clocks()})
    prefill_profiles = {}
    for numerics, tpl, pol in runs:
        caps0 = sum(CAPTURE_COUNTS.values())
        tree = params if pol is None else T.quantize_params(tpl, cfg, params, pol)
        clen = s + QWEN_GEN
        prefill = (lambda: T.prefill(tpl, cfg, tree, prompts, cache_len=clen, policy=pol))
        prefill_ms = time_ms(prefill, target_ms=1.0)
        _, cache = prefill()
        tok = prompts[:, -1:]

        def decode(n=QWEN_GEN - 1):
            c = cache
            for i in range(n):
                _, c = T.decode_step(tpl, cfg, tree, tok, s + i, c, policy=pol)

        # the q8 runs are timed through compiled_steps only, as serve runs
        # them: their eager steps are the grid's code on other raws
        eager = not numerics.startswith("q8")
        decode_ms = time_ms(decode, target_ms=1.0) / (QWEN_GEN - 1) if eager else None
        # the same steps through compiled_steps: one CUDA graph replay each
        fns = compiled_steps(tpl, cfg, clen, pol)
        _, _, cache_g = fns.decode_next(tree, tok, s, cache)

        def decode_graph(n=QWEN_GEN - 1):
            for i in range(n):
                fns.decode_next(tree, tok, s + i, cache_g)

        decode_graph_ms = time_ms(decode_graph, target_ms=1.0) / (QWEN_GEN - 1)
        del cache, cache_g
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        generate(cfg, params, prompts, gen=QWEN_GEN, tpl=tpl, policy=pol)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        captures = sum(CAPTURE_COUNTS.values()) - caps0
        if numerics.startswith("q8") and captures:  # phase 5's capture serves every call
            raise AssertionError(f"q8: {captures} more decode graph captures while timing")
        emit({"phase": "serving_time", "numerics": numerics, "prompts": QWEN_PROMPTS,
              "prompt_len": s, "gen": QWEN_GEN, "prefill_ms": prefill_ms,
              "prefill_tokens_per_s": QWEN_PROMPTS * s / prefill_ms * 1e3,
              "decode_ms_per_step": decode_ms,
              "decode_tokens_per_s": QWEN_PROMPTS / decode_ms * 1e3 if eager else None,
              "decode_ms_per_step_graph": decode_graph_ms,
              "decode_tokens_per_s_graph": QWEN_PROMPTS / decode_graph_ms * 1e3,
              "generate_s_host_clock": gen_s, "peak_mem_bytes": peak,
              "resident_bytes_before": resident, "graph_captures": captures})

        _, cache = prefill()
        torch.cuda.synchronize()
        prefill_profiles[numerics] = profile_window(torch, prefill)
        emit({"phase": "serving_profile", "numerics": numerics, "window": "one prefill",
              **prefill_profiles[numerics]})

        def decode4():
            c = cache
            for i in range(4):
                _, c = T.decode_step(tpl, cfg, tree, tok, s + i, c, policy=pol)

        if eager:
            emit({"phase": "serving_profile", "numerics": numerics,
                  "window": "4 decode steps", **profile_window(torch, decode4, host_ops=True)})
        del cache
    emit({"phase": "clocks_after_serving_timing", "nvidia_smi": smi_clocks()})
    return prefill_profiles


# ---------------------------------------------------------------------------
# phase 6: the serve scheduler (qwen2-0.5b), a CUDA graph per decode step
# ---------------------------------------------------------------------------


def sched_trace(cfg, n: int, *, seed: int = SEED):
    """``synthetic_trace`` over the phase's ladder: prompt lengths from 64 to
    4096, budgets from 8 to 32; half the requests at t = 0, the rest in four
    bursts."""
    from repro_torch.launch.scheduler import synthetic_trace

    trace = synthetic_trace(n, seed=seed, vocab=cfg.vocab, ladder=SCHED_LADDER,
                            max_new=SCHED_MAX_NEW, min_len=SCHED_MIN_LEN,
                            min_new=SCHED_MIN_NEW)
    half = n // 2
    for i, r in enumerate(trace):
        r.arrival = 0.0 if i < half else SCHED_BURST_S * (1 + (i - half) * 4 // (n - half))
    return trace


def slot_state(torch, sched, tree):
    """A slot cache in mid-serve: every slot prefilled (one launch on the
    smallest rung) to its own length, lane 2 off; with the step's tokens and
    positions."""
    from repro_torch.models import transformer as T

    slots, dev = sched.sched.slots, sched.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rung = min(SCHED_LADDER)
    toks = torch.randint(0, sched.cfg.vocab, (slots, rung), generator=gen, device=dev)
    lens = (torch.arange(slots, device=dev) + 1) * rung // (slots + 1)
    _, rows = sched._prefill(tree, toks, None, lens - 1)
    cache = T.insert_cache_rows(sched._make_cache(), rows, src_rows=torch.arange(slots),
                                sel=torch.ones(slots, dtype=torch.bool), valid_lens=lens)
    del rows
    tvec = lens.clone()
    tvec[2] = -1
    tok = torch.randint(0, sched.cfg.vocab, (slots, 1), generator=gen, device=dev)
    return cache, tok, tvec


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_tree(v) for v in tree)
    return tree.clone()


def _tree_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return all(_tree_equal(torch, a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_tree_equal(torch, x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def check_streams(torch, sched, tree, logits_of, trace, *, rel_tol, what):
    """Each request's scheduler stream against the port's unbatched path
    (``compiled_steps``' prefill and graph decode at batch 1), teacher-forced
    on that stream: max |Δlogit| <= ``rel_tol`` of the logit scale, and
    wherever the unbatched argmax differs from the scheduler's token, the
    unbatched top-2 margin <= 2·max |Δlogit|.  Returns the summary."""
    from repro_torch.launch.scheduler import compiled_steps

    fns = compiled_steps(sched.tpl, sched.cfg, sched.cache_len, sched.policy)
    identical, worst, flips = 0, 0.0, []
    for r in trace:
        stream = r.generated
        got = torch.stack(logits_of[r.rid]).float()
        prompt = torch.tensor([r.prompt], device=sched.device)
        s = prompt.shape[1]
        lg, cache = fns.prefill(tree, prompt, None, None)
        want = [lg.to(torch.float32, copy=True)]
        for i in range(len(stream) - 1):
            tok = torch.tensor([[stream[i]]], device=sched.device)
            _, lg, cache = fns.decode_next(tree, tok, s + i, cache)
            # the step's logits buffer is rewritten by its next replay
            want.append(lg.to(torch.float32, copy=True))
        want = torch.cat(want)
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        differ = want.argmax(-1).cpu() != torch.tensor(stream)
        if not (bool(torch.isfinite(got).all()) and diff / scale <= rel_tol):
            # which side moved: the same stream through the eager unbatched steps
            from repro_torch.models import transformer as T

            lg, cache = T.prefill(sched.tpl, sched.cfg, tree, prompt,
                                  cache_len=sched.cache_len, policy=sched.policy)
            eager = [lg.float()]
            for i in range(len(stream) - 1):
                lg, cache = T.decode_step(sched.tpl, sched.cfg, tree,
                                          torch.tensor([[stream[i]]], device=sched.device),
                                          s + i, cache, policy=sched.policy)
                eager.append(lg.float())
            eager = torch.cat(eager)
            raise AssertionError(
                f"{what}: rid {r.rid} (prompt {s}, slots {r.slot_history}) logits off the "
                f"unbatched path: max |Δ| {diff} of scale {scale}; by step, scheduler - "
                f"graph {(got - want).abs().amax(-1).tolist()}, scheduler - eager "
                f"{(got - eager).abs().amax(-1).tolist()}, graph - eager "
                f"{(want - eager).abs().amax(-1).tolist()}")
        for i in differ.nonzero().flatten().tolist():
            if float(margin[i]) > 2 * diff:
                raise AssertionError(f"{what}: rid {r.rid} step {i}: token "
                                     f"{stream[i]} against {int(want[i].argmax())} at a "
                                     f"top-2 margin {float(margin[i])} > 2·{diff}")
            flips.append({"rid": r.rid, "step": i, "margin": float(margin[i]),
                          "max_abs_diff": diff})
        identical += int(not bool(differ.any()))
        worst = max(worst, diff / scale)
    return {"streams": len(trace), "byte_identical_streams": identical,
            "worst_rel_diff": worst, "rel_tol": rel_tol, "token_flips": flips[:8],
            "n_token_flips": len(flips)}


def phase_scheduler(torch, cfg, params, runs):
    """The serve scheduler on qwen2-0.5b at full width and depth, float and
    grid-resident: warm-up, graph = eager bit for bit, a bursty 24-request
    trace (every request completes, no slot leaks, no DSE search and no
    capture after warm-up, launches by route counted through the graph
    replays), each stream against the unbatched path, then eager against
    graph decode times, the busy share of a replayed step, tokens/s, TTFT and
    peak memory; and a shorter chunked-prefill run.  Returns the launch
    windows."""
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import (
        CAPTURE_COUNTS,
        SchedulerConfig,
        ServeScheduler,
        SystemClock,
        compiled_steps,
        replay_trace,
    )
    from repro_torch.models import transformer as T

    windows = {}
    L = cfg.n_layers
    for numerics, tpl, pol in runs:
        kernel = "matmul_fp" if pol is None else "matmul_q16"
        rel_tol = FLOAT_REL_TOL if pol is None else Q16_REL_TOL
        t0 = time.perf_counter()
        sched = ServeScheduler(cfg, params, tpl=tpl, policy=pol, clock=SystemClock(),
                               sched=SchedulerConfig(ladder=SCHED_LADDER, slots=SCHED_SLOTS,
                                                     max_new_limit=SCHED_MAX_NEW))
        tree = sched.exec_params
        sched.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        fns = compiled_steps(tpl, cfg, sched.cache_len, sched.policy)
        misses0 = sched.registry.misses

        # gate 1: a replay of the captured step and the eager step, at the
        # same 8-slot state and inputs: the same logits and cache, bit for
        # bit.  These calls are anonymous (no owner): they capture a graph
        # of their own, beside the scheduler's, released before the trace
        cache, tok, tvec = slot_state(torch, sched, tree)
        lg_e, c_e = T.decode_step(tpl, cfg, tree, tok, tvec, cache, policy=sched.policy)
        _, lg_g, c_g = fns.decode_next(tree, tok, tvec, _clone_tree(cache))
        torch.cuda.synchronize()
        if not (torch.equal(lg_e, lg_g) and _tree_equal(torch, c_e, c_g)):
            raise AssertionError(f"{numerics}: the graph replay differs from the eager "
                                 f"decode step: max |Δlogit| "
                                 f"{float((lg_e.float() - lg_g.float()).abs().max())}")
        # decode ms per step at 8 slots: eager against replay (the replay fed
        # host arrays, as the scheduler feeds it)
        tok_np, t_np = tok.cpu().numpy(), tvec.cpu().numpy()
        eager_ms = time_ms(lambda: T.decode_step(tpl, cfg, tree, tok, tvec, cache,
                                                 policy=sched.policy), target_ms=300.0)
        graph_ms = time_ms(lambda: fns.decode_next(tree, tok_np, t_np, c_g), target_ms=300.0)
        prof = profile_window(torch, lambda: fns.decode_next(tree, tok_np, t_np, c_g))
        if isinstance(prof.get("device_busy_ms"), float):
            prof["device_busy_share_of_event_time"] = prof["device_busy_ms"] / graph_ms
        del cache, c_e, c_g, lg_e
        fns.decode_next.release(None)
        torch.cuda.empty_cache()
        caps0 = dict(CAPTURE_COUNTS)

        # the trace, through the replayed graph
        trace = sched_trace(cfg, SCHED_REQUESTS)
        n_long = sum(len(r.prompt) > SCHED_LADDER[1] for r in trace)
        assert n_long >= 2, f"the trace has {n_long} prompts on the top rung"
        logits_of = {r.rid: [] for r in trace}
        sched.logit_sink = lambda r, row: logits_of[r.rid].append(row.float().clone())
        ticks = []
        step = sched.step

        def timed_step():  # each tick ends in a read of the device
            t1 = time.perf_counter()
            ev = step()
            ticks.append((time.perf_counter() - t1, ev))
            return ev

        sched.step = timed_step
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = sched.clock.now()
        stats = replay_trace(sched, trace, tick=0.0)
        torch.cuda.synchronize()
        wall_s = sched.clock.now() - t0
        del sched.step
        pre = [dt for dt, ev in ticks if ev and ev["prefill_launches"]]
        dec = [dt for dt, ev in ticks if ev and not ev["prefill_launches"]]
        ticks_line = {"ticks": len(ticks), "prefill_ticks": len(pre),
                      "prefill_ticks_s": sum(pre), "decode_only_ticks": len(dec),
                      "decode_only_ticks_s": sum(dec),
                      "decode_only_tick_ms_mean": 1e3 * sum(dec) / max(len(dec), 1),
                      "idle_s": wall_s - sum(pre) - sum(dec)}
        peak = torch.cuda.max_memory_allocated()
        launches = dict(_build.launches)
        windows[f"scheduler {numerics}"] = launches
        c = sched.counters
        if not (c["completed"] == len(trace) == len(sched.results) and not sched.active
                and not sched.queue and sched._free == list(range(SCHED_SLOTS))):
            raise AssertionError(f"{numerics}: the trace did not complete cleanly: "
                                 f"{dict(c)}, free slots {sched._free}")
        if sched.registry.misses != misses0 or dict(CAPTURE_COUNTS) != caps0:
            raise AssertionError(f"{numerics}: the warm trace planned "
                                 f"{sched.registry.misses - misses0} GEMMs / recaptured "
                                 f"({dict(CAPTURE_COUNTS)} vs {caps0})")
        n_pre, n_dec = c["prefill_launches"], c["decode_steps"]
        n4096 = sched.bucket_stats[max(SCHED_LADDER)]["launches"]
        want = {f"{kernel}.splitk": (7 * L + 1) * n_dec + n_pre,  # decode + every head
                f"{kernel}.wgmma": 7 * L * n_pre, f"{kernel}.tile": 0,
                "matmul_fp.tile": 0, "matmul_q16.tile": 0,
                "flash_attention.wgmma": L * n4096, "flash_attention.simt": 0}
        if pol is not None:
            want["matmul_fp"] = 0
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{numerics} scheduler: {name} launched "
                                     f"{launches[name]} times, want {n} ({n_dec} decode "
                                     f"steps, {n_pre} prefill launches, {n4096} on 4096)")
        sched.logit_sink = None
        check = check_streams(torch, sched, tree, logits_of, trace, rel_tol=rel_tol,
                              what=f"{numerics} scheduler")
        del logits_of
        emit({"phase": "scheduler", "numerics": numerics, "nvidia_smi": nvidia_smi(),
              "slots": SCHED_SLOTS, "ladder": SCHED_LADDER, "cache_len": sched.cache_len,
              "requests": len(trace), "prompts_on_the_top_rung": n_long,
              "warmup_s": warmup_s, "graph_equals_eager": True,
              "decode_ms_per_step_eager": eager_ms, "decode_ms_per_step_graph": graph_ms,
              "graph_speedup": eager_ms / graph_ms,
              "replayed_step_profile": prof, "trace_wall_s": wall_s,
              "trace_ticks_host_clock": ticks_line,
              "generated_tokens": c["tokens"], "tokens_per_s": c["tokens"] / wall_s,
              "ttft_s": stats["ttft"], "mean_occupancy": stats["mean_occupancy"],
              "prefill_launches": n_pre, "prefill_launches_4096": n4096,
              "decode_steps": n_dec, "peak_mem_bytes": peak,
              "new_dse_searches": 0, "recaptures": 0, "vs_unbatched": check,
              "stats_line": sched.stats_line()})
        if pol is None:
            windows["scheduler chunked"] = phase_scheduler_chunked(torch, cfg, params, tpl)
        del sched, fns
        torch.cuda.empty_cache()
    return windows


def phase_scheduler_chunked(torch, cfg, params, tpl):
    """A shorter run with ``prefill_chunk``: long prompts stream into their
    slots chunk by chunk beside decode; every stream held to the unbatched
    path as in the main run."""
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import (
        SchedulerConfig,
        ServeScheduler,
        SystemClock,
        replay_trace,
    )

    sched = ServeScheduler(cfg, params, tpl=tpl, clock=SystemClock(),
                           sched=SchedulerConfig(ladder=SCHED_LADDER, slots=SCHED_SLOTS,
                                                 max_new_limit=SCHED_MAX_NEW,
                                                 prefill_chunk=SCHED_CHUNK))
    sched.warmup()
    trace = sched_trace(cfg, SCHED_CHUNK_REQUESTS, seed=SEED + 1)
    logits_of = {r.rid: [] for r in trace}
    sched.logit_sink = lambda r, row: logits_of[r.rid].append(row.float().clone())
    _build.reset_launches()
    t0 = sched.clock.now()
    replay_trace(sched, trace, tick=0.0)
    torch.cuda.synchronize()
    wall_s = sched.clock.now() - t0
    launches = dict(_build.launches)
    c = sched.counters
    if c["completed"] != len(trace) or c["chunk_steps"] == 0:
        raise AssertionError(f"chunked scheduler: {dict(c)}")
    sched.logit_sink = None
    check = check_streams(torch, sched, sched.exec_params, logits_of, trace,
                          rel_tol=FLOAT_REL_TOL, what="chunked scheduler")
    emit({"phase": "scheduler_chunked", "numerics": "float", "prefill_chunk": SCHED_CHUNK,
          "requests": len(trace), "prompt_lens": [len(r.prompt) for r in trace],
          "chunk_steps": c["chunk_steps"], "decode_steps": c["decode_steps"],
          "prefill_launches": c["prefill_launches"], "trace_wall_s": wall_s,
          "tokens_per_s": c["tokens"] / wall_s, "ttft_s": sched.stats()["ttft"],
          "vs_unbatched": check})
    return launches


def phase_serve_cli(torch):
    """``serve.main`` at the reference's reduced CLI size, on the card: the
    default backend, then ``--backend q8`` (the precision DSE at budget 0.5)
    through ``generate`` and through the scheduler; the second q8 run replays
    the first one's pins (no precision search)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.engine import plan_cache_for
    from repro_torch.core.tiling import H100
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    size = ["--prompts", "2", "--prompt-len", "8", "--gen", "3"]
    q8 = ["--backend", "q8", "--precision-budget", "0.5"]
    reg = plan_cache_for(H100)
    cfg = reduced(get_config(QWEN_ARCH))
    for argv in (size, q8 + size, q8 + ["--scheduler"] + size):
        t0 = time.perf_counter()
        st0 = reg.stats()
        out = serve.main(argv)
        st = reg.stats()
        if argv[0] == "--backend":
            assert len(out) == 2 and all(len(row) == 3 for row in out), out
            # every group of the reduced config pinned from a drift sweep
            pinned = reg.precision_plan(cfg.name, H100)
            assert set(pinned) == set(T.precision_group_names(cfg)), pinned
        else:
            assert out.shape == (2, 3) and out.device.type == "cuda"
        emit({"phase": "serve_cli", "argv": " ".join(argv),
              "tokens": [list(map(int, row)) for row in out],
              "registry": {k: st[k] - st0[k] for k in ("hits", "misses")},
              "precision_pins": st["precision"], "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phase 7: the serving fleet (plan store, measured pins, replica router)
# ---------------------------------------------------------------------------

#: phase 7a: (label, kernel, m, n, k, widths, candidates) at qwen2-0.5b's
#: gate / up: decode (4 rows) over route splitk's slices, the float prefill
#: (4 x 4096 rows) over both wgmma tiles
PIN_CASES = (
    ("float decode gate/up", "matmul_fp", 4, 4864, 896, {"dtype_bytes": 2}, 5),
    ("float prefill gate/up", "matmul_fp", 16384, 4864, 896, {"dtype_bytes": 2}, 2),
    ("grid decode gate/up int16", "matmul_q16", 4, 4864, 896, {"xbits": 16, "wbits": 16}, 5),
)
PIN_REPS = 20
FLEET_REPLICAS = 2
FLEET_SLOTS = 4
FLEET_LADDER = (256, 512, 1024)
FLEET_REQUESTS = 16
#: prompts 64-900 tokens, budgets 8-24: prompt + generated fits the top rung
#: on a resume
FLEET_TRACE_LADDER = (256, 512, 900)
FLEET_MAX_NEW = 24
FLEET_MIN_NEW = 8
FLEET_KILL_TICK = 3
FLEET_CHECKPOINT_EVERY = 2
FLEET_STORE_SAVE_EVERY = 4
#: replica 1's store save due at tick 4 lands two ticks late
FLEET_DELAYED_SAVE = (1, 4, 2)


def phase_measure_and_pin(torch, dev):
    """``measure_and_pin`` on the H100 spec at gate / up: every candidate
    timed (CUDA events, the hand-written kernel on its route), the analytic
    plan's time beside the pinned plan; the store saved, reloaded into a
    fresh registry, and the next call launching the pinned plan."""
    import tempfile

    from repro_torch.core.engine import Engine, PlanRegistry
    from repro_torch.core.quantization import Q2_14, QTensor
    from repro_torch.core.template import TemplateConfig
    from repro_torch.core.tiling import H100
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for label, kernel, m, n, k, widths, top in PIN_CASES:
            reg = PlanRegistry()
            analytic = reg.block_for(m, n, k, H100, kernel=kernel, **widths)
            pinned = reg.measure_and_pin(m, n, k, H100, kernel=kernel, top_k=top,
                                         reps=PIN_REPS, device=dev, **widths)
            timed = reg.last_measurement
            if timed[0][0] != analytic or len(timed) != top:
                raise AssertionError(f"{label}: candidates {timed} do not start at the "
                                     f"analytic plan {analytic}")
            path = f"{tmp}/pins.json"
            reg.save(path)
            warm = PlanRegistry()
            warm.load(path)
            if warm.source_for(m, n, k, H100, kernel=kernel, **widths) != "measured":
                raise AssertionError(f"{label}: the pin did not come back measured")
            eng = Engine(TemplateConfig(backend="cuda" if kernel == "matmul_fp" else "q16"),
                         plan_cache=warm)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            _build.reset_launches()
            if kernel == "matmul_fp":
                x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
                eng.matmul(x, w)
            else:
                x = torch.randint(-4096, 4096, (m, k), generator=gen, device=dev,
                                  dtype=torch.int16)
                w = torch.randint(-4096, 4096, (k, n), generator=gen, device=dev,
                                  dtype=torch.int16)
                eng.matmul(QTensor(x, Q2_14), QTensor(w, Q2_14))
            torch.cuda.synchronize()
            want = {f"{kernel}.{pinned.route}": 1,
                    f"{kernel}.splitk_reduce": int(pinned.route == "splitk"
                                                   and pinned.splits > 1)}
            got = {name: _build.launches[name] for name in want}
            if got != want or warm.misses != 0:
                raise AssertionError(f"{label}: the reloaded pin launched {got}, want "
                                     f"{want} ({warm.misses} searches)")
            rows.append({"case": label, "kernel": kernel, "shape": [m, n, k], **widths,
                         "candidates": [{"plan": _plan(b), "ms": 1e3 * s} for b, s in timed],
                         "analytic": _plan(analytic), "analytic_ms": 1e3 * timed[0][1],
                         "pinned": _plan(pinned),
                         "pinned_ms": 1e3 * min(s for _, s in timed),
                         "reloaded_launch": got})
    seconds = time.perf_counter() - t0
    emit({"phase": "measure_and_pin", "nvidia_smi": nvidia_smi(), "reps": PIN_REPS,
          "rows": rows, "seconds": seconds})


def fleet_trace(cfg):
    """Phase 7b's trace, all at t = 0, with the same rids (0..n-1) each call,
    so that runs compare session by session."""
    from repro_torch.launch.scheduler import synthetic_trace

    trace = synthetic_trace(FLEET_REQUESTS, seed=SEED, vocab=cfg.vocab,
                            ladder=FLEET_TRACE_LADDER, max_new=FLEET_MAX_NEW,
                            min_len=SCHED_MIN_LEN, min_new=FLEET_MIN_NEW)
    for i, r in enumerate(trace):
        r.rid = i
    return trace


def _fleet_router(cfg, params, tpl, pol, n, **kw):
    from repro_torch.launch.router import ReplicaRouter
    from repro_torch.launch.scheduler import SchedulerConfig, ServeScheduler, VirtualClock

    def make(rid, clock):
        return ServeScheduler(cfg, params, tpl=tpl, policy=pol, clock=clock,
                              sched=SchedulerConfig(ladder=FLEET_LADDER, slots=FLEET_SLOTS,
                                                    max_new_limit=FLEET_MAX_NEW))

    return ReplicaRouter(make, n, clock=VirtualClock(), **kw)


def _fleet_run(torch, router, trace):
    t0 = time.perf_counter()
    router.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(s) for s in router.ledger.as_dict().values())
    return {"ticks": router.tick_index, "wall_s": wall, "tokens": tokens,
            "tokens_per_s": tokens / wall}


def phase_fleet(torch, cfg, params, tpl, pol):
    """The in-process fleet on qwen2-0.5b at full width and depth on the
    grid: a one-replica fault-free run (the ledger to hold), a two-replica
    fault-free run (the restart's cost), then two replicas with replica 0
    killed mid-decode, checkpoints every two ticks, a restart a tick later
    and periodic store saves with one delayed.  Gates: the ledger equals the
    one-replica run's and every session was served exactly once; a session
    was restored from a checkpoint; no DSE search after the first warm-up;
    no capture but the restarted incarnation's warm-up; the kill releases
    the dead incarnation's device memory and the peak after the restart
    stays within one replica's cache and graph of the peak before it; the
    store loads.  Returns the killed run's launch window."""
    import tempfile

    from repro_torch.core.engine import PlanRegistry
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import CAPTURE_COUNTS
    from repro_torch.runtime.failover import FaultPlan

    t_phase = time.perf_counter()
    reg = tpl.engine.plan_cache
    ref = _fleet_router(cfg, params, tpl, pol, 1)
    misses0 = reg.misses  # the first warm-up planned everything
    one = _fleet_run(torch, ref, fleet_trace(cfg))
    want = ref.ledger.as_dict()
    ref.replicas[0].sched.release()
    del ref
    torch.cuda.empty_cache()
    two = _fleet_router(cfg, params, tpl, pol, FLEET_REPLICAS)
    clean = _fleet_run(torch, two, fleet_trace(cfg))
    two.verify_against(want)
    for rep in two.replicas:
        rep.sched.release()
    del two
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        store = f"{tmp}/fleet_store.json"
        mem0 = torch.cuda.memory_allocated()
        # the level before the kill includes the replicas' warm-ups, as the
        # level after the restart includes the new incarnation's
        torch.cuda.reset_peak_memory_stats()
        router = _fleet_router(
            cfg, params, tpl, pol, FLEET_REPLICAS,
            fault_plan=FaultPlan(kills=((FLEET_KILL_TICK, 0),),
                                 delayed_saves=(FLEET_DELAYED_SAVE,)),
            checkpoint_dir=f"{tmp}/ckpt", checkpoint_every=FLEET_CHECKPOINT_EVERY,
            restart_delay=1, store_path=store, store_save_every=FLEET_STORE_SAVE_EVERY)
        per_replica = (torch.cuda.memory_allocated() - mem0) / FLEET_REPLICAS
        mem, warm = {}, {}
        tick, start = router.tick, router._start

        def timed_tick():
            if router.tick_index == FLEET_KILL_TICK:
                torch.cuda.synchronize()
                mem["allocated_before_kill"] = torch.cuda.memory_allocated()
                mem["peak_before_kill"] = torch.cuda.max_memory_allocated()
            ev = tick()
            if ev["killed"]:
                mem["allocated_after_kill"] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            return ev

        def timed_start(rep, at):
            t1 = time.perf_counter()
            start(rep, at)
            torch.cuda.synchronize()
            if at > 0:
                warm["restart_warmup_s"] = time.perf_counter() - t1

        router.tick, router._start = timed_tick, timed_start
        caps0 = sum(CAPTURE_COUNTS.values())
        _build.reset_launches()
        killed = _fleet_run(torch, router, fleet_trace(cfg))
        launches = dict(_build.launches)
        captures = sum(CAPTURE_COUNTS.values()) - caps0
        peak_after = torch.cuda.max_memory_allocated()
        router.verify_against(want)
        router.assert_exactly_once()
        PlanRegistry().load(store)
        c = router.counters
        if c["killed"] != 1 or c["restarted"] != 1 or c["restored_sessions"] < 1:
            raise AssertionError(f"fleet: the kill did not restore a session: {dict(c)}")
        if reg.misses != misses0:
            raise AssertionError(f"fleet: {reg.misses - misses0} DSE searches after the "
                                 f"first warm-up")
        if captures != c["restarted"]:
            raise AssertionError(f"fleet: {captures} captures during the run, want only the "
                                 f"restarted incarnation's warm-up")
        if not mem["allocated_after_kill"] < mem["allocated_before_kill"]:
            raise AssertionError(f"fleet: the kill released no device memory: {mem}")
        if peak_after > mem["peak_before_kill"] + per_replica:
            raise AssertionError(f"fleet: peak {peak_after} after the restart, over "
                                 f"{mem['peak_before_kill']} + one replica ({per_replica})")
        delayed = [e for e in router.store_save_log
                   if (e["replica"], e["due"]) == FLEET_DELAYED_SAVE[:2]]
        if not delayed or delayed[0]["actual"] != sum(FLEET_DELAYED_SAVE[1:]):
            raise AssertionError(f"fleet: the delayed save: {router.store_save_log}")
        kernel = "matmul_q16"
        if launches[f"{kernel}.wgmma"] == 0 or launches[f"{kernel}.splitk"] == 0 or \
                launches["matmul_fp"] or launches[f"{kernel}.tile"]:
            raise AssertionError(f"fleet: launches by route {launches}")
        emit({"phase": "fleet", "numerics": "grid " + pol.fmt.name,
              "nvidia_smi": nvidia_smi(), "replicas": FLEET_REPLICAS,
              "slots": FLEET_SLOTS, "ladder": FLEET_LADDER, "requests": FLEET_REQUESTS,
              "prompt_lens": [len(r.prompt) for r in fleet_trace(cfg)],
              "one_replica": one, "two_replicas": clean, "two_replicas_killed": killed,
              "restart_cost_ticks": killed["ticks"] - clean["ticks"],
              "restart_cost_s": killed["wall_s"] - clean["wall_s"],
              "restart_warmup_s": warm["restart_warmup_s"],
              "memory_bytes": {**mem, "peak_after_restart": peak_after,
                               "per_replica": per_replica},
              "captures_during_run": captures, "dse_searches_after_first_warmup": 0,
              "counters": dict(c), "duplicates_suppressed":
              router.ledger.duplicates_suppressed, "store_save_log": router.store_save_log,
              "graveyard": [inc for rep in router.replicas for inc, _ in rep.graveyard],
              "ledger_equals_one_replica": True, "stats_line": router.stats_line(),
              "seconds": time.perf_counter() - t_phase})
        for rep in router.replicas:
            rep.sched.release()
        del router
    torch.cuda.empty_cache()
    return launches


def phase_float_fleet_study(torch, cfg, params, tpl):
    """The fleet's kill in float (a finding, not a gate): which sessions'
    streams diverge from the one-replica run once a resumed session
    re-prefills through a bucket, and the top-2 margin of the one-replica
    run's token at each first divergence (its exact-length prefill)."""
    import tempfile

    from repro_torch.models import transformer as T
    from repro_torch.runtime.failover import FaultPlan

    t0 = time.perf_counter()
    ref = _fleet_router(cfg, params, tpl, None, 1)
    ref.run(fleet_trace(cfg))
    want = ref.ledger.as_dict()
    ref.replicas[0].sched.release()
    del ref
    row = {"phase": "float_fleet_study", "nvidia_smi": nvidia_smi()}
    with tempfile.TemporaryDirectory() as tmp:
        router = _fleet_router(cfg, params, tpl, None, FLEET_REPLICAS,
                               fault_plan=FaultPlan(kills=((FLEET_KILL_TICK, 0),)),
                               checkpoint_dir=f"{tmp}/ckpt",
                               checkpoint_every=FLEET_CHECKPOINT_EVERY)
        trace = fleet_trace(cfg)
        try:
            router.run(trace)
        except RuntimeError as err:  # a re-emitted token that differs
            row["ledger_error"] = str(err)
        got = router.ledger.as_dict()
        moved = {rid for rid, recs in router.assignments.items() if len(recs) > 1}
        row["counters"] = dict(router.counters)
        for rep in router.replicas:
            if rep.sched is not None:
                rep.sched.release()
        del router
    flips = []
    for r in trace:
        a, b = got.get(r.rid, []), want[r.rid]
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if pos is None:
            continue
        seq = list(r.prompt) + list(b[:pos])
        logits, _ = T.prefill(tpl, cfg, params, torch.tensor([seq], device=tpl.engine.device))
        top2 = torch.topk(logits[0].float(), 2).values
        flips.append({"rid": r.rid, "position": pos, "resumed": r.rid in moved,
                      "top2_margin": float(top2[0] - top2[1])})
    row.update(ledger_diverged=bool(flips) or "ledger_error" in row,
               sessions=len(trace), diverged_sessions=len(flips), flips=flips,
               seconds=time.perf_counter() - t0)
    emit(row)
    torch.cuda.empty_cache()


def _run_cli(argv, env=None):
    """One CLI run in a subprocess from the checkout; its stdout."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
    res = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(argv)} exited {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    return res.stdout


def _searches(out: str) -> int:
    import re

    return int(re.search(r"(\d+) DSE searches", out).group(1))


def phase_fleet_cli(torch):
    """The CLIs in subprocesses at the reference's reduced size, in five
    chains at once: ``serve --backend q16 --scheduler --replicas 2
    --plan-store S`` twice (the second warm, 0 searches);
    ``scheduler_soak --backend q16`` once writing S3 and once under
    ``REPRO_PLAN_ASSERT_WARM=1`` on S3; ``serve --backend q8 --plan-store
    S2`` twice (the second with no search); ``router_soak --backend q16
    --workers 2``; and phase 9(c)'s ``serve --scheduler --shards 2`` (two
    gloo ranks).  Each exits 0; its last line is printed."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    size = ["--prompts", "4", "--prompt-len", "8", "--gen", "3"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store, store2, store3 = f"{tmp}/serve.json", f"{tmp}/q8.json", f"{tmp}/soak.json"
        serve = ["repro_torch.launch.serve"]
        soak = ["repro_torch.benchmarks.scheduler_soak", "--backend", "q16"]

        def fleet_chain():
            argv = serve + ["--backend", "q16", "--scheduler", "--replicas", "2",
                            "--plan-store", store] + size
            cold, warm = _run_cli(argv), _run_cli(argv)
            if _searches(cold) == 0 or _searches(warm) != 0:
                raise AssertionError(f"serve --replicas 2: {_searches(cold)} then "
                                     f"{_searches(warm)} DSE searches")
            return [("serve q16 --replicas 2 (cold)", cold), ("serve q16 --replicas 2 "
                    "(warm)", warm)]

        def soak_chain():
            env = {"REPRO_TORCH_PLAN_STORE": store3}
            _run_cli(soak + ["--save-store"], env)
            gated = _run_cli(soak, dict(env, REPRO_PLAN_ASSERT_WARM="1"))
            if "warm start OK" not in gated:
                raise AssertionError(f"scheduler_soak warm gate:\n{gated[-2000:]}")
            return [("scheduler_soak q16 (warm gate)", gated)]

        def q8_chain():
            argv = serve + ["--backend", "q8", "--precision-budget", "0.5",
                            "--plan-store", store2] + size
            cold, warm = _run_cli(argv), _run_cli(argv)
            if _searches(warm) != 0:
                raise AssertionError(f"serve q8 warm: {_searches(warm)} DSE searches")
            return [("serve q8 (cold)", cold), ("serve q8 (warm)", warm)]

        def router_soak():
            return [("router_soak q16 --workers 2",
                     _run_cli(["repro_torch.benchmarks.router_soak", "--backend", "q16",
                               "--workers", "2"]))]

        def shards_cli():
            t1 = time.perf_counter()
            out = _run_cli(["repro_torch.launch.serve", "--scheduler", "--shards",
                            str(SHARDS_S)] + size)
            return [("serve --scheduler --shards 2", out, time.perf_counter() - t1)]

        chains = (fleet_chain, soak_chain, q8_chain, router_soak, shards_cli)
        with ThreadPoolExecutor(len(chains)) as pool:
            futures = [pool.submit(f) for f in chains]
            outs = [item for fut in futures for item in fut.result()]
    for name, out, *secs in outs:
        if secs:
            emit({"phase": "shards_cli", "argv": name, "rc": 0, "seconds": secs[0],
                  "stdout_tail": out.strip().splitlines()[-3:]})
            continue
        lines = [ln for ln in out.strip().splitlines() if ln.strip()]
        searches = [ln for ln in lines if "DSE searches" in ln]
        emit({"phase": "fleet_cli", "run": name, "last_line": lines[-1][:600],
              **({"registry_line": searches[-1]} if searches else {})})
    emit({"phase": "fleet_cli", "seconds": time.perf_counter() - t0})


#: the ``kernels`` line: one row per kernel, and for the two GEMMs and the
#: two convs one per route of the main paths (record name -> kernel, route,
#: source, TPU kernel); the GEMMs' route "tile" serves no main-path call and
#: is checked (float) or timed beside the other routes (q16) above.  A row's
#: launches are its wrapper's calls, one launch of the kernel each; route
#: "splitk" adds its reduction pass's launches as ``reduce_launches``, the
#: q16 route "wgmma" its preparation's as ``prep_launches``, both convs'
#: route "tc" its weight preparation's and Cin-split reduction's as
#: ``prep_launches`` and ``reduce_launches``
KERNEL_META = {
    "matmul_fp.wgmma": ("matmul_fp", "wgmma", "src/repro_torch/kernels/csrc/gemm_wgmma.cuh",
                        "src/repro/kernels/matmul_fp.py:76"),
    "matmul_fp.splitk": ("matmul_fp", "splitk",
                         "src/repro_torch/kernels/csrc/gemm_splitk.cuh",
                         "src/repro/kernels/matmul_fp.py:76"),
    "matmul_q16.wgmma": ("matmul_q16", "wgmma",
                         "src/repro_torch/kernels/csrc/gemm_q16_wgmma.cuh",
                         "src/repro/kernels/matmul_q16.py:71"),
    "matmul_q16.splitk": ("matmul_q16", "splitk",
                          "src/repro_torch/kernels/csrc/gemm_splitk.cuh",
                          "src/repro/kernels/matmul_q16.py:71"),
    "conv2d.tc": ("conv2d", "tc", "src/repro_torch/kernels/csrc/conv2d_tc.cuh",
                  "src/repro/kernels/conv2d.py:329"),
    "conv2d.cudacore": ("conv2d", "cudacore", "src/repro_torch/kernels/csrc/conv2d.cu",
                        "src/repro/kernels/conv2d.py:329"),
    "conv2d_q16.tc": ("conv2d_q16", "tc", "src/repro_torch/kernels/csrc/conv2d_q16_tc.cuh",
                      "src/repro/kernels/conv2d.py:437"),
    "conv2d_q16.cudacore": ("conv2d_q16", "cudacore", "src/repro_torch/kernels/csrc/conv2d.cu",
                            "src/repro/kernels/conv2d.py:437"),
    "flash_attention.wgmma": ("flash_attention", "wgmma",
                              "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
                              "src/repro/kernels/flash_attention.py:73"),
    # the same route at head dim 128 (mistral-nemo's prefill, phase 10(b)),
    # its launches counted apart ("flash_attention.wgmma.d128")
    "flash_attention.wgmma.d128": ("flash_attention", "wgmma",
                                   "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
                                   "src/repro/kernels/flash_attention.py:73"),
}
#: flash attention's two routes, named in its row (route simt serves no
#: main-path call at the models' head dims and is checked above)
FLASH_ROUTES = {
    "wgmma": "src/repro_torch/kernels/csrc/flash_wgmma.cuh: head dims 64 and 128, "
             "split-precision bf16 on the tensor cores, after a preparation launch",
    "simt": "src/repro_torch/kernels/csrc/flash_attention.cu: head dims 16 and 32, "
            "f32 FFMA on the CUDA cores",
}


# -- phase 9: sharding ---------------------------------------------------------

SHARDS_NETS = ("alexnet", "vgg16")
SHARDS_S = 2
#: the reference's tolerance for a spatial float forward
#: (``tests/test_spatial_shard.py``), printed beside the measured error
SHARDS_REF_TOL = 1e-5
SHARDS_SLOTS = 4
SHARDS_LADDER = (256, 512)
SHARDS_REQUESTS = 6
SHARDS_MAX_NEW = 8
#: (b)'s qwen2-0.5b at full width cut to 2 of its 24 layers (the smoke's
#: time: four eager scheduler runs a rank)
SHARDS_QWEN_DEPTH = 2
SHARDS_MIN_LEN = 64
SHARDS_FORWARD_REPS = 3
SHARDS_DIR = ROOT / "build" / "shards_phase"
#: (d): granite-moe at full width, cut to 2 of its 32 layers (the smoke's
#: time: its eager step took about 1 s at full depth), through the meshed
#: scheduler on a (1, 2) ("data", "model") mesh, expert_mlp over "model"
#: (gate / up column shards, the hidden gathered before down), 4 slots over
#: (256, 512)
MOE_MESH_ARCH = "granite-moe-3b-a800m"
MOE_MESH_DEPTH = 2
MOE_MESH_OVERRIDES = (("expert_mlp", "model"),)
MOE_MESH_REQUESTS = 4
#: (e): the non-attention families through compiled_steps(mesh=) on the
#: same (1, 2) mesh (the SSD and RG-LRU blocks whole on both "model" ranks,
#: their states uncut; the MLPs and attention projections column shards),
#: full width, (config, depth cut): a quarter of the layers (the smoke's
#: time; whisper's decoder, its encoder whole), llama-vision at phase 10's
#: 5 layers; then on (2, 1), a row a rank (the data split)
FAMILY_MESH_RUNS = (("mamba2-1.3b", 12), ("recurrentgemma-9b", 9),
                    ("whisper-medium", 6), ("llama-3.2-vision-90b", 5))
#: (e)'s meshes: (the ranks' record key, the mesh's axes)
FAMILY_MESHES = (("families", {"data": 1, "model": SHARDS_S}),
                 ("families_split", {"data": SHARDS_S, "model": 1}))
FAMILY_MESH_BATCH = 2
FAMILY_MESH_PROMPT = 256
FAMILY_MESH_STEPS = 8


def shards_trace(cfg):
    """The phase's request set: ``synthetic_trace`` over (256, 512), all at
    t = 0 (every rank sees the same ticks)."""
    from repro_torch.launch.scheduler import synthetic_trace

    return synthetic_trace(SHARDS_REQUESTS, seed=SEED, vocab=cfg.vocab,
                           ladder=SHARDS_LADDER, max_new=SHARDS_MAX_NEW,
                           min_len=SHARDS_MIN_LEN)


def _counted_decode(torch, sched):
    """Wrap the scheduler's decode step: each call's ms between two
    synchronizations of the card and its collectives by kind
    (``sharding.SEAM_COUNTS``'s delta); the prefill's ms and rows too."""
    from repro_torch.parallel import sharding as sh

    inner, pre = sched._decode_next, sched._prefill
    rec = {"decode_ms": [], "collectives": [], "prefill_ms": [], "prefill_tokens": 0}

    def decode(*args, **kw):
        before = collections.Counter(sh.SEAM_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        rec["decode_ms"].append(1e3 * (time.perf_counter() - t0))
        delta = collections.Counter(sh.SEAM_COUNTS)
        delta.subtract(before)
        rec["collectives"].append(sh.collective_counts(delta))
        return out

    def prefill(params, tokens, ctx, last):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pre(params, tokens, ctx, last)
        torch.cuda.synchronize()
        rec["prefill_ms"].append(1e3 * (time.perf_counter() - t0))
        rec["prefill_tokens"] += int(tokens.numel())
        return out

    decode.release = inner.release
    sched._decode_next, sched._prefill = decode, prefill
    return rec


def shards_serve(torch, cfg, params, pol, mesh, store):
    """The phase's scheduler run (``mesh``: this rank's tensor-parallel
    share): warm-up, the trace, then (``store``) a plan-store round trip and
    a warm restart.  Returns the record."""
    from repro_torch.core.engine import load_plan_store, reset_plan_caches, save_plan_store
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import (CAPTURE_COUNTS, SchedulerConfig,
                                              ServeScheduler, VirtualClock, replay_trace)

    def run():
        tpl = default_template("cuda" if pol is None else "q16")
        sched = ServeScheduler(cfg, params, tpl=tpl, policy=pol, clock=VirtualClock(),
                               mesh=mesh,
                               sched=SchedulerConfig(ladder=SHARDS_LADDER, slots=SHARDS_SLOTS,
                                                     max_new_limit=SHARDS_MAX_NEW))
        misses0 = sched.registry.misses
        sched.warmup()
        warm = sched.registry.misses - misses0
        times = _counted_decode(torch, sched)["decode_ms"]
        trace = shards_trace(cfg)
        caps0 = sum(CAPTURE_COUNTS.values())
        _build.reset_launches()
        misses0 = sched.registry.misses
        replay_trace(sched, trace, tick=0.0)
        torch.cuda.synchronize()
        rec = {"streams": [list(r.generated) for r in trace],
               "warmup_misses": warm, "trace_misses": sched.registry.misses - misses0,
               "launches": dict(_build.launches),
               "captures": sum(CAPTURE_COUNTS.values()) - caps0,
               "decode_steps": int(sched.counters["decode_steps"]),
               "meshed_eager_steps": int(sched.counters["meshed_eager_decode_steps"]),
               "warmup_shard_misses": int(sched.counters["warmup_shard_misses"]),
               "decode_ms": times}
        sched.release()
        return rec

    cold = run()
    if store is None:
        return cold
    save_plan_store(str(store))
    reset_plan_caches()
    cold["store_entries"] = load_plan_store(str(store))
    cold["warm_restart"] = run()
    return cold


def family_cfg(name, depth):
    """``name``'s config, its depth cut to ``depth`` layers (or whole), and
    the ``reduced`` line that says so."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    if depth is None:
        return cfg, None
    return dataclasses.replace(cfg, n_layers=depth), f"n_layers {cfg.n_layers} -> {depth}"


def moe_mesh_serve(torch, cfg, params, mesh, rules):
    """Phase 9(d)'s scheduler run (``mesh``: this rank's share): warm-up,
    then ``MOE_MESH_REQUESTS`` of ``shards_trace``'s shape; the streams,
    each decode step's ms and the trace's launches."""
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import (SchedulerConfig, ServeScheduler, VirtualClock,
                                              replay_trace, synthetic_trace)

    sched = ServeScheduler(cfg, params, tpl=default_template("cuda"), clock=VirtualClock(),
                           mesh=mesh, rules=rules,
                           sched=SchedulerConfig(ladder=SHARDS_LADDER, slots=SHARDS_SLOTS,
                                                 max_new_limit=SHARDS_MAX_NEW))
    sched.warmup()
    times = _counted_decode(torch, sched)["decode_ms"]
    trace = synthetic_trace(MOE_MESH_REQUESTS, seed=SEED, vocab=cfg.vocab,
                            ladder=SHARDS_LADDER, max_new=SHARDS_MAX_NEW,
                            min_len=SHARDS_MIN_LEN)
    _build.reset_launches()
    replay_trace(sched, trace, tick=0.0)
    torch.cuda.synchronize()
    rec = {"streams": [list(r.generated) for r in trace], "decode_ms": times,
           "launches": dict(_build.launches),
           "completed": int(sched.counters["completed"]),
           "decode_steps": int(sched.counters["decode_steps"]),
           "meshed_eager_steps": int(sched.counters["meshed_eager_decode_steps"])}
    sched.release()
    return rec


def family_mesh_steps(torch, cfg, params, tokens, ctx, mesh=None, rules=None,
                      steps=FAMILY_MESH_STEPS, capture=True):
    """``compiled_steps``: the prefill, then ``steps`` greedy decode steps
    (``mesh``: on this rank's rows of the cache, eager under gloo or with
    ``capture`` False, replayed graphs over NCCL; else replayed graphs);
    each step's logits (host, f32) and tokens, the prefill's and each
    decode step's ms, each decode step's collectives by kind, the
    launches, the captures."""
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import CAPTURE_COUNTS, compiled_steps, shard_cache
    from repro_torch.parallel import sharding as sh

    s = tokens.shape[1]
    fns = compiled_steps(default_template("cuda"), cfg, s + steps, mesh=mesh, rules=rules,
                         capture=capture)
    caps0 = sum(CAPTURE_COUNTS.values())
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = fns.prefill(params, tokens, ctx, None)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    if mesh is not None:
        cache = shard_cache(cfg, cache, mesh, rules)
    tok = torch.argmax(logits, -1)
    out, toks, ms, coll = [logits.float().cpu()], [tok.cpu()], [], []
    for i in range(steps):
        before = collections.Counter(sh.SEAM_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, logits, cache = fns.decode_next(params, tok[:, None], s + i, cache)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        delta = collections.Counter(sh.SEAM_COUNTS)
        delta.subtract(before)
        coll.append(sh.collective_counts(delta))
        out.append(logits.float().cpu())
        tok = tok.clone()
        toks.append(tok.cpu())
    fns.decode_next.release(None)
    return {"logits": torch.stack(out), "tokens": torch.stack(toks, 1), "decode_ms": ms,
            "prefill_ms": [prefill_ms], "prefill_tokens": int(tokens.numel()),
            "collectives": coll, "launches": dict(_build.launches),
            "captures": sum(CAPTURE_COUNTS.values()) - caps0}


def family_mesh_inputs(torch, dev, cfg):
    """Phase 9(e)'s prompts and context, from the seed on the card."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.serve import draw_context

    tokens = synthetic_batch(SEED, 0, FAMILY_MESH_BATCH, FAMILY_MESH_PROMPT, cfg.vocab,
                             device=dev)
    from repro_torch.models import transformer as T

    ctx = draw_context(cfg, FAMILY_MESH_BATCH, seed=SEED, device=dev,
                       dtype=T._dtype(cfg.dtype))
    return tokens, ctx


def shards_rank_families(torch, dev, rank, tp):
    """Phase 9(d) and (e) on this rank: granite through the meshed
    scheduler on ``tp`` ((1, 2), expert_mlp over "model"), then each of
    ``FAMILY_MESH_RUNS`` through ``compiled_steps(mesh=)`` on ``tp`` and on
    the data split (2, 1), the weights drawn as this rank's shards
    (``serve_shardings``)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.scheduler import serve_shardings
    from repro_torch.parallel.sharding import DECODE_RULES

    out = {}
    t0 = time.perf_counter()
    cfg, _ = family_cfg(MOE_MESH_ARCH, MOE_MESH_DEPTH)
    rules = DECODE_RULES.with_overrides(**dict(MOE_MESH_OVERRIDES))
    params = family_params(torch, dev, cfg, shardings=serve_shardings(cfg, tp, rules))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["moe"] = moe_mesh_serve(torch, cfg, params, tp, rules)
    out["moe"]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["moe"]["seconds"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    out["families"] = family_mesh_ranks(torch, dev, tp)
    split = Mesh((tp.size, 1), ("data", "model")).init_groups()
    out["families_split"] = family_mesh_ranks(torch, dev, split)
    return out


def family_mesh_ranks(torch, dev, mesh) -> dict:
    """Each of ``FAMILY_MESH_RUNS`` through ``compiled_steps(mesh=)`` on this
    rank, the weights drawn as its shards (``serve_shardings``)."""
    from repro_torch.launch.scheduler import serve_shardings
    from repro_torch.parallel.sharding import DECODE_RULES

    out = {}
    for name, depth in FAMILY_MESH_RUNS:
        t0 = time.perf_counter()
        cfg, _ = family_cfg(name, depth)
        params = family_params(torch, dev, cfg,
                               shardings=serve_shardings(cfg, mesh, DECODE_RULES))
        tokens, ctx = family_mesh_inputs(torch, dev, cfg)
        rec = family_mesh_steps(torch, cfg, params, tokens, ctx, mesh, DECODE_RULES)
        rec["seconds"] = time.perf_counter() - t0
        out[name] = rec
        del params
        torch.cuda.empty_cache()
    return out


def family_mesh_single(torch, dev) -> dict:
    """``FAMILY_MESH_RUNS`` through the single-device ``compiled_steps`` on
    the card: the meshed runs' references."""
    out = {}
    for name, depth in FAMILY_MESH_RUNS:
        t0 = time.perf_counter()
        cfg, _ = family_cfg(name, depth)
        params = family_params(torch, dev, cfg)
        tokens, ctx = family_mesh_inputs(torch, dev, cfg)
        out[name] = family_mesh_steps(torch, cfg, params, tokens, ctx)
        out[name]["seconds"] = time.perf_counter() - t0
        del params, tokens, ctx
        torch.cuda.empty_cache()
    return out


#: ``--split-decode-study``: rows, splits, and the decode attention calls
#: studied (config, "self" over the 4128-slot ring (a sliding window's
#: ring where it is shorter) or "cross" over the context)
SPLIT_STUDY_ROWS = 8
SPLIT_STUDY_SPLITS = (2, 4, 8)
SPLIT_STUDY_RING = 4128
SPLIT_STUDY_ATTENTION = (("qwen2-0.5b", "self"), ("recurrentgemma-9b", "self"),
                         ("whisper-medium", "self"), ("whisper-medium", "cross"),
                         ("llama-3.2-vision-90b", "self"), ("llama-3.2-vision-90b", "cross"),
                         ("mistral-nemo-12b", "self"))
SPLIT_STUDY_FORMS = ("batched", "rows", "summed", "split")


def _study_attention(torch, form, q, kc, vc, mask):
    """``_sdpa_dense``'s math on a decode call (q (B, 1, H, D), the (B, Hkv,
    T, D) rings, mask (B, 1, 1, T)) with its two contractions made by
    ``form``: "batched" (one einsum over the rows given, the parent's),
    "rows" (one einsum a row), "summed" (products summed by torch over the
    innermost dim) or "split" (``layers.split_einsum``)."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import split_einsum

    b, s, h, d = q.shape
    hkv = kc.shape[1]
    qg = q.reshape(b, s, hkv, h // hkv, d).float()
    k, v = kc.transpose(1, 2).float(), vc.transpose(1, 2).float()
    if form == "summed":
        sc = (qg.permute(0, 2, 3, 1, 4)[..., None, :]
              * k.permute(0, 2, 1, 3)[:, :, None, None]).sum(-1)
    else:
        ein = {"batched": torch.einsum, "split": split_einsum,
               "rows": lambda eq, x, y: torch.cat([torch.einsum(eq, x[i:i + 1], y[i:i + 1])
                                                   for i in range(x.shape[0])])}[form]
        sc = ein("bshgd,bthd->bhgst", qg, k)
    p = torch.softmax(torch.where(mask[:, :, None], sc / (d ** 0.5), A._NEG), dim=-1)
    if form == "summed":
        out = (p[..., None, :] * v.permute(0, 2, 3, 1)[:, :, None, None]).sum(-1)
        out = out.permute(0, 3, 1, 2, 4)
    else:
        out = ein("bhgst,bthd->bshgd", p, v)
    return out.reshape(b, s, h, d).to(q.dtype)


def _split_ranks_differ(torch, fn, args) -> list:
    """The (f, rank) pairs of :data:`SPLIT_STUDY_SPLITS` whose rank, under
    ``batch_split(f)`` on an (f, 1) layout, gets other bits from ``fn`` on
    its rows than one device on all :data:`SPLIT_STUDY_ROWS`."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel import sharding as sh

    full = fn(*args)
    bad = []
    for f in SPLIT_STUDY_SPLITS:
        r = SPLIT_STUDY_ROWS // f
        for j in range(f):
            with sh.use_mesh(Mesh((f, 1), ("data", "model")), sh.DECODE_RULES), \
                    sh.batch_split(f):
                got = fn(*(a[j * r:(j + 1) * r].clone() for a in args))
            if not torch.equal(got, full[j * r:(j + 1) * r]):
                bad.append([f, j])
    return bad


def phase_split_decode_study(torch, dev):
    """``--split-decode-study`` (module docstring): printed, not gated."""
    from repro_torch.configs import get_config
    from repro_torch.core.template import default_template
    from repro_torch.models import layers as L

    t0 = time.perf_counter()
    n = SPLIT_STUDY_ROWS
    g = torch.Generator(device=dev).manual_seed(SEED)

    def draw(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for name, what in SPLIT_STUDY_ATTENTION:
        cfg = get_config(name)
        t = (cfg.n_frames or cfg.n_image_tokens) if what == "cross" else SPLIT_STUDY_RING
        t = min(cfg.window, t) if cfg.window and what == "self" else t
        h, hkv, d = cfg.eff_heads, cfg.n_kv_heads, cfg.head_dim
        args = (draw(n, 1, h, d), draw(n, hkv, t, d), draw(n, hkv, t, d),
                torch.rand((n, 1, 1, t), generator=g, device=dev) < 0.9)
        for form in SPLIT_STUDY_FORMS:
            fn = functools.partial(_study_attention, torch, form)
            emit({"phase": "split_decode_study", "op": "attention", "arch": name, "call": what,
                  "heads": h, "kv_heads": hkv, "head_dim": d, "keys": t, "form": form,
                  "rows": n, "splits_differing": _split_ranks_differ(torch, fn, args),
                  "ms_by_rows": {r: time_ms(lambda: fn(*(a[:r] for a in args)))
                                 for r in (2, 4, 8)},
                  "nvidia_smi": nvidia_smi()})
    rec, ssm = get_config("recurrentgemma-9b"), get_config("mamba2-1.3b")
    ops = {
        "rglru_conv": (lambda w_, c_=draw(rec.ssm_conv, rec.d_rec or rec.d_model):
                       torch.einsum("bwc,wc->bc", w_, c_),
                       (draw(n, rec.ssm_conv, rec.d_rec or rec.d_model),)),
        "ssd_out_batched": (lambda a, b: torch.einsum("bhpn,bhn->bhp", a, b),
                            (draw(n, ssm.ssm_nheads, ssm.ssm_headdim, ssm.ssm_state,
                                  dtype=torch.float32),
                             draw(n, ssm.ssm_nheads, ssm.ssm_state, dtype=torch.float32))),
    }
    ops["ssd_out_split"] = (functools.partial(L.split_einsum, "bhpn,bhn->bhp"),
                            ops["ssd_out_batched"][1])
    for width in (1024, 2048, 4096, 5120, 8192):
        scale = draw(width)
        ops[f"rms_norm_{width}"] = (lambda x, sc=scale: L.rms_norm(x, sc), (draw(n, 1, width),))
        ops[f"layer_norm_{width}"] = (lambda x, sc=scale: L.layer_norm(x, sc, sc),
                                      (draw(n, 1, width),))
    tpl = default_template("cuda")
    for name in ("recurrentgemma-9b", "whisper-medium", "mamba2-1.3b"):
        cfg = get_config(name)
        for proj, (k, m) in {"up": (cfg.d_model, cfg.d_ff or 2 * cfg.d_model),
                             "head": (cfg.d_model, cfg.vocab)}.items():
            w = draw(k, m)
            ops[f"gemm_{name}_{proj}"] = (lambda x, w_=w: tpl.linear(x, w_), (draw(n, k),))
    for op, (fn, args) in ops.items():
        emit({"phase": "split_decode_study", "op": op, "rows": n,
              "splits_differing": _split_ranks_differ(torch, fn, args)})
    emit({"phase": "split_decode_study_done", "seconds": time.perf_counter() - t0})


def shards_rank(payload, rank, world, dev):
    """One of the phase's two ranks on the card: the spatial forwards with a
    slab each over "data", then tensor-parallel decode over "model"."""
    import torch
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import cnn
    from repro_torch.parallel.sharding import SERVE_RULES, use_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = torch.load(payload["path"], map_location=dev, weights_only=False)
    out = {"spatial": {}}
    mesh = Mesh((world,), ("data",)).init_groups()
    _build.reset_launches()
    with use_mesh(mesh, SERVE_RULES):
        for net in SHARDS_NETS:
            spec = cnn.CNN_ZOO[net]
            params, x, pol = data[net]
            tf, tq = default_template("cuda"), default_template("q16")
            qp = cnn.quantize_cnn_params(tq, spec, params, pol)
            plan_f = cnn.plan_cnn(tf, spec, tuple(x.shape), mesh=mesh, spatial="data")
            plan_q = cnn.plan_cnn(tq, spec, tuple(x.shape), mesh=mesh, spatial="data")
            yf = cnn.cnn_forward(tf, spec, params, x, plan=plan_f)
            yq = cnn.cnn_forward(tq, spec, qp, x, policy=pol, plan=plan_q)
            torch.cuda.synchronize()
            out["spatial"][net] = {"float": yf, "grid": yq}
    out["spatial_launches"] = dict(_build.launches)
    with use_mesh(mesh, SERVE_RULES):
        for net in SHARDS_NETS:
            spec = cnn.CNN_ZOO[net]
            params, x, pol = data[net]
            tf, tq = default_template("cuda"), default_template("q16")
            qp = cnn.quantize_cnn_params(tq, spec, params, pol)
            plan_f = cnn.plan_cnn(tf, spec, tuple(x.shape), mesh=mesh, spatial="data")
            plan_q = cnn.plan_cnn(tq, spec, tuple(x.shape), mesh=mesh, spatial="data")
            rec = out["spatial"][net]
            with tf.engine.plan_cache.scope() as warm:
                for numerics, fwd in (
                        ("float", lambda: cnn.cnn_forward(tf, spec, params, x, plan=plan_f)),
                        ("grid", lambda: cnn.cnn_forward(tq, spec, qp, x, policy=pol,
                                                         plan=plan_q))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(SHARDS_FORWARD_REPS):
                        fwd()
                    torch.cuda.synchronize()
                    rec[f"{numerics}_ms"] = 1e3 * (time.perf_counter() - t0) / SHARDS_FORWARD_REPS
            rec["warm_misses"] = warm["misses"]
    del data
    torch.cuda.empty_cache()
    cfg, _ = family_cfg(QWEN_ARCH, SHARDS_QWEN_DEPTH)
    params = qwen_params(torch, dev, cfg)
    tp = Mesh((1, world), ("data", "model")).init_groups()
    for numerics, pol in (("float", None), ("grid", payload["grid_policy"])):
        store = Path(payload["store_dir"]) / f"{numerics}-rank{rank}.json"
        out[numerics] = shards_serve(torch, cfg, params, pol, tp, store)
    del params
    torch.cuda.empty_cache()
    out.update(shards_rank_families(torch, dev, rank, tp))
    return out


def _mean(xs) -> float:
    return sum(xs) / max(len(xs), 1)


def _sum_launches(recs) -> dict:
    from repro_torch.kernels import _build

    total = dict.fromkeys(_build.launches, 0)
    for rec in recs:
        for k, v in rec.items():
            total[k] += int(v)
    return total


def _phase_9de(torch, single, ranks, ranks_s) -> tuple:
    """Phase 9(d) and (e)'s gates and lines: every rank's granite streams
    byte-identical to the single-device scheduler's, every request
    complete, every meshed decode step eager; every rank's families' logits
    and tokens bit for bit the single-device ``compiled_steps``'.  Returns
    the two launch windows (summed over the ranks)."""
    ref = single["moe"]
    for r, rec in enumerate(ranks):
        got = rec["moe"]
        if got["streams"] != ref["streams"]:
            bad = [i for i, (a, b) in enumerate(zip(got["streams"], ref["streams"])) if a != b]
            raise AssertionError(f"9(d) {MOE_MESH_ARCH}: rank {r}'s streams differ from the "
                                 f"single-device scheduler at requests {bad}")
        if got["completed"] != MOE_MESH_REQUESTS or \
                got["meshed_eager_steps"] != got["decode_steps"]:
            raise AssertionError(f"9(d): rank {r}: {got['completed']} of {MOE_MESH_REQUESTS} "
                                 f"completed, {got['meshed_eager_steps']} eager of "
                                 f"{got['decode_steps']} steps")
    cfg, reduced_line = family_cfg(MOE_MESH_ARCH, MOE_MESH_DEPTH)
    r0 = ranks[0]["moe"]
    emit({"phase": "shards_moe_decode", "arch": MOE_MESH_ARCH, "reduced": reduced_line,
          "mesh": {"data": 1, "model": SHARDS_S}, "rules": "DECODE_RULES + " + ", ".join(
              f"{n} -> {a}" for n, a in MOE_MESH_OVERRIDES), "slots": SHARDS_SLOTS,
          "ladder": SHARDS_LADDER, "requests": MOE_MESH_REQUESTS, "nvidia_smi": nvidia_smi(),
          "streams_byte_identical": True, "tokens": sum(len(x) for x in ref["streams"]),
          "decode_ms_per_step_meshed_eager_gloo": _mean(r0["decode_ms"]),
          "decode_ms_per_step_single_device_replayed": _mean(ref["decode_ms"]),
          "decode_steps": r0["decode_steps"],
          "expert_gemms_per_decode_step_a_rank": cfg.n_layers * cfg.n_experts * 3,
          "launches_rank0": {k: v for k, v in r0["launches"].items() if v},
          "peak_mem_bytes_rank0": r0["peak_mem_bytes"],
          "seconds_rank0": r0["seconds"], "seconds_single_device": ref["seconds"]})
    for key, mesh in FAMILY_MESHES:
        for name, depth in FAMILY_MESH_RUNS:
            want = single["families"][name]
            for r, rec in enumerate(ranks):
                got = rec[key][name]
                lg, tk = torch.as_tensor(got["logits"]), torch.as_tensor(got["tokens"])
                same = torch.equal(lg, want["logits"]) and torch.equal(tk, want["tokens"])
                if not same or not bool(torch.isfinite(want["logits"]).all()):
                    raise AssertionError(
                        f"9(e) {name} on {mesh}: rank {r}'s logits / tokens differ from the "
                        f"single-device compiled_steps: max |Δlogit| "
                        f"{float((lg - want['logits']).abs().max())}")
            r0 = ranks[0][key][name]
            emit({"phase": "shards_families_steps", "arch": name,
                  "reduced": family_cfg(name, depth)[1], "mesh": mesh,
                  "rules": "DECODE_RULES", "batch": FAMILY_MESH_BATCH,
                  "prompt_len": FAMILY_MESH_PROMPT, "decode_steps": FAMILY_MESH_STEPS,
                  "nvidia_smi": nvidia_smi(), "logits_and_tokens_bit_identical": True,
                  "decode_ms_per_step_meshed_eager_gloo": _mean(r0["decode_ms"]),
                  "decode_ms_per_step_single_device_replayed": _mean(want["decode_ms"][1:]),
                  "launches_rank0": {k: v for k, v in r0["launches"].items() if v},
                  "seconds_rank0": r0["seconds"], "seconds_single_device": want["seconds"]})
    emit({"phase": "shards_9de", "ranks_seconds": ranks_s,
          "seconds_single_device": single["moe"]["seconds"] + sum(
              v["seconds"] for v in single["families"].values()),
          "seconds_rank0": ranks[0]["moe"]["seconds"] + sum(
              v["seconds"] for key, _ in FAMILY_MESHES for v in ranks[0][key].values())})
    return (_sum_launches(rec["moe"]["launches"] for rec in ranks),
            _sum_launches(rec[key][n]["launches"] for rec in ranks
                          for key, _ in FAMILY_MESHES for n, _ in FAMILY_MESH_RUNS))


def _halo_bytes(spec, plan, itemsize):
    """The modeled bytes one forward's halo exchanges move, and a full
    gather's at every seam, per ``sharding.spatial_halo_bytes`` /
    ``spatial_gather_bytes``."""
    from repro_torch.parallel.sharding import spatial_gather_bytes, spatial_halo_bytes

    halo = gather = 0
    ww, ch = spec.input_hw, spec.input_ch
    for (cout, k, stride, pad, pool), cp, ph in zip(spec.convs, plan.convs, plan.pool_halos):
        hs = cp.halo
        halo += spatial_halo_bytes(hs, BATCH, ww + 2 * pad, ch, itemsize)
        gather += spatial_gather_bytes(hs.h, BATCH, ww, ch, hs.shards, itemsize)
        ww, ch = (ww + 2 * pad - k) // stride + 1, cout
        if ph is not None:
            halo += spatial_halo_bytes(ph, BATCH, ww, ch, itemsize)
            gather += spatial_gather_bytes(ph.h, BATCH, ww, ch, ph.shards, itemsize)
            ww //= pool
    return halo, gather


def phase_shards(torch, dev, cnn_state, grid_policy):
    """Phase 9 (module docstring).  ``cnn_state``: {net: (float params, x,
    grid policy)} from phase 3.  Returns the launch windows of the ranks'
    main paths (summed over the ranks)."""
    from repro_torch.core.template import default_template
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import cnn

    t_phase = time.perf_counter()
    shutil.rmtree(SHARDS_DIR, ignore_errors=True)
    SHARDS_DIR.mkdir(parents=True)
    # (a, i): the unsharded forwards and the one-process slab-major simulation
    want, sim = {}, {}
    for net in SHARDS_NETS:
        spec = cnn.CNN_ZOO[net]
        p, x, pol = cnn_state[net]
        tf, tq = default_template("cuda"), default_template("q16")
        qp = cnn.quantize_cnn_params(tq, spec, p, pol)
        want[net] = {"float": cnn.cnn_forward(tf, spec, p, x),
                     "grid": cnn.cnn_forward(tq, spec, qp, x, policy=pol)}
        plan_f = cnn.plan_cnn(tf, spec, tuple(x.shape), spatial=SHARDS_S)
        plan_q = cnn.plan_cnn(tq, spec, tuple(x.shape), spatial=SHARDS_S)
        before = dict(_build.launches)
        sim[net] = {"float": cnn.cnn_forward(tf, spec, p, x, plan=plan_f),
                    "grid": cnn.cnn_forward(tq, spec, qp, x, policy=pol, plan=plan_q)}
        torch.cuda.synchronize()
        sim[net]["launches"] = {k: n - before[k] for k, n in _build.launches.items()
                                if n != before[k]}
        with tf.engine.plan_cache.scope() as warm:
            for numerics, fwd in (
                    ("float", lambda: cnn.cnn_forward(tf, spec, p, x, plan=plan_f)),
                    ("grid", lambda: cnn.cnn_forward(tq, spec, qp, x, policy=pol,
                                                     plan=plan_q))):
                sim[net][f"{numerics}_ms"] = time_ms(fwd)
        sim[net]["warm_misses"] = warm["misses"]
        sim[net]["bytes"] = {f"{kind}_{what}": n for kind, item in (("float", 4), ("grid", 2))
                             for what, n in zip(("halo", "full_gather"),
                                                _halo_bytes(spec, plan_q, item))}
        sim[net]["describe"] = plan_q.describe()
    torch.save({net: cnn_state[net] for net in SHARDS_NETS}, SHARDS_DIR / "payload.pt")

    # (b): the single-device scheduler on the card, the streams' reference
    single = {}
    cfg, reduced_line = family_cfg(QWEN_ARCH, SHARDS_QWEN_DEPTH)
    params = qwen_params(torch, dev, cfg)
    for numerics, pol in (("float", None), ("grid", grid_policy)):
        single[numerics] = shards_serve(torch, cfg, params, pol, None, None)
    del params
    torch.cuda.empty_cache()
    # (d), (e): the single-device runs on the card, the ranks' references
    t0 = time.perf_counter()
    mcfg, _ = family_cfg(MOE_MESH_ARCH, MOE_MESH_DEPTH)
    mparams = family_params(torch, dev, mcfg)
    single["moe"] = moe_mesh_serve(torch, mcfg, mparams, None, None)
    del mparams
    torch.cuda.empty_cache()
    single["moe"]["seconds"] = time.perf_counter() - t0
    single["families"] = family_mesh_single(torch, dev)

    # (a, ii) and (b) on two ranks of the card
    t0 = time.perf_counter()
    ranks = spawn_ranks(functools.partial(
        shards_rank, {"path": str(SHARDS_DIR / "payload.pt"), "grid_policy": grid_policy,
                      "store_dir": str(SHARDS_DIR)}), SHARDS_S, device="cuda")
    ranks_s = time.perf_counter() - t0

    for net in SHARDS_NETS:
        w_f, w_q = want[net]["float"].float().cpu(), want[net]["grid"].float().cpu()
        rows = [("one-process simulation", sim[net])] + [
            (f"rank {r}", rec["spatial"][net]) for r, rec in enumerate(ranks)]
        errs = {}
        for name, rec in rows:
            got_q = torch.as_tensor(rec["grid"]).float().cpu()
            if not torch.equal(got_q, w_q):
                raise AssertionError(f"shards {net}: {name}'s grid logits differ from the "
                                     f"unsharded forward (max {float((got_q - w_q).abs().max())})")
            err = float((torch.as_tensor(rec["float"]).float().cpu() - w_f).abs().max())
            if not err <= E2E_TOL:
                raise AssertionError(f"shards {net}: {name}'s float logits miss the unsharded "
                                     f"forward by {err} > {E2E_TOL}")
            if rec["warm_misses"]:
                raise AssertionError(f"shards {net}: {name}'s warm forward planned "
                                     f"{rec['warm_misses']} shapes")
            errs[name] = err
        emit({"phase": "shards_spatial", "net": net, "batch": BATCH, "shards": SHARDS_S,
              "nvidia_smi": nvidia_smi(), "grid_bit_identical_to_unsharded": True,
              "float_max_abs_err_vs_unsharded": errs, "float_tol": E2E_TOL,
              "reference_float_tol": SHARDS_REF_TOL,
              "within_reference_tol": {k: v <= SHARDS_REF_TOL for k, v in errs.items()},
              "simulation_launches": sim[net]["launches"],
              "simulation_ms": {k: sim[net][f"{k}_ms"] for k in ("float", "grid")},
              "ranks_ms_gloo_host_staged": {k: ranks[0]["spatial"][net][f"{k}_ms"]
                                            for k in ("float", "grid")},
              "modeled_bytes": sim[net]["bytes"], "plan": sim[net]["describe"]})

    for numerics in ("float", "grid"):
        ref = single[numerics]
        for r, rec in enumerate(ranks):
            got = rec[numerics]
            if got["streams"] != ref["streams"]:
                bad = [i for i, (a, b) in enumerate(zip(got["streams"], ref["streams"]))
                       if a != b]
                raise AssertionError(f"shards {numerics}: rank {r}'s streams differ from the "
                                     f"single-device scheduler at requests {bad}")
            warm = got["warm_restart"]
            searches = {k: warm[k] for k in ("warmup_misses", "trace_misses",
                                             "warmup_shard_misses")}
            if warm["streams"] != ref["streams"] or any(searches.values()):
                raise AssertionError(f"shards {numerics}: rank {r}'s warm restart: "
                                     f"{searches}, streams equal "
                                     f"{warm['streams'] == ref['streams']}")
            if got["trace_misses"] or got["captures"] or \
                    got["meshed_eager_steps"] != got["decode_steps"]:
                raise AssertionError(f"shards {numerics}: rank {r}: {got['trace_misses']} "
                                     f"searches in the trace, {got['captures']} captures, "
                                     f"{got['meshed_eager_steps']} eager of "
                                     f"{got['decode_steps']} steps")
        kernel = "matmul_fp" if numerics == "float" else "matmul_q16"
        r0 = ranks[0][numerics]
        emit({"phase": "shards_decode", "numerics": numerics, "arch": QWEN_ARCH,
              "reduced": reduced_line,
              "mesh": {"data": 1, "model": SHARDS_S}, "slots": SHARDS_SLOTS,
              "ladder": SHARDS_LADDER, "requests": SHARDS_REQUESTS,
              "nvidia_smi": nvidia_smi(), "streams_byte_identical": True,
              "tokens": sum(len(s) for s in ref["streams"]),
              "cold_warmup_misses_rank0": r0["warmup_misses"],
              "warmup_shard_misses_rank0": r0["warmup_shard_misses"],
              "store_entries_rank0": r0["store_entries"],
              "warm_restart_searches": 0,
              "decode_ms_per_step_meshed_eager_gloo": _mean(r0["decode_ms"]),
              "decode_ms_per_step_single_device_replayed": _mean(ref["decode_ms"]),
              "launches_rank0": {k: v for k, v in r0["launches"].items()
                                 if v and k.startswith(kernel)}})

    moe_launches, steps_launches = _phase_9de(torch, single, ranks, ranks_s)

    spatial = _sum_launches(rec["spatial_launches"] for rec in ranks)
    emit({"phase": "shards_spatial_launches", "ranks": SHARDS_S,
          "both_nets_both_numerics": {k: v for k, v in spatial.items() if v}})

    # (c) the CLI runs with the other CLIs (phase_fleet_cli)
    windows = {"shards spatial": spatial}
    for numerics in ("float", "grid"):
        windows[f"shards decode {numerics}"] = _sum_launches(rec[numerics]["launches"]
                                                             for rec in ranks)
    windows["shards moe scheduler"] = moe_launches
    windows["shards families steps"] = steps_launches
    emit({"phase": "shards", "seconds": time.perf_counter() - t_phase,
          "ranks_seconds": ranks_s})
    shutil.rmtree(SHARDS_DIR, ignore_errors=True)
    return windows


# ---------------------------------------------------------------------------
# phase 10: the other model families through generate, at full width
# ---------------------------------------------------------------------------

#: (config, depth cut or None, prompts, prompt length); 16 greedy tokens each
FAMILY_RUNS = (
    # 4 of 32 layers at full width (the smoke's time: the plain path's check
    # at full depth took half a minute)
    ("granite-moe-3b-a800m", 4, 2, 4096),
    # a quarter of the layers (the smoke's time)
    ("mamba2-1.3b", 12, 2, 4096),
    ("recurrentgemma-9b", 9, 2, 4096),
    ("whisper-medium", None, 2, 432),  # + 16 = whisper's 448-token decoder context
    # 100 layers are 180 GB of weights: one period of 4 self + 1 gated cross
    # layer, ~13 GB, at full width
    ("llama-3.2-vision-90b", 5, 2, 1024),
    # (b): the dense configs no earlier phase ran, at full width and depth;
    # their 4096-token prefills run flash's route wgmma at head dim 128
    ("internlm2-1.8b", None, 2, 4096),
    ("mistral-nemo-12b", None, 2, 4096),
)
#: phase 10(b)'s configs (their seconds printed apart)
FAMILY_RUNS_B = ("internlm2-1.8b", "mistral-nemo-12b")
#: the f32 copy the logit floor reads is made only up to this size (beyond
#: it, mistral-nemo's 49 GB beside its bf16 weights, only where the 5 %
#: gate misses)
FAMILY_F32_MAX_BYTES = 40e9
FAMILY_GEN = 16
#: a VLM's cross gates: init_params starts them at 0 (tanh(0) = 0), where the
#: cross layer runs but adds nothing to the logits
FAMILY_CROSS_GATE = 0.5
#: phase 10's logit gate where bf16 itself misses phase 5's 5 %: the kernel
#: path's max |Δlogit| from the f32 model at most this times the plain bf16
#: path's (the two paths' distances sit within 8 % of each other on all five
#: configs of phase 10, NVIDIA H100 80GB HBM3 at 700 W)
FAMILY_F32_RATIO = 1.25
FAMILY_SCHED_SLOTS = 4
FAMILY_SCHED_LADDER = (256, 512)
FAMILY_SCHED_REQUESTS = 6
FAMILY_SCHED_MAX_NEW = 16
#: granite-moe's expert GEMMs: d 1536 -> ff 512, m = the GShard capacity of a
#: 512-token group at prefill (2 x 4096 tokens: 16 groups, capacity 128) and
#: of the 2-token decode group (capacity 2); phase 10 asserts both
GRANITE_D, GRANITE_FF = 1536, 512
FAMILY_EXPERT_CAP_PREFILL, FAMILY_EXPERT_CAP_DECODE = 128, 2


def family_params(torch, dev, cfg, shardings=None):
    """``init_params`` on the card's generator (seed 0) in the config's bf16,
    with a VLM's cross gates set to ``FAMILY_CROSS_GATE``; ``shardings``:
    this rank's shards only, drawn as the whole tree's are."""
    from repro_torch.models import transformer as T

    params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                           shardings=shardings)
    for blk in (*params["blocks"], *params["tail"]):
        if "cross_gate" in blk:
            blk["cross_gate"].fill_(FAMILY_CROSS_GATE)
    return params


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_f32_tree(v) for v in tree)
    return tree.float()


def family_gemms(cfg, batch: int, prompt_len: int) -> dict:
    """The float GEMM calls of one prefill and of one decode step by route,
    from the model's structure: attention q / k / v / o, a cross layer's q /
    o (its k / v only at prefill, over the context), RG-LRU in_x / in_y /
    gate_a / gate_x / out, SSD in / out, the MLP's 3 (swiglu) or 2 (gelu),
    an MoE layer's 3 per (group, expert) at the group's capacity, whisper's
    encoder at prefill, the head at the last positions.  A call's route is
    the planner's by its m: "splitk" up to 16 rows, "wgmma" above (bf16)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    pattern, g, r = T._split(cfg)
    plans = list(pattern) * g + list(pattern[:r])
    mlp = 3 if cfg.act == "swiglu" else 2
    ctx = T._ctx_len(cfg)

    def calls(mode):
        rows = batch * (prompt_len if mode == "prefill" else 1)
        out = [(batch, 1)]  # the head
        if mode == "prefill" and cfg.family == "encdec":
            out.append((batch * ctx, cfg.n_encoder_layers * (4 + mlp)))
        for plan in plans:
            out.append((rows, {"rec": 5, "ssm": 2}.get(plan.mixer, 4)))
            if plan.cross:
                out.append((rows, 2))
                if mode == "prefill":
                    out.append((batch * ctx, 2))
            if plan.moe:
                xt, _, cap = moe._groups(cfg, torch_meta((batch, rows // batch, cfg.d_model)))
                out.append((cap, xt.shape[0] * cfg.n_experts * 3))
            elif plan.mixer != "ssm":
                out.append((rows, mlp))
        by = {"wgmma": 0, "splitk": 0}
        for m, n in out:
            by["splitk" if m <= 16 else "wgmma"] += n
        return by

    return {"prefill": calls("prefill"), "decode": calls("decode")}


def torch_meta(shape):
    """An empty tensor of ``shape`` with no storage (shape arithmetic)."""
    import torch

    return torch.empty(shape, device="meta")


def _once_ms(torch, fn) -> float:
    """Device time of one call of ``fn`` (CUDA events), for calls too long
    to repeat; the caller has run ``fn``'s path once before."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _recurrent_leaves(tree):
    """The recurrent states of a cache tree (RG-LRU "h", SSD "state")."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in ([v] if k in ("h", "state") else _recurrent_leaves(v))]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _recurrent_leaves(v)]
    return []


def phase_families(torch, dev):
    """The other families through ``generate`` on the cuda backend at full
    width, bf16, ``init_params`` weights from the seed: granite-moe, mamba2,
    recurrentgemma, whisper and llama-3.2-vision (depth cut).  Per config:
    launches by route over generate (flash only in granite's prefill, one a
    layer; every GEMM on the route its m sends it to, counted by the model's
    structure; no tile, q16 or conv launch), the prefill's and every
    teacher-forced decode step's logits against the plain ``torch`` backend
    (phase 5's gates, or where bf16 itself misses them the f32 floor: see
    the module docstring), two replayed decode steps bit for bit the eager ones
    in logits and in the whole cache (recurrent states moving); printed:
    prefill tokens/s, decode ms a step eager and replayed, peak memory.
    Then granite through ``ServeScheduler`` (4 slots, ladder (256, 512), 6
    requests): replay = eager at the 4-slot shape, every request completes.
    Returns the launch windows."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.template import default_template
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import (
        CAPTURE_COUNTS,
        SchedulerConfig,
        ServeScheduler,
        SystemClock,
        compiled_steps,
        replay_trace,
        synthetic_trace,
    )
    from repro_torch.launch.serve import draw_context, generate
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    from repro_torch.models.attention import CHUNKED_THRESHOLD
    from repro_torch.optim.tree import tree_leaves

    tf, tplain = default_template("cuda"), default_template("torch")
    windows = {}
    t_phase = time.perf_counter()
    seconds_b = 0.0
    for name, depth, b, s in FAMILY_RUNS:
        t0 = time.perf_counter()
        cfg = get_config(name)
        reduced_line = None
        if depth is not None:
            reduced_line = f"n_layers {cfg.n_layers} -> {depth}" + (
                " (one cross period)" if cfg.family == "vlm" else "")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        params = family_params(torch, dev, cfg)
        prompts = synthetic_batch(SEED, 0, b, s, cfg.vocab, device=dev)
        ctx = draw_context(cfg, b, seed=SEED, device=dev, dtype=params["embed"].dtype)
        clen = s + FAMILY_GEN
        if cfg.family == "moe":
            caps = [moe._groups(cfg, torch_meta((b, n, cfg.d_model)))[2] for n in (s, 1)]
            want_caps = [FAMILY_EXPERT_CAP_PREFILL, FAMILY_EXPERT_CAP_DECODE]
            if (caps != want_caps or (cfg.d_model, cfg.d_ff) != (GRANITE_D, GRANITE_FF)):
                raise AssertionError(f"{name}: expert GEMMs at capacities {caps}, d "
                                     f"{cfg.d_model}, ff {cfg.d_ff}; phase 2 checks "
                                     f"{want_caps}, {GRANITE_D}, {GRANITE_FF}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        caps0 = sum(CAPTURE_COUNTS.values())
        t1 = time.perf_counter()
        stream = generate(cfg, params, prompts, ctx, gen=FAMILY_GEN, tpl=tf)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        launches = dict(_build.launches)
        windows[f"{name} generate"] = launches
        captures = sum(CAPTURE_COUNTS.values()) - caps0
        if stream.shape != (b, FAMILY_GEN):
            raise AssertionError(f"{name}: generate returned {tuple(stream.shape)}")
        # launches by route: the prefill's GEMMs on wgmma (its head on
        # splitk), every decode GEMM on splitk, over the prefill and the
        # decode steps (generate's, plus the capture's eager warm-up step)
        n = family_gemms(cfg, b, s)
        steps = FAMILY_GEN - 1 + captures
        # flash once a full-attention layer where the prefill reaches the
        # chunked route (granite, internlm2, mistral-nemo: 4096 tokens)
        flash = cfg.n_layers if (cfg.family in ("moe", "dense")
                                 and s >= CHUNKED_THRESHOLD) else 0
        want = {"matmul_fp.wgmma": n["prefill"]["wgmma"] + steps * n["decode"]["wgmma"],
                "matmul_fp.splitk": n["prefill"]["splitk"] + steps * n["decode"]["splitk"],
                "matmul_fp.tile": 0, "matmul_q16": 0, "conv2d": 0, "conv2d_q16": 0,
                "flash_attention": flash, "flash_attention.wgmma": flash,
                "flash_attention.wgmma.d128": flash if cfg.head_dim == 128 else 0,
                "flash_attention.prep": flash, "flash_attention.simt": 0}
        want["matmul_fp"] = want["matmul_fp.wgmma"] + want["matmul_fp.splitk"]
        for key, count in want.items():
            if launches[key] != count:
                raise AssertionError(f"{name}: {key} launched {launches[key]} times, want "
                                     f"{count} ({n}, {steps} decode steps)")
        # the logits against the plain backend, teacher-forced on the stream
        got = teacher_forced(torch, tf, cfg, params, prompts, stream, ctx=ctx)
        if not torch.equal(got.argmax(-1), stream):
            raise AssertionError(f"{name}: the teacher-forced replay does not reproduce "
                                 f"generate's greedy tokens")
        plain = teacher_forced(torch, tplain, cfg, params, prompts, stream, ctx=ctx)
        check = compare_logits(torch, got, plain, rel_tol=FLOAT_REL_TOL,
                               argmax_min=FLOAT_ARGMAX, what=f"{name} vs plain", gate=False)
        # the same weights in f32 on the plain backend: how far each bf16
        # path sits from the model it rounds (read where the copy fits, and
        # always where the 5 % gate misses)
        floor, at_floor = None, False
        f32_bytes = 4 * sum(x.numel() for x in tree_leaves(params))
        if check["rel_diff"] > FLOAT_REL_TOL or f32_bytes <= FAMILY_F32_MAX_BYTES:
            p32 = _f32_tree(params)
            ref = teacher_forced(torch, tplain, cfg, p32, prompts, stream,
                                 ctx=None if ctx is None else ctx.float())
            scale = float(ref.abs().max())
            floor = {"kernel_rel_diff": float((got - ref).abs().max()) / scale,
                     "plain_bf16_rel_diff": float((plain - ref).abs().max()) / scale,
                     "ratio_max": FAMILY_F32_RATIO}
            del p32, ref
            # phase 5's gates; where the plain bf16 path itself sits more
            # than 5 % of the logit scale from the f32 model, two bf16 paths
            # cannot be held within 5 % of each other, and the kernel path is
            # held instead to sit as close to the f32 model as the plain bf16
            # path does
            at_floor = (floor["plain_bf16_rel_diff"] > FLOAT_REL_TOL
                        and floor["kernel_rel_diff"]
                        <= FAMILY_F32_RATIO * floor["plain_bf16_rel_diff"])
        check["vs_f32_plain"] = floor
        check["rel_gate"] = ("5 % of the logit scale" if check["rel_diff"] <= FLOAT_REL_TOL
                             else "bf16 floor" if at_floor else "missed")
        if not (bool(torch.isfinite(got).all()) and check["rel_gate"] != "missed"
                and check["argmax_agreement"] >= FLOAT_ARGMAX
                and check["decisive_agreement"] in (None, 1.0)):
            raise AssertionError(f"{name}: logits off the plain path: {check}")
        del got, plain
        # two replayed decode steps against two eager ones, bit for bit, in
        # logits and in the whole cache (generate's graph: same signature)
        fns = compiled_steps(tf, cfg, clen, None)
        _, cache = T.prefill(tf, cfg, params, prompts, ctx=ctx, cache_len=clen)
        c_e, c_g = _clone_tree(cache), _clone_tree(cache)
        rec0 = [x.clone() for x in _recurrent_leaves(cache)]
        for i in range(2):
            tok = stream[:, i:i + 1]
            lg_e, c_e = T.decode_step(tf, cfg, params, tok, s + i, c_e)
            _, lg_g, c_g = fns.decode_next(params, tok, s + i, c_g)
            torch.cuda.synchronize()
            if not (torch.equal(lg_e, lg_g) and _tree_equal(torch, c_e, c_g)):
                raise AssertionError(f"{name}: replayed decode step {i} differs from the "
                                     f"eager step: max |Δlogit| "
                                     f"{float((lg_e.float() - lg_g.float()).abs().max())}")
        moved = [not torch.equal(a, x) for a, x in zip(rec0, _recurrent_leaves(c_g))]
        if rec0 and not all(moved):
            raise AssertionError(f"{name}: {moved.count(False)} recurrent states did not "
                                 f"move over two replayed steps")
        if sum(CAPTURE_COUNTS.values()) - caps0 != captures:
            raise AssertionError(f"{name}: the replay check captured a new graph")
        # times: one prefill, one eager decode step, replayed steps
        prefill_ms = _once_ms(torch, lambda: T.prefill(tf, cfg, params, prompts, ctx=ctx,
                                                       cache_len=clen))
        tok = stream[:, 2:3]
        eager_ms = _once_ms(torch, lambda: T.decode_step(tf, cfg, params, tok, s + 2, c_e))
        graph_ms = time_ms(lambda: fns.decode_next(params, tok, s + 2, c_g), target_ms=50.0)
        emit({"phase": "families", "arch": name, "reduced": reduced_line,
              "family": cfg.family, "layers": cfg.n_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab, "dtype": cfg.dtype, "prompts": b, "prompt_len": s,
              "ctx": None if ctx is None else list(ctx.shape), "gen": FAMILY_GEN,
              "nvidia_smi": nvidia_smi(), "vs": "torch backend, bf16, same stream",
              **check, "replay_equals_eager": True, "recurrent_states_moved": len(rec0),
              "gemm_calls": n, "decode_graph_captures": captures,
              "launches": {k: v for k, v in launches.items() if v},
              "prefill_ms": prefill_ms, "prefill_tokens_per_s": b * s / prefill_ms * 1e3,
              "decode_ms_per_step_eager": eager_ms, "decode_ms_per_step_graph": graph_ms,
              "generate_s_host_clock": generate_s, "peak_mem_bytes": peak,
              "sample_tokens": stream[0, :8].tolist(),
              "config_s": time.perf_counter() - t0})
        if name in FAMILY_RUNS_B:
            seconds_b += time.perf_counter() - t0
        fns.decode_next.release(None)
        del cache, c_e, c_g, fns, stream, prompts, ctx
        if cfg.family == "moe":
            windows["granite scheduler"] = family_scheduler(torch, cfg, params, tf)
        del params
        torch.cuda.empty_cache()
    emit({"phase": "families_done", "seconds": time.perf_counter() - t_phase,
          "seconds_10b": seconds_b})
    return windows



def family_scheduler(torch, cfg, params, tpl):
    """granite-moe through ``ServeScheduler``: warm-up, a replayed step equal
    to the eager step bit for bit at the 4-slot shape, then 6 requests of
    ``synthetic_trace`` (seed 0) that must all complete; no tile, q16 or
    conv launch, no flash (the rungs stay below the chunked threshold)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.scheduler import (
        SchedulerConfig,
        ServeScheduler,
        SystemClock,
        compiled_steps,
        replay_trace,
        synthetic_trace,
    )
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    sched = ServeScheduler(cfg, params, tpl=tpl, clock=SystemClock(),
                           sched=SchedulerConfig(ladder=FAMILY_SCHED_LADDER,
                                                 slots=FAMILY_SCHED_SLOTS,
                                                 max_new_limit=FAMILY_SCHED_MAX_NEW))
    sched.warmup()
    fns = compiled_steps(tpl, cfg, sched.cache_len, sched.policy)
    cache, tok, tvec = slot_state(torch, sched, params)
    lg_e, c_e = T.decode_step(tpl, cfg, params, tok, tvec, cache)
    _, lg_g, c_g = fns.decode_next(params, tok, tvec, _clone_tree(cache))
    torch.cuda.synchronize()
    if not (torch.equal(lg_e, lg_g) and _tree_equal(torch, c_e, c_g)):
        raise AssertionError(f"granite scheduler: the graph replay differs from the eager "
                             f"step: max |Δlogit| "
                             f"{float((lg_e.float() - lg_g.float()).abs().max())}")
    del cache, c_e, c_g, lg_e
    fns.decode_next.release(None)
    trace = synthetic_trace(FAMILY_SCHED_REQUESTS, seed=SEED, vocab=cfg.vocab,
                            ladder=FAMILY_SCHED_LADDER, max_new=FAMILY_SCHED_MAX_NEW)
    _build.reset_launches()
    t1 = sched.clock.now()
    replay_trace(sched, trace, tick=0.0)
    torch.cuda.synchronize()
    wall_s = sched.clock.now() - t1
    launches = dict(_build.launches)
    c = sched.counters
    if not (c["completed"] == len(trace) == len(sched.results) and not sched.active
            and sched._free == list(range(FAMILY_SCHED_SLOTS))):
        raise AssertionError(f"granite scheduler: the trace did not complete: {dict(c)}")
    for key in ("matmul_fp.tile", "matmul_q16", "conv2d", "conv2d_q16", "flash_attention"):
        if launches[key]:
            raise AssertionError(f"granite scheduler: {key} launched {launches[key]} times")
    if not (launches["matmul_fp.wgmma"] and launches["matmul_fp.splitk"]):
        raise AssertionError(f"granite scheduler: GEMM routes {launches}")
    emit({"phase": "families_scheduler", "arch": cfg.name, "slots": FAMILY_SCHED_SLOTS,
          "ladder": FAMILY_SCHED_LADDER, "requests": len(trace),
          "prompt_lens": [len(r.prompt) for r in trace], "graph_equals_eager": True,
          "completed": c["completed"], "tokens": c["tokens"], "trace_wall_s": wall_s,
          "tokens_per_s": c["tokens"] / wall_s, "launches": {k: v for k, v in
                                                               launches.items() if v},
          "stats_line": sched.stats_line(), "seconds": time.perf_counter() - t0})
    sched.release()
    del sched, fns
    return launches


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

#: qwen2-0.5b through launch/train.main at full width and depth (bf16, remat
#: on): 6 steps of 8 x 1024 tokens in 2 microbatches; run B fails at step 4
#: and resumes from its step-3 checkpoint
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_PARAMS = 493_961_216
TRAIN_ARGV = ("--full", "--batch", "8", "--seq", "1024", "--accum", "2", "--lr", "1e-3",
              "--steps", "6", "--log-every", "1", "--seed", str(SEED))
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 3, 4
#: step 0 of the bf16 run against the same weights and batch in f32 on the card
TRAIN_F32_LOSS_TOL, TRAIN_F32_GNORM_TOL = 0.01, 0.05
#: the same gates for phase 11c's one loss_fn forward and backward a family
FAMILY_TRAIN_RUNS = (
    # (config, tokens, what the depth cut keeps)
    ("granite-moe-3b-a800m", 1024, "one layer (the period)"),
    ("mamba2-1.3b", 1024, "one layer (the period)"),
    ("recurrentgemma-9b", 1024, "one period: rec, rec, local attention"),
    ("whisper-medium", 432, "one decoder and one encoder layer"),
    ("llama-3.2-vision-90b", 1024, "one self and one gated cross layer"),
)
#: device time of a train step by kernel name: cuBLAS's GEMMs ("nvjet",
#: "gemm"), softmax, reductions, elementwise, indexing and copies
TRAIN_PROFILE_GROUPS = ("nvjet", "gemm", "softmax", "reduce_kernel", "elementwise_kernel",
                        "index", "CatArrayBatchedCopy")


def _train_cut(cfg):
    """Phase 11c's depth cut (full width): one pattern period; whisper's
    encoder to one layer; llama-vision to one self and one cross layer (a
    cross period of 2)."""
    from repro_torch.models import transformer as T

    if cfg.family == "vlm":
        return dataclasses.replace(cfg, n_layers=2, cross_attn_period=2)
    cut = dataclasses.replace(cfg, n_layers=len(T.plan_pattern(cfg)))
    if cfg.family == "encdec":
        cut = dataclasses.replace(cut, n_encoder_layers=1)
    return cut


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_train_qwen(torch, dev):
    """qwen2-0.5b through ``launch/train.main`` at full width: run A fault-free
    (no checkpoint), run B with checkpoints every 3 steps and a failure at
    step 4.  Gates: finite losses; A's last two below its first; B one
    failure, resumed at 3; B's steps 0-3 and, after the restart, 3-5 equal
    to A's bit for bit; A's step 0 within 1 % (loss) and 5 % (grad
    norm) of the same weights and batch in f32.  Printed: ms a step,
    tokens/s, peak memory, checkpoint save / restore seconds, the share of
    the bf16 dense peak that 6·N·D reaches, one warm step's device time by
    kernel group (``torch.profiler``).  Returns the launch window (the step
    runs on the torch template: no kernel), A's step 0 (loss, grad norm),
    phase 12's single-device reference, and the step's profile."""
    import tempfile

    from repro_torch.configs import SHAPES, get_config, reduced
    from repro_torch.core.template import default_template
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, adamw_init, cosine_warmup
    from repro_torch.optim.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    if "--full" not in TRAIN_ARGV:
        cfg = reduced(cfg)
    argv = ["--arch", TRAIN_ARCH, *TRAIN_ARGV, "--device", str(dev)]
    steps = int(argv[argv.index("--steps") + 1])
    batch = int(argv[argv.index("--batch") + 1])
    seq = int(argv[argv.index("--seq") + 1])
    work = Path(tempfile.mkdtemp(prefix="train_phase_", dir=ROOT / "build"))
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t_a = time.perf_counter()
        stats_a, loss_a = train.main(argv + ["--ckpt-every", "0",
                                             "--ckpt-dir", str(work / "a")])
        a_s = time.perf_counter() - t_a
        peak_a = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_b = time.perf_counter()
        stats_b, loss_b = train.main(argv + ["--ckpt-every", str(TRAIN_CKPT_EVERY),
                                             "--fail-at", str(TRAIN_FAIL_AT),
                                             "--ckpt-dir", str(work / "b")])
        b_s = time.perf_counter() - t_b
        peak_b = torch.cuda.max_memory_allocated()
        launches = dict(_build.launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if any(launches.values()):
        raise AssertionError(f"train: the torch-template step launched kernels: "
                             f"{ {k: v for k, v in launches.items() if v} }")
    if not all(math.isfinite(x) for x in loss_a + loss_b):
        raise AssertionError(f"train: a loss is not finite: A {loss_a}, B {loss_b}")
    if not sum(loss_a[-2:]) / 2 < loss_a[0]:
        raise AssertionError(f"train: the loss did not fall: {loss_a}")
    if (stats_b["failures"], stats_b["restarts"]) != (1, [TRAIN_CKPT_EVERY]):
        raise AssertionError(f"train: run B {stats_b}")
    # B: steps 0..3, the failure at 4, steps 3..5 again from the checkpoint
    want = loss_a[:TRAIN_FAIL_AT] + loss_a[TRAIN_CKPT_EVERY:]
    if loss_b != want:
        raise AssertionError(f"train: run B's losses {loss_b} are not run A's {loss_a} "
                             f"(B replays steps {TRAIN_CKPT_EVERY}-{steps - 1} after the "
                             f"restart)")

    # the config's parameter count (N of 6·N·D); the tree holds the padded
    # attention heads too (eff_heads), as the reference's does
    n_params = cfg.n_params()
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"train: {TRAIN_ARCH} has {n_params} parameters, want "
                             f"{TRAIN_PARAMS}")
    # A's step 0 against the same weights and batch in f32 on the card
    params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg)
    tree_params = sum(t.numel() for t in tree_leaves(params))
    accum = int(argv[argv.index("--accum") + 1])
    opt = AdamW(lr=cosine_warmup(1e-3, 1, steps))
    pipe = make_pipeline(cfg, SHAPES["train_4k"], seed=SEED, global_batch=batch,
                         seq_len=seq, device=dev)
    p32 = _f32_tree(params)
    step32 = make_train_step(dataclasses.replace(cfg, dtype="float32"),
                             tpl=default_template("torch"), opt=opt, accum=accum)
    _, _, m32 = step32(p32, adamw_init(p32), pipe.batch(0))
    loss32, gnorm32 = float(m32["loss"]), float(m32["grad_norm"])
    del p32, m32
    torch.cuda.empty_cache()
    # where a bf16 step's time goes: one step, warm, under the profiler
    step16 = make_train_step(cfg, tpl=default_template("torch"), opt=opt, accum=accum)
    state = [params, adamw_init(params)]
    del params
    b0 = pipe.batch(1)
    state[:2] = step16(*state, b0)[:2]
    profile = profile_window(torch, lambda: step16(*state, b0), host_ops=True,
                             groups=TRAIN_PROFILE_GROUPS)
    del state
    torch.cuda.empty_cache()
    vs_f32 = {"loss_f32": loss32, "grad_norm_f32": gnorm32, "loss_bf16": loss_a[0],
              "grad_norm_bf16": stats_a["grad_norms"][0],
              "loss_rel_diff": _rel(loss_a[0], loss32),
              "grad_norm_rel_diff": _rel(stats_a["grad_norms"][0], gnorm32),
              "tols": [TRAIN_F32_LOSS_TOL, TRAIN_F32_GNORM_TOL]}
    if (vs_f32["loss_rel_diff"] > TRAIN_F32_LOSS_TOL
            or vs_f32["grad_norm_rel_diff"] > TRAIN_F32_GNORM_TOL):
        raise AssertionError(f"train: bf16 step 0 off the f32 step: {vs_f32}")
    # steady steps: A's after its first (which allocates the optimizer's and
    # the allocator's first buffers)
    step_s = sorted(stats_a["step_seconds"][1:])[len(stats_a["step_seconds"][1:]) // 2]
    tokens = batch * seq
    emit({"phase": "train", "arch": TRAIN_ARCH, "params": n_params,
          "params_in_tree_padded_heads": tree_params, "dtype": cfg.dtype,
          "remat": cfg.remat, "argv": argv, "nvidia_smi": nvidia_smi(),
          "losses_a": loss_a, "losses_b": loss_b, "grad_norms_a": stats_a["grad_norms"],
          "b_failures": stats_b["failures"], "b_restarts": stats_b["restarts"],
          "b_replays_a_bit_for_bit": True, "vs_f32": vs_f32,
          "step_ms_median": step_s * 1e3, "step_ms_all_a": [x * 1e3 for x in
                                                             stats_a["step_seconds"]],
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "model_flops_per_step_6ND": 6 * n_params * tokens,
          "bf16_dense_peak_share_6ND": 6 * n_params * tokens / step_s / PEAK_BF16,
          "peak_mem_bytes_a": peak_a, "peak_mem_bytes_b": peak_b,
          "ckpt_save_s": stats_a["save_seconds"] + stats_b["save_seconds"],
          "ckpt_restore_s": stats_b["restore_seconds"],
          "run_a_s": a_s, "run_b_s": b_s, "profile_one_step": profile,
          "seconds": time.perf_counter() - t0})
    return launches, (loss_a[0], stats_a["grad_norms"][0]), profile


def phase_train_lenet(torch, dev):
    """The LeNet QAT example at its own size on the card: 60 float steps and
    30 QAT steps at batch 32 on the torch template, then the grid deploy
    and the precision DSE on the q16 template.  Gates: the last QAT loss
    below the first float loss; the deployed grid logits (and the DSE's
    mixed plan's) bit-identical to the CPU engine's (the plain versions) on
    the same quantized weights and images; the LeNet's q16 kernels launched
    on their routes (conv "cudacore", GEMM "splitk"), no float kernel.
    Returns the launch window."""
    from repro_torch.core.template import default_template
    from repro_torch.examples import train_lenet_q214
    from repro_torch.kernels import _build
    from repro_torch.models import cnn

    t0 = time.perf_counter()
    _build.reset_launches()
    res = train_lenet_q214.main(["--device", str(dev)])
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    if not res["qat_losses"][-1] < res["float_losses"][0]:
        raise AssertionError(f"lenet: the QAT loss {res['qat_losses'][-1]} is not below the "
                             f"first float loss {res['float_losses'][0]}")
    tcpu = default_template("q16", device="cpu")
    img = res["images"].cpu()
    checked = {}
    for what, policy, logits in (("grid", res["policy"], res["grid_logits"]),
                                 ("dse", res["mixed"], res["mixed_logits"])):
        if logits is None:
            continue
        qp = cnn.quantize_cnn_params(default_template("q16"), cnn.LENET, res["params"],
                                     policy)
        y_cpu = cnn.cnn_forward(tcpu, cnn.LENET, _to(qp, "cpu"), img, policy=policy)
        if not torch.equal(logits.cpu(), y_cpu):
            raise AssertionError(f"lenet {what}: the deployed logits differ from the CPU "
                                 f"engine's (max {float((logits.cpu() - y_cpu).abs().max())})")
        checked[what] = True
    want_zero = ("matmul_fp", "conv2d", "flash_attention", "conv2d_q16.tc", "matmul_q16.wgmma",
                 "matmul_q16.tile")
    if any(launches[k] for k in want_zero) or not (
            launches["matmul_q16.splitk"] and launches["conv2d_q16.cudacore"]):
        raise AssertionError(f"lenet: launches {launches}")
    emit({"phase": "train_lenet", "float_steps": len(res["float_losses"]),
          "qat_steps": len(res["qat_losses"]), "float_loss_first": res["float_losses"][0],
          "float_loss_last": res["float_losses"][-1], "qat_loss_last": res["qat_losses"][-1],
          "accuracy": res["accuracy"], "deploy_fmt": res["policy"].fmt.name,
          "argmax_agreement_grid_vs_fake_quant": res["argmax_agreement"],
          "islands": res["islands"], "bit_identical_to_cpu_engine": checked,
          "dse_plan": {k: v.name for k, v in res["mixed"].layer_fmts},
          "launches": {k: v for k, v in launches.items() if v},
          "matmul_q16_splitk_launches": launches["matmul_q16.splitk"],
          "conv2d_q16_cudacore_launches": launches["conv2d_q16.cudacore"],
          "nvidia_smi": nvidia_smi(), "seconds": time.perf_counter() - t0})
    return launches


def phase_train_families(torch, dev):
    """One ``loss_fn`` forward and backward a family at full width, depth cut
    (``_train_cut``), bf16, ``init_params`` weights from the seed (a VLM's
    cross gates at 0.5), no optimizer state, on the torch template; 1 x
    1024 tokens (whisper 1 x 432 after 1500 frames, llama-vision after 1600
    image tokens).  Gates: the loss and every grad finite, the loss within
    1 % and the grad norm within 5 % of the same weights' f32 pass.
    Printed: ms and peak memory.  Returns the launch window."""
    from repro_torch.configs import get_config
    from repro_torch.core.template import default_template
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import draw_context
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.optim.adamw import global_norm
    from repro_torch.optim.tree import tree_leaves

    tpl = default_template("torch")
    _build.reset_launches()
    for name, s, kept in FAMILY_TRAIN_RUNS:
        t0 = time.perf_counter()
        full = get_config(name)
        cfg = _train_cut(full)
        params = family_params(torch, dev, cfg)
        batch = {"tokens": synthetic_batch(SEED, 0, 1, s, cfg.vocab, device=dev)}
        ctx = draw_context(cfg, 1, seed=SEED, device=dev, dtype=params["embed"].dtype)
        if ctx is not None:
            batch["ctx"] = ctx
        loss_and_grads(tpl, cfg, params, batch)  # warm-up: the allocator, the libraries
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        loss, metrics, grads = loss_and_grads(tpl, cfg, params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        peak = torch.cuda.max_memory_allocated()
        leaves = tree_leaves(grads)
        finite = math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all())
                                                     for g in leaves)
        gnorm = float(global_norm(grads))
        n_params = sum(t.numel() for t in leaves)
        del grads, leaves
        p32 = _f32_tree(params)
        b32 = {k: (v.float() if v.is_floating_point() else v) for k, v in batch.items()}
        loss32, _, g32 = loss_and_grads(tpl, dataclasses.replace(cfg, dtype="float32"), p32,
                                        b32)
        gnorm32 = float(global_norm(g32))
        del p32, g32, params
        torch.cuda.empty_cache()
        row = {"loss": float(loss), "loss_f32": float(loss32), "aux": float(metrics["aux"]),
               "grad_norm": gnorm, "grad_norm_f32": gnorm32,
               "loss_rel_diff": _rel(float(loss), float(loss32)),
               "grad_norm_rel_diff": _rel(gnorm, gnorm32)}
        if not (finite and row["loss_rel_diff"] <= TRAIN_F32_LOSS_TOL
                and row["grad_norm_rel_diff"] <= TRAIN_F32_GNORM_TOL):
            raise AssertionError(f"train {name}: finite {finite}, {row}")
        emit({"phase": "train_family", "arch": name, "family": cfg.family,
              "reduced": f"n_layers {full.n_layers} -> {cfg.n_layers} ({kept})",
              "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
              "tokens": s, "ctx": None if ctx is None else list(ctx.shape),
              "dtype": cfg.dtype, "remat": cfg.remat, **row,
              "tols": [TRAIN_F32_LOSS_TOL, TRAIN_F32_GNORM_TOL],
              "fwd_bwd_ms": ms, "peak_mem_bytes": peak, "nvidia_smi": nvidia_smi(),
              "seconds": time.perf_counter() - t0})
    launches = dict(_build.launches)
    if any(launches.values()):
        raise AssertionError(f"train families: kernels launched on the torch template: "
                             f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase_training(torch, dev):
    """Phase 11: (a) qwen2-0.5b through the training driver, (b) the LeNet QAT
    example, (c) one training pass a family.  Returns the launch windows,
    (a)'s step 0 (loss, grad norm) and (a)'s profile of one step."""
    t0 = time.perf_counter()
    qwen_launches, step0, profile = phase_train_qwen(torch, dev)
    windows = {"train qwen2": qwen_launches}
    torch.cuda.empty_cache()
    windows["train lenet"] = phase_train_lenet(torch, dev)
    windows["train families"] = phase_train_families(torch, dev)
    torch.cuda.empty_cache()
    emit({"phase": "training_done", "seconds": time.perf_counter() - t0})
    return windows, step0, profile


# ---------------------------------------------------------------------------
# phase 12: data-parallel, FSDP and tensor-parallel training on ranks
# ---------------------------------------------------------------------------

#: qwen2-0.5b at phase 11a's width and batch (TRAIN_ARGV: 8 x 1024 in 2
#: microbatches), cut to ``MESH_DEPTH`` of its 24 layers (the smoke's time:
#: a gloo step at full depth took 10-16 s), through ``train.main --mesh
#: single`` on two gloo ranks of the card, one run after another on the
#: same two rank processes: FSDP and data-parallel (``--no-fsdp``) with no
#: checkpoint, FSDP failing at step 1 with a checkpoint every step, and
#: tensor-parallel ("model" = 2) with no checkpoint
MESH_RANKS = 2
MESH_DEPTH = 2
MESH_STEPS = {"fsdp": 2, "fsdp_restart": 2, "dp": 1, "tp": 1}
MESH_FAIL_AT = MESH_CKPT_EVERY = 1
#: step 0 on the ranks against the single-device step 0 at the same depth
MESH_LOSS_TOL, MESH_GNORM_TOL = 1e-3, 1e-2


@contextlib.contextmanager
def _train_depth(depth):
    """``train.main`` builds ``TRAIN_ARCH`` cut to ``depth`` layers (full
    width) inside (None: whole)."""
    from repro_torch.launch import train

    inner = train.get_config

    def get_config(name):
        cfg = inner(name)
        if depth is None or name != TRAIN_ARCH:
            return cfg
        return dataclasses.replace(cfg, n_layers=depth)

    train.get_config = get_config
    try:
        yield
    finally:
        train.get_config = inner


def train_mesh_runs(runs, rank=0, world=1, dev=None, depth=None):
    """Phase 12's rank body: ``train.main(argv)`` of each (name, argv) of
    ``runs`` in turn on this rank (``depth``: ``TRAIN_ARCH`` cut to it);
    rank 0 returns each run's stats, losses, seconds and the seams'
    collectives (``sharding.SEAM_COUNTS``, counted from 0 just before the
    run) and removes its checkpoints."""
    from repro_torch.launch import train
    from repro_torch.parallel import sharding

    out = {}
    for name, argv in runs:
        t0 = time.perf_counter()
        sharding.SEAM_COUNTS.clear()
        with _train_depth(depth):
            stats, losses = train.main(argv)
        out[name] = {"stats": stats, "losses": list(losses),
                     "seconds": time.perf_counter() - t0,
                     "seams": [[*k, n] for k, n in sorted(sharding.SEAM_COUNTS.items())]}
        if rank == 0:
            shutil.rmtree(argv[argv.index("--ckpt-dir") + 1], ignore_errors=True)
    return out if rank == 0 else None


def phase_train_mesh(torch, dev):
    """Phase 12: qwen2-0.5b at full width, cut to ``MESH_DEPTH`` layers,
    through ``launch/train.main --mesh single --ranks 2`` (two gloo ranks of
    the card, collectives staged through the host), four runs, one after another on the same two rank
    processes (``main`` called on each rank trains on them), so each run
    has the card alone: FSDP (``TRAIN_RULES``) and data-parallel
    (``--no-fsdp``), both without checkpoints, FSDP with a failure at step
    1 and a checkpoint every step (saved gathered by rank 0, restored onto
    the ranks' shardings), and tensor-parallel (``--model 2``: "model" = 2,
    heads / qkv / mlp / vocab and the residual stream's sequence over it)
    without checkpoints.  Depth, steps and checkpoints are cut, never the
    width.  Gates: every loss finite; step 0's loss within 1e-3 and its grad
    norm within 1e-2 (relative) of ``train.main``'s single-device step 0 at
    the same depth on the same weights and batch; the restarted run's losses
    and grad norms equal to the fault-free FSDP run's bit for bit.  Printed: ms a
    step, tokens/s and each rank's peak memory a run, the checkpoint's save
    and restore seconds, each run's collectives a step by kind and mesh
    axis, each run's and the phase's seconds.  The ranks run on the torch
    template: no kernel."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    argv = ["--arch", TRAIN_ARCH, *TRAIN_ARGV, "--device", str(dev), "--mesh", "single",
            "--ranks", str(MESH_RANKS)]
    batch = int(argv[argv.index("--batch") + 1])
    seq = int(argv[argv.index("--seq") + 1])
    extra = {"fsdp": ["--ckpt-every", "0"],
             "fsdp_restart": ["--ckpt-every", str(MESH_CKPT_EVERY),
                              "--fail-at", str(MESH_FAIL_AT)],
             "dp": ["--no-fsdp", "--ckpt-every", "0"],
             "tp": ["--model", "2", "--ckpt-every", "0"]}
    work = Path(tempfile.mkdtemp(prefix="train_mesh_phase_", dir=ROOT / "build"))
    try:
        one = ["--arch", TRAIN_ARCH, *TRAIN_ARGV, "--device", str(dev), "--steps", "1",
               "--ckpt-every", "0", "--ckpt-dir", str(work / "one")]
        single = train_mesh_runs([("one", one)], depth=MESH_DEPTH)["one"]
        step0 = (single["losses"][0], single["stats"]["grad_norms"][0])
        torch.cuda.empty_cache()
        t_spawn = time.perf_counter()
        runs = spawn_ranks(functools.partial(train_mesh_runs, [
            (name, argv + extra[name] + ["--steps", str(MESH_STEPS[name]),
                                         "--ckpt-dir", str(work / name)])
            for name in extra], depth=MESH_DEPTH), MESH_RANKS, device=str(dev))[0]
        spawned = time.perf_counter() - t_spawn
    finally:
        shutil.rmtree(work, ignore_errors=True)
    from repro_torch.parallel.sharding import collective_counts

    want_loss, want_gnorm = step0
    rows = {}
    for name, run in runs.items():
        stats, losses = run["stats"], run["losses"]
        if not all(math.isfinite(x) for x in losses + stats["grad_norms"]):
            raise AssertionError(f"train mesh {name}: a loss is not finite: {losses}")
        steady = stats["step_seconds"][1:] or stats["step_seconds"]
        step_s = sorted(steady)[len(steady) // 2]
        rows[name] = {"losses": losses, "grad_norms": stats["grad_norms"],
                      "loss_rel_diff_vs_single": _rel(losses[0], want_loss),
                      "grad_norm_rel_diff_vs_single": _rel(stats["grad_norms"][0],
                                                           want_gnorm),
                      "step_ms_median": step_s * 1e3,
                      "step_ms_all": [x * 1e3 for x in stats["step_seconds"]],
                      "tokens_per_s": batch * seq / step_s,
                      "peak_mem_bytes_by_rank": stats.get("peak_mem_bytes_by_rank"),
                      "ckpt_save_s": stats["save_seconds"],
                      "ckpt_restore_s": stats["restore_seconds"],
                      "failures": stats["failures"], "restarts": stats["restarts"],
                      "run_s": run["seconds"]}
        if name != "fsdp_restart":  # a run of whole steps only: its collectives a step
            seams = {tuple(k[:3]): k[3] for k in run["seams"]}
            rows[name]["collectives_per_step"] = {
                kind: {axis: n / len(losses) for axis, n in by_axis.items()}
                for kind, by_axis in collective_counts(seams).items()}
            rows[name]["seams_per_step"] = {"/".join(k): n / len(losses)
                                            for k, n in seams.items()}
        if (rows[name]["loss_rel_diff_vs_single"] > MESH_LOSS_TOL
                or rows[name]["grad_norm_rel_diff_vs_single"] > MESH_GNORM_TOL):
            raise AssertionError(f"train mesh {name}: step 0 off the single-device step 0 "
                                 f"({want_loss}, {want_gnorm}): {rows[name]}")
    free, again = runs["fsdp"], runs["fsdp_restart"]
    if (again["stats"]["failures"], again["stats"]["restarts"]) != (1, [MESH_CKPT_EVERY]):
        raise AssertionError(f"train mesh: the restarted run {again['stats']}")
    if (again["losses"] != free["losses"]
            or again["stats"]["grad_norms"] != free["stats"]["grad_norms"]):
        raise AssertionError(f"train mesh: the restarted run's steps {again['losses']} are "
                             f"not the fault-free run's {free['losses']}")
    emit({"phase": "train_mesh", "arch": TRAIN_ARCH, "argv": argv, "ranks": MESH_RANKS,
          "reduced": f"n_layers {get_config(TRAIN_ARCH).n_layers} -> {MESH_DEPTH}",
          "single_device_step0_s": single["seconds"],
          "backend": "gloo (both ranks on the card, host-staged)",
          "mesh": {name: "('data', 'model') = " + ("(1, 2)" if name == "tp" else
                                                   f"({MESH_RANKS}, 1)") for name in runs},
          "single_device_step0": {"loss": want_loss, "grad_norm": want_gnorm},
          "tols": [MESH_LOSS_TOL, MESH_GNORM_TOL], "runs": rows,
          "restart_replays_fault_free_bit_for_bit": True, "tokens_per_step": batch * seq,
          "ranks_start_and_stop_s": spawned - sum(r["seconds"] for r in runs.values()),
          "nvidia_smi": nvidia_smi(), "seconds": time.perf_counter() - t0})


#: ``--train-mesh-nccl``: four cards over NCCL.  qwen2-0.5b at train_4k's
#: 4096 tokens (8 rows: 2 a card; one card takes them in 4 microbatches),
#: data-parallel, FSDP, and tensor-parallel on (2, 2) and (1, 4) ("data",
#: "model"); recurrentgemma-9b at full depth under FSDP on 4 x 4096 tokens
#: (one row a card)
NCCL_CARDS = 4
NCCL_SEQ = 4096
NCCL_QWEN_BATCH, NCCL_RG_BATCH = 8, 4
NCCL_STEPS = 3
NCCL_RG_ARCH = "recurrentgemma-9b"


def nccl_train(payload, rank=0, world=1, dev=None):
    """``payload["steps"]`` training steps of one config on this rank (or,
    with ``world`` 1 and no mesh, on one card) from ``init_params`` at the
    seed, batches from the pipeline: losses, grad norms, step seconds and
    peak memory; an out-of-memory error is raised with the peak and the
    state's bytes."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.template import default_template
    from repro_torch.data import make_pipeline
    from repro_torch.launch.mesh import train_mesh
    from repro_torch.launch.steps import make_train_step, state_shardings
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, adamw_init, cosine_warmup
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.parallel.sharding import TRAIN_RULES

    dev = torch.device(dev or "cuda:0")
    cuda = dev.type == "cuda"
    cfg = get_config(payload["arch"])
    rules = TRAIN_RULES.with_overrides(**dict(cfg.rule_overrides))
    if payload["kind"] == "dp":
        rules = rules.with_overrides(embed=None)
    model = payload.get("model", 1)
    mesh = train_mesh(world, model=model).init_groups() if payload["meshed"] else None
    p_sh = state_shardings(cfg, mesh, rules)[0] if mesh is not None else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    steps = payload["steps"]
    where = "init"
    state_bytes = 0
    try:
        params = T.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                               shardings=p_sh)
        opt_state = adamw_init(params)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(params) + tree_leaves(opt_state.m)
                          + tree_leaves(opt_state.v))
        opt = AdamW(lr=cosine_warmup(1e-3, 1, steps))
        step = make_train_step(cfg, tpl=default_template("torch", device=dev.type), opt=opt,
                               accum=payload["accum"], mesh=mesh, rules=rules)
        pipe = make_pipeline(cfg, SHAPES["train_4k"], seed=SEED, mesh=mesh, rules=rules,
                             global_batch=payload["batch"], seq_len=NCCL_SEQ, device=dev,
                             accum=payload["accum"])
        losses, gnorms, secs = [], [], []
        for i in range(steps):
            where = f"step {i}"
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, pipe.batch(i))
            losses.append(float(m["loss"]))  # reads the step's result back
            gnorms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError("NCCL_STUDY_OOM " + json.dumps({
            "rank": rank, "where": where, "state_bytes_on_rank": state_bytes,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "reserved_bytes": torch.cuda.memory_reserved(dev), "error": str(e)[:300]}))
    return {"losses": losses, "grad_norms": gnorms, "step_seconds": secs,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
            "state_bytes_on_rank": state_bytes,
            "card": torch.cuda.get_device_name(dev) if cuda else "cpu"}


def phase_train_mesh_nccl(torch):
    """``--train-mesh-nccl``, run alone: training over NCCL on four cards,
    a rank each.  (a) qwen2-0.5b at 8 x 4096 tokens: one card (4
    microbatches of 2 rows), then data-parallel and FSDP ranks (2 rows
    each), and tensor-parallel on (2, 2) (4 rows a data rank, the sequence
    over "model") and (1, 4) (every row, the sequence over four ranks);
    gates: finite losses, step 0's loss within 1e-3 and grad norm within
    1e-2 of one card's; printed: every step's loss beside one card's, ms a
    step, tokens/s, peak memory a card.  (b) recurrentgemma-9b
    at full depth under FSDP on 4 x 4096 tokens: losses, ms a step, each
    card's peak memory, or, if it does not fit, each card's peak and the
    state's bytes where it ran out."""
    from repro_torch.launch.mesh import spawn_ranks

    cards = torch.cuda.device_count()
    if cards < NCCL_CARDS:
        raise AssertionError(f"--train-mesh-nccl needs {NCCL_CARDS} cards, this machine has "
                             f"{cards}")
    t0 = time.perf_counter()
    qwen = {"arch": TRAIN_ARCH, "batch": NCCL_QWEN_BATCH, "steps": NCCL_STEPS}
    single = nccl_train({**qwen, "kind": "single", "meshed": False,
                         "accum": NCCL_QWEN_BATCH // 2})
    torch.cuda.empty_cache()
    rows = {"one_card": single}
    for kind, model in (("dp", 1), ("fsdp", 1), ("tp_2x2", 2), ("tp_1x4", 4)):
        out = spawn_ranks(functools.partial(nccl_train, {**qwen, "kind": kind, "meshed": True,
                                                         "accum": 1, "model": model}),
                          NCCL_CARDS, device="cuda")
        rows[kind] = {**out[0], "peak_mem_bytes_by_card": [o["peak_mem_bytes"] for o in out]}
        got, want = rows[kind], single
        rows[kind]["loss_rel_diff_vs_one_card"] = [
            _rel(a, b) for a, b in zip(got["losses"], want["losses"])]
        rows[kind]["grad_norm_rel_diff_vs_one_card"] = [
            _rel(a, b) for a, b in zip(got["grad_norms"], want["grad_norms"])]
        if not (all(math.isfinite(x) for x in got["losses"])
                and rows[kind]["loss_rel_diff_vs_one_card"][0] <= MESH_LOSS_TOL
                and rows[kind]["grad_norm_rel_diff_vs_one_card"][0] <= MESH_GNORM_TOL):
            raise AssertionError(f"nccl {kind}: {rows[kind]} against one card's {single}")
    tokens = NCCL_QWEN_BATCH * NCCL_SEQ
    for row in rows.values():
        steady = row["step_seconds"][1:]
        row["step_ms_median"] = sorted(steady)[len(steady) // 2] * 1e3
        row["tokens_per_s"] = tokens / (row["step_ms_median"] / 1e3)
    emit({"phase": "train_mesh_nccl", "arch": TRAIN_ARCH, "cards": NCCL_CARDS,
          "backend": "nccl", "tokens_per_step": tokens, "seq": NCCL_SEQ, "runs": rows,
          "tols_step0": [MESH_LOSS_TOL, MESH_GNORM_TOL], "nvidia_smi": nvidia_smi(),
          "seconds": time.perf_counter() - t0})
    t1 = time.perf_counter()
    try:
        out = spawn_ranks(functools.partial(nccl_train, {
            "arch": NCCL_RG_ARCH, "batch": NCCL_RG_BATCH, "steps": NCCL_STEPS,
            "kind": "fsdp", "meshed": True, "accum": 1}), NCCL_CARDS, device="cuda")
        rg = {"fits": True, **out[0],
              "peak_mem_bytes_by_card": [o["peak_mem_bytes"] for o in out]}
        if not all(math.isfinite(x) for x in rg["losses"]):
            raise AssertionError(f"nccl {NCCL_RG_ARCH}: a loss is not finite: {rg}")
        rg["step_ms_median"] = sorted(rg["step_seconds"][1:])[
            len(rg["step_seconds"][1:]) // 2] * 1e3
    except RuntimeError as e:
        if "NCCL_STUDY_OOM {" not in str(e):
            raise
        text = str(e)
        rg = {"fits": False, "oom": [json.loads(line.split("NCCL_STUDY_OOM ", 1)[1])
                                     for line in text.splitlines()
                                     if "NCCL_STUDY_OOM {" in line]}
    from repro_torch.configs import get_config

    emit({"phase": "train_mesh_nccl_recurrentgemma", "arch": NCCL_RG_ARCH,
          "params": get_config(NCCL_RG_ARCH).n_params(), "cards": NCCL_CARDS,
          "tokens_per_step": NCCL_RG_BATCH * NCCL_SEQ, **rg, "nvidia_smi": nvidia_smi(),
          "seconds": time.perf_counter() - t1})


# ---------------------------------------------------------------------------
# phase 13: the dry-run cells
# ---------------------------------------------------------------------------

#: the dry-run CLI's architecture (both production meshes), the cell whose
#: rank-0 argument shards are allocated, and the cells whose local GEMMs run
DRYRUN_ARCH = "qwen2.5-32b"
DRYRUN_ALLOC = "decode_32k"
DRYRUN_GEMM_SHAPES = ("decode_32k", "prefill_32k")
DRYRUN_MESH = "16x16"
DRYRUN_DIR = ROOT / "build" / "dryrun_phase"


def start_dryrun_cli():
    """Phase 13's CLI run, started early in a process of its own (it plans
    on the host while the card runs the phases before it; ``phase_dryrun``
    waits for it).  Killed at exit if it is still running."""
    import atexit
    import os

    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
            "--mesh", "both", "--out", str(DRYRUN_DIR)]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT)
    atexit.register(proc.kill)
    return proc


#: the single-card steps the analyzer counts beside phases 5 and 11a's
#: profiles, and the file its subprocess writes
SINGLE_CARD_JSON = ROOT / "build" / "single_card_analysis.json"
#: the analyzer's groups that run as plain torch ops on every template (the
#: PS plane: what phase 5's "other" and phase 11a's elementwise kernels time)
PS_GROUPS = ("norm", "softmax", "rope", "elementwise", "copy")


def start_single_card_analysis():
    """Phase 13(b)'s analyzer run (:func:`analyze_single_card`), started early
    in a process of its own on the host, as the CLI is; killed at exit if it
    is still running."""
    import atexit
    import os

    SINGLE_CARD_JSON.unlink(missing_ok=True)
    SINGLE_CARD_JSON.parent.mkdir(parents=True, exist_ok=True)
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--analyze-single-card",
            str(SINGLE_CARD_JSON)]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT)
    atexit.register(proc.kill)
    return proc


def analyze_single_card(out: Path) -> None:
    """``--analyze-single-card OUT``: the op analyzer (``core/op_analysis.py``)
    on phase 5's qwen2-0.5b prefill (4 x 4096, no mesh) and phase 11a's
    train step (8 x 1024 in 2 microbatches), both on the ``torch``
    template, counted on fake tensors on the host; writes flops, bytes by
    group, the least ms of each group's bytes at the card's HBM rate and
    the roofline terms to ``OUT``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.op_analysis import analyze_step
    from repro_torch.core.roofline import roofline_from_counts
    from repro_torch.core.template import default_template
    from repro_torch.launch.steps import abstract_opt_state, abstract_params, \
        make_prefill_step, make_train_step
    from repro_torch.optim import AdamW, cosine_warmup

    tpl = default_template("torch", device="cpu")
    res = {}
    cfg = get_config(QWEN_ARCH)
    params = abstract_params(cfg)
    tokens = torch.zeros((QWEN_PROMPTS, QWEN_PROMPT_LEN), dtype=torch.int64)
    todo = {"prefill": (make_prefill_step(cfg, tpl, cache_len=QWEN_PROMPT_LEN + QWEN_GEN),
                        (params, {"tokens": tokens}), QWEN_PROMPTS * QWEN_PROMPT_LEN, False)}
    tcfg = get_config(TRAIN_ARCH)
    argv = list(TRAIN_ARGV)
    batch, seq, accum, steps = (int(argv[argv.index(f) + 1])
                                for f in ("--batch", "--seq", "--accum", "--steps"))
    tparams = abstract_params(tcfg)
    step = make_train_step(tcfg, tpl=tpl, opt=AdamW(lr=cosine_warmup(1e-3, 1, steps)),
                           accum=accum)
    todo["train"] = (step, (tparams, abstract_opt_state(tcfg, tparams),
                            {"tokens": torch.zeros((batch, seq), dtype=torch.int64)}),
                     batch * seq, True)
    for name, (fn, args, n_tokens, training) in todo.items():
        t0 = time.perf_counter()
        st = analyze_step(fn, *args, tpl=tpl)
        arch = TRAIN_ARCH if training else QWEN_ARCH
        rep = roofline_from_counts(arch=arch, shape=name, mesh_name="1", chips=1,
                                   flops=st.flops, bytes_accessed=st.bytes, collectives=(),
                                   n_params_active=get_config(arch).n_params_active(),
                                   tokens=n_tokens, training=training)
        res[name] = {"flops": st.flops, "bytes": st.bytes, "ops": st.ops,
                     "bytes_by_group": st.bytes_by_group,
                     "least_ms_by_group": {g: b / HBM_BW * 1e3
                                           for g, b in st.bytes_by_group.items()},
                     "ps_plane_bytes": sum(st.bytes_by_group[g] for g in PS_GROUPS),
                     "ps_plane_least_ms": sum(st.bytes_by_group[g] for g in PS_GROUPS)
                     / HBM_BW * 1e3,
                     "compute_ms": rep.compute_s * 1e3, "memory_ms": rep.memory_s * 1e3,
                     "bound_ms": rep.bound_s * 1e3, "dominant": rep.dominant,
                     "useful_ratio": rep.useful_ratio, "top_dots": st.top_dots[:4],
                     "analyze_s": time.perf_counter() - t0}
    out.write_text(json.dumps(res))


def _dryrun_record(shape: str, mesh: str = "16x16") -> dict:
    name = f"{DRYRUN_ARCH}_{shape}_{mesh}.json"
    return json.loads((DRYRUN_DIR / name).read_text())


#: the fields a dry-run record's analysis writes (the reference's names, with
#: ``ops`` in place of ``hlo``)
DRYRUN_ANALYSIS = ("ops", "cost", "roofline", "model_flops", "useful_ratio",
                   "roofline_fraction")


def _dryrun_rooflines(ran: list, summary: str) -> None:
    """Phase 13(a): each ran cell's roofline terms from its record, or its
    recorded ``analysis_refused``; fails where a record has neither."""
    import re

    cells = []
    for label in ran:
        arch, shape, mesh = (x.strip() for x in label.split(" x "))
        rec = _dryrun_record(shape, mesh)
        if "analysis_refused" in rec:
            cells.append({"cell": label, "analysis_refused": rec["analysis_refused"]})
            continue
        missing = [k for k in DRYRUN_ANALYSIS if k not in rec]
        if missing:
            raise AssertionError(f"dryrun {label}: the record lacks {missing} and records "
                                 f"no analysis_refused")
        r = rec["roofline"]
        cells.append({"cell": label, "kind": rec["kind"], "compute_s": r["compute_s"],
                      "memory_s": r["memory_s"], "collective_s": r["collective_s"],
                      "dominant": r["dominant"], "useful_ratio": rec["useful_ratio"],
                      "roofline_fraction": rec["roofline_fraction"],
                      "op_flops": rec["ops"]["flops"], "op_bytes": rec["ops"]["bytes"],
                      "wire_bytes": rec["ops"]["wire_bytes"],
                      "coll_counts": rec["ops"]["coll_counts"],
                      "bytes_by_group": rec["ops"]["bytes_by_group"],
                      "analyze_s": rec["analyze_s"], "rules": rec["ops"]["rules"]})
    took = re.search(r"([0-9.]+)s$", summary)
    emit({"phase": "dryrun_roofline", "arch": DRYRUN_ARCH, "cells": cells,
          "rates": {"hw": "h100_sxm (core/tiling.py:H100)", "peak_bf16_flops": PEAK_BF16,
                    "hbm_bw": HBM_BW},
          "cli_seconds": float(took.group(1)) if took else "not measured",
          "nvidia_smi": nvidia_smi()})


def _single_card_lines(proc, measured: dict) -> None:
    """Phase 13(b): the analyzer's counts of phase 5's float prefill and phase
    11a's train step beside the device ms by group those phases measured
    (reported, not gated)."""
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"single-card analysis exited {proc.returncode}:\n"
                             f"{out[-2000:]}\n{err[-3000:]}")
    got = json.loads(SINGLE_CARD_JSON.read_text())
    for name, prof in measured.items():
        a = got[name]
        emit({"phase": "dryrun_single_card", "step": name,
              "what": ("qwen2-0.5b prefill 4 x 4096, phase 5 float (cuda template) measured, "
                       "torch template counted" if name == "prefill" else
                       "qwen2-0.5b train step 8 x 1024 in 2 microbatches (phase 11a, torch "
                       "template)"),
              "analyzer": a, "measured_wall_ms": prof["wall_ms"],
              "measured_device_busy_ms": prof["device_busy_ms"],
              "measured_device_ms_by_group": prof["device_ms_by_group"],
              "nvidia_smi": nvidia_smi()})


def phase_dryrun(torch, dev, book: KernelBook, cli, single, measured: dict) -> dict:
    """Phase 13 (module docstring): the dry-run CLI (``cli``, from
    :func:`start_dryrun_cli`) and its cells' roofline terms, the analyzer's
    single-card counts (``single``, from :func:`start_single_card_analysis`)
    beside ``measured`` (phase 5's float prefill and phase 11a's step
    profiles), rank 0's argument shards of one cell allocated at the
    record's local shapes, and every planned local GEMM of two cells
    launched through ``Engine.matmul`` on its plan.  Returns the launch
    window of those GEMMs (one call each)."""
    from repro_torch.core.engine import GemmPlan
    from repro_torch.core.template import default_template
    from repro_torch.core.tiling import MatmulBlock
    from repro_torch.kernels import _build
    from repro_torch.kernels.matmul_fp import matmul_fp_plain

    t_phase = time.perf_counter()
    out, err = cli.communicate(timeout=600)
    if cli.returncode != 0:
        raise AssertionError(f"dryrun CLI exited {cli.returncode}:\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("[")]
    ran = [ln.split("]")[0][1:] for ln in lines if "] ok " in ln]
    skipped = [ln.split("]")[0][1:] for ln in lines if "] SKIP: " in ln]
    if len(ran) + len(skipped) != len(lines) or not ran:
        raise AssertionError(f"dryrun: unexpected CLI output:\n{out[-2000:]}")
    summary = out.strip().splitlines()[-1]
    emit({"phase": "dryrun_cli", "arch": DRYRUN_ARCH, "cells_ran": ran,
          "cells_skipped": skipped, "summary": summary,
          "waited_s": time.perf_counter() - t_phase})
    _dryrun_rooflines(ran, summary)
    _single_card_lines(single, measured)

    # rank 0's argument shards of the cell, allocated at the record's shapes
    rec = _dryrun_record(DRYRUN_ALLOC)
    want = rec["memory"]["argument_size_in_bytes"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    shards = [torch.empty(a["local_shape"], dtype=getattr(torch, a["dtype"]), device=dev)
              for a in rec["arguments"]]
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    got = sum(t.numel() * t.element_size() for t in shards)
    if got != want:
        raise AssertionError(f"dryrun {DRYRUN_ALLOC}: rank 0's shards hold {got} bytes, the "
                             f"record says {want}")
    emit({"phase": "dryrun_arguments", "arch": DRYRUN_ARCH, "shape": DRYRUN_ALLOC,
          "mesh": DRYRUN_MESH, "leaves": len(shards), "argument_bytes": got,
          "argument_size_in_bytes_record": want, "equal": True,
          "by_argument": rec["memory"]["argument_bytes_by_argument"],
          "memory_allocated_delta_bytes": delta, "nvidia_smi": nvidia_smi()})
    del shards
    torch.cuda.empty_cache()

    # each planned local GEMM on its plan, in bf16, against its plain version
    eng = default_template("cuda").engine
    window = dict.fromkeys(_build.launches, 0)
    for shape in DRYRUN_GEMM_SHAPES:
        for j, (proj, p) in enumerate(_dryrun_record(shape)["gemm_plans"].items()):
            if p["route"] is None:
                raise AssertionError(f"dryrun {shape} {proj}: no plan to run: {p}")
            m, n, k = p["m"], p["n"], p["k"]
            plan = GemmPlan(m, n, k, MatmulBlock(*p["tile"], route=p["route"],
                                                 splits=p["splits"]), tuple(p["logical"]))
            x = _randn(torch, (m, k), dev, 300 + j).to(torch.bfloat16)
            w = _randn(torch, (k, n), dev, 310 + j, k ** -0.5).to(torch.bfloat16)
            before = dict(_build.launches)
            y = eng.matmul(x, w, plan=plan)
            torch.cuda.synchronize()
            ran_here = {key: c - before[key] for key, c in _build.launches.items()
                        if c != before[key]}
            routes = {key for key in ran_here if key.startswith("matmul_fp.")
                      and not key.endswith("_reduce")}
            if routes != {f"matmul_fp.{p['route']}"}:
                raise AssertionError(f"dryrun {shape} {proj}: launched {ran_here}, the plan "
                                     f"names route {p['route']}")
            for key, c in ran_here.items():
                window[key] += c
            case = (f"{DRYRUN_ARCH} {shape} {DRYRUN_MESH} {proj} local ({m},{k})@({k},{n}) "
                    f"bf16 {_plan(plan.block)}")
            book.check(f"matmul_fp.{p['route']}", case, y, matmul_fp_plain(x, w),
                       exact=False, tol=GEMM_TOL_BF16)
            b_ms, b_by = bound(nbytes(x, w) + m * n * y.element_size(), 2 * m * n * k,
                               PEAK_BF16)
            emit({"phase": "dryrun_gemm", "shape": shape, "proj": proj, "m": m, "n": n,
                  "k": k, "logical": p["logical"], "route": p["route"], "tile": p["tile"],
                  "splits": p["splits"], "launches": ran_here,
                  "ms": time_ms(lambda: eng.matmul(x, w, plan=plan)), "bound_ms": b_ms,
                  "bound_by": b_by, "nvidia_smi": nvidia_smi()})
            del x, w, y
    torch.cuda.empty_cache()
    emit({"phase": "dryrun", "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in window.items() if v}})
    return window


# ---------------------------------------------------------------------------
# phase 14: the benchmark scripts
# ---------------------------------------------------------------------------

BENCH_JSON = ROOT / "build" / "bench_torch.json"
#: the fields of a roofline row that are copied from a dry-run record
ROOFLINE_TERMS = ("compute_s", "memory_s", "collective_s", "dominant")
ROOFLINE_RECORD = ("useful_ratio", "roofline_fraction")


def _bench_roofline(rows: list) -> list:
    """Each roofline row of the report held to phase 13's record of its cell,
    field for field; the rows are exactly the 16x16 records with terms."""
    want = sorted(p.name for p in DRYRUN_DIR.glob(f"*_{DRYRUN_MESH}.json")
                  if "analysis_refused" not in json.loads(p.read_text()))
    got = sorted(f"{r['arch']}_{r['shape']}_{r['mesh']}.json" for r in rows)
    if got != want:
        raise AssertionError(f"bench roofline: rows for {got}, phase 13's records {want}")
    for r in rows:
        rec = _dryrun_record(r["shape"], r["mesh"])
        expect = {**{k: rec["roofline"][k] for k in ROOFLINE_TERMS},
                  **{k: rec[k] for k in ROOFLINE_RECORD},
                  "argument_bytes": rec["memory"]["argument_size_in_bytes"]}
        diff = {k: (r[k], v) for k, v in expect.items() if r[k] != v}
        if diff:
            raise AssertionError(f"bench roofline {r['shape']}: the row differs from the "
                                 f"record: {diff}")
    return rows


def _bench_fpga_tables(got: dict) -> None:
    """Phase 8: the paper's FPGA plane from run.py's Table 1 / Table 2 /
    DSE-sweep rows, with ``tests/test_cnn_fpga.py``'s checks: every paper
    compute unit fits its board, and Table 1's conv GOP/s rise from Ultra96
    to ZCU102."""
    rows = {r["board"]: r for r in got["table1"]}
    if not all(r["fits"] for r in rows.values()):
        raise AssertionError(f"a paper compute unit does not fit its board: {rows}")
    gops = [rows[b]["gops_model"] for b in ("Ultra96", "ZCU104", "ZCU102")]
    if not gops[0] < gops[1] < gops[2]:
        raise AssertionError(f"Table 1 conv GOP/s do not rise with the board: {gops}")
    emit({"phase": "fpga_table1", "rows": got["table1"], "conv_gops": gops})
    emit({"phase": "fpga_table2", **got["table2"]})
    emit({"phase": "fpga_dse_sweep", **got["dse_sweep"]})


def phase_bench_scripts(torch):
    """Phase 14 (module docstring): ``benchmarks/run.py`` in a subprocess on
    phase 13's dry-run records, then its rows printed and checked."""
    import os

    t0 = time.perf_counter()
    BENCH_JSON.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), DRYRUN_OUT=str(DRYRUN_DIR))
    env.pop("REPRO_TORCH_PLAN_STORE", None)
    res = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run",
                          "--out", str(BENCH_JSON)], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"benchmarks.run exited {res.returncode}:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    got = json.loads(BENCH_JSON.read_text())
    _bench_fpga_tables(got)
    kt = got["kernel_table"]
    rows = kt["structural_h100"]
    smi = nvidia_smi()
    if len(rows) != 12 or any(r.get("ms") is None or "library_ms" not in r for r in rows):
        raise AssertionError(f"bench kernel_table: untimed H100 rows: {rows}")
    for r in rows:
        emit({"phase": "bench_kernel_table", **{k: r[k] for k in (
            "gemm", "numerics", "mnk", "route", "block", "splits", "smem_KiB", "ai", "ms",
            "bound_ms", "bound_by", "library_ms", "launches")}, "nvidia_smi": smi})
    corr = kt["correctness"]
    if any(v != 0 for k, v in corr.items() if k.endswith("_raw")):
        raise AssertionError(f"bench correctness: an integer kernel is not exact: {corr}")
    emit({"phase": "bench_correctness", "max_abs_err": corr,
          "integer_kernels_exact": True})
    lenet, tfm, lsw, tsw = got["precision_drift"]
    emit({"phase": "bench_precision", "verdicts": {
        "lenet_one_quantize_one_dequantize_a_forward":
            lenet["quantize_calls"] == lenet["dequantize_calls"] == lenet["batches"],
        "lenet_q16_bytes_ratio": lenet["bytes_ratio"],
        "qwen2_q16_bytes_ratio": tfm["per_token_bytes_q16"] / tfm["per_token_bytes_float"],
        "lenet_int8_layers": lsw["int8_layers"],
        "int8_half_bytes_exact": kt["precision_dse"]["int8_half_bytes_exact"],
        "lenet_mixed_argmax_agreement": lsw["argmax_agreement"],
        "qwen2_plan": tsw["plan"], "qwen2_drift": tsw["drift"],
        "q16_residency_lenet_agreement": kt["q16_residency"]["lenet_argmax_agreement"]},
        "agreement": {row["bench"]: row["argmax_agreement"]
                      for row in got["precision_drift"]}})
    roof = _bench_roofline(got["roofline_report:baseline"]["rows"])
    for r in roof:
        emit({"phase": "bench_roofline", **r})
    emit({"phase": "bench_scripts", "seconds": time.perf_counter() - t0,
          "modules": sorted(got), "run_tail": res.stdout.strip().splitlines()[-4:],
          "nvidia_smi": smi})
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)


# -- --serve-mesh-nccl: meshed serving over NCCL on four cards ----------------

SERVE_NCCL_CARDS = 4
#: the scheduler runs' trace: 4 slots (a whole KV cache on every "model"
#: rank), ladder (256, 512), 6 requests of 64-512 prompt tokens and up to
#: 16 new ones: qwen2.5-32b's 65.5 GB of bf16 weights plus this cache and
#: its activations fit one card, which the byte-for-byte gate needs
SERVE_NCCL_SLOTS = 4
SERVE_NCCL_LADDER = (256, 512)
SERVE_NCCL_REQUESTS = 6
SERVE_NCCL_MAX_NEW = 16
#: the VLM through compiled_steps(mesh=): 2 x 4096 prompt tokens (its
#: prefill runs flash at head dim 128) after a 2 x 1600 x 8192 image
#: context, then 16 greedy decode steps
SERVE_NCCL_VLM_BATCH = 2
SERVE_NCCL_VLM_PROMPT = 4096
SERVE_NCCL_VLM_STEPS = 16
#: (config, rule overrides on DECODE_RULES, path, depth the one-card
#: bitwise check cuts it to (None: full depth on one card too)); the
#: overrides mirror the configs' serve_rule_overrides as far as column
#: parallelism goes (mesh (1, 4) over ("data", "model"))
SERVE_NCCL_RUNS = (
    ("qwen2.5-32b", (), "scheduler", None),
    ("phi3.5-moe-42b-a6.6b", (("expert_mlp", "model"),), "scheduler", 8),
    ("llama-3.2-vision-90b", (("embed", "model"),), "steps", 10),
)


def _nccl_sched_run(torch, cfg, params, mesh, rules, capture):
    """One scheduler run of ``--serve-mesh-nccl`` (``mesh`` None: one card):
    warm-up, the trace; the streams, each picked token's logits row (on the
    card), each decode step's ms and collectives, the decode steps by kind
    and the captures warm-up and trace made."""
    from repro_torch.core.template import default_template
    from repro_torch.launch.scheduler import (CAPTURE_COUNTS, SchedulerConfig, ServeScheduler,
                                              VirtualClock, replay_trace, synthetic_trace)

    caps0 = sum(CAPTURE_COUNTS.values())
    sched = ServeScheduler(cfg, params, tpl=default_template("cuda"), clock=VirtualClock(),
                           mesh=mesh, rules=rules, capture=capture,
                           sched=SchedulerConfig(ladder=SERVE_NCCL_LADDER,
                                                 slots=SERVE_NCCL_SLOTS,
                                                 max_new_limit=SERVE_NCCL_MAX_NEW))
    rows = []
    sched.logit_sink = lambda req, row: rows.append(row.detach().clone())
    sched.warmup()
    counted = _counted_decode(torch, sched)
    trace = synthetic_trace(SERVE_NCCL_REQUESTS, seed=SEED, vocab=cfg.vocab,
                            ladder=SERVE_NCCL_LADDER, max_new=SERVE_NCCL_MAX_NEW,
                            min_len=SHARDS_MIN_LEN)
    t1 = time.perf_counter()
    replay_trace(sched, trace, tick=0.0)
    torch.cuda.synchronize()
    rec = dict(counted, trace_s=time.perf_counter() - t1,
               streams=[list(r.generated) for r in trace], logit_rows=torch.stack(rows),
               completed=int(sched.counters["completed"]),
               decode_steps=int(sched.counters["decode_steps"]),
               eager_steps=int(sched.counters["meshed_eager_decode_steps"]),
               replayed_steps=int(sched.counters["meshed_replayed_decode_steps"]),
               captures=sum(CAPTURE_COUNTS.values()) - caps0)
    sched.release()
    return rec


def nccl_serve(payload, rank=0, world=1, dev=None):
    """``payload["runs"]`` of ``SERVE_NCCL_RUNS``' shape, each on this rank's
    share of a (1, ``world``) mesh, eager (``capture=False``) and then
    captured (a CUDA graph a signature, replayed), or (``payload["meshed"]``
    false) on one card: weights drawn as this rank's shards from the seed,
    then the scheduler's trace or the VLM's steps.  Per run and mode: the
    streams (and the steps' logits), prefill and decode ms, collectives a
    decode step by kind, captures; whether the captured logits equal the
    eager ones bit for bit; the card's peak memory.  An out-of-memory error
    is raised with the peak."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.scheduler import serve_shardings
    from repro_torch.parallel.sharding import DECODE_RULES

    dev = torch.device(dev or "cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = Mesh((1, world), ("data", "model")).init_groups() if payload["meshed"] else None
    modes = (("eager", False), ("captured", True)) if mesh is not None else (("one", True),)
    out = {}
    for name, overrides, path, depth in payload["runs"]:
        t0 = time.perf_counter()
        cfg, reduced_line = family_cfg(name, depth)
        rules = DECODE_RULES.with_overrides(**dict(overrides)) if mesh is not None else None
        torch.cuda.reset_peak_memory_stats(dev)
        where = "init"
        try:
            params = family_params(torch, dev, cfg, shardings=None if mesh is None else
                                   serve_shardings(cfg, mesh, rules))
            torch.cuda.synchronize(dev)
            rec = {"init_s": time.perf_counter() - t0, "reduced": reduced_line,
                   "weights_bytes_on_card": torch.cuda.memory_allocated(dev)}
            for mode, capture in modes:
                where = f"{path} {mode}"
                if path == "scheduler":
                    run = _nccl_sched_run(torch, cfg, params, mesh, rules, capture)
                    logits = run.pop("logit_rows")
                else:
                    from repro_torch.data.pipeline import synthetic_batch
                    from repro_torch.launch.serve import draw_context

                    b, n = SERVE_NCCL_VLM_BATCH, SERVE_NCCL_VLM_STEPS
                    tokens = synthetic_batch(SEED, 0, b, SERVE_NCCL_VLM_PROMPT, cfg.vocab,
                                             device=dev)
                    ctx = draw_context(cfg, b, seed=SEED, device=dev,
                                       dtype=params["embed"].dtype)
                    run = family_mesh_steps(torch, cfg, params, tokens, ctx, mesh, rules,
                                            steps=n, capture=capture)
                    run["completed"] = n
                    logits = run["logits"]
                    del tokens, ctx
                if mode == "eager":  # kept only to hold the captured run to
                    eager_logits = logits
                    run.pop("logits", None)
                elif mode == "captured":
                    run["logits_equal_eager"] = bool(torch.equal(logits.to(dev),
                                                                 eager_logits.to(dev)))
                rec[mode] = run
                torch.cuda.empty_cache()
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError("SERVE_NCCL_OOM " + json.dumps({
                "rank": rank, "arch": name, "where": where,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "error": str(e)[:300]}))
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        rec["seconds"] = time.perf_counter() - t0
        out[(name, depth)] = rec
        del params
        torch.cuda.empty_cache()
    return out


def _nccl_row(rec) -> dict:
    """The printed numbers of one run: prefill tokens/s, decode ms a step
    (the median after the first step), collectives a decode step (the last
    step's), captures."""
    ms = sorted(rec["decode_ms"][1:] or rec["decode_ms"])
    return {"prefill_tokens_per_s": rec["prefill_tokens"] / (sum(rec["prefill_ms"]) / 1e3),
            "prefill_ms": rec["prefill_ms"], "decode_ms_per_step_median": ms[len(ms) // 2],
            "decode_ms_per_step": rec["decode_ms"],
            "collectives_per_decode_step": rec["collectives"][-1] if rec["collectives"]
            else None, "captures": rec["captures"]}


def phase_serve_mesh_nccl(torch):
    """``--serve-mesh-nccl``, run alone: meshed serving over NCCL on four
    cards, a rank each, mesh (1, 4); every meshed run eager
    (``capture=False``), then captured (one CUDA graph a signature on each
    rank, the collectives inside, replayed every step), in the same call on
    the same weights.  (a) qwen2.5-32b at full width and depth through the
    meshed scheduler under ``DECODE_RULES`` against the same scheduler on
    one card: streams byte for byte, eager and captured.  (b) phi3.5-moe
    (scheduler, expert_mlp over "model") and llama-3.2-vision-90b
    (``compiled_steps(mesh=)``, embed over "model", cross gates 0.5) at
    full width and depth on the four cards: every request or step
    completes, finite logits, the captured logits the eager ones bit for
    bit, each card's peak memory under the card's; then each cut to a depth
    one card holds (same widths) on four cards and on one: streams (and the
    VLM's logits) bit for bit.  Captured: every decode step a replay, one
    capture a (signature, owner) on each rank.  Printed for each: each
    card's peak memory, prefill tokens/s, eager and replayed decode ms a
    step, captures a rank, collectives a replayed decode step by kind."""
    from repro_torch.launch.mesh import spawn_ranks

    cards = torch.cuda.device_count()
    if cards < SERVE_NCCL_CARDS:
        raise AssertionError(f"--serve-mesh-nccl needs {SERVE_NCCL_CARDS} cards, this "
                             f"machine has {cards}")
    t0 = time.perf_counter()
    full = [(n, o, p, None) for n, o, p, _ in SERVE_NCCL_RUNS]
    cut = [(n, o, p, d) for n, o, p, d in SERVE_NCCL_RUNS if d is not None]
    ranks = spawn_ranks(functools.partial(nccl_serve, {"runs": full + cut, "meshed": True}),
                        SERVE_NCCL_CARDS, device="cuda")
    ranks_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    # one card: the configs it holds whole, and the depth cuts
    one = nccl_serve({"runs": [(n, o, p, None) for n, o, p, d in SERVE_NCCL_RUNS
                               if d is None] + cut, "meshed": False})
    one_s = time.perf_counter() - t1
    limit = torch.cuda.get_device_properties(0).total_memory
    for name, overrides, path, depth in full + cut:
        key = (name, depth)
        recs = [r[key] for r in ranks]
        peaks = [r["peak_mem_bytes"] for r in recs]
        eager, captured = [r["eager"] for r in recs], [r["captured"] for r in recs]
        row = {"arch": name, "reduced": recs[0]["reduced"], "path": path,
               "rules": "DECODE_RULES" + "".join(f" + {a} -> {b}" for a, b in overrides),
               "mesh": {"data": 1, "model": SERVE_NCCL_CARDS}, "backend": "nccl",
               "peak_mem_bytes_by_card": peaks, "card_memory_bytes": limit,
               "weights_bytes_by_card": [r["weights_bytes_on_card"] for r in recs],
               "init_s": recs[0]["init_s"], "seconds": recs[0]["seconds"],
               "eager": _nccl_row(eager[0]), "captured": _nccl_row(captured[0]),
               "captures_by_rank": [r["captures"] for r in captured]}
        want_done = SERVE_NCCL_REQUESTS if path == "scheduler" else SERVE_NCCL_VLM_STEPS
        if not (all(r["completed"] == want_done for r in eager + captured)
                and max(peaks) < limit):
            raise AssertionError(f"serve nccl {name} ({depth}): completed "
                                 f"{[r['completed'] for r in eager + captured]} of "
                                 f"{want_done}, peaks {peaks}")
        if not all(r["logits_equal_eager"] for r in captured):
            raise AssertionError(f"serve nccl {name} ({depth}): the captured logits differ "
                                 f"from the eager meshed step's")
        if path == "scheduler":
            # warm-up captures the one decode graph; every trace step replays it
            if any(r["eager_steps"] != r["decode_steps"] or r["captures"] for r in eager) or \
                    any(r["replayed_steps"] != r["decode_steps"] or r["eager_steps"] or
                        r["captures"] != 1 for r in captured):
                raise AssertionError(f"serve nccl {name}: eager {eager[0]['eager_steps']} / "
                                     f"replayed {captured[0]['replayed_steps']} of "
                                     f"{captured[0]['decode_steps']} steps, captures "
                                     f"{row['captures_by_rank']}")
            if any(a["streams"] != b["streams"] for a, b in zip(eager, captured)):
                raise AssertionError(f"serve nccl {name} ({depth}): captured streams differ "
                                     f"from the eager meshed streams")
        else:
            if any(r["captures"] for r in eager) or any(r["captures"] != 1 for r in captured):
                raise AssertionError(f"serve nccl {name}: captures {row['captures_by_rank']}")
            if not all(bool(torch.isfinite(torch.as_tensor(r["logits"])).all())
                       for r in captured):
                raise AssertionError(f"serve nccl {name}: logits not finite")
        if key in one:
            single = one[key]["one"]
            if path == "scheduler":
                same = all(r["streams"] == single["streams"] for r in eager + captured)
            else:
                same = all(torch.equal(torch.as_tensor(r["logits"]), single["logits"]) and
                           torch.equal(torch.as_tensor(r["tokens"]), single["tokens"])
                           for r in captured)
            if not same:
                raise AssertionError(f"serve nccl {name} ({depth}): four cards differ from "
                                     f"one card")
            row["bit_identical_to_one_card"] = True
            row["one_card"] = _nccl_row(single)
        if path == "scheduler":
            row["tokens"] = sum(len(x) for x in captured[0]["streams"])
            row["sample_stream"] = captured[0]["streams"][0][:8]
        emit({"phase": "serve_mesh_nccl", **row, "captured_logits_equal_eager": True,
              "nvidia_smi": nvidia_smi()})
    emit({"phase": "serve_mesh_nccl_done", "ranks_seconds": ranks_s, "one_card_seconds": one_s,
          "seconds": time.perf_counter() - t0})


#: ``--parent-ab``: the trees' order, each run in a process of its own, the
#: steps of its single-device run, and its replayed decodes at full depth
#: (config, rows, prompt length)
AB_ORDER = ("parent", "this", "this", "parent")
AB_ONE_DEVICE_STEPS = 4
AB_DECODE_RUNS = (("recurrentgemma-9b", 2, 4096), ("whisper-medium", 2, 432),
                  ("mamba2-1.3b", 2, 4096))


def ab_replayed_decode(torch, dev) -> dict:
    """``--parent-ab``'s replayed single-card decode: each of
    :data:`AB_DECODE_RUNS` at full depth from the seed's weights, prefilled,
    then one ``compiled_steps`` decode step replayed; {config: ms a step}."""
    from repro_torch.configs import get_config
    from repro_torch.core.template import default_template
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.scheduler import compiled_steps
    from repro_torch.launch.serve import draw_context
    from repro_torch.models import transformer as T

    out = {}
    for name, b, s in AB_DECODE_RUNS:
        cfg = get_config(name)
        tpl = default_template("cuda")
        params = family_params(torch, dev, cfg)
        tokens = synthetic_batch(SEED, 0, b, s, cfg.vocab, device=dev)
        ctx = draw_context(cfg, b, seed=SEED, device=dev, dtype=T._dtype(cfg.dtype))
        _, cache = T.prefill(tpl, cfg, params, tokens, ctx=ctx, cache_len=s + FAMILY_GEN)
        fns = compiled_steps(tpl, cfg, s + FAMILY_GEN, None)
        tok = tokens[:, -1:]
        out[name] = time_ms(lambda: fns.decode_next(params, tok, s, cache), target_ms=300.0)
        fns.decode_next.release(None)
        del params, cache
        torch.cuda.empty_cache()
    return out


def ab_rank(payload, rank, world, dev):
    """One of an A/B run's two ranks on the card: phase 9's tensor-parallel
    scheduler runs (float, then grid, no plan store), then phase 12's FSDP
    run (``train.main`` on ``payload["argv"]``); rank 0 returns each
    part's times."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh

    out = {}
    cfg = get_config(QWEN_ARCH)
    params = qwen_params(torch, dev, cfg)
    tp = Mesh((1, world), ("data", "model")).init_groups()
    for numerics, pol in (("float", None), ("grid", payload["grid_policy"])):
        t0 = time.perf_counter()
        rec = shards_serve(torch, cfg, params, pol, tp, None)
        out[numerics] = {"decode_ms": rec["decode_ms"], "streams": rec["streams"],
                         "meshed_eager_steps": rec["meshed_eager_steps"],
                         "seconds": time.perf_counter() - t0}
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats, losses = train.main(payload["argv"])
    out["fsdp"] = {"step_ms": [x * 1e3 for x in stats["step_seconds"]],
                   "losses": list(losses), "grad_norms": list(stats["grad_norms"]),
                   "peak_mem_bytes_by_rank": stats.get("peak_mem_bytes_by_rank"),
                   "seconds": time.perf_counter() - t0}
    return out if rank == 0 else None


def phase_ab_run(torch, dev, src: str):
    """One run of ``--parent-ab`` on the port at ``src`` (this process's
    ``repro_torch``): phase 11a's single-device run for
    :data:`AB_ONE_DEVICE_STEPS` steps, :func:`ab_replayed_decode`, the grid
    policy calibrated as phase 5 does, then :func:`ab_rank` on two ranks;
    prints one ``ab_run`` line."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.template import default_template
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    torch.zeros(1, device=dev)  # the allocator's stats need a context (phase 1 makes one)
    work = Path(tempfile.mkdtemp(prefix="ab_run_", dir=ROOT / "build"))
    try:
        stats, losses = train.main(["--arch", TRAIN_ARCH, *TRAIN_ARGV, "--device", str(dev),
                                    "--steps", str(AB_ONE_DEVICE_STEPS), "--ckpt-every", "0",
                                    "--ckpt-dir", str(work / "one")])
        one = {"step_ms": [x * 1e3 for x in stats["step_seconds"]], "losses": list(losses),
               "seconds": time.perf_counter() - t0}
        torch.cuda.empty_cache()
        decode = ab_replayed_decode(torch, dev)
        cfg = get_config(QWEN_ARCH)
        params = qwen_params(torch, dev, cfg)
        cal = synthetic_batch(SEED + 1, 7, 2, QWEN_PROMPT_LEN, cfg.vocab, device=dev)
        policy = T.calibrate_policy(default_template("q16"), cfg, params, cal)
        del params, cal
        torch.cuda.empty_cache()
        argv = ["--arch", TRAIN_ARCH, *TRAIN_ARGV, "--device", str(dev), "--mesh", "single",
                "--ranks", str(MESH_RANKS), "--ckpt-every", "0",
                "--steps", str(MESH_STEPS["fsdp"]), "--ckpt-dir", str(work / "fsdp")]
        t1 = time.perf_counter()
        out = spawn_ranks(functools.partial(ab_rank, {"grid_policy": policy, "argv": argv}),
                          MESH_RANKS, device=str(dev))[0]
        ranks_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "ab_run", "src": src, "one_device": one, "replayed_decode_ms": decode,
          **out, "ranks_s": ranks_s, "seconds": time.perf_counter() - t0})


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def phase_parent_ab(torch, parent: Path):
    """``--parent-ab``: :func:`phase_ab_run` on ``parent``'s port and on
    this one's, each in a subprocess, in :data:`AB_ORDER`; prints each
    run's decode ms a step (median over the trace), FSDP ms a step, the
    seconds of each part, and whether every run's streams and FSDP losses
    equal the first run's."""
    from repro_torch.kernels import _build

    if not (parent / "src" / "repro_torch").is_dir():
        raise RuntimeError(f"--parent-ab: no src/repro_torch under {parent}")
    lib_dir = parent / "build" / _build.BUILD_DIR.name
    lib_dir.mkdir(parents=True, exist_ok=True)
    for lib in _build.BUILD_DIR.glob("lib*.so"):
        shutil.copy2(lib, lib_dir / lib.name)  # same sources, same digest: no rebuild
    t0 = time.perf_counter()
    runs = []
    for which in AB_ORDER:
        src = (parent if which == "parent" else ROOT) / "src"
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--ab-run",
                               str(src)], capture_output=True, text=True, timeout=900)
        line = next((ln for ln in reversed(proc.stdout.splitlines())
                     if ln.startswith('{"phase": "ab_run"')), None)
        if proc.returncode != 0 or line is None:
            raise RuntimeError(f"--parent-ab: the {which} run failed (rc {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        rec = json.loads(line)
        losses = rec["fsdp"]["losses"]
        if not all(math.isfinite(x) for x in losses + rec["fsdp"]["grad_norms"]):
            raise AssertionError(f"--parent-ab: the {which} run's FSDP losses {losses}")
        runs.append({"tree": which, **rec})
    first = runs[0]
    rows = [{"tree": r["tree"],
             **{f"{n}_decode_ms_median": _median(r[n]["decode_ms"]) for n in ("float", "grid")},
             **{f"{n}_decode_steps": len(r[n]["decode_ms"]) for n in ("float", "grid")},
             **{f"{n}_s": r[n]["seconds"] for n in ("float", "grid", "fsdp")},
             "one_device_step_ms": r["one_device"]["step_ms"],
             "replayed_decode_ms": r["replayed_decode_ms"],
             "one_device_s": r["one_device"]["seconds"],
             "fsdp_step_ms": r["fsdp"]["step_ms"],
             "fsdp_peak_mem_bytes_by_rank": r["fsdp"]["peak_mem_bytes_by_rank"],
             "run_s": r["seconds"], "ranks_s": r["ranks_s"],
             "streams_equal_first": all(r[n]["streams"] == first[n]["streams"]
                                        for n in ("float", "grid")),
             "fsdp_equal_first": (r["fsdp"]["losses"] == first["fsdp"]["losses"]
                                  and r["fsdp"]["grad_norms"] == first["fsdp"]["grad_norms"]),
             "one_device_equal_first": r["one_device"]["losses"] == first["one_device"]["losses"]}
            for r in runs]
    emit({"phase": "parent_ab", "parent": str(parent), "order": list(AB_ORDER), "runs": rows,
          "fsdp_losses": first["fsdp"]["losses"], "nvidia_smi": nvidia_smi(),
          "seconds": time.perf_counter() - t0})


def _build_kernels():
    from repro_torch.kernels import _build

    return [k for k in _build.KERNELS if "." not in k]


def main() -> int:
    global ROUTE_STUDY, CONV_ROUTE_STUDY, FLASH_PV_STUDY, FLOAT_FLEET_STUDY
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gemm-route-study", action="store_true",
                    help="also time the float GEMM's design alternatives (route "
                         "'tile' beside fc0 and the tied head, the W/L threshold sweep)")
    ap.add_argument("--conv-route-study", action="store_true",
                    help="also time the conv's CUDA-core route beside each timed "
                         "tensor-core row (float, and fixed point at every VGG16 layer)")
    ap.add_argument("--flash-pv-study", action="store_true",
                    help="also build and measure flash's route wgmma with PV accumulated "
                         "in place (spills, time, error against the emulation)")
    ap.add_argument("--float-fleet-study", action="store_true",
                    help="also run phase 7b's replica kill in float and report whether "
                         "the ledger diverged, and at what top-2 margin (not gated)")
    ap.add_argument("--train-mesh-nccl", action="store_true",
                    help="run only the study of training over NCCL on four cards (a "
                         "rank each): qwen2-0.5b data-parallel and FSDP at 8 x 4096 "
                         "tokens against one card, recurrentgemma-9b under FSDP")
    ap.add_argument("--serve-mesh-nccl", action="store_true",
                    help="run only the study of meshed serving over NCCL on four cards (a "
                         "rank each), eager and then captured: qwen2.5-32b's scheduler "
                         "against one card, phi3.5-moe and llama-3.2-vision-90b at full "
                         "depth, each cut to a depth one card holds against one card")
    ap.add_argument("--split-decode-study", action="store_true",
                    help="run only the study of the decode's contractions on the rows of "
                         "every data split (which forms give a rank one device's bits, "
                         "and their ms; not gated)")
    ap.add_argument("--parent-ab", metavar="DIR",
                    help="run only the A/B of phase 11a's single-device step, phase 9's "
                         "tensor-parallel decode and phase 12's FSDP run: the checkout "
                         "at DIR against this one, in the order DIR, this, this, DIR")
    ap.add_argument("--ab-run", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--analyze-single-card", metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    ROUTE_STUDY, CONV_ROUTE_STUDY = args.gemm_route_study, args.conv_route_study
    FLASH_PV_STUDY, FLOAT_FLEET_STUDY = args.flash_pv_study, args.float_fleet_study
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: no src/repro_torch beside this script; run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, args.ab_run or str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; the port's kernels "
              "need an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    if args.ab_run:
        phase_ab_run(torch, dev, args.ab_run)
        return 0
    read_peaks()
    if args.analyze_single_card:
        analyze_single_card(Path(args.analyze_single_card))
        return 0
    phase_card(torch, dev)
    if args.train_mesh_nccl or args.serve_mesh_nccl or args.split_decode_study or \
            args.parent_ab:
        if args.train_mesh_nccl:
            phase_train_mesh_nccl(torch)
        elif args.serve_mesh_nccl:
            phase_serve_mesh_nccl(torch)
        elif args.split_decode_study:
            phase_split_decode_study(torch, dev)
        else:
            phase_parent_ab(torch, Path(args.parent_ab).resolve())
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        print(nvidia_smi(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    book = KernelBook()
    dryrun_cli = start_dryrun_cli()
    single_card_analysis = start_single_card_analysis()
    phase_kernels(torch, dev, book)
    phase_kernels_serving(torch, dev, book)
    if ROUTE_STUDY:
        phase_wgmma_threshold(torch, dev)
    if FLASH_PV_STUDY:
        phase_flash_pv_study(torch, dev)
    torch.cuda.empty_cache()
    runs, cnn_launches = phase_main_path(torch, dev)
    phase_timing(torch, runs)
    phase_profile(torch, runs)
    # phase 9's weights: each net's float tree, input and calibrated grid
    cnn_state = {net: (next(r[4] for r in runs if r[0] == net and r[1] == "float"),
                       next(r[5] for r in runs if r[0] == net),
                       next(r[6] for r in runs if r[0] == net and r[1].startswith("grid")))
                 for net in SHARDS_NETS}
    del runs
    torch.cuda.empty_cache()
    cfg, params, prompts, serving_runs, serving_windows = phase_serving(torch, dev)
    prefill_profiles = phase_serving_timing(torch, cfg, params, prompts, serving_runs)
    torch.cuda.empty_cache()
    # the scheduler phase serves float and the grid (q8 runs through phase 5)
    serving_windows.update(phase_scheduler(
        torch, cfg, params, [r for r in serving_runs if not r[0].startswith("q8")]))
    torch.cuda.empty_cache()
    phase_measure_and_pin(torch, dev)
    _, tq, grid_policy = next(r for r in serving_runs if r[0].startswith("grid"))
    serving_windows["fleet grid"] = phase_fleet(torch, cfg, params, tq, grid_policy)
    if FLOAT_FLEET_STUDY:
        phase_float_fleet_study(torch, cfg, params, serving_runs[0][1])
    shard_windows = phase_shards(torch, dev, cnn_state, grid_policy)
    del params, serving_runs, tq, grid_policy, cnn_state
    torch.cuda.empty_cache()
    family_windows = phase_families(torch, dev)
    torch.cuda.empty_cache()
    train_windows, _, train_profile = phase_training(torch, dev)
    torch.cuda.empty_cache()
    phase_train_mesh(torch, dev)
    torch.cuda.empty_cache()
    dryrun_window = phase_dryrun(torch, dev, book, dryrun_cli, single_card_analysis,
                                 {"prefill": prefill_profiles["float"], "train": train_profile})
    phase_serve_cli(torch)
    phase_fleet_cli(torch)
    phase_bench_scripts(torch)

    windows = {"cnn": cnn_launches, **{f"qwen2 {k}": v for k, v in serving_windows.items()},
               **shard_windows, **family_windows, **train_windows,
               "dryrun cells": dryrun_window}
    kernels = []
    for key, (name, gemm_route, source, replaces) in KERNEL_META.items():
        row = book.rows[key]
        by_path = {path: w[key] for path, w in windows.items() if w[key]}
        if not by_path:
            raise AssertionError(f"kernel {key} was not launched on any main path")
        route_key = {"conv2d": "conv_route", "conv2d_q16": "conv_route",
                     "flash_attention": "flash_route"}.get(name, "gemm_route")
        kernels.append({
            "name": name, "route": "cuda", route_key: gemm_route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"], "shape": row["shape"], "checks": row["checks"],
            **{k: row[k] for k in ("route_tile_ms", "route_cudacore_ms",
                                   "prep_ms", "bound_note", "bound_f32_ms",
                                   "max_abs_err_vs_split", "bound_bytes_ms",
                                   "bound_limbs_ms", "bound_imad_ms",
                                   "limb_products") if k in row},
        })
        if key in ("matmul_fp.splitk", "matmul_q16.splitk"):
            kernels[-1]["reduce_launches"] = sum(
                w[f"{name}.splitk_reduce"] for w in windows.values())
        if key == "matmul_q16.wgmma":
            kernels[-1]["prep_launches"] = sum(w["matmul_q16.prep"] for w in windows.values())
        if key == "flash_attention.wgmma.d128":
            kernels[-1]["head_dim"] = 128
            kernels[-1]["of_launches"] = "flash_attention.wgmma (a part of its launches)"
        if key == "flash_attention.wgmma":
            kernels[-1]["prep_launches"] = sum(
                w["flash_attention.prep"] for w in windows.values())
            kernels[-1]["routes"] = FLASH_ROUTES
            kernels[-1]["simt_checks"] = book.rows["flash_attention.simt"]["checks"]
            kernels[-1]["simt_max_abs_err"] = book.rows["flash_attention.simt"]["max_abs_err"]
        if key in ("conv2d.tc", "conv2d_q16.tc"):
            kernels[-1]["prep_launches"] = sum(w[f"{name}.tc_prep"] for w in windows.values())
            kernels[-1]["reduce_launches"] = sum(
                w[f"{name}.tc_reduce"] for w in windows.values())
    if {k["name"] for k in kernels} != set(_build_kernels()):
        raise AssertionError("the kernels line does not list every kernel")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

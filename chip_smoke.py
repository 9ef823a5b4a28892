#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the script (non-zero exit, no "ok" line):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together); report each kernel's registers and spills, and hold
   the bf16 blockwise kernels (forward, dq, dk/dv) to ``HGMMA`` (wgmma) in
   their machine code (``cuobjdump``) and to a ``wgmma`` chain ptxas did
   not serialize, and every SPARC kernel and the float32 attention forward
   (``attention_fwd_tf32<64|32|16>``) and backward
   (``attention_bwd_dq_tf32<...>``, ``attention_bwd_dkdv_tf32<...>``) to
   TF32 ``HMMA`` (``mma.sync``) in its machine code and to no spills; count
   the fused attention kernels' machine instructions;
3. each kernel against its plain PyTorch version on the card, with its
   time, the plain version's, the one-call PyTorch yardstick's where there
   is one (never called by the port) and the least time the card could
   take (its bound):
   - the attention forward at the serving shapes (B=64 and B=1, bf16 and
     fp32; q, k, v both as contiguous per-projection tensors, as the model
     passes them, and as strided slices of one fused projection), and at
     S=77 H=4 with Dh=32 and Dh=16, causal and not; its output and, as the
     train path asks for it, its log-sum-exp; against
     ``scaled_dot_product_attention``; the float32 rows bounded on the TF32
     tensor cores (three TF32 products for each fp32 one, as the kernel
     takes them) with the fp32-core bound beside it;
   - the attention backward at the train shapes (B=32: ViT-B/16 vision,
     the causal text tower and the Dh=32 / Dh=16 rows; the count loss's
     counterfactual text tower, B=288 S=77 H=8 causal; bf16 and fp32, both
     layouts), fed the forward kernel's log-sum-exp, against the backward
     alone of ``scaled_dot_product_attention``, the float32 rows bounded on
     the TF32 tensor cores with the fp32-core bound beside it;
   - both attention kernels on fully masked rows (B=32, S=197 and the
     causal S=77, bf16 and fp32; sample 0 masks every key): against the
     plain versions, and the rows against the TPU's Σv / Sp and its dv
     Σdo / Sp over Sp = round_up(S, 8) keys;
   - the SPARC pooling forward and backward at the train shapes (B=32,
     T=77, P=197 and P=50, D=512, fp32) and on an edge batch (fully masked
     rows, a zero patch, duplicated patches), with no library yardstick;
     the forward's saved sim, rl and rv against the plain version's, and
     the backward fed them, as the train path feeds it;
   - "int8": the quantize and dequantize kernels (``quant_rows``,
     ``quant_cols_t``, ``dequant``, ``csrc/quant.cu``) bit-equal to their
     plain versions in bf16 and fp32 at the slice's operand shapes
     (ViT-B/16's vision microbatch M=6304 with 768 and 3072, the patch
     embedding's M=6272, text M=2464 with 512 and 2048, the weights, and
     M=308 and 788, no multiples of 8), with their times at the timed
     shapes; ``torch._int_mm`` against bf16 ``torch.matmul`` at every
     product shape (forward, dgrad, int8 wgrad); ``quant_linear``'s
     forward and backward against its plain version on the card in both
     modes (output, dx, db and the int8 dW bit-equal; switchback's float
     dW within one step of its type); ``perf/int8_microbench.py``'s
     GEMM-set table; the split passes of a dimension split over ranks
     (``absmax_rows``, ``absmax_cols``, ``quant_rows_given``,
     ``quant_cols_t_given``) bit-equal to their plain versions at the same
     shapes, the split path (reduce, then quantize with the absmax) bit
     equal to the fused passes, and their times at x [6304, 768] bf16 with
     their bounds;
4. the serving main path: ViT-B/16 at full width with random weights from
   a numpy seed, served by ``ClipServer`` on the card behind its HTTP
   server on 127.0.0.1; every endpoint must answer 200 with finite
   unit-norm rows, the forward kernel's launch count must equal the encoder
   layers the bucket forwards ran, and the served embeddings must match
   the port run in fp32 on the CPU;
5. device rates of ``CLIPInference`` at bucket 64
   (``perf/serve_bench.py``'s lines) and the HTTP p50;
6. the train main path: SPARC + AdamSPD train steps on ViT-B/16 at full
   width (random weights from the same seed), microbatch 32 x accum 8,
   inverse temperature 0.07, as ``bench.py`` runs the JAX package. One step
   counted: 24 x accum attention forward and backward launches and accum
   SPARC forward and backward launches; every step's loss and gradient
   norm finite and the parameters moved; one microbatch of 4 pairs on the
   card in bf16, then in fp32 (``use_amp=False``: the fp32 attention
   kernels), against the port in fp32 on the CPU (loss, gradient norm,
   per-tensor gradient cosine, each dtype with limits of its own); then the
   step time, pairs/s, model-FLOP utilization and a profile of one step;
6b. GradCache (``train/gradcache.py``) on the same model and batch: one
   chunk embedded as phase 1 (no grad) and as phase 3 (grad) must be bit
   equal; the exact launches of a GradCache step (per chunk two forwards
   and one backward of each layer, one SPARC forward and backward over
   the pool); the GradCache step at 32 x 8 (a pool of 256) and phase 6's
   plain step in turns, the median of three each: step ms, pairs/s, peak
   memory, device time and busy share (the plain step's device time from
   phase 6's trace of it); the pool of 1024 (32 x 32): step ms,
   peak memory, exact launches; one direct [1, 256] step's peak memory (or
   its OOM); #3 and #4 at B=256 (timed, with bounds) and B=1024 against
   their plain versions; in fp32, one GradCache [8, 4] step against one
   direct [1, 32] step (loss, gradient norm, per-tensor cosine, limits set
   from the CPU);
6c. int8 training (``TrainConfig.quant``): phase 6's step at 32 x 8 with
   ``quant`` none, switchback and int8, three models from the same weights
   on the same batch: each first step counted (the int8 kernels' exact
   launches, derived from the model's 145 quantized linears and printed
   with the derivation; #1-#4 as none's) with its loss and gradient norm
   beside none's; three rounds of the modes in turns (step ms, pairs/s,
   peak memory), device time and busy share from one traced step each
   (none's is phase 6's trace); one microbatch of 4 pairs in int8 on the
   card (bf16, then fp32) against the CPU in fp32 int8 (QUANT_CHECK_LIMITS,
   set from the CPU before any card reading);
7. long-sequence attention: the three blockwise kernels (forward, dq,
   dk/dv) against their plain versions at the flash microbenchmark's design
   points ([B, 12, S, 64] bf16; S=1024, 2048, 4096 at B=8, 4, 1), a causal
   shared bias (S=2048), head dims 32 and 16 (S=1024, B=2, H=4, causal and
   not) and a ViT-L/14@336 key-padding bias [B, 1, S, S] with a fully
   masked row (S=577, H=16, B=8, also in fp32); their times and TFLOP/s at
   S=2048 B=4 against ``scaled_dot_product_attention``; then the ported
   microbenchmark at the three design points, its launches counted (per
   design point, 2 x (steps + 1) forward and steps + 1 of each backward
   kernel on each of its two paths, and nothing else), and one counted
   forward+backward of ``blockwise_flash_attention`` (exactly one launch of
   each blockwise kernel and none of the others);
8. the training CLI on the card: 512 procedural 224 px samples made by the
   port's ``cli/generate_data.py`` and packed by ``cli/pack_dataset.py``
   in a temporary directory, then three in-process runs of
   ``cli/train.py``'s ``main`` at ViT-B/16 full width, each counted on its
   own: A, packed with the pixel bank on the card, SPARC + AdamSPD at
   32 x 8 for 2 epochs (every epoch loss finite; ``best/``, ``epoch_0/``,
   ``epoch_1/``; the bank a uint8 CUDA tensor; batches carrying
   ``pixel_index``, not pixels; 24 x 8 attention and 8 SPARC launches of
   each kind a step); B, a bare ``--resume`` of A to 3 epochs (the
   restored weights equal ``best/``'s bit for bit, the step count goes on
   from ``best/``'s, launches as A's for the steps it ran); C, live decode
   of the annotations, the count loss with AdamW at 32 x 2 for 1 epoch
   (36 x 2 attention launches a step: the counterfactual captions are one
   more text tower; no SPARC), with ``--eval-every-epoch`` where
   matplotlib is installed (its confusion plots need it; two evaluations
   of 36 forward launches each); D, C's data and loss in fp32
   (``--no-amp``, the reference count fine-tune's forced fp32: the fp32
   attention kernels, 36 x 2 launches each a step, no SPARC); E, A's data
   and flags with ``--grad-cache`` for 1 epoch (a GradCache step's launches
   each step); F, A's ``best/`` exported by ``cli/export_checkpoint.py
   --include-optimizer`` and trained on from that ``.pt`` with
   ``--pretrained --import-optimizer-state`` to B's epochs (the optimizer
   state right after the import equal to ``best/``'s bit for bit, the
   launches as B's, the epoch losses beside B's); G, A's data and flags
   with ``--quant int8`` for 1 epoch (A's #1-#4 launches a step, and the
   int8 kernels' exact launches). It prints
   which image decode ran (the native library or PIL), the live
   pipeline's rate alone, and one
   ``train cli: {...}`` line: steps, epoch losses and epoch pairs/s on the
   host clock (data included), peak memory, build and run seconds and the
   card's line;
9. evaluation on the card: ``cli/evaluate.py``'s ``main`` in process at
   ViT-B/16 full width in fp32, reading the ``best/`` that run A wrote:
   ``countbench`` and ``vlmsblind`` on their procedural fixtures (40 and
   24 samples), ``crop`` on the procedural source (500 samples), batch
   32; then ``evaluate_batch`` on run C's held-out batch (the first of its
   epoch 0). Each counted on its own: exactly 24 forward-kernel launches a
   scorer call (as many calls as the samples and batch size imply), 36 an
   ``evaluate_batch``, no other kernel; every accuracy and score finite in
   [0, 1]. The first scorer call of each subcommand and the held-out batch
   against the port in fp32 on the CPU (same weights; run last, in a
   thread beside phase 10's one-rank NCCL step, which times nothing: the
   lap "9-10"). Then samples/s of
   each subcommand on the host clock (decode and preprocessing included),
   the device time of one scorer call (32 images x 10 templates) with its
   kernel profile, #1 in fp32 at evaluation's shapes (vision B=32, text
   B=320 causal) against SDPA and its bounds (TF32 tensor cores and fp32
   cores), and peak memory. Last, ``best/`` exported with OpenAI
   ``clip``-package names (``cli/export_checkpoint.py --format openai``)
   and ``countbench`` run on that ``.pt``: every probability equal to the
   ``best/`` run's, bit for bit;
10. data parallelism (``parallel/``, ``perf/data_parallel_check.py``) on
   the one card, every rank a process (``parallel/launch.py::spawn``),
   ViT-B/16 at full width, SPARC + AdamSPD in bf16, random weights from
   phase 6's seed: a one-rank NCCL group steps once with global negatives
   and ZeRO-1 through ``make_train_step(mesh=...)``, bit-equal to the same
   step with no mesh (every collective is an identity), and on the same
   group ``quant_linear`` with every dimension split over it (the split
   passes, the MAX and the int32 SUM over NCCL) bit-equal to the fused
   path at vision fc1's and fc2's shapes; then two gloo
   ranks on ``cuda:0`` (NCCL refuses two ranks on one GPU): a probe of
   gloo's collectives on CUDA tensors (values checked; the port's route
   must run), each mode (local negatives, global negatives, ZeRO-1, FSDP;
   16 x accum 2 a rank, 3 steps, 2 + 2 layers: ``DP_LAYERS``) against its
   one-process oracle on the same global batch (the mean of the per-shard steps for local
   negatives, one process at B = 32 for the others) within
   ``DP_LIMITS``, AdamSPD's anchors one step off the weights; ZeRO-1 and
   FSDP also against global negatives replicated on the same ranks (their
   first update within ``DP_SHARD_MAX_FIRST_UPDATE_REL``, which a shard
   reading its own AdamSPD sums fails); each rank's exact launches in its
   first step, step ms and peak memory (two ranks sharing one card over
   gloo: not a scaling figure); run H, ``cli/train.py`` on both ranks with ``--packed
   --device-data --global-negatives --zero1`` for one epoch of phase 8's
   data (every epoch loss finite and equal on both ranks, exact
   launches); ``cli/evaluate.py countbench --data-parallel 2`` on H's
   ``best/`` against one process (every probability within
   ``EVAL_MAX_ABS``, exact launches); and a ``--resume`` of H by one
   process to a second epoch, its restored weights and optimizer state
   equal to ``best/``'s bit for bit. Beside the two ranks, this process
   makes phase 11's int8 oracles on the card (``mp_int8_oracles``);
11. tensor, pipeline and sequence parallelism (``parallel/``,
   ``perf/model_parallel_check.py``) on the one card, gloo ranks on
   ``cuda:0``, ViT-B/16 at full width, SPARC + AdamSPD with global
   negatives in bf16, random weights from phase 6's seed, a global batch
   of 32 x accum 2, the bf16 modes at 2 + 2 layers (``DP_LAYERS``) and
   the int8 ones whole (``MP_SPAWNS``): ``tp2`` (1 x 2 x 1, 6 vision and 4 text heads a
   rank) and ``pp2`` (1 x 1 x 2, 4 GPipe microbatches) on two ranks, then
   ``tp2pp2`` (1 x 2 x 2) and ``dp2tp2`` (2 x 2 x 1 with FSDP) on four,
   3 steps each against a one-process oracle on the same global batch
   (phase 10's global-negatives oracle, the same weights and batch)
   within ``MP_LIMITS`` (set from the CPU before any card reading),
   AdamSPD's anchors one step off the weights; each rank's exact launches
   of #1-#4 in its first step, step ms and peak memory (ranks sharing one
   card over gloo: not a scaling figure); sequence parallelism
   (``perf/sequence_parallel_check.py``) the same way: ``sp2`` (1 x 2,
   GSPMD SP: the tokens split over the two ranks, K and V gathered) and
   ``sp2-ring`` (ring attention) on the two ranks, ``dp2sp2-ring`` (2 x 2,
   FSDP) on the four, within ``SP_LIMITS`` (set from the CPU before any
   card reading), with exact launches: no #1 or #2 (the SP attention is
   PyTorch, as JAX's is XLA), #3 and #4 once a train microbatch; int8
   training (``quant="int8"``, the scales JAX's GSPMD step takes) the same
   way: ``tp2-int8`` and ``sp2-int8`` (in fp32, where a limit sees its
   scales) on the two ranks, ``dp2tp2-int8`` (FSDP) on the four, against a
   one-process oracle in int8 and the mode's dtype from the same weights
   (made in phase 10; it takes the fused passes: its split-pass launches
   must be 0) within ``INT8_LIMITS`` (set from the CPU before any card
   reading), each rank's launches of the seven int8 kernels exact; run J,
   ``cli/train.py --sequence-parallel 2 --sp-ring --global-negatives`` and
   run K, ``cli/train.py --model-parallel 2 --quant int8
   --global-negatives``, on the two ranks, and run I, ``cli/train.py
   --model-parallel 2 --pipeline-parallel 2 --global-negatives`` on the
   four, each for one epoch of phase 8's data (every epoch loss finite and
   equal on every rank, exact launches), then a ``--resume`` of I and J by
   one process (its epoch done: no step), its restored weights and
   optimizer state equal to ``best/``'s bit for bit (K's resume is left
   out for the time limit: I's and J's go through the same code). Phase 3
   holds #1 and #2 at this phase's shapes (``MP_ATTENTION_SHAPES``: H/2
   heads, B/4 rows) against their plain versions, bf16 and fp32, with
   their times.

Phase "tools" (after 6c) runs the port's measuring tools (``perf/``), each
line finite and naming the card: ``perf/bench.py`` at ViT-B/32 128 x 4 and
with the count loss (ViT-B/16 32 x 8), ``TOOLS_STEPS`` steps each, their
launches exact (the warm-up and the steps: every microbatch's layers,
forward and backward, and the SPARC pooling); ``perf/serve_http_bench.py``
at 8 clients x 5 requests (#1 alone launched, every request answered, the
batches filled); ``perf/sparc_microbench.py`` at B=32 and 256 (exact
launches). Its ViT-B/16 SPARC 32 x 8 line is phase 6's timed steps
(``perf/bench.py``'s ``time_steps`` and ``result_line``), its
``serve_bench`` lines phase 5's device rates, and its ``profile_step`` and
``trace_report`` phase 6's profile: one step in ``perf/profile_step.py``'s
window, its Chrome trace written, timed and read back by
``perf/trace_report.py`` (the file's device time must equal the live
rows'). Phase 3 holds #1 and #2 (bf16) and #3 and #4 at those models'
train microbatches too (``TOOLS_ATTENTION_SHAPES``, ``SPARC_SHAPES``:
ViT-B/32 at B=128, ViT-L/14 at B=32 with P=257, D=768).

The last lines are the kernels' JSON line (``launches_by_path`` has
``serve``, ``train``, ``long``, ``train_cli`` (runs A-D), ``eval``,
``gradcache`` (phase 6b's counted steps), ``train_cli_gradcache`` (run E),
``train_cli_interop`` (run F), ``eval_openai``, ``train_quant`` (phase
6c's counted steps), ``train_cli_quant`` (run G), ``data_parallel``
(phase 10: both ranks' counted steps, run H, its resume and both
evaluations), ``model_parallel`` (phase 11: every rank's counted
steps, runs I, J and K and the resumes) and ``tools`` (the tools phase's
runs); the forward kernel's
entry also carries its ``fp32_eval`` rows, #1 and #2 their
``model_parallel_shapes`` rows, the backward its
``fp32_train`` rows, the SPARC kernels' their ``gradcache_pool`` row at
B=256), the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero before any
result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection

# The port's own timers and the card's name line (the measuring tools'
# shared helpers); without the package beside this script, it stops here.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from clip_finegrained_alignment_tpu_torch.perf._measure import (  # noqa: E402
    cuda_time_ms, gpu_line, graph_ms)
from clip_finegrained_alignment_tpu_torch.perf.bench import \
    bench_batch  # noqa: E402

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,  # bf16 tensor, fp32 CUDA cores
              "tf32": 495e12}                        # TF32 tensor

SEED = 0
BUCKET = 64
# Kernel vs plain version (fp32 reference from the same inputs).
#   fp32: 1e-4 — same arithmetic, other summation order and an online
#     softmax (measured ~1e-6 at O(1) outputs).
#   bf16: 2e-2 — the output is rounded to bf16: half a step at |o| < 4 is
#     2^-7 ≈ 0.008; inputs are the same bf16 values on both sides.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Served bf16 embeddings vs the port in fp32 on the CPU (unit vectors of
# 512): two runs on an H100 read min cosine 0.99993 and max abs 1.85e-3 at
# worst over both towers. The limits are about 8x the cosine gap and 3x the
# abs error, so 12 layers of bf16 rounding pass and a wrong layer does not.
EMBED_MIN_COSINE = 0.9995
EMBED_MAX_ABS = 5e-3
# Attention backward vs its plain version (same inputs), per element:
# |err| <= rtol·|ref| + atol·max|ref|.
#   bf16: rtol 1e-2 (one bf16 step is at most 2^-7 ≈ 0.8 % of the value: the
#     two sides round the same fp32 math at the same places and differ where
#     a value lands near a rounding boundary) + atol 1e-3 of the largest
#     gradient (elements the fp32 sums move across zero);
#   fp32: 1e-4 and 1e-5 (other summation order; dq is formed as
#     (Σ p·dp·k − r·Σ p·k)/l, which cancels in fp32).
BWD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-5)}
# SPARC kernels vs their plain versions, fp32, absolute. Outputs and
# gradients are O(1); the two sides differ by summation order (~1e-7). A
# token row whose threshold decision (|z − τ| < 1e-5) or min/max choice
# (two distinct masked similarities within 1e-6) lies within fp32 rounding
# can flip between the two sides and change that row's weights by a whole
# entry; such rows (and, for dv, their batch elements) are left out of the
# comparison, counted, and may be at most 1 % of the rows.
SPARC_TOL = 1e-4
SPARC_MAX_NEAR_SHARE = 0.01
# The forward kernel's saved sim (absolute; cosines, summed in another
# order and as 3xTF32 products, ~1e-7 apart) and inverse norms rl, rv
# (relative: a zero row's is 1e12) against the plain version's.
SPARC_RESIDUAL_TOL = 1e-5
TRAIN_B, TRAIN_ACCUM = 32, 8
# Steps each perf/bench.py run of the tools phase times (phase 6's too).
TOOLS_STEPS = 3
# Train step, one microbatch of 4 pairs: the card in bf16 against the port
# in fp32 on the CPU, same weights and batch. The first readings on an
# H100 (PERF.md): loss relative difference 3.3e-7, gradient norm 4.2e-4,
# smallest per-tensor gradient cosine 0.99949 (median 0.99985) over 371
# tensors, key-projection bias gradients 3.2e-6 of the global norm. The
# limits are ~30x, ~5x, ~8x the cosine gap and ~30x those readings: bf16
# rounding through 12 + 12 layers passes, a wrong gradient path does not.
# (The key projections' biases are zero by math, so they are held below a
# share of the global norm instead of to a cosine.)
TRAIN_CHECK_PAIRS = 4
TRAIN_MAX_LOSS_REL = 1e-5
TRAIN_MAX_GNORM_REL = 2e-3
TRAIN_MIN_GRAD_COSINE = 0.996
TRAIN_MAX_ZERO_GRAD_SHARE = 1e-4
# The same microbatch with the card in fp32 (use_amp=False, as
# ``cli/train.py --no-amp``) against the CPU in fp32. Set before any card
# reading, from the CPU emulation in tests/test_torch_attention_tf32.py
# (the same ViT-B/16 weights and 4 pairs, SPARC, every layer's attention
# forward and backward taken as the kernels take them, three TF32 products
# for each fp32 one, against the plain fp32 path; statistics in float64):
# loss relative difference 0 (below fp32's spacing, 1.2e-7), gradient
# norm 1.9e-8, largest per-tensor cosine gap (1 − cosine) 1.3e-11; the
# limits: loss 1e-6 (8 fp32 steps), gradient norm 5e-6, cosine gap 1e-8
# (740x). That emulation rounds its sums to nearest; the card's mma.sync
# TF32 sums mostly round toward zero (perf/fp32_grad_bias_study.py), so the
# backward kernels' dq, dk, dv come out ~2e-6 smaller than exact and the
# card's gradient norm 2.31e-6 below the CPU's (the plain backward on the
# card: 1.9e-8; PERF.md). The emulation with its sums rounded toward zero
# reads 2.1e-6, under half the gradient-norm limit, and a cosine gap of
# 1.8e-11. With one TF32 product each (hi·hi), the emulation reads a
# gradient norm of 2.0e-5 and a cosine gap of 6.5e-7: a kernel at plain
# TF32 accuracy, or a wrong gradient path, fails them.
TRAIN_F32_MAX_LOSS_REL = 1e-6
TRAIN_F32_MAX_GNORM_REL = 5e-6
TRAIN_F32_MIN_GRAD_COSINE = 1 - 1e-8
TRAIN_CHECK_LIMITS = {  # card dtype -> (loss rel, grad norm rel, cosine)
    "bfloat16": (TRAIN_MAX_LOSS_REL, TRAIN_MAX_GNORM_REL,
                 TRAIN_MIN_GRAD_COSINE),
    "float32": (TRAIN_F32_MAX_LOSS_REL, TRAIN_F32_MAX_GNORM_REL,
                TRAIN_F32_MIN_GRAD_COSINE)}
# Blockwise kernels vs their plain versions (same inputs, the plain
# forward's o and lse fed to both backwards), per element: BWD_TOL, for the
# same reasons:
#   bf16: o, dq, dk, dv are rounded to bf16 on both sides from fp32 sums
#     taken in other orders; the forward also rounds p to bf16 against the
#     running max, which the kernel's 64-key tiles and the plain version's
#     256-key blocks move at different keys;
#   fp32: other summation order.
# lse is fp32 on both sides: |err| <= 1e-5 + 1e-6·|ref| (a sum of up to
# 4096 terms in another order, then a log); the fused forward's lse pair
# (hi + lo) is held to the same against a float64 reference. The first
# readings on an H100:
# o at most 0.71 of its limit (bf16), 0.022 (fp32); lse 9.5e-7; dq, dk, dv
# equal to the last bit (both sides sum in the same order).
LSE_TOL = (1e-5, 1e-6)
LONG_D, LONG_BLOCK = 64, 256
LONG_SHAPES = [  # (what, B, H, S, D, bias); the last also runs in fp32
    ("microbench S=1024", 8, 12, 1024, LONG_D, None),
    ("microbench S=2048", 4, 12, 2048, LONG_D, None),
    ("microbench S=4096", 1, 12, 4096, LONG_D, None),
    ("causal S=2048", 1, 12, 2048, LONG_D, "causal"),
    # The other head dims the kernels take: their own tiles and swizzles.
    ("Dh=32", 2, 4, 1024, 32, None),
    ("Dh=32 causal", 2, 4, 1024, 32, "causal"),
    ("Dh=16", 2, 4, 1024, 16, None),
    ("Dh=16 causal", 2, 4, 1024, 16, "causal"),
    ("ViT-L/14@336 key padding", 8, 16, 577, LONG_D, "padding"),
]
LONG_TIMED = "microbench S=2048"
# The long path: the ported flash microbenchmark at its design points
# (S, B) and its default step count, every launch counted.
MICROBENCH_POINTS = ((1024, 8), (2048, 4), (4096, 1))
MICROBENCH_STEPS = 20
# GradCache (phase 6b): the large pool's accumulation (32 x 32 = 1024),
# the timed steps of each variant at 32 x 8, and the fp32 check's shape
# (accum, microbatch) against one direct [1, 32] step. The fp32 limits
# were set before any card reading, from the port on the CPU at ViT-B/16
# widths with 1, 2 and 3 layers a tower (tests/test_torch_gradcache.py::
# test_fp32_gradcache_vs_direct_at_vit_b16_width holds the 1-layer
# case): loss relative difference 0, gradient norm 5.5e-10, largest
# per-tensor cosine gap 1.8e-12. On the card both sides run the same
# kernels on the same samples (their rounding, the truncated TF32 sums
# of #2 among it, is the same); what differs is cuBLAS's GEMM shapes
# (4 rows against 32 a chunk) and .grad's sum over 8 chunks. The limits:
# loss 1e-6 (8 fp32 steps), gradient norm 1e-6, cosine gap 1e-8 (5000x the
# CPU's; the card-vs-CPU fp32 check of phase 6 reads 2e-11): a dropped
# chunk, a 1/accum scale or a cotangent taken at other embeddings fails.
GC_LARGE_ACCUM = 32
GC_TIMED = 3
GC_F32_SHAPE = (8, 4)
GC_F32_LIMITS = {"loss_rel": 1e-6, "grad_norm_rel": 1e-6,
                 "min_grad_cosine": 1.0 - 1e-8}
# Int8 GEMMs (phase 3, "int8"): the quantize passes' operands [R, C] at
# the slice's shapes: ViT-B/16's vision microbatch (M = 32 x 197 = 6304
# rows; x and g [M, 768] and [M, 3072]), the patch embedding's patches
# (32 x 196 = 6272), the text microbatch (32 x 77 = 2464; 512 and 2048),
# the weights [N, K], and the 4-pair microbatch of phase 6c's CPU check,
# whose M (308, 788) is no multiple of 8 (quant_cols_t pads it).
QUANT_SHAPES = [
    ("vision x / g", 6304, 768), ("vision fc2 x / fc1 g", 6304, 3072),
    ("patch embedding x", 6272, 768), ("text x / g", 2464, 512),
    ("text fc2 x / fc1 g", 2464, 2048), ("vision W q/k/v/out", 768, 768),
    ("vision W fc1", 3072, 768), ("vision W fc2", 768, 3072),
    ("text W fc1", 2048, 512), ("text W fc2", 512, 2048),
    ("4 pairs' text x", 308, 512), ("4 pairs' vision x", 788, 768)]
# Every product of the slice (M, K, N): the forward's and dgrad's (x or g
# by W), and the int8 wgrad's [N, M] x [M, K] over the padded M.
INT_MM_SHAPES = [
    ("vision q/k/v/out", 6304, 768, 768), ("vision fc1", 6304, 768, 3072),
    ("vision fc2", 6304, 3072, 768), ("patch embedding", 6272, 768, 768),
    ("text q/k/v/out", 2464, 512, 512), ("text fc1", 2464, 512, 2048),
    ("text fc2", 2464, 2048, 512),
    ("vision wgrad q/k/v/out", 768, 6304, 768),
    ("vision wgrad fc1", 3072, 6304, 768),
    ("vision wgrad fc2", 768, 6304, 3072),
    ("patch embedding wgrad", 768, 6272, 768),
    ("text wgrad q/k/v/out", 512, 2464, 512),
    ("text wgrad fc1", 2048, 2464, 512), ("text wgrad fc2", 512, 2464, 2048)]
PEAK_INT8_OPS = 1979e12             # int8 tensor cores, dense (data sheet)
# quant_linear on the card against its plain version on the card (what,
# dtype, M, K, N): output, dx, db and the int8 dW must be bit-equal (the
# same int32 sums, the same fp32 arithmetic in the same order); switchback's
# dW is a float product on both sides, held within one step of its type
# (torch.finfo(dtype).eps of the value) should cuBLAS pick another
# algorithm between the two calls.
QUANT_LINEAR_CASES = [("vision fc1", "bfloat16", 6304, 768, 3072),
                      ("vision fc2", "bfloat16", 6304, 3072, 768),
                      ("4 pairs' text fc1", "float32", 308, 512, 2048)]
# Phase 6c: the modes, in turns, and the rounds of timed steps.
QUANT_MODES = ("none", "switchback", "int8")
QUANT_TIMED = 3
# Phase 6c's int8 microbatch (4 pairs): the card against the port on the
# CPU, both in int8, the CPU in fp32. Set before any card reading, from
# the port on the CPU at ViT-B/16 widths with 1, 2 and 4 layers a tower
# (int8 on both sides; the same 4 pairs; SPARC):
#   bf16 against fp32 reads loss 2.2e-6, 7.5e-7, 2.1e-6, gradient norm
#     1.8e-3, 1.0e-4, 3.3e-3, smallest per-tensor cosine 0.99666, 0.99536,
#     0.99415 (the exact path: 4.2e-7, 2.2e-4, 0.99907 at 1 layer; its
#     card limits above). Quantization turns bf16's rounding into whole
#     grid steps, and the cosine gap grows ~0.0013 a doubling of depth:
#     ~0.008 at 12. The limits: loss 1e-4, gradient norm 2e-2, cosine
#     0.96 (5x that gap).
#   fp32 against fp32: the card's sums differ from the CPU's by ~1e-6
#     (phase 6's fp32 check: gradient norm 2.31e-6 from the TF32 sums'
#     truncation), and quantization turns that into grid steps as it does
#     bf16's rounding: the weights moved by 1e-6 (relative, random) on the
#     CPU read loss 8.3e-7, 0, 7.5e-7, gradient norm 1.0e-4, 4.1e-4,
#     9.0e-4, cosine gap 1.0e-3, 2.0e-3, 3.3e-3 at 1, 2, 4 layers (the
#     exact path: 0, 1e-6, 3e-7). The same limits hold for it.
# A kernel that quantizes or dequantizes wrongly moves the loss by far
# more (the int8 path itself sits 1.3e-4 to 3e-2 from the exact one on
# the CPU's tiny model); phase 3 holds the kernels bit-equal.
QUANT_CHECK_LIMITS = {"bfloat16": (1e-4, 2e-2, 0.96),
                      "float32": (1e-4, 2e-2, 0.96)}
# Phase 10: two ranks on the one card (gloo), each DP_B rows a microbatch
# x DP_ACCUM (a global batch of 2 x 16 x accum 2), DP_STEPS steps a mode.
DP_RANKS = 2
DP_B = 16
DP_ACCUM = 2
DP_STEPS = 3
# The layers a tower of phases 10 and 11's bf16 modes against their
# oracles: the depth at which the CPU set DP_LIMITS, MP_LIMITS and
# SP_LIMITS, to keep the script inside its time (with these modes at
# 12 + 12 the script took 826.2 s on one H100 machine and passed 1100 s
# on a slower one; PERF.md). The runs of cli/train.py (H, I, J, K) and
# the int8 modes keep the whole model.
DP_LAYERS = 2
# Each mode against its one-process oracle on the card, both in bf16 (the
# default training), AdamSPD's anchors one step (1e-5) off the weights
# (data_parallel_check.anchors_off): the largest per-step loss and
# gradient-norm relative differences, the smallest per-tensor cosine of
# the first step's gradients and of the three steps' whole update. Set
# before any card reading from perf/data_parallel_check.py on the CPU
# (bf16, two gloo ranks of 16 x accum 2, seed 0, ViT-B/16 widths with 1
# and 2 layers a tower; first read with the anchors on the weights, which
# gave the same picture): local negatives equal their oracle to the last
# bit (the mean of two sums is the same fp32 sum in either order); global
# negatives, ZeRO-1 and FSDP read alike: loss 6.1e-8 and 6.1e-8, gradient
# norm 5.5e-6 and 9.1e-6, gradient cosine gap 2.6e-6 and 3.4e-6, update
# cosine gap 3.5e-5 and 2.2e-5 (anchors on the weights: loss 0 and
# 1.8e-7, norm 4.0e-5 and 1.6e-4, cosine gaps up to 7.0e-5; a rank's
# GEMMs see 16 rows, the oracle's 32, so bf16 rounds elsewhere; the gaps
# grow with depth). The limits hold 12 layers even at a square law
# (gradient norm ~6e-3, cosine gap ~2.5e-3): loss 1e-5, gradient norm
# 2e-2, cosines 0.99. A gather that keeps only its rows in the backward
# (the global term at 1/W) fails them: on the CPU at 1 layer it reads
# gradient norm 7.0e-2, cosines 0.941 and 0.934, with the anchors on the
# weights or off them (its loss moves 4.4e-6 only, inside the loss
# limit).
DP_LIMITS = {"loss_rel": 1e-5, "grad_norm_rel": 2e-2,
             "min_grad_cosine": 0.99, "min_update_cosine": 0.99}
# ZeRO-1 and FSDP against global negatives replicated on the same two
# ranks ("vs_replicated"): the first step starts from the same gradients,
# so its update parts only where the optimizer reads a shard alone. The
# gate is the largest per-tensor |first update - replicated's| /
# |replicated's|. The oracle limits above cannot see AdamSPD reading a
# shard's sums alone (trouble spot b): on the CPU at 1 and 2 layers that
# fault reads, against the oracle, gradient norm 4.3e-4 and 3.7e-4 and
# update cosine 0.99989 and 0.99988, well inside DP_LIMITS; against the
# replicated run, first-update error 5.3e-2 and 5.3e-2. Correct code
# reads 4.9e-6 and 1.4e-5 (the sums' order), and its three steps 1.6e-6
# and 4.6e-6. Set before any card reading: 1e-3, 20x above 12 layers at
# a linear growth and 50x below the fault.
DP_SHARD_MAX_FIRST_UPDATE_REL = 1e-3
# Phase 11: tensor and pipeline parallelism on the one card (gloo), a
# global batch of MP_B x accum MP_ACCUM, MP_STEPS steps a mode, MP_MICRO
# GPipe microbatches (perf/model_parallel_check.py's modes: tp2, pp2,
# tp2pp2, dp2tp2 with FSDP).
MP_B = 32
MP_ACCUM = 2
MP_STEPS = 3
MP_MICRO = 4
# Each mode against its one-process oracle on the card, both in bf16,
# AdamSPD's anchors one step off the weights: the largest per-step loss
# and gradient-norm relative differences, the smallest per-tensor cosine
# of the first step's gradients and of the three steps' whole update,
# the largest per-tensor relative error of the first step's gradients,
# and of the first update against a replay (one process's optimizer
# stepping the run's own first-step gradients from the same weights and
# anchors). Set before any card reading from perf/model_parallel_check.py
# on the CPU (bf16, ViT-B/16 widths with 2 layers a tower, a global batch
# of 32 x accum 2, seed 0): the four modes read loss <= 1.8e-7, gradient
# norm <= 2.7e-4, gradient cosine >= 0.99978, update cosine >= 0.99990,
# gradient error <= 2.1e-2 (bf16 on a text q projection), replay
# <= 1.2e-5. The faults of trouble spots a and b read: post-pipeline
# gradients summed over the stages (pp2) norm 0.106 and gradient error
# 1.0; a TP shard's AdamSPD sums read alone (tp2) replay 5.3e-2, every
# other reading inside; whole tensors counted on every model rank in the
# norm (tp2) norm 0.133. The limits leave 12 layers of bf16 room (a
# cosine of 0.99 is a relative error of ~0.14) and fail each fault:
MP_LIMITS = {"loss_rel": 1e-5, "grad_norm_rel": 2e-2,
             "min_grad_cosine": 0.99, "min_update_cosine": 0.99,
             "max_grad_rel": 0.25, "replay_first_update_rel": 1e-3}
# Phase 11's sequence-parallel modes (perf/sequence_parallel_check.py:
# sp2, sp2-ring, dp2sp2-ring with FSDP) against the same oracle, with the
# same readings. Set before any card reading from that study on the CPU
# (bf16, ViT-B/16 widths with 2 layers a tower, a global batch of 32 x
# accum 2, seed 0): the three modes read loss <= 1.8e-7, gradient norm
# <= 3.6e-4, gradient cosine >= 0.99978, update cosine >= 0.99990,
# gradient error <= 2.1e-2 (bf16 on a text q projection), replay
# <= 3.9e-5. The faults of the gradient rule and of the copies read: the
# towers' gather summing the model ranks' cotangents (sp2) loss 2.0e-5,
# norm 1.03 and gradient error 1.0; the gradients after the gather summed
# over the model ranks too (sp2-ring) norm 0.107 and gradient error 1.0;
# whole tensors counted on every model rank in the norm (sp2) norm 0.414.
# The SP attention is PyTorch in fp32 scores where the oracle runs the
# bf16 kernels; the limits are MP_LIMITS' own, which leave 12 layers of
# bf16 room and fail each fault:
SP_LIMITS = dict(MP_LIMITS)
# Phase 11's int8 modes (quant="int8": perf/model_parallel_check.py's
# tp2-int8 and dp2tp2-int8, sequence_parallel_check.py's sp2-int8) against
# a one-process oracle in int8 from the same weights, with the readings
# above and the quantized tests' element reading of the first step: the
# share of the first update's elements more than 2e-3 of their tensor's
# largest update from the oracle's (each int8 mode against an oracle in
# its own dtype). Set before any card reading from
# perf/model_parallel_check.py on the CPU (bf16, ViT-B/16 widths with 2
# layers a tower, a global batch of 32 x accum 2, seed 0): tp2-int8 equals
# its oracle to the last bit (every reading 0 but the replay, 3.0e-5: the
# split contractions' int32 sums are exact and their scales the oracle's);
# dp2tp2-int8 reads loss 3.7e-7, gradient norm 6.3e-4 (first step 8.3e-6),
# gradient cosine 0.999997, update cosine 0.99988, gradient error 2.6e-3,
# first-update elements off 0.81 %, replay 1.5e-5 (a data rank's rows
# dequantize apart and sum in fp32, and its GEMMs see 16 rows). Every
# scale taken from a rank's part alone (the fault quant_shard_scales, as
# the port did before the scales took their groups) reads tp2-int8 /
# dp2tp2-int8 gradient error 5.5e-2 / 5.4e-2 and first-update elements off
# 36.6 % / 36.7 %, norm 1.5e-3 / 1.5e-3, inside MP_LIMITS. The limits:
# MP_LIMITS, the gradient error at 2e-2 and the off share at 0.1 (about 8x
# and 12x above dp2tp2-int8 for 12 layers of growth, 2.7x and 3.7x below
# the fault). sp2-int8 in bf16 reads like sp2 (gradient error 3.3e-2,
# off share 15.8 %: the SP attention's fp32 scores against the oracle's
# bf16 kernels, quantized into grid steps), and so does its fault (3.4e-2,
# 18.8 %): in bf16 it takes SP_LIMITS, which cannot see its scales; in
# fp32 INT8_LIMITS, which see them: at these widths it reads gradient
# error 4.6e-3 and off share 0.68 %, its fault 2.0e-2 and 10.4 %; at the
# tiny width of tests/test_torch_model_parallel.py's gates 2.1e-3 and
# 0.32 %, its fault 1.1e-2 and 15.4 % (tp2-int8 there: 0 and 0, its fault
# 5.8e-2 and 45.9 %).
INT8_LIMITS = dict(MP_LIMITS, max_grad_rel=2e-2, first_update_off_share=0.1)
# Phase 11's spawns: (ranks, groups of modes, runs of cli/train.py on the
# same ranks, MP_RUNS); a group is (dtype, layers a tower or None for the
# whole model, the attention of its int8 oracle, modes): the bf16 modes
# at DP_LAYERS against phase 10's oracle, the int8 ones whole. sp2-int8 runs
# twice: whole in bf16 within SP_LIMITS, and in fp32 at 2 layers a tower
# within INT8_LIMITS, the depth at which those were set and see its
# scales, against an oracle whose attention is the SP modes' own
# (``sp_attention``). The int8 grid turns any rounding that parts the two
# sides into grid steps, layer by layer: against the oracle's fp32
# attention kernels sp2-int8 read gradient error 3.5e-2 and off share
# 18.8 % on the card at 2 layers, and with the same attention on both
# sides at 6 layers on the CPU 3.4e-2 and 13.3 % (PERF.md).
MP_SPAWNS = ((2, (("bfloat16", DP_LAYERS, "kernel",
                   ("tp2", "pp2", "sp2", "sp2-ring")),
                  ("bfloat16", None, "kernel", ("tp2-int8", "sp2-int8")),
                  ("float32", 2, "sp", ("sp2-int8",))), ("J", "K")),
             (4, (("bfloat16", DP_LAYERS, "kernel",
                   ("tp2pp2", "dp2tp2", "dp2sp2-ring")),
                  ("bfloat16", None, "kernel", ("dp2tp2-int8",))), ("I",)))


def phase_11_limits(mode: str, dtype: str = "bfloat16") -> dict:
    """The limits phase 11 holds ``mode`` to in ``dtype``."""
    if mode.startswith(("sp", "dp2sp")):
        return INT8_LIMITS if mode.endswith("-int8") \
            and dtype == "float32" else SP_LIMITS
    return INT8_LIMITS if mode.endswith("-int8") else MP_LIMITS


def mp_label(mode: str, dtype: str, layers) -> str:
    """A phase 11 run's name: the mode, and its dtype and depth where the
    model is cut (``MP_SPAWNS``)."""
    return mode if layers is None else \
        f"{mode} ({dtype}, {layers} + {layers} layers)"
# The training CLI (phase 8): a procedural dataset of this many 224 px
# samples (two SPARC steps an epoch at TRAIN_B x TRAIN_ACCUM; eight count
# steps at TRAIN_B x CLI_COUNT_ACCUM).
CLI_SAMPLES = 512
CLI_COUNT_ACCUM = 2
# Evaluation (phase 9): the CLI's default batch, the crop protocol's
# sample count, and #1 in fp32 at evaluation's shapes (a scorer call of
# 32 images x 10 templates: vision B=32, text B=320 causal).
EVAL_BATCH = 32
EVAL_CROP_SAMPLES = 500
EVAL_ATTENTION_SHAPES = [("eval vision", 32, 197, 12, False),
                         ("eval text (causal)", 320, 77, 8, True)]
# The card's fp32 evaluation against the port in fp32 on the CPU, same
# weights and inputs (TF32 off): probabilities and similarities within
# EVAL_MAX_ABS, the same argmax wherever the top two differ by more than
# EVAL_TIE. The first reading on an H100 (PERF.md): 3.6e-7 at worst
# (CountBench's first call; similarities 2.7e-7), every argmax equal. The
# limit is ~30x that: other summation orders pass, a wrong layer does not.
EVAL_MAX_ABS = 1e-5
EVAL_TIE = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def kernel_name(mangled: str) -> str:
    """``attention_fwd_mma<64>`` from the mangled name of a kernel in an
    anonymous namespace of ``csrc/<file>.cu``."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    args = re.match(r"I(.*?E)E", rest)
    if args:
        parts = [a or "float" for a in
                 re.findall(r"Li(\d+)E|f", args.group(1))]
        name += "<" + ", ".join(parts) + ">"
    return name


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each kernel from nvcc's ``-Xptxas -v``
    output, and ``wgmma_serialized`` for a kernel whose ``wgmma`` chain
    ptxas serialized (its "wgmma.mma_async instructions are serialized"
    warning). (Shared memory is dynamic, set at launch, so ptxas reports
    none.)"""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        s = re.search(r"wgmma\.mma_async instructions are serialized.*'(\S+)'",
                      ln)
        if s:
            out.setdefault(kernel_name(s.group(1)), {})["wgmma_serialized"] = \
                True
        elif m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                out[name]["spill_stores"] = int(m.group(1))
                out[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[name]["registers"] = int(m.group(1))
    return out


def sass_count(lib, *words) -> dict:
    """The number of instructions holding every one of ``words`` (``HGMMA``
    for wgmma; ``HMMA`` and ``TF32`` for TF32 mma.sync) in each kernel of a
    built library, from ``cuobjdump --dump-sass``."""
    from clip_finegrained_alignment_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_name(m.group(1))
            out[name] = 0
        elif name is not None and all(w in ln for w in words):
            out[name] += 1
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

ATTENTION_SHAPES = [  # (what, S, H, Dh, causal, also in the backward check)
    ("ViT-B/16 vision", 197, 12, 64, False, True),
    ("text (causal)", 77, 8, 64, True, True),
    ("ViT-B/32 vision", 50, 12, 64, False, False),
    ("ViT-L/14 vision", 257, 16, 64, False, False),
    # The other head dims the kernels take: their own fragment layouts.
    ("Dh=32", 77, 4, 32, False, True),
    ("Dh=32 causal", 77, 4, 32, True, True),
    ("Dh=16", 77, 4, 16, False, True),
    ("Dh=16 causal", 77, 4, 16, True, True),
]


# The backward at the count loss's counterfactual text tower: 9 captions
# for each of a microbatch's 32 samples, one [288, 77] causal forward.
BACKWARD_EXTRA_SHAPES = [  # (what, B, S, H, Dh, causal)
    ("counterfactual text (causal)", 9 * TRAIN_B, 77, 8, 64, True),
]
# #1 and #2 at phase 11's shapes: H/tp heads of a tensor-parallel rank
# (tp = 2) and the B/M rows of a pipeline microbatch (32 / 4).
MP_ATTENTION_SHAPES = [  # (what, B, S, H, Dh, causal)
    ("tp2 ViT-B/16 vision", 32, 197, 6, 64, False),
    ("tp2 text (causal)", 32, 77, 4, 64, True),
    ("pp microbatch ViT-B/16 vision", 8, 197, 12, 64, False),
    ("pp microbatch text (causal)", 8, 77, 8, 64, True),
]
# #1 and #2 at the train microbatches of the tools phase's other models
# (perf/bench.py's regime, bf16): ViT-B/32 at 128 and ViT-L/14 at 32.
TOOLS_ATTENTION_SHAPES = [  # (what, B, S, H, Dh, causal)
    ("ViT-B/32 vision (train)", 128, 50, 12, 64, False),
    ("ViT-B/32 text (train, causal)", 128, 77, 8, 64, True),
    ("ViT-L/14 vision (train)", 32, 257, 16, 64, False),
    ("ViT-L/14 text (train, causal)", 32, 77, 12, 64, True),
]


def bound_ms(nbytes: float, flops: float, dtype_name: str) -> dict:
    """The least time for ``nbytes`` of device memory traffic and ``flops``
    operations at the card's peak rates for ``dtype_name``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def attention_bound_ms(B, S, H, D, dtype_name, causal, tensors=4,
                       products=2) -> dict:
    """``tensors`` [B, S, H, D] tensors read or written once (forward: q,
    k, v, o; backward: q, k, v, do, dq, dk, dv) plus the fp32 causal bias,
    and ``products`` [S, S, D] matrix products per (batch, head), 2 flops
    per multiply-add (forward: q·kᵀ, p·v; backward: q·kᵀ again, do·vᵀ,
    pᵀ·do, ds·k, dsᵀ·q)."""
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = tensors * B * S * H * D * item + (S * S * 4 if causal else 0)
    return bound_ms(nbytes, 2.0 * products * B * H * S * S * D, dtype_name)


def fused_attention_bound_ms(B, S, H, D, dtype_name, causal, tensors=4,
                             products=2) -> dict:
    """The bound of a fused attention kernel (by default the forward's;
    the backward's with ``tensors=7, products=5``): bf16 products on the
    bf16 tensor cores; float32 ones as the kernels take them, three TF32
    products each on the TF32 tensor cores, with the bound on the fp32
    CUDA cores (one fp32 product each) beside it as
    ``bound_ms_fp32_cores``."""
    cores = attention_bound_ms(B, S, H, D, dtype_name, causal, tensors,
                               products)
    if dtype_name != "float32":
        return cores
    row = bound_ms(cores["bytes"], 3 * cores["flops"], "tf32")
    row["bound_ms_fp32_cores"] = cores["bound_ms"]
    return row


def lse_reference(q, k, bias, scale):
    """float64 ``[B, H, S]`` log-sum-exp of the scores the kernels form: q
    scaled and rounded to its type, fp32 products with k, plus the bias,
    over the TPU wrapper's Sp = round_up(S, 8) keys (the Sp − S padded
    ones at −1e9)."""
    import torch
    import torch.nn.functional as F
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta
    logits = torch.einsum("bqhd,bkhd->bhqk", ta._scaled_q(q, scale).float(),
                          k.float())
    if bias is not None:
        logits = logits + bias.float()
    S = logits.shape[-1]
    logits = F.pad(logits.double(), (0, ta._round_up(S, ta.SEQ_QUANTUM) - S),
                   value=ta.NEG)
    return torch.logsumexp(logits, dim=-1)


def lse_of_pair(lse):
    """The fused forward's log-sum-exp pair ``[2, B, H, S]`` as one float64
    value, hi + lo."""
    return lse[0].double() + lse[1].double()


def lse_excess(got, ref) -> float:
    """The largest |err| / (LSE_TOL[0] + LSE_TOL[1]·|ref|); at most 1
    passes."""
    lim = LSE_TOL[0] + LSE_TOL[1] * ref.abs()
    return ((got - ref).abs() / lim).max().item()


def attention_fwd_times(q, k, v, bias, scale) -> dict:
    """The forward kernel's ``ms`` and ``graph_ms``, the plain version's
    and ``scaled_dot_product_attention``'s ``ms`` on the same bshd
    inputs."""
    import torch.nn.functional as F
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None if bias is None else bias.to(q.dtype)
    return {
        "ms": cuda_time_ms(lambda: ta.flash_attention(q, k, v, bias, scale)),
        "graph_ms": graph_ms(
            lambda: ta.flash_attention(q, k, v, bias, scale)),
        "plain_ms": cuda_time_ms(
            lambda: ta.attention_reference(q, k, v, bias, scale), reps=5),
        "library_ms": cuda_time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale))}


def check_attention(results: dict) -> dict:
    """The forward kernel at the serving shapes, both layouts; its output
    against the plain version and, when asked for it, its log-sum-exp
    against ``lse_reference``."""
    import torch
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for what, S, H, D, causal, _ in ATTENTION_SHAPES:
        for B in (BUCKET, 1):
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[-1]
                x = torch.randn(B, S, 3 * H * D, device="cuda",
                                generator=gen).to(dtype)
                bias = (torch.full((S, S), -1e9, device="cuda").triu(1)
                        [None, None] if causal else None)
                scale = D ** -0.5
                layouts = {
                    # As the model passes them: one contiguous [B, S, H*D]
                    # output per projection, viewed as bshd.
                    "separate": [x[..., i * H * D:(i + 1) * H * D]
                                 .contiguous().view(B, S, H, D)
                                 for i in range(3)],
                    # Strided slices of one fused projection output.
                    "fused": [x[..., i * H * D:(i + 1) * H * D]
                              .view(B, S, H, D) for i in range(3)]}
                errs, lse_over = {}, {}
                for layout, (q, k, v) in layouts.items():
                    out = ta.flash_attention(q, k, v, bias, scale)
                    # As the train path calls it: the same output, and lse.
                    out2, lse = ta._launch(q, k, v, bias, scale, True)
                    torch.cuda.synchronize()
                    ref = ta.attention_reference(q.float(), k.float(),
                                                 v.float(), bias, scale)
                    errs[layout] = (out.float() - ref).abs().max().item()
                    check(bool(torch.isfinite(out).all()),
                          f"attention {what} B={B} {dname} {layout}: "
                          f"non-finite output")
                    check(torch.equal(out, out2),
                          f"attention {what} B={B} {dname} {layout}: the "
                          "output changes when lse is written")
                    lse_over[layout] = lse_excess(
                        lse_of_pair(lse), lse_reference(q, k, bias, scale))
                err = max(errs.values())
                row = {"shape": what, "B": B, "S": S, "H": H, "Dh": D,
                       "dtype": dname, "max_abs_err": err,
                       "max_abs_err_by_layout": errs,
                       "tol": KERNEL_TOL[dname],
                       "lse_err_over_tol": max(lse_over.values()),
                       "lse_tol": "|err| <= %g + %g·|ref|" % LSE_TOL}
                check(err <= KERNEL_TOL[dname],
                      f"attention {what} B={B} {dname}: max abs err {errs} "
                      f"> {KERNEL_TOL[dname]}")
                check(row["lse_err_over_tol"] <= 1.0,
                      f"attention {what} B={B} {dname}: lse error over its "
                      f"tolerance {lse_over}")
                if B == BUCKET:
                    # Timed on the main path's layout.
                    row.update(attention_fwd_times(*layouts["separate"],
                                                   bias, scale))
                    row.update(fused_attention_bound_ms(B, S, H, D, dname,
                                                        causal))
                log("attention", json.dumps(row))
                rows.append(row)
    results["attention"] = rows
    return next(r for r in rows if r["shape"] == "ViT-B/16 vision"
                and r["B"] == BUCKET and r["dtype"] == "bfloat16")


def check_attention_at(results: dict, key: str, shapes, dtypes,
                       seed: int) -> list:
    """#1 and #2 at ``shapes`` (what, B, S, H, Dh, causal) in ``dtypes``:
    the forward's output and lse and the backward's dq, dk, dv (fed the
    forward kernel's lse) against the plain versions, with the forward's
    and the backward's times beside the plain versions', the library's and
    their bounds; the rows go to ``results[key]``."""
    import torch
    import torch.nn.functional as F
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for what, B, S, H, D, causal in shapes:
        for dtype in (getattr(torch, d) for d in dtypes):
            dname = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(B, S, H, D, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            bias = (torch.full((S, S), -1e9, device="cuda").triu(1)
                    [None, None] if causal else None)
            scale = D ** -0.5
            out, lse = ta._launch(q, k, v, bias, scale, True)
            got = ta._launch_backward(q, k, v, bias, scale, do, lse)
            torch.cuda.synchronize()
            ref = ta.attention_reference(q.float(), k.float(), v.float(),
                                         bias, scale)
            err = (out.float() - ref).abs().max().item()
            lse_over = lse_excess(lse_of_pair(lse),
                                  lse_reference(q, k, bias, scale))
            refs = ta.attention_backward_reference(q, k, v, bias, scale, do)
            excess = {n: bwd_excess(a, b, dname)
                      for n, a, b in zip(("dq", "dk", "dv"), got, refs)}
            bwd_err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, refs))
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask = None if bias is None else bias.to(dtype)
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 scale=scale)
            row = {"shape": what, "B": B, "S": S, "H": H, "Dh": D,
                   "dtype": dname,
                   "fwd": {"max_abs_err": err, "tol": KERNEL_TOL[dname],
                           "lse_err_over_tol": lse_over,
                           **attention_fwd_times(q, k, v, bias, scale),
                           **fused_attention_bound_ms(B, S, H, D, dname,
                                                      causal)},
                   "bwd": {"max_abs_err": bwd_err,
                           "max_err_over_tol": max(excess.values()),
                           "ms": cuda_time_ms(lambda: ta._launch_backward(
                               q, k, v, bias, scale, do, lse)),
                           "plain_ms": cuda_time_ms(
                               lambda: ta.attention_backward_reference(
                                   q, k, v, bias, scale, do), reps=5),
                           "library_ms": cuda_time_ms(
                               lambda: torch.autograd.grad(
                                   lib, (qt, kt, vt), do.transpose(1, 2),
                                   retain_graph=True)),
                           **fused_attention_bound_ms(
                               B, S, H, D, dname, causal, tensors=7,
                               products=5)}}
            log(f"attention {key.replace('_', ' ')} shape", json.dumps(row))
            check(err <= KERNEL_TOL[dname] and lse_over <= 1.0
                  and bool(torch.isfinite(out).all()),
                  f"attention {what} {dname}: forward err {err}, lse "
                  f"{lse_over}")
            check(row["bwd"]["max_err_over_tol"] <= 1.0
                  and all(bool(torch.isfinite(a).all()) for a in got),
                  f"attention backward {what} {dname}: {excess}")
            rows.append(row)
    results[key] = rows
    return rows


MASKED_ROW_SHAPES = [  # (what, S, H, Dh, causal) at B=TRAIN_B
    ("ViT-B/16 vision", 197, 12, 64, False),
    ("text (causal)", 77, 8, 64, True),
]


def masked_sample_bias(gen, B, S, causal):
    """fp32 ``[B, 1, S, S]``: −1e9 on masked keys (a key masked twice is
    still −1e9). Sample 0 masks every key, so each of its rows is fully
    masked; the others mask the keys past a random length in [S/2, S], and
    ``causal`` also the keys after each row."""
    import torch
    lens = torch.randint(S // 2, S + 1, (B,), device="cuda", generator=gen)
    lens[0] = 0
    keys = torch.arange(S, device="cuda")
    masked = (keys[None] >= lens[:, None])[:, None, None, :].expand(
        B, 1, S, S)
    if causal:
        masked = masked | torch.ones(S, S, dtype=torch.bool,
                                     device="cuda").triu(1)
    return torch.where(masked, -1e9, 0.0).contiguous()


def check_attention_masked_rows(results: dict) -> None:
    """Both attention kernels where every key of a row is masked: the TPU
    wrapper's padded keys tie with the real ones, so such a row is Σv / Sp
    over Sp = round_up(S, 8) keys and each of its keys gets dv = Σdo / Sp
    (its weight 1 / Sp in every row). Kernels against the plain versions
    (fed the forward kernel's lse pair) and against those closed forms."""
    import torch
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows, B = [], TRAIN_B
    for what, S, H, D, causal in MASKED_ROW_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            q, k, v, do = (torch.randn(B, S, H, D, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            bias = masked_sample_bias(gen, B, S, causal)
            scale = D ** -0.5
            Sp = ta._round_up(S, ta.SEQ_QUANTUM)
            out, lse = ta._launch(q, k, v, bias, scale, True)
            dq, dk, dv = ta._launch_backward(q, k, v, bias, scale, do, lse)
            torch.cuda.synchronize()
            ref = ta.attention_reference(q.float(), k.float(), v.float(),
                                         bias, scale)
            rgrad = ta.attention_backward_reference(q, k, v, bias, scale, do)
            for name, t in (("o", out), ("dq", dq), ("dk", dk), ("dv", dv)):
                check(bool(torch.isfinite(t).all()),
                      f"masked rows {what} {dname} {name}: non-finite")
            row_o = (v[0].float().sum(0) / Sp).expand(S, H, D)
            row_dv = (do[0].float().sum(0) / Sp).expand(S, H, D)
            row = {"shape": what, "B": B, "S": S, "Sp": Sp, "H": H, "Dh": D,
                   "dtype": dname, "tol": KERNEL_TOL[dname],
                   "o_max_abs_err": (out.float() - ref).abs().max().item(),
                   "masked_o_vs_sum_v_over_sp":
                       (out[0].float() - row_o).abs().max().item(),
                   "lse_err_over_tol": lse_excess(
                       lse_of_pair(lse), lse_reference(q, k, bias, scale)),
                   "grad_err_over_tol": max(
                       bwd_excess(a, b, dname)
                       for a, b in zip((dq, dk, dv), rgrad)),
                   "masked_dv_vs_sum_do_over_sp":
                       bwd_excess(dv[0], row_dv, dname),
                   "grad_tol": "|err| <= %g·|ref| + %g·max|ref|"
                               % BWD_TOL[dname]}
            log("attention masked rows", json.dumps(row))
            check(max(row["o_max_abs_err"], row["masked_o_vs_sum_v_over_sp"])
                  <= KERNEL_TOL[dname] and row["lse_err_over_tol"] <= 1.0
                  and max(row["grad_err_over_tol"],
                          row["masked_dv_vs_sum_do_over_sp"]) <= 1.0,
                  f"attention masked rows {what} {dname}: {row}")
            rows.append(row)
    results["attention_masked_rows"] = rows


def bwd_excess(got, ref, dname) -> float:
    """The largest |err| / (rtol·|ref| + atol·max|ref|) over a gradient;
    at most 1 passes."""
    rtol, atol = BWD_TOL[dname]
    ref = ref.float()
    lim = rtol * ref.abs() + atol * ref.abs().max()
    return ((got.float() - ref).abs() / lim.clamp_min(1e-30)).max().item()


def check_attention_backward(results: dict) -> dict:
    """The backward kernels at the train shapes (B=32) and the count
    loss's counterfactual text tower (B=288), both layouts, fed the forward
    kernel's lse pair."""
    import torch
    import torch.nn.functional as F
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    shapes = [(what, TRAIN_B, S, H, D, causal)
              for what, S, H, D, causal, backward in ATTENTION_SHAPES
              if backward] + BACKWARD_EXTRA_SHAPES
    for what, B, S, H, D, causal in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            x = torch.randn(B, S, 3 * H * D, device="cuda",
                            generator=gen).to(dtype)
            do = torch.randn(B, S, H, D, device="cuda", generator=gen).to(dtype)
            bias = (torch.full((S, S), -1e9, device="cuda").triu(1)
                    [None, None] if causal else None)
            scale = D ** -0.5
            layouts = {
                "separate": [x[..., i * H * D:(i + 1) * H * D]
                             .contiguous().view(B, S, H, D) for i in range(3)],
                "fused": [x[..., i * H * D:(i + 1) * H * D]
                          .view(B, S, H, D) for i in range(3)]}
            errs, excess = {}, {}
            for layout, (q, k, v) in layouts.items():
                lse = ta._launch(q, k, v, bias, scale, True)[1]
                got = ta._launch_backward(q, k, v, bias, scale, do, lse)
                torch.cuda.synchronize()
                ref = ta.attention_backward_reference(q, k, v, bias, scale, do)
                for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                    check(bool(torch.isfinite(a).all()),
                          f"attention backward {what} {dname} {layout} "
                          f"{name}: non-finite")
                    errs[f"{layout} {name}"] = \
                        (a.float() - b.float()).abs().max().item()
                    excess[f"{layout} {name}"] = bwd_excess(a, b, dname)
            row = {"shape": what, "B": B, "S": S, "H": H, "Dh": D,
                   "dtype": dname, "max_abs_err": max(errs.values()),
                   "max_abs_err_by": errs,
                   "max_err_over_tol": max(excess.values()),
                   "tol": "|err| <= %g·|ref| + %g·max|ref|" % BWD_TOL[dname]}
            check(row["max_err_over_tol"] <= 1.0,
                  f"attention backward {what} {dname}: error over its "
                  f"tolerance {excess}")
            q, k, v = layouts["separate"]
            lse = ta._launch(q, k, v, bias, scale, True)[1]
            row["ms"] = cuda_time_ms(
                lambda: ta._launch_backward(q, k, v, bias, scale, do, lse))
            row["graph_ms"] = graph_ms(
                lambda: ta._launch_backward(q, k, v, bias, scale, do, lse))
            row["plain_ms"] = cuda_time_ms(
                lambda: ta.attention_backward_reference(q, k, v, bias, scale,
                                                        do), reps=5)
            # Yardstick: the backward alone of PyTorch's fused attention
            # on the same inputs (bhsd views), through a retained graph.
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            mask = None if bias is None else bias.to(dtype)
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 scale=scale)
            dot = do.transpose(1, 2)
            row["library_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))
            row.update(fused_attention_bound_ms(B, S, H, D, dname, causal,
                                                tensors=7, products=5))
            log("attention backward", json.dumps(row))
            rows.append(row)
    results["attention_backward"] = rows
    return next(r for r in rows if r["shape"] == "ViT-B/16 vision"
                and r["dtype"] == "bfloat16")


def sparc_inputs(gen, B, T, P, D, edge=False):
    """fp32 v [B, P, D], l [B, T, D], g [B, T, D] and a caption-like mask
    (each row a prefix of random length). ``edge``: also a fully masked
    sample, a fully masked row, an exactly zero patch row and duplicated
    patches (ties of the min and max)."""
    import torch
    v = torch.randn(B, P, D, device="cuda", generator=gen)
    l = torch.randn(B, T, D, device="cuda", generator=gen)
    g = torch.randn(B, T, D, device="cuda", generator=gen)
    lens = torch.randint(5, T + 1, (B, 1), device="cuda", generator=gen)
    mask = (torch.arange(T, device="cuda")[None] < lens).float()
    if edge:
        mask[0] = 0.0
        mask[1, 2] = 0.0
        v[1, 3] = 0.0
        v[:, 7] = v[:, 5]
        v[:, 9] = v[:, 5]
        v[:, 11] = -v[:, 5]
    return v, l, mask, g


def sparc_near_rows(v, l, mask, tau):
    """[B, T] bool: masked-in token rows whose threshold decision or
    min/max choice lies within fp32 rounding (the plain version's numbers):
    some |z − τ| < 1e-5, or two distinct masked similarities at the bottom
    or the top of the row within 1e-6 of each other."""
    import torch
    from clip_finegrained_alignment_tpu_torch.ops import sparc_kernel as sk
    sim = torch.einsum("btd,bpd->btp", sk.l2_normalize(l), sk.l2_normalize(v))
    sm = sim * mask[:, :, None]
    srt = sm.sort(dim=-1).values
    mn, mx = srt[..., :1], srt[..., -1:]
    z = (sm - mn) / (mx - mn + sk.EPS)
    near = ((z - tau).abs() < 1e-5).any(-1)
    for end in (srt - mn, mx - srt):       # distances from the min / the max
        gap = torch.where(end > 0, end, torch.full_like(end, 1.0))
        near |= gap.amin(-1) < 1e-6
    return near & (mask > 0)


SPARC_SHAPES = [  # (what, B, P, D, edge batch)
    ("ViT-B/16", TRAIN_B, 197, 512, False),
    ("ViT-B/32", TRAIN_B, 50, 512, False),
    ("ViT-B/16 edge batch", 4, 197, 512, True),
    # The tools phase's train microbatches (perf/bench.py's regime).
    ("ViT-B/32 (train, B=128)", 128, 50, 512, False),
    ("ViT-L/14 (train)", TRAIN_B, 257, 768, False),
]


def check_sparc(results: dict) -> tuple:
    """Both SPARC kernels at the train shapes and on an edge batch."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = {"fwd": [], "bwd": []}
    for what, B, P, D, edge in SPARC_SHAPES:
        fwd, bwd = sparc_case(gen, what, B, P, edge, timed=not edge, D=D)
        rows["fwd"].append(fwd)
        rows["bwd"].append(bwd)
    results["sparc"] = rows
    return rows["fwd"][0], rows["bwd"][0]


def sparc_case(gen, what, B, P, edge=False, timed=True, D=512) -> tuple:
    """Both SPARC kernels at [B, T=77, P, D] against their plain
    versions (SPARC_TOL, SPARC_RESIDUAL_TOL), the forward's saved sim, rl,
    rv fed to the backward; with ``timed`` their ms, graph ms, plain ms and
    bounds. Returns the forward's and the backward's rows."""
    import torch
    from clip_finegrained_alignment_tpu_torch.ops import sparc_kernel as sk

    T, tau = 77, 0.5
    v, l, mask, g = sparc_inputs(gen, B, T, P, D, edge)
    near = sparc_near_rows(v, l, mask, tau)
    keep_row = ~near[:, :, None]
    keep_b = ~near.any(-1)[:, None, None]
    out, *res = sk._launch(v, l, mask, tau)
    dv, dl = sk._launch_backward(v, l, mask, tau, g, *res)
    torch.cuda.synchronize()
    ref, *rres = sk.sparc_pooling_reference(v, l, mask, tau,
                                            return_residuals=True)
    rdv, rdl = sk.sparc_pooling_backward_reference(v, l, mask, tau, g)
    for t in (out, dv, dl, *res):
        check(bool(torch.isfinite(t).all()), f"SPARC {what}: non-finite")
    errs = {"out": ((out - ref).abs() * keep_row).max().item(),
            "dl": ((dl - rdl).abs() * keep_row).max().item(),
            "dv": ((dv - rdv).abs() * keep_b).max().item()}
    res_err = {"sim": (res[0] - rres[0]).abs().max().item()}
    for name, got, want in zip(("rl", "rv"), res[1:], rres[1:]):
        res_err[name] = ((got - want).abs() / want.abs()).max().item()
    check(max(res_err.values()) <= SPARC_RESIDUAL_TOL,
          f"SPARC {what}: saved sim, rl, rv off the plain version's by "
          f"{res_err} > {SPARC_RESIDUAL_TOL}")
    n_near, n_rows = int(near.sum()), int((mask > 0).sum())
    common = {"shape": what, "B": B, "T": T, "P": P, "D": D, "tau": tau,
              "tol": SPARC_TOL, "near_decision_rows": n_near,
              "rows": n_rows, "near_decision_samples":
              int(near.any(-1).sum())}
    check(n_near <= SPARC_MAX_NEAR_SHARE * n_rows,
          f"SPARC {what}: {n_near} of {n_rows} rows near a decision")
    fwd = dict(common, max_abs_err=errs["out"], residual_err=res_err)
    bwd = dict(common, max_abs_err=max(errs["dl"], errs["dv"]),
               max_abs_err_by={"dl": errs["dl"], "dv": errs["dv"]})
    for kind, row in (("forward", fwd), ("backward", bwd)):
        check(row["max_abs_err"] <= SPARC_TOL,
              f"SPARC {kind} {what}: max abs err {row['max_abs_err']} "
              f"> {SPARC_TOL}")
    if timed:
        for row, fn in (
                (fwd, lambda: sk._launch(v, l, mask, tau)),
                (bwd, lambda: sk._launch_backward(v, l, mask, tau, g,
                                                  *res))):
            row["ms"], row["graph_ms"] = cuda_time_ms(fn), graph_ms(fn)
        fwd["plain_ms"] = cuda_time_ms(
            lambda: sk.sparc_pooling_reference(
                v, l, mask, tau, return_residuals=True), reps=5)
        bwd["plain_ms"] = cuda_time_ms(
            lambda: sk.sparc_pooling_backward_reference(
                v, l, mask, tau, g, residuals=res), reps=5)
        # No single PyTorch call computes this chain.
        fwd["library_ms"] = bwd["library_ms"] = None
        # Each input read and each output written once. The forward
        # reads v, l, mask and writes out, sim, rl, rv; the backward
        # reads v, l, mask, g, sim, rl, rv and writes dv, dl. Products
        # [T, P, D]: l·vᵀ and w·v forward; g·vᵀ, (dsim∘rv)·v, wᵀ·g,
        # (dsim∘rl)ᵀ·l backward. The kernels issue each as three TF32
        # products; the CUDA-core fp32 bound (one fp32 product each)
        # stays beside it.
        f4, prod = 4.0, 2.0 * B * T * P * D
        io = B * T + B * T * P + B * T + B * P
        for row, nbytes, n in (
                (fwd, f4 * (B * P * D + 2 * B * T * D + io), 2),
                (bwd, f4 * (2 * B * P * D + 3 * B * T * D + io), 4)):
            row.update(bound_ms(nbytes, 3 * n * prod, "tf32"))
            row["bound_ms_fp32_cores"] = bound_ms(
                nbytes, n * prod, "float32")["bound_ms"]
    for kind, row in (("fwd", fwd), ("bwd", bwd)):
        log(f"sparc {kind}", json.dumps(row))
    return fwd, bwd


# ---------------------------------------------------------------------------
# Phase 3, "int8": the quantize and dequantize kernels (ops/quant.py)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_quant():
    """``ops/quant.py``'s int8 functions with the three passes taken by
    their plain versions (the CPU path) on whatever device the tensors lie:
    the yardstick the kernels are held to on the card."""
    from clip_finegrained_alignment_tpu_torch.ops import quant as tq
    names = ("quant_rows", "quant_cols_t", "dequant") + tq.SPLIT_KERNELS
    saved = {n: getattr(tq, n) for n in names}
    for n in names:
        setattr(tq, n, getattr(tq, f"{n}_reference"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(tq, n, fn)


def quant_pass_bound(name, R, C, item) -> dict:
    """A pass's bound: its bytes (``perf/int8_microbench.py::kernel_bytes``)
    or its few fp32 operations an element on the CUDA cores."""
    from clip_finegrained_alignment_tpu_torch.perf.int8_microbench import \
        kernel_bytes
    return bound_ms(kernel_bytes(name, R, C, item), 4.0 * R * C, "float32")


def check_quant(results: dict) -> dict:
    """The int8 kernels bit-equal to their plain versions at the
    slice's shapes (bf16 and fp32), their times at the timed shapes, the
    int8 products (``torch._int_mm``) against bf16 ``torch.matmul``,
    ``quant_linear``'s forward and backward against the plain version on
    the card in both modes, and ``perf/int8_microbench.py``'s GEMM set.
    Returns {kernel name: its timed row}."""
    import torch
    from clip_finegrained_alignment_tpu_torch.ops import quant as tq
    from clip_finegrained_alignment_tpu_torch.perf import int8_microbench

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    out = {"passes": [], "int_mm": [], "quant_linear": [], "gpu": gpu_line()}
    for what, R, C in QUANT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(R, C, device="cuda", generator=gen) * 3).to(dtype)
            x[R // 2] = 0                           # a zero row
            q, s = tq.quant_rows(x)
            qt, st = tq.quant_cols_t(x)
            acc = torch.randint(-2 ** 20, 2 ** 20, (R, C), device="cuda",
                                dtype=torch.int32, generator=gen)
            sr = torch.rand(R, device="cuda", generator=gen) * 1e-3
            sc = torch.rand(C, device="cuda", generator=gen) * 1e-3
            bias = torch.randn(C, device="cuda", generator=gen).to(dtype)
            y = tq.dequant(acc, sr, sc, bias, dtype)
            y0 = tq.dequant(acc, sr, sc, None, dtype)
            torch.cuda.synchronize()
            qr, sr_ = tq.quant_rows_reference(x)
            qtr, str_ = tq.quant_cols_t_reference(x)
            # The split passes: each against its plain version, and the
            # split path (reduce, quantize with the absmax) against the
            # fused passes, kernel against kernel.
            ar, ac = tq.absmax_rows(x), tq.absmax_cols(x)
            qg, sg = tq.quant_rows_given(x, ar)
            qtg, stg = tq.quant_cols_t_given(x, ac)
            torch.cuda.synchronize()
            qgr, sgr = tq.quant_rows_given_reference(x, ar)
            qtgr, stgr = tq.quant_cols_t_given_reference(x, ac)
            split = {
                "absmax_rows_equal": torch.equal(
                    ar, tq.absmax_rows_reference(x)),
                "absmax_cols_equal": torch.equal(
                    ac, tq.absmax_cols_reference(x)),
                "quant_rows_given_equal": torch.equal(qg, qgr)
                and torch.equal(sg, sgr),
                "quant_cols_t_given_equal": torch.equal(qtg, qtgr)
                and torch.equal(stg, stgr),
                "split_path_equal_fused": torch.equal(qg, q)
                and torch.equal(sg, s) and torch.equal(qtg, qt)
                and torch.equal(stg, st)}
            row = {"shape": what, "R": R, "C": C, **split,
                   "dtype": str(dtype).split(".")[-1],
                   "quant_rows_equal": torch.equal(q, qr)
                   and torch.equal(s, sr_),
                   "quant_cols_t_equal": torch.equal(qt, qtr)
                   and torch.equal(st, str_),
                   "padding_rows": qt.shape[1] - R,
                   "dequant_equal": torch.equal(
                       y, tq.dequant_reference(acc, sr, sc, bias, dtype))
                   and torch.equal(y0, tq.dequant_reference(
                       acc, sr, sc, None, dtype))}
            out["passes"].append(row)
            log("int8 pass", json.dumps(row))
            check(row["quant_rows_equal"] and row["quant_cols_t_equal"]
                  and row["dequant_equal"] and all(split.values()),
                  f"int8 kernels differ from their plain versions: {row}")
    # Times: x [6304, 768] by rows (the forward) and by columns (the int8
    # wgrad), the fc1 sums [6304, 3072] to bf16 with the bias; the split
    # passes on the same x.
    timed = {}
    M = TRAIN_B * 197
    x = torch.randn(M, 768, device="cuda", generator=gen).to(torch.bfloat16)
    acc = torch.randint(-2 ** 20, 2 ** 20, (M, 3072), device="cuda",
                        dtype=torch.int32, generator=gen)
    sr = torch.rand(M, device="cuda", generator=gen) * 1e-3
    sc = torch.rand(3072, device="cuda", generator=gen) * 1e-3
    bias = torch.randn(3072, device="cuda", generator=gen).to(torch.bfloat16)
    ax_rows, ax_cols = tq.absmax_rows(x), tq.absmax_cols(x)
    # The absmax passes have one library call each: the inf-norm of each
    # row / column in fp32. The quantizing passes have none.
    library = {"absmax_rows": lambda: torch.linalg.vector_norm(
                   x, float("inf"), dim=1, dtype=torch.float32),
               "absmax_cols": lambda: torch.linalg.vector_norm(
                   x, float("inf"), dim=0, dtype=torch.float32)}
    for name, fn in library.items():
        check(torch.equal(fn(), getattr(tq, f"{name}_reference")(x)),
              f"{name}: the library call is not the same function")
    for name, R, C, fn, plain in (
            ("quant_rows", M, 768, lambda: tq.quant_rows(x),
             lambda: tq.quant_rows_reference(x)),
            ("quant_cols_t", M, 768, lambda: tq.quant_cols_t(x),
             lambda: tq.quant_cols_t_reference(x)),
            ("dequant", M, 3072,
             lambda: tq.dequant(acc, sr, sc, bias, torch.bfloat16),
             lambda: tq.dequant_reference(acc, sr, sc, bias,
                                          torch.bfloat16)),
            ("absmax_rows", M, 768, lambda: tq.absmax_rows(x),
             lambda: tq.absmax_rows_reference(x)),
            ("absmax_cols", M, 768, lambda: tq.absmax_cols(x),
             lambda: tq.absmax_cols_reference(x)),
            ("quant_rows_given", M, 768,
             lambda: tq.quant_rows_given(x, ax_rows),
             lambda: tq.quant_rows_given_reference(x, ax_rows)),
            ("quant_cols_t_given", M, 768,
             lambda: tq.quant_cols_t_given(x, ax_cols),
             lambda: tq.quant_cols_t_given_reference(x, ax_cols))):
        row = {"kernel": name, "shape": f"[{R}, {C}] bf16", "R": R, "C": C,
               "ms": cuda_time_ms(fn), "graph_ms": graph_ms(fn),
               "plain_ms": cuda_time_ms(plain),
               "library_ms": cuda_time_ms(library[name])
               if name in library else None, "max_abs_err": 0.0,
               **quant_pass_bound(name, R, C, 2)}
        timed[name] = row
        log("int8 kernel", json.dumps(row))
    # The int8 products against bf16 at every product shape of the slice.
    for what, m, k, n in INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), device="cuda", dtype=torch.int8,
                          generator=gen)
        b = torch.randint(-127, 128, (n, k), device="cuda", dtype=torch.int8,
                          generator=gen)
        af, bf = a.to(torch.bfloat16), b.to(torch.bfloat16)
        exact = torch.equal(tq.int_mm(a, b.t()).double(),
                            af.double() @ bf.double().t())
        row = {"product": what, "M": m, "K": k, "N": n,
               "int_mm_ms": cuda_time_ms(lambda: tq.int_mm(a, b.t())),
               "bf16_ms": cuda_time_ms(lambda: af @ bf.t()),
               "int_mm_exact": exact,
               "int8_bound_ms": max((m * k + k * n + 4 * m * n)
                                    / HBM_BYTES_PER_S, 2.0 * m * n * k
                                    / PEAK_INT8_OPS) * 1e3,
               "bf16_bound_ms": bound_ms(2.0 * (m * k + k * n + m * n),
                                         2.0 * m * n * k,
                                         "bfloat16")["bound_ms"]}
        out["int_mm"].append(row)
        log("int8 product", json.dumps(row))
        check(exact, f"torch._int_mm {what}: not the exact int32 sums")
    # quant_linear forward and backward against the plain version on the
    # card: the output, dx and the int8 dW bit-equal; switchback's dW is a
    # bf16 (or fp32) product on both sides, within one step of its type.
    for what, dtype_name, m, k, n in QUANT_LINEAR_CASES:
        dtype = getattr(torch, dtype_name)
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
        b = torch.randn(n, device="cuda", generator=gen)
        g = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
        for mode in ("switchback", "int8"):
            sides = []
            for ctx in (contextlib.nullcontext(), plain_quant()):
                with ctx:
                    xl, wl, bl = (t.clone().requires_grad_()
                                  for t in (x, w, b))
                    y = tq.quant_linear(xl, wl, bl, dtype, mode)
                    y.backward(g)
                    torch.cuda.synchronize()
                    sides.append((y.detach(), xl.grad, wl.grad, bl.grad))
            (y1, dx1, dw1, db1), (y2, dx2, dw2, db2) = sides
            step = torch.finfo(dtype).eps * dw2.abs()
            row = {"case": what, "mode": mode,
                   "dtype": str(dtype).split(".")[-1], "M": m, "K": k,
                   "N": n, "y_equal": torch.equal(y1, y2),
                   "dx_equal": torch.equal(dx1, dx2),
                   "db_equal": torch.equal(db1, db2),
                   "dw_equal": torch.equal(dw1, dw2),
                   "dw_max_abs_diff": (dw1 - dw2).abs().max().item(),
                   "dw_over_step": ((dw1 - dw2).abs() / step.clamp_min(
                       1e-30)).max().item()}
            out["quant_linear"].append(row)
            log("int8 quant_linear", json.dumps(row))
            check(row["y_equal"] and row["dx_equal"] and row["db_equal"]
                  and (row["dw_equal"] or (mode == "switchback"
                                           and row["dw_over_step"] <= 1.0)),
                  f"quant_linear on the card differs from the plain "
                  f"version: {row}")
    torch.cuda.empty_cache()
    out["microbench"] = int8_microbench.main([])
    out["timed"] = timed
    results["quant"] = out
    return timed


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def http_request(port, method, path, body=None, headers=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def post_json(port, path, payload):
    status, _, body = http_request(port, "POST", path,
                                   json.dumps(payload).encode(),
                                   {"Content-Type": "application/json"})
    check(status == 200, f"POST {path} answered {status}: {body[:300]!r}")
    return json.loads(body)


def check_rows(name, emb, n, dim):
    import numpy as np
    emb = np.asarray(emb, np.float32)
    check(emb.shape == (n, dim), f"{name}: shape {emb.shape} != {(n, dim)}")
    check(bool(np.isfinite(emb).all()), f"{name}: non-finite values")
    norms = np.linalg.norm(emb, axis=-1)
    check(bool(np.allclose(norms, 1.0, atol=1e-3)),
          f"{name}: row norms {norms} are not 1")
    return emb


def serve_main_path(results: dict) -> dict:
    """Serve ViT-B/16 on the card, check every endpoint (phase 4) and
    time it (phase 5)."""
    import numpy as np
    import torch
    from PIL import Image
    from clip_finegrained_alignment_tpu_torch.cli.serve import (ClipServer,
                                                                make_server)
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.data.tokenizer import \
        HashTokenizer
    from clip_finegrained_alignment_tpu_torch.models import convert
    from clip_finegrained_alignment_tpu_torch.models.inference import \
        CLIPInference
    from clip_finegrained_alignment_tpu_torch.ops import _build

    cfg = CLIPConfig.vit_b16()
    t0 = time.time()
    sd = convert.state_dict_from_jax(convert.random_params(cfg, SEED), cfg)
    log(f"weights: {sum(v.numel() for v in sd.values())} params "
        f"from numpy seed {SEED} in {time.time() - t0:.1f} s")
    t = cfg.text
    tok = HashTokenizer(vocab_size=t.vocab_size, bos_token_id=t.bos_token_id,
                        eos_token_id=t.eos_token_id,
                        pad_token_id=t.pad_token_id)
    clip = ClipServer(sd, cfg, tok, model_name="ViT-B/16", bucket=BUCKET,
                      window_ms=2.0, device="cuda")
    srv = make_server(clip, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_port
    S, P = cfg.vision.image_size, cfg.projection_dim
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, size=(2, S, S, 3)).astype(np.uint8)
    texts = ["a photo of three cats", "two dogs on a red sofa"]
    labels = ["one cat", "two cats", "three cats"]
    try:
        # Warm-up (cuBLAS handles, allocator) outside the counted run.
        clip.embed_texts(["warmup"])
        clip.embed_images({"pixels": images[:1]})

        before = dict(clip.batcher.stats["batches_by_kind"])
        _build.reset_launch_counts()
        txt = post_json(port, "/v1/embed/text", {"texts": texts})
        img = post_json(port, "/v1/embed/image", {"pixels": images.tolist()})
        buf = io.BytesIO()
        Image.fromarray(images[0]).save(buf, format="PNG")
        img_b64 = post_json(port, "/v1/embed/image", {
            "images_b64": [base64.b64encode(buf.getvalue()).decode()]})
        status, headers, raw = http_request(
            port, "POST", "/v1/embed/image_raw", images.tobytes(),
            {"Content-Type": "application/octet-stream"})
        check(status == 200, f"POST /v1/embed/image_raw answered {status}")
        shape = tuple(int(x) for x in headers["X-Embed-Shape"].split(","))
        img_raw = np.frombuffer(raw, np.float32).reshape(shape)
        cls = post_json(port, "/v1/classify",
                        {"pixels": images[:1].tolist(), "labels": labels})
        status, _, body = http_request(port, "GET", "/stats")
        check(status == 200, f"GET /stats answered {status}")
        launches = _build.launch_counts()["attention_fwd"]
        stats = json.loads(body)
        forwards = {k: v - before[k]
                    for k, v in stats["batches_by_kind"].items()}

        txt = check_rows("/v1/embed/text", txt["embeddings"], 2, P)
        img = check_rows("/v1/embed/image", img["embeddings"], 2, P)
        check_rows("/v1/embed/image (b64)", img_b64["embeddings"], 1, P)
        img_raw = check_rows("/v1/embed/image_raw", img_raw, 2, P)
        check(bool(np.allclose(img_raw, img, atol=1e-6)),
              "image_raw and JSON image embeddings differ")
        probs = np.asarray(cls["probs"])
        check(probs.shape == (1, 3) and bool(np.isfinite(probs).all())
              and abs(probs.sum() - 1) < 1e-5, f"/v1/classify probs {probs}")
        check(cls["labels"] == labels, "/v1/classify labels")
        expected = (cfg.vision.num_layers * forwards["image"]
                    + cfg.text.num_layers * forwards["text"])
        log(f"main path: bucket forwards {forwards}, attention launches "
            f"{launches}, expected {expected}")
        check(forwards["image"] >= 4 and forwards["text"] >= 2,
              f"too few forwards reached the card: {forwards}")
        check(launches == expected,
              f"attention launches {launches} != {expected} "
              f"(layers x bucket forwards)")

        # Served embeddings vs the port in fp32 on the CPU, same weights.
        ref = CLIPInference(sd, cfg, dtype=torch.float32, batch_bucket=2,
                            device="cpu")
        ids = np.asarray(tok(texts, t.max_position_embeddings), np.int32)
        agree = {}
        for name, got, want in (
                ("image", img, ref.embed_images(images)),
                ("text", txt, ref.embed_texts(ids))):
            cos = float((got * want).sum(-1).min())
            err = float(np.abs(got - want).max())
            agree[name] = {"min_cosine": cos, "max_abs": err}
            check(cos >= EMBED_MIN_COSINE and err <= EMBED_MAX_ABS,
                  f"{name} embeddings vs CPU fp32: cosine {cos}, "
                  f"max abs {err}")
        log("vs CPU fp32:", json.dumps(agree))
        results["main_path"] = {"forwards": forwards, "launches": launches,
                                "expected_launches": expected,
                                "vs_cpu_fp32": agree, "stats": stats}
        results["rates"] = measure_rates(clip, port, cfg, images)
        return {"launches": launches}
    finally:
        srv.shutdown()
        srv.server_close()
        clip.close()
        thread.join(timeout=10)


# ---------------------------------------------------------------------------
# Phase 5: rates
# ---------------------------------------------------------------------------

def measure_rates(clip, port, cfg, images) -> dict:
    """The device rates of the server's ``CLIPInference`` at its bucket
    (``perf/serve_bench.py``'s lines and inputs), the host-clock rate, a
    bucket forward's device time by kernel and the HTTP p50."""
    import numpy as np
    import torch
    from clip_finegrained_alignment_tpu_torch.perf import serve_bench

    inf = clip.inference
    S = cfg.vision.image_size
    pix, ids = (torch.from_numpy(x).cuda()
                for x in serve_bench.inputs(cfg, BUCKET, SEED + 1))
    lines, _ = serve_bench.measure(inf, pix, ids, 20, "vitb16")
    img_ms, txt_ms = (line["ms_per_batch"] for line in lines)
    out = {
        "serve_bench": lines,
        "image_batch_ms": img_ms, "text_batch_ms": txt_ms,
        "images_per_s": BUCKET / img_ms * 1e3,
        "texts_per_s": BUCKET / txt_ms * 1e3,
        "image_model_flops_per_s": lines[0]["model_tflops_per_s"] * 1e12,
        "text_model_flops_per_s": lines[1]["model_tflops_per_s"] * 1e12,
    }
    rng = np.random.default_rng(SEED + 1)
    # Host clock, upload and download included, through CLIPInference.
    host_pix = rng.integers(0, 256, size=(BUCKET, S, S, 3)).astype(np.uint8)
    inf.embed_images(host_pix)
    t0 = time.perf_counter()
    for _ in range(5):
        inf.embed_images(host_pix)
    out["images_per_s_host_clock"] = 5 * BUCKET / (time.perf_counter() - t0)

    # Where a bucket forward's device time goes, by kernel.
    out["profile"] = profile_forward(inf, pix, ids)
    # Kernel time over the event-timed bucket forward: 1 - this is the
    # share of a back-to-back forward in which the card waits on the host.
    out["busy_share"] = {
        "image": out["profile"]["image"]["device_ms"] / img_ms,
        "text": out["profile"]["text"]["device_ms"] / txt_ms}

    # HTTP latency, one request at a time.
    lat = {"image_raw": [], "text": []}
    one = images[:1].tobytes()
    for i in range(20):
        t0 = time.perf_counter()
        status, _, _ = http_request(port, "POST", "/v1/embed/image_raw", one,
                                    {"Content-Type":
                                     "application/octet-stream"})
        lat["image_raw"].append((time.perf_counter() - t0) * 1e3)
        check(status == 200, "rate phase: image_raw request failed")
        t0 = time.perf_counter()
        post_json(port, "/v1/embed/text", {"texts": [f"a photo of {i}"]})
        lat["text"].append((time.perf_counter() - t0) * 1e3)
    out["http_p50_ms"] = {k: statistics.median(v) for k, v in lat.items()}
    out["gpu"] = gpu_line()
    log("rates:", json.dumps({k: v for k, v in out.items()
                              if k != "profile"}))
    return out


def kernel_table(run) -> dict:
    """Device time by kernel over one call of ``run`` (``torch.profiler``):
    :func:`profile_table` of its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return profile_table(prof)


def profile_table(prof, steps: int = 1) -> dict:
    """A finished profiler's device time a step: the total, the top rows
    by name, ``perf/trace_report.py``'s classes, and the port's own
    kernels by class wherever they rank, with the launches the trace holds
    (set beside the launch counters, they show whether the trace kept
    every record); empty where the profiler reports no device time. Read
    from the trace's raw records (``perf/trace_read.py::device_rows``:
    ``key_averages()`` takes ~20 s for a train step's trace)."""
    from clip_finegrained_alignment_tpu_torch.perf.trace_read import \
        device_rows
    from clip_finegrained_alignment_tpu_torch.perf.trace_report import (
        PORT_KERNEL, class_table)

    rows = device_rows(prof)
    total = sum(r[0] for r in rows)
    table = class_table(rows, steps)
    port = [c for c in table["classes"]
            if PORT_KERNEL.search("::" + c["class"])]
    return {"device_ms": total / 1e3 / steps,
            "kernel_calls": sum(r[2] for r in rows) // steps,
            "top": [{"kernel": k[:90], "ms": us / 1e3 / steps,
                     "calls": c // steps,
                     "share": us / total if total else None}
                    for us, k, c in rows[:12]],
            "classes": [{k: c[k] for k in ("class", "ms_per_step",
                                           "launches_per_step")}
                        for c in table["classes"][:16]],
            "port_kernels_ms": {c["class"]: c["ms_per_step"] for c in port},
            "port_kernels_calls": {c["class"]: c["launches_per_step"]
                                   for c in port}}


def profile_forward(inf, pix, ids) -> dict:
    """Device time by kernel over one bucket forward of each tower."""
    inf.embed_images_device(pix)
    inf.embed_texts_device(ids)
    out = {}
    for name, fn, arg in (("image", inf.embed_images_device, pix),
                          ("text", inf.embed_texts_device, ids)):
        out[name] = kernel_table(lambda: fn(arg))
        log(f"profile {name}:", json.dumps(out[name]))
    return out


# ---------------------------------------------------------------------------
# Phase 6: the train main path
# ---------------------------------------------------------------------------

def grad_triplet(model, losses) -> tuple:
    """(loss, gradient norm in float64, {name: fp32 CPU gradient}) of what
    a gradient function left in ``model``."""
    import torch
    grads = {n: (p.grad if p.grad is not None
                 else torch.zeros_like(p)).detach().float().cpu()
             for n, p in model.named_parameters()}
    norm = math.sqrt(sum(g.double().square().sum().item()
                         for g in grads.values()))
    return losses["total_loss"].item(), norm, grads


def microbatch_grads(model, batch, tcfg, cfg, dtype) -> tuple:
    """(loss, gradient norm, {name: fp32 CPU gradient}) of the first
    TRAIN_CHECK_PAIRS pairs of ``batch``'s first microbatch, on the
    model's device in ``dtype``; the norm in float64."""
    import torch
    from clip_finegrained_alignment_tpu_torch.train.engine import \
        accumulate_grads

    device = next(model.parameters()).device
    mb = {k: torch.from_numpy(x[:1, :TRAIN_CHECK_PAIRS]).to(device)
          for k, x in batch.items()}
    return grad_triplet(model, accumulate_grads(model, mb, tcfg, cfg,
                                                dtype=dtype))


def compare_grads(card, cpu, labels=("card", "cpu"),
                  what="train vs CPU") -> dict:
    """Loss and gradient-norm relative differences and per-tensor
    gradient cosines (float64) of two :func:`microbatch_grads` results.
    A key projection's bias gradient is zero by math (softmax ignores a
    constant added to a row's scores): what both sides hold is rounding
    noise, so it is held to be small, not to agree."""
    import torch
    (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = card, cpu
    cos, zero, noise = {}, [], 0.0
    for n, want in g_cpu.items():
        got = g_gpu[n]
        if not want.any():
            check(not got.any(), f"{what}: {n} has a gradient on the "
                  f"{labels[0]} side only")
            zero.append(n)
        elif n.endswith("self_attn.k_proj.bias"):
            noise = max(noise, got.norm().item() / n_gpu,
                        want.norm().item() / n_cpu)
        else:
            cos[n] = (torch.nn.functional.cosine_similarity(
                got.double().flatten(), want.double().flatten(), dim=0)).item()
    check(noise <= TRAIN_MAX_ZERO_GRAD_SHARE,
          f"{what}: a key-projection bias gradient is {noise} of the "
          "global norm; it is zero by math")
    worst = min(cos, key=cos.get)
    a, b = labels
    return {"pairs": TRAIN_CHECK_PAIRS, f"loss_{a}": l_gpu, f"loss_{b}": l_cpu,
            "loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
            f"grad_norm_{a}": n_gpu, f"grad_norm_{b}": n_cpu,
            "grad_norm_rel": abs(n_gpu - n_cpu) / n_cpu,
            "min_grad_cosine": cos[worst], "min_grad_cosine_tensor": worst,
            "median_grad_cosine": sorted(cos.values())[len(cos) // 2],
            "tensors_compared": len(cos), "zero_grad_tensors": zero,
            "k_proj_bias_grad_share_of_norm": noise}


def grads_vs_cpu(sd, cfg, tcfg, batch, dtype_name, cpu) -> dict:
    """One microbatch's loss, gradient norm and gradients on the card in
    ``dtype_name`` (the compute dtype: bfloat16, or float32 as
    ``use_amp=False`` gives it) against ``cpu``, the port's in fp32 on the
    CPU (:func:`microbatch_grads` of the same weights and batch), held to
    that dtype's TRAIN_CHECK_LIMITS."""
    import torch
    from clip_finegrained_alignment_tpu_torch.models import clip as tm

    model = tm.build_train_model(cfg, sd, device="cuda")
    card = microbatch_grads(model, batch, tcfg, cfg,
                            getattr(torch, dtype_name))
    del model
    out = {"card_dtype": dtype_name, **compare_grads(card, cpu)}
    max_loss, max_norm, min_cos = TRAIN_CHECK_LIMITS[dtype_name]
    out["limits"] = {"loss_rel": max_loss, "grad_norm_rel": max_norm,
                     "min_grad_cosine": min_cos}
    log(f"train vs CPU fp32 (card {dtype_name}):", json.dumps(out))
    check(out["loss_rel"] <= max_loss and out["grad_norm_rel"] <= max_norm
          and out["min_grad_cosine"] >= min_cos,
          f"train step on the card ({dtype_name}) vs CPU fp32 out of "
          f"limits: {out}")
    return out


def train_main_path(results: dict) -> dict:
    """SPARC + AdamSPD train steps of ViT-B/16 on the card (phase 6)."""
    import torch
    from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                             TrainConfig)
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    from clip_finegrained_alignment_tpu_torch.models import convert
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.optim.factory import \
        make_optimizer
    from clip_finegrained_alignment_tpu_torch.train.engine import (
        accumulate_grads, make_train_step)
    from clip_finegrained_alignment_tpu_torch.perf import (bench,
                                                           profile_step,
                                                           trace_report)
    from clip_finegrained_alignment_tpu_torch.utils import flops

    cfg = CLIPConfig.vit_b16()
    tcfg = TrainConfig(loss_type="sparc",
                       optimizer_type="adamspd", inverse_temperature=0.07,
                       batch_size=TRAIN_B,
                       gradient_accumulation_steps=TRAIN_ACCUM, use_amp=True)
    sd = convert.state_dict_from_jax(convert.random_params(cfg, SEED), cfg)
    host_batch = bench_batch(cfg, TRAIN_ACCUM, TRAIN_B, "sparc", SEED)
    out = {"config": {"model": "ViT-B/16", "loss": "sparc",
                      "optimizer": "adamspd", "microbatch": TRAIN_B,
                      "accum": TRAIN_ACCUM, "inverse_temperature": 0.07,
                      "lr": tcfg.lr, "weight_decay": tcfg.weight_decay,
                      "max_grad_norm": tcfg.max_grad_norm}}

    model = tm.build_train_model(cfg, sd, device="cuda")
    opt = make_optimizer(tcfg, model.named_parameters())
    step = make_train_step(tcfg, cfg, model, opt)
    batch = {k: torch.from_numpy(x).cuda() for k, x in host_batch.items()}
    watch = ["vision_model.encoder.layers.0.self_attn.q_proj.weight",
             "text_model.encoder.layers.11.mlp.fc2.weight",
             "visual_projection.weight"]
    params = dict(model.named_parameters())
    first = {n: params[n].detach().clone() for n in watch}

    def checked_step(i):
        m = step(batch)
        vals = {k: x.item() for k, x in m.items()}
        check(all(map(math.isfinite, vals.values())),
              f"train step {i}: non-finite metrics {vals}")
        return vals

    steps = [checked_step(0)]             # warm-up: cuBLAS, allocator
    _build.reset_launch_counts()
    steps.append(checked_step(1))
    launches = _build.launch_counts()
    expected = {name: 0 for name in _build.SOURCES}
    expected.update({
        "attention_fwd": (cfg.vision.num_layers + cfg.text.num_layers)
        * TRAIN_ACCUM,
        "attention_bwd": (cfg.vision.num_layers + cfg.text.num_layers)
        * TRAIN_ACCUM,
        "sparc_fwd": TRAIN_ACCUM, "sparc_bwd": TRAIN_ACCUM})
    log(f"train main path: launches {launches}, expected {expected}")
    check(launches == expected,
          f"train step launches {launches} != {expected}")
    for n in watch:
        check(not torch.equal(first[n], params[n].detach()),
              f"train steps left {n} unchanged")

    # Timed steps: perf/bench.py's (three chained steps on the host clock,
    # to the device's last result), its JSON line the tools phase's B/16.
    torch.cuda.reset_peak_memory_stats()
    seconds, last = bench.time_steps(step, batch, TOOLS_STEPS, "chain",
                                     torch.device("cuda"))
    bench_line = bench.result_line(
        "ViT-B/16", "sparc", cfg, TRAIN_B * TRAIN_ACCUM, TOOLS_STEPS,
        seconds, torch.device("cuda"),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("bench:", json.dumps(bench_line))
    steps.append(last)
    step_ms = bench_line["step_ms"]
    # One more step, split: forward + backward of the microbatches, then
    # the norm, clip and AdamSPD update (device events and host clock).
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    h0 = time.perf_counter()
    marks[0].record()
    accumulate_grads(model, batch, tcfg, cfg, dtype=torch.bfloat16)
    marks[1].record()
    h1 = time.perf_counter()
    opt.step()
    marks[2].record()
    h2 = time.perf_counter()
    torch.cuda.synchronize()
    split = {"fwd_bwd_ms": marks[0].elapsed_time(marks[1]),
             "optimizer_ms": marks[1].elapsed_time(marks[2]),
             "fwd_bwd_host_enqueue_ms": (h1 - h0) * 1e3,
             "optimizer_host_enqueue_ms": (h2 - h1) * 1e3}
    pairs = TRAIN_B * TRAIN_ACCUM
    flops_per_step = flops.sparc_train_step_flops(cfg, pairs)
    out.update({
        "launches": launches, "expected_launches": expected,
        "losses": [s["total_loss"] for s in steps],
        "grad_norms": [s["grad_norm"] for s in steps],
        "bench": bench_line, "step_ms": step_ms,
        "pairs_per_s": bench_line["value"],
        "model_flops_per_step": flops_per_step,
        "mfu_vs_989T_bf16": bench_line["mfu"],
        "peak_memory_gb": bench_line["peak_memory_gb"],
        "split_step": split,
    })
    # One step traced by perf/profile_step.py's window, its Chrome trace
    # written and read back by perf/trace_report.py (the tools phase's
    # profile_step line).
    trace_dir = tempfile.mkdtemp(prefix="cfa_profile_step_")
    try:
        timings = {}
        prof = profile_step.window(step, batch, 1, torch.device("cuda"),
                                   trace_dir, timings)
        out["profile"] = profile_table(prof)
        path = os.path.join(trace_dir, "trace.json")
        t0 = time.perf_counter()
        from_file = trace_report.class_table(trace_report.chrome_rows(path))
        out["profile_step"] = {
            "trace_bytes": os.path.getsize(path), **timings,
            "read_file_s": time.perf_counter() - t0,
            "device_ms_per_step": out["profile"]["device_ms"],
            "file_device_ms_per_step": from_file["device_ms_per_step"],
            "classes": out["profile"]["classes"], "gpu": gpu_line()}
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    live, read = out["profile"]["device_ms"], from_file["device_ms_per_step"]
    check(live > 0 and abs(read - live) <= 1e-4 * live,
          f"the trace file's device time {read} ms != the profiler's {live}")
    log(trace_report.format_table({"steps": 1, "device_ms_per_step":
                                   out["profile"]["device_ms"],
                                   "classes": out["profile"]["classes"]}))
    out["busy_share"] = out["profile"]["device_ms"] / step_ms
    out["gpu"] = gpu_line()
    log("train:", json.dumps({k: v for k, v in out.items()
                              if k != "profile"}))
    log("profile train step:", json.dumps(out["profile"]))
    del step, opt, model, batch
    torch.cuda.empty_cache()

    # The card in bf16 (this phase's steps), then in fp32 (use_amp=False,
    # the fp32 attention kernels), each against the CPU in fp32 (one CPU
    # run serves both: its dtype is fp32 either way).
    cpu = microbatch_grads(tm.build_train_model(cfg, sd, device="cpu"),
                           host_batch, tcfg, cfg, torch.float32)
    out["vs_cpu_fp32"] = grads_vs_cpu(sd, cfg, tcfg, host_batch, "bfloat16",
                                      cpu)
    out["fp32_vs_cpu_fp32"] = grads_vs_cpu(
        sd, cfg, dataclasses.replace(tcfg, use_amp=False), host_batch,
        "float32", cpu)
    results["train"] = out
    return out


# ---------------------------------------------------------------------------
# Phase 6b: GradCache training (train/gradcache.py)
# ---------------------------------------------------------------------------

def expected_gradcache_launches(accum: int, layers: int) -> dict:
    """One GradCache step: every chunk's forward twice (phase 1 without
    grad, phase 3 with it), its backward once, and the SPARC pooling
    forward and backward once over the whole pool (phase 2)."""
    from clip_finegrained_alignment_tpu_torch.ops import _build
    want = {name: 0 for name in _build.SOURCES}
    want.update({"attention_fwd": 2 * accum * layers,
                 "attention_bwd": accum * layers,
                 "sparc_fwd": 1, "sparc_bwd": 1})
    return want


def gradcache_path(results: dict) -> dict:
    """GradCache SPARC + AdamSPD steps of ViT-B/16 on the card (phase 6b):
    the pool of one loss at 32 x 8 = 256 beside phase 6's plain step (the
    two alternated, the median of GC_TIMED each), its exact launches, the
    pool at 32 x 32 = 1024, one direct step of [1, 256] (its peak memory,
    or its OOM), #3 and #4 at B=256 and 1024 against their plain versions,
    phase 1's and phase 3's embeddings of one chunk, and in fp32 one
    GradCache [8, 4] step against one direct [1, 32] step."""
    import torch
    from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                             TrainConfig)
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    from clip_finegrained_alignment_tpu_torch.models import convert
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.optim.factory import \
        make_optimizer
    from clip_finegrained_alignment_tpu_torch.train import gradcache as gc
    from clip_finegrained_alignment_tpu_torch.train.engine import (
        accumulate_grads, make_train_step)

    cfg = CLIPConfig.vit_b16()
    layers = cfg.vision.num_layers + cfg.text.num_layers
    plain_cfg = TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                            inverse_temperature=0.07, batch_size=TRAIN_B,
                            gradient_accumulation_steps=TRAIN_ACCUM,
                            use_amp=True)
    gc_cfg = dataclasses.replace(plain_cfg, grad_cache=True)
    sd = convert.state_dict_from_jax(convert.random_params(cfg, SEED), cfg)
    out = {"gpu": gpu_line(), "config": {
        "model": "ViT-B/16", "loss": "sparc", "optimizer": "adamspd",
        "microbatch": TRAIN_B, "accum": TRAIN_ACCUM, "pool": TRAIN_B
        * TRAIN_ACCUM, "large_accum": GC_LARGE_ACCUM,
        "inverse_temperature": 0.07, "compute_dtype": "bfloat16"}}
    model = tm.build_train_model(cfg, sd, device="cuda")
    opt = make_optimizer(plain_cfg, model.named_parameters())
    batch = {k: torch.from_numpy(x).cuda() for k, x in
             bench_batch(cfg, TRAIN_ACCUM, TRAIN_B, "sparc", SEED).items()}
    out["seconds"] = {}
    t_lap = [time.time()]

    def lap(name):
        now = time.time()
        out["seconds"][name] = now - t_lap[0]
        t_lap[0] = now

    def same_embeddings(model, b, tcfg, dtype):
        """Phase 1 (no grad: #1 without its lse) and phase 3 (grad: #1
        with it) embed the first chunk of ``b``: bit-equal, or how far
        apart."""
        chunk = {k: x[0] for k, x in b.items()}
        with torch.no_grad():
            first = gc._chunk_embeddings(model, chunk, tcfg, dtype=dtype)
        again = gc._chunk_embeddings(model, chunk, tcfg, dtype=dtype)
        row = {"dtype": str(dtype).split(".")[-1],
               "bit_equal": all(torch.equal(a, b.detach())
                                for a, b in zip(first, again)),
               "max_abs_diff": max((a.float() - b.detach().float()).abs()
                                   .max().item()
                                   for a, b in zip(first, again))}
        del first, again
        log("gradcache phase 1 vs phase 3 embeddings:", json.dumps(row))
        check(row["bit_equal"], f"GradCache: phase 1 and phase 3 embed a "
              f"chunk differently: {row}")
        return row

    out["phase1_vs_phase3"] = [same_embeddings(model, batch, gc_cfg,
                                               torch.bfloat16)]

    steps = {"plain": make_train_step(plain_cfg, cfg, model, opt),
             "gradcache": make_train_step(gc_cfg, cfg, model, opt)}

    def checked(name, step, b):
        vals = {k: x.item() for k, x in step(b).items()}
        check(all(map(math.isfinite, vals.values())),
              f"{name} step: non-finite metrics {vals}")
        return vals

    for name, step in steps.items():      # warm-up
        checked(name, step, batch)
    lap("setup and warm-up")

    # The two variants in turns: CUDA events around each step, the peak
    # memory of each; the first GradCache step's launches counted.
    times = {name: [] for name in steps}
    peaks = {name: 0 for name in steps}
    losses = {name: [] for name in steps}
    launches = None
    for _ in range(GC_TIMED):
        for name, step in steps.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counted = name == "gradcache" and launches is None
            if counted:
                _build.reset_launch_counts()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            m = step(batch)
            t1.record()
            torch.cuda.synchronize()
            if counted:
                launches = _build.launch_counts()
            times[name].append(t0.elapsed_time(t1))
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
            losses[name].append(m["total_loss"].item())
            check(all(math.isfinite(x.item()) for x in m.values()),
                  f"{name} step: non-finite metrics")
    want = expected_gradcache_launches(TRAIN_ACCUM, layers)
    log(f"gradcache main path: launches {launches}, expected {want}")
    check(launches == want, f"GradCache step launches {launches} != {want}")
    out.update(launches=launches, expected_launches=want)
    # Device time: the GradCache step's trace; the plain step's is phase
    # 6's trace of the same step.
    pairs = TRAIN_B * TRAIN_ACCUM
    profiles = {"plain": results["train"]["profile"],
                "gradcache": kernel_table(
                    lambda: steps["gradcache"](batch))}
    variants = {}
    for name, prof in profiles.items():
        ms = statistics.median(times[name])
        variants[name] = {
            "step_ms": ms, "step_ms_each": times[name],
            "pairs_per_s": pairs / ms * 1e3,
            "peak_memory_gb": peaks[name] / 1e9, "losses": losses[name],
            "device_ms": prof["device_ms"],
            "busy_share": prof["device_ms"] / ms,
            "profile": prof}
    variants["step_ratio"] = (variants["gradcache"]["step_ms"]
                              / variants["plain"]["step_ms"])
    variants["device_ratio"] = (variants["gradcache"]["device_ms"]
                                / variants["plain"]["device_ms"])
    out["pool_256"] = variants
    log("gradcache pool 256:", json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
         if isinstance(v, dict) else v for k, v in variants.items()}))
    log("profile gradcache step:", json.dumps(profiles["gradcache"]))
    del steps
    torch.cuda.empty_cache()
    lap("pool 256")

    # The pool of 1024: 32 x 32, one GradCache step (its chunks have the
    # shapes the steps above warmed).
    big_cfg = dataclasses.replace(gc_cfg,
                                  gradient_accumulation_steps=GC_LARGE_ACCUM)
    big = {k: torch.from_numpy(x).cuda() for k, x in bench_batch(
        cfg, GC_LARGE_ACCUM, TRAIN_B, "sparc", SEED + 1).items()}
    step = make_train_step(big_cfg, cfg, model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    m = checked("gradcache 32 x 32", step, big)
    torch.cuda.synchronize()
    big_launches = _build.launch_counts()
    want = expected_gradcache_launches(GC_LARGE_ACCUM, layers)
    check(big_launches == want,
          f"GradCache 32 x 32 launches {big_launches} != {want}")
    ms = (time.perf_counter() - t0) * 1e3
    out["pool_1024"] = {"step_ms": ms,
                        "pairs_per_s": TRAIN_B * GC_LARGE_ACCUM / ms * 1e3,
                        "peak_memory_gb": torch.cuda.max_memory_allocated()
                        / 1e9, "batch_gb": sum(x.numel() * x.element_size()
                                               for x in big.values()) / 1e9,
                        "loss": m["total_loss"], "launches": big_launches}
    log("gradcache pool 1024:", json.dumps(out["pool_1024"]))
    del step, big
    torch.cuda.empty_cache()
    lap("pool 1024")

    # Direct: the pool of 256 as one microbatch, for contrast.
    direct_cfg = dataclasses.replace(plain_cfg, batch_size=pairs,
                                     gradient_accumulation_steps=1)
    flat = {k: x.reshape((1, pairs) + x.shape[2:]) for k, x in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        m = make_train_step(direct_cfg, cfg, model, opt)(flat)
        loss = m["total_loss"].item()
        out["direct_256"] = {"peak_memory_gb":
                             torch.cuda.max_memory_allocated() / 1e9,
                             "loss": loss}
    except torch.cuda.OutOfMemoryError as e:     # the measurement itself
        out["direct_256"] = {"oom": str(e).splitlines()[0][:200],
                             "peak_memory_gb_before_oom":
                             torch.cuda.max_memory_allocated() / 1e9}
    log("gradcache direct [1, 256]:", json.dumps(out["direct_256"]))
    del flat, opt
    torch.cuda.empty_cache()
    lap("direct")

    # #3 and #4 at the pool's batch, against their plain versions.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out["sparc"] = {}
    for B, timed in ((TRAIN_B * TRAIN_ACCUM, True),
                     (TRAIN_B * GC_LARGE_ACCUM, False)):
        fwd, bwd = sparc_case(gen, f"GradCache pool {B}", B, 197,
                              timed=timed)
        out["sparc"][B] = {"fwd": fwd, "bwd": bwd}
    torch.cuda.empty_cache()
    lap("sparc")

    # fp32 (use_amp=False): GradCache [8, 4] against one direct [1, 32]
    # step, from the same weights and batch.
    a, b = GC_F32_SHAPE
    f32 = {k: torch.from_numpy(x).cuda() for k, x in
           bench_batch(cfg, a, b, "sparc", SEED + 2).items()}
    f32_cfg = dataclasses.replace(gc_cfg, use_amp=False, batch_size=b,
                                  gradient_accumulation_steps=a)
    del model, batch
    model = tm.build_train_model(cfg, sd, device="cuda")
    out["phase1_vs_phase3"].append(same_embeddings(model, f32, f32_cfg,
                                                   torch.float32))
    side = {"gradcache": grad_triplet(model, gc.gradcache_grads(
        model, f32, f32_cfg, cfg, dtype=torch.float32))}
    flat = {k: x.reshape((1, a * b) + x.shape[2:]) for k, x in f32.items()}
    side["direct"] = grad_triplet(model, accumulate_grads(
        model, flat, dataclasses.replace(f32_cfg, grad_cache=False,
                                         batch_size=a * b,
                                         gradient_accumulation_steps=1),
        cfg, dtype=torch.float32))
    f32_row = compare_grads(side["gradcache"], side["direct"],
                            labels=("gradcache", "direct"),
                            what="GradCache vs direct fp32")
    f32_row.update(pairs=a * b, shape=[a, b], limits=GC_F32_LIMITS)
    log("gradcache fp32 [8, 4] vs direct [1, 32]:", json.dumps(f32_row))
    check(f32_row["loss_rel"] <= GC_F32_LIMITS["loss_rel"]
          and f32_row["grad_norm_rel"] <= GC_F32_LIMITS["grad_norm_rel"]
          and f32_row["min_grad_cosine"] >= GC_F32_LIMITS["min_grad_cosine"],
          f"GradCache fp32 vs direct out of limits: {f32_row}")
    out["fp32_vs_direct"] = f32_row
    del model, f32, flat, side
    torch.cuda.empty_cache()
    lap("fp32")
    log("gradcache seconds:", json.dumps(out["seconds"]))
    results["gradcache"] = out
    return {"launches": {n: launches[n] + big_launches[n]
                         for n in launches},
            "sparc": out["sparc"]}


# ---------------------------------------------------------------------------
# Phase 6c: int8 quantized training (ops/quant.py, TrainConfig.quant)
# ---------------------------------------------------------------------------

def expected_quant_launches(cfg, mode: str, microbatches: int) -> tuple:
    """The int8 kernels' launches of ``microbatches`` forward+backward
    passes of ``clip_forward`` with ``quant=mode`` in one process (no
    group: the fused passes alone, :func:`expected_split_launches`), and
    how they follow from the model."""
    layers = cfg.vision.num_layers + cfg.text.num_layers
    want = expected_split_launches(layers, microbatches,
                                   int8_wgrad=mode == "int8")
    if mode == "none":
        return {k: 0 for k in want}, "none"
    how = (f"6 x ({cfg.vision.num_layers} + {cfg.text.num_layers}) + 1 = "
           f"{6 * layers + 1} linears a forward (the patch embedding "
           "last); each forward quant_rows x 2 + dequant, each dgrad but "
           "the patch embedding's quant_rows + quant_cols_t + dequant"
           + (", each wgrad quant_cols_t x 2 + dequant" if mode == "int8"
              else " (switchback's wgrad a float product)")
           + f"; no split pass (one process); x {microbatches} microbatches")
    return want, how


def expected_split_launches(layers: int, microbatches: int, *,
                            int8_wgrad: bool = True, tp: bool = False,
                            rows: bool = False) -> dict:
    """The seven int8 kernels' launches of one rank in ``microbatches``
    forward+backward passes over ``layers`` encoder layers (both towers)
    and the patch embedding, quantized: in ``int8`` mode, or with
    ``int8_wgrad`` False in ``switchback`` (a float wgrad). Four
    column-parallel projections a layer (q, k, v, fc1), two row-parallel
    ones (out, fc2), and the patch embedding (whole, no dgrad). A forward
    quantizes x and W by rows and dequantizes once: fused (quant_rows x
    2), or with its contraction split over the model ranks (``tp``, the
    row-parallel ones) absmax_rows x 2 and quant_rows_given x 2. A dgrad
    quantizes g by rows and W by columns and dequantizes once: fused
    (quant_rows, quant_cols_t), or split (``tp``, the column-parallel
    ones: absmax_rows, absmax_cols, quant_rows_given, quant_cols_t_given).
    The int8 wgrad quantizes g and x by columns and dequantizes once:
    fused (quant_cols_t x 2), or with the rows split (``rows``: global
    negatives over data ranks, SP's token blocks) absmax_cols x 2 and
    quant_cols_t_given x 2."""
    from clip_finegrained_alignment_tpu_torch.ops.quant import \
        SPLIT_KERNELS
    n = {k: 0 for k in ("quant_rows", "quant_cols_t", "dequant")
         + SPLIT_KERNELS}
    # (count, forward K split, has a dgrad, dgrad N split)
    for count, k_split, dgrad, n_split in (
            (4 * layers, False, True, tp), (2 * layers, tp, True, False),
            (1, False, False, False)):
        fwd = ({"absmax_rows": 2, "quant_rows_given": 2} if k_split
               else {"quant_rows": 2})
        bwd = {}
        if dgrad:
            bwd = ({"absmax_rows": 1, "absmax_cols": 1,
                    "quant_rows_given": 1, "quant_cols_t_given": 1}
                   if n_split else {"quant_rows": 1, "quant_cols_t": 1})
        wgrad = {}
        if int8_wgrad:
            wgrad = ({"absmax_cols": 2, "quant_cols_t_given": 2} if rows
                     else {"quant_cols_t": 2})
        for part in (fwd, bwd, wgrad):
            for k, v in part.items():
                n[k] += v * count
        n["dequant"] += count * (1 + dgrad + int8_wgrad)
    return {k: v * microbatches for k, v in n.items()}


def quant_train_path(results: dict) -> dict:
    """SPARC + AdamSPD steps of ViT-B/16 at 32 x 8 with ``quant`` none,
    switchback and int8 (phase 6c): three models from the same weights
    (phase 6's) on the same batch; the first step of each counted (exact
    int8 launches, #1-#4 as none's) with its loss and gradient norm beside
    none's; then QUANT_TIMED rounds of the three in turns (step ms, peak
    memory), one profiled step each (device ms, busy share); last, one
    microbatch of 4 pairs in int8 on the card (bf16, then fp32) against
    the CPU in fp32 int8."""
    import torch
    from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                             TrainConfig)
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    from clip_finegrained_alignment_tpu_torch.models import convert
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.optim.factory import \
        make_optimizer
    from clip_finegrained_alignment_tpu_torch.train.engine import \
        make_train_step

    cfg = CLIPConfig.vit_b16()
    base = TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                       inverse_temperature=0.07, batch_size=TRAIN_B,
                       gradient_accumulation_steps=TRAIN_ACCUM, use_amp=True)
    sd = convert.state_dict_from_jax(convert.random_params(cfg, SEED), cfg)
    host_batch = bench_batch(cfg, TRAIN_ACCUM, TRAIN_B, "sparc", SEED)
    batch = {k: torch.from_numpy(x).cuda() for k, x in host_batch.items()}
    out = {"gpu": gpu_line(), "config": {
        "model": "ViT-B/16", "loss": "sparc", "optimizer": "adamspd",
        "microbatch": TRAIN_B, "accum": TRAIN_ACCUM,
        "compute_dtype": "bfloat16", "modes": list(QUANT_MODES)}}
    t0 = time.time()
    steps, first, launches = {}, {}, {}
    for mode in QUANT_MODES:
        tcfg = dataclasses.replace(base, quant=mode)
        model = tm.build_train_model(cfg, sd, device="cuda")
        steps[mode] = make_train_step(tcfg, cfg, model, make_optimizer(
            tcfg, model.named_parameters()))
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        m = steps[mode](batch)
        torch.cuda.synchronize()
        launches[mode] = _build.launch_counts()
        first[mode] = {k: x.item() for k, x in m.items()}
        check(all(map(math.isfinite, first[mode].values())),
              f"quant {mode}: non-finite first step {first[mode]}")
    attn = {n: launches["none"][n] for n in
            ("attention_fwd", "attention_bwd", "sparc_fwd", "sparc_bwd")}
    for mode in QUANT_MODES:
        want, how = expected_quant_launches(cfg, mode, TRAIN_ACCUM)
        got = {n: launches[mode][n] for n in want}
        log(f"quant train {mode}: launches {launches[mode]}; int8 kernels "
            f"expected {want} ({how})")
        check(got == want, f"quant {mode}: int8 launches {got} != {want}")
        check({n: launches[mode][n] for n in attn} == attn,
              f"quant {mode}: #1-#4 launches differ from none's {attn}")
        e, q = first["none"]["total_loss"], first[mode]["total_loss"]
        # The JAX package's trajectory bound (tests/test_train_engine.py::
        # test_quant_trajectory_tracks_bf16) on the first step.
        check(abs(q - e) < 0.25 * abs(e) + 0.05,
              f"quant {mode}: first loss {q} against none's {e}")
    out["launches"] = launches
    out["first_step"] = {mode: {
        "total_loss": first[mode]["total_loss"],
        "grad_norm": first[mode]["grad_norm"],
        "loss_rel_vs_none": abs(first[mode]["total_loss"]
                                - first["none"]["total_loss"])
        / abs(first["none"]["total_loss"]),
        "grad_norm_rel_vs_none": abs(first[mode]["grad_norm"]
                                     - first["none"]["grad_norm"])
        / first["none"]["grad_norm"]} for mode in QUANT_MODES}
    log("quant train first step:", json.dumps(out["first_step"]))
    out["setup_s"] = time.time() - t0

    # The modes in turns: CUDA events around each step.
    times = {mode: [] for mode in QUANT_MODES}
    peaks = {mode: 0 for mode in QUANT_MODES}
    for _ in range(QUANT_TIMED):
        for mode, step in steps.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t_a = torch.cuda.Event(enable_timing=True)
            t_b = torch.cuda.Event(enable_timing=True)
            t_a.record()
            m = step(batch)
            t_b.record()
            torch.cuda.synchronize()
            times[mode].append(t_a.elapsed_time(t_b))
            peaks[mode] = max(peaks[mode], torch.cuda.max_memory_allocated())
            check(all(math.isfinite(x.item()) for x in m.values()),
                  f"quant {mode}: non-finite metrics")
    out["timed_s"] = time.time() - t0 - out["setup_s"]
    pairs = TRAIN_B * TRAIN_ACCUM
    variants = {}
    for mode, step in steps.items():
        # none's device time: phase 6's trace of the same step.
        prof = (results["train"]["profile"] if mode == "none"
                and "train" in results else kernel_table(lambda: step(batch)))
        ms = statistics.median(times[mode])
        variants[mode] = {
            "step_ms": ms, "step_ms_each": times[mode],
            "pairs_per_s": pairs / ms * 1e3,
            "peak_memory_gb": peaks[mode] / 1e9,
            "device_ms": prof["device_ms"],
            "busy_share": prof["device_ms"] / ms, "profile": prof}
        log(f"quant train {mode}:", json.dumps(
            {k: v for k, v in variants[mode].items() if k != "profile"}))
        log(f"profile quant train {mode}:", json.dumps(prof))
    for mode in QUANT_MODES[1:]:
        variants[mode]["step_ratio_vs_none"] = (variants[mode]["step_ms"]
                                                / variants["none"]["step_ms"])
        variants[mode]["device_ratio_vs_none"] = (
            variants[mode]["device_ms"] / variants["none"]["device_ms"])
    out["variants"] = variants
    del steps, batch
    torch.cuda.empty_cache()
    t_cpu = time.time()

    # One microbatch of 4 pairs in int8: the card (bf16, then fp32) against
    # the CPU in fp32, each with QUANT_CHECK_LIMITS of its card dtype.
    q_cfg = dataclasses.replace(base, quant="int8")
    cpu = microbatch_grads(tm.build_train_model(cfg, sd, device="cpu"),
                           host_batch, q_cfg, cfg, torch.float32)
    out["vs_cpu"] = []
    for dtype_name in ("bfloat16", "float32"):
        tcfg = dataclasses.replace(q_cfg, use_amp=dtype_name == "bfloat16")
        model = tm.build_train_model(cfg, sd, device="cuda")
        card = microbatch_grads(model, host_batch, tcfg, cfg,
                                getattr(torch, dtype_name))
        del model
        row = {"card_dtype": dtype_name, "quant": "int8",
               **compare_grads(card, cpu, what="int8 train vs CPU")}
        max_loss, max_norm, min_cos = QUANT_CHECK_LIMITS[dtype_name]
        row["limits"] = {"loss_rel": max_loss, "grad_norm_rel": max_norm,
                         "min_grad_cosine": min_cos}
        log(f"int8 train vs CPU fp32 int8 (card {dtype_name}):",
            json.dumps(row))
        check(row["loss_rel"] <= max_loss and row["grad_norm_rel"] <= max_norm
              and row["min_grad_cosine"] >= min_cos,
              f"int8 train step on the card ({dtype_name}) vs the CPU out "
              f"of limits: {row}")
        out["vs_cpu"].append(row)
    torch.cuda.empty_cache()
    out["vs_cpu_s"] = time.time() - t_cpu
    out["seconds"] = time.time() - t0
    log("quant train seconds:", json.dumps(
        {k: out[k] for k in ("setup_s", "timed_s", "vs_cpu_s", "seconds")}))
    results["quant_train"] = out
    return {"launches": {n: sum(launches[m][n] for m in QUANT_MODES)
                         for n in launches["none"]}}


# ---------------------------------------------------------------------------
# Phase "tools": the measuring tools (perf/)
# ---------------------------------------------------------------------------

def expected_bench_launches(cfg, loss: str, accum: int, steps: int) -> dict:
    """``perf/bench.py``'s run: the warm-up and ``steps`` steps, each
    microbatch a forward and a backward of every encoder layer (the count
    loss's counterfactual captions one more text tower) and, under SPARC,
    one pooling forward and backward."""
    from clip_finegrained_alignment_tpu_torch.ops import _build
    layers = cfg.vision.num_layers + cfg.text.num_layers * (
        2 if loss == "count" else 1)
    calls = (1 + steps) * accum
    want = {name: 0 for name in _build.SOURCES}
    want.update(attention_fwd=calls * layers, attention_bwd=calls * layers)
    if loss == "sparc":
        want.update(sparc_fwd=calls, sparc_bwd=calls)
    return want


def tools_path(results: dict) -> dict:
    """The port's measuring tools on the card, each line finite and naming
    the card: ``perf/bench.py`` at ViT-B/32 128 × 4 and with the count
    loss (ViT-B/16 32 × 8), TOOLS_STEPS steps each (ViT-B/16 SPARC 32 × 8
    is phase 6's line); ``perf/serve_http_bench.py`` at 8 clients × 5
    requests; ``perf/sparc_microbench.py`` at B=32 and 256
    (``perf/serve_bench.py`` at bucket 64 is phase 5's, ``profile_step``
    and ``trace_report`` phase 6's). Each tool's launches counted on its
    own: the bench runs' and the microbenchmark's exact, the HTTP bench's
    #1 alone."""
    import torch
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.perf import (bench,
                                                           serve_http_bench,
                                                           sparc_microbench)

    card = gpu_line()
    t0 = time.time()
    out = {"bench": [results["train"]["bench"]],
           "serve_bench": results["rates"]["serve_bench"],
           "profile_step": results["train"]["profile_step"], "launches": {},
           "seconds_by_run": {}}
    total = {name: 0 for name in _build.SOURCES}

    def counted(name, fn, want=None):
        _build.reset_launch_counts()
        t = time.time()
        res = fn()
        out["seconds_by_run"][name] = time.time() - t
        got = _build.launch_counts()
        out["launches"][name] = got
        for k, n in got.items():
            total[k] += n
        if want is not None:
            check(got == want, f"tools {name}: launches {got} != {want}")
        return res

    for model, loss in (("ViT-B/32", "sparc"), ("ViT-B/16", "count")):
        B, accum = bench.regime(model, loss)
        line = counted(f"bench {model} {loss}", lambda: bench.run(
            model, loss, steps=TOOLS_STEPS, device="cuda"),
            expected_bench_launches(CLIPConfig.from_name(model), loss,
                                    accum, TOOLS_STEPS))
        log("bench:", json.dumps(line))
        out["bench"].append(line)
        torch.cuda.empty_cache()
    http = counted("serve_http_bench", lambda: serve_http_bench.run(
        8, 5, "ViT-B/32", "cuda"))
    got = out["launches"]["serve_http_bench"]
    check(got["attention_fwd"] > 0
          and not any(n for k, n in got.items() if k != "attention_fwd"),
          f"tools serve_http_bench: launches {got}, #1 alone expected")
    out["serve_http_bench"] = http
    iters = 50
    micro = {"sparc_fwd": 2 * (1 + iters) + 1, "sparc_bwd": 1 + iters}
    out["sparc_microbench"] = [
        line for B in (TRAIN_B, 256)
        for line in counted(f"sparc_microbench B={B}",
                            lambda B=B: sparc_microbench.run(B, iters,
                                                             "cuda"),
                            {name: micro.get(name, 0)
                             for name in _build.SOURCES})]
    torch.cuda.empty_cache()

    def numbers(x):
        if isinstance(x, dict):
            return [v for y in x.values() for v in numbers(y)]
        if isinstance(x, list):
            return [v for y in x for v in numbers(y)]
        return [x] if isinstance(x, (int, float)) \
            and not isinstance(x, bool) else []
    lines = (out["bench"] + out["serve_bench"] + out["sparc_microbench"]
             + [http, out["profile_step"]])
    for line in lines:
        check(all(map(math.isfinite, numbers(line))),
              f"tools: a number is not finite in {line}")
        check(line["gpu"] == card, f"tools: {line} does not name the card")
    for line in out["bench"]:
        check(line["value"] > 0 and 0 < line["mfu"] < 1,
              f"tools: bench line {line}")
    for name in ("text", "image", "image_raw"):
        check(http[name]["n"] == 40 and http[name]["mean_batch_fill"] >= 1,
              f"tools: serve_http_bench {name}: {http[name]}")
    out["seconds"] = time.time() - t0
    log("tools:", json.dumps({k: out[k] for k in ("launches",
                                                  "seconds_by_run",
                                                  "seconds")}))
    results["tools"] = out
    return {"launches": total}


# ---------------------------------------------------------------------------
# Phase 7: long-sequence attention
# ---------------------------------------------------------------------------

def long_inputs(gen, B, H, S, D, dtype, bias_kind):
    """Normal q, k, v, do ``[B, H, S, D]`` in ``dtype`` and the bias:
    None, a shared causal ``[1, 1, S, S]``, or a batched key-padding
    ``[B, 1, S, S]`` (keys past a random length in [S/2, S] at −1e9) whose
    first query row of batch 0 is masked everywhere."""
    import torch
    q, k, v, do = (torch.randn(B, H, S, D, device="cuda",
                               generator=gen).to(dtype) for _ in range(4))
    bias = None
    if bias_kind == "causal":
        bias = torch.full((S, S), -1e9, device="cuda").triu(1)[None, None]
    elif bias_kind == "padding":
        lens = torch.randint(S // 2, S + 1, (B,), device="cuda", generator=gen)
        keys = torch.arange(S, device="cuda")
        bias = torch.where(keys[None] >= lens[:, None], -1e9, 0.0)[
            :, None, None].expand(B, 1, S, S).contiguous()
        bias[0, 0, 0] = -1e9
    return q, k, v, do, bias


def check_long_attention(results: dict) -> tuple:
    """The three blockwise kernels against their plain versions (7a) and
    timed at S=2048 B=4 (7b)."""
    import torch
    import torch.nn.functional as F
    from clip_finegrained_alignment_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [(shape, torch.bfloat16) for shape in LONG_SHAPES]
    cases.append((LONG_SHAPES[-1], torch.float32))
    rows = {"fwd": [], "dq": [], "dkdv": []}
    for (what, B, H, S, D, bias_kind), dtype in cases:
        dname = str(dtype).split(".")[-1]
        scale = D ** -0.5
        q, k, v, do, bias = long_inputs(gen, B, H, S, D, dtype, bias_kind)
        o, lse = fa._launch_fwd(q, k, v, bias, scale, LONG_BLOCK)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.blockwise_attention_reference(
            q, k, v, bias, scale, LONG_BLOCK)
        delta = fa._delta(do, ref_o)
        dq = fa._launch_bwd_dq(q, k, v, bias, scale, do, ref_lse, delta)
        dk, dv = fa._launch_bwd_dkdv(q, k, v, bias, scale, do, ref_lse, delta)
        torch.cuda.synchronize()
        ref = fa.blockwise_attention_backward_reference(
            q, k, v, bias, scale, ref_o, ref_lse, do)
        got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        want = {"o": ref_o, "lse": ref_lse, "dq": ref[0], "dk": ref[1],
                "dv": ref[2]}
        for name, t in got.items():
            check(bool(torch.isfinite(t).all()),
                  f"blockwise {what} {dname} {name}: non-finite")
        errs = {n: (got[n].float() - want[n].float()).abs().max().item()
                for n in got}
        top = {n: want[n].float().abs().max().item() for n in want}
        excess = {n: bwd_excess(got[n], want[n], dname)
                  for n in ("o", "dq", "dk", "dv")}
        excess["lse"] = lse_excess(lse, ref_lse)
        common = {"shape": what, "B": B, "H": H, "S": S, "D": D,
                  "bias": bias_kind, "dtype": dname,
                  "tol": "|err| <= %g·|ref| + %g·max|ref|" % BWD_TOL[dname]}
        if bias_kind == "padding":
            # The masked row: JAX's padded keys tie with the real ones, so
            # it is Σv / Sk over Sk = round_up(S, block_k) keys.
            Sk = -(-S // LONG_BLOCK) * LONG_BLOCK
            quirk = (v[0].float().sum(1) / Sk).to(dtype)
            common["masked_row_vs_sum_over_sk"] = bwd_excess(
                o[0, :, 0], quirk, dname)
            common["masked_row_vs_plain"] = bwd_excess(
                o[0, :, 0], ref_o[0, :, 0], dname)
            check(max(common["masked_row_vs_sum_over_sk"],
                      common["masked_row_vs_plain"]) <= 1.0,
                  f"blockwise {what} {dname}: the fully masked row is not "
                  f"Σv / {Sk}: {common}")
        fwd = dict(common, max_abs_err=errs["o"], lse_max_abs_err=errs["lse"],
                   max_err_over_tol={"o": excess["o"], "lse": excess["lse"]},
                   max_abs_ref=top["o"])
        bdq = dict(common, max_abs_err=errs["dq"],
                   max_err_over_tol=excess["dq"], max_abs_ref=top["dq"])
        bkv = dict(common, max_abs_err=max(errs["dk"], errs["dv"]),
                   max_abs_err_by={"dk": errs["dk"], "dv": errs["dv"]},
                   max_err_over_tol=max(excess["dk"], excess["dv"]),
                   max_abs_ref={"dk": top["dk"], "dv": top["dv"]})
        check(max(excess.values()) <= 1.0,
              f"blockwise {what} {dname}: error over its tolerance {excess}")
        if what == LONG_TIMED and dtype == torch.bfloat16:
            fwd["ms"] = cuda_time_ms(
                lambda: fa._launch_fwd(q, k, v, None, scale, LONG_BLOCK))
            bdq["ms"] = cuda_time_ms(lambda: fa._launch_bwd_dq(
                q, k, v, None, scale, do, ref_lse, delta))
            bkv["ms"] = cuda_time_ms(lambda: fa._launch_bwd_dkdv(
                q, k, v, None, scale, do, ref_lse, delta))
            fwd["plain_ms"] = cuda_time_ms(
                lambda: fa.blockwise_attention_reference(
                    q, k, v, None, scale, LONG_BLOCK), reps=5)
            # One plain function gives dq, dk and dv together.
            bdq["plain_ms"] = bkv["plain_ms"] = cuda_time_ms(
                lambda: fa.blockwise_attention_backward_reference(
                    q, k, v, None, scale, ref_o, ref_lse, do), reps=5)
            fwd["library_ms"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            # The backward alone of PyTorch's fused attention, through a
            # retained graph, for the dq and dk/dv rows together.
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
            bdq["library_ms"] = bkv["library_ms"] = cuda_time_ms(
                lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                            retain_graph=True))
            del out, qg, kg, vg
            fwd.update(attention_bound_ms(B, S, H, D, dname, False))
            bdq.update(attention_bound_ms(B, S, H, D, dname, False,
                                          tensors=5, products=3))
            bkv.update(attention_bound_ms(B, S, H, D, dname, False,
                                          tensors=6, products=4))
            # The rate reached: the function's operations over its time.
            for row in (fwd, bdq, bkv):
                row["tflops"] = row["flops"] / (row["ms"] * 1e9)
        for kind, row in (("fwd", fwd), ("dq", bdq), ("dkdv", bkv)):
            log(f"blockwise {kind}", json.dumps(row))
            rows[kind].append(row)
        del q, k, v, do, bias, o, lse, dq, dk, dv, ref_o, ref_lse, ref, got, \
            want, delta
        torch.cuda.empty_cache()
    results["blockwise"] = rows
    return tuple(next(r for r in rows[kind] if r["shape"] == LONG_TIMED
                      and r["dtype"] == "bfloat16")
                 for kind in ("fwd", "dq", "dkdv"))


def long_main_path(results: dict) -> dict:
    """The ported flash microbenchmark at its three design points, counted
    (7c), then one counted forward+backward of
    ``blockwise_flash_attention``."""
    import torch
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.ops import flash_attention as fa
    from clip_finegrained_alignment_tpu_torch.perf import flash_microbench

    lines = []
    _build.reset_launch_counts()
    for S, B in MICROBENCH_POINTS:
        lines += flash_microbench.main(["--seq", str(S), "--batch", str(B),
                                        "--steps", str(MICROBENCH_STEPS)])
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    # Each path runs fwd and fwd+bwd at each design point: a warm-up call
    # and MICROBENCH_STEPS timed calls each.
    calls = len(MICROBENCH_POINTS) * (MICROBENCH_STEPS + 1)
    expected = {name: 0 for name in _build.SOURCES}
    expected.update({"flash_fwd": 2 * calls, "flash_bwd_dq": calls,
                     "flash_bwd_dkdv": calls, "attention_fwd": 2 * calls,
                     "attention_bwd": calls})
    log(f"long main path (microbench): launches {launches}, "
        f"expected {expected}")
    check(launches == expected,
          f"flash microbench launches {launches} != {expected}")
    check(len(lines) == 4 * len(MICROBENCH_POINTS),
          f"flash microbench printed {len(lines)} lines")
    for line in lines:
        ms = float(line.rsplit(": ", 1)[1].split()[0])
        check(math.isfinite(ms) and ms > 0, f"flash microbench: {line}")

    # One forward+backward launches each blockwise kernel exactly once.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    B, S = 4, 2048
    q, k, v = (t.requires_grad_() for t in long_inputs(
        gen, B, 12, S, LONG_D, torch.bfloat16, None)[:3])
    _build.reset_launch_counts()
    loss = fa.blockwise_flash_attention(q, k, v, None, LONG_D ** -0.5,
                                        LONG_BLOCK, LONG_BLOCK).float().sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    torch.cuda.synchronize()
    one = _build.launch_counts()
    want = {name: 0 for name in _build.SOURCES}
    want.update({"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1})
    log(f"blockwise forward+backward: launches {one}, expected {want}")
    check(one == want, f"blockwise forward+backward launches {one} != {want}")
    check(math.isfinite(loss.item()), f"blockwise loss {loss.item()}")
    for name, g in zip("qkv", grads):
        check(bool(torch.isfinite(g).all()), f"blockwise d{name}: non-finite")
    results["long"] = {"microbench": lines, "launches": launches,
                       "one_step_launches": one, "loss": loss.item(),
                       "gpu": gpu_line()}
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 8: the training CLI on the card
# ---------------------------------------------------------------------------

def cpu_copy(state):
    """A copy of a state dict with every tensor cloned to the CPU."""
    import torch
    if isinstance(state, dict):
        return {k: cpu_copy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(cpu_copy(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    return state


def same_state(got, want) -> bool:
    """Whether two state dicts (nested dicts, lists, numbers, tensors on
    any device) are equal, tensors bit for bit."""
    import torch
    if isinstance(want, dict):
        return isinstance(got, dict) and set(got) == set(want) and all(
            same_state(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return isinstance(got, (list, tuple)) and len(got) == len(want) \
            and all(same_state(x, y) for x, y in zip(got, want))
    if isinstance(want, torch.Tensor):
        return isinstance(got, torch.Tensor) and got.dtype == want.dtype \
            and torch.equal(got.cpu(), want.cpu())
    return got == want


def train_cli_path(results: dict, keep_dir: str) -> dict:
    """Generate a procedural dataset and pack it with the port's CLIs, then
    four in-process runs of the port's ``cli.train.main`` at ViT-B/16 full
    width: A (packed, pixel bank on the card, SPARC + AdamSPD, 2 epochs),
    B (bare ``--resume`` of A to 3 epochs), C (live decode, the count loss
    with AdamW, 1 epoch, with ``--eval-every-epoch`` where matplotlib can
    write its plots), D (C in fp32: ``--no-amp``), then E
    (``--grad-cache``), F (``--import-optimizer-state``) and G (``--quant
    int8``), as the module docstring says. Each run's launches are
    counted on their own and must be exactly what its steps (and
    evaluations) imply. A's ``best/`` is kept in ``keep_dir`` for phase 9,
    with C's held-out batch (the first of its epoch 0)."""
    import gc
    import importlib.util
    import shutil
    import tempfile

    import torch
    from clip_finegrained_alignment_tpu_torch import native
    from clip_finegrained_alignment_tpu_torch.cli import (generate_data,
                                                          pack_dataset)
    from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
    from clip_finegrained_alignment_tpu_torch.cli import export_checkpoint
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.core.precision import \
        compute_dtype
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.optim import interop
    from clip_finegrained_alignment_tpu_torch.train import engine

    cfg = CLIPConfig.vit_b16()
    layers = cfg.vision.num_layers + cfg.text.num_layers
    out = {"gpu": gpu_line(), "samples": CLI_SAMPLES,
           "image_size": cfg.vision.image_size}
    work = tempfile.mkdtemp(prefix="cfa_train_cli_")
    prev_env = os.environ.get("CFA_ALLOW_HASH_TOKENIZER")
    # No BPE vocabulary on the card's host: the hermetic hash tokenizer.
    os.environ["CFA_ALLOW_HASH_TOKENIZER"] = "1"
    seen_keys, restored = set(), {}
    step, load_state_dict = engine.Trainer.step, engine.Trainer.load_state_dict
    load_reference_state = interop.load_reference_state

    def spy_step(self, batch):
        seen_keys.update(batch)
        return step(self, batch)

    def spy_load(self, state):
        load_state_dict(self, state)
        restored["weights"] = {k: v.detach().cpu().clone()
                               for k, v in self.model.state_dict().items()}

    def counted(name, argv):
        seen_keys.clear()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.time()
        res = cli_train.main(argv)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        hist = res["history"]
        run = {"steps": res["trainer"].global_step,
               "epoch_losses": [h["avg_loss"] for h in hist],
               "epoch_pairs_per_s": [h["pairs_per_sec"] for h in hist],
               "epoch_s": [h["seconds"] for h in hist],
               "peak_memory_gb": res["peak_memory_bytes"] / 1e9,
               "run_s": time.time() - t0, "launches": launches,
               "batch_keys": sorted(seen_keys)}
        check(hist and all(map(math.isfinite, run["epoch_losses"])),
              f"train cli {name}: epoch losses {run['epoch_losses']}")
        log(f"train cli run {name}: launches {launches}")
        return res, run

    def expect(steps, accum, per_microbatch, sparc):
        want = {n: 0 for n in _build.SOURCES}
        want.update({"attention_fwd": steps * accum * per_microbatch,
                     "attention_bwd": steps * accum * per_microbatch,
                     "sparc_fwd": steps * accum * sparc,
                     "sparc_bwd": steps * accum * sparc})
        return want

    engine.Trainer.step, engine.Trainer.load_state_dict = spy_step, spy_load
    try:
        t0 = time.time()
        out["native_available"] = native.available()
        out["native_build_s"] = time.time() - t0
        if not out["native_available"]:   # "auto" then decodes with PIL
            out["native_build_error"] = (native.build_error() or "")[-300:]
        data, packed = os.path.join(work, "data"), os.path.join(work, "packed")
        ckpt = os.path.join(work, "ckpt")
        anns = os.path.join(data, "synthetic_annotations.json")
        t0 = time.time()
        generate_data.main(["--procedural", "--output-dir", data,
                            "--num-samples", str(CLI_SAMPLES),
                            "--image-size", str(cfg.vision.image_size),
                            "--seed", str(SEED)])
        out["generate_s"] = time.time() - t0
        t0 = time.time()
        pack_dataset.main(["--annotations", anns, "--output", packed,
                           "--model", "ViT-B/16", "--loss-type", "sparc"])
        out["pack_s"] = time.time() - t0
        out["disk_free_gb"] = shutil.disk_usage(work).free / 1e9

        sparc = ["--model", "ViT-B/16", "--loss-type", "sparc",
                 "--optimizer", "adamspd", "--batch-size", str(TRAIN_B),
                 "--grad-accum", str(TRAIN_ACCUM), "--inverse-temperature",
                 "0.07", "--save-every", "1", "--packed", packed,
                 "--device-data", "--checkpoint-dir", ckpt,
                 "--experiment-name", "sparc", "--seed", str(SEED),
                 "--log-every", "1"]
        spe = CLI_SAMPLES // (TRAIN_B * TRAIN_ACCUM)
        # Run A: packed, the pixel bank on the card.
        res, a = counted("A", sparc + ["--epochs", "2", "--metrics-file",
                                       os.path.join(work, "metrics.jsonl")])
        bank = res["trainer"].pixel_bank
        a["pixel_bank"] = {"device": str(bank.device),
                           "shape": list(bank.shape), "dtype": str(bank.dtype)}
        check(bank.device.type == "cuda" and bank.dtype == torch.uint8
              and tuple(bank.shape) == (CLI_SAMPLES, cfg.vision.image_size,
                                        cfg.vision.image_size, 3),
              f"train cli A: pixel bank {a['pixel_bank']}")
        check("pixel_index" in a["batch_keys"]
              and "pixel_values" not in a["batch_keys"],
              f"train cli A: batches carried {a['batch_keys']}")
        check(a["steps"] == 2 * spe, f"train cli A: {a['steps']} steps")
        want = expect(a["steps"], TRAIN_ACCUM, layers, 1)
        check(a["launches"] == want,
              f"train cli A: launches {a['launches']} != {want}")
        exp = os.path.join(ckpt, "sparc")
        check(sorted(os.listdir(exp)) == ["best", "epoch_0", "epoch_1"],
              f"train cli A: checkpoints {sorted(os.listdir(exp))}")
        with open(os.path.join(exp, "best", "meta.json")) as f:
            best_step = json.load(f)["global_step"]
        best = torch.load(os.path.join(exp, "best", "state.pt"),
                          map_location="cpu", weights_only=True)["model"]
        del res, bank
        gc.collect()
        torch.cuda.empty_cache()
        # Phase 9 evaluates the best/ that run A wrote; B may replace it.
        kept = os.path.join(keep_dir, "best")
        os.makedirs(kept)
        for name in ("state.pt", "meta.json"):
            try:
                os.link(os.path.join(exp, "best", name),
                        os.path.join(kept, name))
            except OSError:
                shutil.copyfile(os.path.join(exp, "best", name),
                                os.path.join(kept, name))

        # Run B: bare --resume (best/) to 3 epochs.
        restored.clear()
        res, b = counted("B", sparc + ["--epochs", "3", "--resume"])
        check(set(restored.get("weights", {})) == set(best)
              and all(torch.equal(restored["weights"][k], v)
                      for k, v in best.items()),
              "train cli B: the restored weights are not best/'s")
        b["resumed_at_step"] = res["resumed_at_step"]
        check(res["resumed_at_step"] == best_step and b["steps"] == 3 * spe,
              f"train cli B: resumed at {res['resumed_at_step']} (best/ "
              f"holds {best_step}), ended at {b['steps']}")
        want = expect(b["steps"] - best_step, TRAIN_ACCUM, layers, 1)
        check(b["launches"] == want,
              f"train cli B: launches {b['launches']} != {want}")
        del res
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(exp)

        # Run E: A's data and flags with --grad-cache, one epoch: one loss
        # over each step's pool of 256.
        res, e = counted("E", sparc + ["--epochs", "1", "--grad-cache",
                                       "--experiment-name", "gradcache"])
        check(res["trainer"].cfg.grad_cache and e["steps"] == spe,
              f"train cli E: grad_cache {res['trainer'].cfg.grad_cache}, "
              f"{e['steps']} steps")
        check("pixel_index" in e["batch_keys"],
              f"train cli E: batches carried {e['batch_keys']}")
        want = {n: spe * c for n, c in
                expected_gradcache_launches(TRAIN_ACCUM, layers).items()}
        check(e["launches"] == want,
              f"train cli E: launches {e['launches']} != {want}")
        del res
        gc.collect()
        torch.cuda.empty_cache()

        # Run F: A's best/ exported as a reference .pt with its optimizer
        # state (cli/export_checkpoint.py), then --pretrained that.pt
        # --import-optimizer-state to B's epochs. The optimizer state right
        # after the import must be best/'s exactly; the epochs' losses are
        # held against B's (a --resume of the same best/).
        pt = os.path.join(work, "best_reference.pt")
        t0 = time.time()
        export_checkpoint.main(["--checkpoint", kept, "--model", "ViT-B/16",
                                "--output", pt, "--include-optimizer"])
        export_s = time.time() - t0
        imported = {}

        def spy_import(optimizer, opt_sd, model_cfg):
            n = load_reference_state(optimizer, opt_sd, model_cfg)
            # A copy: the steps that follow update the live tensors.
            imported["state"] = cpu_copy(optimizer.state_dict())
            return n

        interop.load_reference_state = spy_import
        try:
            res, f = counted("F", sparc + [
                "--epochs", "3", "--pretrained", pt,
                "--import-optimizer-state", "--experiment-name", "interop"])
        finally:
            interop.load_reference_state = load_reference_state
        f["export_s"] = export_s
        f["pt_gb"] = os.path.getsize(pt) / 1e9
        want_opt = torch.load(os.path.join(kept, "state.pt"),
                              map_location="cpu",
                              weights_only=True)["optimizer"]
        f["optimizer_state_equal"] = same_state(imported.get("state"),
                                                want_opt)
        check(f["optimizer_state_equal"],
              "train cli F: the imported optimizer state is not best/'s")
        check(res["trainer"].global_step == b["steps"] and res[
            "start_epoch"] == best_step // spe,
              f"train cli F: steps {res['trainer'].global_step}, start "
              f"epoch {res['start_epoch']}")
        want = expect(f["steps"] - best_step, TRAIN_ACCUM, layers, 1)
        check(f["launches"] == want,
              f"train cli F: launches {f['launches']} != {want}")
        f["losses_equal_resume"] = f["epoch_losses"] == b["epoch_losses"]
        f["loss_diff_vs_resume"] = [x - y for x, y in zip(f["epoch_losses"],
                                                         b["epoch_losses"])]
        log(f"train cli run F: optimizer state equal to best/'s "
            f"{f['optimizer_state_equal']}, epoch losses {f['epoch_losses']}"
            f" against B's {b['epoch_losses']}")
        del res, best, want_opt, imported
        gc.collect()
        torch.cuda.empty_cache()
        os.unlink(pt)

        # Run G: A's data and flags with --quant int8, one epoch: every
        # encoder projection and the patch embedding through the int8
        # kernels, #1-#4 as A's.
        res, g = counted("G", sparc + ["--epochs", "1", "--quant", "int8",
                                       "--experiment-name", "quant"])
        check(res["trainer"].cfg.quant == "int8" and g["steps"] == spe,
              f"train cli G: quant {res['trainer'].cfg.quant}, "
              f"{g['steps']} steps")
        want = expect(g["steps"], TRAIN_ACCUM, layers, 1)
        q_want, how = expected_quant_launches(cfg, "int8",
                                              g["steps"] * TRAIN_ACCUM)
        want.update(q_want)
        log(f"train cli run G: --quant int8, int8 launches expected "
            f"{q_want} ({how})")
        check(g["launches"] == want,
              f"train cli G: launches {g['launches']} != {want}")
        del res
        gc.collect()
        torch.cuda.empty_cache()

        # Run C: live decode, the count loss (one more text tower: the
        # counterfactual captions) with AdamW. --eval-every-epoch writes a
        # confusion PNG per evaluation, as in the JAX package, so it runs
        # only where matplotlib is installed; phase 9 evaluates the
        # held-out batch on the card either way.
        plots = importlib.util.find_spec("matplotlib") is not None
        res, c = counted("C", [
            "--model", "ViT-B/16", "--loss-type", "count", "--optimizer",
            "adamw", "--batch-size", str(TRAIN_B), "--grad-accum",
            str(CLI_COUNT_ACCUM), "--epochs", "1", "--annotations", anns,
            "--checkpoint-dir", ckpt, "--experiment-name", "count",
            "--seed", str(SEED), "--log-every", "1"]
            + (["--eval-every-epoch"] if plots else []))
        c["eval_every_epoch"] = plots
        log(f"train cli run C: --eval-every-epoch {plots} (matplotlib "
            f"{'installed' if plots else 'missing'})")
        c["image_path"] = res["image_path"]
        log(f"train cli run C: image decode {res['image_path']}")
        # The live pipeline alone, no step: the host's decode rate.
        t0 = time.time()
        pairs = sum(len(batch["input_ids"])
                    for batch in res["pipeline"].epoch(0))
        c["decode_only_pairs_per_s"] = pairs / (time.time() - t0)
        check(c["steps"] == CLI_SAMPLES // (TRAIN_B * CLI_COUNT_ACCUM),
              f"train cli C: {c['steps']} steps")
        check("pixel_values" in c["batch_keys"]
              and "cf_input_ids" in c["batch_keys"],
              f"train cli C: batches carried {c['batch_keys']}")
        want = expect(c["steps"], CLI_COUNT_ACCUM, layers + cfg.text.num_layers,
                      0)
        # Before training and after its one epoch: an image tower and two
        # text towers (GT and counterfactual captions) each.
        want["attention_fwd"] += (2 if plots else 0) * (
            layers + cfg.text.num_layers)
        check(c["launches"] == want,
              f"train cli C: launches {c['launches']} != {want}")
        held_out = next(iter(res["pipeline"].epoch(0)))
        del res
        gc.collect()
        torch.cuda.empty_cache()

        # Run D: C's data and loss in fp32 (--no-amp, the reference count
        # fine-tune's forced fp32): the fp32 attention forward and backward
        # kernels in every layer of all three towers, no SPARC.
        res, d = counted("D", [
            "--model", "ViT-B/16", "--loss-type", "count", "--optimizer",
            "adamw", "--no-amp", "--batch-size", str(TRAIN_B),
            "--grad-accum", str(CLI_COUNT_ACCUM), "--epochs", "1",
            "--annotations", anns, "--checkpoint-dir", ckpt,
            "--experiment-name", "count_fp32", "--seed", str(SEED),
            "--log-every", "1"])
        d["compute_dtype"] = str(compute_dtype(res["trainer"].cfg))
        check(d["compute_dtype"] == "torch.float32",
              f"train cli D: compute dtype {d['compute_dtype']}")
        check(d["steps"] == CLI_SAMPLES // (TRAIN_B * CLI_COUNT_ACCUM),
              f"train cli D: {d['steps']} steps")
        want = expect(d["steps"], CLI_COUNT_ACCUM,
                      layers + cfg.text.num_layers, 0)
        check(d["launches"] == want,
              f"train cli D: launches {d['launches']} != {want}")
        d["step_ms"] = [s / d["steps"] * 1e3 for s in d["epoch_s"]]
        del res
        gc.collect()
        torch.cuda.empty_cache()
        # The packed dataset goes on to phase 10's run H.
        shutil.move(packed, os.path.join(keep_dir, "packed"))
    finally:
        engine.Trainer.step = step
        engine.Trainer.load_state_dict = load_state_dict
        if prev_env is None:
            os.environ.pop("CFA_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["CFA_ALLOW_HASH_TOKENIZER"] = prev_env
        shutil.rmtree(work, ignore_errors=True)

    out.update({"A": a, "B": b, "C": c, "D": d, "E": e, "F": f, "G": g,
                "kernels_build_s": results.get("build_s")})
    log("train cli:", json.dumps(out))
    results["train_cli"] = out
    total = {n: sum(r["launches"][n] for r in (a, b, c, d))
             for n in _build.SOURCES}
    return {"launches": total, "launches_gradcache": e["launches"],
            "launches_interop": f["launches"],
            "launches_quant": g["launches"], "best_dir": kept,
            "packed_dir": os.path.join(keep_dir, "packed"),
            "held_out": held_out}


# ---------------------------------------------------------------------------
# Phase 9: evaluation
# ---------------------------------------------------------------------------

def compare_probs(card, ref) -> dict:
    """The card's [N, K] probabilities (or similarities) against the CPU's:
    the largest absolute difference, and whether the argmax agrees in
    every row whose reference top two differ by more than EVAL_TIE."""
    import numpy as np
    card, ref = np.asarray(card), np.asarray(ref)
    top = np.sort(ref, axis=-1)
    clear = top[:, -1] - top[:, -2] > EVAL_TIE
    agree = card.argmax(-1) == ref.argmax(-1)
    return {"rows": int(len(ref)), "max_abs_err": float(np.abs(card - ref)
                                                         .max()),
            "clear_rows": int(clear.sum()),
            "argmax_agree_clear": bool(agree[clear].all()),
            "argmax_agree_all": int(agree.sum())}


def eval_path(results: dict, best_dir: str, held_out: dict) -> dict:
    """The evaluation CLI at ViT-B/16 full width, fp32, on the card, from
    the ``best/`` that phase 8's run A wrote: ``countbench`` and
    ``vlmsblind`` on their procedural fixtures, ``crop`` on the procedural
    source at the protocol's sample count; then ``evaluate_batch`` on run
    C's held-out batch. Each is counted on its own: 24 forward-kernel
    launches a scorer call, 36 an ``evaluate_batch``, nothing else. Then
    the time of one scorer call (B=32 x NT=10) and #1 in fp32 at
    evaluation's shapes. The first scorer call of each subcommand and the
    held-out batch are held to the port in fp32 on the CPU with the same
    weights by the returned ``vs_cpu``, which main() runs beside phase
    10's one-rank NCCL step, after the card's timings."""
    import numpy as np
    import torch
    from clip_finegrained_alignment_tpu_torch.cli import evaluate as cli_eval
    from clip_finegrained_alignment_tpu_torch.cli import export_checkpoint
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.eval import (batch_eval,
                                                           countbench,
                                                           crop_detection,
                                                           scoring, vlmsblind)
    from clip_finegrained_alignment_tpu_torch.models import clip as m
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

    cfg = CLIPConfig.vit_b16()
    layers = cfg.vision.num_layers + cfg.text.num_layers
    out = {"gpu": gpu_line(), "checkpoint": "phase 8 run A best/"}
    work = tempfile.mkdtemp(prefix="cfa_eval_")
    prev_env = os.environ.get("CFA_ALLOW_HASH_TOKENIZER")
    os.environ["CFA_ALLOW_HASH_TOKENIZER"] = "1"
    # Spies: each scorer call's shape and host time, the first call's
    # inputs and probabilities, the evaluator's own time.
    state = {"calls": [], "first": None, "eval_s": 0.0, "probs": []}
    score, spied = scoring.TemplateScorer.__call__, {}

    def spy_score(self, px, ids, mask):
        t0 = time.time()
        probs = score(self, px, ids, mask)
        state["calls"].append((len(px), ids.shape[1], time.time() - t0))
        state["probs"].append(np.array(probs, copy=True))
        if state["first"] is None:
            state["first"] = (px, ids, mask, probs)
        return probs

    def timed(fn):
        def run(*args, **kw):
            t0 = time.time()
            try:
                return fn(*args, **kw)
            finally:
                state["eval_s"] += time.time() - t0
        return run

    evaluators = ((countbench.CountBenchEvaluator, "evaluate_dataset"),
                  (vlmsblind.VLMsBlindEvaluator, "run_all_tasks"),
                  (crop_detection.CropDetectionEvaluator, "run_evaluation"))
    scoring.TemplateScorer.__call__ = spy_score
    for cls, name in evaluators:
        spied[cls, name] = getattr(cls, name)
        setattr(cls, name, timed(spied[cls, name]))
    runs, first, probs = {}, {}, {}
    try:
        subcommands = {
            "countbench": ["--dataset", "procedural"],
            "vlmsblind": ["--dataset", "procedural"],
            "crop": ["--samples", str(EVAL_CROP_SAMPLES), "--output",
                     os.path.join(work, "crop.json")]}
        for cmd, extra in subcommands.items():
            state.update(calls=[], first=None, eval_s=0.0, probs=[])
            argv = [cmd, "--model", "ViT-B/16", "--checkpoint", best_dir,
                    "--batch-size", str(EVAL_BATCH), "--output-dir",
                    os.path.join(work, cmd), "--device", "cuda", *extra]
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.time()
            metrics = cli_eval.main(argv)
            torch.cuda.synchronize()
            run = {"run_s": time.time() - t0, "eval_s": state["eval_s"],
                   "launches": _build.launch_counts(),
                   "scorer_calls": len(state["calls"]),
                   "scorer_host_s": sum(c[2] for c in state["calls"]),
                   "scorer_shapes": sorted({c[:2] for c in state["calls"]})}
            first[cmd] = state["first"]
            if cmd == "countbench":
                with open(os.path.join(work, cmd,
                                       "countbench_metrics.json")) as f:
                    check(json.load(f) == json.loads(json.dumps(metrics)),
                          "eval countbench: metrics file differs")
                samples = metrics["total_samples"]
                calls = -(-samples // EVAL_BATCH)
                values = [metrics["accuracy"], metrics["argmax_accuracy"],
                          metrics["avg_confidence"],
                          metrics["high_confidence_accuracy"],
                          *metrics["per_number_accuracy"].values()]
            elif cmd == "vlmsblind":
                with open(os.path.join(work, cmd,
                                       "vlmsblind_metrics.json")) as f:
                    check(json.load(f) == metrics,
                          "eval vlmsblind: metrics file differs")
                per = [t["total_samples"] for t in metrics.values()]
                samples = sum(per)
                calls = sum(-(-n // EVAL_BATCH) for n in per)
                values = [t[k] for t in metrics.values()
                          for k in ("accuracy", "avg_confidence")
                          + (("high_confidence_accuracy",)
                             if t["total_samples"] else ())]
            else:
                with open(os.path.join(work, "crop.json")) as f:
                    check(json.load(f)["aggregate_stats"] == metrics,
                          "eval crop: results file differs")
                samples = EVAL_CROP_SAMPLES
                calls = -(-samples // max(1, EVAL_BATCH // 6))
                values = [st[k] for st in metrics.values()
                          for k in ("accuracy", "avg_positive",
                                    "avg_negative")]
            run.update(samples=samples, samples_per_s=samples / run["eval_s"],
                       expected_calls=calls, metrics=metrics)
            check(samples > 0 and all(math.isfinite(v) and 0.0 <= v <= 1.0
                                      for v in values),
                  f"eval {cmd}: metrics {metrics}")
            want = {n: 0 for n in _build.SOURCES}
            want["attention_fwd"] = calls * layers
            check(run["scorer_calls"] == calls and run["launches"] == want,
                  f"eval {cmd}: {run['scorer_calls']} scorer calls, "
                  f"launches {run['launches']}; expected {calls} calls, "
                  f"{want}")
            log(f"eval {cmd}: launches {run['launches']}, "
                f"{run['scorer_calls']} scorer calls")
            runs[cmd] = run
            probs[cmd] = state["probs"]

        # best/ exported with OpenAI clip-package names
        # (cli/export_checkpoint.py --format openai) and evaluated again:
        # the same probabilities, bit for bit.
        pt = os.path.join(work, "best_openai.pt")
        export_checkpoint.main(["--checkpoint", best_dir, "--model",
                                "ViT-B/16", "--output", pt, "--format",
                                "openai"])
        state.update(calls=[], first=None, eval_s=0.0, probs=[])
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        metrics = cli_eval.main([
            "countbench", "--model", "ViT-B/16", "--checkpoint", pt,
            "--batch-size", str(EVAL_BATCH), "--output-dir",
            os.path.join(work, "countbench_openai"), "--device", "cuda",
            *subcommands["countbench"]])
        torch.cuda.synchronize()
        openai = {"launches": _build.launch_counts(),
                  "scorer_calls": len(state["calls"]),
                  "probs_equal": len(state["probs"]) == len(
                      probs["countbench"]) and all(
                      np.array_equal(x, y) for x, y in
                      zip(state["probs"], probs["countbench"])),
                  "accuracy": metrics["accuracy"],
                  "accuracy_best_dir": runs["countbench"]["metrics"][
                      "accuracy"]}
        log("eval countbench from the OpenAI-named export:",
            json.dumps(openai))
        check(openai["probs_equal"] and openai["launches"]
              == runs["countbench"]["launches"],
              f"eval countbench from the OpenAI-named export: {openai}")
    finally:
        scoring.TemplateScorer.__call__ = score
        for (cls, name), fn in spied.items():
            setattr(cls, name, fn)
        if prev_env is None:
            os.environ.pop("CFA_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["CFA_ALLOW_HASH_TOKENIZER"] = prev_env
        shutil.rmtree(work, ignore_errors=True)
    out["runs"] = runs
    out["openai_export"] = openai

    # The held-out batch of run C's live pipeline, as --eval-every-epoch
    # evaluates it (without its plot).
    sd = torch.load(os.path.join(best_dir, "state.pt"), map_location="cpu",
                    weights_only=True)["model"]
    card = m.build_model(cfg, sd, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    acc, confusion, res = batch_eval.evaluate_batch(card, cfg, held_out)
    torch.cuda.synchronize()
    held = {"B": int(len(held_out["count"])), "run_s": time.time() - t0,
            "accuracy": acc, "launches": _build.launch_counts()}
    want = {n: 0 for n in _build.SOURCES}
    want["attention_fwd"] = layers + cfg.text.num_layers
    check(held["launches"] == want,
          f"eval held-out batch: launches {held['launches']} != {want}")
    check(0.0 <= acc <= 1.0 and bool(np.isfinite(confusion).all()),
          f"eval held-out batch: accuracy {acc}")
    out["held_out"] = held
    eval_launches = {n: held["launches"][n] + sum(r["launches"][n]
                                                  for r in runs.values())
                     for n in _build.SOURCES}

    def vs_cpu_check():
        """The card against the port in fp32 on the CPU, same weights (run
        by main() beside phase 10's one-rank NCCL step)."""
        t0 = time.time()
        cpu = scoring.TemplateScorer(sd, cfg, device="cpu")
        vs_cpu = {}
        for cmd, (px, ids, mask, probs) in first.items():
            vs_cpu[cmd] = compare_probs(probs, cpu(px, ids, mask))
            vs_cpu[cmd]["shape"] = [len(px), ids.shape[1]]
        _, cpu_conf, cpu_res = batch_eval.evaluate_batch(cpu.model, cfg,
                                                         held_out)
        vs_cpu["held_out_similarities"] = compare_probs(
            np.stack([r["similarities"] for r in res]),
            np.stack([r["similarities"] for r in cpu_res]))
        vs_cpu["held_out_confusion_max_abs_err"] = float(
            np.abs(confusion - cpu_conf).max())
        vs_cpu["cpu_s"] = time.time() - t0
        out["vs_cpu"] = vs_cpu
        log("eval vs CPU fp32:", json.dumps(vs_cpu))
        for name, r in vs_cpu.items():
            if isinstance(r, dict):
                check(r["max_abs_err"] <= EVAL_MAX_ABS
                      and r["argmax_agree_clear"],
                      f"eval {name}: the card against the CPU {r}")
        check(vs_cpu["held_out_confusion_max_abs_err"] <= EVAL_MAX_ABS,
              f"eval held-out confusion: {vs_cpu}")

    # One scorer call at countbench's first shape, B=32 x NT=10, on the
    # device; and #1 in fp32 at evaluation's two shapes.
    scorer = scoring.TemplateScorer(card, cfg)
    px, ids, mask, _ = first["countbench"]
    args = [scoring.to_device(x, scorer.device) for x in (px, ids, mask)]
    out["scorer_call"] = {
        "shape": [len(px), ids.shape[1]],
        "ms": cuda_time_ms(lambda: scorer.score(*args), reps=3, warmup=1,
                           windows=3),
        "profile": kernel_table(lambda: scorer.score(*args))}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for what, B, S, H, causal in EVAL_ATTENTION_SHAPES:
        D = 64
        q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=gen)
                   for _ in range(3))
        bias = (torch.full((S, S), -1e9, device="cuda").triu(1)[None, None]
                if causal else None)
        scale = D ** -0.5
        err = (ta.flash_attention(q, k, v, bias, scale)
               - ta.attention_reference(q, k, v, bias, scale)).abs().max()
        row = {"shape": what, "B": B, "S": S, "H": H, "Dh": D,
               "dtype": "float32", "max_abs_err": err.item(),
               "tol": KERNEL_TOL["float32"],
               "launches_eval": eval_launches["attention_fwd"]}
        check(row["max_abs_err"] <= KERNEL_TOL["float32"],
              f"attention fp32 {what}: max abs err {row['max_abs_err']}")
        row.update(attention_fwd_times(q, k, v, bias, scale))
        row.update(fused_attention_bound_ms(B, S, H, D, "float32", causal))
        log("attention fp32 eval", json.dumps(row))
        rows.append(row)
    out["attention_fp32"] = rows
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("eval:", json.dumps({k: v for k, v in out.items()
                             if k not in ("runs",)}))
    log("eval runs:", json.dumps({c: {k: v for k, v in r.items()
                                      if k != "metrics"}
                                  for c, r in runs.items()}))
    results["eval"] = out
    return {"launches": eval_launches, "attention_fp32": rows,
            "launches_openai": openai["launches"], "vs_cpu": vs_cpu_check}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 10: data parallelism (two gloo ranks on one card, one NCCL rank)
# ---------------------------------------------------------------------------

def dp_env() -> dict:
    """Every rank on the one card: NCCL refuses two ranks on one GPU, so
    the two-rank runs take gloo (chosen here, explicitly)."""
    return {"CUDA_VISIBLE_DEVICES": "0", "LOCAL_RANK": "0",
            "CFA_ALLOW_HASH_TOKENIZER": "1"}


def expected_dp_launches(steps: int, layers: int) -> dict:
    """#1 and #2 on every encoder layer of every microbatch, #3 and #4 on
    every microbatch, at B/W rows; nothing else."""
    from clip_finegrained_alignment_tpu_torch.ops import _build
    want = {n: 0 for n in _build.SOURCES}
    want.update({"attention_fwd": steps * DP_ACCUM * layers,
                 "attention_bwd": steps * DP_ACCUM * layers,
                 "sparc_fwd": steps * DP_ACCUM,
                 "sparc_bwd": steps * DP_ACCUM})
    return want


def dp_probs_spy(store: list):
    """Wrap ``TemplateScorer.__call__`` to keep every call's
    probabilities (numpy) in ``store``; returns the original."""
    from clip_finegrained_alignment_tpu_torch.eval import scoring
    call = scoring.TemplateScorer.__call__

    def spy(self, *a):
        probs = call(self, *a)
        store.append(probs)
        return probs
    scoring.TemplateScorer.__call__ = spy
    return call


def dp_rank(packed_dir: str, work: str, oracle_path: str) -> dict:
    """One of the two gloo ranks on the card (spawned; the group is up):
    the collectives probe, the four modes against their oracles
    (``perf/data_parallel_check.py``; rank 0 writes its global-negatives
    oracle to ``oracle_path``, phase 11's), run H of ``cli/train.py`` and
    ``cli/evaluate.py countbench --data-parallel 2`` on its ``best/``."""
    import torch
    import torch.distributed as dist
    from clip_finegrained_alignment_tpu_torch.cli import evaluate as cli_eval
    from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
    from clip_finegrained_alignment_tpu_torch.eval import scoring
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.perf import \
        data_parallel_check as dpc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"rank": dist.get_rank(),
           "probe": dpc.probe_collectives(dev)}
    t0 = time.time()
    out["modes"] = dpc.rank_modes("ViT-B/16", DP_LAYERS, "bfloat16", DP_B,
                                  DP_ACCUM, SEED, DP_STEPS, list(dpc.MODES),
                                  save_global=oracle_path)
    out["modes_s"] = time.time() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    t0 = time.time()
    res = cli_train.main(dp_run_h_args(packed_dir, work, epochs=1)
                         + ["--global-negatives", "--zero1"])
    torch.cuda.synchronize(dev)
    out["H"] = {"launches": _build.launch_counts(),
                "steps": res["trainer"].global_step,
                "epoch_losses": [h["avg_loss"] for h in res["history"]],
                "epoch_s": [h["seconds"] for h in res["history"]],
                "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "run_s": time.time() - t0}
    del res
    torch.cuda.empty_cache()

    probs = []
    call = dp_probs_spy(probs)
    try:
        _build.reset_launch_counts()
        metrics = cli_eval.main(dp_eval_args(work, "eval_dp2")
                                + ["--data-parallel", str(DP_RANKS)])
        torch.cuda.synchronize(dev)
    finally:
        scoring.TemplateScorer.__call__ = call
    out["eval"] = {"metrics": metrics, "launches": _build.launch_counts(),
                   "probs": probs}
    return out


def dp_run_h_args(packed_dir: str, work: str, epochs: int) -> list:
    return ["--model", "ViT-B/16", "--loss-type", "sparc", "--optimizer",
            "adamspd", "--batch-size", str(DP_RANKS * DP_B), "--grad-accum",
            str(DP_ACCUM), "--inverse-temperature", "0.07", "--save-every",
            "1", "--packed", packed_dir, "--device-data", "--checkpoint-dir",
            os.path.join(work, "ckpt"), "--experiment-name", "dp",
            "--seed", str(SEED), "--log-every", "1", "--epochs", str(epochs)]


def dp_eval_args(work: str, name: str) -> list:
    return ["countbench", "--model", "ViT-B/16", "--checkpoint",
            os.path.join(work, "ckpt", "dp", "best"), "--dataset",
            "procedural", "--batch-size", str(EVAL_BATCH), "--output-dir",
            os.path.join(work, name), "--device", "cuda"]


def one_rank_split_path() -> list:
    """On a one-rank group (the group is up): ``quant_linear`` in int8 with
    every dimension split over the group (the split passes, the absmax
    MAX and the int32 SUM as all-reduces) against the same call with no
    group (the fused passes), at vision fc1's and fc2's shapes in bf16:
    output and the three gradients bit-equal, and each side's launches."""
    import torch
    import torch.distributed as dist
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.ops import quant as tq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    world = dist.group.WORLD
    rows = []
    for what, m, k, n in (("vision fc1", TRAIN_B * 197, 768, 3072),
                          ("vision fc2", TRAIN_B * 197, 3072, 768)):
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
        b = torch.randn(n, device="cuda", generator=gen)
        g = torch.randn(m, n, device="cuda", generator=gen).to(torch.bfloat16)
        sides = []
        for groups in (tq.LOCAL, tq.Groups(k=world, n=world, m=world)):
            xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            tq.quant_linear(xl, wl, bl, torch.bfloat16, "int8",
                            groups).backward(g)
            torch.cuda.synchronize()
            sides.append(((xl.grad, wl.grad, bl.grad), _build.launch_counts()))
            y = tq.quant_linear(x, w, b, torch.bfloat16, "int8", groups)
            sides[-1] = ((y,) + sides[-1][0], sides[-1][1])
        (fused, fused_n), (split, split_n) = sides
        names = ("quant_rows", "quant_cols_t", "dequant") + tq.SPLIT_KERNELS
        rows.append({"case": what, "M": m, "K": k, "N": n,
                     "equal": all(torch.equal(a, c)
                                  for a, c in zip(fused, split)),
                     "fused_launches": {n_: fused_n[n_] for n_ in names},
                     "split_launches": {n_: split_n[n_] for n_ in names}})
    return rows


def dp_nccl_rank() -> dict:
    """The one-rank NCCL group (spawned): a global-negatives ZeRO-1 step
    with the mesh against the same step with none, bit for bit; then the
    int8 split path over the group against the fused path
    (:func:`one_rank_split_path`)."""
    from clip_finegrained_alignment_tpu_torch.perf import \
        data_parallel_check as dpc
    out = dpc.one_rank_identity("ViT-B/16", None, "bfloat16",
                                DP_RANKS * DP_B, DP_ACCUM, SEED)
    out["split_path"] = one_rank_split_path()
    return out


def nccl_one_rank_path() -> dict:
    """Phase 10's one-rank NCCL group (its own process): a
    global-negatives ZeRO-1 step with the mesh bit-equal to the same step
    with none."""
    from clip_finegrained_alignment_tpu_torch.parallel.launch import spawn
    t0 = time.time()
    one = spawn(dp_nccl_rank, 1, timeout_s=300, device="cuda",
                backend="nccl", env=dp_env())[0]
    one["s"] = time.time() - t0
    log("data parallel, one NCCL rank vs no mesh:", json.dumps(one))
    check(one["backend"] == "nccl" and one["metrics_equal"]
          and one["grads_equal"] and one["params_equal"],
          f"one-rank NCCL step differs from mesh=None: {one}")
    # One int8 linear forward and backward, fused, then split: three
    # products, each reducing two operands.
    fused = {"quant_rows": 3, "quant_cols_t": 3, "dequant": 3,
             "absmax_rows": 0, "absmax_cols": 0, "quant_rows_given": 0,
             "quant_cols_t_given": 0}
    split = {"quant_rows": 0, "quant_cols_t": 0, "dequant": 3,
             "absmax_rows": 3, "absmax_cols": 3, "quant_rows_given": 3,
             "quant_cols_t_given": 3}
    for row in one["split_path"]:
        check(row["equal"] and row["fused_launches"] == fused
              and row["split_launches"] == split,
              f"int8 split path over one NCCL rank: {row}")
    return one


def data_parallel_path(results: dict, packed_dir: str, oracle_path: str,
                       one: dict, background) -> dict:
    """Phase 10 (module docstring): every rank a process on the one card
    (``one``: :func:`nccl_one_rank_path`'s result). Its rank 0 writes its
    global-negatives oracle to ``oracle_path``: phase 11's, the same global
    batch and weights. ``background()`` runs in this process beside the
    ranks (:func:`beside`)."""
    import numpy as np
    import torch
    from clip_finegrained_alignment_tpu_torch.cli import evaluate as cli_eval
    from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.eval import scoring
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.parallel.launch import spawn
    from clip_finegrained_alignment_tpu_torch.train import engine
    from clip_finegrained_alignment_tpu_torch.train.checkpoint import \
        CheckpointManager

    cfg = CLIPConfig.vit_b16()
    layers = cfg.vision.num_layers + cfg.text.num_layers
    out = {"gpu": gpu_line(), "ranks": DP_RANKS, "rows_a_rank": DP_B,
           "accum": DP_ACCUM, "limits": DP_LIMITS,
           "note": "two ranks sharing one card over gloo (collectives staged "
                   "through the host), not a scaling figure",
           "nccl_one_rank": one}
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="cfa_dp_")
    prev_env = os.environ.get("CFA_ALLOW_HASH_TOKENIZER")
    os.environ["CFA_ALLOW_HASH_TOKENIZER"] = "1"
    load_state_dict = engine.Trainer.load_state_dict
    try:
        t0 = time.time()
        ranks = beside(background, lambda: spawn(
            dp_rank, DP_RANKS, (packed_dir, work, oracle_path),
            timeout_s=900, device="cuda", backend="gloo", env=dp_env()))
        out["gloo_spawn_s"] = time.time() - t0
        out["modes_s_per_rank"] = [r["modes_s"] for r in ranks]
        r0, r1 = ranks
        out["probe"] = r0["probe"]
        log("data parallel, gloo on CUDA tensors:", json.dumps(r0["probe"]))
        for r in ranks:
            bad = {k: v for k, v in r["probe"]["used"].items() if v != "ok"}
            check(not bad, f"gloo on the card: rank {r['rank']} {bad}")

        max_loss, max_norm, min_cos, min_upd = (
            DP_LIMITS[k] for k in ("loss_rel", "grad_norm_rel",
                                   "min_grad_cosine", "min_update_cosine"))
        want = expected_dp_launches(1, 2 * DP_LAYERS)
        out["modes"] = {}
        for mode, res in r0["modes"].items():
            vs = res["vs_oracle"]
            row = {"vs_oracle": vs,
                   "vs_replicated": res.get("vs_replicated"),
                   "launches_per_rank": [r["modes"][mode]["launches"]
                                         for r in ranks],
                   "step_ms_per_rank": [r["modes"][mode]["step_ms"]
                                        for r in ranks],
                   "peak_memory_gb_per_rank": [
                       r["modes"][mode]["peak_memory_gb"] for r in ranks]}
            out["modes"][mode] = row
            log(f"data parallel {mode}:", json.dumps(row))
            check(r1["modes"][mode]["metrics"] == res["metrics"],
                  f"data parallel {mode}: the ranks' metrics differ")
            check(vs["loss_rel"] <= max_loss
                  and vs["grad_norm_rel"] <= max_norm
                  and vs["min_grad_cosine"] >= min_cos
                  and vs["min_update_cosine"] >= min_upd
                  and vs["k_proj_bias_grad_share_of_norm"]
                  <= TRAIN_MAX_ZERO_GRAD_SHARE,
                  f"data parallel {mode} vs its oracle out of limits: {vs}")
            if mode in ("zero1", "fsdp"):
                rep = res["vs_replicated"]
                check(rep["max_first_update_rel"]
                      <= DP_SHARD_MAX_FIRST_UPDATE_REL,
                      f"data parallel {mode} vs replicated: the first "
                      f"update parts by {rep['max_first_update_rel']} "
                      f"({rep['max_first_update_rel_tensor']})")
            for r in ranks:
                check(r["modes"][mode]["launches"] == want,
                      f"data parallel {mode}: rank {r['rank']} launches "
                      f"{r['modes'][mode]['launches']} != {want}")
        out["launch_derivation"] = (
            f"a rank's step: {2 * DP_LAYERS} encoder layers ({DP_LAYERS} "
            f"vision + {DP_LAYERS} text) x "
            f"accum {DP_ACCUM} of #1 and of #2, accum {DP_ACCUM} of #3 and "
            f"of #4, each at B/W = {DP_B} rows: {want}")
        log("data parallel launches:", out["launch_derivation"])

        # countbench --data-parallel 2 against one process, on run H's
        # best/ (before the resume below writes another).
        probs = []
        call = dp_probs_spy(probs)
        try:
            _build.reset_launch_counts()
            one_metrics = cli_eval.main(dp_eval_args(work, "eval_dp1"))
            torch.cuda.synchronize()
        finally:
            scoring.TemplateScorer.__call__ = call
        one_launches = _build.launch_counts()
        calls = len(probs)
        ev = {"calls": calls, "metrics_dp1": one_metrics,
              "launches_dp1": one_launches,
              "launches_dp2_per_rank": [r["eval"]["launches"] for r in ranks]}
        err = 0.0
        for r in ranks:
            check(len(r["eval"]["probs"]) == calls and all(
                a.shape == b.shape for a, b in zip(r["eval"]["probs"],
                                                   probs)),
                  f"eval --data-parallel 2: rank {r['rank']} calls differ")
            err = max([err] + [float(np.abs(a - b).max())
                               for a, b in zip(r["eval"]["probs"], probs)])
            want_eval = {n: 0 for n in _build.SOURCES}
            want_eval["attention_fwd"] = calls * layers
            check(r["eval"]["launches"] == want_eval,
                  f"eval --data-parallel 2: rank {r['rank']} launches "
                  f"{r['eval']['launches']} != {want_eval}")
        ev["max_abs_err"] = err
        ev["limit"] = EVAL_MAX_ABS
        out["eval"] = ev
        log("eval countbench --data-parallel 2 vs 1:", json.dumps(ev))
        check(err <= EVAL_MAX_ABS, f"eval --data-parallel 2 vs 1: {err}")
        # Run H: two ranks, global negatives, ZeRO-1, one epoch.
        spe = CLI_SAMPLES // (DP_RANKS * DP_B * DP_ACCUM)
        h = {"ranks": [r["H"] for r in ranks]}
        for r in ranks:
            check(r["H"]["steps"] == spe
                  and all(map(math.isfinite, r["H"]["epoch_losses"])),
                  f"train cli H: rank {r['rank']} {r['H']}")
            check(r["H"]["launches"] == expected_dp_launches(spe, layers),
                  f"train cli H: rank {r['rank']} launches "
                  f"{r['H']['launches']}")
        check(r0["H"]["epoch_losses"] == r1["H"]["epoch_losses"],
              "train cli H: the ranks' epoch losses differ")
        # ... resumed by one process to a second epoch: the restored
        # weights and optimizer state are best/'s bit for bit.
        best = os.path.join(work, "ckpt", "dp", "best")
        want_state = torch.load(os.path.join(best, "state.pt"),
                                map_location="cpu", weights_only=True)
        restored = {}

        def spy_load(self, state):
            load_state_dict(self, state)
            restored["state"] = cpu_copy(self.state_dict())
        engine.Trainer.load_state_dict = spy_load
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.time()
        res = cli_train.main(dp_run_h_args(packed_dir, work, epochs=2)
                             + ["--global-negatives", "--zero1", "--resume"])
        torch.cuda.synchronize()
        engine.Trainer.load_state_dict = load_state_dict
        h["resume_w1"] = {
            "launches": _build.launch_counts(),
            "steps": res["trainer"].global_step,
            "epoch_losses": [x["avg_loss"] for x in res["history"]],
            "run_s": time.time() - t0,
            "peak_memory_gb": res["peak_memory_bytes"] / 1e9,
            "state_equal_to_best": same_state(restored.get("state"),
                                              want_state)}
        del res, want_state, restored
        torch.cuda.empty_cache()
        out["H"] = h
        log("train cli H (2 gloo ranks, --global-negatives --zero1), then "
            "--resume at W = 1:", json.dumps(h))
        check(h["resume_w1"]["state_equal_to_best"],
              "train cli H: the W = 1 resume did not restore best/ exactly")
        check(h["resume_w1"]["steps"] == 2 * spe
              and all(map(math.isfinite, h["resume_w1"]["epoch_losses"])),
              f"train cli H resume: {h['resume_w1']}")
        check(h["resume_w1"]["launches"] == expected_dp_launches(
            spe, layers), f"train cli H resume: launches "
            f"{h['resume_w1']['launches']}")

    finally:
        engine.Trainer.load_state_dict = load_state_dict
        if prev_env is None:
            os.environ.pop("CFA_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["CFA_ALLOW_HASH_TOKENIZER"] = prev_env
        shutil.rmtree(work, ignore_errors=True)
    log("data parallel:", json.dumps(
        {"gpu": out["gpu"], "note": out["note"],
         "step_ms_per_rank": {m: r["step_ms_per_rank"]
                              for m, r in out["modes"].items()},
         "peak_memory_gb_per_rank": {m: r["peak_memory_gb_per_rank"]
                                     for m, r in out["modes"].items()}}))
    results["data_parallel"] = out
    launches = {n: sum(r["modes"][m]["launches"][n] for r in ranks
                       for m in r["modes"])
                + sum(r["H"]["launches"][n] + r["eval"]["launches"][n]
                      for r in ranks)
                + h["resume_w1"]["launches"][n] + one_launches[n]
                for n in _build.SOURCES}
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 11: tensor, pipeline and sequence parallelism (gloo ranks on one card)
# ---------------------------------------------------------------------------

def expected_mp_launches(mode: str, steps: int, layers: int) -> dict:
    """A rank's launches in ``steps`` steps of a mode: #1 and #2 once a
    layer this rank holds, a GPipe microbatch and a train microbatch
    (tensor parallelism runs every layer at H/tp heads, a pipeline stage
    its L/K layers on each of MP_MICRO microbatches; sequence parallelism
    none, its attention is PyTorch on this rank's queries against other
    ranks' keys, which #1 and #2 do not take); #3 and #4 once a train
    microbatch on every rank (the loss is whole on every rank); the int8
    modes' kernels by :func:`expected_split_launches`."""
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.perf import \
        model_parallel_check as mpc
    mesh, extra = mpc.mode_spec(mode)
    pipe = mesh["pipe"]
    sp = extra.get("sequence_parallel", False)
    per_micro = 0 if sp else layers // pipe * (MP_MICRO if pipe > 1 else 1)
    want = {n: 0 for n in _build.SOURCES}
    want.update({"attention_fwd": steps * MP_ACCUM * per_micro,
                 "attention_bwd": steps * MP_ACCUM * per_micro,
                 "sparc_fwd": steps * MP_ACCUM,
                 "sparc_bwd": steps * MP_ACCUM})
    if extra.get("quant") == "int8":
        want.update(expected_split_launches(
            layers, steps * MP_ACCUM, tp=mesh["model"] > 1 and not sp,
            rows=mesh["data"] > 1 or sp))
    return want


# Phase 11's runs of cli/train.py: (experiment, the mode whose launches a
# step they make, flags, resumed by one process); I on the four ranks, J
# and K on the two.
MP_RUNS = {"I": ("mp", "tp2pp2", ["--model-parallel", "2",
                                  "--pipeline-parallel", "2",
                                  "--pipeline-microbatches", str(MP_MICRO)],
                 True),
           "J": ("sp", "sp2-ring", ["--sequence-parallel", "2",
                                    "--sp-ring"], True),
           "K": ("tp_int8", "tp2-int8", ["--model-parallel", "2",
                                         "--quant", "int8"], False)}


def mp_run_args(packed_dir: str, work: str, name: str, epochs: int) -> list:
    return ["--model", "ViT-B/16", "--loss-type", "sparc", "--optimizer",
            "adamspd", "--batch-size", str(MP_B), "--grad-accum",
            str(MP_ACCUM), "--inverse-temperature", "0.07", "--save-every",
            "1", "--packed", packed_dir, "--device-data", "--checkpoint-dir",
            os.path.join(work, "ckpt"), "--experiment-name", name,
            "--seed", str(SEED), "--log-every", "1", "--epochs", str(epochs),
            "--global-negatives"]


def mp_oracle_path(oracle_dir: str, quant: str = "none",
                   dtype: str = "bfloat16", layers=None) -> str:
    """Where phase 11's one-process oracle for ``quant`` in ``dtype`` at
    ``layers`` a tower lies (``perf/model_parallel_check.py::prepare``'s
    format)."""
    return os.path.join(oracle_dir, f"oracle_{quant}_{dtype}_{layers}.pt")


@contextlib.contextmanager
def sp_attention():
    """``models/clip.py``'s attention taken by the sequence-parallel
    modes' own (``parallel/sequence.py::xla_attention``), over the whole
    sequence in one process."""
    from clip_finegrained_alignment_tpu_torch.models import clip
    from clip_finegrained_alignment_tpu_torch.parallel.sequence import \
        xla_attention
    kept = clip.flash_attention
    clip.flash_attention = xla_attention
    try:
        yield
    finally:
        clip.flash_attention = kept


def mp_int8_oracles(oracle_dir: str) -> dict:
    """Phase 11's one-process int8 oracles (global negatives,
    ``quant="int8"``, the weights, anchors and global batch of the bf16
    one), one for each dtype and depth ``MP_SPAWNS`` runs an int8 mode at,
    with the group's attention (the kernels, or :func:`sp_attention`),
    written into ``oracle_dir``, with their launches: the fused passes
    alone. Run beside phase 10's gloo ranks, while this process launches
    nothing else, so that the counts are the oracle's."""
    import torch
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.perf import \
        model_parallel_check as mpc

    cfg = CLIPConfig.vit_b16()
    out = {}
    for _, groups, _ in MP_SPAWNS:
        for dtype, layers, attention, modes in groups:
            label = mp_label("int8", dtype, layers)
            if label in out or not any(m.endswith("-int8") for m in modes):
                continue
            want = expected_split_launches(
                2 * layers if layers else cfg.vision.num_layers
                + cfg.text.num_layers, MP_STEPS * MP_ACCUM)
            t0 = time.time()
            _build.reset_launch_counts()
            with (sp_attention() if attention == "sp"
                  else contextlib.nullcontext()):
                mpc.prepare("ViT-B/16", layers, dtype, MP_B, MP_ACCUM, SEED,
                            MP_STEPS, torch.device("cuda", 0),
                            mp_oracle_path(oracle_dir, "int8", dtype,
                                           layers), quant="int8")
            torch.cuda.synchronize()
            got = _build.launch_counts()
            out[label] = {
                "s": time.time() - t0, "attention": attention,
                "expected": want,
                "launches": {n: got[n] for n in want}}
            torch.cuda.empty_cache()
    return out


def mp_rank(groups, runs, packed_dir, work, oracle_dir) -> dict:
    """One gloo rank on the card (spawned; the group is up): the modes of
    each ``(dtype, layers, _, modes)`` of ``groups`` against their oracles
    (``perf/model_parallel_check.py``, the weights, anchors and oracles
    read from ``oracle_dir``, :func:`mp_oracle_path`), then each of
    ``runs`` of ``cli/train.py`` (``MP_RUNS``)."""
    import torch
    import torch.distributed as dist
    from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.perf import \
        model_parallel_check as mpc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"rank": dist.get_rank()}
    t0 = time.time()
    out["modes"] = {}
    for dtype, layers, _, modes in groups:
        paths = [mp_oracle_path(oracle_dir, q, dtype, layers)
                 for q in sorted({mpc.quant_of(m) for m in modes})]
        res = mpc.rank_modes("ViT-B/16", layers, dtype, MP_B, MP_ACCUM, SEED,
                             MP_STEPS, list(modes), prepared=paths)
        out["modes"].update({mp_label(m, dtype, layers): r
                             for m, r in res.items()})
    out["modes_s"] = time.time() - t0
    for run in runs:
        name, _, flags, _ = MP_RUNS[run]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        t0 = time.time()
        res = cli_train.main(mp_run_args(packed_dir, work, name, 1) + flags)
        torch.cuda.synchronize(dev)
        out[run] = {"launches": _build.launch_counts(),
                    "steps": res["trainer"].global_step,
                    "epoch_losses": [h["avg_loss"] for h in res["history"]],
                    "epoch_s": [h["seconds"] for h in res["history"]],
                    "peak_memory_gb": torch.cuda.max_memory_allocated(dev)
                    / 1e9, "run_s": time.time() - t0}
        del res
    return out


def mp_run_check(run: str, ranks: list, packed_dir: str, work: str,
                 layers: int, launches: dict) -> dict:
    """Run I, J or K (``MP_RUNS``) as the ranks made it: every rank's
    steps, finite and equal epoch losses and exact launches; then, for I
    and J, a ``--resume`` of it by one process (its epoch done: no step),
    whose restored weights and optimizer state must be ``best/``'s bit for
    bit. Adds the launches to ``launches``."""
    import torch
    from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.train import engine

    name, mode, flags, resume_w1 = MP_RUNS[run]
    spe = CLI_SAMPLES // (MP_B * MP_ACCUM)
    want = expected_mp_launches(mode, spe, layers)
    row = {"flags": flags, "ranks": [r[run] for r in ranks],
           "expected": want}
    for r in ranks:
        check(r[run]["steps"] == spe
              and all(map(math.isfinite, r[run]["epoch_losses"])),
              f"train cli {run}: rank {r['rank']} {r[run]}")
        check(r[run]["launches"] == want,
              f"train cli {run}: rank {r['rank']} launches "
              f"{r[run]['launches']} != {want}")
        check(r[run]["epoch_losses"] == ranks[0][run]["epoch_losses"],
              f"train cli {run}: the ranks' epoch losses differ")
        for n in launches:
            launches[n] += r[run]["launches"][n]
    if not resume_w1:
        log(f"train cli {run} ({len(ranks)} gloo ranks, {' '.join(flags)}):",
            json.dumps(row))
        return row
    best = os.path.join(work, "ckpt", name, "best")
    want_state = torch.load(os.path.join(best, "state.pt"),
                            map_location="cpu", weights_only=True)
    restored = {}
    load_state_dict = engine.Trainer.load_state_dict

    def spy_load(self, state):
        load_state_dict(self, state)
        restored["state"] = cpu_copy(self.state_dict())
    engine.Trainer.load_state_dict = spy_load
    try:
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.time()
        res = cli_train.main(mp_run_args(packed_dir, work, name, 1)
                             + ["--resume"])
        torch.cuda.synchronize()
    finally:
        engine.Trainer.load_state_dict = load_state_dict
    resume = {"launches": _build.launch_counts(),
              "steps": res["trainer"].global_step,
              "epoch_losses": [x["avg_loss"] for x in res["history"]],
              "run_s": time.time() - t0,
              "state_equal_to_best": same_state(restored.get("state"),
                                                want_state)}
    del res, want_state, restored
    torch.cuda.empty_cache()
    row["resume_w1"] = resume
    log(f"train cli {run} ({len(ranks)} gloo ranks, {' '.join(flags)}), "
        "then --resume in one process:", json.dumps(row))
    check(resume["state_equal_to_best"],
          f"train cli {run}: the one-process resume did not restore best/ "
          "exactly")
    check(resume["steps"] == spe and not resume["epoch_losses"]
          and not any(resume["launches"].values()),
          f"train cli {run} resume: {resume}")
    for n in launches:
        launches[n] += resume["launches"][n]
    return row


def model_parallel_path(results: dict, packed_dir: str, oracle_dir: str,
                        int8_oracles: dict) -> dict:
    """Phase 11 (module docstring): every rank a process on the one card,
    over gloo; the one-process oracles lie in ``oracle_dir``
    (:func:`mp_oracle_path`): phase 10's global-negatives one (made here
    if it is not there) and the int8 ones of :func:`mp_int8_oracles`
    (``int8_oracles``: what it returned)."""
    import torch
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.ops import _build
    from clip_finegrained_alignment_tpu_torch.parallel.launch import spawn

    from clip_finegrained_alignment_tpu_torch.perf import \
        model_parallel_check as mpc

    cfg = CLIPConfig.vit_b16()
    layers = cfg.vision.num_layers + cfg.text.num_layers
    out = {"gpu": gpu_line(), "global_batch": MP_B, "accum": MP_ACCUM,
           "micro": MP_MICRO, "limits": MP_LIMITS, "sp_limits": SP_LIMITS,
           "int8_limits": INT8_LIMITS,
           # gloo's bytes a tp2 rank sums a step, by the shapes
           "tp2_sum_bytes": {q: mpc.tp_sum_bytes(cfg, MP_B, MP_ACCUM, q)
                             for q in ("none", "int8")},
           "note": "gloo ranks sharing one card (collectives staged through "
                   "the host), not a scaling figure"}
    work = tempfile.mkdtemp(prefix="cfa_mp_")
    prev_env = os.environ.get("CFA_ALLOW_HASH_TOKENIZER")
    os.environ["CFA_ALLOW_HASH_TOKENIZER"] = "1"
    launches = {n: 0 for n in _build.SOURCES}
    try:
        # The weights, anchors and one-process oracle, once for both
        # spawns (its launches are not the ranks').
        t0 = time.time()
        bf16 = mp_oracle_path(oracle_dir, layers=DP_LAYERS)
        if not os.path.exists(bf16):
            mpc.prepare("ViT-B/16", DP_LAYERS, "bfloat16", MP_B, MP_ACCUM,
                        SEED, MP_STEPS, torch.device("cuda", 0), bf16)
        out["oracle_s"] = time.time() - t0
        # The int8 modes' oracles: one process in int8, through the fused
        # passes alone.
        out["oracle_int8"] = int8_oracles
        log("model parallel int8 oracles (one process):",
            json.dumps(int8_oracles))
        for dtype, row in int8_oracles.items():
            check(row["launches"] == row["expected"],
                  f"the {dtype} int8 oracle's launches {row['launches']} != "
                  f"{row['expected']}")
        torch.cuda.empty_cache()
        out["modes"] = {}
        for world, groups, runs in MP_SPAWNS:
            torch.cuda.empty_cache()
            t0 = time.time()
            ranks = spawn(mp_rank, world,
                          (groups, runs, packed_dir, work, oracle_dir),
                          timeout_s=600, device="cuda", backend="gloo",
                          env=dp_env())
            out[f"spawn_{world}_s"] = time.time() - t0
            r0 = ranks[0]
            for dtype, depth, mode in ((d, n, m) for d, n, _, ms in groups
                                       for m in ms):
                label = mp_label(mode, dtype, depth)
                res = r0["modes"][label]
                vs = res["vs_oracle"]
                want = expected_mp_launches(mode, 1, 2 * depth if depth
                                            else layers)
                limits = phase_11_limits(mode, dtype)
                row = {"mesh": res["mesh"], "dtype": dtype, "vs_oracle": vs,
                       "launches_per_rank": [r["modes"][label]["launches"]
                                             for r in ranks],
                       "expected_launches": want,
                       "step_ms_per_rank": [r["modes"][label]["step_ms"]
                                            for r in ranks],
                       "peak_memory_gb_per_rank": [
                           r["modes"][label]["peak_memory_gb"]
                           for r in ranks],
                       "rank0_seconds": res["seconds"]}
                out["modes"][label] = row
                log(f"model parallel {label}:", json.dumps(row))
                for r in ranks:
                    check(r["modes"][label]["metrics"] == res["metrics"],
                          f"model parallel {label}: rank {r['rank']}'s "
                          "metrics differ from rank 0's")
                    check(r["modes"][label]["launches"] == want,
                          f"model parallel {label}: rank {r['rank']} "
                          f"launches {r['modes'][label]['launches']} != "
                          f"{want}")
                    for n in launches:
                        launches[n] += r["modes"][label]["launches"][n]
                held = {k: (vs[k] >= lim if k.startswith("min_")
                            else vs[k] <= lim)
                        for k, lim in limits.items()}
                check(all(held.values()),
                      f"model parallel {label} vs its oracle out of its "
                      f"limits: {held} {vs}")
                check(vs["k_proj_bias_grad_share_of_norm"]
                      <= TRAIN_MAX_ZERO_GRAD_SHARE,
                      f"model parallel {label}: k_proj bias share {vs}")
            # Runs J (sequence parallelism) and K (TP in int8) on two
            # ranks, or I (TP x PP) on four, of cli/train.py, one epoch of
            # phase 8's data, I and J resumed by one process.
            for run in runs:
                out[run] = mp_run_check(run, ranks, packed_dir, work, layers,
                                        launches)
    finally:
        if prev_env is None:
            os.environ.pop("CFA_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["CFA_ALLOW_HASH_TOKENIZER"] = prev_env
        shutil.rmtree(work, ignore_errors=True)
    log("model parallel:", json.dumps(
        {"gpu": out["gpu"], "note": out["note"],
         "tp2_sum_bytes": out["tp2_sum_bytes"],
         "step_ms_per_rank": {m: r["step_ms_per_rank"]
                              for m, r in out["modes"].items()},
         "peak_memory_gb_per_rank": {m: r["peak_memory_gb_per_rank"]
                                     for m, r in out["modes"].items()}}))
    results["model_parallel"] = out
    return {"launches": launches}


def beside(background, foreground):
    """``foreground()`` while ``background()`` runs in a thread; returns
    ``foreground``'s result once both are done, and raises what either
    raised."""
    failed = []

    def run():
        try:
            background()
        except BaseException as e:       # re-raised below
            failed.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    try:
        out = foreground()
    finally:
        thread.join()
    if failed:
        raise failed[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    from clip_finegrained_alignment_tpu_torch.ops import _build

    # A reference states and sets both: PyTorch's fp32 matmuls and
    # convolutions (the plain versions) run in full fp32, never TF32. The
    # hand-written SPARC kernels take their fp32 products as three TF32
    # products each (hi·hi + hi·lo + lo·hi), which holds SPARC_TOL.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {"argv": sys.argv}
    t_start = time.time()

    card = gpu_line()
    log(f"gpu: {card}")
    results["gpu"] = card
    results["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    log(f"torch {results['torch']}, python {sys.version.split()[0]}")

    t0 = time.time()
    for name in _build.SOURCES:     # the first load builds them all at once
        _build.load(name)
    results["build_s"] = time.time() - t0
    log(f"build: {results['build_s']:.1f} s")
    results["ptxas"] = {name: ptxas_report(text)
                        for name, text in _build.build_logs.items()}
    for name, report in results["ptxas"].items():
        log(f"build {name}: {json.dumps(report)}")
    # The bf16 blockwise kernels run their products on wgmma: HGMMA in
    # their machine code, and a chain ptxas did not serialize.
    results["sass_hgmma"] = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        hgmma = sass_count(_build.library_path(name), "HGMMA")
        results["sass_hgmma"][name] = hgmma
        log(f"sass {name}: HGMMA {json.dumps(hgmma)}")
        wgmma = [k for k in hgmma if k.startswith(name + "_wgmma<")]
        check(len(wgmma) == 3 and all(hgmma[k] > 0 for k in wgmma),
              f"{name}: the bf16 kernels lack HGMMA: {hgmma}")
        serialized = [k for k, r in results["ptxas"][name].items()
                      if r.get("wgmma_serialized")]
        check(not serialized,
              f"{name}: ptxas serialized the wgmma chain of {serialized}")
    # The SPARC kernels and the float32 attention forward and backward run
    # their products as 3xTF32 mma.sync: HMMA with TF32 in every one of
    # those kernels (named: the attention libraries also hold the bf16
    # kernels), and no spills.
    results["sass_hmma_tf32"] = {}
    for name, prefix, count in (("sparc_fwd", "sparc_fwd_kernel", 1),
                                ("sparc_bwd", "sparc_bwd_", 2),
                                ("attention_fwd", "attention_fwd_tf32<", 3),
                                ("attention_bwd", "attention_bwd_dq_tf32<", 3),
                                ("attention_bwd", "attention_bwd_dkdv_tf32<",
                                 3)):
        hmma = results["sass_hmma_tf32"].get(name) or sass_count(
            _build.library_path(name), "HMMA", "TF32")
        results["sass_hmma_tf32"][name] = hmma
        log(f"sass {name}: HMMA TF32 {json.dumps(hmma)}")
        tf32 = {k: n for k, n in hmma.items() if k.startswith(prefix)}
        check(len(tf32) == count and all(n > 0 for n in tf32.values()),
              f"{name}: a kernel lacks TF32 HMMA: {hmma}")
        check(name in results["ptxas"],
              f"{name}: no ptxas report (built before this run)")
        spilled = {k: r for k, r in results["ptxas"][name].items()
                   if k.startswith(prefix)
                   and (r.get("spill_stores") or r.get("spill_loads"))}
        check(not spilled, f"{name}: ptxas spilled in {spilled}")

    # Each phase's seconds on the host clock, in results["phase_s"].
    phase_s = results["phase_s"] = {"build": results["build_s"]}
    t_phase = [time.time()]

    def lap(name):
        now = time.time()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    fwd = check_attention(results)
    bwd = check_attention_backward(results)
    check_attention_masked_rows(results)
    attention_mp = check_attention_at(results, "attention_model_parallel",
                                      MP_ATTENTION_SHAPES,
                                      ("bfloat16", "float32"), SEED + 11)
    attention_tools = check_attention_at(results, "attention_tools",
                                         TOOLS_ATTENTION_SHAPES,
                                         ("bfloat16",), SEED + 12)
    sparc_fwd, sparc_bwd = check_sparc(results)
    quant = check_quant(results)
    lap("3 kernels")
    serve = serve_main_path(results)
    lap("4-5 serving")
    train = train_main_path(results)
    lap("6 train")
    gradcache = gradcache_path(results)
    lap("6b gradcache")
    quant_train = quant_train_path(results)
    lap("6c int8 train")
    tools = tools_path(results)
    lap("tools")
    flash_fwd, flash_dq, flash_dkdv = check_long_attention(results)
    long = long_main_path(results)
    lap("7 long")
    keep_dir = tempfile.mkdtemp(prefix="cfa_best_")
    try:
        train_cli = train_cli_path(results, keep_dir)
        lap("8 train cli")
        torch.cuda.reset_peak_memory_stats()
        evaluation = eval_path(results, train_cli["best_dir"],
                               train_cli["held_out"])
        lap("9 eval")
        # Phase 9's CPU half beside phase 10's one-rank NCCL step: a CPU
        # computation beside a process that times nothing.
        one = beside(evaluation["vs_cpu"], nccl_one_rank_path)
        lap("9-10 eval vs CPU, one NCCL rank")
        # Phase 11's int8 oracles on the card beside phase 10's gloo
        # ranks, whose steps wait on the host's collectives.
        int8_oracles = {}
        data_parallel = data_parallel_path(
            results, train_cli["packed_dir"],
            mp_oracle_path(keep_dir, layers=DP_LAYERS), one,
            lambda: int8_oracles.update(mp_int8_oracles(keep_dir)))
        lap("10 data parallel")
        model_parallel = model_parallel_path(results,
                                             train_cli["packed_dir"],
                                             keep_dir, int8_oracles)
        lap("11 model parallel")
    finally:
        shutil.rmtree(keep_dir, ignore_errors=True)
    log("phase seconds:", json.dumps(phase_s))

    csrc = "clip_finegrained_alignment_tpu_torch/csrc/"
    ref = "clip_finegrained_alignment_tpu/ops/"
    entries = [
        ("attention_fwd", ref + "attention.py:115", fwd,
         max(r["max_abs_err"] for r in results["attention"]
             if r["dtype"] == "bfloat16"),
         "B=64 S=197 H=12 Dh=64 bf16 (ViT-B/16 vision, serving bucket)"),
        ("attention_bwd", ref + "attention.py:126", bwd,
         max(r["max_abs_err"] for r in results["attention_backward"]
             if r["dtype"] == "bfloat16"),
         "B=32 S=197 H=12 Dh=64 bf16 (ViT-B/16 vision, train microbatch)"),
        ("sparc_fwd", ref + "sparc_kernel.py:49", sparc_fwd,
         max(r["max_abs_err"] for r in results["sparc"]["fwd"]),
         "B=32 T=77 P=197 D=512 fp32 (ViT-B/16 SPARC, train microbatch)"),
        ("sparc_bwd", ref + "sparc_kernel.py:102", sparc_bwd,
         max(r["max_abs_err"] for r in results["sparc"]["bwd"]),
         "B=32 T=77 P=197 D=512 fp32 (ViT-B/16 SPARC, train microbatch)"),
    ]
    long_shape = "B=4 H=12 S=2048 D=64 bf16 (flash microbenchmark design point)"
    blockwise = results["blockwise"]
    entries += [
        ("flash_fwd", ref + "flash_attention.py:61", flash_fwd,
         max(r["max_abs_err"] for r in blockwise["fwd"]
             if r["dtype"] == "bfloat16"), long_shape),
        ("flash_bwd_dq", ref + "flash_attention.py:101", flash_dq,
         max(r["max_abs_err"] for r in blockwise["dq"]
             if r["dtype"] == "bfloat16"), long_shape),
        ("flash_bwd_dkdv", ref + "flash_attention.py:132", flash_dkdv,
         max(r["max_abs_err"] for r in blockwise["dkdv"]
             if r["dtype"] == "bfloat16"), long_shape),
    ]
    by_path = {"serve": {"attention_fwd": serve["launches"]},
               "train": train["launches"], "long": long["launches"],
               "train_cli": train_cli["launches"],
               "eval": evaluation["launches"],
               "gradcache": gradcache["launches"],
               "train_cli_gradcache": train_cli["launches_gradcache"],
               "train_cli_interop": train_cli["launches_interop"],
               "eval_openai": evaluation["launches_openai"],
               "train_quant": quant_train["launches"],
               "train_cli_quant": train_cli["launches_quant"],
               "data_parallel": data_parallel["launches"],
               "model_parallel": model_parallel["launches"],
               "tools": tools["launches"]}
    # The int8 passes replace no Pallas kernel: what XLA fuses in the JAX
    # package's int8 path (_absmax_quant, int8_matmul's epilogue).
    qref = ref + "quant.py:"
    entries += [(name, qref + line, quant[name], 0.0,
                 quant[name]["shape"] + " (ViT-B/16 vision, train microbatch)")
                for name, line in (("quant_rows", "46"),
                                   ("quant_cols_t", "46"), ("dequant", "60"),
                                   ("absmax_rows", "54"),
                                   ("absmax_cols", "54"),
                                   ("quant_rows_given", "55"),
                                   ("quant_cols_t_given", "55"))]
    pool = TRAIN_B * TRAIN_ACCUM
    kernels = []
    for name, replaces, row, err, shape in entries:
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": csrc + _build.SOURCES[name],
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape,
            **({"graph_ms": row["graph_ms"]} if "graph_ms" in row else {}),
            **({"fp32_eval": evaluation["attention_fp32"]}
               if name == "attention_fwd" else {}),
            **({"model_parallel_shapes": [
                {"shape": r["shape"], "B": r["B"], "S": r["S"], "H": r["H"],
                 "dtype": r["dtype"],
                 **{k: r[name[-3:]][k] for k in (
                     "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "max_abs_err")}} for r in attention_mp]}
               if name in ("attention_fwd", "attention_bwd") else {}),
            **({"gradcache_pool": {
                k: gradcache["sparc"][pool][name[-3:]][k]
                for k in ("B", "ms", "graph_ms", "plain_ms", "bound_ms",
                          "bound_by", "bound_ms_fp32_cores", "max_abs_err")}}
               if name.startswith("sparc") else {}),
            **({"fp32_train": [
                {k: r[k] for k in ("shape", "B", "S", "H", "Dh", "ms",
                                   "graph_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by",
                                   "bound_ms_fp32_cores",
                                   "max_err_over_tol")}
                for r in results["attention_backward"]
                if r["dtype"] == "float32"]}
               if name == "attention_bwd" else {})})
    idle = [k["name"] for k in kernels if not k["launches"]]
    check(not idle, f"kernels the run launched no time: {idle}")
    results["kernels"] = kernels
    results["seconds"] = time.time() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

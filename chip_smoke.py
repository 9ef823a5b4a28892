#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the script (non-zero exit, no "ok" line):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together); report each kernel's registers and spills, and hold
   the bf16 blockwise kernels (forward, dq, dk/dv) to ``HGMMA`` (wgmma) in
   their machine code (``cuobjdump``) and to a ``wgmma`` chain ptxas did
   not serialize, and every SPARC kernel to TF32 ``HMMA`` (``mma.sync``) in
   its machine code and to no spills;
3. each kernel against its plain PyTorch version on the card, with its
   time, the plain version's, the one-call PyTorch yardstick's where there
   is one (never called by the port) and the least time the card could
   take (its bound):
   - the attention forward at the serving shapes (B=64 and B=1, bf16 and
     fp32; q, k, v both as contiguous per-projection tensors, as the model
     passes them, and as strided slices of one fused projection), and at
     S=77 H=4 with Dh=32 and Dh=16, causal and not; its output and, as the
     train path asks for it, its log-sum-exp; against
     ``scaled_dot_product_attention``;
   - the attention backward at the train shapes (B=32: ViT-B/16 vision,
     the causal text tower and the Dh=32 / Dh=16 rows, bf16 and fp32, both
     layouts), fed the forward kernel's log-sum-exp, against the backward
     alone of ``scaled_dot_product_attention``;
   - both attention kernels on fully masked rows (B=32, S=197 and the
     causal S=77, bf16 and fp32; sample 0 masks every key): against the
     plain versions, and the rows against the TPU's Σv / Sp and its dv
     Σdo / Sp over Sp = round_up(S, 8) keys;
   - the SPARC pooling forward and backward at the train shapes (B=32,
     T=77, P=197 and P=50, D=512, fp32) and on an edge batch (fully masked
     rows, a zero patch, duplicated patches), with no library yardstick;
     the forward's saved sim, rl and rv against the plain version's, and
     the backward fed them, as the train path feeds it;
4. the serving main path: ViT-B/16 at full width with random weights from
   a numpy seed, served by ``ClipServer`` on the card behind its HTTP
   server on 127.0.0.1; every endpoint must answer 200 with finite
   unit-norm rows, the forward kernel's launch count must equal the encoder
   layers the bucket forwards ran, and the served embeddings must match
   the port run in fp32 on the CPU;
5. device rates of ``CLIPInference`` at bucket 64 and the HTTP p50;
6. the train main path: SPARC + AdamSPD train steps on ViT-B/16 at full
   width (random weights from the same seed), microbatch 32 x accum 8,
   inverse temperature 0.07, as ``bench.py`` runs the JAX package. One step
   counted: 24 x accum attention forward and backward launches and accum
   SPARC forward and backward launches; every step's loss and gradient
   norm finite and the parameters moved; one microbatch of 4 pairs on the
   card in bf16 against the port in fp32 on the CPU (loss, gradient norm,
   per-tensor gradient cosine); then the step time, pairs/s, model-FLOP
   utilization and a profile of one step;
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
   of 36 forward launches each). It prints which image decode ran (the
   native library or PIL), the live pipeline's rate alone, and one
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
   against the port in fp32 on the CPU (same weights). Then samples/s of
   each subcommand on the host clock (decode and preprocessing included),
   the device time of one scorer call (32 images x 10 templates) with its
   kernel profile, #1 in fp32 at evaluation's shapes (vision B=32, text
   B=320 causal) against SDPA and its bound, and peak memory.

The last lines are the kernels' JSON line (``launches_by_path`` has
``serve``, ``train``, ``long``, ``train_cli`` and ``eval``; the forward
kernel's entry also carries its ``fp32_eval`` rows), the ``nvidia-smi`` line
and ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero before any
result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import base64
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


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3,
                 windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """The card's time per call of ``fn`` without the host's launch cost:
    ``reps`` back-to-back calls captured in one CUDA graph, the median over
    ``windows`` replays (CUDA events) divided by ``reps``. Where the host
    takes longer to launch a call than the card to run it,
    :func:`cuda_time_ms` measures the host; this measures the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


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
                    row.update(attention_bound_ms(B, S, H, D, dname, causal))
                log("attention", json.dumps(row))
                rows.append(row)
    results["attention"] = rows
    return next(r for r in rows if r["shape"] == "ViT-B/16 vision"
                and r["B"] == BUCKET and r["dtype"] == "bfloat16")


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
    """The backward kernel at the train shapes (B=32), both layouts."""
    import torch
    import torch.nn.functional as F
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []
    B = TRAIN_B
    for what, S, H, D, causal, backward in ATTENTION_SHAPES:
        if not backward:
            continue
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
            row.update(attention_bound_ms(B, S, H, D, dname, causal,
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


def check_sparc(results: dict) -> tuple:
    """Both SPARC kernels at the train shapes and on an edge batch."""
    import torch
    from clip_finegrained_alignment_tpu_torch.ops import sparc_kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    T, D, tau = 77, 512, 0.5
    rows = {"fwd": [], "bwd": []}
    for what, B, P, edge in (("ViT-B/16", TRAIN_B, 197, False),
                             ("ViT-B/32", TRAIN_B, 50, False),
                             ("ViT-B/16 edge batch", 4, 197, True)):
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
        if not edge:
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
            rows[kind].append(row)
    results["sparc"] = rows
    return rows["fwd"][0], rows["bwd"][0]


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
    import numpy as np
    import torch
    from clip_finegrained_alignment_tpu_torch.utils import flops

    inf = clip.inference
    rng = np.random.default_rng(SEED + 1)
    S, T = cfg.vision.image_size, cfg.text.max_position_embeddings
    pix = torch.from_numpy(rng.integers(0, 256, size=(BUCKET, S, S, 3))
                           .astype(np.uint8)).cuda()
    ids_np = np.asarray(clip.tok([f"caption number {i}" for i in
                                  range(BUCKET)], T), np.int32)
    ids = torch.from_numpy(ids_np).cuda()
    img_ms = cuda_time_ms(lambda: inf.embed_images_device(pix), reps=10)
    txt_ms = cuda_time_ms(lambda: inf.embed_texts_device(ids), reps=10)
    out = {
        "image_batch_ms": img_ms, "text_batch_ms": txt_ms,
        "images_per_s": BUCKET / img_ms * 1e3,
        "texts_per_s": BUCKET / txt_ms * 1e3,
        "image_model_flops_per_s":
            BUCKET * flops.image_forward_flops(cfg) / img_ms * 1e3,
        "text_model_flops_per_s":
            BUCKET * flops.text_forward_flops(cfg) / txt_ms * 1e3,
    }
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
    the total and the top rows; empty where the profiler reports no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # Kernels only: the CPU-side aten ops carry the same device time
    # again, and so do the GPU-timeline annotations named after them.
    avgs = prof.key_averages()
    cpu_ops = {e.key for e in avgs if e.device_type == DeviceType.CPU}
    rows = [(e.self_device_time_total, e.key, e.count) for e in avgs
            if e.device_type == DeviceType.CUDA and e.key not in cpu_ops
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    # The port's own kernels by name, wherever they rank.
    port = {}
    for us, k, c in rows:
        m = re.search(r"::((?:attention|sparc|flash)_\w+)", k)
        if m:
            port[m.group(1)] = port.get(m.group(1), 0.0) + us / 1e3
    return {"device_ms": total / 1e3,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c,
                     "share": us / total if total else None}
                    for us, k, c in rows[:12]],
            "port_kernels_ms": port}


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

def train_batch(cfg, accum, B, seed):
    """``bench.py``'s batch: normal pixels [accum, B, S, S, 3] fp32 and
    random ids with EOS last, made with numpy from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    ids = rng.integers(1, t.vocab_size - 2,
                       size=(accum, B, t.max_position_embeddings)
                       ).astype(np.int32)
    ids[..., -1] = t.eos_token_id
    pix = rng.normal(size=(accum, B, v.image_size, v.image_size, 3)
                     ).astype(np.float32)
    return {"pixel_values": pix, "input_ids": ids}


def grads_vs_cpu(sd, cfg, tcfg, batch) -> dict:
    """One microbatch's loss, gradient norm and gradients on the card
    (bf16 compute) against the port in fp32 on the CPU."""
    import torch
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    from clip_finegrained_alignment_tpu_torch.optim.factory import \
        global_norm
    from clip_finegrained_alignment_tpu_torch.train.engine import \
        accumulate_grads

    side = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        model = tm.build_train_model(cfg, sd, device=device)
        mb = {k: torch.from_numpy(x[:1, :TRAIN_CHECK_PAIRS]).to(device)
              for k, x in batch.items()}
        losses = accumulate_grads(model, mb, tcfg, cfg, dtype=dtype)
        grads = {n: (p.grad if p.grad is not None
                     else torch.zeros_like(p)).detach().float().cpu()
                 for n, p in model.named_parameters()}
        side[device] = (losses["total_loss"].item(),
                        global_norm(grads.values()).item(), grads)
        del model
    (l_gpu, n_gpu, g_gpu), (l_cpu, n_cpu, g_cpu) = side["cuda"], side["cpu"]
    cos, zero, noise = {}, [], 0.0
    for n, want in g_cpu.items():
        got = g_gpu[n]
        if not want.any():
            check(not got.any(), f"train vs CPU: {n} has a gradient on the "
                  "card only")
            zero.append(n)
        elif n.endswith("self_attn.k_proj.bias"):
            # Zero by math (softmax ignores a constant added to a row's
            # scores): what both sides hold is rounding noise, so it is
            # held to be small, not to agree.
            noise = max(noise, got.norm().item() / n_gpu,
                        want.norm().item() / n_cpu)
        else:
            cos[n] = (torch.nn.functional.cosine_similarity(
                got.flatten(), want.flatten(), dim=0)).item()
    check(noise <= TRAIN_MAX_ZERO_GRAD_SHARE,
          f"train vs CPU: a key-projection bias gradient is {noise} of the "
          "global norm; it is zero by math")
    worst = min(cos, key=cos.get)
    return {"pairs": TRAIN_CHECK_PAIRS, "loss_card": l_gpu, "loss_cpu": l_cpu,
            "loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
            "grad_norm_card": n_gpu, "grad_norm_cpu": n_cpu,
            "grad_norm_rel": abs(n_gpu - n_cpu) / n_cpu,
            "min_grad_cosine": cos[worst], "min_grad_cosine_tensor": worst,
            "median_grad_cosine": sorted(cos.values())[len(cos) // 2],
            "tensors_compared": len(cos), "zero_grad_tensors": zero,
            "k_proj_bias_grad_share_of_norm": noise}


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
    from clip_finegrained_alignment_tpu_torch.utils import flops

    cfg = CLIPConfig.vit_b16()
    tcfg = TrainConfig(loss_type="sparc",
                       optimizer_type="adamspd", inverse_temperature=0.07,
                       batch_size=TRAIN_B,
                       gradient_accumulation_steps=TRAIN_ACCUM, use_amp=True)
    sd = convert.state_dict_from_jax(convert.random_params(cfg, SEED), cfg)
    host_batch = train_batch(cfg, TRAIN_ACCUM, TRAIN_B, SEED)
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

    # Timed steps: CUDA events around each, the metrics read after it.
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        m = step(batch)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
        steps.append({k: x.item() for k, x in m.items()})
        check(all(map(math.isfinite, steps[-1].values())),
              f"train step {len(steps) - 1}: non-finite metrics")
    step_ms = statistics.median(times)
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
        "step_ms_each": times, "step_ms": step_ms,
        "pairs_per_s": pairs / step_ms * 1e3,
        "model_flops_per_step": flops_per_step,
        "mfu_vs_989T_bf16": flops_per_step / (step_ms / 1e3) / PEAK_FLOPS[
            "bfloat16"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "split_step": split,
    })
    out["profile"] = kernel_table(lambda: step(batch))
    out["busy_share"] = out["profile"]["device_ms"] / step_ms
    out["gpu"] = gpu_line()
    log("train:", json.dumps({k: v for k, v in out.items()
                              if k != "profile"}))
    log("profile train step:", json.dumps(out["profile"]))
    del step, opt, model, batch
    torch.cuda.empty_cache()

    agree = grads_vs_cpu(sd, cfg, tcfg, host_batch)
    log("train vs CPU fp32:", json.dumps(agree))
    check(agree["loss_rel"] <= TRAIN_MAX_LOSS_REL
          and agree["grad_norm_rel"] <= TRAIN_MAX_GNORM_REL
          and agree["min_grad_cosine"] >= TRAIN_MIN_GRAD_COSINE,
          f"train step on the card vs CPU fp32 out of limits: {agree}")
    out["vs_cpu_fp32"] = agree
    results["train"] = out
    return out


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

def train_cli_path(results: dict, keep_dir: str) -> dict:
    """Generate a procedural dataset and pack it with the port's CLIs, then
    three in-process runs of the port's ``cli.train.main`` at ViT-B/16 full
    width: A (packed, pixel bank on the card, SPARC + AdamSPD, 2 epochs),
    B (bare ``--resume`` of A to 3 epochs), C (live decode, the count loss
    with AdamW, 1 epoch, with ``--eval-every-epoch`` where matplotlib can
    write its plots). Each run's launches are counted on their own and must
    be exactly what its steps (and evaluations) imply. A's ``best/`` is
    kept in ``keep_dir`` for phase 9, with C's held-out batch (the first of
    its epoch 0)."""
    import gc
    import importlib.util
    import shutil
    import tempfile

    import torch
    from clip_finegrained_alignment_tpu_torch import native
    from clip_finegrained_alignment_tpu_torch.cli import (generate_data,
                                                          pack_dataset)
    from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.ops import _build
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
        del res, best
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(exp)

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
    finally:
        engine.Trainer.step = step
        engine.Trainer.load_state_dict = load_state_dict
        if prev_env is None:
            os.environ.pop("CFA_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["CFA_ALLOW_HASH_TOKENIZER"] = prev_env
        shutil.rmtree(work, ignore_errors=True)

    out.update({"A": a, "B": b, "C": c,
                "kernels_build_s": results.get("build_s")})
    log("train cli:", json.dumps(out))
    results["train_cli"] = out
    total = {n: a["launches"][n] + b["launches"][n] + c["launches"][n]
             for n in _build.SOURCES}
    return {"launches": total, "best_dir": kept, "held_out": held_out}


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
    launches a scorer call, 36 an ``evaluate_batch``, nothing else. The
    first scorer call of each subcommand and the held-out batch are held
    to the port in fp32 on the CPU with the same weights. Then the time of
    one scorer call (B=32 x NT=10) and #1 in fp32 at evaluation's shapes."""
    import numpy as np
    import torch
    from clip_finegrained_alignment_tpu_torch.cli import evaluate as cli_eval
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
    state = {"calls": [], "first": None, "eval_s": 0.0}
    score, spied = scoring.TemplateScorer.__call__, {}

    def spy_score(self, px, ids, mask):
        t0 = time.time()
        probs = score(self, px, ids, mask)
        state["calls"].append((len(px), ids.shape[1], time.time() - t0))
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
    runs, first = {}, {}
    try:
        subcommands = {
            "countbench": ["--dataset", "procedural"],
            "vlmsblind": ["--dataset", "procedural"],
            "crop": ["--samples", str(EVAL_CROP_SAMPLES), "--output",
                     os.path.join(work, "crop.json")]}
        for cmd, extra in subcommands.items():
            state.update(calls=[], first=None, eval_s=0.0)
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

    # The card against the port in fp32 on the CPU, same weights.
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
            check(r["max_abs_err"] <= EVAL_MAX_ABS and r["argmax_agree_clear"],
                  f"eval {name}: the card against the CPU {r}")
    check(vs_cpu["held_out_confusion_max_abs_err"] <= EVAL_MAX_ABS,
          f"eval held-out confusion: {vs_cpu}")
    del cpu

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
        row.update(attention_bound_ms(B, S, H, D, "float32", causal))
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
    return {"launches": eval_launches, "attention_fp32": rows}


# ---------------------------------------------------------------------------

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
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "clip_finegrained_alignment_tpu_torch")):
        print("chip_smoke: the port package is not beside this script; "
              "nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
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
    # The SPARC kernels run their products as 3xTF32 mma.sync: HMMA with
    # TF32 in every one of their kernels, and no spills.
    results["sass_hmma_tf32"] = {}
    for name in ("sparc_fwd", "sparc_bwd"):
        hmma = sass_count(_build.library_path(name), "HMMA", "TF32")
        results["sass_hmma_tf32"][name] = hmma
        log(f"sass {name}: HMMA TF32 {json.dumps(hmma)}")
        check(len(hmma) == (1 if name == "sparc_fwd" else 2)
              and all(n > 0 for n in hmma.values()),
              f"{name}: a kernel lacks TF32 HMMA: {hmma}")
        check(name in results["ptxas"],
              f"{name}: no ptxas report (built before this run)")
        spilled = {k: r for k, r in results["ptxas"][name].items()
                   if r.get("spill_stores") or r.get("spill_loads")}
        check(not spilled, f"{name}: ptxas spilled in {spilled}")

    fwd = check_attention(results)
    bwd = check_attention_backward(results)
    check_attention_masked_rows(results)
    sparc_fwd, sparc_bwd = check_sparc(results)
    serve = serve_main_path(results)
    train = train_main_path(results)
    flash_fwd, flash_dq, flash_dkdv = check_long_attention(results)
    long = long_main_path(results)
    keep_dir = tempfile.mkdtemp(prefix="cfa_best_")
    try:
        train_cli = train_cli_path(results, keep_dir)
        torch.cuda.reset_peak_memory_stats()
        evaluation = eval_path(results, train_cli["best_dir"],
                               train_cli["held_out"])
    finally:
        shutil.rmtree(keep_dir, ignore_errors=True)

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
               "eval": evaluation["launches"]}
    kernels = []
    for name, replaces, row, err, shape in entries:
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + name + ".cu",
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape,
            **({"graph_ms": row["graph_ms"]} if "graph_ms" in row else {}),
            **({"fp32_eval": evaluation["attention_fp32"]}
               if name == "attention_fwd" else {})})
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

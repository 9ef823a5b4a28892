#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the script (non-zero exit, no "ok" line):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together);
3. each kernel against its plain PyTorch version on the card, with its
   time, the plain version's, the one-call PyTorch yardstick's where there
   is one (never called by the port) and the least time the card could
   take (its bound):
   - the attention forward at the serving shapes (B=64 and B=1, bf16 and
     fp32; q, k, v both as contiguous per-projection tensors, as the model
     passes them, and as strided slices of one fused projection), against
     ``scaled_dot_product_attention``;
   - the attention backward at the train shapes (B=32: ViT-B/16 vision and
     the causal text tower, bf16 and fp32, both layouts), against the
     backward alone of ``scaled_dot_product_attention``;
   - the SPARC pooling forward and backward at the train shapes (B=32,
     T=77, P=197 and P=50, D=512, fp32) and on an edge batch (fully masked
     rows, a zero patch, duplicated patches), with no library yardstick;
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
   shared bias (S=2048) and a ViT-L/14@336 key-padding bias [B, 1, S, S]
   with a fully masked row (S=577, H=16, B=8, also in fp32); their times at
   S=2048 B=4 against ``scaled_dot_product_attention``; then the ported
   microbenchmark at the three design points, its launches counted (per
   design point, 2 x (steps + 1) forward and steps + 1 of each backward
   kernel on each of its two paths, and nothing else), and one counted
   forward+backward of ``blockwise_flash_attention`` (exactly one launch of
   each blockwise kernel and none of the others).

The last lines are the kernels' JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
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
import statistics
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor, fp32 CUDA cores

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
# 4096 terms in another order, then a log). The first readings on an H100:
# o at most 0.71 of its limit (bf16), 0.022 (fp32); lse 9.5e-7; dq, dk, dv
# equal to the last bit (both sides sum in the same order).
LSE_TOL = (1e-5, 1e-6)
LONG_D, LONG_BLOCK = 64, 256
LONG_SHAPES = [  # (what, B, H, S, bias)
    ("microbench S=1024", 8, 12, 1024, None),
    ("microbench S=2048", 4, 12, 2048, None),
    ("microbench S=4096", 1, 12, 4096, None),
    ("causal S=2048", 1, 12, 2048, "causal"),
    ("ViT-L/14@336 key padding", 8, 16, 577, "padding"),
]
LONG_TIMED = "microbench S=2048"
# The long path: the ported flash microbenchmark at its design points
# (S, B) and its default step count, every launch counted.
MICROBENCH_POINTS = ((1024, 8), (2048, 4), (4096, 1))
MICROBENCH_STEPS = 20


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


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

ATTENTION_SHAPES = [  # (what, S, H, Dh, causal)
    ("ViT-B/16 vision", 197, 12, 64, False),
    ("text (causal)", 77, 8, 64, True),
    ("ViT-B/32 vision", 50, 12, 64, False),
    ("ViT-L/14 vision", 257, 16, 64, False),
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


def check_attention(results: dict) -> dict:
    import torch
    import torch.nn.functional as F
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for what, S, H, D, causal in ATTENTION_SHAPES:
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
                errs = {}
                for layout, (q, k, v) in layouts.items():
                    out = ta.flash_attention(q, k, v, bias, scale)
                    torch.cuda.synchronize()
                    ref = ta.attention_reference(q.float(), k.float(),
                                                 v.float(), bias, scale)
                    errs[layout] = (out.float() - ref).abs().max().item()
                    check(bool(torch.isfinite(out).all()),
                          f"attention {what} B={B} {dname} {layout}: "
                          f"non-finite output")
                err = max(errs.values())
                row = {"shape": what, "B": B, "S": S, "H": H, "Dh": D,
                       "dtype": dname, "max_abs_err": err,
                       "max_abs_err_by_layout": errs,
                       "tol": KERNEL_TOL[dname]}
                check(err <= KERNEL_TOL[dname],
                      f"attention {what} B={B} {dname}: max abs err {errs} "
                      f"> {KERNEL_TOL[dname]}")
                if B == BUCKET:
                    # Timed on the main path's layout.
                    q, k, v = layouts["separate"]
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    mask = None if bias is None else bias.to(dtype)
                    row["ms"] = cuda_time_ms(
                        lambda: ta.flash_attention(q, k, v, bias, scale))
                    row["plain_ms"] = cuda_time_ms(
                        lambda: ta.attention_reference(q, k, v, bias, scale),
                        reps=5)
                    row["library_ms"] = cuda_time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, scale=scale))
                    row.update(attention_bound_ms(B, S, H, D, dname, causal))
                log("attention", json.dumps(row))
                rows.append(row)
    results["attention"] = rows
    return next(r for r in rows if r["shape"] == "ViT-B/16 vision"
                and r["B"] == BUCKET and r["dtype"] == "bfloat16")


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
    for what, S, H, D, causal in ATTENTION_SHAPES[:2]:
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
                got = ta._launch_backward(q, k, v, bias, scale, do)
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
            row["ms"] = cuda_time_ms(
                lambda: ta._launch_backward(q, k, v, bias, scale, do))
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
        out = sk._launch(v, l, mask, tau)
        dv, dl = sk._launch_backward(v, l, mask, tau, g)
        torch.cuda.synchronize()
        ref = sk.sparc_pooling_reference(v, l, mask, tau)
        rdv, rdl = sk.sparc_pooling_backward_reference(v, l, mask, tau, g)
        for t in (out, dv, dl):
            check(bool(torch.isfinite(t).all()), f"SPARC {what}: non-finite")
        errs = {"out": ((out - ref).abs() * keep_row).max().item(),
                "dl": ((dl - rdl).abs() * keep_row).max().item(),
                "dv": ((dv - rdv).abs() * keep_b).max().item()}
        n_near, n_rows = int(near.sum()), int((mask > 0).sum())
        common = {"shape": what, "B": B, "T": T, "P": P, "D": D, "tau": tau,
                  "tol": SPARC_TOL, "near_decision_rows": n_near,
                  "rows": n_rows, "near_decision_samples":
                  int(near.any(-1).sum())}
        check(n_near <= SPARC_MAX_NEAR_SHARE * n_rows,
              f"SPARC {what}: {n_near} of {n_rows} rows near a decision")
        fwd = dict(common, max_abs_err=errs["out"])
        bwd = dict(common, max_abs_err=max(errs["dl"], errs["dv"]),
                   max_abs_err_by={"dl": errs["dl"], "dv": errs["dv"]})
        for kind, row in (("forward", fwd), ("backward", bwd)):
            check(row["max_abs_err"] <= SPARC_TOL,
                  f"SPARC {kind} {what}: max abs err {row['max_abs_err']} "
                  f"> {SPARC_TOL}")
        if not edge:
            fwd["ms"] = cuda_time_ms(lambda: sk._launch(v, l, mask, tau))
            bwd["ms"] = cuda_time_ms(
                lambda: sk._launch_backward(v, l, mask, tau, g))
            fwd["plain_ms"] = cuda_time_ms(
                lambda: sk.sparc_pooling_reference(v, l, mask, tau), reps=5)
            bwd["plain_ms"] = cuda_time_ms(
                lambda: sk.sparc_pooling_backward_reference(v, l, mask, tau,
                                                            g), reps=5)
            # No single PyTorch call computes this chain.
            fwd["library_ms"] = bwd["library_ms"] = None
            # Reads v, l, mask (and g), writes out (dv, dl) once; fp32
            # products: sim and pooling in the forward; sim again,
            # g·vᵀ, wᵀ·g, dsim·v_norm and dsimᵀ·l_norm in the backward.
            f4 = 4.0
            fwd.update(bound_ms(f4 * (B * P * D + 2 * B * T * D + B * T),
                                2.0 * 2 * B * T * P * D, "float32"))
            bwd.update(bound_ms(f4 * (2 * B * P * D + 3 * B * T * D + B * T),
                                2.0 * 5 * B * T * P * D, "float32"))
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
    return {"device_ms": total / 1e3,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c,
                     "share": us / total if total else None}
                    for us, k, c in rows[:12]]}


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

def long_inputs(gen, B, H, S, dtype, bias_kind):
    """Normal q, k, v, do ``[B, H, S, 64]`` in ``dtype`` and the bias:
    None, a shared causal ``[1, 1, S, S]``, or a batched key-padding
    ``[B, 1, S, S]`` (keys past a random length in [S/2, S] at −1e9) whose
    first query row of batch 0 is masked everywhere."""
    import torch
    q, k, v, do = (torch.randn(B, H, S, LONG_D, device="cuda",
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
    scale = LONG_D ** -0.5
    rows = {"fwd": [], "dq": [], "dkdv": []}
    for (what, B, H, S, bias_kind), dtype in cases:
        dname = str(dtype).split(".")[-1]
        q, k, v, do, bias = long_inputs(gen, B, H, S, dtype, bias_kind)
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
        lse_lim = LSE_TOL[0] + LSE_TOL[1] * ref_lse.abs()
        excess["lse"] = ((lse - ref_lse).abs() / lse_lim).max().item()
        common = {"shape": what, "B": B, "H": H, "S": S, "D": LONG_D,
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
            fwd.update(attention_bound_ms(B, S, H, LONG_D, dname, False))
            bdq.update(attention_bound_ms(B, S, H, LONG_D, dname, False,
                                          tensors=5, products=3))
            bkv.update(attention_bound_ms(B, S, H, LONG_D, dname, False,
                                          tensors=6, products=4))
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
        gen, B, 12, S, torch.bfloat16, None)[:3])
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

    # A reference states and sets both: fp32 matmuls and convolutions run
    # in full fp32, never TF32.
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
    for name, text in _build.build_logs.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build {name}: " + " | ".join(regs[:12]))

    fwd = check_attention(results)
    bwd = check_attention_backward(results)
    sparc_fwd, sparc_bwd = check_sparc(results)
    serve = serve_main_path(results)
    train = train_main_path(results)
    flash_fwd, flash_dq, flash_dkdv = check_long_attention(results)
    long = long_main_path(results)

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
               "train": train["launches"], "long": long["launches"]}
    kernels = []
    for name, replaces, row, err, shape in entries:
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + name + ".cu",
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape})
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

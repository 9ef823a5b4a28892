#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the script (non-zero exit, no "ok" line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernel of the serving path from ``csrc/``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes serving gives it (B=64 and B=1, bf16 and fp32; q, k, v both as
   contiguous per-projection tensors, as the model passes them, and as
   strided slices of one fused projection), with its time,
   the plain version's, the one-call PyTorch yardstick's
   (``scaled_dot_product_attention``, never called by the port) and the
   least time the card could take (its bound);
4. the main path: ViT-B/16 at full width with random weights from a numpy
   seed, served by ``ClipServer`` on the card behind its HTTP server on
   127.0.0.1; every endpoint must answer 200 with finite unit-norm rows,
   the kernels' launch counts must equal the encoder layers the bucket
   forwards ran, and the served embeddings must match the port run in
   fp32 on the CPU;
5. device rates of ``CLIPInference`` at bucket 64 and the HTTP p50.

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


def attention_bound_ms(B, S, H, D, dtype_name, causal) -> dict:
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * S * H * D * item + (S * S * 4 if causal else 0)
    flops = 4.0 * B * H * S * S * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


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
    from clip_finegrained_alignment_tpu_torch.ops import attention as ta

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
        ta.reset_launch_count()
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
        launches = ta.launch_count()
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


def profile_forward(inf, pix, ids) -> dict:
    """Device time by kernel over one bucket forward of each tower
    (``torch.profiler``); empty where the profiler reports no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inf.embed_images_device(pix)
    inf.embed_texts_device(ids)
    torch.cuda.synchronize()
    out = {}
    for name, fn, arg in (("image", inf.embed_images_device, pix),
                          ("text", inf.embed_texts_device, ids)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(arg)
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
        out[name] = {"device_ms": total / 1e3,
                     "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c,
                              "share": us / total if total else None}
                             for us, k, c in rows[:8]]}
        log(f"profile {name}:", json.dumps(out[name]))
    return out


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
    _build.load("attention_fwd")
    results["build_s"] = time.time() - t0
    log(f"build: {results['build_s']:.1f} s")
    for name, text in _build.build_logs.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build {name}: " + " | ".join(regs[:12]))

    head = check_attention(results)
    main_path = serve_main_path(results)

    kernels = [{
        "name": "attention_fwd", "route": "cuda",
        "source": "clip_finegrained_alignment_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "clip_finegrained_alignment_tpu/ops/attention.py:115",
        "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in results["attention"]
                           if r["dtype"] == "bfloat16"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": "B=64 S=197 H=12 Dh=64 bf16 (ViT-B/16 vision)",
    }]
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

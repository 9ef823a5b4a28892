"""The serving driver: the port's HTTP server (``cli/serve.py``'s
``ClipServer`` behind ``make_server``, on 127.0.0.1) under an open loop of
requests from a child process (``drivers/loadgen.py``).

Set-up draws the seed's weights on the card, builds the server at the
traffic's bucket and batching window, warms it with ``warmup`` full-bucket
requests through HTTP, and starts the load generator. The window is the
``--seconds`` over which requests fall due; each is timed from when it was
due to when its answer was read, and ``serve_p95_ms`` is the 95th
percentile of every request due in the window, a failed one counting as
the longest wait. ``--trace 1`` profiles ``trace_seconds`` of the card
alone in the middle of the window, then ``gap_seconds`` of the host's ops
and the card.

Once the window has closed and the server is stopped, the answers of a
sample of the requests drawn from the seed (every one of the largest size
up to ``sample_longest``, others up to ``sample``) are compared with the
plain reference's fp32 embeddings of the same images: ``embed_gap`` is the
widest L2 distance between a served unit embedding and the reference's.

The traffic file's keys: ``path``, ``rate`` (requests a second),
``sizes`` and ``weights`` (images a request), ``bank`` (random images the
requests draw from), ``bucket``, ``window_ms``, ``clients``, ``warmup``,
``grace_s``, ``sample``, ``sample_longest``, ``trace_seconds`` (the
device-only slice), ``gap_seconds`` (the slice that also records the host's
ops, for the idle gaps' names).
"""

from __future__ import annotations

import base64
import gc
import json
import math
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .. import flops, harness, spec, trace, traffic, weights
from ..reference import clip_ref
from .train import port_config, release

UNITS = {"setup_s": "s", "serve_p95_ms": "ms"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CHECKOUT = Path(__file__).resolve().parents[2]


class Server:
    """The port's server on an ephemeral port, serving in a thread."""

    def __init__(self, cfg: dict, tr: dict, sd, dev):
        from clip_finegrained_alignment_tpu_torch.cli.serve import (
            ClipServer, make_server)
        self.clip = ClipServer(sd, port_config(cfg), None,
                               model_name=cfg["name"], bucket=tr["bucket"],
                               window_ms=tr["window_ms"],
                               dtype=DTYPES[cfg["precision"]["compute"]],
                               device=dev)
        self.http = make_server(self.clip, "127.0.0.1", 0)
        self.port = self.http.server_port
        self.thread = threading.Thread(target=self.http.serve_forever,
                                       daemon=True)
        self.thread.start()

    def counters(self) -> dict:
        s = self.clip.batcher.stats
        return {"items": s["items"], "batches": s["batches"]}

    def post(self, path: str, body: bytes) -> bytes:
        conn = HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request("POST", path, body,
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"warm-up request: {resp.status} {data!r}")
            return data
        finally:
            conn.close()

    def close(self) -> None:
        self.http.shutdown()
        self.http.server_close()
        self.clip.close()
        self.thread.join(10)


def warm_up(server: Server, cfg: dict, tr: dict) -> None:
    """``warmup`` requests of a full bucket each (every device batch runs
    at the bucket's shape)."""
    S = cfg["vision_config"]["image_size"]
    body = np.zeros((tr["bucket"], S, S, 3), np.uint8).tobytes()
    for _ in range(tr["warmup"]):
        server.post(tr["path"], body)


def loadgen_args(cfg: dict, tr: dict, seed: int, port: int, rate: float,
                 seconds: float, sample: List[int]) -> dict:
    return {"port": port, "path": tr["path"], "seed": seed, "rate": rate,
            "seconds": seconds, "sizes": tr["sizes"], "weights": tr["weights"],
            "image_size": cfg["vision_config"]["image_size"],
            "bank": tr["bank"], "clients": tr["clients"],
            "grace_s": tr["grace_s"], "sample": sample}


def window(server: Server, args: dict, during=None) -> dict:
    """One window of the load generator against ``server``: its result,
    with ``start`` (the wall clock at the window's start) and the batcher's
    counters over the window; ``during(start)`` runs while it lasts."""
    child = subprocess.Popen(
        [sys.executable, "-m", "port_bench.drivers.loadgen",
         json.dumps(args)], cwd=CHECKOUT, stdout=subprocess.PIPE, text=True)
    try:
        line = child.stdout.readline()
        if not line.startswith("START "):
            raise RuntimeError(f"load generator: {line!r}")
        start = float(line.split()[1])
        c0 = server.counters()
        if during is not None:
            during(start)
        out = json.loads(child.stdout.readline())
        c1 = server.counters()
    finally:
        child.stdout.close()
        if child.wait(timeout=args["grace_s"] + 30) != 0:
            raise RuntimeError(f"load generator exit {child.returncode}")
    out["start"] = start
    out["items"] = c1["items"] - c0["items"]
    out["batches"] = c1["batches"] - c0["batches"]
    return out


def latencies(out: dict, grace_s: float) -> List[float]:
    """Each request's seconds from due to answer; a failed one waited the
    whole grace."""
    return [d - due if d is not None and st == 200 else grace_s
            for due, d, st in zip(out["due"], out["done"], out["status"])]


def p(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` quantile."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def served(out: dict, i: int, P: int) -> Optional[np.ndarray]:
    raw = out["answers"].get(str(i))
    if raw is None:
        return None
    emb = np.frombuffer(base64.b64decode(raw), np.float32)
    n = out["images"][i]
    return emb.reshape(n, P) if emb.size == n * P else None


def reference_embeddings(cfg: dict, sd, images: np.ndarray, dev,
                         gemm: str = "fp32", block: int = 32) -> torch.Tensor:
    clip_ref.exact()
    out = []
    with torch.no_grad():
        for i in range(0, len(images), block):
            x = torch.from_numpy(images[i:i + block]).to(dev)
            out.append(clip_ref.image_embeddings(sd, cfg, x, gemm))
    return torch.cat(out)


def sampled_images(cfg: dict, tr: dict, seed: int, sched: dict,
                   ids: List[int]) -> np.ndarray:
    bank = traffic.image_bank(seed, tr["bank"],
                              cfg["vision_config"]["image_size"])
    return bank[[j for i in ids for j in sched["images"][i]]]


def embed_gap(cfg: dict, tr: dict, seed: int, out: dict, sched: dict,
              ids: List[int], dev, gemm: str = "fp32") -> dict:
    """``embed_gap`` of the sampled answers against the reference (None
    where an answer is missing or of the wrong shape), and ``wrong``, the
    count of such answers."""
    P = cfg["projection_dim"]
    g = weights.generator(seed, dev)
    sd = weights.state_dict(cfg, g, dev)
    ref = reference_embeddings(cfg, sd, sampled_images(cfg, tr, seed, sched,
                                                       ids), dev, gemm)
    del sd
    gaps, wrong, row = [], 0, 0
    for i in ids:
        n = out["images"][i]
        got = served(out, i, P)
        if got is None:
            wrong += 1
        else:
            d = torch.from_numpy(got.copy()).to(dev) - ref[row:row + n]
            gaps.append(float(d.norm(dim=-1).max()))
        row += n
    return {"embed_gap": max(gaps) if not wrong else None, "wrong": wrong}


def control_gap(cfg: dict, tr: dict, seed: int, sched: dict,
                ids: List[int], dev) -> float:
    """The control's ``embed_gap``: the reference with every product's
    operands in float8 e4m3, against the fp32 reference, on the same
    images."""
    g = weights.generator(seed, dev)
    sd = weights.state_dict(cfg, g, dev)
    imgs = sampled_images(cfg, tr, seed, sched, ids)
    ref = reference_embeddings(cfg, sd, imgs, dev)
    low = reference_embeddings(cfg, sd, imgs, dev, "fp8")
    return float((low - ref).norm(dim=-1).max())


def calls_per_batch(cfg: dict, tr: dict) -> dict:
    v = cfg["vision_config"]
    call = {"B": tr["bucket"], "S": flops.vision_tokens(cfg),
            "H": v["num_attention_heads"],
            "D": v["hidden_size"] // v["num_attention_heads"], "dt": "bf16",
            "lse": False}
    return {"attention_fwd": [call] * v["num_hidden_layers"]}


def start(cfg: dict, tr: dict, seed: int, dev) -> Server:
    g = weights.generator(seed, dev)
    server = Server(cfg, tr, weights.state_dict(cfg, g, dev), dev)
    gc.collect()
    warm_up(server, cfg, tr)
    return server


def run(cell: dict, seed: int, seconds: float, traced: bool, dev,
        process_start: float) -> harness.Outcome:
    cfg, tr = cell["config"], cell["traffic"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    phases = {"imports": time.time() - process_start}
    server = start(cfg, tr, seed, dev)
    phases["server_warm"] = time.time() - process_start
    sched = traffic.schedule(seed, tr["rate"], seconds, tr["sizes"],
                             tr["weights"], tr["bank"])
    ids = traffic.sample(seed, sched, tr["sample"], tr["sample_longest"])
    traced_slice = {}

    def profile_middle(start_wall: float) -> None:
        span = min(tr["trace_seconds"], seconds / 2)
        time.sleep(max(0.0, start_wall + (seconds - span) / 2 - time.time()))
        c0 = server.counters()
        prof = trace.profile()
        time.sleep(span)
        c1 = server.counters()
        prof.stop()
        host = trace.profile(cpu=True)
        with torch.profiler.record_function(trace.SLICE):
            time.sleep(tr["gap_seconds"])
        host.stop()
        traced_slice.update(trace=trace.read(prof), gaps=trace.idle_gaps(host),
                            items=c1["items"] - c0["items"],
                            batches=c1["batches"] - c0["batches"])

    out = window(server, loadgen_args(cfg, tr, seed, server.port, tr["rate"],
                                      seconds, ids),
                 profile_middle if traced else None)
    server.close()
    device = harness.device_fields(dev, cell["chips"])
    del server
    release()

    lat = latencies(out, tr["grace_s"])
    failed = sum(1 for d, st in zip(out["done"], out["status"])
                 if d is None or st != 200)
    check = embed_gap(cfg, tr, seed, out, sched, ids, dev)
    checks = {"embed_gap": harness.check(check["embed_gap"],
                                         cell["limits"]["embed_gap"])}
    notes = {"setup_phases": phases,
             "requests": len(lat), "images": sum(out["images"]),
             "window_items": out["items"], "window_batches": out["batches"],
             "latency_p50_ms": 1e3 * p(lat, 0.5),
             "latency_p95_ms": 1e3 * p(lat, 0.95),
             "latency_max_ms": 1e3 * max(lat),
             "send_late_p95_ms": 1e3 * p([s - d for s, d in zip(
                 out["sent"], out["due"]) if s is not None], 0.95),
             "wrong_answers": check["wrong"]}
    breakdown = None
    if traced:
        ts = traced_slice
        ctx = {"kind": "serve", "trace": ts["trace"],
               "calls_per_unit": calls_per_batch(cfg, tr),
               "kernels": spec.kernel_impls(),
               "window_items": out["items"], "window_batches": out["batches"],
               "slice_fill": ts["items"] / ts["batches"] if ts["batches"]
               else None,
               "image_flops": flops.image_forward_flops(cfg)}
        metrics = harness.per_layer(ctx)
        device.update(busy_s=ts["trace"]["busy_s"],
                      window_s=ts["trace"]["window_s"])
        breakdown = {"device_ops": trace.device_ops(ts["trace"]),
                     "idle_gaps": ts["gaps"]}
    else:
        metrics = {"serve_p95_ms": {"value": 1e3 * p(lat, 0.95),
                                    "unit": UNITS["serve_p95_ms"]},
                   "setup_s": {"value": out["start"] - process_start,
                               "unit": UNITS["setup_s"]}}
    return harness.Outcome(attempted=len(lat), failed=failed,
                           metrics=metrics, device=device, checks=checks,
                           breakdown=breakdown, notes=notes)


def calibrate(cell: dict, seeds: List[int], modes: List[str], dev,
              seconds: float = 4.0) -> List[dict]:
    """``embed_gap`` of each seed for each mode: ``program`` (a window of
    ``seconds`` at the cell's rate; the server built anew from the seed's
    weights) and ``control`` (:func:`control_gap`, on the same sample)."""
    cfg, tr = cell["config"], cell["traffic"]
    rows = []
    for seed in seeds:
        sched = traffic.schedule(seed, tr["rate"], seconds, tr["sizes"],
                                 tr["weights"], tr["bank"])
        ids = traffic.sample(seed, sched, tr["sample"], tr["sample_longest"])
        for mode in modes:
            if mode == "program":
                server = start(cfg, tr, seed, dev)
                out = window(server, loadgen_args(
                    cfg, tr, seed, server.port, tr["rate"], seconds, ids))
                server.close()
                del server
                release()
                gap = embed_gap(cfg, tr, seed, out, sched, ids, dev)
                rows.append({"seed": seed, "mode": mode, **gap,
                             "p95_ms": 1e3 * p(latencies(out, tr["grace_s"]),
                                               0.95)})
            elif mode == "control":
                rows.append({"seed": seed, "mode": mode, "embed_gap":
                             control_gap(cfg, tr, seed, sched, ids, dev)})
            release()
    return rows

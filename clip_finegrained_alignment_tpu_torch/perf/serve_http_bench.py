"""Online-serving benchmark: the HTTP front end under concurrent load, the
port of ``perf/serve_http_bench.py``.

What ``perf/serve_bench.py`` (device batch rates) cannot show: the
dynamic request batcher (``cli/serve.py``) under many concurrent clients.
``ClipServer`` and ``make_server`` serve random weights
(``models/convert.py::random_params``, seed 0) with the hash tokenizer
(token ids do not change the cost), bucket 64 and a 3 ms window on
127.0.0.1; ``clients`` threads each post ``requests`` requests of one
item, on one keep-alive connection each, to ``/v1/embed/text``,
``/v1/embed/image`` (JSON pixels: ~150,000 integers a request at 224 px,
which one host serializes and parses, so this endpoint measures the
host) and ``/v1/embed/image_raw`` (the binary path) in turn.

    python -m clip_finegrained_alignment_tpu_torch.perf.serve_http_bench \\
        [clients] [requests]

Defaults: 16 clients × 20 requests, ViT-B/32 (``--model``). Per
endpoint, ``serve_http_bench.py``'s keys: ``requests_per_sec``,
``latency_ms_p50``, ``latency_ms_p95`` (host clock, request sent to
answer read), ``mean_batch_fill`` (items over device batches),
``clients``, ``n``, and the batcher's ``stages`` (``clip.stats()``'s
p50 and p95 of queue wait, dispatch and device batch over the endpoint's
spans); one
line each, then one summary JSON line, each with ``device`` and ``gpu``
(the card's name and power limit). ``--device cpu`` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.client import HTTPConnection
from typing import List, Optional

import numpy as np

from ..models.clip import resolve_device
from ._measure import device_fields


def run(clients: int = 16, per_client: int = 20, model: str = "ViT-B/32",
        device="cuda", bucket: int = 64, window_ms: float = 3.0,
        seed: int = 0) -> dict:
    """Serve ``model``, load each endpoint, return the summary."""
    from ..cli.serve import ClipServer, make_server
    from ..config import CLIPConfig
    from ..data.tokenizer import HashTokenizer
    from ..models.convert import random_params, state_dict_from_jax

    device = resolve_device(device)
    cfg = CLIPConfig.from_name(model)
    t = cfg.text
    tok = HashTokenizer(vocab_size=t.vocab_size, bos_token_id=t.bos_token_id,
                        eos_token_id=t.eos_token_id,
                        pad_token_id=t.pad_token_id)
    clip = ClipServer(state_dict_from_jax(random_params(cfg, seed), cfg), cfg,
                      tok, model_name=model, bucket=bucket,
                      window_ms=window_ms, device=device)
    srv = make_server(clip, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port, S = srv.server_port, cfg.vision.image_size
    card = device_fields(device)
    try:
        clip.embed_texts(["warmup"])        # cuBLAS, allocator, kernels
        clip.embed_images({"pixels": np.zeros((1, S, S, 3), np.uint8)})
        pixels = np.random.default_rng(seed).integers(
            0, 256, size=(1, S, S, 3), dtype=np.uint8)
        results = {}
        for name, path, payload, ctype in (
                ("text", "/v1/embed/text",
                 json.dumps({"texts": ["a photo of three cats"]}),
                 "application/json"),
                ("image", "/v1/embed/image",
                 json.dumps({"pixels": pixels.astype(int).tolist()}),
                 "application/json"),
                ("image_raw", "/v1/embed/image_raw", pixels.tobytes(),
                 "application/octet-stream")):
            results[name] = _load(clip, port, path, payload, ctype, clients,
                                  per_client)
            print(json.dumps({"endpoint": name, **results[name], **card}),
                  flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        clip.close()
        thread.join(timeout=10)
    return {"model": model, **results, **card}


def _load(clip, port: int, path: str, payload, ctype: str, clients: int,
          per_client: int) -> dict:
    """``clients`` threads posting ``per_client`` requests each."""
    lats: List[float] = []
    failures: List[str] = []
    lock = threading.Lock()

    def worker():
        conn = HTTPConnection("127.0.0.1", port, timeout=300)
        mine = []
        try:
            for _ in range(per_client):
                t0 = time.perf_counter()
                conn.request("POST", path, payload, {"Content-Type": ctype})
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200:
                    raise RuntimeError(f"{path} answered {resp.status}: "
                                       f"{body[:200]!r}")
                mine.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:          # reported below, on the main thread
            with lock:
                failures.append(f"{type(e).__name__}: {e}")
        finally:
            conn.close()
            with lock:
                lats.extend(mine)

    stats = clip.batcher.stats
    items0, batches0 = stats["items"], stats["batches"]
    since = time.time_ns()              # this endpoint's stage spans
    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    dt = time.perf_counter() - t0
    if failures:
        raise RuntimeError(f"{path}: {len(failures)} client(s) failed: "
                           f"{failures[0]}")
    items = stats["items"] - items0
    batches = stats["batches"] - batches0
    lats.sort()

    def q(p):
        return lats[int(p * (len(lats) - 1))]
    return {"requests_per_sec": len(lats) / dt,
            "latency_ms_p50": q(0.5), "latency_ms_p95": q(0.95),
            "mean_batch_fill": items / max(batches, 1),
            "clients": clients, "n": len(lats),
            "stages": {k: v for k, v in clip.stats(since).items()
                       if k.endswith(("p50", "p95"))}}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("clients", nargs="?", type=int, default=16)
    ap.add_argument("requests", nargs="?", type=int, default=20)
    ap.add_argument("--model", default="ViT-B/32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.clients, args.requests, args.model, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

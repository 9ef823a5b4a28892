"""Serving CLI: HTTP embedding / zero-shot-classification server, the port
of ``clip_finegrained_alignment_tpu/cli/serve.py``.

A threaded HTTP server whose in-flight requests coalesce into fixed-bucket
device batches (dynamic batching) over ``models/inference.py``.

Endpoints (JSON in / JSON out):

* ``POST /v1/embed/text``     ``{"texts": [str, ...]}``
  → ``{"embeddings": [[f32 × proj_dim], ...]}`` (L2-normalized)
* ``POST /v1/embed/image``    ``{"images_b64": [b64(jpeg|png), ...]}`` or
  ``{"pixels": [[S, S, 3] uint8 nested lists, ...]}`` → same shape.
  Decoded images get the HF-processor geometry (shorter-side bicubic
  resize + center crop).
* ``POST /v1/classify``       images as above + ``{"labels": [str, ...],
  "template": "a photo of {}"}`` → ``{"labels": [...], "probs": [[...]]}``
  (softmax over ``logit_scale``-scaled similarities; the prompt bank is
  embedded once per distinct (template, labels) and cached).
* ``POST /v1/embed/image_raw``  body: raw uint8 pixels
  (``application/octet-stream``, N·S·S·3 bytes) → raw little-endian
  float32 embeddings with an ``X-Embed-Shape: N,P`` header.
* ``GET /healthz`` · ``GET /stats`` (items, batches, mean batch fill,
  stage latency quantiles, read from the batcher's spans).

HTTP/1.1 keep-alive, with the connection closed whenever a request body
was not read in full (a bad ``Content-Length``, or ``Transfer-Encoding:
chunked``, answered 411), and a socket timeout on idle connections.

Run::

    python -m clip_finegrained_alignment_tpu_torch.cli.serve \\
        --model ViT-B/16 --port 8000            # on the GPU
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import inherited, quantile, record, span, spans


_batch_ids = itertools.count()
_request_ids = itertools.count()


class _Waiting:
    """One :meth:`DynamicBatcher.submit` call's items in the queue: its
    ``serve.queue`` span is kept once the last of them is taken into a
    group."""

    __slots__ = ("rid", "parent", "thread", "start_ns", "left", "batches")

    def __init__(self, rid, parent: int, items: int):
        self.rid, self.parent, self.left = rid, parent, items
        self.thread = threading.get_ident()
        self.batches: List[int] = []
        self.start_ns = time.time_ns()

    def taken(self, batch: int, now_ns: int) -> None:
        """One item taken into device batch ``batch``."""
        if not self.batches or self.batches[-1] != batch:
            self.batches.append(batch)
        self.left -= 1
        if self.left == 0:
            record("serve.queue", self.start_ns, now_ns, self.parent,
                   self.thread, rid=self.rid, batch=self.batches)


class DynamicBatcher:
    """Coalesces concurrent embed requests into bucket-sized batches.

    Per kind ("image" | "text"), a dispatcher thread drains a queue: it
    waits for the first item, keeps accepting until the bucket fills or
    ``window_ms`` elapses, then dispatches one bucketed forward
    (``CLIPInference.dispatch_*``: upload + enqueued device work) and
    returns to forming the next group; a completion thread waits for the
    results and resolves the client futures, so the upload of batch k+1
    overlaps the compute and download of batch k.

    ``stats`` counts ``items``, ``batches`` and, per tower,
    ``batches_by_kind``. The stages are spans (``utils/logging.py``):
    ``serve.submit`` around each blocking :meth:`submit`, and in it
    ``serve.queue``, from the enqueue to the moment the request's last item
    is taken into a group (attrs ``rid`` and the ``batch`` ids it joined);
    per device batch ``serve.dispatch`` (the stack, the pad, the upload and
    the enqueue; attrs ``id``, ``items``, ``bucket``) and ``serve.device``
    (from the end of the dispatch to the results on the host).
    """

    _PIPELINE_DEPTH = 2  # dispatched-but-unfetched batches per kind

    def __init__(self, inference, *, window_ms: float = 2.0):
        self._inf = inference
        self._window = window_ms / 1000.0
        self._lock = threading.Lock()
        self._queues: Dict[str, List[Tuple[np.ndarray, Future, _Waiting]]] \
            = {"image": [], "text": []}
        self._wakeups = {k: threading.Event() for k in self._queues}
        self._inflight = {k: queue.Queue(maxsize=self._PIPELINE_DEPTH)
                          for k in self._queues}
        self._stop = False
        self.stats = {"items": 0, "batches": 0,
                      "batches_by_kind": {k: 0 for k in self._queues}}
        self.started_ns = time.time_ns()
        self._threads = [
            threading.Thread(target=fn, args=(k,), daemon=True)
            for k in self._queues
            for fn in (self._run_dispatch, self._run_complete)]
        for t in self._threads:
            t.start()

    def submit(self, kind: str, arrays: Sequence[np.ndarray]) -> np.ndarray:
        """Blocking: enqueue ``arrays`` and return stacked embeddings."""
        with span("serve.submit") as sub:
            futures = [Future() for _ in arrays]
            waiting = _Waiting(inherited("rid"), sub.span_id, len(futures))
            with self._lock:
                self._queues[kind].extend(
                    (a, f, waiting) for a, f in zip(arrays, futures))
            self._wakeups[kind].set()
            return np.stack([f.result() for f in futures]) if futures \
                else np.zeros((0,), np.float32)

    def close(self, timeout: float = 5.0):
        """Stop the dispatcher and completion threads and join them."""
        self._stop = True
        for ev in self._wakeups.values():
            ev.set()
        for q in self._inflight.values():
            try:
                q.put(None, timeout=timeout)
            except queue.Full:
                pass
        for t in self._threads:
            t.join(timeout)

    def _run_dispatch(self, kind: str):
        bucket = self._inf.bucket
        dispatch = (self._inf.dispatch_images if kind == "image"
                    else self._inf.dispatch_texts)
        while not self._stop:
            self._wakeups[kind].wait(timeout=0.1)
            with self._lock:
                have = len(self._queues[kind])
            if not have:
                self._wakeups[kind].clear()
                continue
            # Batching window: let concurrent requests pile up (skipped
            # when the bucket is already full).
            deadline = time.monotonic() + self._window
            while have < bucket and time.monotonic() < deadline:
                time.sleep(self._window / 4)
                with self._lock:
                    have = len(self._queues[kind])
            with self._lock:
                group = self._queues[kind][:bucket]
                del self._queues[kind][:bucket]
                if not self._queues[kind]:
                    self._wakeups[kind].clear()
            batch = next(_batch_ids)
            taken = time.time_ns()
            for _, _, waiting in group:
                waiting.taken(batch, taken)
            try:
                with span("serve.dispatch", id=batch, items=len(group),
                          bucket=bucket) as d:
                    handles = dispatch(np.stack([a for a, _, _ in group]))
            except Exception as e:  # resolve, don't hang clients
                for _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            # Blocks when _PIPELINE_DEPTH batches are already in flight.
            self._inflight[kind].put((group, handles, batch, d.end_ns))

    def _run_complete(self, kind: str):
        while True:
            item = self._inflight[kind].get()
            if item is None or self._stop:
                return
            group, handles, batch, dispatched = item
            try:
                out = self._inf.fetch(handles)
            except Exception as e:
                for _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            # Stats first: a client that has its answer sees them counted.
            record("serve.device", dispatched, time.time_ns(), id=batch,
                   items=len(group))
            with self._lock:
                self.stats["items"] += len(group)
                self.stats["batches"] += 1
                self.stats["batches_by_kind"][kind] += len(handles)
            for (_, fut, _), emb in zip(group, out):
                fut.set_result(emb)


class ClipServer:
    """Model + tokenizer + batcher behind the HTTP handler (separable from
    the CLI for tests)."""

    def __init__(self, state_dict, model_cfg, tokenizer, *,
                 model_name: str = "?", bucket: int = 64,
                 window_ms: float = 2.0, dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        from ..models.inference import CLIPInference
        self.cfg = model_cfg
        self.model_name = model_name
        self.tok = tokenizer
        self.inference = CLIPInference(state_dict, model_cfg, dtype=dtype,
                                       batch_bucket=bucket, device=device)
        self.batcher = DynamicBatcher(self.inference, window_ms=window_ms)
        self.logit_scale = self.inference.logit_scale
        self._prompt_cache: Dict[Tuple, np.ndarray] = {}
        self._cache_lock = threading.Lock()

    # ---- request decoding ------------------------------------------------
    def _decode_images(self, payload: dict) -> np.ndarray:
        S = self.cfg.vision.image_size
        if "pixels" in payload:
            arr = np.asarray(payload["pixels"], np.uint8)
            if arr.ndim == 3:
                arr = arr[None]
            if arr.shape[1:] != (S, S, 3):
                raise ValueError(f"pixels must be [N,{S},{S},3] uint8, "
                                 f"got {arr.shape}")
            return arr
        from PIL import Image
        from ..data.preprocess import resize_center_crop
        out = []
        for b64 in payload["images_b64"]:
            raw = base64.b64decode(b64)
            with Image.open(io.BytesIO(raw)) as im:
                rgb = np.asarray(im.convert("RGB"))
            out.append(resize_center_crop(rgb, S))
        return np.stack(out)

    # ---- endpoint logic ----------------------------------------------------
    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        ids = self.tok(list(texts), self.cfg.text.max_position_embeddings)
        return self.batcher.submit("text", np.asarray(ids, np.int32))

    def embed_images(self, payload: dict) -> np.ndarray:
        return self.batcher.submit("image", self._decode_images(payload))

    def embed_images_raw(self, raw: bytes) -> np.ndarray:
        """Binary fast path: raw uint8 [N, S, S, 3] bytes → embeddings."""
        S = self.cfg.vision.image_size
        item = S * S * 3
        if not raw or len(raw) % item:
            raise ValueError(
                f"raw image body must be N*{item} bytes "
                f"(uint8 [N,{S},{S},3]), got {len(raw)}")
        arr = np.frombuffer(raw, np.uint8).reshape(-1, S, S, 3)
        return self.batcher.submit("image", arr)

    def classify(self, payload: dict):
        labels = payload["labels"]
        template = payload.get("template", "a photo of {}")
        key = (template, tuple(labels))
        with self._cache_lock:
            bank = self._prompt_cache.get(key)
        if bank is None:
            bank = self.embed_texts([template.format(l) for l in labels])
            with self._cache_lock:
                if len(self._prompt_cache) >= 256:  # bound the bank cache
                    self._prompt_cache.pop(next(iter(self._prompt_cache)))
                self._prompt_cache[key] = bank
        img = self.embed_images(payload)                    # [N, P]
        logits = self.logit_scale * img @ bank.T            # [N, C]
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        return labels, probs

    def stats(self, since_ns: Optional[int] = None) -> dict:
        """The counters, and the stages' quantiles over the spans that
        started since ``since_ns`` (by default since the batcher started)."""
        s = self.batcher.stats
        since = self.batcher.started_ns if since_ns is None else since_ns

        def q(name, p):
            v = quantile((x.ms for x in spans(name, since)), p)
            return None if v is None else round(v, 2)

        return {
            "model": self.model_name,
            "device": str(self.inference.device),
            "items": s["items"], "batches": s["batches"],
            "batches_by_kind": dict(s["batches_by_kind"]),
            "mean_batch_fill": round(s["items"] / s["batches"], 2)
            if s["batches"] else None,
            "queue_wait_ms_p50": q("serve.queue", 0.5),
            "queue_wait_ms_p95": q("serve.queue", 0.95),
            "dispatch_ms_p50": q("serve.dispatch", 0.5),
            "dispatch_ms_p95": q("serve.dispatch", 0.95),
            "device_batch_ms_p50": q("serve.device", 0.5),
            "device_batch_ms_p95": q("serve.device", 0.95),
        }

    def close(self):
        self.batcher.close()


class _HTTPError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _Handler(BaseHTTPRequestHandler):
    server_version = "cfa-serve-torch/1.0"
    # HTTP/1.1 keep-alive: every response carries an exact Content-Length.
    protocol_version = "HTTP/1.1"
    # An idle or half-open keep-alive client releases its thread after
    # this many seconds (a timed-out read closes the connection).
    timeout = 60
    # set by make_server:
    clip: ClipServer = None  # type: ignore

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def send_response(self, code, message=None):
        self._status = code
        super().send_response(code, message)

    def _reply(self, code: int, obj: dict):
        with span("serve.reply"):
            body = json.dumps(obj).encode()
            self._started = True
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"status": "ok",
                              "model": self.clip.model_name})
        elif self.path == "/stats":
            self._reply(200, self.clip.stats())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _read_body(self) -> bytes:
        """The request body, read in full, or an error for framing this
        server does not read (the caller then closes the connection, so
        that unread body bytes are never parsed as the next request)."""
        if self.headers.get("Transfer-Encoding") is not None:
            raise _HTTPError(411, "Transfer-Encoding is not supported; "
                                  "send a Content-Length")
        length = self.headers.get("Content-Length", "0")
        try:
            n = int(length)
        except ValueError:
            n = -1
        if n < 0:
            raise _HTTPError(400, f"bad Content-Length {length!r}")
        body = self.rfile.read(n)
        if len(body) != n:
            raise _HTTPError(400, f"body ended after {len(body)} of {n} "
                                  "bytes")
        return body

    def do_POST(self):
        """One request inside its ``serve.request`` span (attrs ``rid``,
        ``path``, ``images`` where it carries images, ``status``), from
        entry to the last byte written; ``serve.read`` and ``serve.reply``
        are its body's read and the answer's encoding and write."""
        self._status = None
        with span("serve.request", rid=next(_request_ids),
                  path=self.path) as req:
            try:
                self._post(req)
            finally:
                req.attrs["status"] = self._status

    def _post(self, req: span):
        self._started = False
        body_read = False
        try:
            with span("serve.read"):
                body = self._read_body()
            body_read = True
            if self.path == "/v1/embed/image_raw":
                emb = self.clip.embed_images_raw(body)
                req.attrs["images"] = len(emb)
                with span("serve.reply"):
                    out = np.ascontiguousarray(emb, np.float32).tobytes()
                    self._started = True
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("X-Embed-Shape",
                                     ",".join(map(str, emb.shape)))
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                return
            payload = json.loads(body or b"{}")
            if self.path == "/v1/embed/text":
                emb = self.clip.embed_texts(payload["texts"])
                self._reply(200, {"embeddings": emb.tolist()})
            elif self.path == "/v1/embed/image":
                emb = self.clip.embed_images(payload)
                req.attrs["images"] = len(emb)
                self._reply(200, {"embeddings": emb.tolist()})
            elif self.path == "/v1/classify":
                labels, probs = self.clip.classify(payload)
                req.attrs["images"] = len(probs)
                self._reply(200, {"labels": list(labels),
                                  "probs": probs.tolist()})
            else:
                self._reply(404, {"error": f"no route {self.path}"})
        except Exception as e:  # a bad request must not kill the server
            if self._started:
                # A response line is already on the wire; a second status
                # would corrupt the keep-alive stream. Drop this connection.
                self.close_connection = True
                return
            if not body_read:
                self.close_connection = True
            if isinstance(e, _HTTPError):
                self._reply(e.code, {"error": str(e)})
            else:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    request_queue_size = 128  # bursts of connects queue, not reset
    daemon_threads = True


def make_server(clip: ClipServer, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    handler = type("_BoundHandler", (_Handler,), {"clip": clip})
    return _Server((host, port), handler)


def load_state_dict(args, model_cfg):
    """``--checkpoint`` (a reference ``.pt``, HF or OpenAI names), else
    random weights from ``--seed``."""
    from ..models import convert
    if args.checkpoint:
        sd, _ = convert.load_reference_checkpoint(args.checkpoint, model_cfg)
        print(f"loaded reference checkpoint {args.checkpoint}", flush=True)
        return sd
    print(f"no checkpoint given: RANDOM weights from seed {args.seed}",
          flush=True)
    return convert.state_dict_from_jax(
        convert.random_params(model_cfg, args.seed), model_cfg)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="ViT-B/32")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pt checkpoint in HF CLIPModel naming")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without "
                        "--checkpoint")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--bucket", type=int, default=64,
                   help="device batch size (requests coalesce up to this)")
    p.add_argument("--window-ms", type=float, default=2.0,
                   help="max time a request waits for batch-mates")
    p.add_argument("--bpe-path", default=None)
    args = p.parse_args(argv)

    from ..config import CLIPConfig
    from ..data.tokenizer import load_tokenizer

    model_cfg = CLIPConfig.from_name(args.model)
    tok = load_tokenizer(args.bpe_path)
    clip = ClipServer(load_state_dict(args, model_cfg), model_cfg, tok,
                      model_name=args.model, bucket=args.bucket,
                      window_ms=args.window_ms, device=args.device)
    try:
        # Warm up: builds the CUDA kernel and initializes cuBLAS before the
        # first request.
        S = model_cfg.vision.image_size
        clip.embed_texts(["warmup"])
        clip.embed_images({"pixels": np.zeros((1, S, S, 3), np.uint8)})
        srv = make_server(clip, args.host, args.port)
        print(f"serving {args.model} on {clip.inference.device} at "
              f"http://{args.host}:{srv.server_port} "
              f"(bucket={args.bucket}, window={args.window_ms}ms)",
              flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
    finally:
        clip.close()


if __name__ == "__main__":
    main()

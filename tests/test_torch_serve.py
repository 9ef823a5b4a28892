"""The port's serving path (``clip_finegrained_alignment_tpu_torch/models/
inference.py`` and ``cli/serve.py``) against the JAX package's, on the CPU.

Both servers get the same weights (the JAX tree, through
``state_dict_from_jax``) and the same ``HashTokenizer`` ids, and answer the
same requests on every endpoint. Both serve in bf16; the JAX side runs
with ``CFA_ATTENTION_PROBS_FP32=1`` (the Pallas kernel's and the port's
attention numerics).

Tolerances: port server vs port ``CLIPInference`` 1e-6 (the same
computation); port vs JAX in fp32 (``CLIPInference(dtype=float32)``)
1e-5; port vs JAX servers in bf16 2e-2 on unit embeddings and 2e-2 on
probabilities (bf16 keeps 8 significant bits; the frameworks round at
slightly different points, see ``tests/test_torch_model.py``).
"""

import base64
import io
import json
import socket
import threading
from http.client import HTTPConnection

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.cli.serve import (
    ClipServer as JaxClipServer, make_server as jax_make_server)
from clip_finegrained_alignment_tpu.config import CLIPConfig as JaxCLIPConfig
from clip_finegrained_alignment_tpu.data.tokenizer import \
    HashTokenizer as JaxHashTokenizer
from clip_finegrained_alignment_tpu.models import clip as jm
from clip_finegrained_alignment_tpu.models.inference import (
    CLIPInference as JaxCLIPInference,
    ZeroShotClassifier as JaxZeroShotClassifier)
from clip_finegrained_alignment_tpu_torch.cli.serve import (ClipServer,
                                                            make_server)
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
from clip_finegrained_alignment_tpu_torch.data.tokenizer import HashTokenizer
from clip_finegrained_alignment_tpu_torch.models.convert import \
    state_dict_from_jax
from clip_finegrained_alignment_tpu_torch.models.inference import (
    CLIPInference, ZeroShotClassifier)
from clip_finegrained_alignment_tpu_torch.ops import _build

BF16_TOL = dict(rtol=0, atol=2e-2)


def _tok(cls, cfg):
    t = cfg.text
    return cls(vocab_size=t.vocab_size, bos_token_id=t.bos_token_id,
               eos_token_id=t.eos_token_id, pad_token_id=t.pad_token_id)


@pytest.fixture(scope="module")
def served():
    cfg, jcfg = CLIPConfig.tiny_test(), JaxCLIPConfig.tiny_test()
    params = jm.init_clip_params(jax.random.key(3), jcfg)
    sd = state_dict_from_jax(params, cfg)
    with pytest.MonkeyPatch.context() as mp:
        # Read when the JAX embedders trace, i.e. at their first calls,
        # which all happen inside this fixture's lifetime.
        mp.setenv("CFA_ATTENTION_PROBS_FP32", "1")
        port_clip = ClipServer(sd, cfg, _tok(HashTokenizer, cfg),
                               model_name="tiny", bucket=8, window_ms=20.0,
                               device="cpu")
        jax_clip = JaxClipServer(params, jcfg, _tok(JaxHashTokenizer, jcfg),
                                 model_name="tiny", bucket=8, window_ms=20.0)
        servers = [make_server(port_clip), jax_make_server(jax_clip)]
        for s in servers:
            threading.Thread(target=s.serve_forever, daemon=True).start()
        yield {"cfg": cfg, "jcfg": jcfg, "params": params, "sd": sd,
               "clip": port_clip, "port": servers[0].server_port,
               "jax_port": servers[1].server_port}
        for s in servers:
            s.shutdown()
            s.server_close()
        port_clip.close()
        jax_clip.batcher.close()


def _post(port, path, payload):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _both(served, path, payload):
    s1, ours = _post(served["port"], path, payload)
    s2, ref = _post(served["jax_port"], path, payload)
    assert s1 == s2 == 200, (ours, ref)
    return ours, ref


def _pixels(served, n, seed):
    S = served["cfg"].vision.image_size
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, S, S, 3)).astype(np.uint8)


def test_embed_text_matches_jax_server(served):
    texts = ["three cats", "a photo of seven dogs", "one"]
    ours, ref = _both(served, "/v1/embed/text", {"texts": texts})
    got = np.asarray(ours["embeddings"], np.float32)
    assert got.shape == (3, served["cfg"].projection_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref["embeddings"]),
                               **BF16_TOL)
    cfg = served["cfg"]
    direct = served["clip"].inference.embed_texts(np.asarray(
        _tok(HashTokenizer, cfg)(texts, cfg.text.max_position_embeddings)))
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-6)


def test_embed_image_pixels_matches_jax_server(served):
    pix = _pixels(served, 3, seed=0)
    ours, ref = _both(served, "/v1/embed/image", {"pixels": pix.tolist()})
    got = np.asarray(ours["embeddings"], np.float32)
    np.testing.assert_allclose(got, np.asarray(ref["embeddings"]),
                               **BF16_TOL)
    direct = served["clip"].inference.embed_images(pix)
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-6)


def test_embed_image_b64_matches_jax_server(served):
    from PIL import Image
    raw = np.random.default_rng(1).integers(
        0, 256, size=(48, 64, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(raw).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    ours, ref = _both(served, "/v1/embed/image", {"images_b64": [b64]})
    np.testing.assert_allclose(np.asarray(ours["embeddings"]),
                               np.asarray(ref["embeddings"]), **BF16_TOL)


def test_embed_image_raw_matches_jax_server(served):
    pix = _pixels(served, 3, seed=2)
    out = []
    for port in (served["port"], served["jax_port"]):
        conn = HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/embed/image_raw", pix.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200
        shape = tuple(int(x) for x in
                      resp.getheader("X-Embed-Shape").split(","))
        out.append(np.frombuffer(body, np.float32).reshape(shape))
        conn.close()
    assert out[0].shape == (3, served["cfg"].projection_dim)
    np.testing.assert_allclose(out[0], out[1], **BF16_TOL)


def test_classify_matches_jax_server(served):
    payload = {"pixels": _pixels(served, 2, seed=3).tolist(),
               "labels": ["one cat", "two cats", "three cats"]}
    ours, ref = _both(served, "/v1/classify", payload)
    assert ours["labels"] == payload["labels"]
    probs = np.asarray(ours["probs"])
    assert probs.shape == (2, 3)
    np.testing.assert_allclose(probs.sum(axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(probs, np.asarray(ref["probs"]), **BF16_TOL)
    # the second call is served from the prompt-bank cache
    _, again = _post(served["port"], "/v1/classify", payload)
    np.testing.assert_allclose(np.asarray(again["probs"]), probs, atol=1e-6)
    assert ("a photo of {}", tuple(payload["labels"])) \
        in served["clip"]._prompt_cache


def test_healthz_stats_and_errors(served):
    port = served["port"]
    conn = HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200 and json.loads(resp.read())["model"] == "tiny"
    conn.request("GET", "/stats")      # same connection: keep-alive
    resp = conn.getresponse()
    stats = json.loads(resp.read())
    assert resp.status == 200 and stats["device"] == "cpu"
    assert set(stats["batches_by_kind"]) == {"image", "text"}
    conn.request("GET", "/nope")
    resp = conn.getresponse()
    resp.read()
    assert resp.status == 404
    conn.close()
    status, body = _post(port, "/v1/embed/text", {"wrong": 1})
    assert status == 400 and "error" in body
    status, body = _post(port, "/v1/embed/image_raw", {"not": "pixels"})
    assert status == 400 and "error" in body


def test_concurrent_requests_coalesce(served):
    clip, port, cfg = served["clip"], served["port"], served["cfg"]
    before = dict(clip.batcher.stats)
    results = {}

    def worker(i):
        results[i] = _post(port, "/v1/embed/text",
                           {"texts": [f"sample {i}"]})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(s == 200 for s, _ in results.values())
    items = clip.batcher.stats["items"] - before["items"]
    batches = clip.batcher.stats["batches"] - before["batches"]
    assert items == 8 and batches < items, (items, batches)
    direct = clip.inference.embed_texts(np.asarray(_tok(HashTokenizer, cfg)(
        [f"sample {i}" for i in range(8)], cfg.text.max_position_embeddings)))
    for i in range(8):
        np.testing.assert_allclose(
            np.asarray(results[i][1]["embeddings"][0]), direct[i],
            rtol=0, atol=1e-6)


def _raw_exchange(port, request: bytes) -> bytes:
    """Send raw bytes; read until the server closes (or 10 s pass)."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(request)
        chunks = []
        while True:
            data = s.recv(65536)
            if not data:
                return b"".join(chunks)
            chunks.append(data)


def test_chunked_body_gets_411_and_a_closed_connection(served):
    body = b'{"texts": ["a"]}'
    req = (b"POST /v1/embed/text HTTP/1.1\r\nHost: x\r\n"
           b"Transfer-Encoding: chunked\r\n\r\n"
           + f"{len(body):x}\r\n".encode() + body + b"\r\n0\r\n\r\n")
    reply = _raw_exchange(served["port"], req)   # returns only on close
    assert reply.startswith(b"HTTP/1.1 411")
    assert reply.count(b"HTTP/1.1") == 1         # the body was not parsed
    assert b"Connection: close" in reply


def test_bad_content_length_gets_400_and_a_closed_connection(served):
    req = (b"POST /v1/embed/text HTTP/1.1\r\nHost: x\r\n"
           b"Content-Length: abc\r\n\r\n"
           b'{"texts": ["a"]}')
    reply = _raw_exchange(served["port"], req)
    assert reply.startswith(b"HTTP/1.1 400")
    assert reply.count(b"HTTP/1.1") == 1


def test_handler_has_a_socket_timeout(served):
    srv = make_server(served["clip"])
    try:
        assert 0 < srv.RequestHandlerClass.timeout <= 300
    finally:
        srv.server_close()


def test_inference_fp32_matches_jax_with_bucket_padding(served):
    """N=11 over bucket 4: two full buckets and a padded one."""
    cfg, jcfg, params, sd = (served[k] for k in ("cfg", "jcfg", "params",
                                                 "sd"))
    ours = CLIPInference(sd, cfg, dtype=torch.float32, batch_bucket=4,
                         device="cpu")
    ref = JaxCLIPInference(params, jcfg, dtype=jnp.float32, batch_bucket=4)
    pix = _pixels(served, 11, seed=4)
    ids = np.asarray(_tok(HashTokenizer, cfg)(
        [f"caption {i}" for i in range(11)],
        cfg.text.max_position_embeddings))
    _build.reset_launch_counts()
    np.testing.assert_allclose(ours.embed_images(pix), ref.embed_images(pix),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours.embed_texts(ids), ref.embed_texts(ids),
                               rtol=0, atol=1e-5)
    assert _build.launch_counts()["attention_fwd"] == 0
    assert ours.logit_scale == pytest.approx(
        float(np.exp(float(np.asarray(params["logit_scale"])))), rel=1e-12)


def test_zero_shot_classifier_matches_jax(served):
    cfg, jcfg, params, sd = (served[k] for k in ("cfg", "jcfg", "params",
                                                 "sd"))
    prompts = ["a photo of one cat", "a photo of two cats", "a dog"]
    ours = ZeroShotClassifier(
        CLIPInference(sd, cfg, dtype=torch.float32, batch_bucket=4,
                      device="cpu"), prompts, _tok(HashTokenizer, cfg))
    ref = JaxZeroShotClassifier(
        JaxCLIPInference(params, jcfg, dtype=jnp.float32, batch_bucket=4),
        prompts, _tok(JaxHashTokenizer, jcfg))
    pix = _pixels(served, 3, seed=5)
    idx, probs = ours.predict(pix)
    ridx, rprobs = ref.predict(pix)
    np.testing.assert_allclose(probs, rprobs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(idx, ridx)


def test_cuda_request_raises_without_a_card(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        CLIPInference(served["sd"], served["cfg"], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ClipServer(served["sd"], served["cfg"],
                   _tok(HashTokenizer, served["cfg"]))


def test_close_stops_the_batcher_threads(served):
    clip = ClipServer(served["sd"], served["cfg"],
                      _tok(HashTokenizer, served["cfg"]), bucket=4,
                      device="cpu")
    assert clip.embed_texts(["a cat"]).shape == (1, served["cfg"]
                                                 .projection_dim)
    clip.close()
    assert not any(t.is_alive() for t in clip.batcher._threads)

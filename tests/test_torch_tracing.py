"""The port's spans and counters (``clip_finegrained_alignment_tpu_torch/
utils/logging.py``), the spans the train step and the server keep, and the
benchmark's per-layer readers of them (``port_bench/metrics/``,
``port_bench/program_spans.py``), on the CPU.

The readers are fed synthetic slices: busy intervals and spans recorded
into fresh rings, each reading computed by hand in the test.
"""

import threading
from http.client import HTTPConnection

import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu_torch.utils import logging as tlog

MS = 1_000_000          # ns


@pytest.fixture
def rings(monkeypatch):
    """Fresh rings, so that a test reads only its own spans."""
    monkeypatch.setattr(tlog, "_rings", {})
    return tlog._rings


def test_span_nesting_and_parent_ids(rings):
    with tlog.span("outer", n=1) as outer:
        with tlog.span("inner", micro=0) as inner:
            assert tlog.inherited("n") == 1
            assert tlog.inherited("micro") == 0
            assert tlog.inherited("none", "x") == "x"
        with tlog.span("inner", micro=1):
            pass
    assert tlog._local.stack == []
    (o,) = tlog.spans("outer")
    i0, i1 = tlog.spans("inner")
    assert o.parent_id is None and o.attrs == {"n": 1}
    assert i0.parent_id == i1.parent_id == o.span_id == outer.span_id
    assert i0.span_id == inner.span_id and i0.attrs == {"micro": 0}
    assert o.start_ns <= i0.start_ns <= i0.end_ns <= i1.start_ns \
        <= i1.end_ns <= o.end_ns
    assert o.thread == i0.thread == threading.get_ident()
    assert i0.ms == (i0.end_ns - i0.start_ns) / 1e6


def test_a_span_left_by_an_exception_is_kept(rings):
    with pytest.raises(ValueError):
        with tlog.span("failing"):
            raise ValueError("x")
    assert len(tlog.spans("failing")) == 1 and tlog._local.stack == []


def test_stacks_are_per_thread(rings):
    """A span opened on another thread while one is open here has no
    parent: each thread nests its own spans."""
    opened, release = threading.Event(), threading.Event()
    ids = {}

    def other():
        with tlog.span("b.outer") as b:
            ids["b"] = b.span_id
            opened.set()
            release.wait(10)
            with tlog.span("b.inner"):
                pass

    with tlog.span("a.outer") as a:
        t = threading.Thread(target=other)
        t.start()
        assert opened.wait(10)
        with tlog.span("a.inner"):
            release.set()
            t.join(10)
    (bo,), (bi,) = tlog.spans("b.outer"), tlog.spans("b.inner")
    (ai,) = tlog.spans("a.inner")
    assert bo.parent_id is None and bi.parent_id == ids["b"]
    assert ai.parent_id == a.span_id
    assert bo.thread == bi.thread != ai.thread


def test_ring_keeps_the_last_records(rings):
    for i in range(tlog.RING + 10):
        tlog.record("many", i, i + 1, i=i)
    got = tlog.spans("many")
    assert len(got) == tlog.RING
    assert got[0].attrs == {"i": 10} and got[-1].attrs == {"i": tlog.RING + 9}


def test_record_and_window(rings):
    ids = [tlog.record("w", t * MS, t * MS + 5, parent_id=7, thread=3, k=t)
           for t in (1, 2, 3, 4)]
    assert len(set(ids)) == 4
    got = tlog.spans("w", since_ns=2 * MS, until_ns=4 * MS)
    assert [s.attrs["k"] for s in got] == [2, 3]
    assert all(s.parent_id == 7 and s.thread == 3 for s in got)
    assert [s.attrs["k"] for s in tlog.spans("w", since_ns=3 * MS)] == [3, 4]
    assert tlog.spans("never") == []


@pytest.mark.parametrize("values,q,want", [
    ([], 0.5, None), ([4.0], 0.95, 4.0), ([3.0, 1.0, 2.0], 0.5, 2.0),
    (list(range(101)), 0.95, 95), (list(range(10)), 0.95, 8)])
def test_quantile(values, q, want):
    assert tlog.quantile(values, q) == want


def test_counter_and_spans_under_threads(rings):
    """More threads than cores, switching often: no count, span or id is
    lost."""
    import os
    import sys
    c = tlog.Counter()
    n_threads = 2 * (os.cpu_count() or 4)

    def work(k):
        for i in range(2000):
            c.add()
            with tlog.span("stress", k=k):
                with tlog.span("stress.inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value == n_threads * 2000
    outer, inner = tlog.spans("stress"), tlog.spans("stress.inner")
    assert len(outer) == len(inner) == n_threads * 2000
    assert len({s.span_id for s in outer + inner}) == 2 * len(outer)
    by_id = {s.span_id: s for s in outer}
    assert all(by_id[s.parent_id].thread == s.thread for s in inner)
    c.reset()
    assert c.value == 0


def test_launch_counters_are_counters():
    from clip_finegrained_alignment_tpu_torch.ops import _build
    assert all(isinstance(c, tlog.Counter) for c in _build.LAUNCHES.values())
    _build.reset_launch_counts()
    _build.LAUNCHES["sparc_fwd"].add()
    assert _build.launch_counts()["sparc_fwd"] == 1
    _build.reset_launch_counts()
    assert not any(_build.launch_counts().values())


def test_spans_share_the_profilers_clock(rings):
    """Under a CPU profiler each span is a profiler range of its name, and
    its ends lie within 1 ms of the range's event; with none running it
    opens no range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with tlog.span("tracing.idle") as idle:
        pass
    assert idle._range is None
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    for i in range(3):
        with tlog.span("tracing.clock") as s:
            assert s._range is not None
            torch.ones(64).sum()
    prof.stop()
    events = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "tracing.clock"
                    and e.device_type() == DeviceType.CPU)
    got = tlog.spans("tracing.clock")
    assert len(events) == len(got) == 3
    for (a, b), s in zip(events, got):
        assert abs(s.start_ns - a) < MS and abs(s.end_ns - b) < MS


def test_spans_across_a_profilers_start_and_stop(rings):
    """A span open when a profiler starts, or still open when it stops,
    ends cleanly (the server's threads keep spans open across the
    benchmark's profiled slices)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU])
    with tlog.span("tracing.before"):
        prof.start()
        with tlog.span("tracing.during") as s:
            assert s._range is not None
    with tlog.span("tracing.after") as s:
        prof.stop()
    assert s._range is not None
    assert [len(tlog.spans(n)) for n in (
        "tracing.before", "tracing.during", "tracing.after")] == [1, 1, 1]


GIL_PROBE = """
import sys, threading, time
from torch.profiler import ProfilerActivity, profile
from clip_finegrained_alignment_tpu_torch.utils import logging as tlog
stop = threading.Event()
def spin():
    while not stop.is_set():
        pass
busy = threading.Thread(target=spin)
sys.setswitchinterval(0.05)        # a hand-off of the GIL costs up to 50 ms
prof = profile(activities=[ProfilerActivity.CPU])
prof.start()
busy.start()
t = time.perf_counter()
for _ in range(200):
    with tlog.span("tracing.gil") as s:
        assert s._range is not None
print(time.perf_counter() - t)
stop.set()
busy.join(10)
prof.stop()
"""


def test_a_span_under_a_profiler_keeps_the_gil():
    """Beside a thread that never waits, 200 spans under a profiler take
    a few forced switches at most: no call in them hands the GIL to the
    busy thread (``record_function``'s operator calls do, twice a span:
    7-11 s on a CPU host, against 0.002-0.1 s). In a process of its own:
    this one has imported JAX, whose threads change how the GIL passes."""
    import subprocess
    import sys
    from pathlib import Path
    out = subprocess.run([sys.executable, "-c", GIL_PROBE], text=True,
                         capture_output=True, timeout=300, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    seconds = float(out.stdout.split()[-1])
    assert seconds < 0.4, seconds


# ---- the train step -------------------------------------------------------

ACCUM, B = 2, 4


def test_train_step_spans(rings):
    from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                             TrainConfig)
    from clip_finegrained_alignment_tpu_torch.models import clip as tm
    from clip_finegrained_alignment_tpu_torch.models.convert import (
        random_params, state_dict_from_jax)
    from clip_finegrained_alignment_tpu_torch.optim.factory import \
        make_optimizer
    from clip_finegrained_alignment_tpu_torch.train.engine import \
        make_train_step
    cfg = CLIPConfig.tiny_test()
    tcfg = TrainConfig(batch_size=B, gradient_accumulation_steps=ACCUM,
                       use_amp=False, loss_type="sparc",
                       optimizer_type="adamspd")
    model = tm.build_train_model(
        cfg, state_dict_from_jax(random_params(cfg, 0), cfg), device="cpu")
    step = make_train_step(tcfg, cfg, model,
                           make_optimizer(tcfg, model.named_parameters()))
    rng = np.random.default_rng(0)
    S, T = cfg.vision.image_size, cfg.text.max_position_embeddings
    for _ in range(2):
        ids = rng.integers(1, cfg.text.bos_token_id - 1,
                           size=(ACCUM, B, T)).astype(np.int32)
        ids[..., -1] = cfg.text.eos_token_id
        step({"pixel_values": rng.integers(0, 256, (ACCUM, B, S, S, 3),
                                           dtype=np.uint8),
              "input_ids": ids})
    steps = tlog.spans("train.step")
    assert [s.attrs["n"] for s in steps] == [0, 1]
    for st in steps:
        def inside(name, parent=st.span_id):
            got = [s for s in tlog.spans(name) if s.parent_id == parent]
            assert all(st.start_ns <= s.start_ns <= s.end_ns <= st.end_ns
                       for s in got)
            return got
        assert [s.attrs["micro"] for s in inside("train.forward")] \
            == list(range(ACCUM))
        assert [s.attrs["micro"] for s in inside("train.backward")] \
            == list(range(ACCUM))
        assert len(inside("train.grad_mean")) == 1
        (opt,) = inside("train.optimizer")
        (clip,) = inside("train.clip", opt.span_id)
        (update,) = inside("train.update", opt.span_id)
        assert opt.start_ns <= clip.start_ns <= clip.end_ns \
            <= update.start_ns <= update.end_ns <= opt.end_ns


# ---- the server ------------------------------------------------------------

def test_served_request_spans(rings):
    from clip_finegrained_alignment_tpu_torch.cli.serve import (ClipServer,
                                                                make_server)
    from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
    from clip_finegrained_alignment_tpu_torch.models.convert import (
        random_params, state_dict_from_jax)
    cfg = CLIPConfig.tiny_test()
    clip = ClipServer(state_dict_from_jax(random_params(cfg, 1), cfg), cfg,
                      None, model_name="tiny", bucket=2, window_ms=5.0,
                      device="cpu")
    srv = make_server(clip)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    S = cfg.vision.image_size
    try:
        body = np.random.default_rng(0).integers(
            0, 256, (3, S, S, 3), dtype=np.uint8).tobytes()
        conn = HTTPConnection("127.0.0.1", srv.server_port, timeout=60)
        conn.request("POST", "/v1/embed/image_raw", body,
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        conn.close()
        stats = clip.stats()
    finally:
        srv.shutdown()
        srv.server_close()
        clip.close()
        thread.join(10)
    (req,) = tlog.spans("serve.request")
    rid = req.attrs["rid"]
    assert req.attrs == {"rid": rid, "path": "/v1/embed/image_raw",
                         "images": 3, "status": 200}
    (read,), (sub,), (reply,) = (tlog.spans(n) for n in (
        "serve.read", "serve.submit", "serve.reply"))
    assert read.parent_id == sub.parent_id == reply.parent_id == req.span_id
    (queue,) = tlog.spans("serve.queue")
    assert queue.parent_id == sub.span_id and queue.attrs["rid"] == rid
    assert queue.thread == sub.thread
    assert sub.start_ns <= queue.start_ns <= queue.end_ns <= sub.end_ns
    batches = queue.attrs["batch"]
    assert len(batches) == 2            # 3 images, bucket 2
    dispatch = {s.attrs["id"]: s for s in tlog.spans("serve.dispatch")}
    device = {s.attrs["id"]: s for s in tlog.spans("serve.device")}
    for b in batches:
        assert dispatch[b].attrs["bucket"] == 2
        assert dispatch[b].end_ns == device[b].start_ns <= device[b].end_ns
    assert sum(dispatch[b].attrs["items"] for b in batches) == 3
    assert req.start_ns <= read.start_ns <= sub.start_ns <= reply.start_ns \
        <= reply.end_ns <= req.end_ns
    assert all(isinstance(stats[f"{k}_ms_{q}"], float)
               for k in ("queue_wait", "dispatch", "device_batch")
               for q in ("p50", "p95"))


# ---- the per-layer readers ---------------------------------------------------

def _readers():
    from port_bench import spec
    return spec.metric_readers()


def _train_ctx(units=2, busy=((10, 20), (25, 40), (50, 60))):
    """Two traced steps inside busy intervals, the window's last step
    before them and the host-op slice's step after them."""
    step = {}
    for n, (a, b) in enumerate([(1, 8), (9, 30), (31, 61), (62, 70)]):
        step[n] = tlog.record("train.step", a * MS, b * MS, n=n)
    for parent, name, a, b in [
            (1, "train.forward", 9.5, 12), (1, "train.forward", 14, 16),
            (2, "train.forward", 31.5, 33), (2, "train.forward", 35, 36),
            (1, "train.backward", 12, 13), (2, "train.backward", 33, 35),
            (1, "train.optimizer", 22, 29), (2, "train.optimizer", 45, 55),
            (0, "train.optimizer", 2, 7), (3, "train.optimizer", 63, 69),
            (3, "train.forward", 62.5, 63)]:
        tlog.record(name, int(a * MS), int(b * MS), parent_id=step[parent])
    return {"kind": "train", "units": units,
            "trace": {"busy": [(a * MS, b * MS) for a, b in busy]}}


def _serve_ctx(busy=((100, 150), (160, 200))):
    for a, d in [(90, 3), (100, 10), (150, 30), (199, 5), (200, 8)]:
        tlog.record("serve.queue", a * MS, (a + d) * MS)
    for a, d in [(50, 9), (110, 2), (120, 5), (130, 1)]:
        tlog.record("serve.dispatch", a * MS, (a + d) * MS)
    for a, b, sub in [(50, 60, None), (100, 150, (105, 140)),
                      (120, 130, (121, 129)), (160, 170, None)]:
        rid = tlog.record("serve.request", a * MS, b * MS)
        if sub:
            tlog.record("serve.submit", sub[0] * MS, sub[1] * MS, rid)
    return {"kind": "serve", "trace": {"busy": [(a * MS, b * MS)
                                                for a, b in busy]}}


# Hand-computed: forward (2.5 + 2 + 1.5 + 1) / 2 steps; backward (1 + 2) / 2;
# optimizer (7 + 10) / 2; its idle: [22, 29] minus busy [25, 29] is 3 ms,
# [45, 55] minus [50, 55] is 5 ms, over 2 steps; queue waits 10, 30, 5 ms
# start in the slice (nearest-rank p95: 30); dispatches 2, 5, 1 (median 2);
# requests' own ms 50 − 35, 10 − 8, 10 (p95: 15).
READINGS = [("forward_host_ms.train", 3.5), ("backward_host_ms.train", 1.5),
            ("optimizer_host_ms.train", 8.5),
            ("optimizer_idle_ms.train", 4.0),
            ("queue_wait_p95_ms.serve", 30.0), ("dispatch_ms.serve", 2.0),
            ("http_p95_ms.serve", 15.0)]


@pytest.mark.parametrize("name,want", READINGS)
def test_reader_on_a_synthetic_slice(rings, name, want):
    read, unit = _readers()[name]
    assert unit == "ms"
    train = name.endswith(".train")
    ctx = _train_ctx() if train else _serve_ctx()
    assert read(ctx) == pytest.approx(want, abs=1e-9)
    assert read({**ctx, "kind": "serve" if train else "train"}) is None


@pytest.mark.parametrize("name", [n for n, _ in READINGS])
def test_reader_finds_nothing(rings, monkeypatch, name):
    """None on an empty slice (a CPU run), on a count of steps other than
    the slice's, and for a port that keeps no spans."""
    from port_bench import program_spans
    read, _ = _readers()[name]
    train = name.endswith(".train")
    assert read(_train_ctx(busy=()) if train else _serve_ctx(busy=())) is None
    tlog._rings.clear()
    ctx = _train_ctx(units=3) if train else _serve_ctx()
    if train:
        assert read(ctx) is None
    monkeypatch.setattr(program_spans, "_reader", lambda: None)
    assert read(_train_ctx() if train else ctx) is None

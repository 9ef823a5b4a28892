"""The port's measuring tools (``clip_finegrained_alignment_tpu_torch/perf/``:
``bench.py``, ``serve_bench.py``, ``serve_http_bench.py``,
``sparc_microbench.py``, ``profile_step.py``, ``trace_report.py``) on the
CPU at the tiny config, against the JAX side:

* ``perf/bench.py``: its batch equals the arrays ``bench.py`` draws (read
  from ``bench.py``'s own ``main`` through a stand-in step), its regime,
  metric names and model FLOPs equal ``bench.py``'s (every model × loss;
  the FLOPs against the JAX ``utils/flops.py`` unrounded), and its first
  step's ``total_loss`` from the same numpy weights equals JAX's
  ``make_train_step`` in fp32 (rtol 2e-5, the train tests' tolerance);
* ``serve_bench``'s embeddings equal JAX's ``CLIPInference`` on the same
  weights and inputs (fp32, atol 1e-5), its metric names
  ``perf/serve_bench.py``'s;
* both ``sparc_microbench`` paths equal JAX's ``_reference_chain`` in
  values and gradients (atol 1e-5);
* ``serve_http_bench`` answers every request of 2 clients × 2 with 200;
* ``trace_report`` classifies kernel names, the rows of a profiler, and a
  Chrome trace written by ``utils/logging.py::trace_capture``, and reads
  only a file (live windows are ``profile_step``'s);
* every other tool's default device (the card) raises here.

``pp_activation_report`` runs on two gloo ranks inside the two-rank spawn
of ``tests/test_torch_model_parallel.py``.
"""

import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.models.inference import \
    CLIPInference as JaxCLIPInference
from clip_finegrained_alignment_tpu.ops.sparc_kernel import _reference_chain
from clip_finegrained_alignment_tpu.optim.factory import \
    make_optimizer as jax_make_optimizer
from clip_finegrained_alignment_tpu.train.engine import \
    make_train_step as jax_make_train_step
from clip_finegrained_alignment_tpu.utils import flops as jax_flops
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.models.inference import \
    CLIPInference
from clip_finegrained_alignment_tpu_torch.perf import (
    bench, pp_activation_report, profile_step, serve_bench, serve_http_bench,
    sparc_microbench, trace_report)
from clip_finegrained_alignment_tpu_torch.utils.logging import trace_capture

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MODELS = ["ViT-B/32", "ViT-B/16", "ViT-L/14", "ViT-L/14@336", "tiny"]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Stop(Exception):
    pass


def _jax_bench(monkeypatch, capsys, model, loss, argv, accum=None,
               stop_at_step=False):
    """``bench.py``'s ``main`` with a stand-in for ``make_train_step``:
    returns (the TrainConfig it was given, the batch its step saw, the
    JSON line it printed). The weights are the tiny config's (the stand-in
    step never reads them)."""
    from clip_finegrained_alignment_tpu.models import clip as jm
    from clip_finegrained_alignment_tpu.train import engine
    seen = {}

    def make_train_step(cfg, model_cfg, opt, mesh=None):
        seen["cfg"] = cfg
        if stop_at_step:
            raise _Stop

        def step(params, opt_state, batch):
            seen.setdefault("batch", {k: np.asarray(x)
                                      for k, x in batch.items()})
            return params, opt_state, {"total_loss": jnp.float32(1.0)}
        return step

    init = jm.init_clip_params
    monkeypatch.setattr(engine, "make_train_step", make_train_step)
    monkeypatch.setattr(jm, "init_clip_params", lambda key, cfg: init(
        key, JaxCLIPConfig.tiny_test()))
    monkeypatch.setenv("CFA_COMPILE_CACHE", "0")
    monkeypatch.setenv("BENCH_MODEL", model)
    monkeypatch.setenv("BENCH_LOSS", loss)
    if accum is None:
        monkeypatch.delenv("BENCH_ACCUM", raising=False)
    else:
        monkeypatch.setenv("BENCH_ACCUM", str(accum))
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    jax_bench = _load(ROOT / "bench.py", "jax_bench")
    capsys.readouterr()
    try:
        jax_bench.main()
    except _Stop:
        return seen["cfg"], None, None
    return seen["cfg"], seen["batch"], json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("loss", ["sparc", "count"])
def test_bench_batch_is_bench_py_draws(monkeypatch, capsys, loss):
    _, want, _ = _jax_bench(monkeypatch, capsys, "tiny", loss, ["4", "1"],
                            accum=2)
    got = bench.bench_batch(CLIPConfig.tiny_test(), 2, 4, loss)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("loss", ["sparc", "count"])
def test_bench_regime_metric_and_flops_are_bench_py(monkeypatch, capsys,
                                                    model, loss):
    cfg, _, _ = _jax_bench(monkeypatch, capsys, model, loss, [],
                           stop_at_step=True)
    B, accum = bench.regime(model, loss)
    assert (B, accum) == (cfg.batch_size, cfg.gradient_accumulation_steps)
    _, _, want = _jax_bench(monkeypatch, capsys, model, loss, ["1", "1"],
                            accum=1)
    pcfg, jcfg = CLIPConfig.from_name(model), JaxCLIPConfig.from_name(model)
    line = bench.result_line(model, loss, pcfg, B * accum, 3, 1.5, CPU)
    assert line["metric"] == want["metric"]
    assert set(want) - set(line) == ({"reference_model_vitb32"} if (
        model, loss) == ("ViT-B/16", "sparc") else set())
    jax_count = (jax_flops.count_train_step_flops if loss == "count"
                 else jax_flops.sparc_train_step_flops)
    assert line["tflops_per_step"] * 1e12 == pytest.approx(
        jax_count(jcfg, B * accum), rel=1e-12)
    assert line["gflops_per_pair"] * 1e9 * B * accum == pytest.approx(
        jax_count(jcfg, B * accum), rel=1e-12)
    # One pair a step, as bench.py was run here: its rounded TFLOPs.
    assert round(bench.step_flops(pcfg, loss, 1) / 1e12, 3) == \
        want["tflops_per_step"]
    assert line["value"] == B * accum * 3 / 1.5
    assert line["mfu"] is None and line["vs_baseline"] is None
    assert line["device"] == "cpu" and line["gpu"] is None


@pytest.mark.parametrize("loss", ["sparc", "count"])
def test_bench_first_step_loss_matches_jax(loss):
    B, accum = 4, 2
    b = bench.build("tiny", loss, B, accum, "none", CPU, use_amp=False)
    got = b["step"](b["batch"])["total_loss"].item()
    params = random_params(CLIPConfig.tiny_test(), 0)
    jcfg = JaxTrainConfig(clip_model="tiny", loss_type=loss,
                          optimizer_type="adamspd", inverse_temperature=0.07,
                          batch_size=B, gradient_accumulation_steps=accum,
                          use_amp=False, remat=False)
    jp = jax.tree.map(jnp.array, params)
    jopt = jax_make_optimizer(jcfg, jp,
                              anchor_params=jax.tree.map(jnp.array, params))
    jstep = jax_make_train_step(jcfg, JaxCLIPConfig.tiny_test(), jopt,
                                mesh=None)
    batch = bench.bench_batch(CLIPConfig.tiny_test(), accum, B, loss)
    _, _, jm = jstep(jp, jopt.init(jp),
                     {k: jnp.asarray(x) for k, x in batch.items()})
    np.testing.assert_allclose(got, float(jm["total_loss"]), rtol=2e-5)


def test_bench_main_on_the_cpu(monkeypatch):
    monkeypatch.setenv("BENCH_MODEL", "tiny")
    monkeypatch.setenv("BENCH_ACCUM", "2")
    line = bench.main(["2", "2", "--device", "cpu"])
    assert line["metric"] == "sparc_spd_finetune_throughput_tiny"
    assert line["steps"] == 2 and line["device"] == "cpu"
    assert line["value"] > 0 and line["step_ms"] > 0
    assert line["mfu"] is None and line["peak_memory_gb"] is None
    assert line["tflops_per_step"] * 1e12 == pytest.approx(
        bench.step_flops(CLIPConfig.tiny_test(), "sparc", 4))


def test_serve_bench_embeddings_match_jax(monkeypatch, capsys):
    cfg, B = CLIPConfig.tiny_test(), 4
    params = random_params(cfg, 0)
    px, ids = serve_bench.inputs(cfg, B)
    inf = CLIPInference(state_dict_from_jax(params, cfg), cfg,
                        dtype=torch.float32, batch_bucket=B, device="cpu")
    lines, got = serve_bench.measure(inf, torch.from_numpy(px),
                                     torch.from_numpy(ids), 1, "tiny")
    jinf = JaxCLIPInference(jax.tree.map(jnp.asarray, params),
                            JaxCLIPConfig.tiny_test(), dtype=jnp.float32,
                            batch_bucket=B)
    for name, fn, x in (("image", jinf._embed_images, px),
                        ("text", jinf._embed_texts, ids)):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(fn(jinf.params, x)),
                                   atol=1e-5, err_msg=name)
    # perf/serve_bench.py's own lines at the same model and batch.
    monkeypatch.setattr(sys, "argv", ["serve_bench.py", "tiny", str(B), "1"])
    capsys.readouterr()
    _load(ROOT / "perf" / "serve_bench.py", "jax_serve_bench").main()
    want = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    for g, w in zip(lines, want):
        assert set(w) <= set(g)
        assert {k: g[k] for k in ("metric", "unit", "batch")} == \
            {k: w[k] for k in ("metric", "unit", "batch")}
        assert g["device"] == "cpu" and g["model_tflops_per_s"] is None


def test_sparc_microbench_paths_match_reference_chain():
    v, l, mask = sparc_microbench.inputs(2)
    want = _reference_chain(jnp.asarray(v), jnp.asarray(l), jnp.asarray(mask),
                            sparc_microbench.THRESHOLD)
    jdv, jdl = jax.grad(lambda a, b: _reference_chain(
        a, b, jnp.asarray(mask), sparc_microbench.THRESHOLD).sum(),
        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(l))
    tv, tl, tm = (torch.from_numpy(x) for x in (v, l, mask))
    for name, fn in sparc_microbench.paths(tm).items():
        np.testing.assert_allclose(fn(tv, tl).detach().numpy(),
                                   np.asarray(want), atol=1e-5, err_msg=name)
        (out,) = sparc_microbench.modes(fn)["fwd"](tv, tl)
        np.testing.assert_allclose(out.item(), float(want.sum()), rtol=1e-5)
        dv, dl = sparc_microbench.modes(fn)["fwd+bwd"](tv, tl)
        np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=1e-5,
                                   err_msg=f"{name} dv")
        np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), atol=1e-5,
                                   err_msg=f"{name} dl")


def test_sparc_microbench_main_lines():
    lines = sparc_microbench.main(["2", "1", "--device", "cpu"])
    assert [(r["path"], r["mode"]) for r in lines] == [
        ("kernel", "fwd"), ("kernel", "fwd+bwd"), ("plain", "fwd"),
        ("plain", "fwd+bwd")]
    for r in lines:
        assert {"op", "path", "mode", "batch", "ms", "pairs_per_sec"} <= \
            set(r)
        assert r["batch"] == 2 and r["device"] == "cpu" and r["gpu"] is None
    # On the CPU the kernel path is the plain chain.
    assert lines[0]["max_abs_err"] == 0.0
    assert lines[1]["max_abs_err"] <= 1e-6


def test_serve_http_bench_answers_every_request():
    out = serve_http_bench.run(clients=2, per_client=2, model="tiny",
                               device="cpu")
    for name in ("text", "image", "image_raw"):
        r = out[name]
        assert r["n"] == 4 and r["clients"] == 2, name
        assert r["mean_batch_fill"] >= 1, name
        assert r["latency_ms_p50"] <= r["latency_ms_p95"], name
        assert r["requests_per_sec"] > 0, name
        assert set(r["stages"]) == {
            f"{s}_ms_{q}" for s in ("queue_wait", "dispatch", "device_batch")
            for q in ("p50", "p95")}, name
    assert out["device"] == "cpu" and out["gpu"] is None


KERNEL_NAMES = [
    ("void (anonymous namespace)::attention_fwd_mma<64>(Params)",
     "attention_fwd_mma"),
    ("void (anonymous namespace)::attention_bwd_dkdv_tf32<32>(Params)",
     "attention_bwd_dkdv_tf32"),
    ("void (anonymous namespace)::sparc_bwd_rows_kernel(float const*)",
     "sparc_bwd_rows_kernel"),
    ("void (anonymous namespace)::flash_fwd_wgmma<64>(CUtensorMap)",
     "flash_fwd_wgmma"),
    ("void (anonymous namespace)::quant_cols_t_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, signed char*)", "quant_cols_t_kernel"),
    ("void (anonymous namespace)::col_absmax_kernel<float>(float const*)",
     "col_absmax_kernel"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "cublas", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_256x128_"
     "64x3_tn_align16>(Params)", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int, float*)", "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<copy>(int)",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>(R)", "reduce"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_"
     "kernel<float, float>(int, float)", "layer_norm"),
    ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel"
     "<float>(long)", "layer_norm"),
    ("void (anonymous namespace)::cunn_SoftMaxForward<4, float>(float*)",
     "softmax"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "TensorListMetadata<2>>(T)", "multi_tensor_apply"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("Memset (Device)", "memset"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>(TensorInfo)",
     "indexSelectLargeIndex"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
     "OpaqueType<4u>, unsigned int, 3, 128, 1>(T)", "CatArrayBatchedCopy"),
]


@pytest.mark.parametrize("name,cls", KERNEL_NAMES)
def test_trace_report_classifies_kernel_names(name, cls):
    assert trace_report.classify(name) == cls


def _record(name, device, start_us, end_us):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: device,
        start_ns=lambda: start_us * 1000, end_ns=lambda: end_us * 1000)


def test_trace_report_of_profiler_rows():
    """A real CPU window holds no device record; a made-up window's
    records, read by ``device_rows`` as a live profiler's, sum by class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from clip_finegrained_alignment_tpu_torch.perf.trace_read import \
        device_rows
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8, 8).matmul(torch.ones(8, 8)).softmax(-1)
    assert trace_report.class_table(device_rows(prof))["classes"] == []
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    made_up = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: [
            _record("aten::mm", cpu, 0, 100),
            _record(KERNEL_NAMES[6][0], cuda, 0, 40),
            _record(KERNEL_NAMES[7][0], cuda, 40, 60),
            _record(KERNEL_NAMES[0][0], cuda, 60, 70),
            _record(KERNEL_NAMES[0][0], cuda, 70, 80),
            _record(KERNEL_NAMES[16][0], cuda, 80, 84)])))
    table = trace_report.class_table(device_rows(made_up), steps=2)
    assert table["device_ms_per_step"] == pytest.approx(0.042)
    assert table["launches_per_step"] == 2
    assert [(r["class"], r["ms_per_step"], r["launches_per_step"])
            for r in table["classes"]] == [
        ("gemm", pytest.approx(0.03), 1),
        ("attention_fwd_mma", pytest.approx(0.01), 1),
        ("memcpy", pytest.approx(0.002), 0)]
    text = trace_report.format_table(table)
    assert text.splitlines()[0] == "total device time: 0.042 ms/step " \
        "(2 steps)"
    assert text.splitlines()[2].split() == ["0.030", "1", "gemm"]


def test_trace_report_reads_a_chrome_trace(tmp_path):
    with trace_capture(str(tmp_path)):
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    path = tmp_path / "trace.json"
    assert trace_report.chrome_rows(str(path)) == []   # CPU records only
    trace = json.loads(path.read_text())
    trace["traceEvents"] += [
        {"ph": "X", "cat": "kernel", "name": KERNEL_NAMES[2][0], "ts": 0,
         "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_NAMES[2][0], "ts": 40,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": KERNEL_NAMES[9][0], "ts": 60,
         "dur": 6.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 70, "dur": 2.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
         "dur": 500.0}]
    path.write_text(json.dumps(trace))
    table = trace_report.main([str(path), "--steps", "2"])
    assert table["device_ms_per_step"] == pytest.approx(0.024)
    assert [(r["class"], r["launches_per_step"])
            for r in table["classes"]] == [("sparc_bwd_rows_kernel", 1),
                                           ("elementwise", 0),
                                           ("memset", 0)]


def test_profile_step_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_MODEL", "tiny")
    monkeypatch.setenv("BENCH_ACCUM", "1")
    out = profile_step.main(["2", "1", "--out", str(tmp_path),
                             "--device", "cpu"])
    assert [Path(f["path"]).name for f in out["files"]] == ["trace.json"]
    assert out["device"] == "cpu" and out["device_ms_per_step"] is None
    assert out["busy_share"] is None and out["window_s"] > 0
    assert trace_report.chrome_rows(out["files"][0]["path"]) == []


def test_trace_report_reads_a_file_only(capsys):
    # Live windows are profile_step's: the report takes a trace file, and
    # no device.
    with pytest.raises(SystemExit):
        trace_report.main([])
    with pytest.raises(SystemExit):
        trace_report.main(["trace.json", "--device", "cpu"])
    capsys.readouterr()


@pytest.mark.parametrize("tool", [bench, serve_bench, serve_http_bench,
                                  sparc_microbench, profile_step,
                                  pp_activation_report],
                         ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_tools_default_to_the_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tool.main([])

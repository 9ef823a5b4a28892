"""The port's hardware drills (``clip_finegrained_alignment_tpu_torch/perf/
e2e_learn_to_count.py``, ``preempt_rehearsal.py``, ``gradcache_rehearsal.py``,
``packed_rehearsal.py``) on the CPU at ``--model tiny``, procedural 64 px
images fed at 32 px, fp32 (``--no-amp``), against the port's CLIs and the
JAX side:

* learn-to-count: its trajectory (one ``cli/train.py`` call an epoch,
  resumed, evaluated with no plot) equals the port CLI's own
  ``--eval-every-epoch`` metrics on the same run, exactly; its anchor and
  best equal what the JAX script's stage-3 code (run as text from
  ``perf/e2e_learn_to_count.sh``) computes from its metrics file; its
  stage-4 metrics on the trained ``best/`` equal JAX's ``cli/evaluate.py
  countbench`` on that checkpoint exported to a reference ``.pt`` within
  1e-5 (``tests/test_torch_cli_evaluate.py``'s tolerance; counts exactly);
* preempt: a real SIGTERM to one child process (one spawn for the file),
  which exits 0 with ``preempt/meta.json`` committed, and a step-exact
  resume whose final weights equal an unbroken run's bit for bit;
* GradCache: ``gc_a16``'s first step loss equals JAX's GradCache
  full-pool loss (``train/gradcache.py``) on the same weights and batch
  within rtol 2e-5 (``tests/test_torch_gradcache.py``'s), and differs
  from ``plain_a16``'s;
* packed: its epoch losses equal a live-decode ``cli/train.py`` run's on
  the same data, exactly;
* every drill's default device is the card (it raises here).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.cli import evaluate as jax_evaluate
from clip_finegrained_alignment_tpu.config import \
    CLIPConfig as JaxCLIPConfig, TrainConfig as JaxTrainConfig
from clip_finegrained_alignment_tpu.train.gradcache import \
    gradcache_grads as jax_gradcache_grads
from clip_finegrained_alignment_tpu_torch.cli import train as train_cli
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
from clip_finegrained_alignment_tpu_torch.data.packed import \
    PackedDataPipeline
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, save_reference_checkpoint)
from clip_finegrained_alignment_tpu_torch.perf import (e2e_learn_to_count,
                                                       gradcache_rehearsal,
                                                       packed_rehearsal,
                                                       preempt_rehearsal)

ROOT = Path(__file__).resolve().parent.parent
CFG, JCFG = CLIPConfig.tiny_test(), JaxCLIPConfig.tiny_test()
TINY = ["--model", "tiny", "--image-size", "64", "--no-amp",
        "--device", "cpu"]
EVAL_TOL = 1e-5      # tests/test_torch_cli_evaluate.py
LOSS_RTOL = 2e-5     # tests/test_torch_gradcache.py, the port against JAX
L2C_EPOCHS, L2C_B, L2C_ACCUM = 2, 4, 2


@pytest.fixture(autouse=True)
def hermetic(monkeypatch):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
    # JAX's CLIs would set a persistent compilation cache for the whole
    # worker process otherwise (core/xla_flags.py).
    monkeypatch.setenv("CFA_COMPILE_CACHE", "0")
    # One intra-op thread, here and in the preempt drill's child: the
    # tiny model gains nothing from more, and the suite's workers share the
    # host's cores.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(a, b, where=""):
    """Nested JSON values: equal, floats within EVAL_TOL."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert abs(a - b) <= EVAL_TOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


def _accuracies(metrics_file):
    with open(metrics_file) as f:
        rows = [json.loads(ln) for ln in f]
    return [(r["step"], r["count_eval_accuracy"]) for r in rows
            if "count_eval_accuracy" in r]


# ---------------------------------------------------------------------------
# learn-to-count
# ---------------------------------------------------------------------------

def test_learn_to_count_matches_the_cli_and_the_jax_script(
        tmp_path, monkeypatch, capsys):
    """One drill run (the test runs its stages' checks in turn, so that
    xdist runs it once)."""
    out = tmp_path / "out"
    line = e2e_learn_to_count.main(
        ["--out", str(out), "--samples", "16", "--epochs", str(L2C_EPOCHS),
         "--batch-size", str(L2C_B), "--grad-accum", str(L2C_ACCUM),
         "--cb-samples", "8", "--min-acc", "-1", "--min-gain", "-1", *TINY])
    _trajectory_equals_eval_every_epoch(out, line, tmp_path / "cli")
    _stage3_equals_the_jax_scripts(out, line, monkeypatch, capsys)
    _countbench_equals_jax_cli(out, line, tmp_path / "jax")


def _trajectory_equals_eval_every_epoch(out, line, tmp_path):
    tmp_path.mkdir()
    metrics = str(tmp_path / "cli.jsonl")
    train_cli.main([
        "--annotations", str(out / "data" / "synthetic_annotations.json"),
        "--model", "tiny", "--loss-type", "count", "--optimizer", "adamw",
        "--lr", "0.0001", "--weight-decay", "0.01", "--batch-size",
        str(L2C_B), "--grad-accum", str(L2C_ACCUM), "--epochs",
        str(L2C_EPOCHS), "--no-amp", "--eval-every-epoch",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--metrics-file",
        metrics, "--device", "cpu"])
    want = _accuracies(metrics)
    steps = 16 // (L2C_B * L2C_ACCUM)
    assert [s for s, _ in want] == [e * steps for e in
                                    range(L2C_EPOCHS + 1)]
    assert [tuple(r) for r in line["trajectory"]] == want
    assert _accuracies(out / "metrics.jsonl") == want
    assert line["anchor"] == want[0][1]
    assert line["best"] == max(a for _, a in want)


def _stage3_code():
    """The JAX script's stage-3 heredoc, as text."""
    text = (ROOT / "perf" / "e2e_learn_to_count.sh").read_text()
    start = text.index('MIN_ACC="$MIN_ACC" python - "$OUT/metrics.jsonl"'
                       " <<'EOF'\n")
    body = text[text.index("\n", start) + 1:]
    return body[:body.index("\nEOF\n")]


def _stage3_equals_the_jax_scripts(out, line, monkeypatch, capsys):
    capsys.readouterr()
    monkeypatch.setenv("MIN_ACC", "-1")
    monkeypatch.setattr("sys.argv", ["-", str(out / "metrics.jsonl")])
    ns = {}
    exec(compile(_stage3_code(), "e2e_learn_to_count.sh:stage3", "exec"), ns)
    assert (ns["first"], ns["best"]) == (line["anchor"], line["best"])
    assert "learning demonstrated" in capsys.readouterr().out


def _countbench_equals_jax_cli(out, line, tmp_path):
    tmp_path.mkdir()
    state = torch.load(out / "ckpt" / "e2e_count" / "best" / "state.pt",
                       map_location="cpu", weights_only=True)
    pt = str(tmp_path / "best.pt")
    save_reference_checkpoint(pt, state["model"], CFG)
    jax_evaluate.main([
        "countbench", "--model", "tiny", "--checkpoint", pt, "--dataset",
        str(out / "cb_fixture" / "countbench_fixture.json"),
        *e2e_learn_to_count.COUNTBENCH_FLAGS, "--output-dir",
        str(tmp_path / "jax")])
    with open(out / "cb_trained" / "countbench_metrics.json") as f:
        port = json.load(f)
    with open(tmp_path / "jax" / "countbench_metrics.json") as f:
        _close(port, json.load(f))
    assert port["total_samples"] == 8
    for k in ("accuracy", "argmax_accuracy", "total_samples", "correct"):
        assert line["countbench"]["trained"][k] == port[k]


# ---------------------------------------------------------------------------
# preempt
# ---------------------------------------------------------------------------

PRE_SAMPLES, PRE_BATCH, PRE_EPOCHS = 64, 4, 2   # 16 steps an epoch


def test_preempt_sigterm_and_step_exact_bit_equal_resume(tmp_path):
    """The file's one child process: a real SIGTERM, preempt/, the resume
    against an unbroken run."""
    out = tmp_path / "out"
    line = preempt_rehearsal.main(
        ["--out", str(out), "--samples", str(PRE_SAMPLES), "--batch",
         str(PRE_BATCH), "--epochs", str(PRE_EPOCHS), "--wait-steps", "1",
         "--timeout", "120", *TINY])
    assert line["child_rc"] == 0 and line["preempt_logged"]
    with open(out / "ckpts" / "preempt" / "preempt" / "meta.json") as f:
        meta = json.load(f)
    assert meta["preempted"] is True
    assert line["preempt_meta"] == {k: meta[k] for k in (
        "preempted", "global_step", "epoch")}
    assert 1 <= meta["global_step"] < PRE_SAMPLES // PRE_BATCH * PRE_EPOCHS
    assert (out / "ckpts" / "preempt" / "preempt" / "state.pt").exists()
    steps = PRE_SAMPLES // PRE_BATCH * PRE_EPOCHS
    assert line["resumed_at_step"] == line["preempt_meta"]["global_step"]
    assert line["skipped_steps"] == line["resumed_at_step"] % (
        PRE_SAMPLES // PRE_BATCH) > 0
    assert line["resumed_steps"] == line["unbroken_steps"] == steps
    assert line["resumed_epoch_losses"][1:] == \
        line["unbroken_epoch_losses"][1:]
    assert line["weights_equal"] and line["ok"]


# ---------------------------------------------------------------------------
# GradCache
# ---------------------------------------------------------------------------

GC_B, GC_ACCUM = 2, 16


def test_gradcache_first_step_equals_jax_full_pool_loss(tmp_path):
    out = tmp_path / "out"
    line = gradcache_rehearsal.main(
        ["--out", str(out), "--samples", str(GC_B * GC_ACCUM), "--epochs",
         "1", "--batch-size", str(GC_B), "--runs", "plain_a16", "gc_a16",
         *TINY])
    plain, gc = line["runs"]["plain_a16"], line["runs"]["gc_a16"]
    assert plain["steps"] == gc["steps"] == 1 and gc["grad_cache"]
    assert line["objectives_differ"]
    assert abs(plain["epoch_losses"][0] - gc["epoch_losses"][0]) > 1e-3

    # The drill's first batch (cli/train.py's seed 42), and its weights.
    pipe = PackedDataPipeline(str(out / "pack"), GC_B * GC_ACCUM, seed=42)
    held = next(iter(pipe.epoch(0)))
    held = pipe.materialize(held) if "pixel_index" in held else held
    batch = {k: jnp.asarray(np.asarray(held[k]).reshape(
        (GC_ACCUM, GC_B) + np.asarray(held[k]).shape[1:]))
        for k in ("pixel_values", "input_ids")}
    jcfg = JaxTrainConfig(
        clip_model="tiny", batch_size=GC_B,
        gradient_accumulation_steps=GC_ACCUM, use_amp=False,
        loss_type="sparc", grad_cache=True, remat=False,
        use_pallas_attention=True, use_fused_sparc=True,
        inverse_temperature=0.07)
    _, jlosses = jax.jit(
        lambda p, b: jax_gradcache_grads(p, b, jcfg, JCFG, jnp.float32))(
        jax.tree.map(jnp.asarray, random_params(CFG, 42)), batch)
    np.testing.assert_allclose(gc["epoch_losses"][0],
                               float(jlosses["total_loss"]), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# packed
# ---------------------------------------------------------------------------

def test_packed_losses_equal_live_decode(tmp_path):
    out = tmp_path / "out"
    common = ["--batch-size", "4", "--grad-accum", "2", "--epochs", "2"]
    line = packed_rehearsal.main(["--out", str(out), "--samples", "32",
                                  *common, *TINY])
    assert line["pixel_bank"]["device"] == "cpu"
    assert line["steps"] == 2 * 32 // 8
    res = train_cli.main([
        "--annotations", str(out / "data" / "synthetic_annotations.json"),
        "--model", "tiny", "--loss-type", "sparc", "--optimizer", "adamspd",
        "--lr", "2e-05", "--no-amp", *common, "--checkpoint-dir",
        str(tmp_path / "live"), "--device", "cpu"])
    assert line["epoch_losses"] == [h["avg_loss"] for h in res["history"]]


@pytest.mark.parametrize("drill", [e2e_learn_to_count, preempt_rehearsal,
                                   gradcache_rehearsal, packed_rehearsal],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_drills_default_to_the_card(drill, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        drill.main(["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()

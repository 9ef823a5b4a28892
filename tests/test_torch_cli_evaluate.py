"""The port's evaluation CLI (``clip_finegrained_alignment_tpu_torch/cli/
evaluate.py``) and the training CLI's ``--eval-every-epoch``, with
``--device cpu``, against the JAX package's CLIs.

Both CLIs read one reference ``.pt`` (tiny config, the JAX tree's weights
written by the port's ``save_reference_checkpoint``) and generate the same
procedural fixtures; every metric of ``countbench``, ``vlmsblind`` and
``crop`` agrees within 1e-5 (the counts and accuracies exactly). The port
also reads a ``best/`` directory its own training CLI wrote, and refuses
what would need a download: a hub dataset, an HF model name. Without
``--device`` it asks for the card and fails on a host without one.

``cli/train.py --eval-every-epoch`` logs ``count_eval_accuracy`` at step 0
and after every epoch and writes the confusion PNGs; its step-0 accuracy
equals the JAX ``evaluate_batch`` on the same weights and held-out batch.
"""

import json
import os

import jax
import pytest
import torch

from clip_finegrained_alignment_tpu.cli import evaluate as jcli
from clip_finegrained_alignment_tpu.config import CLIPConfig as JaxCLIPConfig
from clip_finegrained_alignment_tpu.eval.batch_eval import \
    evaluate_batch as jax_evaluate_batch
from clip_finegrained_alignment_tpu.models import clip as jm
from clip_finegrained_alignment_tpu.models.hf_import import \
    load_reference_checkpoint as jax_load_reference
from clip_finegrained_alignment_tpu_torch.cli import evaluate as cli
from clip_finegrained_alignment_tpu_torch.cli import train as train_cli
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
from clip_finegrained_alignment_tpu_torch.data.packed import pack_dataset
from clip_finegrained_alignment_tpu_torch.data.synthetic import \
    generate_procedural_dataset
from clip_finegrained_alignment_tpu_torch.data.tokenizer import HashTokenizer
from clip_finegrained_alignment_tpu_torch.models.convert import (
    save_reference_checkpoint, state_dict_from_jax)

CFG, JCFG = CLIPConfig.tiny_test(), JaxCLIPConfig.tiny_test()
TOL = 1e-5
SAMPLES, B, ACCUM, EPOCHS = 32, 4, 2, 2
STEPS = SAMPLES // (B * ACCUM)


@pytest.fixture(autouse=True)
def hash_tokenizer(monkeypatch):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
    # JAX's cli/evaluate.py would otherwise turn on a persistent compilation
    # cache under HOME for the rest of the worker process
    # (core/xla_flags.py::enable_persistent_compilation_cache).
    monkeypatch.setenv("CFA_COMPILE_CACHE", "0")


@pytest.fixture(scope="module")
def ref_pt(tmp_path_factory):
    params = jm.init_clip_params(jax.random.key(1), JCFG)
    path = str(tmp_path_factory.mktemp("ref") / "ref.pt")
    save_reference_checkpoint(path, state_dict_from_jax(params, CFG), CFG)
    return path


def _close(a, b, where=""):
    """Nested JSON values: equal, floats within TOL."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert abs(a - b) <= TOL, (where, a, b)
    else:
        assert a == b, (where, a, b)


def _read(path):
    with open(path) as f:
        return json.load(f)


def _argv(command, checkpoint, out):
    extra = {"countbench": ["--dataset", "procedural"],
             "vlmsblind": ["--dataset", "procedural"],
             "crop": ["--samples", "5", "--output",
                      os.path.join(out, "crop.json")]}[command]
    return [command, "--model", "tiny", "--checkpoint", checkpoint,
            "--batch-size", "12", "--output-dir", out, *extra]


METRICS_FILE = {"countbench": "countbench_metrics.json",
                "vlmsblind": "vlmsblind_metrics.json", "crop": "crop.json"}


@pytest.mark.parametrize("command", ["countbench", "vlmsblind", "crop"])
def test_each_subcommand_matches_the_jax_cli(ref_pt, tmp_path, command):
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(port_out)
    os.makedirs(jax_out)
    got = cli.main(_argv(command, ref_pt, port_out) + ["--device", "cpu"])
    jcli.main(_argv(command, ref_pt, jax_out))
    port = _read(os.path.join(port_out, METRICS_FILE[command]))
    _close(port, _read(os.path.join(jax_out, METRICS_FILE[command])))
    _close(json.loads(json.dumps(got)),
           port["aggregate_stats"] if command == "crop" else port)
    if command == "countbench":
        assert port["total_samples"] == 40
        assert os.path.exists(os.path.join(port_out, "countbench_results.npy"))
    elif command == "vlmsblind":
        assert sorted(t for t, m in port.items() if m["total_samples"]) == [
            "Counting Grid - Blank Grids", "Nested Squares",
            "Olympic Counting - Circles", "Touching Circles"]
    else:
        assert len(port["individual_results"]) == 5


@pytest.mark.parametrize("argv,message", [
    (["countbench", "--dataset", "nielsr/countbench"], "out of reach"),
    (["vlmsblind"], "out of reach"),
    (["countbench", "--checkpoint", "openai/clip-vit-base-patch32"],
     "out of reach"),
])
def test_refuses_downloads(tmp_path, argv, message):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--model", "tiny", "--device", "cpu",
                         "--output-dir", str(tmp_path)])
    assert message in str(e.value.code)


def test_default_device_is_the_card(ref_pt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs none")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(_argv("countbench", ref_pt, str(tmp_path)))


def test_random_init_without_a_checkpoint(tmp_path, capsys):
    out = str(tmp_path)
    metrics = cli.main(["crop", "--model", "tiny", "--samples", "2",
                        "--device", "cpu", "--output",
                        os.path.join(out, "crop.json")])
    assert "RANDOM INIT" in capsys.readouterr().out
    assert set(metrics) == {"original_positive", "original_negative",
                            "crop_05_positive", "crop_05_negative",
                            "crop_10_positive", "crop_10_negative"}


# ---------------------------------------------------------------------------
# cli/train.py --eval-every-epoch, and evaluating the best/ it wrote
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def count_runs(ref_pt, tmp_path_factory):
    """Two count-loss runs with --eval-every-epoch from the reference
    weights: live decode, and packed with the pixel bank."""
    root = tmp_path_factory.mktemp("count")
    generate_procedural_dataset(str(root / "data"), SAMPLES, image_size=64,
                                max_objects=3, seed=2)
    anns = str(root / "data" / "synthetic_annotations.json")
    t = CFG.text
    pack_dataset(anns, str(root / "packed"), mode="counterfactual",
                 image_size=CFG.vision.image_size,
                 context_length=t.max_position_embeddings,
                 tokenizer=HashTokenizer(
                     vocab_size=t.vocab_size, bos_token_id=t.bos_token_id,
                     eos_token_id=t.eos_token_id,
                     pad_token_id=t.pad_token_id))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
        for name, data in (("live", ["--annotations", anns]),
                           ("bank", ["--packed", str(root / "packed"),
                                     "--device-data"])):
            ckpt = root / name
            metrics = str(root / f"{name}.jsonl")
            res = train_cli.main([
                *data, "--model", "tiny", "--loss-type", "count",
                "--optimizer", "adamw", "--batch-size", str(B),
                "--grad-accum", str(ACCUM), "--epochs", str(EPOCHS),
                "--lr", "1e-3", "--no-amp", "--save-every", "1",
                "--checkpoint-dir", str(ckpt), "--experiment-name", "count",
                "--pretrained", ref_pt, "--device", "cpu",
                "--eval-every-epoch", "--metrics-file", metrics])
            runs[name] = (res, ckpt / "count", metrics)
    return runs


@pytest.mark.parametrize("name", ["live", "bank"])
def test_train_eval_every_epoch(count_runs, ref_pt, name):
    res, exp, metrics = count_runs[name]
    with open(metrics) as f:
        rows = [json.loads(ln) for ln in f]
    evals = [(r["step"], r["count_eval_accuracy"]) for r in rows
             if "count_eval_accuracy" in r]
    assert [s for s, _ in evals] == [0, STEPS, 2 * STEPS]
    assert all(0.0 <= a <= 1.0 for _, a in evals)
    for png in ("confusion_pretrain.png", "confusion_epoch_0.png",
                "confusion_epoch_1.png"):
        assert os.path.getsize(exp / png) > 0
    # The held-out batch: the first of epoch 0, with pixels.
    held = next(iter(res["pipeline"].epoch(0)))
    if name == "bank":
        assert "pixel_index" in held
        held = res["pipeline"].materialize(held)
    params, _ = jax_load_reference(ref_pt, JCFG)
    acc, _, _ = jax_evaluate_batch(params, JCFG, held)
    assert evals[0][1] == acc


def test_live_and_bank_evaluations_agree(count_runs):
    accs = {}
    for name, (_, _, metrics) in count_runs.items():
        with open(metrics) as f:
            accs[name] = [json.loads(ln)["count_eval_accuracy"] for ln in f
                          if "count_eval_accuracy" in ln]
    assert accs["live"] == accs["bank"]


def test_evaluate_reads_the_trainers_best_dir(count_runs, tmp_path):
    """countbench from the port's best/ directory equals the JAX CLI on the
    same weights exported as a reference .pt."""
    _, exp, _ = count_runs["live"]
    state = torch.load(exp / "best" / "state.pt", map_location="cpu",
                       weights_only=True)
    pt = str(tmp_path / "best.pt")
    save_reference_checkpoint(pt, state["model"], CFG)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    cli.main(_argv("countbench", str(exp / "best"), port_out)
             + ["--device", "cpu"])
    jcli.main(_argv("countbench", pt, jax_out))
    _close(_read(os.path.join(port_out, "countbench_metrics.json")),
           _read(os.path.join(jax_out, "countbench_metrics.json")))

"""The port's training CLI (``clip_finegrained_alignment_tpu_torch/cli/
train.py``) with ``--device cpu`` on a tiny generated fixture
(``--model tiny``, the hash tokenizer): live decode, packed, packed with
the pixel bank, the metrics file, bare ``--resume`` and ``--resume`` of a
``preempt/`` directory, and every refused flag. Without ``--device`` the
CLI asks for the card and fails on a host without one.

The runs are held to each other: the three ingest paths give the same
epoch losses (the same batches; the bank only moves the gather to the
device), and a preempted run resumed from ``preempt/`` ends with the
weights of the unbroken run.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu_torch.cli import train as cli
from clip_finegrained_alignment_tpu_torch.data.packed import pack_dataset
from clip_finegrained_alignment_tpu_torch.data.synthetic import \
    generate_procedural_dataset
from clip_finegrained_alignment_tpu_torch.data.tokenizer import HashTokenizer
from clip_finegrained_alignment_tpu_torch.train import engine

SAMPLES, B, ACCUM = 32, 4, 2
STEPS = SAMPLES // (B * ACCUM)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    generate_procedural_dataset(str(root / "data"), SAMPLES, image_size=64,
                                max_objects=3, seed=2)
    anns = str(root / "data" / "synthetic_annotations.json")
    pack_dataset(anns, str(root / "packed"), image_size=32,
                 context_length=16,
                 tokenizer=HashTokenizer(vocab_size=256, bos_token_id=254,
                                         eos_token_id=255, pad_token_id=0))
    return {"annotations": anns, "packed": str(root / "packed")}


@pytest.fixture(autouse=True)
def hash_tokenizer(monkeypatch):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")


def _args(ckpt, *extra, epochs=2):
    return ["--model", "tiny", "--loss-type", "sparc", "--optimizer",
            "adamspd", "--batch-size", str(B), "--grad-accum", str(ACCUM),
            "--epochs", str(epochs), "--save-every", "1", "--lr", "1e-3",
            "--no-amp", "--checkpoint-dir", str(ckpt), "--device", "cpu",
            "--log-every", "1", *extra]


@pytest.fixture(scope="module")
def runs(fixture, tmp_path_factory):
    """One two-epoch run per ingest path (each with its own checkpoints);
    the live-decode run also writes a profile to ``<ckpt>/profile``."""
    out = {}
    for name in ("annotations", "packed", "bank"):
        ckpt = tmp_path_factory.mktemp(name)
        data = {"annotations": ["--annotations", fixture["annotations"],
                                "--profile-dir", str(ckpt / "profile")],
                "packed": ["--packed", fixture["packed"]],
                "bank": ["--packed", fixture["packed"], "--device-data"]}
        metrics = ckpt / "metrics.jsonl"
        res = cli.main(_args(ckpt, *data[name], "--metrics-file",
                             str(metrics)))
        out[name] = (res, ckpt, metrics)
    return out


@pytest.mark.parametrize("name", ["annotations", "packed", "bank"])
def test_each_ingest_path_trains_two_epochs(runs, name):
    res, ckpt, metrics = runs[name]
    t = res["trainer"]
    assert t.global_step == 2 * STEPS and not res["preempted"]
    losses = [h["avg_loss"] for h in res["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    exp = ckpt / "clip_finetune"
    assert sorted(os.listdir(exp)) == ["best", "epoch_0", "epoch_1"]
    with open(exp / "epoch_1" / "meta.json") as f:
        assert json.load(f)["global_step"] == 2 * STEPS
    assert (t.pixel_bank is not None) == (name == "bank")
    assert res["image_path"] == (None if name != "annotations"
                                 else "native" if res["pipeline"]._native
                                 else "PIL")
    # The same batches on every path: the same losses as the packed run.
    ref = [h["avg_loss"] for h in runs["packed"][0]["history"]]
    np.testing.assert_allclose(losses, ref, rtol=1e-6)
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    assert recs and all("pairs_per_sec_enqueue" in r and "step" in r
                        for r in recs)


def test_profile_dir_gets_a_trace(runs):
    with open(runs["annotations"][1] / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_bank_run_ships_indices_not_pixels(runs):
    res = runs["bank"][0]
    assert res["pipeline"].index_only
    assert res["trainer"].pixel_bank.device.type == "cpu"
    batch = next(iter(res["pipeline"].epoch(0)))
    assert "pixel_index" in batch and "pixel_values" not in batch


def test_bare_resume_continues_from_best(runs, fixture, capsys):
    res, ckpt, _ = runs["packed"]
    with open(ckpt / "clip_finetune" / "best" / "meta.json") as f:
        best_step = json.load(f)["global_step"]
    handler = signal.getsignal(signal.SIGTERM)
    out = cli.main(_args(ckpt, "--packed", fixture["packed"], "--resume",
                         epochs=3))
    # The run's SIGTERM handler (it holds the trainer) was taken down.
    assert signal.getsignal(signal.SIGTERM) is handler
    assert out["resumed_at_step"] == best_step
    assert out["start_epoch"] == best_step // STEPS
    assert out["trainer"].global_step == best_step + (
        3 - best_step // STEPS) * STEPS
    assert "resumed from" in capsys.readouterr().out


def test_resume_of_a_preempt_directory_is_step_exact(runs, fixture,
                                                     tmp_path, monkeypatch,
                                                     capsys):
    step = engine.Trainer.step

    def step_then_preempt(self, batch):
        out = step(self, batch)
        if self.global_step == STEPS + 1:   # one step into epoch 1
            self.request_preempt()
        return out

    with monkeypatch.context() as mp:
        mp.setattr(engine.Trainer, "step", step_then_preempt)
        first = cli.main(_args(tmp_path, "--packed", fixture["packed"]))
    assert first["preempted"]
    preempt = tmp_path / "clip_finetune" / "preempt"
    with open(preempt / "meta.json") as f:
        meta = json.load(f)
    assert meta["preempted"] and meta["global_step"] == STEPS + 1
    capsys.readouterr()

    out = cli.main(_args(tmp_path, "--packed", fixture["packed"],
                         "--resume", str(preempt)))
    assert out["skipped_steps"] == 1 and out["start_epoch"] == 1
    assert "skipping 1 completed steps" in capsys.readouterr().out
    t, ref = out["trainer"], runs["packed"][0]["trainer"]
    assert t.global_step == ref.global_step == 2 * STEPS
    for k, v in ref.model.state_dict().items():
        assert torch.equal(t.model.state_dict()[k], v), k


@pytest.mark.parametrize("extra,message", [
    (["--import-optimizer-state"], "requires --pretrained"),
    (["--pretrained", "openai/clip-vit-base-patch32"], "out of reach"),
    (["--device-data"], "requires --packed"),
])
def test_refused_flags_exit_non_zero(fixture, tmp_path, extra, message):
    with pytest.raises(SystemExit) as e:
        cli.main(_args(tmp_path, "--annotations", fixture["annotations"],
                       *extra))
    assert message in str(e.value.code)


@pytest.mark.parametrize("data", ["both", "neither"])
def test_exactly_one_data_source(fixture, tmp_path, data):
    extra = ["--annotations", fixture["annotations"], "--packed",
             fixture["packed"]] if data == "both" else []
    with pytest.raises(SystemExit) as e:
        cli.main(_args(tmp_path, *extra))
    assert "exactly one of --annotations / --packed" in str(e.value.code)


def test_pretrained_reference_checkpoint(runs, fixture, tmp_path):
    from clip_finegrained_alignment_tpu_torch.models.convert import \
        save_reference_checkpoint
    t = runs["packed"][0]["trainer"]
    path = str(tmp_path / "ref.pt")
    save_reference_checkpoint(path, t.model, t.model_cfg, global_step=8)
    out = cli.main(_args(tmp_path, "--packed", fixture["packed"],
                         "--pretrained", path, epochs=0))
    for k, v in t.model.state_dict().items():
        assert torch.equal(out["trainer"].model.state_dict()[k], v), k


def test_default_device_is_the_card(fixture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs none")
    args = _args(tmp_path, "--packed", fixture["packed"])
    i = args.index("--device")
    del args[i:i + 2]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(args)


@pytest.mark.parametrize("quant", ["switchback", "int8"])
def test_quant_flag_trains_on_the_cpu(fixture, tmp_path, quant, capsys,
                                      monkeypatch):
    """--quant reaches the trainer's config (and the printed report) and
    its step: one epoch of the packed data trains with finite losses, and
    the step runs the int8 GEMMs (the quantize passes are called)."""
    from clip_finegrained_alignment_tpu_torch.ops import quant as tq
    calls = []
    rows = tq.quant_rows

    def spy(x):
        calls.append(tuple(x.shape))
        return rows(x)

    monkeypatch.setattr(tq, "quant_rows", spy)
    res = cli.main(_args(tmp_path, "--packed", fixture["packed"],
                         "--quant", quant, epochs=1))
    assert res["trainer"].cfg.quant == quant
    assert f"Int8 quantized GEMMs: {quant}" in capsys.readouterr().out
    losses = [h["avg_loss"] for h in res["history"]]
    assert res["trainer"].global_step == STEPS and np.isfinite(losses).all()
    assert calls


def test_quant_flag_refuses_other_modes(fixture, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(_args(tmp_path, "--packed", fixture["packed"],
                       "--quant", "fp8"))
    assert e.value.code == 2
    assert "invalid choice: 'fp8'" in capsys.readouterr().err
    assert cli.build_parser().parse_args([]).quant == "none"

"""The port's CLIs at W = 2 gloo processes on the CPU
(``parallel/launch.py::spawn``): ``cli/train.py --global-negatives
--zero1`` on a tiny packed fixture, resumed by one process, and
``cli/evaluate.py countbench --data-parallel 2`` against one process;
then the flags the CLIs refuse.

A W-rank run's batches are not a one-process run's (each rank reads its
own shard of the permutation), so the training run is held to what it can
show: finite losses equal on both ranks, ``best/`` equal to what every
rank holds, and a resume at W = 1 that restores it bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_parallel_workers as W
from clip_finegrained_alignment_tpu_torch.cli import evaluate as cli_eval
from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
from clip_finegrained_alignment_tpu_torch.data.packed import pack_dataset
from clip_finegrained_alignment_tpu_torch.data.synthetic import \
    generate_procedural_dataset
from clip_finegrained_alignment_tpu_torch.data.tokenizer import HashTokenizer
from clip_finegrained_alignment_tpu_torch.parallel.launch import spawn
from clip_finegrained_alignment_tpu_torch.train import engine
from clip_finegrained_alignment_tpu_torch.train.checkpoint import \
    CheckpointManager

SAMPLES, B, ACCUM = 32, 8, 2    # 2 steps an epoch at W = 2 (4 rows a rank)
SPAWN_S = 240


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("pcli")
    generate_procedural_dataset(str(root / "data"), SAMPLES, image_size=64,
                                max_objects=3, seed=4)
    pack_dataset(str(root / "data" / "synthetic_annotations.json"),
                 str(root / "packed"), image_size=32, context_length=16,
                 tokenizer=HashTokenizer(vocab_size=256, bos_token_id=254,
                                         eos_token_id=255, pad_token_id=0))
    return str(root / "packed")


@pytest.fixture(autouse=True)
def hash_tokenizer(monkeypatch):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")


def _train_args(ckpt, *extra, epochs=1):
    return ["--model", "tiny", "--loss-type", "sparc", "--optimizer",
            "adamspd", "--batch-size", str(B), "--grad-accum", str(ACCUM),
            "--epochs", str(epochs), "--save-every", "1", "--lr", "1e-3",
            "--no-amp", "--checkpoint-dir", str(ckpt), "--device", "cpu",
            *extra]


def test_train_two_ranks_then_resume_in_one(packed, tmp_path, monkeypatch):
    flags = ["--packed", packed, "--device-data", "--global-negatives",
             "--zero1"]
    ranks = spawn(W.cli_main, 2, ("clip_finegrained_alignment_tpu_torch."
                                  "cli.train", _train_args(tmp_path, *flags)),
                  timeout_s=SPAWN_S)
    r0, r1 = ranks
    assert len(r0["losses"]) == 1 and np.isfinite(r0["losses"]).all()
    assert r0["losses"] == r1["losses"]
    assert r0["global_step"] == r1["global_step"] == SAMPLES // (B * ACCUM)
    best, meta = CheckpointManager(
        str(tmp_path / "clip_finetune")).restore("best")
    assert meta["config"]["mesh"]["data"] == 2 and meta["config"]["zero1"]
    for r in ranks:
        for k, v in best["model"].items():
            assert np.array_equal(r["state"]["model"][k], v.numpy()), k

    restored = {}
    load = engine.Trainer.load_state_dict

    def spy(self, state):
        load(self, state)
        restored.update(W.numpy_state(self.state_dict()))
    monkeypatch.setattr(engine.Trainer, "load_state_dict", spy)
    out = cli_train.main(_train_args(tmp_path, *flags, "--resume",
                                     epochs=2))
    assert out["resumed_at_step"] == r0["global_step"]
    want = W.numpy_state(best)
    for part in ("model", "optimizer"):
        assert set(restored[part]) == set(want[part])
    for k, v in want["model"].items():
        assert np.array_equal(restored["model"][k], v), k
    for i, st in want["optimizer"]["optimizer"]["state"].items():
        for n, v in st.items():
            assert np.array_equal(
                restored["optimizer"]["optimizer"]["state"][i][n], v), (i, n)
    assert out["trainer"].global_step == 2 * r0["global_step"]
    assert np.isfinite([h["avg_loss"] for h in out["history"]]).all()


def test_evaluate_data_parallel_2_equals_1(tmp_path):
    args = ["countbench", "--model", "tiny", "--device", "cpu", "--dataset",
            "procedural", "--batch-size", "8"]
    one = cli_eval.main(args + ["--output-dir", str(tmp_path / "one")])
    ranks = spawn(W.cli_main, 2, (
        "clip_finegrained_alignment_tpu_torch.cli.evaluate",
        args + ["--output-dir", str(tmp_path / "two"),
                "--data-parallel", "2"]), timeout_s=SPAWN_S)
    for metrics in ranks:   # the same decisions, sums ~1e-9 apart
        assert metrics["per_number_accuracy"] == one["per_number_accuracy"]
        assert {k: v for k, v in metrics.items()
                if k != "per_number_accuracy"} == pytest.approx(
            {k: v for k, v in one.items() if k != "per_number_accuracy"},
            rel=0, abs=1e-6)
    blobs = [np.load(tmp_path / d / "countbench_results.npy",
                     allow_pickle=True).item()["results"]
             for d in ("one", "two")]
    assert len(blobs[0]["confidence"]) > 8      # several batches
    np.testing.assert_allclose(blobs[1]["confidence"],
                               blobs[0]["confidence"], rtol=0, atol=1e-6)
    for k in ("correct", "pred_templates", "groundtruth"):
        assert blobs[1][k] == blobs[0][k], k


# The first five keep the ids they had when the flags were all refused
# (ROADMAP A6b); they now hold JAX's refusals. The last held the refusal
# of --fsdp with --eval-every-epoch, which now runs
# (test_torch_model_parallel.py's CLI spawn).
@pytest.mark.parametrize("extra,message", [
    pytest.param(["--model-parallel", "2"], "require --global-negatives",
                 id="extra0-A6b"),
    pytest.param(["--pipeline-parallel", "2"], "require --global-negatives",
                 id="extra1-A6b"),
    pytest.param(["--pipeline-parallel", "2", "--pipeline-microbatches",
                  "4", "--global-negatives"],
                 "must divide the world size (1 processes)",
                 id="extra2-A6b"),
    pytest.param(["--sequence-parallel", "2"], "require --global-negatives",
                 id="extra3-A6b"),
    pytest.param(["--sequence-parallel", "2", "--model-parallel", "2",
                  "--global-negatives"], "cannot be combined with "
                 "--model-parallel or --pipeline-parallel", id="extra4-A6b"),
    (["--fsdp"], "requires global_negatives"),
    (["--fsdp", "--global-negatives", "--zero1"], "subsumes"),
    (["--sequence-parallel", "2", "--sp-ring", "--global-negatives"],
     "must divide the world size (1 processes)"),
])
def test_train_refuses(packed, tmp_path, extra, message):
    with pytest.raises(SystemExit) as e:
        cli_train.main(_train_args(tmp_path, "--packed", packed, *extra))
    assert message in str(e.value.code)


class _Built(Exception):
    pass


@pytest.mark.parametrize("torchrun", [False, True])
def test_train_device_index(packed, tmp_path, monkeypatch, torchrun):
    """One process trains on the ``--device`` it names, index included;
    under torchrun a ``--device`` whose index is not ``LOCAL_RANK``
    raises before any group forms."""
    from clip_finegrained_alignment_tpu_torch.models import clip as m
    monkeypatch.setattr(m, "resolve_device", torch.device)

    def built(cfg, state_dict, device, **kw):
        raise _Built(device)
    monkeypatch.setattr(engine, "Trainer", built)
    args = _train_args(tmp_path, "--packed", packed)
    args[args.index("--device") + 1] = "cuda:1"
    if not torchrun:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(_Built) as e:
            cli_train.main(args)
        assert e.value.args[0] == torch.device("cuda", 1)
        return
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="cuda:1 but LOCAL_RANK 0"):
        cli_train.main(args)
    assert not torch.distributed.is_initialized()


def test_evaluate_refuses_a_data_parallel_run_of_one_process(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli_eval.main(["countbench", "--model", "tiny", "--device", "cpu",
                       "--dataset", "procedural", "--data-parallel", "2",
                       "--output-dir", str(tmp_path)])
    assert "torchrun" in str(e.value.code)
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "countbench_results.npy")

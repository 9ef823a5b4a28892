"""End-to-end "learn to count" on the card, the port of
``perf/e2e_learn_to_count.sh``: procedural counting data → the
counterfactual count fine-tune from random weights → the accuracy
trajectory and its gates → the CountBench-fixture evaluation, random
weights against trained.

    python -m clip_finegrained_alignment_tpu_torch.perf.e2e_learn_to_count \\
        [--out DIR] [--samples 2048] [--epochs 30] [--model ViT-B/32] \\
        [--lr 1e-4] [--min-acc 0.25]

Stages, as the JAX script's:

1. ``cli/generate_data.py --procedural --max-objects 10 --size-category
   small --annotation-mode count --seed 7 --visualize 4`` (the previews
   are matplotlib plots: left out where it is not installed, as on the
   card's host; ``--data DIR`` takes an existing procedural dataset
   instead);
2. ``cli/train.py --loss-type count --optimizer adamw --lr LR
   --weight-decay 0.01 --batch-size 32 --grad-accum 4`` for ``--epochs``,
   with the per-epoch counting evaluation: ``eval/batch_eval.py::
   evaluate_batch`` in fp32 on the held-out batch (the first batch of
   epoch 0, as ``cli/train.py --eval-every-epoch`` takes it) at step 0 and
   after every epoch, each row appended to ``OUT/metrics.jsonl`` as
   ``count_eval_accuracy``;
3. the trajectory table and the gates: ``best > --min-acc`` (the JAX
   gate) and ``best - anchor >= --min-gain`` (the anchor is step 0's
   accuracy, which a count-word prior can lift above chance);
4. ``make_countbench_fixture(OUT/cb_fixture, 200 samples, seed 11)``
   through ``cli/evaluate.py countbench --confidence 0.2 --margin 0.01
   --format word --position first``, with random weights and with the
   trained ``best/``.

``--eval-every-epoch`` writes a confusion plot at every evaluation, and
the card's host has no matplotlib; so stage 2 trains one epoch a
``cli/train.py`` call, each call after the first resuming (step-exact)
from the last call's ``epoch_<n>/`` (``--save-every 1``, where the JAX
script passes 1000; the CLI keeps the newest three), and evaluates the
returned trainer's model with no plot. The step-0 anchor is a call with
``--epochs 0``. The trajectory equals what ``--eval-every-epoch`` logs
on the same run. Left out: ``--unstack-layers --remat 0`` (TPU knobs).

Prints the stages' lines, then ONE JSON line (returned by :func:`main`):
the trajectory, the anchor, best, the gates, each epoch's loss, pairs/s
and seconds, the CountBench-fixture metrics of both sides, ``device`` and
``gpu`` (the card's name and power limit). A failed gate raises
``SystemExit`` after the line. The device is the card; ``--device cpu``
is for the tests (with ``--model tiny``, ``--image-size 64``, a smaller
``--batch-size`` and ``--grad-accum``, ``--no-amp``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import time
from typing import List, Optional

from . import _drill
from ._measure import device_fields
from ..models.clip import resolve_device

EXPERIMENT = "e2e_count"
COUNTBENCH_FLAGS = ["--confidence", "0.2", "--margin", "0.01", "--format",
                    "word", "--position", "first"]


def countbench(out: str, model: str, checkpoint: Optional[str],
               fixture: str, side: str, device) -> dict:
    """Stage 4 for one side: ``cli/evaluate.py countbench`` on the
    fixture, its metrics."""
    from ..cli import evaluate
    with _drill.hash_tokenizer():
        return evaluate.main(
            ["countbench", "--model", model, "--dataset", fixture,
             *COUNTBENCH_FLAGS, "--output-dir",
             os.path.join(out, f"cb_{side}"), "--device", str(device)]
            + (["--checkpoint", checkpoint] if checkpoint else []))


def run(out: str, samples: int = 2048, epochs: int = 30,
        model: str = "ViT-B/32", lr: float = 1e-4, min_acc: float = 0.25,
        min_gain: float = 0.25, batch_size: int = 32, grad_accum: int = 4,
        image_size: int = 224, cb_samples: int = 200, amp: bool = True,
        data: Optional[str] = None, device="cuda") -> dict:
    """The four stages; returns the JSON line's fields."""
    import torch

    from ..data import fixtures
    from ..eval.batch_eval import evaluate_batch
    from ..utils.logging import MetricsLogger

    device = resolve_device(device)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t_start = time.time()
    line = {"drill": "e2e_learn_to_count", "model": model,
            "samples": samples, "epochs": epochs}

    if data is None:
        print(f"== stage 1: procedural counting dataset ({samples} "
              "samples) ==", flush=True)
        # The previews are matplotlib plots: written where it is installed.
        plots = importlib.util.find_spec("matplotlib") is not None
        anns = _drill.generate(
            os.path.join(out, "data"), samples, 7, image_size,
            ["--max-objects", "10", "--size-category", "small",
             "--annotation-mode", "count"]
            + (["--visualize", "4"] if plots else []))
    else:
        anns = os.path.join(data, "synthetic_annotations.json")
        print(f"== stage 1: the procedural dataset in {data} ==",
              flush=True)
    line["data_s"] = time.time() - t_start

    print(f"== stage 2: counterfactual count fine-tune ({model}, random "
          "init) ==", flush=True)
    ckpt = os.path.join(out, "ckpt")
    metrics_file = os.path.join(out, "metrics.jsonl")
    base = ["--annotations", anns, "--model", model, "--loss-type", "count",
            "--optimizer", "adamw", "--lr", str(lr), "--weight-decay",
            "0.01", "--batch-size", str(batch_size), "--grad-accum",
            str(grad_accum), "--experiment-name", EXPERIMENT,
            "--checkpoint-dir", ckpt, "--metrics-file", metrics_file,
            "--save-every", "1"] + ([] if amp else ["--no-amp"])
    exp = os.path.join(ckpt, EXPERIMENT)
    accs, rows = [], {"epoch_losses": [], "epoch_pairs_per_s": [],
                      "epoch_s": [], "eval_s": []}
    log = MetricsLogger(metrics_file, echo=False)
    held, model_cfg = None, None
    try:
        for epoch in range(-1, epochs):   # -1: the step-0 anchor
            argv = base + ["--epochs", str(epoch + 1)]
            if epoch > 0:
                argv += ["--resume", os.path.join(exp, f"epoch_{epoch - 1}")]
            res, summary = _drill.train(argv, device)
            trainer = res["trainer"]
            if held is None:
                held = next(iter(res["pipeline"].epoch(0)))
                model_cfg = trainer.model_cfg
            for k in ("epoch_losses", "epoch_pairs_per_s", "epoch_s"):
                rows[k] += summary[k]
            t0 = time.time()
            acc, _, _ = evaluate_batch(trainer.model, model_cfg, held,
                                       device=device, dtype=torch.float32)
            rows["eval_s"].append(time.time() - t0)
            log.log(trainer.global_step, count_eval_accuracy=acc)
            accs.append((trainer.global_step, acc))
            print(f"{'pre-training' if epoch < 0 else f'epoch {epoch}'} "
                  f"counting-eval accuracy: {acc:.3f}", flush=True)
            del res, trainer
            _drill.release(device)
    finally:
        log.close()
    line.update(rows)
    line["train_s"] = time.time() - t_start - line["data_s"]

    print("== stage 3: accuracy trajectory ==", flush=True)
    print(f"{'step':>6}  count_eval_accuracy")
    for step, acc in accs:
        print(f"{step:>6}  {acc:.3f}")
    anchor, best = accs[0][1], max(a for _, a in accs)
    print("\nexchangeable chance = 0.100 (the pre-train anchor can sit "
          "above it: candidates differ in one token, so a count-word "
          "prior independent of the image biases a random-init model)")
    print(f"pre-train anchor = {anchor:.3f}; best = {best:.3f}; gain = "
          f"{best - anchor:.3f}", flush=True)
    line.update(trajectory=[[s, a] for s, a in accs], anchor=anchor,
                best=best, gain=best - anchor,
                losses_finite=all(map(math.isfinite, rows["epoch_losses"])),
                above_min_acc=best > min_acc,
                gain_at_least_min=best - anchor >= min_gain,
                min_acc=min_acc, min_gain=min_gain)

    print("== stage 4: CountBench-fixture eval, random init vs trained ==",
          flush=True)
    t0 = time.time()
    fixtures.make_countbench_fixture(os.path.join(out, "cb_fixture"),
                                     num_samples=cb_samples,
                                     image_size=image_size, seed=11)
    fixture = os.path.join(out, "cb_fixture", "countbench_fixture.json")
    best_dir = os.path.join(exp, "best")
    print(f"trained checkpoint: {best_dir}")
    cb = {side: countbench(out, model, ckpt_dir, fixture, side, device)
          for side, ckpt_dir in (("random", None), ("trained", best_dir))}
    for k in ("accuracy", "argmax_accuracy"):
        print(f"{k}: random-init {cb['random'][k]:.3f} -> trained "
              f"{cb['trained'][k]:.3f}")
    line["countbench"] = {side: {k: m[k] for k in (
        "accuracy", "argmax_accuracy", "total_samples", "correct")}
        for side, m in cb.items()}
    line["countbench_s"] = time.time() - t0
    line["seconds"] = time.time() - t_start
    line.update(device_fields(device))
    return line


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=_drill.default_out("e2e_count"))
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--model", default="ViT-B/32")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--min-acc", type=float, default=0.25,
                    help="the JAX gate: best accuracy above this")
    ap.add_argument("--min-gain", type=float, default=0.25,
                    help="best accuracy minus the step-0 anchor at least "
                         "this")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--grad-accum", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=224,
                    help="procedural frame size (data and fixture)")
    ap.add_argument("--cb-samples", type=int, default=200,
                    help="CountBench-fixture samples")
    ap.add_argument("--no-amp", action="store_true",
                    help="train in fp32 (cli/train.py --no-amp)")
    ap.add_argument("--data", default=None, metavar="DIR",
                    help="an existing procedural dataset: skips stage 1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = run(args.out, args.samples, args.epochs, args.model, args.lr,
               args.min_acc, args.min_gain, args.batch_size, args.grad_accum,
               args.image_size, args.cb_samples, not args.no_amp, args.data,
               args.device)
    print(json.dumps(line), flush=True)
    if not line["losses_finite"]:
        raise SystemExit(f"a loss is not finite: {line['epoch_losses']}")
    if not (line["above_min_acc"] and line["gain_at_least_min"]):
        raise SystemExit(
            f"no learning signal: best {line['best']:.3f} (gate > "
            f"{args.min_acc}), gain {line['gain']:.3f} over the anchor "
            f"(gate >= {args.min_gain}) — demonstration FAILED")
    print("learning demonstrated: counting accuracy rose well above the "
          "anchor", flush=True)
    return line


if __name__ == "__main__":
    main()

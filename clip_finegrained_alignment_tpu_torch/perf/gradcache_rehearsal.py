"""GradCache rehearsal on the card, the port of
``perf/gradcache_rehearsal_r5.sh``: the contrastive negative pool grows
256 → 512 → 1024 (microbatch 32 × accum 8 / 16 / 32 under
``--grad-cache``) at one chunk's activation memory, with what each pool
costs in pairs/s; and the objective A/B: plain accumulation at accum 16
against GradCache at accum 16 on the same data, seed and learning rate
must give different losses (plain trains per-chunk 32-negative InfoNCE,
GradCache the whole pool's).

    python -m clip_finegrained_alignment_tpu_torch.perf.gradcache_rehearsal \\
        [--out DIR] [--samples 2048] [--epochs 4] [--runs plain_a16 ...]

Stage 1 generates ``--samples`` procedural 224 px images (seed 11) and
packs them for ViT-B/16 SPARC (``cli/pack_dataset.py``; ``--packed DIR``
takes an existing pack instead). Stage 2 runs, in this process, each of
``--runs`` (default ``plain_a16 gc_a8 gc_a16 gc_a32``: ``gc_`` adds
``--grad-cache``, ``aN`` is ``--grad-accum N``) as ``cli/train.py
--packed PACK --device-data --model ViT-B/16 --loss-type sparc
--optimizer adamspd --batch-size 32 --epochs 4 --lr 1e-4
--global-negatives`` (one process: every collective of a one-device mesh
is the identity, as in JAX).

Prints each run's epoch losses, pairs/s (synced epoch timings) and peak
memory (``torch.cuda.max_memory_allocated``, reset before each run's
first step), then ONE JSON line (returned by :func:`main`) with the runs,
whether ``plain_a16``'s and ``gc_a16``'s losses differ, ``device`` and
``gpu`` (the card's name and power limit). Where both ran and their
losses are equal, it raises ``SystemExit`` after the line. The device is
the card; ``--device cpu`` is for the tests (``--model tiny``,
``--image-size 64``, a smaller ``--batch-size``, ``--no-amp``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from typing import List, Optional, Sequence

from . import _drill
from ._measure import device_fields
from ..models.clip import resolve_device

RUNS = ("plain_a16", "gc_a8", "gc_a16", "gc_a32")


def run_flags(name: str) -> List[str]:
    """``plain_aN`` / ``gc_aN`` → ``--grad-accum N`` (and
    ``--grad-cache``)."""
    kind, accum = name.split("_a")
    if kind not in ("plain", "gc") or not accum.isdigit():
        raise ValueError(f"run {name!r}: expected plain_aN or gc_aN")
    return ["--grad-accum", accum] + (["--grad-cache"] if kind == "gc"
                                      else [])


def run(out: str, samples: int = 2048, epochs: int = 4,
        runs: Sequence[str] = RUNS, model: str = "ViT-B/16",
        batch_size: int = 32, lr: float = 1e-4, image_size: int = 224,
        amp: bool = True, packed: Optional[str] = None,
        device="cuda") -> dict:
    """The two stages; returns the JSON line's fields."""
    device = resolve_device(device)
    flags = [run_flags(name) for name in runs]   # refuse bad names first
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t_start = time.time()
    line = {"drill": "gradcache_rehearsal", "model": model,
            "samples": samples, "epochs": epochs, "batch_size": batch_size}
    if packed is None:
        print(f"=== data: {samples} procedural {image_size}px samples ===",
              flush=True)
        anns = _drill.generate(os.path.join(out, "data"), samples, 11,
                               image_size)
        print("=== pack (decode once; --device-data keeps the feed on the "
              "device) ===", flush=True)
        packed = _drill.pack(anns, os.path.join(out, "pack"), model, "sparc")
    line["data_s"] = time.time() - t_start

    line["runs"] = {}
    for name, extra in zip(runs, flags):
        print(f"=== {name}: {model} sparc mb{batch_size} x accum "
              f"{extra[1]} {' '.join(extra[2:])} ===", flush=True)
        t0 = time.time()
        res, summary = _drill.train(
            ["--packed", packed, "--device-data", "--model", model,
             "--loss-type", "sparc", "--optimizer", "adamspd",
             "--batch-size", str(batch_size), "--epochs", str(epochs),
             "--lr", str(lr), "--global-negatives", "--experiment-name",
             name, "--checkpoint-dir", os.path.join(out, "ckpt"),
             "--metrics-file", os.path.join(out, f"{name}.jsonl"), *extra]
            + ([] if amp else ["--no-amp"]), device)
        summary.update(pool=batch_size * int(extra[1]),
                       grad_cache=res["trainer"].cfg.grad_cache,
                       run_s=time.time() - t0)
        line["runs"][name] = summary
        peak = summary["peak_memory_gb"]
        print(f"{name}: pool {summary['pool']}, epoch losses "
              f"{summary['epoch_losses']}, pairs/s "
              f"{[round(r, 1) for r in summary['epoch_pairs_per_s']]}, "
              f"peak {'n/a' if peak is None else f'{peak:.2f} GB'}",
              flush=True)
        del res
        _drill.release(device)
    ab = ("plain_a16", "gc_a16")
    if all(n in line["runs"] for n in ab):
        plain, gc = (line["runs"][n]["epoch_losses"] for n in ab)
        line["objectives_differ"] = plain != gc
        line["loss_gap"] = [g - p for p, g in zip(plain, gc)]
        print(f"plain_a16 vs gc_a16 losses differ: "
              f"{line['objectives_differ']} (gc - plain {line['loss_gap']})",
              flush=True)
    line["seconds"] = time.time() - t_start
    line.update(device_fields(device))
    return line


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=_drill.default_out("gc5"))
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--runs", nargs="+", default=list(RUNS),
                    help="plain_aN | gc_aN, in order")
    ap.add_argument("--model", default="ViT-B/16")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--image-size", type=int, default=224,
                    help="procedural frame size")
    ap.add_argument("--no-amp", action="store_true",
                    help="train in fp32 (cli/train.py --no-amp)")
    ap.add_argument("--packed", default=None, metavar="DIR",
                    help="an existing SPARC pack for --model: skips the "
                         "data stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = run(args.out, args.samples, args.epochs, args.runs, args.model,
               args.batch_size, args.lr, args.image_size, not args.no_amp,
               args.packed, args.device)
    print(json.dumps(line), flush=True)
    losses = [x for r in line["runs"].values() for x in r["epoch_losses"]]
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"a loss is not finite: {losses}")
    if line.get("objectives_differ") is False:
        raise SystemExit("plain_a16 and gc_a16 gave the same losses: "
                         "GradCache did not change the objective")
    return line


if __name__ == "__main__":
    main()

"""Packed-ingest rehearsal on the card, the port of
``perf/packed_rehearsal_r5.sh``: ViT-B/16 SPARC + AdamSPD at microbatch
32 × accum 8 on decode-free packed data with the uint8 pixel bank on the
card (``--packed --device-data``), each epoch's pairs/s from synced
timings.

    python -m clip_finegrained_alignment_tpu_torch.perf.packed_rehearsal \\
        [--out DIR] [--samples 8192] [--epochs 3]

Stage 1 generates ``--samples`` procedural 224 px images (seed 7) and
packs them for ViT-B/16 SPARC on the host (``cli/pack_dataset.py``;
``--packed DIR`` takes an existing pack instead). Stage 2 is, in this
process, ``cli/train.py --packed PACK --device-data --model ViT-B/16
--loss-type sparc --optimizer adamspd --batch-size 32 --grad-accum 8
--epochs 3 --lr 2e-5``.

Prints the stages' seconds, each epoch's loss and pairs/s, the CLI's
done line, then ONE JSON line (returned by :func:`main`): the epochs,
the pixel bank's size and device, the peak memory, ``device`` and
``gpu`` (the card's name and power limit). The device is the card;
``--device cpu`` is for the tests (``--model tiny``, ``--image-size
64``, a smaller ``--batch-size`` and ``--grad-accum``, ``--no-amp``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from typing import List, Optional

from . import _drill
from ._measure import device_fields
from ..models.clip import resolve_device


def run(out: str, samples: int = 8192, epochs: int = 3,
        model: str = "ViT-B/16", batch_size: int = 32, grad_accum: int = 8,
        lr: float = 2e-5, image_size: int = 224, amp: bool = True,
        packed: Optional[str] = None, device="cuda") -> dict:
    """The two stages; returns the JSON line's fields."""
    device = resolve_device(device)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t_start = time.time()
    line = {"drill": "packed_rehearsal", "model": model, "samples": samples,
            "epochs": epochs, "batch_size": batch_size,
            "grad_accum": grad_accum}
    if packed is None:
        print(f"=== data: {samples} procedural {image_size}px samples ===",
              flush=True)
        anns = _drill.generate(os.path.join(out, "data"), samples, 7,
                               image_size)
        line["generate_s"] = time.time() - t_start
        print("=== pack (decode once, host) ===", flush=True)
        t0 = time.time()
        packed = _drill.pack(anns, os.path.join(out, "pack"), model, "sparc")
        line["pack_s"] = time.time() - t0

    print(f"=== train --packed --device-data: mb{batch_size} x accum "
          f"{grad_accum}, {epochs} epochs ===", flush=True)
    t0 = time.time()
    res, summary = _drill.train(
        ["--packed", packed, "--device-data", "--model", model,
         "--loss-type", "sparc", "--optimizer", "adamspd", "--batch-size",
         str(batch_size), "--grad-accum", str(grad_accum), "--epochs",
         str(epochs), "--lr", str(lr), "--experiment-name",
         "packed_devdata", "--checkpoint-dir", os.path.join(out, "ckpt")]
        + ([] if amp else ["--no-amp"]), device)
    bank = res["trainer"].pixel_bank
    summary.update(run_s=time.time() - t0,
                   pixel_bank={"device": str(bank.device),
                               "shape": list(bank.shape),
                               "gb": bank.numel() / 1e9})
    for e, (loss, rate) in enumerate(zip(summary["epoch_losses"],
                                         summary["epoch_pairs_per_s"])):
        print(f"epoch {e}: loss {loss:.4f}, {rate:.1f} pairs/s (synced)",
              flush=True)
    del res, bank
    _drill.release(device)
    line.update(summary)
    line["seconds"] = time.time() - t_start
    line.update(device_fields(device))
    return line


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=_drill.default_out("pk5"))
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--model", default="ViT-B/16")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--grad-accum", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--image-size", type=int, default=224,
                    help="procedural frame size")
    ap.add_argument("--no-amp", action="store_true",
                    help="train in fp32 (cli/train.py --no-amp)")
    ap.add_argument("--packed", default=None, metavar="DIR",
                    help="an existing SPARC pack for --model: skips the "
                         "data stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = run(args.out, args.samples, args.epochs, args.model,
               args.batch_size, args.grad_accum, args.lr, args.image_size,
               not args.no_amp, args.packed, args.device)
    print(json.dumps(line), flush=True)
    if not all(map(math.isfinite, line["epoch_losses"])):
        raise SystemExit(f"a loss is not finite: {line['epoch_losses']}")
    return line


if __name__ == "__main__":
    main()

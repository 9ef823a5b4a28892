"""fp32 training through ``cli/train.py`` on the card, timed: the count
fine-tune in forced fp32 (``--loss-type count --optimizer adamw
--no-amp``), as ``chip_smoke.py`` phase 8 runs it (run D).

    python -m clip_finegrained_alignment_tpu_torch.perf.train_cli_fp32

Run from the repository root on the card. It makes the procedural 224 px
dataset (:data:`SAMPLES`) with the port's ``cli/generate_data.py`` in a
temporary directory, trains ViT-B/16 at full width on it for
:data:`EPOCHS` epochs (random weights from seed 0, microbatch 32 x accum
2, live decode, no checkpoints kept; the second epoch runs warm), and prints
one JSON line: each epoch's pairs/s on the host clock (data included) and
step ms (epoch seconds / steps), the mean losses, peak device memory, the
attention kernels' launches, and the device time by kernel of one more
step (``torch.profiler``), with the port's kernels (#1 ``attention_fwd``,
#2 ``attention_bwd``) summed by name; then the card's name and power
limit. It takes the package and ``chip_smoke.py`` from the directory it
runs in, so the same file copied into an older checkout, whose
``chip_smoke.py`` has no run D, and run from its root times that
checkout's kernels: that is what it is for. Its ``cli/train.py``
arguments must stay those of ``chip_smoke.py``'s run D but for
``--epochs``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

EPOCHS = 2
SAMPLES = 512   # chip_smoke.py's CLI_SAMPLES: 8 steps an epoch


def main() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the run times the card")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    from clip_finegrained_alignment_tpu_torch.cli import generate_data
    from clip_finegrained_alignment_tpu_torch.cli import train as cli_train
    from clip_finegrained_alignment_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["CFA_ALLOW_HASH_TOKENIZER"] = "1"
    work = tempfile.mkdtemp(prefix="cfa_train_fp32_")
    try:
        data = os.path.join(work, "data")
        generate_data.main(["--procedural", "--output-dir", data,
                            "--num-samples", str(SAMPLES),
                            "--image-size", "224", "--seed", "0"])
        _build.reset_launch_counts()
        res = cli_train.main([
            "--model", "ViT-B/16", "--loss-type", "count", "--optimizer",
            "adamw", "--no-amp", "--batch-size", "32", "--grad-accum", "2",
            "--epochs", str(EPOCHS), "--annotations",
            os.path.join(data, "synthetic_annotations.json"),
            "--checkpoint-dir", os.path.join(work, "ckpt"),
            "--experiment-name", "count_fp32", "--seed", "0",
            "--log-every", "100"])
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        hist = res["history"]
        steps = res["trainer"].global_step // len(hist)
        batch = next(iter(res["pipeline"].epoch(0)))
        profile = smoke.kernel_table(lambda: res["trainer"].step(batch))
        out = {"epochs": len(hist), "steps_per_epoch": steps,
               "epoch_pairs_per_s": [h["pairs_per_sec"] for h in hist],
               "step_ms": [h["seconds"] / steps * 1e3 for h in hist],
               "epoch_losses": [h["avg_loss"] for h in hist],
               "peak_memory_gb": res["peak_memory_bytes"] / 1e9,
               "launches": {k: launches[k] for k in ("attention_fwd",
                                                     "attention_bwd")},
               "profiled_step": profile, "gpu": smoke.gpu_line()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)
    print(out["gpu"], flush=True)
    return out


if __name__ == "__main__":
    main()

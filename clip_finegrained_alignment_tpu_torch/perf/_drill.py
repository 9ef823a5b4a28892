"""What the hardware drills (``perf/e2e_learn_to_count.py``,
``perf/preempt_rehearsal.py``, ``perf/gradcache_rehearsal.py``,
``perf/packed_rehearsal.py``) share. Each drives the port's CLIs in this
process, as the JAX package's shell drills drive its CLIs one process a
command:

* :func:`hash_tokenizer`: the CLIs' hermetic hash tokenizer
  (``CFA_ALLOW_HASH_TOKENIZER=1``, which the JAX drills set for every
  command), the environment put back afterwards;
* :func:`generate`: ``cli/generate_data.py --procedural``;
* :func:`pack`: ``cli/pack_dataset.py``;
* :func:`train`: ``cli/train.py``'s ``main`` and what its epochs read
  (losses, pairs/s from the synced epoch timings, seconds, the card's
  peak memory, which the CLI resets before its first step);
* :func:`release`: what a finished run left on the card, freed;
* :func:`default_out`: a drill's working directory under the temporary
  directory (``TMPDIR``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
from typing import Any, Dict, Sequence, Tuple


def default_out(name: str) -> str:
    """``<tempdir>/<name>``: the JAX drill's ``/tmp/<name>``, under
    ``TMPDIR`` where it is set."""
    return os.path.join(tempfile.gettempdir(), name)


@contextlib.contextmanager
def hash_tokenizer():
    """``CFA_ALLOW_HASH_TOKENIZER=1`` while the block runs: no BPE
    vocabulary is available offline."""
    prev = os.environ.get("CFA_ALLOW_HASH_TOKENIZER")
    os.environ["CFA_ALLOW_HASH_TOKENIZER"] = "1"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("CFA_ALLOW_HASH_TOKENIZER", None)
        else:
            os.environ["CFA_ALLOW_HASH_TOKENIZER"] = prev


def generate(out_dir: str, samples: int, seed: int, image_size: int,
             extra: Sequence[str] = ()) -> str:
    """A procedural dataset of ``samples`` ``image_size`` px images in
    ``out_dir``; returns its annotations file."""
    from ..cli import generate_data
    generate_data.main(["--procedural", "--output-dir", out_dir,
                        "--num-samples", str(samples), "--image-size",
                        str(image_size), "--seed", str(seed), *extra])
    return os.path.join(out_dir, "synthetic_annotations.json")


def pack(annotations: str, out_dir: str, model: str,
         loss_type: str) -> str:
    """``annotations`` packed for ``model`` and ``loss_type`` into
    ``out_dir`` (returned)."""
    from ..cli import pack_dataset
    with hash_tokenizer():
        pack_dataset.main(["--annotations", annotations, "--output",
                           out_dir, "--model", model, "--loss-type",
                           loss_type])
    return out_dir


def train(argv: Sequence[str], device) -> Tuple[Dict[str, Any], dict]:
    """``cli/train.py`` on ``device`` in this process; returns its result
    and a summary: the steps, each epoch's loss, pairs/s (synced epoch
    timings) and seconds, and the card's peak memory in GB (null on the
    CPU)."""
    from ..cli import train as train_cli
    with hash_tokenizer():
        res = train_cli.main([*argv, "--device", str(device)])
    hist, peak = res["history"], res.get("peak_memory_bytes")
    return res, {"steps": res["trainer"].global_step,
                 "epoch_losses": [h["avg_loss"] for h in hist],
                 "epoch_pairs_per_s": [h["pairs_per_sec"] for h in hist],
                 "epoch_s": [h["seconds"] for h in hist],
                 "peak_memory_gb": None if peak is None else peak / 1e9}


def release(device) -> None:
    """Free what a finished run left on the card (call after dropping its
    result)."""
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()

"""Serving-path throughput: the port of ``perf/serve_bench.py``.

``models/inference.py::CLIPInference``'s device forwards
(``embed_images_device`` on uint8 pixels already on the card: the
on-device rescale and normalize, the vision tower in bf16, the unit
norm; ``embed_texts_device`` on token ids) at one batch, random weights
(``models/convert.py::random_params``, seed 0) and ``serve_bench.py``'s
inputs (:func:`inputs`, ``default_rng(0)``). These are the forwards every
evaluator and the server's batcher run. Each modality: one warm-up call,
then the mean of ``iters`` back-to-back calls between two CUDA events.
Host transfers are not timed (``chip_smoke.py`` phase 5 reads the
host-clock rate through ``CLIPInference.embed_images`` beside it).

    python -m clip_finegrained_alignment_tpu_torch.perf.serve_bench \\
        [model] [batch] [iters]

Defaults: ViT-B/16, batch 512, 20 iterations. Prints one JSON line per
modality with ``serve_bench.py``'s keys (``metric``
``serve_embed_{image,text}_throughput_<model>``, ``value``, ``unit``,
``batch``, ``ms_per_batch``), the model FLOP rate
(``utils/flops.py``), ``device`` and ``gpu`` (the card's name and power
limit). ``--device cpu`` is for the tests (the host clock there).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.clip import resolve_device
from ._measure import device_fields, time_ms


def inputs(cfg, batch: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``serve_bench.py``'s draws in its order: uint8 pixels [batch, S, S,
    3], then ids [batch, T] with EOS last."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    px = rng.integers(0, 256, size=(batch, v.image_size, v.image_size, 3)
                      ).astype(np.uint8)
    ids = rng.integers(1, t.vocab_size - 2,
                       size=(batch, t.max_position_embeddings)
                       ).astype(np.int32)
    ids[:, -1] = t.eos_token_id
    return px, ids


def measure(inf, pixels, ids, iters: int, tag: str) -> Tuple[
        List[dict], Dict[str, object]]:
    """The two modalities' lines for ``inf`` (a ``CLIPInference``) on
    ``pixels`` and ``ids`` (tensors on its device), and the embeddings the
    last call of each returned."""
    from ..utils import flops
    device, cfg = inf.device, inf.cfg
    batch = pixels.shape[0]
    lines, embeds = [], {}
    for name, fn, x, per_item in (
            ("image", inf.embed_images_device, pixels,
             flops.image_forward_flops(cfg)),
            ("text", inf.embed_texts_device, ids,
             flops.text_forward_flops(cfg))):
        ms = time_ms(lambda: embeds.__setitem__(name, fn(x)), device,
                     reps=iters)
        lines.append({"metric": f"serve_embed_{name}_throughput_{tag}",
                      "value": batch / ms * 1e3, "unit": f"{name}s/sec/chip",
                      "batch": batch, "ms_per_batch": ms,
                      "model_tflops_per_s": batch * per_item / ms / 1e9
                      if device.type == "cuda" else None,
                      **device_fields(device)})
    return lines, embeds


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", default="ViT-B/16")
    ap.add_argument("batch", nargs="?", type=int, default=512)
    ap.add_argument("iters", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from ..config import CLIPConfig
    from ..models.convert import random_params, state_dict_from_jax
    from ..models.inference import CLIPInference

    device = resolve_device(args.device)
    cfg = CLIPConfig.from_name(args.model)
    inf = CLIPInference(state_dict_from_jax(random_params(cfg, 0), cfg), cfg,
                        batch_bucket=args.batch, device=device)
    px, ids = inputs(cfg, args.batch)
    tag = args.model.lower().replace("-", "").replace("/", "")
    lines, _ = measure(inf, torch.from_numpy(px).to(device),
                       torch.from_numpy(ids).to(device), args.iters, tag)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()

"""Headline benchmark: SPARC + AdamSPD fine-tune throughput (pairs/s on
one card), the port of ``bench.py``.

The full train step (``train/engine.py::make_train_step``: CLIP forward
of both towers, SPARC loss, backward, clip, AdamSPD update) in bf16
compute on fp32 master weights, on random weights
(``models/convert.py::random_params``, seed 0) and ``bench.py``'s random
batch (:func:`bench_batch`, ``default_rng(0)``), moved to the card once.
One untimed warm-up step, then ``steps`` steps timed on the host clock
from the first launch to ``torch.cuda.synchronize()`` after the last;
with ``BENCH_SYNC=chain`` (the default) nothing is read until the last
step (the step's metrics are 0-dim device tensors), with ``step`` the
loss is read after every step.

    python -m clip_finegrained_alignment_tpu_torch.perf.bench [batch] [steps]

Knobs (``bench.py``'s): ``BENCH_MODEL`` (default ViT-B/16), ``BENCH_LOSS``
(``sparc`` | ``count``: the counterfactual count loss, 9 extra captions a
pair), ``BENCH_ACCUM``, ``BENCH_QUANT`` (``none`` | ``switchback`` |
``int8``: ``TrainConfig.quant``), ``BENCH_SYNC`` (``chain`` | ``step``)
and ``BENCH_PEAK_TFLOPS`` (default 989, the H100 SXM's dense bf16 peak).
The regime (:func:`regime`): ViT-B/32 runs microbatch 128 × accum 4,
every other model 32 × 8, and the count loss 32 × 8 on every model.
``argv`` ``[batch] [steps]`` (default: the regime's microbatch, 30
steps). ``bench.py``'s ``BENCH_PALLAS``, ``BENCH_FUSED_SPARC``,
``BENCH_REMAT``, ``BENCH_UNROLL``, ``BENCH_ACCUM_UNROLL`` and
``BENCH_UNSTACK`` have no counterpart: the card always runs the port's
kernels, and the layers are never scanned or rematerialized.

Prints ONE JSON line with ``bench.py``'s keys (``metric``, ``value`` in
pairs/s, ``unit``, ``vs_baseline``, ``step_ms``, ``mfu`` over
``BENCH_PEAK_TFLOPS``, ``tflops_per_step`` and ``gflops_per_pair`` from
``utils/flops.py``, ``baseline_basis``) and ``device``, ``gpu`` (the
card's name and power limit), ``steps`` and ``peak_memory_gb``. The
device is the card; ``--device cpu`` is for the tests, and there every
device metric (``mfu``, ``vs_baseline``, ``peak_memory_gb``) is null.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.clip import resolve_device
from ._measure import PEAK_BF16_FLOPS, device_fields, synchronize

ESTIMATED_REFERENCE_PAIRS_PER_SEC = 500.0  # A100, reference torch stack
BASELINE_BASIS = (
    "reference publishes no numbers; 500 pairs/s = 20% MFU of A100 "
    "312 TFLOP/s bf16 peak on the ViT-B/16 124 GFLOPs/pair workload "
    "(0.20*312e12/124e9=503; utils/flops.py, BASELINE.md roofline). "
    "Eager-mode fine-tune MFU is typically 10-15%, so the denominator "
    "over-credits the reference stack.")


def regime(model_name: str, loss: str) -> Tuple[int, int]:
    """``bench.py``'s (microbatch, accum): ViT-B/32 128 × 4 under SPARC,
    everything else 32 × 8."""
    if loss == "sparc" and model_name == "ViT-B/32":
        return 128, 4
    return 32, 8


def metric_name(model_name: str, loss: str) -> str:
    """``sparc_spd_finetune_throughput_vitb16`` and the like."""
    return (f"{loss}_spd_finetune_throughput_"
            + model_name.lower().replace("-", "").replace("/", ""))


def step_flops(cfg, loss: str, pairs: int) -> float:
    """Model FLOPs of one train step over ``pairs`` pairs
    (``utils/flops.py``)."""
    from ..utils import flops
    if loss == "count":
        return flops.count_train_step_flops(cfg, pairs)
    return flops.sparc_train_step_flops(cfg, pairs)


def bench_batch(cfg, accum: int, B: int, loss: str,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """``bench.py:126-143``'s numpy draws in its order: ids [accum, B, T]
    with EOS last, normal pixels [accum, B, S, S, 3] fp32, and for the
    count loss 9 counterfactual captions a pair."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    ids = rng.integers(1, t.vocab_size - 2,
                       size=(accum, B, t.max_position_embeddings)
                       ).astype(np.int32)
    ids[..., -1] = t.eos_token_id
    batch = {"pixel_values": rng.normal(
        size=(accum, B, v.image_size, v.image_size, 3)).astype(np.float32),
             "input_ids": ids}
    if loss == "count":
        cf = rng.integers(1, t.vocab_size - 2,
                          size=(accum, B, 9, t.max_position_embeddings)
                          ).astype(np.int32)
        cf[..., -1] = t.eos_token_id
        batch["cf_input_ids"] = cf
    return batch


def build(model_name: str, loss: str, B: int, accum: int, quant: str,
          device, seed: int = 0, use_amp: bool = True) -> dict:
    """``bench.py``'s model and step: the config, the train model on
    ``device`` from ``random_params(cfg, seed)``, AdamSPD anchored at the
    initial weights, the step, and the batch on ``device``."""
    import torch

    from ..config import CLIPConfig, TrainConfig
    from ..models import clip as m
    from ..models.convert import random_params, state_dict_from_jax
    from ..optim.factory import make_optimizer
    from ..train.engine import make_train_step

    cfg = CLIPConfig.from_name(model_name)
    tcfg = TrainConfig(clip_model=model_name, loss_type=loss,
                       optimizer_type="adamspd", inverse_temperature=0.07,
                       batch_size=B, gradient_accumulation_steps=accum,
                       use_amp=use_amp, quant=quant)
    model = m.build_train_model(
        cfg, state_dict_from_jax(random_params(cfg, seed), cfg),
        device=device)
    opt = make_optimizer(tcfg, model.named_parameters())
    batch = {k: torch.from_numpy(x).to(device)
             for k, x in bench_batch(cfg, accum, B, loss, seed).items()}
    return {"cfg": cfg, "tcfg": tcfg, "model": model, "opt": opt,
            "step": make_train_step(tcfg, cfg, model, opt), "batch": batch}


def time_steps(step, batch, steps: int, sync: str, device) -> Tuple[
        float, Dict[str, float]]:
    """Seconds on the host clock for ``steps`` steps, from the first
    launch to the device's last result, and the last step's metrics.
    ``sync``: ``chain`` reads nothing until the end, ``step`` reads the
    loss after every step."""
    if sync not in ("chain", "step"):
        raise ValueError(f"BENCH_SYNC must be chain or step, not {sync!r}")
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(batch)
        if sync == "step":
            metrics["total_loss"].item()
    last = {k: x.item() for k, x in metrics.items()}
    synchronize(device)
    seconds = time.perf_counter() - t0
    if not all(map(math.isfinite, last.values())):
        raise FloatingPointError(f"non-finite metrics after {steps} steps: "
                                 f"{last}")
    return seconds, last


def result_line(model_name: str, loss: str, cfg, pairs: int, steps: int,
                seconds: float, device,
                peak_tflops: float = PEAK_BF16_FLOPS / 1e12,
                peak_memory_gb: Optional[float] = None) -> dict:
    """``bench.py``'s JSON line for ``steps`` steps of ``pairs`` pairs in
    ``seconds``; device metrics null on the CPU."""
    on_card = device.type == "cuda"
    pairs_per_sec = pairs * steps / seconds
    flops = step_flops(cfg, loss, pairs)
    return {"metric": metric_name(model_name, loss),
           "value": pairs_per_sec, "unit": "pairs/sec/chip",
           "vs_baseline": pairs_per_sec / ESTIMATED_REFERENCE_PAIRS_PER_SEC
           if on_card else None,
           "step_ms": seconds / steps * 1e3,
           "mfu": flops * steps / seconds / (peak_tflops * 1e12)
           if on_card else None,
           "tflops_per_step": flops / 1e12,
           "gflops_per_pair": flops / pairs / 1e9,
           "baseline_basis": BASELINE_BASIS + (
               "" if loss == "sparc" and model_name == "ViT-B/16" else
               f" Same denominator convention for {model_name}/{loss} — "
               "pairs/s vs the same estimated reference stack rate."),
           **device_fields(device), "steps": steps,
           "peak_memory_gb": peak_memory_gb if on_card else None}


def run(model_name: str = "ViT-B/16", loss: str = "sparc",
        batch_size: Optional[int] = None, steps: int = 30,
        accum: Optional[int] = None, quant: str = "none",
        sync: str = "chain", device="cuda",
        peak_tflops: float = PEAK_BF16_FLOPS / 1e12) -> dict:
    """Build, one warm-up step, ``steps`` timed steps: the JSON line."""
    import torch
    device = resolve_device(device)
    B0, accum0 = regime(model_name, loss)
    B = batch_size or B0
    accum = accum or accum0
    b = build(model_name, loss, B, accum, quant, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    b["step"](b["batch"])                   # warm-up: cuBLAS, allocator
    seconds, _ = time_steps(b["step"], b["batch"], steps, sync, device)
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    return result_line(model_name, loss, b["cfg"], B * accum, steps, seconds,
                       device, peak_tflops, peak)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=None)
    ap.add_argument("steps", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env = os.environ.get
    out = run(model_name=env("BENCH_MODEL", "ViT-B/16"),
              loss=env("BENCH_LOSS", "sparc"), batch_size=args.batch,
              steps=args.steps,
              accum=int(env("BENCH_ACCUM")) if env("BENCH_ACCUM") else None,
              quant=env("BENCH_QUANT", "none"),
              sync=env("BENCH_SYNC", "chain"), device=args.device,
              peak_tflops=float(env("BENCH_PEAK_TFLOPS",
                                    PEAK_BF16_FLOPS / 1e12)))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

"""The train step, the port of ``clip_finegrained_alignment_tpu/train/
engine.py``'s single-device path (``compute_loss``, the microbatch
accumulation and ``make_train_step`` with ``mesh=None``).

* ``compute_loss`` dispatches the four objectives; the count loss encodes
  the counterfactual captions as one batched ``[B·N_cf, T]`` text forward,
  and uint8 pixels are rescaled and normalized on the device.
* The step runs a forward and a backward per microbatch of the
  ``[accum, B, …]`` batch; ``.grad`` sums the microbatch gradients and is
  scaled by 1/accum at the end, which is the JAX package's order
  (sum, then scale).
* Then ``grad_norm`` (before clipping), the global-norm clip and the
  optimizer step (``optim/factory.py``). Towers run in the compute dtype
  (bf16 by default) on fp32 master parameters; losses and the optimizer
  run in fp32.

Every encoder layer goes through ``ops/attention.py`` (forward and
backward kernels) and, under SPARC, the local term through
``ops/sparc_kernel.py``: on the card their CUDA kernels, on the CPU their
plain versions.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch

from ..config import CLIPConfig, TrainConfig
from ..core.precision import compute_dtype
from ..data.preprocess import normalize_batch
from ..models import clip as m
from ..objectives import losses as L
from ..optim.factory import ClippedOptimizer

Batch = Mapping[str, torch.Tensor]


def compute_loss(model: m.CLIPModel, batch: Batch, cfg: TrainConfig,
                 model_cfg: CLIPConfig, *,
                 dtype) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and objective for one microbatch → (total loss, loss dict).

    ``batch``: pixel_values [B, H, W, 3] (normalized float, or uint8),
    input_ids [B, T]; cf_input_ids [B, N_cf, T] for ``count``; optional
    group_input_ids [B, G, T] for ``clip_count``."""
    pixel_values = batch["pixel_values"]
    if pixel_values.dtype == torch.uint8:
        pixel_values = normalize_batch(pixel_values.float() / 255.0)
    input_ids = batch["input_ids"]
    out = m.clip_forward(model, pixel_values, input_ids, dtype=dtype)

    if cfg.loss_type == "sparc":
        v_patch, l_token = m.sparc_embeddings(model, out, dtype=dtype)
        mask = input_ids != model_cfg.text.pad_token_id
        losses = L.sparc_loss(
            v_patch, l_token, mask,
            similarity_threshold=cfg.similarity_threshold,
            global_loss_weight=cfg.global_loss_weight,
            local_loss_weight=cfg.local_loss_weight,
            inverse_temperature=cfg.inverse_temperature)
    elif cfg.loss_type == "count":
        cf = batch["cf_input_ids"]
        B, N, T = cf.shape
        ek_cf = m.encode_text(model, cf.reshape(B * N, T),
                              dtype=dtype).reshape(B, N, -1)
        losses = L.count_loss(out.logits_per_image, out.logits_per_text,
                              out.image_embeds, out.text_embeds, ek_cf,
                              alpha=cfg.count_alpha)
    elif cfg.loss_type == "clip_count":
        group = batch.get("group_input_ids")
        ek = None
        if group is not None:
            B, G, T = group.shape
            ek = m.encode_text(model, group.reshape(B * G, T),
                               dtype=dtype).reshape(B, G, -1)
        losses = L.clip_count_loss(out.image_embeds, out.text_embeds, ek,
                                   count_alpha=cfg.count_alpha)
    else:  # "clip"
        losses = L.clip_loss(out.image_embeds, out.text_embeds)
    return losses["total_loss"], losses


def accumulate_grads(model: m.CLIPModel, batch: Batch, cfg: TrainConfig,
                     model_cfg: CLIPConfig, *,
                     dtype) -> Dict[str, torch.Tensor]:
    """Forward and backward over each microbatch of ``batch`` (leaves
    ``[accum, B, …]`` on the model's device); leaves the mean gradient in
    ``.grad`` and returns the mean loss dict (detached)."""
    model.zero_grad(set_to_none=True)
    accum = batch["input_ids"].shape[0]
    totals: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        loss, losses = compute_loss(model, {k: x[i] for k, x in batch.items()},
                                    cfg, model_cfg, dtype=dtype)
        loss.backward()
        for k, x in losses.items():
            totals[k] = totals[k] + x.detach() if k in totals else x.detach()
    inv = 1.0 / accum
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
    return {k: x * inv for k, x in totals.items()}


def make_train_step(cfg: TrainConfig, model_cfg: CLIPConfig,
                    model: m.CLIPModel,
                    optimizer: ClippedOptimizer) -> Callable:
    """``train_step(batch) -> metrics``: ``batch`` leaves are
    ``[accum, B, …]`` (tensors or numpy arrays, moved to the model's
    device); ``metrics`` holds the mean losses and ``grad_norm``, the
    global norm of the mean gradient before clipping, as 0-dim tensors on
    the device (reading them waits for the step)."""
    dtype = compute_dtype(cfg)
    device = next(model.parameters()).device

    def train_step(batch) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(x).to(device, non_blocking=True)
                 for k, x in batch.items()}
        metrics = accumulate_grads(model, batch, cfg, model_cfg, dtype=dtype)
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return train_step

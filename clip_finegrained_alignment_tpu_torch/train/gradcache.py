"""GradCache: one contrastive loss over the whole effective batch at one
chunk's activation memory, the port of
``clip_finegrained_alignment_tpu/train/gradcache.py`` (Gao et al.,
arXiv:2101.06983).

Gradient accumulation gives each microbatch its own loss, so the negative
pool is ``batch_size``, not ``batch_size × accum``. GradCache keeps the
loss over the whole pool without holding every sample's tower activations:

1. **Embed.** Under ``torch.no_grad()``, forward every chunk of the
   ``[accum, B, …]`` batch and keep only the embeddings (the loss's
   inputs), concatenated into ``[accum·B, …]``.
2. **Loss.** Make the cache a leaf in the compute dtype, compute the
   objective over the whole pool and take its gradient with respect to
   the cache (``torch.autograd.grad``). Under bf16 the cotangent is bf16,
   as the JAX package differentiates with respect to the cached
   embeddings in the compute dtype.
3. **Re-forward and backward.** For each chunk, forward again with grad
   and ``torch.autograd.backward`` the chunk's slice of the cotangent.
   ``.grad`` sums across the chunks in fp32 on the fp32 master weights;
   no 1/accum scaling: the chunks are parts of one loss.

Both forwards take ``cfg.quant``'s projection GEMMs, as the JAX chunk
forward does, with the scales JAX's GSPMD ``gradcache.py:107`` takes
(under TP the model group's, and phase 3's int8 wgrad's over every data
rank's rows of the chunk: the groups the model holds,
``models/clip.py::build_train_model``). The result is the gradient of
the full-pool loss (``tests/test_torch_gradcache.py`` holds it to one
direct ``[1, accum·B]`` step), at one extra forward a chunk. Phase 1 runs the attention forward without
its log-sum-exp (no grad), phase 3 with it (under grad): the same kernel
and the same output either way.

Scope: ``loss_type`` ``clip`` or ``sparc``, the two objectives whose
samples are each other's negatives. On a data mesh GradCache needs
``global_negatives`` (one loss over the whole pool is the point): each
rank embeds its own chunks, the loss gathers the ranks' caches (SPARC's
pooled embeddings, ``objectives/losses.py``), so it covers ``accum·B``
globally, and the engine averages the gradients over the ranks after
phase 3. Under tensor parallelism both forwards run the shards (every
model rank holds the same cache and loss); sequence and pipeline
parallelism refuse it, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..config import CLIPConfig, TrainConfig
from ..models import clip as m
from ..objectives import losses as L
from .engine import device_pixels

Batch = Mapping[str, torch.Tensor]


def validate_gradcache(cfg: TrainConfig, mesh=None) -> None:
    """Refuse the configurations GradCache cannot carry (JAX
    ``train/gradcache.py::validate_gradcache``)."""
    if cfg.loss_type not in ("clip", "sparc"):
        raise ValueError(
            f"grad_cache supports loss_type 'clip' or 'sparc', got "
            f"{cfg.loss_type!r}: the count losses pair each sample "
            "against its own counterfactuals, so accumulation already "
            "sees the full negative pool")
    if mesh is not None and not cfg.global_negatives:
        raise ValueError(
            "grad_cache on a mesh requires global_negatives=True: the "
            "whole point is ONE loss over the full effective batch, "
            "which contradicts the DDP-parity per-device local-negative "
            "semantics")
    if cfg.sequence_parallel:
        raise ValueError("grad_cache is not supported with "
                         "sequence_parallel (the token dim the embedding "
                         "cache indexes is sharded)")
    if cfg.mesh.pipe > 1:
        raise ValueError("grad_cache is not supported with pipeline "
                         "parallelism (the GPipe wavefront already holds "
                         "all microbatches in flight)")


def _chunk_embeddings(model: m.CLIPModel, mb: Batch, cfg: TrainConfig,
                      *, dtype, pixel_bank: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's forward → the loss's inputs: (v_patch [b, S_v, P],
    l_token [b, T, P]) in ``dtype`` for ``sparc``, (image_embeds [b, P],
    text_embeds [b, P]) in fp32 for ``clip``."""
    out = m.clip_forward(model, device_pixels(mb, pixel_bank),
                         mb["input_ids"], dtype=dtype, quant=cfg.quant)
    if cfg.loss_type == "sparc":
        return m.sparc_embeddings(model, out, dtype=dtype)
    return out.image_embeds, out.text_embeds


def _full_batch_loss(embs: Tuple[torch.Tensor, torch.Tensor],
                     input_ids: torch.Tensor, cfg: TrainConfig,
                     model_cfg: CLIPConfig, mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """The objective over the concatenated ``[accum·B, …]`` embeddings:
    ``objectives/losses.py`` at the bigger batch; with ``mesh``, over
    every rank's."""
    if cfg.loss_type == "sparc":
        v_patch, l_token = embs
        mask = input_ids.reshape(-1, input_ids.shape[-1]) \
            != model_cfg.text.pad_token_id
        return L.sparc_loss(
            v_patch, l_token, mask,
            similarity_threshold=cfg.similarity_threshold,
            global_loss_weight=cfg.global_loss_weight,
            local_loss_weight=cfg.local_loss_weight,
            inverse_temperature=cfg.inverse_temperature, mesh=mesh)
    if mesh is not None:
        embs = tuple(mesh.gather(e) for e in embs)
    return L.clip_loss(*embs)


def gradcache_grads(model: m.CLIPModel, batch: Batch, cfg: TrainConfig,
                    model_cfg: CLIPConfig, *, dtype,
                    pixel_bank: Optional[torch.Tensor] = None,
                    mesh=None) -> Dict[str, torch.Tensor]:
    """In place of ``engine.accumulate_grads``: ``batch`` leaves are
    ``[accum, B, …]`` on the model's device; leaves the gradient of the
    loss over all ``accum·B`` samples (with ``mesh``: over every rank's,
    before the engine's mean over the ranks) in ``.grad`` and returns that
    loss dict (detached)."""
    model.zero_grad(set_to_none=True)
    accum = batch["input_ids"].shape[0]
    chunks = [{k: x[i] for k, x in batch.items()} for i in range(accum)]

    # Phase 1: the embedding cache; no activation outlives its chunk.
    with torch.no_grad():
        embs = [_chunk_embeddings(model, mb, cfg, dtype=dtype,
                                  pixel_bank=pixel_bank) for mb in chunks]
    cache = tuple(torch.cat(parts).requires_grad_()
                  for parts in zip(*embs))
    del embs

    # Phase 2: the full-pool loss and its cotangent at the cache.
    losses = _full_batch_loss(cache, batch["input_ids"], cfg, model_cfg,
                              mesh)
    cotangents = torch.autograd.grad(losses["total_loss"], cache)
    del cache

    # Phase 3: re-forward each chunk with grad and pull its slice of the
    # cotangent back to the parameters; .grad sums over the chunks.
    for mb, *ds in zip(chunks, *(d.chunk(accum) for d in cotangents)):
        torch.autograd.backward(
            _chunk_embeddings(model, mb, cfg, dtype=dtype,
                              pixel_bank=pixel_bank), ds)
    return {k: x.detach() for k, x in losses.items()}

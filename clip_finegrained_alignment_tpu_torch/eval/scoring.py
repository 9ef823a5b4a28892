"""Zero-shot template scoring shared by the evaluators: the port of
``clip_finegrained_alignment_tpu/eval/scoring.py``.

    pixel_values [B, S, S, 3], template_ids [B, NT, T], template_mask [B, NT]
      → probs [B, NT]  (masked softmax over each sample's templates)

Samples with fewer than NT templates fill the rest with masked slots, so a
batch of B samples is one image forward of B rows and one text forward of
B·NT rows. Every encoder layer goes through ``ops/attention.py``: on the
card its CUDA kernel, on the CPU its plain version.

Deliberate differences from the JAX scorer: no ``pad_to_batch`` and no
``mesh``. JAX pads a short last batch to keep one compiled TPU program and
shards batches over a device mesh; eager PyTorch compiles no program, so a
short batch runs at its own size, and the data-parallel mesh waits for the
multi-GPU slice. Each row's probabilities are the same either way.

``thresholded_decision`` is the reference's correctness rule, vectorized.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from ..config import CLIPConfig
from ..models import clip as m

NEG = -1e9

ModelOrStateDict = Union[m.CLIPModel, Mapping[str, torch.Tensor]]


def frozen_model(model_or_state_dict: ModelOrStateDict, cfg: CLIPConfig, *,
                 device="cuda", dtype=torch.float32) -> m.CLIPModel:
    """A :class:`CLIPModel` as it is (on its own device), or one built
    frozen from an HF-named state dict on ``device`` (raises if that is
    ``cuda`` and there is no card)."""
    if isinstance(model_or_state_dict, m.CLIPModel):
        return model_or_state_dict
    return m.build_model(cfg, model_or_state_dict, device=device, dtype=dtype)


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.require(x, requirements="CW")).to(device)


class TemplateScorer:
    """Image × templates probability scorer on one device."""

    def __init__(self, model_or_state_dict: ModelOrStateDict,
                 cfg: CLIPConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.model = frozen_model(model_or_state_dict, cfg, device=device,
                                  dtype=dtype)
        self.device = next(self.model.parameters()).device

    def score(self, pixel_values: torch.Tensor, template_ids: torch.Tensor,
              template_mask: torch.Tensor) -> torch.Tensor:
        """The same on tensors on the model's device; returns fp32 [B, NT]
        on the device."""
        with torch.inference_mode():
            B, NT, T = template_ids.shape
            img = m.encode_image(self.model, pixel_values, dtype=self.dtype)
            txt = m.encode_text(self.model, template_ids.reshape(B * NT, T),
                                dtype=self.dtype)
            img = img.float()
            txt = txt.float().reshape(B, NT, -1)
            img = img / img.norm(dim=-1, keepdim=True)
            txt = txt / txt.norm(dim=-1, keepdim=True)
            scale = self.model.logit_scale.float().exp()
            logits = torch.einsum("bd,bnd->bn", img, txt) * scale
            logits = torch.where(template_mask > 0, logits, NEG)
            return torch.softmax(logits, dim=-1)

    def __call__(self, pixel_values: np.ndarray, template_ids: np.ndarray,
                 template_mask: np.ndarray) -> np.ndarray:
        """``pixel_values`` normalized float [B, S, S, 3] → numpy probs
        [B, NT]."""
        probs = self.score(to_device(pixel_values, self.device),
                           to_device(template_ids, self.device),
                           to_device(template_mask, self.device))
        return probs.cpu().numpy()


def pad_templates(template_ids_list, pos_indices_list, max_templates: int,
                  context_length: int, pad_token_id: int = 0):
    """Ragged per-sample template sets → fixed [B, NT, T] + masks.

    ``pos_indices_list[i]`` gives the slots holding positive templates
    (the caller arranges them, ``first`` or ``random``, before padding, so
    indices are arbitrary). Returns (ids, valid_mask, pos_mask)."""
    B = len(template_ids_list)
    ids = np.full((B, max_templates, context_length), pad_token_id,
                  np.int32)
    valid = np.zeros((B, max_templates), np.float32)
    pos = np.zeros((B, max_templates), np.float32)
    for i, t in enumerate(template_ids_list):
        n = min(len(t), max_templates)
        ids[i, :n] = t[:n]
        valid[i, :n] = 1.0
        for j in pos_indices_list[i]:
            if j < n:
                pos[i, j] = 1.0
    return ids, valid, pos


def thresholded_decision(probs: np.ndarray, pos_mask: np.ndarray,
                         valid_mask: np.ndarray, confidence: float,
                         margin: float):
    """The reference's correctness rule over B samples: correct iff the
    best positive's probability > confidence AND > the best negative's +
    margin AND is the global argmax.

    Returns dict with correct [B] bool, confidence (best positive prob) [B],
    argmax_idx [B].
    """
    probs = np.where(valid_mask > 0, probs, -1.0)
    pos_probs = np.where(pos_mask > 0, probs, -1.0)
    neg_probs = np.where((pos_mask == 0) & (valid_mask > 0), probs, -1.0)
    best_pos = pos_probs.max(axis=-1)
    best_neg = neg_probs.max(axis=-1)
    # as the reference: best_neg is 0.0 when there are no negatives
    best_neg = np.where(best_neg < 0, 0.0, best_neg)
    argmax_idx = probs.argmax(axis=-1)
    is_argmax = best_pos >= probs.max(axis=-1)
    correct = ((best_pos > confidence)
               & (best_pos > best_neg + margin)
               & is_argmax)
    return {"correct": correct, "confidence": best_pos,
            "argmax_idx": argmax_idx}

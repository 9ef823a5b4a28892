"""Train-time counting accuracy and probability confusion matrix: the port
of ``clip_finegrained_alignment_tpu/eval/batch_eval.py``, which the training
CLI's ``--eval-every-epoch`` runs on a held-out batch.

Per sample: the cosine similarity of the image embedding with the GT
caption and with each counterfactual caption, a softmax over the 10
possible counts, a probability-weighted confusion matrix normalized per
true count, and argmax accuracy. The B GT captions and the B·9
counterfactuals are two batched text forwards; uint8 pixels are rescaled
and normalized on the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import CLIPConfig
from ..data.preprocess import normalize_batch
from ..models import clip as m
from .scoring import ModelOrStateDict, frozen_model, to_device

POSSIBLE_COUNTS = tuple(range(1, 11))


def evaluate_batch(model_or_state_dict: ModelOrStateDict, cfg: CLIPConfig,
                   batch: Dict[str, np.ndarray], *, device="cuda",
                   dtype: torch.dtype = torch.float32,
                   filename: Optional[str] = None
                   ) -> Tuple[float, np.ndarray, List[Dict]]:
    """``batch``: pixel_values [B,S,S,3] (uint8 or normalized f32),
    input_ids [B,T] (GT captions), cf_input_ids [B,9,T], count [B],
    cf_counts [B,9], numpy. A :class:`CLIPModel` runs on its own device; a
    state dict is built frozen on ``device``. Returns (accuracy,
    confusion [10,10], results)."""
    model = frozen_model(model_or_state_dict, cfg, device=device,
                         dtype=dtype)
    dev = next(model.parameters()).device
    gt_counts = np.asarray(batch["count"])
    cf_counts = np.asarray(batch["cf_counts"])
    with torch.inference_mode():
        px = to_device(batch["pixel_values"], dev)
        if px.dtype == torch.uint8:
            px = normalize_batch(px.float() / 255.0)
        ids = to_device(batch["input_ids"], dev)
        cf = to_device(batch["cf_input_ids"], dev)
        B, N, T = cf.shape
        img = m.encode_image(model, px, dtype=dtype)                # [B, P]
        txt = m.encode_text(model, ids, dtype=dtype)                # [B, P]
        cf_txt = m.encode_text(model, cf.reshape(B * N, T),
                               dtype=dtype).reshape(B, N, -1)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        cf_txt = cf_txt / cf_txt.norm(dim=-1, keepdim=True)
        gt_sim = (img * txt).sum(dim=-1)                            # [B]
        cf_sim = torch.einsum("bd,bnd->bn", img, cf_txt)            # [B, N]
        gt_sim = gt_sim.float().cpu().numpy()
        cf_sim = cf_sim.float().cpu().numpy()

    K = len(POSSIBLE_COUNTS)
    confusion = np.zeros((K, K))
    occurrences = np.zeros(K)
    results = []
    for i in range(B):
        similarities = np.zeros(K)
        similarities[int(gt_counts[i]) - 1] = gt_sim[i]
        for c, s in zip(cf_counts[i], cf_sim[i]):
            similarities[int(c) - 1] = s
        # softmax over the raw cosine similarities
        e = np.exp(similarities - similarities.max())
        probs = e / e.sum()
        t = int(gt_counts[i]) - 1
        confusion[t] += probs
        occurrences[t] += 1
        pred = int(np.argmax(similarities)) + 1
        results.append({"true_count": int(gt_counts[i]),
                        "pred_count": pred,
                        "correct": pred == int(gt_counts[i]),
                        "similarities": similarities})
    nz = occurrences > 0
    confusion[nz] /= occurrences[nz, None]

    if filename:
        from .viz import plot_probability_confusion
        plot_probability_confusion(confusion, list(POSSIBLE_COUNTS),
                                   filename)

    accuracy = sum(r["correct"] for r in results) / max(len(results), 1)
    return accuracy, confusion, results

"""Serving-oriented inference: the port of ``clip_finegrained_alignment_tpu/
models/inference.py``.

* ``CLIPInference`` — bucketed, L2-normalized image and text embeddings on
  one device: host batches are padded to a fixed bucket (the last row
  repeated), uploaded, normalized on the device (uint8 pixels), encoded in
  the compute dtype, and normalized with the unguarded ``e / ‖e‖``.
  ``dispatch_*`` enqueue the device work and return handles; ``fetch``
  waits for them.
* ``ZeroShotClassifier`` — a frozen prompt bank and one matmul per batch.

Grad mode is per thread, so every forward enters ``torch.inference_mode``
itself: the serving batcher calls ``dispatch_*`` from its own threads.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..config import CLIPConfig
from ..data.preprocess import normalize_batch
from . import clip as m


def _pad_to_bucket(x: np.ndarray, bucket: int):
    n = x.shape[0]
    if n == bucket:
        return x, n
    return np.concatenate([x, np.repeat(x[-1:], bucket - n, axis=0)]), n


class CLIPInference:
    """Bucketed embedding front-end over an HF-named state dict."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 cfg: CLIPConfig, *, dtype: torch.dtype = torch.bfloat16,
                 batch_bucket: int = 64, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.bucket = batch_bucket
        self.device = m.resolve_device(device)
        self.model = m.build_model(cfg, state_dict, device=self.device,
                                   dtype=dtype)
        self.logit_scale = float(np.exp(self.model.logit_scale.item()))

    def embed_images_device(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] uint8 (or normalized float) on the device → [B, P]
        fp32, L2-normalized."""
        with torch.inference_mode():
            if pixel_values.dtype == torch.uint8:
                pixel_values = normalize_batch(
                    pixel_values.to(torch.float32) / 255.0)
            e = m.encode_image(self.model, pixel_values,
                               dtype=self.dtype).float()
            return e / e.norm(dim=-1, keepdim=True)

    def embed_texts_device(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, T] int ids on the device → [B, P] fp32, L2-normalized."""
        with torch.inference_mode():
            e = m.encode_text(self.model, input_ids, dtype=self.dtype).float()
            return e / e.norm(dim=-1, keepdim=True)

    def _dispatch(self, fn, x: np.ndarray) -> list:
        """Upload and enqueue bucketed device work without waiting for it;
        returns handles for :meth:`fetch`."""
        handles = []
        for i in range(0, len(x), self.bucket):
            chunk, n = _pad_to_bucket(x[i:i + self.bucket], self.bucket)
            host = torch.from_numpy(np.require(chunk, requirements="CW"))
            handles.append((fn(host.to(self.device, non_blocking=True)), n))
        return handles

    @staticmethod
    def fetch(handles: list) -> np.ndarray:
        outs = [h.cpu().numpy()[:n] for h, n in handles]
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def dispatch_images(self, pixel_values: np.ndarray) -> list:
        """Async form of :meth:`embed_images`; finish with :meth:`fetch`."""
        return self._dispatch(self.embed_images_device, pixel_values)

    def dispatch_texts(self, input_ids: np.ndarray) -> list:
        return self._dispatch(self.embed_texts_device, input_ids)

    def embed_images(self, pixel_values: np.ndarray) -> np.ndarray:
        """[N, S, S, 3] (uint8 or normalized f32) → [N, P] normalized."""
        return self.fetch(self.dispatch_images(pixel_values))

    def embed_texts(self, input_ids: np.ndarray) -> np.ndarray:
        """[N, T] int → [N, P] normalized."""
        return self.fetch(self.dispatch_texts(input_ids))


class ZeroShotClassifier:
    """Frozen prompt bank + streaming image classification."""

    def __init__(self, inference: CLIPInference, prompts: Sequence[str],
                 tokenizer=None):
        from ..data.tokenizer import load_tokenizer
        tok = tokenizer if tokenizer is not None else load_tokenizer()
        ids = tok(list(prompts), inference.cfg.text.max_position_embeddings)
        self.inference = inference
        self.prompts = list(prompts)
        self.text_features = inference.embed_texts(ids)     # [C, P]
        self._scale = inference.logit_scale

    def logits(self, pixel_values: np.ndarray) -> np.ndarray:
        img = self.inference.embed_images(pixel_values)      # [N, P]
        return self._scale * img @ self.text_features.T      # [N, C]

    def predict(self, pixel_values: np.ndarray):
        """→ (class indices [N], probabilities [N, C])."""
        lg = self.logits(pixel_values)
        e = np.exp(lg - lg.max(axis=-1, keepdims=True))
        probs = e / e.sum(axis=-1, keepdims=True)
        return probs.argmax(axis=-1), probs

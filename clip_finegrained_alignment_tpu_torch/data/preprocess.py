"""Image preprocessing: host-side decode, pad, resize and crop,
device-side normalize.

The port of ``clip_finegrained_alignment_tpu/data/preprocess.py`` without
its ``jax.image`` batch resize, which nothing calls. Decode and uint8
geometry stay on the host (PIL); the arithmetic (rescale and normalize)
runs on the device on the batch the model reads. Images are NHWC
throughout, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

# Published CLIP normalization constants (the HF processor's and the
# OpenAI transform's).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_batch(x: torch.Tensor) -> torch.Tensor:
    """Normalize already-rescaled [0, 1] float images, ``[..., 3]``."""
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def resize_center_crop(image: np.ndarray,
                       image_size: int = 224) -> np.ndarray:
    """Host-side resize-shorter-side (bicubic) + center crop, uint8 → uint8,
    with the HF processor's geometry."""
    from PIL import Image
    h, w = image.shape[:2]
    scale = image_size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    im = Image.fromarray(image).resize((nw, nh), Image.BICUBIC)
    arr = np.asarray(im)
    top = (nh - image_size) // 2
    left = (nw - image_size) // 2
    return arr[top:top + image_size, left:left + image_size]


def load_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 [H, W, 3]."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def pad_to_square(image: np.ndarray, fill: int = 255) -> np.ndarray:
    """Pad to square with white, centred: the counterfactual loader's
    geometry (the aspect ratio is kept, not squashed)."""
    h, w = image.shape[:2]
    if h == w:
        return image
    side = max(h, w)
    out = np.full((side, side, image.shape[2]), fill, image.dtype)
    top = (side - h) // 2
    left = (side - w) // 2
    out[top:top + h, left:left + w] = image
    return out


def preprocess_host(image: np.ndarray, image_size: int = 224) -> np.ndarray:
    """The whole pipeline on the host → float32 [S, S, 3] normalized (for
    eval paths that need the HF processor's geometry on any image)."""
    arr = resize_center_crop(image, image_size).astype(np.float32) / 255.0
    return ((arr - np.asarray(CLIP_MEAN, np.float32))
            / np.asarray(CLIP_STD, np.float32))

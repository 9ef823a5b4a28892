"""Zero-shot small-object detection crop sweep, the port of
``clip_finegrained_alignment_tpu/eval/crop_detection.py`` (the protocol of
the reference's ``zero_shot_detection/crop_eval.py``).

CLIP's existence classification against object scale: sample images whose
sole instance of a category covers < 0.5 % of the area, score ``"A photo
with {obj}"`` against ``"A photo with no {obj}"`` (a 2-template softmax of
the scaled cosine similarities), at the original scale and at crops where
the box is 5 % and 10 % of the crop. Negative control: a category absent
from the image, with the rule reversed. A white square is the null-input
control. Aggregates accuracy and the average positive and negative scores
per condition, and dumps JSON.

The six conditions of ``max(1, batch_size // 6)`` samples are scored in one
``TemplateScorer`` call of 6·chunk images × 2 templates; ``debug_dir`` runs
take the serial path, one sample a call, with bbox overlays.

Sources: ``CocoObjectSource`` (COCO through ``pycocotools``, imported when
a source is made) and ``ProceduralObjectSource`` (one small shape on a
procedural background, no files needed).

Deliberate differences: JAX pads the last partial chunk by repeating its
first sample, to keep one compiled TPU shape; the port scores the chunk at
its own size (the real rows' results are the same). A source that fails to
draw a sample is logged and drawn again, as in JAX, but the serial debug
path does not also retry a failed scorer call or plot: that error is
raised, where JAX would log it and loop.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import CLIPConfig
from ..data.preprocess import load_image, preprocess_host
from ..data.tokenizer import load_tokenizer
from .scoring import ModelOrStateDict, TemplateScorer

logger = logging.getLogger(__name__)

CONDITIONS = ("original_positive", "original_negative",
              "crop_05_positive", "crop_05_negative",
              "crop_10_positive", "crop_10_negative")


def box_area_ratio(bbox, width, height) -> float:
    """bbox [x, y, w, h] area over the image area."""
    return (bbox[2] * bbox[3]) / (width * height)


def crop_to_target_ratio(image: np.ndarray, bbox,
                         target_ratio: float) -> Tuple[np.ndarray, list]:
    """Crop so that the box covers ``target_ratio`` of the crop: the full
    frame scaled by sqrt(box_area / (ratio · image_area)) around the box
    centre, clamped to the image."""
    h, w = image.shape[:2]
    x, y, bw, bh = bbox
    target_area = (bw * bh) / target_ratio
    scale = np.sqrt(target_area / (w * h))
    nw, nh = int(w * scale), int(h * scale)
    cx, cy = x + bw / 2, y + bh / 2
    x1 = max(0, int(cx - nw / 2))
    y1 = max(0, int(cy - nh / 2))
    x2 = min(w, x1 + nw)
    y2 = min(h, y1 + nh)
    return image[y1:y2, x1:x2], [x - x1, y - y1, bw, bh]


def white_square_image(size: int = 224) -> np.ndarray:
    """The null-input control."""
    return np.full((size, size, 3), 255, np.uint8)


# ---------------------------------------------------------------------------
# Sample sources
# ---------------------------------------------------------------------------

class CocoObjectSource:
    """COCO small-object sampler."""

    def __init__(self, coco_dir: str, split: str = "train2017",
                 seed: int = 0):
        from pycocotools.coco import COCO
        self.coco = COCO(os.path.join(coco_dir, "annotations",
                                      f"instances_{split}.json"))
        self.image_dir = os.path.join(coco_dir, split)
        self.categories = {c["id"]: c["name"]
                           for c in self.coco.loadCats(self.coco.getCatIds())}
        self._rng = random.Random(seed)

    def sample(self):
        """(image uint8, bbox, true_name, false_name) for a random image
        whose single instance of some category has < 0.5 % of the area."""
        ids = list(self.coco.imgs.keys())
        while True:
            img_id = self._rng.choice(ids)
            info = self.coco.imgs[img_id]
            anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))
            counts: Dict[int, int] = {}
            small = None
            for a in anns:
                counts[a["category_id"]] = counts.get(a["category_id"], 0) + 1
                if small is None and box_area_ratio(
                        a["bbox"], info["width"], info["height"]) < 0.005:
                    small = a
            if small is None or counts[small["category_id"]] != 1:
                continue
            present = {a["category_id"] for a in anns}
            absent = [n for i, n in self.categories.items()
                      if i not in present]
            if not absent:
                continue
            img = load_image(os.path.join(self.image_dir, info["file_name"]))
            return (img, list(small["bbox"]),
                    self.categories[small["category_id"]],
                    self._rng.choice(absent))


class ProceduralObjectSource:
    """One small coloured shape on a procedural background."""

    def __init__(self, image_size: int = 448, seed: int = 0):
        from ..data.synthetic import ProceduralSource
        self.src = ProceduralSource(image_size)
        self.image_size = image_size
        self._rng = np.random.default_rng(seed)

    def sample(self):
        from ..data.synthetic import alpha_paste
        bg, _ = self.src.background(self._rng)
        H, W = bg.shape[:2]
        # The < 0.5 % area filter bounds the object's side at
        # sqrt(0.005·H·W): draw under the cap instead of rejecting.
        max_side = max(9, int(np.sqrt(0.005 * H * W)))
        obj = self.src.object_crop(self._rng, "small",
                                   side_bounds=(8, max_side))
        oh, ow = obj.rgb.shape[:2]
        x = int(self._rng.integers(0, W - ow))
        y = int(self._rng.integers(0, H - oh))
        bg = bg.copy()
        alpha_paste(bg, obj.rgb, obj.alpha, x, y)
        others = [f"{c} {s}" for c in self.src.COLORS
                  for s in self.src.SHAPES]
        others = [o for o in others if o != obj.label]
        false_name = others[int(self._rng.integers(len(others)))]
        return bg, [x, y, ow, oh], obj.label, false_name


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class CropDetectionEvaluator:
    """Batched 6-condition crop sweep over a ``TemplateScorer``."""

    def __init__(self, model_or_state_dict: ModelOrStateDict,
                 model_cfg: CLIPConfig, *, tokenizer=None,
                 batch_size: int = 16, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 use_white_square: bool = False, mesh=None):
        self.model_cfg = model_cfg
        self.tok = tokenizer if tokenizer is not None else load_tokenizer()
        self.batch_size = batch_size
        self.use_white_square = use_white_square
        self.context_length = model_cfg.text.max_position_embeddings
        # On a mesh the scorer pads each call to the chunk's 6·chunk rows
        # rounded up to a multiple of the ranks (a debug call's 6 too).
        pad = None
        if mesh is not None:
            rows = 6 * max(1, batch_size // 6)
            pad = -(-rows // mesh.data) * mesh.data
        self.scorer = TemplateScorer(model_or_state_dict, model_cfg,
                                     device=device, dtype=dtype,
                                     pad_to_batch=pad, mesh=mesh)

    def _score_pairs(self, images: List[np.ndarray],
                     names: List[str]) -> np.ndarray:
        """[(presence, absence)] softmax probs for each (image, name), on
        the templates "A photo with {name}" / "A photo with no {name}".
        Returns [N, 2]."""
        S = self.model_cfg.vision.image_size
        px = np.stack([preprocess_host(im, S) for im in images])
        ids = np.stack([self.tok([f"A photo with {n}",
                                  f"A photo with no {n}"],
                                 self.context_length) for n in names])
        mask = np.ones(ids.shape[:2], np.float32)
        return self.scorer(px, ids, mask)

    def evaluate_sample(self, image: np.ndarray, bbox, true_name: str,
                        false_name: str,
                        debug_dir: Optional[str] = None) -> Dict[str, Dict]:
        """All 6 conditions for one sampled image in one scorer call.

        ``debug_dir``: save ``original_positive.png`` and
        ``crop_{5,10}_positive.png``, each titled with the condition and its
        pos-vs-neg scores, the box drawn in the crop's coordinates.
        """
        if self.use_white_square:
            image, bbox = white_square_image(), [50, 50, 50, 50]
        crop05, bbox05 = crop_to_target_ratio(image, bbox, 0.05)
        crop10, bbox10 = crop_to_target_ratio(image, bbox, 0.10)
        images = [image, image, crop05, crop05, crop10, crop10]
        names = [true_name, false_name] * 3
        probs = self._score_pairs(images, names)
        out = self._conditions_from_probs(probs, names)

        if debug_dir is not None:
            from .viz import save_image_with_bbox
            for fname, img, bx, cond, label in (
                    ("original_positive.png", image, bbox,
                     "original_positive", "Original"),
                    ("crop_5_positive.png", crop05, bbox05,
                     "crop_05_positive", "5% Crop"),
                    ("crop_10_positive.png", crop10, bbox10,
                     "crop_10_positive", "10% Crop")):
                r = out[cond]
                save_image_with_bbox(
                    img, bx, os.path.join(debug_dir, fname),
                    title=f"{label} - True {true_name} "
                          f"({r['positive_score']:.2f} vs "
                          f"{r['negative_score']:.2f})")
        return out

    def _conditions_from_probs(self, probs: np.ndarray,
                               names: List[str]) -> Dict[str, Dict]:
        """probs [6, 2] + per-condition names → the result dict."""
        out = {}
        for i, cond in enumerate(CONDITIONS):
            pos, neg = float(probs[i, 0]), float(probs[i, 1])
            is_negative_control = cond.endswith("negative")
            out[cond] = {
                "object_name": names[i],
                "positive_score": pos,
                "negative_score": neg,
                # the negative control's rule is reversed
                "correct": (neg > pos) if is_negative_control
                else (pos > neg),
                "ground_truth": "negative" if is_negative_control
                else "positive",
            }
        return out

    def run_evaluation(self, source, num_samples: int = 100,
                       debug_dir: Optional[str] = None) -> Dict:
        """``num_samples`` from ``source``, the aggregate per condition.
        Samples are scored in chunks of ``max(1, batch_size // 6)``, one
        [6·chunk, 2] scorer call a chunk (the last may be shorter).
        ``debug_dir`` takes the serial path, one sample a call, with the
        bbox overlays in ``<debug_dir>/<index>_<category>/``."""
        if debug_dir is not None:
            all_results = []
            while len(all_results) < num_samples:
                try:
                    image, bbox, true_name, false_name = source.sample()
                except Exception as e:
                    logger.warning("sample failed: %s", e)
                    continue
                sample_dir = os.path.join(
                    debug_dir,
                    f"{len(all_results)}_{true_name.replace(' ', '_')}")
                r = self.evaluate_sample(image, bbox, true_name, false_name,
                                         debug_dir=sample_dir)
                r["category"] = true_name
                all_results.append(r)
            return {"individual_results": all_results,
                    "aggregate_stats": self.aggregate(all_results)}

        chunk = max(1, self.batch_size // 6)
        all_results: List[Dict] = []
        pending: List[Tuple[List[np.ndarray], List[str], str]] = []

        def flush():
            if not pending:
                return
            images, names = [], []
            for imgs, nms, _ in pending:
                images.extend(imgs)
                names.extend(nms)
            probs = self._score_pairs(images, names)   # [6*len(pending), 2]
            for j, (_, nms, category) in enumerate(pending):
                r = self._conditions_from_probs(
                    probs[6 * j:6 * (j + 1)], nms)
                r["category"] = category
                all_results.append(r)
            pending.clear()

        while len(all_results) + len(pending) < num_samples:
            try:
                image, bbox, true_name, false_name = source.sample()
                if self.use_white_square:
                    image, bbox = white_square_image(), [50, 50, 50, 50]
                crop05, _ = crop_to_target_ratio(image, bbox, 0.05)
                crop10, _ = crop_to_target_ratio(image, bbox, 0.10)
                pending.append((
                    [image, image, crop05, crop05, crop10, crop10],
                    [true_name, false_name] * 3, true_name))
            except Exception as e:
                logger.warning("sample failed: %s", e)
                continue
            if len(pending) == chunk:
                flush()
        flush()
        return {"individual_results": all_results,
                "aggregate_stats": self.aggregate(all_results)}

    @staticmethod
    def aggregate(results: List[Dict]) -> Dict:
        n = len(results)
        stats = {}
        for cond in CONDITIONS:
            correct = sum(int(r[cond]["correct"]) for r in results)
            stats[cond] = {
                "correct": correct,
                "accuracy": correct / n,
                "avg_positive": sum(r[cond]["positive_score"]
                                    for r in results) / n,
                "avg_negative": sum(r[cond]["negative_score"]
                                    for r in results) / n,
            }
        return stats

    @staticmethod
    def save(results: Dict, path: str) -> None:
        """JSON dump of ``run_evaluation``'s results."""
        with open(path, "w") as f:
            json.dump(results, f, indent=2)

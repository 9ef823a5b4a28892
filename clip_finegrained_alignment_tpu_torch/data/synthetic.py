"""Synthetic counting-dataset generator (host side, numpy, seeded): the
port's copy of ``clip_finegrained_alignment_tpu/data/synthetic.py``, same
functions, same random draws, same bytes.

The reference's copy-paste compositing: sample an object crop filtered by
size category, alpha-paste it 1..max_objects times at random coordinates
into a destination image, and caption the result. Two sources:

* ``ProceduralSource``: noise backgrounds and coloured shapes, so data
  generation (and the train loop and its tests) needs nothing from
  outside;
* ``CocoSource``: COCO instances and captions through ``pycocotools``
  (imported when a source is made), from a local COCO tree only.

Output: a PNG per sample and one ``synthetic_annotations.json`` with
``image_path / width / height / caption / source_object / count`` (and
``boxes`` / ``labels`` / ``box_integers`` for the non-``count`` modes).
Caption modes: ``count`` ("A photo of {original} with {N} {label}s"),
``integer`` (boxes packed ``x1<<24 | y1<<16 | x2<<8 | y2``) and ``full``
(3×3 position-grid phrases). The rng is a ``numpy.random.Generator``
seeded per call, so a dataset is the same on every host.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .numbers import pluralize

# Size categories by max dimension (gen_synthetic_data.py:14-18,140-148).
SIZE_CATEGORIES = {
    "small": (32, 96),
    "medium": (96, 224),
    "large": (224, 640),
}


def size_category(width: int, height: int) -> str:
    m = max(width, height)
    if m < SIZE_CATEGORIES["small"][1]:
        return "small"
    if m < SIZE_CATEGORIES["medium"][1]:
        return "medium"
    return "large"


def pack_box(box: Sequence[int]) -> int:
    """[x1,y1,x2,y2] → single int via bit-shifts (the ``integer``
    annotation mode, gen_synthetic_data.py:274-281)."""
    x1, y1, x2, y2 = (int(v) for v in box)
    return (x1 << 24) | (y1 << 16) | (x2 << 8) | y2


def position_phrase(boxes: Sequence[Sequence[float]], label: str,
                    width: int, height: int) -> str:
    """3×3 grid position phrases for the ``full`` caption mode
    (gen_synthetic_data.py:166-200)."""
    names = []
    for x1, y1, x2, y2 in boxes:
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        xp = "left" if cx < width / 3 else \
            "center" if cx < 2 * width / 3 else "right"
        yp = "top" if cy < height / 3 else \
            "middle" if cy < 2 * height / 3 else "bottom"
        names.append(f"{yp}-{xp}")
    if len(names) == 1:
        pos = names[0]
    elif len(names) == 2:
        pos = f"{names[0]} and {names[1]}"
    else:
        pos = ", ".join(names[:-1]) + f", and {names[-1]}"
    n = len(names)
    return f"{n} {pluralize(label, n)} at {pos}"


def alpha_paste(dst: np.ndarray, obj_rgb: np.ndarray,
                obj_alpha: Optional[np.ndarray], x: int, y: int) -> None:
    """In-place alpha-over paste of ``obj`` at (x, y); clips at borders.
    Uses the native C++ primitive when built, numpy otherwise. The two
    are byte-equal for opaque objects and 0/255 masks (all the generator
    pastes); for other alphas the native integer blend
    ``(a·s + (255 − a)·d) // 255`` and numpy's float blend, truncated,
    differ by at most 1."""
    from .. import native
    if dst.flags.c_contiguous and native.available():
        if native.alpha_paste(dst, obj_rgb, obj_alpha, x, y):
            return
    h, w = obj_rgb.shape[:2]
    H, W = dst.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    if x1 <= x0 or y1 <= y0:
        return
    ox0, oy0 = x0 - x, y0 - y
    region = obj_rgb[oy0:oy0 + (y1 - y0), ox0:ox0 + (x1 - x0)]
    if obj_alpha is None:
        dst[y0:y1, x0:x1] = region
    else:
        a = obj_alpha[oy0:oy0 + (y1 - y0), ox0:ox0 + (x1 - x0), None] / 255.0
        dst[y0:y1, x0:x1] = (a * region
                             + (1 - a) * dst[y0:y1, x0:x1]).astype(dst.dtype)


# ---------------------------------------------------------------------------
# Object/background sources
# ---------------------------------------------------------------------------

@dataclass
class ObjectCrop:
    rgb: np.ndarray                 # [h, w, 3] uint8
    alpha: Optional[np.ndarray]     # [h, w] uint8 or None (opaque)
    label: str
    source: Dict                    # provenance for the annotation


class ProceduralSource:
    """Hermetic source: noise backgrounds + simple shape objects."""

    SHAPES = ("circle", "square", "triangle")
    COLORS = {"red": (220, 40, 40), "green": (40, 190, 60),
              "blue": (40, 80, 220), "yellow": (230, 210, 40)}

    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def background(self, rng: np.random.Generator) -> Tuple[np.ndarray, str]:
        s = self.image_size
        base = rng.integers(90, 170, size=3)
        img = (base[None, None, :]
               + rng.normal(0, 18, size=(s, s, 3))).clip(0, 255)
        return img.astype(np.uint8), "a textured background"

    def object_crop(self, rng: np.random.Generator, category: str,
                    side_bounds: Optional[Tuple[int, int]] = None
                    ) -> ObjectCrop:
        """``side_bounds`` overrides the category band (e.g. the crop-eval
        source needs objects under the <0.5%-area cap regardless of band)."""
        lo, hi = side_bounds if side_bounds else SIZE_CATEGORIES[category]
        hi = min(hi, self.image_size - 1)
        side = int(rng.integers(max(8, lo), max(9, hi)))
        shape = self.SHAPES[rng.integers(len(self.SHAPES))]
        cname, color = list(self.COLORS.items())[
            rng.integers(len(self.COLORS))]
        yy, xx = np.mgrid[0:side, 0:side]
        c = (side - 1) / 2
        if shape == "circle":
            mask = ((yy - c) ** 2 + (xx - c) ** 2) <= c ** 2
        elif shape == "square":
            mask = np.ones((side, side), bool)
        else:  # triangle
            mask = (yy >= np.abs(xx - c) * 2 * c / side)
        rgb = np.zeros((side, side, 3), np.uint8)
        rgb[..., 0], rgb[..., 1], rgb[..., 2] = color
        return ObjectCrop(rgb=rgb, alpha=(mask * 255).astype(np.uint8),
                          label=f"{cname} {shape}",
                          source={"backend": "procedural", "shape": shape,
                                  "color": cname, "side": side})


class CocoSource:
    """COCO-backed source, the reference's pipeline
    (gen_synthetic_data.py:20-34,59-93,202-267): object crops from
    instance bboxes, destinations from train images, original captions from
    the captions annotation set."""

    def __init__(self, coco_dir: str, split: str = "train2017"):
        from pycocotools.coco import COCO
        ann = os.path.join(coco_dir, "annotations")
        self.image_dir = os.path.join(coco_dir, split)
        self.instances = COCO(os.path.join(ann, f"instances_{split}.json"))
        self.captions = COCO(os.path.join(ann, f"captions_{split}.json"))
        self.categories = {c["id"]: c["name"]
                           for c in self.instances.loadCats(
                               self.instances.getCatIds())}
        self.image_ids = list(self.instances.imgs.keys())

    def _load(self, image_id: int) -> np.ndarray:
        from .preprocess import load_image
        info = self.instances.loadImgs([image_id])[0]
        return load_image(os.path.join(self.image_dir, info["file_name"]))

    def background(self, rng: np.random.Generator) -> Tuple[np.ndarray, str]:
        image_id = int(self.image_ids[rng.integers(len(self.image_ids))])
        img = self._load(image_id)
        cap_ids = self.captions.getAnnIds(imgIds=[image_id])
        caption = "an image"
        if cap_ids:
            anns = self.captions.loadAnns(cap_ids)
            caption = anns[0]["caption"].strip().rstrip(".")
        return img, caption

    def object_crop(self, rng: np.random.Generator,
                    category: str) -> Optional[ObjectCrop]:
        """Rejection-sample an instance whose bbox max-dim falls in the
        category band (the reference's reject-and-retry loop,
        gen_synthetic_data.py:221-235)."""
        for _ in range(100):
            image_id = int(self.image_ids[rng.integers(len(self.image_ids))])
            ann_ids = self.instances.getAnnIds(imgIds=[image_id],
                                               iscrowd=False)
            if not ann_ids:
                continue
            ann = self.instances.loadAnns(
                [ann_ids[rng.integers(len(ann_ids))]])[0]
            x, y, w, h = ann["bbox"]
            if w < 4 or h < 4 or size_category(w, h) != category:
                continue
            img = self._load(image_id)
            x, y, w, h = int(x), int(y), int(w), int(h)
            crop = img[y:y + h, x:x + w]
            if crop.size == 0:
                continue
            return ObjectCrop(
                rgb=crop, alpha=None,
                label=self.categories[ann["category_id"]],
                source={"backend": "coco", "image_id": image_id,
                        "bbox": [x, y, x + w, y + h],
                        "category_id": ann["category_id"]})
        return None


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

class SyntheticCountGenerator:
    """Compose counting samples and write the annotations JSON."""

    def __init__(self, source, output_dir: str):
        self.source = source
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)

    def generate(self, num_samples: int, *, max_objects: int = 10,
                 category: str = "small", annotation_mode: str = "count",
                 seed: int = 42, save_images: bool = True) -> List[Dict]:
        """Generate ``num_samples`` samples; returns (and writes) the
        annotation list. ``annotation_mode``: count | integer | full."""
        if annotation_mode not in ("count", "integer", "full"):
            raise ValueError(f"bad annotation_mode {annotation_mode!r}")
        rng = np.random.default_rng(np.random.SeedSequence([seed]))
        dataset: List[Dict] = []
        while len(dataset) < num_samples:
            obj = self.source.object_crop(rng, category)
            if obj is None:
                continue
            bg, original_caption = self.source.background(rng)
            bg = bg.copy()
            H, W = bg.shape[:2]
            oh, ow = obj.rgb.shape[:2]
            if oh >= H or ow >= W:
                continue

            n = int(rng.integers(1, max_objects + 1))
            boxes = []
            for _ in range(n):
                x = int(rng.integers(0, max(1, W - ow)))
                y = int(rng.integers(0, max(1, H - oh)))
                alpha_paste(bg, obj.rgb, obj.alpha, x, y)
                boxes.append([x, y, x + ow, y + oh])

            if annotation_mode == "count":
                added = f"{n} {pluralize(obj.label, n)}"
            elif annotation_mode == "integer":
                box_integers = [pack_box(b) for b in boxes]
                added = (f"{n} {pluralize(obj.label, n)} "
                         f"at positions {box_integers}")
            else:
                added = position_phrase(boxes, obj.label, W, H)

            caption = f"A photo of {original_caption} with {added}"
            idx = len(dataset)
            image_path = os.path.join(self.output_dir,
                                      f"synthetic_{idx}.png")
            if save_images:
                from PIL import Image
                Image.fromarray(bg).save(image_path)

            annotation = {
                "image_path": image_path,
                "width": W, "height": H,
                "caption": caption,
                "source_object": obj.source,
                "count": n,
            }
            if annotation_mode != "count":
                annotation["boxes"] = boxes
                annotation["labels"] = [obj.label] * n
                if annotation_mode == "integer":
                    annotation["box_integers"] = box_integers
            dataset.append(annotation)

        with open(os.path.join(self.output_dir,
                               "synthetic_annotations.json"), "w") as f:
            json.dump(dataset, f)
        return dataset


def visualize_sample(sample: Dict, path: str, *, show_labels: bool = True,
                     show_caption: bool = True,
                     show_integers: bool = False) -> None:
    """Render one generated sample with its pasted boxes for eyeballing
    data quality (``gen_synthetic_data.py:347-378``'s ``visualize_sample``):
    red box outlines, optional per-box label text (plus the packed
    box-integer when ``show_integers``), the caption as a bottom figtext.
    ``count``-mode annotations carry no boxes (reference schema,
    :308-315) — those render image + caption only, as the reference's
    ``if 'boxes' in sample`` guard does."""
    from PIL import Image

    from ..eval.viz import save_image_with_bbox

    img = np.asarray(Image.open(sample["image_path"]).convert("RGB"))
    boxes = sample.get("boxes", [])
    labels = None
    if show_labels and boxes:
        labels = list(sample.get("labels", []))
        if show_integers and "box_integers" in sample:
            labels = [f"{lb}\n{bi}" for lb, bi in
                      zip(labels, sample["box_integers"])]
    xywh = [[x1, y1, x2 - x1, y2 - y1] for x1, y1, x2, y2 in boxes] \
        if boxes else np.zeros((0, 4))
    save_image_with_bbox(
        img, xywh, path, labels=labels,
        caption=sample.get("caption", "") if show_caption else "")


def visualize_dataset(annotations: List[Dict], output_dir: str,
                      num_samples: int = 8, **kw) -> List[str]:
    """Dump bbox-overlay PNGs for the first ``num_samples`` annotations;
    returns the written paths (CLI ``--visualize`` entry)."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, sample in enumerate(annotations[:num_samples]):
        p = os.path.join(output_dir, f"debug_{i}.png")
        visualize_sample(sample, p, **kw)
        paths.append(p)
    return paths


def generate_procedural_dataset(output_dir: str, num_samples: int,
                                *, image_size: int = 224,
                                max_objects: int = 10,
                                category: str = "small",
                                annotation_mode: str = "count",
                                seed: int = 42,
                                save_images: bool = True) -> List[Dict]:
    """One-call hermetic dataset (tests, smoke runs)."""
    gen = SyntheticCountGenerator(ProceduralSource(image_size), output_dir)
    return gen.generate(num_samples, max_objects=max_objects,
                        category=category, annotation_mode=annotation_mode,
                        seed=seed, save_images=save_images)

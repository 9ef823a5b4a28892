"""Procedural benchmark fixtures, the port of ``clip_finegrained_alignment_
tpu/data/fixtures.py`` (same draws, the same JSON and PNG bytes from the
same seed).

The real benchmark datasets are on the HF hub (``nielsr/countbench``,
``XAI/vlmsareblind``) and out of reach without a network. These generators
draw benchmark-shaped samples locally, so the evaluation CLI runs end to
end with no download:

* ``make_countbench_fixture``: images holding exactly k shapes, captioned
  "A photo of {k} {label}s", k ∈ [1, 10];
* ``make_vlmsblind_fixture``: drawn samples of four of the nine tasks
  (Touching Circles, Nested Squares, Olympic Counting - Circles, Counting
  Grid - Blank Grids); the other tasks need text rendering.

They are fixtures, not the benchmarks: their numbers say nothing about
CountBench accuracy. They check plumbing, shapes and protocols.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from .synthetic import ProceduralSource, alpha_paste


def _save(img: np.ndarray, path: str) -> None:
    from PIL import Image
    Image.fromarray(img).save(path)


def make_countbench_fixture(output_dir: str, num_samples: int = 40,
                            image_size: int = 224,
                            seed: int = 0) -> List[Dict]:
    """CountBench-shaped local dataset: [{image_path, text, number}], also
    written to ``countbench_fixture.json``."""
    from .numbers import pluralize, to_word
    rng = np.random.default_rng(seed)
    src = ProceduralSource(image_size)
    os.makedirs(output_dir, exist_ok=True)
    samples = []
    for i in range(num_samples):
        k = int(rng.integers(1, 11))
        bg, _ = src.background(rng)
        bg = bg.copy()
        obj = src.object_crop(rng, "small", side_bounds=(16, 40))
        oh, ow = obj.rgb.shape[:2]
        for _ in range(k):
            x = int(rng.integers(0, image_size - ow))
            y = int(rng.integers(0, image_size - oh))
            alpha_paste(bg, obj.rgb, obj.alpha, x, y)
        path = os.path.join(output_dir, f"cb_{i}.png")
        _save(bg, path)
        samples.append({
            "image_path": path,
            "text": f"A photo of {to_word(k)} "
                    f"{pluralize(obj.label, k)}.",
            "number": k,
        })
    with open(os.path.join(output_dir, "countbench_fixture.json"),
              "w") as f:
        json.dump(samples, f)
    return samples


# ---------------------------------------------------------------------------
# VLMs-are-Blind drawings
# ---------------------------------------------------------------------------

def _blank(size: int) -> np.ndarray:
    return np.full((size, size, 3), 255, np.uint8)


def _draw_circle_outline(img, cy, cx, r, color, thickness=3):
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    ring = (d2 <= (r + thickness) ** 2) & (d2 >= (r - thickness) ** 2)
    img[ring] = color


def _touching_circles(size, touching: bool, rng) -> np.ndarray:
    img = _blank(size)
    r = size // 8
    cy = size // 2
    gap = (0 if touching else r) + int(rng.integers(0, r // 2))
    cx1 = size // 2 - r - gap // 2
    cx2 = size // 2 + r + gap // 2 if not touching else cx1 + 2 * r
    _draw_circle_outline(img, cy, cx1, r, (30, 30, 200))
    _draw_circle_outline(img, cy, cx2, r, (200, 30, 30))
    return img


def _nested_squares(size, n, rng) -> np.ndarray:
    img = _blank(size)
    c = size // 2
    for i in range(n):
        half = size // 3 - i * (size // (3 * (n + 1)))
        y0, y1 = c - half, c + half
        x0, x1 = c - half, c + half
        img[y0:y0 + 3, x0:x1] = 0
        img[y1 - 3:y1, x0:x1] = 0
        img[y0:y1, x0:x0 + 3] = 0
        img[y0:y1, x1 - 3:x1] = 0
    return img


def _olympic_circles(size, n, rng) -> np.ndarray:
    img = _blank(size)
    r = size // 10
    top = [(size // 3, size // 2 + (i - 2) * int(2.2 * r))
           for i in range(3)]
    bottom = [(size // 3 + int(1.1 * r),
               size // 2 + int((i - 1.5) * 2.2 * r)) for i in range(2)]
    centers = (top + bottom + [(2 * size // 3, size // 2 + (i - 2) * r)
                               for i in range(4)])[:n]
    colors = [(20, 20, 200), (20, 150, 20), (200, 20, 20),
              (200, 180, 20), (20, 20, 20), (150, 20, 150),
              (20, 180, 180), (120, 80, 20), (80, 80, 80)]
    for (cy, cx), col in zip(centers, colors):
        _draw_circle_outline(img, cy, cx, r, col)
    return img


def _counting_grid(size, rows, cols) -> np.ndarray:
    img = _blank(size)
    margin = size // 10
    for i in range(rows + 1):
        y = margin + i * (size - 2 * margin) // rows
        img[y:y + 2, margin:size - margin] = 0
    for j in range(cols + 1):
        x = margin + j * (size - 2 * margin) // cols
        img[margin:size - margin, x:x + 2] = 0
    return img


def make_vlmsblind_fixture(output_dir: str, per_task: int = 6,
                           image_size: int = 224,
                           seed: int = 0) -> List[Dict]:
    """Drawn samples of 4 of the 9 tasks: [{image_path, task,
    groundtruth}], also written to ``vlmsblind_fixture.json``."""
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    samples = []

    def add(img, task, gt):
        path = os.path.join(output_dir,
                            f"vb_{len(samples)}.png")
        _save(img, path)
        samples.append({"image_path": path, "task": task,
                        "groundtruth": str(gt)})

    for _ in range(per_task):
        touching = bool(rng.integers(2))
        add(_touching_circles(image_size, touching, rng),
            "Touching Circles", "Yes" if touching else "No")

        n = int(rng.integers(2, 6))
        add(_nested_squares(image_size, n, rng), "Nested Squares", n)

        k = int(rng.integers(5, 10))
        add(_olympic_circles(image_size, k, rng),
            "Olympic Counting - Circles", k)

        r, c = int(rng.integers(3, 10)), int(rng.integers(3, 10))
        add(_counting_grid(image_size, r, c),
            "Counting Grid - Blank Grids", f"{r},{c}")

    with open(os.path.join(output_dir, "vlmsblind_fixture.json"),
              "w") as f:
        json.dump(samples, f)
    return samples

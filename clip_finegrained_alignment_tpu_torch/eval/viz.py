"""Evaluation figures, the port of ``clip_finegrained_alignment_tpu/eval/
viz.py``. So far only the box overlay that the synthetic generator's
``--visualize`` draws; the confusion matrices and probability plots come
with the evaluation slice. matplotlib is imported at first use, with the
Agg backend, so a headless host never touches a display."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    return plt


def save_image_with_bbox(image: np.ndarray, bboxes, path: str,
                         title: str = "",
                         labels: Optional[Sequence[str]] = None,
                         caption: str = "") -> None:
    """Image with red bounding-box overlays, optional per-box labels and a
    caption at the bottom. ``bboxes``: one ``[x, y, w, h]`` box or a
    sequence of them."""
    plt = _plt()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    boxes = np.asarray(bboxes, dtype=float)
    if boxes.ndim == 1:
        boxes = boxes[None]
    plt.figure(figsize=(10, 10))
    plt.imshow(image)
    ax = plt.gca()
    from matplotlib import patches
    for i, (x, y, w, h) in enumerate(boxes):
        ax.add_patch(patches.Rectangle((x, y), w, h, linewidth=2,
                                       edgecolor="r", facecolor="none"))
        if labels is not None and i < len(labels):
            ax.text(x, y, labels[i],
                    bbox=dict(facecolor="white", alpha=0.7), fontsize=8)
    if title:
        plt.title(title)
    if caption:
        plt.figtext(0.5, 0.02, caption, wrap=True,
                    horizontalalignment="center", fontsize=10,
                    bbox=dict(facecolor="white", alpha=0.7))
    plt.axis("off")
    plt.savefig(path, bbox_inches="tight", pad_inches=0.5 if caption else 0)
    plt.close()

"""Evaluation figures, the port of ``clip_finegrained_alignment_tpu/eval/
viz.py``: the debug-image saver, the box overlay, per-sample template
probability bars, the count confusion matrix, the probability-weighted
confusion heatmap, pos/neg probability histograms and the stats text dump.
matplotlib is imported at first use, with the Agg backend, so a headless
host never touches a display."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    return plt


def save_debug_image(image: np.ndarray, path: str,
                     title: str = "") -> None:
    plt = _plt()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.figure(figsize=(6, 6))
    plt.imshow(image)
    if title:
        plt.title(title)
    plt.axis("off")
    plt.savefig(path, bbox_inches="tight")
    plt.close()


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


def plot_template_probabilities(templates: Sequence[str],
                                probs: np.ndarray, path: str,
                                positive_indices: Sequence[int]) -> None:
    """Green positive / red negative template probability bars."""
    plt = _plt()
    pos = set(positive_indices)
    colors = ["green" if i in pos else "red" for i in range(len(templates))]
    plt.figure(figsize=(10, max(3, 0.5 * len(templates))))
    y = np.arange(len(templates))
    plt.barh(y, np.asarray(probs)[:len(templates)], color=colors)
    plt.yticks(y, [t[:60] for t in templates], fontsize=7)
    plt.xlabel("probability")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def plot_confusion_matrix(true_values: Sequence, pred_values: Sequence,
                          path: str, labels: Optional[Sequence] = None
                          ) -> None:
    """Count-confusion heatmap (a numpy confusion, no sklearn)."""
    plt = _plt()
    if labels is None:
        labels = sorted(set(true_values) | set(pred_values))
    index = {v: i for i, v in enumerate(labels)}
    mat = np.zeros((len(labels), len(labels)), int)
    for t, p in zip(true_values, pred_values):
        mat[index[t], index[p]] += 1
    plt.figure(figsize=(8, 7))
    plt.imshow(mat, cmap="Blues")
    for i in range(len(labels)):
        for j in range(len(labels)):
            if mat[i, j]:
                plt.text(j, i, str(mat[i, j]), ha="center", va="center",
                         fontsize=7)
    plt.xticks(range(len(labels)), labels, rotation=45)
    plt.yticks(range(len(labels)), labels)
    plt.xlabel("Predicted")
    plt.ylabel("True")
    plt.title("Confusion Matrix")
    plt.colorbar()
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def plot_probability_confusion(confusion: np.ndarray, labels: Sequence,
                               path: str) -> None:
    """Probability-weighted confusion heatmap."""
    plt = _plt()
    plt.figure(figsize=(10, 8))
    plt.imshow(confusion, cmap="Blues", vmin=0.0)
    for i in range(confusion.shape[0]):
        for j in range(confusion.shape[1]):
            plt.text(j, i, f"{confusion[i, j]:.2f}", ha="center",
                     va="center", fontsize=7)
    plt.xticks(range(len(labels)), labels)
    plt.yticks(range(len(labels)), labels)
    plt.xlabel("Predicted Count")
    plt.ylabel("True Count")
    plt.title("Counting Confusion Matrix (Probabilities)")
    plt.colorbar()
    plt.savefig(path)
    plt.close()


def plot_probability_histograms(pos_probs: Sequence[float],
                                neg_probs: Sequence[float],
                                path: str) -> None:
    """Positive/negative template probability distributions."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].hist(pos_probs, bins=30, color="green", alpha=0.7)
    axes[0].set_title("Positive template probabilities")
    axes[1].hist(neg_probs, bins=30, color="red", alpha=0.7)
    axes[1].set_title("Negative template probabilities")
    for ax in axes:
        ax.set_xlabel("probability")
        ax.set_ylabel("count")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def write_stats(metrics: Dict, path: str) -> None:
    """Plain-text metrics dump, one ``key: value`` line each."""
    with open(path, "w") as f:
        for k, v in metrics.items():
            f.write(f"{k}: {v}\n")

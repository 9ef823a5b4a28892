"""VLMs-are-Blind evaluation suite, the port of ``clip_finegrained_alignment_
tpu/eval/vlmsblind.py`` (the protocol of the reference's
``vlms-are-blind/eval.py``).

Nine visual-reasoning tasks scored zero-shot with 4 hand-written positive
templates per task and task-specific negative templates: Touching Circles,
Line Plot Intersections, Circled Letter, Subway Connections, Nested
Squares, Olympic Counting ×2 (circles, pentagons), Counting Grid ×2 (blank,
word). Per-task ground-truth validation; the CountBench correctness rule;
accuracy, average confidence and high-confidence accuracy, where the
high-confidence cut is a fixed 0.5, not the decision threshold; per-task
``.npy`` result dumps.

Samples stream in batches through ``TemplateScorer`` (4 positive and at
most 6 negative slots, padded and masked). ``load_vlmsblind`` reads a
local JSON only: the HF hub's ``XAI/vlmsareblind`` is a download.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import CLIPConfig
from ..data.preprocess import load_image, preprocess_host
from ..data.tokenizer import load_tokenizer
from .scoring import (ModelOrStateDict, TemplateScorer, pad_templates,
                      thresholded_decision)

logger = logging.getLogger(__name__)

TASKS = (
    "Touching Circles",
    "Line Plot Intersections",
    "Circled Letter",
    "Subway Connections",
    "Nested Squares",
    "Olympic Counting - Circles",
    "Counting Grid - Blank Grids",
    "Counting Grid - Word Grids",
    "Olympic Counting - Pentagons",
)

VALID_VALUES = {
    "Line Plot Intersections": {0, 1, 2},
    "Olympic Counting - Circles": {5, 6, 7, 8, 9},
    "Olympic Counting - Pentagons": {5, 6, 7, 8, 9},
    "Nested Squares": {2, 3, 4, 5},
    "Subway Connections": {0, 1, 2, 3},
    # the alphabet minus f and j, which the benchmark's three source words
    # lack
    "Circled Letter": set("abcdeghiklmnopqrstuvwxyz"),
}

MAX_TEMPLATES = 10


def _parse_grid(groundtruth: str):
    sep = "," if "," in groundtruth else "x"
    rows, cols = map(int, groundtruth.split(sep))
    return rows, cols


def validate_groundtruth(task: str, groundtruth) -> bool:
    """Per-task validity gates."""
    try:
        if task == "Circled Letter":
            return str(groundtruth).lower() in VALID_VALUES[task]
        if task in VALID_VALUES:
            return int(groundtruth) in VALID_VALUES[task]
        if task == "Touching Circles":
            return str(groundtruth).lower() in {"yes", "no"}
        if task.startswith("Counting Grid"):
            rows, cols = _parse_grid(str(groundtruth))
            return 3 <= rows <= 10 and 3 <= cols <= 10
        return True
    except (ValueError, TypeError):
        return False


def positive_templates(task: str, groundtruth) -> List[str]:
    """4 positive templates per task."""
    g = str(groundtruth)
    if task == "Touching Circles":
        state = ("touching or overlapping" if g.lower() == "yes"
                 else "separated")
        return [f"Two circles that are {state}",
                f"A pair of circles that are {state}",
                f"Two circles {state} from each other",
                f"Two circles in {state} configuration"]
    if task == "Circled Letter":
        return [f"The letter {g} is circled in red",
                f"A red circle highlights the letter {g}",
                f"The character {g} is marked with a red oval",
                f"Letter {g} is emphasized with a red circle"]
    if task == "Line Plot Intersections":
        return [f"Two lines intersecting {g} times",
                f"A graph with {g} intersection points",
                f"Two line segments with {g} crossing points",
                f"Two piecewise linear functions with {g} intersections"]
    if task == "Subway Connections":
        return [f"{g} different paths between stations A and B",
                f"{g} unique routes connecting stations A and B",
                f"A subway map showing {g} paths between A and B",
                f"A transit map with {g} distinct routes between stations"]
    if task == "Nested Squares":
        return [f"A pattern of {g} nested squares",
                f"{g} concentric squares",
                f"{g} squares inside each other",
                f"A diagram showing {g} squares nested within each other"]
    if task.startswith("Olympic Counting"):
        shape = "circles" if "Circles" in task else "pentagons"
        return [f"An image with {g} overlapping {shape}",
                f"A logo-like pattern with {g} {shape}",
                f"{g} {shape} arranged in an Olympic-like pattern",
                f"A design containing {g} {shape} in overlapping rows"]
    if task.startswith("Counting Grid"):
        try:
            rows, cols = _parse_grid(g)
        except ValueError:
            return [f"A grid with {g}"]
        grid_type = "empty" if "Blank" in task else "filled with text"
        return [f"A {grid_type} grid with {rows} rows and {cols} columns",
                f"A {grid_type} table layout of {rows} by {cols}",
                f"A {grid_type} grid of size {rows} rows × {cols} columns",
                f"A {rows}×{cols} {grid_type} table"]
    logger.warning("Unknown task: %s", task)
    return [f"An image showing {g}"]


def negative_templates(task: str, groundtruth) -> List[str]:
    """Task-specific negatives."""
    if not validate_groundtruth(task, groundtruth):
        return ["Invalid input"]
    g = str(groundtruth)
    if task == "Touching Circles":
        state = ("separated" if g.lower() == "yes"
                 else "touching or overlapping")
        return [f"Two circles that are {state}"]
    if task == "Circled Letter":
        alphabet = "abcdefghijklmnopqrstuvwxyz"
        idx = alphabet.find(g.lower())
        if idx == -1:
            return ["A different letter is circled"]
        nearby = []
        for off in (-2, -1, 1, 2):
            c = alphabet[(idx + off) % 26]
            if c in VALID_VALUES["Circled Letter"]:
                nearby.append(c)
        return ([f"The letter {c} is circled in red" for c in nearby[:4]]
                + ["No letter is circled", "Multiple letters are circled"])
    if task in ("Olympic Counting - Circles", "Olympic Counting - Pentagons",
                "Line Plot Intersections", "Subway Connections"):
        gt = int(g)
        nearby = [n for n in VALID_VALUES[task] if n != gt][:4]
        shape = ("circles" if "Circles" in task else
                 "pentagons" if "Pentagons" in task else "intersections")
        return [f"An image showing {n} {shape}" for n in nearby]
    if task == "Nested Squares":
        gt = int(g)
        others = [n for n in VALID_VALUES[task] if n != gt]
        return ([f"{n} nested squares" for n in others]
                + ["Overlapping squares", "Adjacent squares"])
    if task.startswith("Counting Grid"):
        try:
            rows, cols = _parse_grid(g)
        except ValueError:
            return ["A grid with different dimensions"]
        grid_type = "empty" if "Blank" in task else "text-filled"
        pairs = [(rows + 1, cols), (rows - 1, cols),
                 (rows, cols + 1), (rows, cols - 1)]
        return ([f"A {grid_type} grid of size {r}×{c}" for r, c in pairs
                 if 3 <= r <= 9 and 3 <= c <= 9]
                + [f"A {grid_type} grid with random dimensions"])
    return ["Something else entirely", "An unrelated image"]


class VLMsBlindEvaluator:
    """Batched evaluator over the 9-task suite."""

    def __init__(self, model_or_state_dict: ModelOrStateDict,
                 model_cfg: CLIPConfig, *,
                 confidence: float = 0.25, margin: float = 0.01,
                 tokenizer=None, batch_size: int = 32, device="cuda",
                 dtype: torch.dtype = torch.float32, mesh=None):
        self.model_cfg = model_cfg
        self.confidence = confidence
        self.margin = margin
        self.tok = tokenizer if tokenizer is not None else load_tokenizer()
        self.batch_size = batch_size
        self.context_length = model_cfg.text.max_position_embeddings
        self.scorer = TemplateScorer(
            model_or_state_dict, model_cfg, device=device, dtype=dtype,
            pad_to_batch=batch_size if mesh is not None else None, mesh=mesh)

    def evaluate_task(self, samples: Sequence[Dict],
                      task: str) -> Dict[str, list]:
        """``samples``: dicts with ``image`` (uint8 HWC or path),
        ``task``, ``groundtruth``; only ``task``'s are scored. Invalid
        ground truths count as incorrect with confidence 0."""
        task_samples = [s for s in samples if s.get("task") == task]
        n = len(task_samples)
        results = {
            "correct": [False] * n,
            "confidence": [0.0] * n,
            "pred_templates": ["Invalid input"] * n,
            "groundtruth": [s["groundtruth"] for s in task_samples],
        }
        # Valid samples are scored in batches and written back by index;
        # invalid rows keep their incorrect / 0.0 defaults.
        batch_px, batch_tpl, batch_idx = [], [], []

        def flush():
            if not batch_px:
                return
            ids = [self.tok(t, self.context_length) for t, _ in batch_tpl]
            tpl_ids, valid, pos = pad_templates(
                ids, [p for _, p in batch_tpl], MAX_TEMPLATES,
                self.context_length, self.tok.pad_token_id)
            probs = self.scorer(np.stack(batch_px), tpl_ids, valid)
            dec = thresholded_decision(probs, pos, valid,
                                       self.confidence, self.margin)
            for i, j in enumerate(batch_idx):
                templates = batch_tpl[i][0]
                results["correct"][j] = bool(dec["correct"][i])
                results["confidence"][j] = float(dec["confidence"][i])
                results["pred_templates"][j] = \
                    templates[int(dec["argmax_idx"][i])]
            batch_px.clear()
            batch_tpl.clear()
            batch_idx.clear()

        for j, s in enumerate(task_samples):
            gt = s["groundtruth"]
            if not validate_groundtruth(task, gt):
                continue
            pos_t = positive_templates(task, gt)
            neg_t = negative_templates(task, gt)
            templates = pos_t + neg_t
            image = s["image"]
            if isinstance(image, str):
                image = load_image(image)
            px = preprocess_host(np.asarray(image),
                                 self.model_cfg.vision.image_size)
            batch_px.append(px)
            batch_tpl.append((templates, list(range(len(pos_t)))))
            batch_idx.append(j)
            if len(batch_px) == self.batch_size:
                flush()
        flush()
        return results

    def compute_metrics(self, results: Dict[str, list]) -> Dict:
        """The 0.5 high-confidence cut is fixed, independent of the
        decision threshold."""
        total = len(results["correct"])
        if total == 0:
            return {"accuracy": 0.0, "total_samples": 0, "correct": 0,
                    "avg_confidence": 0.0}
        correct = np.asarray(results["correct"])
        conf = np.asarray(results["confidence"])
        high = conf > 0.5
        return {
            "accuracy": float(correct.mean()),
            "total_samples": total,
            "correct": int(correct.sum()),
            "avg_confidence": float(conf.mean()),
            "high_confidence_accuracy":
                float(correct[high].mean()) if high.sum() > 0 else 0.0,
        }

    def run_all_tasks(self, samples: Sequence[Dict],
                      output_dir: Optional[str] = None,
                      tasks: Sequence[str] = TASKS) -> Dict[str, Dict]:
        """Evaluate every task; with ``output_dir``, write each task's
        ``.npy`` results and ``vlmsblind_metrics.json``."""
        all_metrics = {}
        for task in tasks:
            results = self.evaluate_task(samples, task)
            metrics = self.compute_metrics(results)
            all_metrics[task] = metrics
            logger.info("%s: %s", task, metrics)
            if output_dir:
                os.makedirs(output_dir, exist_ok=True)
                safe = task.replace(" ", "_").replace("-", "")
                np.save(os.path.join(output_dir, f"{safe}_results.npy"),
                        {"results": results, "metrics": metrics},
                        allow_pickle=True)
        if output_dir:
            with open(os.path.join(output_dir, "vlmsblind_metrics.json"),
                      "w") as f:
                json.dump(all_metrics, f, indent=2)
        return all_metrics


def load_vlmsblind(source: Optional[str] = None) -> List[Dict]:
    """VLMs-are-Blind samples from a local JSON (``[{image|image_path,
    task, groundtruth}]``). Anything else (the HF hub's
    ``XAI/vlmsareblind``, the default) is a download and raises
    ``SystemExit``."""
    if source and os.path.exists(source):
        with open(source) as f:
            items = json.load(f)
        for it in items:
            if "image" not in it:
                it["image"] = it.get("image_path")
        return items
    raise SystemExit(
        f"VLMs-are-Blind dataset {source or 'XAI/vlmsareblind'!r} is not a "
        "local JSON file; the HF hub dataset is a download, out of reach "
        "(no network). Pass a local JSON or --dataset procedural")

"""Zero-shot CountBench evaluation, the port of ``clip_finegrained_alignment_
tpu/eval/countbench.py`` (the protocol of the reference's
``count-bench/cb_eval.py``):

* valid counting range 1–12; the number-word extraction table goes to 20;
* templates: the first word-level occurrence of the caption's number is
  replaced; positives render the true count per ``number_format``
  (numeric | word | both), negatives n±1 and n±2 within the valid range;
  arrangement ``first`` | ``random``;
* correctness: the best positive's probability > confidence, > the best
  negative's + margin, and the global argmax; plus plain argmax accuracy
  from the number in the argmax template;
* metrics: accuracy, argmax accuracy, average confidence, high-confidence
  accuracy, per-number accuracy; a confusion-matrix PNG (best-effort) and
  a results ``.npy`` blob.

Samples stream in batches of ``batch_size`` through one ``TemplateScorer``
call each (templates padded to 10 slots and masked: 2 positives in the
``both`` format and 8 negatives at most).

``load_countbench`` reads a local JSON only: the HF hub dataset
``nielsr/countbench`` is a download, out of reach here.
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import CLIPConfig
from ..data import numbers
from ..data.preprocess import load_image, preprocess_host
from ..data.tokenizer import load_tokenizer
from .scoring import (ModelOrStateDict, TemplateScorer, pad_templates,
                      thresholded_decision)

logger = logging.getLogger(__name__)

VALID_NUMBERS = frozenset(range(1, 13))
MAX_TEMPLATES = 10                               # 2 pos + 4 counts × 2 fmts

# The extraction table goes to twenty.
_EXTRACT_WORDS = dict(numbers.WORD_NUMBERS)
_EXTRACT_WORDS.update({
    "thirteen": 13, "fourteen": 14, "fifteen": 15, "sixteen": 16,
    "seventeen": 17, "eighteen": 18, "nineteen": 19, "twenty": 20})


def format_number(n: int, number_format: str) -> List[str]:
    """Render a count per the format flag."""
    if number_format == "numeric":
        return [str(n)]
    if number_format == "word":
        return [numbers.to_word(n)]
    return [str(n), numbers.to_word(n)]


def extract_number(template: str) -> Optional[int]:
    """The first valid number (digit 1-12 or word 1-20) by word
    position."""
    for word in template.lower().split():
        if word.isdigit() and int(word) in VALID_NUMBERS:
            return int(word)
        if word in _EXTRACT_WORDS:
            return _EXTRACT_WORDS[word]
    return None


def find_number_word(text: str, number: int) -> str:
    """The token (digit or word form) by which ``number`` appears first in
    ``text``; the digit string when it does not appear."""
    digit, word = str(number), numbers.to_word(number).lower()
    for tok in text.lower().split():
        if tok == digit or tok == word:
            return tok
    logger.warning("Could not find number %s in text: %s", number, text)
    return digit


def generate_templates(text: str, number: int, number_format: str = "word"):
    """(positives, negatives) caption variants: word-level replacement at
    the first occurrence of the number."""
    original = find_number_word(text, number)
    words = text.split()
    idx = next((i for i, w in enumerate(words)
                if w.lower() == original.lower()), None)
    if idx is None:
        return [], []

    def render(n_fmt: str) -> str:
        out = words.copy()
        out[idx] = n_fmt
        return " ".join(out)

    positives = [render(f) for f in format_number(number, number_format)]
    nearby = [n for n in (number - 2, number - 1, number + 1, number + 2)
              if n in VALID_NUMBERS]
    negatives = [render(f) for n in nearby
                 for f in format_number(n, number_format)]
    return positives, negatives


class CountBenchEvaluator:
    """Batched CountBench evaluator over a ``TemplateScorer``."""

    def __init__(self, model_or_state_dict: ModelOrStateDict,
                 model_cfg: CLIPConfig, *,
                 confidence: float = 0.2, margin: float = 0.01,
                 number_format: str = "word",
                 template_position: str = "first",
                 tokenizer=None, batch_size: int = 32,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 seed: int = 0, debug_dir: Optional[str] = None,
                 samples_of_interest: Optional[Sequence[int]] = None,
                 mesh=None):
        if template_position not in ("first", "random"):
            raise ValueError(f"bad template_position {template_position!r}")
        # Debug mode: dump the input image and the template probability
        # bars of the selected (or all) sample indices.
        self.debug_dir = debug_dir
        self.samples_of_interest = set(samples_of_interest or [])
        self.model_cfg = model_cfg
        self.confidence = confidence
        self.margin = margin
        self.number_format = number_format
        self.template_position = template_position
        self.tok = tokenizer if tokenizer is not None else load_tokenizer()
        self.batch_size = batch_size
        self.context_length = model_cfg.text.max_position_embeddings
        self.scorer = TemplateScorer(
            model_or_state_dict, model_cfg, device=device, dtype=dtype,
            pad_to_batch=batch_size if mesh is not None else None, mesh=mesh)
        self._rng = random.Random(seed)

    # ------------------------------------------------------------------
    def _prepare_sample(self, text: str, number: int):
        """templates (arranged), positive slot indices — or None if the
        caption yields no templates."""
        pos, neg = generate_templates(text, number, self.number_format)
        if not pos:
            return None
        templates = pos + neg
        pos_idx = list(range(len(pos)))
        if self.template_position == "random":
            order = list(range(len(templates)))
            self._rng.shuffle(order)
            templates = [templates[i] for i in order]
            pos_idx = [order.index(i) for i in range(len(pos))]
        return templates, pos_idx

    def evaluate_dataset(self, samples: Sequence[Dict]) -> Dict[str, list]:
        """``samples``: dicts with ``image`` (uint8 HWC or path), ``text``,
        ``number``. Skips invalid samples (no image, or a number out of
        range). Returns the results blob."""
        results = {"correct": [], "confidence": [], "groundtruth": [],
                   "pred_numbers": [], "pred_templates": [], "texts": []}
        batch_px, batch_tpl, batch_meta = [], [], []
        sample_idx = 0

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
            for i, (number, templates, pos_idx, s_idx, raw) in \
                    enumerate(batch_meta):
                results["correct"].append(bool(dec["correct"][i]))
                results["confidence"].append(float(dec["confidence"][i]))
                results["groundtruth"].append(number)
                pred_t = templates[int(dec["argmax_idx"][i])]
                results["pred_templates"].append(pred_t)
                results["pred_numbers"].append(extract_number(pred_t))
                if self.debug_dir and (not self.samples_of_interest
                                       or s_idx in self.samples_of_interest):
                    self._dump_debug(s_idx, raw, templates, pos_idx,
                                     probs[i])
            batch_px.clear()
            batch_tpl.clear()
            batch_meta.clear()

        for s in samples:
            image, text, number = s.get("image"), s["text"], s["number"]
            if image is None or number not in VALID_NUMBERS:
                continue
            prep = self._prepare_sample(text, number)
            if prep is None:
                continue
            templates, pos_idx = prep
            if isinstance(image, str):
                image = load_image(image)
            px = preprocess_host(np.asarray(image),
                                 self.model_cfg.vision.image_size)
            batch_px.append(px)
            batch_tpl.append((templates, pos_idx))
            batch_meta.append((number, templates, pos_idx, sample_idx,
                               image if self.debug_dir else None))
            results["texts"].append(text)
            sample_idx += 1
            if len(batch_px) == self.batch_size:
                flush()
        flush()
        return results

    def _dump_debug(self, idx, image, templates, pos_idx, probs):
        """One sample's debug files: the raw image and the green/red
        template probability bars."""
        from .viz import plot_template_probabilities, save_debug_image
        os.makedirs(self.debug_dir, exist_ok=True)
        if image is not None:
            save_debug_image(np.asarray(image),
                             os.path.join(self.debug_dir,
                                          f"sample_{idx}_image.png"))
        plot_template_probabilities(
            templates, np.asarray(probs),
            os.path.join(self.debug_dir, f"sample_{idx}_probs.png"),
            pos_idx)

    # ------------------------------------------------------------------
    def compute_metrics(self, results: Dict[str, list]) -> Dict:
        total = len(results["correct"])
        if total == 0:
            return {"accuracy": 0.0, "total_samples": 0, "correct": 0,
                    "avg_confidence": 0.0}
        correct_arr = np.asarray(results["correct"])
        gts = np.asarray(results["groundtruth"])
        conf = np.asarray(results["confidence"])

        valid = [(t, p) for t, p in zip(results["groundtruth"],
                                        results["pred_numbers"])
                 if p is not None]
        argmax_acc = (sum(1 for t, p in valid if t == p) / len(valid)
                      if valid else 0.0)

        high = conf > self.confidence
        high_acc = (correct_arr[high].sum() / high.sum()
                    if high.sum() > 0 else 0.0)

        per_number = {}
        for n in sorted(VALID_NUMBERS):
            mask = gts == n
            if mask.sum() > 0:
                per_number[n] = float(correct_arr[mask].mean())

        return {
            "accuracy": float(correct_arr.mean()),
            "argmax_accuracy": float(argmax_acc),
            "total_samples": total,
            "correct": int(correct_arr.sum()),
            "avg_confidence": float(conf.mean()),
            "high_confidence_accuracy": float(high_acc),
            "per_number_accuracy": per_number,
        }

    def save_results(self, results: Dict, metrics: Dict,
                     output_dir: str, tag: str = "countbench") -> None:
        """The ``.npy`` results blob, the metrics JSON and the confusion
        PNG (best-effort: a host without matplotlib logs a warning)."""
        os.makedirs(output_dir, exist_ok=True)
        np.save(os.path.join(output_dir, f"{tag}_results.npy"),
                {"results": results, "metrics": metrics},
                allow_pickle=True)
        with open(os.path.join(output_dir, f"{tag}_metrics.json"),
                  "w") as f:
            json.dump(metrics, f, indent=2)
        try:
            from .viz import plot_confusion_matrix
            pairs = [(t, p) for t, p in zip(results["groundtruth"],
                                            results["pred_numbers"])
                     if p is not None]
            if pairs:
                t, p = zip(*pairs)
                plot_confusion_matrix(
                    list(t), list(p),
                    os.path.join(output_dir, f"{tag}_confusion.png"))
        except Exception as e:  # the plot is best-effort
            logger.warning("confusion plot failed: %s", e)


def load_countbench(source: Optional[str] = None) -> List[Dict]:
    """CountBench samples from a local JSON (``[{image_path|image, text,
    number}]``). Anything else (the HF hub's ``nielsr/countbench``, the
    default) is a download and raises ``SystemExit``."""
    if source and os.path.exists(source):
        with open(source) as f:
            items = json.load(f)
        for it in items:
            if "image" not in it:
                it["image"] = it.get("image_path")
        return items
    raise SystemExit(
        f"CountBench dataset {source or 'nielsr/countbench'!r} is not a "
        "local JSON file; the HF hub dataset is a download, out of reach "
        "(no network). Pass a local JSON or --dataset procedural")

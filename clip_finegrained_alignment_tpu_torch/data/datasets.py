"""Counting datasets and the input pipeline that feeds the trainer: the
port's copy of ``clip_finegrained_alignment_tpu/data/datasets.py``, the
same batches byte for byte from the same seed.

* Fixed-shape numpy batches (drop_last) with uint8 images; rescale and
  normalize run on the device inside the train step
  (``train/engine.py::compute_loss``), so the host ships 4x fewer bytes
  than fp32 tensors.
* A deterministic per-epoch shuffle shared by every process and a
  contiguous shard per process (``parallel/mesh.py``) replace
  ``DistributedSampler``.
* A background thread assembles batches ahead of the step (decode on the
  host while the device computes); a failure in it is raised in the
  consumer, never a silently short epoch.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import numbers
from .preprocess import load_image, pad_to_square, resize_center_crop
from .tokenizer import CONTEXT_LENGTH, load_tokenizer


# ---------------------------------------------------------------------------
# Record datasets (host-side, lazy image decode)
# ---------------------------------------------------------------------------

@dataclass
class Sample:
    image_path: str
    caption: str
    count: int


class SyntheticCaptionDataset:
    """Samples from a ``synthetic_annotations.json``
    (``synthetic_dataloader.py:11-82``): caption + first-number count
    feature. ``count`` falls back to caption parsing when the annotation
    lacks the field, as the reference does (:36-53)."""

    def __init__(self, annotations_path: str):
        with open(annotations_path) as f:
            anns = json.load(f)
        self.root = os.path.dirname(os.path.abspath(annotations_path))
        self.samples: List[Sample] = []
        for a in anns:
            count = a.get("count")
            if count is None:
                found = numbers.find_first_number(a.get("caption", ""))
                count = found[0] if found else 0
            self.samples.append(Sample(
                image_path=self._resolve(a["image_path"]),
                caption=a["caption"], count=int(count)))

    def _resolve(self, path: str) -> str:
        if os.path.isabs(path) and os.path.exists(path):
            return path
        cand = os.path.join(self.root, os.path.basename(path))
        return cand if os.path.exists(cand) else path

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Sample:
        return self.samples[i]


class CounterfactualCaptionDataset(SyntheticCaptionDataset):
    """Adds the 9 counterfactual captions per sample
    (``count_dataloader.py:51-73``): every count in [1,10] except the
    ground truth, rewritten after the last ``'with '``."""

    num_counterfactuals = 9

    def counterfactuals(self, i: int):
        s = self.samples[i]
        gt = numbers.count_after_with(s.caption) or s.count
        cf_counts = numbers.counterfactual_counts(gt)[
            :self.num_counterfactuals]
        cf_captions = [numbers.counterfactual_caption(s.caption, c)
                       for c in cf_counts]
        return cf_captions, cf_counts, gt


# ---------------------------------------------------------------------------
# Batch pipeline
# ---------------------------------------------------------------------------

class EpochBatchPipeline:
    """Shared epoch machinery for fixed-shape batch sources: deterministic
    cross-host shuffling, contiguous per-host shards (``parallel/mesh.py``),
    and a background producer thread double-buffering batch assembly against
    the device step. Subclasses provide ``_num_samples()`` and
    ``_make_batch(idx)``; the trainer protocol is ``batches(epoch)``
    (``train/engine.py::Trainer.train``)."""

    batch_size: int
    seed: int
    shuffle: bool
    process_index: Optional[int]
    process_count: Optional[int]
    prefetch: int

    def _num_samples(self) -> int:
        raise NotImplementedError

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def steps_per_epoch(self) -> int:
        from ..parallel.mesh import process_shard_bounds
        s, e = process_shard_bounds(self._num_samples(), self.process_index,
                                    self.process_count)
        return (e - s) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        from ..parallel.mesh import (epoch_permutation,
                                     process_shard_bounds)
        n = self._num_samples()
        order = epoch_permutation(n, epoch, self.seed) if self.shuffle \
            else np.arange(n)
        s, e = process_shard_bounds(n, self.process_index,
                                    self.process_count)
        idx = order[np.arange(s, e) % n]  # wraparound pad, sampler-style
        return idx

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yield fixed-shape batches, assembled ahead of consumption by a
        background thread (double-buffering host IO against device step)."""
        idx = self._epoch_indices(epoch)
        nb = len(idx) // self.batch_size
        if nb == 0:
            return iter(())
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = object()
        failure: list = []

        def producer():
            try:
                for b in range(nb):
                    sl = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    q.put(self._make_batch(sl))
            except BaseException as e:  # surface in the consumer, don't
                failure.append(e)       # silently truncate the epoch
            finally:
                q.put(stop)

        threading.Thread(target=producer, daemon=True).start()

        def gen():
            while True:
                item = q.get()
                if item is stop:
                    if failure:
                        raise failure[0]
                    return
                yield item

        return gen()

    def __call__(self, epoch: int):
        """Trainer protocol: ``batches(epoch)`` (train/engine.py)."""
        return self.epoch(epoch)


class CountingDataPipeline(EpochBatchPipeline):
    """Epoch-sharded, shuffled, fixed-shape batch source.

    ``mode``:
      * ``"standard"`` — {pixel_values u8 [B,S,S,3], input_ids i32 [B,T],
        count i32 [B]} (the synthetic_dataloader 3-tuple, :78-82)
      * ``"counterfactual"`` — adds {cf_input_ids [B,9,T], cf_counts [B,9]}
        and pads images to square first (the count_dataloader dict batch,
        :93-100)
    """

    def __init__(self, dataset: SyntheticCaptionDataset, batch_size: int,
                 *, mode: str = "standard", image_size: int = 224,
                 context_length: int = CONTEXT_LENGTH,
                 tokenizer=None, seed: int = 42, shuffle: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 prefetch: int = 2, use_native: str = "auto"):
        if mode not in ("standard", "counterfactual"):
            raise ValueError(f"bad mode {mode!r}")
        if mode == "counterfactual" and not isinstance(
                dataset, CounterfactualCaptionDataset):
            raise TypeError("counterfactual mode needs a "
                            "CounterfactualCaptionDataset")
        self.ds = dataset
        self.batch_size = batch_size
        self.mode = mode
        self.image_size = image_size
        self.tok = tokenizer if tokenizer is not None else load_tokenizer()
        self.seed = seed
        self.shuffle = shuffle
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # Native C++ batch assembler (native/cfa_host.cc): one call per
        # batch — threaded libjpeg/libpng decode + geometry with the GIL
        # released. Geometry matches the PIL path per mode: standard →
        # shorter-side resize + center crop (HF-processor window,
        # synthetic_dataloader.py:69-76), counterfactual → white pad to
        # square (count_dataloader.py:12-24). The resample kernel is the
        # PIL-compatible antialiased bicubic (native.FILTER_BICUBIC),
        # within 1 LSB of the PIL path on both geometries.
        # "auto" uses it when the library builds; "never" forces PIL.
        if use_native not in ("auto", "always", "never"):
            raise ValueError(f"bad use_native {use_native!r}")
        if use_native == "never":
            self._native = False
        else:
            from .. import native
            self._native = native.available()
            if use_native == "always" and not self._native:
                raise RuntimeError(
                    f"native loader unavailable: {native.build_error()}")
        logging.getLogger(__name__).info(
            "CountingDataPipeline image path: %s (mode=%s)",
            "native C++ assembler" if self._native else "PIL", mode)
        # Tokenize all captions once up front — captions are small and
        # static; this removes BPE from the per-epoch hot path entirely.
        self._input_ids = self.tok([s.caption for s in dataset.samples],
                                   context_length)
        if mode == "counterfactual":
            cf_ids, cf_counts = [], []
            for i in range(len(dataset)):
                caps, counts, _ = dataset.counterfactuals(i)
                cf_ids.append(self.tok(caps, context_length))
                cf_counts.append(counts)
            self._cf_input_ids = np.stack(cf_ids)        # [N, 9, T]
            self._cf_counts = np.asarray(cf_counts, np.int32)

    def _num_samples(self) -> int:
        return len(self.ds)

    def _load_pixels(self, sample: Sample) -> np.ndarray:
        img = load_image(sample.image_path)
        if self.mode == "counterfactual":
            img = pad_to_square(img)  # count_dataloader.py:12-24
        if img.shape[0] != self.image_size or img.shape[1] != self.image_size:
            img = resize_center_crop(img, self.image_size)
        return img

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        pixels = None
        if self._native:
            from .. import native
            geom = native.MODE_PAD_SQUARE if self.mode == "counterfactual" \
                else native.MODE_CENTER_CROP
            pixels = native.assemble_batch(
                [self.ds[i].image_path for i in idx], self.image_size,
                mode=geom)
        if pixels is None:
            pixels = np.stack([self._load_pixels(self.ds[i])
                               for i in idx])
        batch = {
            "pixel_values": pixels,                       # uint8
            "input_ids": self._input_ids[idx],
            "count": np.asarray([self.ds[i].count for i in idx], np.int32),
        }
        if self.mode == "counterfactual":
            batch["cf_input_ids"] = self._cf_input_ids[idx]
            batch["cf_counts"] = self._cf_counts[idx]
        return batch


# ---------------------------------------------------------------------------
# COCO captions warmup loader (the "dummy_data" path)
# ---------------------------------------------------------------------------

class CocoCaptionsDataset:
    """Random-subset COCO captions dataset (``finetune/dummy_data.py:10-52``):
    ``max_samples`` random images, one random caption per item per epoch."""

    def __init__(self, coco_dir: str, split: str = "val2017",
                 max_samples: Optional[int] = None, seed: int = 42):
        from pycocotools.coco import COCO
        self.image_dir = os.path.join(coco_dir, split)
        self.captions = COCO(os.path.join(
            coco_dir, "annotations", f"captions_{split}.json"))
        ids = sorted(self.captions.imgs.keys())
        rng = np.random.default_rng(seed)
        if max_samples is not None and max_samples < len(ids):
            ids = list(rng.choice(ids, size=max_samples, replace=False))
        self.samples = []
        for image_id in ids:
            ann_ids = self.captions.getAnnIds(imgIds=[int(image_id)])
            caps = [a["caption"] for a in self.captions.loadAnns(ann_ids)]
            if not caps:
                continue
            info = self.captions.loadImgs([int(image_id)])[0]
            self.samples.append(
                (os.path.join(self.image_dir, info["file_name"]), caps))
        self._rng = rng

    def __len__(self):
        return len(self.samples)

    def as_caption_dataset(self) -> SyntheticCaptionDataset:
        """Fix one random caption per image and expose the standard
        pipeline interface."""
        ds = SyntheticCaptionDataset.__new__(SyntheticCaptionDataset)
        ds.root = self.image_dir
        ds.samples = []
        for path, caps in self.samples:
            cap = caps[int(self._rng.integers(len(caps)))]
            found = numbers.find_first_number(cap)
            ds.samples.append(Sample(image_path=path, caption=cap,
                                     count=found[0] if found else 0))
        return ds

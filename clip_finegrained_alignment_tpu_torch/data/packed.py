"""Packed-dataset ingest, a decode-free training feed: the port's copy of
``clip_finegrained_alignment_tpu/data/packed.py`` (same ``.npy`` layout,
same ``meta.json``, the same batches).

* ``pack_dataset`` runs the host preprocessing once (decode, geometry for
  the training mode, tokenization) and writes flat ``.npy`` arrays
  (``pixels.npy`` uint8 [N, S, S, 3], ``input_ids.npy`` i32 [N, T],
  ``counts.npy``, and in counterfactual mode ``cf_input_ids.npy`` and
  ``cf_counts.npy``) with a ``meta.json`` describing them.
* ``PackedDataPipeline`` memory-maps ``pixels.npy`` and streams the same
  batches as ``CountingDataPipeline`` (same shuffle, shards and prefetch),
  each one fancy-index copy out of the page cache instead of B decodes.
  With ``index_only`` the batches carry ``pixel_index`` and the trainer
  gathers pixels from a bank on the device (``pixel_bank``).

The pack stores the output of the per-sample pipeline the live loader
runs, so its batches are byte-equal to ``CountingDataPipeline``'s for the
same (seed, epoch, shard).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from .datasets import (CounterfactualCaptionDataset, CountingDataPipeline,
                       EpochBatchPipeline, SyntheticCaptionDataset)
from .tokenizer import CONTEXT_LENGTH

PACK_VERSION = 1
META_NAME = "meta.json"

_ARRAYS = {
    "standard": ("pixels", "input_ids", "counts"),
    "counterfactual": ("pixels", "input_ids", "counts",
                       "cf_input_ids", "cf_counts"),
}


def pack_dataset(annotations_path: str, output_dir: str, *,
                 mode: str = "standard", image_size: int = 224,
                 context_length: int = CONTEXT_LENGTH, tokenizer=None,
                 use_native: str = "auto", chunk_size: int = 64,
                 log_every: int = 0) -> Dict:
    """One-time preprocess: annotations JSON → packed ``.npy`` directory.

    Reuses ``CountingDataPipeline``'s batch assembler (native C++ decoder
    when available, PIL otherwise) on sequential index chunks, so the
    stored pixels are produced by the identical code path training would
    otherwise run per-epoch. Returns the written ``meta.json`` dict.
    """
    if mode not in _ARRAYS:
        raise ValueError(f"bad mode {mode!r}")
    ds_cls = CounterfactualCaptionDataset if mode == "counterfactual" \
        else SyntheticCaptionDataset
    dataset = ds_cls(annotations_path)
    n = len(dataset)
    if n == 0:
        raise ValueError(f"{annotations_path}: empty dataset")
    pipe = CountingDataPipeline(
        dataset, batch_size=min(chunk_size, n), mode=mode,
        image_size=image_size, context_length=context_length,
        tokenizer=tokenizer, shuffle=False, use_native=use_native)

    os.makedirs(output_dir, exist_ok=True)
    pixels = np.lib.format.open_memmap(
        os.path.join(output_dir, "pixels.npy"), mode="w+", dtype=np.uint8,
        shape=(n, image_size, image_size, 3))
    for lo in range(0, n, chunk_size):
        idx = np.arange(lo, min(lo + chunk_size, n))
        pixels[lo:lo + len(idx)] = pipe._make_batch(idx)["pixel_values"]
        if log_every and (lo // chunk_size) % log_every == 0:
            print(f"packed {lo + len(idx)}/{n} images", flush=True)
    pixels.flush()
    del pixels

    np.save(os.path.join(output_dir, "input_ids.npy"),
            pipe._input_ids.astype(np.int32))
    np.save(os.path.join(output_dir, "counts.npy"),
            np.asarray([s.count for s in dataset.samples], np.int32))
    if mode == "counterfactual":
        np.save(os.path.join(output_dir, "cf_input_ids.npy"),
                pipe._cf_input_ids.astype(np.int32))
        np.save(os.path.join(output_dir, "cf_counts.npy"), pipe._cf_counts)

    meta = {
        "version": PACK_VERSION,
        "mode": mode,
        "num_samples": n,
        "image_size": image_size,
        "context_length": context_length,
        "annotations": os.path.abspath(annotations_path),
        "arrays": list(_ARRAYS[mode]),
    }
    with open(os.path.join(output_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


class PackedDataPipeline(EpochBatchPipeline):
    """Stream fixed-shape batches from a ``pack_dataset`` directory.

    Pixels stay memory-mapped (the page cache is the only host "decode");
    token ids / counts are small and loaded into RAM. Batch keys match
    ``CountingDataPipeline`` exactly: {pixel_values u8, input_ids i32,
    count i32} plus {cf_input_ids, cf_counts} in counterfactual mode.
    """

    def __init__(self, packed_dir: str, batch_size: int, *,
                 seed: int = 42, shuffle: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 prefetch: int = 2,
                 expect_mode: Optional[str] = None,
                 expect_image_size: Optional[int] = None,
                 expect_context_length: Optional[int] = None,
                 index_only: bool = False):
        meta_path = os.path.join(packed_dir, META_NAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{packed_dir}: not a packed dataset (no {META_NAME}; "
                "create one with cli.pack_dataset)")
        with open(meta_path) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != PACK_VERSION:
            raise ValueError(
                f"{packed_dir}: pack version {self.meta.get('version')} "
                f"!= supported {PACK_VERSION}; re-pack the dataset")
        for name, expect in (("mode", expect_mode),
                             ("image_size", expect_image_size),
                             ("context_length", expect_context_length)):
            if expect is not None and self.meta.get(name) != expect:
                raise ValueError(
                    f"{packed_dir}: packed {name}={self.meta.get(name)!r} "
                    f"but this run needs {expect!r} — re-pack with the "
                    "matching flags (a silent mismatch would feed the "
                    "model wrong-geometry pixels or a wrong tokenizer "
                    "layout)")
        self.mode = self.meta["mode"]
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch

        self._pixels = np.load(os.path.join(packed_dir, "pixels.npy"),
                               mmap_mode="r")
        self._input_ids = np.load(os.path.join(packed_dir, "input_ids.npy"))
        self._counts = np.load(os.path.join(packed_dir, "counts.npy"))
        n = self.meta["num_samples"]
        if len(self._pixels) != n or len(self._input_ids) != n:
            raise ValueError(
                f"{packed_dir}: array lengths disagree with meta "
                f"(pixels {len(self._pixels)}, ids {len(self._input_ids)}, "
                f"meta {n}) — incomplete pack?")
        if self.mode == "counterfactual":
            self._cf_input_ids = np.load(
                os.path.join(packed_dir, "cf_input_ids.npy"))
            self._cf_counts = np.load(
                os.path.join(packed_dir, "cf_counts.npy"))

        # Device-resident mode (``index_only=True``): batches carry
        # ``pixel_index`` instead of pixels and the train step gathers them
        # from the bank on the device (``train/engine.py``). A step's
        # host-to-device traffic drops from S·S·3 to 4 bytes a sample.
        self.index_only = index_only

    def _num_samples(self) -> int:
        return int(self.meta["num_samples"])

    def pixel_bank(self) -> np.ndarray:
        """The full uint8 [N, S, S, 3] pixel array (memory-mapped), for
        one placement in device memory (the trainer's ``pixel_bank``)."""
        return self._pixels

    def pixel_bank_bytes(self) -> int:
        return int(self._pixels.size)

    def materialize(self, batch: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """Index batch → pixel batch (for host-side eval paths that need
        real pixels, e.g. the per-epoch counting eval)."""
        if "pixel_index" not in batch:
            return batch
        out = {k: v for k, v in batch.items() if k != "pixel_index"}
        out["pixel_values"] = self._pixels[batch["pixel_index"]]
        return out

    def _make_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        batch = {
            "input_ids": self._input_ids[idx],
            "count": self._counts[idx],
        }
        if self.index_only:
            batch["pixel_index"] = idx.astype(np.int32)
        else:
            batch["pixel_values"] = self._pixels[idx]  # fancy index → copy
        if self.mode == "counterfactual":
            batch["cf_input_ids"] = self._cf_input_ids[idx]
            batch["cf_counts"] = self._cf_counts[idx]
        return batch

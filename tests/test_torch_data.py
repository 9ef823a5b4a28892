"""The port's data path (``clip_finegrained_alignment_tpu_torch/data``,
``native/``, ``parallel/mesh.py`` and the generate / pack CLIs) against the
JAX package's, on the CPU, from one seed.

Everything here is host code on integers and bytes, so every comparison is
exact: the same annotations, the same PNG bytes, the same batches (pixels,
ids, counts, counterfactuals) over two epochs and over process shards, the
same packed arrays and ``meta.json``. The JAX generator is run on its numpy
paste (its ``native.available`` monkeypatched to False, no JAX file
changed); the port's native paste is held to its numpy paste.
"""

import json
import os

import numpy as np
import pytest

from clip_finegrained_alignment_tpu import native as jnative
from clip_finegrained_alignment_tpu.data import datasets as jds
from clip_finegrained_alignment_tpu.data import numbers as jnumbers
from clip_finegrained_alignment_tpu.data import packed as jpacked
from clip_finegrained_alignment_tpu.data import preprocess as jpre
from clip_finegrained_alignment_tpu.data import synthetic as jsyn
from clip_finegrained_alignment_tpu.data.tokenizer import \
    HashTokenizer as JHashTokenizer
from clip_finegrained_alignment_tpu.parallel import mesh as jmesh
from clip_finegrained_alignment_tpu_torch import native as tnative
from clip_finegrained_alignment_tpu_torch.cli import generate_data, pack_dataset
from clip_finegrained_alignment_tpu_torch.data import datasets as tds
from clip_finegrained_alignment_tpu_torch.data import numbers as tnumbers
from clip_finegrained_alignment_tpu_torch.data import packed as tpacked
from clip_finegrained_alignment_tpu_torch.data import preprocess as tpre
from clip_finegrained_alignment_tpu_torch.data import synthetic as tsyn
from clip_finegrained_alignment_tpu_torch.data.tokenizer import \
    HashTokenizer as THashTokenizer
from clip_finegrained_alignment_tpu_torch.parallel import mesh as tmesh

TOK = dict(vocab_size=256, bos_token_id=254, eos_token_id=255,
           pad_token_id=0)
IMAGE, CTX, BATCH, SEED = 32, 16, 4, 7
SHARDS = [None, (0, 2), (1, 2)]


def _dataset(root, num_samples=16, seed=3, image_size=64, **kw):
    tsyn.generate_procedural_dataset(str(root), num_samples,
                                     image_size=image_size, max_objects=3,
                                     seed=seed, **kw)
    return os.path.join(str(root), "synthetic_annotations.json")


@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    return _dataset(tmp_path_factory.mktemp("data"))


def _without_paths(anns):
    return [{**a, "image_path": os.path.basename(a["image_path"])}
            for a in anns]


@pytest.mark.parametrize("mode", ["count", "integer", "full"])
def test_generated_dataset_matches_jax(tmp_path, monkeypatch, mode):
    monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(image_size=64, max_objects=3, seed=3, annotation_mode=mode)
    want = jsyn.generate_procedural_dataset(str(tmp_path / "jax"), 12, **kw)
    got = tsyn.generate_procedural_dataset(str(tmp_path / "port"), 12, **kw)
    assert _without_paths(got) == _without_paths(want)
    for side in ("jax", "port"):
        with open(tmp_path / side / "synthetic_annotations.json") as f:
            assert _without_paths(json.load(f)) == _without_paths(want)
    for a in want:
        name = os.path.basename(a["image_path"])
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_native_paste_matches_numpy_paste(tmp_path, monkeypatch):
    if not tnative.available():
        pytest.skip(f"native library not built here: "
                    f"{tnative.build_error()}")
    rng = np.random.default_rng(0)
    for alpha in ("opaque", "mask", "any"):
        for x, y in ((5, 9), (-7, 3), (50, 58), (-20, -20), (70, 0)):
            dst = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
            obj = rng.integers(0, 256, (17, 13, 3), dtype=np.uint8)
            a = None if alpha == "opaque" else \
                rng.integers(0, 2, (17, 13), dtype=np.uint8) * 255 \
                if alpha == "mask" else \
                rng.integers(0, 256, (17, 13), dtype=np.uint8)
            native = dst.copy()
            assert tnative.alpha_paste(native, obj, a, x, y)
            with monkeypatch.context() as mp:
                mp.setattr(tnative, "available", lambda: False)
                plain = dst.copy()
                tsyn.alpha_paste(plain, obj, a, x, y)
            diff = np.abs(native.astype(int) - plain.astype(int)).max()
            # Integer blend against numpy's truncated float blend: equal
            # for 0/255 masks, at most 1 apart for other alphas.
            assert diff <= (1 if alpha == "any" else 0), (alpha, x, y)
    # A whole dataset: native paste against numpy paste, byte for byte.
    _dataset(tmp_path / "native", num_samples=6)
    monkeypatch.setattr(tnative, "available", lambda: False)
    _dataset(tmp_path / "numpy", num_samples=6)
    for i in range(6):
        name = f"synthetic_{i}.png"
        assert (tmp_path / "native" / name).read_bytes() == \
            (tmp_path / "numpy" / name).read_bytes()


def _pipelines(annotations, mode, use_native, shard):
    pi, pc = shard or (None, None)
    out = []
    for ds_mod, tok_cls in ((jds, JHashTokenizer), (tds, THashTokenizer)):
        cls = ds_mod.CounterfactualCaptionDataset \
            if mode == "counterfactual" else ds_mod.SyntheticCaptionDataset
        out.append(ds_mod.CountingDataPipeline(
            cls(annotations), BATCH, mode=mode, image_size=IMAGE,
            context_length=CTX, tokenizer=tok_cls(**TOK), seed=SEED,
            process_index=pi, process_count=pc, use_native=use_native))
    return out


def _assert_same_epochs(want_pipe, got_pipe, epochs=(0, 1)):
    assert got_pipe.steps_per_epoch() == want_pipe.steps_per_epoch() > 0
    for epoch in epochs:
        want = list(want_pipe.epoch(epoch))
        got = list(got_pipe(epoch))
        assert len(got) == len(want) == want_pipe.steps_per_epoch()
        for w, g in zip(want, got):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("shard", SHARDS, ids=["all", "0of2", "1of2"])
@pytest.mark.parametrize("use_native", ["never", "auto"])
@pytest.mark.parametrize("mode", ["standard", "counterfactual"])
def test_counting_pipeline_matches_jax(annotations, mode, use_native, shard):
    want, got = _pipelines(annotations, mode, use_native, shard)
    assert got._native == want._native
    _assert_same_epochs(want, got)
    batch = next(iter(got.epoch(0)))
    assert batch["pixel_values"].shape == (BATCH, IMAGE, IMAGE, 3)
    if mode == "counterfactual":
        assert batch["cf_input_ids"].shape == (BATCH, 9, CTX)


def _pack(module, annotations, out, mode, tok_cls):
    return module.pack_dataset(annotations, str(out), mode=mode,
                               image_size=IMAGE, context_length=CTX,
                               tokenizer=tok_cls(**TOK), use_native="never",
                               chunk_size=5)


@pytest.mark.parametrize("mode", ["standard", "counterfactual"])
def test_pack_dataset_writes_what_jax_writes(annotations, tmp_path, mode):
    want = _pack(jpacked, annotations, tmp_path / "jax", mode,
                 JHashTokenizer)
    got = _pack(tpacked, annotations, tmp_path / "port", mode,
                THashTokenizer)
    assert got == want
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == len(want["arrays"]) + 1
    with open(tmp_path / "port" / "meta.json") as f:
        assert json.load(f) == want
    for name in names:
        if name.endswith(".npy"):
            w = np.load(tmp_path / "jax" / name)
            g = np.load(tmp_path / "port" / name)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("index_only", [False, True])
@pytest.mark.parametrize("mode", ["standard", "counterfactual"])
def test_packed_pipeline_matches_jax(annotations, tmp_path, mode,
                                     index_only):
    _pack(tpacked, annotations, tmp_path, mode, THashTokenizer)
    kw = dict(seed=SEED, expect_mode=mode, expect_image_size=IMAGE,
              expect_context_length=CTX, index_only=index_only)
    want = jpacked.PackedDataPipeline(str(tmp_path), BATCH, **kw)
    got = tpacked.PackedDataPipeline(str(tmp_path), BATCH, **kw)
    _assert_same_epochs(want, got)
    np.testing.assert_array_equal(got.pixel_bank(), want.pixel_bank())
    assert got.pixel_bank_bytes() == want.pixel_bank_bytes() \
        == 16 * IMAGE * IMAGE * 3
    for batch in got.epoch(1):
        assert ("pixel_index" in batch) == index_only
        assert ("pixel_values" in batch) != index_only
        mat, wmat = got.materialize(batch), want.materialize(batch)
        assert sorted(mat) == sorted(wmat)
        for k in wmat:
            np.testing.assert_array_equal(mat[k], wmat[k])
    # The pack's batches are the live pipeline's, byte for byte.
    live = _pipelines(annotations, mode, "never", None)[1]
    for a, b in zip(live.epoch(0), got.epoch(0)):
        b = got.materialize(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_packed_pipeline_refuses_a_mismatched_pack(annotations, tmp_path):
    _pack(tpacked, annotations, tmp_path, "standard", THashTokenizer)
    for kw in (dict(expect_mode="counterfactual"),
               dict(expect_image_size=IMAGE * 2),
               dict(expect_context_length=CTX + 1)):
        with pytest.raises(ValueError, match="re-pack"):
            tpacked.PackedDataPipeline(str(tmp_path), BATCH, **kw)
    with pytest.raises(FileNotFoundError, match="not a packed dataset"):
        tpacked.PackedDataPipeline(str(tmp_path / "missing"), BATCH)


def test_generate_and_pack_clis(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
    out = tmp_path / "gen"
    generate_data.main(["--procedural", "--output-dir", str(out),
                        "--num-samples", "8", "--image-size", "64",
                        "--seed", "5", "--max-objects", "3",
                        "--visualize", "1"])
    anns = out / "synthetic_annotations.json"
    want = tsyn.generate_procedural_dataset(str(tmp_path / "lib"), 8,
                                            image_size=64, max_objects=3,
                                            seed=5)
    with open(anns) as f:
        assert _without_paths(json.load(f)) == _without_paths(want)
    assert (out / "viz" / "debug_0.png").exists()
    pack_dataset.main(["--annotations", str(anns), "--output",
                       str(tmp_path / "pack"), "--model", "tiny",
                       "--loss-type", "count", "--use-native", "never"])
    with open(tmp_path / "pack" / "meta.json") as f:
        meta = json.load(f)
    assert meta["mode"] == "counterfactual" and meta["num_samples"] == 8
    assert meta["image_size"] == IMAGE and meta["context_length"] == CTX
    assert np.load(tmp_path / "pack" / "cf_input_ids.npy").shape == \
        (8, 9, CTX)
    assert "packed 8 samples" in capsys.readouterr().out


class _FailingPipeline(tds.EpochBatchPipeline):
    batch_size, seed, shuffle, prefetch = 2, 0, False, 1
    process_index, process_count = 0, 1

    def _num_samples(self):
        return 8

    def _make_batch(self, idx):
        if idx[0] >= 4:
            raise OSError(f"cannot read sample {idx[0]}")
        return {"x": idx}


def test_producer_failure_is_raised_in_the_consumer():
    got = []
    with pytest.raises(OSError, match="cannot read sample 4"):
        for batch in _FailingPipeline().epoch(0):
            got.append(batch["x"].tolist())
    assert got == [[0, 1], [2, 3]]


CAPTIONS = ["A photo of a kitchen with 4 cups",
            "A photo of a table with three oranges",
            "two cats and 3 dogs", "no counts here",
            "A photo of a field with 1 red circle.",
            "A photo of a textured background with 10 blue squares"]


@pytest.mark.parametrize("caption", CAPTIONS)
def test_numbers_match_jax(caption):
    for fn in ("find_first_number", "count_after_with"):
        assert getattr(tnumbers, fn)(caption) == \
            getattr(jnumbers, fn)(caption)
    for n in range(1, 13):
        assert tnumbers.counterfactual_caption(caption, n) == \
            jnumbers.counterfactual_caption(caption, n)
        assert tnumbers.replace_first_number(caption, n, "numeric") == \
            jnumbers.replace_first_number(caption, n, "numeric")
        assert tnumbers.counterfactual_counts(n) == \
            jnumbers.counterfactual_counts(n)


def test_host_preprocessing_matches_jax(annotations, tmp_path):
    rng = np.random.default_rng(1)
    with open(annotations) as f:
        path = json.load(f)[0]["image_path"]
    np.testing.assert_array_equal(tpre.load_image(path),
                                  jpre.load_image(path))
    for shape in ((40, 64, 3), (64, 40, 3), (33, 33, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(tpre.pad_to_square(img),
                                      jpre.pad_to_square(img))
        np.testing.assert_array_equal(tpre.preprocess_host(img, 32),
                                      jpre.preprocess_host(img, 32))


@pytest.mark.parametrize("n", [1, 7, 16, 1000])
def test_shards_and_permutations_match_jax(n):
    for pc in (1, 2, 3):
        for pi in range(pc):
            assert tmesh.process_shard_bounds(n, pi, pc) == \
                jmesh.process_shard_bounds(n, pi, pc)
    assert tmesh.process_shard_bounds(n) == (0, n)
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(tmesh.epoch_permutation(n, epoch, 3),
                                      jmesh.epoch_permutation(n, epoch, 3))

"""The port's framework-free copies (tokenizer, preprocessing, configs, FLOP
counts) against the JAX package's originals: identical ids, identical
bytes, identical configs and counts, and normalization to fp32 rounding
(atol 1e-6; both compute (x - mean) / std in fp32)."""

import dataclasses
import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu import config as jconfig
from clip_finegrained_alignment_tpu.data import preprocess as jpre
from clip_finegrained_alignment_tpu.data import tokenizer as jtok
from clip_finegrained_alignment_tpu.utils import flops as jflops
from clip_finegrained_alignment_tpu_torch import config as tconfig
from clip_finegrained_alignment_tpu_torch.data import preprocess as tpre
from clip_finegrained_alignment_tpu_torch.data import tokenizer as ttok
from clip_finegrained_alignment_tpu_torch.utils import flops as tflops

TEXTS = ["a photo of three cats", "Two DOGS,  sitting!", "",
         "the cat's hat &amp; 42 dogs", "café naïve — test",
         " ".join(["word"] * 100)]                  # truncated at 77

MERGES = [("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"),
          ("d", "o"), ("do", "g</w>"), ("h", "a"), ("ha", "t</w>"),
          ("o", "f</w>"), ("p", "h"), ("ph", "o"), ("pho", "t"),
          ("phot", "o</w>"), ("w", "o"), ("wo", "r"), ("wor", "d</w>")]

MODEL_NAMES = ["ViT-B/32", "ViT-B/16", "ViT-L/14", "ViT-L/14@336", "tiny"]


@pytest.mark.parametrize("kind", ["default", "tiny"])
def test_hash_tokenizer_gives_identical_ids(kind):
    kw = {} if kind == "default" else dict(
        vocab_size=256, bos_token_id=254, eos_token_id=255, pad_token_id=0)
    for ctx in (77, 16):
        np.testing.assert_array_equal(ttok.HashTokenizer(**kw)(TEXTS, ctx),
                                      jtok.HashTokenizer(**kw)(TEXTS, ctx))


@pytest.mark.parametrize("fmt", ["openai", "hf"])
def test_bpe_tokenizer_gives_identical_ids(tmp_path, fmt):
    if fmt == "openai":
        path = tmp_path / "bpe.txt.gz"
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write("#version: test\n"
                    + "\n".join(" ".join(m) for m in MERGES) + "\n")
        ours = ttok.load_tokenizer(str(path))
        ref = jtok.load_tokenizer(str(path))
    else:
        vocab = jtok.CLIPTokenizer(MERGES).encoder
        (tmp_path / "vocab.json").write_text(json.dumps(vocab))
        (tmp_path / "merges.txt").write_text(
            "#version: test\n" + "\n".join(" ".join(m) for m in MERGES))
        ours = ttok.load_tokenizer(str(tmp_path))
        ref = jtok.load_tokenizer(str(tmp_path))
    assert isinstance(ours, ttok.CLIPTokenizer)
    np.testing.assert_array_equal(ours(TEXTS), ref(TEXTS))
    for text in TEXTS[:5]:
        assert ours.encode(text) == ref.encode(text)
        assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))


def test_load_tokenizer_fails_loudly_without_a_vocab(monkeypatch):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    monkeypatch.delenv("CFA_ALLOW_HASH_TOKENIZER", raising=False)
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer()
    monkeypatch.setenv("CFA_ALLOW_HASH_TOKENIZER", "1")
    assert isinstance(ttok.load_tokenizer(), ttok.HashTokenizer)


def test_normalize_batch_matches_jax():
    assert tpre.CLIP_MEAN == jpre.CLIP_MEAN and tpre.CLIP_STD == jpre.CLIP_STD
    x = np.random.default_rng(0).random((2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tpre.normalize_batch(torch.from_numpy(x)).numpy(),
        np.asarray(jpre.normalize_batch(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(48, 64, 3), (100, 37, 3), (32, 32, 3)])
def test_resize_center_crop_gives_identical_bytes(shape):
    img = np.random.default_rng(1).integers(0, 256, size=shape) \
        .astype(np.uint8)
    np.testing.assert_array_equal(tpre.resize_center_crop(img, 32),
                                  jpre.resize_center_crop(img, 32))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_configs_equal_the_jax_configs(name):
    ours = tconfig.CLIPConfig.from_name(name)
    ref = jconfig.CLIPConfig.from_name(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.vision.seq_len == ref.vision.seq_len
    assert ours.vision.head_dim == ref.vision.head_dim
    assert ours.text.head_dim == ref.text.head_dim


def test_unknown_model_name_raises():
    with pytest.raises(ValueError):
        tconfig.CLIPConfig.from_name("ViT-H/14")


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_flop_counts_equal_the_jax_counts(name):
    ours = tconfig.CLIPConfig.from_name(name)
    ref = jconfig.CLIPConfig.from_name(name)
    for sparc in (True, False):
        assert tflops.clip_forward_flops(ours, sparc=sparc) \
            == jflops.clip_forward_flops(ref, sparc=sparc)
    assert tflops.image_forward_flops(ours) \
        + tflops.text_forward_flops(ours) \
        == jflops.clip_forward_flops(ref, sparc=False)
    v = ours.vision
    assert tflops._tower_forward_flops(v.seq_len, v.hidden_size,
                                       v.intermediate_size, v.num_layers) \
        == jflops._tower_forward_flops(v.seq_len, v.hidden_size,
                                       v.intermediate_size, v.num_layers)

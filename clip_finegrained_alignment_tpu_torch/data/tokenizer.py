"""CLIP byte-pair-encoding tokenizer, vendored (no Rust, no network).

The port's own copy of ``clip_finegrained_alignment_tpu/data/tokenizer.py``
(numpy only); it gives identical ids. HF ``CLIPProcessor`` and the OpenAI
``clip`` package's ``SimpleTokenizer`` implement the same published CLIP
BPE scheme: lowercase + whitespace-clean the text, split with the CLIP
regex, encode each word byte-level with a learned merge table, append
``</w>`` to word-final tokens, and wrap in
``<|startoftext|> ... <|endoftext|>`` padded to 77.

This module implements that algorithm in pure Python. The merge table
(training artifact, not code) loads from either published format:

* OpenAI ``bpe_simple_vocab_16e6.txt.gz`` (one merge per line)
* HF ``vocab.json`` + ``merges.txt``

Tokenization is host-side data prep on fixed 77-token shapes, never on the
device's hot path, so pure Python is the right tool.

``HashTokenizer`` is the hermetic stand-in for environments with no vocab
file (e.g. CI): same API, same special-token layout, deterministic ids.
"""

from __future__ import annotations

import gzip
import html
import json
import os
import re
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77  # config.py:16 — CLIP's fixed text length


# ---------------------------------------------------------------------------
# Byte-level unicode mapping (GPT-2/CLIP standard)
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map raw bytes to printable unicode chars so BPE operates on strings
    without whitespace/control-character pitfalls (GPT-2 scheme)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


try:                                   # ftfy is what the OpenAI tokenizer
    import ftfy                        # applies first; optional here — when
    _fix_text = ftfy.fix_text          # present (parity hosts) we match it
except ImportError:                    # exactly, otherwise clean UTF-8 text
    _fix_text = None                   # is returned unchanged by fix_text.


def basic_clean(text: str) -> str:
    """ftfy.fix_text (when installed) + html-unescape twice — the OpenAI
    tokenizer's cleanup (clip/simple_tokenizer.py). Without ftfy, mojibake
    inputs may tokenize differently; well-formed UTF-8 is unaffected."""
    if _fix_text is not None:
        text = _fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# The CLIP word-split pattern. The real pattern needs unicode categories
# (\p{L}/\p{N}); the ``regex`` module (a transformers dependency, reliably
# present) provides them — identical matches to the HF/OpenAI tokenizers.
# The ``re`` fallback approximates letters with a range that misclassifies
# some unicode punctuation (em-dash, CJK punctuation) as letters; only
# ASCII captions are guaranteed bit-identical under the fallback.
try:
    import regex
    _PAT = regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        regex.IGNORECASE)
except ImportError:  # pragma: no cover - regex ships with transformers
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[a-zA-ZÀ-￿]+|[0-9]|[^\sa-zA-Z0-9À-￿]+",
        re.IGNORECASE)


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# ---------------------------------------------------------------------------
# BPE tokenizer
# ---------------------------------------------------------------------------

class CLIPTokenizer:
    """The CLIP ``SimpleTokenizer`` algorithm over a loaded merge table."""

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 vocab: Optional[Dict[str, int]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        if vocab is None:
            # OpenAI construction: 256 bytes, 256 byte+'</w>', merged
            # tokens in merge order, then the two specials.
            chars = list(self.byte_encoder.values())
            tokens = chars + [c + "</w>" for c in chars]
            tokens += ["".join(m) for m in merges]
            tokens += ["<|startoftext|>", "<|endoftext|>"]
            vocab = {t: i for i, t in enumerate(tokens)}
        self.encoder = vocab
        self.decoder = {i: t for t, i in vocab.items()}
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        # HF CLIP pads with id 1 but masks nothing in the trainer path; the
        # OpenAI tokenizer zero-pads. We default to 0 per OpenAI; callers
        # building HF-style batches can override.
        self.pad_token_id = 0
        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>"}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # -- core BPE ------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace"
                          ).replace("</w>", " ").strip()

    # -- batch API (fixed shapes, jit-friendly downstream) -------------
    def __call__(self, texts, context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """texts → int32 [N, context_length]: BOS + tokens + EOS, padded.
        Matches ``clip.tokenize`` / HF pad-to-max-length
        (``synthetic_dataloader.py:69-76``)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.pad_token_id,
                      dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.bos_token_id] + self.encode(text) \
                + [self.eos_token_id]
            if len(toks) > context_length:
                if not truncate:
                    raise ValueError(
                        f"text {i} too long ({len(toks)} tokens)")
                toks = toks[:context_length]
                toks[-1] = self.eos_token_id
            out[i, :len(toks)] = toks
        return out


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def load_openai_bpe(path: str) -> CLIPTokenizer:
    """Load ``bpe_simple_vocab_16e6.txt.gz`` (the OpenAI merge list)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    # Line 0 is a version header; CLIP uses merges [1, 49152-256-2+1).
    merges = [tuple(line.split()) for line in lines[1:49152 - 256 - 2 + 1]]
    return CLIPTokenizer(merges)


def load_hf_tokenizer(vocab_json: str, merges_txt: str) -> CLIPTokenizer:
    """Load HF-format ``vocab.json`` + ``merges.txt``."""
    with open(vocab_json, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_txt, encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(l.split()) for l in lines
              if l and not l.startswith("#version") and len(l.split()) == 2]
    return CLIPTokenizer(merges, vocab=vocab)


def load_tokenizer(path: Optional[str] = None, *,
                   allow_fallback: Optional[bool] = None):
    """Load the CLIP BPE vocab: explicit path → $CLIP_BPE_PATH.

    When no vocab file is found the default is to **fail loudly** —
    token-id drift from the ``HashTokenizer`` stand-in silently breaks the
    ±0.5% eval-parity contract. The hermetic fallback must be requested
    explicitly (``allow_fallback=True`` or ``CFA_ALLOW_HASH_TOKENIZER=1``,
    used by unit tests and offline smoke runs)."""
    candidates = []
    if path:
        candidates.append(path)
    env = os.environ.get("CLIP_BPE_PATH")
    if env:
        candidates.append(env)
    for cand in candidates:
        if os.path.isdir(cand):
            vj, mt = (os.path.join(cand, "vocab.json"),
                      os.path.join(cand, "merges.txt"))
            if os.path.exists(vj) and os.path.exists(mt):
                return load_hf_tokenizer(vj, mt)
        elif os.path.exists(cand):
            return load_openai_bpe(cand)
    if allow_fallback is None:
        allow_fallback = os.environ.get(
            "CFA_ALLOW_HASH_TOKENIZER", "0") == "1"
    if allow_fallback:
        return HashTokenizer()
    raise FileNotFoundError(
        "No CLIP BPE vocab found (searched: "
        f"{candidates or 'nothing — no path given'}). Point --bpe-path or "
        "$CLIP_BPE_PATH at bpe_simple_vocab_16e6.txt.gz or an HF tokenizer "
        "dir (vocab.json + merges.txt). For hermetic runs without real "
        "token ids, set CFA_ALLOW_HASH_TOKENIZER=1 (NOT valid for eval "
        "parity).")


# ---------------------------------------------------------------------------
# Hermetic fallback
# ---------------------------------------------------------------------------

class HashTokenizer:
    """Deterministic word-hash tokenizer with the CLIP token layout
    (BOS=49406, EOS=49407, pad=0, vocab 49408). NOT the CLIP BPE — use only
    where no vocab file exists (unit tests, offline smoke runs); ids are
    stable across runs/platforms so golden tests stay valid."""

    def __init__(self, vocab_size: int = 49408,
                 bos_token_id: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: int = 0):
        self.vocab_size = vocab_size
        self.bos_token_id = vocab_size - 2 if bos_token_id is None \
            else bos_token_id
        self.eos_token_id = vocab_size - 1 if eos_token_id is None \
            else eos_token_id
        self.pad_token_id = pad_token_id

    def encode(self, text: str) -> List[int]:
        import hashlib
        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        ids = []
        for w in words:
            if not w:
                continue
            h = int.from_bytes(
                hashlib.sha1(w.encode("utf-8")).digest()[:4], "little")
            ids.append(1 + h % (self.vocab_size - 3))  # avoid pad/bos/eos
        return ids

    def decode(self, ids) -> str:
        return " ".join(f"<{i}>" for i in ids)

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.pad_token_id,
                      dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.bos_token_id] + self.encode(text) \
                + [self.eos_token_id]
            toks = toks[:context_length]
            toks[-1] = self.eos_token_id
            out[i, :len(toks)] = toks
        return out

"""The error budget of the float32 attention forward on the TF32 tensor
cores (``csrc/attention_fwd.cu::attention_fwd_tf32``), checked on the CPU.

The kernel takes every fp32 product as three TF32 products of hi / lo
halves (lo·hi + hi·lo + hi·hi, ``ops/sparc_kernel.py::tf32_split``
rounds them as the kernel does). :func:`tf32_attention` repeats that
arithmetic in plain PyTorch and is held here against the Pallas kernel
``_fused_forward`` (interpret mode) at evaluation's shapes, on fully
masked rows, and, through one ``TemplateScorer`` call at ViT-B/16 full
width, against the plain fp32 path with ``chip_smoke.py``'s card limit
``EVAL_MAX_ABS``. One TF32 product alone (hi·hi) would miss both. The
kernel itself is held to the plain version on the card by
``chip_smoke.py``.

Also here: what the float32 launcher hands the C entry, its refusal of
views the 16-byte copies cannot take, and that the float32 backward, which
reads scalars, takes them.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_finegrained_alignment_tpu.ops.attention import _fused_forward
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig
from clip_finegrained_alignment_tpu_torch.data.tokenizer import HashTokenizer
from clip_finegrained_alignment_tpu_torch.eval import scoring
from clip_finegrained_alignment_tpu_torch.models import convert
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import attention as ta
from clip_finegrained_alignment_tpu_torch.ops import sparc_kernel as sk
from clip_finegrained_alignment_tpu_torch.perf import attention_fp32_study

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

NEG = -1e9
# The emulated kernel against the Pallas kernel: a tenth of the card's
# fp32 tolerance, KERNEL_TOL["float32"] = 1e-4.
EMULATION_TOL = 1e-5


def _products(eq, a, b, products=3):
    """``einsum(eq, a, b)`` as the kernel takes it: lo·hi + hi·lo, then
    + hi·hi, in fp32 (``products`` 1: hi·hi alone, plain TF32)."""
    ah, al = sk.tf32_split(a)
    bh, bl = sk.tf32_split(b)
    hh = torch.einsum(eq, ah, bh)
    if products == 1:
        return hh
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + hh


def tf32_attention(q, k, v, bias, scale, products=3):
    """The float32 kernel's arithmetic over bshd q, k, v: qs = (q·scale)
    rounded to fp32, scores qs·kᵀ + bias, the softmax over the TPU
    wrapper's Sp = round_up(S, 8) keys (the padded ones at −1e9), and
    o = (Σ e·v) / Σ e with both products in TF32 halves."""
    qs = ta._scaled_q(q, scale)
    logits = _products("bqhd,bkhd->bhqk", qs, k.float(), products)
    if bias is not None:
        logits = logits + bias.float()
    S = logits.shape[-1]
    logits = F.pad(logits, (0, ta._round_up(S, ta.SEQ_QUANTUM) - S),
                   value=NEG)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = e.sum(-1)                                          # [B, H, S]
    o = _products("bhqk,bkhd->bqhd", e[..., :S].contiguous(), v.float(),
                  products)
    return o / l.transpose(1, 2)[..., None]


def _masked_bias(B, S, causal):
    """fp32 ``[B, 1, S, S]``: sample 0 masks every key (every one of its
    rows is fully masked), sample 1 pads its last 5 keys; ``causal`` also
    masks the keys after each row."""
    masked = np.zeros((B, 1, S, S), bool)
    masked[0] = True
    masked[1:, ..., S - 5:] = True
    if causal:
        masked |= np.triu(np.ones((S, S), bool), k=1)
    return np.where(masked, NEG, 0.0).astype(np.float32)


CASES = {  # name -> (B, S, H, bias)
    "eval vision": (2, 197, 12, None),
    "eval text causal": (2, 77, 8, "causal"),
    "masked rows S=197": (2, 197, 12, "masked"),
    "masked rows S=77 causal": (2, 77, 8, "masked causal"),
}


def _case(name, seed):
    B, S, H, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, 64)).astype(np.float32)
               for _ in range(3))
    bias = None
    if kind == "causal":
        bias = np.triu(np.full((S, S), NEG, np.float32), k=1)[None, None]
    elif kind is not None:
        bias = _masked_bias(B, S, kind.endswith("causal"))
    return q, k, v, bias


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_matches_pallas(name):
    """The 3xTF32 forward within a tenth of the card's tolerance of the
    Pallas kernel at evaluation's widths (Dh=64), a fully masked row being
    Σv / Sp in both; hi·hi alone misses the card's tolerance."""
    q, k, v, bias = _case(name, seed=len(name))
    S, scale = q.shape[1], 64 ** -0.5
    want = np.asarray(_fused_forward(
        *(jnp.asarray(x) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias), scale, 0, "bshd"))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    got = tf32_attention(tq, tk, tv, tb, scale).numpy()
    err = np.abs(got - want).max()
    assert err <= EMULATION_TOL, err
    if bias is not None and name.startswith("masked"):
        Sp = ta._round_up(S, ta.SEQ_QUANTUM)
        row = v[0].sum(0) / Sp                     # [H, Dh]
        assert np.abs(got[0] - row[None]).max() <= EMULATION_TOL
    plain_tf32 = tf32_attention(tq, tk, tv, tb, scale, products=1).numpy()
    assert np.abs(plain_tf32 - want).max() > smoke.KERNEL_TOL["float32"]


def test_emulated_scorer_holds_the_card_limit_at_vit_b16():
    """One ``TemplateScorer`` call at ViT-B/16 full width (12 + 12 layers,
    2 images x 3 templates) with every layer's attention emulated as the
    kernel computes it: its probabilities lie within ``EVAL_MAX_ABS`` of
    the plain fp32 path's, as ``chip_smoke.py`` phase 9 holds the card to
    the CPU; with hi·hi alone they would not."""
    cfg = CLIPConfig.vit_b16()
    sd = convert.state_dict_from_jax(convert.random_params(cfg, 0), cfg)
    scorer = scoring.TemplateScorer(sd, cfg, device="cpu")
    t = cfg.text
    tok = HashTokenizer(vocab_size=t.vocab_size, bos_token_id=t.bos_token_id,
                        eos_token_id=t.eos_token_id,
                        pad_token_id=t.pad_token_id)
    texts = ["a photo of two dogs", "a photo of three cats",
             "a photo of seven birds", "a photo of one dog",
             "a photo of four cars", "a photo of nine apples"]
    ids = np.asarray(tok(texts, context_length=t.max_position_embeddings))
    ids = ids.reshape(2, 3, -1)
    rng = np.random.default_rng(5)
    px = rng.standard_normal((2, cfg.vision.image_size, cfg.vision.image_size,
                              3)).astype(np.float32)
    mask = np.ones((2, 3), np.float32)
    plain = scorer(px, ids, mask)

    def emulated(products):
        def run(q, k, v, bias, scale):
            return tf32_attention(q, k, v, bias, scale, products)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ta, "attention_reference", run)
            return scorer(px, ids, mask)

    err = np.abs(emulated(3) - plain).max()
    assert err <= smoke.EVAL_MAX_ABS, err
    assert np.abs(emulated(1) - plain).max() > smoke.EVAL_MAX_ABS


def _views(which, kind, dtype):
    """q, k, v [B, S, H, D] of ``dtype``, ``which`` of them a view that is
    not 16-byte aligned: its pointer, its sequence stride or its head
    stride."""
    B, S, H, D = 2, 5, 2, 16
    ts = {n: torch.zeros(B, S, H, D, dtype=dtype) for n in "qkv"}
    if kind == "pointer":             # one element past a 16-byte boundary
        view = torch.zeros(B * S * H * D + 1, dtype=dtype)[1:] \
            .view(B, S, H, D)
    elif kind == "sequence stride":   # rows one element longer than H·D
        view = torch.zeros(B, S, H * D + 1, dtype=dtype)[..., :H * D] \
            .view(B, S, H, D)
    else:                             # heads one element longer than D
        view = torch.zeros(B, S, H, D + 1, dtype=dtype)[..., :D]
    ts[which] = view
    return ts["q"], ts["k"], ts["v"]


class _FakeEntry:
    """A C entry that records its arguments and reports success."""

    def __init__(self):
        self.argtypes = self.restype = None
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _fake_lib(monkeypatch, entry_name):
    entry = _FakeEntry()
    lib = type("Lib", (), {entry_name: entry})()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("Stream", (), {"cuda_stream": 0})())
    return entry


@pytest.mark.parametrize("kind", ["pointer", "sequence stride",
                                  "head stride"])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_fp32_forward_refuses_unaligned_views(which, kind, monkeypatch):
    """The float32 forward reads q and k 16 bytes at a time: its launcher
    refuses a view that is not 16-byte aligned with ValueError before a
    kernel is built, and nothing is rerouted. The backward takes the same
    views (next test)."""
    q, k, v = _views(which, kind, torch.float32)

    def no_build(name):
        raise AssertionError(f"{name} built for a view it cannot take")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ta._launch(q, k, v, None, 0.25)


@pytest.mark.parametrize("kind", ["pointer", "sequence stride",
                                  "head stride"])
def test_fp32_backward_takes_unaligned_views(kind, monkeypatch):
    """The float32 backward reads scalars: an unaligned view reaches its C
    entry with dtype code 0, as before the forward's redesign."""
    q, k, v = _views("q", kind, torch.float32)
    do = torch.zeros(q.shape)
    entry = _fake_lib(monkeypatch, "cfa_attention_bwd")
    ta._launch_backward(q, k, v, None, 0.25, do, None)
    (args,) = entry.calls
    assert args[0] == q.data_ptr() and args[10:15] == (2, 5, 2, 16, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want_lse", [False, True])
def test_dtype_alone_selects_the_forward_kernel(dtype, want_lse,
                                                monkeypatch):
    """The forward launcher hands ``cfa_attention_fwd`` q, k, v as they
    are (the kernels scale q), dtype code 0 for float32 (the 3xTF32
    kernel) or 1 for bfloat16, their strides, the scale rounded to the
    input type, and an lse pair only when asked; it counts one launch."""
    B, S, H, D = 2, 77, 8, 64
    x = torch.randn(B, S, 3 * H * D).to(dtype)
    q, k, v = (x[..., i * H * D:(i + 1) * H * D].view(B, S, H, D)
               for i in range(3))
    entry = _fake_lib(monkeypatch, "cfa_attention_fwd")
    _build.reset_launch_counts()
    out, lse = ta._launch(q, k, v, None, D ** -0.5, want_lse)
    (args,) = entry.calls
    assert len(entry.argtypes) == len(args)
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[4] == out.data_ptr() and out.dtype == dtype
    assert (args[5] is None) is (not want_lse)
    if want_lse:
        assert args[5] == lse.data_ptr() and lse.shape == (2, B, H, S)
    assert args[6:11] == (B, S, H, D, 0 if dtype == torch.float32 else 1)
    assert list(args[11:20]) == [s for t in (q, k, v) for s in t.stride()[:3]]
    assert args[21] == ta.rounded_scale(D ** -0.5, dtype)
    assert _build.launch_counts()["attention_fwd"] == 1


@pytest.mark.parametrize("variant", sorted(attention_fp32_study.VARIANTS))
def test_study_variants_set_each_constant_once(variant):
    """Each design variant of the float32 forward edits exactly the
    constants it names, in the float32 section, and nothing else."""
    values = attention_fp32_study.VARIANTS[variant]
    source = (_build.CSRC / "attention_fwd.cu").read_text()
    got = attention_fp32_study.with_constants(values)
    for const, value in values.items():
        assert const.startswith("kF32")
        assert f"constexpr int {const} = {value};" in got
    changed = [a for a, b in zip(source.splitlines(), got.splitlines())
               if a != b]
    assert len(changed) == len(values)
    with pytest.raises(ValueError):
        attention_fp32_study.with_constants({"kNoSuchConstant": 1})

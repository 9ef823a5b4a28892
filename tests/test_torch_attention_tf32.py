"""The error budget of the float32 attention kernels on the TF32 tensor
cores (``csrc/attention_fwd.cu::attention_fwd_tf32``, and the backward's
``attention_bwd_dq_tf32`` and ``attention_bwd_dkdv_tf32`` in
``csrc/attention_bwd.cu``), checked on the CPU.

The kernels take every fp32 product as three TF32 products of hi / lo
halves (lo·hi + hi·lo + hi·hi, ``ops/sparc_kernel.py::tf32_split``
rounds them as the kernels do). :func:`tf32_attention` and
:func:`tf32_attention_backward` repeat that arithmetic in plain PyTorch
and are held here against the Pallas kernels ``_fused_forward`` and
``_fused_backward`` (interpret mode) at evaluation's and training's
shapes and on fully masked rows; through one ``TemplateScorer`` call at
ViT-B/16 full width against the plain fp32 path with ``chip_smoke.py``'s
card limit ``EVAL_MAX_ABS``; and through one ViT-B/16 train microbatch
against the plain fp32 path with the limits of ``chip_smoke.py``'s fp32
gradient check (``TRAIN_F32_*``), which were set from this emulation.
One TF32 product alone (hi·hi) would miss each. The kernels themselves
are held to the plain versions on the card by ``chip_smoke.py``.

Also here: what the float32 launchers hand the C entries, and their
refusal of views the 16-byte loads cannot take.
"""

import contextlib
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clip_finegrained_alignment_tpu.ops.attention import (_fused_backward,
                                                         _fused_forward)
from clip_finegrained_alignment_tpu_torch.config import (CLIPConfig,
                                                         TrainConfig)
from clip_finegrained_alignment_tpu_torch.data.tokenizer import HashTokenizer
from clip_finegrained_alignment_tpu_torch.eval import scoring
from clip_finegrained_alignment_tpu_torch.models import clip as tm
from clip_finegrained_alignment_tpu_torch.models import convert
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import attention as ta
from clip_finegrained_alignment_tpu_torch.ops import sparc_kernel as sk
from clip_finegrained_alignment_tpu_torch.perf import (
    attention_bwd_fp32_study, attention_fp32_study)
from clip_finegrained_alignment_tpu_torch.perf import \
    fp32_grad_bias_study as bias_study

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

NEG = -1e9


@pytest.fixture(autouse=True)
def _one_thread():
    """Every test here on one intra-op thread: the emulations are long,
    and a test worker beside others that takes every core for each op
    spends most of its time waiting on its own threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The emulated kernel against the Pallas kernel: a tenth of the card's
# fp32 tolerance, KERNEL_TOL["float32"] = 1e-4.
EMULATION_TOL = 1e-5


def _products(eq, a, b, products=3, sums="nearest"):
    """``einsum(eq, a, b)`` as the kernel takes it: lo·hi + hi·lo, then
    + hi·hi, in fp32 (``products`` 1: hi·hi alone, plain TF32). ``sums``
    "toward zero" adds them as the tensor cores do into one running sum,
    "toward zero by step" into a zeroed sum a k8 step, added to the
    running sum rounded to nearest (:func:`_core_sums`)."""
    ah, al = sk.tf32_split(a)
    bh, bl = sk.tf32_split(b)
    if sums.startswith("toward zero"):
        pairs = [(al, bh), (ah, bl)] if products == 3 else []
        return _core_sums(eq, pairs + [(ah, bh)],
                          by_step=sums == "toward zero by step")
    hh = torch.einsum(eq, ah, bh)
    if products == 1:
        return hh
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + hh


def _core_sums(eq, pairs, by_step=False):
    """Σ over ``pairs`` of ``einsum(eq, x, y)`` as ``mma.sync`` TF32 sums
    it: over the contracted index 8 at a time, in order, each pair's
    product of those 8 added exactly to the fp32 accumulator and the
    result rounded toward zero, as ``perf/fp32_grad_bias_study.py`` finds
    the H100 rounds it. ``by_step``: each step's pairs summed so into a
    zeroed accumulator, which is added to the running fp32 sum rounded to
    nearest (``csrc/attention_tf32.cuh::mma_row_rn``). Every step's
    products come from one float64 einsum a pair (the contracted index
    split into steps of 8, zero-padded: exact zeros add nothing); the
    loop over the steps only adds and rounds."""
    ins, out = eq.split("->")
    ia, ib = ins.split(",")
    (kdim,) = (set(ia) & set(ib)) - set(out)
    step = next(c for c in "jnoprtuwxyz" if c not in eq)
    xa, xb = ia.index(kdim), ib.index(kdim)
    K = pairs[0][0].shape[xa]
    steps = -(-K // 8)

    def split(t, dim):
        t = t.double()
        pad = [0, 0] * (t.dim() - 1 - dim) + [0, steps * 8 - K]
        t = F.pad(t, pad)
        return t.reshape(t.shape[:dim] + (steps, 8) + t.shape[dim + 1:])
    eq_steps = (f"{ia.replace(kdim, step + kdim)},"
                f"{ib.replace(kdim, step + kdim)}->{step}{out}")
    parts = [torch.einsum(eq_steps, split(x, xa), split(y, xb))
             for x, y in pairs]
    acc = total = None
    for j in range(steps):
        if by_step:
            acc = None
        for part in parts:
            acc = bias_study.round_toward_zero(
                part[j] if acc is None else acc.double() + part[j])
        if by_step:
            total = acc if total is None else total + acc
    return total if by_step else acc


def tf32_attention(q, k, v, bias, scale, products=3, sums="nearest"):
    """The float32 kernel's arithmetic over bshd q, k, v: qs = (q·scale)
    rounded to fp32, scores qs·kᵀ + bias, the softmax over the TPU
    wrapper's Sp = round_up(S, 8) keys (the padded ones at −1e9), and
    o = (Σ e·v) / Σ e with both products in TF32 halves. ``sums`` "card"
    is the card's order: every sum toward zero (the forward keeps its
    running sums in the mma accumulator)."""
    if sums == "card":
        sums = "toward zero"
    qs = ta._scaled_q(q, scale)
    logits = _products("bqhd,bkhd->bhqk", qs, k.float(), products, sums)
    if bias is not None:
        logits = logits + bias.float()
    S = logits.shape[-1]
    logits = F.pad(logits, (0, ta._round_up(S, ta.SEQ_QUANTUM) - S),
                   value=NEG)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = e.sum(-1)                                          # [B, H, S]
    o = _products("bhqk,bkhd->bqhd", e[..., :S].contiguous(), v.float(),
                  products, sums)
    return o / l.transpose(1, 2)[..., None]


def tf32_attention_backward(q, k, v, bias, scale, do, products=3,
                            sums="nearest"):
    """The float32 backward kernels' arithmetic over bshd q, k, v, do: the
    forward's log-sum-exp pair (hi, lo) from the emulated scores over Sp
    keys; p = exp((s − hi) − lo); r = Σ p·dp; dq = (A − r·B)·scale with
    A = (p·dp)·k and B = p·k; ds = p·(dp − r), dk = dsᵀ·qs, dv = pᵀ·do;
    every product in TF32 halves. ``sums`` "card" is the card's order:
    the scores' and dp's sums over the head dim toward zero, the four sums
    over the rows (A, B, dk, dv) toward zero by step. Returns (dq, dk,
    dv)."""
    rows = "toward zero by step" if sums == "card" else sums
    if sums == "card":
        sums = "toward zero"
    qs = ta._scaled_q(q, scale)
    s = _products("bqhd,bkhd->bhqk", qs, k.float(), products, sums)
    if bias is not None:
        s = s + bias.float()
    S = s.shape[-1]
    padded = F.pad(s, (0, ta._round_up(S, ta.SEQ_QUANTUM) - S), value=NEG)
    m = padded.amax(-1, keepdim=True)
    log_l = torch.log(torch.exp(padded - m).sum(-1, keepdim=True))
    hi = m + log_l
    lo = (m - hi) + log_l
    p = torch.exp((s - hi) - lo)
    dp = _products("bqhd,bkhd->bhqk", do.float(), v.float(), products, sums)
    pd = p * dp
    r = pd.sum(-1, keepdim=True)                           # [B, H, S, 1]
    a = _products("bhqk,bkhd->bqhd", pd, k.float(), products, rows)
    b = _products("bhqk,bkhd->bqhd", p, k.float(), products, rows)
    dq = (a - r.transpose(1, 2) * b) * ta.rounded_scale(scale, torch.float32)
    ds = p * (dp - r)
    dk = _products("bhqk,bqhd->bkhd", ds, qs, products, rows)
    dv = _products("bhqk,bqhd->bkhd", p, do.float(), products, rows)
    return dq, dk, dv


def _bwd_excess(got, ref):
    """The largest |err| / (rtol·|ref| + atol·max|ref|) with the card's
    ``BWD_TOL["float32"]``, as ``chip_smoke.py::bwd_excess``."""
    rtol, atol = smoke.BWD_TOL["float32"]
    lim = rtol * np.abs(ref) + atol * np.abs(ref).max()
    return float((np.abs(got - ref) / lim).max())


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


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_backward_matches_pallas(name):
    """The 3xTF32 backward within a tenth of the card's tolerance
    (``BWD_TOL["float32"]``) of the Pallas backward at evaluation's and
    training's widths (Dh=64) and on fully masked rows (dv of such a row's
    keys Σdo / Sp in both), with its sums rounded to nearest and as the
    card rounds them; hi·hi alone misses the card's tolerance."""
    q, k, v, bias = _case(name, seed=len(name) + 1)
    do = np.random.default_rng(len(name)).standard_normal(
        q.shape).astype(np.float32)
    S, scale = q.shape[1], 64 ** -0.5
    want = [np.asarray(x) for x in _fused_backward(
        *(jnp.asarray(x) for x in (q, k, v)),
        None if bias is None else jnp.asarray(bias), scale, 0,
        jnp.asarray(do), layout="bshd")]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    got = tf32_attention_backward(tq, tk, tv, tb, scale, tdo)
    for dname, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _bwd_excess(g.numpy(), w) <= 0.1, dname
    # The same with the sums rounded as the card's are.
    card = tf32_attention_backward(tq, tk, tv, tb, scale, tdo, sums="card")
    for dname, g, w in zip(("dq", "dk", "dv"), card, want):
        assert _bwd_excess(g.numpy(), w) <= 0.1, dname
    if name.startswith("masked"):
        Sp = ta._round_up(S, ta.SEQ_QUANTUM)
        dv0 = np.broadcast_to(do[0].sum(0) / Sp, do[0].shape)
        assert _bwd_excess(got[2][0].numpy(), dv0) <= 0.1
    plain_tf32 = tf32_attention_backward(tq, tk, tv, tb, scale, tdo,
                                         products=1)
    assert max(_bwd_excess(g.numpy(), w)
               for g, w in zip(plain_tf32, want)) > 1.0


@functools.lru_cache(maxsize=None)
def _vit_b16_state():
    cfg = CLIPConfig.vit_b16()
    return convert.state_dict_from_jax(convert.random_params(cfg, 0), cfg)


@functools.lru_cache(maxsize=None)
def _microbatch_grads(products=None, sums="nearest"):
    """``chip_smoke.microbatch_grads`` of one ViT-B/16 fp32 microbatch on
    the CPU (``TRAIN_CHECK_PAIRS`` pairs, SPARC), every layer's attention
    forward and backward emulated with ``products`` and ``sums`` (None:
    the plain path); each once a test process (the two tests below share
    the plain one)."""
    cfg = CLIPConfig.vit_b16()
    tcfg = TrainConfig(loss_type="sparc", optimizer_type="adamspd",
                       inverse_temperature=0.07, use_amp=False)
    sd = _vit_b16_state()
    batch = smoke.bench_batch(cfg, 1, smoke.TRAIN_CHECK_PAIRS, "sparc", 0)
    model = tm.build_train_model(cfg, sd, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        if products:
            mp.setattr(ta, "attention_reference",
                       lambda q, k, v, bias, scale: tf32_attention(
                           q, k, v, bias, scale, products, sums))
            mp.setattr(ta, "attention_backward_reference",
                       lambda q, k, v, bias, scale, do:
                       tf32_attention_backward(q, k, v, bias, scale, do,
                                               products, sums))
        return smoke.microbatch_grads(model, batch, tcfg, cfg,
                                      torch.float32)


def test_emulated_train_microbatch_holds_the_fp32_card_limits_at_vit_b16():
    """One ViT-B/16 train microbatch at full width (12 + 12 layers,
    ``TRAIN_CHECK_PAIRS`` pairs, SPARC, as ``chip_smoke.py`` phase 6) in
    fp32 on the CPU, with every layer's attention forward and backward
    taken as the kernels take them, against the plain fp32 path: the loss,
    gradient norm and per-tensor gradient cosines hold the limits of the
    phase's fp32 card check (``TRAIN_F32_*``), which were set from these
    readings with a wide margin; with hi·hi alone they do not."""
    plain = _microbatch_grads()
    ok = smoke.compare_grads(_microbatch_grads(3), plain)
    # The readings the limits were set from, with the margins stated there.
    assert ok["loss_rel"] <= smoke.TRAIN_F32_MAX_LOSS_REL / 8, ok
    assert ok["grad_norm_rel"] <= smoke.TRAIN_F32_MAX_GNORM_REL / 100, ok
    assert 1 - ok["min_grad_cosine"] <= \
        (1 - smoke.TRAIN_F32_MIN_GRAD_COSINE) / 100, ok
    off = smoke.compare_grads(_microbatch_grads(1), plain)
    assert off["grad_norm_rel"] > smoke.TRAIN_F32_MAX_GNORM_REL
    assert off["min_grad_cosine"] < smoke.TRAIN_F32_MIN_GRAD_COSINE


def test_emulated_microbatch_with_the_cards_sums_holds_the_fp32_limits():
    """The microbatch of the test above with the emulated kernels' sums
    rounded as ``mma.sync`` TF32 rounds them on the H100
    (``perf/fp32_grad_bias_study.py``): toward zero, the backward's four
    sums over the rows a k8 step at a time, added to nearest
    (``csrc/attention_tf32.cuh::mma_row_rn``). Kept in the accumulator
    over the whole row, as the backward did before, every gradient shrank
    and the norm read 2.1e-6 low (the card: 2.31e-6); so the norm is now
    within 1e-7 of the plain path's. The limits of the phase's fp32 card
    check hold it with the margins stated beside them: the gradient norm
    at under half its limit, the cosine gap at under a hundredth."""
    plain = _microbatch_grads()
    card = _microbatch_grads(3, "card")
    ok = smoke.compare_grads(card, plain)
    assert ok["grad_norm_rel"] <= 1e-7, ok
    assert ok["loss_rel"] <= smoke.TRAIN_F32_MAX_LOSS_REL / 8, ok
    assert ok["grad_norm_rel"] <= smoke.TRAIN_F32_MAX_GNORM_REL / 2, ok
    assert 1 - ok["min_grad_cosine"] <= \
        (1 - smoke.TRAIN_F32_MIN_GRAD_COSINE) / 100, ok


def test_truncating_sums_shrink_the_backward_as_the_card_does():
    """At ViT-B/16 vision's widths (``fp32_grad_bias_study.bias_inputs``,
    B=2) against a float64 backward: the emulated kernel with sums rounded
    to nearest has no magnitude bias (|scale| < 2e-8); with every sum
    rounded toward zero in one running accumulator, as the backward took
    them before, dq, dk and dv shrink by 1e-6 to 4e-6 (the card read
    1.55e-6 to 1.90e-6); in the card's order now (the four sums over the
    rows a k8 step at a time, added to nearest) by 3e-7 to 1.2e-6, what
    is left being the score sums over the head dim. All stay far inside
    the card's tolerance."""
    q, k, v, do = bias_study.bias_inputs()
    scale = q.shape[-1] ** -0.5
    ref = bias_study.backward64(q, k, v, do, scale)
    bounds = {"nearest": (-2e-8, 2e-8), "toward zero": (-4e-6, -1e-6),
              "card": (-1.2e-6, -3e-7)}
    for sums, (lo, hi) in bounds.items():
        got = tf32_attention_backward(q, k, v, None, scale, do, sums=sums)
        for dname, g, r in zip(("dq", "dk", "dv"), got, ref):
            stats = bias_study.bias_stats(g, r)
            assert stats["err_rel"] < 1e-5, (sums, dname, stats)
            assert lo < stats["scale"] < hi, (sums, dname, stats)


@pytest.mark.parametrize("rounding", ["nearest", "toward zero"])
def test_bias_study_classes_each_rounding(rounding):
    """The study's probe sets, summed exactly and rounded each way, are
    classed as that rounding wherever the two differ, with the mean
    signed error of its kind: about 0 to nearest, negative toward zero."""
    sets = bias_study.probe_sets(torch.Generator().manual_seed(0))
    assert set(sets) == {"random", "accumulating", "crafted"}
    for name, (a, b, c) in sets.items():
        assert torch.equal(sk.tf32_split(a)[0], a)
        assert torch.equal(sk.tf32_split(b)[0], b)
        exact = c.double() + a.double() @ b.double()
        d = (exact.float() if rounding == "nearest"
             else bias_study.round_toward_zero(exact))
        got = bias_study.classify(d, exact)
        assert got["decisive"] > 0, name
        if rounding == "nearest":
            assert got["rn"] == 1.0 and got["rz"] == 0.0, (name, got)
            assert abs(got["mean_signed_ulp"]) < (0.3 if name == "crafted"
                                                  else 1e-2), (name, got)
        else:
            assert got["rz"] == 1.0 and got["rn"] == 0.0, (name, got)
            assert got["mean_signed_ulp"] < -0.3, (name, got)


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
    kernel is built, and nothing is rerouted. So does the backward (next
    test)."""
    q, k, v = _views(which, kind, torch.float32)

    def no_build(name):
        raise AssertionError(f"{name} built for a view it cannot take")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ta._launch(q, k, v, None, 0.25)


@pytest.mark.parametrize("kind", ["pointer", "sequence stride",
                                  "head stride"])
def test_fp32_backward_refuses_unaligned_views(kind, monkeypatch):
    """The float32 backward reads its tiles 16 bytes at a time, as the
    forward does: an unaligned view raises ValueError before a kernel is
    built, as in bf16. No caller meets it: the forward refuses the same
    views first."""
    q, k, v = _views("q", kind, torch.float32)
    B, S, H, _ = q.shape
    do = torch.zeros(q.shape)

    def no_build(name):
        raise AssertionError(f"{name} built for a view it cannot take")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ta._launch_backward(q, k, v, None, 0.25, do,
                            torch.zeros(2, B, H, S))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned_do", [True, False])
def test_backward_hands_the_c_entry_the_lse_pair(dtype, aligned_do,
                                                  monkeypatch):
    """Both backward paths hand ``cfa_attention_bwd`` the forward's lse
    pair, the dtype code (0 for the float32 3xTF32 kernels, 1 for bf16),
    q, k, v and their strides as they are, one row-term float a row as
    scratch and the scale rounded to the input type; a cotangent view that
    is not 16-byte aligned is copied first. One launch counted."""
    B, S, H, D = 2, 77, 8, 64
    x = torch.randn(B, S, 3 * H * D).to(dtype)
    q, k, v = (x[..., i * H * D:(i + 1) * H * D].view(B, S, H, D)
               for i in range(3))
    do = torch.randn(B, S, H, D).to(dtype)
    if not aligned_do:
        do = torch.zeros(B * S * H * D + 1, dtype=dtype)[1:].view(B, S, H, D)
    lse = torch.zeros(2, B, H, S)
    entry = _fake_lib(monkeypatch, "cfa_attention_bwd")
    _build.reset_launch_counts()
    dq, dk, dv = ta._launch_backward(q, k, v, None, D ** -0.5, do, lse)
    (args,) = entry.calls
    assert len(entry.argtypes) == len(args)
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), None)
    assert (args[4] == do.data_ptr()) is aligned_do
    assert args[5] == lse.data_ptr()
    assert args[6:9] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    assert args[10:15] == (B, S, H, D, 0 if dtype == torch.float32 else 1)
    assert list(args[15:24]) == [s for t in (q, k, v)
                                 for s in t.stride()[:3]]
    assert args[-2] == ta.rounded_scale(D ** -0.5, dtype)
    assert all(t.dtype == dtype and t.shape == q.shape for t in (dq, dk, dv))
    assert _build.launch_counts()["attention_bwd"] == 1


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


@pytest.mark.parametrize("variant", sorted(attention_bwd_fp32_study.VARIANTS))
def test_bwd_study_variants_set_each_constant_once(variant):
    """Each design variant of the float32 backward edits exactly the
    constants it names, in attention_bwd.cu's float32 section, and nothing
    else."""
    values = attention_bwd_fp32_study.VARIANTS[variant]
    name = attention_bwd_fp32_study.NAME
    source = (_build.CSRC / _build.SOURCES[name]).read_text()
    got = attention_fp32_study.with_constants(values, name)
    for const, value in values.items():
        assert const.startswith("kF32")
        assert f"constexpr int {const} = {value};" in got
    changed = [a for a, b in zip(source.splitlines(), got.splitlines())
               if a != b]
    assert len(changed) == len(values)

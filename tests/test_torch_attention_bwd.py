"""The port's attention backward (``clip_finegrained_alignment_tpu_torch/
ops/attention.py``) against the JAX package's, and the autograd wiring of
``flash_attention``.

On the CPU the port runs ``attention_backward_reference``; here it is held
against the Pallas backward ``_fused_backward`` (interpret mode, bshd, as
``tests/test_ops.py`` runs the kernels) and against ``jax.vjp`` of the XLA
path ``_xla_attention_bshd``, on the same numpy inputs, at S in
{13, 50, 77}, with and without the causal bias, in fp32 and bf16. The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.

Tolerances (gradients of size ≤ ~5):

* fp32: atol 2e-5 (both sides fp32; other summation order);
* bf16 against ``_fused_backward``: each element within one bf16 step
  (2^-7 relative) plus 2e-3 of the largest magnitude: both sides do the
  same fp32 math on the same bf16 values and round at the same places,
  so they differ where a value lands near a rounding boundary;
* bf16 against ``jax.vjp`` of the XLA path: 5 % of the largest magnitude.
  XLA's autodiff rounds its probabilities and products to bf16 at other
  places than the fused kernels do (the scores are fp32 on both sides:
  ``CFA_ATTENTION_PROBS_FP32=1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.models.clip import _xla_attention_bshd
from clip_finegrained_alignment_tpu.ops.attention import _fused_backward
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import attention as ta
from test_torch_attention import masked_sample_bias

NEG = -1e9


def _case(S, causal, seed, B=2, H=2, D=16):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    bias = (np.triu(np.full((S, S), NEG, np.float32), k=1)[None, None]
            if causal else None)
    return q, k, v, do, bias, D ** -0.5


def _jax_grads(q, k, v, do, bias, scale, dtype):
    jq, jk, jv, jdo = (jnp.asarray(x, dtype) for x in (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias)
    fused = jax.jit(lambda a, b, c, d, e: _fused_backward(
        a, b, c, d, scale, 0, e, layout="bshd"))(jq, jk, jv, jb, jdo)
    xla = jax.jit(lambda a, b, c, d, e: jax.vjp(
        lambda x, y, z: _xla_attention_bshd(x, y, z, d, scale),
        a, b, c)[1](e))(jq, jk, jv, jb, jdo)
    return fused, xla


def _ours(q, k, v, do, bias, scale, dtype):
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    return ta.attention_backward_reference(
        tq, tk, tv, None if bias is None else torch.from_numpy(bias), scale,
        tdo)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [13, 50, 77])
def test_plain_backward_matches_pallas_and_vjp_fp32(S, causal):
    q, k, v, do, bias, scale = _case(S, causal, seed=S + causal)
    ours = _ours(q, k, v, do, bias, scale, torch.float32)
    fused, xla = _jax_grads(q, k, v, do, bias, scale, jnp.float32)
    for name, got, a, b in zip("qkv", ours, fused, xla):
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-5, err_msg=f"d{name} vs Pallas")
        np.testing.assert_allclose(got.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-5, err_msg=f"d{name} vs vjp")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [13, 50, 77])
def test_plain_backward_matches_pallas_and_vjp_bf16(S, causal, monkeypatch):
    monkeypatch.setenv("CFA_ATTENTION_PROBS_FP32", "1")
    q, k, v, do, bias, scale = _case(S, causal, seed=100 + S + causal,
                                     D=32)   # scale 1/sqrt(32) rounds in bf16
    ours = _ours(q, k, v, do, bias, scale, torch.bfloat16)
    fused, xla = _jax_grads(q, k, v, do, bias, scale, jnp.bfloat16)
    for name, got, a, b in zip("qkv", ours, fused, xla):
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        top = np.abs(a).max()
        assert np.all(np.abs(got - a) <= 2 ** -7 * np.abs(a) + 2e-3 * top), \
            f"d{name} vs Pallas: max err {np.abs(got - a).max()}"
        np.testing.assert_allclose(got, b, rtol=0, atol=5e-2 * top,
                                   err_msg=f"d{name} vs vjp")


@pytest.mark.parametrize("S,causal", [(77, True), (197, False)])
def test_plain_backward_of_fully_masked_rows_matches_pallas_fp32(S, causal):
    """Sample 0 masks every key: the Pallas backward weighs each key of its
    rows 1 / Sp (Sp = round_up(S, 8), its padded keys tie), so dv of sample
    0 is Σ_rows do / Sp; the plain backward gives the same."""
    B, H, D = 2, 2, 16
    q, k, v, do, _, scale = _case(S, False, seed=S + 1, B=B, H=H, D=D)
    bias = masked_sample_bias(B, S, causal)
    ours = _ours(q, k, v, do, bias, scale, torch.float32)
    fused = jax.jit(lambda a, b, c, d, e: _fused_backward(
        a, b, c, d, scale, 0, e, layout="bshd"))(
            *(jnp.asarray(x) for x in (q, k, v, bias, do)))
    for name, got, want in zip("qkv", ours, fused):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5, err_msg=f"d{name} vs Pallas")
    Sp = -(-S // 8) * 8
    np.testing.assert_allclose(
        ours[2][0].numpy(), np.broadcast_to(do[0].sum(0) / Sp, (S, H, D)),
        rtol=0, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_function_on_cpu_gives_the_plain_backward(causal):
    q, k, v, do, bias, scale = _case(19, causal, seed=7)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    _build.reset_launch_counts()
    out = ta.flash_attention(tq, tk, tv, tb, scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want = _ours(q, k, v, do, bias, scale, torch.float32)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert _build.launch_counts()["attention_bwd"] == 0


def test_function_gives_grads_to_strided_views():
    """q, k, v as bshd views of one fused projection: the gradient reaches
    the projection through the views."""
    B, S, H, D = 2, 10, 2, 16
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(rng.standard_normal(
        (B, S, 3 * H * D)).astype(np.float32)).requires_grad_()
    q, k, v = (fused[..., i * H * D:(i + 1) * H * D].view(B, S, H, D)
               for i in range(3))
    ta.flash_attention(q, k, v, None, D ** -0.5).square().sum().backward()
    want = _ours(*(x.detach().contiguous().numpy() for x in (q, k, v)),
                 (2 * ta.attention_reference(q, k, v, None, D ** -0.5))
                 .detach().numpy(), None, D ** -0.5, torch.float32)
    torch.testing.assert_close(
        fused.grad, torch.cat([w.reshape(B, S, H * D) for w in want], -1),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("branch", ["cuda", "cpu"])
def test_output_under_grad_has_the_functions_grad_fn(branch, monkeypatch):
    """The fault this pins: on a CUDA tensor the forward kernel's output is
    a fresh ``torch.empty``, so without the Function a forward under
    autograd would cut the q, k, v gradients of every layer. The CUDA
    branch is taken without a card: ``_device_kind`` says "cuda" and the
    launchers are stubs that return fresh tensors, as the real ones do."""
    q, k, v, do, bias, scale = _case(13, True, seed=9)
    calls = []
    if branch == "cuda":
        _stub_launchers(monkeypatch, calls)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ta.flash_attention(tq, tk, tv, torch.from_numpy(bias), scale)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (tq, tk, tv))
    assert [c[0] for c in calls] == (["fwd", "bwd"] if branch == "cuda"
                                     else [])
    if branch == "cuda":
        # The backward got the statistics the forward wrote.
        assert calls[0][1] is True and calls[1][1] is calls[0][2]


def _stub_launchers(monkeypatch, calls):
    """Take the CUDA branch without a card: ``_device_kind`` says "cuda"
    and the launchers are stubs with the real ones' signatures that return
    fresh tensors, as the real ones do. Each call is logged as ("fwd",
    want_lse, lse) or ("bwd", lse)."""
    def fwd(q, k, v, bias, scale, want_lse=False):
        out = ta.attention_reference(q, k, v, bias, scale).detach()
        lse = (torch.zeros(2, q.shape[0], q.shape[2], q.shape[1])
               if want_lse else None)
        calls.append(("fwd", want_lse, lse))
        return out, lse

    def bwd(q, k, v, bias, scale, do, lse):
        calls.append(("bwd", lse))
        return ta.attention_backward_reference(q, k, v, bias, scale, do)

    monkeypatch.setattr(ta, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(ta, "_launch", fwd)
    monkeypatch.setattr(ta, "_launch_backward", bwd)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode",
                                  "no_requires_grad"])
def test_forward_asks_for_statistics_only_under_grad(mode, monkeypatch):
    """The forward kernel writes the log-sum-exp only when a backward will
    read it: inputs that require grad under grad mode. Serving runs under
    ``inference_mode`` and writes none, nor does ``no_grad``, where
    ``ctx.needs_input_grad`` alone would still ask for it."""
    q, k, v, _, _, scale = _case(13, False, seed=11)
    calls = []
    _stub_launchers(monkeypatch, calls)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(mode != "no_requires_grad")
                  for x in (q, k, v))
    if mode == "no_grad":
        with torch.no_grad():
            ta.flash_attention(tq, tk, tv, None, scale)
    elif mode == "inference_mode":
        with torch.inference_mode():
            ta.flash_attention(tq, tk, tv, None, scale)
    else:
        ta.flash_attention(tq, tk, tv, None, scale)
    assert len(calls) == 1 and calls[0][0] == "fwd"
    assert calls[0][1] is (mode == "grad")


def _refusals(what, dtype):
    """The launchers of ``dtype`` raise ValueError before a kernel is
    built or launched on ``what``: a q pointer or sequence stride that is
    not a multiple of 16 bytes (both directions), or a missing or
    single-plane lse (the backward)."""
    B, S, H, D = 2, 5, 2, 16
    pad = 8 // torch.tensor([], dtype=dtype).element_size()
    q = torch.zeros(B, S, H, D, dtype=dtype)
    if what == "pointer":       # one element past a 16-byte boundary
        q = torch.zeros(B * S * H * D + 1, dtype=dtype)[1:].view(B, S, H, D)
    elif what == "stride":      # rows 8 bytes longer than H·D
        q = torch.zeros(B, S, H * D + pad, dtype=dtype)[..., :H * D] \
            .view(B, S, H, D)
    k = v = do = torch.zeros(B, S, H, D, dtype=dtype)
    lse = torch.zeros(B, H, S) if what == "lse_single" else None
    with pytest.raises(ValueError):
        ta._launch_backward(q, k, v, None, 0.25, do, lse)
    if what not in ("lse", "lse_single"):
        with pytest.raises(ValueError):
            ta._launch(q, k, v, None, 0.25)


@pytest.mark.parametrize("what", ["pointer", "stride", "lse", "lse_single"])
def test_bf16_launchers_refuse_what_the_copies_cannot_take(what):
    """The bf16 kernels copy 16 bytes at a time and the backward reads the
    forward's statistics, the lse pair [2, B, H, S] (a single fp32 lse
    cannot hold a fully masked row): anything else raises before a kernel
    is built or launched, and nothing is rerouted."""
    _refusals(what, torch.bfloat16)


@pytest.mark.parametrize("what", ["pointer", "stride", "lse", "lse_single"])
def test_fp32_launchers_refuse_what_the_copies_cannot_take(what):
    """The float32 kernels read 16 bytes at a time too, and the float32
    backward reads the forward's lse pair as the bf16 one does: the same
    refusals."""
    _refusals(what, torch.float32)


def test_no_graph_under_inference_mode():
    q, k, v, _, _, scale = _case(13, False, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.inference_mode():
        out = ta.flash_attention(tq, tk, tv, None, scale)
    assert out.grad_fn is None

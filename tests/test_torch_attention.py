"""The port's attention (``clip_finegrained_alignment_tpu_torch/ops/
attention.py``) against the JAX package's.

On the CPU the port's wrapper runs its plain version; here it is held
against the Pallas kernel ``flash_attention`` (interpret mode, as
``tests/test_ops.py`` runs it) and against the XLA path
``_xla_attention_bshd``, on the same numpy inputs. The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py``.

Tolerances: fp32 1e-5 absolute (outputs are O(1); the two sides differ
only in summation order); bf16 1e-2 absolute (one bf16 step at |o| < 2 is
2^-7 ≈ 0.008, and both sides round p and o to bf16 at the same places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.models.clip import _xla_attention_bshd
from clip_finegrained_alignment_tpu.ops.attention import \
    flash_attention as jax_flash_attention
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import attention as ta

NEG = -1e9


def _bias(kind, B, S, rng):
    if kind == "none":
        return None
    causal = np.triu(np.full((S, S), NEG, np.float32), k=1)[None, None]
    if kind == "causal":
        return causal
    mask = np.ones((B, S), np.float32)
    mask[0, S - 3:] = 0.0                      # row 0 has 3 padded keys
    pad = ((1.0 - mask) * NEG)[:, None, None, :]
    if kind == "padding":                      # [B, 1, S, S]
        return np.broadcast_to(pad, (B, 1, S, S)).copy()
    if kind == "padding_row":           # [B, 1, 1, S] broadcast form
        return pad
    raise ValueError(kind)


def _inputs(B, S, H, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(dtype)
               for _ in range(3))
    return q, k, v, rng


CASES = [  # (bias kind, B, S, H, Dh)
    ("none", 2, 16, 2, 16),
    ("causal", 2, 16, 2, 32),
    ("padding", 2, 24, 3, 16),
    ("none", 2, 13, 2, 64),          # S not a multiple of 8
    ("causal", 1, 21, 2, 16),        # S not a multiple of 8, causal
    ("padding_row", 2, 11, 2, 16),
]


@pytest.mark.parametrize("kind,B,S,H,D", CASES)
def test_plain_attention_matches_pallas_and_xla_fp32(kind, B, S, H, D):
    q, k, v, rng = _inputs(B, S, H, D, seed=S * 10 + D)
    bias = _bias(kind, B, S, rng)
    scale = D ** -0.5
    _build.reset_launch_counts()
    ours = ta.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              None if bias is None
                              else torch.from_numpy(bias), scale).numpy()
    jb = None if bias is None else jnp.asarray(bias)
    pallas = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, scale,
        layout="bshd"))
    xla = np.asarray(_xla_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, scale))
    assert ours.shape == (B, S, H, D)
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=1e-5)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert _build.launch_counts()["attention_fwd"] == 0


@pytest.mark.parametrize("kind", ["none", "causal"])
def test_plain_attention_matches_pallas_bf16(kind):
    B, S, H, D = 2, 19, 2, 32          # scale 1/sqrt(32) is inexact in bf16
    q, k, v, rng = _inputs(B, S, H, D, seed=7)
    bias = _bias(kind, B, S, rng)
    scale = D ** -0.5
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    ours = ta.flash_attention(tq, tk, tv, None if bias is None
                              else torch.from_numpy(bias), scale)
    assert ours.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (tq, tk, tv))
    pallas = jax_flash_attention(jq, jk, jv, None if bias is None
                                 else jnp.asarray(bias), scale,
                                 layout="bshd")
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=0, atol=1e-2)


def masked_sample_bias(B, S, causal):
    """fp32 ``[B, 1, S, S]``: −1e9 on masked keys (not summed: a key masked
    twice still scores −1e9). Sample 0 masks every key, so each of its query
    rows is fully masked; sample 1 pads its last 5 keys; ``causal`` also
    masks the keys after each row."""
    masked = np.zeros((B, 1, S, S), bool)
    masked[0] = True
    masked[1:, ..., S - 5:] = True
    if causal:
        masked |= np.triu(np.ones((S, S), bool), k=1)
    return np.where(masked, NEG, 0.0).astype(np.float32)


@pytest.mark.parametrize("S,causal", [(77, True), (197, False)])
def test_fully_masked_row_matches_pallas_fp32(S, causal):
    """A row whose every key is at −1e9: the TPU wrapper's Sp − S padded
    keys (Sp = round_up(S, 8)) tie with the real ones, so the Pallas kernel
    gives Σv / Sp (the XLA path, which pads nothing, gives the mean over S).
    The plain version, and so the kernels held to it, give the Pallas row."""
    B, H, D = 2, 2, 16
    q, k, v, _ = _inputs(B, S, H, D, seed=S)
    bias = masked_sample_bias(B, S, causal)
    scale = D ** -0.5
    ours = ta.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, bias)),
                              scale).numpy()
    pallas = np.asarray(jax_flash_attention(
        *(jnp.asarray(x) for x in (q, k, v, bias)), scale, layout="bshd"))
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-5)
    Sp = -(-S // 8) * 8
    row = np.broadcast_to(v[0].sum(0) / Sp, (S, H, D))
    np.testing.assert_allclose(ours[0], row, rtol=0, atol=1e-5)
    assert np.abs(row - v[0].mean(0)).max() > 1e-3  # not the mean over S


def test_plain_attention_reads_strided_views():
    """q, k, v as bshd views of one fused projection output (batch and
    sequence strides ≠ contiguous) give the contiguous result."""
    B, S, H, D = 2, 10, 2, 16
    rng = np.random.default_rng(3)
    fused = torch.from_numpy(
        rng.standard_normal((B, S, 3 * H * D)).astype(np.float32))
    q, k, v = (fused[..., i * H * D:(i + 1) * H * D].view(B, S, H, D)
               for i in range(3))
    assert not q.is_contiguous()
    got = ta.flash_attention(q, k, v, None, D ** -0.5)
    want = ta.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              None, D ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "shape", "rank",
                                  "last_dim_stride", "bias_heads",
                                  "bias_len"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    B, S, H, D = 2, 8, 2, 16
    q = torch.zeros(B, S, H, D)
    k, v, bias = q.clone(), q.clone(), None
    if case == "head_dim":
        q = k = v = torch.zeros(B, S, H, 48)
    elif case == "dtype":
        q = k = v = q.half()
    elif case == "shape":
        k = torch.zeros(B, S + 1, H, D)
    elif case == "rank":
        q = k = v = torch.zeros(B, S, H * D)
    elif case == "last_dim_stride":
        q = torch.zeros(B, S, H, 2 * D)[..., ::2]
    elif case == "bias_heads":
        bias = torch.zeros(1, H, S, S)
    elif case == "bias_len":
        bias = torch.zeros(1, 1, S, S + 1)
    with pytest.raises(ValueError):
        ta.flash_attention(q, k, v, bias, 0.25)


def test_rounded_scale_matches_jax_weak_typing():
    """JAX multiplies a bf16 array by a Python float in bf16."""
    for d in (16, 32, 64):
        s = d ** -0.5
        want = float(jnp.asarray(s, jnp.bfloat16))
        assert ta.rounded_scale(s, torch.bfloat16) == want
        assert ta.rounded_scale(s, torch.float32) == float(np.float32(s))

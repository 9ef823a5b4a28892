"""The port's fused SPARC pooling (``clip_finegrained_alignment_tpu_torch/
ops/sparc_kernel.py``) against the JAX package's.

On the CPU the port's wrapper runs its plain versions; here they are held
against the Pallas kernels ``fused_sparc_pooling`` (forward and backward,
interpret mode, as ``tests/test_ops.py`` runs them) and against the XLA
chain ``_reference_chain`` (values and ``jax.vjp``), on the same numpy
inputs: thresholds 0, 0.5 and 1, fully masked token rows, zero and
tiny-norm rows, and duplicated patches (ties of the min and max). The CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py``.

Tolerances: forward rtol 1e-5, atol 1e-6 (fp32 on both sides, other
summation order); backward rtol 1e-4, atol 1e-5 (as ``tests/test_ops.py``
holds the Pallas backward against ``jax.vjp``: the VJP divides by the
row's range and sum, which amplifies the fp32 rounding of sim).

The CUDA kernels take their products as three TF32 products (hi·hi,
hi·lo, lo·hi of ``tf32_split``); an emulation of those products in plain
PyTorch, at the train widths, is held to the Pallas kernels within
``chip_smoke.py``'s ``SPARC_TOL`` outside its near-decision rows.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.ops.sparc_kernel import (
    _reference_chain, fused_sparc_pooling as jax_fused_sparc_pooling)
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import sparc_kernel as sk
from clip_finegrained_alignment_tpu_torch.perf import sparc_study

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _inputs(case, seed, B=3, P=11, T=6, D=16):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, P, D)).astype(np.float32)
    l = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, T // 2:] = 0.0                 # a partly padded sample
    if case in ("edges", "masked"):
        mask[1, :] = 0.0                   # a fully masked sample
    if case == "edges":
        v[2, 4] = 0.0                      # an exactly zero patch row
        l[0, 1] = 0.0                      # an exactly zero token row
    if case == "tiny":
        v[0, 2] = 1e-13                    # 0 < ||x|| < eps: divides by eps
        l[1, 3] = -1e-13
    if case == "ties":
        v[:, 5] = v[:, 2]                  # duplicated patches: every row's
        v[:, 7] = v[:, 2]                  # sim ties across them, so each
        v[:, 8] = -v[:, 2]                 # row's min or max may tie
        v[:, 9] = -v[:, 2]
    g = rng.normal(size=(B, T, D)).astype(np.float32)
    return v, l, mask, g


CASES = ["random", "edges", "masked", "tiny", "ties"]


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("case", CASES)
def test_plain_forward_matches_pallas_and_chain(case, threshold):
    v, l, mask, _ = _inputs(case, seed=CASES.index(case))
    _build.reset_launch_counts()
    ours = sk.fused_sparc_pooling(*(torch.from_numpy(x) for x in (v, l, mask)),
                                  threshold).numpy()
    jv, jl, jm = (jnp.asarray(x) for x in (v, l, mask))
    pallas, chain = (np.asarray(jax.jit(fn, static_argnums=3)(
        jv, jl, jm, threshold))
        for fn in (jax_fused_sparc_pooling, _reference_chain))
    assert ours.shape == l.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, chain, rtol=1e-5, atol=1e-6)
    if case in ("edges", "masked"):
        assert not ours[1].any()           # a fully masked sample pools to 0
    # CPU tensors take the plain version: no kernel launch is counted.
    assert _build.launch_counts()["sparc_fwd"] == 0


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_pallas_and_vjp(case, threshold):
    v, l, mask, g = _inputs(case, seed=10 + CASES.index(case))
    dv, dl = sk.sparc_pooling_backward_reference(
        *(torch.from_numpy(x) for x in (v, l, mask)), threshold,
        torch.from_numpy(g))
    jv, jl, jm, jg = (jnp.asarray(x) for x in (v, l, mask, g))

    def vjp(fn):
        return jax.jit(lambda a, b, m, c: jax.vjp(
            lambda x, y: fn(x, y, m, threshold), a, b)[1](c))(jv, jl, jm, jg)

    for want in (vjp(jax_fused_sparc_pooling), vjp(_reference_chain)):
        np.testing.assert_allclose(dv.numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dl.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-5)


def test_backward_in_bf16_returns_the_input_type():
    v, l, mask, g = _inputs("random", seed=3)
    tv, tl = (torch.from_numpy(x).to(torch.bfloat16) for x in (v, l))
    dv, dl = sk.sparc_pooling_backward_reference(
        tv, tl, torch.from_numpy(mask), 0.5, torch.from_numpy(g))
    assert dv.dtype == dl.dtype == torch.bfloat16
    jv, jl = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tv, tl))
    _, vjp = jax.vjp(lambda a, b: jax_fused_sparc_pooling(
        a, b, jnp.asarray(mask), 0.5), jv, jl)
    for got, want in zip((dv, dl), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_function_on_cpu_gives_the_plain_backward():
    v, l, mask, g = _inputs("edges", seed=4)
    tv, tl = (torch.from_numpy(x).requires_grad_() for x in (v, l))
    out = sk.fused_sparc_pooling(tv, tl, torch.from_numpy(mask), 0.5)
    assert type(out.grad_fn).__name__ == "FusedSparcPoolingBackward"
    gv, gl = torch.autograd.grad(out, (tv, tl), torch.from_numpy(g))
    dv, dl = sk.sparc_pooling_backward_reference(
        *(torch.from_numpy(x) for x in (v, l, mask)), 0.5,
        torch.from_numpy(g))
    torch.testing.assert_close(gv, dv, rtol=0, atol=0)
    torch.testing.assert_close(gl, dl, rtol=0, atol=0)


def test_function_routes_cuda_tensors_to_the_kernels(monkeypatch):
    """The device branch, without a card: ``_device_kind`` says "cuda" and
    the launchers are stubs that count and return the plain results. The
    forward output carries the Function's backward node, and the backward
    reaches the backward launcher with the forward's sim, rl and rv."""
    v, l, mask, g = _inputs("random", seed=5)
    calls, saved = [], []

    def fwd(v, l, mask, threshold):
        calls.append("fwd")
        out = sk.sparc_pooling_reference(v.detach(), l.detach(), mask,
                                         threshold, return_residuals=True)
        saved.extend(out[1:])
        return out

    def bwd(v, l, mask, threshold, g, sim, rl, rv):
        calls.append("bwd")
        assert all(a is b for a, b in zip((sim, rl, rv), saved))
        return sk.sparc_pooling_backward_reference(v, l, mask, threshold, g,
                                                   residuals=(sim, rl, rv))

    monkeypatch.setattr(sk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(sk, "_launch", fwd)
    monkeypatch.setattr(sk, "_launch_backward", bwd)
    tv, tl = (torch.from_numpy(x).requires_grad_() for x in (v, l))
    out = sk.fused_sparc_pooling(tv, tl, torch.from_numpy(mask), 0.5)
    assert type(out.grad_fn).__name__ == "FusedSparcPoolingBackward"
    out.backward(torch.from_numpy(g))
    assert calls == ["fwd", "bwd"]
    assert tv.grad is not None and tl.grad is not None


@pytest.mark.parametrize("case", ["rank", "mask_shape", "batch", "width",
                                  "dtype"])
def test_wrapper_rejects_what_the_kernels_do_not_take(case):
    v, l, mask = torch.zeros(2, 5, 8), torch.zeros(2, 3, 8), torch.ones(2, 3)
    if case == "rank":
        v = torch.zeros(2, 5 * 8)
    elif case == "mask_shape":
        mask = torch.ones(2, 4)
    elif case == "batch":
        l = torch.zeros(3, 3, 8)
    elif case == "width":
        l = torch.zeros(2, 3, 9)
    elif case == "dtype":
        v = torch.zeros(2, 5, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        sk.fused_sparc_pooling(v, l, mask, 0.5)


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_from_residuals_matches_pallas_and_vjp(case,
                                                              threshold):
    """The plain backward fed the plain forward's sim, rl and rv (what the
    CUDA backward reads from the CUDA forward) is the recomputing one."""
    v, l, mask, g = _inputs(case, seed=20 + CASES.index(case))
    tv, tl, tm = (torch.from_numpy(x) for x in (v, l, mask))
    out, sim, rl, rv = sk.sparc_pooling_reference(tv, tl, tm, threshold,
                                                  return_residuals=True)
    assert sim.shape == (3, 6, 11) and rl.shape == (3, 6) \
        and rv.shape == (3, 11)
    torch.testing.assert_close(
        out, sk.sparc_pooling_reference(tv, tl, tm, threshold),
        rtol=0, atol=0)
    dv, dl = sk.sparc_pooling_backward_reference(
        tv, tl, tm, threshold, torch.from_numpy(g), residuals=(sim, rl, rv))
    jv, jl, jm, jg = (jnp.asarray(x) for x in (v, l, mask, g))

    def vjp(fn):
        return jax.jit(lambda a, b, m, c: jax.vjp(
            lambda x, y: fn(x, y, m, threshold), a, b)[1](c))(jv, jl, jm, jg)

    for want in (vjp(jax_fused_sparc_pooling), vjp(_reference_chain)):
        np.testing.assert_allclose(dv.numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dl.numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-5)


def test_tf32_split_rounds_to_nearest_away_and_recovers_x():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (``cvt.rna``), and hi + lo is x to 2^-22 of it, over a seeded sweep
    of magnitudes (1e-30 to 1e30, where lo is a normal number too) and
    signs, exact ties and zeros."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(
        np.float32)
    ties = (rng.integers(64 << 23, 1 << 30, 64, dtype=np.int64) & ~0x1FFF
            | 0x1000).astype(np.int32).view(np.float32)
    x = np.concatenate([x, ties, -ties, np.float32([0.0, -0.0, 1.0, -3.5])])
    hi, lo = sk.tf32_split(torch.from_numpy(x))
    bits = hi.view(torch.int32)
    assert not (bits & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - torch.from_numpy(x).double()).abs()
    assert (err <= 2.0 ** -22 * torch.from_numpy(x).double().abs()).all()
    # the nearest of the two TF32 neighbours; ties away from zero
    n = len(ties)
    t_hi = hi[4096:4096 + n].view(torch.int32)
    want = torch.from_numpy((ties.view(np.int32).astype(np.int64) + 0x1000)
                            .astype(np.int32))
    assert torch.equal(t_hi, want)
    assert torch.equal(hi[4096 + n:4096 + 2 * n], -hi[4096:4096 + n])
    low = (torch.from_numpy(x).view(torch.int32) & 0x1FFF)
    up = low >= 0x1000
    mag = torch.from_numpy(x).view(torch.int32) & 0x7FFFFFFF
    want_mag = torch.where(up, (mag & ~0x1FFF) + 0x2000, mag & ~0x1FFF)
    assert torch.equal(bits & 0x7FFFFFFF, want_mag)


def _einsum_3xtf32(eq, a, b):
    """The kernels' products: lo·hi + hi·lo, then + hi·hi, in fp32."""
    ah, al = sk.tf32_split(a)
    bh, bl = sk.tf32_split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _tf32_forward(v, l, mask, threshold):
    """The CUDA forward's arithmetic: sim from the raw operands, scaled by
    rl and rv after the product; out = w·v; both products 3xTF32."""
    rl = torch.rsqrt(torch.clamp_min((l * l).sum(-1), sk.NORM_EPS ** 2))
    rv = torch.rsqrt(torch.clamp_min((v * v).sum(-1), sk.NORM_EPS ** 2))
    sim = _einsum_3xtf32("btd,bpd->btp", l, v) * rl[:, :, None] \
        * rv[:, None, :]
    w = sk.sparc_alignment_weights(sim, mask, threshold)
    return _einsum_3xtf32("btp,bpd->btd", w, v), sim, rl, rv


def test_tf32_products_hold_the_card_tolerance_at_train_widths():
    """At B=2, T=77, P=197, D=512 (ViT-B/16 SPARC widths), the forward and
    the backward built from 3xTF32 products stay within SPARC_TOL of the
    Pallas kernels (interpret mode), outside the near-decision rows; plain
    TF32 products (hi·hi alone) would not."""
    rng = np.random.default_rng(11)
    B, T, P, D, tau = 2, 77, 197, 512, 0.5
    v = rng.normal(size=(B, P, D)).astype(np.float32)
    l = rng.normal(size=(B, T, D)).astype(np.float32)
    g = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([[40], [77]])).astype(np.float32)
    tv, tl, tm, tg = (torch.from_numpy(x) for x in (v, l, mask, g))
    out, sim, rl, rv = _tf32_forward(tv, tl, tm, tau)
    dv, dl = sk.sparc_pooling_backward_reference(
        tv, tl, tm, tau, tg, residuals=(sim, rl, rv), einsum=_einsum_3xtf32)
    jv, jl, jm, jg = (jnp.asarray(x) for x in (v, l, mask, g))
    want, pull = jax.vjp(lambda a, b: jax_fused_sparc_pooling(a, b, jm, tau),
                         jv, jl)
    wdv, wdl = pull(jg)
    near = smoke.sparc_near_rows(tv, tl, tm, tau)
    assert int(near.sum()) <= smoke.SPARC_MAX_NEAR_SHARE * int(tm.sum())
    keep_row = ~near[:, :, None].numpy()
    keep_b = ~near.any(-1)[:, None, None].numpy()
    errs = {"out": np.abs(out.numpy() - np.asarray(want)) * keep_row,
            "dl": np.abs(dl.numpy() - np.asarray(wdl)) * keep_row,
            "dv": np.abs(dv.numpy() - np.asarray(wdv)) * keep_b}
    for name, err in errs.items():
        assert err.max() <= smoke.SPARC_TOL, (name, err.max())
    # The raw product l·vᵀ (|l||v| ≈ 512): hi·hi alone misses the exact
    # sum by over 100 tolerances, the three products by less than one.
    exact = torch.einsum("btd,bpd->btp", tl.double(), tv.double())
    hh = torch.einsum("btd,bpd->btp", *(sk.tf32_split(x)[0] for x in (tl, tv)))
    three = _einsum_3xtf32("btd,bpd->btp", tl, tv)
    assert (hh.double() - exact).abs().max() > 100 * smoke.SPARC_TOL
    assert (three.double() - exact).abs().max() < smoke.SPARC_TOL


def test_tf32_products_keep_ties_bit_equal():
    """Duplicated patches give bit-equal similarities under the emulated
    3xTF32 products, so the min/max cotangent still splits among them."""
    v, l, mask, _ = _inputs("ties", seed=13)
    _, sim, _, _ = _tf32_forward(*(torch.from_numpy(x) for x in (v, l, mask)),
                                 0.5)
    assert torch.equal(sim[..., 5], sim[..., 2])
    assert torch.equal(sim[..., 7], sim[..., 2])
    assert torch.equal(sim[..., 9], sim[..., 8])


@pytest.mark.parametrize("variant", sorted(sparc_study.VARIANTS))
def test_study_variants_set_each_constant_once(variant):
    values = sparc_study.VARIANTS[variant]
    sources = sparc_study.with_constants(values)
    for const, value in values.items():
        text = sources[sparc_study.CONSTANT_FILES[const]]
        assert text.count(f"constexpr int {const} = {value};") == 1

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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.ops.sparc_kernel import (
    _reference_chain, fused_sparc_pooling as jax_fused_sparc_pooling)
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import sparc_kernel as sk


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
    reaches the backward launcher."""
    v, l, mask, g = _inputs("random", seed=5)
    calls = []

    def fwd(v, l, mask, threshold):
        calls.append("fwd")
        return sk.sparc_pooling_reference(v, l, mask, threshold).detach()

    def bwd(v, l, mask, threshold, g):
        calls.append("bwd")
        return sk.sparc_pooling_backward_reference(v, l, mask, threshold, g)

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

"""The port's blockwise attention (``clip_finegrained_alignment_tpu_torch/
ops/flash_attention.py``) and flash microbenchmark against the JAX
package's.

On the CPU the port runs ``blockwise_attention_reference`` and
``blockwise_attention_backward_reference``; here they are held against the
Pallas wrappers ``_fwd`` and ``_bwd`` of ``clip_finegrained_alignment_tpu/
ops/flash_attention.py`` (interpret mode, as ``tests/test_ops.py`` runs
them) and the autograd Function against ``jax.vjp`` of the JAX
``blockwise_flash_attention``, on the same numpy inputs, at
``tests/test_ops.py``'s blockwise shapes with head dim 16 (S=160 blocks 64,
ragged; S=96 causal blocks 32; S=80 blocks 32), in fp32 and bf16. The CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py``; here the launchers are driven up to their C entries
(refusals of views the bf16 kernels' copies cannot take, the dtype code
and operands each entry gets).

Tolerances (outputs and gradients of size ≤ ~2):

* fp32: atol 2e-5, as in ``tests/test_ops.py`` (both sides fp32; other
  summation order);
* bf16: each element within one bf16 step (2^-7 relative) plus 2e-3 of
  the largest magnitude: both sides do the same fp32 math on the same bf16
  values and round at the same places (p for the product with v, the
  output, dq twice), so they differ only where an fp32 sum taken in
  another order lands near a rounding boundary.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.models.clip import _xla_attention
from clip_finegrained_alignment_tpu.ops import flash_attention as jfa
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import flash_attention as tfa
from clip_finegrained_alignment_tpu_torch.perf import (flash_fwd_study,
                                                      flash_microbench,
                                                      lo_half_study)

NEG = -1e9
# (S, causal, block_q = block_k): tests/test_ops.py's blockwise cases
CASES = [(160, False, 64), (96, True, 32), (80, False, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(S, causal, seed, B=2, H=2, D=16):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    bias = (np.triu(np.full((S, S), NEG, np.float32), k=1)[None, None]
            if causal else None)
    return q, k, v, do, bias, D ** -0.5


def _close(got, want, dtype_name, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5, err_msg=what)
    else:
        lim = 2 ** -7 * np.abs(want) + 2e-3 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= lim), \
            f"{what}: max err {np.abs(got - want).max()}"


def _torch(xs, dtype):
    return [torch.from_numpy(np.array(x, np.float32)).to(dtype) for x in xs]


def _bias(bias):
    """The bias stays fp32 on both sides, as the JAX wrapper takes it."""
    return None if bias is None else torch.from_numpy(bias)


@functools.lru_cache(maxsize=None)
def _jax_fwd_bwd(S, causal, block, dname):
    """JAX ``_fwd`` (o, lse over the real rows) and ``_bwd`` from that o and
    lse, as numpy."""
    q, k, v, do, bias, scale = _case(S, causal, seed=S + causal)
    jdt = DTYPES[dname][0]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias)
    o, lse = jax.jit(lambda a, b, c, d: jfa._fwd(
        a, b, c, d, scale, block, block))(jq, jk, jv, jb)
    grads = jax.jit(lambda a, b, c, d, e, f, g: jfa._bwd(
        a, b, c, d, scale, block, block, e, f, g))(jq, jk, jv, jb, o, lse, jdo)
    return (np.asarray(o, np.float32), np.asarray(lse)[:, :, :S, 0],
            [np.asarray(g, np.float32) for g in grads])


def _jax_vjp(q, k, v, do, bias, scale, block, jdt):
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    jb = None if bias is None else jnp.asarray(bias)

    def run(a, b, c, d, e):
        out, pull = jax.vjp(lambda x, y, z: jfa.blockwise_flash_attention(
            x, y, z, d, scale, block, block), a, b, c)
        return out, pull(e)

    out, grads = jax.jit(run)(jq, jk, jv, jb, jdo)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("S,causal,block", CASES)
def test_plain_forward_matches_pallas(S, causal, block, dname):
    q, k, v, _, bias, scale = _case(S, causal, seed=S + causal)
    tq, tk, tv = _torch((q, k, v), DTYPES[dname][1])
    o, lse = tfa.blockwise_attention_reference(tq, tk, tv, _bias(bias), scale,
                                               block)
    jo, jlse, _ = _jax_fwd_bwd(S, causal, block, dname)
    assert o.dtype == DTYPES[dname][1] and lse.dtype == torch.float32
    _close(o, jo, dname, "o")
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=2e-5,
                               err_msg="lse")


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("S,causal,block", CASES)
def test_plain_backward_matches_pallas(S, causal, block, dname):
    """Both sides get JAX's o and lse and the same random do."""
    q, k, v, do, bias, scale = _case(S, causal, seed=S + causal)
    dt = DTYPES[dname][1]
    jo, jlse, jgrads = _jax_fwd_bwd(S, causal, block, dname)
    tq, tk, tv, tdo, to = _torch((q, k, v, do, jo), dt)
    ours = tfa.blockwise_attention_backward_reference(
        tq, tk, tv, _bias(bias), scale, to, torch.tensor(jlse), tdo)
    for name, got, want in zip("qkv", ours, jgrads):
        assert got.dtype == dt
        _close(got, want, dname, f"d{name}")


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("S,causal,block", CASES)
def test_autograd_matches_jax_vjp(S, causal, block, dname):
    q, k, v, do, bias, scale = _case(S, causal, seed=50 + S + causal)
    jdt, dt = DTYPES[dname]
    tq, tk, tv = (t.requires_grad_() for t in _torch((q, k, v), dt))
    out = tfa.blockwise_flash_attention(tq, tk, tv, _bias(bias), scale, block,
                                        block)
    grads = torch.autograd.grad(out, (tq, tk, tv), _torch((do,), dt)[0])
    jout, jgrads = _jax_vjp(q, k, v, do, bias, scale, block, jdt)
    _close(out.detach(), jout, dname, "o")
    for name, got, want in zip("qkv", grads, jgrads):
        _close(got, want, dname, f"d{name}")


@pytest.mark.parametrize("dname", DTYPES)
def test_batched_padding_bias(dname):
    """A per-sample key-padding bias [B, 1, S, S] (ViT-L/14@336's 577 is
    shaped like this S: no block divides it)."""
    S, block = 77, 32
    q, k, v, do, _, scale = _case(S, False, seed=11, B=3)
    lens = np.array([77, 50, 31])
    bias = np.where(np.arange(S)[None, :] >= lens[:, None], NEG, 0.0) \
        .astype(np.float32)[:, None, None, :].repeat(S, axis=2)
    jdt, dt = DTYPES[dname]
    tq, tk, tv = (t.requires_grad_() for t in _torch((q, k, v), dt))
    out = tfa.blockwise_flash_attention(tq, tk, tv, torch.from_numpy(bias),
                                        scale, block, block)
    grads = torch.autograd.grad(out, (tq, tk, tv), _torch((do,), dt)[0])
    jout, jgrads = _jax_vjp(q, k, v, do, bias, scale, block, jdt)
    _close(out.detach(), jout, dname, "o")
    for name, got, want in zip("qkv", grads, jgrads):
        _close(got, want, dname, f"d{name}")
    # Keys past a sample's length get no gradient.
    assert not grads[1][1, :, 50:].any() and not grads[2][2, :, 31:].any()


def test_key_bias_broadcasts_over_query_rows():
    """A key-padding bias [B, 1, 1, S] gives what the same bias expanded to
    [B, 1, S, S] gives, and what JAX gives (its padding takes this shape
    where block_q divides S)."""
    S, block = 64, 32
    q, k, v, do, _, scale = _case(S, False, seed=12)
    bias = np.where(np.arange(S)[None, :] >= np.array([64, 40])[:, None],
                    NEG, 0.0).astype(np.float32)[:, None, None, :]
    runs = []
    for b in (bias, np.repeat(bias, S, axis=2)):
        tq, tk, tv = (t.requires_grad_() for t in _torch((q, k, v),
                                                         torch.float32))
        out = tfa.blockwise_flash_attention(tq, tk, tv, torch.from_numpy(b),
                                            scale, block, block)
        runs.append([out.detach()] + list(torch.autograd.grad(
            out, (tq, tk, tv), torch.from_numpy(do))))
    for got, want in zip(*runs):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    jout, jgrads = _jax_vjp(q, k, v, do, bias, scale, block, jnp.float32)
    for name, got, want in zip(("o", "dq", "dk", "dv"), runs[0],
                               [jout] + jgrads):
        _close(got, want, "float32", name)


@pytest.mark.parametrize("block_k", [32, 40])
def test_fully_masked_row_is_sum_over_padded_keys(block_k):
    """A reproduced JAX behaviour: in a row whose every key has a −1e9
    bias, the TPU wrapper's zero padding keys (also −1e9) tie with the real
    ones, so the row is Σv / Sk with Sk = round_up(S, block_k): Σv / 64 at
    block_k = 32; the XLA path's mean over S = 40 at block_k = 40."""
    S = 40
    q, k, v, _, _, scale = _case(S, False, seed=5, B=1, H=1)
    bias = np.zeros((1, 1, S, S), np.float32)
    bias[0, 0, 0] = NEG
    o, lse = tfa.blockwise_attention_reference(
        *_torch((q, k, v), torch.float32), _bias(bias), scale, block_k)
    jo, _ = jax.jit(lambda a, b, c, d: jfa._fwd(
        a, b, c, d, scale, block_k, block_k))(q, k, v, bias)
    xla = np.asarray(_xla_attention(q, k, v, bias, scale))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=2e-5)
    Sk = -(-S // block_k) * block_k
    np.testing.assert_allclose(o[0, 0, 0].numpy(), v[0, 0].sum(0) / Sk,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(o[0, 0, 1:].numpy(), xla[0, 0, 1:], rtol=0,
                               atol=2e-5)
    assert (np.abs(o[0, 0, 0].numpy() - xla[0, 0, 0]).max() < 1e-6) \
        == (Sk == S)
    assert lse[0, 0, 0].item() == NEG      # −1e9 + log(Sk) rounds to −1e9


@pytest.mark.parametrize("block_k", [32, 40])
def test_fully_masked_row_backward_follows_jax(block_k):
    """The same row's backward, also reproduced: its lse rounds to −1e9, so
    JAX's p = exp(s − lse) is 1 for every real key instead of 1/Sk, and the
    row's dq is ~S times the XLA path's gradient, at every block_k."""
    S = 40
    q, k, v, do, _, scale = _case(S, False, seed=5, B=1, H=1)
    bias = np.zeros((1, 1, S, S), np.float32)
    bias[0, 0, 0] = NEG
    tq, tk, tv = (t.requires_grad_() for t in _torch((q, k, v),
                                                     torch.float32))
    out = tfa.blockwise_flash_attention(tq, tk, tv, _bias(bias), scale,
                                        block_k, block_k)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _, jgrads = _jax_vjp(q, k, v, do, bias, scale, block_k, jnp.float32)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5,
                                   err_msg=f"d{name}")
    xla_dq = np.asarray(jax.vjp(lambda x: _xla_attention(
        x, k, v, bias, scale), q)[1](do)[0])
    ratio = np.abs(grads[0][0, 0, 0].numpy()).max() / \
        np.abs(xla_dq[0, 0, 0]).max()
    assert 20 < ratio < 80


def test_strided_bhsd_views():
    """q, k, v as bhsd views of bshd tensors (the microbenchmark's fused
    path makes the converse views): same result as contiguous inputs."""
    q, k, v, do, _, scale = _case(70, False, seed=4)
    dense = _torch((q, k, v), torch.float32)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in dense]
    assert not views[0].is_contiguous()
    want = tfa.blockwise_flash_attention(*dense, None, scale, 32, 32)
    got = tfa.blockwise_flash_attention(*views, None, scale, 32, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("branch", ["cuda", "cpu"])
def test_output_under_grad_has_the_functions_grad_fn(branch, monkeypatch):
    """The CUDA branch without a card: ``_device_kind`` says "cuda" and the
    launchers are stubs that return fresh tensors, as the real ones do; the
    backward must reach both backward launchers and no plain version."""
    q, k, v, do, bias, scale = _case(48, True, seed=9)
    plain_fwd = tfa.blockwise_attention_reference
    plain_bwd = tfa.blockwise_attention_backward_reference
    calls = []
    if branch == "cuda":
        def fwd(q, k, v, bias, scale, block_k):
            calls.append("fwd")
            o, lse = plain_fwd(q, k, v, bias, scale, block_k)
            return o.detach(), lse

        def bwd(q, k, v, bias, scale, do, lse, delta):
            o = plain_fwd(q, k, v, bias, scale, 32)[0]
            torch.testing.assert_close(delta, tfa._delta(do, o))
            return plain_bwd(q, k, v, bias, scale, o, lse, do)

        def dq(*args):
            calls.append("dq")
            return bwd(*args)[0]

        def dkdv(*args):
            calls.append("dkdv")
            return bwd(*args)[1:]

        def no_plain(*args):
            raise AssertionError("a plain version ran on the CUDA branch")

        monkeypatch.setattr(tfa, "_device_kind", lambda t: "cuda")
        monkeypatch.setattr(tfa, "_launch_fwd", fwd)
        monkeypatch.setattr(tfa, "_launch_bwd_dq", dq)
        monkeypatch.setattr(tfa, "_launch_bwd_dkdv", dkdv)
        monkeypatch.setattr(tfa, "blockwise_attention_reference", no_plain)
        monkeypatch.setattr(tfa, "blockwise_attention_backward_reference",
                            no_plain)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.blockwise_flash_attention(tq, tk, tv, torch.from_numpy(bias),
                                        scale, 32, 32)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == "BlockwiseFlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (tq, tk, tv))
    assert calls == (["fwd", "dq", "dkdv"] if branch == "cuda" else [])


def test_bias_gets_no_gradient():
    q, k, v, do, bias, scale = _case(40, True, seed=2)
    tb = torch.from_numpy(bias).requires_grad_()
    tq = torch.from_numpy(q).requires_grad_()
    _build.reset_launch_counts()
    out = tfa.blockwise_flash_attention(tq, *_torch((k, v), torch.float32),
                                        tb, scale, 32, 32)
    out.backward(torch.from_numpy(do))
    assert tb.grad is None and tq.grad is not None
    assert sum(_build.launch_counts().values()) == 0   # CPU: no kernel


def _refusals():
    ok = np.zeros((1, 2, 8, 16), np.float32)
    t = torch.from_numpy(ok)
    return {
        "3-d q": ((t[0], t[0], t[0], None), {}),
        "shapes differ": ((t, t[:, :1], t, None), {}),
        "head dim 8": ((t[..., :8], t[..., :8], t[..., :8], None), {}),
        "float16": ((t.half(), t.half(), t.half(), None), {}),
        "mixed dtypes": ((t, t.bfloat16(), t, None), {}),
        "strided last dim": ((torch.zeros(1, 2, 8, 32)[..., ::2],) * 3
                             + (None,), {}),
        "empty": ((t[:, :, :0],) * 3 + (None,), {}),
        "bias over heads": ((t, t, t, torch.zeros(1, 2, 8, 8)), {}),
        "bias wrong length": ((t, t, t, torch.zeros(1, 1, 8, 7)), {}),
        "integer bias": ((t, t, t, torch.zeros(1, 1, 8, 8, dtype=torch.int32)),
                         {}),
        "block_k 0": ((t, t, t, None), {"block_k": 0}),
        "block_k float": ((t, t, t, None), {"block_k": 64.0}),
    }


@pytest.mark.parametrize("what", list(_refusals()))
def test_refuses_what_the_kernels_do_not_take(what):
    args, kw = _refusals()[what]
    with pytest.raises(ValueError):
        tfa.blockwise_flash_attention(*args, 0.25, **kw)


def test_microbench_prints_four_lines_per_design_point(capsys):
    lines = flash_microbench.main(["--device", "cpu", "--seq", "64",
                                   "--batch", "1", "--steps", "1"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == lines and len(lines) == 4
    for line, label in zip(lines, ("blockwise fwd", "blockwise fwd+bwd",
                                   "fused fwd", "fused fwd+bwd")):
        assert line.startswith(f"S=64 B=1 {label}: ")
        assert line.endswith(" ms/call")


def test_microbench_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_microbench.main(["--seq", "64", "--steps", "1"])
    lines = flash_microbench.main(["--device", "cpu", "--seq", "32",
                                   "--batch", "2", "--steps", "1"])
    assert sum(line.startswith("S=32 B=2 ") for line in lines) == 4


def _bf16_views(which, kind, B=2, H=2, S=8, D=16):
    """bf16 q, k, v, do [B, H, S, D] with ``which`` made a view the bf16
    kernels' 16-byte copies cannot take (``kind``), the rest contiguous."""
    rng = np.random.default_rng(3)
    ts = {n: torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(
        np.float32)).bfloat16() for n in ("q", "k", "v", "do")}
    x = ts[which]
    if kind == "pointer":          # 2 bytes past a 16-byte boundary
        flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
        view = flat[1:].view(B, H, S, D)
    elif kind == "sequence stride":    # rows 8 bytes longer than D
        view = torch.empty(B, H, S, D + 4, dtype=torch.bfloat16)[..., :D]
    else:                          # heads 8 bytes longer than S·D
        view = torch.empty(B, H, S * D + 4, dtype=torch.bfloat16)[
            ..., :S * D].view(B, H, S, D)
    view.copy_(x)
    ts[which] = view
    return ts


@pytest.mark.parametrize("kind", ["pointer", "sequence stride",
                                  "head stride"])
@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_bf16_backward_refuses_unaligned_views(which, kind, monkeypatch):
    """The bf16 backward kernels copy 16-byte-aligned tiles by TMA: both
    launchers refuse such a view with ValueError before a kernel is built,
    and nothing is rerouted. The CPU branch takes the same views."""
    ts = _bf16_views(which, kind)
    q, k, v, do = ts["q"], ts["k"], ts["v"], ts["do"]
    B, H, S, _ = q.shape
    lse = torch.zeros(B, H, S)

    def no_build(name):
        raise AssertionError(f"{name} built for a view it cannot take")

    monkeypatch.setattr(_build, "load", no_build)
    for launch in (tfa._launch_bwd_dq, tfa._launch_bwd_dkdv):
        with pytest.raises(ValueError, match="multiples of 16 bytes"):
            launch(q, k, v, None, 0.25, do, lse, lse)
    monkeypatch.undo()
    dense = {n: t.contiguous().requires_grad_(n != "do")
             for n, t in ts.items()}
    views = {n: t.requires_grad_(n != "do") for n, t in ts.items()}
    grads = []
    for run in (dense, views):
        out = tfa.blockwise_flash_attention(run["q"], run["k"], run["v"],
                                            None, 0.25, 32, 32)
        grads.append(torch.autograd.grad(out, (run["q"], run["k"], run["v"]),
                                         run["do"]))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["pointer", "sequence stride",
                                  "head stride"])
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_bf16_forward_refuses_unaligned_views(which, kind, monkeypatch):
    """The bf16 forward kernel copies 16-byte-aligned tiles by TMA too: its
    launcher refuses such a view with ValueError before a kernel is built,
    and nothing is rerouted. The CPU branch takes the same views."""
    ts = _bf16_views(which, kind)
    q, k, v = ts["q"], ts["k"], ts["v"]

    def no_build(name):
        raise AssertionError(f"{name} built for a view it cannot take")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tfa._launch_fwd(q, k, v, None, 0.25, 32)
    monkeypatch.undo()
    got = tfa.blockwise_flash_attention(q, k, v, None, 0.25, 32, 32)
    want = tfa.blockwise_flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), None, 0.25, 32, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


class _FakeEntry:
    """A C entry that records its arguments and reports success."""

    def __init__(self):
        self.argtypes = self.restype = None
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("kernel", [tfa.DQ_KERNEL, tfa.DKDV_KERNEL])
@pytest.mark.parametrize("dname", DTYPES)
def test_dtype_alone_selects_the_backward_entry(kernel, dname, monkeypatch):
    """The launchers hand the C entry the dtype code that picks its kernel
    (0: the fp32 CUDA-core kernel, 1: the bf16 wgmma kernel) and what that
    kernel reads: fp32 q with lse and δ rows of S, or bf16 qs = (q·scale)
    with lse and δ rows padded to 64 with zeros."""
    B, H, S, D = 2, 3, 70, 16
    dt = DTYPES[dname][1]
    q, k, v, do = _torch(_case(S, False, seed=8, B=B, H=H, D=D)[:4], dt)
    lse, delta = torch.randn(B, H, S), torch.randn(B, H, S)
    entry = _FakeEntry()
    lib = type("Lib", (), {f"cfa_{kernel}": entry})()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    launch = (tfa._launch_bwd_dq if kernel == tfa.DQ_KERNEL
              else tfa._launch_bwd_dkdv)
    launch(q, k, v, None, D ** -0.5, do, lse, delta)
    (args,) = entry.calls
    n_out = 1 if kernel == tfa.DQ_KERNEL else 2
    ints = args[7 + n_out:13 + n_out]
    assert ints[:5] == (B, H, S, D, 0 if dname == "float32" else 1)
    assert len(entry.argtypes) == len(args)
    ls = ints[5]
    if dname == "float32":
        assert args[0] == q.data_ptr() and ls == S
    else:
        assert args[0] != q.data_ptr() and ls == 128


def _fake_lib(monkeypatch, kernel):
    """The C entry of ``kernel`` replaced by a :class:`_FakeEntry`, launched
    as on the card's current stream."""
    entry = _FakeEntry()
    lib = type("Lib", (), {f"cfa_{kernel}": entry})()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(tfa, "_stream", lambda t: 0)
    return entry


@pytest.mark.parametrize("dname", DTYPES)
def test_dtype_alone_selects_the_forward_entry(dname, monkeypatch):
    """The forward launcher hands the C entry dtype code 0 with q itself
    (the fp32 CUDA-core kernel scales q), or code 1 with qs = (q·scale)
    rounded to bf16 (the bf16 wgmma kernel), the strides of what it hands
    over, and the padded key count Sk − S."""
    B, H, S, D = 2, 3, 70, 16
    dt = DTYPES[dname][1]
    q, k, v = _torch(_case(S, False, seed=9, B=B, H=H, D=D)[:3], dt)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)   # bshd memory
    entry = _fake_lib(monkeypatch, tfa.FWD_KERNEL)
    o, lse = tfa._launch_fwd(q, k, v, None, D ** -0.5, 64)
    (args,) = entry.calls
    assert len(entry.argtypes) == len(args)
    assert args[6:12] == (B, H, S, D, 0 if dname == "float32" else 1,
                          128 - S)
    assert args[1:3] == (k.data_ptr(), v.data_ptr())
    assert args[4:6] == (o.data_ptr(), lse.data_ptr())
    # q's bshd memory order (qs keeps it), then k's and v's.
    assert list(args[12:21]) == [s for t in (q, k, v) for s in t.stride()[:3]]
    assert (args[0] == q.data_ptr()) is (dname == "float32")
    assert o.shape == (B, H, S, D) and o.dtype == dt
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32


@pytest.mark.parametrize("D", [16, 32, 64])
def test_tma_operands(D):
    """The operands both bf16 directions read: qs equal to the plain
    version's ``_scaled_q`` to the bit, the others as they are unless
    broadcast (then dense), and dense strides for dims of extent 1."""
    B, H, S = 1, 3, 100
    q, k, v = _torch(_case(S, False, seed=D, B=B, H=H, D=D)[:3],
                     torch.bfloat16)
    q = q * 7
    vb = v[:, :1].expand(B, H, S, D)              # one head for all heads
    scale = D ** -0.5
    qs, k2, v2, strides = tfa._tma_operands(q, scale, k, vb)
    assert torch.equal(qs, tfa._scaled_q(q, scale))
    assert k2 is k and torch.equal(v2, vb) and v2.is_contiguous()
    assert strides == [H * S * D, S * D, D] * 3
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tfa._tma_operands(q, scale, k, shifted)


@pytest.mark.parametrize("D", [16, 32, 64])
def test_bf16_backward_operands(D):
    """What the bf16 kernels read: qs equal to the plain version's
    ``_scaled_q`` to the bit, lse and δ padded with zeros to a multiple of
    64 a row, and dense strides for dims of extent 1 (TMA needs every
    stride a multiple of 16 bytes)."""
    B, H, S = 1, 3, 100
    q, k, v, do = _torch(_case(S, False, seed=D, B=B, H=H, D=D)[:4],
                         torch.bfloat16)
    q = q * 7
    lse, delta = torch.randn(B, H, S), torch.randn(B, H, S)
    scale = D ** -0.5
    qs, _, _, _, ls, l2, d2, strides = tfa._bwd_operands(
        q, k, v, scale, do, lse, delta)
    assert torch.equal(qs, tfa._scaled_q(q, scale))
    assert ls == 128 and l2.shape == d2.shape == (B, H, 128)
    assert torch.equal(l2[..., :S], lse) and torch.equal(d2[..., :S], delta)
    assert not l2[..., S:].any() and not d2[..., S:].any()
    assert strides[:3] == [H * S * D, S * D, D]
    sliced = tfa._tma_strides(torch.empty(1, 1, 5, 2 * D)[..., :D])
    assert sliced == [5 * D, 5 * D, 2 * D]


@pytest.mark.parametrize("grad", sorted(lo_half_study.LO_PRODUCTS))
def test_lo_half_study_takes_out_one_product(grad):
    """The precision study's variants: each lo-half product is one line of
    its kernel's source, and taking it out leaves the rest as it is."""
    name, line = lo_half_study.LO_PRODUCTS[grad]
    source = (_build.CSRC / _build.SOURCES[name]).read_text()
    variant = lo_half_study.without_line(name, line)
    assert line in source and line not in variant
    assert len(source.splitlines()) - len(variant.splitlines()) == 1
    with pytest.raises(ValueError):
        lo_half_study.without_line(name, "no such line")


@pytest.mark.parametrize("variant", sorted(flash_fwd_study.VARIANTS))
def test_forward_study_sets_only_its_constants(variant):
    """Each variant of the forward design study is the kernel's source with
    the named constants of its bf16 section set, and nothing else changed;
    a constant the source does not set once raises."""
    values = flash_fwd_study.VARIANTS[variant]
    source = (_build.CSRC / _build.SOURCES["flash_fwd"]).read_text()
    got = flash_fwd_study.with_constants(values)
    changed = [(a, b) for a, b in zip(source.splitlines(), got.splitlines())
               if a != b]
    assert len(changed) == len(values)
    for const, value in values.items():
        assert f"constexpr int {const} = {value};" in got
    with pytest.raises(ValueError):
        flash_fwd_study.with_constants({"kNoSuchConstant": 1})

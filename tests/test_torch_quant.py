"""The port's dynamic int8 GEMMs (``clip_finegrained_alignment_tpu_torch/
ops/quant.py``) against the JAX package's ``ops/quant.py``.

On the CPU the quantize and dequantize passes are the plain versions and
the product ``torch._int_mm``, so the port's ``int8_matmul``,
``quant_matmul`` (output, dx, dW; both modes; fp32 and bf16) and
``quant_linear`` are bit-equal to JAX's (dW transposed to the port's
[N, K] layout): the int32 sums are exact and the fp32 scale products
commute. The one exception is switchback's exact wgrad, a float product
whose sums the two frameworks take in other orders: in fp32 it is held
within 1e-6 of Σ_m |x[m,k]·g[m,n]|, the scale of a sum's rounding error
(readings ~4e-7 at [394, 768]; an element that cancels can differ by far
more than 1e-6 of itself), and in bf16 within one bf16 step.

Also here: JAX's ``tests/test_quant.py`` cases re-run on the port, the
zero-padded contraction of the int8 wgrad, zero rows, the refusal of an
invalid mode, the CUDA branch's launches and ``_int_mm`` shape rules
(through monkeypatched launchers), what each launcher hands its C entry,
and the model's linears picked by ``quant``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_finegrained_alignment_tpu.ops import quant as jq
from clip_finegrained_alignment_tpu_torch.config import CLIPConfig, TrainConfig
from clip_finegrained_alignment_tpu_torch.models import clip as tm
from clip_finegrained_alignment_tpu_torch.models.convert import (
    random_params, state_dict_from_jax)
from clip_finegrained_alignment_tpu_torch.ops import _build
from clip_finegrained_alignment_tpu_torch.ops import quant as tq

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(394, 768, 768), (200, 3072, 768), (37, 24, 20)]


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    return x, w, g


# ---------------------------------------------------------------------------
# JAX's tests/test_quant.py, on the port
# ---------------------------------------------------------------------------

def _grid_exact(rng, m, k, scale_rows=True):
    x = rng.integers(-127, 128, size=(m, k)).astype(np.float32)
    if scale_rows:
        x[:, 0] = 127.0
    else:
        x[0, :] = 127.0
    return x


def test_int8_matmul_exact_on_grid_inputs():
    rng = np.random.default_rng(0)
    x = _grid_exact(rng, 16, 32, scale_rows=True)
    w = _grid_exact(rng, 32, 8, scale_rows=False)
    y = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(y.numpy(), x @ w)


def test_int8_matmul_error_bounded_on_random_inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    w = rng.normal(size=(96, 48)).astype(np.float32)
    y = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    y, exact = y.numpy(), x @ w
    assert np.max(np.abs(y - exact)) < 0.05 * np.abs(exact).max()
    cos = (y * exact).sum() / (np.linalg.norm(y) * np.linalg.norm(exact))
    assert cos > 0.999


@pytest.mark.parametrize("mode", ["switchback", "int8"])
def test_quant_matmul_ste_gradients(mode):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 24)).astype(np.float32)
    w = rng.normal(size=(24, 16)).astype(np.float32)
    g = rng.normal(size=(32, 16)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    (tq.quant_matmul(tx, tw, mode) * torch.from_numpy(g)).sum().backward()
    dx, dw = tx.grad.numpy(), tw.grad.numpy().T
    dx_exact, dw_exact = g @ w.T, x.T @ g
    if mode == "switchback":
        np.testing.assert_allclose(dw, dw_exact, rtol=1e-6, atol=1e-5)
    else:
        assert np.max(np.abs(dw - dw_exact)) < 0.05 * np.abs(dw_exact).max()
    assert np.max(np.abs(dx - dx_exact)) < 0.05 * np.abs(dx_exact).max()


def test_quant_matmul_zero_rows_are_finite():
    x = torch.zeros(4, 8, requires_grad=True)
    w = torch.ones(4, 8, requires_grad=True)
    y = tq.quant_matmul(x, w, "int8")
    assert torch.all(y == 0)
    y.backward(torch.ones_like(y))
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


def test_quant_linear_shapes_bias_and_dtype():
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(12, 20)).astype(np.float32)
    bias = rng.normal(size=(20,)).astype(np.float32)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    y = tq.quant_linear(torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
                        torch.from_numpy(bias), torch.bfloat16, "switchback")
    assert y.shape == (2, 5, 20) and y.dtype == torch.bfloat16
    exact = x @ kernel + bias
    assert np.max(np.abs(_np(y) - exact)) < 0.08 * np.abs(exact).max() + 0.05


# ---------------------------------------------------------------------------
# The port against JAX, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_matmul_bit_equal_to_jax(M, K, N, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, _ = _operands(M + K, M, K, N)
    want = jq.int8_matmul(jnp.asarray(x).astype(jdt),
                          jnp.asarray(w).astype(jdt))
    got = tq.int8_matmul(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w.T.copy()).to(tdt))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["switchback", "int8"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_quant_matmul_matches_jax(M, K, N, dtype, mode):
    """Output, dx and dW bit-equal to JAX's ``quant_matmul`` and its VJP,
    but switchback's exact dW (the module docstring's tolerance)."""
    jdt, tdt = DTYPES[dtype]
    x, w, g = _operands(M * K + N, M, K, N)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    out, vjp = jax.vjp(lambda a, b: jq.quant_matmul(a, b, mode), jx, jw)
    dx, dw = vjp(jnp.asarray(g).astype(jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).to(tdt).requires_grad_()
    y = tq.quant_matmul(tx, tw, mode)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt and tw.grad.dtype == tdt
    np.testing.assert_array_equal(_np(y), _np(out))
    np.testing.assert_array_equal(_np(tx.grad), _np(dx))
    got_dw, want_dw = _np(tw.grad), _np(dw).T
    if mode == "int8":
        np.testing.assert_array_equal(got_dw, want_dw)
    elif dtype == "float32":
        terms = np.abs(g).T @ np.abs(x)          # Σ_m |g[m,n] x[m,k]|
        assert np.all(np.abs(got_dw - want_dw) <= 1e-6 * terms)
    else:
        step = np.spacing(np.abs(want_dw).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(got_dw - want_dw) <= step)


@pytest.mark.parametrize("mode", ["switchback", "int8"])
def test_quant_linear_matches_jax(mode):
    """3-D x, bias, bf16 compute from fp32 master weights: output bit-equal
    to JAX's ``quant_linear``, and the gradients of x, the weight and the
    bias through the casts."""
    rng = np.random.default_rng(4)
    K, N = 768, 3072
    x = rng.normal(size=(4, 50, K)).astype(np.float32)
    kernel = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32)
    g = rng.normal(size=(4, 50, N)).astype(np.float32)

    def jfn(x, k, b):
        return jq.quant_linear({"kernel": k, "bias": b}, x, jnp.bfloat16, mode)

    out, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(kernel),
                       jnp.asarray(bias))
    dx, dk, _ = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(kernel.T.copy()).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y = tq.quant_linear(tx, tw, tb, torch.bfloat16, mode)
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert y.shape == (4, 50, N) and y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(y), _np(out))
    np.testing.assert_array_equal(_np(tx.grad), _np(dx))
    assert tw.grad.dtype == torch.float32 and tb.grad.dtype == torch.float32
    # The bias's gradient: Σ over the 200 rows of the bf16 cotangent. XLA
    # sums it in bf16 (JAX's db reads up to 0.5 off at |db| ~ 4); torch
    # sums in fp32 and rounds once, as the port's exact path does for
    # every bias: within one bf16 step of the float64 sum.
    exact = _np(torch.from_numpy(g).to(torch.bfloat16)).astype(
        np.float64).reshape(-1, N).sum(0)
    step = np.spacing(np.abs(exact).astype(np.float32)) * 2 ** 16
    assert np.all(np.abs(_np(tb.grad) - exact) <= step)
    if mode == "int8":
        np.testing.assert_array_equal(_np(tw.grad), _np(dk).T)
    else:
        step = np.spacing(np.abs(_np(dk).T).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(_np(tw.grad) - _np(dk).T) <= step)


@pytest.mark.parametrize("M", [197 * 3, 77 * 5, 13, 1])
def test_int8_wgrad_pads_the_contraction_exactly(M):
    """quant_cols_t writes zero rows up to a multiple of 8 along M; the
    int8 wgrad over the padded M is JAX's ``int8_matmul(x.T, g)``
    transposed, bit for bit, whatever M is."""
    x, _, g = _operands(M, M, 40, 24)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    qt, s = tq.quant_cols_t(tx)
    assert qt.shape == (40, tq.round_up(M)) and s.shape == (40,)
    assert not qt[:, M:].any()
    q_rows, s_rows = tq.quant_rows(tx.t().contiguous())
    assert torch.equal(qt[:, :M], q_rows) and torch.equal(s, s_rows)
    want = jq.int8_matmul(jnp.asarray(x).T, jnp.asarray(g))
    got = tq._wgrad_int8(tg, tx, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)


def test_zero_rows_and_columns_quantize_to_zero():
    x = torch.randn(24, 16)
    x[3] = 0.0
    x[:, 5] = 0.0
    q, s = tq.quant_rows(x)
    assert not q[3].any()
    assert s[3].item() == np.float32(1e-12) / np.float32(127)
    qt, sc = tq.quant_cols_t(x)
    assert not qt[5].any() and torch.isfinite(sc).all()
    y = tq.dequant(torch._int_mm(q, q.t()), s, s, None, torch.float32)
    assert torch.isfinite(y).all() and not y[3].any()


def test_invalid_modes_raise():
    x, w = torch.randn(20, 8), torch.randn(8, 8)
    for bad in ("none", "fp8", ""):
        with pytest.raises(ValueError, match="invalid quant mode"):
            tq.quant_matmul(x, w, bad)
        with pytest.raises(ValueError, match="invalid quant mode"):
            tq.quant_linear(x, w, None, torch.float32, bad)
    with pytest.raises(ValueError, match="invalid quant"):
        TrainConfig(quant="fp8")
    with pytest.raises(ValueError, match="invalid quant mode"):
        tm._linear_fn("int4")(x, w, None, torch.float32)
    assert tm._linear_fn("none") is tm.linear
    assert TrainConfig.from_dict(TrainConfig(quant="int8").to_dict()).quant \
        == "int8"


# ---------------------------------------------------------------------------
# The CUDA branch, through launchers that run the plain versions
# ---------------------------------------------------------------------------

def _cuda_branch(monkeypatch):
    """Route quant.py's CUDA branch on CPU tensors: the launchers become
    the plain versions, each counting a launch as the real ones do."""
    monkeypatch.setattr(tq, "_device_kind", lambda t: "cuda")

    def counted(name, fn):
        def run(*args):
            _build.LAUNCHES[name].add()
            return fn(*args)
        return run

    monkeypatch.setattr(tq, "_launch_quant_rows",
                        counted(tq.ROWS_KERNEL, tq.quant_rows_reference))
    monkeypatch.setattr(tq, "_launch_quant_cols_t",
                        counted(tq.COLS_KERNEL, tq.quant_cols_t_reference))
    monkeypatch.setattr(tq, "_launch_dequant",
                        counted(tq.DEQUANT_KERNEL, tq.dequant_reference))
    for name in tq.SPLIT_KERNELS:
        monkeypatch.setattr(tq, f"_launch_{name}",
                            counted(name, getattr(tq, f"{name}_reference")))


QUANT_KERNELS = (tq.ROWS_KERNEL, tq.COLS_KERNEL, tq.DEQUANT_KERNEL)


def _counts():
    c = _build.launch_counts()
    return tuple(c[n] for n in QUANT_KERNELS)


@pytest.mark.parametrize("x_grad", [True, False])
@pytest.mark.parametrize("mode", ["switchback", "int8"])
def test_cuda_branch_launches_each_pass_once(mode, x_grad, monkeypatch):
    """Forward: x and W by rows, one dequant (the bias inside it). dgrad,
    only when x needs a gradient: g by rows, W by columns, one dequant.
    int8 wgrad: x and g by columns, one dequant; switchback's is a float
    product. Results equal the CPU branch's."""
    _cuda_branch(monkeypatch)
    x, w, g = _operands(5, 40, 32, 24)
    tx = torch.from_numpy(x).requires_grad_(x_grad)
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    tb = torch.zeros(24, requires_grad=True)
    _build.reset_launch_counts()
    y = tq.quant_linear(tx, tw, tb, torch.float32, mode)
    assert _counts() == (2, 0, 1)
    y.backward(torch.from_numpy(g))
    want = [2 + x_grad, x_grad + 2 * (mode == "int8"),
            1 + x_grad + (mode == "int8")]
    assert list(_counts()) == want
    monkeypatch.setattr(tq, "_device_kind", lambda t: t.device.type)
    tx2 = torch.from_numpy(x).requires_grad_(x_grad)
    tw2 = torch.from_numpy(w.T.copy()).requires_grad_()
    tq.quant_linear(tx2, tw2, None, torch.float32, mode).backward(
        torch.from_numpy(g))
    assert torch.equal(tw.grad, tw2.grad)
    assert not x_grad or torch.equal(tx.grad, tx2.grad)
    assert torch.equal(tb.grad, torch.from_numpy(g).sum(0))


@pytest.mark.parametrize("shape", [(16, 32, 24), (40, 36, 24),
                                   (40, 32, 20)])
def test_cuda_branch_refuses_int_mm_shapes(shape, monkeypatch):
    """On the card ``_int_mm`` wants M > 16 and K, N multiples of 8: the
    port raises ValueError before calling it."""
    _cuda_branch(monkeypatch)
    M, K, N = shape
    with pytest.raises(ValueError, match="_int_mm on the card"):
        tq.int8_matmul(torch.randn(M, K), torch.randn(N, K))


def test_model_linears_follow_quant(monkeypatch):
    """``clip_forward`` on the CUDA branch: every encoder projection and the
    patch embedding quantized (two quant_rows and one dequant each), the
    loss-facing projections exact; backward: dgrad for all but the patch
    embedding, wgrad for all. ``quant="none"`` launches none."""
    cfg = CLIPConfig.tiny_test()
    model = tm.build_train_model(
        cfg, state_dict_from_jax(random_params(cfg, 0), cfg), device="cpu")
    rng = np.random.default_rng(0)
    pix = torch.from_numpy(rng.normal(size=(3, 32, 32, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, 250, size=(3, 16)))
    _cuda_branch(monkeypatch)
    _build.reset_launch_counts()
    tm.clip_forward(model, pix, ids, quant="none")
    assert _counts() == (0, 0, 0)
    layers = cfg.vision.num_layers + cfg.text.num_layers
    linears = 6 * layers + 1
    for mode in ("switchback", "int8"):
        _build.reset_launch_counts()
        out = tm.clip_forward(model, pix, ids, quant=mode)
        assert _counts() == (2 * linears, 0, linears)
        (out.image_embeds.sum() + out.text_embeds.sum()).backward()
        int8 = mode == "int8"
        assert _counts() == (
            2 * linears + (linears - 1),
            (linears - 1) + 2 * linears * int8,
            linears + (linears - 1) + linears * int8)


def test_launchers_hand_the_c_entries_their_operands(monkeypatch):
    """Each launcher hands its C entry the pointers, shapes, dtype code (0
    fp32, 1 bf16) and stream, allocates the outputs (quant_cols_t: [C,
    R_pad] and ceil(R / COL_CHUNK) partial rows) and counts one launch."""
    calls = {}

    class Entry:
        argtypes = restype = None

        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls[self.name] = args
            return 0

    lib = type("Lib", (), {f"cfa_{n}": Entry(n) for n in QUANT_KERNELS})()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("Stream", (), {"cuda_stream": 7})())
    _build.reset_launch_counts()
    x = torch.randn(300, 40).to(torch.bfloat16)
    q, s = tq._launch_quant_rows(x)
    args = calls["quant_rows"]
    assert args == (x.data_ptr(), q.data_ptr(), s.data_ptr(), 300, 40, 1, 7)
    assert q.dtype == torch.int8 and s.shape == (300,)
    qt, sc = tq._launch_quant_cols_t(x.float())
    args = calls["quant_cols_t"]
    assert qt.shape == (40, 304) and sc.shape == (40,)
    assert args[1:3] == (qt.data_ptr(), sc.data_ptr())
    assert args[4:] == (300, 40, 304, tq.COL_CHUNK, 0, 7)
    acc = torch.zeros(300, 40, dtype=torch.int32)
    bias = torch.zeros(40)
    y = tq._launch_dequant(acc, s, sc, bias, torch.bfloat16)
    args = calls["dequant"]
    assert args[0] == acc.data_ptr() and args[3] is not None
    assert args[4:] == (y.data_ptr(), 300, 40, 1, 7)
    assert y.dtype == torch.bfloat16 and y.shape == (300, 40)
    assert _counts() == (1, 1, 1)
    with pytest.raises(ValueError):
        tq._launch_quant_rows(torch.randn(4, 4).half())
    with pytest.raises(ValueError):
        tq._launch_dequant(acc.float(), s, sc, None, torch.float32)
    assert _counts() == (1, 1, 1)


def test_split_launchers_hand_the_c_entries_their_operands(monkeypatch):
    """The split passes' launchers: the absmax entries write an fp32
    vector (the column one with ceil(R / COL_CHUNK) partial rows, none for
    one chunk), the quantize entries take the absmax and write what the
    fused ones write; each counts one launch and refuses an absmax of the
    wrong length or type before building anything."""
    calls = {}

    class Entry:
        argtypes = restype = None

        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            calls[self.name] = args
            return 0

    lib = type("Lib", (), {f"cfa_{n}": Entry(n)
                           for n in tq.SPLIT_KERNELS})()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("Stream", (), {"cuda_stream": 7})())
    _build.reset_launch_counts()
    x = torch.randn(300, 40).to(torch.bfloat16)
    a = tq._launch_absmax_rows(x)
    assert calls["absmax_rows"] == (x.data_ptr(), a.data_ptr(), 300, 40, 1,
                                    7)
    assert a.shape == (300,) and a.dtype == torch.float32
    ac = tq._launch_absmax_cols(x.float())
    args = calls["absmax_cols"]
    assert args[1] == ac.data_ptr() and args[2] is not None
    assert args[3:] == (300, 40, tq.COL_CHUNK, 0, 7) and ac.shape == (40,)
    tq._launch_absmax_cols(x[:tq.COL_CHUNK])
    assert calls["absmax_cols"][2] is None     # one chunk: no partials
    q, sc = tq._launch_quant_rows_given(x, a)
    assert calls["quant_rows_given"] == (x.data_ptr(), a.data_ptr(),
                                         q.data_ptr(), sc.data_ptr(), 300,
                                         40, 1, 7)
    assert q.shape == (300, 40) and sc.shape == (300,)
    qt, sc = tq._launch_quant_cols_t_given(x, ac)
    args = calls["quant_cols_t_given"]
    assert args[:4] == (x.data_ptr(), ac.data_ptr(), qt.data_ptr(),
                        sc.data_ptr())
    assert args[4:] == (300, 40, 304, 1, 7) and qt.shape == (40, 304)
    counts = _build.launch_counts()
    assert [counts[n] for n in tq.SPLIT_KERNELS] == [1, 2, 1, 1]
    for name in tq.SPLIT_KERNELS:
        entry = getattr(lib, f"cfa_{name}")
        assert len(entry.argtypes) == len(calls[name]), name
    for bad in (a[:40].double(), a):       # wrong type; wrong length
        with pytest.raises(ValueError, match="absmax"):
            tq._launch_quant_cols_t_given(x, bad)
    with pytest.raises(ValueError, match="absmax"):
        tq._launch_quant_rows_given(x, ac)
    assert [counts[n] for n in tq.SPLIT_KERNELS] == [1, 2, 1, 1]


# ---------------------------------------------------------------------------
# A dimension split over ranks: the split passes and the groups
# ---------------------------------------------------------------------------

def _nasty(seed, R, C, dtype):
    """[R, C] of ``dtype``: normal values, a zero row and a zero column,
    a row holding a NaN and a column holding an inf."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(R, C)).astype(np.float32) * 3).to(dtype)
    x[R // 2] = 0
    x[:, C // 3] = 0
    x[R // 3, 1] = float("nan")
    x[R - 1, C - 1] = float("inf")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(394, 768), (37, 24), (300, 13), (1, 8)])
def test_split_passes_equal_the_fused_ones(R, C, dtype):
    """Reduce, then quantize with the absmax given: bit for bit the fused
    pass (int8 values and scales; NaN and inf rows and columns as the
    fused pass leaves them), and the absmax vectors are those the fused
    passes' scales come from."""
    x = _nasty(R + C, R, C, dtype)
    ar, ac = tq.absmax_rows(x), tq.absmax_cols(x)
    for (q1, s1), (q2, s2) in (
            (tq.quant_rows(x), tq.quant_rows_given(x, ar)),
            (tq.quant_cols_t(x), tq.quant_cols_t_given(x, ac))):
        assert torch.equal(q1, q2)
        assert torch.equal(s1, s2) or (
            torch.equal(s1.isnan(), s2.isnan())
            and torch.equal(s1.nan_to_num(), s2.nan_to_num()))
    want = torch.maximum(ar, torch.full_like(ar, tq.SCALE_FLOOR))
    got = tq.quant_rows(x)[1] * tq.QMAX
    assert torch.allclose(got, want, rtol=1e-6, equal_nan=True)


class _ThreadGroup:
    """A process group of ``n`` threads in one process (``rank`` set per
    thread) for :class:`_ThreadDist`."""

    def __init__(self, n):
        import threading
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n
        self.local = threading.local()
        self.calls = []


class _ThreadDist:
    """The few ``torch.distributed`` calls ``parallel/collectives.py``
    makes for the int8 products, over a :class:`_ThreadGroup`: all_reduce
    SUM and MAX, elementwise over the threads' tensors of one dtype."""

    class ReduceOp:
        SUM, MAX = "sum", "max"

    @staticmethod
    def get_backend(group=None):
        return "gloo"

    @staticmethod
    def get_world_size(group=None):
        return group.n

    @staticmethod
    def all_reduce(t, op, group):
        rank = group.local.rank
        group.slots[rank] = t.clone()
        if rank == 0:
            group.calls.append((op, t.dtype, tuple(t.shape)))
        group.barrier.wait()
        stack = torch.stack(group.slots)
        out = stack.amax(0) if op == "max" else stack.sum(0)
        group.barrier.wait()
        t.copy_(out)


def _on_threads(monkeypatch, n, fn):
    """``fn(rank, group)`` on n threads sharing one :class:`_ThreadGroup`;
    their results by rank."""
    import threading
    from clip_finegrained_alignment_tpu_torch.parallel import collectives
    monkeypatch.setattr(collectives, "dist", _ThreadDist)
    group, out, errors = _ThreadGroup(n), [None] * n, []

    def run(rank):
        group.local.rank = rank
        try:
            out[rank] = fn(rank, group)
        except BaseException as e:       # re-raised below
            errors.append(e)
            group.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, group


def _linear_grads(x, w, b, g, dtype, mode, groups=tq.LOCAL):
    x, w = (t.clone().requires_grad_() for t in (x, w))
    b = None if b is None else b.clone().requires_grad_()
    y = tq.quant_linear(x, w, b, dtype, mode, groups)
    y.backward(g)
    return y.detach(), x.grad, w.grad, None if b is None else b.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_products_with_global_scales_are_the_whole_one(dtype,
                                                             monkeypatch):
    """A product split in two over a group of two threads
    (``parallel/collectives.py`` on a stand-in for ``torch.distributed``),
    as tensor parallelism splits it: the row-parallel forward (K split;
    both operands' absmax MAXed, the int32 sums summed, the bias added
    once) and the column-parallel dgrad (N split) equal the one-process
    product bit for bit, with one MAX all-reduce (both operands' absmax
    in one int32 vector) and one int32 SUM each; the int8 wgrad over rows
    split in two (global negatives) takes the whole rows' scales, so the
    ranks' dW sum to the whole dW within fp32 rounding. With every scale
    local, none of the three holds."""
    M, K, N = 64, 48, 40
    rng = np.random.default_rng(0)
    x, w, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((M, K), (N, K), (M, N)))
    b = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    g = g.to(dtype)
    y, dx, dw, db = _linear_grads(x, w, b, g, dtype, "int8")

    def row_parallel(local):
        def run(rank, group):
            part = slice(rank * K // 2, (rank + 1) * K // 2)
            return _linear_grads(x[:, part], w[:, part], b, g, dtype,
                                 "int8", tq.Groups(k=None if local
                                                   else group))
        return _on_threads(monkeypatch, 2, run)

    (r0, r1), group = row_parallel(False)
    assert torch.equal(r0[0], y) and torch.equal(r1[0], y)
    assert torch.equal(torch.cat([r0[1], r1[1]], 1), dx)
    assert group.calls[:2] == [("max", torch.int32, (M + N,)),
                               ("sum", torch.int32, (M, N))]
    (l0, l1), _ = row_parallel(True)
    assert not torch.equal((l0[0].float() + l1[0].float() - b).to(dtype), y)

    def column_parallel(local):
        def run(rank, group):
            part = slice(rank * N // 2, (rank + 1) * N // 2)
            return _linear_grads(x, w[part], b[part], g[:, part], dtype,
                                 "int8", tq.Groups(n=None if local
                                                   else group))
        return _on_threads(monkeypatch, 2, run)

    (c0, c1), group = column_parallel(False)
    assert torch.equal(torch.cat([c0[0], c1[0]], 1), y)
    assert torch.equal(c0[1], dx) and torch.equal(c1[1], dx)
    assert torch.equal(torch.cat([c0[2], c1[2]]), dw)
    assert group.calls == [("max", torch.int32, (M + K,)),
                           ("sum", torch.int32, (M, K))]
    (k0, k1), _ = column_parallel(True)
    assert not torch.equal((k0[1].float() + k1[1].float()).to(dtype), dx)

    def rows_split(local):
        def run(rank, group):
            part = slice(rank * M // 2, (rank + 1) * M // 2)
            return _linear_grads(x[part], w, b, g[part], dtype, "int8",
                                 tq.Groups(m=None if local else group))
        return _on_threads(monkeypatch, 2, run)

    (m0, m1), group = rows_split(False)
    assert group.calls == [("max", torch.int32, (N + K,))]
    ag, ax = (tq.absmax_cols(t.to(dtype)) for t in (g, x))
    for rank, (m_dw, n_dw) in enumerate(zip(
            (m0[2], m1[2]), (r[2] for r in rows_split(True)[0]))):
        part = slice(rank * M // 2, (rank + 1) * M // 2)
        gqt, sg = tq.quant_cols_t_given(g[part], ag)
        xqt, sx = tq.quant_cols_t_given(x[part].to(dtype), ax)
        want = tq.dequant(tq.int_mm(gqt, xqt.t()), sg, sx, None,
                          dtype).float()
        assert torch.equal(m_dw, want), rank
        assert not torch.equal(n_dw, want), rank
    if dtype == torch.float32:
        assert (m0[2] + m1[2] - dw).abs().max() <= 1e-6 * dw.abs().max()


def test_absmax_all_reduce_keeps_a_nan_and_every_value(monkeypatch):
    """``all_reduce_absmax``'s MAX on the bits: a NaN on any rank is a NaN
    on every rank, +inf beats every finite value, and finite values come
    back bit for bit as the larger one."""
    from clip_finegrained_alignment_tpu_torch.parallel.collectives import \
        all_reduce_absmax
    a = [torch.tensor([0.0, 1.5, float("nan"), 3.0, float("inf"), 1e-30]),
         torch.tensor([2.0, 1.25, 5.0, float("nan"), 7.0, 2e-30])]
    b = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 0.5])]
    out, _ = _on_threads(monkeypatch, 2,
                         lambda r, grp: all_reduce_absmax([a[r], b[r]], grp))
    for got_a, got_b in out:
        assert got_a[:2].tolist() == [2.0, 1.5]
        assert got_a[2].isnan() and got_a[3].isnan()
        assert got_a[4] == float("inf")
        assert got_a[5] == torch.tensor(2e-30)
        assert got_b.tolist() == [3.0, 2.0]


def test_split_path_launches_the_split_passes(monkeypatch):
    """On the CUDA branch a split dimension takes the split passes in
    place of the fused ones: a row-parallel int8 linear's forward two
    absmax_rows and two quant_rows_given, its dgrad (local) the fused
    passes, its int8 wgrad over split rows two absmax_cols and two
    quant_cols_t_given; one dequant each product."""
    _cuda_branch(monkeypatch)
    x, w, g = _operands(5, 40, 32, 24)

    def run(rank, group):
        _build.reset_launch_counts()
        tq.quant_linear(torch.from_numpy(x).requires_grad_(),
                        torch.from_numpy(w.T.copy()).requires_grad_(),
                        None, torch.float32, "int8",
                        tq.Groups(k=group, m=group)).backward(
            torch.from_numpy(g))
        return _build.launch_counts()
    counts, _ = _on_threads(monkeypatch, 1, run)
    c = counts[0]
    assert [c[n] for n in tq.SPLIT_KERNELS] == [2, 2, 2, 2]
    assert _counts_of(c) == (1, 1, 3)


def _counts_of(c):
    return tuple(c[n] for n in QUANT_KERNELS)


def test_microbenchmark_runs_on_the_cpu(capsys):
    """perf/int8_microbench.py at a small size with the plain versions: a
    row for each GEMM-set variant and each kernel, the bytes each kernel
    must move (operand read once, outputs written once)."""
    from clip_finegrained_alignment_tpu_torch.perf import int8_microbench

    out = int8_microbench.main(["--device", "cpu", "--m", "40", "--d", "16",
                                "--f", "32", "--reps", "1"])
    assert sorted(out["gemm_set"]) == sorted(
        ["fwd_bf16", "fwd_int8", "fwd_int8_static", "bwd_none",
         "bwd_switchback", "bwd_int8"])
    assert all(r["ms"] > 0 for r in out["gemm_set"].values())
    assert [r["kernel"] for r in out["kernels"]] == \
        ["quant_rows"] * 3 + ["quant_cols_t"] * 3 + ["dequant"] * 2
    assert out["kernels"][0]["bytes"] == 40 * 16 * 3 + 4 * 40
    assert out["kernels"][3]["bytes"] == 40 * 16 * 2 + 16 * 40 + 4 * 16
    assert out["kernels"][6]["bytes"] == 40 * 16 * 6 + 4 * 56 + 2 * 16
    assert "fwd_int8_static" in capsys.readouterr().out

"""Dynamic int8 quantized matmul, the port of
``clip_finegrained_alignment_tpu/ops/quant.py``: SwitchBack's recipe
(Wortsman et al., arXiv:2304.13013, int8 linear layers written for CLIP
training) on the card's int8 tensor cores.

Per-row (per-example) absmax scales for activations, per-output-feature
scales for weights, round to nearest even, and a straight-through
estimator around the rounding. Modes:

* ``switchback``: int8 forward and input gradient (dgrad); the weight
  gradient (wgrad) is the exact product in the compute dtype;
* ``int8``: all three products int8, the wgrad quantized over the example
  axis on both operands;
* ``none``: the exact path (``models/clip.py::linear``).

Weights are in the port's ``[N, K]`` (out, in) layout, HF ``nn.Linear``'s,
where JAX's kernel is ``[K, N]``: JAX's per-column scales of the kernel
are per-row scales of ``W``; the dgrad's ``w.T`` is ``W`` itself, with
per-column scales; the wgrad returns ``dW = dwᵀ``,
``Σ_m gq[m,n]·xq[m,k] · (sg[n]·sx[k])``. The int32 sums are exact and an
fp32 product commutes, so every int8 result is bit-equal to JAX's
(transposed).

The three passes around the product (``quant_rows``, ``quant_cols_t``,
``dequant``) are hand-written kernels (``csrc/quant.cu``) on CUDA tensors
and their plain versions here on CPU tensors; the product itself is
``torch._int_mm`` on both (cuBLASLt's int8 GEMM on the card), as the JAX
package leaves it to XLA's ``dot_general``. ``quant_cols_t`` writes the
per-column quantization transposed and zero-padded to a multiple of 8
along the contraction axis, so the second operand of every ``_int_mm`` is
column-major (cuBLASLt int8's "TN" layout, no copy) and the wgrad's
contraction over M = B·S meets ``_int_mm``'s rule; zero rows change no
absmax and add nothing to a sum. On the card ``_int_mm`` also wants M > 16
and K, N multiples of 8: other shapes raise ``ValueError`` there (none
occurs at the model's widths).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MODES = ("none", "switchback", "int8")

ROWS_KERNEL = "quant_rows"
COLS_KERNEL = "quant_cols_t"
DEQUANT_KERNEL = "dequant"

SCALE_FLOOR = 1e-12     # all-zero rows quantize to zeros, not NaN
QMAX = 127.0
PAD = 8                 # _int_mm's multiple on the card
COL_CHUNK = 256         # rows a partial column absmax covers (quant.cu)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path; chip_smoke.py holds the kernels to them)
# ---------------------------------------------------------------------------

def _absmax_quant(x: torch.Tensor, dim: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along ``dim`` of a 2-D tensor:
    (q int8, scale fp32) with q·scale ≈ x; the scale keeps ``dim`` as size
    1 for broadcasting."""
    xf = x.float()
    a = xf.abs().amax(dim, keepdim=True).clamp_min(SCALE_FLOOR)
    # Divided by a tensor, not the Python scalar: on the card torch divides
    # by a scalar as a multiply by its reciprocal, which is not IEEE
    # division (the kernels' and JAX's op-by-op).
    s = a / torch.full_like(a, QMAX)
    return torch.round(xf / s).to(torch.int8), s


def round_up(n: int, m: int = PAD) -> int:
    return -(-n // m) * m


def quant_rows_reference(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] → (int8 [R, C], fp32 scales [R]): one scale a row."""
    q, s = _absmax_quant(x, 1)
    return q, s[:, 0]


def quant_cols_t_reference(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] → (int8 [C, round_up(R, 8)], fp32 scales [C]): one scale a
    column, the quantized columns written as rows, zeros past R."""
    q, s = _absmax_quant(x, 0)
    R, C = x.shape
    qt = torch.zeros((C, round_up(R)), dtype=torch.int8, device=x.device)
    qt[:, :R] = q.t()
    return qt, s[0]


def dequant_reference(acc: torch.Tensor, s_row: torch.Tensor,
                      s_col: torch.Tensor, bias: Optional[torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    """int32 [R, C] · (s_row ⊗ s_col) in fp32, cast to ``dtype``, then
    + bias cast to ``dtype``."""
    y = (acc.float() * (s_row[:, None] * s_col[None, :])).to(dtype)
    if bias is not None:
        y = y + bias.to(dtype)
    return y


# ---------------------------------------------------------------------------
# The kernels (csrc/quant.cu)
# ---------------------------------------------------------------------------

def _check_operand(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"{what} must be a non-empty 2-D tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"{what} on the card must be one of "
                         f"{SUPPORTED_DTYPES}, got {x.dtype}")
    return x.contiguous()


def _dtype_code(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def _entry(name: str, argtypes):
    fn = getattr(_build.load(name), f"cfa_{name}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err} "
                           "(-1: a shape it does not take)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_quant_rows(x: torch.Tensor):
    x = _check_operand(x, "quant_rows input")
    R, C = x.shape
    fn = _entry(ROWS_KERNEL, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C,
                 _dtype_code(x.dtype), _stream(x))
    _raise_on(err, ROWS_KERNEL)
    _build.LAUNCHES[ROWS_KERNEL].add()
    return q, s


def _launch_quant_cols_t(x: torch.Tensor):
    x = _check_operand(x, "quant_cols_t input")
    R, C = x.shape
    fn = _entry(COLS_KERNEL, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
    qt = torch.empty((C, round_up(R)), dtype=torch.int8, device=x.device)
    s = torch.empty((C,), dtype=torch.float32, device=x.device)
    partial = torch.empty((-(-R // COL_CHUNK), C), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), qt.data_ptr(), s.data_ptr(),
                 partial.data_ptr(), R, C, qt.shape[1], COL_CHUNK,
                 _dtype_code(x.dtype), _stream(x))
    _raise_on(err, COLS_KERNEL)
    _build.LAUNCHES[COLS_KERNEL].add()
    return qt, s


def _launch_dequant(acc, s_row, s_col, bias, dtype):
    R, C = acc.shape
    if acc.dtype != torch.int32 or not acc.is_contiguous():
        raise ValueError("dequant takes contiguous int32 sums")
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"dequant on the card writes one of "
                         f"{SUPPORTED_DTYPES}, not {dtype}")
    if s_row.shape != (R,) or s_col.shape != (C,) \
            or s_row.dtype != torch.float32 or s_col.dtype != torch.float32:
        raise ValueError(f"dequant of [{R}, {C}] needs fp32 scales [{R}] "
                         f"and [{C}]")
    if bias is not None:
        if bias.shape != (C,):
            raise ValueError(f"dequant bias must be [{C}], got "
                             f"{tuple(bias.shape)}")
        bias = bias.to(dtype).contiguous()
    fn = _entry(DEQUANT_KERNEL, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    y = torch.empty((R, C), dtype=dtype, device=acc.device)
    s_row, s_col = s_row.contiguous(), s_col.contiguous()
    with torch.cuda.device(acc.device):
        err = fn(acc.data_ptr(), s_row.data_ptr(), s_col.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 R, C, _dtype_code(dtype), _stream(acc))
    _raise_on(err, DEQUANT_KERNEL)
    _build.LAUNCHES[DEQUANT_KERNEL].add()
    return y


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] → (int8 [R, C], fp32 scales [R]). CUDA: ``cfa_quant_rows``;
    CPU: :func:`quant_rows_reference`."""
    kind = _device_kind(x)
    if kind == "cuda":
        return _launch_quant_rows(x)
    if kind == "cpu":
        return quant_rows_reference(x)
    raise ValueError(f"no int8 quantization for device {x.device}")


def quant_cols_t(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] → (int8 [C, round_up(R, 8)], fp32 scales [C]). CUDA:
    ``cfa_quant_cols_t``; CPU: :func:`quant_cols_t_reference`."""
    kind = _device_kind(x)
    if kind == "cuda":
        return _launch_quant_cols_t(x)
    if kind == "cpu":
        return quant_cols_t_reference(x)
    raise ValueError(f"no int8 quantization for device {x.device}")


def dequant(acc: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor,
            bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int32 [R, C] → ``dtype`` [R, C], + bias. CUDA: ``cfa_dequant``;
    CPU: :func:`dequant_reference`."""
    kind = _device_kind(acc)
    if kind == "cuda":
        return _launch_dequant(acc, s_row, s_col, bias, dtype)
    if kind == "cpu":
        return dequant_reference(acc, s_row, s_col, bias, dtype)
    raise ValueError(f"no int8 dequantization for device {acc.device}")


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] → int32 [M, N] by ``torch._int_mm``; on
    the card its shape rules are checked first (M > 16, K and N multiples
    of 8) and raise ``ValueError``."""
    M, K = a.shape
    N = b.shape[1]
    if _device_kind(a) == "cuda" and (M <= 16 or K % PAD or N % PAD):
        raise ValueError(
            f"torch._int_mm on the card needs M > 16 and K, N multiples of "
            f"{PAD}; got [{M}, {K}] @ [{K}, {N}]")
    return torch._int_mm(a, b)


# ---------------------------------------------------------------------------
# The three products and their autograd Function
# ---------------------------------------------------------------------------

def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, K] @ Wᵀ for W [N, K] through dynamic int8: per-row scales of
    x, per-row (output-feature) scales of W; ``(xq @ wqᵀ) · (sx · sw)`` in
    fp32, cast to ``dtype``, + bias. With the defaults it is JAX's
    ``int8_matmul(x, W.T)``."""
    xq, sx = quant_rows(x)
    wq, sw = quant_rows(w)
    return dequant(int_mm(xq, wq.t()), sx, sw, bias, dtype)


def _dgrad(g: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """dx [M, K] = g [M, N] @ W [N, K]: per-row scales of g, per-column
    scales of W (JAX's ``int8_matmul(g, w.T)``)."""
    gq, sg = quant_rows(g)
    wqt, sk = quant_cols_t(w)
    N = w.shape[0]
    return dequant(int_mm(gq, wqt[:, :N].t()), sg, sk, None, dtype)


def _wgrad_int8(g: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """dW [N, K] = gᵀ x over M, both quantized over M (JAX's
    ``int8_matmul(x.T, g)``, transposed); M zero-padded to a multiple
    of 8."""
    gqt, sg = quant_cols_t(g)
    xqt, sx = quant_cols_t(x)
    return dequant(int_mm(gqt, xqt.t()), sg, sx, None, dtype)


class QuantMatmul(torch.autograd.Function):
    """``int8_matmul`` forward (+ bias) with straight-through gradients:
    dgrad int8 in both modes; wgrad exact (``switchback``) or int8
    (``int8``); the bias's gradient is Σ_m g. Each gradient is computed
    only when its input needs one (the patch embedding's pixels do not),
    as XLA drops the unused products."""

    @staticmethod
    def forward(ctx, x, w, bias, mode):
        ctx.mode = mode
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, w)
        return int8_matmul(x, w, bias, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = g.contiguous()
        dx = _dgrad(g, w, x.dtype) if need_x else None
        dw = None
        if need_w:
            dw = (_wgrad_int8(g, x, w.dtype) if ctx.mode == "int8"
                  else (g.t() @ x).to(w.dtype))
        db = g.sum(0) if ctx.has_bias and need_b else None
        return dx, dw, db, None


def quant_matmul(x: torch.Tensor, w: torch.Tensor,
                 mode: str = "switchback") -> torch.Tensor:
    """Quantized ``x @ Wᵀ`` with straight-through gradients: x [M, K],
    W [N, K] → [M, N] in x's dtype; ``mode`` picks the backward."""
    if mode not in MODES[1:]:
        raise ValueError(f"invalid quant mode {mode!r} (switchback | int8)")
    return QuantMatmul.apply(x, w, None, mode)


def quant_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], dtype: torch.dtype,
                 mode: str) -> torch.Tensor:
    """Drop-in for ``models/clip.py::linear`` on the int8 path: x and the
    weight cast to ``dtype``, leading dims collapsed to one example axis,
    the quantized product, then the bias cast to ``dtype`` added in
    ``dtype`` (inside ``dequant``)."""
    if mode not in MODES[1:]:
        raise ValueError(f"invalid quant mode {mode!r} (switchback | int8)")
    x = x.to(dtype)
    shape = x.shape
    y = QuantMatmul.apply(x.reshape(-1, shape[-1]), weight.to(dtype),
                          None if bias is None else bias.to(dtype), mode)
    return y.reshape(shape[:-1] + (weight.shape[0],))


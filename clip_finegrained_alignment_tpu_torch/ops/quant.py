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

**Split dimensions** (:class:`Groups`). A scale reduces over one
dimension; where the ranks of a process group each hold a part of it,
the scale must be the MAX over those ranks, as JAX's GSPMD step (one
program, single-device semantics) takes it. Three such dimensions: the
forward's contraction K (a tensor-parallel row-parallel layer:
``out_proj``, ``fc2``), the dgrad's contraction N (a column-parallel
layer: ``q/k/v_proj``, ``fc1``) and the int8 wgrad's example rows M
(global negatives' data ranks, sequence parallelism's token blocks). For
a split one the fused pass splits in two around one MAX all-reduce of
both operands' absmax vectors (``parallel/collectives.py::
all_reduce_absmax``): :func:`absmax_rows` / :func:`absmax_cols`, then
:func:`quant_rows_given` / :func:`quant_cols_t_given` (kernels
``absmax_rows``, ``absmax_cols``, ``quant_rows_given``,
``quant_cols_t_given`` in ``csrc/quant.cu``). A split contraction's int32
sums are then summed over the group (exact) and dequantized once, the
bias added once: the product GSPMD computes, bit for bit. A dimension no
group splits keeps the fused passes (one launch and one read fewer).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

MODES = ("none", "switchback", "int8")

ROWS_KERNEL = "quant_rows"
COLS_KERNEL = "quant_cols_t"
DEQUANT_KERNEL = "dequant"
ABSMAX_ROWS_KERNEL = "absmax_rows"
ABSMAX_COLS_KERNEL = "absmax_cols"
ROWS_GIVEN_KERNEL = "quant_rows_given"
COLS_GIVEN_KERNEL = "quant_cols_t_given"
SPLIT_KERNELS = (ABSMAX_ROWS_KERNEL, ABSMAX_COLS_KERNEL, ROWS_GIVEN_KERNEL,
                 COLS_GIVEN_KERNEL)

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


def absmax_rows_reference(x: torch.Tensor) -> torch.Tensor:
    """[R, C] → fp32 [R]: max |x| of each row."""
    return x.float().abs().amax(1)


def absmax_cols_reference(x: torch.Tensor) -> torch.Tensor:
    """[R, C] → fp32 [C]: max |x| of each column."""
    return x.float().abs().amax(0)


def _scales(a: torch.Tensor) -> torch.Tensor:
    """The scales of an absmax vector, as :func:`_absmax_quant` takes
    them."""
    a = a.clamp_min(SCALE_FLOOR)
    return a / torch.full_like(a, QMAX)


def quant_rows_given_reference(x: torch.Tensor, a: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] and its rows' absmax [R] → (int8 [R, C], fp32 scales [R]):
    :func:`quant_rows_reference` with the absmax given."""
    s = _scales(a.float())
    return torch.round(x.float() / s[:, None]).to(torch.int8), s


def quant_cols_t_given_reference(x: torch.Tensor, a: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] and its columns' absmax [C] → (int8 [C, round_up(R, 8)],
    fp32 scales [C]): :func:`quant_cols_t_reference` with the absmax
    given."""
    s = _scales(a.float())
    R, C = x.shape
    qt = torch.zeros((C, round_up(R)), dtype=torch.int8, device=x.device)
    qt[:, :R] = torch.round(x.float() / s[None, :]).to(torch.int8).t()
    return qt, s


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


def _check_absmax(a: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if a.shape != (n,) or a.dtype != torch.float32:
        raise ValueError(f"{what} takes an fp32 absmax of [{n}], got "
                         f"{a.dtype} {tuple(a.shape)}")
    return a.contiguous()


def _launch_absmax_rows(x: torch.Tensor) -> torch.Tensor:
    x = _check_operand(x, "absmax_rows input")
    R, C = x.shape
    fn = _entry(ABSMAX_ROWS_KERNEL, [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    a = torch.empty((R,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), R, C, _dtype_code(x.dtype),
                 _stream(x))
    _raise_on(err, ABSMAX_ROWS_KERNEL)
    _build.LAUNCHES[ABSMAX_ROWS_KERNEL].add()
    return a


def _launch_absmax_cols(x: torch.Tensor) -> torch.Tensor:
    x = _check_operand(x, "absmax_cols input")
    R, C = x.shape
    fn = _entry(ABSMAX_COLS_KERNEL, [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    a = torch.empty((C,), dtype=torch.float32, device=x.device)
    chunks = -(-R // COL_CHUNK)
    partial = torch.empty((chunks, C), dtype=torch.float32,
                          device=x.device) if chunks > 1 else None
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(),
                 None if partial is None else partial.data_ptr(), R, C,
                 COL_CHUNK, _dtype_code(x.dtype), _stream(x))
    _raise_on(err, ABSMAX_COLS_KERNEL)
    _build.LAUNCHES[ABSMAX_COLS_KERNEL].add()
    return a


def _launch_quant_rows_given(x: torch.Tensor, a: torch.Tensor):
    x = _check_operand(x, "quant_rows_given input")
    R, C = x.shape
    a = _check_absmax(a, R, "quant_rows_given")
    fn = _entry(ROWS_GIVEN_KERNEL, [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), q.data_ptr(), s.data_ptr(), R,
                 C, _dtype_code(x.dtype), _stream(x))
    _raise_on(err, ROWS_GIVEN_KERNEL)
    _build.LAUNCHES[ROWS_GIVEN_KERNEL].add()
    return q, s


def _launch_quant_cols_t_given(x: torch.Tensor, a: torch.Tensor):
    x = _check_operand(x, "quant_cols_t_given input")
    R, C = x.shape
    a = _check_absmax(a, C, "quant_cols_t_given")
    fn = _entry(COLS_GIVEN_KERNEL, [ctypes.c_void_p] * 4
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    qt = torch.empty((C, round_up(R)), dtype=torch.int8, device=x.device)
    s = torch.empty((C,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), qt.data_ptr(), s.data_ptr(), R,
                 C, qt.shape[1], _dtype_code(x.dtype), _stream(x))
    _raise_on(err, COLS_GIVEN_KERNEL)
    _build.LAUNCHES[COLS_GIVEN_KERNEL].add()
    return qt, s


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


def _route(t: torch.Tensor, kernel, plain, *args):
    """``kernel(*args)`` on a CUDA tensor, ``plain(*args)`` on a CPU one;
    any other device raises."""
    kind = _device_kind(t)
    if kind == "cuda":
        return kernel(*args)
    if kind == "cpu":
        return plain(*args)
    raise ValueError(f"no int8 quantization for device {t.device}")


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] → (int8 [R, C], fp32 scales [R]). CUDA: ``cfa_quant_rows``;
    CPU: :func:`quant_rows_reference`."""
    return _route(x, _launch_quant_rows, quant_rows_reference, x)


def quant_cols_t(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] → (int8 [C, round_up(R, 8)], fp32 scales [C]). CUDA:
    ``cfa_quant_cols_t``; CPU: :func:`quant_cols_t_reference`."""
    return _route(x, _launch_quant_cols_t, quant_cols_t_reference, x)


def dequant(acc: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor,
            bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """int32 [R, C] → ``dtype`` [R, C], + bias. CUDA: ``cfa_dequant``;
    CPU: :func:`dequant_reference`."""
    return _route(acc, _launch_dequant, dequant_reference, acc, s_row,
                  s_col, bias, dtype)


def absmax_rows(x: torch.Tensor) -> torch.Tensor:
    """[R, C] → fp32 [R], each row's max |x|. CUDA: ``cfa_absmax_rows``;
    CPU: :func:`absmax_rows_reference`."""
    return _route(x, _launch_absmax_rows, absmax_rows_reference, x)


def absmax_cols(x: torch.Tensor) -> torch.Tensor:
    """[R, C] → fp32 [C], each column's max |x|. CUDA:
    ``cfa_absmax_cols``; CPU: :func:`absmax_cols_reference`."""
    return _route(x, _launch_absmax_cols, absmax_cols_reference, x)


def quant_rows_given(x: torch.Tensor, a: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quant_rows` with the rows' absmax ``a`` [R] given. CUDA:
    ``cfa_quant_rows_given``; CPU: :func:`quant_rows_given_reference`."""
    return _route(x, _launch_quant_rows_given, quant_rows_given_reference,
                  x, a)


def quant_cols_t_given(x: torch.Tensor, a: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quant_cols_t` with the columns' absmax ``a`` [C] given.
    CUDA: ``cfa_quant_cols_t_given``; CPU:
    :func:`quant_cols_t_given_reference`."""
    return _route(x, _launch_quant_cols_t_given,
                  quant_cols_t_given_reference, x, a)


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

class Groups(NamedTuple):
    """The process groups over which a product's three reduced dimensions
    are split (module docstring); None: this rank holds the whole
    dimension, and the fused passes run."""
    k: object = None    # the forward's contraction (row-parallel layer)
    n: object = None    # the dgrad's contraction (column-parallel layer)
    m: object = None    # the int8 wgrad's example rows


LOCAL = Groups()


def _absmax_over(group, *vectors):
    """The vectors' elementwise MAX over ``group``, one all-reduce."""
    from ..parallel.collectives import all_reduce_absmax
    return all_reduce_absmax(vectors, group)


def _sum_over(group, acc: torch.Tensor) -> torch.Tensor:
    """int32 partial sums summed over ``group`` (exact), in place."""
    from ..parallel.collectives import all_reduce_sum_
    return all_reduce_sum_(acc, group)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                group=None) -> torch.Tensor:
    """x [M, K] @ Wᵀ for W [N, K] through dynamic int8: per-row scales of
    x, per-row (output-feature) scales of W; ``(xq @ wqᵀ) · (sx · sw)`` in
    fp32, cast to ``dtype``, + bias. With the defaults it is JAX's
    ``int8_matmul(x, W.T)``. ``group``: K is split over it (this rank's
    x and W hold one part of it): both operands' absmax MAXed over it,
    the int32 sums summed, then one dequant with the bias."""
    if group is None:
        xq, sx = quant_rows(x)
        wq, sw = quant_rows(w)
        return dequant(int_mm(xq, wq.t()), sx, sw, bias, dtype)
    ax, aw = _absmax_over(group, absmax_rows(x), absmax_rows(w))
    xq, sx = quant_rows_given(x, ax)
    wq, sw = quant_rows_given(w, aw)
    return dequant(_sum_over(group, int_mm(xq, wq.t())), sx, sw, bias,
                   dtype)


def _dgrad(g: torch.Tensor, w: torch.Tensor, dtype,
           group=None) -> torch.Tensor:
    """dx [M, K] = g [M, N] @ W [N, K]: per-row scales of g, per-column
    scales of W (JAX's ``int8_matmul(g, w.T)``). ``group``: N is split
    over it (a column-parallel layer): the scales MAXed and the int32
    sums summed, so dx is whole."""
    N = w.shape[0]
    if group is None:
        gq, sg = quant_rows(g)
        wqt, sk = quant_cols_t(w)
        return dequant(int_mm(gq, wqt[:, :N].t()), sg, sk, None, dtype)
    ag, ak = _absmax_over(group, absmax_rows(g), absmax_cols(w))
    gq, sg = quant_rows_given(g, ag)
    wqt, sk = quant_cols_t_given(w, ak)
    return dequant(_sum_over(group, int_mm(gq, wqt[:, :N].t())), sg, sk,
                   None, dtype)


def _wgrad_int8(g: torch.Tensor, x: torch.Tensor, dtype,
                group=None) -> torch.Tensor:
    """dW [N, K] = gᵀ x over M, both quantized over M (JAX's
    ``int8_matmul(x.T, g)``, transposed); M zero-padded to a multiple
    of 8. ``group``: the rows M are split over it: the scales MAXed (the
    train step sums the ranks' dW)."""
    if group is None:
        gqt, sg = quant_cols_t(g)
        xqt, sx = quant_cols_t(x)
    else:
        ag, ax = _absmax_over(group, absmax_cols(g), absmax_cols(x))
        gqt, sg = quant_cols_t_given(g, ag)
        xqt, sx = quant_cols_t_given(x, ax)
    return dequant(int_mm(gqt, xqt.t()), sg, sx, None, dtype)


class QuantMatmul(torch.autograd.Function):
    """``int8_matmul`` forward (+ bias) with straight-through gradients:
    dgrad int8 in both modes; wgrad exact (``switchback``) or int8
    (``int8``); the bias's gradient is Σ_m g. Each gradient is computed
    only when its input needs one (the patch embedding's pixels do not),
    as XLA drops the unused products. ``groups``: :class:`Groups`."""

    @staticmethod
    def forward(ctx, x, w, bias, mode, groups=LOCAL):
        ctx.mode = mode
        ctx.groups = groups
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, w)
        return int8_matmul(x, w, bias, x.dtype, groups.k)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        groups = ctx.groups
        g = g.contiguous()
        dx = _dgrad(g, w, x.dtype, groups.n) if need_x else None
        dw = None
        if need_w:
            dw = (_wgrad_int8(g, x, w.dtype, groups.m)
                  if ctx.mode == "int8" else (g.t() @ x).to(w.dtype))
        db = g.sum(0) if ctx.has_bias and need_b else None
        return dx, dw, db, None, None


def quant_matmul(x: torch.Tensor, w: torch.Tensor,
                 mode: str = "switchback") -> torch.Tensor:
    """Quantized ``x @ Wᵀ`` with straight-through gradients: x [M, K],
    W [N, K] → [M, N] in x's dtype; ``mode`` picks the backward."""
    if mode not in MODES[1:]:
        raise ValueError(f"invalid quant mode {mode!r} (switchback | int8)")
    return QuantMatmul.apply(x, w, None, mode)


def quant_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], dtype: torch.dtype,
                 mode: str, groups: Groups = LOCAL) -> torch.Tensor:
    """Drop-in for ``models/clip.py::linear`` on the int8 path: x and the
    weight cast to ``dtype``, leading dims collapsed to one example axis,
    the quantized product, then the bias cast to ``dtype`` added in
    ``dtype`` (inside ``dequant``). ``groups``: :class:`Groups`."""
    if mode not in MODES[1:]:
        raise ValueError(f"invalid quant mode {mode!r} (switchback | int8)")
    x = x.to(dtype)
    shape = x.shape
    y = QuantMatmul.apply(x.reshape(-1, shape[-1]), weight.to(dtype),
                          None if bias is None else bias.to(dtype), mode,
                          groups)
    return y.reshape(shape[:-1] + (weight.shape[0],))

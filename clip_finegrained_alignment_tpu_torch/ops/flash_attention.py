"""Blockwise (long-sequence) attention, forward and backward: the CUDA
kernels and their plain twins, joined by an ``autograd.Function``.

``blockwise_flash_attention(q, k, v, bias, scale, block_q, block_k)`` is the
port of ``clip_finegrained_alignment_tpu/ops/flash_attention.py``, the
streaming-softmax attention whose memory grows with S·block instead of S².
It replaces the three Pallas TPU kernels there:

* the forward ``_fwd_kernel`` with ``csrc/flash_fwd.cu``;
* the backward ``_bwd_dq_kernel`` with ``csrc/flash_bwd_dq.cu``;
* the backward ``_bwd_dkv_kernel`` with ``csrc/flash_bwd_dkdv.cu``;

each written by hand for Hopper and loaded through ``ops/_build.py``.

* q, k, v are ``[B, H, S, D]`` (bhsd), any batch / head / sequence strides,
  last dim contiguous; float32 or bfloat16; D in {16, 32, 64}.
* bias is None or floating, broadcastable to ``[B|1, 1, S, S]``. It is
  detached and gets no gradient, as JAX stops its gradient.
* The output and the gradients are ``[B, H, S, D]`` contiguous in q's type.

The numerics are the TPU kernels': ``qs = (q·scale)`` rounded to q's type;
an online softmax whose running max starts at −1e9; p summed in fp32 but
rounded to v's type for the product with v; ``lse = m + log l``. The
backward takes ``δ = Σ(do∘o)`` (the flash-2 identity, in plain PyTorch as
JAX computes it in XLA) and ``p = exp(s − lse)`` unrounded; dq is rounded,
multiplied by the rounded scale and rounded again; dk and dv are rounded
once.

``block_q`` and ``block_k`` are JAX's signature. ``block_q`` is ignored:
on the TPU it only pads query rows that are dropped again. ``block_k``
fixes the padded key count ``Sk = round_up(S, block_k)`` of the TPU
wrapper, whose zero keys with a −1e9 bias tie with the real keys of a row
that is masked everywhere: such a row comes out as Σv / Sk, not the mean
over S. The kernels tile their own way and reproduce that by adding the
padded keys' ``(Sk − S)·exp(−1e9 − m)`` to l; the plain forward walks
JAX's padded key blocks. Neither block size sets a kernel tile.

On a CUDA tensor each direction launches its kernels or raises; on a CPU
tensor it runs :func:`blockwise_attention_reference` or
:func:`blockwise_attention_backward_reference`, the same math in plain
PyTorch. Nothing routes a CUDA tensor to a plain version or to a library
call. No model path calls this module; ``perf/flash_microbench.py`` does.

Bound at the microbenchmark's S=2048, B=4, H=12, D=64, bf16 on an H100
(989 TFLOP/s bf16): forward 51.5 GFLOP (0.052 ms), dq 77.3 GFLOP
(0.078 ms), dk/dv 103 GFLOP (0.104 ms), all bound by operations.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .attention import (_check_operands, _kernel_bias, _scaled_q, _strides,
                        rounded_scale)

FWD_KERNEL = "flash_fwd"
DQ_KERNEL = "flash_bwd_dq"
DKDV_KERNEL = "flash_bwd_dkdv"
NEG = -1e9
BLOCKWISE_THRESHOLD = 1024  # the JAX package's: whole-tile kernel below this
MAX_GRID_DIM = 65535        # B and H are CUDA grid dimensions


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """δ = Σ(do∘o) over the head dim, fp32 ``[B, H, S]``."""
    return (do.float() * o.float()).sum(-1)


def blockwise_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor], scale: float,
                                  block_k: int = 128):
    """Plain PyTorch forward with the TPU kernel's numerics (``_prepare`` +
    ``_fwd_kernel``): the keys padded to ``round_up(S, block_k)`` with zero
    k, v and a −1e9 bias, then walked in blocks of ``block_k`` with the
    online softmax, so p is rounded to v's type where JAX rounds it.
    Returns (o in q's type, lse fp32 ``[B, H, S]``)."""
    B, H, S, D = q.shape
    pad = _round_up(S, block_k) - S
    qs = _scaled_q(q, scale).float()
    kp = F.pad(k.float(), (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    full_bias = torch.where(torch.arange(S + pad, device=q.device) >= S,
                            NEG, 0.0).float()
    if bias is not None:
        full_bias = F.pad(bias.float(), (0, pad)) + full_bias
    m = torch.full((B, H, S, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S + pad, block_k):
        s = qs @ kp[:, :, k0:k0 + block_k].transpose(-1, -2) \
            + full_bias[..., k0:k0 + block_k]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ \
            vp[:, :, k0:k0 + block_k].float()
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def blockwise_attention_backward_reference(q, k, v, bias, scale, o, lse, do):
    """Plain PyTorch backward with the TPU kernels' numerics (``_bwd``):
    δ = Σ(do∘o) from the saved output, p = exp(s − lse) in fp32 over the
    real keys (JAX's padded keys have zero k and add nothing), dp = do·vᵀ,
    ds = p∘(dp − δ); dq = ds·k rounded, times the rounded scale, rounded
    again; dk = dsᵀ·qs and dv = pᵀ·do rounded once. p, dp and ds are
    materialized ``[B, H, S, S]`` in fp32. Returns (dq, dk, dv)."""
    dtype = q.dtype
    qs = _scaled_q(q, scale).float()
    do32 = do.float()
    p = qs @ k.float().transpose(-1, -2)
    if bias is not None:
        p += bias.float()
    p = p.sub_(lse.float()[..., None]).exp_()
    ds = do32 @ v.float().transpose(-1, -2)
    ds = ds.sub_(_delta(do, o)[..., None]).mul_(p)
    dv = (p.transpose(-1, -2) @ do32).to(dtype)
    del p
    dq = (ds @ k.float()).to(dtype)
    dq = (dq.float() * rounded_scale(scale, dtype)).to(dtype)
    dk = (ds.transpose(-1, -2) @ qs).to(dtype)
    return dq, dk, dv


def _check(q, k, v, bias, block_k) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if min(B, H, S) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if max(B, H) > MAX_GRID_DIM:
        raise ValueError(f"B and H must be at most {MAX_GRID_DIM}, got "
                         f"{tuple(q.shape)}")
    if not isinstance(block_k, int) or isinstance(block_k, bool) \
            or block_k < 1:
        raise ValueError(f"block_k must be a positive int, got {block_k!r}")
    _check_operands(q, k, v, bias, B, S)


def _dtype_code(t: torch.Tensor) -> int:
    return 0 if t.dtype == torch.float32 else 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, bias, scale, block_k):
    """(o, lse) from ``csrc/flash_fwd.cu``."""
    B, H, S, D = q.shape
    fn = _build.load(FWD_KERNEL).cfa_flash_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    bias_ptr, bias_sb, held = _kernel_bias(bias, S)
    # The C entry launches on the current device: make it q's.
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 o.data_ptr(), lse.data_ptr(), B, H, S, D, _dtype_code(q),
                 _round_up(S, block_k) - S, *_strides(q, k, v), bias_sb,
                 rounded_scale(scale, q.dtype), _stream(q))
    del held
    if err != 0:
        raise RuntimeError(f"{FWD_KERNEL} kernel launch failed: CUDA error {err}")
    _build.LAUNCHES[FWD_KERNEL].add()
    return o, lse


def _bwd_operands(q, do, lse, delta):
    """do in q's type with a contiguous last dim; lse and δ contiguous fp32."""
    if do.dtype != q.dtype or do.stride(-1) != 1:
        do = do.to(q.dtype).contiguous()
    return do, lse.float().contiguous(), delta.float().contiguous()


def _bwd_argtypes(n_out: int) -> list:
    return ([ctypes.c_void_p] * (7 + n_out) + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 13 + [ctypes.c_float, ctypes.c_void_p])


def _launch_bwd_dq(q, k, v, bias, scale, do, lse, delta):
    """dq from ``csrc/flash_bwd_dq.cu``, given the forward's lse and
    δ = Σ(do∘o), both fp32 ``[B, H, S]``."""
    B, H, S, D = q.shape
    fn = _build.load(DQ_KERNEL).cfa_flash_bwd_dq
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _bwd_argtypes(1)
    do, lse, delta = _bwd_operands(q, do, lse, delta)
    dq = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    bias_ptr, bias_sb, held = _kernel_bias(bias, S)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), B, H, S, D, _dtype_code(q),
                 *_strides(q, k, v, do), bias_sb,
                 rounded_scale(scale, q.dtype), _stream(q))
    del held
    if err != 0:
        raise RuntimeError(f"{DQ_KERNEL} kernel launch failed: CUDA error {err}")
    _build.LAUNCHES[DQ_KERNEL].add()
    return dq


def _launch_bwd_dkdv(q, k, v, bias, scale, do, lse, delta):
    """(dk, dv) from ``csrc/flash_bwd_dkdv.cu``, given lse and δ as for
    :func:`_launch_bwd_dq`."""
    B, H, S, D = q.shape
    fn = _build.load(DKDV_KERNEL).cfa_flash_bwd_dkdv
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _bwd_argtypes(2)
    do, lse, delta = _bwd_operands(q, do, lse, delta)
    dk, dv = (torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
              for _ in range(2))
    bias_ptr, bias_sb, held = _kernel_bias(bias, S)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, H, S, D, _dtype_code(q),
                 *_strides(q, k, v, do), bias_sb,
                 rounded_scale(scale, q.dtype), _stream(q))
    del held
    if err != 0:
        raise RuntimeError(
            f"{DKDV_KERNEL} kernel launch failed: CUDA error {err}")
    _build.LAUNCHES[DKDV_KERNEL].add()
    return dk, dv


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


def _forward(q, k, v, bias, scale, block_k):
    kind = _device_kind(q)
    if kind == "cuda":
        return _launch_fwd(q, k, v, bias, scale, block_k)
    if kind == "cpu":
        return blockwise_attention_reference(q, k, v, bias, scale, block_k)
    raise ValueError(f"no blockwise attention for device {q.device}")


def _backward(q, k, v, bias, scale, o, lse, do):
    kind = _device_kind(q)
    if kind == "cuda":
        delta = _delta(do, o)
        dq = _launch_bwd_dq(q, k, v, bias, scale, do, lse, delta)
        dk, dv = _launch_bwd_dkdv(q, k, v, bias, scale, do, lse, delta)
        return dq, dk, dv
    if kind == "cpu":
        return blockwise_attention_backward_reference(q, k, v, bias, scale,
                                                      o, lse, do)
    raise ValueError(f"no blockwise attention backward for device {q.device}")


class BlockwiseFlashAttention(torch.autograd.Function):
    """The forward kernel with the two backward kernels as its gradient
    (the port of ``_blockwise_vjp``). Saves JAX's residuals: q, k, v, the
    bias, the output and the fp32 lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, block_k):
        o, lse = _forward(q, k, v, bias, scale, block_k)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, bias, ctx.scale, o, lse, do)
        return dq, dk, dv, None, None, None


def blockwise_flash_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: Optional[torch.Tensor],
                              scale: float, block_q: int = 128,
                              block_k: int = 128) -> torch.Tensor:
    """softmax(q·scale·kᵀ + bias)·v over bhsd q, k, v → ``[B, H, S, D]``,
    streamed over key blocks, differentiable in q, k and v.

    CUDA tensors launch ``csrc/flash_fwd.cu`` (and, in the backward,
    ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkdv.cu``); CPU tensors
    run the plain versions. Inputs the kernels do not take raise
    ``ValueError`` on either device. ``block_q`` is ignored (see the
    module note)."""
    _check(q, k, v, bias, block_k)
    if bias is not None:
        bias = bias.detach()
    return BlockwiseFlashAttention.apply(q, k, v, bias, scale, block_k)

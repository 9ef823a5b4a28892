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
(0.078 ms), dk/dv 103 GFLOP (0.104 ms), all bound by operations, against
~25–38 MB moved. So in bf16 all three kernels run every product on the
tensor cores through ``wgmma``, fed by TMA copies through a ring of tiles
in shared memory (``csrc/attention_wgmma.cuh``): s, p, dp and the sums
never leave the SM, and p and ds pass from one product to the next in
registers. They read qs = (q·scale) in bf16, made by the wrapper as JAX's
``_prepare`` makes it (:func:`_tma_operands`), and the backward reads lse
and δ padded to a multiple of 64 per row; bf16 q, k, v and do views whose
pointers or strides are not multiples of 16 bytes raise ``ValueError`` on
the card (the CPU takes any layout). The float32 kernels are the first
CUDA-core versions (TF32 would not hold the fp32 tolerance); the dtype
alone picks the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .attention import (NEG, _check_copy_aligned, _check_operands,
                        _dtype_code, _kernel_bias, _round_up, _scaled_q,
                        _strides, rounded_scale)

FWD_KERNEL = "flash_fwd"
DQ_KERNEL = "flash_bwd_dq"
DKDV_KERNEL = "flash_bwd_dkdv"
BLOCKWISE_THRESHOLD = 1024  # the JAX package's: whole-tile kernel below this
MAX_GRID_DIM = 65535        # B and H are CUDA grid dimensions


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, bias, scale, block_k):
    """(o, lse) from ``csrc/flash_fwd.cu``: float32 reads q (the kernel
    scales it), bf16 the operands of :func:`_tma_operands`."""
    B, H, S, D = q.shape
    if q.dtype == torch.bfloat16:
        qk, k, v, strides = _tma_operands(q, scale, k, v)
    else:
        qk, strides = q, _strides(q, k, v)
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
        err = fn(qk.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 o.data_ptr(), lse.data_ptr(), B, H, S, D, _dtype_code(q),
                 _round_up(S, block_k) - S, *strides, bias_sb,
                 rounded_scale(scale, q.dtype), _stream(q))
    del held
    if err != 0:
        raise RuntimeError(f"{FWD_KERNEL} kernel launch failed: CUDA error {err}")
    _build.LAUNCHES[FWD_KERNEL].add()
    return o, lse


def _tma_strides(t: torch.Tensor) -> list:
    """Batch, head and sequence strides of a bhsd tensor for a tensor map:
    a dim of extent 1 is never stepped and takes its dense stride, since
    TMA wants every stride a multiple of 16 bytes."""
    _, H, S, D = t.shape
    dense = (H * S * D, S * D, D)
    return [st if n > 1 else c
            for st, n, c in zip(t.stride()[:3], t.shape[:3], dense)]


def _broadcast(t: torch.Tensor) -> bool:
    return any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape))


def _tma_operands(q, scale, *ts):
    """What the bf16 ``wgmma`` kernels read (TMA copies): ``(qs, *ts,
    strides)``, the tensor-map strides of qs and each of ``ts`` in turn.
    q and ``ts`` views whose pointers or strides are not multiples of 16
    bytes raise ``ValueError``; broadcast (stride 0) operands are made
    dense. qs = (q·scale) rounded to bf16, made here as JAX's ``_prepare``
    makes it (a bf16 product with a bf16-exact scalar is computed in fp32
    and rounded once, as ``_scaled_q``)."""
    _check_copy_aligned(q, *ts)
    ts = [t.contiguous() if _broadcast(t) else t for t in ts]
    qs = q * rounded_scale(scale, q.dtype)
    if _broadcast(qs):
        qs = qs.contiguous()
    return (qs, *ts, [s for t in (qs, *ts) for s in _tma_strides(t)])


def _bwd_operands(q, k, v, scale, do, lse, delta):
    """What the backward kernels read: (q or qs, k, v, do, ls, lse, δ,
    strides of the four bhsd operands). do comes in q's type with a
    contiguous last dim.

    float32: q itself (the kernel scales it), lse and δ contiguous fp32
    ``[B, H, S]`` (ls = S).

    bfloat16: the operands of :func:`_tma_operands`, and lse and δ
    zero-padded to ls = round_up(S, 64) values a row, so the dk/dv pass
    copies them in 64-value blocks."""
    if do.dtype != q.dtype or do.stride(-1) != 1:
        do = do.to(q.dtype).contiguous()
    B, H, S, _ = q.shape
    if q.dtype != torch.bfloat16:
        return (q, k, v, do, S, lse.float().contiguous(),
                delta.float().contiguous(), _strides(q, k, v, do))
    qs, k, v, do, strides = _tma_operands(q, scale, k, v, do)
    ls = _round_up(S, 64)
    stats = torch.zeros((2, B, H, ls), dtype=torch.float32, device=q.device)
    stats[0, ..., :S] = lse
    stats[1, ..., :S] = delta
    return qs, k, v, do, ls, stats[0], stats[1], strides


def _bwd_argtypes(n_out: int) -> list:
    return ([ctypes.c_void_p] * (7 + n_out) + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 13 + [ctypes.c_float, ctypes.c_void_p])


def _launch_bwd_dq(q, k, v, bias, scale, do, lse, delta):
    """dq from ``csrc/flash_bwd_dq.cu``, given the forward's lse and
    δ = Σ(do∘o), both fp32 ``[B, H, S]``."""
    B, H, S, D = q.shape
    qk, k, v, do, ls, lse, delta, strides = _bwd_operands(
        q, k, v, scale, do, lse, delta)
    fn = _build.load(DQ_KERNEL).cfa_flash_bwd_dq
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _bwd_argtypes(1)
    dq = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    bias_ptr, bias_sb, held = _kernel_bias(bias, S)
    with torch.cuda.device(q.device):
        err = fn(qk.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), B, H, S, D, _dtype_code(q), ls, *strides,
                 bias_sb, rounded_scale(scale, q.dtype), _stream(q))
    del held
    if err != 0:
        raise RuntimeError(f"{DQ_KERNEL} kernel launch failed: CUDA error {err}")
    _build.LAUNCHES[DQ_KERNEL].add()
    return dq


def _launch_bwd_dkdv(q, k, v, bias, scale, do, lse, delta):
    """(dk, dv) from ``csrc/flash_bwd_dkdv.cu``, given lse and δ as for
    :func:`_launch_bwd_dq`."""
    B, H, S, D = q.shape
    qk, k, v, do, ls, lse, delta, strides = _bwd_operands(
        q, k, v, scale, do, lse, delta)
    fn = _build.load(DKDV_KERNEL).cfa_flash_bwd_dkdv
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _bwd_argtypes(2)
    dk, dv = (torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
              for _ in range(2))
    bias_ptr, bias_sb, held = _kernel_bias(bias, S)
    with torch.cuda.device(q.device):
        err = fn(qk.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), B, H, S, D, _dtype_code(q), ls,
                 *strides, bias_sb, rounded_scale(scale, q.dtype), _stream(q))
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

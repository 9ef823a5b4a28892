"""Fused multi-head attention, forward and backward: the CUDA kernels and
their plain twins, joined by an ``autograd.Function``.

``flash_attention(q, k, v, bias, scale)`` is the attention of every encoder
layer of both towers (``models/clip.py::attention``). It replaces the
Pallas TPU kernels of ``clip_finegrained_alignment_tpu/ops/attention.py``:

* the forward ``_fwd_kernel_bshd`` (math ``_fwd_math``) with
  ``csrc/attention_fwd.cu``;
* the backward ``_bwd_kernel_bshd`` (math ``_bwd_math``, wrapper
  ``_fused_backward``) with ``csrc/attention_bwd.cu``;

both written by hand for Hopper and loaded through ``ops/_build.py``.

* q, k, v are ``[B, S, H, Dh]`` (bshd) views of the projection outputs;
  any batch / sequence / head strides that are multiples of 16 bytes,
  last dim contiguous; float32 or bfloat16; Dh in {16, 32, 64}.
* bias is None or additive fp32, broadcastable to ``[B|1, 1, S, S]``
  (head-invariant: CLIP's causal and padding masks). It gets no gradient,
  as in the JAX package (``_fa_bwd`` returns None for it).
* The output and the gradients are ``[B, S, H, Dh]`` contiguous in the
  input type.
* The softmax runs over the TPU wrapper's Sp = round_up(S, 8) keys: its
  Sp − S padded keys (zero k and v, score −1e9) join a row whose every
  real key scores at or below −1e9, so a fully masked row comes out as
  Σv / Sp, as the Pallas kernel gives it (XLA's path, which pads nothing,
  gives the mean over S). Every other row is the plain softmax over S. The
  plain versions append the padded keys' scores; the kernels add their
  share to each row's sum in closed form.

On a CUDA tensor each direction launches its kernel or raises; on a CPU
tensor it runs :func:`attention_reference` or
:func:`attention_backward_reference`, the same math in plain PyTorch.
Nothing routes a CUDA tensor to a plain version or to a library call, and
the kernel is chosen by dtype alone.

Bound at B=32 on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the ViT-B/16
vision forward (S=197, H=12, Dh=64, bf16) moves ~39 MB of q/k/v/o for
~3.8 GFLOP (~11.5 us, bytes); its backward moves ~68 MB of q/k/v/do/dq/
dk/dv for ~9.5 GFLOP (~20 us, bytes). Every kernel runs every product on
the tensor cores (``mma.sync``, fp32 sums) from tiles read 16 bytes at a
time through the tensors' strides into shared memory, so each pointer
and stride must be a multiple of 16 bytes (true of every projection view
the model makes; anything else raises ``ValueError``; a misaligned
cotangent is copied):

* bf16, the type of serving and of training by default: m16n8k16 bf16
  products;
* float32, the type of evaluation's towers (``eval/scoring.py``) and of
  training under ``cli/train.py --no-amp``: each fp32 product as three
  m16n8k8 TF32 products of hi / lo halves (hi·hi + hi·lo + lo·hi), which
  holds the fp32 tolerance one TF32 product would miss, the tiles split
  once into those halves as they are stored; the same bound in bytes, and
  three times the flops at 495 TFLOP/s (~23 us for the forward at
  evaluation's B=32 either way; ~58 us of operations for the vision
  backward at B=32).

When a gradient will be taken, the forward also writes the per-row
log-sum-exp, which ``FlashAttention`` saves so that the backward, in
either dtype, reads exact probabilities instead of recomputing the
softmax statistics; serving and evaluation (no gradient) write none. It
is an fp32 pair ``[2, B, H, S]``: lse[0] the log-sum-exp rounded to fp32
and lse[1] what that rounding left out, since at a fully masked row's
−1e9 one fp32 has a spacing of 64 and would lose log Sp. The designs are
described in the sources.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

KERNEL = "attention_fwd"
BACKWARD_KERNEL = "attention_bwd"
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (16, 32, 64)
NEG = -1e9          # the TPU wrapper's mask value (``_NEG``)
SEQ_QUANTUM = 8     # the TPU wrapper pads S to a multiple of this


@functools.lru_cache(maxsize=None)
def rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype``: JAX multiplies a bf16 array by a
    Python float in bf16, so the TPU wrapper's ``q * scale`` uses this."""
    return float(torch.tensor(scale, dtype=dtype))


def _scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``(q * scale).astype(q.dtype)`` as the TPU wrapper's ``_prepare``."""
    return (q.float() * rounded_scale(scale, q.dtype)).to(q.dtype)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _probs(qs, k, bias) -> torch.Tensor:
    """fp32 softmax of qs·kᵀ + bias, ``[B, H, S, S]``, over the TPU
    wrapper's Sp = round_up(S, 8) keys: the Sp − S padded keys score −1e9
    (zero k and a −1e9 bias) and are dropped after the softmax. They change
    only a row whose every real key scores at or below −1e9, which they
    join: a fully masked row weighs its keys 1 / Sp, not 1 / S."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    S = logits.shape[-1]
    logits = F.pad(logits, (0, _round_up(S, SEQ_QUANTUM) - S), value=NEG)
    return torch.softmax(logits, dim=-1)[..., :S]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        scale: float) -> torch.Tensor:
    """Plain PyTorch attention with the TPU kernel's numerics
    (``_prepare`` + ``_fwd_math``): q pre-scaled and rounded to its type,
    fp32 scores, bias, max, exp and sum, the probabilities rounded to v's
    type, an fp32 product with v, the result in q's type. bshd in and out.
    """
    p = _probs(_scaled_q(q, scale), k, bias).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def attention_backward_reference(q, k, v, bias, scale, do):
    """Plain PyTorch backward with the TPU kernel's numerics
    (``_fused_backward`` + ``_bwd_math``): recompute p in fp32 from the
    scaled and rounded q; dv = pᵀ·do, dp = do·vᵀ, ds = p∘(dp − Σ(dp∘p)),
    dq = ds·k, dk = dsᵀ·qs, each cast to the input type; then dq is
    multiplied by the scale and cast again. Returns (dq, dk, dv), bshd."""
    dtype = q.dtype
    qs = _scaled_q(q, scale)
    p = _probs(qs, k, bias)
    do32 = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    dq = (dq.float() * rounded_scale(scale, dtype)).to(dtype)
    return dq, dk.to(dtype), dv.to(dtype)


def _check(q, k, v, bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, Dh], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if min(B, S, H) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    _check_operands(q, k, v, bias, B, S)


def _check_operands(q, k, v, bias, B, S) -> None:
    """The checks of q, k, v and the bias that do not depend on the layout
    (bshd here, bhsd in ``ops/flash_attention.py``): one supported dtype
    and head dim, a contiguous last dim, one device, and a floating bias
    broadcastable to ``[B|1, 1, S, S]``."""
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {SUPPORTED_DTYPES}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last dim of q, k, v must be contiguous")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v lie on different devices")
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, B) \
                or bias.shape[1] != 1 or bias.shape[2] not in (1, S) \
                or bias.shape[3] != S:
            raise ValueError(f"bias must broadcast to [B|1, 1, S, S] = "
                             f"[{B}|1, 1, {S}, {S}], got {tuple(bias.shape)}")
        if not bias.is_floating_point():
            raise ValueError(f"bias must be floating point, got {bias.dtype}")
        if bias.device != q.device:
            raise ValueError("bias lies on another device than q")


def _kernel_bias(bias, S):
    """(pointer, batch stride, tensor) of the fp32 ``[B|1, S, S]`` bias the
    kernels read; the caller holds the tensor through the C call. It may
    be freed before the kernel runs: the caching allocator only hands it
    out again to later work on this same stream, which runs after the
    kernel."""
    if bias is None:
        return None, 0, None
    bb = bias.shape[0]
    bias = bias.to(torch.float32).expand(bb, 1, S, S) \
        .reshape(bb, S, S).contiguous()
    return bias.data_ptr(), (S * S if bb > 1 else 0), bias


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _copy_aligned(t: torch.Tensor) -> bool:
    """Whether a tensor's pointer and batch / sequence / head strides (of a
    dim longer than 1) are multiples of 16 bytes, as the kernels' 16-byte
    loads and ``cp.async`` copies need."""
    st, n, quantum = t.stride(), t.shape, 16 // t.element_size()
    return not (t.data_ptr() % 16 or (st[0] % quantum and n[0] > 1)
                or (st[1] % quantum and n[1] > 1)
                or (st[2] % quantum and n[2] > 1))


def _check_copy_aligned(*ts) -> None:
    if not all(map(_copy_aligned, ts)):
        raise ValueError(f"{ts[0].dtype} attention operands on the card need "
                         "pointers and batch / sequence / head strides that "
                         "are multiples of 16 bytes")


def _dtype_code(t: torch.Tensor) -> int:
    return 0 if t.dtype == torch.float32 else 1


def _launch(q, k, v, bias, scale, want_lse=False):
    """The forward kernel: ``(o, lse)``, lse the fp32 pair ``[2, B, H, S]``
    (hi, lo) if ``want_lse`` else None."""
    B, S, H, D = q.shape
    _check_copy_aligned(q, k, v)
    fn = _build.load(KERNEL).cfa_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((2, B, H, S), dtype=torch.float32, device=q.device)
           if want_lse else None)
    bias_ptr, bias_sb, _ = _kernel_bias(bias, S)
    # The C entry launches on the current device: make it q's.
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 out.data_ptr(), None if lse is None else lse.data_ptr(),
                 B, S, H, D, _dtype_code(q), *_strides(q, k, v), bias_sb,
                 rounded_scale(scale, q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")
    _build.LAUNCHES[KERNEL].add()
    return out, lse


def _launch_backward(q, k, v, bias, scale, do, lse):
    """The backward kernels: ``(dq, dk, dv)``, from the forward's ``lse``
    pair in either dtype."""
    B, S, H, D = q.shape
    _check_copy_aligned(q, k, v)
    if lse is None or lse.shape != (2, B, H, S) \
            or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("the attention backward needs the forward's fp32 "
                         "[2, B, H, S] log-sum-exp pair")
    fn = _build.load(BACKWARD_KERNEL).cfa_attention_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 13
                       + [ctypes.c_float, ctypes.c_void_p])
    if do.dtype != q.dtype or do.shape != q.shape or do.stride(-1) != 1 \
            or not _copy_aligned(do):
        # A fresh copy: .contiguous() would keep a contiguous view whose
        # pointer is not 16-byte aligned.
        do = do.to(q.dtype, memory_format=torch.contiguous_format, copy=True)
    dq, dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    # fp32 scratch: the dq pass's row term, read by the dk/dv pass.
    stats = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    bias_ptr, bias_sb, _ = _kernel_bias(bias, S)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 do.data_ptr(), lse.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats.data_ptr(), B, S, H, D, _dtype_code(q),
                 *_strides(q, k, v, do), bias_sb,
                 rounded_scale(scale, q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{BACKWARD_KERNEL} kernel launch failed: CUDA error {err}")
    _build.LAUNCHES[BACKWARD_KERNEL].add()
    return dq, dk, dv


def _device_kind(t: torch.Tensor) -> str:
    return t.device.type


def _forward(q, k, v, bias, scale, want_lse):
    """``(o, lse)``; lse (CUDA only) when ``want_lse``: the plain backward
    recomputes what it needs."""
    kind = _device_kind(q)
    if kind == "cuda":
        return _launch(q, k, v, bias, scale, want_lse)
    if kind == "cpu":
        return attention_reference(q, k, v, bias, scale), None
    raise ValueError(f"no attention for device {q.device}")


def _backward(q, k, v, bias, scale, do, lse):
    kind = _device_kind(q)
    if kind == "cuda":
        return _launch_backward(q, k, v, bias, scale, do, lse)
    if kind == "cpu":
        return attention_backward_reference(q, k, v, bias, scale, do)
    raise ValueError(f"no attention backward for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    port of ``_flash_attention_vjp``). Saves q, k, v, the bias and, on the
    card, the forward's log-sum-exp; the backward recomputes the
    probabilities from them. :func:`flash_attention` applies it only when
    a gradient will be taken."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = _forward(q, k, v, bias, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, bias, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, bias, ctx.scale, do, lse)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    scale: float) -> torch.Tensor:
    """softmax(q·scale·kᵀ + bias)·v over bshd q, k, v → ``[B, S, H, Dh]``,
    differentiable in q, k and v.

    CUDA tensors launch ``csrc/attention_fwd.cu`` (and, in the backward,
    ``csrc/attention_bwd.cu``); CPU tensors run the plain versions. Inputs
    the kernels do not take raise ``ValueError`` on either device."""
    _check(q, k, v, bias)
    if bias is not None:
        bias = bias.detach()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bias, scale)
    # No backward will run (serving runs under inference_mode): the forward
    # alone, without the statistics and the autograd Function's host cost.
    return _forward(q, k, v, bias, scale, want_lse=False)[0]

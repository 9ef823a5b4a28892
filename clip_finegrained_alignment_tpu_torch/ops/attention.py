"""Fused multi-head attention forward: the CUDA kernel and its plain twin.

``flash_attention(q, k, v, bias, scale)`` is the attention of every encoder
layer of both towers (``models/clip.py::attention``). It replaces the
Pallas TPU kernel ``clip_finegrained_alignment_tpu/ops/attention.py::
_fwd_kernel_bshd`` (its math is ``_fwd_math``, its wrapper
``flash_attention``) with ``csrc/attention_fwd.cu``, written by hand for
Hopper and loaded through ``ops/_build.py``:

* q, k, v are ``[B, S, H, Dh]`` (bshd) views of the projection outputs;
  any batch / sequence / head strides, last dim contiguous; float32 or
  bfloat16; Dh in {16, 32, 64}.
* bias is None or additive fp32, broadcastable to ``[B|1, 1, S, S]``
  (head-invariant: CLIP's causal and padding masks).
* The output is ``[B, S, H, Dh]`` contiguous in the input type.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`attention_reference`, the same math in plain
PyTorch. Nothing routes a CUDA tensor to the plain version or to a library
call.

Bound at B=64 on an H100 (3.35 TB/s, 989 TFLOP/s bf16): ViT-B/16 vision
(S=197, H=12, Dh=64, bf16) is ~7.6 GFLOP and ~77 MB of q/k/v/o traffic,
memory-bound at ~23 us; the text tower (S=77, H=8) is ~20 MB, ~6 us.
The kernel's design against that bound is described in the source.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build

KERNEL = "attention_fwd"
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (16, 32, 64)

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _count_launch() -> None:
    global _launches
    with _count_lock:
        _launches += 1


def rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype``: JAX multiplies a bf16 array by a
    Python float in bf16, so the TPU wrapper's ``q * scale`` uses this."""
    return float(torch.tensor(scale, dtype=dtype))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        scale: float) -> torch.Tensor:
    """Plain PyTorch attention with the TPU kernel's numerics
    (``_prepare`` + ``_fwd_math``): q pre-scaled and rounded to its type,
    fp32 scores, bias, max, exp and sum, the probabilities rounded to v's
    type, an fp32 product with v, the result in q's type. bshd in and out.
    """
    qs = (q.float() * rounded_scale(scale, q.dtype)).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _check(q, k, v, bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, Dh], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if min(B, S, H) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {SUPPORTED_DTYPES}, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
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


def _launch(q, k, v, bias, scale) -> torch.Tensor:
    B, S, H, D = q.shape
    fn = _build.load(KERNEL).cfa_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    bias_ptr, bias_sb = None, 0
    if bias is not None:
        # A temporary made here may be freed before the kernel runs: the
        # caching allocator only hands it out again to later work on this
        # same stream, which runs after the kernel.
        bb = bias.shape[0]
        bias = bias.to(torch.float32).expand(bb, 1, S, S) \
            .reshape(bb, S, S).contiguous()
        bias_ptr, bias_sb = bias.data_ptr(), (S * S if bb > 1 else 0)
    # The C entry launches on the current device: make it q's.
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
                 out.data_ptr(), B, S, H, D,
                 0 if q.dtype == torch.float32 else 1,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 bias_sb, rounded_scale(scale, q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {err}")
    _count_launch()
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    scale: float) -> torch.Tensor:
    """softmax(q·scale·kᵀ + bias)·v over bshd q, k, v → ``[B, S, H, Dh]``.

    CUDA tensors launch ``csrc/attention_fwd.cu``; CPU tensors run
    :func:`attention_reference`. Inputs the kernel does not take raise
    ``ValueError`` on either device."""
    _check(q, k, v, bias)
    if q.device.type == "cuda":
        return _launch(q, k, v, bias, scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    raise ValueError(f"no attention for device {q.device}")
